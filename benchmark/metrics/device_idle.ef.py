"""Device idle share of the traced E+F batches."""

from benchmark import readers


def read(ctx):
    return readers.device_idle(ctx)
