"""Device idle share of the traced MD stretches."""

from benchmark import readers


def read(ctx):
    return readers.device_idle(ctx)
