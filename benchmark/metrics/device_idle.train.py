"""Device idle share of the traced training steps."""

from benchmark import readers


def read(ctx):
    return readers.device_idle(ctx)
