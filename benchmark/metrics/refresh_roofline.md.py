"""K1 and K2's share of their roofline in the MD step."""

from benchmark import readers


def read(ctx):
    return readers.refresh_roofline(ctx)
