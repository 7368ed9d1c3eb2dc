"""Kernel launches per E+F batch."""

from benchmark import readers


def read(ctx):
    return readers.launches(ctx, "batches")
