"""Kernel launches per training step."""

from benchmark import readers


def read(ctx):
    return readers.launches(ctx, "steps")
