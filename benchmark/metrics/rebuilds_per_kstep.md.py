"""Neighbor rebuilds per thousand MD steps (the program's MDState.rebuilds)."""

from benchmark import readers


def read(ctx):
    return readers.rebuilds_per_kstep(ctx)
