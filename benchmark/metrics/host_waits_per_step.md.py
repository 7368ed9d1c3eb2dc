"""Host waits for the device per MD step."""

from benchmark import readers


def read(ctx):
    return readers.host_waits(ctx, "steps")
