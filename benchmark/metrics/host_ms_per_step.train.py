"""Host milliseconds per training step inside train.step, less its waits for the device."""

from benchmark import span_readers


def read(ctx):
    return span_readers.host_ms(ctx, "train.step", "steps")
