"""Device milliseconds per training step between the timing events of train.backward (the weight gradients)."""

from benchmark import span_readers


def read(ctx):
    return span_readers.device_ms(ctx, "train.backward", "train.step", "steps")
