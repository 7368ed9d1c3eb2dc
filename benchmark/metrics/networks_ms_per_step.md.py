"""Device milliseconds per MD step between the timing events of nnp.networks."""

from benchmark import span_readers


def read(ctx):
    return span_readers.device_ms(ctx, "nnp.networks", "md.step", "steps")
