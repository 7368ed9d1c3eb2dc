"""Device milliseconds per MD step between the timing events of md.rebuild (the neighbor rebuilds)."""

from benchmark import span_readers


def read(ctx):
    return span_readers.device_ms(ctx, "md.rebuild", "md.step", "steps")
