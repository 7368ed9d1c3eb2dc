"""Host milliseconds per training step in the wait spans inside train.step."""

from benchmark import span_readers


def read(ctx):
    return span_readers.wait_ms(ctx, "train.step", "steps")
