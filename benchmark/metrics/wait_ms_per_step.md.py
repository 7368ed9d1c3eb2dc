"""Host milliseconds per MD step in the wait spans inside md.step."""

from benchmark import span_readers


def read(ctx):
    return span_readers.wait_ms(ctx, "md.step", "steps")
