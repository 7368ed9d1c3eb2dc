"""Host milliseconds per MD step inside the program's md.step span, less its waits for the device."""

from benchmark import span_readers


def read(ctx):
    return span_readers.host_ms(ctx, "md.step", "steps")
