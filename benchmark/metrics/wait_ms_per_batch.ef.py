"""Host milliseconds per E+F batch in the wait spans inside grad.energies_and_forces."""

from benchmark import span_readers


def read(ctx):
    return span_readers.wait_ms(ctx, "grad.energies_and_forces", "batches")
