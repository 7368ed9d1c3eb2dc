"""Host milliseconds per E+F batch inside grad.energies_and_forces, less its waits for the device."""

from benchmark import span_readers


def read(ctx):
    return span_readers.host_ms(ctx, "grad.energies_and_forces", "batches")
