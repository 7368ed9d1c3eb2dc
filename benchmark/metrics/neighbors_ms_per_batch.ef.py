"""Device milliseconds per E+F batch between the timing events of the neighbor table (all_pairs)."""

from benchmark import span_readers


def read(ctx):
    return span_readers.device_ms(ctx, "neighbors", "grad.energies_and_forces", "batches")
