"""What the per-layer metrics that read the program's own spans share.

The program records spans (`torchani_tpu_torch.profiling.scope`) only while
a profiler runs, so in a ``--trace 1`` run they cover the traced window's
units and nothing else.  Each reader takes the totals by span name that
``profiling.span_table()`` gives after that window and divides by the
window's units (``ctx.trace.work[unit]``, as `readers` does).  A unit span
is the program's span around one unit (``md.step``, ``train.step``,
``grad.energies_and_forces``); its ``wait_s`` is the host time in the wait
spans inside it.  Where the program keeps no span table, or recorded no
unit span, a reader returns None and the metric is left out of the result
line.
"""

import typing as tp


def span_table() -> tp.Optional[tp.Dict[str, dict]]:
    """The program's span totals, or None where it keeps none."""
    from torchani_tpu_torch import profiling

    read = getattr(profiling, "span_table", None)
    return None if read is None else read()


def _unit_row(unit_span: str) -> tp.Tuple[tp.Optional[dict], tp.Optional[dict]]:
    table = span_table()
    return table, (None if table is None else table.get(unit_span))


def host_ms(ctx, unit_span: str, unit: str) -> tp.Optional[float]:
    """Host milliseconds per ``unit`` inside ``unit_span``, less its waits
    for the device: the time the host takes to issue the unit's work."""
    _, row = _unit_row(unit_span)
    if row is None:
        return None
    return 1e3 * (row["host_s"] - row["wait_s"]) / ctx.trace.work[unit]


def wait_ms(ctx, unit_span: str, unit: str) -> tp.Optional[float]:
    """Host milliseconds per ``unit`` spent in wait spans inside
    ``unit_span``."""
    _, row = _unit_row(unit_span)
    if row is None:
        return None
    return 1e3 * row["wait_s"] / ctx.trace.work[unit]


def device_ms(ctx, span: str, unit_span: str, unit: str) -> tp.Optional[float]:
    """Milliseconds per ``unit`` between the device timing events of
    ``span``: 0 where the unit span ran on a card and ``span`` never did (a
    stretch without a rebuild), None where the unit span did not run on
    one."""
    table, row = _unit_row(unit_span)
    if row is None or row["device_s"] is None:
        return None
    seconds = table.get(span, {"device_s": 0.0})["device_s"]
    return 1e3 * (seconds or 0.0) / ctx.trace.work[unit]
