"""The readers of the program's spans on a synthetic span table, the None
cases (no table, no unit span, no device intervals), and every new metric
read through the harness."""

import json
import types
from pathlib import Path

import pytest

from benchmark import harness, span_readers

ROOT = Path(__file__).resolve().parents[2]
WORK = {"steps": 10.0, "batches": 2.0}
TABLE = {
    "md.step": dict(count=10, host_s=0.050, self_s=0.001, wait_s=0.004, device_s=0.300),
    "md.rebuild": dict(count=1, host_s=0.003, self_s=0.001, wait_s=0.001, device_s=0.012),
    "nnp.networks": dict(count=10, host_s=0.010, self_s=0.010, wait_s=0.0, device_s=0.090),
}


def context() -> types.SimpleNamespace:
    return types.SimpleNamespace(trace=types.SimpleNamespace(work=WORK))


@pytest.fixture
def table(monkeypatch):
    from torchani_tpu_torch import profiling

    current = {"table": TABLE}
    monkeypatch.setattr(profiling, "span_table", lambda: current["table"])
    return current


def test_readers(table):
    ctx = context()
    assert span_readers.host_ms(ctx, "md.step", "steps") == pytest.approx(4.6)
    assert span_readers.wait_ms(ctx, "md.step", "steps") == pytest.approx(0.4)
    assert span_readers.device_ms(ctx, "md.rebuild", "md.step", "steps") == pytest.approx(1.2)
    assert span_readers.device_ms(ctx, "nnp.networks", "md.step", "batches") == pytest.approx(45.0)
    # the unit ran and the layer never did: no time
    assert span_readers.device_ms(ctx, "neighbors", "md.step", "steps") == 0.0


def test_none_without_spans(table, monkeypatch):
    ctx = context()
    for unit_span in ("train.step", "grad.energies_and_forces"):
        assert span_readers.host_ms(ctx, unit_span, "steps") is None
        assert span_readers.wait_ms(ctx, unit_span, "steps") is None
        assert span_readers.device_ms(ctx, "nnp.networks", unit_span, "steps") is None
    # spans recorded on the CPU have no device interval
    table["table"] = {k: dict(v, device_s=None) for k, v in TABLE.items()}
    assert span_readers.device_ms(ctx, "nnp.networks", "md.step", "steps") is None
    assert span_readers.device_ms(ctx, "neighbors", "md.step", "steps") is None
    assert span_readers.host_ms(ctx, "md.step", "steps") == pytest.approx(4.6)
    # a program that keeps no span table (the parent of the spans)
    from torchani_tpu_torch import profiling

    monkeypatch.delattr(profiling, "span_table")
    assert span_readers.span_table() is None
    assert span_readers.host_ms(ctx, "md.step", "steps") is None
    assert span_readers.device_ms(ctx, "md.rebuild", "md.step", "steps") is None


def test_span_metrics_through_the_harness(table):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    spans = [m for m in bench["per_layer"] if m["source"] == "program_span"]
    assert len(spans) == 11
    md = {m["name"]: harness.reader(m["name"])(context()) for m in spans
          if m["workloads"] == ["ani2x-md-water59k"]}
    assert md == pytest.approx({"host_ms_per_step.md": 4.6, "wait_ms_per_step.md": 0.4,
                                "rebuild_ms_per_step.md": 1.2, "networks_ms_per_step.md": 9.0})
    for m in spans:
        if m["workloads"] != ["ani2x-md-water59k"]:
            assert harness.reader(m["name"])(context()) is None
