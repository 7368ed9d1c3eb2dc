"""PyTorch port: the tracing and timing API of `torchani_tpu_torch.profiling`
against the JAX package's `torchani_tpu.profiling`: `Timer`'s report in the
same format from the same totals, `sync` over nested trees, `trace` writing
a trace file that names a `scope`, and `PRINT_AEV_BRANCH` read from the
environment.  Everything runs on the CPU; the CUDA side of `scope` (an NVTX
range) and `sync` (a stream wait) run in `chip_smoke.py` phase 49."""

import importlib
import json
import typing as tp

import numpy as np
import torch

import torchani_tpu.profiling as jprof
import torchani_tpu_torch.profiling as pprof


def test_timer_report_matches_jax():
    ours, theirs = pprof.Timer(), jprof.Timer()
    for t in (ours, theirs):
        t.totals = {"aev": 0.012345, "networks": 0.5, "neighbors": 0.000123}
        t.counts = {"aev": 3, "networks": 10, "neighbors": 1}
    assert ours.report() == theirs.report()
    assert ours.report().splitlines()[0].startswith("networks ")
    assert pprof.Timer().report() == jprof.Timer().report() == ""


def test_timer_sections_and_time_fn():
    timer = pprof.Timer()
    calls = []
    with timer.section("a"):
        calls.append(1)
    with timer.section("a"):
        calls.append(2)
    out = timer.time_fn("mm", lambda x: x @ x, torch.eye(4), iters=5)
    assert calls == [1, 2] and timer.counts == {"a": 2, "mm": 5}
    assert torch.equal(out, torch.eye(4)) and all(v >= 0 for v in timer.totals.values())
    assert "mm" in timer.report() and "x5" in timer.report()


class Pair(tp.NamedTuple):
    energies: torch.Tensor
    extra: tp.Any


def test_sync_returns_nested_trees():
    tree = {"a": torch.ones(2), "b": [Pair(torch.zeros(1), (np.ones(3), "x")), 3.0], "c": None}
    assert pprof.sync(tree) is tree
    assert list(pprof._tensors(tree))[0] is tree["a"]
    assert len(list(pprof._tensors(tree))) == 2
    t = torch.arange(3)
    assert pprof.sync(t) is t


def test_trace_writes_a_file_naming_the_scope(tmp_path):
    with pprof.trace(str(tmp_path / "tr")) as log_dir:
        with pprof.scope("aev_scope_label"):
            torch.randn(64, 64) @ torch.randn(64, 64)
    files = sorted((tmp_path / "tr").glob("*.json"))
    assert log_dir == str(tmp_path / "tr") and len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "aev_scope_label" for e in events)
    assert any("mm" in str(e.get("name", "")) for e in events)


def test_print_aev_branch_from_environment(monkeypatch):
    try:
        for value, want in (("1", True), ("0", False)):
            monkeypatch.setenv("TORCHANI_TPU_PRINT_AEV_BRANCH", value)
            assert importlib.reload(pprof).PRINT_AEV_BRANCH is want
            assert importlib.reload(jprof).PRINT_AEV_BRANCH is want
    finally:
        monkeypatch.delenv("TORCHANI_TPU_PRINT_AEV_BRANCH")
        importlib.reload(pprof)
        importlib.reload(jprof)
