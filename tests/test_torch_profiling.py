"""PyTorch port: the tracing and timing API of `torchani_tpu_torch.profiling`.

`Timer`'s report against the JAX package's `torchani_tpu.profiling` (same
format from the same totals), `sync` over nested trees, `trace` writing a
trace file that names a `scope`; then the port's spans: off (no profiler)
a shared null context that records nothing, on (a CPU ``torch.profiler``)
the spans of an NVE stretch, an E+F call and a force-training step, each
under its parent and unit, with `span_table`'s totals.  The device side of
a span (its CUDA timing events) and `sync`'s stream wait run on the card
(`chip_smoke.py` phase 49, the benchmark's ``--trace 1`` runs)."""

import functools
import json
import typing as tp

import numpy as np
import pytest
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


# ---- the port's spans ----

#: each span of the three paths, by the span it opens in (None: a unit)
MD_PARENTS = {
    "md.step": None, "md.integrate": "md.step", "md.rebuild_check": "md.step",
    "md.rebuild": "md.step", "neighbors.cell_inverse": "md.rebuild",
    "utils.cell_inverse": "md.rebuild", "md.forces": "md.step", "md.refresh": "md.forces",
    "potential.nnp": "md.forces", "nnp.aev": "potential.nnp",
    "nnp.networks": "potential.nnp", "md.backward": "md.forces",
}
EF_PARENTS = {
    "grad.energies_and_forces": None, "arch.copy_in": "grad.energies_and_forces",
    "neighbors": "grad.energies_and_forces",
    "potential.nnp": "grad.energies_and_forces", "nnp.aev": "potential.nnp",
    "aev.present_species": "nnp.aev", "nnp.networks": "potential.nnp",
    "nn.present_species": "nnp.networks", "nn.species_rows": "nnp.networks",
    "grad.backward": "grad.energies_and_forces",
}
TRAIN_PARENTS = dict(
    {k: ("train.step" if v == "grad.energies_and_forces" else v)
     for k, v in EF_PARENTS.items() if k not in ("grad.energies_and_forces", "arch.copy_in")},
    **{"train.step": None, "train.batch": "train.step", "train.backward": "train.step",
       "train.optimizer": "train.step"},
)
WAITS = {"md.rebuild_check", "neighbors.cell_inverse", "utils.cell_inverse", "arch.copy_in",
         "aev.present_species", "nn.present_species", "nn.species_rows"}


@pytest.fixture(scope="module")
def ani2x():
    from torchani_tpu_torch.models import ANI2x

    return ANI2x(model_index=0, device="cpu")


def _nve_stretch(model):
    from torchani_tpu_torch.md import MolecularDynamics
    from torchani_tpu_torch.testing import make_water_box

    species, coords, cell = make_water_box(150, density_molec_per_a3=0.008)
    md = MolecularDynamics(model, species, cell=cell, pbc=True, skin=0.6, device="cpu")
    state = md.init(coords, temperature=300.0)
    # a reference far from the coordinates: the first step's check rebuilds
    state = state.replace(ref_coords=state.ref_coords + 5.0)
    return lambda: md.run_nve(state, 2)


def _molecules(n: int = 3):
    from torchani_tpu_torch.testing import make_chain_molecs

    return make_chain_molecs(n, 12, seed=1, znums=(1, 6, 8))


def _ef_call(model):
    from torchani_tpu_torch.grad import energies_and_forces

    species, coords = _molecules()
    return lambda: energies_and_forces(model, species, coords)


def _train_step(model):
    from torchani_tpu_torch.training import make_train_step

    species, coords = _molecules()
    init_fn, step_fn = make_train_step(
        model, functools.partial(torch.optim.AdamW, lr=1e-3), force_training=True)
    batch = {"species": species, "coordinates": coords,
             "energies": np.zeros(len(species), np.float32),
             "forces": np.zeros(coords.shape, np.float32)}
    return lambda: step_fn(init_fn(), batch)


def test_scope_off_records_nothing(monkeypatch):
    labels = []
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        lambda name: labels.append(name))
    pprof.reset()
    assert pprof.scope("md.step") is pprof.scope("nn.species_rows", wait=True)
    with pprof.scope("md.step"):
        with pprof.scope("md.rebuild_check", wait=True):
            torch.ones(3).sum()
    assert labels == [] and pprof.spans() == [] and pprof.span_table() == {}


@pytest.mark.parametrize("path", ["md", "ef", "train"])
def test_spans_of_each_path(path, ani2x):
    make, parents, unit = {
        "md": (_nve_stretch, MD_PARENTS, "md.step"),
        "ef": (_ef_call, EF_PARENTS, "grad.energies_and_forces"),
        "train": (_train_step, TRAIN_PARENTS, "train.step"),
    }[path]
    run = make(ani2x)
    pprof.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        run()
    recorded = pprof.spans()
    by_id = {s.id: s for s in recorded}
    assert {s.name for s in recorded} == set(parents)
    for s in recorded:
        parent = by_id.get(s.parent)
        assert (parent and parent.name) == parents[s.name], s.name
        assert by_id[s.unit].name == unit and (s.parent is not None or s.unit == s.id)
        assert s.wait == (s.name in WAITS) and s.end_ns >= s.start_ns and s.events is None
    table = pprof.span_table()
    assert all(row["self_s"] >= 0 and row["device_s"] is None for row in table.values())
    named = {e.key for e in prof.key_averages()}
    assert set(parents) <= named
    if path == "md":
        assert table["md.step"]["count"] == 2 and table["md.rebuild"]["count"] == 1
        assert table["md.rebuild_check"]["count"] == 2
        waits = ("md.rebuild_check", "neighbors.cell_inverse", "utils.cell_inverse")
        assert table["md.step"]["wait_s"] == pytest.approx(
            sum(table[w]["host_s"] for w in waits), abs=1e-12)
    pprof.reset()


def test_span_table_totals():
    pprof.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(2):
            with pprof.scope("unit"):
                with pprof.scope("wait.a", wait=True):
                    with pprof.scope("inner wait", wait=True):
                        pass
                with pprof.scope("layer"):
                    with pprof.scope("wait.b", wait=True):
                        pass
    host = {}
    for s in pprof.spans():
        host[s.name] = host.get(s.name, 0.0) + (s.end_ns - s.start_ns) * 1e-9
    table = pprof.span_table()
    assert {k: r["count"] for k, r in table.items()} == {
        "unit": 2, "wait.a": 2, "inner wait": 2, "layer": 2, "wait.b": 2}
    for name, row in table.items():
        assert row["host_s"] == pytest.approx(host[name], abs=1e-12)
    unit, layer = table["unit"], table["layer"]
    assert unit["self_s"] == pytest.approx(unit["host_s"] - host["wait.a"] - host["layer"])
    # the inner wait is inside a wait: counted once
    assert unit["wait_s"] == pytest.approx(host["wait.a"] + host["wait.b"])
    assert table["wait.a"]["wait_s"] == pytest.approx(host["wait.a"])
    assert layer["wait_s"] == pytest.approx(host["wait.b"])
    assert layer["self_s"] == pytest.approx(host["layer"] - host["wait.b"])
    pprof.reset()
    assert pprof.span_table() == {}


def test_trace_names_the_program_spans(tmp_path, ani2x):
    run = _ef_call(ani2x)
    with pprof.trace(str(tmp_path)):
        run()
    (path,) = tmp_path.glob("*.json")
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert set(EF_PARENTS) <= names
    assert pprof.span_table()["grad.energies_and_forces"]["count"] == 1
    pprof.reset()
