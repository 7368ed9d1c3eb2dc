"""PyTorch port: the legacy data pipeline (`torchani_tpu_torch.legacy_data`)
against the JAX package's, on HDF5 files that the test writes with each
package's `datapacker`: pyanitools groups of one species row shared by
their conformers (chemical symbols), and groups of per-conformer atomic
numbers.

Every comparison is exact (the same numpy operations on the same arrays),
item by item and in order, the shuffle's order too.  Species are compared
by value: the port's indices are int64 where JAX's atomic-number path gives
its default int32.
"""

import numpy as np
import pytest
import torch

import torchani_tpu.legacy_data as jld
import torchani_tpu_torch.legacy_data as pld
from torchani_tpu_torch.arch import simple_ani
from torchani_tpu_torch.testing import make_molecs
from torchani_tpu_torch.training import make_train_step
from torchani_tpu_torch.training.loop import _model_with_networks, energy_force_loss

torch.set_num_threads(2)
SYMBOLS = ("H", "C", "N", "O")
SAES = (-0.5, -37.8, -54.5, -75.0)


def _write(packer_cls, path):
    """Three groups: two legacy ones (a symbol row shared by 3 and 4
    conformers), one of 5 conformers with per-conformer atomic numbers
    (-1 padded)."""
    rng = np.random.RandomState(7)
    packer = packer_cls(path)
    for name, symbols, n in (("gdb01/mol0", ["C", "H", "H", "O"], 3),
                             ("gdb02/mol1", ["N", "H", "H", "H", "C"], 4)):
        packer.store_data(name, species=symbols,
                          coordinates=rng.rand(n, len(symbols), 3).astype(np.float32) * 3,
                          energies=rng.randn(n) - 100.0,
                          forces=rng.randn(n, len(symbols), 3).astype(np.float32))
    sp, co = make_molecs(5, 7, seed=3, znums=(1, 6, 7, 8))
    packer.store_data("gdb03/batch", species=sp, coordinates=co,
                      energies=rng.randn(5) - 200.0,
                      forces=rng.randn(*co.shape).astype(np.float32))
    packer.cleanup()
    return path


def _assert_items_equal(ours, theirs):
    ours, theirs = list(ours), list(theirs)
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        assert sorted(a) == sorted(b)
        for k in a:
            va = a[k].numpy() if isinstance(a[k], torch.Tensor) else a[k]
            if isinstance(va, list):
                assert va == b[k]
            else:
                np.testing.assert_array_equal(np.asarray(va), np.asarray(b[k]))
                assert np.asarray(va).dtype.kind == np.asarray(b[k]).dtype.kind


@pytest.fixture(params=["port", "jax"], ids=["written_by_port", "written_by_jax"])
def h5file(request, tmp_path):
    packer = pld.datapacker if request.param == "port" else jld.datapacker
    return _write(packer, tmp_path / "data.h5")


def test_anidataloader_reads_both_writers(h5file):
    ours, theirs = pld.anidataloader(str(h5file)), jld.anidataloader(str(h5file))
    try:
        _assert_items_equal(ours, theirs)
        assert ours.group_size() == theirs.group_size() == 3
        assert ours.size() == theirs.size() == 3
        first = next(iter(ours))
        assert first["path"] == "/gdb01/mol0" and first["species"] == ["C", "H", "H", "O"]
    finally:
        ours.cleanup()
        theirs.cleanup()
    with pytest.raises(FileNotFoundError):
        pld.anidataloader(str(h5file) + ".missing")


def test_chain_matches_jax_step_by_step(h5file):
    ours, theirs = pld.load(h5file), jld.load(h5file)
    _assert_items_equal(ours, theirs)
    assert len(list(ours)) == 12
    steps = [
        ("species_to_indices", (SYMBOLS,)),
        ("subtract_self_energies", (SAES,)),
        ("shuffle", (3,)),
        ("cache", ()),
    ]
    for name, args in steps:
        ours, theirs = getattr(ours, name)(*args), getattr(theirs, name)(*args)
        _assert_items_equal(ours, theirs)
        assert ours.transforms == theirs.transforms
    assert len(ours) == len(theirs) == 12
    assert list(ours)[0]["energies"].dtype == np.float64
    batches, jbatches = ours.collate(5), theirs.collate(5)
    _assert_items_equal(batches, jbatches)
    assert [b["species"].shape[0] for b in batches] == [5, 5, 2]
    for a, b in zip(ours.split(0.5, None), theirs.split(0.5, None)):
        _assert_items_equal(a, b)
    a, b = ours.split(0.25, 0.25)
    assert len(a) == len(b) == 3
    with pytest.raises(TypeError, match="cache"):
        len(pld.load(h5file))
    # a mapping of self energies, and a directory of files
    _assert_items_equal(
        pld.load(h5file.parent).species_to_indices(SYMBOLS).subtract_self_energies(
            dict(enumerate(SAES))),
        jld.load(h5file.parent).species_to_indices(SYMBOLS).subtract_self_energies(
            dict(enumerate(SAES))))


def test_transformations_static_forms(h5file):
    items = list(jld.load(h5file))
    adapter = pld.IterableAdapter(lambda: iter(items))
    jadapter = jld.IterableAdapter(lambda: iter(items))
    T, J = pld.Transformations, jld.Transformations
    ours = T.cache(T.shuffle(T.subtract_self_energies(T.species_to_indices(adapter, SYMBOLS),
                                                      SAES), 1))
    theirs = J.cache(J.shuffle(J.subtract_self_energies(J.species_to_indices(jadapter, SYMBOLS),
                                                        SAES), 1))
    _assert_items_equal(ours, theirs)
    # collate's padding is ignored in both: the ANI padding values apply
    _assert_items_equal(T.collate(ours, 4, padding={"species": -7}), J.collate(theirs, 4))
    assert int(next(iter(T.collate(ours, 12)))["species"].min()) == -1
    sized = pld.IterableAdapterWithLength(lambda: iter(items), len(items))
    assert len(sized) == len(jld.IterableAdapterWithLength(lambda: iter(items), len(items))) == 12
    _assert_items_equal(sized, items)


def test_collate_fn_and_stack_with_padding():
    samples = [
        {"species": np.array([1, 6, 8]), "coordinates": np.ones((3, 3), np.float32),
         "energies": np.float64(2.0)},
        {"species": np.array([8]), "coordinates": np.full((1, 3), 2.0, np.float32),
         "energies": np.float64(1.0)},
    ]
    ours, theirs = pld.collate_fn(samples), jld.collate_fn(samples)
    _assert_items_equal([ours], [theirs])
    np.testing.assert_array_equal(ours["species"], [[1, 6, 8], [8, -1, -1]])
    pad = {"species": -5, "coordinates": 9.0}
    _assert_items_equal([pld.stack_with_padding(samples, pad)],
                        [jld.stack_with_padding(samples, pad)])
    _assert_items_equal([pld.collate_fn(samples, pad)], [jld.collate_fn(samples, pad)])


def test_pin_memory_needs_cuda(monkeypatch, h5file):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    batches = pld.load(h5file).species_to_indices(SYMBOLS).cache().collate(4)
    with pytest.raises(RuntimeError, match="CUDA"):
        pld.Transformations.pin_memory(batches)


def test_collated_batches_feed_training(h5file):
    """The chain's batches (element indices) into the port's force-training
    step on the CPU: each step's loss is the batch's loss before it."""
    batches = list(pld.load(h5file).species_to_indices(SYMBOLS).subtract_self_energies(SAES)
                   .shuffle(0).cache().collate(6))
    model = simple_ani(SYMBOLS, seed=1, device="cpu")
    model.energy_shifter.enabled = False
    model.periodic_table_index = False
    init, step = make_train_step(model, torch.optim.Adam, force_training=True)
    state = init()
    for b in batches:
        want = float(energy_force_loss(
            _model_with_networks(model, state.networks), b["species"], b["coordinates"],
            b["energies"], b["forces"]).detach())
        state, met = step(state, b)
        assert abs(float(met["loss"]) - want) <= 1e-6 * abs(want)
    assert state.step == len(batches) == 2
