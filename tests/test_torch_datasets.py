"""PyTorch port: the dataset stack (`torchani_tpu_torch.datasets`), the
transforms, the SAE fits and ``cli data`` against the JAX package's, on the
CPU.

Stores: a round trip through each backend, and Zarr, HDF5 and Parquet
stores written by one package read by the other, arrays equal, with the
md5 sidecar of one verified by the other.  Append, delete, regrouping by
formula and by atom count, backend conversion and the union of several
files equal to JAX's.  `Batcher` batches (with and without
``density_cutoff``), `batch_all_in_ram` and `create_batched_dataset`'s
files bitwise equal to JAX's from the same seeds.  Transforms: element
indices and SAE subtraction equal (the SAE's f32 per-atom sum to 1e-5 Ha,
a few ulps of ~100 Ha sums), the xTB and D3 subtractions to 1e-6 Ha and
Ha/A.  `exact_saes` and `approx_saes` equal to JAX's to 1e-10; both
filters flag JAX's conformers (the energy filter over bridged models).
``cli data`` as ``tests/test_datasets.py::test_cli_data_verify`` expects,
and ls/info/pack/rm/clean/convert against JAX's output.
"""

import json

import jax
import numpy as np
import pytest
import torch

import torchani_tpu as tt
import torchani_tpu.datasets as jds
import torchani_tpu.sae_estimation as jsae
import torchani_tpu.transforms as jtf
from torchani_tpu.cli import main as jcli
from torchani_tpu_torch import datasets as pds
from torchani_tpu_torch import sae_estimation as psae
from torchani_tpu_torch import transforms as ptf
from torchani_tpu_torch.arch import simple_ani
from torchani_tpu_torch.cli import main as pcli
from torchani_tpu_torch.datasets.filters import filter_by_high_energy_error, filter_by_high_force
from torchani_tpu_torch.interop import load_jax_arrays
from torchani_tpu_torch.testing import make_chain_molecs

torch.set_num_threads(2)
CPU = "cpu"
SUFFIX = {"hdf5": "h5", "parquet": "pq", "zarr": "zarr"}


def _fill(ds, n_groups=3, seed=0):
    rng = np.random.RandomState(seed)
    for gi in range(n_groups):
        n, a = 5 + gi, 4 + gi
        ds.append_conformers(f"group{gi}", {
            "species": rng.choice([1, 6, 7, 8], size=(n, a)),
            "coordinates": rng.rand(n, a, 3).astype(np.float32) * 4,
            "energies": rng.randn(n).astype(np.float64),
            "forces": rng.randn(n, a, 3).astype(np.float32),
        })
    return ds


def _location(tmp_path, backend, name="ds"):
    return None if backend == "memory" else tmp_path / f"{name}.{SUFFIX[backend]}"


def _assert_same(a, b):
    assert sorted(a.keys()) == sorted(b.keys())
    for k in a.keys():
        ga, gb = a[k], b[k]
        assert sorted(ga) == sorted(gb), k
        for prop in ga:
            assert np.asarray(ga[prop]).dtype == np.asarray(gb[prop]).dtype, (k, prop)
            np.testing.assert_array_equal(np.asarray(ga[prop]), np.asarray(gb[prop]))


def _assert_batches_equal(pb, jb):
    assert len(pb) == len(jb)
    for x, y in zip(pb, jb):
        assert sorted(x) == sorted(y)
        for k in x:
            assert np.asarray(x[k]).dtype == np.asarray(y[k]).dtype, k
            np.testing.assert_array_equal(np.asarray(x[k]), np.asarray(y[k]))


@pytest.mark.parametrize("backend", ["memory", "hdf5", "parquet", "zarr"])
def test_store_roundtrip_matches_jax(tmp_path, backend):
    p = _fill(pds.ANIDataset(_location(tmp_path, backend, "p"), backend=backend))
    j = _fill(jds.ANIDataset(_location(tmp_path, backend, "j"), backend=backend))
    assert len(p) == 3 and p.num_conformers == 5 + 6 + 7
    assert p.properties == j.properties and p.group_sizes() == j.group_sizes()
    _assert_same(p, j)


@pytest.mark.parametrize("backend", ["hdf5", "parquet", "zarr"])
def test_stores_cross_read_and_checksums(tmp_path, backend):
    """A store written by JAX reads in the port and back; each package
    verifies the other's md5 manifest and flags a corrupted byte."""
    jloc, ploc = _location(tmp_path, backend, "j"), _location(tmp_path, backend, "p")
    _fill(jds.ANIDataset(jloc), seed=1).store.set_metadata({"grouping": "by_name"})
    _fill(pds.ANIDataset(ploc), seed=1).store.set_metadata({"grouping": "by_name"})
    _assert_same(pds.ANIDataset(jloc), jds.ANIDataset(jloc))
    _assert_same(jds.ANIDataset(ploc), pds.ANIDataset(ploc))
    assert pds.ANIDataset(jloc).store.get_metadata() == jds.ANIDataset(jloc).store.get_metadata()
    sums = jds.ANIDataset(jloc).record_checksums()
    assert pds.ANIDataset(jloc).verify_checksums()["ok"]
    assert pds.ANIDataset(ploc).record_checksums().keys() == {
        k.replace("j.", "p.", 1) for k in sums
    }
    assert jds.ANIDataset(ploc).verify_checksums()["ok"]
    victim = pds.ANIDataset(ploc).store.files()[0]
    raw = bytearray(victim.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    victim.write_bytes(bytes(raw))
    for pkg in (pds, jds):
        report = pkg.ANIDataset(ploc).verify_checksums()
        assert not report["ok"] and report["mismatched"]


def test_append_delete_regroup_convert_match_jax(tmp_path):
    p, j = _fill(pds.ANIDataset()), _fill(jds.ANIDataset())
    rng = np.random.RandomState(1)
    extra = {
        "species": rng.choice([1, 6], size=(2, 4)),
        "coordinates": rng.rand(2, 4, 3).astype(np.float32),
        "energies": rng.randn(2),
        "forces": rng.randn(2, 4, 3).astype(np.float32),
    }
    for ds in (p, j):
        ds.append_conformers("group0", extra)
        ds.delete_conformers("group0", np.array([0, 3]))
        ds.delete_conformers("group1")
    assert "group1" not in p and p.num_conformers == j.num_conformers == 5 + 2 - 2 + 7
    _assert_same(p, j)
    _assert_same(p.to_backend(tmp_path / "conv.zarr"), j)
    for regroup in ("regroup_by_formula", "regroup_by_num_atoms"):
        p2, j2 = _fill(pds.ANIDataset(), seed=3), _fill(jds.ANIDataset(), seed=3)
        getattr(p2, regroup)()
        getattr(j2, regroup)()
        _assert_same(p2, j2)
        assert p2.grouping == j2.grouping
    for fname, gname, z in (("a.zarr", "water", [8, 1, 1]), ("b.zarr", "methane", [6, 1, 1, 1, 1])):
        one = jds.ANIDataset(tmp_path / fname)
        one.append_conformers(gname, {"species": np.tile(z, (4, 1)),
                                      "coordinates": rng.rand(4, len(z), 3).astype(np.float32)})
    locs = [tmp_path / "a.zarr", tmp_path / "b.zarr"]
    assert pds.ANIDataset(locs).keys() == jds.ANIDataset(locs).keys() == ["a/water", "b/methane"]
    _assert_same(pds.concatenate(pds.ANIDataset(locs), tmp_path / "c.h5"),
                 jds.concatenate(jds.ANIDataset(locs), tmp_path / "cj.h5"))


@pytest.mark.parametrize("density_cutoff", [None, 3.5])
def test_batcher_bitwise_equal_to_jax(tmp_path, density_cutoff):
    p, j = pds.ANIDataset(), jds.ANIDataset()
    for ds in (p, j):
        for gi, seed in enumerate((3, 4)):
            sp, co = make_chain_molecs(24, 10 + 2 * gi, seed=seed)
            rng = np.random.RandomState(seed)
            ds.append_conformers(f"g{gi}", {
                "species": sp, "coordinates": co, "energies": rng.randn(24) - 40,
                "forces": rng.randn(24, sp.shape[1], 3).astype(np.float32) * 0.01,
            })
    splits = {"training": 0.75, "validation": 0.25}
    pdiv = pds.Batcher(rng_seed=5).divide(p, splits)
    jdiv = jds.Batcher(rng_seed=5).divide(j, splits)
    assert pdiv == jdiv
    assert pds.Batcher(rng_seed=5).divide(p, folds=3) == jds.Batcher(rng_seed=5).divide(j, folds=3)
    for name in pdiv:
        pb = pds.Batcher(rng_seed=5).gather_batches(p, pdiv[name], 8, density_cutoff=density_cutoff,
                                                    pad_molecules=True)
        jb = jds.Batcher(rng_seed=5).gather_batches(j, jdiv[name], 8, density_cutoff=density_cutoff,
                                                    pad_molecules=True)
        _assert_batches_equal(pb, jb)
        if density_cutoff is not None:
            caps = [int(b["angular_capacity"]) for b in pb]
            assert caps == sorted(caps)
    pdest = pds.create_batched_dataset(p, tmp_path / "pb", batch_size=8, rng_seed=2,
                                       density_cutoff=density_cutoff)
    jdest = jds.create_batched_dataset(j, tmp_path / "jb", batch_size=8, rng_seed=2,
                                       density_cutoff=density_cutoff)
    assert (json.loads((pdest / "creation_log.json").read_text())
            == json.loads((jdest / "creation_log.json").read_text()))
    for div in ("training", "validation"):
        pread = pds.ANIBatchedDataset(pdest, div)
        _assert_batches_equal(list(pread), list(jds.ANIBatchedDataset(jdest, div)))
        _assert_batches_equal(list(pread.cache()), list(pread))
        _assert_batches_equal(list(pread.shuffled(1)),
                              list(jds.ANIBatchedDataset(jdest, div).shuffled(1)))


def test_batch_all_in_ram_shapes():
    p, j = _fill(pds.ANIDataset()), _fill(jds.ANIDataset())
    pdivs = pds.batch_all_in_ram(p, batch_size=4, rng_seed=3)
    jdivs = jds.batch_all_in_ram(j, batch_size=4, rng_seed=3)
    total = sum(b["species"].shape[0] for div in pdivs.values() for b in div)
    assert total == p.num_conformers
    for name, div in pdivs.items():
        for batch in div:
            c, a = batch["species"].shape
            assert batch["coordinates"].shape == (c, a, 3)
        _assert_batches_equal(list(div), list(jdivs[name]))
        _assert_batches_equal(list(div.shuffled(4)), list(jdivs[name].shuffled(4)))
        assert div.cache() is div


def _chain_batch(num=6, atoms=10, seed=2):
    sp, co = make_chain_molecs(num, atoms, seed=seed)
    rng = np.random.RandomState(seed)
    return {"species": sp, "coordinates": co, "energies": rng.randn(num) - 40.0,
            "forces": rng.randn(num, atoms, 3).astype(np.float32) * 0.01}


def test_transforms_match_jax():
    symbols = ("H", "C", "N", "O")
    saes = [-0.5, -37.8, -54.6, -75.0]
    batch = _chain_batch()
    p = ptf.AtomicNumbersToIndices(symbols)(batch)
    j = jtf.AtomicNumbersToIndices(symbols)(batch)
    assert p["species"].dtype == j["species"].dtype
    np.testing.assert_array_equal(p["species"], j["species"])
    for species_key in (batch, p):  # atomic numbers and element indices
        ps = ptf.SubtractSAE(symbols, saes, device=CPU)(species_key)
        js = jtf.SubtractSAE(symbols, saes)(species_key)
        np.testing.assert_allclose(ps["energies"], js["energies"], rtol=0, atol=1e-5)
    pc = ptf.Compose([ptf.Identity(), ptf.SubtractSAE(symbols, saes, device=CPU),
                      ptf.AtomicNumbersToIndices(symbols)])(batch)
    jc = jtf.Compose([jtf.Identity(), jtf.SubtractSAE(symbols, saes),
                      jtf.AtomicNumbersToIndices(symbols)])(batch)
    np.testing.assert_array_equal(pc["species"], jc["species"])
    np.testing.assert_allclose(pc["energies"], jc["energies"], atol=1e-5)
    for pt, jt in (
        (ptf.SubtractRepulsionXTB(symbols, device=CPU), jtf.SubtractRepulsionXTB(symbols)),
        (ptf.SubtractTwoBodyDispersionD3(symbols, "wb97x", device=CPU),
         jtf.SubtractTwoBodyDispersionD3(symbols, "wb97x")),
    ):
        po, jo = pt(batch), jt(batch)
        assert np.abs(po["energies"] - batch["energies"]).max() > 1e-6
        np.testing.assert_allclose(po["energies"], jo["energies"], rtol=0, atol=1e-6)
        np.testing.assert_allclose(po["forces"], jo["forces"], rtol=0, atol=1e-6)
    no_forces = {k: v for k, v in batch.items() if k != "forces"}
    out = ptf.SubtractRepulsionXTB(symbols, device=CPU)(no_forces)
    assert "forces" not in out
    assert ptf.identity(batch) is batch


def test_sae_fits_match_jax():
    rng = np.random.RandomState(0)
    true_saes = np.array([-0.5, -37.8, -54.6, -75.0])
    batches = []
    for _ in range(10):
        species = rng.randint(-1, 4, size=(16, 6))
        counts = np.stack([(species == s).sum(1) for s in range(4)], 1)
        batches.append({"species": species, "energies": counts @ true_saes + rng.randn(16) * 1e-6})
    for intercept in (False, True):
        (pf, pi), (jf, ji) = (m.exact_saes(batches, 4, fit_intercept=intercept)
                              for m in (psae, jsae))
        np.testing.assert_allclose(pf, jf, rtol=0, atol=1e-10)
        assert abs(pi - ji) <= 1e-10
    np.testing.assert_allclose(psae.exact_saes(batches, 4)[0], true_saes, atol=1e-4)
    np.testing.assert_allclose(psae.approx_saes(batches, 4, lr=0.05, epochs=3),
                               jsae.approx_saes(batches, 4, lr=0.05, epochs=3),
                               rtol=0, atol=1e-10)


def test_filters_match_jax():
    from torchani_tpu.datasets.filters import (
        filter_by_high_energy_error as jfilter_e,
        filter_by_high_force as jfilter_f,
    )

    p, j = _fill(pds.ANIDataset()), _fill(jds.ANIDataset())
    for ds in (p, j):
        g = ds["group0"]
        g["forces"][2] = 100.0
        ds.store.put("group0", g)
    assert filter_by_high_force(p, threshold=2.5) == jfilter_f(j, threshold=2.5)
    flagged = filter_by_high_force(p, threshold=50.0, delete=True)
    jfilter_f(j, threshold=50.0, delete=True)
    assert ("group0", 2) in flagged
    _assert_same(p, j)

    jmodel = tt.simple_ani(("H", "C", "N", "O"), key=jax.random.PRNGKey(2))
    pmodel = simple_ani(("H", "C", "N", "O"), device=CPU)
    load_jax_arrays(pmodel, {jax.tree_util.keystr(k): np.asarray(x)
                             for k, x in jax.tree_util.tree_flatten_with_path(jmodel)[0]})
    pe, je = pds.ANIDataset(), jds.ANIDataset()
    sp, co = make_chain_molecs(12, 8, seed=4)
    with torch.no_grad():
        model_e = pmodel(sp, co).numpy().astype(np.float64)
    offsets = np.where(np.arange(12) % 3 == 0, 0.5, 0.01)
    for ds in (pe, je):
        ds.append_conformers("g", {"species": sp, "coordinates": co, "energies": model_e + offsets})
    flagged = filter_by_high_energy_error(pe, pmodel, threshold=0.1, max_batch=5)
    assert flagged == jfilter_e(je, jax.jit(lambda s_, c_: jmodel(s_, c_)), threshold=0.1)
    assert flagged == [("g", i) for i in range(0, 12, 3)]
    filter_by_high_energy_error(pe, pmodel, threshold=0.1, delete=True)
    assert pe.num_conformers == 8


def test_cli_data_commands(tmp_path, capsys):
    """``data verify`` as tests/test_datasets.py::test_cli_data_verify
    expects; ls, info, pack, clean, rm and convert print JAX's lines and
    write JAX's files."""
    loc = tmp_path / "ds.h5"
    _fill(pds.ANIDataset(loc))
    pcli(["data", "verify", str(loc), "--record"])
    pcli(["data", "verify", str(loc)])
    assert "integrity ok" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        pcli(["data", "verify", str(tmp_path / "nope.h5")])
    capsys.readouterr()
    for argv in (["ls"], ["info"]):
        pcli(["data"] + argv + [str(loc)])
        mine = capsys.readouterr().out
        jcli(["data"] + argv + [str(loc)])
        assert mine == capsys.readouterr().out
    pcli(["data", "pack", str(loc), str(tmp_path / "pp"), "--batch-size", "4", "--seed", "3"])
    jcli(["data", "pack", str(loc), str(tmp_path / "jp"), "--batch-size", "4", "--seed", "3"])
    for div in ("training", "validation"):
        _assert_batches_equal(list(pds.ANIBatchedDataset(tmp_path / "pp", div)),
                              list(jds.ANIBatchedDataset(tmp_path / "jp", div)))
    g = pds.ANIDataset(loc)["group1"]
    g["energies"][1] = np.nan
    pds.ANIDataset(loc).store.put("group1", g)
    capsys.readouterr()
    pcli(["data", "clean", str(loc)])
    out = capsys.readouterr().out
    assert "group1: removed 1/6" in out and "refreshed md5 manifest" in out
    pcli(["data", "verify", str(loc)])
    pcli(["data", "rm", str(loc), "group2"])
    assert "deleted group group2" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        pcli(["data", "rm", str(loc), "group9"])
    pcli(["data", "convert", str(loc), str(tmp_path / "conv.zarr")])
    assert capsys.readouterr().out == f"wrote {tmp_path / 'conv.zarr'}\n"
    _assert_same(jds.ANIDataset(tmp_path / "conv.zarr"), jds.ANIDataset(loc))
    from torchani_tpu_torch import cli

    cli.data_ls(loc)
    assert capsys.readouterr().out == "group0\t5\ngroup1\t5\n"
    with pytest.raises(RuntimeError, match="downloads nothing"):
        cli.data_pull("ANI1x")


def test_builtin_datasets(tmp_path):
    """The synthetic datasets equal JAX's; the downloading ones raise when
    their file is absent."""
    for name in ("TestData", "TestDataForcesDipoles", "TestDataIons"):
        (tmp_path / "p" / name).mkdir(parents=True)
        (tmp_path / "j" / name).mkdir(parents=True)
        _assert_same(getattr(pds, name)(root=tmp_path / "p" / name, num_conformers=10),
                     getattr(jds, name)(root=tmp_path / "j" / name, num_conformers=10))
    assert pds.builtin.available_datasets() == jds.builtin.available_datasets()
    for name in ("ANI1x", "ANI1ccx", "ANI2x", "COMP6v1", "COMP6v2", "ANI1e", "ANI1q",
                 "ANI2qHeavy", "IonsLight", "IonsHeavy", "IonsVeryHeavy"):
        with pytest.raises(FileNotFoundError, match="downloads"):
            getattr(pds, name)(root=tmp_path)
    with pytest.raises(ValueError, match="Unknown dataset"):
        pds.builtin.builtin_dataset("nope")
    assert [e.value for e in pds._DatasetId] == [e.value for e in jds._DatasetId]
