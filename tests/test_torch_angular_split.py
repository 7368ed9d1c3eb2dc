"""PyTorch port: the count-class angular split (`AEVComputer.angular_split`,
set by `MolecularDynamics.init`) against the JAX package, on the CPU.

The split that the port's `MolecularDynamics` picks on a 2,049-atom water
box equals the JAX package's, and the weight bridge carries it; the plain path with a
split gives the unsplit AEVs within atol 1e-6 (f32 sums over the same
lanes in another order) and JAX's split AEVs on the same table within
``tests/test_torch_aev.py``'s atol 1e-5, rtol 1e-4 (the two plain paths
sum in other orders), and poisons the angular AEV with NaN when the counts
outgrow it, in both packages; forces with and without the split agree
within 1e-5 Ha/A.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchani_tpu as tt
from torchani_tpu.aev import AEVComputer as JAEVComputer
from torchani_tpu.md import MolecularDynamics as JMolecularDynamics
from torchani_tpu.neighbors import Neighbors as JNeighbors
from torchani_tpu_torch.aev import AEVComputer
from torchani_tpu_torch.arch import simple_ani
from torchani_tpu_torch.interop import load_jax_arrays
from torchani_tpu_torch.md import MolecularDynamics, choose_angular_split
from torchani_tpu_torch.neighbors import cell_list
from torchani_tpu_torch.testing import make_molecs, make_water_box

torch.set_num_threads(2)
CPU = "cpu"
AEV_ATOL = 1e-6
#: port against JAX, as tests/test_torch_aev.py
JAX_ATOL, JAX_RTOL = 1e-5, 1e-4


def _leaves(tree):
    return {
        jax.tree_util.keystr(p): np.asarray(x)
        for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


@pytest.fixture(scope="module")
def big_box():
    """2,049 atoms (683 waters) at liquid density: the size from which the
    `MolecularDynamics` classes of both packages measure a split."""
    return make_water_box(2049)


def test_md_picks_the_jax_split(big_box):
    species, coords, cell = big_box
    jmodel = tt.simple_ani(("H", "O"), ensemble_size=1, cutoff_fn="cosine")
    jmd = JMolecularDynamics(jmodel, species, cell=cell, pbc=True)
    jmd.init(coords)
    jsplit = jmd.model.aev_computer.angular_split
    pmodel = load_jax_arrays(simple_ani(("H", "O"), cutoff_fn="cosine", device=CPU),
                             _leaves(jmodel))
    pmd = MolecularDynamics(pmodel, species, cell=cell, pbc=True, device=CPU)
    start = pmd.init(coords)
    assert pmd.capacity == jmd.capacity
    assert jsplit is not None
    assert pmd.model.aev_computer.angular_split == tuple(jsplit)
    # the caller's model is untouched, and the split path gives the
    # unsplit forces
    assert pmodel.aev_computer.angular_split is None
    assert pmd.model.aev_computer.angular_preslice is not None
    e, f = pmd._energy_and_forces(start, start.coords)
    pmd.model.aev_computer.angular_split = None
    try:
        e0, f0 = pmd._energy_and_forces(start, start.coords)
    finally:
        pmd.model.aev_computer.angular_split = tuple(jsplit)
    np.testing.assert_allclose(float(e), float(e0), rtol=1e-6)
    np.testing.assert_allclose(f.numpy(), f0.numpy(), atol=1e-5)
    assert choose_angular_split(np.full(3000, 27), 28) is None  # every row dense
    # the weight bridge carries the split, a static field of the JAX model
    leaves = _leaves(jmd.model)
    leaves[".potentials['nnp'].aev_computer.angular_split"] = np.asarray(jsplit)
    bridged = load_jax_arrays(simple_ani(("H", "O"), cutoff_fn="cosine", device=CPU), leaves)
    assert bridged.aev_computer.angular_split == tuple(jsplit)


@pytest.fixture(scope="module")
def box_table():
    """The port's cell-list table of a 300-atom box (a 2 x 2 x 2 grid: all
    pairs, 80 lanes) with 12 padding atoms, and the same table as the JAX
    package's `Neighbors`."""
    species, coords, cell = make_water_box(300)
    elem = np.where(species == 8, 3, 0).astype(np.int64)
    elem[0, -12:] = -1  # padding atoms: rows without lanes, for a split's third class
    pnb = cell_list(5.1, torch.as_tensor(elem), torch.as_tensor(coords), torch.as_tensor(cell),
                    torch.ones(3, dtype=torch.bool))
    jnb = JNeighbors(
        idx=jnp.asarray(pnb.idx.numpy().astype(np.int32)), mask=jnp.asarray(pnb.mask.numpy()),
        diff=jnp.asarray(pnb.diff.numpy()), dist=jnp.asarray(pnb.dist.numpy()),
        overflow=jnp.asarray(bool(pnb.overflow)),
        elem=None if pnb.elem is None else jnp.asarray(pnb.elem.numpy().astype(np.int32)),
    )
    counts = (pnb.mask & (pnb.dist <= 3.5)).sum(-1).reshape(-1).numpy()
    return elem, coords, jnb, pnb, counts


@pytest.mark.parametrize("k_small,n_rows", [(14, None), (28, 300), (16, 290)])
def test_split_plain_path(box_table, k_small, n_rows):
    elem, coords, jnb, pnb, counts = box_table
    assert pnb.capacity > 40  # the angular table is repacked (to 28 lanes)
    n_dense = int(-(-int((counts > k_small).sum() + 1) // 8) * 8)
    split = (k_small, n_dense) if n_rows is None else (k_small, n_dense, n_rows)
    plain = AEVComputer.like_1x(strategy="plain", device=CPU)
    want = plain.compute_from_neighbors(torch.as_tensor(elem), None, pnb)
    plain.angular_split = split
    got = plain.compute_from_neighbors(torch.as_tensor(elem), None, pnb)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=AEV_ATOL)
    if n_rows is None:  # each split shape costs the JAX side a compile
        jgot = JAEVComputer.like_1x(strategy="xla", angular_split=split).compute_from_neighbors(
            jnp.asarray(elem), None, jnb
        )
        np.testing.assert_allclose(got.numpy(), np.asarray(jgot), atol=JAX_ATOL, rtol=JAX_RTOL)


def test_split_overflow_poisons_in_both(box_table):
    """More rows over ``k_small`` than ``n_dense``, or more rows with lanes
    than ``n_rows``: the angular AEV is NaN, the radial part finite."""
    elem, _, jnb, pnb, counts = box_table
    assert (counts > 8).sum() > 64 and (counts > 0).sum() == 288
    n_dense = int(-(-int((counts > 16).sum() + 1) // 8) * 8)
    radial_len = 4 * 16
    for split in ((8, 64), (16, n_dense, 280)):
        got = AEVComputer.like_1x(
            strategy="plain", angular_split=split, device=CPU
        ).compute_from_neighbors(torch.as_tensor(elem), None, pnb)
        outs = [got.numpy()]
        if len(split) == 2:  # each split shape costs the JAX side a compile
            outs.append(np.asarray(JAEVComputer.like_1x(
                strategy="xla", angular_split=split
            ).compute_from_neighbors(jnp.asarray(elem), None, jnb)))
        for aevs in outs:
            assert np.isnan(aevs[..., radial_len:]).all(), split
            assert np.isfinite(aevs[..., :radial_len]).all(), split
    # a table that was not repacked ignores the split, as in JAX
    small = AEVComputer.like_1x(strategy="plain", angular_split=split, device=CPU)
    species, coords = make_molecs(2, 8, seed=1)
    sel = np.where(species >= 0, np.searchsorted([1, 6, 7, 8], species), -1)
    assert bool(torch.isfinite(small(torch.as_tensor(sel), torch.as_tensor(coords))).all())
