"""PyTorch port: neighbor tables against the JAX package.

Per-row neighbor sets must be equal (the image shift is part of a
neighbor's identity, compared through its distance), distances agree to
atol 1e-6 (f32 differences of the same coordinates), and the overflow flags
are the same.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchani_tpu.neighbors as jn
import torchani_tpu_torch.neighbors as pn
from torchani_tpu_torch.testing import make_molecs, make_water_box

torch.set_num_threads(2)
ATOL = 1e-6


def _rows(nb):
    """Per-row sorted (idx, dist) of the real lanes."""
    idx = np.asarray(nb.idx).reshape(-1, nb.idx.shape[-1])
    mask = np.asarray(nb.mask).reshape(idx.shape)
    dist = np.asarray(nb.dist).reshape(idx.shape)
    rows = []
    for i, m, d in zip(idx, mask, dist):
        order = np.lexsort((d[m], i[m]))
        rows.append((i[m][order], d[m][order]))
    return rows


def _compare(jnb, pnb):
    assert bool(jnb.overflow) == bool(pnb.overflow)
    jr, pr = _rows(jnb), _rows(pnb)
    assert len(jr) == len(pr)
    for (ji, jd), (pi, pd) in zip(jr, pr):
        np.testing.assert_array_equal(pi, ji)
        np.testing.assert_allclose(pd, jd, atol=ATOL)


def _both(fn_name, cutoff, elem, coords, cell=None, pbc=None, **kw):
    jnb = getattr(jn, fn_name)(
        cutoff, jnp.asarray(elem), jnp.asarray(coords),
        None if cell is None else jnp.asarray(cell),
        None if pbc is None else jnp.asarray(pbc), **kw,
    )
    pnb = getattr(pn, fn_name)(
        cutoff, torch.as_tensor(elem), torch.as_tensor(coords),
        None if cell is None else torch.as_tensor(cell),
        None if pbc is None else torch.as_tensor(pbc), **kw,
    )
    return jnb, pnb


def _molecs(seed):
    species, coords = make_molecs(5, 14, seed=seed)
    elem = np.where(species >= 0, np.searchsorted([1, 6, 7, 8], species), -1)
    return elem.astype(np.int64), coords


@pytest.mark.parametrize("capacity", [None, 10])
@pytest.mark.parametrize("seed", [0, 1])
def test_all_pairs_molecules(capacity, seed):
    elem, coords = _molecs(seed)
    _compare(*_both("all_pairs", 5.2, elem, coords, capacity=capacity))


@pytest.mark.parametrize("cutoff", [3.5, 5.2])
def test_all_pairs_periodic(cutoff):
    rng = np.random.RandomState(3)
    cell = np.diag([6.5, 7.0, 7.5]).astype(np.float32)
    coords = (rng.rand(2, 12, 3) * 7.0).astype(np.float32)
    elem = rng.randint(0, 4, (2, 12))
    elem[1, -2:] = -1
    _compare(*_both("all_pairs", cutoff, elem, coords, cell, np.ones(3, bool)))


def _water(n):
    species, coords, cell = make_water_box(n)
    elem = np.where(species == 8, 3, 0).astype(np.int64)
    return elem, coords, cell


@pytest.mark.parametrize("periodic", [False, True])
def test_cell_list_water(periodic):
    elem, coords, cell = _water(600)  # 18.6 A: a 3x3x3 bucket grid
    if periodic:
        jnb, pnb = _both("cell_list", 5.1, elem, coords, cell, np.ones(3, bool))
    else:
        jnb, pnb = _both("cell_list", 5.1, elem, coords)
    _compare(jnb, pnb)
    assert pnb.idx.shape == (1, 600, 96)


def test_cell_list_small_cell_falls_back_to_all_pairs():
    elem, coords, cell = _water(90)
    jnb, pnb = _both("cell_list", 5.1, elem, coords, cell, np.ones(3, bool))
    _compare(jnb, pnb)


def test_cell_list_overflow_on_purpose():
    elem, coords, cell = _water(600)
    jnb, pnb = _both(
        "cell_list", 5.1, elem, coords, cell, np.ones(3, bool), capacity=16
    )
    assert bool(jnb.overflow) and bool(pnb.overflow)
    # what fits is the same: each row's first 16 candidates in candidate order
    np.testing.assert_array_equal(pnb.mask.numpy(), np.asarray(jnb.mask))


def test_bucket_overflow_on_purpose():
    elem, coords, cell = _water(600)
    jnb, pnb = _both(
        "cell_list", 5.1, elem, coords, cell, np.ones(3, bool), bucket_capacity=8
    )
    assert bool(jnb.overflow) and bool(pnb.overflow)


@pytest.mark.parametrize("capacity", [20, 28])
def test_narrow_and_repack(capacity):
    elem, coords, cell = _water(600)
    jnb, pnb = _both("cell_list", 5.1, elem, coords, cell, np.ones(3, bool))
    jr = jn.repack_to_capacity(jn.narrow_to_cutoff(jnb, 3.5), capacity)
    pr = pn.repack_to_capacity(pn.narrow_to_cutoff(pnb, 3.5), capacity)
    _compare(jr, pr)
    np.testing.assert_array_equal(pr.mask.numpy(), np.asarray(jr.mask))


@pytest.mark.parametrize("n,pbc", [(60, True), (300, True), (60, False)])
def test_adaptive_list(n, pbc):
    elem, coords, cell = _water(n)
    if pbc:
        _compare(*_both("adaptive_list", 5.1, elem, coords, cell, np.ones(3, bool)))
    else:
        _compare(*_both("adaptive_list", 5.1, elem, coords))


def test_estimate_capacity_and_registry():
    for args in ((5.2, 600, 0.12, 1.35, True), (5.2, 20), (3.5, 3000)):
        assert pn.estimate_capacity(*args) == jn.estimate_capacity(*args)
    assert isinstance(pn.parse_neighborlist("cell_list"), pn.CellList)
    assert isinstance(pn.parse_neighborlist("adaptive"), pn.AdaptiveList)
    with pytest.raises(ValueError):
        pn.parse_neighborlist("verlet")


def test_diff_gradient_flows_to_coords():
    elem, coords, cell = _water(600)
    c = torch.as_tensor(coords).requires_grad_(True)
    nb = pn.cell_list(5.1, torch.as_tensor(elem), c, torch.as_tensor(cell),
                      torch.ones(3, dtype=torch.bool))
    (g,) = torch.autograd.grad(nb.dist.sum(), c)
    assert torch.isfinite(g).all() and g.abs().max() > 0
