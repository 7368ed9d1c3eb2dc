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


def test_clustered_bucket_overflow_flags_and_stays_in_range():
    """A sparse lattice with dense pockets puts more atoms into one bucket
    than the default capacity holds: both packages flag it, and the port's
    indices stay in range."""
    species, coords, cell = make_water_box(150, density_molec_per_a3=0.008)
    elem = np.where(species == 8, 3, 0).astype(np.int64)
    jnb, pnb = _both("cell_list", 5.2, elem, coords, cell, np.ones(3, bool))
    assert bool(jnb.overflow) and bool(pnb.overflow)
    assert int(pnb.idx.min()) >= 0 and int(pnb.idx.max()) < 150


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


def _decode(keys, central, atom_of_slot, grid, b, cell):
    """Each lane key -> (atom, image position) through the bucket structure:
    section and rank name a slot of a neighbouring bucket."""
    gx, gy, gz = grid
    gdims = np.array(grid)
    frac = central @ np.linalg.inv(cell)
    idx3 = np.minimum((np.clip(frac, 0.0, 1.0 - 1e-7) * gdims).astype(np.int64), gdims - 1)
    offs = np.mgrid[-1:2, -1:2, -1:2].reshape(3, -1).T
    sec, rank = keys >> 8, keys & 255
    valid = sec < 27
    nb3 = idx3[:, None, :] + offs[np.where(valid, sec, 0)]  # (A, K, 3)
    wrap = np.floor_divide(nb3, gdims)
    nb3 = nb3 - wrap * gdims
    bucket = (nb3[..., 0] * gy + nb3[..., 1]) * gz + nb3[..., 2]
    atom = atom_of_slot[bucket * b + np.where(valid, rank, 0)]
    pos = central[np.minimum(atom, central.shape[0] - 1)] + wrap @ cell
    return valid, atom, pos


def test_cell_list_bucket_aux_matches_jax():
    """`cell_list(bucket_aux=True)`: the same neighbor sets as JAX, every
    lane's key decodes to the lane's atom and image, and the slot maps are
    inverse to each other; ``central`` agrees to atol 1e-6."""
    rng = np.random.RandomState(5)
    a, box, cutoff, b = 120, 16.0, 5.2, 32
    coords = (rng.rand(a, 3) * box + rng.randint(-2, 3, (a, 3)) * box).astype(np.float32)
    cell = np.eye(3, dtype=np.float32) * box
    elem = rng.randint(0, 4, (1, a))
    elem[0, 17] = -1
    kw = dict(capacity=64, bucket_capacity=b, bucket_aux=True)
    (jnb, jaux), (pnb, paux) = _both(
        "cell_list", cutoff, elem, coords[None], cell, np.ones(3, bool), **kw
    )
    _compare(jnb, pnb)
    assert pnb.idx.shape == (1, a, 64) and not pnb.diff.requires_grad
    np.testing.assert_allclose(paux["central"].numpy(), np.asarray(jaux["central"]), atol=ATOL)
    for name in ("keys", "atom_of_slot", "slot_of_atom"):
        np.testing.assert_array_equal(paux[name].numpy(), np.asarray(jaux[name]))
    assert paux["keys"].dtype == torch.int32

    keys, central = paux["keys"].numpy(), paux["central"].numpy()
    atom_of_slot, slot_of_atom = paux["atom_of_slot"].numpy(), paux["slot_of_atom"].numpy()
    idx, mask = pnb.idx[0].numpy(), pnb.mask[0].numpy()
    valid, atom, pos = _decode(keys, central, atom_of_slot, (3, 3, 3), b, cell)
    np.testing.assert_array_equal(valid, mask)
    np.testing.assert_array_equal(atom[mask], idx[mask])
    diff = (pos - central[:, None, :])[mask]
    np.testing.assert_allclose(diff, pnb.diff[0].numpy()[mask], atol=1e-5)
    assert (keys[~mask] == 27 << 8).all()
    real = elem[0] >= 0
    assert slot_of_atom[17] == -1 and (slot_of_atom[real] >= 0).all()
    np.testing.assert_array_equal(atom_of_slot[slot_of_atom[real]], np.arange(a)[real])
    assert (atom_of_slot[np.setdiff1d(np.arange(27 * b), slot_of_atom[real])] == a).all()


def test_cell_list_gradient_stops_with_bucket_aux():
    elem, coords, cell = _water(600)
    c = torch.as_tensor(coords).requires_grad_(True)
    nb, aux = pn.cell_list(
        5.1, torch.as_tensor(elem), c, torch.as_tensor(cell),
        torch.ones(3, dtype=torch.bool), bucket_aux=True,
    )
    assert not nb.diff.requires_grad and not nb.dist.requires_grad
    assert not aux["central"].requires_grad


def test_cell_list_bucket_aux_raises_where_jax_does():
    elem, coords, cell = _water(90)  # an 8.3 A box: fewer than 3 buckets per axis
    for args in ((cell, np.ones(3, bool)), (None, None)):
        with pytest.raises(ValueError):
            _both("cell_list", 5.1, elem, coords, *args, bucket_aux=True)[0]
        with pytest.raises(ValueError):
            pn.cell_list(
                5.1, torch.as_tensor(elem), torch.as_tensor(coords),
                None if args[0] is None else torch.as_tensor(args[0]),
                None if args[1] is None else torch.as_tensor(args[1]),
                bucket_aux=True,
            )


def test_cell_list_takes_a_grid_shape():
    """A coarser grid than the default gives the same neighbors."""
    elem, coords, cell = _water(3000)  # 31.7 A: 6 buckets per axis by default
    jnb, pnb = _both(
        "cell_list", 5.1, elem, coords, cell, np.ones(3, bool),
        grid_shape=(4, 4, 4), bucket_capacity=96,
    )
    _compare(jnb, pnb)
    _compare(jn.cell_list(5.1, jnp.asarray(elem), jnp.asarray(coords), jnp.asarray(cell),
                          jnp.asarray(np.ones(3, bool))), pnb)


def test_lane_permute_matches_jax():
    rng = np.random.RandomState(2)
    r, k, c = 7, 9, 5
    top = np.stack([rng.permutation(k)[:c] for _ in range(r)]).astype(np.int64)
    values = (
        rng.randint(0, 50, (r, k)).astype(np.int64),
        rng.rand(r, k) < 0.5,
        rng.randn(r, k, 3).astype(np.float32),
        rng.randn(r, k).astype(np.float32),
    )
    ref = jn.lane_permute([jnp.asarray(v) for v in values], jnp.asarray(top))
    out = pn.lane_permute([torch.as_tensor(v) for v in values], torch.as_tensor(top))
    for o, j, v in zip(out, ref, values):
        np.testing.assert_array_equal(o.numpy(), np.asarray(j))
        assert o.numpy().dtype == v.dtype


def test_cell_list_survives_a_non_finite_coordinate():
    """A NaN coordinate (an MD run whose AEV capacity overflowed poisons its
    forces) must not index out of range: the atom lands in a valid bucket and
    pairs with nothing, every other row is as without it."""
    species, coords, cell = make_water_box(300)
    elem = torch.zeros((1, species.shape[1]), dtype=torch.int64)
    pbc = torch.ones(3, dtype=torch.bool)
    good = pn.cell_list(5.2, elem, torch.as_tensor(coords), torch.as_tensor(cell), pbc)
    broken = coords.copy()
    broken[0, 5] = np.nan
    nbrs = pn.cell_list(5.2, elem, torch.as_tensor(broken), torch.as_tensor(cell), pbc)
    assert int(nbrs.mask[0, 5].sum()) == 0
    assert torch.isfinite(nbrs.dist).all()
    others = good.mask[0].sum(-1) - (good.mask[0] & (good.idx[0] == 5)).sum(-1)
    others[5] = 0
    assert torch.equal(nbrs.mask[0].sum(-1), others)
