"""PyTorch port: the bucket refresh against the JAX package.

Tolerances: the selection K1 is exact (difference 0); its transpose K2 sums
in another order (atol 1e-6); integer tables are equal and ``wrap_offset``
agrees to atol 1e-6; refreshed positions agree to 2e-4 A (coordinates drift
up to two boxes out, so canonical coordinates round in f32, as
``tests/test_bucket_refresh.py``); gradients agree to 1e-5 of their scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchani_tpu.bucket_refresh as jbr
import torchani_tpu_torch.bucket_refresh as pbr
from torchani_tpu.neighbors import _static_grid_shape
from torchani_tpu.neighbors import cell_list as j_cell_list
from torchani_tpu_torch.neighbors import cell_list

torch.set_num_threads(2)


def _t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _random_keys(rng, g, c, r, occupied=None):
    """Random lane keys with repeats; a quarter sentinels, or (with
    ``occupied`` slots per bucket) sentinels exactly past the occupied lanes."""
    k = r // c
    rank = rng.randint(0, c, (g, r)).astype(np.int32)
    if occupied is None:
        sec = np.where(rng.rand(g, r) < 0.75, rng.randint(0, 27, (g, r)), 27)
        nlanes = None
    else:
        nlanes = (np.asarray(occupied) * k).astype(np.int32)
        lane_real = np.arange(r)[None, :] < nlanes[:, None]
        sec = np.where(lane_real, rng.randint(0, 27, (g, r)), 27)
    sec = sec.astype(np.int32)
    return (sec << 8) | np.where(sec < 27, rank, 0), nlanes


def _jax_layout(cand):
    """``(G, 27, C, 3)`` -> the TPU kernel's ``(G, 96, C)`` rows d * 32 + s."""
    g, _, c, _ = cand.shape
    cand3 = np.zeros((g, 3, 32, c), np.float32)
    cand3[:, :, :27] = cand.transpose(0, 3, 1, 2)
    return cand3.reshape(g, 96, c)


def _jax_bwd(gt, keys, c, nlanes):
    """JAX K2 on ``gt (G, R, 3)`` -> ``(G, 27, C, 3)``."""
    hi, mid, lo = jbr._split3(jnp.asarray(gt.transpose(0, 2, 1)))
    g16 = jnp.pad(jnp.concatenate([hi, mid, lo], axis=1), ((0, 0), (0, 7), (0, 0)))
    out = jbr._bucket_select_bwd(
        g16, jnp.asarray(keys), c, None if nlanes is None else jnp.asarray(nlanes)
    )
    g = keys.shape[0]
    return np.asarray(out).reshape(g, 3, 32, c)[:, :, :27].transpose(0, 2, 3, 1)


SELECT_CASES = [
    pytest.param(256, None, 11, id="R256"),
    pytest.param(512, (2, 64, 0), 13, id="R512-nlanes"),
]


@pytest.mark.parametrize("r,occupied,seed", SELECT_CASES)
def test_select_reference_matches_jax_kernel(r, occupied, seed):
    """`bucket_select_reference` against the Pallas forward kernel in
    interpret mode: exactly equal on every occupied lane."""
    g, c = 3, 64
    rng = np.random.RandomState(seed)
    cand = (rng.randn(g, 27, c, 3) * 20.0).astype(np.float32)
    keys, nlanes = _random_keys(rng, g, c, r, occupied)
    ref = jbr._bucket_select_fwd(
        jbr._split3(jnp.asarray(_jax_layout(cand))), jnp.asarray(keys),
        None if nlanes is None else jnp.asarray(nlanes),
    )
    ref = np.asarray(ref)[:, :3].transpose(0, 2, 1)  # (G, R, 3)
    out = pbr.bucket_select_reference(
        _t(cand), _t(keys), None if nlanes is None else _t(nlanes)
    ).numpy()
    lane_real = np.ones((g, r), bool)
    if nlanes is not None:
        lane_real = np.arange(r)[None, :] < nlanes[:, None]
        assert (out[~lane_real] == 0).all()
    assert np.abs(out - ref)[lane_real].max() == 0.0
    # the wrapper takes the plain version for CPU tensors, and counts nothing
    before = pbr.bucket_select_fwd.launches
    via = pbr.bucket_select_fwd(_t(cand), _t(keys), None if nlanes is None else _t(nlanes))
    assert pbr.bucket_select_fwd.launches == before
    np.testing.assert_array_equal(via.numpy(), out)


@pytest.mark.parametrize("r,occupied,seed", SELECT_CASES)
def test_select_bwd_reference_matches_jax_kernel(r, occupied, seed):
    """`bucket_select_bwd_reference` against the Pallas backward kernel in
    interpret mode (atol 1e-6: another order of the sums)."""
    g, c = 3, 64
    rng = np.random.RandomState(seed)
    keys, nlanes = _random_keys(rng, g, c, r, occupied)
    gt = rng.randn(g, r, 3).astype(np.float32)
    ref = _jax_bwd(gt, keys, c, nlanes)
    out = pbr.bucket_select_bwd_reference(
        _t(gt), _t(keys), c, None if nlanes is None else _t(nlanes)
    ).numpy()
    assert out.shape == (g, 27, c, 3)
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)
    before = pbr.bucket_select_bwd.launches
    via = pbr.bucket_select_bwd(_t(gt), _t(keys), c, None if nlanes is None else _t(nlanes))
    assert pbr.bucket_select_bwd.launches == before
    np.testing.assert_array_equal(via.numpy(), out)


def test_select_is_the_transpose_of_select_bwd():
    """<K1(cand), w> == <cand, K2(w)> for random keys with repeats."""
    g, c, r = 2, 16, 96
    rng = np.random.RandomState(5)
    keys, _ = _random_keys(rng, g, c, r)
    cand = _t(rng.randn(g, 27, c, 3).astype(np.float32)).double()
    w = _t(rng.randn(g, r, 3).astype(np.float32)).double()
    lhs = (pbr.bucket_select_reference(cand, _t(keys)) * w).sum()
    rhs = (cand * pbr.bucket_select_bwd_reference(w, _t(keys), c)).sum()
    assert abs(float(lhs - rhs)) < 1e-9


@pytest.mark.parametrize("grid", [(3, 4, 5), (2, 2, 2), (1, 3, 1)])
def test_cand_table_is_27_rolls_of_the_slot_table(grid):
    """`_cand_table` gathers through a static index what the JAX package
    builds with 27 rolls, and `_cand_table_transpose` is its transpose."""
    rng = np.random.RandomState(6)
    gx, gy, gz = grid
    g, c = gx * gy * gz, 4
    a = g * c - 3  # three slots stay empty
    canon = _t(rng.randn(a, 3).astype(np.float32)).double().requires_grad_(True)
    atom_of_slot = _t(rng.permutation(np.r_[np.arange(a), np.full(3, a)]))
    cell = np.diag([7.0, 8.0, 9.0])
    wrapshift = _t(pbr.make_wrapshift(grid, cell)).double()
    cand = pbr._cand_table(canon, atom_of_slot, wrapshift, grid, c)

    posb3 = torch.cat([canon, canon.new_zeros((1, 3))])[atom_of_slot].reshape(gx, gy, gz, c, 3)
    rolled = torch.stack(
        [
            torch.roll(posb3, shifts=(-int(ox), -int(oy), -int(oz)), dims=(0, 1, 2))
            for ox, oy, oz in pbr._SECTION_OFFSETS
        ],
        dim=3,
    ).reshape(g, 27, c, 3) + wrapshift.reshape(g, 27, 1, 3)
    assert torch.equal(cand, rolled)

    w = _t(rng.randn(g, 27, c, 3))
    (d_canon,) = torch.autograd.grad((rolled * w).sum(), canon)
    d_posb = pbr._cand_table_transpose(w, grid, c)  # (G*C, 3)
    d_ref = torch.zeros((a + 1, 3), dtype=torch.float64).index_add_(
        0, atom_of_slot.clamp(max=a), d_posb
    )[:a]
    np.testing.assert_allclose(d_ref.numpy(), d_canon.numpy(), atol=1e-12)


def _random_periodic_topology(seed, a=60, box=12.0, cutoff=5.2):
    """A random periodic system whose atoms drift up to two boxes out, and
    the JAX cell list's cached topology for it (numpy arrays)."""
    rng = np.random.RandomState(seed)
    coords = rng.rand(a, 3).astype(np.float32) * box
    coords = coords + (rng.randint(-2, 3, (a, 3)) * box).astype(np.float32)
    cell = np.eye(3, dtype=np.float32) * box
    nbrs = j_cell_list(
        cutoff, jnp.zeros((1, a), jnp.int32), jnp.asarray(coords)[None],
        jnp.asarray(cell), jnp.asarray([True] * 3),
    )
    idx, mask = np.asarray(nbrs.idx[0]), np.asarray(nbrs.mask[0])
    diff = np.asarray(nbrs.diff[0])
    shift = diff - (coords[np.where(mask, idx, 0)] - coords[:, None, :])
    shift = np.where(mask[..., None], shift, 0.0).astype(np.float32)
    grid = _static_grid_shape(cell, cutoff)
    return coords, cell, grid, idx, mask, shift, diff


def _assert_tables_equal(pt: pbr.BucketTables, jt) -> None:
    np.testing.assert_array_equal(pt.keys.numpy(), np.asarray(jt.keys))
    np.testing.assert_array_equal(pt.atom_of_slot.numpy(), np.asarray(jt.atom_of_slot))
    np.testing.assert_array_equal(pt.slot_of_atom.numpy(), np.asarray(jt.slot_of_atom))
    np.testing.assert_allclose(pt.wrap_offset.numpy(), np.asarray(jt.wrap_offset), atol=1e-6)
    np.testing.assert_array_equal(pt.wrapshift.numpy(), np.asarray(jt.wrapshift))
    assert pt.keys.dtype == torch.int32


def _both_tables(topology, grid, c):
    coords, cell, _, idx, mask, shift, _ = topology
    a = coords.shape[0]
    ws = jbr.make_wrapshift(grid, cell)
    np.testing.assert_array_equal(pbr.make_wrapshift(grid, cell), ws)
    jt, jovf = jbr.build_bucket_tables(
        jnp.asarray(coords), jnp.asarray(idx), jnp.asarray(mask), jnp.asarray(shift),
        jnp.ones((a,), bool), jnp.asarray(cell), grid_shape=grid, c=c,
        wrapshift=jnp.asarray(ws),
    )
    pt, povf = pbr.build_bucket_tables(
        _t(coords), _t(idx, torch.int64), _t(mask), _t(shift),
        torch.ones(a, dtype=torch.bool), _t(cell), grid_shape=grid, c=c, wrapshift=_t(ws),
    )
    return pt, bool(povf), jt, bool(jovf)


@pytest.mark.parametrize("seed", [0, 2, 3])
def test_build_bucket_tables_match_jax(seed):
    topology = _random_periodic_topology(seed)
    pt, povf, jt, jovf = _both_tables(topology, topology[2], c=32)
    assert povf == jovf and not povf
    _assert_tables_equal(pt, jt)


@pytest.mark.parametrize("grid,a", [((1, 1, 1), 60), ((2, 2, 2), 200)])
def test_build_bucket_tables_overflow_flags_match_jax(grid, a):
    """60 atoms in one bucket of 16 slots must flag, not crash; so must 200
    atoms in 8 such buckets.  Only the flags and
    the slot maps are compared: the keys of an overflowed table are not
    defined (the JAX package derives them from a packed per-atom code that
    an overflowed rank corrupts)."""
    topology = _random_periodic_topology(2, a=a)
    pt, povf, jt, jovf = _both_tables(topology, grid, 16)
    assert povf == jovf
    assert povf
    np.testing.assert_array_equal(pt.atom_of_slot.numpy(), np.asarray(jt.atom_of_slot))
    np.testing.assert_array_equal(pt.slot_of_atom.numpy(), np.asarray(jt.slot_of_atom))


def test_build_bucket_tables_rejects_too_many_slots():
    topology = _random_periodic_topology(0)
    coords, cell, grid, idx, mask, shift, _ = topology
    with pytest.raises(ValueError, match="8 bits"):
        pbr.build_bucket_tables(
            _t(coords), _t(idx, torch.int64), _t(mask), _t(shift),
            torch.ones(60, dtype=torch.bool), _t(cell), grid_shape=grid, c=272,
            wrapshift=_t(pbr.make_wrapshift(grid, cell)),
        )


def _cell_aux_system(seed=5, a=120, box=16.0):
    rng = np.random.RandomState(seed)
    coords = rng.rand(a, 3).astype(np.float32) * box
    coords = coords + (rng.randint(-2, 3, (a, 3)) * box).astype(np.float32)
    return coords, np.eye(3, dtype=np.float32) * box


@pytest.fixture(scope="module")
def cell_aux():
    """The port's and the JAX package's ``cell_list(bucket_aux=True)`` on one
    system, and the tables assembled from each (cutoff 5.2, C = 32)."""
    coords, cell = _cell_aux_system()
    a, cutoff, c = coords.shape[0], 5.2, 32
    grid = _static_grid_shape(cell, cutoff)
    ws = pbr.make_wrapshift(grid, cell)
    jn, jaux = j_cell_list(
        cutoff, jnp.zeros((1, a), jnp.int32), jnp.asarray(coords)[None],
        jnp.asarray(cell), jnp.asarray([True] * 3),
        capacity=64, bucket_capacity=c, bucket_aux=True,
    )
    jt = jbr.tables_from_cell_aux(
        jaux["keys"], jn.mask[0], jaux["atom_of_slot"], jaux["slot_of_atom"],
        jnp.asarray(coords) - jaux["central"], jnp.asarray(ws), c,
    )
    pn, paux = cell_list(
        cutoff, torch.zeros((1, a), dtype=torch.int64), _t(coords)[None],
        _t(cell), torch.ones(3, dtype=torch.bool),
        capacity=64, bucket_capacity=c, bucket_aux=True,
    )
    pt = pbr.tables_from_cell_aux(
        paux["keys"], pn.mask[0], paux["atom_of_slot"], paux["slot_of_atom"],
        _t(coords) - paux["central"], _t(ws), c,
    )
    return coords, (pn, pt), (jn, jt)


def test_tables_from_cell_aux_match_jax(cell_aux):
    """The two cell lists pack candidates in the same order, so the tables
    are equal lane for lane."""
    _, (pn, pt), (jn, jt) = cell_aux
    assert not bool(pn.overflow) and not bool(jn.overflow)
    np.testing.assert_array_equal(pn.idx.numpy(), np.asarray(jn.idx))
    np.testing.assert_array_equal(pn.mask.numpy(), np.asarray(jn.mask))
    _assert_tables_equal(pt, jt)


def _port_diff(coords_t, tables, mask):
    canon = coords_t - tables.wrap_offset
    nbr = pbr.bucket_nbr_pos(
        canon, tables.keys, tables.atom_of_slot, tables.slot_of_atom, tables.wrapshift
    )
    return torch.where(mask[..., None], nbr - canon[:, None, :], 0.0)


def test_bucket_nbr_pos_reproduces_cached_diff(cell_aux):
    """The port's tables from its own cell list reproduce the cached
    topology's ``diff``, and the JAX refresh on the JAX tables."""
    coords, (pn, pt), (jn, jt) = cell_aux
    diff = _port_diff(_t(coords), pt, pn.mask[0]).numpy()
    assert np.abs(diff - pn.diff[0].numpy()).max() < 2e-4
    jcanon = jnp.asarray(coords) - jt.wrap_offset
    jnbr = jbr.bucket_nbr_pos(
        jcanon, jt.keys, jt.atom_of_slot, jt.slot_of_atom, jt.wrapshift
    )
    jdiff = jnp.where(jn.mask[0][..., None], jnbr - jcanon[:, None, :], 0.0)
    assert np.abs(diff - np.asarray(jdiff)).max() < 2e-4


@pytest.mark.parametrize("seed", [0, 3])
def test_bucket_nbr_pos_matches_gather_on_built_tables(seed):
    """Tables derived from a cached topology (`build_bucket_tables`)."""
    topology = _random_periodic_topology(seed)
    coords, _, grid, _, mask, _, diff_ref = topology
    pt, povf, _, _ = _both_tables(topology, grid, c=32)
    assert not povf
    diff = _port_diff(_t(coords), pt, _t(mask)).numpy()
    assert np.abs(diff - diff_ref).max() < 2e-4


def test_bucket_nbr_pos_gradient_matches_jax_and_gather():
    topology = _random_periodic_topology(1)
    coords, _, grid, idx, mask, shift, _ = topology
    a, k = idx.shape
    pt, povf, jt, _ = _both_tables(topology, grid, c=32)
    assert not povf
    w = np.random.RandomState(7).randn(a, k, 3).astype(np.float32)

    crd = _t(coords).requires_grad_(True)
    (gb,) = torch.autograd.grad((_t(w) * _port_diff(crd, pt, _t(mask))).sum(), crd)

    # the port's gather refresh: index_select forward, index_add backward
    crd2 = _t(coords).requires_grad_(True)
    idx_safe = _t(np.where(mask, idx, 0), torch.int64)
    nbr = crd2.index_select(0, idx_safe.reshape(-1)).reshape(a, k, 3)
    d = torch.where(_t(mask)[..., None], nbr - crd2[:, None, :] + _t(shift), 0.0)
    (gg,) = torch.autograd.grad((_t(w) * d).sum(), crd2)

    def loss_jax(c):
        canon = c - jt.wrap_offset
        nbr = jbr.bucket_nbr_pos(canon, jt.keys, jt.atom_of_slot, jt.slot_of_atom, jt.wrapshift)
        dd = jnp.where(jnp.asarray(mask)[..., None], nbr - canon[:, None, :], 0.0)
        return jnp.sum(jnp.asarray(w) * dd)

    gj = np.asarray(jax.grad(loss_jax)(jnp.asarray(coords)))
    scale = np.abs(gg.numpy()).max() + 1e-9
    assert np.abs(gb.numpy() - gg.numpy()).max() / scale < 1e-5
    assert np.abs(gb.numpy() - gj).max() / scale < 1e-5


def test_atoms_without_a_slot_get_zero():
    """A dummy atom has slot -1: its row of neighbor positions is 0 and it
    receives no gradient."""
    topology = _random_periodic_topology(0)
    coords, cell, grid, idx, mask, shift, _ = topology
    a = coords.shape[0]
    valid = torch.ones(a, dtype=torch.bool)
    valid[7] = False
    mask = mask & (idx != 7)
    mask[7] = False
    pt, _ = pbr.build_bucket_tables(
        _t(coords), _t(idx, torch.int64), _t(mask), _t(shift), valid, _t(cell),
        grid_shape=grid, c=32, wrapshift=_t(pbr.make_wrapshift(grid, cell)),
    )
    assert int(pt.slot_of_atom[7]) == -1
    crd = _t(coords).requires_grad_(True)
    canon = crd - pt.wrap_offset
    nbr = pbr.bucket_nbr_pos(canon, pt.keys, pt.atom_of_slot, pt.slot_of_atom, pt.wrapshift)
    assert (nbr[7] == 0).all()
    (g,) = torch.autograd.grad(nbr.sum(), crd)
    assert (g[7] == 0).all() and g.abs().max() > 0
