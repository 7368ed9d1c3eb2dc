"""PyTorch port: the per-lane selection of runtime per-atom values
(`bucket_lane_values`, `select_lane_values`; kernels K4f and K4b) against the
JAX package, on the CPU.

The plain versions are held against the Pallas kernels in interpret mode, for
P = 1, 2 and 5 channels.  Tolerances: the selection is exact (difference 0);
its transpose sums in another order (atol 1e-6); `bucket_lane_values` equals
``values[idx]`` exactly and its gradient agrees to 1e-5 of its scale (the
contract of ``test_bucket_lane_values_matches_gather``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchani_tpu.bucket_refresh as jbr
import torchani_tpu_torch.bucket_refresh as pbr
from test_torch_bucket_refresh import _both_tables, _random_keys, _random_periodic_topology, _t
from torchani_tpu_torch.neighbors import Neighbors

torch.set_num_threads(2)
CHANNELS = [1, 2, 5]


def _jax_vals_layout(cand):
    """``(G, 27, C, P)`` -> the TPU kernel's ``(G, 32 P, C)`` rows d * 32 + s."""
    g, _, c, p = cand.shape
    rows = np.zeros((g, p, 32, c), np.float32)
    rows[:, :, :27] = cand.transpose(0, 3, 1, 2)
    return rows.reshape(g, 32 * p, c)


@pytest.mark.parametrize("p", CHANNELS)
def test_vals_select_reference_matches_jax_kernel(p):
    """`vals_select_reference` against the Pallas forward kernel in interpret
    mode: exactly equal on every occupied lane, 0 past them."""
    g, c, r = 3, 64, 512
    rng = np.random.RandomState(20 + p)
    cand = (rng.randn(g, 27, c, p) * 20.0).astype(np.float32)
    keys, nlanes = _random_keys(rng, g, c, r, occupied=(2, 64, 0))
    ref = jbr._vals_select_fwd(
        jbr._split3(jnp.asarray(_jax_vals_layout(cand))), jnp.asarray(keys),
        jnp.asarray(nlanes), p,
    )
    ref = np.asarray(ref)[:, :p].transpose(0, 2, 1)  # (G, R, P)
    out = pbr.vals_select_reference(_t(cand), _t(keys), _t(nlanes)).numpy()
    lane_real = np.arange(r)[None, :] < nlanes[:, None]
    assert out.shape == (g, r, p)
    assert (out[~lane_real] == 0).all()
    assert np.abs(out - ref)[lane_real].max() == 0.0
    # the wrapper takes the plain version for CPU tensors, and counts nothing
    before = pbr.vals_select_fwd.launches
    via = pbr.vals_select_fwd(_t(cand), _t(keys), _t(nlanes))
    assert pbr.vals_select_fwd.launches == before
    np.testing.assert_array_equal(via.numpy(), out)


@pytest.mark.parametrize("p", CHANNELS)
def test_vals_select_bwd_reference_matches_jax_kernel(p):
    """`vals_select_bwd_reference` against the Pallas backward kernel in
    interpret mode (atol 1e-6: another order of the sums)."""
    g, c, r = 3, 64, 512
    rng = np.random.RandomState(30 + p)
    keys, nlanes = _random_keys(rng, g, c, r, occupied=(2, 64, 0))
    gt = rng.randn(g, r, p).astype(np.float32)
    hi, mid, lo = jbr._split3(jnp.asarray(gt.transpose(0, 2, 1)))  # (G, P, R) each
    rows = max(8, -(-3 * p // 8) * 8)
    g16 = jnp.pad(jnp.concatenate([hi, mid, lo], axis=1), ((0, 0), (0, rows - 3 * p), (0, 0)))
    ref = jbr._vals_select_bwd(g16, jnp.asarray(keys), c, jnp.asarray(nlanes), p)
    ref = np.asarray(ref).reshape(g, p, 32, c)[:, :, :27].transpose(0, 2, 3, 1)
    out = pbr.vals_select_bwd_reference(_t(gt), _t(keys), c, _t(nlanes)).numpy()
    assert out.shape == (g, 27, c, p)
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)
    before = pbr.vals_select_bwd.launches
    via = pbr.vals_select_bwd(_t(gt), _t(keys), c, _t(nlanes))
    assert pbr.vals_select_bwd.launches == before
    np.testing.assert_array_equal(via.numpy(), out)


@pytest.mark.parametrize("p", CHANNELS)
def test_vals_select_is_the_transpose_of_its_backward(p):
    """<K4f(cand), w> == <cand, K4b(w)> for random keys with repeats."""
    g, c, r = 2, 16, 96
    rng = np.random.RandomState(40 + p)
    keys, _ = _random_keys(rng, g, c, r)
    cand = _t(rng.randn(g, 27, c, p)).double()
    w = _t(rng.randn(g, r, p)).double()
    lhs = (pbr.vals_select_reference(cand, _t(keys)) * w).sum()
    rhs = (cand * pbr.vals_select_bwd_reference(w, _t(keys), c)).sum()
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-12)


@pytest.fixture(scope="module")
def topology():
    topo = _random_periodic_topology(7)
    pt, povf, jt, jovf = _both_tables(topo, topo[2], c=16)
    assert not povf and not jovf
    return topo, pt, jt


@pytest.mark.parametrize("p", CHANNELS)
def test_bucket_lane_values_matches_gather_and_jax(topology, p):
    (coords, _, _, idx, mask, _, _), pt, jt = topology
    a = coords.shape[0]
    rng = np.random.RandomState(3)
    vals = rng.randn(a, p).astype(np.float32)
    w = rng.randn(*idx.shape, p).astype(np.float32)
    mask_t, idx_t = _t(mask), _t(np.where(mask, idx, 0), torch.int64)

    v = _t(vals).requires_grad_(True)
    out = pbr.bucket_lane_values(v, pt.keys, pt.atom_of_slot, pt.slot_of_atom, pt.wrapshift)
    got = torch.where(mask_t[..., None], out, 0.0)
    ref = np.where(mask[..., None], vals[np.where(mask, idx, 0)], 0.0)
    assert out.shape == idx.shape + (p,)
    assert (out.detach().numpy()[~mask] == 0).all(), "masked lanes give 0"
    np.testing.assert_array_equal(got.detach().numpy(), ref)
    jgot = jbr.bucket_lane_values(
        jnp.asarray(vals), jt.keys, jt.atom_of_slot, jt.slot_of_atom, jt.wrapshift
    )
    np.testing.assert_array_equal(got.detach().numpy(), np.where(mask[..., None], jgot, 0.0))

    (g_got,) = torch.autograd.grad((got * _t(w)).sum(), v)
    v2 = _t(vals).requires_grad_(True)
    gathered = torch.where(mask_t[..., None], v2[idx_t], 0.0)
    (g_ref,) = torch.autograd.grad((gathered * _t(w)).sum(), v2)
    scale = float(g_ref.abs().max()) + 1e-9
    assert float((g_got - g_ref).abs().max()) / scale < 1e-5


def test_select_lane_values_with_and_without_tables(topology):
    """With ``select_tables`` the values go through `bucket_lane_values`;
    without, through a gather.  1-D values give ``(A, K)``."""
    (coords, _, _, idx, mask, _, diff), pt, _ = topology
    a = coords.shape[0]
    rng = np.random.RandomState(5)
    idx_safe = np.where(mask, idx, 0)
    nb = Neighbors(
        idx=_t(idx_safe, torch.int64), mask=_t(mask), diff=_t(diff),
        dist=_t(np.where(mask, np.linalg.norm(diff, axis=-1), 1.0)),
        overflow=torch.tensor(False),
    )
    for shape in ((a,), (a, 5)):
        vals = rng.randn(*shape).astype(np.float32)
        plain = pbr.select_lane_values(_t(vals), nb)
        np.testing.assert_array_equal(plain.numpy(), vals[idx_safe])
        via = pbr.select_lane_values(_t(vals), nb.replace(select_tables=pt))
        assert via.shape == plain.shape
        lanes = mask if len(shape) == 1 else mask[..., None]
        np.testing.assert_array_equal(
            np.where(lanes, via.numpy(), 0.0), np.where(lanes, plain.numpy(), 0.0)
        )


def test_atoms_without_a_slot_select_zero(topology):
    """An atom whose slot is -1 (dummy or overflowed) selects 0 and receives
    no gradient; a too-wide tile is refused on the card's path only."""
    (coords, _, _, idx, mask, _, _), pt, _ = topology
    a = coords.shape[0]
    slot_of_atom = pt.slot_of_atom.clone()
    slot_of_atom[3] = -1
    vals = _t(np.random.RandomState(6).randn(a, 2).astype(np.float32)).requires_grad_(True)
    out = pbr.bucket_lane_values(vals, pt.keys, pt.atom_of_slot, slot_of_atom, pt.wrapshift)
    assert (out[3] == 0).all()
    (g,) = torch.autograd.grad(out.sum(), vals)
    assert torch.isfinite(g).all()
    assert 27 * 256 * 9 * 4 > pbr.MAX_SHARED_BYTES > 27 * 256 * 5 * 4
