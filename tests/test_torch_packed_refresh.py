"""PyTorch port: the atom-packed bucket refresh (`pack_tables`,
`packed_nbr_pos`; kernels K5f and K5b) against the JAX package, on the CPU.

Tolerances: `choose_span` and every integer table of `pack_tables` are equal,
``wrap_offset`` agrees to atol 1e-6; the plain selection equals the Pallas
kernel in interpret mode exactly and its transpose to atol 1e-6 (another order
of the sums); refreshed positions agree with the cached diffs to 2e-4 A
(coordinates drift up to two boxes out, as ``tests/test_bucket_refresh.py``)
and with the slot-row refresh exactly; gradients agree to 1e-5 of their scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchani_tpu.bucket_refresh as jbr
import torchani_tpu.bucket_refresh_packed as jbp
import torchani_tpu_torch.bucket_refresh as pbr
import torchani_tpu_torch.bucket_refresh_packed as pbp
from test_torch_bucket_refresh import _both_tables, _random_periodic_topology, _t

torch.set_num_threads(2)
FIELDS = (
    "keys_flat", "tile_bucket", "atom_of_row", "row_of_atom", "atom_of_slot", "slot_of_atom",
    "wrapshift",
)


def _setup(seed, c=32):
    topo = _random_periodic_topology(seed)
    coords, _, grid = topo[0], topo[1], topo[2]
    pt, povf, jt, jovf = _both_tables(topo, grid, c)
    assert not povf and not jovf
    a = coords.shape[0]
    g = int(np.prod(grid))
    counts = (pt.atom_of_slot.numpy() < a).reshape(g, c).sum(axis=1)
    span = pbp.choose_span(grid, counts, c)
    assert span == jbp.choose_span(grid, counts, c)
    packed, ovf = pbp.pack_tables(pt, *span)
    jpacked, jo = jbp.pack_tables(jt, *span)
    assert not bool(ovf) and not bool(jo)
    return topo, pt, jt, packed, jpacked


@pytest.fixture(scope="module", params=[0, 3])
def packed_setup(request):
    return _setup(request.param)


def test_pack_tables_match_jax_field_by_field(packed_setup):
    _, _, _, packed, jpacked = packed_setup
    for name in FIELDS:
        np.testing.assert_array_equal(
            getattr(packed, name).numpy(), np.asarray(getattr(jpacked, name)), err_msg=name
        )
    np.testing.assert_allclose(
        packed.wrap_offset.numpy(), np.asarray(jpacked.wrap_offset), atol=1e-6
    )
    assert packed.keys_flat.dtype == packed.tile_bucket.dtype == torch.int32
    assert packed.keys_flat.is_contiguous() and packed.tile_bucket.is_contiguous()


@pytest.mark.parametrize("grid,counts,c,kl", [
    ((3, 3, 3), np.arange(27) % 7 + 3, 16, 128),
    ((5, 5, 5), np.full(125, 80), 112, 384),
    ((7, 7, 7), np.arange(343) % 30 + 20, 64, 128),
])
def test_choose_span_matches_jax(grid, counts, c, kl):
    assert pbp.choose_span(grid, counts, c, kl) == jbp.choose_span(grid, counts, c, kl)
    with pytest.raises(ValueError, match="fits"):
        pbp.choose_span(grid, counts, c, kl, budget=1000)
    with pytest.raises(ValueError, match="shape"):
        pbp.choose_span(grid, counts[:-1], c, kl)


def _jax_cand16(cand):
    """``(G, 27, C, 3)`` -> the TPU kernel's three bf16 ``(G, 96, C)`` planes."""
    g, _, c, _ = cand.shape
    cand3 = np.zeros((g, 3, 32, c), np.float32)
    cand3[:, :, :27] = cand.transpose(0, 3, 1, 2)
    return jbr._split3(jnp.asarray(cand3.reshape(g, 96, c)))


def test_packed_select_references_match_jax_kernels(packed_setup):
    """The plain versions against the Pallas kernels in interpret mode, on
    real tables: the forward exactly, the backward to atol 1e-6."""
    _, _, _, packed, jpacked = packed_setup
    _, g, c, ns, s_cap, kl = pbp._statics(packed)
    rng = np.random.RandomState(8)
    cand = (rng.randn(g, 27, c, 3) * 20.0).astype(np.float32)
    ref = jbp._packed_select_fwd(_jax_cand16(cand), jpacked.keys_flat, jpacked.tile_bucket)
    ref = np.asarray(ref)[:, :3].transpose(0, 2, 1)  # (ns, S_cap * KL, 3)
    out = pbp.packed_select_reference(_t(cand), packed.keys_flat, packed.tile_bucket).numpy()
    assert out.shape == (ns, s_cap * kl, 3)
    assert np.abs(out - ref).max() == 0.0

    gt = rng.randn(ns, s_cap * kl, 3).astype(np.float32)
    hi, mid, lo = jbr._split3(jnp.asarray(gt.transpose(0, 2, 1)))
    g16 = jnp.pad(jnp.concatenate([hi, mid, lo], axis=1), ((0, 0), (0, 7), (0, 0)))
    jd = jbp._packed_select_bwd(g16, jpacked.keys_flat, jpacked.tile_bucket, c, g)
    jd = np.asarray(jd).reshape(g, 3, 32, c)[:, :, :27].transpose(0, 2, 3, 1)
    d = pbp.packed_select_bwd_reference(_t(gt), packed.keys_flat, packed.tile_bucket, c, g)
    assert d.shape == (g, 27, c, 3)
    np.testing.assert_allclose(d.numpy(), jd, atol=1e-6, rtol=0)

    # the wrappers take the plain versions for CPU tensors, and count nothing
    before = pbp.packed_select_fwd.launches, pbp.packed_select_bwd.launches
    via = pbp.packed_select_fwd(_t(cand), packed.keys_flat, packed.tile_bucket)
    via_b = pbp.packed_select_bwd(_t(gt), packed.keys_flat, packed.tile_bucket, c, g)
    assert (pbp.packed_select_fwd.launches, pbp.packed_select_bwd.launches) == before
    np.testing.assert_array_equal(via.numpy(), out)
    np.testing.assert_array_equal(via_b.numpy(), d.numpy())

    # <K5f(cand), w> == <cand, K5b(w)>
    lhs = (pbp.packed_select_reference(_t(cand).double(), packed.keys_flat, packed.tile_bucket)
           * _t(gt).double()).sum()
    rhs = (_t(cand).double() * pbp.packed_select_bwd_reference(
        _t(gt).double(), packed.keys_flat, packed.tile_bucket, c, g)).sum()
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-12)


def test_packed_nbr_pos_matches_bucket(packed_setup):
    """Atom-packed forward == slot-row forward == cached gather diffs == JAX."""
    (coords, _, _, idx, mask, _, diff_ref), pt, _, packed, jpacked = packed_setup
    k = idx.shape[1]
    canon = _t(coords) - packed.wrap_offset
    nbr = pbp.packed_nbr_pos(canon, packed)
    assert nbr.shape == (coords.shape[0], -(-k // 128) * 128, 3)
    nbr = nbr[:, :k]
    m = _t(mask)[..., None]
    diff = torch.where(m, nbr - canon[:, None, :], 0.0)
    assert float((diff - _t(diff_ref)).abs().max()) < 2e-4
    nbr_slot = pbr.bucket_nbr_pos(
        canon, pt.keys, pt.atom_of_slot, pt.slot_of_atom, pt.wrapshift
    )
    assert float(torch.where(m, nbr - nbr_slot, 0.0).abs().max()) == 0.0
    jnbr = jbp.packed_nbr_pos(jnp.asarray(canon.numpy()), jpacked)[:, :k]
    assert float(np.abs(np.where(mask[..., None], nbr.numpy() - np.asarray(jnbr), 0.0)).max()) == 0.0


def test_packed_nbr_pos_backward_matches_gather():
    (coords, _, _, idx, mask, shift, _), _, _, packed, jpacked = _setup(1)
    a, k = idx.shape
    w = np.random.RandomState(7).randn(a, k, 3).astype(np.float32)
    m = _t(mask)[..., None]
    idx_safe = _t(np.where(mask, idx, 0), torch.int64)

    def loss_packed(crd):
        canon = crd - packed.wrap_offset
        nbr = pbp.packed_nbr_pos(canon, packed)[:, :k]
        return (torch.where(m, nbr - canon[:, None, :], 0.0) * _t(w)).sum()

    def loss_gather(crd):
        d = crd[idx_safe] - crd[:, None, :] + _t(shift)
        return (torch.where(m, d, 0.0) * _t(w)).sum()

    grads = []
    for loss in (loss_packed, loss_gather):
        c = _t(coords).requires_grad_(True)
        grads.append(torch.autograd.grad(loss(c), c)[0])
    scale = float(grads[1].abs().max()) + 1e-9
    assert float((grads[0] - grads[1]).abs().max()) / scale < 1e-5

    def jloss(crd):
        canon = crd - jpacked.wrap_offset
        nbr = jbp.packed_nbr_pos(canon, jpacked)[:, :k]
        return jnp.sum(jnp.where(mask[..., None], nbr - canon[:, None, :], 0.0) * w)

    jg = np.asarray(jax.grad(jloss)(jnp.asarray(coords)))
    assert float(np.abs(grads[0].numpy() - jg).max()) / scale < 1e-5


def test_pack_tables_span_overflow_guard():
    """On span overflow: flag set, and rows never collide across spans (an
    overflowing span must not corrupt its neighbor's atoms); the same tables
    as the JAX package's."""
    topo = _random_periodic_topology(4)
    pt, povf, jt, _ = _both_tables(topo, topo[2], 32)
    assert not povf
    packed, ovf = pbp.pack_tables(pt, 1, 8)  # far below occupancy
    jpacked, jovf = jbp.pack_tables(jt, 1, 8)
    assert bool(ovf) and bool(jovf)
    row_of_atom = packed.row_of_atom.numpy()
    atom_of_row = packed.atom_of_row.numpy()
    kept = np.where(row_of_atom >= 0)[0]
    assert len(set(row_of_atom[kept])) == len(kept)
    assert (atom_of_row[row_of_atom[kept]] == kept).all()
    np.testing.assert_array_equal(row_of_atom, np.asarray(jpacked.row_of_atom))
    with pytest.raises(ValueError, match="must divide"):
        pbp.pack_tables(pt, 5, 8)
