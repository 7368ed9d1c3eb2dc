"""PyTorch port: the kernels' wrappers and, on the card, the CUDA kernels:
the fused angular AEV (K3), its backward (K3b) and K3b's backward (K3bb),
the bucket refresh's
selection and its transpose (K1, K2), the same for P channels of runtime
values (K4f, K4b) and over atom-packed rows (K5f, K5b).

This file imports no JAX, so the tests marked ``cuda`` also run on a
machine with a GPU and no JAX::

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

K3 against its plain version: atol 1e-5, rtol 1e-4 (f32 sums over the
neighbour pairs in another order, as in tests/test_pallas.py).  K3b
against its plain version: |k - p| <= 1e-5 max|p| + 1e-4 |p| (its sums run
over shared-memory atomics, in an order that changes from run to run), and
exact zeros on masked lanes; K3bb the same on each of its three outputs.  K1 is a
selection: exactly equal.  K2 sums with atomics in shared memory, in an
order that changes from run to run: atol 1e-5 + 1e-5 |p|.  K4f and K5f are
selections (exactly equal), K4b and K5b sum as K2 does (the same bound).
"""

import dataclasses

import numpy as np
import pytest
import torch

from torchani_tpu_torch.aev import AEVComputer, angular_aev, angular_aev_reference
from torchani_tpu_torch.aev import kernels as kernels_module
from torchani_tpu_torch.aev.kernels import (
    angular_aev_bwd,
    angular_aev_bwd_bwd,
    angular_aev_bwd_bwd_reference,
    bwd_launch_shape as k3b_launch_shape,
    angular_aev_bwd_reference,
    angular_grid,
    lane_species,
)
from torchani_tpu_torch.aev.terms import ANIAngular
from torchani_tpu_torch.bucket_refresh import (
    BLOCK_RESERVED_BYTES,
    CLUSTER_SPLITS,
    MAX_FWD_SPLIT,
    MAX_SHARED_BYTES,
    SM_SHARED_BYTES,
    SM_THREADS,
    SPLIT_THREADS,
    _cluster_split,
    _fwd_split,
    _one_wave,
    _packed_smem,
    _packed_split,
    bucket_nbr_pos,
    bucket_select_bwd,
    bucket_select_bwd_reference,
    bucket_select_fwd,
    bucket_select_reference,
    bwd_launch_shape,
    fwd_launch_shape,
    make_wrapshift,
    packed_launch_shape,
    tables_from_cell_aux,
    vals_select_bwd,
    vals_select_bwd_reference,
    vals_select_fwd,
    vals_select_reference,
)
from torchani_tpu_torch.bucket_refresh_packed import (
    pack_tables,
    packed_nbr_pos,
    packed_select_bwd,
    packed_select_bwd_reference,
    packed_select_fwd,
    packed_select_reference,
)
from torchani_tpu_torch.grad import energies_and_forces
from torchani_tpu_torch.models import ANI2x
from torchani_tpu_torch.neighbors import CellList, _static_grid_shape, cell_list
from torchani_tpu_torch.testing import make_water_box

torch.set_num_threads(2)
ATOL, RTOL = 1e-5, 1e-4


def _kwargs(version: str, cutoff_fn: str, num_species: int) -> dict:
    ang = getattr(ANIAngular, version)(cutoff_fn, device="cpu")
    return dict(
        eta=float(ang.eta[0]), zeta=float(ang.zeta[0]),
        shifts=tuple(ang.shifts.tolist()), sections=tuple(ang.sections.tolist()),
        cutoff=ang.cutoff, cutoff_kind=cutoff_fn, num_species=num_species,
    )


def _lanes(n: int, ka: int, s: int, seed: int, device: str = "cpu"):
    """Random angular lanes: masked ones hold dist 1.0, diff 0 and an
    all-zero one-hot; every 7th row is fully masked."""
    rng = np.random.RandomState(seed)
    dist = rng.uniform(0.8, 3.4, (n, ka)).astype(np.float32)
    diff = rng.randn(n, ka, 3).astype(np.float32)
    diff *= (dist / np.linalg.norm(diff, axis=-1))[..., None]
    mask = rng.rand(n, ka) < 0.7
    mask[::7] = False
    oh = np.eye(s, dtype=np.float32)[rng.randint(0, s, (n, ka))] * mask[..., None]
    arrays = (np.where(mask, dist, 1.0).astype(np.float32), diff * mask[..., None], mask, oh)
    return [torch.as_tensor(a, device=device) for a in arrays]


CASES = [("like_2x", "cosine", 7), ("like_1x", "smooth", 4), ("like_2x", "smooth", 2)]


@pytest.mark.parametrize("version,cutoff_fn,ns", CASES)
def test_wrapper_takes_plain_version_on_cpu(version, cutoff_fn, ns, monkeypatch):
    """On CPU tensors the wrapper calls `angular_aev_reference` once, with
    its own arguments, returns that output as it is and launches nothing.
    A fresh call agrees within atol 1e-6 (its einsums may round otherwise
    from one call to the next), and rows without a pair are exact zeros."""
    kw = _kwargs(version, cutoff_fn, ns)
    lanes = _lanes(50, 12, ns, seed=0)
    calls = []

    def spy(*args, **kwargs):
        calls.append((args, kwargs, angular_aev_reference(*args, **kwargs)))
        return calls[-1][2]

    monkeypatch.setattr(kernels_module, "angular_aev_reference", spy)
    before = angular_aev.launches
    out = angular_aev(*lanes, **kw)
    assert angular_aev.launches == before
    assert len(calls) == 1
    args, kwargs, spied = calls[0]
    assert out is spied
    assert all(a is b for a, b in zip(args, lanes)) and len(args) == len(lanes)
    assert kwargs == kw
    np.testing.assert_allclose(
        out.numpy(), angular_aev_reference(*lanes, **kw).numpy(), atol=1e-6, rtol=0
    )
    assert out.shape == (50, ns * (ns + 1) // 2 * 32)
    assert (out[::7] == 0).all()


def test_wrapper_rejects_other_devices():
    lanes = [t.to("meta") for t in _lanes(4, 3, 4, seed=1)]
    with pytest.raises(ValueError):
        angular_aev(*lanes, **_kwargs("like_1x", "cosine", 4))


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("version,cutoff_fn,ns", CASES)
@pytest.mark.parametrize("n,ka", [(257, 19), (64, 40)])
def test_kernel_matches_plain_on_card(version, cutoff_fn, ns, n, ka):
    _cuda()
    kw = _kwargs(version, cutoff_fn, ns)
    lanes = _lanes(n, ka, ns, seed=2, device="cuda")
    before = angular_aev.launches
    out = angular_aev(*lanes, **kw)
    torch.cuda.synchronize()
    assert angular_aev.launches == before + 1
    ref = angular_aev_reference(*lanes, **kw)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), atol=ATOL, rtol=RTOL)
    assert (out[::7] == 0).all()


@pytest.mark.cuda
def test_kernel_wrapper_checks_on_card():
    _cuda()
    dist, diff, mask, oh = _lanes(8, 5, 4, seed=3, device="cuda")
    kw = _kwargs("like_1x", "cosine", 4)
    with pytest.raises(TypeError):
        angular_aev(dist.double(), diff, mask, oh, **kw)
    with pytest.raises(ValueError):
        angular_aev(dist, diff[:, :4], mask, oh, **kw)
    with pytest.raises(ValueError):
        angular_aev(dist.t().contiguous().t(), diff, mask, oh, **kw)


@pytest.mark.cuda
def test_kernel_strategy_gradients_on_card():
    """E+F through the kernel strategy equal the plain strategy on the card."""
    _cuda()
    species, coords, cell = make_water_box(600)
    model = ANI2x(seed=0, device="cuda")
    model.neighborlist = CellList()
    results = {}
    for strategy in ("cuda", "plain"):
        model.aev_computer.strategy = strategy
        results[strategy] = energies_and_forces(model, species, coords, cell, np.ones(3, bool))
    (e_k, f_k), (e_p, f_p) = results["cuda"], results["plain"]
    np.testing.assert_allclose(e_k.cpu().numpy(), e_p.cpu().numpy(), rtol=1e-6)
    np.testing.assert_allclose(f_k.cpu().numpy(), f_p.cpu().numpy(), atol=1e-5)
    assert isinstance(model.aev_computer, AEVComputer)


# ---- K3b ----


def _cotangent(rows: int, width: int, seed: int, device: str = "cpu") -> torch.Tensor:
    g = np.random.RandomState(seed).randn(rows, width).astype(np.float32)
    return torch.as_tensor(g, device=device)


def _assert_bwd_close(out, ref, mask):
    """|k - p| <= 1e-5 max|p| + 1e-4 |p| for both cotangents, and exact zeros
    on masked lanes."""
    for k, p in zip(out, ref):
        k, p = k.cpu(), p.cpu()
        assert torch.isfinite(k).all()
        assert ((k - p).abs() <= ATOL * p.abs().max() + RTOL * p.abs()).all()
    m = mask.cpu()
    assert (out[0].cpu()[~m] == 0).all() and (out[1].cpu()[~m] == 0).all()


def test_bwd_wrapper_rejects_other_devices():
    kw = _kwargs("like_1x", "cosine", 4)
    lanes = [t.to("meta") for t in _lanes(4, 3, 4, seed=1)]
    with pytest.raises(ValueError):
        angular_aev_bwd(torch.zeros((4, 10 * 32), device="meta"), *lanes, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("version,cutoff_fn,ns", CASES)
@pytest.mark.parametrize("n,ka", [(257, 19), (64, 40)])
def test_bwd_kernel_matches_plain_on_card(version, cutoff_fn, ns, n, ka):
    _cuda()
    kw = _kwargs(version, cutoff_fn, ns)
    lanes = _lanes(n, ka, ns, seed=2, device="cuda")
    g = _cotangent(n, ns * (ns + 1) // 2 * 32, seed=3, device="cuda")
    before = angular_aev_bwd.launches
    out = angular_aev_bwd(g, *lanes, **kw)
    torch.cuda.synchronize()
    assert angular_aev_bwd.launches == before + 1
    _assert_bwd_close(out, angular_aev_bwd_reference(g, *lanes, **kw), lanes[2])
    assert (out[0][::7] == 0).all() and (out[1][::7] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("version,cutoff_fn,ns", CASES)
def test_bwd_kernel_reads_a_column_slice_on_card(version, cutoff_fn, ns):
    """A cotangent that is a column slice of a wider tensor (as the AEV's
    ``cat`` hands it back) gives what its contiguous copy gives."""
    _cuda()
    kw = _kwargs(version, cutoff_fn, ns)
    lanes = _lanes(257, 19, ns, seed=4, device="cuda")
    width = ns * (ns + 1) // 2 * 32
    wide = _cotangent(257, width + 112, seed=5, device="cuda")
    g = wide[:, 112:]
    assert not g.is_contiguous() and g.stride() == (width + 112, 1)
    sliced = angular_aev_bwd(g, *lanes, **kw)
    _assert_bwd_close(sliced, angular_aev_bwd(g.contiguous(), *lanes, **kw), lanes[2])
    _assert_bwd_close(sliced, angular_aev_bwd_reference(g, *lanes, **kw), lanes[2])


@pytest.mark.cuda
@pytest.mark.parametrize("num_shifts,num_sections", [(5, 3), (16, 4)])
def test_kernels_take_other_term_widths_on_card(num_shifts, num_sections):
    """Widths other than ANI's 8 x 4 and 4 x 8 run the kernels' generic
    instantiation: Z = 15 leaves lanes without a feature, Z = 64 gives each
    lane two."""
    _cuda()
    kw = {
        **_kwargs("like_1x", "smooth", 3),
        "shifts": tuple(np.linspace(0.9, 3.2, num_shifts).tolist()),
        "sections": tuple(np.linspace(0.2, 3.0, num_sections).tolist()),
    }
    lanes = _lanes(97, 23, 3, seed=7, device="cuda")
    out = angular_aev(*lanes, **kw)
    np.testing.assert_allclose(
        out.cpu().numpy(), angular_aev_reference(*lanes, **kw).cpu().numpy(), atol=ATOL, rtol=RTOL
    )
    g = _cotangent(97, out.shape[1], seed=8, device="cuda")
    _assert_bwd_close(angular_aev_bwd(g, *lanes, **kw), angular_aev_bwd_reference(g, *lanes, **kw),
                      lanes[2])


def _lanes_with_counts(counts, ka: int, s: int, seed: int, device: str):
    """Lanes whose row i has exactly ``counts[i]`` valid lanes, scattered over
    the row (the rest masked as `_lanes` masks them)."""
    rng = np.random.RandomState(seed)
    n = len(counts)
    mask = np.zeros((n, ka), bool)
    for i, nv in enumerate(counts):
        mask[i, rng.permutation(ka)[:nv]] = True
    elem = rng.randint(0, s, (n, ka))
    oh = np.eye(s, dtype=np.float32)[elem] * mask[..., None]
    d = np.where(mask, rng.uniform(0.8, 3.4, (n, ka)), 1.0).astype(np.float32)
    v = rng.randn(n, ka, 3).astype(np.float32)
    v *= (d / np.linalg.norm(v, axis=-1))[..., None] * mask[..., None]
    return [torch.as_tensor(a, device=device) for a in (d, v, mask, oh)]


@pytest.mark.cuda
@pytest.mark.parametrize("version,cutoff_fn,ns", CASES)
def test_bwd_kernel_rows_of_0_1_2_and_28_lanes_on_card(version, cutoff_fn, ns):
    """Rows with no valid lane (fully masked), one (no pair), two (one pair)
    and all 28 (the water box's Ka, 378 pairs) against the plain version,
    on a column-sliced cotangent; 8 x 4 (like_2x), 4 x 8 (like_1x)."""
    _cuda()
    kw = _kwargs(version, cutoff_fn, ns)
    counts = [0, 1, 2, 28, 0, 2, 28, 1, 17, 28, 3]
    lanes = _lanes_with_counts(counts, 28, ns, seed=21, device="cuda")
    width = ns * (ns + 1) // 2 * 32
    g = _cotangent(len(counts), width + 112, seed=22, device="cuda")[:, 112:]
    out = angular_aev_bwd(g, *lanes, **kw)
    _assert_bwd_close(out, angular_aev_bwd_reference(g, *lanes, **kw), lanes[2])
    for i, nv in enumerate(counts):
        if nv < 2:  # no pair: every lane's cotangent is exactly 0
            assert (out[0][i] == 0).all() and (out[1][i] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("version,cutoff_fn,ns,widths", [
    ("like_2x", "cosine", 7, None), ("like_1x", "smooth", 4, None),
    ("like_1x", "smooth", 3, (5, 3)),
])
def test_bwd_kernel_walks_more_atoms_than_its_grid_on_card(version, cutoff_fn, ns, widths):
    """N past the persistent grid and not a multiple of its warps: warps
    take two or three atoms, the last round ragged; the 8 x 4, 4 x 8 and
    generic (5 x 3) instantiations."""
    _cuda()
    kw = _kwargs(version, cutoff_fn, ns)
    if widths is not None:
        kw["shifts"] = tuple(np.linspace(0.9, 3.2, widths[0]).tolist())
        kw["sections"] = tuple(np.linspace(0.2, 3.0, widths[1]).tolist())
    sh, se = len(kw["shifts"]), len(kw["sections"])
    shape = k3b_launch_shape(10 ** 6, 28, ns, sh, se, "cuda")
    warps = shape["blocks"] * shape["threads"] // 32
    n = 2 * warps + 37
    small = k3b_launch_shape(n, 28, ns, sh, se, "cuda")
    assert small["blocks"] == shape["blocks"] and small["atoms_per_warp"] == 3
    assert k3b_launch_shape(5, 28, ns, sh, se, "cuda")["blocks"] == -(-5 // (warps // shape[
        "blocks"]))
    lanes = _lanes(n, 28, ns, seed=23, device="cuda")
    g = _cotangent(n, ns * (ns + 1) // 2 * sh * se, seed=24, device="cuda")
    before = angular_aev_bwd.launches
    out = angular_aev_bwd(g, *lanes, **kw)
    torch.cuda.synchronize()
    assert angular_aev_bwd.launches == before + 1
    _assert_bwd_close(out, angular_aev_bwd_reference(g, *lanes, atom_block=2048, **kw), lanes[2])
    assert (out[0][::7] == 0).all() and (out[1][::7] == 0).all()


@pytest.mark.cuda
def test_bwd_kernel_wrapper_checks_on_card():
    _cuda()
    dist, diff, mask, oh = _lanes(8, 5, 4, seed=3, device="cuda")
    kw = _kwargs("like_1x", "cosine", 4)
    g = _cotangent(8, 10 * 32, seed=6, device="cuda")
    with pytest.raises(TypeError):
        angular_aev_bwd(g.double(), dist, diff, mask, oh, **kw)
    with pytest.raises(TypeError):
        angular_aev_bwd(g, dist.double(), diff, mask, oh, **kw)
    with pytest.raises(ValueError):
        angular_aev_bwd(g[:, :-1], dist, diff, mask, oh, **kw)
    with pytest.raises(ValueError):
        angular_aev_bwd(g.cpu(), dist, diff, mask, oh, **kw)
    with pytest.raises(ValueError, match="columns"):
        angular_aev_bwd(g.t().contiguous().t(), dist, diff, mask, oh, **kw)
    with pytest.raises(ValueError):
        angular_aev_bwd(g, dist, diff, mask, oh, lane_species(mask, oh).long(), **kw)
    with pytest.raises(ValueError):
        angular_aev_bwd(g, dist, diff[:, :4], mask, oh, **kw)
    with pytest.raises(ValueError, match="shifts"):
        angular_aev_bwd(g, dist, diff, mask, oh, **{**kw, "shifts": tuple(range(17))})


@pytest.mark.cuda
def test_one_ef_launches_k3_and_k3b_once_on_card():
    """E+F through the kernel strategy: one K3 and one K3b launch, and the
    plain grid is never built."""
    _cuda()
    species, coords, cell = make_water_box(600)
    model = ANI2x(seed=0, device="cuda")
    model.neighborlist = CellList()
    energies_and_forces(model, species, coords, cell, np.ones(3, bool))
    before = angular_aev.launches, angular_aev_bwd.launches, angular_grid.calls
    energies_and_forces(model, species, coords, cell, np.ones(3, bool))
    torch.cuda.synchronize()
    after = angular_aev.launches, angular_aev_bwd.launches, angular_grid.calls
    assert tuple(a - b for a, b in zip(after, before)) == (1, 1, 0)


# ---- K3bb ----


def _direction(n: int, ka: int, seed: int, device: str = "cpu"):
    rng = np.random.RandomState(seed)
    return (torch.as_tensor(rng.randn(n, ka).astype(np.float32), device=device),
            torch.as_tensor(rng.randn(n, ka, 3).astype(np.float32), device=device))


def _assert_bwd_bwd_close(out, ref, mask):
    """K3b's tolerance on each of gg, hdist and hdiff, exact zeros on masked
    lanes and on the rows that meet no pair."""
    _assert_bwd_close(out[1:], ref[1:], mask)
    k, p = out[0].cpu(), ref[0].cpu()
    assert torch.isfinite(k).all()
    assert ((k - p).abs() <= ATOL * p.abs().max() + RTOL * p.abs()).all()
    assert (k[::7] == 0).all()


def test_bwd_bwd_wrapper_takes_plain_version_on_cpu():
    kw = _kwargs("like_2x", "cosine", 7)
    lanes = _lanes(30, 9, 7, seed=30)
    g = _cotangent(30, 28 * 32, seed=31)
    u = _direction(30, 9, seed=32)
    before = angular_aev_bwd_bwd.launches
    out = angular_aev_bwd_bwd(g, *lanes, *u, atom_block=7, **kw)
    assert angular_aev_bwd_bwd.launches == before
    for a, b in zip(out, angular_aev_bwd_bwd_reference(g, *lanes, *u, **kw)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError):
        angular_aev_bwd_bwd(g.to("meta"), *(t.to("meta") for t in lanes + list(u)), **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("version,cutoff_fn,ns", CASES)
@pytest.mark.parametrize("n,ka", [(257, 19), (64, 40)])
def test_bwd_bwd_kernel_matches_plain_on_card(version, cutoff_fn, ns, n, ka):
    _cuda()
    kw = _kwargs(version, cutoff_fn, ns)
    lanes = _lanes(n, ka, ns, seed=40, device="cuda")
    width = ns * (ns + 1) // 2 * 32
    g = _cotangent(n, width + 112, seed=41, device="cuda")[:, 112:]
    u = _direction(n, ka, seed=42, device="cuda")
    before = angular_aev_bwd_bwd.launches
    out = angular_aev_bwd_bwd(g, *lanes, *u, **kw)
    torch.cuda.synchronize()
    assert angular_aev_bwd_bwd.launches == before + 1
    _assert_bwd_bwd_close(out, angular_aev_bwd_bwd_reference(g, *lanes, *u, **kw), lanes[2])


@pytest.mark.cuda
@pytest.mark.parametrize("num_shifts,num_sections", [(5, 3), (16, 4)])
def test_bwd_bwd_kernel_takes_other_term_widths_on_card(num_shifts, num_sections):
    _cuda()
    kw = dict(eta=8.0, zeta=14.1, shifts=tuple(np.linspace(0.9, 3.0, num_shifts).tolist()),
              sections=tuple(np.linspace(0.2, 2.9, num_sections).tolist()), cutoff=3.5,
              cutoff_kind="cosine", num_species=3)
    lanes = _lanes(97, 23, 3, seed=43, device="cuda")
    g = _cotangent(97, 6 * num_shifts * num_sections, seed=44, device="cuda")
    u = _direction(97, 23, seed=45, device="cuda")
    out = angular_aev_bwd_bwd(g, *lanes, *u, **kw)
    torch.cuda.synchronize()
    _assert_bwd_bwd_close(out, angular_aev_bwd_bwd_reference(g, *lanes, *u, **kw), lanes[2])


@pytest.mark.cuda
def test_bwd_bwd_kernel_wrapper_checks_on_card():
    _cuda()
    kw = _kwargs("like_1x", "cosine", 4)
    dist, diff, mask, oh = _lanes(8, 5, 4, seed=46, device="cuda")
    g = _cotangent(8, 10 * 32, seed=47, device="cuda")
    u_dist, u_diff = _direction(8, 5, seed=48, device="cuda")
    with pytest.raises(ValueError):
        angular_aev_bwd_bwd(g, dist, diff, mask, oh, u_dist[:, :4].contiguous(), u_diff, **kw)
    with pytest.raises(ValueError):
        angular_aev_bwd_bwd(g, dist, diff, mask, oh, u_dist, u_diff.transpose(0, 1), **kw)
    with pytest.raises(TypeError):
        angular_aev_bwd_bwd(g, dist, diff, mask, oh, u_dist.double(), u_diff, **kw)
    with pytest.raises(ValueError):
        angular_aev_bwd_bwd(g.t(), dist, diff, mask, oh, u_dist, u_diff, **kw)


def _lanes_of_species(rows, ka: int, s: int, seed: int, device: str = "cpu"):
    """Lanes whose row i holds exactly the species ``rows[i]`` on valid lanes
    scattered over the row (the rest masked as `_lanes` masks them)."""
    rng = np.random.RandomState(seed)
    n = len(rows)
    mask = np.zeros((n, ka), bool)
    elem = np.zeros((n, ka), np.int64)
    for i, species in enumerate(rows):
        lanes = rng.permutation(ka)[:len(species)]
        mask[i, lanes] = True
        elem[i, lanes] = species
    oh = np.eye(s, dtype=np.float32)[elem] * mask[..., None]
    d = np.where(mask, rng.uniform(0.8, 3.4, (n, ka)), 1.0).astype(np.float32)
    v = rng.randn(n, ka, 3).astype(np.float32)
    v *= (d / np.linalg.norm(v, axis=-1))[..., None] * mask[..., None]
    return [torch.as_tensor(a, device=device) for a in (d, v, mask, oh)]


def _slots_with_pairs(species, s: int):
    """Packed slots that some pair of these lanes' species meets."""
    counts = np.bincount(np.asarray(species, np.int64), minlength=s)
    slots, slot = set(), 0
    for a in range(s):
        for b in range(a, s):
            if (a != b and counts[a] and counts[b]) or (a == b and counts[a] > 1):
                slots.add(slot)
            slot += 1
    return slots


@pytest.mark.cuda
@pytest.mark.parametrize("version,cutoff_fn,ns", CASES)
def test_bwd_bwd_kernel_rows_of_every_size_and_all_slots_on_card(version, cutoff_fn, ns):
    """K3bb against its plain version on a column-sliced cotangent, on rows
    of 0, 1 and 2 valid lanes, odd and even counts from 3 to 17 (a batch of
    32 pairs then spans up to 4 rounds), one species alone, every species at
    least twice (all ns (ns + 1) / 2 slots met), and all 40 lanes (Ka > 32:
    two chunks of staged lanes, rounds longer than a batch); 8 x 4
    (like_2x), 4 x 8 (like_1x).  gg is exactly 0 in every slot that no pair
    of the row meets, and so are masked lanes and empty rows."""
    _cuda()
    kw = _kwargs(version, cutoff_fn, ns)
    ka, z = 40, 32
    rng = np.random.RandomState(51)
    sizes = [0, 1, 2, 3, 4, 5, 8, 9, 10, 11, 16, 17, 40, 0]
    rows = [list(rng.randint(0, ns, size)) for size in sizes]
    rows += [[0] * 6, list(range(ns)) * 2 + list(rng.randint(0, ns, 5))]
    lanes = _lanes_of_species(rows, ka, ns, seed=52, device="cuda")
    width = ns * (ns + 1) // 2 * z
    g = _cotangent(len(rows), width + 112, seed=53, device="cuda")[:, 112:]
    u = _direction(len(rows), ka, seed=54, device="cuda")
    out = angular_aev_bwd_bwd(g, *lanes, *u, **kw)
    torch.cuda.synchronize()
    ref = angular_aev_bwd_bwd_reference(g, *lanes, *u, **kw)
    _assert_bwd_close(out[1:], ref[1:], lanes[2])
    k, p = out[0].cpu(), ref[0].cpu()
    assert torch.isfinite(k).all()
    assert ((k - p).abs() <= ATOL * p.abs().max() + RTOL * p.abs()).all()
    assert len(_slots_with_pairs(rows[-1], ns)) == ns * (ns + 1) // 2
    for i, species in enumerate(rows):
        met = _slots_with_pairs(species, ns)
        for slot in range(ns * (ns + 1) // 2):
            block = k[i, slot * z:(slot + 1) * z]
            if slot in met:
                assert (block != 0).any(), (i, slot)
            else:
                assert (block == 0).all(), (i, slot)
        if len(species) < 2:
            assert (out[1][i] == 0).all() and (out[2][i] == 0).all()


@pytest.mark.cuda
def test_hessian_launches_k3bb_on_card():
    """A Hessian through the kernel strategy: per chunk of replicated rows
    one K3 and one K3bb launch, K3b twice (the forces' backward and the
    second backward's pass through the AEV), never the plain grid; equal
    to the plain strategy's Hessian on the card."""
    _cuda()
    from torchani_tpu_torch.grad import hessian_rows, hessians

    species = np.array([[8, 1, 1, 8, 1, 1]])
    coords = np.array([[[0.0, 0.0, 0.12], [0.0, 0.76, -0.48], [0.0, -0.76, -0.48],
                        [2.8, 0.1, 0.0], [3.3, 0.8, 0.3], [3.2, -0.7, 0.2]]], dtype=np.float32)
    model = ANI2x(seed=0, device="cuda")
    rows = hessian_rows(1, 6)
    chunks = -(-18 // rows)
    before = (angular_aev.launches, angular_aev_bwd.launches, angular_aev_bwd_bwd.launches,
              angular_grid.calls)
    h_k = hessians(model, species, coords)
    torch.cuda.synchronize()
    after = (angular_aev.launches, angular_aev_bwd.launches, angular_aev_bwd_bwd.launches,
             angular_grid.calls)
    assert tuple(a - b for a, b in zip(after, before)) == (chunks, 2 * chunks, chunks, 0)
    model.aev_computer.strategy = "plain"
    h_p = hessians(model, species, coords)
    np.testing.assert_allclose(h_k.cpu().numpy(), h_p.cpu().numpy(), atol=2e-4, rtol=1e-3)


# ---- K1 and K2 ----


def _select_inputs(g: int, c: int, k: int, seed: int, with_nlanes: bool, device: str):
    """Random candidates, cotangents and keys with repeats: a quarter
    sentinels, or (with ``nlanes``) sentinels exactly past a random number of
    occupied slot rows per bucket, one bucket empty and one full."""
    rng = np.random.RandomState(seed)
    r = c * k
    cand = (rng.randn(g, 27, c, 3) * 20.0).astype(np.float32)
    gout = rng.randn(g, r, 3).astype(np.float32)
    sec = rng.randint(0, 27, (g, r))
    rank = rng.randint(0, c, (g, r))
    nlanes = None
    if with_nlanes:
        occ = rng.randint(0, c + 1, g)
        occ[0], occ[-1] = 0, c
        nlanes = (occ * k).astype(np.int32)
        sec = np.where(np.arange(r)[None, :] < nlanes[:, None], sec, 27)
    else:
        sec = np.where(rng.rand(g, r) < 0.75, sec, 27)
    keys = ((sec << 8) | np.where(sec < 27, rank, 0)).astype(np.int32)
    to = lambda x: None if x is None else torch.as_tensor(x, device=device)  # noqa: E731
    return to(cand), to(gout), to(keys), to(nlanes)


def _occupied(keys, nlanes):
    r = keys.shape[1]
    if nlanes is None:
        return torch.ones_like(keys, dtype=torch.bool)
    return torch.arange(r, device=keys.device)[None, :] < nlanes[:, None]


def test_select_wrappers_check_their_arguments_on_cpu():
    cand, gout, keys, _ = _select_inputs(2, 16, 3, seed=0, with_nlanes=False, device="cpu")
    with pytest.raises(ValueError):
        bucket_select_fwd(cand.to("meta"), keys.to("meta"))
    with pytest.raises(ValueError):
        bucket_select_bwd(gout.to("meta"), keys.to("meta"), 16)


SELECT_SHAPES = [(5, 16, 8), (7, 64, 17), (3, 256, 5)]  # C = 256: 83 KB of shared memory


@pytest.mark.cuda
@pytest.mark.parametrize("with_nlanes", [False, True])
@pytest.mark.parametrize("g,c,k", SELECT_SHAPES)
def test_select_kernel_matches_plain_on_card(g, c, k, with_nlanes):
    _cuda()
    cand, _, keys, nlanes = _select_inputs(g, c, k, 4, with_nlanes, "cuda")
    before = bucket_select_fwd.launches
    out = bucket_select_fwd(cand, keys, nlanes)
    torch.cuda.synchronize()
    assert bucket_select_fwd.launches == before + 1
    ref = bucket_select_reference(cand, keys, nlanes)
    occupied = _occupied(keys, nlanes)
    assert torch.equal(out[occupied], ref[occupied])
    assert (out[occupied & (keys >> 8 == 27)] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("with_nlanes", [False, True])
@pytest.mark.parametrize("g,c,k", SELECT_SHAPES)
def test_select_bwd_kernel_matches_plain_on_card(g, c, k, with_nlanes):
    _cuda()
    _, gout, keys, nlanes = _select_inputs(g, c, k, 5, with_nlanes, "cuda")
    before = bucket_select_bwd.launches
    out = bucket_select_bwd(gout, keys, c, nlanes)
    torch.cuda.synchronize()
    assert bucket_select_bwd.launches == before + 1
    ref = bucket_select_bwd_reference(gout, keys, c, nlanes)
    assert out.shape == (g, 27, c, 3)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), atol=1e-5, rtol=1e-5)
    if with_nlanes:
        assert (out[0] == 0).all()  # an empty bucket still starts from zeros


@pytest.mark.cuda
def test_select_wrappers_check_on_card():
    _cuda()
    cand, gout, keys, nlanes = _select_inputs(4, 16, 6, 6, True, "cuda")
    with pytest.raises(TypeError):
        bucket_select_fwd(cand.double(), keys, nlanes)
    with pytest.raises(TypeError):
        bucket_select_fwd(cand, keys.long(), nlanes)
    with pytest.raises(ValueError):
        bucket_select_fwd(cand[:, :26], keys, nlanes)
    with pytest.raises(ValueError):
        bucket_select_fwd(cand, keys.t().contiguous().t(), nlanes)
    with pytest.raises(ValueError):
        bucket_select_fwd(cand, keys, nlanes[:2])
    with pytest.raises(ValueError):
        bucket_select_bwd(gout[:, :-1], keys, 16, nlanes)
    with pytest.raises(ValueError):
        bucket_select_bwd(gout, keys.cpu(), 16, nlanes)
    with pytest.raises(ValueError):
        bucket_select_bwd(gout, keys, 272, nlanes)


@pytest.mark.cuda
def test_bucket_nbr_pos_gradient_on_card_matches_cpu():
    """The whole refresh and its gradient on a random periodic system whose
    atoms drift out of the box: card (K1, K2) against CPU (plain versions)."""
    _cuda()
    rng = np.random.RandomState(5)
    a, box, cutoff, c = 400, 24.0, 5.2, 32
    coords = (rng.rand(a, 3) * box + rng.randint(-2, 3, (a, 3)) * box).astype(np.float32)
    cell = np.eye(3, dtype=np.float32) * box
    weights = rng.randn(a, 64, 3).astype(np.float32)
    grid = _static_grid_shape(cell, cutoff)
    # one topology, built on the CPU, for both devices
    crd0 = torch.as_tensor(coords)
    nbrs, aux = cell_list(
        cutoff, torch.zeros((1, a), dtype=torch.int64), crd0[None],
        torch.as_tensor(cell), torch.ones(3, dtype=torch.bool),
        capacity=64, bucket_capacity=c, bucket_aux=True,
    )
    assert not bool(nbrs.overflow)
    tables = tables_from_cell_aux(
        aux["keys"], nbrs.mask[0], aux["atom_of_slot"], aux["slot_of_atom"],
        crd0 - aux["central"], torch.as_tensor(make_wrapshift(grid, cell)), c,
    )
    results = {}
    for dev in ("cuda", "cpu"):
        t = {f.name: getattr(tables, f.name).to(dev) for f in dataclasses.fields(tables)}
        mask = nbrs.mask[0].to(dev)
        crd = crd0.to(dev).requires_grad_(True)
        canon = crd - t["wrap_offset"]
        launches = (bucket_select_fwd.launches, bucket_select_bwd.launches)
        nbr = bucket_nbr_pos(
            canon, t["keys"], t["atom_of_slot"], t["slot_of_atom"], t["wrapshift"]
        )
        diff = torch.where(mask[..., None], nbr - canon[:, None, :], 0.0)
        (grad,) = torch.autograd.grad((diff * torch.as_tensor(weights, device=dev)).sum(), crd)
        rose = (bucket_select_fwd.launches - launches[0], bucket_select_bwd.launches - launches[1])
        assert rose == ((1, 1) if dev == "cuda" else (0, 0))
        assert (diff.detach().cpu() - nbrs.diff[0]).abs().max() < 2e-4
        results[dev] = (diff.detach().cpu().numpy(), grad.cpu().numpy())
    np.testing.assert_array_equal(results["cuda"][0], results["cpu"][0])
    scale = np.abs(results["cpu"][1]).max()
    np.testing.assert_allclose(results["cuda"][1] / scale, results["cpu"][1] / scale, atol=1e-5)


# ---- K4f and K4b ----


def _vals_inputs(g, c, k, p, seed, with_nlanes, device):
    """`_select_inputs` with P value channels in place of 3."""
    _, _, keys, nlanes = _select_inputs(g, c, k, seed, with_nlanes, device)
    rng = np.random.RandomState(seed + 100)
    cand = torch.as_tensor((rng.randn(g, 27, c, p) * 20.0).astype(np.float32), device=device)
    gout = torch.as_tensor(rng.randn(g, c * k, p).astype(np.float32), device=device)
    return cand, gout, keys, nlanes


def test_vals_and_packed_wrappers_check_their_arguments_on_cpu():
    cand, gout, keys, _ = _vals_inputs(2, 16, 3, 2, seed=0, with_nlanes=False, device="cpu")
    with pytest.raises(ValueError):
        vals_select_fwd(cand.to("meta"), keys.to("meta"))
    with pytest.raises(ValueError):
        vals_select_bwd(gout.to("meta"), keys.to("meta"), 16)
    with pytest.raises(ValueError):
        packed_select_fwd(cand.to("meta"), keys.to("meta"), keys.to("meta"))
    with pytest.raises(ValueError):
        packed_select_bwd(gout.to("meta"), keys.to("meta"), keys.to("meta"), 16, 2)


# C = 256 at P = 5: 138 KB of shared memory; C = 112, P = 5: 60 KB
VALS_SHAPES = [(5, 16, 8, 1), (7, 64, 17, 2), (4, 112, 9, 5), (3, 256, 5, 5), (3, 256, 3, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("with_nlanes", [False, True])
@pytest.mark.parametrize("g,c,k,p", VALS_SHAPES)
def test_vals_select_kernel_matches_plain_on_card(g, c, k, p, with_nlanes):
    """Random keys with repeats and sentinels; with ``nlanes`` one bucket is
    empty (its lanes are all sentinels) and one full."""
    _cuda()
    cand, _, keys, nlanes = _vals_inputs(g, c, k, p, 4, with_nlanes, "cuda")
    before = vals_select_fwd.launches
    out = vals_select_fwd(cand, keys, nlanes)
    torch.cuda.synchronize()
    assert vals_select_fwd.launches == before + 1
    ref = vals_select_reference(cand, keys, nlanes)
    occupied = _occupied(keys, nlanes)
    assert out.shape == (g, c * k, p)
    assert torch.equal(out[occupied], ref[occupied])
    assert (out[occupied & (keys >> 8 == 27)] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("with_nlanes", [False, True])
@pytest.mark.parametrize("g,c,k,p", VALS_SHAPES)
def test_vals_select_bwd_kernel_matches_plain_on_card(g, c, k, p, with_nlanes):
    _cuda()
    _, gout, keys, nlanes = _vals_inputs(g, c, k, p, 5, with_nlanes, "cuda")
    before = vals_select_bwd.launches
    out = vals_select_bwd(gout, keys, c, nlanes)
    torch.cuda.synchronize()
    assert vals_select_bwd.launches == before + 1
    ref = vals_select_bwd_reference(gout, keys, c, nlanes)
    assert out.shape == (g, 27, c, p)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), atol=1e-5, rtol=1e-5)
    if with_nlanes:
        assert (out[0] == 0).all()  # an empty bucket still starts from zeros


@pytest.mark.cuda
def test_vals_select_all_sentinels_and_one_repeated_key_on_card():
    _cuda()
    g, c, k, p = 3, 32, 4, 5
    cand, gout, keys, _ = _vals_inputs(g, c, k, p, 6, False, "cuda")
    keys[0] = 27 << 8  # a bucket of sentinels only
    keys[1] = (13 << 8) | 7  # every lane of a bucket points at one candidate
    out = vals_select_fwd(cand, keys)
    assert (out[0] == 0).all() and torch.equal(out[1], cand[1, 13, 7].expand(c * k, p))
    d = vals_select_bwd(gout, keys, c)
    assert (d[0] == 0).all()
    np.testing.assert_allclose(
        d[1, 13, 7].cpu().numpy(), gout[1].sum(0).cpu().numpy(), atol=1e-4, rtol=1e-5
    )
    assert int((d[1] != 0).any(-1).sum()) == 1


@pytest.mark.cuda
def test_vals_select_wrappers_check_on_card():
    _cuda()
    cand, gout, keys, nlanes = _vals_inputs(4, 16, 6, 2, 6, True, "cuda")
    with pytest.raises(TypeError):
        vals_select_fwd(cand.double(), keys, nlanes)
    with pytest.raises(TypeError):
        vals_select_fwd(cand, keys.long(), nlanes)
    with pytest.raises(ValueError):
        vals_select_fwd(cand[:, :26], keys, nlanes)
    with pytest.raises(ValueError, match="contiguous"):
        vals_select_fwd(cand.transpose(2, 3).contiguous().transpose(2, 3), keys, nlanes)
    with pytest.raises(ValueError, match="contiguous"):
        vals_select_bwd(gout, keys.t().contiguous().t(), 16, nlanes)
    with pytest.raises(ValueError):
        vals_select_bwd(gout[:, :-1], keys, 16, nlanes)
    with pytest.raises(ValueError):
        vals_select_bwd(gout, keys, 272, nlanes)
    wide = torch.zeros((1, 27, 256, 9), device="cuda")
    with pytest.raises(ValueError, match="shared memory"):
        vals_select_fwd(wide, torch.zeros((1, 256), dtype=torch.int32, device="cuda"))
    with pytest.raises(ValueError, match="shared memory"):
        vals_select_bwd(torch.zeros((1, 256, 9), device="cuda"),
                        torch.zeros((1, 256), dtype=torch.int32, device="cuda"), 256)


# ---- K1: each bucket's lanes split over S independent blocks ----

#: the water box's K1 tables (G, C, K): ANI-2x MD, ANI-2dr MD, and the MTS
#: fast lane's 7 x 7 x 7 grid at K = 112
K1_TABLES = [(343, 64, 104), (125, 96, 336), (343, 64, 112)]


@pytest.mark.parametrize("g,c,k", K1_TABLES)
def test_fwd_split_fills_an_h100_in_one_wave(g, c, k):
    """At the water box's tables every block is on an H100's 132 SMs at
    once, every SM holds one at least, the block is the largest that allows
    this, and S + 1 would need a second wave."""
    tile = 27 * c * 3 * 4
    threads, s = _fwd_split(g, c * k, tile, 132)
    per_sm = min(SM_THREADS // threads, SM_SHARED_BYTES // (tile + BLOCK_RESERVED_BYTES))
    assert threads in SPLIT_THREADS and 1 <= s <= MAX_FWD_SPLIT
    assert 132 <= g * s <= 132 * per_sm
    assert g * (s + 1) > 132 * per_sm
    assert threads == SPLIT_THREADS[0] or g > 132 * (SM_THREADS // SPLIT_THREADS[0])


@pytest.mark.parametrize("g,tile,want", [
    (125, 27 * 96 * 12, (1024, 2)),  # the ANI-2dr tables: 264 blocks of 1,024 fit
    (343, 27 * 64 * 12, (512, 1)),  # the ANI-2x tables: only 512 fits 343 blocks
    (16, 27 * 64 * 12, (1024, 16)),  # few buckets: 264 blocks over 16
    (2 * 10 ** 5, 27 * 64 * 12, (1024, 1)),  # no size holds them: one block each
])
def test_one_wave_cases(g, tile, want):
    """K1's and K2's launch shapes start from one rule on 132 SMs: the block
    size, and the most blocks a bucket may have with every block resident;
    both pickers take that block size."""
    assert _one_wave(g, tile, 132) == want
    assert _cluster_split(g, tile, 132)[0] == want[0] == _fwd_split(g, 10 ** 6, tile, 132)[0]


@pytest.mark.parametrize("g,r,tile,want", [
    (125, 96 * 336, 27 * 96 * 12, (1024, 2)),  # the ANI-2dr tables: 250 blocks
    (343, 64 * 104, 27 * 64 * 12, (512, 1)),  # the ANI-2x tables: 343 blocks of 512
    (343, 64 * 112, 27 * 64 * 12, (512, 1)),  # the MTS fast lane
    (1, 96 * 336, 27 * 96 * 12, (1024, 31)),  # one bucket: a lane a thread
    (1, 10 ** 6, 1024, (1024, MAX_FWD_SPLIT)),
    (5, 256 * 5, 27 * 256 * 12, (1024, 1)),  # C = 256: too few lanes to split
    (2, 256 * 40, 27 * 256 * 12, (1024, 10)),  # 83 KB: two blocks an SM
    (2000, 10_000, 1024, (1024, 1)),  # more buckets than one wave holds
])
def test_fwd_split_cases(g, r, tile, want):
    assert _fwd_split(g, r, tile, 132) == want


def test_fwd_split_refuses_a_tile_past_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        _fwd_split(4, 1024, MAX_SHARED_BYTES + 4, 132)


def _k1_at(cand, keys, nlanes, split: int, threads: int, fill: float = 1234.5):
    """K1 at an explicit launch shape into an output filled with ``fill``."""
    from torchani_tpu_torch.bucket_refresh import _launch

    g, _, c, _ = cand.shape
    out = torch.full((g, keys.shape[1], 3), fill, device=cand.device)
    _launch("bucket_select_fwd", cand, keys, nlanes, out, g, c, keys.shape[1], split, threads)
    torch.cuda.synchronize()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("g,c,k", [(6, 64, 104), (3, 96, 336), (2, 256, 40), (5, 6, 3),
                                   (4, 10, 4), (7, 16, 9)])
@pytest.mark.parametrize("threads,split", [(512, 1), (512, 3), (512, 64), (1024, 1),
                                           (1024, 2), (1024, 7)])
def test_select_kernel_split_leaves_lanes_past_nlanes_untouched_on_card(g, c, k, threads, split):
    """K1 over S blocks of each size: an empty bucket, buckets of 1 lane and
    of lane counts that are not multiples of 4, full ones; exact on every
    occupied lane and never writing past ``nlanes``.  C = 6 and C = 10 load
    the tile 4 bytes at a time, the rest 16 bytes at a time."""
    _cuda()
    cand, _, keys, nlanes = _select_inputs(g, c, k, 30, True, "cuda")
    r = c * k
    counts = [0, 1, r, 5, r - 3, 2, 4 * (r // 8) + 1][:g]
    nlanes = torch.tensor(counts, dtype=torch.int32, device="cuda")
    lane = torch.arange(r, device="cuda")[None, :]
    keys = torch.where(lane < nlanes[:, None], keys, 27 << 8).to(torch.int32).contiguous()
    ref = bucket_select_reference(cand, keys, nlanes)
    out = _k1_at(cand, keys, nlanes, split, threads)
    occupied = _occupied(keys, nlanes)
    assert torch.equal(out[occupied], ref[occupied])
    assert (out[~occupied] == 1234.5).all()


@pytest.mark.cuda
def test_select_kernel_wrapper_splits_and_counts_on_card():
    """Through the wrapper: its launch shape has S > 1 at few buckets, one
    launch counted, an exact selection; no ``nlanes`` selects every lane."""
    _cuda()
    cand, _, keys, nlanes = _select_inputs(3, 64, 104, 31, True, "cuda")
    shape = fwd_launch_shape(3, 64, 64 * 104, cand.device)
    assert shape["split"] > 1 and shape["blocks"] == 3 * shape["split"]
    assert shape["threads"] in SPLIT_THREADS and shape["smem_bytes"] == 27 * 64 * 12
    before = bucket_select_fwd.launches
    out = bucket_select_fwd(cand, keys, nlanes)
    torch.cuda.synchronize()
    assert bucket_select_fwd.launches == before + 1
    occupied = _occupied(keys, nlanes)
    assert torch.equal(out[occupied], bucket_select_reference(cand, keys, nlanes)[occupied])
    full = bucket_select_fwd(cand, keys)
    assert torch.equal(full, bucket_select_reference(cand, keys))


# ---- K2 and K4b: each bucket's lanes split over a thread-block cluster ----

#: the water box's tables: ANI-2x (G = 343, C = 64) and ANI-2dr (G = 125,
#: C = 96); K2's tile has 3 channels, K4b's 5 (D3's default) or 1 (frozen)
WATER_BOX_TILES = [(343, 64, 3), (125, 96, 3), (125, 96, 5), (125, 96, 1), (343, 96, 3)]


@pytest.mark.parametrize("g,c,p", WATER_BOX_TILES)
def test_cluster_split_fills_an_h100_in_one_wave(g, c, p):
    """At the water box's shapes every block is on an H100's 132 SMs at
    once, every SM holds one at least, the block is the largest that allows
    this and the next larger S would need a second wave."""
    tile = 27 * c * p * 4
    threads, s = _cluster_split(g, tile, 132)
    assert s in CLUSTER_SPLITS and threads in SPLIT_THREADS and tile <= MAX_SHARED_BYTES
    resident = 132 * (2048 // threads)  # these tiles fit that many blocks an SM
    assert 132 <= g * s <= resident
    assert s == CLUSTER_SPLITS[-1] or g * 2 * s > resident
    assert threads == SPLIT_THREADS[0] or g > 132 * (2048 // SPLIT_THREADS[0])


@pytest.mark.parametrize("g,tile,want", [
    (1, 27 * 96 * 3 * 4, (1024, 8)),  # one bucket: the largest cluster
    (125, 27 * 96 * 3 * 4, (1024, 2)),  # the ANI-2dr tables: 250 blocks
    (343, 27 * 64 * 3 * 4, (512, 1)),  # the ANI-2x tables: 343 blocks of 512
    (3, 27 * 256 * 5 * 4, (1024, 8)),  # 138 KB: one block an SM
    (66, 27 * 256 * 5 * 4, (1024, 2)),
    (200, 27 * 256 * 5 * 4, (1024, 1)),  # no block size gives one wave
    (33, 1024, (1024, 8)),  # 264 blocks: exactly one wave
    (10_000, 1024, (1024, 1)),
])
def test_cluster_split_cases(g, tile, want):
    assert _cluster_split(g, tile, 132) == want


def test_cluster_split_refuses_a_tile_past_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        _cluster_split(4, MAX_SHARED_BYTES + 4, 132)


@pytest.mark.parametrize("p", [3, 5, 1])
def test_bwd_wrappers_take_plain_version_on_cpu(p):
    """On CPU tensors K2 and K4b are their plain versions, launch nothing and
    split nothing: an empty bucket among full ones, one candidate repeated."""
    _, _, keys, nlanes = _select_inputs(4, 16, 6, 7, True, "cpu")
    keys[1] = (13 << 8) | 7
    nlanes[1] = keys.shape[1]
    gout = torch.as_tensor(np.random.RandomState(8).randn(4, 96, p).astype(np.float32))
    wrapper, ref = ((bucket_select_bwd, bucket_select_bwd_reference) if p == 3
                    else (vals_select_bwd, vals_select_bwd_reference))
    before = wrapper.launches
    out = wrapper(gout, keys, 16, nlanes)
    assert wrapper.launches == before
    assert torch.equal(out, ref(gout, keys, 16, nlanes))
    assert (out[0] == 0).all()
    torch.testing.assert_close(out[1, 13, 7], gout[1].sum(0))


def _split_case(case: str, p: int):
    """(g_out, keys, nlanes, C) on the card for one cluster-split case.
    Random keys hold the water box's density: about 83% of a bucket's slots
    occupied, 81% of their lanes real (the rest sentinels)."""
    g, c, k = {
        "one_bucket": (1, 96, 336), "ani2dr_tables": (125, 96, 336),
        "ani2x_grid": (343, 96, 336), "empty_bucket": (125, 96, 336),
        "fewer_lanes_than_split": (1, 96, 336), "one_candidate": (2, 96, 336),
        "wide_tile": (3, 256, 5), "many_buckets": (600, 32, 20),
    }[case]
    r, dev = c * k, "cuda"
    gen = torch.Generator(dev).manual_seed(17)
    occ = (torch.rand((g, c), device=dev, generator=gen) < 0.83).sum(1)
    nlanes = (occ * k).to(torch.int32)
    lanes = torch.arange(r, device=dev)
    real = (lanes[None, :] < nlanes[:, None]) & (
        torch.rand((g, r), device=dev, generator=gen) < 0.81)
    sec = torch.randint(0, 27, (g, r), device=dev, generator=gen)
    rank = torch.randint(0, c, (g, r), device=dev, generator=gen)
    keys = torch.where(real, (sec << 8) | rank, 27 << 8).to(torch.int32)
    gout = torch.randn((g, r, p), device=dev, generator=gen)
    if case == "empty_bucket":
        nlanes.fill_(r)
        keys = torch.where(keys == 27 << 8, (sec << 8) | rank, keys).to(torch.int32)
        nlanes[7], keys[7] = 0, 27 << 8
    elif case == "fewer_lanes_than_split":
        nlanes[0] = 3
    elif case == "one_candidate":
        # every lane on one candidate; integer cotangents sum exactly in any order
        nlanes.fill_(r)
        keys.fill_((13 << 8) | 7)
        gout = torch.randint(-8, 9, (g, r, p), device=dev, generator=gen).float()
    return gout, keys.contiguous(), nlanes, c


SPLIT_CASES = ["one_bucket", "ani2dr_tables", "ani2x_grid", "empty_bucket",
               "fewer_lanes_than_split", "one_candidate", "wide_tile", "many_buckets"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SPLIT_CASES)
@pytest.mark.parametrize("p", [3, 5])
def test_select_bwd_cluster_split_matches_plain_on_card(case, p):
    """K2 (P = 3) and K4b (P = 5) over clusters of S blocks, against their
    plain versions (the K2 bound; exact where the sums are of integers).
    ``wide_tile`` is C = 256: 83 KB (K2) and 138 KB (K4b) a block;
    ``ani2x_grid`` takes blocks of 512 threads, ``many_buckets`` more
    blocks than the card holds at once."""
    _cuda()
    gout, keys, nlanes, c = _split_case(case, p)
    g = keys.shape[0]
    wrapper, ref_fn = ((bucket_select_bwd, bucket_select_bwd_reference) if p == 3
                       else (vals_select_bwd, vals_select_bwd_reference))
    shape = bwd_launch_shape(g, c, p, gout.device)
    assert shape["split"] in CLUSTER_SPLITS and shape["blocks"] == g * shape["split"]
    assert shape["threads"] in SPLIT_THREADS
    if g == 1:
        assert shape["split"] == 8
    before = wrapper.launches
    out = wrapper(gout, keys, c, nlanes)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    ref = ref_fn(gout, keys, c, nlanes)
    assert out.shape == (g, 27, c, p)
    if case == "one_candidate":
        assert torch.equal(out, ref)
        assert int((out != 0).any(-1).sum()) == g
    else:
        np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), atol=1e-5, rtol=1e-5)
    if case == "empty_bucket":
        assert (out[7] == 0).all()
    if case == "fewer_lanes_than_split":
        assert int((out != 0).any(-1).sum()) <= 3


# ---- K5f and K5b: each bucket's tiles split over S blocks ----

#: the water box's ANI-2dr packed tables: G = 125 buckets (one a span) of
#: C = 96 slots, 13 tiles each
K5_BOX = (125, 96, 13)


@pytest.mark.parametrize("g,c,tiles,want", [
    (*K5_BOX, (1024, 2)),  # the water box: 250 blocks of 1,024 on 132 SMs
    (5, 256, 3, (1024, 2)),  # C = 256 (83 KB tile): capped by 3 tiles a bucket
    (4, 256, 13, (1024, 8)),  # C = 256, few buckets: the largest cluster
    (66, 256, 13, (1024, 4)),  # C = 256: 264 blocks of 99 KB fill the card
    (2, 96, 1, (1024, 1)),  # one tile a bucket: one block
    (343, 64, 13, (512, 1)),  # only 512 threads put 343 blocks on the card
    (2000, 96, 13, (1024, 1)),  # G past one wave at any block size: one block each
])
def test_packed_split_cases(g, c, tiles, want):
    """K5's launch shape on 132 SMs, a pure function of G, C and the tiles a
    bucket owns: K1's and K2's one-wave rule at K5f's block (its tile and a
    512-byte offset buffer a warp), a cluster size, no more than the tiles."""
    assert _packed_split(g, c, tiles, 132) == want
    assert _one_wave(g, _packed_smem(c, 1024, True), 132)[0] == want[0]


def test_packed_split_fills_an_h100_in_one_wave_at_the_water_box():
    """At the water box every K5 block is resident at once on an H100's 132
    SMs (K5f's block holds its tile and 16 KB of offsets; two fit an SM),
    every SM holds one at least, and the next cluster size would need a
    second wave."""
    g, c, tiles = K5_BOX
    threads, s = _packed_split(g, c, tiles, 132)
    smem = _packed_smem(c, threads, True)
    assert smem == 27 * 96 * 12 + 16 * 1024 and _packed_smem(c, threads, False) == 27 * 96 * 12
    per_sm = min(SM_THREADS // threads, SM_SHARED_BYTES // (smem + BLOCK_RESERVED_BYTES))
    assert per_sm == 2 and 132 <= g * s <= 132 * per_sm < g * 2 * s
    assert s in CLUSTER_SPLITS and s <= tiles


def test_packed_smem_fits_a_block_at_c_256():
    """K5f's block at C = 256 (an 83 KB tile and 16 KB of offsets) fits the
    227 KB of shared memory a block may have, twice on an SM."""
    smem = _packed_smem(256, 1024, True)
    assert smem == 27 * 256 * 12 + 16 * 1024 <= MAX_SHARED_BYTES
    assert SM_SHARED_BYTES // (smem + BLOCK_RESERVED_BYTES) == 2
    # C = 255: 20,655 floats, rounded up to 20,656 so that the buffers start
    # on 16 bytes; 16 bytes of offsets a thread
    assert _packed_smem(255, 512, True) == 20656 * 4 + 512 * 16
    assert _packed_smem(255, 512, False) == 20656 * 4


# ---- K5f and K5b ----


def _packed_system(device: str, a: int = 400, c: int = 32, sb: int = 2, seed: int = 5):
    """Slot-row and atom-packed tables of one random periodic system (built
    on the CPU, moved to ``device``), its coordinates and its mask."""
    rng = np.random.RandomState(seed)
    box, cutoff = 24.0, 5.2
    coords = (rng.rand(a, 3) * box + rng.randint(-2, 3, (a, 3)) * box).astype(np.float32)
    cell = np.eye(3, dtype=np.float32) * box
    grid = _static_grid_shape(cell, cutoff)
    crd = torch.as_tensor(coords)
    nbrs, aux = cell_list(
        cutoff, torch.zeros((1, a), dtype=torch.int64), crd[None],
        torch.as_tensor(cell), torch.ones(3, dtype=torch.bool),
        capacity=64, bucket_capacity=c, bucket_aux=True,
    )
    assert not bool(nbrs.overflow)
    tables = tables_from_cell_aux(
        aux["keys"], nbrs.mask[0], aux["atom_of_slot"], aux["slot_of_atom"],
        crd - aux["central"], torch.as_tensor(make_wrapshift(grid, cell)), c,
    )
    g = int(np.prod(grid))
    occ = (tables.atom_of_slot < a).reshape(g, c).sum(1)
    padded = ((occ + 7) // 8 * 8).reshape(g // sb, sb).sum(1)
    packed, overflow = pack_tables(tables, sb, int(padded.max()) + 8)
    assert not bool(overflow)
    move = lambda t: type(t)(  # noqa: E731
        **{f.name: getattr(t, f.name).to(device) for f in dataclasses.fields(t)}
    )
    return move(tables), move(packed), crd.to(device), nbrs.mask[0].to(device), g, c


def _k5_at(name: str, src, keys_flat, tile_bucket, shape, g: int, c: int, split: int,
           threads: int, fill: float = 1234.5):
    """K5f or K5b at an explicit launch shape into an output filled with
    ``fill``."""
    from torchani_tpu_torch.bucket_refresh_packed import _launch

    ns, n_tiles = tile_bucket.shape
    kl = keys_flat.shape[2] // (8 * n_tiles)
    dst = torch.full(shape, fill, device=src.device)
    _launch(name, src, keys_flat, tile_bucket, dst, ns, g // ns, c, n_tiles, kl, split, threads)
    torch.cuda.synchronize()
    return dst


def _within_sum_tol(out, ref) -> bool:
    """K5b against its plain version: |k - p| <= 1e-5 (1 + |p|)."""
    return bool(((out - ref).abs() <= 1e-5 * (1 + ref.abs())).all())


@pytest.mark.cuda
@pytest.mark.parametrize("sb", [1, 2, 4])
def test_packed_select_kernels_match_plain_on_card(sb):
    """Real tables (grid 4 x 4 x 4; empty buckets, pad tiles of sentinels
    only), random candidates and cotangents: through the wrappers at the
    shape of `packed_launch_shape`, and at every split and block size."""
    _cuda()
    _, packed, _, _, g, c = _packed_system("cuda", sb=sb)
    gen = torch.Generator("cuda").manual_seed(3)
    cand = torch.randn((g, 27, c, 3), device="cuda", generator=gen) * 20.0
    keys, tiles = packed.keys_flat, packed.tile_bucket
    before = packed_select_fwd.launches, packed_select_bwd.launches
    out = packed_select_fwd(cand, keys, tiles)
    ref = packed_select_reference(cand, keys, tiles)
    assert torch.equal(out, ref)
    gout = torch.randn(out.shape, device="cuda", generator=gen)
    d = packed_select_bwd(gout, keys, tiles, c, g)
    torch.cuda.synchronize()
    assert (packed_select_fwd.launches, packed_select_bwd.launches) == (
        before[0] + 1, before[1] + 1
    )
    d_ref = packed_select_bwd_reference(gout, keys, tiles, c, g)
    assert d.shape == (g, 27, c, 3)
    np.testing.assert_allclose(d.cpu().numpy(), d_ref.cpu().numpy(), atol=1e-5, rtol=1e-5)
    shape = packed_launch_shape(g, c, tiles.shape[1] // sb, "cuda")
    assert shape["split"] in CLUSTER_SPLITS and shape["split"] <= max(1, tiles.shape[1] // sb)
    assert shape["blocks"] == g * shape["split"] and shape["threads"] in SPLIT_THREADS
    for threads in SPLIT_THREADS:
        for split in CLUSTER_SPLITS:
            assert torch.equal(_k5_at("packed_select_fwd", cand, keys, tiles, out.shape, g, c,
                                      split, threads), ref)
            assert _within_sum_tol(_k5_at("packed_select_bwd", gout, keys, tiles, d.shape, g, c,
                                          split, threads), d_ref)


@pytest.mark.cuda
@pytest.mark.parametrize("threads", SPLIT_THREADS)
@pytest.mark.parametrize("split", CLUSTER_SPLITS)
def test_packed_select_sentinel_rows_repeats_and_wide_tiles_on_card(split, threads):
    """Hand-made tables at every split and block size: C = 256 (83 KB of
    shared memory); a bucket that owns separate runs of tiles, and one that
    owns fewer tiles than S; a span of sentinels only, whose d_cand tiles
    must be all zeros; one key repeated over a whole tile, and a tile of
    heavily repeated keys (32 candidates for its 1,024 lanes); a tile whose
    id is outside [0, SB), left unwritten and adding nothing."""
    _cuda()
    g, c, ns, n_tiles, kl = 6, 256, 3, 4, 128  # SB = 2
    rng = np.random.RandomState(9)
    tile_lanes = 8 * kl
    lanes = n_tiles * tile_lanes
    sec = np.where(rng.rand(ns, lanes) < 0.8, rng.randint(0, 27, (ns, lanes)), 27)
    keys = (sec << 8) | np.where(sec < 27, rng.randint(0, c, (ns, lanes)), 0)
    keys[1] = 27 << 8
    keys[0, :tile_lanes] = (5 << 8) | 200
    keys[2, tile_lanes: 2 * tile_lanes] = (
        (rng.randint(0, 4, tile_lanes) << 8) | rng.randint(0, 8, tile_lanes)
    )
    keys_flat = torch.as_tensor(keys.astype(np.int32), device="cuda").reshape(ns, 1, lanes)
    # span 0: bucket 1 owns tiles 0, 2 and 3, bucket 0 tile 1 alone; span 2:
    # bucket 4 owns tiles 0 and 3, bucket 5 tile 1, tile 2 has no owner
    tile_bucket = torch.tensor([[1, 0, 1, 1], [0, 0, 1, 1], [0, 1, 5, 0]], dtype=torch.int32,
                               device="cuda")
    owned = (tile_bucket < 2).repeat_interleave(tile_lanes, dim=1)  # (ns, lanes)
    ref_keys = torch.where(owned[:, None], keys_flat, 27 << 8).to(torch.int32)
    ref_tiles = torch.where(tile_bucket < 2, tile_bucket, 0).to(torch.int32)
    cand = torch.as_tensor(rng.randn(g, 27, c, 3).astype(np.float32), device="cuda")
    out = _k5_at("packed_select_fwd", cand, keys_flat, tile_bucket, (ns, lanes, 3), g, c, split,
                 threads)
    ref = packed_select_reference(cand, ref_keys, ref_tiles)
    assert torch.equal(out[owned], ref[owned]) and (out[~owned] == 1234.5).all()
    assert (out[1] == 0).all()
    assert torch.equal(out[0, :tile_lanes], cand[1, 5, 200].expand(tile_lanes, 3))
    gout = torch.as_tensor(rng.randn(ns, lanes, 3).astype(np.float32), device="cuda")
    d = _k5_at("packed_select_bwd", gout, keys_flat, tile_bucket, (g, 27, c, 3), g, c, split,
               threads)
    d_ref = packed_select_bwd_reference(gout, ref_keys, ref_tiles, c, g)
    np.testing.assert_allclose(d.cpu().numpy(), d_ref.cpu().numpy(), atol=1e-4, rtol=1e-5)
    assert _within_sum_tol(d[5], d_ref[5]) and int((d_ref[5] != 0).any(-1).sum()) == 32
    assert (d[2:4] == 0).all()
    if split == 1 and threads == SPLIT_THREADS[0]:
        # the wrappers at their own shape, on the same tables without the
        # ownerless tile
        assert torch.equal(packed_select_fwd(cand, ref_keys, ref_tiles), ref)
        np.testing.assert_allclose(
            packed_select_bwd(gout, ref_keys, ref_tiles, c, g).cpu().numpy(),
            d_ref.cpu().numpy(), atol=1e-4, rtol=1e-5,
        )


@pytest.mark.cuda
def test_packed_select_wrappers_check_on_card():
    _cuda()
    _, packed, _, _, g, c = _packed_system("cuda")
    cand = torch.zeros((g, 27, c, 3), device="cuda")
    keys, tiles = packed.keys_flat, packed.tile_bucket
    gout = torch.zeros((keys.shape[0], keys.shape[2], 3), device="cuda")
    with pytest.raises(TypeError):
        packed_select_fwd(cand.double(), keys, tiles)
    with pytest.raises(TypeError):
        packed_select_fwd(cand, keys.long(), tiles)
    with pytest.raises(ValueError):
        packed_select_fwd(cand, keys[:, 0], tiles)
    with pytest.raises(ValueError, match="contiguous"):
        packed_select_fwd(cand, keys, tiles.t().contiguous().t())
    with pytest.raises(ValueError, match="contiguous"):
        packed_select_bwd(gout.transpose(0, 1).contiguous().transpose(0, 1), keys, tiles, c, g)
    with pytest.raises(ValueError):
        packed_select_bwd(gout[:, :-1], keys, tiles, c, g)
    with pytest.raises(ValueError):
        packed_select_bwd(gout, keys, tiles, c, g + 1)
    with pytest.raises(ValueError):
        packed_select_fwd(cand, keys.cpu(), tiles)
    narrow = keys[:, :, : tiles.shape[1] * 8 * 8].contiguous()  # KL = 8
    with pytest.raises(ValueError, match="multiple of 16"):
        packed_select_fwd(cand, narrow, tiles)
    with pytest.raises(RuntimeError, match="launch"):
        _k5_at("packed_select_bwd", gout, keys, tiles, (g, 27, c, 3), g, c, 3, 1024)
    with pytest.raises(RuntimeError, match="launch"):
        _k5_at("packed_select_fwd", cand, keys, tiles, gout.shape, g, c, 2, 256)


@pytest.mark.cuda
def test_packed_nbr_pos_on_card_matches_slot_refresh_and_cpu():
    """The whole packed refresh and its gradient: card (K5f, K5b) against the
    slot refresh on the card (K1, K2) and against the CPU (plain versions)."""
    _cuda()
    results = {}
    for dev in ("cuda", "cpu"):
        tables, packed, crd, mask, _, _ = _packed_system(dev)
        k = mask.shape[1]
        weights = torch.as_tensor(
            np.random.RandomState(1).randn(crd.shape[0], k, 3).astype(np.float32), device=dev
        )
        crd = crd.requires_grad_(True)
        canon = crd - packed.wrap_offset
        launches = packed_select_fwd.launches, packed_select_bwd.launches
        nbr = packed_nbr_pos(canon, packed)[:, :k]
        diff = torch.where(mask[..., None], nbr - canon[:, None, :], 0.0)
        (grad,) = torch.autograd.grad((diff * weights).sum(), crd)
        rose = (packed_select_fwd.launches - launches[0], packed_select_bwd.launches - launches[1])
        assert rose == ((1, 1) if dev == "cuda" else (0, 0))
        slot = bucket_nbr_pos(
            canon.detach(), tables.keys, tables.atom_of_slot, tables.slot_of_atom,
            tables.wrapshift,
        )
        assert torch.equal(torch.where(mask[..., None], nbr.detach() - slot, 0.0).abs().max(),
                           torch.zeros((), device=dev))
        results[dev] = (diff.detach().cpu().numpy(), grad.cpu().numpy())
    np.testing.assert_array_equal(results["cuda"][0], results["cpu"][0])
    scale = np.abs(results["cpu"][1]).max()
    np.testing.assert_allclose(results["cuda"][1] / scale, results["cpu"][1] / scale, atol=1e-5)
