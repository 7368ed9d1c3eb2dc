"""The fused angular-AEV kernel (K3), its backward (K3b) and their plain
PyTorch versions.

`angular_aev` is the counterpart of ``angular_aev_pallas``
(``torchani_tpu/aev/pallas_kernels.py:120``), with the same signature and the
same ``(N, P * Z)`` pair-major output.  On a CUDA tensor it launches the
hand-written kernel of ``csrc/angular_aev.cu`` (or raises); on a CPU tensor,
and only there, it computes `angular_aev_reference`, the plain
``(N, Ka, Ka, Z)`` formulation of the same function (`angular_grid`, which
the AEV computer's plain path also runs, with any cutoff).

`angular_aev_bwd` is its backward, from the cotangent of the output to
those of ``dist`` and ``diff``: K3b of the same source on a CUDA tensor,
`angular_aev_bwd_reference` (the closed-form derivative over the same grid,
in atom blocks) on a CPU tensor.  The JAX package has no kernel here: its
``_angular_pallas_bwd`` differentiates an XLA recompute of the forward.

`angular_aev_bwd_bwd` is K3b's own backward (K3bb), for second derivatives
(Hessians, force training): from the cotangents of K3b's outputs, the
cotangent of its ``g`` (the AEV's derivative along them) and the
second-order term on ``dist`` and ``diff``; K3bb on a CUDA tensor,
`angular_aev_bwd_bwd_reference` (closed form, atom blocks) on a CPU tensor.
"""

import ctypes
import functools
import math
import typing as tp

import numpy as np
import torch

from torchani_tpu_torch.aev.terms import ANIAngular, BaseAngular
from torchani_tpu_torch.annotations import Tensor

__all__ = [
    "angular_aev",
    "angular_aev_bwd",
    "angular_aev_bwd_bwd",
    "angular_aev_bwd_bwd_reference",
    "angular_aev_bwd_reference",
    "angular_aev_reference",
    "angular_grid",
    "bwd_launch_shape",
    "lane_species",
    "CUTOFF_KINDS",
]

#: cutoff functions the kernel evaluates (code passed to the kernel)
CUTOFF_KINDS = {"cosine": 0, "smooth": 1}
#: widest terms the kernels take (shifts, sections)
MAX_SHIFTS = MAX_SECTIONS = 16


def _section_trig(sections: tp.Sequence[float]) -> tp.Tuple[np.ndarray, np.ndarray]:
    """cos/sin of the angular sections, evaluated in f64 and rounded to f32
    (as the Pallas kernel does)."""
    sec = np.asarray(sections, dtype=np.float64)
    return np.cos(sec).astype(np.float32), np.sin(sec).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _pair_maps(num_species: int, device: torch.device) -> tp.Tuple[Tensor, Tensor, Tensor]:
    """Flat ``(s1, s2)`` and ``(s2, s1)`` indices of each packed species pair
    ``s1 <= s2``, and 1.0 off the diagonal, on ``device``.  Cached:
    uploading them on every call made each call wait for the device's
    queue."""
    iu1, iu2 = np.triu_indices(num_species)
    return tuple(
        torch.as_tensor(x, device=device)
        for x in (
            iu1 * num_species + iu2, iu2 * num_species + iu1,
            (iu1 != iu2).astype(np.float32),
        )
    )


@functools.lru_cache(maxsize=16)
def _slot_of_pair(num_species: int, device: torch.device) -> Tensor:
    """Packed slot of every ordered species pair ``(s, t)``, flat ``(S * S,)``."""
    iu1, iu2 = np.triu_indices(num_species)
    slots = np.empty((num_species, num_species), dtype=np.int64)
    slots[iu1, iu2] = slots[iu2, iu1] = np.arange(len(iu1))
    return torch.as_tensor(slots.reshape(-1), device=device)


def lane_species(mask: Tensor, oh: Tensor) -> Tensor:
    """The kernels' lane species: ``(N, Ka)`` int32, the species of each
    valid lane and -1 for a masked one."""
    return torch.where(mask & (oh.sum(-1) > 0), oh.argmax(-1), -1).to(torch.int32).contiguous()


def angular_grid(
    angular: BaseAngular,
    num_species: int,
    dist: Tensor,  # (N, Ka), masked lanes hold 1.0
    diff: Tensor,  # (N, Ka, 3), masked lanes 0
    mask: Tensor,  # (N, Ka) bool
    oh: Tensor,  # (N, Ka, S) one-hot, masked lanes all-zero
) -> Tensor:
    """Angular AEV rows from the full neighbour-pair grid; ``(N, P * Z)``.

    The counterpart of ``_angular_rows_grid``: ``angular`` evaluates the
    ``(N, Ka, Ka, Z)`` terms, the strict upper triangle of valid pairs keeps
    each unordered pair once, and both sides are contracted with the lane
    one-hots.  Differentiable in ``dist`` and ``diff``; memory grows as
    ``N * Ka^2 * Z``, so callers block large N.  ``angular_grid.calls``
    counts calls, so that a run can show the kernel path never reaches it.
    """
    angular_grid.calls += 1
    n, ka = dist.shape
    dots = torch.sum(diff[:, :, None, :] * diff[:, None, :, :], dim=-1)
    cos = dots / torch.clamp(dist[:, :, None] * dist[:, None, :], min=1e-10)
    grid = (n, ka, ka)
    terms = angular(dist[:, :, None].expand(grid), dist[:, None, :].expand(grid), cos)
    return _pairs_to_slots(terms, mask, oh, num_species)


angular_grid.calls = 0


def _pairs_to_slots(terms: Tensor, mask: Tensor, oh: Tensor, num_species: int) -> Tensor:
    """Sums the ``(N, Ka, Ka, Z)`` terms of the valid pairs ``j < k`` into
    the packed species-pair slots; ``(N, P * Z)``."""
    n, ka, _, nz = terms.shape
    # the pair mask (valid k > j) rides on the narrow one-hot side, not on
    # the (N, Ka, Ka, Z) terms; a masked j is dropped by the second sum
    ohm = oh.to(terms.dtype) * mask[..., None]
    upper = torch.ones((ka, ka), dtype=terms.dtype, device=terms.device).triu(1)
    ohk = upper[None, :, :, None] * ohm[:, None, :, :]  # (N, Ka_j, Ka_k, S)
    # v[n, s, t, z] = sum_{j<k} T[n, j, k, z] oh[n, j, s] oh[n, k, t]
    w = torch.einsum("njkz,njkt->njtz", terms, ohk)
    v = torch.einsum("njs,njtz->nstz", ohm, w)
    # packed pair p = {s1 <= s2}: v[s1, s2] + v[s2, s1], the diagonal once
    upper_pairs, lower_pairs, off_diag = _pair_maps(num_species, terms.device)
    v = v.reshape(n, num_species * num_species, nz)
    packed = (
        v.index_select(1, upper_pairs)
        + v.index_select(1, lower_pairs) * off_diag[:, None]
    )
    return packed.reshape(n, upper_pairs.numel() * nz)


@functools.lru_cache(maxsize=16)
def _angular_term(
    eta: float,
    zeta: float,
    shifts: tp.Tuple[float, ...],
    sections: tp.Tuple[float, ...],
    cutoff: float,
    cutoff_kind: str,
    device: torch.device,
) -> ANIAngular:
    """The `ANIAngular` term of the kernel's arguments, on ``device``
    (cached, so that its constants are uploaded once)."""
    return ANIAngular(eta, zeta, shifts, sections, cutoff, cutoff_kind, device)


def angular_aev_reference(
    dist: Tensor,  # (N, Ka), masked lanes hold 1.0
    diff: Tensor,  # (N, Ka, 3), masked lanes 0
    mask: Tensor,  # (N, Ka) bool
    oh: Tensor,  # (N, Ka, S) one-hot, masked lanes all-zero
    *,
    eta: float,
    zeta: float,
    shifts: tp.Sequence[float],
    sections: tp.Sequence[float],
    cutoff: float,
    cutoff_kind: str,
    num_species: int,
) -> Tensor:
    """Plain version of the fused angular AEV, with the kernel's signature;
    returns ``(N, P * Z)`` (`angular_grid` of the term these arguments
    describe)."""
    if cutoff_kind not in CUTOFF_KINDS:
        raise ValueError(f"Unsupported cutoff kind {cutoff_kind!r}")
    angular = _angular_term(
        float(eta), float(zeta), tuple(shifts), tuple(sections), float(cutoff),
        cutoff_kind, dist.device,
    )
    return angular_grid(angular, num_species, dist, diff, mask, oh)


def _cutoff_and_derivative(r: Tensor, cutoff: float, kind: str) -> tp.Tuple[Tensor, Tensor]:
    """fc(r) and fc'(r) of the cosine or the default smooth cutoff (order 2,
    eps 1e-10: 0 past the clamp)."""
    if kind == "cosine":
        arg = r * (math.pi / cutoff)
        return 0.5 * torch.cos(arg) + 0.5, -0.5 * (math.pi / cutoff) * torch.sin(arg)
    x = r / cutoff
    u = 1 - x * x
    uc = u.clamp(min=1e-10)
    fc = torch.exp(1 - 1 / uc)
    return fc, torch.where(u >= 1e-10, fc * (-2 * x / cutoff) / (uc * uc), 0.0)


def _angular_bwd_block(
    g: Tensor, dist: Tensor, diff: Tensor, mask: Tensor, oh: Tensor, *,
    eta: float, zeta: float, shifts: Tensor, cos_sec: Tensor, sin_sec: Tensor,
    cutoff: float, cutoff_kind: str, num_species: int,
) -> tp.Tuple[Tensor, Tensor]:
    """`angular_aev_bwd_reference` on one block of atoms."""
    n, ka = dist.shape
    sh, se = shifts.numel(), cos_sec.numel()
    fc, dfc = _cutoff_and_derivative(dist, cutoff, cutoff_kind)
    rj, rk = dist[:, :, None], dist[:, None, :]
    rr = rj * rk
    den = rr.clamp(min=1e-10)
    c = 0.95 * torch.sum(diff[:, :, None, :] * diff[:, None, :, :], dim=-1) / den
    s2 = 1 - c * c
    sin_t = torch.sqrt(s2.clamp(min=1e-20))
    dsin = torch.where(s2 > 1e-20, -c / sin_t, 0.0)
    f = fc[:, :, None] * fc[:, None, :]
    dr = 0.5 * (rj + rk)[..., None] - shifts  # (n, Ka, Ka, Sh)
    rad = torch.exp(-eta * dr * dr)
    drad = -2 * eta * dr * rad
    base = 0.5 * (1 + c[..., None] * cos_sec + sin_t[..., None] * sin_sec)  # (n, Ka, Ka, Se)
    pw = base ** (zeta - 1)
    ang = 2 * base * pw
    dang = zeta * pw * (cos_sec + sin_sec * dsin[..., None])
    # each term's cotangent: g at the pair's slot, on valid pairs j < k only
    ohm = oh.to(dist.dtype) * mask[..., None]
    slots = _slot_of_pair(num_species, dist.device)
    gfull = g.reshape(n, -1, sh * se).index_select(1, slots)
    gfull = gfull.reshape(n, num_species, num_species, sh * se)
    upper = torch.ones((ka, ka), dtype=dist.dtype, device=dist.device).triu(1)
    w = torch.einsum("njs,nstz,nkt->njkz", ohm, gfull, ohm) * upper[None, :, :, None]
    w = w.reshape(n, ka, ka, sh, se)
    wa = torch.sum(w * ang[..., None, :], dim=-1)  # (n, Ka, Ka, Sh)
    wda = torch.sum(w * dang[..., None, :], dim=-1)
    dl_df = torch.sum(wa * rad, dim=-1)
    dl_dm = f * torch.sum(wa * drad, dim=-1)
    dl_dc = f * torch.sum(wda * rad, dim=-1)
    through_r = rr >= 1e-10
    g_rj = (0.5 * dl_dm + dl_df * dfc[:, :, None] * fc[:, None, :]
            + torch.where(through_r, dl_dc * (-c / rj), 0.0))
    g_rk = (0.5 * dl_dm + dl_df * fc[:, :, None] * dfc[:, None, :]
            + torch.where(through_r, dl_dc * (-c / rk), 0.0))
    coef = 0.95 * dl_dc / den
    gdist = g_rj.sum(2) + g_rk.sum(1)
    gdiff = torch.einsum("njk,nkx->njx", coef, diff) + torch.einsum("njk,njx->nkx", coef, diff)
    return gdist, gdiff


def angular_aev_bwd_reference(
    g: Tensor,  # (N, P * Z)
    dist: Tensor,  # (N, Ka), masked lanes hold 1.0
    diff: Tensor,  # (N, Ka, 3), masked lanes 0
    mask: Tensor,  # (N, Ka) bool
    oh: Tensor,  # (N, Ka, S) one-hot, masked lanes all-zero
    *,
    eta: float,
    zeta: float,
    shifts: tp.Sequence[float],
    sections: tp.Sequence[float],
    cutoff: float,
    cutoff_kind: str,
    num_species: int,
    atom_block: tp.Optional[int] = None,
) -> tp.Tuple[Tensor, Tensor]:
    """Plain version of K3b: the cotangents of ``dist`` and ``diff`` from
    the cotangent ``g`` of `angular_aev_reference`'s output.

    The closed-form derivative of the kernel (see ``csrc/angular_aev.cu``)
    over the ``(blk, Ka, Ka, Z)`` grid, ``atom_block`` atoms at a time (all
    at once by default); not an autograd recompute, so that the tests hold
    the kernel's own formulas against the JAX package.  Masked lanes get
    exact zeros."""
    if cutoff_kind not in CUTOFF_KINDS:
        raise ValueError(f"Unsupported cutoff kind {cutoff_kind!r}")
    cos_np, sin_np = _section_trig(sections)
    consts = dict(
        eta=float(eta), zeta=float(zeta),
        shifts=torch.as_tensor(np.asarray(shifts, dtype=np.float32), device=dist.device),
        cos_sec=torch.as_tensor(cos_np, device=dist.device),
        sin_sec=torch.as_tensor(sin_np, device=dist.device),
        cutoff=float(cutoff), cutoff_kind=cutoff_kind, num_species=num_species,
    )
    n = dist.shape[0]
    block = max(1, n if atom_block is None else atom_block)
    gdist = torch.zeros_like(dist)
    gdiff = torch.zeros_like(diff)
    for start in range(0, n, block):
        sl = slice(start, start + block)
        gdist[sl], gdiff[sl] = _angular_bwd_block(
            g[sl], dist[sl], diff[sl], mask[sl], oh[sl], **consts
        )
    return gdist, gdiff


def _cutoff_second_derivative(r: Tensor, fc: Tensor, dfc: Tensor, cutoff: float,
                              kind: str) -> Tensor:
    """fc''(r): the derivative of `_cutoff_and_derivative`'s fc' as it
    stands (0 past the smooth cutoff's clamp)."""
    if kind == "cosine":
        return -0.5 * (math.pi / cutoff) ** 2 * torch.cos(r * (math.pi / cutoff))
    x = r / cutoff
    u = 1 - x * x
    uc = u.clamp(min=1e-10)
    t = -2 * x / cutoff  # du/dr
    d2 = dfc * t / (uc * uc) - 2 * fc / (cutoff * cutoff * uc * uc) - 2 * fc * t * t / (uc * uc * uc)
    return torch.where(u >= 1e-10, d2, 0.0)


def _angular_bwd_bwd_block(
    g: Tensor, dist: Tensor, diff: Tensor, mask: Tensor, oh: Tensor,
    u_dist: Tensor, u_diff: Tensor, *,
    eta: float, zeta: float, shifts: Tensor, cos_sec: Tensor, sin_sec: Tensor,
    cutoff: float, cutoff_kind: str, num_species: int,
) -> tp.Tuple[Tensor, Tensor, Tensor]:
    """`angular_aev_bwd_bwd_reference` on one block of atoms.

    Per valid pair, with S = F P0(m, c) the pair's share of <g, AEV> and
    (F, m, c) its factors: K3b's lane cotangents are S_F dF + S_m dm + S_c
    dc; along the direction u they give phi = S_F du(F) + S_m du(m) + S_c
    du(c), whose gradient is the second-order term, and du(T) is the
    directional derivative of the terms (the J u half)."""
    n, ka = dist.shape
    sh, se = shifts.numel(), cos_sec.numel()
    fc, dfc = _cutoff_and_derivative(dist, cutoff, cutoff_kind)
    d2fc = _cutoff_second_derivative(dist, fc, dfc, cutoff, cutoff_kind)
    rj, rk = dist[:, :, None], dist[:, None, :]
    rr = rj * rk
    thr = rr >= 1e-10
    inv_den = 1 / rr.clamp(min=1e-10)
    c = 0.95 * torch.sum(diff[:, :, None, :] * diff[:, None, :, :], dim=-1) * inv_den
    s2 = 1 - c * c
    sin_t = torch.sqrt(s2.clamp(min=1e-20))
    inside = s2 > 1e-20
    dsin = torch.where(inside, -c / sin_t, 0.0)
    ddsin = torch.where(inside, -1 / (sin_t * sin_t * sin_t), 0.0)
    f = fc[:, :, None] * fc[:, None, :]
    f_rj = dfc[:, :, None] * fc[:, None, :]
    f_rk = fc[:, :, None] * dfc[:, None, :]
    dr = 0.5 * (rj + rk)[..., None] - shifts  # (n, Ka, Ka, Sh)
    rad = torch.exp(-eta * dr * dr)
    rad1 = -2 * eta * dr * rad
    rad2 = (4 * eta * eta * dr * dr - 2 * eta) * rad
    slope = cos_sec + sin_sec * dsin[..., None]  # d(2 base)/dc, (n, Ka, Ka, Se)
    base = 0.5 * (1 + c[..., None] * cos_sec + sin_t[..., None] * sin_sec)
    pw = base ** (zeta - 1)
    ang = 2 * base * pw
    ang1 = zeta * pw * slope
    ang2 = (0.5 * zeta * (zeta - 1) * base ** (zeta - 2) * slope * slope
            + zeta * pw * sin_sec * ddsin[..., None])
    # each term's cotangent: g at the pair's slot, on valid pairs j < k only
    ohm = oh.to(dist.dtype) * mask[..., None]
    slots = _slot_of_pair(num_species, dist.device)
    gfull = g.reshape(n, -1, sh * se).index_select(1, slots)
    gfull = gfull.reshape(n, num_species, num_species, sh * se)
    upper = torch.ones((ka, ka), dtype=dist.dtype, device=dist.device).triu(1)
    w = torch.einsum("njs,nstz,nkt->njkz", ohm, gfull, ohm) * upper[None, :, :, None]
    w = w.reshape(n, ka, ka, sh, se)
    t1 = torch.sum(w * ang[..., None, :], dim=-1)  # (n, Ka, Ka, Sh)
    t2 = torch.sum(w * ang1[..., None, :], dim=-1)
    t3 = torch.sum(w * ang2[..., None, :], dim=-1)
    p0, pm, pmm = (torch.sum(t1 * r, dim=-1) for r in (rad, rad1, rad2))
    pc, pmc = (torch.sum(t2 * r, dim=-1) for r in (rad, rad1))
    pcc = torch.sum(t3 * rad, dim=-1)

    # the direction: du(F), du(m), du(c) of each pair
    urj, urk = u_dist[:, :, None], u_dist[:, None, :]
    q = (torch.einsum("nkx,njx->njk", diff, u_diff)
         + torch.einsum("njx,nkx->njk", diff, u_diff))  # d_k . u_j + d_j . u_k
    c_rj = torch.where(thr, -c / rj, 0.0)
    c_rk = torch.where(thr, -c / rk, 0.0)
    d_f = f_rj * urj + f_rk * urk
    d_m = 0.5 * (urj + urk)
    d_c = c_rj * urj + c_rk * urk + 0.95 * inv_den * q

    # J u: the terms' directional derivative, summed into the slots
    xa = d_f[..., None] * rad + (f * d_m)[..., None] * rad1  # (n, Ka, Ka, Sh)
    ya = (f * d_c)[..., None] * rad
    jvp = xa[..., None] * ang[..., None, :] + ya[..., None] * ang1[..., None, :]
    gg = _pairs_to_slots(jvp.reshape(n, ka, ka, sh * se), mask, oh, num_species)

    # the gradient of phi
    w_f = pm * d_m + pc * d_c
    w_m = pm * d_f + f * (pmm * d_m + pmc * d_c)
    w_c = pc * d_f + f * (pmc * d_m + pcc * d_c)
    wr = torch.where(thr, urj / rj + urk / rk, 0.0)
    fpc = f * pc
    ddc_rj = torch.where(thr, (c / rj) * wr + c * urj / (rj * rj) - 0.95 * q * inv_den / rj, 0.0)
    ddc_rk = torch.where(thr, (c / rk) * wr + c * urk / (rk * rk) - 0.95 * q * inv_den / rk, 0.0)
    dfc_jk = dfc[:, :, None] * dfc[:, None, :]
    h_rj = (w_f * f_rj + 0.5 * w_m + w_c * c_rj + fpc * ddc_rj
            + p0 * (d2fc[:, :, None] * fc[:, None, :] * urj + dfc_jk * urk))
    h_rk = (w_f * f_rk + 0.5 * w_m + w_c * c_rk + fpc * ddc_rk
            + p0 * (dfc_jk * urj + fc[:, :, None] * d2fc[:, None, :] * urk))
    alpha = 0.95 * inv_den * (w_c - fpc * wr)
    beta = 0.95 * inv_den * fpc
    hdist = h_rj.sum(2) + h_rk.sum(1)
    hdiff = (torch.einsum("njk,nkx->njx", alpha, diff) + torch.einsum("njk,nkx->njx", beta, u_diff)
             + torch.einsum("njk,njx->nkx", alpha, diff)
             + torch.einsum("njk,njx->nkx", beta, u_diff))
    return gg, hdist, hdiff


def angular_aev_bwd_bwd_reference(
    g: Tensor,  # (N, P * Z)
    dist: Tensor,  # (N, Ka), masked lanes hold 1.0
    diff: Tensor,  # (N, Ka, 3), masked lanes 0
    mask: Tensor,  # (N, Ka) bool
    oh: Tensor,  # (N, Ka, S) one-hot, masked lanes all-zero
    u_dist: Tensor,  # (N, Ka)
    u_diff: Tensor,  # (N, Ka, 3)
    *,
    eta: float,
    zeta: float,
    shifts: tp.Sequence[float],
    sections: tp.Sequence[float],
    cutoff: float,
    cutoff_kind: str,
    num_species: int,
    atom_block: tp.Optional[int] = None,
) -> tp.Tuple[Tensor, Tensor, Tensor]:
    """Plain version of K3bb, the vector-Jacobian product of K3b: from the
    cotangents ``(u_dist, u_diff)`` of K3b's outputs, ``gg (N, P * Z)``, the
    AEV's directional derivative along u (the cotangent of K3b's ``g``),
    and ``(hdist, hdiff)``, the second-order term ``sum_o g_o Hess(AEV_o)
    u`` (the cotangents of ``dist`` and ``diff``, as independent inputs).

    The closed form of the derivative of K3b's formulas as they stand (their
    clamps included), over the ``(blk, Ka, Ka, Z)`` grid, ``atom_block``
    atoms at a time (all at once by default).  Masked lanes get exact
    zeros, and so do rows that meet no pair."""
    if cutoff_kind not in CUTOFF_KINDS:
        raise ValueError(f"Unsupported cutoff kind {cutoff_kind!r}")
    cos_np, sin_np = _section_trig(sections)
    consts = dict(
        eta=float(eta), zeta=float(zeta),
        shifts=torch.as_tensor(np.asarray(shifts, dtype=np.float32), device=dist.device),
        cos_sec=torch.as_tensor(cos_np, device=dist.device),
        sin_sec=torch.as_tensor(sin_np, device=dist.device),
        cutoff=float(cutoff), cutoff_kind=cutoff_kind, num_species=num_species,
    )
    n = dist.shape[0]
    block = max(1, n if atom_block is None else atom_block)
    width = num_species * (num_species + 1) // 2 * len(shifts) * len(sections)
    gg = dist.new_zeros((n, width))
    hdist = torch.zeros_like(dist)
    hdiff = torch.zeros_like(diff)
    for start in range(0, n, block):
        sl = slice(start, start + block)
        gg[sl], hdist[sl], hdiff[sl] = _angular_bwd_bwd_block(
            g[sl], dist[sl], diff[sl], mask[sl], oh[sl], u_dist[sl], u_diff[sl], **consts
        )
    return gg, hdist, hdiff


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from torchani_tpu_torch.csrc import load_library

    lib = load_library("angular_aev")
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    terms = [
        ci, ci, ci,  # n, ka, num_species
        vp, ci,  # shifts, num_shifts
        vp, vp, ci,  # cos_sections, sin_sections, num_sections
        cf, cf, cf, cf, ci,  # eta, zeta, cutoff, pi/cutoff, cutoff_kind
        ci, vp,  # device, stream
    ]
    lib.angular_aev_launch.argtypes = [vp, vp, vp, vp] + terms  # dist, diff, species, out
    lib.angular_aev_bwd_launch.argtypes = [
        vp, ctypes.c_longlong,  # g, its row stride
        vp, vp, vp, vp, vp,  # dist, diff, species, gdist, gdiff
    ] + terms
    lib.angular_aev_bwd_bwd_launch.argtypes = [
        vp, ctypes.c_longlong,  # g, its row stride
        vp, vp, vp, vp, vp,  # dist, diff, species, u_dist, u_diff
        vp, vp, vp,  # gg, hdist, hdiff
    ] + terms
    lib.angular_aev_launch.restype = lib.angular_aev_bwd_launch.restype = ci
    lib.angular_aev_bwd_bwd_launch.restype = ci
    ip = ctypes.POINTER(ci)
    lib.angular_aev_bwd_shape.argtypes = [ci, ci, ci, ci, ci, ci, ci, ip, ip,
                                          ctypes.POINTER(ctypes.c_longlong)]
    lib.angular_aev_bwd_shape.restype = ci
    lib.angular_aev_error_string.argtypes = [ci]
    lib.angular_aev_error_string.restype = ctypes.c_char_p
    return lib


def _check_lanes(
    what: str, dist: Tensor, diff: Tensor, mask: Tensor, oh: Tensor,
    species: tp.Optional[Tensor], num_species: int, shifts, sections, cutoff_kind: str,
) -> Tensor:
    """The kernels' checks of their lane inputs, on a CUDA ``dist``; returns
    the lane species (``species``, or computed from ``mask`` and ``oh``)."""
    if dist.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dist.device}")
    n, ka = dist.shape
    if diff.shape != (n, ka, 3) or mask.shape != (n, ka) or oh.shape != (
        n, ka, num_species
    ):
        raise ValueError(
            f"{what}: shapes dist {tuple(dist.shape)}, diff {tuple(diff.shape)}, mask "
            f"{tuple(mask.shape)}, oh {tuple(oh.shape)} do not agree with "
            f"num_species={num_species}"
        )
    for name, t in (("diff", diff), ("mask", mask), ("oh", oh), ("species", species)):
        if t is not None and t.device != dist.device:
            raise ValueError(f"{what}: {name} is on {t.device}, not {dist.device}")
    if dist.dtype != torch.float32 or diff.dtype != torch.float32:
        raise TypeError(f"{what}: dist and diff must be float32")
    if mask.dtype != torch.bool:
        raise TypeError(f"{what}: mask must be bool")
    if not (dist.is_contiguous() and diff.is_contiguous()):
        raise ValueError(f"{what}: dist and diff must be contiguous")
    if cutoff_kind not in CUTOFF_KINDS:
        raise ValueError(f"{what}: unsupported cutoff kind {cutoff_kind!r}")
    if not (0 < len(shifts) <= MAX_SHIFTS and 0 < len(sections) <= MAX_SECTIONS):
        raise ValueError(
            f"{what}: the kernel takes 1 to {MAX_SHIFTS} shifts and 1 to {MAX_SECTIONS} "
            f"sections, not {len(shifts)} and {len(sections)}"
        )
    if species is None:
        return lane_species(mask, oh)
    if species.shape != (n, ka) or species.dtype != torch.int32 or not species.is_contiguous():
        raise ValueError(f"{what}: species must be a contiguous ({n}, {ka}) int32 tensor")
    return species


def _launch(what: str, fn, device: torch.device, pointers: tp.Sequence, n: int, ka: int,
            kw: tp.Dict[str, tp.Any]) -> None:
    """Launches one of the library's entry points on ``device``'s current
    stream; raises if the launch failed."""
    shifts_np = np.ascontiguousarray(np.asarray(kw["shifts"], dtype=np.float32))
    cos_np, sin_np = _section_trig(kw["sections"])
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(
            *pointers, n, ka, kw["num_species"],
            shifts_np.ctypes.data, len(shifts_np),
            cos_np.ctypes.data, sin_np.ctypes.data, len(cos_np),
            float(kw["eta"]), float(kw["zeta"]), float(kw["cutoff"]),
            float(math.pi / kw["cutoff"]), CUTOFF_KINDS[kw["cutoff_kind"]],
            device.index, stream,
        )
    if rc != 0:
        msg = _library().angular_aev_error_string(rc).decode()
        raise RuntimeError(f"{what}: kernel launch failed: CUDA error {rc} ({msg})")


def angular_aev(
    dist: Tensor,  # (N, Ka), masked lanes hold 1.0
    diff: Tensor,  # (N, Ka, 3), masked lanes 0
    mask: Tensor,  # (N, Ka) bool
    oh: Tensor,  # (N, Ka, S) one-hot with masked lanes all-zero
    *,
    eta: float,
    zeta: float,
    shifts: tp.Sequence[float],
    sections: tp.Sequence[float],
    cutoff: float,
    cutoff_kind: str,
    num_species: int,
    species: tp.Optional[Tensor] = None,
) -> Tensor:
    """Fused angular AEV; returns ``(N, P * Z)`` (pair-major layout).

    CPU tensors take `angular_aev_reference`; CUDA tensors launch the kernel
    and raise if it cannot run.  ``species`` is `lane_species` of ``mask``
    and ``oh`` where the caller has it already.  ``angular_aev.launches``
    counts launches.
    """
    kwargs = dict(
        eta=eta, zeta=zeta, shifts=shifts, sections=sections, cutoff=cutoff,
        cutoff_kind=cutoff_kind, num_species=num_species,
    )
    if dist.device.type == "cpu":
        return angular_aev_reference(dist, diff, mask, oh, **kwargs)
    species = _check_lanes(
        "angular_aev", dist, diff, mask, oh, species, num_species, shifts, sections, cutoff_kind
    )
    n, ka = dist.shape
    num_pairs = num_species * (num_species + 1) // 2
    out = torch.empty(
        (n, num_pairs * len(shifts) * len(sections)), dtype=torch.float32, device=dist.device
    )
    if n == 0:
        return out
    lib = _library()
    _launch(
        "angular_aev", lib.angular_aev_launch, dist.device,
        (dist.data_ptr(), diff.data_ptr(), species.data_ptr(), out.data_ptr()), n, ka, kwargs,
    )
    angular_aev.launches += 1
    return out


angular_aev.launches = 0


def angular_aev_bwd(
    g: Tensor,  # (N, P * Z), columns contiguous, any row stride
    dist: Tensor,  # (N, Ka), masked lanes hold 1.0
    diff: Tensor,  # (N, Ka, 3), masked lanes 0
    mask: Tensor,  # (N, Ka) bool
    oh: Tensor,  # (N, Ka, S) one-hot with masked lanes all-zero
    species: tp.Optional[Tensor] = None,
    *,
    eta: float,
    zeta: float,
    shifts: tp.Sequence[float],
    sections: tp.Sequence[float],
    cutoff: float,
    cutoff_kind: str,
    num_species: int,
    atom_block: tp.Optional[int] = None,
) -> tp.Tuple[Tensor, Tensor]:
    """Backward of `angular_aev`: ``(gdist (N, Ka), gdiff (N, Ka, 3))`` from
    the output's cotangent ``g``.

    CPU tensors take `angular_aev_bwd_reference`, ``atom_block`` atoms at a
    time; CUDA tensors launch K3b once (``atom_block`` unused; a persistent
    grid, `bwd_launch_shape`) and raise if it cannot run.  ``g`` may be a
    column slice of a wider tensor: the kernel reads it with its row
    stride, and only the rows of the species pairs that meet a pair.  ``angular_aev_bwd.launches``
    counts launches.
    """
    kwargs = dict(
        eta=eta, zeta=zeta, shifts=shifts, sections=sections, cutoff=cutoff,
        cutoff_kind=cutoff_kind, num_species=num_species,
    )
    if dist.device.type == "cpu":
        return angular_aev_bwd_reference(g, dist, diff, mask, oh, atom_block=atom_block, **kwargs)
    species = _check_lanes(
        "angular_aev_bwd", dist, diff, mask, oh, species, num_species, shifts, sections,
        cutoff_kind,
    )
    n, ka = dist.shape
    width = num_species * (num_species + 1) // 2 * len(shifts) * len(sections)
    if g.shape != (n, width):
        raise ValueError(f"angular_aev_bwd: g has shape {tuple(g.shape)}, not {(n, width)}")
    if g.device != dist.device:
        raise ValueError(f"angular_aev_bwd: g is on {g.device}, not {dist.device}")
    if g.dtype != torch.float32:
        raise TypeError("angular_aev_bwd: g must be float32")
    if g.stride(1) != 1:
        raise ValueError(
            f"angular_aev_bwd: g's columns must be contiguous (strides {g.stride()})"
        )
    gdist = torch.empty_like(dist)
    gdiff = torch.empty_like(diff)
    if n == 0:
        return gdist, gdiff
    lib = _library()
    _launch(
        "angular_aev_bwd", lib.angular_aev_bwd_launch, dist.device,
        (g.data_ptr(), g.stride(0), dist.data_ptr(), diff.data_ptr(), species.data_ptr(),
         gdist.data_ptr(), gdiff.data_ptr()),
        n, ka, kwargs,
    )
    angular_aev_bwd.launches += 1
    return gdist, gdiff


angular_aev_bwd.launches = 0


def angular_aev_bwd_bwd(
    g: Tensor,  # (N, P * Z), columns contiguous, any row stride
    dist: Tensor,  # (N, Ka), masked lanes hold 1.0
    diff: Tensor,  # (N, Ka, 3), masked lanes 0
    mask: Tensor,  # (N, Ka) bool
    oh: Tensor,  # (N, Ka, S) one-hot with masked lanes all-zero
    u_dist: Tensor,  # (N, Ka)
    u_diff: Tensor,  # (N, Ka, 3)
    species: tp.Optional[Tensor] = None,
    *,
    eta: float,
    zeta: float,
    shifts: tp.Sequence[float],
    sections: tp.Sequence[float],
    cutoff: float,
    cutoff_kind: str,
    num_species: int,
    atom_block: tp.Optional[int] = None,
) -> tp.Tuple[Tensor, Tensor, Tensor]:
    """Backward of `angular_aev_bwd` (K3bb): ``(gg (N, P * Z), hdist (N,
    Ka), hdiff (N, Ka, 3))`` from the cotangents ``u_dist`` and ``u_diff``
    of its outputs (see `angular_aev_bwd_bwd_reference`).

    CPU tensors take `angular_aev_bwd_bwd_reference`, ``atom_block`` atoms
    at a time; CUDA tensors launch K3bb once (a persistent grid,
    `bwd_launch_shape` with ``second_order``) and raise if it cannot run.
    ``g`` may be a column slice of a wider tensor, as for K3b.
    ``angular_aev_bwd_bwd.launches`` counts launches.
    """
    kwargs = dict(
        eta=eta, zeta=zeta, shifts=shifts, sections=sections, cutoff=cutoff,
        cutoff_kind=cutoff_kind, num_species=num_species,
    )
    if dist.device.type == "cpu":
        return angular_aev_bwd_bwd_reference(
            g, dist, diff, mask, oh, u_dist, u_diff, atom_block=atom_block, **kwargs
        )
    what = "angular_aev_bwd_bwd"
    species = _check_lanes(
        what, dist, diff, mask, oh, species, num_species, shifts, sections, cutoff_kind
    )
    n, ka = dist.shape
    width = num_species * (num_species + 1) // 2 * len(shifts) * len(sections)
    if g.shape != (n, width):
        raise ValueError(f"{what}: g has shape {tuple(g.shape)}, not {(n, width)}")
    if g.stride(1) != 1:
        raise ValueError(f"{what}: g's columns must be contiguous (strides {g.stride()})")
    for name, t, shape in (("g", g, None), ("u_dist", u_dist, (n, ka)),
                           ("u_diff", u_diff, (n, ka, 3))):
        if t.device != dist.device:
            raise ValueError(f"{what}: {name} is on {t.device}, not {dist.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} must be float32")
        if shape is not None and (tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{what}: {name} must be a contiguous {shape} tensor")
    gg = torch.empty((n, width), dtype=torch.float32, device=dist.device)
    hdist = torch.empty_like(dist)
    hdiff = torch.empty_like(diff)
    if n == 0:
        return gg, hdist, hdiff
    lib = _library()
    _launch(
        what, lib.angular_aev_bwd_bwd_launch, dist.device,
        (g.data_ptr(), g.stride(0), dist.data_ptr(), diff.data_ptr(), species.data_ptr(),
         u_dist.data_ptr(), u_diff.data_ptr(), gg.data_ptr(), hdist.data_ptr(),
         hdiff.data_ptr()),
        n, ka, kwargs,
    )
    angular_aev_bwd_bwd.launches += 1
    return gg, hdist, hdiff


angular_aev_bwd_bwd.launches = 0


def bwd_launch_shape(
    n: int, ka: int, num_species: int, num_shifts: int, num_sections: int,
    device: torch.device, second_order: bool = False,
) -> tp.Dict[str, int]:
    """K3b's persistent grid (K3bb's with ``second_order``) for ``N`` atoms
    of ``Ka`` lanes at these widths on a CUDA ``device``: the blocks (as many
    as the card holds at once, no more than the atoms need), the threads and
    the shared memory a block (each warp's cotangent rows, lane records and
    planes; K3bb's also its pair tile and J u rows), and the most atoms a
    warp takes."""
    device = torch.device(device)
    index = torch.cuda.current_device() if device.index is None else device.index
    blocks, threads, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_longlong()
    with torch.cuda.device(index):
        rc = _library().angular_aev_bwd_shape(
            n, ka, num_species, num_shifts, num_sections, int(second_order), index,
            ctypes.byref(blocks), ctypes.byref(threads), ctypes.byref(smem),
        )
    if rc != 0:
        msg = _library().angular_aev_error_string(rc).decode()
        what = "angular_aev_bwd_bwd" if second_order else "angular_aev_bwd"
        raise RuntimeError(f"{what}: no launch shape: CUDA error {rc} ({msg})")
    return {"blocks": blocks.value, "threads": threads.value, "smem_bytes": smem.value,
            "atoms_per_warp": -(-n // (blocks.value * threads.value // 32))}
