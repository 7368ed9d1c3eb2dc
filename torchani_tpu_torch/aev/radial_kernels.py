"""The fused radial-AEV kernel (K6), its backward (K6b), K6b's backward
(K6bb) and their plain PyTorch versions.

These replace no Pallas kernel: the JAX package leaves the radial terms to
XLA, which fuses them (see ``csrc/radial_aev.cu``).  `radial_aev` gives the
radial block of the AEV, ``(N, S * R)`` species-major, from a radial table's
``dist (N, K)`` and each lane's species (int64, -1 in a masked lane).  On a
CUDA tensor it launches the hand-written kernel (or raises); on a CPU tensor,
and only there, it computes `radial_aev_reference`, the AEV computer's plain
formula.  `radial_aev_bwd` is its backward, from the cotangent of the output
to that of ``dist``; `radial_aev_bwd_bwd` is K6b's own backward (second
derivatives: Hessians, force training), from the cotangent ``w`` of K6b's
output.  Their plain versions are closed forms, not autograd recomputes, so
that the tests hold the kernels' formulas against autograd.
"""

import ctypes
import functools
import math
import typing as tp

import numpy as np
import torch

from torchani_tpu_torch.aev.kernels import (
    CUTOFF_KINDS,
    _cutoff_and_derivative,
    _cutoff_second_derivative,
)
from torchani_tpu_torch.aev.terms import ANIRadial
from torchani_tpu_torch.annotations import Tensor

__all__ = [
    "radial_aev",
    "radial_aev_bwd",
    "radial_aev_bwd_bwd",
    "radial_aev_reference",
    "radial_aev_bwd_reference",
    "radial_aev_bwd_bwd_reference",
    "species_sums",
    "MAX_RADIAL_SHIFTS",
    "MAX_RADIAL_SPECIES",
]

#: widest terms the kernels take (shifts, species)
MAX_RADIAL_SHIFTS = 32
MAX_RADIAL_SPECIES = 16


@functools.lru_cache(maxsize=16)
def _radial_term(
    eta: float, shifts: tp.Tuple[float, ...], cutoff: float, cutoff_kind: str,
    device: torch.device,
) -> ANIRadial:
    """The `ANIRadial` term of the kernel's arguments, on ``device`` (cached,
    so that its constants are uploaded once)."""
    return ANIRadial(eta, shifts, cutoff, cutoff_kind, device)


def species_sums(
    terms: Tensor,  # (N, K, R)
    species: Tensor,  # (N, K) int, -1 in masked lanes
    num_species: int,
    present: tp.Optional[tp.Collection[int]] = None,
) -> Tensor:
    """The plain radial formula's sums over lanes: ``out[n, e, r] =
    sum_{k: e_k = e} terms[n, k, r]``, flat ``(N, S * R)`` species-major;
    masked lanes fall in no species.  A species not in ``present`` (all
    when None) is zero, and costs no pass."""
    n, _, r = terms.shape
    zeros = terms.new_zeros((n, r))
    return torch.stack(
        [
            torch.sum(terms * (species == t)[..., None], dim=1)
            if present is None or t in present else zeros
            for t in range(num_species)
        ],
        dim=1,
    ).reshape(n, num_species * r)


def radial_aev_reference(
    dist: Tensor,  # (N, K)
    species: Tensor,  # (N, K) int, -1 in masked lanes
    *,
    eta: float,
    shifts: tp.Sequence[float],
    cutoff: float,
    cutoff_kind: str,
    num_species: int,
) -> Tensor:
    """Plain version of K6, with its signature; returns ``(N, S * R)``: the
    AEV computer's plain radial formula, `species_sums` of the `ANIRadial`
    terms."""
    if cutoff_kind not in CUTOFF_KINDS:
        raise ValueError(f"Unsupported cutoff kind {cutoff_kind!r}")
    radial = _radial_term(float(eta), tuple(shifts), float(cutoff), cutoff_kind, dist.device)
    return species_sums(radial(dist), species, num_species)


def _gaussians(dist: Tensor, eta: float, shifts: tp.Sequence[float]) -> tp.Tuple[Tensor, Tensor]:
    """``d - ShfR`` and ``exp(-eta (d - ShfR)^2)``, ``(N, K, R)``, with the
    term's float32 constants in ``dist``'s type."""
    shf = torch.as_tensor(np.asarray(shifts, dtype=np.float32), device=dist.device)
    dr = dist[..., None] - shf.to(dist.dtype)
    return dr, torch.exp(-float(np.float32(eta)) * dr * dr)


def _species_cotangent(g: Tensor, species: Tensor, num_species: int, num_shifts: int) -> Tensor:
    """Each lane's row of ``g``: ``g[n, e_k]``, ``(N, K, R)``, 0 where masked."""
    g = g.reshape(g.shape[0], num_species, num_shifts)
    lanes = torch.gather(g, 1, species.clamp(min=0)[..., None].expand(-1, -1, num_shifts))
    return lanes * (species >= 0)[..., None]


def radial_aev_bwd_reference(
    g: Tensor,  # (N, S * R)
    dist: Tensor,  # (N, K)
    species: Tensor,  # (N, K) int, -1 in masked lanes
    *,
    eta: float,
    shifts: tp.Sequence[float],
    cutoff: float,
    cutoff_kind: str,
    num_species: int,
) -> Tensor:
    """Plain version of K6b: the cotangent of ``dist`` from the cotangent
    ``g`` of `radial_aev_reference`'s output, ``sum_r g[n, e_k, r]
    T'_r(d_k)``; exact zeros on masked lanes."""
    if cutoff_kind not in CUTOFF_KINDS:
        raise ValueError(f"Unsupported cutoff kind {cutoff_kind!r}")
    fc, dfc = _cutoff_and_derivative(dist, cutoff, cutoff_kind)
    dr, ex = _gaussians(dist, eta, shifts)
    eta = float(np.float32(eta))
    dterm = 0.25 * ex * (dfc[..., None] - 2 * eta * dr * fc[..., None])
    gl = _species_cotangent(g, species, num_species, len(shifts))
    return torch.sum(gl * dterm, dim=-1)


def radial_aev_bwd_bwd_reference(
    g: Tensor,  # (N, S * R)
    dist: Tensor,  # (N, K)
    species: Tensor,  # (N, K) int, -1 in masked lanes
    w: Tensor,  # (N, K)
    *,
    eta: float,
    shifts: tp.Sequence[float],
    cutoff: float,
    cutoff_kind: str,
    num_species: int,
) -> tp.Tuple[Tensor, Tensor]:
    """Plain version of K6bb, the vector-Jacobian product of K6b: from the
    cotangent ``w`` of K6b's output, ``gg (N, S * R) = sum_{k: e_k = e} w_k
    T'_r(d_k)`` (the radial AEV's derivative along ``w``, the cotangent of
    ``g``) and ``gdist (N, K) = w_k sum_r g[n, e_k, r] T''_r(d_k)``; exact
    zeros on masked lanes."""
    if cutoff_kind not in CUTOFF_KINDS:
        raise ValueError(f"Unsupported cutoff kind {cutoff_kind!r}")
    fc, dfc = _cutoff_and_derivative(dist, cutoff, cutoff_kind)
    d2fc = _cutoff_second_derivative(dist, fc, dfc, cutoff, cutoff_kind)
    dr, ex = _gaussians(dist, eta, shifts)
    eta = float(np.float32(eta))
    fc, dfc, d2fc = fc[..., None], dfc[..., None], d2fc[..., None]
    dterm = 0.25 * ex * (dfc - 2 * eta * dr * fc)
    gg = species_sums(w[..., None] * dterm, species, num_species)
    e1 = -2 * eta * dr * ex
    e2 = (4 * eta * eta * dr * dr - 2 * eta) * ex
    d2term = 0.25 * (e2 * fc + 2 * e1 * dfc + ex * d2fc)
    gl = _species_cotangent(g, species, num_species, len(shifts))
    return gg, w * torch.sum(gl * d2term, dim=-1)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from torchani_tpu_torch.csrc import load_library

    lib = load_library("radial_aev")
    vp, ci, cf, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    terms = [
        ci, ci, ci,  # n, k, num_species
        vp, ci,  # shifts, num_shifts
        cf, cf, cf, ci,  # eta, cutoff, pi/cutoff, cutoff_kind
        ci, vp,  # device, stream
    ]
    lib.radial_aev_launch.argtypes = [vp, vp, vp] + terms  # dist, species, out
    lib.radial_aev_bwd_launch.argtypes = [
        vp, cll, vp, vp, vp,  # g, its row stride, dist, species, gdist
    ] + terms
    lib.radial_aev_bwd_bwd_launch.argtypes = [
        vp, cll, vp, vp, vp,  # g, its row stride, dist, species, w
        vp, vp,  # gg, gdist
    ] + terms
    for fn in (lib.radial_aev_launch, lib.radial_aev_bwd_launch, lib.radial_aev_bwd_bwd_launch):
        fn.restype = ci
    lib.radial_aev_error_string.argtypes = [ci]
    lib.radial_aev_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=16)
def _host_shifts(shifts: tp.Tuple[float, ...]) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(shifts, dtype=np.float32))


def _check(what: str, dist: Tensor, species: Tensor, kw: tp.Dict[str, tp.Any]) -> None:
    """The kernels' checks of their table inputs, on a CUDA ``dist``."""
    if dist.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dist.device}")
    if dist.dim() != 2 or species.shape != dist.shape:
        raise ValueError(
            f"{what}: dist {tuple(dist.shape)} and species {tuple(species.shape)} must be one "
            f"(N, K) shape"
        )
    if species.device != dist.device:
        raise ValueError(f"{what}: species is on {species.device}, not {dist.device}")
    if dist.dtype != torch.float32:
        raise TypeError(f"{what}: dist must be float32")
    if species.dtype != torch.int64:
        raise TypeError(f"{what}: species must be int64")
    if not (dist.is_contiguous() and species.is_contiguous()):
        raise ValueError(f"{what}: dist and species must be contiguous")
    if kw["cutoff_kind"] not in CUTOFF_KINDS:
        raise ValueError(f"{what}: unsupported cutoff kind {kw['cutoff_kind']!r}")
    r, s = len(kw["shifts"]), kw["num_species"]
    if not (0 < r <= MAX_RADIAL_SHIFTS and 0 < s <= MAX_RADIAL_SPECIES):
        raise ValueError(
            f"{what}: the kernel takes 1 to {MAX_RADIAL_SHIFTS} shifts and 1 to "
            f"{MAX_RADIAL_SPECIES} species, not {r} and {s}"
        )


def _check_cotangent(what: str, g: Tensor, dist: Tensor, width: int) -> None:
    if g.shape != (dist.shape[0], width):
        raise ValueError(f"{what}: g has shape {tuple(g.shape)}, not {(dist.shape[0], width)}")
    if g.device != dist.device:
        raise ValueError(f"{what}: g is on {g.device}, not {dist.device}")
    if g.dtype != torch.float32:
        raise TypeError(f"{what}: g must be float32")
    if g.stride(1) != 1 or (g.shape[0] > 1 and g.stride(0) < width):
        raise ValueError(f"{what}: g's columns must be contiguous (strides {g.stride()})")


def _launch(what: str, fn, device: torch.device, pointers: tp.Sequence, n: int, k: int,
            kw: tp.Dict[str, tp.Any]) -> None:
    """Launches one of the library's entry points on ``device``'s current
    stream; raises if the launch failed."""
    shifts = _host_shifts(tuple(kw["shifts"]))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(
            *pointers, n, k, kw["num_species"], shifts.ctypes.data, len(shifts),
            float(kw["eta"]), float(kw["cutoff"]), float(math.pi / kw["cutoff"]),
            CUTOFF_KINDS[kw["cutoff_kind"]], device.index, stream,
        )
    if rc != 0:
        msg = _library().radial_aev_error_string(rc).decode()
        raise RuntimeError(f"{what}: kernel launch failed: CUDA error {rc} ({msg})")


def radial_aev(
    dist: Tensor,  # (N, K)
    species: Tensor,  # (N, K) int64, -1 in masked lanes
    *,
    eta: float,
    shifts: tp.Sequence[float],
    cutoff: float,
    cutoff_kind: str,
    num_species: int,
) -> Tensor:
    """Fused radial AEV; returns ``(N, S * R)`` (species-major).

    CPU tensors take `radial_aev_reference`; CUDA tensors launch K6 and
    raise if it cannot run.  ``radial_aev.launches`` counts launches."""
    kw = dict(eta=eta, shifts=shifts, cutoff=cutoff, cutoff_kind=cutoff_kind,
              num_species=num_species)
    if dist.device.type == "cpu":
        return radial_aev_reference(dist, species, **kw)
    _check("radial_aev", dist, species, kw)
    n, k = dist.shape
    out = torch.empty((n, num_species * len(shifts)), dtype=torch.float32, device=dist.device)
    if n == 0:
        return out
    _launch("radial_aev", _library().radial_aev_launch, dist.device,
            (dist.data_ptr(), species.data_ptr(), out.data_ptr()), n, k, kw)
    radial_aev.launches += 1
    return out


radial_aev.launches = 0


def radial_aev_bwd(
    g: Tensor,  # (N, S * R), columns contiguous, any row stride
    dist: Tensor,  # (N, K)
    species: Tensor,  # (N, K) int64, -1 in masked lanes
    *,
    eta: float,
    shifts: tp.Sequence[float],
    cutoff: float,
    cutoff_kind: str,
    num_species: int,
) -> Tensor:
    """Backward of `radial_aev`: ``gdist (N, K)`` from the output's
    cotangent ``g``, which may be a column slice of a wider tensor.

    CPU tensors take `radial_aev_bwd_reference`; CUDA tensors launch K6b and
    raise if it cannot run.  ``radial_aev_bwd.launches`` counts launches."""
    kw = dict(eta=eta, shifts=shifts, cutoff=cutoff, cutoff_kind=cutoff_kind,
              num_species=num_species)
    if dist.device.type == "cpu":
        return radial_aev_bwd_reference(g, dist, species, **kw)
    what = "radial_aev_bwd"
    _check(what, dist, species, kw)
    _check_cotangent(what, g, dist, num_species * len(shifts))
    n, k = dist.shape
    gdist = torch.empty_like(dist)
    if n == 0:
        return gdist
    _launch(what, _library().radial_aev_bwd_launch, dist.device,
            (g.data_ptr(), max(g.stride(0), g.shape[1]), dist.data_ptr(), species.data_ptr(),
             gdist.data_ptr()), n, k, kw)
    radial_aev_bwd.launches += 1
    return gdist


radial_aev_bwd.launches = 0


def radial_aev_bwd_bwd(
    g: Tensor,  # (N, S * R), columns contiguous, any row stride
    dist: Tensor,  # (N, K)
    species: Tensor,  # (N, K) int64, -1 in masked lanes
    w: Tensor,  # (N, K)
    *,
    eta: float,
    shifts: tp.Sequence[float],
    cutoff: float,
    cutoff_kind: str,
    num_species: int,
) -> tp.Tuple[Tensor, Tensor]:
    """Backward of `radial_aev_bwd` (K6bb): ``(gg (N, S * R), gdist (N,
    K))`` from the cotangent ``w`` of its output (see
    `radial_aev_bwd_bwd_reference`).

    CPU tensors take `radial_aev_bwd_bwd_reference`; CUDA tensors launch
    K6bb once and raise if it cannot run.  ``radial_aev_bwd_bwd.launches``
    counts launches."""
    kw = dict(eta=eta, shifts=shifts, cutoff=cutoff, cutoff_kind=cutoff_kind,
              num_species=num_species)
    if dist.device.type == "cpu":
        return radial_aev_bwd_bwd_reference(g, dist, species, w, **kw)
    what = "radial_aev_bwd_bwd"
    _check(what, dist, species, kw)
    width = num_species * len(shifts)
    _check_cotangent(what, g, dist, width)
    if w.shape != dist.shape or w.device != dist.device or w.dtype != torch.float32 or not (
        w.is_contiguous()
    ):
        raise ValueError(f"{what}: w must be a contiguous float32 {tuple(dist.shape)} tensor "
                         f"on {dist.device}")
    n, k = dist.shape
    gg = torch.empty((n, width), dtype=torch.float32, device=dist.device)
    gdist = torch.empty_like(dist)
    if n == 0:
        return gg, gdist
    _launch(what, _library().radial_aev_bwd_bwd_launch, dist.device,
            (g.data_ptr(), max(g.stride(0), width), dist.data_ptr(), species.data_ptr(),
             w.data_ptr(), gg.data_ptr(), gdist.data_ptr()),
            n, k, kw)
    radial_aev_bwd_bwd.launches += 1
    return gg, gdist


radial_aev_bwd_bwd.launches = 0
