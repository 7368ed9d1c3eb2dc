"""The fused angular-AEV kernel (K3) and its plain PyTorch version.

`angular_aev` is the counterpart of ``angular_aev_pallas``
(``torchani_tpu/aev/pallas_kernels.py:120``), with the same signature and the
same ``(N, P * Z)`` pair-major output.  On a CUDA tensor it launches the
hand-written kernel of ``csrc/angular_aev.cu`` (or raises); on a CPU tensor,
and only there, it computes `angular_aev_reference`, the plain
``(N, Ka, Ka, Z)`` formulation of the same function (`angular_grid`, which
the AEV computer's plain path also runs, with any cutoff).
"""

import ctypes
import functools
import math
import typing as tp

import numpy as np
import torch

from torchani_tpu_torch.aev.terms import ANIAngular
from torchani_tpu_torch.annotations import Tensor

__all__ = ["angular_aev", "angular_aev_reference", "angular_grid", "CUTOFF_KINDS"]

#: cutoff functions the kernel evaluates (code passed to the kernel)
CUTOFF_KINDS = {"cosine": 0, "smooth": 1}


def _section_trig(sections: tp.Sequence[float]) -> tp.Tuple[np.ndarray, np.ndarray]:
    """cos/sin of the angular sections, evaluated in f64 and rounded to f32
    (as the Pallas kernel does)."""
    sec = np.asarray(sections, dtype=np.float64)
    return np.cos(sec).astype(np.float32), np.sin(sec).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _pair_maps(num_species: int, device: torch.device) -> tp.Tuple[Tensor, Tensor, Tensor]:
    """Flat ``(s1, s2)`` and ``(s2, s1)`` indices of each packed species pair
    ``s1 <= s2``, and 1.0 off the diagonal, on ``device``.  Cached:
    uploading them on every call (the backward calls once per atom block)
    made each call wait for the device's queue."""
    iu1, iu2 = np.triu_indices(num_species)
    return tuple(
        torch.as_tensor(x, device=device)
        for x in (
            iu1 * num_species + iu2, iu2 * num_species + iu1,
            (iu1 != iu2).astype(np.float32),
        )
    )


def angular_grid(
    angular: ANIAngular,
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
    ``N * Ka^2 * Z``, so callers block large N.
    """
    n, ka = dist.shape
    dots = torch.sum(diff[:, :, None, :] * diff[:, None, :, :], dim=-1)
    cos = dots / torch.clamp(dist[:, :, None] * dist[:, None, :], min=1e-10)
    grid = (n, ka, ka)
    terms = angular(dist[:, :, None].expand(grid), dist[:, None, :].expand(grid), cos)

    # the pair mask (valid k > j) rides on the narrow one-hot side, not on
    # the (N, Ka, Ka, Z) terms; a masked j is dropped by the second sum
    ohm = oh.to(dist.dtype) * mask[..., None]
    upper = torch.ones((ka, ka), dtype=dist.dtype, device=dist.device).triu(1)
    ohk = upper[None, :, :, None] * ohm[:, None, :, :]  # (N, Ka_j, Ka_k, S)
    # v[n, s, t, z] = sum_{j<k} T[n, j, k, z] oh[n, j, s] oh[n, k, t]
    w = torch.einsum("njkz,njkt->njtz", terms, ohk)
    v = torch.einsum("njs,njtz->nstz", ohm, w)
    # packed pair p = {s1 <= s2}: v[s1, s2] + v[s2, s1], the diagonal once
    upper_pairs, lower_pairs, off_diag = _pair_maps(num_species, dist.device)
    v = v.reshape(n, num_species * num_species, angular.num_feats)
    packed = (
        v.index_select(1, upper_pairs)
        + v.index_select(1, lower_pairs) * off_diag[:, None]
    )
    return packed.reshape(n, upper_pairs.numel() * angular.num_feats)


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


def _library() -> ctypes.CDLL:
    from torchani_tpu_torch.csrc import load_library

    lib = load_library("angular_aev")
    fn = lib.angular_aev_launch
    if fn.argtypes is None:
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [
            vp, vp, vp, vp,  # dist, diff, species, out
            ci, ci, ci,  # n, ka, num_species
            vp, ci,  # shifts, num_shifts
            vp, vp, ci,  # cos_sections, sin_sections, num_sections
            cf, cf, cf, cf, ci,  # eta, zeta, cutoff, pi/cutoff, cutoff_kind
            ci, vp,  # device, stream
        ]
        fn.restype = ctypes.c_int
        lib.angular_aev_error_string.argtypes = [ctypes.c_int]
        lib.angular_aev_error_string.restype = ctypes.c_char_p
    return lib


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
) -> Tensor:
    """Fused angular AEV; returns ``(N, P * Z)`` (pair-major layout).

    CPU tensors take `angular_aev_reference`; CUDA tensors launch the kernel
    and raise if it cannot run.  ``angular_aev.launches`` counts launches.
    """
    kwargs = dict(
        eta=eta, zeta=zeta, shifts=shifts, sections=sections, cutoff=cutoff,
        cutoff_kind=cutoff_kind, num_species=num_species,
    )
    if dist.device.type == "cpu":
        return angular_aev_reference(dist, diff, mask, oh, **kwargs)
    if dist.device.type != "cuda":
        raise ValueError(f"angular_aev: unsupported device {dist.device}")
    n, ka = dist.shape
    if diff.shape != (n, ka, 3) or mask.shape != (n, ka) or oh.shape != (
        n, ka, num_species
    ):
        raise ValueError(
            f"angular_aev: shapes dist {tuple(dist.shape)}, diff "
            f"{tuple(diff.shape)}, mask {tuple(mask.shape)}, oh {tuple(oh.shape)} "
            f"do not agree with num_species={num_species}"
        )
    for name, t in (("dist", dist), ("diff", diff), ("mask", mask), ("oh", oh)):
        if t.device != dist.device:
            raise ValueError(f"angular_aev: {name} is on {t.device}, not {dist.device}")
    if dist.dtype != torch.float32 or diff.dtype != torch.float32:
        raise TypeError("angular_aev: dist and diff must be float32")
    if mask.dtype != torch.bool:
        raise TypeError("angular_aev: mask must be bool")
    if not (dist.is_contiguous() and diff.is_contiguous()):
        raise ValueError("angular_aev: dist and diff must be contiguous")
    if cutoff_kind not in CUTOFF_KINDS:
        raise ValueError(f"angular_aev: unsupported cutoff kind {cutoff_kind!r}")
    num_pairs = num_species * (num_species + 1) // 2
    out = torch.empty(
        (n, num_pairs * len(shifts) * len(sections)),
        dtype=torch.float32, device=dist.device,
    )
    if n == 0:
        return out
    species = torch.where(
        mask & (oh.sum(-1) > 0), oh.argmax(-1), -1
    ).to(torch.int32).contiguous()
    shifts_np = np.ascontiguousarray(np.asarray(shifts, dtype=np.float32))
    cos_np, sin_np = _section_trig(sections)
    lib = _library()
    with torch.cuda.device(dist.device):
        stream = torch.cuda.current_stream(dist.device).cuda_stream
        rc = lib.angular_aev_launch(
            dist.data_ptr(), diff.data_ptr(), species.data_ptr(), out.data_ptr(),
            n, ka, num_species,
            shifts_np.ctypes.data, len(shifts_np),
            cos_np.ctypes.data, sin_np.ctypes.data, len(cos_np),
            float(eta), float(zeta), float(cutoff), float(math.pi / cutoff),
            CUTOFF_KINDS[cutoff_kind], dist.get_device(), stream,
        )
    if rc != 0:
        msg = lib.angular_aev_error_string(rc).decode()
        raise RuntimeError(f"angular_aev: kernel launch failed: CUDA error {rc} ({msg})")
    angular_aev.launches += 1
    return out


angular_aev.launches = 0
