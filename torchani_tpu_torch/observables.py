"""Trajectory observables: RDF, MSD, diffusion coefficient, velocity
autocorrelation (counterpart of ``torchani_tpu/observables.py``).

Companions to `MolecularDynamics.trajectory`'s frames.  Each function runs on
the device its frames lie on (a tensor keeps its device; other input goes to
CUDA unless ``device="cpu"`` is passed) and returns numpy, as the JAX
package's do.

The JAX package's RDF builds every atom's distance to every atom under each of
the 27 nearest images at once, ``(A, A, 27, 3)``: 32 GB for a 10,002-atom box.
Here only the center atoms' rows against the partner atoms' columns are
computed, in row blocks of at most `_RDF_BLOCK_BYTES`, with the same
arithmetic per pair, and the histogram is counted in integers
(`torch.bincount`).
"""

import itertools
import typing as tp

import numpy as np
import torch

from torchani_tpu_torch.annotations import DeviceArg, Tensor
from torchani_tpu_torch.arch import as_tensor
from torchani_tpu_torch.utils import tensor_on

__all__ = [
    "radial_distribution",
    "mean_squared_displacement",
    "velocity_autocorrelation",
    "diffusion_coefficient",
]

#: device memory that one row block of the RDF may take
_RDF_BLOCK_BYTES = 256 << 20
#: bytes a (center, partner) pair holds at once in a row block: its 27 image
#: candidates and their squares (27 x 3 floats each), their squared lengths
#: (27 floats), and 16 floats of difference, wrap, distance and bin index
_RDF_PAIR_BYTES = (2 * 27 * 3 + 27 + 16) * 4

#: the 27 image offsets in fractional units, in the JAX package's order
_SHIFTS = tuple(itertools.product((-1, 0, 1), repeat=3))


def _min_image_dist2(
    rows: Tensor, cols: Tensor, cell: tp.Optional[Tensor], inv: tp.Optional[Tensor]
) -> Tensor:
    """Squared distances ``(R, P)`` from each of ``rows (R, 3)`` to each of
    ``cols (P, 3)``, under minimum image where there is a cell: the
    fractional difference wrapped to [-0.5, 0.5], then the nearest of the
    27 adjacent images (exact for cells whose skew keeps the Wigner-Seitz
    cell inside +-1 images)."""
    diff = cols[None, :, :] - rows[:, None, :]  # (R, P, 3)
    if cell is None:
        return torch.sum(diff * diff, dim=-1)
    frac = diff @ inv
    frac = frac - torch.round(frac)
    base = frac @ cell
    shifts = torch.tensor(_SHIFTS, dtype=base.dtype, device=base.device) @ cell  # (27, 3)
    cand = base[:, :, None, :] + shifts
    return torch.amin(torch.sum(cand * cand, dim=-1), dim=-1)


def _pair_histogram(
    frames: Tensor,
    cell: tp.Optional[Tensor],
    r_max: float,
    num_bins: int,
    centers: Tensor,
    partners: Tensor,
) -> Tensor:
    """Integer counts ``(num_bins,)`` of (center, partner) pairs by distance,
    summed over the frames; a pair of an atom with itself is not counted."""
    inv = None if cell is None else torch.linalg.inv(cell)
    block = max(1, _RDF_BLOCK_BYTES // (_RDF_PAIR_BYTES * max(1, partners.numel())))
    counts = torch.zeros(num_bins + 1, dtype=torch.int64, device=frames.device)
    for coords in frames:
        cols = coords.index_select(0, partners)
        for start in range(0, centers.numel(), block):
            rows_idx = centers[start:start + block]
            d2 = _min_image_dist2(coords.index_select(0, rows_idx), cols, cell, inv)
            d = torch.sqrt(torch.clamp(d2, min=1e-12))
            d = torch.where(rows_idx[:, None] != partners[None, :], d, 2.0 * r_max)
            idx = torch.clamp((d / r_max * num_bins).to(torch.int32), 0, num_bins)
            counts += torch.bincount(idx.reshape(-1), minlength=num_bins + 1)
    return counts[:num_bins]


def radial_distribution(
    frames,  # (F, A, 3) coordinates
    cell,
    r_max: float,
    num_bins: int = 100,
    species=None,  # (A,) atomic numbers / element indices
    pair: tp.Optional[tp.Tuple[int, int]] = None,  # restrict to (za, zb)
    device: DeviceArg = None,
) -> tp.Tuple[np.ndarray, np.ndarray]:
    """g(r) averaged over frames.  Returns ``(bin centers, g)`` as numpy.

    ``pair=(za, zb)`` (with ``species``) restricts centers to species ``za``
    and partners to ``zb`` (e.g. O-O in water).  Normalization uses the
    ideal-gas shell count at the partner density in the (fixed) cell volume;
    without a cell, the density of the bounding sphere of the first frame.
    """
    frames = tensor_on(frames, torch.float32, device)
    dev = frames.device
    f, a, _ = frames.shape
    if species is not None and pair is not None:
        sp = as_tensor(species, torch.int64, dev).reshape(-1)
        centers = torch.nonzero(sp == pair[0]).reshape(-1)
        partners = torch.nonzero(sp == pair[1]).reshape(-1)
    else:
        centers = partners = torch.arange(a, device=dev)
    n_center, n_partner = float(centers.numel()), float(partners.numel())
    cell_t = None if cell is None else as_tensor(cell, torch.float32, dev)
    counts = _pair_histogram(frames, cell_t, r_max, num_bins, centers, partners)
    hist = counts.cpu().numpy() / f
    if cell is not None:
        volume = float(abs(np.linalg.det(cell_t.cpu().numpy())))
    else:
        c0 = frames[0].cpu().numpy()
        r = np.linalg.norm(c0 - c0.mean(0), axis=-1).max() + 1e-6
        volume = 4.0 / 3.0 * np.pi * r**3
    edges = np.linspace(0.0, r_max, num_bins + 1)
    centers_r = (edges[:-1] + edges[1:]) / 2.0
    shell = 4.0 * np.pi * centers_r**2 * (r_max / num_bins)
    ideal = shell * (n_partner / volume) * n_center
    return centers_r, hist / np.maximum(ideal, 1e-12)


def mean_squared_displacement(frames, device: DeviceArg = None) -> np.ndarray:
    """MSD(t) against the first frame, ``(F,)`` in Angstrom^2 (no unwrapping:
    feed unwrapped MD coordinates, which the integrators keep)."""
    frames = tensor_on(frames, torch.float32, device)
    d = frames - frames[0][None]
    return torch.mean(torch.sum(d * d, dim=-1), dim=-1).cpu().numpy()


def diffusion_coefficient(
    frames, frame_interval_fs: float, fit_from: float = 0.5, device: DeviceArg = None
) -> float:
    """Einstein diffusion coefficient D = slope(MSD) / 6 in Angstrom^2/fs.

    Least-squares slope over the tail of the MSD curve (``fit_from``
    fraction onward, past the ballistic and cage regime).  Multiply by 1e-1
    for cm^2/s.
    """
    msd = mean_squared_displacement(frames, device)
    f = msd.shape[0]
    start = min(f - 2, max(1, int(f * fit_from)))
    t = np.arange(start, f) * frame_interval_fs
    slope = np.polyfit(t, msd[start:], 1)[0]
    return float(slope / 6.0)


def velocity_autocorrelation(velocities, device: DeviceArg = None) -> np.ndarray:
    """Normalized VACF(t) = <v(0).v(t)> / <v(0).v(0)> over atoms, ``(F,)``."""
    v = tensor_on(velocities, torch.float32, device)
    num = torch.mean(torch.sum(v[0][None] * v, dim=-1), dim=-1)
    return (num / torch.clamp(num[0], min=1e-30)).cpu().numpy()
