"""The yardstick: one H100's peaks and the least work of each layer.

Frozen copies from ``chip_smoke.py`` at commit b90920e: the peaks (lines
173-179) and the bound functions ``angular_bound_ms``, ``k3b_bytes``,
``k3bb_bound_ms`` and ``select_bound_ms`` (lines 414-502), with two
changes.  They return seconds.  And their byte counts
take what the inputs need, counted here from the atoms' positions, where
the originals took the program's padded tables: a lane is a neighbor pair
that exists, the candidate table of the refresh (the same positions copied
27 times over buckets) becomes the atoms' positions read once.  So a share
of a roofline here never counts the program's padding as work.

`count_work` counts, from coordinates alone, what an evaluation needs:
atoms of each element, neighbor pairs within each radius, angular pairs,
the cotangent rows K3b must read.  `network_flops` and `aev_flops` are the
work that ``mfu.*`` divides by the f32 peak.
"""

import typing as tp

import torch

from benchmark.reference.model import constants, find_pairs, pair_vectors
from benchmark.weights import aev_length

#: H100 SXM peaks (NVIDIA data sheet, dense, 700 W): non-tensor f32 and HBM
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
#: special-function instructions: 16 a clock on each of the 132 SMs (CUDA
#: programming guide, compute capability 9.0) at the 1,980 MHz boost clock
#: that the f32 peak assumes; worked out, not a data-sheet figure
PEAK_SFU_OPS = 132 * 16 * 1.98e9


def angular_bound_s(pairs: float, lanes: float, sh: int, se: int, nbytes: float,
                    backward: bool) -> float:
    """Least time for K3 (forward) or K3b (``backward``): the bytes moved once
    against the separable term's operations per valid pair, each unit at
    its own peak (``chip_smoke.angular_bound_ms``)."""
    z = sh * se
    if backward:
        sfu, f32 = sh + 2 * se + 6, 4 * z + 10 * (sh + se) + 50
    else:
        sfu, f32 = sh + 2 * se + 2, 2 * z + 4 * sh + 6 * se + 15
    by_f32 = pairs * f32 / PEAK_F32_FLOPS
    by_sfu = (pairs * sfu + 3 * lanes) / PEAK_SFU_OPS
    return max(by_f32, by_sfu, nbytes / PEAK_HBM_BYTES)


def k3bb_bound_s(pairs: float, lanes: float, sh: int, se: int, nbytes: float) -> float:
    """Least time for K3bb (``chip_smoke.k3bb_bound_ms``)."""
    sfu, f32 = sh + 3 * se + 1, 10 * sh * se + 25 * sh + 20 * se + 120
    by_f32 = pairs * f32 / PEAK_F32_FLOPS
    by_sfu = (pairs * sfu + 5 * lanes) / PEAK_SFU_OPS
    return max(by_f32, by_sfu, nbytes / PEAK_HBM_BYTES)


def angular_bytes(config: dict, w: tp.Mapping[str, float]) -> tp.Dict[str, float]:
    """Bytes K3, K3b and K3bb must move: each lane's distance, vector and
    species (20 bytes) read once; K3 writes the angular rows; K3b reads
    the cotangent rows that meet a pair and writes each lane's gradient
    (16 bytes); K3bb also reads the lanes' cotangents and writes the rows'
    (``chip_smoke.k3b_bytes`` and its K3bb sum)."""
    s = len(config["symbols"])
    nz = config["aev"]["angular"]["num_shifts"] * config["aev"]["angular"]["num_sections"]
    rows = w["atoms"] * s * (s + 1) // 2 * nz * 4
    lanes = w["angular_lanes"]
    k3 = 20 * lanes + rows
    k3b = 20 * lanes + 16 * lanes + w["k3b_rows"] * nz * 4
    k3bb = k3b + 16 * lanes + rows
    return {"k3": k3, "k3b": k3b, "k3bb": k3bb}


def select_bound_s(lanes: float, atoms: float, adds: bool) -> float:
    """Least time for K1 or K2: each lane's key (4 bytes) and vector or
    cotangent (12 bytes), and the atoms' positions read (K1) or gradients
    written (K2) once; K2 adds 3 a lane (``chip_smoke.select_bound_ms``
    with the positions in place of the bucket candidate table)."""
    nbytes = 16 * lanes + 12 * atoms
    by_ops = (3 * lanes if adds else 0) / PEAK_F32_FLOPS
    return max(nbytes / PEAK_HBM_BYTES, by_ops)


def count_work(config: dict, znums: torch.Tensor, coords: torch.Tensor,
               box: tp.Optional[float], molecule: tp.Optional[torch.Tensor],
               radii: tp.Mapping[str, float]) -> tp.Dict[str, float]:
    """What one evaluation of these atoms needs: ``atoms`` and
    ``atoms.<symbol>``, ``angular_lanes`` (directed pairs within the
    angular cutoff), ``angular_pairs`` (unordered neighbor pairs of a
    center within it), ``k3b_rows`` (the species-pair rows a center's
    angular neighbors meet), ``radial_lanes`` and ``lanes.<name>`` for each
    extra radius in ``radii``."""
    elements = constants()["elements"]
    symbols = list(config["symbols"])
    species = torch.full_like(znums, -1)
    for s, sym in enumerate(symbols):
        species[znums == elements[sym]["znumber"]] = s
    n = znums.shape[0]
    valid = species >= 0
    cut = max([config["aev"]["radial"]["cutoff"]] + list(radii.values()))
    boxt = None if box is None else torch.full((3,), float(box), device=coords.device)
    pairs = find_pairs(coords, cut, boxt, molecule if box is None else None)
    r = torch.linalg.vector_norm(pair_vectors(coords, pairs, boxt), dim=-1)
    ang = r < config["aev"]["angular"]["cutoff"]
    s = len(symbols)
    per = torch.zeros(n * s, dtype=torch.int64, device=coords.device)
    per.index_add_(0, pairs.i[ang] * s + species[pairs.j[ang]], torch.ones_like(pairs.i[ang]))
    per = per.reshape(n, s)
    lanes = per.sum(1)
    held = (per > 0).sum(1)
    out = {
        "atoms": float(valid.sum()),
        "angular_lanes": float(lanes.sum()),
        "angular_pairs": float((lanes * (lanes - 1) // 2).sum()),
        "k3b_rows": float((held * (held - 1) // 2 + (per > 1).sum(1)).sum()),
        "radial_lanes": float((r < config["aev"]["radial"]["cutoff"]).sum()),
    }
    for s_, sym in enumerate(symbols):
        out[f"atoms.{sym}"] = float((species == s_).sum())
    for name, radius in radii.items():
        out[f"lanes.{name}"] = float((r < radius).sum())
    return out


def network_flops(config: dict, w: tp.Mapping[str, float], products: int, members: int
                  ) -> float:
    """f32 operations of ``products`` passes of matrix products through
    ``members`` members' networks over the atoms in ``w`` (2 per multiply-add;
    forward and input backward of E+F and MD: 2; a force-training step:
    6, the forward, the forces' backward and the backward of both to the
    weights and the inputs)."""
    in_dim = aev_length(config)
    total = 0.0
    for sym in config["symbols"]:
        dims = [in_dim] + list(config["widths"][sym]) + [1]
        macs = sum(dims[i] * dims[i + 1] for i in range(len(dims) - 1))
        total += w.get(f"atoms.{sym}", 0.0) * macs
    return 2.0 * products * total * members


def aev_flops(config: dict, w: tp.Mapping[str, float], backward_order: int) -> float:
    """f32 operations of the AEV: the angular term's per-pair operations of
    K3 (forward), K3b (``backward_order`` >= 1) and K3bb (>= 2) as
    `angular_bound_s` counts them, and 5 a radial feature a lane forward,
    8 backward."""
    sh = config["aev"]["angular"]["num_shifts"]
    se = config["aev"]["angular"]["num_sections"]
    nr = config["aev"]["radial"]["num_shifts"]
    z = sh * se
    per_pair = 2 * z + 4 * sh + 6 * se + 15
    per_lane = 5 * nr
    if backward_order >= 1:
        per_pair += 4 * z + 10 * (sh + se) + 50
        per_lane += 8 * nr
    if backward_order >= 2:
        per_pair += 10 * z + 25 * sh + 20 * se + 120
        per_lane += 8 * nr
    return w["angular_pairs"] * per_pair + w["radial_lanes"] * per_lane

