"""Neighbor tables with static capacities (counterpart of
``torchani_tpu/neighbors.py``).

A `Neighbors` table is a *full* per-atom table ``idx/mask/diff/dist`` of
shape ``(..., A, K)`` with a fixed capacity ``K``: every true pair appears in
both atoms' rows, out-of-cutoff and padding lanes are masked rather than
removed, and an ``overflow`` flag reports a row that held more real
neighbors than ``K``.  The capacities, the lane order (candidate order) and
the overflow semantics are those of the JAX package, so a table built here
holds the same neighbors in the same lanes.

Candidate screening runs on detached geometry; coordinates enter the
autograd graph only where ``diff``/``dist`` are recomputed from the packed
indices (`_finalize`).
"""

import dataclasses
import functools
import math
import typing as tp

import numpy as np
import torch

from torchani_tpu_torch.annotations import Tensor
from torchani_tpu_torch.profiling import scope
from torchani_tpu_torch.utils import _host, map_to_central

__all__ = [
    "Neighbors",
    "all_pairs",
    "cell_list",
    "adaptive_list",
    "narrow_to_cutoff",
    "neighbor_distances",
    "lane_permute",
    "repack_to_capacity",
    "estimate_capacity",
    "pbc_repeats",
    "pbc_shift_set",
    "compute_bounding_cell",
    "parse_neighborlist",
    "AllPairs",
    "CellList",
    "AdaptiveList",
    "VerletCellList",
    "FastCellList",
    "Neighborlist",
    "NeighborlistArg",
    "Triples",
    "neighbors_to_triples",
    "discard_inter_molecule_pairs",
    "discard_outside_cutoff",
    "reconstruct_shifts",
    "narrow_down",
    "coords_to_fractional",
    "setup_grid",
    "coords_to_grid_idx3",
    "flatten_idx3",
    "count_atoms_in_buckets",
    "atom_image_converters",
    "image_pairs_within",
    "lower_image_pairs_between",
]


@dataclasses.dataclass(frozen=True)
class Neighbors:
    """Padded full neighbor table.

    Attributes:
        idx: int64 ``(..., A, K)`` index of each neighbor atom within its
            system; arbitrary in masked lanes.
        mask: bool ``(..., A, K)``, which lanes hold real neighbors.
        diff: ``(..., A, K, 3)`` center -> neighbor vectors (image shift
            included), zero in masked lanes.
        dist: ``(..., A, K)`` distances, a safe nonzero value in masked lanes.
        overflow: bool scalar tensor, True if some row had more real
            neighbors than ``K`` (the table is then incomplete).
        elem: optional ``(..., A, K)`` neighbor species (-1 in masked lanes).
        select_tables: optional bucket tables
            (`torchani_tpu_torch.bucket_refresh.BucketTables`) of the table's
            full lane layout, attached by `MolecularDynamics`: with them
            `torchani_tpu_torch.bucket_refresh.select_lane_values` selects
            runtime per-atom values per lane without a gather.  They live in
            flat single-system atom space.
        pair_aux: optional ``(A, K, P)`` per-lane constants of one potential
            that `MolecularDynamics` computed at the last rebuild
            (``freeze_pair_window``), in the same flat space.
    """

    idx: Tensor
    mask: Tensor
    diff: Tensor
    dist: Tensor
    overflow: Tensor
    elem: tp.Optional[Tensor] = None
    select_tables: tp.Optional[tp.Any] = None
    pair_aux: tp.Optional[Tensor] = None

    @property
    def capacity(self) -> int:
        return self.idx.shape[-1]

    def nbr_elem(self, elem_flat: Tensor) -> Tensor:
        """Neighbor species table, from the cache or a fresh gather."""
        if self.elem is not None:
            return self.elem
        return elem_flat[self.idx]

    def replace(self, **changes) -> "Neighbors":
        return dataclasses.replace(self, **changes)


def _safe_norm(diff: Tensor, valid: Tensor) -> Tensor:
    """Norm along the last axis with NaN-free gradients in masked lanes."""
    d2 = torch.sum(diff * diff, dim=-1)
    return torch.sqrt(torch.where(valid, d2, torch.ones_like(d2)))


def pbc_repeats(
    cutoff: float, cell: np.ndarray, pbc: tp.Sequence[bool]
) -> tp.Tuple[int, int, int]:
    """Number of cell images needed per axis to cover ``cutoff`` (host)."""
    cell = np.asarray(cell, dtype=np.float64)
    reciprocal = np.linalg.inv(cell).T
    inv_distances = np.linalg.norm(reciprocal, axis=-1)
    num_repeats = np.ceil(cutoff * inv_distances).astype(np.int64)
    num_repeats = np.where(np.asarray(pbc, dtype=bool), num_repeats, 0)
    return (int(num_repeats[0]), int(num_repeats[1]), int(num_repeats[2]))


def pbc_shift_set(repeats: tp.Tuple[int, int, int]) -> np.ndarray:
    """Full symmetric set of integer image shifts, center (0,0,0) first."""
    r1, r2, r3 = repeats
    g = np.mgrid[-r1: r1 + 1, -r2: r2 + 1, -r3: r3 + 1].reshape(3, -1).T
    order = np.argsort(np.abs(g).sum(axis=1), kind="stable")
    return np.ascontiguousarray(g[order]).astype(np.int32)


def estimate_capacity(
    cutoff: float,
    num_atoms: int,
    density_per_a3: float = 0.12,
    safety: float = 1.35,
    periodic: bool = False,
) -> int:
    """Heuristic padded capacity for a neighbor table (the JAX package's
    rule: a sphere at slightly above liquid-water density, rounded up to a
    multiple of 8, clipped to ``num_atoms - 1`` without PBC)."""
    vol = 4.0 / 3.0 * math.pi * cutoff**3
    k = int(math.ceil(vol * density_per_a3 * safety))
    k = max(k, 8)
    if not periodic:
        k = min(k, max(num_atoms - 1, 1))
    return int(-(-k // 8) * 8) if k >= 8 else k


def _pack_positions(
    valid: Tensor, capacity: int
) -> tp.Tuple[Tensor, Tensor, Tensor]:
    """Positions of the first ``capacity`` valid candidates of each row, in
    candidate order.

    Returns ``(pos (R, K) int64, mask (R, K) bool, overflow ())``; ``pos`` is
    0 in masked lanes.  Each valid candidate goes to the lane given by its
    exclusive rank; ranks past the capacity land in a spill column that is
    cut away.
    """
    r, n = valid.shape
    vl = valid.to(torch.int64)
    count = vl.sum(dim=1)
    rank = torch.cumsum(vl, dim=1) - vl
    lanes = torch.arange(capacity, device=valid.device)
    mask = lanes[None, :] < count[:, None]
    overflow = torch.any(count > capacity)
    target = torch.where(valid & (rank < capacity), rank, capacity)
    src = torch.arange(n, device=valid.device).expand(r, n)
    pos = torch.zeros((r, capacity + 1), dtype=torch.int64, device=valid.device)
    pos.scatter_(1, target, src)
    pos = torch.where(mask, pos[:, :capacity], 0)
    return pos, mask, overflow


def _gather_atoms(x: Tensor, idx: Tensor) -> Tensor:
    """``x[c, idx[c, i, k]]`` for ``x (C, A, ...)`` and ``idx (C, A, K)``.

    An ``index_select`` over the flattened atoms: its backward is an
    ``index_add`` (atomic adds on the card), where the backward of advanced
    indexing sorts the ~K-fold repeated indices: 84 ms of a 123 ms E+F on
    the 10,002-atom water box on an H100 (700 W).
    """
    c, a = x.shape[:2]
    offsets = torch.arange(c, device=x.device)[:, None, None] * a
    flat = x.reshape((c * a,) + x.shape[2:])
    out = flat.index_select(0, (idx + offsets).reshape(-1))
    return out.reshape(idx.shape + x.shape[2:])


def _finalize(
    coords: Tensor,  # (C, A, 3)
    idx: Tensor,  # (C, A, K)
    mask: Tensor,  # (C, A, K)
    shift: tp.Optional[Tensor],  # (C, A, K, 3) cartesian or None
    overflow: Tensor,
    elem: tp.Optional[Tensor] = None,
) -> Neighbors:
    """Recompute differentiable diff/dist from packed indices.

    The only place where coordinates enter the autograd graph.
    """
    idx_safe = torch.where(mask, idx, 0)
    diff = _gather_atoms(coords, idx_safe) - coords[:, :, None, :]
    if shift is not None:
        diff = diff + shift
    diff = torch.where(mask[..., None], diff, torch.zeros_like(diff))
    return Neighbors(
        idx=idx_safe, mask=mask, diff=diff, dist=_safe_norm(diff, mask),
        overflow=overflow, elem=elem,
    )


def all_pairs(
    cutoff: float,
    elem_idxs: Tensor,  # (C, A) with -1 padding
    coords: Tensor,  # (C, A, 3)
    cell: tp.Optional[Tensor] = None,
    pbc: tp.Optional[Tensor] = None,
    capacity: tp.Optional[int] = None,
) -> Neighbors:
    """O(A^2) neighbor table, batched over molecules.

    ``cell``/``pbc`` apply to every molecule.  With PBC the image-shift set
    is derived on the host from the cell.
    """
    c, a = elem_idxs.shape
    dev = coords.device
    shift_set = None
    if pbc is not None:
        if cell is None:
            raise ValueError("If pbc is not None, cell should be present")
        cell_np = cell.detach().cpu().numpy()
        shift_set = pbc_shift_set(
            pbc_repeats(cutoff, cell_np, pbc.detach().cpu().numpy())
        )
        if capacity is None:
            # density-based: neighbors ~ (A / V_cell) * cutoff-sphere volume
            vol = abs(float(np.linalg.det(cell_np)))
            density = a / max(vol, 1e-6)
            est = density * 4.0 / 3.0 * math.pi * cutoff**3 * 1.6
            capacity = min(int(-(-max(est, 8.0) // 8) * 8), a * len(shift_set))
    if capacity is None:
        capacity = a
    real = elem_idxs >= 0
    no_overflow = torch.zeros((), dtype=torch.bool, device=dev)

    if shift_set is None or len(shift_set) == 1:
        if cell is not None and pbc is not None:
            coords = map_to_central(coords, cell, pbc)
        s = coords.detach()
        dist = _safe_norm(
            s[:, None, :, :] - s[:, :, None, :],
            torch.ones((c, a, a), dtype=torch.bool, device=dev),
        )
        not_self = ~torch.eye(a, dtype=torch.bool, device=dev)
        valid = not_self & real[:, :, None] & real[:, None, :] & (dist <= cutoff)
        if capacity >= a:
            # identity lanes: lane k IS candidate k, nothing to pack
            diff = coords[:, None, :, :] - coords[:, :, None, :]
            diff = torch.where(valid[..., None], diff, torch.zeros_like(diff))
            pad = capacity - a
            elem = torch.where(
                valid, elem_idxs[:, None, :].expand(c, a, a), -1
            )
            if pad:
                valid = torch.nn.functional.pad(valid, (0, pad))
                diff = torch.nn.functional.pad(diff, (0, 0, 0, pad))
                elem = torch.nn.functional.pad(elem, (0, pad), value=-1)
            idx = torch.clamp(torch.arange(capacity, device=dev), max=a - 1)
            return Neighbors(
                idx=idx.expand(c, a, capacity),
                mask=valid,
                diff=diff,
                dist=_safe_norm(diff, valid),
                overflow=no_overflow,
                elem=elem,
            )
        pos, mask, overflow = _pack_positions(valid.reshape(c * a, a), capacity)
        idx = pos.reshape(c, a, capacity)
        mask = mask.reshape(c, a, capacity)
        elem = torch.where(mask, _gather_atoms(elem_idxs[..., None], idx)[..., 0], -1)
        return _finalize(coords, idx, mask, None, overflow, elem)

    # periodic: (A, A * S) candidates over the static image-shift set,
    # candidate order (atom, shift)
    coords = map_to_central(coords, cell, pbc)
    ns = len(shift_set)
    shifts_frac = torch.as_tensor(shift_set, dtype=coords.dtype, device=dev)
    shifts_cart = shifts_frac @ cell.to(coords.dtype)  # (S, 3)
    s = coords.detach()
    scarts = shifts_cart.detach()
    d = (
        s[:, None, :, None, :]
        + scarts[None, None, None, :, :]
        - s[:, :, None, None, :]
    )  # (C, A, A, S, 3)
    dist = _safe_norm(d, torch.ones(d.shape[:-1], dtype=torch.bool, device=dev))
    is_zero_shift = torch.all(shifts_frac == 0, dim=-1)
    self_home = (
        torch.eye(a, dtype=torch.bool, device=dev)[:, :, None]
        & is_zero_shift[None, None, :]
    )
    valid = (
        ~self_home
        & real[:, :, None, None]
        & real[:, None, :, None]
        & (dist <= cutoff)
    )
    pos, mask, overflow = _pack_positions(valid.reshape(c * a, a * ns), capacity)
    pos = pos.reshape(c, a, capacity)
    mask = mask.reshape(c, a, capacity)
    idx = pos // ns
    shift = shifts_cart[pos % ns]
    elem = torch.where(mask, _gather_atoms(elem_idxs[..., None], idx)[..., 0], -1)
    return _finalize(coords, idx, mask, shift, overflow, elem)


def neighbor_distances(neighbors: Neighbors) -> Tensor:
    """The table's distances, ``inf`` outside the mask (for screening)."""
    return torch.where(neighbors.mask, neighbors.dist, torch.full_like(neighbors.dist, math.inf))


def narrow_to_cutoff(neighbors: Neighbors, cutoff: float) -> Neighbors:
    """Tighten the mask of a table to a smaller cutoff (lanes stay)."""
    mask = neighbors.mask & (neighbors.dist <= cutoff)
    return neighbors.replace(
        mask=mask,
        diff=torch.where(mask[..., None], neighbors.diff, torch.zeros_like(neighbors.diff)),
        dist=torch.where(mask, neighbors.dist, torch.ones_like(neighbors.dist)),
    )


def lane_permute(values: tp.Sequence[Tensor], top: Tensor) -> tp.List[Tensor]:
    """Apply a per-row lane permutation ``top (R, C)`` to ``(R, K[, ...])``
    tensors: ``out[r, c] = x[r, top[r, c]]``.

    A plain ``take_along_dim``; the JAX package contracts with a one-hot
    selector instead, because per-row lane gathers are slow on its device.
    """
    out = []
    for x in values:
        index = top.reshape(top.shape + (1,) * (x.dim() - 2))
        out.append(torch.take_along_dim(x, index.expand(top.shape + x.shape[2:]), dim=1))
    return out


def repack_to_capacity(neighbors: Neighbors, capacity: int) -> Neighbors:
    """Re-pack a (narrowed) table into a smaller static capacity, keeping
    each row's valid lanes in order as a prefix; sets the overflow flag when
    a row does not fit."""
    *batch, a, k = neighbors.idx.shape
    rows = neighbors.mask.reshape(-1, k)
    top, new_mask, overflow = _pack_positions(rows, capacity)
    out_shape = tuple(batch) + (a, capacity)
    top = top.reshape(out_shape)
    new_mask = new_mask.reshape(out_shape)

    def take(x: Tensor) -> Tensor:
        return torch.gather(x, -1, top)

    new_diff = torch.gather(
        neighbors.diff, -2, top[..., None].expand(out_shape + (3,))
    )
    new_diff = torch.where(new_mask[..., None], new_diff, torch.zeros_like(new_diff))
    new_dist = torch.where(new_mask, take(neighbors.dist), 1.0)
    elem = None
    if neighbors.elem is not None:
        elem = torch.where(new_mask, take(neighbors.elem), -1)
    return Neighbors(
        idx=torch.where(new_mask, take(neighbors.idx), 0),
        mask=new_mask,
        diff=new_diff,
        dist=new_dist,
        overflow=neighbors.overflow | overflow,
        elem=elem,
    )


def compute_bounding_cell(
    coords: Tensor, eps: float = 1e-3
) -> tp.Tuple[Tensor, Tensor]:
    """Rectangular cell minimally bounding ``coords``; displaces coords >= 0."""
    flat = coords.detach().reshape(-1, 3)
    min_ = torch.min(flat, dim=0).values - eps
    max_ = torch.max(flat, dim=0).values + eps
    return coords - min_, torch.diag(max_ - min_)


def _static_grid_shape(cell: np.ndarray, cutoff: float) -> tp.Tuple[int, int, int]:
    """Bucket-grid shape: one bucket >= cutoff along each cell vector (host)."""
    cell = np.asarray(cell, dtype=np.float64)
    reciprocal = np.linalg.inv(cell).T
    widths = 1.0 / np.linalg.norm(reciprocal, axis=-1)
    shape = np.floor(widths / cutoff).astype(np.int64)
    return (int(shape[0]), int(shape[1]), int(shape[2]))


def rank_in_bucket(bucket_id: Tensor) -> Tensor:
    """Rank of each atom within its bucket, in atom order (stable sort and
    segment starts)."""
    a = bucket_id.shape[0]
    pos = torch.arange(a, device=bucket_id.device)
    order = torch.argsort(bucket_id, stable=True)
    sorted_bucket = bucket_id[order]
    is_new = torch.ones(a, dtype=torch.bool, device=bucket_id.device)
    is_new[1:] = sorted_bucket[1:] != sorted_bucket[:-1]
    seg_start = torch.cummax(torch.where(is_new, pos, 0), dim=0).values
    rank = torch.empty_like(pos)
    rank[order] = pos - seg_start
    return rank


@functools.lru_cache(maxsize=16)
def _bucket_neighborhood(
    grid: tp.Tuple[int, int, int], periodic: bool, device: torch.device
) -> tp.Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """The static 27-neighborhood of every bucket of a grid, on ``device``:
    neighbor bucket ``(G, 27)``, section valid ``(G, 27)``, integer image
    wrap ``(G * 27, 3)``, zero-wrap ``(G, 27)`` and the grid dims ``(3,)``.

    Cached: uploading these on every call made each call wait for the
    device's queue.
    """
    gx, gy, gz = grid
    g = gx * gy * gz
    bidx3 = np.stack(
        np.meshgrid(np.arange(gx), np.arange(gy), np.arange(gz), indexing="ij"),
        axis=-1,
    ).reshape(g, 3)
    offs = np.mgrid[-1:2, -1:2, -1:2].reshape(3, -1).T  # (27, 3)
    nb3 = bidx3[:, None, :] + offs[None, :, :]  # (G, 27, 3)
    gdims = np.array([gx, gy, gz])
    if periodic:
        wrap = np.floor_divide(nb3, gdims)
        nb3w = nb3 - wrap * gdims
        sec_ok = np.ones((g, 27), dtype=bool)
    else:
        sec_ok = np.all((nb3 >= 0) & (nb3 < gdims), axis=-1)
        wrap = np.zeros_like(nb3)
        nb3w = np.clip(nb3, 0, gdims - 1)
    nb_bucket = (nb3w[..., 0] * gy + nb3w[..., 1]) * gz + nb3w[..., 2]
    return tuple(
        torch.as_tensor(x, device=device)
        for x in (nb_bucket, sec_ok, wrap.reshape(-1, 3), np.all(wrap == 0, axis=-1), gdims)
    )


def cell_list(
    cutoff: float,
    elem_idxs: Tensor,  # (1, A) or (A,)
    coords: Tensor,  # (1, A, 3) or (A, 3)
    cell: tp.Optional[Tensor] = None,
    pbc: tp.Optional[Tensor] = None,
    capacity: tp.Optional[int] = None,
    bucket_capacity: tp.Optional[int] = None,
    grid_shape: tp.Optional[tp.Tuple[int, int, int]] = None,
    bucket_aux: bool = False,
) -> tp.Union[Neighbors, tp.Tuple[Neighbors, tp.Dict[str, Tensor]]]:
    """O(A) neighbor table via a 3D bucket grid with static capacities.

    Atoms go into a ``(G, B)`` bucket table (static bucket capacity ``B``);
    each atom's candidates are the atoms of its 27 surrounding buckets in
    (section, bucket slot) order.  PBC wraps bucket coordinates and adds the
    image shift.  A bucket that overflows sets the overflow flag, as does a
    row with more than ``capacity`` neighbors.  A periodic cell with fewer
    than 3 buckets along an axis falls back to `all_pairs`, as in the JAX
    package.  ``grid_shape`` fixes the bucket grid (and spares reading the
    cell on the host); by default it follows from the cell and the cutoff.

    ``bucket_aux=True`` (periodic cells with at least 3 buckets per axis)
    returns ``(nbrs, aux)``, where ``aux`` holds the bucket structure that
    the MD bucket refresh needs (`torchani_tpu_torch.bucket_refresh`): each
    lane's packed candidate position is its ``(section, rank)`` key.
    ``keys`` ``(A, K)`` int32 ``(section << 8) | rank`` with the sentinel
    section 27 in masked lanes, ``atom_of_slot`` ``(G * B,)`` with the
    sentinel ``A``, ``slot_of_atom`` ``(A,)`` with -1 for dummy and
    overflowed atoms, and ``central`` ``(A, 3)``, the coordinates mapped
    into the cell.  In this mode ``diff`` and ``dist`` carry no gradient:
    the Verlet cache reads them for lane-sort keys and skin checks only,
    and forces flow through the per-step refresh.
    """
    squeeze = elem_idxs.dim() == 2
    if squeeze:
        if elem_idxs.shape[0] != 1:
            raise ValueError("cell_list supports a single system (shape (1, A))")
        elem_idxs = elem_idxs[0]
        coords = coords[0]
    a = coords.shape[0]
    dev = coords.device

    periodic = pbc is not None
    if periodic:
        if cell is None:
            raise ValueError("If pbc is not None, cell should be present")
        coords = map_to_central(coords, cell, pbc)
        used_cell = cell.to(coords.dtype)
        origin_coords = coords
    else:
        origin_coords, used_cell = compute_bounding_cell(coords, eps=1e-3)

    if grid_shape is None:
        grid_shape = _static_grid_shape(used_cell.detach().cpu().numpy(), cutoff)
    gx, gy, gz = (max(g, 1) for g in grid_shape)
    if bucket_aux and not periodic:
        raise ValueError("bucket_aux requires a periodic cell")
    if periodic and min(gx, gy, gz) < 3:
        if bucket_aux:
            raise ValueError("bucket_aux needs >= 3 buckets per axis (cell too small)")
        return all_pairs(
            cutoff, elem_idxs[None], coords[None], cell, pbc, capacity=capacity
        )
    g = gx * gy * gz
    if bucket_capacity is None:
        # mean occupancy x 2 headroom (overflow is detected and flagged)
        bucket_capacity = int(max(8, -(-2 * a // g // 8) * 8))
    b = bucket_capacity
    if capacity is None:
        capacity = estimate_capacity(cutoff, a, periodic=periodic)

    real = elem_idxs >= 0
    spos = origin_coords.detach()
    scell = used_cell.detach()
    with scope("neighbors.cell_inverse", wait=True):
        inverse = torch.linalg.inv(scell)  # its singularity check waits for a card
    frac = spos @ inverse
    if periodic:
        frac = frac - torch.floor(frac)
    frac = torch.clamp(frac, 0.0, 1.0 - 1e-7)
    nb_bucket, sec_ok, wrap, zero_shift, gdims = _bucket_neighborhood(
        (gx, gy, gz), periodic, dev
    )
    # a non-finite coordinate converts to a huge negative integer: keep it
    # in range (its distances stay NaN, so nothing wrong is selected)
    idx3 = torch.minimum((frac * gdims.to(frac.dtype)).to(torch.int64), gdims - 1).clamp(min=0)
    bucket_id = flatten_idx3(idx3, (gx, gy, gz))
    bucket_id = torch.where(real, bucket_id, g)  # dummies into a trash bucket

    pos = torch.arange(a, device=dev)
    rank = rank_in_bucket(bucket_id)

    in_table = real & (rank < b)
    bucket_overflow = torch.any(real & (rank >= b))
    table = torch.full(((g + 1) * b,), a, dtype=torch.int64, device=dev)
    table.scatter_(
        0, torch.where(in_table, bucket_id * b + rank, g * b), torch.where(in_table, pos, a)
    )
    table = table.view(g + 1, b)[:g]  # (G, B), a = empty slot

    valid_slot = table < a
    safe_table = torch.where(valid_slot, table, 0)
    pos_b = torch.where(valid_slot[..., None], spos[safe_table], 1e30)  # (G, B, 3)

    cand_idx_b = table[nb_bucket]  # (G, 27, B)
    cand_valid_b = (cand_idx_b < a) & sec_ok[..., None]
    cand_pos_b = pos_b[nb_bucket]  # (G, 27, B, 3)
    shift_cart_b = None
    if periodic:
        shift_cart_b = (wrap.to(scell.dtype) @ scell).reshape(g, 27, 3)
        cand_pos_b = cand_pos_b + shift_cart_b[:, :, None, :]
    d = cand_pos_b[:, None] - pos_b[:, :, None, None, :]  # (G, Bc, 27, B, 3)
    dist2 = torch.sum(d * d, dim=-1)  # (G, Bc, 27, B)
    same_atom = cand_idx_b[:, None] == safe_table[:, :, None, None]
    not_self = ~(same_atom & zero_shift[:, None, :, None])
    valid = (
        cand_valid_b[:, None]
        & not_self
        & (dist2 <= cutoff * cutoff)
        & valid_slot[:, :, None, None]
    )  # (G, Bc, 27, B)

    n = 27 * b
    atom_row = torch.where(in_table, bucket_id * b + rank, 0)
    valid_a = valid.reshape(g * b, n)[atom_row] & real[:, None]
    top, mask, overflow = _pack_positions(valid_a, capacity)
    g_of_atom = torch.where(real, bucket_id, 0)[:, None]
    # an atom that found no slot in its (overflowed) bucket reads another
    # row's candidates: keep its indices in range, the flag reports it
    idx = cand_idx_b.reshape(g * n)[g_of_atom * n + top].clamp(max=a - 1)
    if bucket_aux:
        # topology and build-time distances only: straight from the screened
        # (detached, shifted) candidate positions
        idx = torch.where(mask, idx, 0)
        diff = cand_pos_b.reshape(g * n, 3)[g_of_atom * n + top] - spos[:, None, :]
        diff = torch.where(mask[..., None], diff, torch.zeros_like(diff))
        nbrs = Neighbors(
            idx=idx[None], mask=mask[None], diff=diff[None],
            dist=_safe_norm(diff, mask)[None], overflow=overflow | bucket_overflow,
        )
    else:
        shift = None
        if periodic:
            shift = shift_cart_b[g_of_atom, top // b]  # (A, K, 3)
            shift = shift[None]
        nbrs = _finalize(
            origin_coords[None], idx[None], mask[None], shift,
            overflow | bucket_overflow,
        )
    if not squeeze:
        nbrs = nbrs.replace(
            idx=nbrs.idx[0], mask=nbrs.mask[0], diff=nbrs.diff[0], dist=nbrs.dist[0]
        )
    if bucket_aux:
        aux = {
            "keys": torch.where(mask, ((top // b) << 8) | (top % b), 27 << 8).to(torch.int32),
            "atom_of_slot": table.reshape(-1),
            "slot_of_atom": torch.where(in_table, bucket_id * b + rank, -1),
            "central": origin_coords.detach(),
        }
        return nbrs, aux
    return nbrs


def adaptive_list(
    cutoff: float,
    elem_idxs: Tensor,
    coords: Tensor,
    cell: tp.Optional[Tensor] = None,
    pbc: tp.Optional[Tensor] = None,
    capacity: tp.Optional[int] = None,
    threshold: int = 190,
    threshold_nopbc: int = 1770,
) -> Neighbors:
    """All-pairs below a size threshold (or for batches), cell list above."""
    num_atoms = elem_idxs.shape[-1]
    thresh = threshold if pbc is not None else threshold_nopbc
    if num_atoms < thresh or elem_idxs.shape[0] > 1:
        return all_pairs(cutoff, elem_idxs, coords, cell, pbc, capacity=capacity)
    return cell_list(cutoff, elem_idxs, coords, cell, pbc, capacity=capacity)


@dataclasses.dataclass(frozen=True)
class AllPairs:
    capacity: tp.Optional[int] = None

    def __call__(self, cutoff, elem_idxs, coords, cell=None, pbc=None):
        return all_pairs(cutoff, elem_idxs, coords, cell, pbc, capacity=self.capacity)


@dataclasses.dataclass(frozen=True)
class CellList:
    capacity: tp.Optional[int] = None
    bucket_capacity: tp.Optional[int] = None

    def __call__(self, cutoff, elem_idxs, coords, cell=None, pbc=None):
        return cell_list(
            cutoff, elem_idxs, coords, cell, pbc,
            capacity=self.capacity, bucket_capacity=self.bucket_capacity,
        )


@dataclasses.dataclass(frozen=True)
class AdaptiveList:
    capacity: tp.Optional[int] = None
    threshold: int = 190
    threshold_nopbc: int = 1770

    def __call__(self, cutoff, elem_idxs, coords, cell=None, pbc=None):
        return adaptive_list(
            cutoff, elem_idxs, coords, cell, pbc,
            capacity=self.capacity,
            threshold=self.threshold,
            threshold_nopbc=self.threshold_nopbc,
        )


@dataclasses.dataclass(frozen=True)
class VerletCellList(CellList):
    """The reference's skin-cached cell list.  The skin cache lives in
    `torchani_tpu_torch.md.MolecularDynamics` (its Verlet rebuild
    criterion), as in the JAX package; called on its own this is a plain
    `CellList`."""

    skin: float = 1.0


#: The reference's compiled twin of its cell list; here `CellList` is the
#: one cell list, so the name is an alias
FastCellList = CellList


class Neighborlist:
    """Base class of neighbor-list strategies, called as ``(cutoff,
    elem_idxs, coords, cell, pbc) -> Neighbors``."""

    def __call__(
        self,
        cutoff: float,
        elem_idxs: Tensor,
        coords: Tensor,
        cell: tp.Optional[Tensor] = None,
        pbc: tp.Optional[Tensor] = None,
        **kwargs,
    ) -> Neighbors:
        raise NotImplementedError("Must be implemented by subclasses")


NeighborlistArg = tp.Union[str, AllPairs, CellList, AdaptiveList]


def parse_neighborlist(neighborlist: NeighborlistArg):
    """String-dispatch registry."""
    if neighborlist == "all_pairs":
        return AllPairs()
    if neighborlist == "cell_list":
        return CellList()
    if neighborlist == "verlet_cell_list":
        return VerletCellList()
    if neighborlist == "adaptive":
        return AdaptiveList()
    if isinstance(neighborlist, (AllPairs, CellList, AdaptiveList)):
        return neighborlist
    raise ValueError(f"Unsupported neighborlist: {neighborlist}")


#: The reference's name of `narrow_to_cutoff`: lanes beyond the cutoff are
#: masked (the reference removes them)
discard_outside_cutoff = narrow_to_cutoff


def discard_inter_molecule_pairs(neighbors: Neighbors, molecule_idxs: Tensor) -> Neighbors:
    """Mask the pairs whose atoms belong to different molecules;
    ``molecule_idxs`` gives each atom of the flattened system its molecule.
    Neighbor indices are read as indices into the flattened system, as in
    the JAX package."""
    flat = molecule_idxs.reshape(-1)
    nbr_ids = flat[torch.where(neighbors.mask, neighbors.idx, 0)]
    if neighbors.idx.dim() == 3:
        c, a, _ = neighbors.idx.shape
        same = molecule_idxs.reshape(c, a)[:, :, None] == nbr_ids
    else:
        same = flat[:, None] == nbr_ids
    mask = neighbors.mask & same
    return neighbors.replace(
        mask=mask,
        diff=torch.where(mask[..., None], neighbors.diff, 0.0),
        dist=torch.where(mask, neighbors.dist, 1.0),
    )


def reconstruct_shifts(coords: Tensor, neighbors: Neighbors) -> Tensor:
    """The cartesian image shift of each lane, ``diff - (x_nbr - x_center)``
    (0 in masked lanes); neighbor positions are read from the flattened
    coordinates, as in the JAX package."""
    flat = coords.reshape(-1, 3)
    nbr_pos = flat[torch.where(neighbors.mask, neighbors.idx, 0)]
    if neighbors.idx.dim() == 3:
        c, a, _ = neighbors.idx.shape
        center = coords.reshape(c, a, 3)[:, :, None, :]
    else:
        center = flat[:, None, :]
    shift = neighbors.diff - (nbr_pos - center)
    return torch.where(neighbors.mask[..., None], shift, 0.0)


def narrow_down(
    cutoff: float,
    elem_idxs: Tensor,
    coords: Tensor,
    neighbors: Neighbors,
    shifts: tp.Optional[Tensor] = None,
) -> Neighbors:
    """Screen a candidate table down to the true neighbors: ``diff`` and
    ``dist`` recomputed (differentiably) from ``coords`` and the image
    shifts (``shifts``, else `reconstruct_shifts`), and lanes of padding
    atoms or beyond ``cutoff`` masked.  Neighbor positions are read from the
    flattened coordinates, as in the JAX package."""
    idx_safe = torch.where(neighbors.mask, neighbors.idx, 0)
    nbr_pos = coords.reshape(-1, 3)[idx_safe]
    shift = reconstruct_shifts(coords, neighbors) if shifts is None else shifts
    diff = nbr_pos + shift - coords[..., :, None, :]
    elem_flat = elem_idxs.reshape(-1)
    mask = neighbors.mask & (elem_flat[..., :, None] >= 0) & (elem_flat[idx_safe] >= 0)
    d2 = torch.sum(diff * diff, dim=-1)
    mask = mask & (d2 <= cutoff * cutoff)
    diff = torch.where(mask[..., None], diff, 0.0)
    dist = torch.sqrt(torch.where(mask, d2, 1.0))
    return neighbors.replace(idx=idx_safe, mask=mask, diff=diff, dist=dist)


class Triples(tp.NamedTuple):
    """Each center's pairs of neighbors, padded: the ``(Ka, Ka)`` grid of
    lane pairs with the strict upper triangle of valid ones masked in."""

    side_dist: Tensor  # (..., A, Ka, Ka, 2) distances (d_j, d_k)
    side_diff: Tensor  # (..., A, Ka, Ka, 2, 3) center -> side vectors
    side_idx: Tensor  # (..., A, Ka, Ka, 2) atom indices of the two sides
    mask: Tensor  # (..., A, Ka, Ka) valid pairs j < k


def neighbors_to_triples(neighbors: Neighbors) -> Triples:
    """Expand a neighbor table into padded per-center triples."""
    dist = torch.where(neighbors.mask, neighbors.dist, 1.0)
    ka = neighbors.capacity
    upper = torch.ones((ka, ka), dtype=torch.bool, device=dist.device).triu(1)
    mask = neighbors.mask[..., :, None] & neighbors.mask[..., None, :] & upper
    side_dist = torch.stack(
        torch.broadcast_tensors(dist[..., :, None], dist[..., None, :]), dim=-1
    )
    diff = neighbors.diff
    side_diff = torch.stack(
        torch.broadcast_tensors(diff[..., :, None, :], diff[..., None, :, :]), dim=-2
    )
    idx = neighbors.idx
    side_idx = torch.stack(torch.broadcast_tensors(idx[..., :, None], idx[..., None, :]), dim=-1)
    return Triples(side_dist, side_diff, side_idx, mask)


# ---- the reference's cell-list internals, as public functions ----


def coords_to_fractional(coords: Tensor, cell: Tensor) -> Tensor:
    """Fractional coordinates wrapped into [0, 1)."""
    return torch.remainder(coords @ torch.linalg.inv(cell), 1.0)


def setup_grid(
    cell, cutoff: float, buckets_per_cutoff: int = 1, extra_space: float = 1e-5
) -> np.ndarray:
    """Bucket-grid shape ``(GX, GY, GZ)`` (int64, host) of a cell: the
    distance between opposite faces over ``(cutoff + extra_space) /
    buckets_per_cutoff``, at least 1."""
    cell = _host(cell)
    bucket_len = (cutoff + extra_space) / buckets_per_cutoff
    vol = abs(float(np.linalg.det(cell)))
    heights = [
        vol / np.linalg.norm(np.cross(cell[(i + 1) % 3], cell[(i + 2) % 3])) for i in range(3)
    ]
    return np.maximum(np.floor(np.asarray(heights) / bucket_len), 1).astype(np.int64)


def coords_to_grid_idx3(coords: Tensor, cell: Tensor, grid_shape) -> Tensor:
    """Integer 3D bucket index of each atom (int64)."""
    gs = torch.as_tensor(np.asarray(grid_shape), dtype=torch.int64, device=coords.device)
    idx3 = torch.floor(coords_to_fractional(coords, cell) * gs).to(torch.int64)
    return torch.minimum(idx3.clamp(min=0), gs - 1)


def flatten_idx3(idx3: Tensor, grid_shape) -> Tensor:
    """Row-major flat bucket index of 3D bucket indices."""
    gy, gz = int(grid_shape[1]), int(grid_shape[2])
    return (idx3[..., 0] * gy + idx3[..., 1]) * gz + idx3[..., 2]


def count_atoms_in_buckets(atom_grid_idx: Tensor, grid_shape) -> tp.Tuple[Tensor, Tensor]:
    """Atoms in each flat bucket, and their exclusive cumulative count."""
    g = int(np.prod(np.asarray(grid_shape)))
    count = torch.bincount(atom_grid_idx.reshape(-1), minlength=g)
    return count, torch.cumsum(count, dim=0) - count


def atom_image_converters(grid_idx: Tensor) -> tp.Tuple[Tensor, Tensor]:
    """The permutations between atom order and bucket-sorted ("image")
    order: ``(image_to_atom, atom_to_image)``."""
    image_to_atom = torch.argsort(grid_idx.reshape(-1), stable=True)
    return image_to_atom, torch.argsort(image_to_atom)


def image_pairs_within(
    count_in_grid: Tensor, cumcount_in_grid: Tensor, count_in_grid_max: int
) -> Tensor:
    """Every pair of image indices within one bucket, ``(2, W)``.  Its size
    depends on the data: it is computed on the host (the cell list here
    pairs buckets in padded tables instead)."""
    count = _host(count_in_grid)
    cum = _host(cumcount_in_grid)
    tl = np.tril_indices(count_in_grid_max, -1)
    pairs = []
    for g in np.flatnonzero(count > 1):
        keep = (tl[0] < count[g]) & (tl[1] < count[g])
        pairs.append(np.stack([tl[0][keep], tl[1][keep]]) + cum[g])
    out = np.concatenate(pairs, axis=1) if pairs else np.zeros((2, 0))
    dev = count_in_grid.device if isinstance(count_in_grid, torch.Tensor) else None
    return torch.as_tensor(out.astype(np.int64), device=dev)


def lower_image_pairs_between(
    count_in_atom_surround: Tensor,  # (C, A, 13)
    cumcount_in_atom_surround: Tensor,  # (C, A, 13)
    shift_idxs_between: Tensor,  # (C, A, 13, 3)
    count_in_grid_max: int,
) -> tp.Tuple[Tensor, Tensor]:
    """The lower-side image indices of the candidate pairs between buckets,
    and their shift indices.  Computed on the host, as
    `image_pairs_within`."""
    count = _host(count_in_atom_surround)
    cum = _host(cumcount_in_atom_surround)
    shifts = _host(shift_idxs_between)
    lanes = np.broadcast_to(np.arange(count_in_grid_max), count.shape + (count_in_grid_max,))
    mask = lanes < count[..., None]
    padded = lanes + cum[..., None]
    shifts_b = np.broadcast_to(shifts[..., None, :], count.shape + (count_in_grid_max, 3))
    dev = (
        count_in_atom_surround.device if isinstance(count_in_atom_surround, torch.Tensor) else None
    )
    return (
        torch.as_tensor(padded[mask].astype(np.int64), device=dev),
        torch.as_tensor(shifts_b[mask].astype(np.int64), device=dev),
    )
