"""The per-step Verlet refresh over cell-list buckets (counterpart of
``torchani_tpu/bucket_refresh.py``).

The MD refresh must produce each atom's K neighbor positions from the
current coordinates.  Here it is a *bucket-local* selection:

- Atoms are binned into the cell-list bucket grid (edge >= cutoff + skin),
  ``C`` padded slots per bucket.  A bucket's candidates are the atoms of its
  27 surrounding buckets, built every step from the ``(G, C, 3)`` slot table
  plus a constant image shift per (bucket, section) (`_cand_table`).  The
  JAX package builds them with 27 rolls of the slot table; a roll over three
  axes is three launches here, and the step is bound by the host's launch
  rate, so the same table is one row gather through a static index.
- Each neighbor lane caches, at rebuild time, the *candidate key*
  ``(section << 8) | rank`` of its partner: which of the bucket's ``27 * C``
  candidates it is (section 27 is the sentinel of a masked lane).  The
  per-step work is then one selection per lane, the kernel K1
  (`bucket_select_fwd`), and its transpose in the backward, the kernel K2
  (`bucket_select_bwd`), which sums each lane's cotangent onto its
  candidate.  Both are hand-written CUDA kernels (``csrc/bucket_select.cu``)
  that read and write f32: the selection is exact.

The JAX package runs the same selection as one-hot matrix products over a
bf16 triple split of the values, with sections padded to 32 rows; those are
devices of its hardware and are not carried over.  Layouts here are the
natural ones: ``cand (G, 27, C, 3)``, ``keys (G, R)`` with ``R = C * K`` and
``r = c * K + k``, ``out (G, R, 3)``.

The same tables select runtime per-atom VALUES per lane (`bucket_lane_values`,
`select_lane_values`): ``values[idx]`` for quantities that change every step
(the D3 dispersion's coordination numbers), with P channels in place of the 3
of a position and no image shift.  Its kernels are K4f (`vals_select_fwd`)
and K4b (`vals_select_bwd`), in ``csrc/vals_select.cu``.

Coordinate convention: MD coordinates drift unwrapped across the periodic
box.  All positions here are *canonical*: ``canon = coords - wrap_offset``
where ``wrap_offset`` is frozen at rebuild time, so canonical positions move
continuously, live in the box the bucket grid was built for, and the
per-(bucket, section) shift stays constant between rebuilds.
"""

import ctypes
import dataclasses
import functools
import typing as tp

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from torchani_tpu_torch.annotations import Tensor
from torchani_tpu_torch.neighbors import rank_in_bucket

__all__ = [
    "BucketTables",
    "build_bucket_tables",
    "bucket_nbr_pos",
    "bucket_select_fwd",
    "bucket_select_bwd",
    "bucket_select_reference",
    "bucket_select_bwd_reference",
    "bucket_lane_values",
    "select_lane_values",
    "vals_select_fwd",
    "vals_select_bwd",
    "vals_select_reference",
    "vals_select_bwd_reference",
    "make_wrapshift",
    "tables_from_cell_aux",
    "bwd_launch_shape",
    "fwd_launch_shape",
    "packed_launch_shape",
]

#: lane key encoding: (section << 8) | rank; section 27 = masked sentinel
_SENTINEL = 27 << 8
#: the rank has 8 bits
MAX_SLOTS = 256
#: dynamic shared memory a block may have on an H100: a bucket's candidate
#: tile must fit it
MAX_SHARED_BYTES = 227 * 1024
#: an H100 SM's shared memory, the part of it the card keeps per block, and
#: the threads it holds: how many backward blocks fit an SM at once
SM_SHARED_BYTES = 228 * 1024
BLOCK_RESERVED_BYTES = 1024
SM_THREADS = 2048
#: block sizes of K1, K2, K4b, K5f and K5b, in order of preference (their
#: sources take these two); the cluster sizes over which K2 and K4b split a
#: bucket's lanes and K5f and K5b its tiles (8 is the portable maximum), and
#: the most independent blocks K1 splits a bucket over
SPLIT_THREADS = (1024, 512)
CLUSTER_SPLITS = (1, 2, 4, 8)
MAX_FWD_SPLIT = 64

_SECTION_OFFSETS = np.mgrid[-1:2, -1:2, -1:2].reshape(3, -1).T  # (27, 3)


@dataclasses.dataclass(frozen=True)
class BucketTables:
    """Rebuild-time tables of the bucket refresh.

    Every static parameter follows from the shapes: the grid from
    ``wrapshift``, ``C`` from ``atom_of_slot`` against the grid, ``K`` from
    ``keys`` against ``C``.
    """

    keys: Tensor  # (G, C*K) int32 (section << 8) | rank per (slot row, lane)
    atom_of_slot: Tensor  # (G*C,) int64 atom index per slot, sentinel = A
    slot_of_atom: Tensor  # (A,) int64 slot per atom, -1 for dummy/overflowed atoms
    wrap_offset: Tensor  # (A, 3) f32, frozen: canon = coords - wrap_offset
    wrapshift: Tensor  # (gx, gy, gz, 27, 3) f32 image shift per (bucket, section)


def make_wrapshift(grid_shape: tp.Tuple[int, int, int], cell: np.ndarray) -> np.ndarray:
    """(gx, gy, gz, 27, 3) cartesian shift: section o of bucket b holds atoms
    of bucket wrap(b3 + off_o); the shift is the unwrap ``floordiv`` times
    the cell."""
    gx, gy, gz = grid_shape
    b3 = np.stack(
        np.meshgrid(np.arange(gx), np.arange(gy), np.arange(gz), indexing="ij"),
        axis=-1,
    )  # (gx, gy, gz, 3)
    nb3 = b3[:, :, :, None, :] + _SECTION_OFFSETS[None, None, None, :, :]
    wrap = np.floor_divide(nb3, np.array([gx, gy, gz]))
    return (
        (wrap.reshape(-1, 3) @ np.asarray(cell))
        .reshape(gx, gy, gz, 27, 3)
        .astype(np.float32)
    )


def _check_slots(c: int) -> None:
    if not 0 < c <= MAX_SLOTS:
        raise ValueError(
            f"bucket slot capacity c={c} must be in 1..{MAX_SLOTS}: a lane key "
            f"holds the rank in 8 bits"
        )


def _slot_row_keys(keys_atom: Tensor, atom_of_slot: Tensor, g: int) -> Tensor:
    """Lane keys ``(A, K)`` in slot-row order ``(G, C * K)``; an empty slot's
    row holds sentinels."""
    a, k = keys_atom.shape
    pad = torch.full((1, k), _SENTINEL, dtype=torch.int32, device=keys_atom.device)
    keys_pad = torch.cat([keys_atom, pad], dim=0)
    return keys_pad.index_select(0, atom_of_slot.clamp(max=a)).reshape(g, -1)


@torch.no_grad()
def build_bucket_tables(
    coords: Tensor,  # (A, 3) internal-order, unwrapped
    idx: Tensor,  # (A, K) cached neighbor table
    mask: Tensor,  # (A, K)
    shift: Tensor,  # (A, K, 3) cached cartesian image shifts
    valid_atom: Tensor,  # (A,) bool, False for dummy padding atoms
    cell: Tensor,  # (3, 3)
    grid_shape: tp.Tuple[int, int, int],
    c: int,  # slot capacity
    wrapshift: Tensor,  # (gx, gy, gz, 27, 3) from make_wrapshift
) -> tp.Tuple[BucketTables, Tensor]:
    """Derive the refresh tables from a cached topology.  Returns
    ``(tables, overflow)``."""
    gx, gy, gz = grid_shape
    g = gx * gy * gz
    a, k = idx.shape
    _check_slots(c)
    dev = coords.device

    cell_inv = torch.linalg.inv(cell)
    u = coords @ cell_inv  # (A, 3) fractional, unwrapped
    fu = torch.floor(u)
    m = torch.clamp(u - fu, 0.0, 1.0 - 1e-7)
    gdims = torch.tensor([gx, gy, gz], dtype=torch.int64, device=dev)
    idx3 = torch.minimum((m * gdims.to(m.dtype)).to(torch.int64), gdims - 1)  # (A, 3)
    bucket = (idx3[:, 0] * gy + idx3[:, 1]) * gz + idx3[:, 2]
    bucket = torch.where(valid_atom, bucket, g)  # dummies into a trash bucket
    rank = rank_in_bucket(bucket)
    slot_ok = valid_atom & (rank < c)
    overflow = torch.any(valid_atom & (rank >= c))

    slot_of_atom = torch.where(slot_ok, bucket * c + rank, -1)
    atom_of_slot = torch.full((g * c + 1,), a, dtype=torch.int64, device=dev)
    atom_of_slot.scatter_(
        0,
        torch.where(slot_ok, slot_of_atom, g * c),
        torch.where(slot_ok, torch.arange(a, device=dev), a),
    )
    atom_of_slot = atom_of_slot[: g * c]

    # ---- per-lane candidate keys ----
    # The section offset is derived from INTEGER quantities only (bucket
    # indices + exact lattice wraps), never from float floors of the pair
    # position: a float re-derivation can disagree with the partner's own
    # bucket assignment at gridline boundaries, silently selecting the
    # wrong atom.  Identity: the lane's image sits in virtual bucket
    # idx3_j + gdims * D with D = fu_j + w - fu_i, and only D mod 3 matters
    # because a valid offset lands in [-1, 1].
    fm = torch.remainder(fu.to(torch.int64), 3)  # (A, 3) in [0, 3)
    jidx = torch.where(mask, idx, 0)
    rank_j = rank[jidx]  # (A, K)
    fm_j = fm[jidx]  # (A, K, 3)
    idx3_j = idx3[jidx]
    w = torch.round(shift @ cell_inv).to(torch.int64)  # (A, K, 3) lattice wrap
    d3 = torch.remainder(fm_j + w - fm[:, None, :] + 1, 3) - 1  # in {-1, 0, 1}
    off3 = idx3_j + gdims * d3 - idx3[:, None, :]  # (A, K, 3)
    off_ok = torch.all((off3 >= -1) & (off3 <= 1), dim=-1)
    overflow = overflow | torch.any(mask & ~off_ok)
    overflow = overflow | torch.any(mask & (rank_j >= c))
    o = ((off3[..., 0] + 1) * 3 + (off3[..., 1] + 1)) * 3 + (off3[..., 2] + 1)
    lane_ok = mask & off_ok & (rank_j < c)
    keys_atom = torch.where(lane_ok, (o << 8) | rank_j, _SENTINEL).to(torch.int32)

    tables = BucketTables(
        keys=_slot_row_keys(keys_atom, atom_of_slot, g),
        atom_of_slot=atom_of_slot,
        slot_of_atom=slot_of_atom,
        wrap_offset=(fu @ cell).to(coords.dtype),
        wrapshift=wrapshift,
    )
    return tables, overflow


@torch.no_grad()
def tables_from_cell_aux(
    keys_atom: Tensor,  # (A, K) (section << 8) | rank, sentinel section 27
    mask: Tensor,  # (A, K) final lane mask (after any lane permutation)
    atom_of_slot: Tensor,  # (G*C,) from cell_list's aux, sentinel = A
    slot_of_atom: Tensor,  # (A,) from cell_list's aux, -1 invalid
    wrap_offset: Tensor,  # (A, 3) coords - central (frozen at rebuild)
    wrapshift: Tensor,  # (gx, gy, gz, 27, 3) static, from make_wrapshift
    c: int,
) -> BucketTables:
    """Assemble refresh tables from ``cell_list(..., bucket_aux=True)``: a
    sentinel re-mask and the slot-row reorder.  The cell list's packed
    candidate positions are the keys, so `build_bucket_tables`' derivation is
    not needed."""
    _check_slots(c)
    g = atom_of_slot.shape[0] // c
    keys_atom = torch.where(mask, keys_atom, _SENTINEL).to(torch.int32)
    return BucketTables(
        keys=_slot_row_keys(keys_atom, atom_of_slot, g),
        atom_of_slot=atom_of_slot,
        slot_of_atom=slot_of_atom,
        wrap_offset=wrap_offset,
        wrapshift=wrapshift,
    )


# ---------------------------------------------------------------------------
# K1 and K2: the selection and its transpose
# ---------------------------------------------------------------------------


def _flat_index(keys: Tensor, c: int) -> Tensor:
    """Position ``section * C + rank`` of each key in a bucket's flat
    candidate table; the sentinel section lands in ``[27 C, 28 C)``."""
    keys = keys.to(torch.int64)
    return (keys >> 8) * c + (keys & 255)


def bucket_select_reference(
    cand: Tensor, keys: Tensor, nlanes: tp.Optional[Tensor] = None
) -> Tensor:
    """Plain version of `bucket_select_fwd` (the counterpart of
    ``_ref_select_fwd``): a gather from each bucket's flat candidate table,
    padded with a zero section for the sentinel.  Lanes at or past
    ``nlanes[g]`` give 0.  Any number of channels: ``cand (G, 27, C, P)``."""
    g, _, c, p = cand.shape
    flat = torch.nn.functional.pad(cand.reshape(g, 27 * c, p), (0, 0, 0, c))
    index = _flat_index(keys, c)
    out = torch.gather(flat, 1, index[:, :, None].expand(-1, -1, p))
    if nlanes is not None:
        lanes = torch.arange(keys.shape[1], device=keys.device)
        out = torch.where((lanes[None, :] < nlanes[:, None])[..., None], out, 0.0)
    return out


def bucket_select_bwd_reference(
    g_out: Tensor, keys: Tensor, c: int, nlanes: tp.Optional[Tensor] = None
) -> Tensor:
    """Plain version of `bucket_select_bwd` (the counterpart of
    ``_ref_select_bwd``): a scatter-add onto each bucket's flat candidate
    table; the sentinel section is cut away.  Any number of channels."""
    g, r, p = g_out.shape
    if nlanes is not None:
        lanes = torch.arange(r, device=keys.device)
        g_out = torch.where((lanes[None, :] < nlanes[:, None])[..., None], g_out, 0.0)
    d_flat = g_out.new_zeros((g, 28 * c, p))
    d_flat.scatter_add_(1, _flat_index(keys, c)[:, :, None].expand(-1, -1, p), g_out)
    return d_flat[:, : 27 * c].reshape(g, 27, c, p)


def _library() -> ctypes.CDLL:
    from torchani_tpu_torch.csrc import load_library

    lib = load_library("bucket_select")
    if lib.bucket_select_fwd_launch.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        # source, keys, nlanes (or null), destination; G, C, R, the split S
        # and the threads a block; device, stream
        for fn in (lib.bucket_select_fwd_launch, lib.bucket_select_bwd_launch):
            fn.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, vp]
            fn.restype = ci
        lib.bucket_select_error_string.argtypes = [ci]
        lib.bucket_select_error_string.restype = ctypes.c_char_p
    return lib


def _check_kernel_args(
    name: str, values: Tensor, keys: Tensor, nlanes: tp.Optional[Tensor], g: int, c: int
) -> None:
    _check_slots(c)
    if values.dtype != torch.float32:
        raise TypeError(f"{name}: values must be float32, not {values.dtype}")
    if keys.dtype != torch.int32:
        raise TypeError(f"{name}: keys must be int32, not {keys.dtype}")
    if keys.dim() != 2 or keys.shape[0] != g:
        raise ValueError(f"{name}: keys {tuple(keys.shape)} must be (G={g}, R)")
    if nlanes is not None:
        if nlanes.dtype != torch.int32 or tuple(nlanes.shape) != (g,):
            raise ValueError(f"{name}: nlanes must be int32 of shape ({g},)")
    for what, t in (("values", values), ("keys", keys), ("nlanes", nlanes)):
        if t is None:
            continue
        if t.device != values.device:
            raise ValueError(f"{name}: {what} is on {t.device}, not {values.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")


def _one_wave(g: int, tile_bytes: int, sms: int) -> tp.Tuple[int, int]:
    """``(threads, most)`` for a selection kernel at ``G`` buckets on
    ``sms`` SMs, each block holding a bucket's tile of ``tile_bytes``: the
    first block size of `SPLIT_THREADS` at which all G buckets' blocks fit
    on the card at once (an SM holds 2,048 threads, and fewer blocks where
    the tile takes more of its shared memory), and the most blocks a bucket
    may then have in that one wave; 1,024 threads and 1 where no size does.
    A block has a fixed lifetime (its tile, and for K2 and K4b two cluster
    barriers and the reduction), so a second wave costs more than the
    threads it adds."""
    if not 0 < tile_bytes <= MAX_SHARED_BYTES:
        raise ValueError(
            f"a bucket's candidate tile of {tile_bytes} bytes does not fit the "
            f"{MAX_SHARED_BYTES} bytes of shared memory a block may have"
        )
    by_smem = SM_SHARED_BYTES // (tile_bytes + BLOCK_RESERVED_BYTES)
    for threads in SPLIT_THREADS:
        resident = sms * max(min(SM_THREADS // threads, by_smem), 1)
        if g <= resident:
            return threads, resident // g
    return SPLIT_THREADS[0], 1


def _cluster_split(g: int, tile_bytes: int, sms: int) -> tp.Tuple[int, int]:
    """``(threads, S)`` for K2 and K4b: each bucket's occupied lanes go to
    a cluster of S blocks, the largest S in `CLUSTER_SPLITS` that
    `_one_wave` allows.  On an H100 S = 2 beats S = 4 at 125 buckets, and
    512 threads beat 1,024 at 343."""
    threads, most = _one_wave(g, tile_bytes, sms)
    return threads, max(s for s in CLUSTER_SPLITS if s <= most)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def bwd_launch_shape(g: int, c: int, p: int, device: torch.device) -> tp.Dict[str, int]:
    """How K2 (``p = 3``) or K4b launch for ``G`` buckets of ``C`` slots on
    a CUDA ``device``: the cluster split S, the blocks, the threads a block
    and the shared memory a block (its candidate tile)."""
    smem = 27 * c * p * 4
    threads, s = _cluster_split(g, smem, _sm_count(torch.device(device)))
    return {"split": s, "blocks": g * s, "threads": threads, "smem_bytes": smem}


def _fwd_split(g: int, r: int, tile_bytes: int, sms: int) -> tp.Tuple[int, int]:
    """``(threads, S)`` for K1 at ``G`` buckets of ``R`` lanes: each
    bucket's occupied lanes go to S independent blocks, each of which loads
    the bucket's tile, the most that `_one_wave` allows (no more than
    leaves each block of a full bucket a lane a thread, at most
    `MAX_FWD_SPLIT`).  On an H100 this gives S = 2 of 1,024 threads at the
    ANI-2dr tables and S = 1 of 512 at the ANI-2x ones."""
    threads, most = _one_wave(g, tile_bytes, sms)
    return threads, max(1, min(most, r // threads, MAX_FWD_SPLIT))


def fwd_launch_shape(g: int, c: int, r: int, device: torch.device) -> tp.Dict[str, int]:
    """How K1 launches for ``G`` buckets of ``C`` slots and ``R`` lanes on
    a CUDA ``device``: the split S, the blocks, the threads a block and the
    shared memory a block (its candidate tile)."""
    smem = 27 * c * 3 * 4
    threads, s = _fwd_split(g, r, smem, _sm_count(torch.device(device)))
    return {"split": s, "blocks": g * s, "threads": threads, "smem_bytes": smem}


def _packed_smem(c: int, threads: int, forward: bool) -> int:
    """Shared memory of a K5f (``forward``) or K5b block of ``threads`` at C
    slots: its candidate tile rounded up to 16 bytes, and for K5f one buffer
    of 128 tile offsets a warp (16 bytes a thread)."""
    return -(-27 * c * 3 // 4) * 16 + (16 * threads if forward else 0)


def _packed_split(g: int, c: int, tiles: int, sms: int) -> tp.Tuple[int, int]:
    """``(threads, S)`` for K5f and K5b at ``G`` buckets of ``C`` slots
    that own ``tiles`` row tiles each (a span's tiles over its buckets):
    each bucket's tiles go to S blocks, independent in K5f and a cluster in
    K5b, the largest S in `CLUSTER_SPLITS` that `_one_wave` allows for K5f's
    larger block, and no more than the bucket has tiles.  On an H100 this
    gives S = 2 of 1,024 threads at the ANI-2dr water box's tables."""
    threads, most = _one_wave(g, _packed_smem(c, SPLIT_THREADS[0], True), sms)
    return threads, max(s for s in CLUSTER_SPLITS if s <= max(1, min(most, tiles)))


def packed_launch_shape(g: int, c: int, tiles: int, device: torch.device) -> tp.Dict[str, int]:
    """How K5f and K5b launch for ``G`` buckets of ``C`` slots that own
    ``tiles`` row tiles each on a CUDA ``device``: the split S, the blocks,
    the threads a block and each kernel's shared memory a block."""
    threads, s = _packed_split(g, c, tiles, _sm_count(torch.device(device)))
    return {
        "split": s, "blocks": g * s, "threads": threads,
        "fwd_smem_bytes": _packed_smem(c, threads, True),
        "bwd_smem_bytes": _packed_smem(c, threads, False),
    }


def _launch(name: str, src: Tensor, keys: Tensor, nlanes, dst: Tensor, *dims: int) -> None:
    """Launch ``{name}_launch`` on ``src``'s device and current stream with
    ``dims`` (G, C, R, the split S and the threads a block)."""
    lib = _library()
    fn = getattr(lib, f"{name}_launch")
    with torch.cuda.device(src.device):
        rc = fn(
            src.data_ptr(), keys.data_ptr(),
            None if nlanes is None else nlanes.data_ptr(), dst.data_ptr(),
            *dims, src.get_device(), torch.cuda.current_stream(src.device).cuda_stream,
        )
    if rc != 0:
        msg = lib.bucket_select_error_string(rc).decode()
        raise RuntimeError(f"{name}: kernel launch at {dims} failed: CUDA error {rc} ({msg})")


def bucket_select_fwd(
    cand: Tensor, keys: Tensor, nlanes: tp.Optional[Tensor] = None
) -> Tensor:
    """K1: ``out[g, r] = cand[g, key >> 8, key & 255]``, 0 for the sentinel
    section 27; ``cand (G, 27, C, 3)`` f32, ``keys (G, R)`` int32 ->
    ``(G, R, 3)`` f32, an exact selection.

    ``nlanes (G,)`` int32 bounds each bucket's occupied lanes: lanes at or
    past it must all be sentinels, and the kernel leaves them unwritten
    (callers read occupied slots' rows only).  The kernel splits each
    bucket's lanes over S blocks (`fwd_launch_shape`).  CPU tensors take
    `bucket_select_reference`; CUDA tensors launch the kernel or raise.
    ``bucket_select_fwd.launches`` counts launches.
    """
    if cand.device.type == "cpu":
        return bucket_select_reference(cand, keys, nlanes)
    if cand.device.type != "cuda":
        raise ValueError(f"bucket_select_fwd: unsupported device {cand.device}")
    if cand.dim() != 4 or cand.shape[1] != 27 or cand.shape[3] != 3:
        raise ValueError(f"bucket_select_fwd: cand {tuple(cand.shape)} must be (G, 27, C, 3)")
    g, _, c, _ = cand.shape
    _check_kernel_args("bucket_select_fwd", cand, keys, nlanes, g, c)
    r = keys.shape[1]
    out = torch.empty((g, r, 3), dtype=torch.float32, device=cand.device)
    if g == 0 or r == 0:
        return out
    shape = fwd_launch_shape(g, c, r, cand.device)
    _launch("bucket_select_fwd", cand, keys, nlanes, out, g, c, r, shape["split"],
            shape["threads"])
    bucket_select_fwd.launches += 1
    return out


bucket_select_fwd.launches = 0


def bucket_select_bwd(
    g_out: Tensor, keys: Tensor, c: int, nlanes: tp.Optional[Tensor] = None
) -> Tensor:
    """K2, the transpose of K1: ``d_cand[g, key >> 8, key & 255] +=
    g_out[g, r]`` over every lane whose section is below 27; ``g_out
    (G, R, 3)`` f32, ``keys (G, R)`` int32 -> ``(G, 27, C, 3)`` f32, zeros
    where no lane points.

    Lanes at or past ``nlanes[g]`` are not read.  The kernel splits each
    bucket's lanes over a cluster of S blocks (`bwd_launch_shape`), sums
    with atomics in each block's shared memory and adds the S tiles through
    distributed shared memory, so the order of a candidate's sum (at most
    one term per slot row of the bucket) changes from run to run.  CPU
    tensors take `bucket_select_bwd_reference`; CUDA tensors launch the
    kernel or raise.  ``bucket_select_bwd.launches`` counts launches.
    """
    if g_out.device.type == "cpu":
        return bucket_select_bwd_reference(g_out, keys, c, nlanes)
    if g_out.device.type != "cuda":
        raise ValueError(f"bucket_select_bwd: unsupported device {g_out.device}")
    if g_out.dim() != 3 or g_out.shape[2] != 3 or g_out.shape[:2] != keys.shape:
        raise ValueError(
            f"bucket_select_bwd: g_out {tuple(g_out.shape)} must be keys' "
            f"{tuple(keys.shape)} + (3,)"
        )
    g, r, _ = g_out.shape
    _check_kernel_args("bucket_select_bwd", g_out, keys, nlanes, g, c)
    d_cand = torch.empty((g, 27, c, 3), dtype=torch.float32, device=g_out.device)
    if g == 0:
        return d_cand
    shape = bwd_launch_shape(g, c, 3, g_out.device)
    _launch("bucket_select_bwd", g_out, keys, nlanes, d_cand, g, c, r, shape["split"],
            shape["threads"])
    bucket_select_bwd.launches += 1
    return d_cand


bucket_select_bwd.launches = 0


# ---------------------------------------------------------------------------
# K4f and K4b: the same selection for P channels of runtime per-atom values
# ---------------------------------------------------------------------------


def vals_select_reference(
    cand: Tensor, keys: Tensor, nlanes: tp.Optional[Tensor] = None
) -> Tensor:
    """Plain version of `vals_select_fwd`: `bucket_select_reference` at
    ``cand (G, 27, C, P)``."""
    return bucket_select_reference(cand, keys, nlanes)


def vals_select_bwd_reference(
    g_out: Tensor, keys: Tensor, c: int, nlanes: tp.Optional[Tensor] = None
) -> Tensor:
    """Plain version of `vals_select_bwd`: `bucket_select_bwd_reference` at
    ``g_out (G, R, P)``."""
    return bucket_select_bwd_reference(g_out, keys, c, nlanes)


def _vals_library() -> ctypes.CDLL:
    from torchani_tpu_torch.csrc import load_library

    lib = load_library("vals_select")
    if lib.vals_select_fwd_launch.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        # source, keys, nlanes (or null), destination; G, C, R, P (and for
        # K4b the cluster split S and the threads a block); device, stream
        lib.vals_select_fwd_launch.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, vp]
        lib.vals_select_bwd_launch.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, vp]
        for fn in (lib.vals_select_fwd_launch, lib.vals_select_bwd_launch):
            fn.restype = ci
        lib.vals_select_error_string.argtypes = [ci]
        lib.vals_select_error_string.restype = ctypes.c_char_p
    return lib


def _vals_launch(name: str, src: Tensor, keys: Tensor, nlanes, dst: Tensor, g, c, r, p,
                 *split: int) -> None:
    """Launch ``{name}_launch`` with G, C, R, P (and for K4b ``split``: the
    cluster split S and the threads a block); a candidate tile past a
    block's shared memory raises."""
    if 27 * c * p * 4 > MAX_SHARED_BYTES:
        raise ValueError(
            f"{name}: a bucket's candidate tile of 27 x {c} slots x {p} channels takes "
            f"{27 * c * p * 4} bytes of shared memory, over the {MAX_SHARED_BYTES} a block "
            f"may have; select fewer channels per call"
        )
    lib = _vals_library()
    fn = getattr(lib, f"{name}_launch")
    with torch.cuda.device(src.device):
        rc = fn(
            src.data_ptr(), keys.data_ptr(),
            None if nlanes is None else nlanes.data_ptr(), dst.data_ptr(),
            g, c, r, p, *split, src.get_device(),
            torch.cuda.current_stream(src.device).cuda_stream,
        )
    if rc != 0:
        msg = lib.vals_select_error_string(rc).decode()
        raise RuntimeError(
            f"{name}: kernel launch at {(g, c, r, p, *split)} failed: CUDA error {rc} ({msg})"
        )


def vals_select_fwd(
    cand: Tensor, keys: Tensor, nlanes: tp.Optional[Tensor] = None
) -> Tensor:
    """K4f: ``out[g, r] = cand[g, key >> 8, key & 255]``, 0 for the sentinel
    section 27; ``cand (G, 27, C, P)`` f32, ``keys (G, R)`` int32 ->
    ``(G, R, P)`` f32, an exact selection of P value channels.

    ``nlanes`` as in `bucket_select_fwd`: lanes at or past it are left
    unwritten.  CPU tensors take `vals_select_reference`; CUDA tensors launch
    the kernel or raise.  ``vals_select_fwd.launches`` counts launches.
    """
    if cand.device.type == "cpu":
        return vals_select_reference(cand, keys, nlanes)
    if cand.device.type != "cuda":
        raise ValueError(f"vals_select_fwd: unsupported device {cand.device}")
    if cand.dim() != 4 or cand.shape[1] != 27 or cand.shape[3] < 1:
        raise ValueError(f"vals_select_fwd: cand {tuple(cand.shape)} must be (G, 27, C, P)")
    g, _, c, p = cand.shape
    _check_kernel_args("vals_select_fwd", cand, keys, nlanes, g, c)
    r = keys.shape[1]
    out = torch.empty((g, r, p), dtype=torch.float32, device=cand.device)
    if g == 0 or r == 0:
        return out
    _vals_launch("vals_select_fwd", cand, keys, nlanes, out, g, c, r, p)
    vals_select_fwd.launches += 1
    return out


vals_select_fwd.launches = 0


def vals_select_bwd(
    g_out: Tensor, keys: Tensor, c: int, nlanes: tp.Optional[Tensor] = None
) -> Tensor:
    """K4b, the transpose of K4f: ``d_cand[g, key >> 8, key & 255] +=
    g_out[g, r]`` over every lane whose section is below 27; ``g_out
    (G, R, P)`` f32, ``keys (G, R)`` int32 -> ``(G, 27, C, P)`` f32, zeros
    where no lane points.

    Lanes at or past ``nlanes[g]`` are not read.  As in `bucket_select_bwd`,
    each bucket's lanes are split over a cluster of S blocks
    (`bwd_launch_shape`) whose shared-memory tiles are added through
    distributed shared memory; sums run in an order that changes from run
    to run.  CPU tensors take `vals_select_bwd_reference`; CUDA tensors
    launch the kernel or raise.  ``vals_select_bwd.launches`` counts
    launches.
    """
    if g_out.device.type == "cpu":
        return vals_select_bwd_reference(g_out, keys, c, nlanes)
    if g_out.device.type != "cuda":
        raise ValueError(f"vals_select_bwd: unsupported device {g_out.device}")
    if g_out.dim() != 3 or g_out.shape[2] < 1 or g_out.shape[:2] != keys.shape:
        raise ValueError(
            f"vals_select_bwd: g_out {tuple(g_out.shape)} must be keys' "
            f"{tuple(keys.shape)} + (P,)"
        )
    g, r, p = g_out.shape
    _check_kernel_args("vals_select_bwd", g_out, keys, nlanes, g, c)
    d_cand = torch.empty((g, 27, c, p), dtype=torch.float32, device=g_out.device)
    if g == 0:
        return d_cand
    shape = bwd_launch_shape(g, c, p, g_out.device)
    _vals_launch("vals_select_bwd", g_out, keys, nlanes, d_cand, g, c, r, p, shape["split"],
                 shape["threads"])
    vals_select_bwd.launches += 1
    return d_cand


vals_select_bwd.launches = 0


# ---------------------------------------------------------------------------
# the full refresh forward and backward around the kernels
# ---------------------------------------------------------------------------


def _statics(atom_of_slot: Tensor, keys: Tensor, wrapshift: Tensor):
    gx, gy, gz = wrapshift.shape[:3]
    g = gx * gy * gz
    c = atom_of_slot.shape[0] // g
    k = keys.shape[1] // c
    return (gx, gy, gz), g, c, k


@functools.lru_cache(maxsize=16)
def _section_rows(grid: tp.Tuple[int, int, int], device: torch.device) -> tp.Tuple[Tensor, Tensor]:
    """Static row indices of a grid's 27-neighborhoods, on ``device``.

    ``fwd (G * 27,)``: the bucket whose slot table is section ``o`` of bucket
    ``b``, ``wrap(b3 + off_o)``.  ``bwd (G * 27,)``: the row ``b' * 27 + o``
    of the ``(G * 27, ...)`` candidate table that holds bucket ``b`` as its
    section ``o``, ``b' = wrap(b3 - off_o)``: the transpose as a gather.
    """
    gx, gy, gz = grid
    gdims = np.array([gx, gy, gz])
    b3 = np.stack(
        np.meshgrid(np.arange(gx), np.arange(gy), np.arange(gz), indexing="ij"), axis=-1
    ).reshape(-1, 3)

    def flat(nb3: np.ndarray) -> np.ndarray:
        nb3 = np.mod(nb3, gdims)
        return (nb3[..., 0] * gy + nb3[..., 1]) * gz + nb3[..., 2]

    fwd = flat(b3[:, None, :] + _SECTION_OFFSETS[None])  # (G, 27)
    bwd = flat(b3[:, None, :] - _SECTION_OFFSETS[None]) * 27 + np.arange(27)[None, :]
    return (
        torch.as_tensor(fwd.reshape(-1), device=device),
        torch.as_tensor(bwd.reshape(-1), device=device),
    )


def _slot_sections(values: Tensor, atom_of_slot: Tensor, grid, c: int) -> Tensor:
    """(G, 27, C, P) candidate values of every bucket from per-atom ``values
    (A, P)``: section ``o`` of bucket ``b`` is the slot table of bucket
    ``wrap(b3 + off_o)`` (what 27 rolls of the ``(gx, gy, gz, C, P)`` slot
    table give).  Two row gathers: G*C atoms, then G*27 slot tables."""
    gx, gy, gz = grid
    g = gx * gy * gz
    a, p = values.shape
    vals_pad = torch.cat([values, values.new_zeros((1, p))])
    valsb = vals_pad.index_select(0, atom_of_slot.clamp(max=a)).reshape(g, c * p)
    cand = valsb.index_select(0, _section_rows(grid, values.device)[0])
    return cand.reshape(g, 27, c, p)


def _cand_table_transpose(d_cand: Tensor, grid, c: int) -> Tensor:
    """(G * C, P) cotangent of the slot table from the candidate table's
    ``(G, 27, C, P)``: each bucket sums the 27 sections that hold it."""
    g, p = d_cand.shape[0], d_cand.shape[3]
    rows = d_cand.reshape(g * 27, c * p).index_select(0, _section_rows(grid, d_cand.device)[1])
    return rows.reshape(g, 27, c * p).sum(dim=1).reshape(g * c, p)


def _cand_table(canon: Tensor, atom_of_slot: Tensor, wrapshift: Tensor, grid, c: int) -> Tensor:
    """(G, 27, C, 3) candidate positions of every bucket: the slot tables of
    its 27 surrounding buckets plus the constant section shift."""
    g = wrapshift.shape[0] * wrapshift.shape[1] * wrapshift.shape[2]
    return _slot_sections(canon, atom_of_slot, grid, c) + wrapshift.reshape(g, 27, 1, 3)


def _occupied_lanes(atom_of_slot: Tensor, a: int, g: int, c: int, k: int) -> Tensor:
    """(G,) int32 occupied-lane count per bucket: occupied slots are each
    bucket's prefix, so lanes >= count * K are all sentinels."""
    occ = (atom_of_slot < a).reshape(g, c).sum(dim=1)
    return (occ * k).to(torch.int32)


def _fwd_impl(canon, keys, atom_of_slot, slot_of_atom, wrapshift, nlanes):
    grid, g, c, k = _statics(atom_of_slot, keys, wrapshift)
    a = canon.shape[0]
    cand = _cand_table(canon, atom_of_slot, wrapshift, grid, c)
    out = bucket_select_fwd(cand, keys, nlanes)  # (G, C*K, 3)
    # r = c * K + k: the slot-row table is a view
    nbr_slot = out.reshape(g * c, k * 3)
    has_slot = slot_of_atom >= 0
    nbr = nbr_slot.index_select(0, slot_of_atom.clamp(min=0)).reshape(a, k, 3)
    return torch.where(has_slot[:, None, None], nbr, 0.0)


def _bwd_impl(g_out, keys, atom_of_slot, slot_of_atom, wrapshift, nlanes):
    grid, g, c, k = _statics(atom_of_slot, keys, wrapshift)
    a = g_out.shape[0]
    # atom-order cotangents -> slot-row layout (a G*C wide-row gather)
    g_pad = torch.cat([g_out.reshape(a, k * 3), g_out.new_zeros((1, k * 3))])
    g_rows = g_pad.index_select(0, atom_of_slot.clamp(max=a)).reshape(g, c * k, 3)
    d_cand = bucket_select_bwd(g_rows, keys, c, nlanes)  # (G, 27, C, 3)
    d_pad = torch.cat([_cand_table_transpose(d_cand, grid, c), g_out.new_zeros((1, 3))])
    return d_pad.index_select(0, torch.where(slot_of_atom >= 0, slot_of_atom, g * c))


class _BucketNbrPos(torch.autograd.Function):
    @staticmethod
    def forward(ctx, canon, keys, atom_of_slot, slot_of_atom, wrapshift):
        _, g, c, k = _statics(atom_of_slot, keys, wrapshift)
        nlanes = _occupied_lanes(atom_of_slot, canon.shape[0], g, c, k)
        ctx.save_for_backward(keys, atom_of_slot, slot_of_atom, wrapshift, nlanes)
        return _fwd_impl(canon, keys, atom_of_slot, slot_of_atom, wrapshift, nlanes)

    @staticmethod
    @once_differentiable
    def backward(ctx, g_out):
        d_canon = _bwd_impl(g_out.contiguous(), *ctx.saved_tensors)
        return d_canon, None, None, None, None


def bucket_nbr_pos(
    canon: Tensor,  # (A, 3) canonical coordinates (see the module docstring)
    keys: Tensor,  # (G, C*K) int32
    atom_of_slot: Tensor,  # (G*C,) int64
    slot_of_atom: Tensor,  # (A,) int64
    wrapshift: Tensor,  # (gx, gy, gz, 27, 3)
) -> Tensor:
    """Per-lane neighbor positions ``canon[j] + image_shift`` ``(A, K, 3)``,
    an exact selection; the forward launches K1 and the backward K2 (no
    per-atom scatter).  Masked lanes and atoms without a slot give 0."""
    return _BucketNbrPos.apply(canon, keys, atom_of_slot, slot_of_atom, wrapshift)


# ---------------------------------------------------------------------------
# per-lane selection of runtime per-atom values around K4f and K4b
# ---------------------------------------------------------------------------


def _vals_fwd_impl(values, keys, atom_of_slot, slot_of_atom, wrapshift, nlanes):
    grid, g, c, k = _statics(atom_of_slot, keys, wrapshift)
    a, p = values.shape
    cand = _slot_sections(values, atom_of_slot, grid, c)  # (G, 27, C, P)
    out = vals_select_fwd(cand, keys, nlanes)  # (G, C*K, P)
    # r = c * K + k: the slot-row table is a view
    per_slot = out.reshape(g * c, k * p)
    lane = per_slot.index_select(0, slot_of_atom.clamp(min=0)).reshape(a, k, p)
    return torch.where((slot_of_atom >= 0)[:, None, None], lane, 0.0)


def _vals_bwd_impl(g_out, keys, atom_of_slot, slot_of_atom, wrapshift, nlanes):
    grid, g, c, k = _statics(atom_of_slot, keys, wrapshift)
    a, _, p = g_out.shape
    g_pad = torch.cat([g_out.reshape(a, k * p), g_out.new_zeros((1, k * p))])
    g_rows = g_pad.index_select(0, atom_of_slot.clamp(max=a)).reshape(g, c * k, p)
    d_cand = vals_select_bwd(g_rows, keys, c, nlanes)  # (G, 27, C, P)
    d_pad = torch.cat([_cand_table_transpose(d_cand, grid, c), g_out.new_zeros((1, p))])
    return d_pad.index_select(0, torch.where(slot_of_atom >= 0, slot_of_atom, g * c))


class _BucketLaneValues(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, keys, atom_of_slot, slot_of_atom, wrapshift):
        _, g, c, k = _statics(atom_of_slot, keys, wrapshift)
        nlanes = _occupied_lanes(atom_of_slot, values.shape[0], g, c, k)
        ctx.save_for_backward(keys, atom_of_slot, slot_of_atom, wrapshift, nlanes)
        return _vals_fwd_impl(values, keys, atom_of_slot, slot_of_atom, wrapshift, nlanes)

    @staticmethod
    @once_differentiable
    def backward(ctx, g_out):
        d_values = _vals_bwd_impl(g_out.contiguous(), *ctx.saved_tensors)
        return d_values, None, None, None, None


def bucket_lane_values(
    values: Tensor,  # (A, P) runtime per-atom values
    keys: Tensor,  # (G, C*K) int32
    atom_of_slot: Tensor,  # (G*C,) int64
    slot_of_atom: Tensor,  # (A,) int64
    wrapshift: Tensor,  # (gx, gy, gz, 27, 3): read for the grid's shape only
) -> Tensor:
    """Exact per-lane selection of runtime per-atom values: ``(A, P)`` ->
    ``(A, K, P)`` with ``out[i, k] = values[idx[i, k]]``; the forward launches
    K4f and the backward K4b (no per-atom scatter).  Masked lanes and atoms
    without a slot give 0."""
    return _BucketLaneValues.apply(values, keys, atom_of_slot, slot_of_atom, wrapshift)


def select_lane_values(values: Tensor, neighbors) -> Tensor:
    """``values[neighbors.idx]`` for runtime per-atom values: through
    `bucket_lane_values` where the table carries bucket tables
    (``Neighbors.select_tables``, attached by `MolecularDynamics`), a plain
    ``index_select`` otherwise.

    ``values``: ``(A,)`` or ``(A, P)``.  Returns ``(A, K)`` or ``(A, K, P)``.
    """
    tables = neighbors.select_tables
    if tables is None:
        idx = neighbors.idx
        out = values.index_select(0, idx.reshape(-1))
        return out.reshape(tuple(idx.shape) + tuple(values.shape[1:]))
    squeeze = values.dim() == 1
    v = values[:, None] if squeeze else values
    out = bucket_lane_values(
        v.contiguous(), tables.keys, tables.atom_of_slot, tables.slot_of_atom, tables.wrapshift
    )
    return out[..., 0] if squeeze else out
