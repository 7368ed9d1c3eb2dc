"""The atom-packed bucket refresh: `bucket_refresh`'s selection without slot
padding (counterpart of ``torchani_tpu/bucket_refresh_packed.py``).

Same selection as `torchani_tpu_torch.bucket_refresh` (each lane's partner
position from its bucket's candidate table, its transpose in the backward),
but the rows are ATOMS sorted by bucket instead of ``(bucket, slot)`` grid
cells, so empty slots cost no rows.

Layout (that of the JAX package, so that a state carries across):

- Atoms ordered by (bucket, rank); each bucket's run padded to a multiple of
  8 rows (a tile of 8 rows never straddles buckets), lanes padded ``K -> KL``
  (next multiple of 128).
- Buckets grouped into *spans* of ``SB`` consecutive buckets with a static
  row capacity ``S_cap`` per span (measured at MD init like the other
  capacities; overflow is flagged).
- ``tile_bucket`` names each tile's bucket within its span.

The kernels are K5f (`packed_select_fwd`) and K5b (`packed_select_bwd`) in
``csrc/packed_select.cu``: each bucket's tiles are split over S blocks
(`packed_launch_shape`; a thread-block cluster in K5b, whose blocks add
their sums through distributed shared memory), a warp taking 128 lanes at a
time.  The 8-row tiles and the span budget of `choose_span` are layout
parameters kept for the shared state format; the kernels take any KL that
is a multiple of 16 (the layout pads to 128).
"""

import ctypes
import dataclasses
import typing as tp

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from torchani_tpu_torch.annotations import Tensor
from torchani_tpu_torch.bucket_refresh import (
    _SENTINEL,
    MAX_SHARED_BYTES,
    BucketTables,
    _cand_table,
    _cand_table_transpose,
    _check_slots,
    packed_launch_shape,
)

__all__ = [
    "PackedTables",
    "choose_span",
    "pack_tables",
    "packed_nbr_pos",
    "packed_select_fwd",
    "packed_select_bwd",
    "packed_select_reference",
    "packed_select_bwd_reference",
]


@dataclasses.dataclass(frozen=True)
class PackedTables:
    """Rebuild-time tables of the atom-packed refresh.

    Every static parameter follows from the shapes: ``n_spans`` and
    ``S_cap * KL`` from ``keys_flat``, ``n_tiles`` (so ``S_cap = 8 *
    n_tiles``, and ``KL``) from ``tile_bucket``, the grid from ``wrapshift``,
    ``C`` from ``atom_of_slot`` against the grid, ``SB = G / n_spans``.
    """

    keys_flat: Tensor  # (n_spans, 1, S_cap*KL) int32, row-major (row, lane)
    tile_bucket: Tensor  # (n_spans, S_cap//8) int32 bucket of each tile within its span
    atom_of_row: Tensor  # (n_spans*S_cap,) int64, sentinel = A
    row_of_atom: Tensor  # (A,) int64, -1 invalid
    atom_of_slot: Tensor  # (G*C,) int64 (builds the candidate table), sentinel = A
    slot_of_atom: Tensor  # (A,) int64, -1 invalid (where the backward lands)
    wrap_offset: Tensor  # (A, 3) f32, frozen: canon = coords - wrap_offset
    wrapshift: Tensor  # (gx, gy, gz, 27, 3) f32


def choose_span(
    grid_shape: tp.Tuple[int, int, int],
    bucket_counts,  # (G,) host per-bucket occupancy (e.g. np.bincount)
    c: int,
    kl: int = 128,  # padded lane count (next multiple of 128 of K)
    budget: int = 10 * 2**20,
) -> tp.Tuple[int, int]:
    """The static ``(sb, s_cap)`` of the layout, chosen on the host at MD
    init by the JAX package's rule, so that both packages lay a system out
    the same way.

    ``sb`` (buckets per span) must divide G, and a span's blocks (the
    candidate planes of its buckets and the lane-wide tables that scale with
    ``s_cap * kl``) must fit ``budget`` bytes twice over.  Among the fits,
    the span with the fewest rows ``n_spans * s_cap`` wins, ties going to the
    larger span.  ``s_cap`` covers the measured 8-padded occupancy of the
    fullest span with the ~8% + constant margin of the other capacities.
    ``budget`` is a parameter of the layout (the JAX package sizes it to its
    device's on-chip memory); nothing on this card depends on it.
    """
    g = int(np.prod(grid_shape))
    counts = np.asarray(bucket_counts, np.int64)
    if counts.shape != (g,):
        raise ValueError(f"bucket_counts must be shape ({g},)")
    padded = ((counts + 7) // 8) * 8
    best = None
    for sb in range(1, g + 1):
        if g % sb:
            continue
        spans = padded.reshape(g // sb, sb).sum(axis=1)
        need = int(spans.max())
        s_cap = max(8, -(-int(need * 1.08 + 8) // 8) * 8)
        lanes = s_cap * kl
        fwd_bytes = lanes * 4 + sb * 288 * c * 2 + 8 * lanes * 4
        bwd_bytes = 16 * lanes * 2 + lanes * 4 + sb * 96 * c * 4
        if 2 * max(fwd_bytes, bwd_bytes) > budget:
            continue
        cost = (g // sb) * s_cap
        if best is None or cost < best[0] or (cost == best[0] and sb > best[1]):
            best = (cost, sb, s_cap)
    if best is None:
        raise ValueError(f"no span size sb fits the budget at c={c}")
    return best[1], best[2]


@torch.no_grad()
def pack_tables(tables: BucketTables, sb: int, s_cap: int) -> tp.Tuple[PackedTables, Tensor]:
    """Repack slot-row `BucketTables` into the atom-packed layout (at each
    Verlet rebuild).  Returns ``(packed, overflow)``; overflow means that
    some span's 8-padded occupancy exceeded ``s_cap``."""
    gx, gy, gz = tables.wrapshift.shape[:3]
    g = gx * gy * gz
    c = tables.atom_of_slot.shape[0] // g
    k = tables.keys.shape[1] // c
    a = tables.slot_of_atom.shape[0]
    dev = tables.keys.device
    kl = -(-k // 128) * 128
    if g % sb or s_cap % 8:
        raise ValueError(f"sb={sb} must divide G={g}; s_cap={s_cap} % 8 == 0")
    ns = g // sb
    n_rows = ns * s_cap

    occ = (tables.atom_of_slot < a).reshape(g, c).sum(dim=1)
    padded = ((occ + 7) // 8) * 8
    padded_sp = padded.reshape(ns, sb)
    csum = torch.cumsum(padded_sp, dim=1) - padded_sp  # exclusive
    overflow = torch.any(csum[:, -1] + padded_sp[:, -1] > s_cap)
    row_base = (torch.arange(ns, device=dev)[:, None] * s_cap + csum).reshape(g)

    slot = tables.slot_of_atom  # (A,) bucket * c + rank, -1 invalid
    has_slot = slot >= 0
    slot_safe = slot.clamp(min=0)
    bucket_of_atom = torch.div(slot_safe, c, rounding_mode="floor")
    row_of_atom = torch.where(
        has_slot, row_base.index_select(0, bucket_of_atom) + slot_safe % c, -1
    )
    # Under overflow a span's rows can run past s_cap INTO THE NEXT SPAN's
    # valid row range, where they would collide with that span's atoms in
    # the atom_of_row scatter and corrupt a span that did not overflow.
    # Reject any row outside its own span (the flag is set either way).
    span_of_atom = torch.where(has_slot, torch.div(bucket_of_atom, sb, rounding_mode="floor"), -1)
    row_ok = (
        (row_of_atom >= 0)
        & (row_of_atom < n_rows)
        & (torch.div(row_of_atom, s_cap, rounding_mode="floor") == span_of_atom)
    )
    atom_of_row = torch.full((n_rows + 1,), a, dtype=torch.int64, device=dev)
    atom_of_row.scatter_(
        0,
        torch.where(row_ok, row_of_atom, n_rows),
        torch.where(row_ok, torch.arange(a, device=dev), a),
    )
    atom_of_row = atom_of_row[:n_rows]
    row_of_atom = torch.where(row_ok, row_of_atom, -1)

    # per-row lane keys: one wide-row gather from the slot-row layout
    slot_pad = torch.cat([slot, slot.new_full((1,), -1)])
    slot_of_row = slot_pad.index_select(0, atom_of_row.clamp(max=a))
    keys_slot = tables.keys.reshape(g * c, k)
    keys_row = torch.where(
        (slot_of_row >= 0)[:, None],
        keys_slot.index_select(0, slot_of_row.clamp(min=0)),
        _SENTINEL,
    )
    keys_row = torch.nn.functional.pad(keys_row, (0, kl - k), value=_SENTINEL)
    keys_flat = keys_row.to(torch.int32).reshape(ns, 1, s_cap * kl).contiguous()

    # tile -> bucket within the span: each non-empty bucket's id at the start
    # of its run, then a running maximum along the span (runs are 8-aligned,
    # so a tile never straddles buckets; pad tiles carry the previous id and
    # hold sentinels only)
    local_id = torch.arange(sb, device=dev).repeat(ns)
    pos = torch.where(padded > 0, row_base, n_rows)
    marks = torch.zeros((n_rows + 1,), dtype=torch.int64, device=dev)
    marks.scatter_reduce_(0, pos, local_id, reduce="amax", include_self=True)
    bucket_of_row = torch.cummax(marks[:n_rows].reshape(ns, s_cap), dim=1).values
    tile_bucket = bucket_of_row[:, ::8].to(torch.int32).contiguous()

    packed = PackedTables(
        keys_flat=keys_flat,
        tile_bucket=tile_bucket,
        atom_of_row=atom_of_row,
        row_of_atom=row_of_atom,
        atom_of_slot=tables.atom_of_slot,
        slot_of_atom=tables.slot_of_atom,
        wrap_offset=tables.wrap_offset,
        wrapshift=tables.wrapshift,
    )
    return packed, overflow


# ---------------------------------------------------------------------------
# K5f and K5b: the selection over atom rows and its transpose
# ---------------------------------------------------------------------------


def _statics(pt: PackedTables):
    gx, gy, gz = pt.wrapshift.shape[:3]
    g = gx * gy * gz
    c = pt.atom_of_slot.shape[0] // g
    ns, n_tiles = pt.tile_bucket.shape
    s_cap = 8 * n_tiles
    kl = pt.keys_flat.shape[2] // s_cap
    return (gx, gy, gz), g, c, ns, s_cap, kl


def _flat_rows_index(keys_flat: Tensor, tile_bucket: Tensor, g: int, c: int) -> Tensor:
    """(n_spans, S_cap * KL) position of each lane's candidate in the flat
    ``(G * 27 * C,)`` candidate table; ``G * 27 * C`` for sentinels."""
    ns, n_tiles = tile_bucket.shape
    sb = g // ns
    lanes = keys_flat.shape[-1]
    kl = lanes // (8 * n_tiles)
    keys = keys_flat.reshape(ns, lanes).to(torch.int64)
    sec, rank = keys >> 8, keys & 255
    bucket = tile_bucket.to(torch.int64) + torch.arange(ns, device=keys.device)[:, None] * sb
    bucket = bucket.repeat_interleave(8 * kl, dim=1)  # (ns, lanes)
    ok = (sec >= 0) & (sec < 27) & (rank < c)
    return torch.where(ok, bucket * (27 * c) + sec * c + rank, g * 27 * c)


def packed_select_reference(cand: Tensor, keys_flat: Tensor, tile_bucket: Tensor) -> Tensor:
    """Plain version of `packed_select_fwd`: a gather from the flat candidate
    table, padded with a zero row for the sentinel."""
    g, _, c, _ = cand.shape
    ns = tile_bucket.shape[0]
    flat = torch.cat([cand.reshape(g * 27 * c, 3), cand.new_zeros((1, 3))])
    index = _flat_rows_index(keys_flat, tile_bucket, g, c)
    return flat.index_select(0, index.reshape(-1)).reshape(ns, -1, 3)


def packed_select_bwd_reference(
    g_out: Tensor, keys_flat: Tensor, tile_bucket: Tensor, c: int, g: int
) -> Tensor:
    """Plain version of `packed_select_bwd`: an ``index_add_`` onto the flat
    candidate table; the sentinel row is cut away."""
    index = _flat_rows_index(keys_flat, tile_bucket, g, c)
    d_flat = g_out.new_zeros((g * 27 * c + 1, 3))
    d_flat.index_add_(0, index.reshape(-1), g_out.reshape(-1, 3))
    return d_flat[: g * 27 * c].reshape(g, 27, c, 3)


def _library() -> ctypes.CDLL:
    from torchani_tpu_torch.csrc import load_library

    lib = load_library("packed_select")
    if lib.packed_select_fwd_launch.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.packed_select_fwd_launch, lib.packed_select_bwd_launch):
            # source, keys, tile_bucket, destination; n_spans, SB, C, n_tiles, KL,
            # the split S and the threads a block; device, stream
            fn.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci, vp]
            fn.restype = ci
        lib.packed_select_error_string.argtypes = [ci]
        lib.packed_select_error_string.restype = ctypes.c_char_p
    return lib


def _check_kernel_args(
    name: str, values: Tensor, keys_flat: Tensor, tile_bucket: Tensor, g: int, c: int
) -> tp.Tuple[int, int, int, int]:
    """Validate the kernel's tables; returns ``(n_spans, sb, n_tiles, kl)``."""
    _check_slots(c)
    if 27 * c * 12 > MAX_SHARED_BYTES:
        raise ValueError(f"{name}: the candidate tile of c={c} slots does not fit shared memory")
    if values.dtype != torch.float32:
        raise TypeError(f"{name}: values must be float32, not {values.dtype}")
    for what, t in (("keys_flat", keys_flat), ("tile_bucket", tile_bucket)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: {what} must be int32, not {t.dtype}")
    if tile_bucket.dim() != 2 or keys_flat.dim() != 3 or keys_flat.shape[:2] != (
        tile_bucket.shape[0], 1
    ):
        raise ValueError(
            f"{name}: keys_flat {tuple(keys_flat.shape)} must be (n_spans, 1, S_cap*KL) and "
            f"tile_bucket {tuple(tile_bucket.shape)} (n_spans, S_cap/8)"
        )
    ns, n_tiles = tile_bucket.shape
    lanes = keys_flat.shape[2]
    if ns == 0 or n_tiles == 0 or g % ns or lanes % (8 * n_tiles) or lanes == 0:
        raise ValueError(
            f"{name}: {ns} spans must divide G={g} and {n_tiles} tiles of 8 rows must "
            f"divide the {lanes} lanes of a span"
        )
    if lanes // (8 * n_tiles) % 16:
        raise ValueError(
            f"{name}: KL={lanes // (8 * n_tiles)} lanes a row must be a multiple of 16 (a "
            f"tile's lanes are whole chunks of 128)"
        )
    for what, t in (("values", values), ("keys_flat", keys_flat), ("tile_bucket", tile_bucket)):
        if t.device != values.device:
            raise ValueError(f"{name}: {what} is on {t.device}, not {values.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    return ns, g // ns, n_tiles, lanes // (8 * n_tiles)


def _launch(name, src, keys_flat, tile_bucket, dst, *dims: int) -> None:
    """Launch ``{name}_launch`` on ``src``'s device and current stream with
    ``dims`` (n_spans, SB, C, n_tiles, KL, the split S and the threads a
    block)."""
    lib = _library()
    fn = getattr(lib, f"{name}_launch")
    with torch.cuda.device(src.device):
        rc = fn(
            src.data_ptr(), keys_flat.data_ptr(), tile_bucket.data_ptr(), dst.data_ptr(),
            *dims, src.get_device(), torch.cuda.current_stream(src.device).cuda_stream,
        )
    if rc != 0:
        msg = lib.packed_select_error_string(rc).decode()
        raise RuntimeError(f"{name}: kernel launch at {dims} failed: CUDA error {rc} ({msg})")


def _shape(g: int, c: int, ns: int, n_tiles: int, device: torch.device) -> tp.Tuple[int, int]:
    """``(S, threads)`` of both kernels: `packed_launch_shape` at a span's
    tiles over its buckets."""
    shape = packed_launch_shape(g, c, max(1, n_tiles * ns // g), device)
    return shape["split"], shape["threads"]


def packed_select_fwd(cand: Tensor, keys_flat: Tensor, tile_bucket: Tensor) -> Tensor:
    """K5f: ``out[span, row * KL + lane] = cand[b, key >> 8, key & 255]`` with
    ``b = span * SB + tile_bucket[span, row // 8]``, 0 for the sentinel
    section 27; ``cand (G, 27, C, 3)`` f32, ``keys_flat (n_spans, 1, S_cap *
    KL)`` int32, ``tile_bucket (n_spans, S_cap / 8)`` int32 with values in
    ``[0, SB)`` -> ``(n_spans, S_cap * KL, 3)`` f32, an exact selection.

    The kernel splits each bucket's tiles over S blocks
    (`packed_launch_shape`).  CPU tensors take `packed_select_reference`;
    CUDA tensors launch the kernel or raise.  ``packed_select_fwd.launches``
    counts launches.
    """
    if cand.device.type == "cpu":
        return packed_select_reference(cand, keys_flat, tile_bucket)
    if cand.device.type != "cuda":
        raise ValueError(f"packed_select_fwd: unsupported device {cand.device}")
    if cand.dim() != 4 or cand.shape[1] != 27 or cand.shape[3] != 3:
        raise ValueError(f"packed_select_fwd: cand {tuple(cand.shape)} must be (G, 27, C, 3)")
    g, _, c, _ = cand.shape
    ns, sb, n_tiles, kl = _check_kernel_args(
        "packed_select_fwd", cand, keys_flat, tile_bucket, g, c
    )
    out = torch.empty((ns, keys_flat.shape[2], 3), dtype=torch.float32, device=cand.device)
    _launch("packed_select_fwd", cand, keys_flat, tile_bucket, out, ns, sb, c, n_tiles, kl,
            *_shape(g, c, ns, n_tiles, cand.device))
    packed_select_fwd.launches += 1
    return out


packed_select_fwd.launches = 0


def packed_select_bwd(
    g_out: Tensor, keys_flat: Tensor, tile_bucket: Tensor, c: int, g: int
) -> Tensor:
    """K5b, the transpose of K5f: every lane whose section is below 27 adds
    its ``g_out (n_spans, S_cap * KL, 3)`` row onto its candidate; ->
    ``(G, 27, C, 3)`` f32, zeros where no lane points.

    Each bucket's tiles are split over a cluster of S blocks
    (`packed_launch_shape`), each summing with atomics in its shared memory,
    and the S sums are added through distributed shared memory, so the order
    of a candidate's sum changes from run to run.  The cotangents of four
    consecutive sentinel lanes (a thread's share) are not read.  CPU tensors
    take `packed_select_bwd_reference`; CUDA tensors launch the kernel or
    raise.  ``packed_select_bwd.launches`` counts launches.
    """
    if g_out.device.type == "cpu":
        return packed_select_bwd_reference(g_out, keys_flat, tile_bucket, c, g)
    if g_out.device.type != "cuda":
        raise ValueError(f"packed_select_bwd: unsupported device {g_out.device}")
    if g_out.dim() != 3 or g_out.shape[2] != 3 or g_out.shape[:2] != (
        keys_flat.shape[0], keys_flat.shape[-1]
    ):
        raise ValueError(
            f"packed_select_bwd: g_out {tuple(g_out.shape)} must be (n_spans, S_cap*KL, 3) "
            f"for keys_flat {tuple(keys_flat.shape)}"
        )
    ns, sb, n_tiles, kl = _check_kernel_args(
        "packed_select_bwd", g_out, keys_flat, tile_bucket, g, c
    )
    d_cand = torch.empty((g, 27, c, 3), dtype=torch.float32, device=g_out.device)
    _launch("packed_select_bwd", g_out, keys_flat, tile_bucket, d_cand, ns, sb, c, n_tiles, kl,
            *_shape(g, c, ns, n_tiles, g_out.device))
    packed_select_bwd.launches += 1
    return d_cand


packed_select_bwd.launches = 0


# ---------------------------------------------------------------------------
# the full refresh forward and backward around the kernels
# ---------------------------------------------------------------------------


def _fwd_impl(canon: Tensor, pt: PackedTables) -> Tensor:
    grid, g, c, ns, s_cap, kl = _statics(pt)
    a = canon.shape[0]
    cand = _cand_table(canon, pt.atom_of_slot, pt.wrapshift, grid, c)
    out = packed_select_fwd(cand, pt.keys_flat, pt.tile_bucket)  # (ns, s_cap*kl, 3)
    rows = out.reshape(ns * s_cap, kl * 3)
    nbr = rows.index_select(0, pt.row_of_atom.clamp(min=0)).reshape(a, kl, 3)
    return torch.where((pt.row_of_atom >= 0)[:, None, None], nbr, 0.0)


def _bwd_impl(g_out: Tensor, pt: PackedTables) -> Tensor:
    grid, g, c, ns, s_cap, kl = _statics(pt)
    a = g_out.shape[0]
    # atom-order cotangents -> packed row layout (a wide-row gather)
    g_pad = torch.cat([g_out.reshape(a, kl * 3), g_out.new_zeros((1, kl * 3))])
    g_rows = g_pad.index_select(0, pt.atom_of_row.clamp(max=a)).reshape(ns, s_cap * kl, 3)
    d_cand = packed_select_bwd(g_rows, pt.keys_flat, pt.tile_bucket, c, g)
    # the tail of bucket_refresh._bwd_impl: fold the 27 sections back onto
    # the slot table, then slot -> atom rows
    d_pad = torch.cat([_cand_table_transpose(d_cand, grid, c), g_out.new_zeros((1, 3))])
    return d_pad.index_select(0, torch.where(pt.slot_of_atom >= 0, pt.slot_of_atom, g * c))


class _PackedNbrPos(torch.autograd.Function):
    @staticmethod
    def forward(ctx, canon, pt):
        ctx.pt = pt
        return _fwd_impl(canon, pt)

    @staticmethod
    @once_differentiable
    def backward(ctx, g_out):
        return _bwd_impl(g_out.contiguous(), ctx.pt), None


def packed_nbr_pos(canon: Tensor, pt: PackedTables) -> Tensor:
    """Per-lane neighbor positions ``canon[j] + image_shift`` over the
    atom-packed layout, an exact selection; returns ``(A, KL, 3)`` (callers
    slice lanes ``[:, :K]``).  The forward launches K5f and the backward K5b.
    ``canon`` must be canonical coordinates (see `bucket_refresh`); masked and
    pad lanes and atoms without a row give 0."""
    return _PackedNbrPos.apply(canon, pt)
