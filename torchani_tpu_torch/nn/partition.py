"""Species-blocked network evaluation (counterpart of
``torchani_tpu/nn/partition.py``).

Given a per-species row budget ``caps``, the atom rows are permuted into
species-contiguous blocks of ``caps[s]`` rows, each species' MLP runs at its
true widths over its own block, and the per-atom outputs are permuted back.
The permutation is derived on the device (one sort of the atom axis, a
cumulative sum and gathers), and the rows move through
`torchani_tpu_torch.utils.perm_gather`, whose backward is the inverse
gather: nothing waits for the device, where the default evaluation reads the
present species and each species' rows back to the host.  Padding atoms
(-1) sort past every block and are never evaluated.  A species with more
atoms than its cap would lose rows: the result is poisoned with NaN instead,
as every capacity overflow of the package is.
"""

import functools
import typing as tp

import numpy as np
import torch

from torchani_tpu_torch.annotations import Tensor
from torchani_tpu_torch.utils import cumsum_from_zero, perm_gather

__all__ = [
    "SpeciesBlocks",
    "supports",
    "species_blocks",
    "species_blocks_static",
    "block_rows",
    "unblock_rows",
    "measure_caps",
]

#: sort keys ``elem * N + i`` are int64 here (the JAX package's are f32,
#: exact below 2^24)
_MAX_EXACT = 1 << 62


def supports(num_species: int, num_rows: int) -> bool:
    """Whether `species_blocks` takes this shape: its sort keys stay
    exact."""
    return (num_species + 1) * num_rows < _MAX_EXACT


class SpeciesBlocks(tp.NamedTuple):
    inv: Tensor  # (P,) source row of each block slot; N = a zero row
    pos: Tensor  # (N,) block slot of each source row; P = dropped
    ok: Tensor  # () bool, False if a species overflowed its cap
    caps: tp.Tuple[int, ...]

    @property
    def offsets(self) -> tp.Tuple[int, ...]:
        return tuple(int(x) for x in np.cumsum((0,) + self.caps[:-1]))


@functools.lru_cache(maxsize=32)
def _slot_tables(
    caps: tp.Tuple[int, ...], device: torch.device
) -> tp.Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Static tables of a cap tuple, on ``device``: the species and the rank
    of each slot, the caps with a 0 for padding appended, and each
    species' first slot with the dropped sentinel ``P`` appended.  Cached:
    an upload on every call would wait for the device's queue."""
    species_of_slot = np.concatenate([np.full((c,), i, np.int64) for i, c in enumerate(caps)])
    rank_of_slot = np.concatenate([np.arange(c, dtype=np.int64) for c in caps])
    caps_ext = np.asarray(caps + (0,), np.int64)
    off = np.concatenate([[0], np.cumsum(caps)]).astype(np.int64)
    return tuple(
        torch.as_tensor(x, device=device)
        for x in (species_of_slot, rank_of_slot, caps_ext, off)
    )


def species_blocks(elem: Tensor, caps: tp.Sequence[int]) -> SpeciesBlocks:
    """The block permutation of an element array ``(N,)`` (-1 padding) for
    the per-species row budgets ``caps`` (one per species), computed on the
    element array's device without reading it back."""
    caps = tuple(int(c) for c in caps)
    n = elem.shape[0]
    s = len(caps)
    if not supports(s, n):
        raise ValueError(f"species_blocks: {s} species x {n} rows exceeds the exact sort-key range")
    dev = elem.device
    sos, ros, caps_ext, off = _slot_tables(caps, dev)
    key = torch.where(elem >= 0, elem, s).to(torch.int64)  # padding sorts last
    iota = torch.arange(n, device=dev)
    order = torch.sort(key * n + iota).indices  # unique keys: the species-sorted rows
    onehot = torch.nn.functional.one_hot(key, s + 1)[:, :s]  # (N, S); padding 0
    counts = onehot.sum(dim=0)
    ok = torch.all(counts <= caps_ext[:s])
    valid_slot = ros < counts[sos]
    src_in_order = torch.clamp(cumsum_from_zero(counts)[sos] + ros, max=max(n - 1, 0))
    inv = torch.where(valid_slot, order[src_in_order], n)
    rank = torch.sum((torch.cumsum(onehot, dim=0) - onehot) * onehot, dim=1)
    p = int(sum(caps))
    real = (elem >= 0) & (rank < caps_ext[key])
    pos = torch.where(real, off[key] + rank, p)
    return SpeciesBlocks(inv=inv, pos=pos, ok=ok, caps=caps)


def species_blocks_static(elem: np.ndarray, quantum: int = 8, device=None) -> SpeciesBlocks:
    """`species_blocks` of an element array known on the host: the caps are
    the exact per-species counts (rounded up to ``quantum`` rows), so no
    species overflows.  The tables go to ``device`` (the CPU by default)."""
    elem = np.asarray(elem).reshape(-1)
    n = elem.shape[0]
    smax = int(elem.max(initial=-1))
    counts = [int((elem == s).sum()) for s in range(smax + 1)]
    caps = tuple(max(-(-c // quantum) * quantum, quantum) for c in counts)
    p = int(sum(caps))
    inv = np.full((p,), n, np.int64)
    pos = np.full((n,), p, np.int64)
    off = 0
    for s, cap in enumerate(caps):
        rows = np.flatnonzero(elem == s)
        inv[off:off + rows.size] = rows
        pos[rows] = off + np.arange(rows.size)
        off += cap
    return SpeciesBlocks(
        inv=torch.as_tensor(inv, device=device),
        pos=torch.as_tensor(pos, device=device),
        ok=torch.ones((), dtype=torch.bool, device=device),
        caps=caps,
    )


def block_rows(x: Tensor, blocks: SpeciesBlocks) -> Tensor:
    """Rows ``(N, ...)`` -> species-blocked rows ``(P, ...)`` (empty slots
    0)."""
    return perm_gather(x, blocks.inv, blocks.pos)


def unblock_rows(y: Tensor, blocks: SpeciesBlocks) -> Tensor:
    """Species-blocked rows ``(P, ...)`` back to source order ``(N, ...)``;
    padding and overflowed rows get 0."""
    return perm_gather(y, blocks.pos, blocks.inv)


def measure_caps(
    species_batches: tp.Iterable[np.ndarray],
    num_species: int,
    margin: float = 1.2,
    quantum: int = 256,
    max_batches: int = 16,
) -> tp.Tuple[int, ...]:
    """Per-species row budgets from sample element arrays (host): the
    largest count of each species over the first ``max_batches`` batches,
    times ``margin``, rounded up to ``quantum``."""
    maxc = np.zeros((num_species,), np.int64)
    for bi, sp in enumerate(species_batches):
        if bi >= max_batches:
            break
        if isinstance(sp, torch.Tensor):
            sp = sp.detach().cpu().numpy()
        sp = np.asarray(sp).reshape(-1)
        for s in range(num_species):
            maxc[s] = max(maxc[s], int((sp == s).sum()))
    return tuple(int(-(-max(int(c * margin), 1) // quantum) * quantum) for c in maxc)
