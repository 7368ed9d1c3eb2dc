"""Batching engine: shuffle, split, pad, pack (counterpart of
``torchani_tpu/datasets/batching.py``, whose numpy code it copies).

All (group, conformer) index pairs are shuffled with a seeded RNG, split
into named divisions (fraction splits or k-folds) and packed into padded
batches, through a `torchani_tpu_torch.transforms.Transform`; batches stay
in RAM or go to disk as one ``.npz`` file per batch, with a
``creation_log.json`` of the seed, splits and properties.  The same seed
gives the JAX package's batches bit for bit: the same order, padding and
angular-capacity buckets.

Batches are padded on both axes, atoms to the division's largest molecule
and (optionally) molecules to the batch size, so that a division's batches
share their shapes.  `BatchedDataset.cache` with ``pin_memory=True`` holds
each batch's arrays as pinned host tensors, which copy to the card without
a staging copy.
"""

import json
import typing as tp
from pathlib import Path

import numpy as np
import torch

from torchani_tpu_torch.datasets.anidataset import ANIDataset
from torchani_tpu_torch.transforms import Transform, identity
from torchani_tpu_torch.utils import pad_atomic_properties

__all__ = [
    "Batcher",
    "BatchedDataset",
    "ANIBatchedDataset",
    "ANIBatchedInMemoryDataset",
    "Div",
    "create_batched_dataset",
    "batch_all_in_ram",
]

Properties = tp.Dict[str, np.ndarray]


class Div(tp.NamedTuple):
    """A named division of a batched dataset."""

    name: str
    indices: np.ndarray  # (num_conformers, 2) [group-ordinal, conformer-idx]
    path: tp.Optional[object] = None


class BatchedDataset:
    """Base class for batched-dataset divisions: an indexable sequence of
    batch dicts."""

    def __len__(self) -> int:
        raise NotImplementedError

    def __getitem__(self, i: int) -> Properties:
        raise NotImplementedError

    def __iter__(self) -> tp.Iterator[Properties]:
        for i in range(len(self)):
            yield self[i]

    def cache(self, verbose: bool = True, pin_memory: bool = False):
        """Load all batches into RAM; with ``pin_memory`` as pinned host
        tensors (which needs a CUDA device)."""
        batches = [self[i] for i in range(len(self))]
        return ANIBatchedInMemoryDataset(_pinned(batches) if pin_memory else batches)


def _pinned(batches: tp.Sequence[Properties]) -> tp.List[tp.Dict[str, torch.Tensor]]:
    """Each batch's arrays as pinned (page-locked) host tensors."""
    return [
        {k: torch.as_tensor(np.asarray(v)).pin_memory() for k, v in b.items()}
        for b in batches
    ]


class ANIBatchedInMemoryDataset(BatchedDataset):
    """A division's batches held in RAM; iterable, optionally shuffled."""

    def __init__(self, batches: tp.List[Properties]) -> None:
        self._batches = batches

    def cache(self, verbose: bool = True, pin_memory: bool = False):
        """The division itself; with ``pin_memory`` a copy whose arrays are
        pinned host tensors (which needs a CUDA device)."""
        return ANIBatchedInMemoryDataset(_pinned(self._batches)) if pin_memory else self

    def __len__(self) -> int:
        return len(self._batches)

    def __getitem__(self, i: int) -> Properties:
        return self._batches[i]

    def __iter__(self) -> tp.Iterator[Properties]:
        return iter(self._batches)

    def shuffled(self, seed: int = 0) -> tp.Iterator[Properties]:
        order = np.random.RandomState(seed).permutation(len(self._batches))
        for i in order:
            yield self._batches[i]


class ANIBatchedDataset(BatchedDataset):
    """A division stored as one ``.npz`` file per batch."""

    def __init__(self, root, division: str = "training") -> None:
        self.dir = Path(root) / division
        if not self.dir.is_dir():
            raise FileNotFoundError(f"No batched division at {self.dir}")
        self._files = sorted(self.dir.glob("batch_*.npz"))

    def __len__(self) -> int:
        return len(self._files)

    def __getitem__(self, i: int) -> Properties:
        with np.load(self._files[i]) as data:
            return {k: data[k] for k in data.files}

    def __iter__(self) -> tp.Iterator[Properties]:
        for i in range(len(self)):
            yield self[i]

    def shuffled(self, seed: int = 0) -> tp.Iterator[Properties]:
        order = np.random.RandomState(seed).permutation(len(self))
        for i in order:
            yield self[i]


class Batcher:
    """Batch creation: shuffle -> divisions -> padded batches."""

    def __init__(
        self,
        rng_seed: tp.Optional[int] = None,
        shuffle: bool = True,
    ) -> None:
        self.rng_seed = rng_seed if rng_seed is not None else 1234
        self.shuffle = shuffle

    def divide(
        self,
        dataset: ANIDataset,
        splits: tp.Optional[tp.Dict[str, float]] = None,
        folds: tp.Optional[int] = None,
    ) -> tp.Dict[str, tp.List[tp.Tuple[str, int]]]:
        """Shuffle all (group, conformer-idx) pairs and split into divisions."""
        pairs: tp.List[tp.Tuple[str, int]] = []
        for name, size in sorted(dataset.group_sizes().items()):
            pairs.extend((name, i) for i in range(size))
        rng = np.random.RandomState(self.rng_seed)
        if self.shuffle:
            rng.shuffle(pairs)
        if folds is not None:
            out: tp.Dict[str, tp.List[tp.Tuple[str, int]]] = {}
            n = len(pairs)
            for f in range(folds):
                lo, hi = f * n // folds, (f + 1) * n // folds
                out[f"validation{f}"] = pairs[lo:hi]
                out[f"training{f}"] = pairs[:lo] + pairs[hi:]
            return out
        if splits is None:
            splits = {"training": 0.8, "validation": 0.2}
        if not np.isclose(sum(splits.values()), 1.0):
            raise ValueError("Split fractions must sum to 1.0")
        out = {}
        start = 0
        n = len(pairs)
        items = list(splits.items())
        for i, (name, frac) in enumerate(items):
            stop = n if i == len(items) - 1 else start + int(round(frac * n))
            out[name] = pairs[start:stop]
            start = stop
        return out

    def gather_batches(
        self,
        dataset: ANIDataset,
        division_pairs: tp.List[tp.Tuple[str, int]],
        batch_size: int,
        properties: tp.Optional[tp.Sequence[str]] = None,
        transform: Transform = identity,
        pad_molecules: bool = False,
        density_cutoff: tp.Optional[float] = None,
        capacity_buckets: tp.Sequence[int] = (8, 12, 16, 20, 24, 32, 48, 64),
    ) -> tp.List[Properties]:
        """Materialize padded batches for one division.

        Conformers are fetched group by group (bounding random reads), then
        assembled in shuffled order.

        ``density_cutoff`` (e.g. the model's 3.5 A angular cutoff) enables
        capacity bucketing: conformers are stably regrouped by their max
        within-cutoff neighbor count so each batch holds molecules of
        similar density, and every batch carries an ``angular_capacity``
        scalar (the smallest bucket covering its densest atom).  The
        training step runs each batch at its capacity, so the angular AEV
        work, which grows with the capacity squared, is not padded to the
        densest conformer of the whole dataset.
        """
        # fetch per group, preserving division order via an index map
        by_group: tp.Dict[str, tp.List[int]] = {}
        for name, i in division_pairs:
            by_group.setdefault(name, []).append(i)
        cache: tp.Dict[str, Properties] = {}
        for name, idxs in by_group.items():
            cache[name] = dataset.get_conformers(
                name, np.asarray(sorted(idxs)), properties
            )
            cache[name]["__idx"] = np.asarray(sorted(idxs))
        if density_cutoff is not None:
            # stable sort by per-conformer density class: equal-density
            # conformers keep their seeded-shuffle order
            stats = [
                _max_neighbor_count(
                    cache[name], int(np.searchsorted(cache[name]["__idx"], i)),
                    density_cutoff,
                )
                for name, i in division_pairs
            ]
            classes = [
                int(np.searchsorted(np.asarray(capacity_buckets), s))
                for s in stats
            ]
            order = np.argsort(np.asarray(classes), kind="stable")
            division_pairs = [division_pairs[int(o)] for o in order]
            stats = [stats[int(o)] for o in order]
        batches = []
        for b0 in range(0, len(division_pairs), batch_size):
            chunk = division_pairs[b0: b0 + batch_size]
            singles = []
            for name, i in chunk:
                group = cache[name]
                j = int(np.searchsorted(group["__idx"], i))
                singles.append(
                    {
                        k: v[j: j + 1]
                        for k, v in group.items()
                        if k != "__idx"
                    }
                )
            batch = pad_atomic_properties(singles)
            if pad_molecules and len(chunk) < batch_size:
                batch = _pad_molecule_axis(batch, batch_size)
            batch = transform(batch)
            if density_cutoff is not None:
                worst = max(stats[b0: b0 + len(chunk)])
                cap = next(
                    (c for c in capacity_buckets if c >= worst),
                    capacity_buckets[-1],
                )
                batch["angular_capacity"] = np.asarray(cap, dtype=np.int32)
            batches.append(batch)
        return batches


def _max_neighbor_count(
    group: Properties, j: int, cutoff: float
) -> int:
    """Max within-cutoff neighbor count of conformer ``j`` (host-side)."""
    species = np.asarray(group["species"])[j]
    coords = np.asarray(group["coordinates"])[j]
    real = species >= 0
    n = int(real.sum())
    if n < 2:
        return 0
    pos = coords[real][:n]
    d = np.linalg.norm(pos[:, None] - pos[None, :], axis=-1)
    np.fill_diagonal(d, np.inf)
    return int((d < cutoff).sum(axis=1).max())


def _pad_molecule_axis(batch: Properties, size: int) -> Properties:
    out = {}
    for k, v in batch.items():
        pad = size - v.shape[0]
        if pad <= 0:
            out[k] = v
            continue
        fill = -1 if k in ("species", "numbers") else 0
        shape = (pad,) + v.shape[1:]
        out[k] = np.concatenate([v, np.full(shape, fill, dtype=v.dtype)])
    return out


def create_batched_dataset(
    dataset: tp.Union[ANIDataset, str, Path],
    dest_path: tp.Union[str, Path],
    batch_size: int = 2560,
    splits: tp.Optional[tp.Dict[str, float]] = None,
    folds: tp.Optional[int] = None,
    properties: tp.Optional[tp.Sequence[str]] = None,
    transform: Transform = identity,
    rng_seed: tp.Optional[int] = None,
    shuffle: bool = True,
    density_cutoff: tp.Optional[float] = None,
) -> Path:
    """Create an on-disk batched dataset (one npz per batch per division).

    ``density_cutoff`` enables per-batch angular-capacity bucketing (see
    `Batcher.gather_batches`); the capacity rides in each batch file and in
    the creation log.
    """
    if not isinstance(dataset, ANIDataset):
        dataset = ANIDataset(dataset)
    dest = Path(dest_path)
    dest.mkdir(parents=True, exist_ok=True)
    batcher = Batcher(rng_seed=rng_seed, shuffle=shuffle)
    divisions = batcher.divide(dataset, splits, folds)
    log = {
        "rng_seed": batcher.rng_seed,
        "shuffle": shuffle,
        "batch_size": batch_size,
        "divisions": {k: len(v) for k, v in divisions.items()},
        "properties": sorted(properties or dataset.properties),
    }
    if density_cutoff is not None:
        log["density_cutoff"] = density_cutoff
    for name, pairs in divisions.items():
        ddir = dest / name
        ddir.mkdir(exist_ok=True)
        batches = batcher.gather_batches(
            dataset, pairs, batch_size, properties, transform,
            density_cutoff=density_cutoff,
        )
        for i, batch in enumerate(batches):
            np.savez_compressed(ddir / f"batch_{i:06d}.npz", **batch)
    (dest / "creation_log.json").write_text(json.dumps(log, indent=1))
    return dest


def batch_all_in_ram(
    dataset: tp.Union[ANIDataset, str, Path],
    batch_size: int = 2560,
    splits: tp.Optional[tp.Dict[str, float]] = None,
    properties: tp.Optional[tp.Sequence[str]] = None,
    transform: Transform = identity,
    rng_seed: tp.Optional[int] = None,
    shuffle: bool = True,
    density_cutoff: tp.Optional[float] = None,
) -> tp.Dict[str, ANIBatchedInMemoryDataset]:
    """Create all divisions as in-memory batch lists."""
    if not isinstance(dataset, ANIDataset):
        dataset = ANIDataset(dataset)
    batcher = Batcher(rng_seed=rng_seed, shuffle=shuffle)
    divisions = batcher.divide(dataset, splits)
    return {
        name: ANIBatchedInMemoryDataset(
            batcher.gather_batches(
                dataset, pairs, batch_size, properties, transform,
                density_cutoff=density_cutoff,
            )
        )
        for name, pairs in divisions.items()
    }
