"""Legacy (TorchANI-1 style) lazy data pipeline (counterpart of
``torchani_tpu/legacy_data.py``).

A chainable lazy iterable over single-conformer dicts of numpy arrays, read
from (legacy) HDF5 files::

    load(path).species_to_indices().subtract_self_energies(saes)
        .shuffle().cache().collate(batch_size).split(0.8, None)

and the pyanitools reader and writer (`anidataloader`, `datapacker`), whose
files either package reads.  The pipeline stays on the host, as the port's
`datasets` does; `Transformations.pin_memory` turns its batches into pinned
``torch.Tensor``s for fast copies to the card.
"""

import os
import typing as tp
from pathlib import Path

import numpy as np
import torch

from torchani_tpu_torch.nn import SpeciesConverter
from torchani_tpu_torch.utils import PADDING, pad_atomic_properties

__all__ = [
    "load",
    "TransformableIterable",
    "Transformations",
    "IterableAdapter",
    "IterableAdapterWithLength",
    "collate_fn",
    "stack_with_padding",
    "anidataloader",
    "datapacker",
]

Properties = tp.Dict[str, tp.Any]


def _iter_hdf5(path) -> tp.Iterator[Properties]:
    """Each group that holds datasets, in sorted order of its path, as a
    dict of numpy arrays (byte strings decoded)."""
    import h5py

    with h5py.File(path, "r") as f:
        groups: tp.List[str] = []

        def visit(name, obj):
            if isinstance(obj, h5py.Group) and any(
                isinstance(c, h5py.Dataset) for c in obj.values()
            ):
                groups.append(name)

        f.visititems(visit)
        for name in sorted(groups):
            g = f[name]
            data = {}
            for k in g.keys():
                arr = np.asarray(g[k])
                if arr.dtype.kind in "SO":
                    arr = arr.astype(str)
                data[k] = arr
            yield data


def _split_conformers(group: Properties) -> tp.Iterator[Properties]:
    """A group's conformers one by one; a 1-d ``species`` (or ``numbers``)
    row, as legacy files store it, is shared by every conformer."""
    key = "species" if "species" in group else "numbers"
    species = group[key]
    if species.ndim == 1:
        n = group["coordinates"].shape[0]
        for i in range(n):
            yield {
                "species": species,
                **{k: v[i] for k, v in group.items() if k not in ("species", "numbers")},
            }
    else:
        for i in range(species.shape[0]):
            yield {k: v[i] for k, v in group.items()}


class TransformableIterable:
    """Lazy chainable iterable of single-conformer dicts."""

    def __init__(self, iterable: tp.Iterable[Properties], transforms: tp.Tuple = ()) -> None:
        self._iterable = iterable
        self.transforms = transforms

    def __iter__(self) -> tp.Iterator[Properties]:
        return iter(self._iterable)

    def _chain(self, gen: tp.Callable[[], tp.Iterator[Properties]], name: str):
        return TransformableIterable(_Regenerable(gen), self.transforms + (name,))

    # ---- transformations ----
    def species_to_indices(
        self, symbols: tp.Sequence[str] = ("H", "C", "N", "O", "F", "S", "Cl")
    ) -> "TransformableIterable":
        """Chemical symbols or atomic numbers to 0-based indices into
        ``symbols`` (int64; atomic numbers through a `SpeciesConverter` on a
        CPU tensor, so nothing goes to the card)."""
        conv = SpeciesConverter(tuple(symbols))
        symbol_map = {s: i for i, s in enumerate(symbols)}

        def gen():
            for c in self:
                out = dict(c)
                sp = np.asarray(c["species"])
                if sp.dtype.kind in "UO":
                    out["species"] = np.asarray([symbol_map[s] for s in sp], dtype=np.int64)
                else:
                    out["species"] = conv(torch.from_numpy(sp[None].astype(np.int64)))[0].numpy()
                yield out

        return self._chain(gen, "species_to_indices")

    def subtract_self_energies(
        self, self_energies: tp.Union[tp.Mapping[int, float], tp.Sequence[float]]
    ) -> "TransformableIterable":
        """Energies (f64) less the self energies of the conformer's element
        indices (a sequence by index, or a mapping)."""
        if isinstance(self_energies, tp.Mapping):
            table = dict(self_energies)
        else:
            table = {i: e for i, e in enumerate(self_energies)}

        def gen():
            for c in self:
                out = dict(c)
                sae = sum(table[int(s)] for s in c["species"] if int(s) >= 0)
                out["energies"] = np.asarray(c["energies"], dtype=np.float64) - sae
                yield out

        return self._chain(gen, "subtract_self_energies")

    def shuffle(self, seed: int = 0) -> "TransformableIterable":
        """Every item, in the order of ``np.random.RandomState(seed).shuffle``."""

        def gen():
            items = list(self)
            np.random.RandomState(seed).shuffle(items)
            yield from items

        return self._chain(gen, "shuffle")

    def cache(self) -> "TransformableIterable":
        return TransformableIterable(list(self), self.transforms + ("cache",))

    def collate(self, batch_size: int) -> "TransformableIterable":
        """Batches of ``batch_size`` conformers (the last may be smaller),
        padded along the atom axis with the ANI padding values."""

        def gen():
            batch: tp.List[Properties] = []
            for c in self:
                batch.append(
                    {
                        k: (np.asarray(v)[None] if np.ndim(v) >= 1 else np.asarray([v]))
                        for k, v in c.items()
                    }
                )
                if len(batch) == batch_size:
                    yield pad_atomic_properties(batch, PADDING)
                    batch.clear()
            if batch:
                yield pad_atomic_properties(batch, PADDING)

        return self._chain(gen, "collate")

    def split(self, *fractions: tp.Optional[float]) -> tp.Tuple["TransformableIterable", ...]:
        """Consecutive parts of ``int(fraction * n)`` items each; a None
        fraction takes the rest."""
        items = list(self)
        n = len(items)
        out = []
        start = 0
        for frac in fractions:
            stop = n if frac is None else start + int(frac * n)
            out.append(TransformableIterable(items[start:stop], self.transforms + ("split",)))
            start = stop
        return tuple(out)

    def __len__(self) -> int:
        if hasattr(self._iterable, "__len__"):
            return len(self._iterable)  # type: ignore[arg-type]
        raise TypeError("Lazy iterable has no length; call .cache() first")


class _Regenerable:
    def __init__(self, gen: tp.Callable[[], tp.Iterator[Properties]]):
        self._gen = gen

    def __iter__(self):
        return self._gen()


def load(path) -> TransformableIterable:
    """Lazily load conformers from a (legacy) HDF5 file, or from every
    ``*.h5`` file of a directory in sorted order."""
    path = Path(path)
    files = sorted(path.glob("*.h5")) if path.is_dir() else [path]

    def gen():
        for f in files:
            for group in _iter_hdf5(f):
                yield from _split_conformers(group)

    return TransformableIterable(_Regenerable(gen))


def stack_with_padding(
    properties: tp.Sequence[Properties], padding: tp.Mapping[str, float]
) -> Properties:
    """Stack single-conformer dicts into numpy arrays, padding the atom axis
    with ``padding[key]`` (0 for other keys)."""
    out: Properties = {}
    for k in properties[0].keys():
        vals = [np.asarray(p[k]) for p in properties]
        if vals[0].ndim == 0:
            out[k] = np.stack(vals)
            continue
        max_len = max(v.shape[0] for v in vals)
        stacked = np.full(
            (len(vals), max_len) + vals[0].shape[1:], padding.get(k, 0), dtype=vals[0].dtype
        )
        for i, v in enumerate(vals):
            stacked[i, : v.shape[0]] = v
        out[k] = stacked
    return out


def collate_fn(
    samples: tp.Sequence[Properties],
    padding: tp.Optional[tp.Mapping[str, float]] = None,
) -> Properties:
    """`stack_with_padding` with the ANI padding values by default."""
    return stack_with_padding(samples, PADDING if padding is None else padding)


class IterableAdapter:
    """A re-enterable iterable from a generator factory."""

    def __init__(self, iterable_factory, length: tp.Optional[int] = None):
        self.iterable_factory = iterable_factory
        self.length = length

    def __iter__(self):
        return iter(self.iterable_factory())


class IterableAdapterWithLength(IterableAdapter):
    def __init__(self, iterable_factory, length: int):
        super().__init__(iterable_factory)
        self.length = length

    def __len__(self) -> int:
        return self.length


class Transformations:
    """The chain's transformations as static functions over re-enterable
    iterables (the method chain on `TransformableIterable` is the primary
    API; these delegate to it), and `pin_memory`."""

    @staticmethod
    def _wrap(it) -> TransformableIterable:
        return it if isinstance(it, TransformableIterable) else TransformableIterable(it)

    @staticmethod
    def species_to_indices(
        it, species_order=("H", "C", "N", "O", "F", "S", "Cl")
    ) -> TransformableIterable:
        return Transformations._wrap(it).species_to_indices(species_order)

    @staticmethod
    def subtract_self_energies(it, self_energies) -> TransformableIterable:
        return Transformations._wrap(it).subtract_self_energies(self_energies)

    @staticmethod
    def shuffle(it, seed: int = 0) -> TransformableIterable:
        return Transformations._wrap(it).shuffle(seed)

    @staticmethod
    def cache(it) -> TransformableIterable:
        return Transformations._wrap(it).cache()

    @staticmethod
    def collate(it, batch_size: int, padding=None) -> TransformableIterable:
        """`TransformableIterable.collate`; ``padding`` is ignored, as the
        JAX package ignores it (the ANI padding values apply)."""
        return Transformations._wrap(it).collate(batch_size)

    @staticmethod
    def pin_memory(it) -> TransformableIterable:
        """Each item's arrays as pinned (page-locked) CPU tensors, which copy
        to the card asynchronously.  Needs CUDA, as ``Tensor.pin_memory``
        does: without it this raises, and nothing is returned unpinned."""
        if not torch.cuda.is_available():
            raise RuntimeError("pin_memory needs a CUDA device and none is available")
        src = Transformations._wrap(it)

        def gen():
            for c in src:
                yield {k: torch.as_tensor(np.asarray(v)).pin_memory() for k, v in c.items()}

        return src._chain(gen, "pin_memory")


class datapacker:
    """pyanitools-compatible HDF5 writer: one group of datasets per
    `store_data` call (lists of strings stored as UTF-8 bytes)."""

    def __init__(self, store_file, mode: str = "w-", complib: str = "gzip", complevel: int = 6):
        import h5py

        self.store = h5py.File(store_file, mode=mode)
        self.clib = complib
        self.clev = complevel

    def store_data(self, store_loc: str, **kwargs) -> None:
        g = self.store.create_group(store_loc)
        for k, v in kwargs.items():
            if isinstance(v, list) and v and isinstance(v[0], str):
                v = [a.encode("utf-8") for a in v]
            g.create_dataset(k, data=v, compression=self.clib, compression_opts=self.clev)

    def cleanup(self) -> None:
        self.store.close()


class anidataloader:
    """pyanitools-compatible HDF5 reader: iterates over the groups whose
    members are all datasets, each as a dict with its ``path`` (byte-string
    arrays as lists of str)."""

    def __init__(self, store_file):
        import h5py

        if not os.path.exists(store_file):
            raise FileNotFoundError(f"file not found: {store_file}")
        self.store = h5py.File(store_file, "r")

    def h5py_dataset_iterator(self, g, prefix: str = ""):
        import h5py

        for key in g.keys():
            item = g[key]
            path = f"{prefix}/{key}"
            if isinstance(item, h5py.Dataset):
                continue
            keys = list(item.keys())
            if keys and all(isinstance(item[k], h5py.Dataset) for k in keys):
                data: Properties = {"path": path}
                for k in keys:
                    arr = np.asarray(item[k][()])
                    if arr.dtype.kind == "S" or (
                        arr.dtype.kind == "O" and arr.size and isinstance(arr.reshape(-1)[0], bytes)
                    ):
                        arr = [a.decode("ascii") for a in arr.reshape(-1)]
                    data[k] = arr
                yield data
            else:
                yield from self.h5py_dataset_iterator(item, path)

    def __iter__(self):
        return self.h5py_dataset_iterator(self.store)

    def get_group_list(self):
        return list(self.store.values())

    def group_size(self):
        return len(self.get_group_list())

    def size(self):
        return sum(1 for _ in self)

    def cleanup(self) -> None:
        self.store.close()
