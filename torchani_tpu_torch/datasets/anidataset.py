"""User-facing conformer dataset (counterpart of
``torchani_tpu/datasets/anidataset.py``): a mapping over named conformer
groups with iteration, append and delete, regrouping by formula or atom
count, property management, backend conversion and md5 checksums.
Host-side (numpy); training batches come from
`torchani_tpu_torch.datasets.batching`.
"""

import typing as tp
from pathlib import Path

import numpy as np

from torchani_tpu_torch.constants import PERIODIC_TABLE
from torchani_tpu_torch.datasets.backends import Store, UnionStore, create_store
from torchani_tpu_torch.utils import pad_atomic_properties

__all__ = ["ANIDataset"]

Conformers = tp.Dict[str, np.ndarray]

#: Keys whose second axis is atoms
ATOMIC_KEYS = ("species", "numbers", "coordinates", "forces", "atomic_charges")


class ANIDataset:
    """A collection of named conformer groups over a storage backend.

    Each group holds arrays with a leading conformer axis; ``species`` (atomic
    numbers, shape ``(C, A)``) and ``coordinates`` ``(C, A, 3)`` are standard.
    """

    def __init__(
        self,
        locations: tp.Union[None, str, Path, tp.Sequence[tp.Union[str, Path]]] = None,
        backend: tp.Optional[str] = None,
        store: tp.Optional[Store] = None,
    ) -> None:
        if store is not None:
            self._store = store
        elif isinstance(locations, (list, tuple)):
            if len(locations) == 1:
                self._store = create_store(locations[0], backend)
            else:
                # several files presented as one dataset with
                # store-prefixed group names ("<stem>/<group>")
                stores: tp.Dict[str, Store] = {}
                for loc in locations:
                    name = Path(loc).stem
                    suffix, i = name, 1
                    while suffix in stores:
                        i += 1
                        suffix = f"{name}{i}"
                    stores[suffix] = create_store(loc, backend)
                self._store = UnionStore(stores)
        else:
            self._store = create_store(locations, backend)

    # ---- mapping interface ----
    @property
    def store(self) -> Store:
        return self._store

    def keys(self) -> tp.List[str]:
        return self._store.keys()

    def __len__(self) -> int:
        return len(self._store)

    def __contains__(self, name: str) -> bool:
        return name in self._store

    def __getitem__(self, name: str) -> Conformers:
        return self.get_conformers(name)

    def get_conformers(
        self,
        name: str,
        idxs: tp.Union[None, int, slice, np.ndarray] = None,
        properties: tp.Optional[tp.Sequence[str]] = None,
    ) -> Conformers:
        group = self._store.get(name, properties)
        if idxs is None:
            return group
        if isinstance(idxs, int):
            idxs = slice(idxs, idxs + 1)
        return {k: v[idxs] for k, v in group.items()}

    @property
    def grouping(self) -> str:
        return self._store.get_metadata().get("grouping", "by_name")

    @property
    def num_conformers(self) -> int:
        return sum(self._store.group_sizes().values())

    @property
    def properties(self) -> tp.Set[str]:
        return self._store.properties()

    def group_sizes(self) -> tp.Dict[str, int]:
        return self._store.group_sizes()

    # ---- iteration ----
    def items(self) -> tp.Iterator[tp.Tuple[str, Conformers]]:
        for k in self.keys():
            yield k, self._store.get(k)

    def iter_conformers(self) -> tp.Iterator[Conformers]:
        """Yield single conformers across all groups."""
        for _, group in self.items():
            n = int(np.shape(next(iter(group.values())))[0])
            for i in range(n):
                yield {k: v[i] for k, v in group.items()}

    def chunked_items(
        self, max_size: int = 2500
    ) -> tp.Iterator[tp.Tuple[str, Conformers]]:
        """Yield (name, chunk) pairs with at most ``max_size`` conformers."""
        for k, group in self.items():
            n = int(np.shape(next(iter(group.values())))[0])
            for i0 in range(0, n, max_size):
                yield k, {key: v[i0: i0 + max_size] for key, v in group.items()}

    # ---- mutation ----
    def append_conformers(self, name: str, conformers: Conformers) -> "ANIDataset":
        conformers = {k: np.asarray(v) for k, v in conformers.items()}
        self._validate(conformers)
        if name in self._store:
            self._store.append_to(name, conformers)
        else:
            self._store.put(name, conformers)
        return self

    def delete_conformers(
        self, name: str, idxs: tp.Union[None, int, np.ndarray] = None
    ) -> "ANIDataset":
        if idxs is None:
            self._store.delete(name)
            return self
        group = self._store.get(name)
        n = int(np.shape(next(iter(group.values())))[0])
        keep = np.setdiff1d(np.arange(n), np.atleast_1d(idxs))
        if keep.size == 0:
            self._store.delete(name)
        else:
            self._store.put(name, {k: v[keep] for k, v in group.items()})
        return self

    def record_checksums(self) -> tp.Dict[str, str]:
        """Write an md5 manifest for the backing files (``<root>.md5.json``)."""
        return self._store.record_checksums()

    def verify_checksums(self) -> tp.Dict[str, tp.Any]:
        """Compare backing files against the recorded md5 manifest."""
        return self._store.verify_checksums()

    def rename_property(self, old: str, new: str) -> "ANIDataset":
        for k in self.keys():
            g = self._store.get(k)
            if old in g:
                g[new] = g.pop(old)
                self._store.put(k, g)
        return self

    def delete_properties(self, properties: tp.Sequence[str]) -> "ANIDataset":
        for k in self.keys():
            g = self._store.get(k)
            changed = False
            for p in properties:
                if p in g:
                    del g[p]
                    changed = True
            if changed:
                self._store.put(k, g)
        return self

    def _validate(self, conformers: Conformers) -> None:
        if "species" not in conformers and "numbers" not in conformers:
            raise ValueError("Conformers must include 'species' (atomic numbers)")
        key = "species" if "species" in conformers else "numbers"
        c, a = conformers[key].shape
        if "coordinates" in conformers:
            if conformers["coordinates"].shape != (c, a, 3):
                raise ValueError("coordinates must have shape (C, A, 3)")

    # ---- restructuring ----
    def regroup_by_formula(self) -> "ANIDataset":
        return self._regroup(lambda znums: _formula(znums))

    def regroup_by_num_atoms(self) -> "ANIDataset":
        return self._regroup(lambda znums: str(int((znums >= 0).sum())))

    def _regroup(self, keyfn) -> "ANIDataset":
        new_groups: tp.Dict[str, tp.List[Conformers]] = {}
        for _, group in self.items():
            key = "species" if "species" in group else "numbers"
            n = group[key].shape[0]
            for i in range(n):
                gname = keyfn(group[key][i])
                new_groups.setdefault(gname, []).append(
                    {k: v[i: i + 1] for k, v in group.items()}
                )
        for k in self.keys():
            self._store.delete(k)
        for gname, confs in new_groups.items():
            merged = pad_atomic_properties(confs)
            self._store.put(gname, merged)
        meta = self._store.get_metadata()
        meta["grouping"] = "by_formula"
        try:
            self._store.set_metadata(meta)
        except NotImplementedError:
            pass
        return self

    def to_backend(self, location, backend: tp.Optional[str] = None) -> "ANIDataset":
        """Copy all groups into a different backend; returns the new dataset."""
        new = ANIDataset(location, backend)
        for k, group in self.items():
            new._store.put(k, group)
        try:
            new._store.set_metadata(self._store.get_metadata())
        except NotImplementedError:
            pass
        return new


def _formula(znums: np.ndarray) -> str:
    znums = znums[znums >= 0]
    symbols, counts = np.unique(
        [PERIODIC_TABLE[int(z)] for z in znums], return_counts=True
    )
    return "".join(
        f"{s}{c}" if c > 1 else str(s) for s, c in zip(symbols, counts)
    )


def concatenate(
    source: ANIDataset,
    dest_location,
    verbose: bool = True,
    backend: str = "hdf5",
    delete_originals: bool = False,
) -> ANIDataset:
    """Combine all backing stores of a dataset into one store."""
    dest_location = Path(dest_location).resolve()
    dest = ANIDataset(dest_location, backend=backend)
    for name, conformers in source.items():
        dest.append_conformers(name.split("/")[-1], conformers)
    if delete_originals:
        import shutil

        for loc in getattr(source, "locations", []):
            loc = Path(loc)
            if loc.resolve() == dest_location:
                continue
            if loc.is_dir():
                shutil.rmtree(loc)
            elif loc.exists():
                loc.unlink()
    return dest
