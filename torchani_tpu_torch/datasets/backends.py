"""Storage backends of conformer datasets (counterpart of
``torchani_tpu/datasets/backends.py``, whose numpy code it copies).

A `Store` is a mutable mapping of named conformer *groups*; each group is a
dict of numpy arrays sharing a leading conformer axis (and an atom axis for
atomic keys).  Backends: HDF5 (h5py), Parquet (pandas), a dependency-free
Zarr v2 directory store and an in-memory one.  The on-disk formats, and the
md5 sidecar of `Store.record_checksums`, are the JAX package's: a store
written by one package is read by the other.  ``h5py`` and ``pandas`` are
imported only by their stores.
"""

import json
import typing as tp
from pathlib import Path

import numpy as np

__all__ = ["Store", "HDF5Store", "ParquetStore", "ZarrStore", "InMemoryStore", "UnionStore", "create_store"]

Conformers = tp.Dict[str, np.ndarray]


class Store:
    """Abstract mutable mapping: group name -> {property: array}."""

    def keys(self) -> tp.List[str]:
        raise NotImplementedError

    def get(self, name: str, properties: tp.Optional[tp.Sequence[str]] = None) -> Conformers:
        raise NotImplementedError

    def put(self, name: str, conformers: Conformers) -> None:
        raise NotImplementedError

    def append_to(self, name: str, conformers: Conformers) -> None:
        data = self.get(name)
        merged = {}
        if set(data) != set(conformers):
            raise ValueError(
                f"Property mismatch appending to {name}: "
                f"{sorted(data)} vs {sorted(conformers)}"
            )
        for k in data:
            merged[k] = np.concatenate([data[k], np.asarray(conformers[k])])
        self.put(name, merged)

    def delete(self, name: str) -> None:
        raise NotImplementedError

    def properties(self) -> tp.Set[str]:
        props: tp.Set[str] = set()
        for k in self.keys():
            props |= set(self.get(k).keys())
        return props

    def group_sizes(self) -> tp.Dict[str, int]:
        sizes = {}
        for k in self.keys():
            g = self.get(k)
            first = next(iter(g.values()))
            sizes[k] = int(np.shape(first)[0])
        return sizes

    # metadata
    def get_metadata(self) -> tp.Dict[str, str]:
        return {}

    def set_metadata(self, meta: tp.Dict[str, str]) -> None:
        raise NotImplementedError

    # -- integrity: an md5 manifest of any local store, in a sidecar file --
    @property
    def root(self) -> tp.Optional[Path]:
        """Filesystem root of this store (file or directory); None if not
        disk-backed."""
        return None

    def files(self) -> tp.List[Path]:
        """On-disk files backing this store, for integrity checksums."""
        return []

    def _checksum_sidecar(self) -> tp.Optional[Path]:
        # The manifest must live OUTSIDE the data it checksums (a checksum
        # stored inside an HDF5 attr would invalidate itself on write).
        root = self.root
        if root is None:
            return None
        return root.with_name(root.name + ".md5.json")

    def _file_md5s(self) -> tp.Dict[str, str]:
        import hashlib

        root = tp.cast(Path, self.root)
        out = {}
        for p in sorted(self.files()):
            h = hashlib.md5()
            with open(p, "rb") as fh:
                for chunk in iter(lambda: fh.read(1 << 20), b""):
                    h.update(chunk)
            out[p.relative_to(root.parent).as_posix()] = h.hexdigest()
        return out

    def record_checksums(self) -> tp.Dict[str, str]:
        """Write an md5 manifest sidecar (``<root>.md5.json``) for the
        store's current files; returns the manifest."""
        side = self._checksum_sidecar()
        if side is None:
            raise ValueError("store is not disk-backed; nothing to checksum")
        sums = self._file_md5s()
        side.write_text(json.dumps(sums, sort_keys=True, indent=1))
        return sums

    def verify_checksums(self) -> tp.Dict[str, tp.Any]:
        """Compare current file md5s against the recorded manifest.

        Returns ``{"ok", "recorded", "missing", "mismatched", "untracked"}``
        — ``ok`` is True when a manifest exists and everything matches.
        """
        side = self._checksum_sidecar()
        if side is None or not side.exists():
            return {
                "ok": False,
                "recorded": False,
                "missing": [],
                "mismatched": [],
                "untracked": [],
            }
        want = json.loads(side.read_text())
        have = self._file_md5s()
        missing = sorted(set(want) - set(have))
        untracked = sorted(set(have) - set(want))
        mismatched = sorted(
            k for k in set(want) & set(have) if want[k] != have[k]
        )
        return {
            "ok": not (missing or mismatched or untracked),
            "recorded": True,
            "missing": missing,
            "mismatched": mismatched,
            "untracked": untracked,
        }

    def __contains__(self, name: str) -> bool:
        return name in self.keys()

    def __len__(self) -> int:
        return len(self.keys())


class InMemoryStore(Store):
    def __init__(self) -> None:
        self._groups: tp.Dict[str, Conformers] = {}
        self._meta: tp.Dict[str, str] = {}

    def keys(self) -> tp.List[str]:
        return sorted(self._groups)

    def get(self, name, properties=None) -> Conformers:
        g = self._groups[name]
        if properties is not None:
            return {k: g[k] for k in properties}
        return dict(g)

    def put(self, name, conformers) -> None:
        self._groups[name] = {k: np.asarray(v) for k, v in conformers.items()}

    def delete(self, name) -> None:
        del self._groups[name]

    def get_metadata(self):
        return dict(self._meta)

    def set_metadata(self, meta):
        self._meta.update(meta)


class HDF5Store(Store):
    """HDF5-backed store: one group per conformer set, one dataset per key.

    Also reads "legacy" ANI-1x style files (nested groups; each leaf group
    holding datasets is flattened to a ``/``-joined name).
    """

    def __init__(self, path, mode: str = "a") -> None:
        import h5py

        self.path = Path(path)
        self._h5py = h5py
        self._mode = mode
        # Create the file if missing (mode 'a')
        with self._open("a" if mode != "r" else "r"):
            pass

    def _open(self, mode: tp.Optional[str] = None):
        return self._h5py.File(self.path, mode or self._mode)

    @property
    def root(self) -> Path:
        return self.path

    def files(self) -> tp.List[Path]:
        return [self.path] if self.path.exists() else []

    def keys(self) -> tp.List[str]:
        names: tp.List[str] = []

        def visit(name, obj):
            if isinstance(obj, self._h5py.Group) and any(
                isinstance(child, self._h5py.Dataset) for child in obj.values()
            ):
                names.append(name)

        with self._open("r") as f:
            f.visititems(visit)
        return sorted(names)

    def get(self, name, properties=None) -> Conformers:
        with self._open("r") as f:
            g = f[name]
            keys = properties if properties is not None else list(g.keys())
            out = {}
            for k in keys:
                arr = np.asarray(g[k])
                if arr.dtype.kind == "S" or arr.dtype.kind == "O":
                    arr = arr.astype(str)
                out[k] = arr
            return out

    def put(self, name, conformers) -> None:
        with self._open("a") as f:
            if name in f:
                del f[name]
            g = f.create_group(name)
            for k, v in conformers.items():
                v = np.asarray(v)
                if v.dtype.kind == "U":
                    v = v.astype("S")
                g.create_dataset(k, data=v)

    def delete(self, name) -> None:
        with self._open("a") as f:
            del f[name]

    def get_metadata(self):
        with self._open("r") as f:
            return {k: str(v) for k, v in f.attrs.items()}

    def set_metadata(self, meta):
        with self._open("a") as f:
            for k, v in meta.items():
                f.attrs[k] = v


class ParquetStore(Store):
    """Parquet-backed store: one file per group + a JSON sidecar with shapes."""

    def __init__(self, path, mode: str = "a") -> None:
        import pandas  # noqa: F401 (availability check)

        self.dir = Path(path)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._meta_path = self.dir / "_metadata.json"

    @property
    def root(self) -> Path:
        return self.dir

    def files(self) -> tp.List[Path]:
        return sorted(p for p in self.dir.rglob("*") if p.is_file())

    def _sidecar(self, name: str) -> Path:
        return self.dir / f"{name.replace('/', '__')}.shapes.json"

    def _file(self, name: str) -> Path:
        return self.dir / f"{name.replace('/', '__')}.parquet"

    def keys(self) -> tp.List[str]:
        return sorted(
            p.stem.replace("__", "/")
            for p in self.dir.glob("*.parquet")
        )

    def get(self, name, properties=None) -> Conformers:
        import pandas as pd

        df = pd.read_parquet(self._file(name))
        shapes = json.loads(self._sidecar(name).read_text())
        out = {}
        keys = properties if properties is not None else list(shapes)
        for k in keys:
            flat = np.stack(df[k].to_numpy())
            shape = shapes[k]
            out[k] = flat.reshape([len(df)] + shape)
        return out

    def put(self, name, conformers) -> None:
        import pandas as pd

        n = int(np.shape(next(iter(conformers.values())))[0])
        cols = {}
        shapes = {}
        for k, v in conformers.items():
            v = np.asarray(v)
            shapes[k] = list(v.shape[1:])
            cols[k] = list(v.reshape(n, -1))
        pd.DataFrame(cols).to_parquet(self._file(name))
        self._sidecar(name).write_text(json.dumps(shapes))

    def delete(self, name) -> None:
        self._file(name).unlink()
        self._sidecar(name).unlink(missing_ok=True)

    def get_metadata(self):
        if self._meta_path.exists():
            return json.loads(self._meta_path.read_text())
        return {}

    def set_metadata(self, meta):
        data = self.get_metadata()
        data.update(meta)
        self._meta_path.write_text(json.dumps(data))


class ZarrStore(Store):
    """Zarr-v2 directory store, implemented dependency-free.

    Reads and writes the standard zarr v2 on-disk format directly (JSON
    ``.zgroup``/``.zarray``/``.zattrs`` metadata + zlib-compressed chunk
    files, stdlib ``zlib``/``gzip`` only), so stores are interoperable with
    the ``zarr`` package and with the JAX package's `ZarrStore`.  Arrays
    are written as a single chunk; reading follows the metadata's chunk
    grid, so multi-chunk files written by other tools load too.
    """

    _GROUP_META = '{"zarr_format": 2}'

    def __init__(self, path, mode: str = "a") -> None:
        self.dir = Path(path)
        if mode == "r" and not self.dir.exists():
            raise FileNotFoundError(self.dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        zgroup = self.dir / ".zgroup"
        if not zgroup.exists():
            zgroup.write_text(self._GROUP_META)

    @property
    def root(self) -> Path:
        return self.dir

    def files(self) -> tp.List[Path]:
        return sorted(p for p in self.dir.rglob("*") if p.is_file())

    # -- format helpers --
    @staticmethod
    def _compress(raw: bytes) -> bytes:
        import zlib

        return zlib.compress(raw, 1)

    @staticmethod
    def _decode_chunk(data: bytes, compressor: tp.Optional[dict]) -> bytes:
        if compressor is None:
            return data
        cid = compressor.get("id")
        if cid == "zlib":
            import zlib

            return zlib.decompress(data)
        if cid == "gzip":
            import gzip

            return gzip.decompress(data)
        if cid == "blosc":
            raise ValueError(
                "blosc-compressed zarr chunks need the 'zarr'/'numcodecs' "
                "packages, which this store does not use; re-encode with zlib"
            )
        raise ValueError(f"Unsupported zarr compressor {compressor!r}")

    def _write_array(self, adir: Path, v: np.ndarray) -> None:
        adir.mkdir(parents=True, exist_ok=True)
        meta = {
            "zarr_format": 2,
            "shape": list(v.shape),
            "chunks": list(v.shape) if v.ndim else [1],
            "dtype": v.dtype.str,
            "compressor": {"id": "zlib", "level": 1},
            "fill_value": None,
            "order": "C",
            "filters": None,
        }
        (adir / ".zarray").write_text(json.dumps(meta))
        chunk_name = ".".join(["0"] * max(v.ndim, 1))
        (adir / chunk_name).write_bytes(
            self._compress(np.ascontiguousarray(v).tobytes())
        )

    def _read_array(self, adir: Path) -> np.ndarray:
        meta = json.loads((adir / ".zarray").read_text())
        dtype = np.dtype(meta["dtype"])
        shape = tuple(meta["shape"])
        chunks = tuple(meta["chunks"]) if shape else (1,)
        if meta.get("order", "C") != "C" or meta.get("filters"):
            raise ValueError("Only order='C', unfiltered zarr arrays supported")
        sep = meta.get("dimension_separator", ".")
        grid = [
            -(-s // c) for s, c in zip(shape, chunks)
        ] or [1]
        out = np.zeros(shape if shape else (), dtype)
        fill = meta.get("fill_value")
        if fill is not None and dtype.kind not in "SU":
            out[...] = fill
        for idx in np.ndindex(*grid):
            name = sep.join(str(i) for i in (idx or (0,)))
            cpath = adir / name
            if not cpath.exists():
                continue  # chunk at fill value
            raw = self._decode_chunk(cpath.read_bytes(), meta["compressor"])
            chunk = np.frombuffer(raw, dtype).reshape(chunks)
            if not shape:
                return chunk.reshape(())[()] * np.ones((), dtype)
            sl = tuple(
                slice(i * c, min((i + 1) * c, s))
                for i, c, s in zip(idx, chunks, shape)
            )
            trim = tuple(slice(0, s.stop - s.start) for s in sl)
            out[sl] = chunk[trim]
        return out

    def _group_dir(self, name: str) -> Path:
        parts = [p for p in name.split("/") if p]
        if not parts or any(p.startswith(".") for p in parts):
            raise ValueError(f"Invalid group name {name!r}")
        return self.dir.joinpath(*parts)

    # -- Store interface --
    def keys(self) -> tp.List[str]:
        names = set()
        for zarray in self.dir.rglob(".zarray"):
            group = zarray.parent.parent
            if group == self.dir:
                continue
            names.add(group.relative_to(self.dir).as_posix())
        return sorted(names)

    def get(self, name, properties=None) -> Conformers:
        gdir = self._group_dir(name)
        if properties is None:
            properties = sorted(
                p.name for p in gdir.iterdir()
                if p.is_dir() and (p / ".zarray").exists()
            )
        out = {}
        for k in properties:
            arr = self._read_array(gdir / k)
            if arr.dtype.kind in ("S", "O"):
                arr = arr.astype(str)
            out[k] = arr
        return out

    def put(self, name, conformers) -> None:
        gdir = self._group_dir(name)
        if gdir.exists():
            import shutil

            shutil.rmtree(gdir)
        # mark every level as a zarr group
        level = self.dir
        for part in gdir.relative_to(self.dir).parts:
            level = level / part
            level.mkdir(exist_ok=True)
            zg = level / ".zgroup"
            if not zg.exists():
                zg.write_text(self._GROUP_META)
        for k, v in conformers.items():
            v = np.asarray(v)
            if v.dtype.kind == "U":
                v = v.astype("S")
            self._write_array(gdir / k, v)

    def delete(self, name) -> None:
        import shutil

        gdir = self._group_dir(name)
        if not gdir.exists():
            raise KeyError(name)
        shutil.rmtree(gdir)

    def get_metadata(self):
        zattrs = self.dir / ".zattrs"
        if zattrs.exists():
            return {k: str(v) for k, v in json.loads(zattrs.read_text()).items()}
        return {}

    def set_metadata(self, meta):
        data = self.get_metadata()
        data.update(meta)
        (self.dir / ".zattrs").write_text(json.dumps(data))


def create_store(location, backend: tp.Optional[str] = None, mode: str = "a") -> Store:
    """Open/create a store; backend inferred from the location suffix."""
    if backend is None:
        if location is None:
            backend = "memory"
        else:
            suffix = Path(location).suffix
            backend = {
                ".h5": "hdf5",
                ".hdf5": "hdf5",
                ".pq": "parquet",
                ".parquet": "parquet",
                ".zarr": "zarr",
            }.get(suffix, "hdf5" if suffix else "parquet")
    if backend == "memory":
        return InMemoryStore()
    if backend == "hdf5":
        return HDF5Store(location, mode)
    if backend == "parquet":
        return ParquetStore(location, mode)
    if backend == "zarr":
        return ZarrStore(location, mode)
    raise ValueError(f"Unsupported backend: {backend}")


class UnionStore(Store):
    """A read/write union of several stores, keyed as ``"<store>/<group>"``.

    ``ANIDataset`` accepts multiple file locations and presents them as one
    dataset with store-prefixed group names.  Mutations
    route to the owning sub-store; new groups go to the store named in the
    key (or the first store when the key carries no prefix).
    """

    def __init__(self, stores: tp.Dict[str, Store]) -> None:
        if not stores:
            raise ValueError("UnionStore needs at least one sub-store")
        self.stores = dict(stores)

    def _split(self, name: str) -> tp.Tuple[Store, str]:
        if "/" in name:
            prefix, rest = name.split("/", 1)
            if prefix in self.stores:
                return self.stores[prefix], rest
        return next(iter(self.stores.values())), name

    def keys(self) -> tp.List[str]:
        return [
            f"{sname}/{k}" for sname, s in self.stores.items() for k in s.keys()
        ]

    def get(self, name, properties=None) -> Conformers:
        store, key = self._split(name)
        return store.get(key, properties)

    def put(self, name, conformers) -> None:
        store, key = self._split(name)
        store.put(key, conformers)

    def append_to(self, name, conformers) -> None:
        store, key = self._split(name)
        store.append_to(key, conformers)

    def delete(self, name) -> None:
        store, key = self._split(name)
        store.delete(key)

    def properties(self) -> tp.Set[str]:
        out: tp.Set[str] = set()
        for s in self.stores.values():
            out |= s.properties()
        return out

    def group_sizes(self) -> tp.Dict[str, int]:
        return {
            f"{sname}/{k}": v
            for sname, s in self.stores.items()
            for k, v in s.group_sizes().items()
        }

    def get_metadata(self):
        return next(iter(self.stores.values())).get_metadata()

    def set_metadata(self, meta) -> None:
        for s in self.stores.values():
            try:
                s.set_metadata(meta)
            except NotImplementedError:
                pass

    def record_checksums(self) -> tp.Dict[str, str]:
        out: tp.Dict[str, str] = {}
        for s in self.stores.values():
            if s.root is not None:
                out.update(s.record_checksums())
        return out

    def verify_checksums(self) -> tp.Dict[str, tp.Any]:
        reports = [
            s.verify_checksums() for s in self.stores.values()
            if s.root is not None
        ]
        if not reports:
            return Store.verify_checksums(self)
        merged: tp.Dict[str, tp.Any] = {
            "ok": all(r["ok"] for r in reports),
            "recorded": all(r["recorded"] for r in reports),
        }
        for k in ("missing", "mismatched", "untracked"):
            merged[k] = sorted(sum((r[k] for r in reports), []))
        return merged

    def __contains__(self, name: str) -> bool:
        store, key = self._split(name)
        return key in store
