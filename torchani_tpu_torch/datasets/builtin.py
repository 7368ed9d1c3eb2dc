"""Built-in dataset registry and factories (counterpart of
``torchani_tpu/datasets/builtin.py``).

Named datasets (ANI-1x, ANI-2x, COMP6, ...) keyed by level of theory,
looked up under `torchani_tpu_torch.paths.datasets_dir` and checked
against an md5 when one is given.  The package downloads nothing: a factory
whose file is absent raises `FileNotFoundError`.  ``TestData``,
``TestDataForcesDipoles`` and ``TestDataIons`` create small deterministic
synthetic HCNO datasets locally, from the JAX package's seeds and draws.
"""

import hashlib
import typing as tp
from enum import Enum
from pathlib import Path

import numpy as np

from torchani_tpu_torch.datasets.anidataset import ANIDataset
from torchani_tpu_torch.paths import datasets_dir

__all__ = [
    "DATASET_REGISTRY",
    "available_datasets",
    "builtin_dataset",
    "TestData",
    "TestDataForcesDipoles",
    "TestDataIons",
    "ANI1x",
    "ANI1ccx",
    "ANI1e",
    "ANI1q",
    "ANI2x",
    "ANI2qHeavy",
    "COMP6v1",
    "COMP6v2",
    "IonsLight",
    "IonsHeavy",
    "IonsVeryHeavy",
    "DatasetIntegrityError",
    "_DatasetId",
    "_LotId",
]


class DatasetIntegrityError(RuntimeError):
    pass


class _DatasetId(Enum):
    """Builtin-dataset identifiers (exported for API parity)."""

    TESTDATA = "TestData"
    TESTDATAIONS = "TestDataIons"
    TESTDATAFORCESDIPOLES = "TestDataForcesDipoles"
    IONSVERYHEAVY = "IonsVeryHeavy"
    IONSHEAVY = "IonsHeavy"
    IONSLIGHT = "IonsLight"
    ANI1Q = "ANI1q"
    ANI2QHEAVY = "ANI2qHeavy"
    ANI1CCX = "ANI1ccx"
    ANI1X = "ANI1x"
    ANI2X = "ANI2x"
    COMP6V1 = "COMP6v1"
    COMP6V2 = "COMP6v2"
    ANI1E = "ANI1e"


class _LotId(Enum):
    """Level-of-theory identifiers."""

    DEFAULT = "default"
    ALL = "all"
    B973C_DEF2MTZVP = "b973c-def2mtzvp"
    CCSD_PTP_STAR_CBS = "ccsd(t)star-cbs"
    WB97MD3BJ_DEF2TZVPP = "wb97md3bj-def2tzvpp"
    WB97MV_DEF2TZVPP = "wb97mv-def2tzvpp"
    WB97X_631GD = "wb97x-631gd"
    WB97X_DEF2TZVPP = "wb97x-def2tzvpp"


#: name -> {lot: filename}
DATASET_REGISTRY: tp.Dict[str, tp.Dict[str, str]] = {
    "ANI1x": {
        "wb97x-631gd": "ani1x-wb97x-631gd.h5",
        "ccsd(t)star-cbs": "ani1ccx-ccsdtstar-cbs.h5",
    },
    "ANI2x": {
        "wb97x-631gd": "ani2x-wb97x-631gd.h5",
    },
    "COMP6v1": {
        "wb97x-631gd": "comp6v1-wb97x-631gd.h5",
    },
    "COMP6v2": {
        "wb97x-631gd": "comp6v2-wb97x-631gd.h5",
    },
    "AminoacidDimers": {
        "b973c-def2mtzvp": "aminoacid-dimers-b973c.h5",
    },
    "ANI1e": {
        "wb97x-631gd": "ani1e-wb97x-631gd.h5",
    },
    "ANI1q": {
        "wb97x-631gd": "ani1q-wb97x-631gd.h5",
    },
    "ANI2qHeavy": {
        "wb97x-631gd": "ani2q-heavy-wb97x-631gd.h5",
    },
    "IonsLight": {
        "wb97x-631gd": "ions-light-wb97x-631gd.h5",
    },
    "IonsHeavy": {
        "wb97x-631gd": "ions-heavy-wb97x-631gd.h5",
    },
    "IonsVeryHeavy": {
        "wb97x-631gd": "ions-very-heavy-wb97x-631gd.h5",
    },
}


def available_datasets() -> tp.List[str]:
    return sorted(DATASET_REGISTRY)


def _verify_md5(path: Path, md5: tp.Optional[str]) -> None:
    if md5 is None:
        return
    digest = hashlib.md5(path.read_bytes()).hexdigest()
    if digest != md5:
        raise DatasetIntegrityError(
            f"{path} is corrupted (md5 {digest} != expected {md5}); "
            "re-download it or run integrity repair"
        )


def builtin_dataset(
    name: str,
    lot: str = "wb97x-631gd",
    root: tp.Optional[Path] = None,
    md5: tp.Optional[str] = None,
) -> ANIDataset:
    """Open a built-in dataset from the local dataset directory.

    The package downloads nothing, so the file must already exist under
    ``root`` (default `torchani_tpu_torch.paths.datasets_dir`).
    """
    if name not in DATASET_REGISTRY:
        raise ValueError(
            f"Unknown dataset {name!r}; available: {available_datasets()}"
        )
    lots = DATASET_REGISTRY[name]
    if lot not in lots:
        raise ValueError(f"{name} has no level of theory {lot!r}; has {sorted(lots)}")
    root = Path(root) if root is not None else datasets_dir()
    path = root / lots[lot]
    if not path.exists():
        raise FileNotFoundError(
            f"Dataset file {path} not found, and this package downloads "
            f"nothing. Place the file there."
        )
    _verify_md5(path, md5)
    return ANIDataset(path)


def ANI1x(lot: str = "wb97x-631gd", **kwargs) -> ANIDataset:
    return builtin_dataset("ANI1x", lot, **kwargs)


def ANI2x(lot: str = "wb97x-631gd", **kwargs) -> ANIDataset:
    return builtin_dataset("ANI2x", lot, **kwargs)


def COMP6v1(lot: str = "wb97x-631gd", **kwargs) -> ANIDataset:
    return builtin_dataset("COMP6v1", lot, **kwargs)


def TestData(
    root: tp.Optional[Path] = None,
    num_conformers: int = 64,
    seed: int = 1234,
) -> ANIDataset:
    """Small deterministic synthetic dataset (HCNO), created locally."""
    root = Path(root) if root is not None else datasets_dir()
    path = root / f"test-data-{num_conformers}-{seed}.h5"
    if path.exists():
        return ANIDataset(path)
    rng = np.random.RandomState(seed)
    ds = ANIDataset(path)
    for gi, max_atoms in enumerate((6, 9, 12)):
        n = num_conformers // 3 + (gi == 0) * (num_conformers % 3)
        species = rng.choice([1, 6, 7, 8], size=(n, max_atoms))
        ds.append_conformers(
            f"group{gi}",
            {
                "species": species,
                "coordinates": (rng.rand(n, max_atoms, 3) * 4).astype(np.float32),
                "energies": (rng.randn(n) - 40).astype(np.float64),
                "forces": rng.randn(n, max_atoms, 3).astype(np.float32) * 0.01,
            },
        )
    return ds


def ANI1ccx(lot: str = "ccsd(t)star-cbs", **kwargs) -> ANIDataset:
    """ANI-1ccx dataset (CCSD(T)*/CBS energies over ANI-1x structures)."""
    return builtin_dataset("ANI1x", lot, **kwargs)


def ANI1e(lot: str = "wb97x-631gd", **kwargs) -> ANIDataset:
    return builtin_dataset("ANI1e", lot, **kwargs)


def ANI1q(lot: str = "wb97x-631gd", **kwargs) -> ANIDataset:
    return builtin_dataset("ANI1q", lot, **kwargs)


def ANI2qHeavy(lot: str = "wb97x-631gd", **kwargs) -> ANIDataset:
    return builtin_dataset("ANI2qHeavy", lot, **kwargs)


def COMP6v2(lot: str = "wb97x-631gd", **kwargs) -> ANIDataset:
    return builtin_dataset("COMP6v2", lot, **kwargs)


def IonsLight(lot: str = "wb97x-631gd", **kwargs) -> ANIDataset:
    return builtin_dataset("IonsLight", lot, **kwargs)


def IonsHeavy(lot: str = "wb97x-631gd", **kwargs) -> ANIDataset:
    return builtin_dataset("IonsHeavy", lot, **kwargs)


def IonsVeryHeavy(lot: str = "wb97x-631gd", **kwargs) -> ANIDataset:
    return builtin_dataset("IonsVeryHeavy", lot, **kwargs)


def TestDataForcesDipoles(
    root: tp.Optional[Path] = None,
    num_conformers: int = 64,
    seed: int = 1234,
) -> ANIDataset:
    """Synthetic local dataset carrying forces and dipoles."""
    root = Path(root) if root is not None else datasets_dir()
    path = root / f"test-data-fd-{num_conformers}-{seed}.h5"
    if path.exists():
        return ANIDataset(path)
    rng = np.random.RandomState(seed)
    ds = ANIDataset(path)
    for gi, max_atoms in enumerate((5, 8)):
        n = num_conformers // 2 + (gi == 0) * (num_conformers % 2)
        species = rng.choice([1, 6, 7, 8], size=(n, max_atoms))
        ds.append_conformers(
            f"group{gi}",
            {
                "species": species,
                "coordinates": (rng.rand(n, max_atoms, 3) * 4).astype(np.float32),
                "energies": (rng.randn(n) - 40).astype(np.float64),
                "forces": rng.randn(n, max_atoms, 3).astype(np.float32) * 0.01,
                "dipoles": rng.randn(n, 3).astype(np.float32) * 0.1,
            },
        )
    return ds


def TestDataIons(
    root: tp.Optional[Path] = None,
    num_conformers: int = 48,
    seed: int = 1234,
) -> ANIDataset:
    """Synthetic local dataset with net charges."""
    root = Path(root) if root is not None else datasets_dir()
    path = root / f"test-data-ions-{num_conformers}-{seed}.h5"
    if path.exists():
        return ANIDataset(path)
    rng = np.random.RandomState(seed)
    ds = ANIDataset(path)
    for gi, max_atoms in enumerate((4, 7)):
        n = num_conformers // 2 + (gi == 0) * (num_conformers % 2)
        species = rng.choice([1, 6, 7, 8], size=(n, max_atoms))
        ds.append_conformers(
            f"group{gi}",
            {
                "species": species,
                "coordinates": (rng.rand(n, max_atoms, 3) * 4).astype(np.float32),
                "energies": (rng.randn(n) - 40).astype(np.float64),
                "charges": rng.choice([-1, 0, 1], size=(n,)).astype(np.int64),
            },
        )
    return ds
