"""Filesystem locations of the port's bundled resources, kernel builds and
user data (counterpart of ``torchani_tpu/paths.py``)."""

import os
import typing as tp
from pathlib import Path

_data_dir_override: tp.Optional[Path] = None


def resources_dir() -> Path:
    """Directory holding the bundled physical-constant JSON files."""
    return Path(__file__).resolve().parent / "resources"


def csrc_dir() -> Path:
    """Directory holding the CUDA C++ kernel sources."""
    return Path(__file__).resolve().parent / "csrc"


def kernel_build_dir() -> Path:
    """Where compiled kernel libraries go.

    ``TORCHANI_TPU_TORCH_BUILD_DIR`` overrides the default, which is
    ``build/torch_kernels`` beside the package (inside the checkout).
    """
    env = os.getenv("TORCHANI_TPU_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parent.parent / "build" / "torch_kernels"


def set_data_dir(path: tp.Union[str, Path, None]) -> None:
    """Override the data root for this process; ``None`` restores the
    default resolution (environment, then ``~/.local/share``)."""
    global _data_dir_override
    _data_dir_override = None if path is None else Path(path)


def data_dir() -> Path:
    """Root directory for user data (state dicts, datasets, model files).

    Resolution order: the `set_data_dir` override, ``TORCHANI_TPU_DATA_DIR``,
    ``TORCHANI_DATA_DIR``, then ``~/.local/share/TorchaniTPU``.
    """
    if _data_dir_override is not None:
        d = _data_dir_override
    else:
        env = os.getenv("TORCHANI_TPU_DATA_DIR") or os.getenv("TORCHANI_DATA_DIR")
        d = Path(env) if env else Path.home() / ".local" / "share" / "TorchaniTPU"
    d.mkdir(parents=True, exist_ok=True)
    return d


def _subdir(name: str) -> Path:
    d = data_dir() / name
    d.mkdir(parents=True, exist_ok=True)
    return d


def neurochem_dir() -> Path:
    """Directory for NeuroChem-format model files."""
    return _subdir("Neurochem")


def datasets_dir() -> Path:
    """Directory for datasets."""
    return _subdir("Datasets")


def custom_models_dir() -> Path:
    """Directory for user-defined model factories, one ``<Name>/model.py``
    each (the JAX package's layout)."""
    return _subdir("CustomModels")


def state_dicts_dir() -> Path:
    """Where ``models.*(pretrained=True)`` looks for ``{name}_state_dict.npz``
    or ``.pt``."""
    return _subdir("StateDicts")
