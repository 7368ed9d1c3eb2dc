"""Filesystem locations of the port's bundled resources and kernel builds."""

import os
from pathlib import Path


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
