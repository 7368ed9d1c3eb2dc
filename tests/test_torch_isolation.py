"""PyTorch port: it imports no JAX, never falls back to the CPU on its own,
and keeps TF32 off."""

import ast
import pathlib

import numpy as np
import pytest
import torch

import torchani_tpu_torch
from torchani_tpu_torch import csrc, models
from torchani_tpu_torch.aev import AEVComputer
from torchani_tpu_torch.aev.terms import ANIRadial
from torchani_tpu_torch.sae import SelfEnergy
from torchani_tpu_torch.utils import resolve_device

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "torchani_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "torchani_tpu")


def _imported_modules(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_imports(path):
    for name in _imported_modules(path):
        root = name.split(".")[0]
        assert root not in FORBIDDEN, f"{path.name} imports {name}"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize(
    "entry",
    [
        lambda: models.ANI2x(),
        lambda: models.ANI2x(seed=1, device="cuda"),
        lambda: AEVComputer.like_2x(),
        lambda: ANIRadial.like_2x(),
        lambda: SelfEnergy(("H",), [0.5]),
        lambda: resolve_device("cuda"),
    ],
    ids=["ANI2x", "ANI2x-cuda", "AEVComputer", "ANIRadial", "SelfEnergy", "resolve_device"],
)
def test_default_device_raises_without_cuda(no_cuda, entry):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()


def test_cpu_when_asked(no_cuda):
    assert resolve_device("cpu") == torch.device("cpu")
    model = models.ANI2x(device="cpu")
    assert model.device == torch.device("cpu")
    e = model(np.array([[8, 1, 1]]), np.array([[[0, 0, 0.12], [0, 0.76, -0.48], [0, -0.76, -0.48]]]))
    assert e.shape == (1,) and torch.isfinite(e).all()


def test_tf32_is_off():
    assert torchani_tpu_torch is not None
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_kernel_build_settings():
    assert "angular_aev" in csrc.sources()
    flags = " ".join(csrc.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast-math" not in flags and "fast_math" not in flags
