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
from torchani_tpu_torch.arch import simple_ani
from torchani_tpu_torch.interop import load_jax_md_state
from torchani_tpu_torch.md import CachedSinglePoint, MolecularDynamics, MultipleTimestepMD
from torchani_tpu_torch.potentials import RepulsionXTB, RepulsionZBL, TwoBodyDispersionD3
from torchani_tpu_torch.sae import SelfEnergy
from torchani_tpu_torch.utils import resolve_device

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "torchani_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "torchani_tpu")
WATER = np.array([[8, 1, 1]])


def _imported_modules(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_new_modules_are_covered():
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    for module in (
        "md.py", "bucket_refresh.py", "interop.py", "profiling.py",
        "bucket_refresh_packed.py", "potentials/core.py", "potentials/repulsion.py",
        "potentials/dispersion.py", "convert.py", "paths.py",
    ):
        assert f"torchani_tpu_torch/{module}" in names


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
        lambda: models.ANI2dr(),
        lambda: models.ANI2xr(model_index=0),
        lambda: models.ANI1x(),
        lambda: models.ANI1ccx(model_index=0),
        lambda: simple_ani(("H", "O"), dispersion=True),
        lambda: RepulsionXTB(("H", "O")),
        lambda: RepulsionZBL(("H", "O")),
        lambda: TwoBodyDispersionD3(("H", "O"), functional="b973c"),
        lambda: AEVComputer.like_2x(),
        lambda: ANIRadial.like_2x(),
        lambda: SelfEnergy(("H",), [0.5]),
        lambda: resolve_device("cuda"),
        lambda: MolecularDynamics(models.ANI2x(model_index=0, device="cpu"), WATER),
        lambda: CachedSinglePoint(models.ANI2x(model_index=0, device="cpu"), WATER),
        lambda: MultipleTimestepMD(simple_ani(("H", "O"), dispersion=True, device="cpu"), WATER),
        lambda: load_jax_md_state({}),
    ],
    ids=[
        "ANI2x", "ANI2x-cuda", "ANI2dr", "ANI2xr", "ANI1x", "ANI1ccx", "simple_ani", "RepulsionXTB", "RepulsionZBL",
        "TwoBodyDispersionD3", "AEVComputer", "ANIRadial", "SelfEnergy", "resolve_device",
        "MolecularDynamics", "CachedSinglePoint", "MultipleTimestepMD", "load_jax_md_state",
    ],
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


def test_md_wants_the_models_device():
    """A CPU model under `MolecularDynamics` that was not asked for the CPU is refused,
    not moved."""
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="model is on"):
            MolecularDynamics(models.ANI2x(model_index=0, device="cpu"), WATER)
    md = MolecularDynamics(models.ANI2x(model_index=0, device="cpu"), WATER, device="cpu")
    assert md.device == torch.device("cpu")


def test_kernel_build_settings():
    assert set(csrc.sources()) == {
        "angular_aev", "bucket_select", "vals_select", "packed_select"
    }
    flags = " ".join(csrc.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast-math" not in flags and "fast_math" not in flags
