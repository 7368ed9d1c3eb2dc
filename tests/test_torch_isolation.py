"""PyTorch port: it imports no JAX and loads no file of the JAX package,
never falls back to the CPU on its own, and keeps TF32 off."""

import ast
import pathlib
import re

import numpy as np
import pytest
import torch

import torchani_tpu_torch
from torchani_tpu_torch import csrc, models
from torchani_tpu_torch.aev import AEVComputer
from torchani_tpu_torch.aev.terms import ANIRadial, Radial
from torchani_tpu_torch.arch import simple_ani, simple_aniq
from torchani_tpu_torch.electro import ChargeNormalizer, DipoleComputer
from torchani_tpu_torch.interop import load_jax_md_state
from torchani_tpu_torch.md import CachedSinglePoint, MolecularDynamics, MultipleTimestepMD
from torchani_tpu_torch.neb import neb_path
from torchani_tpu_torch.neurochem import (
    load_atomic_network,
    load_ensemble,
    load_model_from_info,
    load_sae,
    modules_from_info_file,
)
from torchani_tpu_torch.observables import mean_squared_displacement, radial_distribution
from torchani_tpu_torch.optimize import minimize_fire, minimize_fire_batched
from torchani_tpu_torch.parallel import ShardedMolecularDynamics
from torchani_tpu_torch.replica import ReplicaExchange
from torchani_tpu_torch.nn import ANISharedNetworks, AtomicEmbedding, AtomicNetwork, SingleNN
from torchani_tpu_torch.potentials import (
    FixedCoulomb,
    FixedMNOK,
    LennardJones,
    RepulsionXTB,
    RepulsionZBL,
    TwoBodyDispersionD3,
)
from torchani_tpu_torch.sae import SelfEnergy
from torchani_tpu_torch.testing import make_elem_idxs, make_molec, make_neighbors, make_tensor
from torchani_tpu_torch.transforms import SubtractRepulsionXTB, SubtractSAE
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
        "potentials/dispersion.py", "convert.py", "paths.py", "observables.py",
        "optimize.py", "neb.py", "replica.py", "io.py", "cli.py", "__main__.py", "ase.py",
        "electro.py", "nn/shared.py", "potentials/nnp_charges.py", "potentials/lj.py",
        "potentials/fixed_coulomb.py", "potentials/utils.py", "nn/core.py", "nn/partition.py",
        "testing.py", "tuples.py", "utils.py", "cutoffs.py", "aev/terms.py", "neighbors.py",
        "datasets/__init__.py", "datasets/backends.py", "datasets/anidataset.py",
        "datasets/batching.py", "datasets/builtin.py", "datasets/filters.py",
        "transforms.py", "sae_estimation.py", "training/__init__.py", "training/loop.py",
        "training/checkpoints.py", "training/metrics.py", "training/schedules.py",
        "neurochem.py", "legacy_data.py", "parallel/__init__.py", "parallel/md.py",
        "parallel/sharding.py",
    ):
        assert f"torchani_tpu_torch/{module}" in names


#: calls that open or load a file by its path
_LOADERS = {"open", "Path", "PurePath", "CDLL", "PyDLL", "LoadLibrary", "load_library"}
_JAX_PACKAGE_PATH = re.compile(r"(^|[/\\])torchani_tpu([/\\]|$)")


def _call_name(func) -> str:
    return func.id if isinstance(func, ast.Name) else getattr(func, "attr", "")


def _jax_package_paths(source: str):
    """String constants naming a path under ``torchani_tpu/`` inside a call
    that opens or loads a file, or inside a path joined with ``/``."""
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Call) and _call_name(node.func) in _LOADERS:
            parts = node.args + [k.value for k in node.keywords]
        elif isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div):
            parts = [node.left, node.right]
        else:
            continue
        for part in parts:
            for leaf in ast.walk(part):
                if isinstance(leaf, ast.Constant) and isinstance(leaf.value, str):
                    if _JAX_PACKAGE_PATH.search(leaf.value):
                        yield leaf.value


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_package_files_loaded(path):
    assert list(_jax_package_paths(path.read_text())) == []


@pytest.mark.parametrize("source", [
    'ctypes.CDLL("torchani_tpu/csrc/libxyzparse.so")',
    'lib = ctypes.cdll.LoadLibrary(str(REPO / "torchani_tpu" / "csrc" / "x.so"))',
    'open(Path(__file__).parent.parent / "torchani_tpu/csrc/xyzparse.cpp")',
])
def test_jax_package_path_check_finds_a_load(source):
    assert list(_jax_package_paths(source))


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_imports(path):
    for name in _imported_modules(path):
        root = name.split(".")[0]
        assert root not in FORBIDDEN, f"{path.name} imports {name}"


def test_data_and_training_load_no_jax():
    """Importing the data and training stacks, the NeuroChem loaders, the
    legacy data pipeline, the profiling module and `parallel` (in a fresh
    interpreter) loads neither JAX nor any module of the JAX package."""
    import subprocess
    import sys

    code = (
        "import sys; import torchani_tpu_torch.datasets, torchani_tpu_torch.training, "
        "torchani_tpu_torch.transforms, torchani_tpu_torch.sae_estimation, torchani_tpu_torch.cli, "
        "torchani_tpu_torch.neurochem, torchani_tpu_torch.legacy_data, torchani_tpu_torch.profiling, "
        "torchani_tpu_torch.parallel; "
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'torchani_tpu')); print(bad)"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, check=True).stdout
    assert out.strip() == "[]"


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
        lambda: ReplicaExchange(models.ANI2x(model_index=0, device="cpu"), WATER, (300.0, 310.0)),
        lambda: minimize_fire(lambda c: c.sum(), np.zeros((2, 3))),
        lambda: minimize_fire_batched(lambda c: c.sum((1, 2)), np.zeros((2, 2, 3))),
        lambda: neb_path(lambda c: c.sum((1, 2)), np.zeros((3, 1, 3))),
        lambda: radial_distribution(np.zeros((1, 2, 3)), None, 1.0),
        lambda: mean_squared_displacement(np.zeros((2, 2, 3))),
        lambda: models.ANImbis(),
        lambda: models.ANIr2s("chcl3"),
        lambda: models.ANIr2s_water(),
        lambda: models.SnnANI2xr(model_index=0),
        lambda: simple_aniq(("H", "O"), merge_charge_networks=True),
        lambda: simple_ani(("H", "O"), container="ANISharedNetworks", ensemble_size=2),
        lambda: SingleNN.large(("H", "O"), 16),
        lambda: ANISharedNetworks.build(("H", "O"), 16),
        lambda: ChargeNormalizer.from_electronegativity_and_hardness(("H", "O")),
        lambda: DipoleComputer(masses=(0.0, 1.008)),
        lambda: LennardJones.ff19SB(("H", "O"), cutoff=8.0),
        lambda: FixedCoulomb(("H", "O"), (0.4, -0.8)),
        lambda: FixedMNOK(("H", "O"), (0.4, -0.8), (12.8, 12.2)),
        lambda: Radial.make(5.2),
        lambda: AtomicNetwork.make((4, 1)),
        lambda: AtomicEmbedding.make(("H", "O")),
        lambda: make_tensor((2,)),
        lambda: make_elem_idxs(1, 2),
        lambda: make_molec(3),
        lambda: make_neighbors(3),
        lambda: SubtractSAE(("H",), [0.5]),
        lambda: SubtractRepulsionXTB(("H", "O")),
        lambda: load_sae(__file__),
        lambda: load_atomic_network(__file__),
        lambda: load_model_from_info(__file__),
        lambda: modules_from_info_file(__file__),
        lambda: load_ensemble(("H",), "train", 1),
        lambda: ShardedMolecularDynamics(models.ANI2x(model_index=0, device="cpu"), WATER, None),
    ],
    ids=[
        "ANI2x", "ANI2x-cuda", "ANI2dr", "ANI2xr", "ANI1x", "ANI1ccx", "simple_ani", "RepulsionXTB", "RepulsionZBL",
        "TwoBodyDispersionD3", "AEVComputer", "ANIRadial", "SelfEnergy", "resolve_device",
        "MolecularDynamics", "CachedSinglePoint", "MultipleTimestepMD", "load_jax_md_state",
        "ReplicaExchange", "minimize_fire", "minimize_fire_batched", "neb_path",
        "radial_distribution", "mean_squared_displacement", "ANImbis", "ANIr2s",
        "ANIr2s_water", "SnnANI2xr", "simple_aniq", "simple_ani-shared", "SingleNN",
        "ANISharedNetworks", "ChargeNormalizer", "DipoleComputer", "LennardJones",
        "FixedCoulomb", "FixedMNOK", "Radial", "AtomicNetwork", "AtomicEmbedding",
        "make_tensor", "make_elem_idxs", "make_molec", "make_neighbors", "SubtractSAE",
        "SubtractRepulsionXTB", "load_sae", "load_atomic_network", "load_model_from_info",
        "modules_from_info_file", "load_ensemble", "ShardedMolecularDynamics",
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
        "angular_aev", "bucket_select", "vals_select", "packed_select", "radial_aev"
    }
    flags = " ".join(csrc.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast-math" not in flags and "fast_math" not in flags
