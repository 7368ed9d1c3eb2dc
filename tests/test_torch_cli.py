"""PyTorch port: the command line interface against the JAX package's, on the
CPU.

Both CLIs' `_build_model` return one-member `simple_ani` models with the same
weights (bridged through `torchani_tpu_torch.interop`): ``sp -f``'s JSON
holds the JAX model's energies and forces of the file (energies rtol 1e-6,
forces atol 1e-5 Ha/A; from `torchani_tpu.grad.energies_and_forces` under
``jax.jit``, which compiles in a fraction of the time that the JAX CLI's
op-by-op call takes); ``opt`` writes the
same relaxed geometries (atol 1e-4 A) for one conformer and for a file whose
conformers have 3 and 4 atoms (padded batch).  ``md --traj`` records its
frames through `MolecularDynamics.trajectory`, ``md --mts`` runs RESPA; an
unknown model exits, and without ``--device cpu`` a machine with no CUDA
device is refused.  The JAX CLI reads its files through the JAX package's
native parser as `test_torch_io.jax_parser` hands it out (built in this
process's own directory), never through a build in the JAX package's.
"""

import json

import jax
import numpy as np
import pytest
import torch

import torchani_tpu as tt
from torchani_tpu import cli as jcli
from torchani_tpu import grad as jgrad
from torchani_tpu_torch import cli
from torchani_tpu_torch.arch import simple_ani
from torchani_tpu_torch.interop import load_jax_arrays
from torchani_tpu_torch.io import read_xyz, write_xyz
from test_torch_io import jax_parser, jax_parser_lib  # noqa: F401  (JAX's CLI reads xyz)

torch.set_num_threads(2)
WATER = np.array([[0.0, 0.0, 0.119], [0.0, 0.763, -0.477], [0.0, -0.763, -0.477]], np.float32)


def _leaves(tree):
    return {
        jax.tree_util.keystr(p): np.asarray(x)
        for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


@pytest.fixture(scope="module")
def bridged():
    jmodel = tt.simple_ani(("H", "C", "N", "O"), ensemble_size=1)
    pmodel = simple_ani(("H", "C", "N", "O"), ensemble_size=1, device="cpu")
    return jmodel, load_jax_arrays(pmodel, _leaves(jmodel))


@pytest.fixture
def both_clis(bridged, monkeypatch):
    jmodel, pmodel = bridged
    monkeypatch.setattr(jcli, "_build_model", lambda name, member: jmodel)
    monkeypatch.setattr(cli, "_build_model", lambda name, member, device: pmodel)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    write_xyz(np.array([[8, 1, 1]]), WATER[None] * 1.04, d / "water.xyz")
    rng = np.random.RandomState(0)
    sp = np.array([[8, 1, 1, -1], [6, 1, 1, 8]])
    co = np.zeros((2, 4, 3), np.float32)
    co[0, :3] = WATER * 1.05
    co[1] = [[0.0, 0.0, 0.0], [1.15, 0.0, 0.0], [-0.4, 1.05, 0.0], [0.0, -0.6, 1.15]]
    co += 0.01 * rng.randn(2, 4, 3).astype(np.float32) * (sp >= 0)[..., None]
    write_xyz(sp, co, d / "padded.xyz")
    return d


def test_sp_matches_jax(bridged, both_clis, files, tmp_path):
    cli.main(["sp", str(files / "padded.xyz"), "-f", "-o", str(tmp_path / "port.json"),
              "--device", "cpu"])
    ours = json.loads((tmp_path / "port.json").read_text())
    species, coords, _, _ = read_xyz(files / "padded.xyz")
    e, f = jax.jit(lambda s, c: jgrad.energies_and_forces(bridged[0], s, c))(species, coords)
    assert set(ours) == {"energies", "forces"}
    np.testing.assert_allclose(ours["energies"], np.asarray(e), rtol=1e-6)
    np.testing.assert_allclose(ours["forces"], np.asarray(f), atol=1e-5)
    assert np.asarray(ours["forces"]).shape == (2, 4, 3)


@pytest.mark.parametrize("name", ["water", "padded"])
def test_opt_matches_jax(both_clis, files, tmp_path, capsys, name):
    args = ["opt", str(files / f"{name}.xyz"), "-n", "15", "--fmax", "1e-9"]
    jcli.main(args + ["-o", str(tmp_path / "jax.xyz")])
    jax_out = capsys.readouterr().out
    cli.main(args + ["-o", str(tmp_path / "port.xyz"), "--device", "cpu"])
    port_out = capsys.readouterr().out
    ours, theirs = read_xyz(tmp_path / "port.xyz"), read_xyz(tmp_path / "jax.xyz")
    np.testing.assert_array_equal(ours[0], theirs[0])
    np.testing.assert_allclose(ours[1], theirs[1], atol=1e-4, rtol=0)
    # the same report, line for line, up to the digits of E and fmax
    assert [line.split(" E=")[0] for line in port_out.splitlines()] == [
        line.split(" E=")[0] for line in jax_out.splitlines()
    ]
    assert "steps=15" in port_out
    if name == "padded":
        assert "[1] converged=False" in port_out and ours[0][0, 3] == -1


def test_md_traj(both_clis, files, tmp_path, capsys):
    traj = tmp_path / "traj.xyz"
    cli.main([
        "md", str(files / "water.xyz"), "-n", "20", "--timestep", "0.2", "--temperature", "100",
        "--nvt-nhc", "--traj", str(traj), "--record-every", "5", "--device", "cpu",
        "-o", str(tmp_path / "last.xyz"),
    ])
    out = capsys.readouterr().out
    assert "T =" in out and "wrote 4 frames" in out
    species, coords, _, _ = read_xyz(traj)
    assert coords.shape == (4, 3, 3) and np.isfinite(coords).all()
    np.testing.assert_array_equal(read_xyz(tmp_path / "last.xyz")[1][0], coords[-1])


def test_md_mts(files, capsys):
    """The real `_build_model`: a dispersion-bearing model, RESPA every 2."""
    cli.main([
        "md", str(files / "water.xyz"), "-m", "simple-dr", "-n", "8", "--timestep", "0.25",
        "--temperature", "50", "--mts", "2", "--device", "cpu",
    ])
    out = capsys.readouterr().out
    assert "T =" in out and "step        8" in out


def test_unknown_model_errors(files):
    with pytest.raises(SystemExit):
        cli.main(["sp", str(files / "water.xyz"), "-m", "nope", "--device", "cpu"])


def test_cuda_by_default(files, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["sp", str(files / "water.xyz"), "-m", "simple"])
