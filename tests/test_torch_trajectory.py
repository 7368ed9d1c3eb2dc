"""PyTorch port: `MolecularDynamics.trajectory` against the JAX package's, on
the CPU.

The 30-atom water box of ``tests/test_md.py``'s trajectory test under a
one-member `simple_ani` model whose weights come through
`torchani_tpu_torch.interop`, from the JAX state (`load_jax_md_state`): 20
steps recorded every 5 under NVE, the Nose-Hoover chain and Berendsen NPT.
Frames: coordinates atol 1e-4 A, energies, temperatures and scales rtol 1e-5
(f32 sums over the atoms in another order along a short trajectory).
"""

import jax
import numpy as np
import pytest
import torch

import torchani_tpu as tt
from torchani_tpu.md import MolecularDynamics as JMolecularDynamics
from torchani_tpu_torch.arch import simple_ani
from torchani_tpu_torch.interop import load_jax_arrays, load_jax_md_state
from torchani_tpu_torch.md import MolecularDynamics, MultipleTimestepMD
from torchani_tpu_torch.testing import make_water_box

torch.set_num_threads(2)
CPU = "cpu"
STEPS, EVERY = 20, 5
ENSEMBLES = [
    ("nve", {}),
    ("nvt-nhc", {"temperature": 200.0, "tau_fs": 20.0}),
    ("npt", {"temperature": 200.0, "pressure_bar": 1.0}),
]


def _leaves(tree):
    return {
        jax.tree_util.keystr(p): np.asarray(x)
        for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


def _md_kw(ensemble):
    return dict(pbc=True, timestep_fs=0.5, skin=0.6,
                npt_compression=0.1 if ensemble == "npt" else 0.0)


@pytest.fixture(scope="module")
def both_models():
    jmodel = tt.simple_ani(("H", "C", "N", "O"), ensemble_size=1)
    pmodel = simple_ani(("H", "C", "N", "O"), ensemble_size=1, device=CPU)
    return jmodel, load_jax_arrays(pmodel, _leaves(jmodel))


@pytest.fixture(scope="module")
def box():
    return make_water_box(30)


@pytest.mark.parametrize("ensemble,params", ENSEMBLES, ids=[e for e, _ in ENSEMBLES])
def test_trajectory_matches_jax(both_models, box, ensemble, params):
    jmodel, pmodel = both_models
    species, coords, cell = box
    jmd = JMolecularDynamics(jmodel, species, cell=cell, nn_precision="highest", **_md_kw(ensemble))
    jstart = jmd.init(coords, temperature=200.0, key=jax.random.PRNGKey(7))
    jend, jtraj = jmd.trajectory(jstart, STEPS, record_every=EVERY, ensemble=ensemble, **params)
    md = MolecularDynamics(pmodel, species, cell=cell, device=CPU, **_md_kw(ensemble))
    start = load_jax_md_state(_leaves(jstart), CPU)
    end, traj = md.trajectory(start, STEPS, record_every=EVERY, ensemble=ensemble, **params)

    keys = {"coords", "energies", "temperatures"} | ({"scales"} if ensemble == "npt" else set())
    assert set(traj) == set(jtraj) == keys
    frames = STEPS // EVERY
    assert traj["coords"].shape == (frames,) + tuple(end.coords.shape)
    assert end.step == int(jend.step) == STEPS
    np.testing.assert_allclose(traj["coords"].numpy(), np.asarray(jtraj["coords"]), atol=1e-4, rtol=0)
    for k in keys - {"coords"}:
        assert traj[k].shape == (frames,)
        np.testing.assert_allclose(traj[k].numpy(), np.asarray(jtraj[k]), rtol=1e-5)
    # the last frame is the final state, to the bit
    assert torch.equal(traj["coords"][-1], end.coords)
    assert float(traj["energies"][-1]) == float(end.energy)
    if ensemble == "nvt-nhc":
        assert end.nhc.shape == (2, 3)
        np.testing.assert_allclose(end.nhc.numpy(), np.asarray(jend.nhc), rtol=1e-5, atol=1e-12)
    if ensemble == "npt":
        assert float(traj["scales"][-1]) == float(end.scale)


def test_temperature_counts_real_atoms(both_models, box):
    """The frames' temperature divides by 3 n_real, not 3 A: a dummy (-1)
    atom changes nothing."""
    _, pmodel = both_models
    species, coords, cell = box
    v = (np.random.RandomState(3).randn(30, 3) * 0.004).astype(np.float32)
    temps = []
    for pad in (False, True):
        sp, co, vel = species, coords, v
        if pad:
            sp = np.concatenate([species, [[-1]]], axis=1)
            co = np.concatenate([coords, np.zeros((1, 1, 3), np.float32)], axis=1)
            vel = np.concatenate([v, np.zeros((1, 3), np.float32)])
        md = MolecularDynamics(pmodel, sp, cell=cell, device=CPU, **_md_kw("nve"))
        st = md.init(co).replace(velocities=torch.as_tensor(vel))
        if pad:
            assert md._n_real == species.shape[1]
        _, traj = md.trajectory(st, 2, record_every=1)
        temps.append(traj["temperatures"])
    np.testing.assert_allclose(temps[1].numpy(), temps[0].numpy(), rtol=1e-5)


def test_nvt_shapes_and_determinism(both_models, box):
    _, pmodel = both_models
    species, coords, cell = box
    md = MolecularDynamics(pmodel, species, cell=cell, device=CPU, **_md_kw("nvt"))
    runs = []
    for _ in range(2):
        st = md.init(coords, temperature=200.0, generator=torch.Generator().manual_seed(11))
        runs.append(md.trajectory(st, 10, record_every=5, ensemble="nvt", temperature=200.0))
    (end, traj), (end2, traj2) = runs
    assert traj["coords"].shape == (2, 30, 3) and "scales" not in traj
    assert torch.isfinite(traj["energies"]).all() and torch.isfinite(traj["temperatures"]).all()
    for k in traj:
        assert torch.equal(traj[k], traj2[k])
    assert torch.equal(end.coords, end2.coords) and end.step == 10


def test_trajectory_rejects_bad_args(both_models, box):
    """The errors of ``tests/test_md.py:test_trajectory_rejects_bad_args``,
    and NPT without a cell."""
    _, pmodel = both_models
    species, coords, cell = box
    md = MolecularDynamics(pmodel, species, cell=cell, device=CPU, pbc=True)
    st = md.init(coords)
    with pytest.raises(ValueError, match="multiple of record_every"):
        md.trajectory(st, 21, record_every=5)
    with pytest.raises(TypeError, match="unused nvt parameters"):
        md.trajectory(st, 20, record_every=5, ensemble="nvt", temperature=100.0, bogus=1)
    with pytest.raises(ValueError, match="unknown ensemble"):
        md.trajectory(st, 20, record_every=5, ensemble="nosuch")
    free = MolecularDynamics(pmodel, species, device=CPU)
    with pytest.raises(ValueError, match="periodic cell"):
        free.trajectory(free.init(coords), 5, record_every=5, ensemble="npt", temperature=300.0)


def test_mts_keeps_refusing_npt_and_nhc():
    model = simple_ani(("H", "O"), dispersion=True, device=CPU)
    mts = MultipleTimestepMD(model, np.array([[8, 1, 1]]), every=2, device=CPU)
    st = mts.init(np.array([[0.0, 0.0, 0.119], [0.0, 0.763, -0.477], [0.0, -0.763, -0.477]]))
    for ensemble in ("npt", "nvt-nhc"):
        with pytest.raises(ValueError, match="not supported under MTS"):
            mts.run(st, 2, ensemble=ensemble, temperature=300.0)
    assert mts.run(st, 2, ensemble="nvt", temperature=300.0).step == 2
