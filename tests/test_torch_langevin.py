"""PyTorch port: Langevin dynamics (BAOAB, `MolecularDynamics.step_langevin`)
against the JAX package's, on the CPU.

The system is the 30-atom water box of `tests/test_md.py` (and, for the bucket
refresh, 150 atoms at low density) under a one-member `simple_ani` model
whose weights come through `torchani_tpu_torch.interop` (timestep 0.5 fs,
skin 1.0 A).  One step from the JAX state, with JAX's own
normal draw fed to the port's O step: coordinates atol 1e-5 A, forces atol
1e-5 Ha/A, velocities rtol 1e-5 plus the half kick of that force tolerance
(0.5 dt 1e-5 ACCEL_UNIT / m, 6.5e-7 A/fs for H): the port rounds the drift
once where JAX rounds each half drift, so positions may differ by an ulp.  Friction 0 against NVE
over 10 steps: equal to the bit (BAOAB without friction is velocity Verlet,
and the port adds its two half drifts in one rounding).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchani_tpu as tt
from torchani_tpu.md import MolecularDynamics as JMolecularDynamics
from torchani_tpu_torch.arch import simple_ani
from torchani_tpu_torch.interop import load_jax_arrays, load_jax_md_state
from torchani_tpu_torch.md import (
    ACCEL_UNIT,
    MolecularDynamics,
    kinetic_temperature,
    langevin_o_step,
)
from torchani_tpu_torch.testing import make_water_box

torch.set_num_threads(2)
CPU = "cpu"
MD_KW = dict(pbc=True, timestep_fs=0.5, skin=1.0)


def _leaves(tree):
    return {
        jax.tree_util.keystr(p): np.asarray(x)
        for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


@pytest.fixture(scope="module")
def both_models():
    jmodel = tt.simple_ani(("H", "C", "N", "O"), ensemble_size=1)
    pmodel = simple_ani(("H", "C", "N", "O"), ensemble_size=1, device=CPU)
    return jmodel, load_jax_arrays(pmodel, _leaves(jmodel))


@pytest.fixture(scope="module")
def box():
    return make_water_box(30)


@pytest.fixture(scope="module")
def port_md(both_models, box):
    species, _, cell = box
    return MolecularDynamics(both_models[1], species, cell=cell, device=CPU, **MD_KW)


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("refresh", ["gather", "bucket"])
def test_one_step_matches_jax_under_the_same_noise(refresh, both_models, box, port_md):
    """On the 30-atom box (gather refresh), and on 150 atoms at low density
    (20 A, a 3 x 3 x 3 grid: the bucket refresh)."""
    jmodel, pmodel = both_models
    species, coords, cell = box
    if refresh == "bucket":
        species, coords, cell = make_water_box(150, density_molec_per_a3=0.008)
        port_md = MolecularDynamics(pmodel, species, cell=cell, device=CPU, **MD_KW)
    jmd = JMolecularDynamics(jmodel, species, cell=cell, nn_precision="highest", **MD_KW)
    jstart = jmd.init(coords, temperature=300.0, key=jax.random.PRNGKey(1))
    jend = jmd.run_langevin(jstart, 1, temperature=300.0, friction_per_fs=0.05)
    # the draw of JAX's step: the state's key split once
    _, nkey = jax.random.split(jstart.key)
    noise = np.asarray(jax.random.normal(nkey, jstart.velocities.shape))
    start = load_jax_md_state(_leaves(jstart), CPU)
    assert (start.bucket is not None) == (refresh == "bucket")
    with pytest.raises(ValueError, match="no generator"):
        port_md.step_langevin(start, 300.0, 0.05)
    end = port_md.step_langevin(start, 300.0, 0.05, noise=torch.from_numpy(noise.copy()))
    assert end.step == int(jend.step) == 1
    np.testing.assert_allclose(end.coords.numpy(), np.asarray(jend.coords), atol=1e-5, rtol=0)
    # the port rounds the drift once where JAX rounds each half drift, so
    # positions differ by an ulp and so do the forces of the last half kick:
    # velocities within rtol 1e-5 plus that kick of the force tolerance
    kick_atol = 0.5 * MD_KW["timestep_fs"] * 1e-5 * float((ACCEL_UNIT / port_md.masses).max())
    np.testing.assert_allclose(
        end.velocities.numpy(), np.asarray(jend.velocities), rtol=1e-5, atol=kick_atol
    )
    np.testing.assert_allclose(end.forces.numpy(), np.asarray(jend.forces), atol=1e-5, rtol=0)


def test_o_step_matches_jax_formula():
    rng = np.random.RandomState(0)
    v = rng.randn(7, 3).astype(np.float32) * 0.01
    m = rng.uniform(1.0, 35.0, 7).astype(np.float32)
    noise = rng.randn(7, 3).astype(np.float32)
    out = langevin_o_step(
        torch.as_tensor(v), torch.as_tensor(m), 0.5, 300.0, 0.1, torch.as_tensor(noise)
    )
    c1 = np.exp(-0.1 * 0.5)
    sigma = jnp.sqrt((1 - c1**2) * tt.md.KB_HARTREE * 300.0 / jnp.asarray(m))[:, None]
    ref = c1 * jnp.asarray(v) + sigma * np.sqrt(tt.md.ACCEL_UNIT) * jnp.asarray(noise)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-9)


def test_the_seed_sets_the_run(port_md, box):
    _, coords, _ = box

    def run(seed):
        start = port_md.init(coords, temperature=300.0, generator=_gen(seed))
        return port_md.run_langevin(start, 5, temperature=300.0, friction_per_fs=0.05)

    a, b, c = run(4), run(4), run(5)
    assert torch.equal(a.coords, b.coords) and torch.equal(a.velocities, b.velocities)
    assert not torch.equal(a.coords, c.coords)
    assert a.step == 5


def test_langevin_thermalizes(port_md, box):
    """`tests/test_md.py::test_langevin_thermalizes`, on the port."""
    _, coords, _ = box
    state = port_md.init(coords, temperature=300.0, generator=_gen(1))
    state = port_md.run_langevin(state, 30, temperature=300.0, friction_per_fs=0.05)
    temp = float(kinetic_temperature(state.velocities, port_md.masses))
    assert 30.0 < temp < 3000.0
    assert np.isfinite(float(state.energy))
    assert not bool(state.overflow)


def test_zero_friction_is_nve(port_md, box):
    _, coords, _ = box
    start = port_md.init(coords, temperature=300.0, generator=_gen(2))
    langevin = port_md.run_langevin(start, 10, temperature=300.0, friction_per_fs=0.0)
    nve = port_md.run_nve(start, 10)
    # the two half drifts are added at once: velocity Verlet to the bit
    assert torch.equal(langevin.coords, nve.coords)
    assert torch.equal(langevin.velocities, nve.velocities)
    assert langevin.rebuilds == nve.rebuilds
