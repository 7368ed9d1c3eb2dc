"""PyTorch port: NVE molecular dynamics (`MolecularDynamics`) and `CachedSinglePoint`
against the JAX package's, with a one-member ANI-2x whose weights come through
`torchani_tpu_torch.interop`.

The system is the 150-atom water box at low density (20 A, a 3x3x3 bucket
grid, so the bucket refresh is on).  Tolerances: `init` forces atol 1e-5
Ha/A and energy rtol 1e-6 (the single-point bounds); after 12 steps from the
same cached topology, coordinates atol 1e-4 A, forces atol 1e-4 Ha/A and the
total-energy drift equal within 1e-5 Ha + 1e-6 |E| (rounding grows along a
trajectory; one f32 ulp of the ~3,800 Ha total is 2.4e-4 Ha).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchani_tpu import models as jzoo
from torchani_tpu.md import MolecularDynamics as JMolecularDynamics
from torchani_tpu.md import kinetic_temperature as j_kinetic_temperature
from torchani_tpu_torch import models
from torchani_tpu_torch.grad import energies_and_forces
from torchani_tpu_torch.interop import load_jax_arrays, load_jax_md_state
from torchani_tpu_torch.md import (
    ACCEL_UNIT,
    CachedSinglePoint,
    MolecularDynamics,
    kinetic_temperature,
    maxwell_boltzmann_velocities,
)
from torchani_tpu_torch.testing import make_water_box

torch.set_num_threads(2)
CPU = "cpu"
STEPS = 12
MD_KW = dict(pbc=True, timestep_fs=0.25, skin=0.6)


def _leaves(tree):
    return {
        jax.tree_util.keystr(p): np.asarray(x)
        for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


def _kinetic(velocities, masses) -> float:
    v = np.asarray(velocities, np.float64)
    m = np.asarray(masses, np.float64)
    return float(0.5 * np.sum(m[:, None] * v**2) / ACCEL_UNIT)


@pytest.fixture(scope="module")
def both_models():
    jmodel = jzoo.ANI2x(model_index=0, pretrained=False)
    pmodel = load_jax_arrays(models.ANI2x(model_index=0, device=CPU), _leaves(jmodel))
    return jmodel, pmodel


@pytest.fixture(scope="module")
def box():
    species, coords, cell = make_water_box(150, density_molec_per_a3=0.008)
    velocities = (np.random.RandomState(4).randn(150, 3) * 0.004).astype(np.float32)
    return species, coords, cell, velocities


@pytest.fixture(scope="module")
def jax_run(both_models, box):
    """The JAX `MolecularDynamics` once: `init`, then 12 NVE steps from numpy velocities."""
    jmodel, _ = both_models
    species, coords, cell, velocities = box
    jmd = JMolecularDynamics(
        jmodel, species, cell=cell, nn_precision="highest", **MD_KW
    )
    start = jmd.init(coords).replace(velocities=jnp.asarray(velocities))
    end = jmd.run_nve(start, STEPS)
    return jmd, start, end


@pytest.fixture(scope="module")
def port_md(both_models, box):
    _, pmodel = both_models
    species, coords, cell, _ = box
    pmd = MolecularDynamics(pmodel, species, cell=cell, device=CPU, **MD_KW)
    return pmd, pmd.init(coords)


def test_init_matches_jax(jax_run, port_md):
    jmd, jstart, _ = jax_run
    pmd, pstart = port_md
    assert pmd.capacity == jmd.capacity
    assert pmd._bucket_c == jmd._bucket_c and pmd._bucket_c is not None
    assert pmd.grid_shape == jmd.grid_shape == (3, 3, 3)
    assert pmd._ang_prefix == jmd._ang_prefix
    assert pstart.bucket is not None
    assert pstart.rebuilds == int(jstart.rebuilds) == 0
    assert bool(pstart.overflow) == bool(jstart.overflow) is False
    np.testing.assert_allclose(pstart.forces.numpy(), np.asarray(jstart.forces), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(pstart.energy), float(jstart.energy), rtol=1e-6)
    np.testing.assert_allclose(pmd.masses.numpy(), np.asarray(jmd.masses))
    # the species-sorted internal order and the cached tables are the same,
    # up to the order of lanes whose build distances tie within rounding
    np.testing.assert_array_equal(pstart.nbr_perm.numpy(), np.asarray(jstart.nbr_perm))
    np.testing.assert_array_equal(pstart.nbr_mask.numpy(), np.asarray(jstart.nbr_mask))
    for name in ("nbr_idx", "nbr_elem"):
        np.testing.assert_array_equal(
            np.sort(getattr(pstart, name).numpy(), axis=1),
            np.sort(np.asarray(getattr(jstart, name)), axis=1),
        )
    k = pstart.nbr_idx.shape[1]
    np.testing.assert_array_equal(
        np.sort(pstart.bucket.keys.numpy().reshape(-1, k), axis=1),
        np.sort(np.asarray(jstart.bucket.keys).reshape(-1, k), axis=1),
    )
    np.testing.assert_array_equal(
        pstart.bucket.atom_of_slot.numpy(), np.asarray(jstart.bucket.atom_of_slot)
    )


def _drift(md_masses, start, end) -> float:
    e0 = float(start.energy) + _kinetic(start.velocities, md_masses)
    e1 = float(end.energy) + _kinetic(end.velocities, md_masses)
    return e1 - e0


def test_nve_from_bridged_state_matches_jax(jax_run, port_md):
    """The port on the JAX run's cached topology, lane for lane."""
    jmd, jstart, jend = jax_run
    pmd, _ = port_md
    start = load_jax_md_state(_leaves(jstart), CPU)
    assert start.bucket is not None and start.step == 0
    end = pmd.run_nve(start, STEPS)
    assert end.step == int(jend.step) == STEPS
    assert end.rebuilds == int(jend.rebuilds)
    assert not bool(end.overflow) and not bool(jend.overflow)
    np.testing.assert_allclose(end.coords.numpy(), np.asarray(jend.coords), atol=1e-4, rtol=0)
    np.testing.assert_allclose(end.forces.numpy(), np.asarray(jend.forces), atol=1e-4, rtol=0)
    np.testing.assert_allclose(
        end.velocities.numpy(), np.asarray(jend.velocities), atol=1e-5, rtol=0
    )
    masses = np.asarray(jmd.masses)
    e0 = abs(float(jstart.energy))
    assert abs(_drift(masses, start, end) - _drift(masses, jstart, jend)) < 1e-5 + 1e-6 * e0
    # nothing of a step's autograd graph stays in the state
    for t in (end.coords, end.velocities, end.forces, end.energy):
        assert not t.requires_grad and t.grad_fn is None


def test_state_bridge_refuses_what_is_not_ported(jax_run):
    _, jstart, _ = jax_run
    leaves = _leaves(jstart)
    with pytest.raises(KeyError, match="scale"):
        load_jax_md_state({**leaves, ".scale": np.ones(())}, CPU)
    partial = dict(leaves)
    partial.pop(".nbr_mask")
    with pytest.raises(KeyError, match="nbr_mask"):
        load_jax_md_state(partial, CPU)
    no_bucket = {k: v for k, v in leaves.items() if not k.startswith(".bucket.")}
    assert load_jax_md_state(no_bucket, CPU).bucket is None


@pytest.fixture(scope="module")
def port_runs(both_models, box):
    """The port's bucket path and gather path from the same start."""
    _, pmodel = both_models
    species, coords, cell, velocities = box
    runs = {}
    for bucket_refresh in (True, False):
        md = MolecularDynamics(
            pmodel, species, cell=cell, device=CPU, bucket_refresh=bucket_refresh, **MD_KW
        )
        start = md.init(coords).replace(velocities=torch.as_tensor(velocities))
        runs[bucket_refresh] = (md, start, md.run_nve(start, STEPS))
    return runs


def test_bucket_path_matches_gather_path(port_runs):
    """The bounds of ``test_md_bucket_path_matches_gather_path``."""
    md_b, start_b, st_b = port_runs[True]
    md_g, start_g, st_g = port_runs[False]
    assert md_b._bucket_c is not None and st_b.bucket is not None
    assert md_g._bucket_c is None and st_g.bucket is None
    assert start_g.nbr_shift.shape == start_g.nbr_idx.shape + (3,)
    assert start_b.nbr_shift.shape == (1, 1, 3)
    assert st_b.rebuilds == st_g.rebuilds
    assert not bool(st_b.overflow) and not bool(st_g.overflow)
    de = abs(float(st_b.energy) - float(st_g.energy))
    assert de < 5e-5 * abs(float(st_g.energy)) + 5e-5
    fscale = float(st_g.forces.abs().max()) + 1e-9
    assert float((st_b.forces - st_g.forces).abs().max()) / fscale < 5e-3
    assert float((st_b.coords - st_g.coords).abs().max()) < 1e-3


def test_port_run_matches_jax_run(jax_run, port_runs):
    """The port from its OWN init (its own cell list and lane sort)."""
    _, _, jend = jax_run
    _, _, end = port_runs[True]
    np.testing.assert_allclose(end.coords.numpy(), np.asarray(jend.coords), atol=1e-4, rtol=0)
    np.testing.assert_allclose(end.forces.numpy(), np.asarray(jend.forces), atol=1e-4, rtol=0)


@pytest.mark.parametrize("bucket_refresh", [True, False], ids=["bucket", "gather"])
def test_md_forces_match_single_point(both_models, box, port_runs, bucket_refresh):
    _, pmodel = both_models
    species, coords, cell, _ = box
    _, start, _ = port_runs[bucket_refresh]
    e, f = energies_and_forces(pmodel, species, coords, cell, np.ones(3, bool))
    np.testing.assert_allclose(float(e[0]), float(start.energy), atol=2e-4 + 1e-6 * abs(float(e[0])))
    np.testing.assert_allclose(f[0].numpy(), start.forces.numpy(), atol=2e-4)


def test_small_skin_rebuilds_without_overflow(both_models, box):
    _, pmodel = both_models
    species, coords, cell, _ = box
    md = MolecularDynamics(
        pmodel, species, cell=cell, pbc=True, timestep_fs=1.0, skin=0.1, device=CPU
    )
    state = md.init(coords, temperature=600.0, generator=torch.Generator().manual_seed(2))
    k, c = state.nbr_idx.shape[1], md._bucket_c
    state = md.run_nve(state, 8)
    assert state.rebuilds > 0
    assert not bool(state.overflow)
    assert torch.isfinite(state.forces).all() and torch.isfinite(state.energy)
    # a rebuild changes no static size
    assert state.nbr_idx.shape[1] == k and md._bucket_c == c
    # forces right after the run equal a fresh evaluation at the same coordinates
    _, f = energies_and_forces(pmodel, species, state.coords[None], cell, np.ones(3, bool))
    np.testing.assert_allclose(f[0].numpy(), state.forces.numpy(), atol=2e-4)


def test_nonperiodic_md_takes_the_gather_branch(both_models):
    _, pmodel = both_models
    species = np.array([[6, 1, 1, 1, 1]])
    coords = np.array(
        [[[0.0, 0.0, 0.0], [0.63, 0.63, 0.63], [-0.63, -0.63, 0.63],
          [-0.63, 0.63, -0.63], [0.63, -0.63, -0.63]]], dtype=np.float32
    )
    md = MolecularDynamics(pmodel, species, timestep_fs=0.2, device=CPU)
    state = md.init(coords, temperature=100.0)
    assert state.bucket is None and md._bucket_c is None
    # user order H-first is not sorted: C (index 1 in the model) sorts last
    np.testing.assert_array_equal(state.nbr_perm.numpy(), [1, 2, 3, 4, 0])
    e, f = energies_and_forces(pmodel, species, coords)
    np.testing.assert_allclose(f[0].numpy(), state.forces.numpy(), atol=1e-5)
    np.testing.assert_allclose(float(e[0]), float(state.energy), rtol=1e-6)
    state = md.run_nve(state, 10)
    assert state.step == 10
    assert torch.isfinite(state.energy) and torch.isfinite(state.coords).all()


def test_dummy_atoms_do_not_move(both_models):
    _, pmodel = both_models
    species = np.array([[8, -1, 1, 1]])
    coords = np.array(
        [[[0.0, 0.0, 0.12], [9.0, 9.0, 9.0], [0.0, 0.76, -0.48], [0.0, -0.76, -0.48]]],
        dtype=np.float32,
    )
    md = MolecularDynamics(pmodel, species, timestep_fs=0.2, device=CPU)
    assert float(md.masses[1]) == 1.0
    start = md.init(coords)
    velocities = torch.as_tensor(np.random.RandomState(1).randn(4, 3).astype(np.float32) * 0.01)
    velocities[1] = 0.0
    state = md.run_nve(start.replace(velocities=velocities), 5)
    assert (state.forces[1] == 0).all() and (state.velocities[1] == 0).all()
    np.testing.assert_array_equal(state.coords[1].numpy(), coords[0, 1])
    assert torch.isfinite(state.energy)


def test_cached_single_point_matches_one_shot(both_models):
    """Three geometries of one system, the last displaced past the skin."""
    _, pmodel = both_models
    species, coords, cell = make_water_box(48)
    sp = CachedSinglePoint(pmodel, species, cell=cell, pbc=True, skin=0.6, device=CPU)
    assert not sp.overflow
    rng = np.random.RandomState(0)
    geoms = [
        coords[0],
        coords[0] + rng.randn(*coords[0].shape).astype(np.float32) * 0.02,
        coords[0] + rng.randn(*coords[0].shape).astype(np.float32) * 0.5,
    ]
    for i, g in enumerate(geoms):
        e, f = sp(g)
        e_ref, f_ref = energies_and_forces(pmodel, species, g[None], cell, np.ones(3, bool))
        de = abs(float(e) - float(e_ref[0]))
        assert de < 5e-5 * abs(float(e_ref[0])) + 5e-5, (i, de)
        fscale = float(f_ref.abs().max()) + 1e-9
        assert float((f - f_ref[0]).abs().max()) / fscale < 5e-4, i
    assert not sp.overflow
    assert sp._state.rebuilds >= 1  # the big displacement rebuilt
    sp.reset()
    assert sp._state is None


def test_velocities_are_seeded_and_thermal():
    species = np.tile(np.array([8, 1, 1]), 1000)
    masses = torch.as_tensor(np.where(species == 8, 15.999, 1.008).astype(np.float32))
    draw = lambda seed: maxwell_boltzmann_velocities(  # noqa: E731
        torch.Generator().manual_seed(seed), masses, 300.0
    )
    v = draw(0)
    assert torch.equal(v, draw(0)) and not torch.equal(v, draw(1))
    temp = float(kinetic_temperature(v, masses))
    assert abs(temp - 300.0) < 30.0
    ref = float(j_kinetic_temperature(jnp.asarray(v.numpy()), jnp.asarray(masses.numpy())))
    np.testing.assert_allclose(temp, ref, rtol=1e-5)
    # a massless (dummy) atom gets zero velocity, not inf
    masses0 = masses.clone()
    masses0[5] = 0.0
    assert (maxwell_boltzmann_velocities(torch.Generator().manual_seed(0), masses0, 300.0)[5] == 0).all()


def test_callers_model_is_unchanged(both_models, box):
    _, pmodel = both_models
    species, _, cell, _ = box
    aevc = pmodel.aev_computer
    md = MolecularDynamics(pmodel, species, cell=cell, pbc=True, device=CPU)
    assert md._ang_prefix is not None
    assert md.model is not pmodel and md.model.aev_computer is not aevc
    assert md.model.aev_computer.angular_preslice == md._ang_prefix
    assert pmodel.aev_computer is aevc and aevc.angular_preslice is None
    # weights and buffers are shared, not copied
    assert md.model.neural_networks is pmodel.neural_networks
    assert md.model.aev_computer.angular.shifts is aevc.angular.shifts
    assert md.model.energy_shifter is pmodel.energy_shifter


def test_md_rejects_what_it_cannot_run(both_models, box):
    _, pmodel = both_models
    species, _, cell, _ = box
    # the atom-packed layout is ported: `MolecularDynamics` takes it
    md = MolecularDynamics(pmodel, species, cell=cell, pbc=True, bucket_refresh="packed", device=CPU)
    assert md._bucket_packed
    with pytest.raises(ValueError, match=r"\(1, A\)"):
        MolecularDynamics(pmodel, species[0], cell=cell, pbc=True, device=CPU)
