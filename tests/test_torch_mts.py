"""PyTorch port: multiple-timestep (RESPA) MD, `MultipleTimestepMD`, against
the JAX package's, on the CPU: the cases of `tests/test_md_mts.py`.

The model is the ANI-2dr-class stack of that file (a one-member `simple_ani`
over H and O: networks and xTB repulsion at 5.2 A, D3 dispersion at 8 A),
its weights bridged through `torchani_tpu_torch.interop`; the system its
60-atom water box.  Three JAX runs, each from `init`, are bridged into the
port (both lanes' states) and run again there: every=1 (6 NVE steps at 1 fs
from 80 K), every=4 (8 NVE steps at 0.5 fs from 50 K, the slow constants
cached) and every=2 Langevin (10 steps at 0.5 fs, JAX's own normal draws fed
to the port's O step).

Tolerances: the port's own identities at `tests/test_md_mts.py`'s (lane
split: energy rtol/atol 1e-6, forces rtol 1e-4 atol 1e-6; every=1 against
velocity Verlet: coordinates rtol 2e-5 atol 2e-6, energy rtol/atol 1e-5;
cached slow constants: energy atol 5e-5, forces 2e-5, coordinates 1e-6).
Against JAX: forces atol 1e-5 Ha/A at init and energy rtol 1e-6 (the single
point bounds); after the runs coordinates atol 1e-5 A, forces atol 1e-4 Ha/A
and energy atol 1e-5 Ha + rtol 1e-6 (as `tests/test_torch_md.py`).
"""

import jax
import numpy as np
import pytest
import torch

import torchani_tpu as tt
from torchani_tpu.md import MultipleTimestepMD as JMultipleTimestepMD
from torchani_tpu_torch.arch import simple_ani
from torchani_tpu_torch.interop import load_jax_arrays, load_jax_md_state
from torchani_tpu_torch.md import (
    ACCEL_UNIT,
    MolecularDynamics,
    MTSState,
    MultipleTimestepMD,
)
from torchani_tpu_torch.testing import make_water_box

torch.set_num_threads(2)
CPU = "cpu"
#: the three JAX runs: constructor settings, init temperature and key, run
RUNS = {
    "every1": (dict(every=1), 80.0, 3, 6, {}),
    "every4": (dict(every=4, timestep_fs=0.5), 50.0, 5, 8, {}),
    "langevin": (
        dict(every=2, timestep_fs=0.5), 300.0, 11, 10,
        dict(ensemble="langevin", temperature=300.0, friction_per_fs=0.05),
    ),
}


def _leaves(tree):
    return {
        jax.tree_util.keystr(p): np.asarray(x)
        for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


def _bridge(jstate) -> MTSState:
    """Both lanes of a JAX ``MTSState`` as the port's."""
    leaves = _leaves(jstate)
    lane = {
        name: load_jax_md_state(
            {k[len(f".{name}"):]: v for k, v in leaves.items() if k.startswith(f".{name}.")}, CPU
        )
        for name in ("fast", "slow")
    }
    return MTSState(**lane)


def _kinetic(masses, velocities) -> float:
    v = np.asarray(velocities, np.float64)
    m = np.asarray(masses, np.float64)
    return float(0.5 * np.sum(m[:, None] * v**2) / ACCEL_UNIT)


@pytest.fixture(scope="module")
def both_models():
    jmodel = tt.simple_ani(("H", "O"), ensemble_size=1, repulsion=True, dispersion=True)
    pmodel = simple_ani(("H", "O"), ensemble_size=1, repulsion=True, dispersion=True, device=CPU)
    return jmodel, load_jax_arrays(pmodel, _leaves(jmodel))


@pytest.fixture(scope="module")
def system():
    return make_water_box(60)  # 20 waters, ~8.4 A box


def _port(pmodel, system, **kw) -> MultipleTimestepMD:
    species, _, cell = system
    return MultipleTimestepMD(pmodel, species, cell=cell, pbc=True, device=CPU, **kw)


@pytest.fixture(scope="module")
def jax_runs(both_models, system):
    """Each JAX run once: (its MultipleTimestepMD, start, end)."""
    jmodel, _ = both_models
    species, coords, cell = system
    out = {}
    for name, (kw, temperature, seed, steps, run_kw) in RUNS.items():
        jmts = JMultipleTimestepMD(
            jmodel, species, cell=cell, pbc=True, nn_precision="highest", **kw
        )
        start = jmts.init(coords, temperature=temperature, key=jax.random.PRNGKey(seed))
        out[name] = (jmts, start, jmts.run(start, steps, **run_kw))
    return out


def _close_to_jax(end: MTSState, jend):
    assert end.step == int(jend.step)
    assert end.rebuilds == int(jend.rebuilds)
    assert not bool(end.overflow) and not bool(jend.overflow)
    np.testing.assert_allclose(
        end.coords.numpy(), np.asarray(jend.coords), atol=1e-5, rtol=0
    )
    np.testing.assert_allclose(end.forces.numpy(), np.asarray(jend.forces), atol=1e-4, rtol=0)
    np.testing.assert_allclose(float(end.energy), float(jend.energy), atol=1e-5, rtol=1e-6)


def test_slow_set_defaults_to_dispersion(both_models, system, jax_runs):
    mts = _port(both_models[1], system, every=2)
    jmts = jax_runs["every1"][0]
    assert mts.slow_names == jmts.slow_names == ("dispersion_d3",)
    for lane, jlane in ((mts.fast, jmts.fast), (mts.slow, jmts.slow)):
        assert {n: p.enabled for n, p in lane.model.potentials.items()} == {
            n: p.enabled for n, p in jlane.model.potentials.items()
        }
        assert lane.model.energy_shifter.enabled == jlane.model.energy_shifter.enabled
    assert mts.slow._freeze_pair == ("dispersion_d3",)


def test_lane_split_is_exact_at_init(both_models, system, jax_runs):
    """MTS total energy and forces at init equal the monolithic model's, and
    JAX's MTS init."""
    _, pmodel = both_models
    species, coords, cell = system
    st = _port(pmodel, system, every=2).init(coords)
    full = MolecularDynamics(pmodel, species, cell=cell, pbc=True, device=CPU).init(coords)
    np.testing.assert_allclose(float(st.energy), float(full.energy), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(st.forces.numpy(), full.forces.numpy(), rtol=1e-4, atol=1e-6)
    assert not bool(st.overflow)
    jstart = jax_runs["every1"][1]
    np.testing.assert_allclose(float(st.energy), float(jstart.energy), rtol=1e-6)
    np.testing.assert_allclose(st.forces.numpy(), np.asarray(jstart.forces), atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        st.slow.forces.numpy(), np.asarray(jstart.slow.forces), atol=1e-5, rtol=0
    )


def test_every_one_matches_plain_velocity_verlet(both_models, system, jax_runs):
    """every=1 is velocity Verlet on the full model; from JAX's start it
    ends where JAX's does."""
    _, pmodel = both_models
    species, _, cell = system
    _, jstart, jend = jax_runs["every1"]
    start = _bridge(jstart)
    end = _port(pmodel, system, every=1).run(start, 6)
    full = MolecularDynamics(pmodel, species, cell=cell, pbc=True, device=CPU)
    plain = full.run_nve(full.init(start.coords).replace(velocities=start.velocities), 6)
    np.testing.assert_allclose(end.coords.numpy(), plain.coords.numpy(), rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(float(end.energy), float(plain.energy), rtol=1e-5, atol=1e-5)
    _close_to_jax(end, jend)


def test_nve_drift_bounded_with_mts(both_models, system, jax_runs):
    """every=3 conserves total energy comparably to every=1; every=4 from
    JAX's start drifts as JAX's run does."""
    _, pmodel = both_models
    _, coords, _ = system

    def drift(every):
        mts = _port(pmodel, system, every=every, timestep_fs=0.25)
        st = mts.init(coords, temperature=50.0, generator=torch.Generator().manual_seed(7))
        e0 = float(st.energy) + _kinetic(mts.masses, st.velocities)
        st = mts.run(st, 30)
        assert not bool(st.overflow)
        return abs(float(st.energy) + _kinetic(mts.masses, st.velocities) - e0)

    d1, d3 = drift(1), drift(3)
    assert d3 < 5e-3
    assert d3 < 10 * max(d1, 1e-5)
    jmts, jstart, jend = jax_runs["every4"]
    masses = jmts.masses
    end = _port(pmodel, system, every=4, timestep_fs=0.5).run(_bridge(jstart), 8)
    e0 = float(jstart.energy) + _kinetic(masses, jstart.velocities)
    jdrift = float(jend.energy) + _kinetic(masses, jend.velocities) - e0
    pdrift = float(end.energy) + _kinetic(masses, end.velocities) - e0
    assert abs(pdrift - jdrift) <= 1e-5 + 1e-6 * abs(float(jstart.energy))


def test_langevin_runs_under_mts(both_models, system, jax_runs):
    _, pmodel = both_models
    _, coords, _ = system
    mts = _port(pmodel, system, every=2, timestep_fs=0.5)
    st = mts.init(coords, temperature=300.0, generator=torch.Generator().manual_seed(11))
    st = mts.run(st, 10, ensemble="langevin", temperature=300.0)
    assert np.isfinite(float(st.energy))
    assert st.step == 10
    # from JAX's start, with the draws of JAX's fast-lane key chain
    _, jstart, jend = jax_runs["langevin"]
    key, noises = jstart.fast.key, []
    for _ in range(10):
        key, nkey = jax.random.split(key)
        noises.append(torch.from_numpy(np.array(jax.random.normal(nkey, jstart.coords.shape))))
    noises = iter(noises)

    def inner(state):
        return mts.fast.step_langevin(state, 300.0, 0.05, noise=next(noises))

    end = _bridge(jstart)
    for _ in range(5):
        end = mts._outer_step(end, inner)
    _close_to_jax(end, jend)


def test_mts_validation_errors(both_models, system):
    _, pmodel = both_models
    species, coords, cell = system
    plain = simple_ani(("H", "O"), ensemble_size=1, repulsion=True, device=CPU)
    with pytest.raises(ValueError, match="cutoff beyond"):
        MultipleTimestepMD(plain, species, cell=cell, pbc=True, device=CPU)
    with pytest.raises(ValueError, match="every must be"):
        _port(pmodel, system, every=0)
    with pytest.raises(ValueError, match="fast set is empty"):
        _port(pmodel, system, slow_names=("nnp", "repulsion_xtb", "dispersion_d3"))
    mts = _port(pmodel, system, every=4)
    st = mts.init(coords)
    with pytest.raises(ValueError, match="multiple of"):
        mts.run(st, 6)
    for ensemble in ("npt", "nvt-nhc"):
        with pytest.raises(ValueError, match="not supported"):
            mts.run(st, 8, ensemble=ensemble, temperature=300.0)
    with pytest.raises(ValueError, match="unknown ensemble"):
        mts.run(st, 8, ensemble="nph")
    with pytest.raises(TypeError, match="unused"):
        mts.run(st, 8, ensemble="langevin", temperature=300.0, tau_fs=3.0)


def test_cached_slow_constants_exact(both_models, system, jax_runs):
    """Caching the slow lane's per-window constants is exact, and both runs
    end where JAX's (cached) run does."""
    _, pmodel = both_models
    _, jstart, jend = jax_runs["every4"]
    out = {}
    for cached in (False, True):
        mts = _port(pmodel, system, every=4, timestep_fs=0.5, cache_slow_constants=cached)
        start = mts.init(np.array(jstart.coords)).replace(fast=_bridge(jstart).fast)
        assert (start.slow.pair_aux is not None) == cached
        out[cached] = mts.run(start, 8)
    np.testing.assert_allclose(float(out[False].energy), float(out[True].energy), rtol=0, atol=5e-5)
    np.testing.assert_allclose(out[False].forces.numpy(), out[True].forces.numpy(), atol=2e-5)
    np.testing.assert_allclose(out[False].coords.numpy(), out[True].coords.numpy(), atol=1e-6)
    for end in out.values():
        _close_to_jax(end, jend)


def test_callers_model_is_unchanged(both_models, system):
    _, pmodel = both_models
    species, coords, cell = system
    pbc = np.ones(3, dtype=bool)
    with torch.no_grad():
        before = float(pmodel(species, coords, cell, pbc))
    mts = _port(pmodel, system, every=2)
    mts.run(mts.init(coords), 2)
    assert all(p.enabled for p in pmodel.potentials.values())
    assert pmodel.energy_shifter.enabled
    assert pmodel.cutoff == 8.0
    with torch.no_grad():
        assert float(pmodel(species, coords, cell, pbc)) == before
    # the lanes share the caller's weights, not copies of them
    lane_nnp = mts.fast.model.potentials["nnp"]
    assert lane_nnp.neural_networks is pmodel.potentials["nnp"].neural_networks
