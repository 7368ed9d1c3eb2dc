"""PyTorch port: the Nose-Hoover chain (NVT), Berendsen NPT and `rebaseline`
of `MolecularDynamics` against the JAX package's, on the CPU.

The system is the 30-atom water box of `tests/test_md.py` (and, for the
bucket refresh, 150 atoms at low density) under a one-member `simple_ani`
model whose weights come through `torchani_tpu_torch.interop`.  One step
from the JAX state (`load_jax_md_state`): coordinates and forces atol 1e-5
(A, Ha/A), velocities rtol 1e-5 plus the half kick of that force tolerance,
the chain state and the scale rtol 1e-5 (f32 sums over the atoms in another
order).  The virial dU/dscale against a central finite difference of the
port's `single_point` under joint coordinate and cell scaling, at the JAX
test's tolerance (3e-2 of |fd| + 2e-2: f32 cancellation in E(1 +- h)), and
against the JAX package's virial at 1e-4 of its size.

The ANI-2dr-style model of ``tests/test_torch_hetero_md.py`` (networks, xTB
repulsion and D3 dispersion on a ``cell_list``) on 150 atoms at low density
(a 20 A box, so that the bucket refresh runs at NPT's build radius): two
Berendsen NPT steps (``npt_compression`` 0.1, 5e4 bar) with the default
refresh, the frozen D3 window and the atom-packed refresh, and two Nose-Hoover
steps, each from the JAX state: coordinates and forces atol 1e-6 (A, Ha/A),
velocities rtol 1e-5 plus the half kick of that force tolerance, the scale
rtol 1e-6, the chain rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchani_tpu as tt
from torchani_tpu.md import MolecularDynamics as JMolecularDynamics
from torchani_tpu_torch.bucket_refresh import BucketTables
from torchani_tpu_torch.bucket_refresh_packed import PackedTables
from torchani_tpu_torch.arch import simple_ani
from torchani_tpu_torch.grad import single_point
from torchani_tpu_torch.interop import load_jax_arrays, load_jax_md_state
from torchani_tpu_torch.md import ACCEL_UNIT, MolecularDynamics, kinetic_temperature
from torchani_tpu_torch.testing import make_water_box

from test_torch_hetero_md import ani2dr_style_models

torch.set_num_threads(2)
CPU = "cpu"
MD_KW = dict(pbc=True, timestep_fs=0.5, skin=0.6)


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


def _system(refresh: str):
    if refresh == "bucket":
        return make_water_box(150, density_molec_per_a3=0.008)
    return make_water_box(30)


def _assert_step(end, jend, md, atol=1e-5):
    np.testing.assert_allclose(end.coords.numpy(), np.asarray(jend.coords), atol=atol, rtol=0)
    np.testing.assert_allclose(end.forces.numpy(), np.asarray(jend.forces), atol=atol, rtol=0)
    kick = 0.5 * md.dt * atol * float((ACCEL_UNIT / md.masses).max())
    np.testing.assert_allclose(
        end.velocities.numpy(), np.asarray(jend.velocities), rtol=1e-5, atol=kick
    )
    assert end.step == int(jend.step)


def test_one_nose_hoover_step_matches_jax(both_models):
    jmodel, pmodel = both_models
    species, coords, cell = _system("gather")
    jmd = JMolecularDynamics(jmodel, species, cell=cell, nn_precision="highest", **MD_KW)
    jstart = jmd.init(coords, temperature=300.0, key=jax.random.PRNGKey(1))
    jend = jmd.run_nvt_nose_hoover(jstart, 1, temperature=300.0, tau_fs=20.0)
    md = MolecularDynamics(pmodel, species, cell=cell, device=CPU, **MD_KW)
    start = load_jax_md_state(_leaves(jstart), CPU)
    with pytest.raises(ValueError, match="chain"):
        md.step_nvt_nose_hoover(start, 300.0, 20.0)
    end = md.run_nvt_nose_hoover(start, 1, temperature=300.0, tau_fs=20.0)
    _assert_step(end, jend, md)
    np.testing.assert_allclose(end.nhc.numpy(), np.asarray(jend.nhc), rtol=1e-5, atol=1e-12)
    assert float(end.nhc.abs().max()) > 0


@pytest.mark.parametrize("refresh", ["gather", "bucket"])
def test_one_npt_step_matches_jax(refresh, both_models):
    """Under a strong external pressure, so that the scale moves; on the
    30-atom box (gather refresh) and 150 atoms at low density (bucket)."""
    jmodel, pmodel = both_models
    species, coords, cell = _system(refresh)
    kw = dict(MD_KW, npt_compression=0.1)
    jmd = JMolecularDynamics(jmodel, species, cell=cell, nn_precision="highest", **kw)
    jstart = jmd.init(coords, temperature=300.0, key=jax.random.PRNGKey(3))
    npt = dict(temperature=300.0, pressure_bar=5.0e4, tau_p_fs=200.0)
    jend = jmd.run_npt_berendsen(jstart, 1, **npt)
    md = MolecularDynamics(pmodel, species, cell=cell, device=CPU, **kw)
    assert md.build_radius == pytest.approx(jmd.build_radius)
    assert md._ang_prefix is None and not md._lane_prefixes
    start = load_jax_md_state(_leaves(jstart), CPU)
    assert (start.bucket is not None) == (refresh == "bucket")
    end = md.run_npt_berendsen(start, 1, **npt)
    _assert_step(end, jend, md)
    np.testing.assert_allclose(float(end.scale), float(jend.scale), rtol=1e-6)
    assert float(end.scale) != 1.0
    np.testing.assert_allclose(float(end.energy), float(jend.energy), rtol=1e-6)


def test_npt_virial_matches_finite_difference_and_jax(both_models):
    jmodel, pmodel = both_models
    species, coords, cell = _system("gather")
    md = MolecularDynamics(pmodel, species, cell=cell, device=CPU, npt_compression=0.1, skin=0.6,
                           pbc=True)
    st = md.init(coords, temperature=50.0)
    one = torch.ones(())
    e0, f0, du_ds = md._energy_forces_virial(st.replace(scale=one), st.coords, one)

    def e_at(s):
        out = single_point(pmodel, species, st.coords[None] * s, cell=cell * s, pbc=np.ones(3, bool))
        return float(out["energies"][0])

    assert abs(float(e0) - e_at(1.0)) < 5e-5 * abs(e_at(1.0)) + 5e-5
    h = 1e-3
    fd = (e_at(1.0 + h) - e_at(1.0 - h)) / (2 * h)
    assert abs(float(du_ds) - fd) < 3e-2 * abs(fd) + 2e-2, (float(du_ds), fd)
    _, f_nve = md._energy_and_forces(st, st.coords)
    np.testing.assert_allclose(f0.numpy(), f_nve.numpy(), atol=1e-5, rtol=0)

    jmd = JMolecularDynamics(jmodel, species, cell=cell, nn_precision="highest", skin=0.6,
                             pbc=True, npt_compression=0.1)
    jst = jmd.init(st.coords.numpy()).replace(scale=jnp.ones(()))
    je, jf, jdu = jax.jit(jmd._energy_forces_virial)(jst, jst.coords, jnp.ones(()))
    assert abs(float(du_ds) - float(jdu)) < 1e-4 * abs(float(jdu)) + 1e-5, (float(du_ds), jdu)
    np.testing.assert_allclose(f0.numpy(), np.asarray(jf), atol=1e-5, rtol=0)


def test_npt_virial_bucket_matches_gather(both_models):
    """dU/dscale agrees between the bucket and gather refresh paths (the
    scale rides on the pair vectors after the selection)."""
    _, pmodel = both_models
    species, coords, cell = _system("bucket")
    out = {}
    for bucket in (True, False):
        md = MolecularDynamics(pmodel, species, cell=cell, device=CPU, skin=0.6, pbc=True,
                               npt_compression=0.1, bucket_refresh=bucket)
        st = md.init(coords, temperature=50.0)
        assert (st.bucket is not None) == bucket
        one = torch.ones(())
        out[bucket] = md._energy_forces_virial(st.replace(scale=one), st.coords, one)
    (e_b, f_b, v_b), (e_g, f_g, v_g) = out[True], out[False]
    assert abs(float(e_b) - float(e_g)) < 5e-5 * abs(float(e_g)) + 5e-5
    assert float((f_b - f_g).abs().max()) / (float(f_g.abs().max()) + 1e-9) < 5e-3
    assert abs(float(v_b) - float(v_g)) < 5e-3 * abs(float(v_g)) + 5e-3


def test_npt_berendsen_responds_to_pressure(both_models):
    """The barostat compresses under a large external pressure and expands
    under tension; trajectories stay finite, without overflow."""
    _, pmodel = both_models
    species, coords, cell = _system("gather")

    def run(p_bar):
        md = MolecularDynamics(pmodel, species, cell=cell, device=CPU, timestep_fs=0.5, skin=0.6,
                               pbc=True, npt_compression=0.15)
        st = md.init(coords, temperature=100.0, generator=torch.Generator().manual_seed(3))
        st = md.run_npt_berendsen(st, 60, temperature=100.0, pressure_bar=p_bar, tau_p_fs=200.0)
        assert np.isfinite(float(st.energy))
        return float(st.scale), bool(st.overflow)

    s_hi, of_hi = run(5.0e4)
    s_lo, of_lo = run(-5.0e4)
    assert s_hi < 0.999 and s_lo > 1.001, (s_hi, s_lo)
    assert not of_hi and not of_lo


def test_rebaseline_preserves_the_energy(both_models):
    _, pmodel = both_models
    species, coords, cell = _system("gather")
    md = MolecularDynamics(pmodel, species, cell=cell, device=CPU, timestep_fs=0.5, skin=0.6,
                           pbc=True, npt_compression=0.15)
    st = md.init(coords, temperature=100.0, generator=torch.Generator().manual_seed(9))
    st = md.run_npt_berendsen(st, 40, temperature=100.0, pressure_bar=3.0e4, tau_p_fs=150.0)
    assert float(st.scale) != 1.0
    md2, st2 = md.rebaseline(st)
    assert float(st2.scale) == 1.0 and st2.step == st.step
    assert torch.equal(st2.velocities, st.velocities)
    np.testing.assert_allclose(md2.cell.numpy(), md.cell.numpy() * float(st.scale), rtol=1e-6)
    assert abs(float(st2.energy) - float(st.energy)) < 2e-4 * abs(float(st.energy)) + 2e-3
    st2 = md2.run_npt_berendsen(st2, 10, temperature=100.0, pressure_bar=3.0e4, tau_p_fs=150.0)
    assert np.isfinite(float(st2.energy)) and not bool(st2.overflow)
    with pytest.raises(ValueError, match="NPT"):
        md.rebaseline(st.replace(scale=None))


def test_nose_hoover_holds_the_temperature(both_models):
    """`tests/test_md.py`'s NHC test on the port, over 120 steps: the chain
    takes part and the kinetic temperature stays in a loose band."""
    _, pmodel = both_models
    species, coords, cell = _system("gather")
    md = MolecularDynamics(pmodel, species, cell=cell, device=CPU, **MD_KW)
    st = md.init(coords, temperature=300.0, generator=torch.Generator().manual_seed(1))
    temps = []
    for _ in range(3):
        st = md.run_nvt_nose_hoover(st, 40, temperature=300.0, tau_fs=20.0)
        temps.append(float(kinetic_temperature(st.velocities, md.masses)))
    assert np.isfinite(float(st.energy)) and not bool(st.overflow)
    assert 120.0 < np.mean(temps[1:]) < 520.0, temps
    assert float(st.nhc.abs().max()) > 0


def test_npt_arguments_are_checked(both_models):
    _, pmodel = both_models
    species, coords, cell = _system("gather")
    with pytest.raises(ValueError, match="periodic cell"):
        MolecularDynamics(pmodel, species, device=CPU, npt_compression=0.1)
    with pytest.raises(ValueError, match=r"\[0, 0.5\)"):
        MolecularDynamics(pmodel, species, cell=cell, pbc=True, device=CPU, npt_compression=0.5)
    md = MolecularDynamics(pmodel, species, device=CPU)
    st = md.init(coords)
    with pytest.raises(ValueError, match="periodic cell"):
        md.run_npt_berendsen(st, 1, temperature=300.0)
    with pytest.raises(ValueError, match="scale"):
        md.step_npt_berendsen(st, 300.0)


DR_MD_KW = dict(pbc=True, timestep_fs=0.25, skin=0.4)
DR_VARIANTS = {
    "default": ({}, BucketTables),
    "frozen": (dict(freeze_pair_window=("dispersion_d3",)), BucketTables),
    "packed": (dict(bucket_refresh="packed"), PackedTables),
}


@pytest.fixture(scope="module")
def dr_models():
    return ani2dr_style_models()


def _dr_runs(dr_models, npt_kw):
    """The JAX and port `MolecularDynamics` on the 150-atom box, the JAX
    `init` state and the port's copy of it."""
    jmodel, pmodel = dr_models
    species, coords, cell = make_water_box(150, density_molec_per_a3=0.008)
    jmd = JMolecularDynamics(jmodel, species, cell=cell, nn_precision="highest", **npt_kw)
    jstart = jmd.init(coords, temperature=300.0, key=jax.random.PRNGKey(3))
    md = MolecularDynamics(pmodel, species, cell=cell, device=CPU, **npt_kw)
    return jmd, jstart, md, load_jax_md_state(_leaves(jstart), CPU)


@pytest.mark.parametrize("variant", sorted(DR_VARIANTS))
def test_two_npt_steps_of_the_ani2dr_style_model_match_jax(dr_models, variant):
    kw, tables = DR_VARIANTS[variant]
    jmd, jstart, md, start = _dr_runs(dr_models, dict(DR_MD_KW, npt_compression=0.1, **kw))
    assert isinstance(start.bucket, tables) and md._bucket_on
    assert md._freeze_pair == jmd._freeze_pair == tuple(kw.get("freeze_pair_window", ()))
    npt = dict(temperature=300.0, pressure_bar=5.0e4, tau_p_fs=200.0)
    jend = jmd.run_npt_berendsen(jstart, 2, **npt)
    end = md.run_npt_berendsen(start, 2, **npt)
    _assert_step(end, jend, md, atol=1e-6)
    np.testing.assert_allclose(float(end.scale), float(jend.scale), rtol=1e-6)
    assert float(end.scale) != 1.0 and not bool(end.overflow)


def test_two_nose_hoover_steps_of_the_ani2dr_style_model_match_jax(dr_models):
    jmd, jstart, md, start = _dr_runs(dr_models, DR_MD_KW)
    assert isinstance(start.bucket, BucketTables)
    jend = jmd.run_nvt_nose_hoover(jstart, 2, temperature=300.0, tau_fs=20.0)
    end = md.run_nvt_nose_hoover(start, 2, temperature=300.0, tau_fs=20.0)
    _assert_step(end, jend, md, atol=1e-6)
    np.testing.assert_allclose(end.nhc.numpy(), np.asarray(jend.nhc), rtol=1e-5, atol=1e-12)
    assert float(end.nhc.abs().max()) > 0 and not bool(end.overflow)
