"""PyTorch port: the Lennard-Jones family, fixed-charge Coulomb and MNOK,
`DummyPotential` and `potentials.utils.pair_curves`, against the JAX package
and the acceptance goldens on the CPU; an ANI-2x model with Lennard-Jones
added through the `Assembler`, in single point and in two NVE steps.

Tolerances: against the acceptance goldens those of
``tests/test_potentials_acceptance.py`` (energies atol and rtol 1e-4; forces
atol 1e-4, rtol 1e-3); against JAX energies rtol 1e-5 (atol 1e-6 Ha),
forces atol 1e-5 Ha/A (rtol 1e-5); curves rtol 1e-5; the model's energies
rtol 1e-6 and forces atol 1e-5 Ha/A; coordinates after two MD steps from the
JAX run's state atol 1e-5 A.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import load_golden
from torchani_tpu.arch import Assembler as JAssembler
from torchani_tpu.grad import energies_and_forces as j_energies_and_forces
from torchani_tpu.md import MolecularDynamics as JMolecularDynamics
from torchani_tpu.potentials import core as jcore
from torchani_tpu.potentials import fixed_coulomb as jfc
from torchani_tpu.potentials import lj as jlj
from torchani_tpu.potentials.utils import pair_curves as j_pair_curves
from torchani_tpu_torch.arch import Assembler
from torchani_tpu_torch.grad import energies_and_forces
from torchani_tpu_torch.interop import load_jax_arrays, load_jax_md_state
from torchani_tpu_torch.md import MolecularDynamics
from torchani_tpu_torch.potentials import (
    DispersionLJ,
    DummyPotential,
    FixedCoulomb,
    FixedMNOK,
    LennardJones,
    RepulsionLJ,
)
from torchani_tpu_torch.potentials.utils import pair_curves
from torchani_tpu_torch.testing import make_water_box
from torchani_tpu_torch.units import HARTREE_TO_EV
from torchani_tpu_torch.utils import SYMBOLS_2X

torch.set_num_threads(2)
CPU = "cpu"
NAMES = ["lj", "rep-lj", "disp-lj", "fixed-coulomb", "fixed-mnok"]
MD_KW = dict(pbc=True, timestep_fs=0.25, skin=0.6)


def _make(name, sym=SYMBOLS_2X, **kw):
    """The port's potential and the JAX package's, alike."""
    q, eta = [0.1] * len(sym), [0.01] * len(sym)
    return {
        "lj": lambda: (LennardJones(sym, device=CPU, **kw), jlj.LennardJones.make(sym, **kw)),
        "rep-lj": lambda: (RepulsionLJ(sym, device=CPU, **kw), jlj.RepulsionLJ.make(sym, **kw)),
        "disp-lj": lambda: (DispersionLJ(sym, device=CPU, **kw), jlj.DispersionLJ.make(sym, **kw)),
        "fixed-coulomb": lambda: (
            FixedCoulomb(sym, q, device=CPU, **kw), jfc.FixedCoulomb.make(sym, q, **kw)
        ),
        "fixed-mnok": lambda: (
            FixedMNOK(sym, q, eta, device=CPU, **kw), jfc.FixedMNOK.make(sym, q, eta, **kw)
        ),
    }[name]()


def _leaves(tree):
    return {
        jax.tree_util.keystr(p): np.asarray(x)
        for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


def _port_ef(pot, species, coords, **kw):
    c = torch.as_tensor(coords).requires_grad_(True)
    e = pot(torch.as_tensor(species), c, **kw)
    (g,) = torch.autograd.grad(e.sum(), c)
    return e.detach().numpy(), -g.numpy()


def _jax_ef(pot, species, coords, **kw):
    s = jnp.asarray(species)

    def total(x):
        e = pot(s, x, **kw)
        return jnp.sum(e), e

    (_, e), g = jax.jit(jax.value_and_grad(total, has_aux=True))(jnp.asarray(coords))
    return np.asarray(e), -np.asarray(g)


@pytest.fixture(scope="module")
def goldens():
    return load_golden("acceptance_goldens.npz")


@pytest.mark.parametrize("name", NAMES)
def test_energies_match_acceptance_goldens(goldens, name):
    pot, _ = _make(name)
    with torch.no_grad():
        e = pot(torch.as_tensor(goldens["e_atomic_nums"]), torch.as_tensor(goldens["e_coords"]))
    np.testing.assert_allclose(e.numpy(), goldens[f"{name}_energies"], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name", NAMES)
def test_forces_match_acceptance_goldens_and_jax(goldens, name):
    pot, jpot = _make(name)
    e, f = _port_ef(pot, goldens["f_atomic_nums"], goldens["f_coords"])
    np.testing.assert_allclose(e, goldens[f"{name}_f_energies"], atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(f, goldens[f"{name}_forces"], atol=1e-4, rtol=1e-3)
    je, jf = _jax_ef(jpot, goldens["f_atomic_nums"], goldens["f_coords"])
    np.testing.assert_allclose(e, je, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(f, jf, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", NAMES)
def test_smooth_cutoff_and_leaves_match_jax(name):
    """At 8 A under the smooth envelope, atomic energies and forces of a
    periodic box; the JAX leaves load into the port's buffers."""
    pot, jpot = _make(name, ("H", "O"), cutoff=8.0)
    assert set(_leaves(jpot)) == {"." + n for n, _ in pot.named_buffers()}
    load_jax_arrays(pot, _leaves(jpot))
    species, coords, cell = make_water_box(150, density_molec_per_a3=0.008)
    pbc = np.ones(3, dtype=bool)
    e, f = _port_ef(pot, species, coords, cell=torch.as_tensor(cell), pbc=torch.as_tensor(pbc))
    je, jf = _jax_ef(jpot, species, coords, cell=jnp.asarray(cell), pbc=jnp.asarray(pbc))
    np.testing.assert_allclose(e, je, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(f, jf, rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        at = pot(torch.as_tensor(species), torch.as_tensor(coords), torch.as_tensor(cell),
                 torch.as_tensor(pbc), atomic=True)
    js, jcell, jpbc = jnp.asarray(species), jnp.asarray(cell), jnp.asarray(pbc)
    jat = jax.jit(lambda x: jpot(js, x, jcell, jpbc, atomic=True))(jnp.asarray(coords))
    np.testing.assert_allclose(at.numpy(), np.asarray(jat), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("cls", [LennardJones, RepulsionLJ, DispersionLJ])
def test_ff19sb_matches_jax(goldens, cls):
    sym = ("H", "C", "N", "O", "S", "F", "Cl")
    pot = cls.ff19SB(sym, device=CPU)
    jpot = getattr(jlj, cls.__name__).ff19SB(sym)
    for name in ("eps", "sigma"):
        np.testing.assert_array_equal(getattr(pot, name).numpy(), np.asarray(getattr(jpot, name)))
    e, f = _port_ef(pot, goldens["f_atomic_nums"], goldens["f_coords"])
    je, jf = _jax_ef(jpot, goldens["f_atomic_nums"], goldens["f_coords"])
    np.testing.assert_allclose(e, je, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(f, jf, rtol=1e-5, atol=1e-5)


def test_constructors_refuse_what_jax_refuses():
    with pytest.raises(ValueError, match="one value per symbol"):
        LennardJones(("H", "O"), eps=(0.1,), device=CPU)
    with pytest.raises(ValueError, match="one value per symbol"):
        FixedCoulomb(("H", "O"), charges=(0.1,), device=CPU)
    with pytest.raises(ValueError, match="one value per symbol"):
        FixedMNOK(("H", "O"), charges=(0.1, 0.2), eta=(1.0,), device=CPU)
    mnok = FixedMNOK(("H", "O"), (0.1, -0.2), (1.0, 2.0), dielectric=4.0, device=CPU)
    plain = FixedMNOK(("H", "O"), (0.1, -0.2), (1.0, 2.0), device=CPU)
    sp, co, _ = make_water_box(30)
    with torch.no_grad():
        # the dielectric is stored and not applied, as in JAX
        assert torch.equal(mnok(torch.as_tensor(sp), torch.as_tensor(co)),
                           plain(torch.as_tensor(sp), torch.as_tensor(co)))


@pytest.fixture(scope="module")
def lj_pair():
    kw = dict(eps=(0.001, 0.002), sigma=(1.2, 1.6), cutoff=6.0)
    return LennardJones(("H", "O"), device=CPU, **kw), jlj.LennardJones.make(("H", "O"), **kw)


@pytest.mark.parametrize("force", [False, True])
def test_pair_curves_match_jax(lj_pair, force):
    pot, jpot = lj_pair
    r, curves = pair_curves(pot, steps=64, force=force)
    jr, jcurves = j_pair_curves(jpot, steps=64, force=force)
    np.testing.assert_array_equal(r, jr)
    assert set(curves) == set(jcurves) == {("H", "H"), ("H", "O"), ("O", "O")}
    for pair, values in curves.items():
        assert values.shape == (64,) and np.isfinite(values).all()
        np.testing.assert_allclose(values, jcurves[pair], rtol=1e-5, atol=1e-9)


def test_pair_curves_units_match_jax(lj_pair):
    pot, jpot = lj_pair
    _, e_ha = pair_curves(pot, symbol_pairs=[("O", "O")], steps=16)
    _, e_ev = pair_curves(pot, symbol_pairs=[("O", "O")], steps=16, eunits="ev")
    np.testing.assert_allclose(e_ev[("O", "O")], e_ha[("O", "O")] * HARTREE_TO_EV, rtol=1e-6)
    kw = dict(symbol_pairs=[("H", "O")], xmin=1.0, xmax=3.0, steps=16, force=True,
              eunits="kcalpermol", runits="bohr")
    r, f = pair_curves(pot, **kw)
    jr, jf = j_pair_curves(jpot, **kw)
    np.testing.assert_array_equal(r, jr)
    np.testing.assert_allclose(f[("H", "O")], jf[("H", "O")], rtol=1e-5)


def test_pair_curves_bad_units_raise(lj_pair):
    pot, _ = lj_pair
    with pytest.raises(ValueError, match="Unsupported unit"):
        pair_curves(pot, eunits="calories")
    with pytest.raises(ValueError, match="Unsupported unit"):
        pair_curves(pot, runits="parsec")


def test_dummy_potential_matches_jax():
    pot = DummyPotential(("H", "O"))
    jpot = jcore.DummyPotential(symbols=("H", "O"))
    sp, co, _ = make_water_box(30)
    with torch.no_grad():
        e = pot(torch.as_tensor(sp), torch.as_tensor(co))
        at = pot(torch.as_tensor(sp), torch.as_tensor(co), atomic=True)
    assert e.shape == (1,) and at.shape == (1, 30)
    np.testing.assert_array_equal(e.numpy(), np.asarray(jpot(jnp.asarray(sp), jnp.asarray(co))))
    assert not at.any() and pot.cutoff == jpot.cutoff


def _assemble(asm, lj):
    asm.set_symbols(("H", "O"))
    asm.set_global_cutoff_fn("cosine")
    asm.set_aev_computer(radial="ani2x", angular="ani2x")
    asm.set_atomic_networks(ctor="ani2x")
    asm.set_gsaes_as_self_energies("wb97x-631gd")
    asm.set_neighborlist("cell_list")
    asm.add_potential("lj", lj)
    return asm


@pytest.fixture(scope="module")
def lj_models():
    """ANI-2x (one member, H and O) with Lennard-Jones at 8 A, both packages."""
    jmodel = _assemble(JAssembler(), jlj.LennardJones.make(("H", "O"), cutoff=8.0)).assemble(1)
    pmodel = _assemble(Assembler(), LennardJones(("H", "O"), cutoff=8.0, device=CPU))
    pmodel = pmodel.assemble(1, device=CPU)
    return jmodel, load_jax_arrays(pmodel, _leaves(jmodel))


@pytest.fixture(scope="module")
def low_density_box():
    species, coords, cell = make_water_box(150, density_molec_per_a3=0.008)
    velocities = (np.random.RandomState(4).randn(150, 3) * 0.004).astype(np.float32)
    return species, coords, cell, velocities


def test_assembled_model_with_lj_matches_jax(lj_models, low_density_box):
    jmodel, pmodel = lj_models
    species, coords, cell, _ = low_density_box
    assert pmodel.cutoff == jmodel.cutoff == 8.0
    pbc = np.ones(3, dtype=bool)
    e, f = energies_and_forces(pmodel, species, coords, cell, pbc)
    js, jcell, jpbc = jnp.asarray(species), jnp.asarray(cell), jnp.asarray(pbc)
    je, jf = jax.jit(lambda m, c: j_energies_and_forces(m, js, c, jcell, jpbc))(
        jmodel, jnp.asarray(coords)
    )
    np.testing.assert_allclose(e.numpy(), np.asarray(je), rtol=1e-6)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), atol=1e-5, rtol=0)


def test_two_nve_steps_with_lj_match_jax(lj_models, low_density_box):
    """The networks run on a prefix of the lanes, Lennard-Jones on all of
    them; the port replays the JAX run from its bridged state."""
    jmodel, pmodel = lj_models
    species, coords, cell, velocities = low_density_box
    jmd = JMolecularDynamics(jmodel, species, cell=cell, nn_precision="highest", **MD_KW)
    jstart = jmd.init(coords).replace(velocities=jnp.asarray(velocities))
    jend = jmd.run_nve(jstart, 2)
    md = MolecularDynamics(pmodel, species, cell=cell, device=CPU, **MD_KW)
    assert md._lane_prefixes == jmd._lane_prefixes and "nnp" in md._lane_prefixes
    assert "lj" not in md._lane_prefixes
    start = md.init(coords)
    np.testing.assert_allclose(start.forces.numpy(), np.asarray(jstart.forces), atol=1e-5, rtol=0)
    end = md.run_nve(load_jax_md_state(_leaves(jstart), CPU), 2)
    assert not bool(end.overflow) and not bool(jend.overflow)
    np.testing.assert_allclose(end.coords.numpy(), np.asarray(jend.coords), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(end.energy), float(jend.energy), rtol=1e-6)
