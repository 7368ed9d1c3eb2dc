"""PyTorch port: the pair potentials (`RepulsionXTB`, `RepulsionZBL`,
`TwoBodyDispersionD3`, the declarative `PairPotential`) and the models that sum
them (`simple_ani`, `ANI2xr`, `ANI2dr`) against the JAX package and against the
repository's goldens, on the CPU.

Inputs come from the golden files (made from numpy seeds) or from a numpy
seed here.  Tolerances: energies and atomic energies rtol 1e-5 and atol 1e-6
Ha against JAX, forces rtol 1e-5 and atol 1e-5 Ha/A; against the goldens the
JAX tests' own bounds (atol 1e-5, rtol 1e-5; forces rtol 1e-4; the acceptance
set 1e-4).  Model energies rtol 1e-6, model forces atol 1e-5 Ha/A and rtol
1e-5 (random geometries hold close contacts with forces of order 100 Ha/A).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import load_golden
from torchani_tpu import arch as jarch
from torchani_tpu import models as jzoo
from torchani_tpu.convert import load_state_dict
from torchani_tpu.grad import energies_and_forces as j_energies_and_forces
from torchani_tpu.potentials import core as jcore
from torchani_tpu.potentials.dispersion import TwoBodyDispersionD3 as JD3
from torchani_tpu.potentials.repulsion import RepulsionXTB as JXTB
from torchani_tpu.potentials.repulsion import RepulsionZBL as JZBL
from torchani_tpu_torch import models
from torchani_tpu_torch.arch import simple_ani
from torchani_tpu_torch.grad import energies_and_forces
from torchani_tpu_torch.interop import load_jax_arrays
from torchani_tpu_torch.potentials import (
    PairPotential,
    RepulsionXTB,
    RepulsionZBL,
    TwoBodyDispersionD3,
)
from torchani_tpu_torch.utils import SYMBOLS_2X, SYMBOLS_2X_ZNUM_ORDER

torch.set_num_threads(2)
CPU = "cpu"
SYM = ("H", "C", "N", "O")

MAKERS = {
    "xtb": (lambda: RepulsionXTB(SYM, cutoff=5.2, device=CPU), lambda: JXTB.make(SYM, cutoff=5.2)),
    "zbl": (lambda: RepulsionZBL(SYM, cutoff=5.2, device=CPU), lambda: JZBL.make(SYM, cutoff=5.2)),
    "xtb_inf": (lambda: RepulsionXTB(SYM, device=CPU), lambda: JXTB.make(SYM)),
    "d3": (
        lambda: TwoBodyDispersionD3.from_functional(SYM, "wb97x", cutoff=8.0, device=CPU),
        lambda: JD3.from_functional(SYM, "wb97x", cutoff=8.0),
    ),
    "d3_inf": (
        lambda: TwoBodyDispersionD3.from_functional(SYM, "b973c", device=CPU),
        lambda: JD3.from_functional(SYM, "b973c"),
    ),
}


def _leaves(tree):
    return {
        jax.tree_util.keystr(p): np.asarray(x)
        for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


def _t(x, dtype=None):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def _port_eaf(pot, elem, coords, atomic_nums_input=False):
    """Energies, atomic energies and forces of a port potential."""
    c = _t(coords, torch.float32).requires_grad_(True)
    e = pot(_t(elem, torch.int64), c, atomic_nums_input=atomic_nums_input)
    (g,) = torch.autograd.grad(e.sum(), c)
    at = pot(_t(elem, torch.int64), c.detach(), atomic=True, atomic_nums_input=atomic_nums_input)
    return e.detach().numpy(), at.detach().numpy(), -g.numpy()


def _jax_eaf(pot, elem, coords, atomic_nums_input=False):
    elem, coords = jnp.asarray(elem), jnp.asarray(coords)
    e = pot(elem, coords, atomic_nums_input=atomic_nums_input)
    at = pot(elem, coords, atomic=True, atomic_nums_input=atomic_nums_input)
    g = jax.grad(lambda c: jnp.sum(pot(elem, c, atomic_nums_input=atomic_nums_input)))(coords)
    return np.asarray(e), np.asarray(at), -np.asarray(g)


@pytest.fixture(scope="module")
def goldens():
    return load_golden("potential_goldens.npz")


@pytest.mark.parametrize("name", sorted(MAKERS))
def test_potential_matches_jax_and_goldens(goldens, name):
    port, jpot = (make() for make in MAKERS[name])
    e, at, f = _port_eaf(port, goldens["elem"], goldens["coords"])
    je, jat, jf = _jax_eaf(jpot, goldens["elem"], goldens["coords"])
    np.testing.assert_allclose(e, je, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(at, jat, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(f, jf, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(e, goldens[f"{name}_energies"], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(at, goldens[f"{name}_atomic"], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(f, goldens[f"{name}_forces"], atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("name", sorted(MAKERS))
def test_potential_constants_equal_the_jax_leaves(name):
    """The port builds its tables from its own resources; they equal the JAX
    potential's leaves, and `load_jax_arrays` resolves every one of them."""
    port, jpot = (make() for make in MAKERS[name])
    leaves = _leaves(jpot)
    assert leaves
    buffers = dict(port.named_buffers())
    assert {k.lstrip(".") for k in leaves} == set(buffers)
    for path, value in leaves.items():
        np.testing.assert_array_equal(buffers[path.lstrip(".")].numpy(), value, err_msg=path)
    load_jax_arrays(port, leaves)


def test_zbl_matches_acceptance_goldens():
    g = load_golden("acceptance_goldens.npz")
    pot = RepulsionZBL(SYMBOLS_2X, device=CPU)
    e, _, _ = _port_eaf(pot, g["e_atomic_nums"], g["e_coords"], atomic_nums_input=True)
    np.testing.assert_allclose(e, g["zbl_energies"], atol=1e-4, rtol=1e-4)
    e, _, f = _port_eaf(pot, g["f_atomic_nums"], g["f_coords"], atomic_nums_input=True)
    np.testing.assert_allclose(e, g["zbl_f_energies"], atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(f, g["zbl_forces"], atol=1e-4, rtol=1e-3)


def test_d3_factorized_matches_literal_grid(goldens):
    """The factorised path (5 exponentials per atom) equals the literal
    25-channel pair grid, values and gradients: rtol 1e-5."""
    pot = MAKERS["d3"][0]()
    assert pot.cn_refs is not None, "the factorisation should verify for HCNO"
    literal = MAKERS["d3"][0]()
    literal.cn_refs = None
    e_new, at_new, f_new = _port_eaf(pot, goldens["elem"], goldens["coords"])
    e_old, at_old, f_old = _port_eaf(literal, goldens["elem"], goldens["coords"])
    np.testing.assert_allclose(e_new, e_old, rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(at_new, at_old, rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(f_new, f_old, rtol=1e-5, atol=1e-7)
    assert literal.frozen_window_channels(None, None) is None


def test_d3_gradients_are_finite_with_masked_lanes_and_a_lone_atom():
    """Padding atoms (masked lanes everywhere), an atom with no neighbor in
    range and pad CN references of 1e4: energies and forces stay finite, the
    lone atom feels exactly zero force."""
    rng = np.random.RandomState(0)
    species = np.array([[8, 1, 1, 6, 1, 17, -1, -1]])
    coords = (rng.randn(1, 8, 3) * 1.2).astype(np.float32)
    coords[0, 5] = [40.0, 40.0, 40.0]  # Cl far beyond the cutoff
    for jcls, pot in (
        (JD3, TwoBodyDispersionD3(SYMBOLS_2X_ZNUM_ORDER, functional="b973c", cutoff=8.0, device=CPU)),
        (JXTB, RepulsionXTB(SYMBOLS_2X_ZNUM_ORDER, cutoff=5.2, device=CPU)),
    ):
        e, at, f = _port_eaf(pot, species, coords, atomic_nums_input=True)
        assert np.isfinite(e).all() and np.isfinite(at).all() and np.isfinite(f).all()
        assert (f[0, 5:] == 0).all() and (at[0, 5:] == 0).all()
        kwargs = dict(functional="b973c", cutoff=8.0) if jcls is JD3 else dict(cutoff=5.2)
        je, jat, jf = _jax_eaf(jcls.make(SYMBOLS_2X_ZNUM_ORDER, **kwargs), species, coords, True)
        np.testing.assert_allclose(e, je, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(f, jf, rtol=1e-5, atol=1e-5)
    # the guard survives f32: 1e-35 is a normal number there
    assert float(torch.tensor(TwoBodyDispersionD3._EPS, dtype=torch.float32)) > 0


def test_declarative_pair_potential_matches_jax():
    class JSquare(jcore.PairPotential):
        tensors = ["bias"]
        pair_elem_tensors = ["k", "eq"]

        def pair_energies(self, elem_flat, neighbors):
            center, nbr = self.elem_pairs(elem_flat, neighbors)
            eq = self.to_pair_values(self.eq, center, nbr)
            k = self.to_pair_values(self.k, center, nbr)
            return self.bias + k / 2 * (neighbors.dist - eq) ** 2

    class Square(PairPotential):
        tensors = ["bias"]
        pair_elem_tensors = ["k", "eq"]

        def pair_energies(self, elem_flat, neighbors):
            center, nbr = self.elem_pairs(elem_flat, neighbors)
            eq = self.to_pair_values(self.eq, center, nbr)
            k = self.to_pair_values(self.k, center, nbr)
            return self.bias + k / 2 * (neighbors.dist - eq) ** 2

    rng = np.random.RandomState(2)
    sym = ("H", "C", "O")
    k, eq = rng.rand(6) + 0.5, rng.rand(6) + 1.0
    port = Square.make(sym, k=k, eq=eq, bias=0.1, cutoff=4.0, device=CPU)
    jpot = JSquare.make(sym, k=k, eq=eq, bias=0.1, cutoff=4.0)
    np.testing.assert_array_equal(port.k.numpy(), np.asarray(jpot.k))
    species = np.array([[1, 6, 8, 1, 1, -1]])
    coords = (rng.randn(1, 6, 3) * 1.5).astype(np.float32)
    e, at, f = _port_eaf(port, species, coords, atomic_nums_input=True)
    je, jat, jf = _jax_eaf(jpot, species, coords, atomic_nums_input=True)
    np.testing.assert_allclose(e, je, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(at, jat, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(f, jf, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="takes exactly"):
        Square.make(sym, k=k, device=CPU)


def _model_pair(jmodel, pmodel):
    return jmodel, load_jax_arrays(pmodel, _leaves(jmodel))


def _molecules(symbols_znums, seed):
    rng = np.random.RandomState(seed)
    species = rng.choice(symbols_znums, size=(3, 9))
    species[1, 7:] = -1
    coords = (rng.rand(3, 9, 3) * 4.0).astype(np.float32)
    return species, coords


@pytest.mark.parametrize(
    "name, jmake, pmake",
    [
        ("ani2dr", lambda: jzoo.ANI2dr(pretrained=False), lambda: models.ANI2dr(device=CPU)),
        ("ani2xr-member", lambda: jzoo.ANI2xr(model_index=1, pretrained=False),
         lambda: models.ANI2xr(model_index=1, device=CPU)),
        ("simple_ani-HO", lambda: jarch.simple_ani(("H", "O"), dispersion=True),
         lambda: simple_ani(("H", "O"), dispersion=True, device=CPU)),
    ],
    ids=lambda x: x if isinstance(x, str) else "",
)
def test_model_energies_and_forces_match_jax(name, jmake, pmake):
    """The slice as a whole: AEV (smooth cutoff, 8 x 4 angular terms), gelu
    networks without bias, repulsion and dispersion summed."""
    jmodel, pmodel = _model_pair(jmake(), pmake())
    assert pmodel.cutoff == jmodel.cutoff
    assert sorted(pmodel.potentials) == sorted(jmodel.potentials)
    znums = [1, 8] if name == "simple_ani-HO" else [1, 6, 7, 8, 9, 16, 17]
    species, coords = _molecules(znums, seed=5)
    e, f = energies_and_forces(pmodel, species, coords)
    je, jf = j_energies_and_forces(jmodel, jnp.asarray(species), jnp.asarray(coords))
    np.testing.assert_allclose(e.numpy(), np.asarray(je), rtol=1e-6)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), atol=1e-5, rtol=1e-5)
    at = pmodel(species, coords, atomic=True)
    jat = jmodel(jnp.asarray(species), jnp.asarray(coords), atomic=True)
    np.testing.assert_allclose(at.detach().numpy(), np.asarray(jat), rtol=1e-5, atol=5e-5)


def test_disabled_potential_is_skipped():
    model = simple_ani(("H", "O"), dispersion=True, device=CPU)
    species, coords = _molecules([1, 8], seed=6)
    full = model(species, coords)
    assert model.cutoff == 8.0
    model.set_enabled("dispersion_d3", False)
    assert model.cutoff == 5.2
    without = model(species, coords)
    assert float((full - without).detach().abs().max()) > 1e-6
    with pytest.raises(NotImplementedError, match="SingleNN"):
        simple_ani(("H", "O"), container="SingleNN", device=CPU)


def test_ani2xr_zoo_goldens_through_the_weight_bridge():
    """`ANI2xr` against the reference's goldens: state dict -> JAX `convert`
    -> numpy leaves -> `interop.load_jax_arrays` (energies rtol 1e-6, forces
    atol 1e-5 Ha/A, the JAX test's bounds)."""
    golden = load_golden("zoo_goldens_ani2xr.npz")
    sd = {k[3:]: v for k, v in golden.items() if k.startswith("sd.")}
    jmodel = load_state_dict(jzoo.ANI2xr(pretrained=False), sd)
    pmodel = load_jax_arrays(models.ANI2xr(device=CPU), _leaves(jmodel))
    e, f = energies_and_forces(pmodel, golden["species"], golden["coords"])
    np.testing.assert_allclose(e.numpy(), golden["energies"], rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(f.numpy(), golden["forces"], atol=1e-5, rtol=0)
