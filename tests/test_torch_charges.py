"""PyTorch port: the charge models (`electro`, `MergedChargesNNPotential`,
`SeparateChargesNNPotential`, `ANIq`, `simple_aniq`, `models.ANImbis`)
against the JAX package on the CPU, with weights bridged through
`torchani_tpu_torch.interop`.

Inputs come from numpy seeds and the repository's water box.  Tolerances:
the normalizer and dipoles rtol 1e-6 (and atol 1e-7 e, 1e-6 e A); model
energies rtol 1e-6, forces atol 1e-5 Ha/A, charges atol 1e-5 e; the
published-scheme goldens of ANI-mbis through the port's own converter < 1e-5
(energies, forces and charges, as ``tests/test_zoo_convert.py``).
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import RESOURCES
from torchani_tpu import arch as jarch
from torchani_tpu import electro as jelectro
from torchani_tpu import models as jzoo
from torchani_tpu.grad import energies_and_forces as j_energies_and_forces
from torchani_tpu.grad import single_point as j_single_point
from torchani_tpu_torch import electro, models
from torchani_tpu_torch.arch import simple_ani, simple_aniq
from torchani_tpu_torch.grad import energies_and_forces, single_point
from torchani_tpu_torch.interop import load_jax_arrays
from torchani_tpu_torch.md import MolecularDynamics
from torchani_tpu_torch.testing import make_water_box

torch.set_num_threads(2)
CPU = "cpu"
SYM = ("H", "C", "N", "O")


def _leaves(tree):
    return {
        jax.tree_util.keystr(p): np.asarray(x)
        for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


def _np(t):
    return t.detach().cpu().numpy()


@pytest.fixture(scope="module")
def cluster():
    """The first 30 waters of the box, no cell."""
    species, coords, _ = make_water_box(96)
    return species[:, :90], coords[:, :90]


@pytest.fixture(scope="module")
def padded():
    """Two molecules of HCNO with padding: a 10-atom slice of the cluster
    with a C and an N, and a 7-atom one."""
    species, coords, _ = make_water_box(96)
    sp = np.full((2, 10), -1, dtype=np.int64)
    co = np.zeros((2, 10, 3), dtype=np.float32)
    sp[0], co[0] = species[0, :10], coords[0, :10]
    sp[0, 3], sp[0, 6] = 6, 7
    sp[1, :7], co[1, :7] = species[0, 30:37], coords[0, 30:37]
    return sp, co


# ---- electro ----
def _raw(seed, c=3, a=6, s=4):
    rng = np.random.RandomState(seed)
    elem = rng.randint(0, s, (c, a))
    elem[1, 4:] = -1
    elem[2, 5:] = -1
    raw = rng.randn(c, a).astype(np.float32) * 0.3
    return elem, np.where(elem >= 0, raw, 0.0).astype(np.float32)


@pytest.mark.parametrize("charge", [0, 1])
@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("weights", ["uniform", "chi_eta"])
def test_charge_normalizer_matches_jax(weights, scaled, charge):
    if weights == "uniform":
        jn = jelectro.ChargeNormalizer.make(SYM, scale_weights_by_charges_squared=scaled)
        pn = electro.ChargeNormalizer.make(SYM, scale_weights_by_charges_squared=scaled, device=CPU)
    else:
        jn = jelectro.ChargeNormalizer.from_electronegativity_and_hardness(
            SYM, scale_weights_by_charges_squared=scaled
        )
        pn = electro.ChargeNormalizer.from_electronegativity_and_hardness(
            SYM, scale_weights_by_charges_squared=scaled, device=CPU
        )
    np.testing.assert_array_equal(_np(pn.weights), np.asarray(jn.weights))
    elem, raw = _raw(3)
    ref = np.asarray(jn(jnp.asarray(elem), jnp.asarray(raw), charge))
    out = _np(pn(torch.as_tensor(elem), torch.as_tensor(raw), charge))
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(out.sum(-1), charge, atol=1e-5)
    assert (out[elem < 0] == 0).all()
    # a per-molecule tensor charge (C, 1)
    per = np.asarray([[0.0], [1.0], [-1.0]], dtype=np.float32)
    ref = np.asarray(jn(jnp.asarray(elem), jnp.asarray(raw), jnp.asarray(per)))
    out = _np(pn(torch.as_tensor(elem), torch.as_tensor(raw), torch.as_tensor(per)))
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-7)


def test_a_flat_charge_tensor_raises_in_both():
    """A ``(C,)`` charge broadcasts to ``(C, C)`` and fails the product."""
    elem, raw = _raw(4)
    jn = jelectro.ChargeNormalizer.make(SYM)
    pn = electro.ChargeNormalizer.make(SYM, device=CPU)
    with pytest.raises(TypeError):
        jn(jnp.asarray(elem), jnp.asarray(raw), jnp.asarray([0.0, 1.0, 0.0]))
    with pytest.raises(RuntimeError):
        pn(torch.as_tensor(elem), torch.as_tensor(raw), torch.tensor([0.0, 1.0, 0.0]))


def _dipole_inputs():
    rng = np.random.RandomState(5)
    species = rng.choice([1, 6, 7, 8], (3, 7))
    species[1, 5:] = -1
    coords = rng.randn(3, 7, 3).astype(np.float32) * 2
    charges = np.where(species >= 0, rng.randn(3, 7) * 0.2, 0.0).astype(np.float32)
    return species, coords, charges


@pytest.mark.parametrize("reference", ["center_of_mass", "center_of_geometry", "origin"])
def test_compute_dipole_matches_jax(reference):
    species, coords, charges = _dipole_inputs()
    ref = np.asarray(jelectro.compute_dipole(
        jnp.asarray(species), jnp.asarray(coords), jnp.asarray(charges), reference
    ))
    out = _np(electro.compute_dipole(
        torch.as_tensor(species), torch.as_tensor(coords), torch.as_tensor(charges), reference
    ))
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)
    ref_c = np.asarray(jelectro.DipoleComputer.make(reference=reference)(
        jnp.asarray(species), jnp.asarray(coords), jnp.asarray(charges)
    ))
    out_c = _np(electro.DipoleComputer(reference=reference, device=CPU)(
        torch.as_tensor(species), torch.as_tensor(coords), torch.as_tensor(charges)
    ))
    np.testing.assert_allclose(out_c, ref_c, rtol=1e-6, atol=1e-6)


def test_dipole_computer_custom_masses_matches_jax():
    species, coords, charges = _dipole_inputs()
    masses = np.linspace(0.5, 20.0, 10)
    jd = jelectro.DipoleComputer.make(masses=masses)
    pd = electro.DipoleComputer(masses=masses, device=CPU)
    load_jax_arrays(pd, _leaves(jd))
    ref = np.asarray(jd(jnp.asarray(species), jnp.asarray(coords), jnp.asarray(charges)))
    out = _np(pd(torch.as_tensor(species), torch.as_tensor(coords), torch.as_tensor(charges)))
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="Unsupported reference"):
        electro.compute_dipole(
            torch.as_tensor(species), torch.as_tensor(coords), torch.as_tensor(charges), "nowhere"
        )


# ---- models ----
def _compare(jmodel, pmodel, species, coords, charge=0):
    """Energies, forces and charges of both models, each to its tolerance."""
    js, jc = jnp.asarray(species), jnp.asarray(coords)
    je, jf = jax.jit(lambda m, c: j_energies_and_forces(m, js, c))(jmodel, jc)
    jq = jax.jit(lambda m, c: m.energies_and_charges(js, c, charge=charge))(jmodel, jc)
    pe, pf = energies_and_forces(pmodel, species, coords)
    pq = pmodel.energies_and_charges(species, coords, charge=charge)
    np.testing.assert_allclose(_np(pe), np.asarray(je), rtol=1e-6)
    np.testing.assert_allclose(_np(pf), np.asarray(jf), atol=1e-5)
    np.testing.assert_allclose(_np(pq.energies), np.asarray(jq.energies), rtol=1e-6)
    np.testing.assert_allclose(_np(pq.scalars), np.asarray(jq.scalars), atol=1e-5)
    return pf, pq


@pytest.mark.parametrize("merged", [False, True])
def test_simple_aniq_matches_jax_with_padding(padded, merged):
    jmodel = jarch.simple_aniq(SYM, ensemble_size=2, merge_charge_networks=merged)
    pmodel = simple_aniq(SYM, ensemble_size=2, merge_charge_networks=merged, device=CPU)
    load_jax_arrays(pmodel, _leaves(jmodel))
    sp, co = padded
    pf, pq = _compare(jmodel, pmodel, sp, co, charge=1)
    assert (_np(pq.scalars)[sp < 0] == 0).all()
    assert (_np(pf)[sp < 0] == 0).all()
    np.testing.assert_allclose(_np(pq.scalars).sum(-1), 1.0, atol=1e-5)


@pytest.fixture(scope="module")
def mbis():
    jmodel = jzoo.ANImbis(pretrained=False)
    return jmodel, load_jax_arrays(models.ANImbis(device=CPU), _leaves(jmodel))


def test_animbis_matches_jax_on_a_cluster(mbis, cluster):
    jmodel, pmodel = mbis
    # the energy networks are ANI-2x's of the same seed
    fresh, ani2x = models.ANImbis(device=CPU), models.ANI2x(device=CPU)
    for w, w2 in zip(fresh.neural_networks.weights, ani2x.neural_networks.weights):
        assert torch.equal(w, w2)
    _, pq = _compare(jmodel, pmodel, *cluster)
    np.testing.assert_allclose(_np(pq.scalars).sum(-1), 0.0, atol=1e-5)


def test_single_point_with_a_charge(mbis, cluster):
    jmodel, pmodel = mbis
    sp, co = cluster
    js = jnp.asarray(sp)
    ref = jax.jit(
        lambda m, c: j_single_point(m, js, c, charge=1, atomic_energies=True)
    )(jmodel, jnp.asarray(co))
    out = single_point(pmodel, sp, co, charge=1, forces=True, atomic_energies=True)
    np.testing.assert_allclose(_np(out["energies"]), np.asarray(ref["energies"]), rtol=1e-6)
    np.testing.assert_allclose(
        _np(out["atomic_energies"]), np.asarray(ref["atomic_energies"]), atol=5e-5
    )
    # a model without charges takes neutral molecules only, as in JAX
    plain = simple_ani(SYM, device=CPU)
    with pytest.raises(ValueError, match="neutral"):
        single_point(plain, sp[:, :3], co[:, :3], charge=1)
    with pytest.raises(ValueError, match="neutral"):
        j_single_point(
            jarch.simple_ani(SYM), jnp.asarray(sp[:, :3]), jnp.asarray(co[:, :3]), charge=1
        )


def test_energy_paths_never_run_the_charge_networks():
    """`forward`, `grad` and `MolecularDynamics` read no charges; only
    `energies_and_charges` runs the charge networks."""
    model = simple_aniq(SYM, device=CPU)
    calls = []
    model.potentials["nnp"].charge_networks.register_forward_hook(
        lambda *args: calls.append(1)
    )
    species, coords, cell = make_water_box(96)
    sp, co = species[:, :30], coords[:, :30]
    model(sp, co)
    energies_and_forces(model, sp, co)
    single_point(model, sp, co, forces=True, ensemble_values=False)
    md = MolecularDynamics(model, species, cell=cell, pbc=True, device=CPU)
    md.run_nve(md.init(coords, temperature=300.0, generator=torch.Generator().manual_seed(0)), 2)
    assert calls == []
    model.energies_and_charges(sp, co)
    assert calls == [1]


_NO_JAX_LOAD = """
import sys
import numpy as np
from torchani_tpu_torch import convert, models
from torchani_tpu_torch.grad import energies_and_forces
g = dict(np.load(sys.argv[1]))
sd = {k[3:]: v for k, v in g.items() if k.startswith("sd.")}
model = convert.load_state_dict(models.ANImbis(device="cpu"), sd)
e, f = energies_and_forces(model, g["species"], g["coords"])
q = model.atomic_charges(g["species"], g["coords"]).detach().numpy()
print(float(np.abs(e.numpy() - g["energies"]).max()), float(np.abs(f.numpy() - g["forces"]).max()),
      float(np.abs(q - g["charges"]).max()))
roots = ("jax", "jaxlib", "flax", "torchani_tpu")
print(sorted(m for m in sys.modules if m.split(".")[0] in roots))
"""


def test_animbis_goldens_through_the_ports_converter():
    """The published key scheme (charge networks included) in a fresh
    interpreter that never imports JAX."""
    out = subprocess.run(
        [sys.executable, "-c", _NO_JAX_LOAD, f"{RESOURCES}/zoo_goldens_animbis.npz"],
        capture_output=True, text=True, check=True,
    ).stdout.splitlines()
    de, df, dq = (float(x) for x in out[0].split())
    assert de < 1e-5 and df < 1e-5 and dq < 1e-5
    assert out[1] == "[]"
