"""PyTorch port: element-index inputs (``periodic_table_index=False``)
against the atomic-number model and the JAX package, on the CPU.

A model given ``species_converter(znums)`` with ``periodic_table_index=False``
computes exactly what the atomic-number model computes from ``znums``:
energies and forces bit-equal (``tests/test_models.py``'s gate for JAX),
Hessians, frequencies, MD coordinates, `CachedSinglePoint`, FIRE and
replica masses equal; JAX's element-index model within atol 1e-5 Ha (f32
sums in another order).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchani_tpu as tt
from torchani_tpu_torch.arch import Assembler, simple_ani, simple_aniq
from torchani_tpu_torch.grad import energies_and_forces, hessians, single_point
from torchani_tpu_torch.interop import load_jax_arrays
from torchani_tpu_torch.md import CachedSinglePoint, MolecularDynamics
from torchani_tpu_torch.models import ANImbis
from torchani_tpu_torch.optimize import minimize_fire
from torchani_tpu_torch.replica import ReplicaExchange
from torchani_tpu_torch.testing import make_molecs, make_water_box

torch.set_num_threads(2)
CPU = "cpu"
SYM = ("H", "C", "N", "O")


def _leaves(tree):
    return {
        jax.tree_util.keystr(p): np.asarray(x)
        for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


def _indexed(model):
    """The same model (shared weights) taking element indices."""
    other = copy.copy(model)
    other.periodic_table_index = False
    return other


@pytest.fixture(scope="module")
def both_models():
    jmodel = tt.simple_ani(SYM, ensemble_size=2)
    pmodel = load_jax_arrays(simple_ani(SYM, ensemble_size=2, device=CPU), _leaves(jmodel))
    return jmodel, pmodel


def test_forward_and_forces_bit_equal(both_models):
    jmodel, pmodel = both_models
    species, coords = make_molecs(6, 10, seed=2)
    elem = pmodel.species_converter(torch.as_tensor(species))
    assert elem.tolist()[0][:3] == [SYM.index({1: "H", 6: "C", 7: "N", 8: "O"}[z])
                                    for z in species[0, :3]]
    e_z, f_z = energies_and_forces(pmodel, species, coords)
    e_i, f_i = energies_and_forces(_indexed(pmodel), elem, coords)
    assert torch.equal(e_z, e_i) and torch.equal(f_z, f_i)
    je = jmodel.replace(periodic_table_index=False)(jnp.asarray(elem.numpy()), jnp.asarray(coords))
    np.testing.assert_allclose(e_i.numpy(), np.asarray(je), atol=1e-5)
    assert torch.equal(pmodel(species, coords, atomic=True),
                       _indexed(pmodel)(elem, coords, atomic=True))


def test_vibrational_analysis_equal(both_models):
    _, pmodel = both_models
    species, coords, _ = make_water_box(96)
    species, coords = species[:, :6], coords[:, :6]
    elem = pmodel.species_converter(torch.as_tensor(species))
    z = single_point(pmodel, species, coords, forces=True, vibrational=True)
    i = single_point(_indexed(pmodel), elem, coords, forces=True, vibrational=True)
    for key in ("energies", "forces", "hessians", "freqs", "reduced_masses"):
        assert torch.equal(z[key], i[key]), key
    assert torch.equal(hessians(pmodel, species, coords), hessians(_indexed(pmodel), elem, coords))


def test_md_cached_fire_and_replica_equal(both_models):
    _, pmodel = both_models
    species, coords, cell = make_water_box(150, density_molec_per_a3=0.008)
    elem = pmodel.species_converter(torch.as_tensor(species))
    velocities = torch.as_tensor(np.random.RandomState(4).randn(150, 3).astype(np.float32) * 0.004)
    ends = []
    for model, sp in ((pmodel, species), (_indexed(pmodel), elem)):
        md = MolecularDynamics(model, sp, cell=cell, pbc=True, timestep_fs=0.25, device=CPU)
        start = md.init(coords).replace(velocities=velocities)
        ends.append((md, md.run_nve(start, 4)))
    (md_z, end_z), (md_i, end_i) = ends
    assert torch.equal(md_z.masses, md_i.masses)
    assert torch.equal(end_z.coords, end_i.coords) and torch.equal(end_z.forces, end_i.forces)
    # CachedSinglePoint and FIRE on a cluster of the box
    cl_sp, cl_el, cl_co = species[:, :9], elem[:, :9], torch.as_tensor(coords[0, :9])
    sp_z = CachedSinglePoint(pmodel, cl_sp, device=CPU)(cl_co)
    sp_i = CachedSinglePoint(_indexed(pmodel), cl_el, device=CPU)(cl_co)
    assert torch.equal(sp_z[0], sp_i[0]) and torch.equal(sp_z[1], sp_i[1])
    runs = [
        minimize_fire(lambda c, m=m, s=s: m(s, c[None])[0], cl_co, max_steps=6, fmax=1e-12,
                      device=CPU)
        for m, s in ((pmodel, cl_sp), (_indexed(pmodel), cl_el))
    ]
    assert torch.equal(runs[0].coords, runs[1].coords)
    rex = [ReplicaExchange(m, s, (300.0, 330.0), device=CPU)
           for m, s in ((pmodel, cl_sp), (_indexed(pmodel), cl_el))]
    assert torch.equal(rex[0].masses, rex[1].masses)


def test_the_flag_is_kept():
    asm = Assembler(periodic_table_index=False).set_symbols(("H", "O"))
    assert asm.assemble(device=CPU).periodic_table_index is False
    assert simple_ani(("H", "O"), device=CPU).periodic_table_index is True
    base = simple_ani(("H", "O"), device=CPU)
    q = simple_aniq(("H", "O"), device=CPU)
    assert q.periodic_table_index is True and base.atomic_numbers == (1, 8)
    mbis = ANImbis(device=CPU)
    assert mbis.periodic_table_index is True
    idx = _indexed(base)
    znums = idx.atomic_numbers_of(torch.as_tensor([[1, 0, -1]]))
    assert znums.tolist() == [[8, 1, -1]]
