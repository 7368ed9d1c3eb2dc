"""PyTorch port: ANI-2x energies and forces against the reference goldens
and the JAX package, with the JAX model's weights carried over by
`torchani_tpu_torch.interop`.

Tolerances: the goldens at the BASELINE gate (1e-5 Ha, 1e-5 Ha/A); on the
periodic water box forces atol 1e-5 Ha/A, atomic energies atol 5e-5 Ha
(about 75 Ha each with the self energy, where one f32 ulp is ~7.6e-6), and
totals rtol 1e-6 (f32 sums over 600 atoms in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import load_golden
from torchani_tpu import models as jzoo
from torchani_tpu.convert import load_state_dict
from torchani_tpu.grad import energies_and_forces as j_energies_and_forces
from torchani_tpu.grad import single_point as j_single_point
from torchani_tpu.neighbors import CellList as JCellList
from torchani_tpu_torch import models
from torchani_tpu_torch.grad import energies, energies_and_forces, forces, single_point
from torchani_tpu_torch.interop import load_jax_arrays
from torchani_tpu_torch.neighbors import CellList
from torchani_tpu_torch.nn import AtomicNetworks
from torchani_tpu_torch.testing import make_water_box

torch.set_num_threads(2)
CPU = "cpu"


def _jax_arrays(jmodel):
    return {
        jax.tree_util.keystr(p): np.asarray(x)
        for p, x in jax.tree_util.tree_flatten_with_path(jmodel)[0]
    }


@pytest.fixture(scope="module")
def zoo():
    golden = load_golden("zoo_goldens_ani2x.npz")
    sd = {k[len("sd."):]: v for k, v in golden.items() if k.startswith("sd.")}
    jmodel = load_state_dict(jzoo.ANI2x(pretrained=False), sd)
    pmodel = load_jax_arrays(models.ANI2x(device=CPU), _jax_arrays(jmodel))
    return golden, jmodel, pmodel


def test_zoo_goldens_through_weight_bridge(zoo):
    golden, jmodel, pmodel = zoo
    e, f = energies_and_forces(pmodel, golden["species"], golden["coords"])
    assert np.abs(e.numpy() - golden["energies"]).max() < 1e-5
    assert np.abs(f.numpy() - golden["forces"]).max() < 1e-5
    je, jf = j_energies_and_forces(
        jmodel, jnp.asarray(golden["species"]), jnp.asarray(golden["coords"])
    )
    assert np.abs(e.numpy() - np.asarray(je)).max() < 1e-5
    assert np.abs(f.numpy() - np.asarray(jf)).max() < 1e-5


def test_zoo_single_point_ensemble_values(zoo):
    golden, jmodel, pmodel = zoo
    sp, co = golden["species"], golden["coords"]
    ref = j_single_point(
        jmodel, jnp.asarray(sp), jnp.asarray(co), ensemble_values=True,
        atomic_energies=True,
    )
    out = single_point(pmodel, sp, co, ensemble_values=True, atomic_energies=True)
    assert set(out) == set(ref)
    for key in ("energies", "ensemble_energies", "atomic_energies"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=1e-5)
    for key in ("ensemble_std", "qbcs"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=1e-6)


@pytest.fixture(scope="module")
def water():
    """600-atom periodic box (18.6 A, a 3x3x3 bucket grid), JAX side once."""
    species, coords, cell = make_water_box(600)
    pbc = np.ones(3, dtype=bool)
    jmodel = jzoo.ANI2x(pretrained=False).replace(neighborlist=JCellList())
    args = tuple(jnp.asarray(x) for x in (species, coords, cell, pbc))
    ref = j_single_point(jmodel, *args, forces=True, atomic_energies=True)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    pmodel = load_jax_arrays(models.ANI2x(device=CPU), _jax_arrays(jmodel))
    pmodel.neighborlist = CellList()
    return (species, coords, cell, pbc), ref, pmodel


@pytest.mark.parametrize("strategy", ["plain", "cuda"])
def test_water_box_matches_jax(water, strategy):
    inputs, ref, pmodel = water
    pmodel.aev_computer.strategy = strategy
    try:
        out = single_point(pmodel, *inputs, forces=True, atomic_energies=True)
    finally:
        pmodel.aev_computer.strategy = "auto"
    assert set(out) == {"energies", "forces", "atomic_energies"}
    np.testing.assert_allclose(out["forces"].numpy(), ref["forces"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        out["atomic_energies"].numpy(), ref["atomic_energies"], atol=5e-5, rtol=0
    )
    np.testing.assert_allclose(out["energies"].numpy(), ref["energies"], rtol=1e-6)


def test_water_box_entry_points_agree(water):
    inputs, ref, pmodel = water
    e, f = energies_and_forces(pmodel, *inputs)
    # the gradient's scatter-adds may sum in another order from call to call
    np.testing.assert_allclose(f.numpy(), forces(pmodel, *inputs).numpy(), atol=1e-7)
    np.testing.assert_array_equal(e.numpy(), energies(pmodel, *inputs).numpy())
    members = pmodel.members_energies(*inputs)
    assert members.shape == (8, 1)
    np.testing.assert_allclose(members.mean(0).detach().numpy(), e.numpy(), rtol=1e-6)


@pytest.mark.parametrize("single", [False, True], ids=["Ensemble", "AtomicNetworks"])
def test_networks_match_jax(zoo, single):
    """Per-species MLPs on the same AEV rows (species rows scattered through
    the batch, padding atoms included); atol 1e-5 on atomic energies."""
    _, jmodel, pmodel = zoo
    jnets = jmodel.neural_networks
    pnets = pmodel.neural_networks
    if single:
        jnets = jnets.member(2)
        pnets = AtomicNetworks(
            [torch.as_tensor(np.array(w)) for w in jnets.weights],
            [torch.as_tensor(np.array(b)) for b in jnets.biases],
            jnets.layer_dims, jnets.symbols,
        )
    rng = np.random.RandomState(7)
    elem = rng.randint(-1, 7, (3, 40))
    aevs = rng.rand(3, 40, 1008).astype(np.float32)
    for kw in (dict(atomic=True), dict(atomic=True, ensemble_values=not single)):
        ref = np.asarray(jnets(jnp.asarray(elem), jnp.asarray(aevs), **kw))
        out = pnets(torch.as_tensor(elem), torch.as_tensor(aevs), **kw)
        np.testing.assert_allclose(out.detach().numpy(), ref, atol=1e-5)


def test_one_member_model_matches_jax(water):
    """`ANI2x(model_index=3)`: the JAX factory's one-member model through the
    weight bridge, and the same member cut from the port's ensemble."""
    inputs, _, ensemble = water
    jmodel = jzoo.ANI2x(model_index=3, pretrained=False).replace(neighborlist=JCellList())
    ref = j_single_point(jmodel, *(jnp.asarray(x) for x in inputs), forces=True)
    pmodel = models.ANI2x(model_index=3, device=CPU)
    assert isinstance(pmodel.neural_networks, AtomicNetworks)
    assert pmodel.neural_networks.weights[0].shape == (7, 1008, 256)
    load_jax_arrays(pmodel, _jax_arrays(jmodel))
    pmodel.neighborlist = CellList()
    out = single_point(pmodel, *inputs, forces=True)
    np.testing.assert_allclose(out["forces"].numpy(), np.asarray(ref["forces"]), atol=1e-5, rtol=0)
    np.testing.assert_allclose(out["energies"].numpy(), np.asarray(ref["energies"]), rtol=1e-6)
    # the JAX models of this module share one seed, so member 3 of the bridged
    # ensemble is this model; `member` copies, it does not alias
    member = ensemble.neural_networks.member(3)
    for w, v in zip(member.weights, pmodel.neural_networks.weights):
        assert torch.equal(w, v)
    assert member.weights[0].data_ptr() != ensemble.neural_networks.weights[0][3].data_ptr()
    with pytest.raises(IndexError):
        ensemble.neural_networks.member(8)


def test_species_ranges_give_the_same_energies(water):
    """Networks and AEVs told the (sorted) species rows on the host equal
    the ones that read them from the tensor."""
    _, _, pmodel = water
    rng = np.random.RandomState(3)
    elem = np.sort(rng.choice([-1, 0, 3, 5], 30))[None]
    aevs = torch.as_tensor(rng.rand(1, 30, 1008).astype(np.float32))
    vals, starts = np.unique(elem[0], return_index=True)
    stops = list(starts[1:]) + [30]
    ranges = tuple((int(v), int(s), int(e)) for v, s, e in zip(vals, starts, stops) if v >= 0)
    nets = pmodel.neural_networks
    out = nets(torch.as_tensor(elem), aevs, atomic=True, species_ranges=ranges)
    ref = nets(torch.as_tensor(elem), aevs, atomic=True)
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(), atol=1e-6)
    assert (out[0, : starts[1]] == 0).all()  # padding atoms


def test_random_init_is_seeded():
    a = models.ANI2x(seed=3, device=CPU).neural_networks.weights[0]
    b = models.ANI2x(seed=3, device=CPU).neural_networks.weights[0]
    c = models.ANI2x(seed=4, device=CPU).neural_networks.weights[0]
    assert a.shape == (8, 7, 1008, 256)
    assert torch.equal(a, b) and not torch.equal(a, c)
    # zero padding past each species' true widths (C's first layer is 224)
    assert torch.count_nonzero(a[:, 1, :, 224:]) == 0


def test_weight_bridge_rejects_bad_input(zoo):
    _, jmodel, _ = zoo
    arrays = _jax_arrays(jmodel)
    port = models.ANI2x(device=CPU)
    with pytest.raises(KeyError):
        load_jax_arrays(port, {**arrays, ".potentials['nnp'].nope": np.zeros(1)})
    missing = dict(arrays)
    missing.pop(".energy_shifter.self_energies")
    with pytest.raises(KeyError):
        load_jax_arrays(port, missing)
    bad = dict(arrays)
    bad[".energy_shifter.self_energies"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError):
        load_jax_arrays(port, bad)


def test_pretrained_waits_for_converter():
    with pytest.raises(NotImplementedError):
        models.ANI2x(pretrained=True, device=CPU)
