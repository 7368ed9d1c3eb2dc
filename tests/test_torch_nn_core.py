"""PyTorch port: `nn.core` (the building blocks and the inference container
names) and `nn.partition` (species-blocked evaluation) against the JAX
package, with `tests/test_nn_partition.py`'s cases.

Tolerances: the permutation tables and caps exactly; block/unblock round
trips exactly; layers atol 1e-6 (f32 products of the same weights);
blocked against padded energies atol 1e-6 Ha and forces 1e-5 Ha/A, as the
JAX test holds them; port against JAX energies atol 1e-5 Ha and forces
1e-5 Ha/A (f32 sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchani_tpu as tt
import torchani_tpu.nn as jnn
import torchani_tpu.nn.partition as jpart
import torchani_tpu_torch as pt
import torchani_tpu_torch.nn as pnn
import torchani_tpu_torch.nn.partition as ppart
from torchani_tpu.grad import energies_and_forces as j_energies_and_forces
from torchani_tpu_torch.arch import simple_ani
from torchani_tpu_torch.convert import load_state_dict, save_state_dict
from torchani_tpu_torch.grad import energies_and_forces
from torchani_tpu_torch.interop import load_jax_arrays
from torchani_tpu_torch.testing import make_molecs

torch.set_num_threads(2)
CPU = "cpu"
SYM = ("H", "C", "N", "O")


def _leaves(tree):
    return {
        jax.tree_util.keystr(p): np.asarray(x)
        for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


def _with_partition(jmodel, caps):
    nnp = jmodel.potentials["nnp"]
    pots = dict(jmodel.potentials)
    pots["nnp"] = nnp.replace(neural_networks=nnp.neural_networks.replace(partition=caps))
    return jmodel.replace(potentials=pots)


@pytest.fixture(scope="module")
def batch():
    species, coords = make_molecs(24, 11, seed=5)
    return species, coords


@pytest.fixture(scope="module")
def both_models():
    jmodel = tt.simple_ani(SYM, ensemble_size=2)
    pmodel = load_jax_arrays(simple_ani(SYM, ensemble_size=2, device=CPU), _leaves(jmodel))
    return jmodel, pmodel


def test_activation_and_embeddings():
    x = np.linspace(-3, 3, 13, dtype=np.float32)
    np.testing.assert_allclose(
        pnn.TightCELU()(torch.as_tensor(x)).numpy(), np.asarray(jnn.TightCELU()(jnp.asarray(x))),
        atol=1e-7,
    )
    elem = np.asarray([[0, 3, -1, 2], [1, 1, 0, -1]])
    oh = pnn.AtomicOneHot(SYM)
    assert oh.num_species == 4 and oh.atomic_numbers == jnn.AtomicOneHot(SYM).atomic_numbers
    np.testing.assert_array_equal(
        oh(torch.as_tensor(elem)).numpy(), np.asarray(jnn.AtomicOneHot(SYM)(jnp.asarray(elem)))
    )
    jemb = jnn.AtomicEmbedding.make(SYM, dim=5)
    pemb = pnn.AtomicEmbedding(SYM, torch.as_tensor(np.array(jemb.weight)))
    np.testing.assert_array_equal(
        pemb(torch.as_tensor(elem)).detach().numpy(), np.asarray(jemb(jnp.asarray(elem)))
    )
    made = pnn.AtomicEmbedding.make(SYM, dim=5, device=CPU)
    assert tuple(made.weight.shape) == (4, 5) and made.num_species == 4


def test_atomic_container_is_zero():
    elem = torch.as_tensor([[0, 1, -1]])
    c = pnn.AtomicContainer()
    assert c(elem).shape == (1,) and c(elem, atomic=True).shape == (1, 3)
    assert float(c(elem).abs().sum()) == 0.0
    assert c.to_infer_model(use_mnp=True) is c and c.get_active_members_num() == 1


@pytest.mark.parametrize("bias,activation", [(True, "celu"), (False, "gelu")])
def test_atomic_network_and_bmm(bias, activation):
    dims = (12, 9, 7, 1)
    jnets = [
        jnn.AtomicNetwork.make(dims, activation, bias, key=jax.random.PRNGKey(i)) for i in range(3)
    ]
    if bias:  # nonzero biases, so that they are checked
        jnets = [n.replace(biases=tuple(b + 0.1 * (i + 1) for b in n.biases))
                 for i, n in enumerate(jnets)]
    pnets = [
        pnn.AtomicNetwork(
            [torch.as_tensor(np.array(w)) for w in n.weights],
            None if n.biases is None else [torch.as_tensor(np.array(b)) for b in n.biases],
            activation,
        )
        for n in jnets
    ]
    x = np.random.RandomState(0).randn(3, 5, 12).astype(np.float32)
    assert pnets[0].layer_dims == jnets[0].layer_dims == dims
    for jn_, pn_, xe in zip(jnets, pnets, x):
        np.testing.assert_allclose(
            pn_(torch.as_tensor(xe)).detach().numpy(), np.asarray(jn_(jnp.asarray(xe))), atol=1e-6
        )
    jbmm = jnn.BmmAtomicNetwork.from_networks(jnets)
    pbmm = pnn.BmmAtomicNetwork.from_networks(pnets)
    assert isinstance(pbmm.layers[0], pnn.BmmLinear)
    np.testing.assert_allclose(
        pbmm(torch.as_tensor(x)).detach().numpy(), np.asarray(jbmm(jnp.asarray(x))), atol=1e-6
    )
    made = pnn.AtomicNetwork.make(dims, activation, bias, device=CPU)
    assert made.layer_dims == dims and (made.biases is None) == (not bias)
    with pytest.raises(ValueError):
        pnn.AtomicNetwork.make((4, 0, 1), device=CPU)


def test_bmm_ensemble_and_mnp(both_models):
    _, pmodel = both_models
    ens = pmodel.neural_networks
    assert pnn.BmmEnsemble(ens) is ens and pnn.MNPNetworks(ens, use_mnp=True) is ens
    with pytest.raises(TypeError):
        pnn.BmmEnsemble(ens.member(0))
    with pytest.raises(TypeError):
        jnn.BmmEnsemble(jnn.AtomicNetworks.like_1x())


def test_sequential_and_aliases():
    with pytest.warns(UserWarning, match="discouraged"):
        seq = pnn.Sequential(lambda x, c, p: x + 1, lambda x, c, p: x * 2)
    assert seq(3) == 8
    assert pt.ANIModel is pt.ANINetworks is pnn.ANIModel is pnn.ANINetworks is pnn.AtomicNetworks
    assert pt.EnergyShifter is pt.SelfEnergy


def test_species_blocks_match_jax():
    rng = np.random.RandomState(0)
    elem = rng.randint(-1, 4, size=(50,))
    caps = ppart.measure_caps([elem], 4, quantum=8)
    assert caps == jpart.measure_caps([elem], 4, quantum=8)
    for cs in (caps, (8, 8, 8, 8), (16, 0, 24, 16)):
        pb = ppart.species_blocks(torch.as_tensor(elem), cs)
        jb = jpart.species_blocks(jnp.asarray(elem, jnp.int32), cs)
        np.testing.assert_array_equal(pb.inv.numpy(), np.asarray(jb.inv))
        np.testing.assert_array_equal(pb.pos.numpy(), np.asarray(jb.pos))
        assert bool(pb.ok) == bool(jb.ok) and pb.offsets == jb.offsets
    pst = ppart.species_blocks_static(np.asarray([2, -1, 0, 0, 3, -1, 2, 0]))
    jst = jpart.species_blocks_static(np.asarray([2, -1, 0, 0, 3, -1, 2, 0], np.int32))
    assert pst.caps == jst.caps
    np.testing.assert_array_equal(pst.inv.numpy(), np.asarray(jst.inv))
    np.testing.assert_array_equal(pst.pos.numpy(), np.asarray(jst.pos))
    assert ppart.supports(4, 1 << 40) and not jpart.supports(4, 1 << 22)


def test_block_unblock_roundtrip():
    """`tests/test_nn_partition.py`'s round trip: real rows come back
    exactly, padding rows as 0, and the backward is the same permutation."""
    rng = np.random.RandomState(0)
    elem = torch.as_tensor(rng.randint(-1, 4, size=(50,)))
    x = torch.as_tensor(rng.randn(50, 7).astype(np.float32)).requires_grad_(True)
    blocks = ppart.species_blocks(elem, ppart.measure_caps([elem], 4, quantum=8))
    y = ppart.unblock_rows(ppart.block_rows(x, blocks), blocks)
    real = elem.numpy() >= 0
    np.testing.assert_array_equal(y.detach().numpy()[real], x.detach().numpy()[real])
    assert (y.detach().numpy()[~real] == 0).all()
    (g,) = torch.autograd.grad(torch.sum(y * x), x)
    np.testing.assert_allclose(g.numpy()[real], 2 * x.detach().numpy()[real], rtol=1e-6)
    assert (g.numpy()[~real] == 0).all()


def test_blocked_matches_padded_and_jax(both_models, batch):
    jmodel, pmodel = both_models
    species, coords = batch
    elem = pmodel._convert(species)
    caps = ppart.measure_caps([elem], 4, quantum=8)
    e0, f0 = energies_and_forces(pmodel, species, coords)
    pmodel.neural_networks.partition = caps
    try:
        e1, f1 = energies_and_forces(pmodel, species, coords)
    finally:
        pmodel.neural_networks.partition = None
    np.testing.assert_allclose(e1.numpy(), e0.numpy(), atol=1e-6)
    np.testing.assert_allclose(f1.numpy(), f0.numpy(), atol=1e-5)
    jp = _with_partition(jmodel, caps)
    je, jf = jax.jit(lambda s, c: j_energies_and_forces(jp, s, c))(
        jnp.asarray(species), jnp.asarray(coords)
    )
    np.testing.assert_allclose(e1.numpy(), np.asarray(je), atol=1e-5)
    np.testing.assert_allclose(f1.numpy(), np.asarray(jf), atol=1e-5)


def test_partition_overflow_poisons(both_models, batch):
    jmodel, pmodel = both_models
    species, coords = batch
    member = pmodel.neural_networks.member(0)
    assert member.partition is None
    pmodel.neural_networks.partition = (8, 8, 8, 8)
    try:
        assert pmodel.neural_networks.member(1).partition == (8, 8, 8, 8)
        e = pmodel(species, coords)
    finally:
        pmodel.neural_networks.partition = None
    assert bool(torch.isnan(e).all())
    je = jax.jit(lambda s, c: _with_partition(jmodel, (8, 8, 8, 8))(s, c))(
        jnp.asarray(species), jnp.asarray(coords)
    )
    assert bool(jnp.all(jnp.isnan(je)))
    with pytest.raises(ValueError, match="3 entries for 4 species"):
        pmodel.neural_networks.partition = (8, 8, 8)


def test_partition_survives_the_bridges(both_models, batch):
    """`convert` and `interop` fill the networks in place and keep the
    field; `interop` also carries it from the JAX model's static fields."""
    jmodel, pmodel = both_models
    species, coords = batch
    caps = (128, 64, 64, 64)
    leaves = _leaves(jmodel)
    leaves[".potentials['nnp'].neural_networks.partition"] = np.asarray(caps)
    fresh = load_jax_arrays(simple_ani(SYM, ensemble_size=2, device=CPU), leaves)
    assert fresh.neural_networks.partition == caps
    fresh = load_state_dict(fresh, save_state_dict(pmodel))
    assert fresh.neural_networks.partition == caps
    np.testing.assert_allclose(
        fresh(species, coords).detach().numpy(), pmodel(species, coords).detach().numpy(), atol=1e-6
    )
    leaves[".potentials['nnp'].neural_networks.partition"] = np.zeros((0,), np.int64)
    assert load_jax_arrays(fresh, leaves).neural_networks.partition is None


def test_partition_waits_for_nothing(both_models, batch, monkeypatch):
    """With ``partition`` the networks read nothing back from the tensors:
    `torch.unique` and `torch.nonzero` are never called."""
    _, pmodel = both_models
    species, coords = batch
    elem = pmodel._convert(species)
    aevs = pmodel.aev_computer(elem, torch.as_tensor(coords))

    def refuse(*args, **kwargs):
        raise AssertionError("read back from the device")

    nets = pmodel.neural_networks
    nets.partition = ppart.measure_caps([elem], 4, quantum=8)
    monkeypatch.setattr(torch, "unique", refuse)
    monkeypatch.setattr(torch, "nonzero", refuse)
    try:
        e = nets(elem, aevs)
    finally:
        nets.partition = None
    assert bool(torch.isfinite(e).all())


def test_zero_caps_skip_absent_species(both_models, monkeypatch):
    """A budget of 0 runs no network for that species; the energies are the
    default container's."""
    _, pmodel = both_models
    species, coords = make_molecs(8, 10, seed=3, znums=(1, 6, 8))  # no nitrogen
    nets = pmodel.neural_networks
    e0 = pmodel(species, coords)
    ran = []
    mlp = type(nets)._species_mlp
    monkeypatch.setattr(type(nets), "_species_mlp",
                        lambda self, s, x: ran.append(s) or mlp(self, s, x))
    nets.partition = (64, 16, 0, 16)
    try:
        e1 = pmodel(species, coords)
    finally:
        nets.partition = None
    assert sorted(ran) == [0, 1, 3]
    np.testing.assert_allclose(e1.detach().numpy(), e0.detach().numpy(), atol=1e-6)
