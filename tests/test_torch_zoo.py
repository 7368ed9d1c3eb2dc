"""PyTorch port: the shared-weight containers (`SingleNN`, `ANISharedNetworks`,
`GenericEnsemble`) and the rest of the model zoo (`ANIr2s` in its four
solvents, `SnnANI2xr`) against the JAX package on the CPU, with weights
bridged through `torchani_tpu_torch.interop`; and the angular AEV at
SnnANI2xr's width (6 sections: Z = 48 terms per species pair) through the
plain path and through the kernel strategy, whose wrappers take the plain
versions on the CPU.

Tolerances: containers rtol 1e-5 (atol 1e-6); model energies rtol 1e-6,
forces atol 1e-5 Ha/A; AEVs and their gradients atol 1e-5, rtol 1e-4 (as
``tests/test_torch_aev.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchani_tpu import aev as jaev
from torchani_tpu import models as jzoo
from torchani_tpu import nn as jnn
from torchani_tpu.grad import energies_and_forces as j_energies_and_forces
from torchani_tpu_torch import models
from torchani_tpu_torch.aev import AEVComputer
from torchani_tpu_torch.aev.terms import ANIAngular, ANIRadial
from torchani_tpu_torch.grad import energies_and_forces
from torchani_tpu_torch.interop import load_jax_arrays
from torchani_tpu_torch.nn import ANISharedNetworks, GenericEnsemble, SingleNN
from torchani_tpu_torch.testing import make_water_box

torch.set_num_threads(2)
CPU = "cpu"
SYM = ("H", "C", "N", "O")
IN_DIM = 24


def _leaves(tree):
    return {
        jax.tree_util.keystr(p): np.asarray(x)
        for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


@pytest.fixture(scope="module")
def features():
    rng = np.random.RandomState(11)
    elem = rng.randint(0, len(SYM), (3, 9))
    elem[1, 6:] = -1
    elem[2, 4:] = -1
    aevs = rng.randn(3, 9, IN_DIM).astype(np.float32)
    return elem, aevs


def _containers(kind, n_members):
    """A JAX container (a `GenericEnsemble` of ``n_members`` when more than
    one) and the port's, at small widths."""
    keys = jax.random.split(jax.random.PRNGKey(3), n_members)
    if kind == "shared":
        members = [
            jnn.ANISharedNetworks.build(
                SYM, IN_DIM, shared_dims=(20,), dims={"H": (12, 8)}, default_dims=(10, 6),
                bias=True, key=k,
            )
            for k in keys
        ]
        ports = [
            ANISharedNetworks.build(
                SYM, IN_DIM, shared_dims=(20,), dims={"H": (12, 8)}, default_dims=(10, 6),
                bias=True, device=CPU,
            )
            for _ in range(n_members)
        ]
    else:
        members = [
            jnn.SingleNN.build(SYM, IN_DIM, (16, 12), embed_kind=kind, bias=True, key=k)
            for k in keys
        ]
        ports = [
            SingleNN.build(SYM, IN_DIM, (16, 12), embed_kind=kind, bias=True, device=CPU)
            for _ in range(n_members)
        ]
    if n_members == 1:
        return members[0], ports[0]
    return jnn.GenericEnsemble.from_members(members), GenericEnsemble.from_members(ports)


@pytest.mark.parametrize("n_members", [1, 3])
@pytest.mark.parametrize("kind", ["continuous", "one-hot", "none", "shared"])
def test_containers_match_jax(features, kind, n_members):
    jnet, pnet = _containers(kind, n_members)
    load_jax_arrays(pnet, _leaves(jnet))
    elem, aevs = features
    je, ja = jnp.asarray(elem), jnp.asarray(aevs)
    pe, pa = torch.as_tensor(elem), torch.as_tensor(aevs)
    for kw in (dict(), dict(atomic=True), dict(ensemble_values=True),
               dict(atomic=True, ensemble_values=True)):
        ref = np.asarray(jax.jit(lambda n, a: n(je, a, **kw))(jnet, ja))
        with torch.no_grad():
            out = pnet(pe, pa, **kw).numpy()
        assert out.shape == ref.shape, kw
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6, err_msg=str(kw))
    with torch.no_grad():
        atomic = pnet(pe, pa, atomic=True).numpy()
    assert (atomic[elem < 0] == 0).all()
    if n_members > 1:
        one = pnet.member(2)
        ref = np.asarray(jax.jit(lambda n, a: n(je, a, atomic=True))(jnet.member(2), ja))
        with torch.no_grad():
            np.testing.assert_allclose(one(pe, pa, atomic=True).numpy(), ref, rtol=1e-5, atol=1e-6)
        with pytest.raises(IndexError):
            pnet.member(3)


@pytest.fixture(scope="module")
def cluster():
    """The first 30 waters of the box, no cell."""
    species, coords, _ = make_water_box(96)
    return species[:, :90], coords[:, :90]


def _check_model(jmodel, pmodel, species, coords):
    load_jax_arrays(pmodel, _leaves(jmodel))
    js = jnp.asarray(species)
    je, jf = jax.jit(lambda m, c: j_energies_and_forces(m, js, c))(jmodel, jnp.asarray(coords))
    e, f = energies_and_forces(pmodel, species, coords)
    np.testing.assert_allclose(e.numpy(), np.asarray(je), rtol=1e-6)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), atol=1e-5, rtol=0)
    return e


@pytest.fixture(scope="module")
def r2s_energies(cluster):
    return {}


@pytest.mark.parametrize("solvent", ["water", "chcl3", "ch3cn", "vacuum"])
def test_anir2s_matches_jax(cluster, r2s_energies, solvent):
    pmodel = models.ANIr2s(solvent, device=CPU)
    jmodel = jzoo.ANIr2s(solvent, pretrained=False)
    assert pmodel.cutoff == jmodel.cutoff == float("inf")
    assert pmodel.potentials["repulsion_xtb"].cutoff == float("inf")
    np.testing.assert_array_equal(
        pmodel.energy_shifter.self_energies.numpy(), np.asarray(jmodel.energy_shifter.self_energies)
    )
    r2s_energies[solvent] = float(_check_model(jmodel, pmodel, *cluster)[0])
    if len(r2s_energies) == 4:
        assert len(set(r2s_energies.values())) == 4, "each solvent has its own energies"


def test_anir2s_factories_and_bad_solvent():
    for name, solvent in (("ANIr2s_water", "water"), ("ANIr2s_chcl3", "chcl3"),
                          ("ANIr2s_ch3cn", "ch3cn")):
        a = getattr(models, name)(device=CPU)
        b = models.ANIr2s(solvent, device=CPU)
        assert torch.equal(a.energy_shifter.self_energies, b.energy_shifter.self_energies)
    with pytest.raises(ValueError, match="Unsupported solvent"):
        models.ANIr2s("benzene", device=CPU)
    with pytest.raises(FileNotFoundError):
        models.SnnANI2xr(pretrained=True, device=CPU)


def test_snnani2xr_matches_jax(cluster):
    pmodel = models.SnnANI2xr(device=CPU)
    jmodel = jzoo.SnnANI2xr(pretrained=False)
    assert isinstance(pmodel.neural_networks, GenericEnsemble)
    assert pmodel.neural_networks.total_members_num == 8
    assert pmodel.aev_computer.out_dim == jmodel.aev_computer.out_dim == 7 * 16 + 28 * 48
    _check_model(jmodel, pmodel, *cluster)
    one = models.SnnANI2xr(model_index=3, device=CPU)
    assert isinstance(one.neural_networks, SingleNN)


@pytest.mark.parametrize("strategy", ["plain", "cuda"])
def test_angular_aev_at_48_terms_matches_jax(cluster, strategy):
    """SnnANI2xr's AEV (8 shifts x 6 sections): values and gradients."""
    kw = dict(start=0.9, cutoff=3.5, eta=12.5, zeta=14.1, num_shifts=8, num_sections=6,
              cutoff_fn="smooth")
    rkw = dict(start=0.9, cutoff=5.2, eta=19.7, num_shifts=16, cutoff_fn="smooth")
    aevc = AEVComputer.make(
        ANIRadial.cover_linearly(**rkw, device=CPU), ANIAngular.cover_linearly(**kw, device=CPU),
        7, cutoff_fn="smooth", strategy=strategy, device=CPU,
    )
    jaevc = jaev.AEVComputer.make(
        jaev.terms.ANIRadial.cover_linearly(**rkw), jaev.terms.ANIAngular.cover_linearly(**kw),
        7, cutoff_fn="smooth",
    )
    species, coords = cluster
    elem = np.where(species == 8, 3, 0)  # O and H in the ANI-2x element order
    elem[0, ::7] = 1  # some C, to meet more species pairs
    c = torch.as_tensor(coords).requires_grad_(True)
    out = aevc(torch.as_tensor(elem), c)
    assert out.shape[-1] == 7 * 16 + 28 * 48
    (g,) = torch.autograd.grad(torch.sum(out**2), c)
    jelem = jnp.asarray(elem)

    def total(x):
        a = jaevc(jelem, x)
        return jnp.sum(a**2), a

    (_, ref), ref_g = jax.jit(jax.value_and_grad(total, has_aux=True))(jnp.asarray(coords))
    ref, ref_g = np.asarray(ref), np.asarray(ref_g)
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=1e-5, rtol=1e-4)
    scale = np.abs(ref_g).max()
    np.testing.assert_allclose(g.numpy() / scale, ref_g / scale, atol=1e-5, rtol=1e-4)
