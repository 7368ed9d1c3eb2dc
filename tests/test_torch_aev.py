"""PyTorch port: AEVs, the angular kernel's plain version and AEV gradients
against the JAX package and the reference goldens.

Tolerance atol 1e-5, rtol 1e-4 (as ``tests/test_pallas.py``): the angular
sums are taken in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchani_tpu as tt
from conftest import load_golden
from torchani_tpu.aev.computer import _angular_rows
from torchani_tpu.aev.pallas_kernels import angular_aev_pallas
from torchani_tpu.neighbors import Neighbors as JNeighbors
from torchani_tpu.neighbors import all_pairs as j_all_pairs
from torchani_tpu.neighbors import narrow_to_cutoff as j_narrow
from torchani_tpu_torch.aev import AEVComputer, angular_aev, angular_aev_reference
from torchani_tpu_torch.cutoffs import CutoffSmooth
from torchani_tpu_torch.neighbors import Neighbors, all_pairs, lane_permute

torch.set_num_threads(2)
CPU = "cpu"
ATOL, RTOL = 1e-5, 1e-4

FACTORIES = [("aev1x", "like_1x", 4), ("aev2x", "like_2x", 7)]


@pytest.fixture(scope="module")
def goldens():
    return load_golden("aev_goldens.npz")


@pytest.mark.parametrize("name,factory,ns", FACTORIES)
@pytest.mark.parametrize("strategy", ["plain", "cuda"])
def test_aev_matches_goldens_and_jax(goldens, name, factory, ns, strategy):
    elem = goldens[f"{name}_elem"]
    coords = goldens["coords"]
    aevc = getattr(AEVComputer, factory)(device=CPU, strategy=strategy)
    out = aevc(torch.as_tensor(elem), torch.as_tensor(coords)).numpy()
    np.testing.assert_allclose(out, goldens[f"{name}_values"], atol=ATOL, rtol=RTOL)
    ref = np.asarray(getattr(tt.AEVComputer, factory)()(jnp.asarray(elem), jnp.asarray(coords)))
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)


# cutoffs the angular kernel does not evaluate: the plain path takes them
OTHER_CUTOFFS = [
    ("dummy", "dummy"),
    ("smooth4", (CutoffSmooth(order=4), tt.cutoffs.CutoffSmooth(order=4))),
]


@pytest.mark.parametrize("label,cutoff", OTHER_CUTOFFS)
@pytest.mark.parametrize("strategy", ["plain", "auto"])
def test_aev_other_cutoffs_match_jax(goldens, label, cutoff, strategy):
    port_cut, jax_cut = (cutoff, cutoff) if isinstance(cutoff, str) else cutoff
    elem = goldens["aev2x_elem"][:3]
    coords = goldens["coords"][:3]
    aevc = AEVComputer.make(
        "ani2x", "ani2x", 7, strategy=strategy, cutoff_fn=port_cut, device=CPU,
        atom_block=5,
    )
    c = torch.as_tensor(coords).requires_grad_(True)
    out = aevc(torch.as_tensor(elem), c)
    (g,) = torch.autograd.grad(torch.sum(out**2), c)
    jaevc = tt.AEVComputer.make(
        tt.aev.terms.ANIRadial.like_2x(jax_cut), tt.aev.terms.ANIAngular.like_2x(jax_cut), 7
    )
    jelem = jnp.asarray(elem)
    ref = np.asarray(jaevc(jelem, jnp.asarray(coords)))
    ref_g = np.asarray(
        jax.grad(lambda x: jnp.sum(jaevc(jelem, x) ** 2))(jnp.asarray(coords))
    )
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=ATOL, rtol=RTOL)
    scale = np.abs(ref_g).max()
    np.testing.assert_allclose(g.numpy() / scale, ref_g / scale, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("label,cutoff", OTHER_CUTOFFS)
def test_kernel_strategy_rejects_other_cutoffs(goldens, label, cutoff):
    port_cut = cutoff if isinstance(cutoff, str) else cutoff[0]
    aevc = AEVComputer.make("ani2x", "ani2x", 7, strategy="cuda", cutoff_fn=port_cut, device=CPU)
    with pytest.raises(ValueError, match="cutoff"):
        aevc(torch.as_tensor(goldens["aev2x_elem"][:1]), torch.as_tensor(goldens["coords"][:1]))


def test_kernel_kwargs_follow_the_term_buffers():
    """The kernel's arguments are read once, and again after a buffer is
    written in place (as `interop.load_jax_arrays` does)."""
    aevc = AEVComputer.like_2x(device=CPU)
    first = aevc.kernel_kwargs()
    assert aevc.kernel_kwargs() is first
    assert first["zeta"] == pytest.approx(14.1) and first["cutoff_kind"] == "cosine"
    with torch.no_grad():
        aevc.angular.zeta.fill_(32.0)
    assert aevc.kernel_kwargs()["zeta"] == 32.0


def test_aev_pbc_matches_goldens():
    g = load_golden("aev_pbc_goldens.npz")
    aevc = AEVComputer.like_1x(device=CPU)
    out = aevc(
        torch.as_tensor(g["species"]), torch.as_tensor(g["coords"]),
        cell=torch.as_tensor(g["cell"]), pbc=torch.ones(3, dtype=torch.bool),
    ).numpy()
    np.testing.assert_allclose(out, g["values"], atol=ATOL, rtol=RTOL)


def _angular_lanes(factory, ns, seed, a=14):
    """The angular kernel's inputs from a JAX all-pairs table (as
    tests/test_pallas.py builds them)."""
    aevc = getattr(tt.AEVComputer, factory)()
    rng = np.random.RandomState(seed)
    elem = jnp.asarray(rng.choice(list(range(ns)), (1, a)))
    coords = jnp.asarray(rng.rand(1, a, 3).astype(np.float32) * 4)
    nbrs = j_narrow(j_all_pairs(aevc.radial.cutoff, elem, coords), aevc.angular.cutoff)
    dist = jnp.where(nbrs.mask, nbrs.dist, 1.0)[0]
    mask = nbrs.mask[0]
    nbr_elem = jnp.where(mask, jnp.take(elem[0], nbrs.idx[0]), -1)
    oh = jax.nn.one_hot(nbr_elem, ns, dtype=jnp.float32)
    return aevc, dist, nbrs.diff[0], mask, oh


@pytest.mark.parametrize("name,factory,ns", FACTORIES)
@pytest.mark.parametrize("cutoff_kind", ["cosine", "smooth"])
def test_angular_reference_matches_pallas_interpret(name, factory, ns, cutoff_kind):
    aevc, dist, diff, mask, oh = _angular_lanes(factory, ns, seed=0)
    angular = getattr(tt.aev.terms.ANIAngular, factory)(cutoff_kind)
    kw = dict(
        eta=float(angular.eta[0]), zeta=float(angular.zeta[0]),
        shifts=np.asarray(angular.shifts).tolist(),
        sections=np.asarray(angular.sections).tolist(),
        cutoff=angular.cutoff, cutoff_kind=cutoff_kind, num_species=ns,
    )
    pallas = np.asarray(angular_aev_pallas(dist, diff, mask, oh, interpret=True, **kw))
    rows = np.asarray(
        _angular_rows(angular, ns, dist, diff, mask.astype(jnp.float32), oh)
    )
    t = [torch.as_tensor(np.array(x)) for x in (dist, diff, mask, oh)]
    out = angular_aev_reference(*t, **kw).numpy()
    np.testing.assert_allclose(out, pallas, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(out, rows, atol=ATOL, rtol=RTOL)
    # the wrapper takes the plain version for CPU tensors, launching nothing
    before = angular_aev.launches
    np.testing.assert_array_equal(angular_aev(*t, **kw).numpy(), out)
    assert angular_aev.launches == before


def _coords_grad(aev_fn, elem, coords):
    c = torch.as_tensor(coords).requires_grad_(True)
    out = aev_fn(torch.as_tensor(elem), c)
    (g,) = torch.autograd.grad(torch.sum(out**2), c)
    return g.numpy()


@pytest.mark.parametrize("name,factory,ns", FACTORIES)
@pytest.mark.parametrize("strategy", ["plain", "cuda"])
def test_aev_coordinate_gradient_matches_jax(goldens, name, factory, ns, strategy):
    elem = goldens[f"{name}_elem"][:3]
    coords = goldens["coords"][:3]
    jaevc = getattr(tt.AEVComputer, factory)(strategy="xla")
    ref = np.asarray(
        jax.grad(lambda c: jnp.sum(jaevc(jnp.asarray(elem), c) ** 2))(jnp.asarray(coords))
    )
    # atom_block=5 exercises the blocked backward recompute
    aevc = getattr(AEVComputer, factory)(device=CPU, strategy=strategy, atom_block=5)
    g = _coords_grad(aevc, elem, coords)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(g / scale, ref / scale, atol=ATOL, rtol=RTOL)


def test_kernel_strategy_backward_matches_plain():
    """The autograd Function (kernel forward, kernel backward; on the CPU
    their plain versions, the backward in blocks) gives the plain path's
    gradients in dist and diff."""
    aevc, dist, diff, mask, oh = _angular_lanes("like_2x", 7, seed=3, a=20)
    pa = AEVComputer.like_2x(device=CPU)
    kw = pa.kernel_kwargs()
    from torchani_tpu_torch.aev.computer import _AngularAEVFunction, _angular_plain

    grads = []
    for fn in (
        lambda d, df, m, o: _AngularAEVFunction.apply(d, df, m, o, kw, 6),
        lambda d, df, m, o: _angular_plain(pa.angular, 7, 7, d, df, m, o),
    ):
        d = torch.as_tensor(np.array(dist)).requires_grad_(True)
        df = torch.as_tensor(np.array(diff)).requires_grad_(True)
        out = fn(d, df, torch.as_tensor(np.array(mask)), torch.as_tensor(np.array(oh)))
        grads.append(torch.autograd.grad(torch.sin(out * 3).sum(), (d, df)))
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL, rtol=RTOL)


def test_overflow_poisons_with_nan(goldens):
    aevc = AEVComputer.like_2x(device=CPU)
    elem = torch.as_tensor(goldens["aev2x_elem"][:2])
    coords = torch.as_tensor(goldens["coords"][:2])
    fine = aevc.compute_from_neighbors(elem, coords, all_pairs(5.1, elem, coords))
    assert torch.isfinite(fine).all()
    tight = all_pairs(5.1, elem, coords, capacity=3)
    assert bool(tight.overflow)
    assert torch.isnan(aevc.compute_from_neighbors(elem, coords, tight)).all()


def test_padding_and_isolated_atoms(goldens):
    aevc = AEVComputer.like_1x(device=CPU)
    elem = goldens["aev1x_elem"][:2]
    coords = goldens["coords"][:2]
    base = aevc(torch.as_tensor(elem), torch.as_tensor(coords)).numpy()
    pad_elem = np.concatenate([elem, np.full((2, 5), -1, dtype=elem.dtype)], axis=1)
    pad_coords = np.concatenate([coords, np.zeros((2, 5, 3), np.float32)], axis=1)
    padded = aevc(torch.as_tensor(pad_elem), torch.as_tensor(pad_coords)).numpy()
    np.testing.assert_allclose(padded[:, : elem.shape[1]], base, atol=1e-6)
    assert np.abs(padded[:, elem.shape[1]:]).max() == 0.0
    lone = aevc(torch.tensor([[0]]), torch.zeros((1, 1, 3))).numpy()
    assert np.abs(lone).max() == 0.0


@pytest.mark.parametrize("prefix", [24, 32, 200])
def test_angular_preslice_matches_jax(prefix):
    """A distance-sorted table of a dense cluster (49 lanes, past the 40 at
    which the angular table is repacked): cutting the angular table to a lane
    prefix first gives the JAX computer's AEVs with the same prefix.  32
    lanes hold every angular neighbor (at most 26 a row), so that AEV is the
    unsliced one; 24 lanes drop some (both packages the same); 200 is no
    cut."""
    rng = np.random.RandomState(3)
    a = 49
    elem = rng.randint(0, 7, (1, a))
    coords = (rng.rand(1, a, 3) * 7.0).astype(np.float32)
    nb = all_pairs(5.2, torch.as_tensor(elem), torch.as_tensor(coords))
    assert nb.capacity == 49
    order = torch.sort(torch.where(nb.mask, nb.dist, torch.inf), dim=-1, stable=True).indices[0]
    idx, mask, diff, dist, nelem = lane_permute(
        (nb.idx[0], nb.mask[0], nb.diff[0], nb.dist[0], nb.elem[0]), order
    )
    table = Neighbors(idx[None], mask[None], diff[None], dist[None], nb.overflow, nelem[None])
    jtable = JNeighbors(
        *(jnp.asarray(x.numpy()) for x in (table.idx, table.mask, table.diff, table.dist)),
        overflow=jnp.asarray(False), elem=jnp.asarray(table.elem.numpy()),
    )
    in_reach = int((mask & (dist <= 3.5)).sum(-1).max())
    assert 24 < in_reach <= 28 and int(mask[:, 32:].sum()) > 0

    aevc = AEVComputer.like_2x(device=CPU, angular_preslice=prefix)
    out = aevc.compute_from_neighbors(torch.as_tensor(elem), None, table).numpy()
    jaevc = tt.AEVComputer.like_2x().replace(angular_preslice=prefix)
    ref = np.asarray(jaevc.compute_from_neighbors(jnp.asarray(elem), None, jtable))
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)
    full = AEVComputer.like_2x(device=CPU).compute_from_neighbors(
        torch.as_tensor(elem), None, table
    ).numpy()
    if prefix == 24:
        assert np.abs(out - full).max() > 1e-3
    else:
        np.testing.assert_allclose(out, full, atol=ATOL, rtol=RTOL)
