"""PyTorch port: third and higher derivatives through the angular kernels'
path (`_AngularAEVBwdBwdFunction`'s backward, `_bwd_bwd_vjp`) against the
JAX package's, on the CPU.

The ``vib_goldens.npz`` HCNO model in both packages, on a padded batch of
two molecules: the goldens' water and a water beside a methane (8 atoms,
inter-molecular angles within the cutoff).  For seeded directions u, v, w:
the directional third derivative ``grad <grad <grad E, u>, v>``, the
fourth-order vector ``grad <that, w>``, and the weight gradient of the
Hessian-vector loss ``sum (H w)^2``.  The port's ``"cuda"`` strategy (the
kernels' plain versions on the CPU; the third order recomputes through
`angular_grid`) and its ``"plain"`` one against JAX's ``"pallas"`` (the
Pallas forward in interpret mode, whose backward differentiates an XLA
recompute): scaled by max|ref|, atol 1e-5, rtol 1e-4 (f32 sums in another
order, as ``tests/test_torch_angular_grad.py``).

JAX's fourth-order vector is taken forward over reverse (three `jax.jvp`
over `jax.grad`, equal to ``grad <that, w>`` as the fourth derivative is
symmetric) on the ``"xla"`` strategy: the ``"pallas"`` one is a
`jax.custom_vjp`, which has no forward mode, and its derivatives of every
order are those of the same XLA recompute.  Four reverse passes on
``"pallas"`` took twice as long to compile.

`_bwd_bwd_vjp` alone: against autograd through K3bb's closed form
(`angular_aev_bwd_bwd_reference`, in float64) on random lanes, at the same
tolerance; atom blocks give the unblocked result.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchani_tpu as tt
from torchani_tpu.convert import load_state_dict as jload_state_dict
from torchani_tpu_torch import convert
from torchani_tpu_torch.aev import computer
from torchani_tpu_torch.aev.computer import _bwd_bwd_vjp
from torchani_tpu_torch.aev.kernels import angular_aev_bwd_bwd_reference, angular_grid
from torchani_tpu_torch.arch import simple_ani
from torchani_tpu_torch.interop import _resolve

from conftest import load_golden
from test_torch_angular_grad import CASES, _kwargs, _random_lanes, _width

torch.set_num_threads(2)
ATOL, RTOL = 1e-5, 1e-4

#: a water and a methane 2.9 A apart (A): O-H and C-H within the angular cutoff
WATER_METHANE = np.array([
    [0.0, 0.0, 0.119], [0.0, 0.763, -0.477], [0.0, -0.763, -0.477],
    [2.9, 0.2, 0.1], [3.529, 0.829, 0.729], [2.271, -0.429, 0.729],
    [2.271, 0.829, -0.529], [3.529, -0.429, -0.529],
], np.float32)


def _assert_close(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    scale = np.abs(ref).max()
    assert scale > 0
    np.testing.assert_allclose(out / scale, ref / scale, atol=ATOL, rtol=RTOL)


@pytest.fixture(scope="module")
def models():
    """The goldens' model in both packages (JAX's on its Pallas path), the
    padded batch and the seeded directions u, v, w."""
    g = load_golden("vib_goldens.npz")
    sd = {k[3:]: v for k, v in g.items() if k.startswith("sd.")}
    pmodel = convert.load_state_dict(
        simple_ani(("H", "C", "N", "O"), ensemble_size=1, device="cpu"), sd)
    jmodel = jload_state_dict(tt.simple_ani(("H", "C", "N", "O"), ensemble_size=1), sd)
    nnp = jmodel.potentials["nnp"]
    nnp = nnp.replace(aev_computer=nnp.aev_computer.set_strategy("pallas"))
    jmodel = jmodel.replace(potentials={**jmodel.potentials, "nnp": nnp})
    a = WATER_METHANE.shape[0]
    species = np.full((2, a), -1, np.int64)
    coords = np.zeros((2, a, 3), np.float32)
    n0 = g["species"].shape[1]
    species[0, :n0], coords[0, :n0] = g["species"][0], g["coords"][0]
    species[1], coords[1] = [8, 1, 1, 6, 1, 1, 1, 1], WATER_METHANE
    rng = np.random.RandomState(20)
    dirs = [rng.randn(2, a, 3).astype(np.float32) * (species >= 0)[..., None] for _ in range(3)]
    return pmodel, jmodel, species, coords, dirs


def _leaves(tree):
    return {
        jax.tree_util.keystr(p): np.asarray(x)
        for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


@pytest.fixture(scope="module")
def jax_refs(models):
    """JAX's third derivative and Hessian-loss weight gradients (on
    ``"pallas"``, in one compile) and its fourth-order vector (forward
    over reverse, on ``"xla"``)."""
    _, jmodel, species, coords, (u, v, w) = models
    sp = jnp.asarray(species)

    def energy(m, x):
        return jnp.sum(m(sp, x))

    def hvp(m, x, d):
        return jax.grad(lambda y: jnp.sum(jax.grad(energy, argnums=1)(m, y) * d))(x)

    def third(m, x):
        return jax.grad(lambda y: jnp.sum(hvp(m, y, u) * v))(x)

    nnp = jmodel.potentials["nnp"]

    def with_nnp(**changes):
        return jmodel.replace(potentials={**jmodel.potentials, "nnp": nnp.replace(**changes)})

    @jax.jit
    def refs(x, nets):
        # the Pallas path reads its constants from the model on the host:
        # only the networks are traced
        wg = jax.grad(lambda n: jnp.sum(hvp(with_nnp(neural_networks=n), x, w) ** 2))(nets)
        return third(jmodel, x), wg

    xla_model = with_nnp(aev_computer=nnp.aev_computer.set_strategy("xla"))

    def tangent(f, d):
        return lambda y: jax.jvp(f, (y,), (jnp.asarray(d),))[1]

    fourth = tangent(tangent(tangent(lambda y: jax.grad(energy, argnums=1)(xla_model, y), u), v), w)
    x = jnp.asarray(coords)
    t, wg = refs(x, nnp.neural_networks)
    q = jax.jit(fourth)(x)
    return np.asarray(t), np.asarray(q), _leaves(with_nnp(neural_networks=wg))


def _port(pmodel, species, coords, dirs, strategy, atom_block=None):
    """The port's three quantities under ``strategy``, and the calls each
    angular function of the kernel path took for the third derivative."""
    u, v, w = (torch.as_tensor(d) for d in dirs)
    aevc = pmodel.aev_computer
    aevc.strategy, aevc.atom_block = strategy, atom_block
    calls = {}
    wrapped = {}
    for name in ("angular_aev", "angular_aev_bwd", "angular_aev_bwd_bwd"):
        real = getattr(computer, name)

        def counted(*args, _real=real, _name=name, **kwargs):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*args, **kwargs)

        wrapped[name] = real
        setattr(computer, name, counted)
    try:
        def grad_e(x):
            (f,) = torch.autograd.grad(pmodel(species, x).sum(), x, create_graph=True)
            return f

        def hvp(x, d):
            (h,) = torch.autograd.grad((grad_e(x) * d).sum(), x, create_graph=True)
            return h

        x = torch.as_tensor(coords).clone().requires_grad_(True)
        grid_before = angular_grid.calls
        (t,) = torch.autograd.grad((hvp(x, u) * v).sum(), x, create_graph=True)
        third_calls = dict(calls, angular_grid=angular_grid.calls - grid_before)
        (q,) = torch.autograd.grad((t * w).sum(), x)
        x = torch.as_tensor(coords).clone().requires_grad_(True)
        params = dict(pmodel.named_parameters())
        wg = torch.autograd.grad((hvp(x, w) ** 2).sum(), list(params.values()))
    finally:
        for name, real in wrapped.items():
            setattr(computer, name, real)
        aevc.strategy, aevc.atom_block = "auto", None
    return t.detach().numpy(), q.numpy(), dict(zip(params, wg)), third_calls


@pytest.fixture(scope="module")
def port_results(models):
    pmodel, _, species, coords, dirs = models
    return {s: _port(pmodel, species, coords, dirs, s) for s in ("cuda", "plain")}


@pytest.mark.parametrize("strategy", ["cuda", "plain"])
def test_third_derivative_matches_jax(jax_refs, port_results, strategy):
    t = port_results[strategy][0]
    _assert_close(t, jax_refs[0])
    _assert_close(t, port_results["plain"][0])
    assert (t[0, 3:] == 0).all()  # the padded atoms


@pytest.mark.parametrize("strategy", ["cuda", "plain"])
def test_fourth_order_matches_jax(jax_refs, port_results, strategy):
    q = port_results[strategy][1]
    _assert_close(q, jax_refs[1])
    _assert_close(q, port_results["plain"][1])


@pytest.mark.parametrize("strategy", ["cuda", "plain"])
def test_hessian_loss_weight_gradients_match_jax(models, jax_refs, port_results, strategy):
    """The weight gradient of ``sum (H w)^2``: the backward of K3bb with
    respect to its cotangent, and through its g to the networks."""
    pmodel = models[0]
    grads = port_results[strategy][2]
    by_id = {id(p): name for name, p in pmodel.named_parameters()}
    compared = 0
    for path, jg in jax_refs[2].items():
        try:
            name = by_id.get(id(_resolve(pmodel, path)))
        except KeyError:
            continue
        if name is None:
            continue  # a constant of the JAX tree, a buffer in the port
        scale = np.abs(jg).max() + 1e-12
        ours = grads[name].numpy()
        np.testing.assert_allclose(ours / scale, jg / scale, atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(
            ours / scale, port_results["plain"][2][name].numpy() / scale, atol=ATOL, rtol=RTOL)
        compared += 1
    assert compared == len(grads) > 0
    assert any(np.abs(t.numpy()).max() > 0 for t in grads.values())


def test_third_derivative_calls_and_blocks(models, port_results):
    """The third derivative on the kernel path: K3 once, K3b and K3bb three
    times each (the third pass reaches K3b's first node through the lanes'
    second derivative, and K3b's second node), and one `angular_grid` call a
    recompute block beside the forward's plain version; atom blocks of one
    atom give the one-block result."""
    pmodel, _, species, coords, dirs = models
    assert port_results["cuda"][3] == {
        "angular_aev": 1, "angular_aev_bwd": 3, "angular_aev_bwd_bwd": 3, "angular_grid": 2,
    }
    assert port_results["plain"][3] == {"angular_grid": 1}
    t, q, _, calls = _port(pmodel, species, coords, dirs, "cuda", atom_block=2)
    atoms = species.size
    assert max(1, 2 * computer._GRID_BYTES // computer._THIRD_ORDER_GRID_BYTES) == 1
    assert calls["angular_grid"] == 1 + atoms
    np.testing.assert_allclose(t, port_results["cuda"][0], atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(q, port_results["cuda"][1], atol=1e-5, rtol=1e-5)


def _vjp_inputs(lanes, width, seed, dtype):
    n, ka = lanes[0].shape
    rng = np.random.RandomState(seed)
    g = rng.randn(n, width)
    u = (rng.randn(n, ka), rng.randn(n, ka, 3))
    w = (rng.randn(n, width), rng.randn(n, ka), rng.randn(n, ka, 3))
    to = lambda x: torch.as_tensor(x, dtype=dtype)  # noqa: E731
    ins = (to(g), to(lanes[0]), to(lanes[1]), to(u[0]), to(u[1]))
    return ins, torch.as_tensor(lanes[2]), to(lanes[3]), tuple(map(to, w))


@pytest.mark.parametrize("version,cutoff_kind,ns", CASES)
def test_bwd_bwd_vjp_matches_autograd_of_the_closed_form(version, cutoff_kind, ns):
    """`_bwd_bwd_vjp` (f32) against autograd through K3bb's closed form in
    float64: both are K3bb's derivative, cutoff terms included; blocks of 3
    atoms give the unblocked result."""
    kw = _kwargs(version, cutoff_kind, ns)
    lanes = _random_lanes(30, 10, ns, seed=21)
    ins, mask, oh, w = _vjp_inputs(lanes, _width(kw), 22, torch.float32)
    with torch.no_grad():  # as in a backward that takes no graph
        out = _bwd_bwd_vjp(kw, 30, ins, mask, oh, w)
        blocked = _bwd_bwd_vjp(kw, 3, ins, mask, oh, w)
    ins64, _, oh64, w64 = _vjp_inputs(lanes, _width(kw), 22, torch.float64)
    ins64 = [t.requires_grad_(True) for t in ins64]
    outs = angular_aev_bwd_bwd_reference(ins64[0], ins64[1], ins64[2], mask, oh64, *ins64[3:], **kw)
    psi = sum(torch.sum(o * c) for o, c in zip(outs, w64))
    ref = torch.autograd.grad(psi, ins64)
    for o, r in zip(out, ref):
        _assert_close(o.numpy(), r.float().numpy())
    assert all((o[::7] == 0).all() for o in out)  # rows with no lane
    for a, b in zip(blocked, out):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=1e-6)
