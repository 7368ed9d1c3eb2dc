"""PyTorch port: the angular AEV's backward (K3b's plain version,
`angular_aev_bwd_reference`) against the JAX package's own backward and
against autograd of the plain forward, on the CPU.

The JAX side is ``jax.vjp`` of ``_angular_pallas_op``: the Pallas forward in
interpret mode and ``_angular_pallas_bwd``, which differentiates an XLA
recompute.  Tolerance: scaled by max|ref|, atol 1e-5, rtol 1e-4 (f32 sums in
another order, as ``tests/test_torch_aev.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchani_tpu as tt
from torchani_tpu.aev.computer import _angular_pallas_op
from torchani_tpu.neighbors import all_pairs as j_all_pairs
from torchani_tpu.neighbors import narrow_to_cutoff as j_narrow
from torchani_tpu_torch.aev import AEVComputer
from torchani_tpu_torch.aev.computer import _AngularAEVFunction
from torchani_tpu_torch.aev.kernels import (
    angular_aev,
    angular_aev_bwd,
    angular_aev_bwd_reference,
    angular_aev_reference,
    angular_grid,
)

torch.set_num_threads(2)
ATOL, RTOL = 1e-5, 1e-4
CASES = [("like_2x", "cosine", 7), ("like_1x", "smooth", 4), ("like_2x", "smooth", 2)]


def _kwargs(version: str, cutoff_kind: str, ns: int) -> dict:
    ang = getattr(tt.aev.terms.ANIAngular, version)(cutoff_kind)
    return dict(
        eta=float(ang.eta[0]), zeta=float(ang.zeta[0]),
        shifts=tuple(np.asarray(ang.shifts).tolist()),
        sections=tuple(np.asarray(ang.sections).tolist()),
        cutoff=float(ang.cutoff), cutoff_kind=cutoff_kind, num_species=ns,
    )


def _width(kw: dict) -> int:
    ns = kw["num_species"]
    return ns * (ns + 1) // 2 * len(kw["shifts"]) * len(kw["sections"])


def _cluster_lanes(version: str, ns: int, seed: int, a: int = 14):
    """Angular lanes of a random cluster from a JAX all-pairs table (as
    tests/test_torch_aev.py builds them), as numpy arrays."""
    aevc = getattr(tt.AEVComputer, version)()
    rng = np.random.RandomState(seed)
    elem = jnp.asarray(rng.choice(list(range(ns)), (1, a)))
    coords = jnp.asarray(rng.rand(1, a, 3).astype(np.float32) * 4)
    nbrs = j_narrow(j_all_pairs(aevc.radial.cutoff, elem, coords), aevc.angular.cutoff)
    mask = nbrs.mask[0]
    nbr_elem = jnp.where(mask, jnp.take(elem[0], nbrs.idx[0]), -1)
    arrays = (
        jnp.where(mask, nbrs.dist, 1.0)[0], nbrs.diff[0], mask,
        jax.nn.one_hot(nbr_elem, ns, dtype=jnp.float32),
    )
    return [np.array(x) for x in arrays]


def _random_lanes(n: int, ka: int, s: int, seed: int):
    """Random lanes: masked ones hold dist 1.0, diff 0 and an all-zero
    one-hot; every 7th row is fully masked."""
    rng = np.random.RandomState(seed)
    dist = rng.uniform(0.8, 3.4, (n, ka)).astype(np.float32)
    diff = rng.randn(n, ka, 3).astype(np.float32)
    diff *= (dist / np.linalg.norm(diff, axis=-1))[..., None]
    mask = rng.rand(n, ka) < 0.7
    mask[::7] = False
    oh = np.eye(s, dtype=np.float32)[rng.randint(0, s, (n, ka))] * mask[..., None]
    return [np.where(mask, dist, 1.0).astype(np.float32), diff * mask[..., None], mask, oh]


def _cotangent(rows: int, width: int, seed: int) -> np.ndarray:
    return np.random.RandomState(seed).randn(rows, width).astype(np.float32)


def _autograd_of_plain(g, lanes, kw):
    """The cotangents of dist and diff by autograd through `angular_grid`."""
    dist, diff, mask, oh = (torch.as_tensor(x) for x in lanes)
    dist.requires_grad_(True)
    diff.requires_grad_(True)
    out = angular_aev_reference(dist, diff, mask, oh, **kw)
    return torch.autograd.grad(out, (dist, diff), torch.as_tensor(g))


def _assert_close(out, ref):
    for o, r in zip(out, ref):
        o, r = np.asarray(o), np.asarray(r)
        scale = np.abs(r).max()
        np.testing.assert_allclose(o / scale, r / scale, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("version,cutoff_kind,ns", CASES)
def test_bwd_reference_matches_jax_vjp(version, cutoff_kind, ns):
    kw = _kwargs(version, cutoff_kind, ns)
    dist, diff, mask, oh = _cluster_lanes(version, ns, seed=0)
    g = _cotangent(dist.shape[0], _width(kw), seed=1)
    config = (kw["eta"], kw["zeta"], kw["shifts"], kw["sections"], kw["cutoff"],
              cutoff_kind, ns, 1024)
    maskf = jnp.asarray(mask.astype(np.float32))

    @jax.jit
    def grads(d, df, cot):
        op = lambda a, b: _angular_pallas_op(config, a, b, maskf, jnp.asarray(oh))  # noqa: E731
        return jax.vjp(op, d, df)[1](cot)

    ref = grads(jnp.asarray(dist), jnp.asarray(diff), jnp.asarray(g))
    out = angular_aev_bwd_reference(
        *(torch.as_tensor(x) for x in (g, dist, diff, mask, oh)), **kw
    )
    _assert_close([t.numpy() for t in out], ref)
    assert (out[0][~torch.as_tensor(mask)] == 0).all()


@pytest.mark.parametrize("version,cutoff_kind,ns", CASES)
def test_bwd_reference_matches_autograd_of_the_plain_forward(version, cutoff_kind, ns):
    kw = _kwargs(version, cutoff_kind, ns)
    lanes = _random_lanes(40, 12, ns, seed=2)
    g = _cotangent(40, _width(kw), seed=3)
    out = angular_aev_bwd_reference(*(torch.as_tensor(x) for x in [g] + lanes), **kw)
    _assert_close([t.numpy() for t in out], [t.numpy() for t in _autograd_of_plain(g, lanes, kw)])
    mask = torch.as_tensor(lanes[2])
    assert (out[0][~mask] == 0).all() and (out[1][~mask] == 0).all()
    assert (out[0][::7] == 0).all() and (out[1][::7] == 0).all()


def test_bwd_reference_edge_lanes():
    """An atom with a single neighbour (no pair: exact zeros) and lanes just
    inside the smooth cutoff (where fc' is tiny and 1 / u^2 is large)."""
    kw = _kwargs("like_2x", "smooth", 2)
    rc = kw["cutoff"]
    rng = np.random.RandomState(4)
    mask = np.zeros((3, 5), dtype=bool)
    mask[0, 0] = True
    mask[1:, :3] = True
    dist = np.where(mask, rng.uniform(0.9, 3.0, (3, 5)), 1.0).astype(np.float32)
    dist[1, :2] = [rc * 0.95, rc * 0.99]
    diff = rng.randn(3, 5, 3).astype(np.float32)
    diff *= (dist / np.linalg.norm(diff, axis=-1) * mask)[..., None]
    oh = np.eye(2, dtype=np.float32)[rng.randint(0, 2, (3, 5))] * mask[..., None]
    lanes = [dist, diff, mask, oh]
    g = _cotangent(3, _width(kw), seed=5)
    out = angular_aev_bwd_reference(*(torch.as_tensor(x) for x in [g] + lanes), **kw)
    assert all(torch.isfinite(t).all() for t in out)
    assert (out[0][0] == 0).all() and (out[1][0] == 0).all()
    assert (out[0][1:, :3] != 0).all()
    _assert_close([t.numpy() for t in out], [t.numpy() for t in _autograd_of_plain(g, lanes, kw)])


def test_bwd_reference_blocks_and_column_slices():
    """Atom blocks give the unblocked result, and a cotangent that is a
    column slice of a wider tensor gives what its contiguous copy gives."""
    kw = _kwargs("like_1x", "smooth", 4)
    lanes = [torch.as_tensor(x) for x in _random_lanes(30, 10, 4, seed=6)]
    wide = torch.as_tensor(_cotangent(30, _width(kw) + 16, seed=7))
    g = wide[:, 16:]
    assert not g.is_contiguous()
    whole = angular_aev_bwd_reference(g.contiguous(), *lanes, **kw)
    for out in (
        angular_aev_bwd_reference(g, *lanes, **kw),
        angular_aev_bwd_reference(g, *lanes, atom_block=4, **kw),
        angular_aev_bwd(g, *lanes, atom_block=4, **kw),
    ):
        for a, b in zip(out, whole):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=1e-6)


def test_kernel_path_on_cpu_launches_no_kernel():
    """`_AngularAEVFunction` on CPU tensors takes the plain versions (the
    backward in blocks), launches nothing, builds the plain grid only for
    its forward, and gives the plain path's gradients."""
    kw = AEVComputer.like_2x(device="cpu").kernel_kwargs()
    lanes = [torch.as_tensor(x) for x in _cluster_lanes("like_2x", 7, seed=8, a=20)]
    dist, diff = (t.clone().requires_grad_(True) for t in lanes[:2])
    before = angular_aev.launches, angular_aev_bwd.launches, angular_grid.calls
    out = _AngularAEVFunction.apply(dist, diff, lanes[2], lanes[3], kw, 6)
    grads = torch.autograd.grad(torch.sin(3 * out).sum(), (dist, diff))
    after = angular_aev.launches, angular_aev_bwd.launches, angular_grid.calls
    assert after == (before[0], before[1], before[2] + 1)
    g = (3 * torch.cos(3 * out)).detach().numpy()
    _assert_close([t.numpy() for t in grads], _autograd_of_plain(g, lanes, kw))
