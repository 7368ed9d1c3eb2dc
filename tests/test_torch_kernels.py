"""PyTorch port: the angular-AEV wrapper and, on the card, its CUDA kernel.

This file imports no JAX, so the tests marked ``cuda`` also run on a
machine with a GPU and no JAX::

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

Kernel against plain version: atol 1e-5, rtol 1e-4 (f32 sums over the
neighbour pairs in another order, as in tests/test_pallas.py).
"""

import numpy as np
import pytest
import torch

from torchani_tpu_torch.aev import AEVComputer, angular_aev, angular_aev_reference
from torchani_tpu_torch.aev.terms import ANIAngular
from torchani_tpu_torch.grad import energies_and_forces
from torchani_tpu_torch.models import ANI2x
from torchani_tpu_torch.neighbors import CellList
from torchani_tpu_torch.testing import make_water_box

torch.set_num_threads(2)
ATOL, RTOL = 1e-5, 1e-4


def _kwargs(version: str, cutoff_fn: str, num_species: int) -> dict:
    ang = getattr(ANIAngular, version)(cutoff_fn, device="cpu")
    return dict(
        eta=float(ang.eta[0]), zeta=float(ang.zeta[0]),
        shifts=tuple(ang.shifts.tolist()), sections=tuple(ang.sections.tolist()),
        cutoff=ang.cutoff, cutoff_kind=cutoff_fn, num_species=num_species,
    )


def _lanes(n: int, ka: int, s: int, seed: int, device: str = "cpu"):
    """Random angular lanes: masked ones hold dist 1.0, diff 0 and an
    all-zero one-hot; every 7th row is fully masked."""
    rng = np.random.RandomState(seed)
    dist = rng.uniform(0.8, 3.4, (n, ka)).astype(np.float32)
    diff = rng.randn(n, ka, 3).astype(np.float32)
    diff *= (dist / np.linalg.norm(diff, axis=-1))[..., None]
    mask = rng.rand(n, ka) < 0.7
    mask[::7] = False
    oh = np.eye(s, dtype=np.float32)[rng.randint(0, s, (n, ka))] * mask[..., None]
    arrays = (np.where(mask, dist, 1.0).astype(np.float32), diff * mask[..., None], mask, oh)
    return [torch.as_tensor(a, device=device) for a in arrays]


CASES = [("like_2x", "cosine", 7), ("like_1x", "smooth", 4), ("like_2x", "smooth", 2)]


@pytest.mark.parametrize("version,cutoff_fn,ns", CASES)
def test_wrapper_takes_plain_version_on_cpu(version, cutoff_fn, ns):
    kw = _kwargs(version, cutoff_fn, ns)
    lanes = _lanes(50, 12, ns, seed=0)
    before = angular_aev.launches
    out = angular_aev(*lanes, **kw)
    assert angular_aev.launches == before
    np.testing.assert_array_equal(out.numpy(), angular_aev_reference(*lanes, **kw).numpy())
    assert out.shape == (50, ns * (ns + 1) // 2 * 32)
    assert (out[::7] == 0).all()


def test_wrapper_rejects_other_devices():
    lanes = [t.to("meta") for t in _lanes(4, 3, 4, seed=1)]
    with pytest.raises(ValueError):
        angular_aev(*lanes, **_kwargs("like_1x", "cosine", 4))


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("version,cutoff_fn,ns", CASES)
@pytest.mark.parametrize("n,ka", [(257, 19), (64, 40)])
def test_kernel_matches_plain_on_card(version, cutoff_fn, ns, n, ka):
    _cuda()
    kw = _kwargs(version, cutoff_fn, ns)
    lanes = _lanes(n, ka, ns, seed=2, device="cuda")
    before = angular_aev.launches
    out = angular_aev(*lanes, **kw)
    torch.cuda.synchronize()
    assert angular_aev.launches == before + 1
    ref = angular_aev_reference(*lanes, **kw)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), atol=ATOL, rtol=RTOL)
    assert (out[::7] == 0).all()


@pytest.mark.cuda
def test_kernel_wrapper_checks_on_card():
    _cuda()
    dist, diff, mask, oh = _lanes(8, 5, 4, seed=3, device="cuda")
    kw = _kwargs("like_1x", "cosine", 4)
    with pytest.raises(TypeError):
        angular_aev(dist.double(), diff, mask, oh, **kw)
    with pytest.raises(ValueError):
        angular_aev(dist, diff[:, :4], mask, oh, **kw)
    with pytest.raises(ValueError):
        angular_aev(dist.t().contiguous().t(), diff, mask, oh, **kw)


@pytest.mark.cuda
def test_kernel_strategy_gradients_on_card():
    """E+F through the kernel strategy equal the plain strategy on the card."""
    _cuda()
    species, coords, cell = make_water_box(600)
    model = ANI2x(seed=0, device="cuda")
    model.neighborlist = CellList()
    results = {}
    for strategy in ("cuda", "plain"):
        model.aev_computer.strategy = strategy
        results[strategy] = energies_and_forces(model, species, coords, cell, np.ones(3, bool))
    (e_k, f_k), (e_p, f_p) = results["cuda"], results["plain"]
    np.testing.assert_allclose(e_k.cpu().numpy(), e_p.cpu().numpy(), rtol=1e-6)
    np.testing.assert_allclose(f_k.cpu().numpy(), f_p.cpu().numpy(), atol=1e-5)
    assert isinstance(model.aev_computer, AEVComputer)
