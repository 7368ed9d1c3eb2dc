"""PyTorch port: the fused radial AEV (K6), its backward (K6b) and K6b's
backward (K6bb), their plain versions and the AEV computer's route to them.

On the CPU the plain versions are held, in float64, against autograd of the
AEV computer's plain radial sums (the masked ``(N, K, R)`` terms summed per
species), and `_RadialAEVFunction` is checked by ``gradcheck`` and
``gradgradcheck`` and to the third derivative.  The tables carry masked
lanes, rows of padding atoms (no valid lane), a lane exactly at the cutoff
and one past it (masked, as `narrow_to_cutoff` masks it).

This file imports no JAX, so the tests marked ``cuda`` also run on a
machine with a GPU and no JAX::

    python -m pytest --noconftest -m cuda tests/test_torch_radial_kernel.py

On the card the kernels are held against their plain versions at atol
1e-6 max|p| + rtol 1e-5 (float32 sums over the lanes or shifts in another
order than the plain version's), with exact zeros on masked lanes and on
padding rows.
"""

import types

import numpy as np
import pytest
import torch

from torchani_tpu_torch.aev import AEVComputer, ANIAngular, ANIRadial, Radial
from torchani_tpu_torch.aev import computer as computer_module
from torchani_tpu_torch.aev.radial_kernels import (
    radial_aev,
    radial_aev_bwd,
    radial_aev_bwd_bwd,
    radial_aev_bwd_bwd_reference,
    radial_aev_bwd_reference,
    radial_aev_reference,
    species_sums,
)
from torchani_tpu_torch.neighbors import Neighbors

torch.set_num_threads(2)

#: (term, cutoff function, species)
CASES = [
    ("like_2x", "cosine", 7), ("like_2x", "smooth", 7),
    ("like_1x", "cosine", 4), ("like_1x", "smooth", 4),
]
PADDING_EVERY = 5


def _kwargs(version: str, cutoff_fn: str, num_species: int) -> dict:
    rad = getattr(ANIRadial, version)(cutoff_fn, device="cpu")
    return dict(eta=float(rad.eta[0]), shifts=tuple(rad.shifts.tolist()), cutoff=rad.cutoff,
                cutoff_kind=cutoff_fn, num_species=num_species)


def _raw_table(n: int, k: int, s: int, cutoff: float, seed: int):
    """Random lanes before the cutoff narrows them: distances, the raw mask
    (every `PADDING_EVERY`-th row a padding atom) and each lane's species;
    row 1 holds a lane exactly at the cutoff (lane 0) and one past it (lane
    1)."""
    rng = np.random.RandomState(seed)
    dist = rng.uniform(0.6, cutoff + 0.4, (n, k))
    mask = rng.rand(n, k) < 0.7
    mask[::PADDING_EVERY] = False
    dist[1, :2] = np.float32(cutoff), cutoff + 0.3
    mask[1, :2] = True
    elem = rng.randint(0, s, (n, k))
    return dist, mask, elem


def _table(n: int, k: int, s: int, cutoff: float, seed: int, dtype=torch.float64,
           device: str = "cpu"):
    """The kernels' inputs as the AEV computer makes them: the mask narrowed
    to the cutoff, 1.0 in masked lanes, species -1 there."""
    dist, mask, elem = _raw_table(n, k, s, cutoff, seed)
    mask &= dist.astype(np.float32) <= np.float32(cutoff)
    dist = np.where(mask, dist, 1.0)
    species = np.where(mask, elem, -1)
    return (torch.as_tensor(dist, dtype=dtype, device=device),
            torch.as_tensor(species, dtype=torch.int64, device=device))


def _composite(dist: torch.Tensor, species: torch.Tensor, version: str, cutoff_fn: str,
               s: int) -> torch.Tensor:
    """The radial block of the AEV computer's plain path on this table."""
    aevc = AEVComputer.make("ani" + version[5:], "ani" + version[5:], s, strategy="plain",
                            cutoff_fn=cutoff_fn, device="cpu")
    n, k = dist.shape
    mask = species >= 0
    table = Neighbors(idx=torch.zeros((n, k), dtype=torch.int64), mask=mask,
                      diff=torch.zeros((n, k, 3), dtype=dist.dtype), dist=dist,
                      overflow=torch.tensor(False), elem=species)
    elem = torch.zeros(n, dtype=torch.int64)
    return aevc._aev_flat(elem, table, table, tuple(range(s)))[:, :aevc.radial_len]


def _cotangent(n: int, width: int, seed: int, dtype=torch.float64, device: str = "cpu"):
    rng = np.random.RandomState(seed)
    return torch.as_tensor(rng.randn(n, width), dtype=dtype, device=device)


@pytest.mark.parametrize("version,cutoff_fn,ns", CASES)
def test_plain_versions_match_autograd_of_the_composite(version, cutoff_fn, ns):
    kw = _kwargs(version, cutoff_fn, ns)
    width = ns * len(kw["shifts"])
    dist, species = _table(23, 9, ns, kw["cutoff"], seed=1)
    valid = species >= 0
    assert valid[1, 0] and not valid[1, 1]  # at the cutoff: kept; past it: masked
    dist.requires_grad_()
    ref = _composite(dist, species, version, cutoff_fn, ns)
    out = radial_aev_reference(dist, species, **kw)
    torch.testing.assert_close(out, ref, rtol=1e-12, atol=1e-14)
    assert (out[::PADDING_EVERY] == 0).all()

    g = _cotangent(23, width, seed=2)
    (gdist_ref,) = torch.autograd.grad(ref, dist, g, create_graph=True)
    gdist = radial_aev_bwd_reference(g, dist.detach(), species, **kw)
    torch.testing.assert_close(gdist, gdist_ref.detach(), rtol=1e-10, atol=1e-12)
    assert (gdist[~valid] == 0).all()

    w = _cotangent(23, 9, seed=3)
    g.requires_grad_()
    (gdist_g,) = torch.autograd.grad(ref, dist, g, create_graph=True)
    gg_ref, h_ref = torch.autograd.grad(torch.sum(gdist_g * w), (g, dist))
    gg, h = radial_aev_bwd_bwd_reference(g.detach(), dist.detach(), species, w, **kw)
    torch.testing.assert_close(gg, gg_ref, rtol=1e-10, atol=1e-12)
    torch.testing.assert_close(h, h_ref, rtol=1e-10, atol=1e-12)
    assert (h[~valid] == 0).all() and (gg[::PADDING_EVERY] == 0).all()


@pytest.mark.parametrize("version,cutoff_fn,ns", CASES)
def test_function_gradcheck_and_gradgradcheck(version, cutoff_fn, ns):
    """`_RadialAEVFunction` on the CPU route: forward K6's plain version,
    backward K6b's, second derivative K6bb's."""
    kw = _kwargs(version, cutoff_fn, ns)
    dist, species = _table(6, 5, ns, kw["cutoff"], seed=4)
    dist.requires_grad_()

    def fn(d):
        return computer_module._RadialAEVFunction.apply(d, species, kw)

    assert torch.autograd.gradcheck(fn, (dist,))
    assert torch.autograd.gradgradcheck(fn, (dist,))


@pytest.mark.parametrize("version,cutoff_fn,ns", CASES)
def test_function_third_derivative_matches_the_composite(version, cutoff_fn, ns):
    """Third and fourth derivatives of an energy of the AEV through the
    function (K6bb's backward recomputes) equal autograd of the composite.
    The energy is nonlinear in the AEV, as the networks are, so that K6b's
    cotangent ``g`` carries a graph back to ``dist`` through the function
    itself."""
    kw = _kwargs(version, cutoff_fn, ns)
    dist, species = _table(11, 7, ns, kw["cutoff"], seed=5)
    c = _cotangent(ns * len(kw["shifts"]), 3, seed=6) * 0.3
    u, v, w = (_cotangent(11, 7, seed=s) for s in (7, 8, 9))
    results = []
    for f in (lambda d: computer_module._RadialAEVFunction.apply(d, species, kw),
              lambda d: _composite(d, species, version, cutoff_fn, ns)):
        d = dist.clone().requires_grad_()
        (g1,) = torch.autograd.grad(torch.sum(torch.tanh(f(d) @ c)), d, create_graph=True)
        (g2,) = torch.autograd.grad(torch.sum(g1 * u), d, create_graph=True)
        (g3,) = torch.autograd.grad(torch.sum(g2 * v), d, create_graph=True)
        (g4,) = torch.autograd.grad(torch.sum(g3 * w), d)
        results.append((g1.detach(), g2.detach(), g3.detach(), g4))
    for a, b in zip(*results):
        torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("version,cutoff_fn,ns", CASES)
def test_bwd_function_gives_both_second_order_cotangents(version, cutoff_fn, ns):
    """K6b's backward (K6bb) gives the cotangent of ``g`` and the
    second-order term of ``dist`` together, each as its plain version."""
    kw = _kwargs(version, cutoff_fn, ns)
    dist, species = _table(13, 8, ns, kw["cutoff"], seed=9)
    g = _cotangent(13, ns * 16, seed=10).requires_grad_()
    w = _cotangent(13, 8, seed=11)
    gg_ref, h_ref = radial_aev_bwd_bwd_reference(g.detach(), dist, species, w, **kw)
    dist.requires_grad_()
    gdist = computer_module._RadialAEVBwdFunction.apply(g, dist, species, kw)
    gg, h = torch.autograd.grad(torch.sum(gdist * w), (g, dist))
    torch.testing.assert_close(gg, gg_ref, rtol=1e-12, atol=1e-14)
    torch.testing.assert_close(h, h_ref, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("present", [None, (0, 3, 6), ()])
def test_species_sums_against_a_loop(present):
    """The one plain per-species sum (K6's plain version and the AEV
    computer's plain path both take it) against a loop over lanes; masked
    lanes fall in no species, absent species are zero."""
    rng = np.random.RandomState(16)
    terms = torch.as_tensor(rng.randn(5, 6, 3))
    species = torch.as_tensor(rng.randint(-1, 7, (5, 6)))
    want = torch.zeros(5, 7, 3, dtype=terms.dtype)
    for i in range(5):
        for k in range(6):
            e = int(species[i, k])
            if e >= 0 and (present is None or e in present):
                want[i, e] += terms[i, k]
    torch.testing.assert_close(species_sums(terms, species, 7, present), want.reshape(5, 21),
                               rtol=1e-12, atol=1e-14)


def test_wrappers_take_plain_versions_on_cpu():
    kw = _kwargs("like_2x", "smooth", 7)
    dist, species = _table(20, 6, 7, kw["cutoff"], seed=12, dtype=torch.float32)
    g = _cotangent(20, 7 * 16, seed=13, dtype=torch.float32)
    w = _cotangent(20, 6, seed=14, dtype=torch.float32)
    before = radial_aev.launches, radial_aev_bwd.launches, radial_aev_bwd_bwd.launches
    torch.testing.assert_close(radial_aev(dist, species, **kw),
                               radial_aev_reference(dist, species, **kw), rtol=0, atol=0)
    torch.testing.assert_close(radial_aev_bwd(g, dist, species, **kw),
                               radial_aev_bwd_reference(g, dist, species, **kw), rtol=0, atol=0)
    for a, b in zip(radial_aev_bwd_bwd(g, dist, species, w, **kw),
                    radial_aev_bwd_bwd_reference(g, dist, species, w, **kw)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (radial_aev.launches, radial_aev_bwd.launches,
            radial_aev_bwd_bwd.launches) == before
    with pytest.raises(ValueError):
        radial_aev(dist.to("meta"), species.to("meta"), **kw)
    with pytest.raises(ValueError):
        radial_aev_reference(dist, species, **dict(kw, cutoff_kind="biweight"))


class _SubRadial(ANIRadial):
    """A subclass: the kernel does not evaluate it, whatever it computes."""


class _UserRadial(Radial):
    tensors = ["eta", "shifts"]

    def compute(self, d):
        return 0.25 * torch.exp(-self.eta * (d[..., None] - self.shifts) ** 2)


def _computer(term: str, strategy: str) -> AEVComputer:
    cutoff_fn = "biweight" if term == "biweight" else "cosine"
    if term == "subclass":
        radial = _SubRadial.like_2x(device="cpu")
    elif term == "user":
        ref = ANIRadial.like_2x(device="cpu")
        radial = _UserRadial.make(ref.cutoff, eta=float(ref.eta[0]),
                                  shifts=ref.shifts.tolist(), device="cpu")
    else:
        radial = ANIRadial.like_2x(cutoff_fn, device="cpu")
    angular = ANIAngular.like_2x(cutoff_fn, device="cpu")
    return AEVComputer(radial, angular, 7, strategy=strategy)


#: (radial term, strategy, whether `_RadialAEVFunction` runs on the CPU)
ROUTES = [
    ("ani", "cuda", True), ("ani", "auto", False), ("ani", "plain", False),
    ("subclass", "cuda", False), ("user", "cuda", False), ("subclass", "auto", False),
    ("biweight", "auto", False), ("biweight", "plain", False),
]


@pytest.mark.parametrize("term,strategy,kernel", ROUTES)
def test_route(term, strategy, kernel, monkeypatch):
    """Which radial terms the kernels take: `ANIRadial` itself with the
    cosine or smooth cutoff; a subclass, a user term and the biweight cutoff
    keep the plain sums under every strategy (``"cuda"`` raises for none of
    them), and so does ``"plain"``.  Every route gives the plain AEV."""
    calls = []
    real = computer_module._RadialAEVFunction

    class Spy:
        @staticmethod
        def apply(*args):
            calls.append(args)
            return real.apply(*args)

    monkeypatch.setattr(computer_module, "_RadialAEVFunction", Spy)
    aevc = _computer(term, strategy)
    rng = np.random.RandomState(15)
    elem = torch.as_tensor(rng.randint(0, 7, (2, 9)))
    elem[1, 7:] = -1
    coords = torch.as_tensor(rng.uniform(0, 4.0, (2, 9, 3)), dtype=torch.float32)
    out = aevc(elem, coords)
    assert len(calls) == int(kernel)
    plain = _computer(term, "plain")
    torch.testing.assert_close(out, plain(elem, coords), rtol=1e-5, atol=1e-6)
    on_card = types.SimpleNamespace(is_cuda=True)
    expect_on_card = term == "ani" and strategy != "plain"
    assert aevc._use_radial_kernel(on_card) == expect_on_card


def test_route_keeps_plain_past_the_kernel_widths():
    aevc = AEVComputer(ANIRadial.cover_linearly(num_shifts=40, device="cpu"),
                       ANIAngular.like_2x(device="cpu"), 7, strategy="cuda")
    assert not aevc._use_radial_kernel(types.SimpleNamespace(is_cuda=True))
    aevc = AEVComputer.like_2x(num_species=17, strategy="auto", device="cpu")
    assert not aevc._use_radial_kernel(types.SimpleNamespace(is_cuda=True))


# ---- on the card ----


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")


def _assert_close(out, ref):
    k, p = out.cpu(), ref.cpu()
    assert torch.isfinite(k).all()
    bound = 1e-6 * p.abs().max() + 1e-5 * p.abs()
    assert ((k - p).abs() <= bound).all(), float((k - p).abs().max())


#: (term, cutoff, species, shifts): ANI-2x's and ANI-1x's instantiations and
#: the generic one
CARD_CASES = [("like_2x", "cosine", 7, None), ("like_1x", "smooth", 4, None),
              ("like_2x", "smooth", 3, None), ("like_2x", "cosine", 16, 10),
              ("like_1x", "cosine", 2, 32)]


def _card_kwargs(version, cutoff_fn, ns, nshifts):
    kw = _kwargs(version, cutoff_fn, ns)
    if nshifts is not None:
        rad = ANIRadial.cover_linearly(0.8, kw["cutoff"], kw["eta"], nshifts, cutoff_fn,
                                       device="cpu")
        kw["shifts"] = tuple(rad.shifts.tolist())
    return kw


@pytest.mark.cuda
@pytest.mark.parametrize("version,cutoff_fn,ns,nshifts", CARD_CASES)
@pytest.mark.parametrize("n,k", [(257, 19), (64, 104)])
def test_kernels_match_plain_on_card(version, cutoff_fn, ns, nshifts, n, k):
    _cuda()
    kw = _card_kwargs(version, cutoff_fn, ns, nshifts)
    width = ns * len(kw["shifts"])
    dist, species = _table(n, k, ns, kw["cutoff"], seed=20, dtype=torch.float32,
                           device="cuda")
    wide = _cotangent(n, width + 48, seed=21, dtype=torch.float32, device="cuda")
    g = wide[:, :width]  # a column slice, as the AEV's cotangent gives it
    w = _cotangent(n, k, seed=22, dtype=torch.float32, device="cuda")
    before = radial_aev.launches, radial_aev_bwd.launches, radial_aev_bwd_bwd.launches
    out = radial_aev(dist, species, **kw)
    gdist = radial_aev_bwd(g, dist, species, **kw)
    gg, h = radial_aev_bwd_bwd(g, dist, species, w, **kw)
    torch.cuda.synchronize()
    after = radial_aev.launches, radial_aev_bwd.launches, radial_aev_bwd_bwd.launches
    assert tuple(a - b for a, b in zip(after, before)) == (1, 1, 1)
    gc = g.contiguous()
    _assert_close(out, radial_aev_reference(dist, species, **kw))
    _assert_close(gdist, radial_aev_bwd_reference(gc, dist, species, **kw))
    gg_ref, h_ref = radial_aev_bwd_bwd_reference(gc, dist, species, w, **kw)
    _assert_close(gg, gg_ref)
    _assert_close(h, h_ref)
    masked = species < 0
    assert (out[::PADDING_EVERY] == 0).all() and (gg[::PADDING_EVERY] == 0).all()
    assert (gdist[masked] == 0).all() and (h[masked] == 0).all()
    assert torch.equal(radial_aev(dist, species, **kw), out)  # a fixed order


@pytest.mark.cuda
def test_kernel_wrapper_checks_on_card():
    _cuda()
    kw = _kwargs("like_2x", "cosine", 7)
    dist, species = _table(8, 5, 7, kw["cutoff"], seed=23, dtype=torch.float32,
                           device="cuda")
    with pytest.raises(TypeError):
        radial_aev(dist.double(), species, **kw)
    with pytest.raises(TypeError):
        radial_aev(dist, species.int(), **kw)
    with pytest.raises(ValueError):
        radial_aev(dist[:, :4], species, **kw)
    with pytest.raises(ValueError):
        radial_aev(dist.t().contiguous().t(), species, **kw)
    with pytest.raises(ValueError):
        radial_aev_bwd(_cotangent(8, 100, seed=0, dtype=torch.float32, device="cuda"),
                       dist, species, **kw)
    assert radial_aev(dist[:0], species[:0], **kw).shape == (0, 112)


@pytest.mark.cuda
def test_launches_per_path_on_card():
    """One K6 a forward, one K6b a force evaluation, one K6bb a second
    derivative pass; the route gives the plain strategy's forces."""
    _cuda()
    from torchani_tpu_torch.grad import energies_and_forces, hessians
    from torchani_tpu_torch.models import ANI2x
    from torchani_tpu_torch.neighbors import CellList
    from torchani_tpu_torch.testing import make_water_box

    species, coords, cell = make_water_box(600)
    model = ANI2x(seed=0, device="cuda")
    model.neighborlist = CellList()
    pbc = np.ones(3, bool)
    results = {}
    for strategy in ("plain", "auto"):
        model.aev_computer.strategy = strategy
        before = radial_aev.launches, radial_aev_bwd.launches, radial_aev_bwd_bwd.launches
        results[strategy] = energies_and_forces(model, species, coords, cell, pbc)
        torch.cuda.synchronize()
        after = radial_aev.launches, radial_aev_bwd.launches, radial_aev_bwd_bwd.launches
        expect = (1, 1, 0) if strategy == "auto" else (0, 0, 0)
        assert tuple(a - b for a, b in zip(after, before)) == expect
    (e_k, f_k), (e_p, f_p) = results["auto"], results["plain"]
    np.testing.assert_allclose(e_k.cpu().numpy(), e_p.cpu().numpy(), rtol=1e-6)
    np.testing.assert_allclose(f_k.cpu().numpy(), f_p.cpu().numpy(), atol=1e-5)

    small = make_water_box(30)
    before = radial_aev_bwd_bwd.launches
    hessians(model, small[0], small[1])
    torch.cuda.synchronize()
    assert radial_aev_bwd_bwd.launches > before
