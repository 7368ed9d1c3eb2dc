"""PyTorch port: constants, cutoffs, AEV terms and self energies against the
JAX package.

Tolerance: atol 1e-6, elementwise f32 math on the same inputs; the angular
terms add rtol 1e-5, since the zeta power (up to 32) multiplies a one-ulp
difference in its base by zeta.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchani_tpu.aev.terms as jterms
import torchani_tpu.constants as jconst
import torchani_tpu.cutoffs as jcut
import torchani_tpu.sae as jsae
import torchani_tpu.units as junits
import torchani_tpu.utils as jutils
import torchani_tpu_torch.aev.terms as pterms
import torchani_tpu_torch.constants as pconst
import torchani_tpu_torch.cutoffs as pcut
import torchani_tpu_torch.sae as psae
import torchani_tpu_torch.units as punits
import torchani_tpu_torch.utils as putils

torch.set_num_threads(2)
CPU = "cpu"
ATOL = 1e-6


def _dists(seed: int, shape=(64, 12), low=0.5, high=5.0) -> np.ndarray:
    return np.random.RandomState(seed).uniform(low, high, shape).astype(np.float32)


@pytest.mark.parametrize("name", ["cosine", "smooth", "dummy"])
@pytest.mark.parametrize("cutoff", [3.5, 5.2])
def test_cutoff_values(name, cutoff):
    d = _dists(0, high=cutoff)
    ref = np.asarray(jcut.parse_cutoff_fn(name)(jnp.asarray(d), cutoff))
    out = pcut.parse_cutoff_fn(name)(torch.as_tensor(d), cutoff).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_cutoff_registry():
    assert pcut.parse_cutoff_fn("cosine") == pcut.CutoffCosine()
    assert pcut.parse_cutoff_fn("smooth").is_same(pcut.CutoffSmooth())
    g = pcut.CutoffSmooth(order=4)
    assert pcut.parse_cutoff_fn(g) is g
    with pytest.raises(ValueError):
        pcut.parse_cutoff_fn("nope")


@pytest.mark.parametrize("version", ["like_1x", "like_2x"])
@pytest.mark.parametrize("cutoff_fn", ["cosine", "smooth"])
def test_radial_terms(version, cutoff_fn):
    jr = getattr(jterms.ANIRadial, version)(cutoff_fn)
    pr = getattr(pterms.ANIRadial, version)(cutoff_fn, device=CPU)
    for k in ("eta", "shifts"):
        np.testing.assert_array_equal(getattr(pr, k).numpy(), np.asarray(getattr(jr, k)))
    assert pr.cutoff == jr.cutoff and pr.num_feats == jr.num_feats
    d = _dists(1, high=jr.cutoff)
    np.testing.assert_allclose(
        pr(torch.as_tensor(d)).numpy(), np.asarray(jr(jnp.asarray(d))), atol=ATOL
    )


@pytest.mark.parametrize("version", ["like_1x", "like_2x"])
@pytest.mark.parametrize("cutoff_fn", ["cosine", "smooth"])
def test_angular_terms(version, cutoff_fn):
    ja = getattr(jterms.ANIAngular, version)(cutoff_fn)
    pa = getattr(pterms.ANIAngular, version)(cutoff_fn, device=CPU)
    for k in ("eta", "zeta", "shifts", "sections"):
        np.testing.assert_array_equal(getattr(pa, k).numpy(), np.asarray(getattr(ja, k)))
    rng = np.random.RandomState(2)
    dj = _dists(3, (40, 6), high=ja.cutoff)
    dk = _dists(4, (40, 6), high=ja.cutoff)
    cos = rng.uniform(-1, 1, (40, 6)).astype(np.float32)
    ref = np.asarray(ja(jnp.asarray(dj), jnp.asarray(dk), jnp.asarray(cos)))
    out = pa(torch.as_tensor(dj), torch.as_tensor(dk), torch.as_tensor(cos)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=1e-5)


def test_term_registry():
    assert pterms.parse_radial_term("ani2x", device=CPU).num_feats == 16
    assert pterms.parse_angular_term("ani1x", device=CPU).num_feats == 32
    with pytest.raises(ValueError):
        pterms.parse_radial_term("ani3x", device=CPU)


def test_constants_match():
    assert pconst.ATOMIC_NUMBER == jconst.ATOMIC_NUMBER
    assert pconst.PERIODIC_TABLE == jconst.PERIODIC_TABLE
    assert pconst.GSAES == jconst.GSAES
    assert punits.ANGSTROM_TO_BOHR == junits.ANGSTROM_TO_BOHR


def test_utils_match():
    assert putils.linspace(0.8, 5.1, 16) == jutils.linspace(0.8, 5.1, 16)
    assert putils.SYMBOLS_2X == jutils.SYMBOLS_2X
    assert putils.SYMBOLS_1X == jutils.SYMBOLS_1X
    assert putils.SYMBOLS_2X_ZNUM_ORDER == jutils.SYMBOLS_2X_ZNUM_ORDER
    assert putils.symbols_to_atomic_numbers(("H", "Cl")) == (1, 17)
    assert putils.atomic_numbers_to_symbols((8, 16)) == ("O", "S")


def test_map_to_central_matches():
    rng = np.random.RandomState(5)
    cell = np.diag([7.0, 8.0, 9.0]).astype(np.float32)
    coords = (rng.rand(20, 3) * 30 - 10).astype(np.float32)
    pbc = np.array([True, False, True])
    ref = np.asarray(
        jutils.map_to_central(jnp.asarray(coords), jnp.asarray(cell), jnp.asarray(pbc))
    )
    out = putils.map_to_central(
        torch.as_tensor(coords), torch.as_tensor(cell), torch.as_tensor(pbc)
    ).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5)


@pytest.mark.parametrize("atomic", [False, True])
def test_self_energy_matches(atomic):
    symbols = ("H", "C", "N", "O", "S", "F", "Cl")
    jse = jsae.SelfEnergy.from_lot(symbols, "wb97x-631gd")
    pse = psae.SelfEnergy.from_lot(symbols, "wb97x-631gd", device=CPU)
    elem = np.random.RandomState(6).randint(-1, 7, (3, 11))
    ref = np.asarray(jse(jnp.asarray(elem), atomic=atomic))
    out = pse(torch.as_tensor(elem), atomic=atomic).numpy()
    # per-atom values are exact; molecule totals are f32 sums in another order
    np.testing.assert_allclose(out, ref, rtol=0 if atomic else 1e-6)
