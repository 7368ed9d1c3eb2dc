"""PyTorch port: `neb.neb_path` against the JAX package's, on the CPU.

The Mueller-Brown surface (the same analytic energy in torch and jax.numpy):
after 100 iterations the band and the FIRE schedule equal JAX's (images
within 1e-5; past ~120 iterations the surface amplifies the last-bit
differences of the two libraries' f32 ``exp``, so the converged bands are
held to the saddle, not to each other), and the climbing image lands on the
A-C saddle at (-0.822, 0.624), E = -40.665, as in ``tests/test_neb.py``.
A band of 5 images of water through a one-member `simple_ani` whose weights
come through `torchani_tpu_torch.interop`, 20 iterations: images within
1e-5 A.  The endpoints stay fixed to the bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchani_tpu as tt
from torchani_tpu.neb import _tangents as j_tangents
from torchani_tpu.neb import neb_path as j_neb_path
from torchani_tpu_torch.arch import simple_ani
from torchani_tpu_torch.interop import load_jax_arrays
from torchani_tpu_torch.neb import _tangents, neb_path

torch.set_num_threads(2)
CPU = "cpu"
_A = np.array([-200.0, -100.0, -170.0, 15.0], np.float32)
_a = np.array([-1.0, -1.0, -6.5, 0.7], np.float32)
_b = np.array([0.0, 0.0, 11.0, 0.6], np.float32)
_c = np.array([-10.0, -10.0, -6.5, 0.7], np.float32)
_x0 = np.array([1.0, 0.0, -0.5, -1.0], np.float32)
_y0 = np.array([0.0, 0.5, 1.5, 1.0], np.float32)
MIN_A, MIN_C, SADDLE_AC = (-0.5582, 1.4417), (-0.0500, 0.4667), (-0.8220, 0.6243)


def _mueller_brown(xp):
    a_, a, b, c, x0, y0 = (xp.asarray(v) for v in (_A, _a, _b, _c, _x0, _y0))

    def energy(images):  # (I, 1, 3) -> (I,); z is flat
        dx = images[:, 0, 0][:, None] - x0[None, :]
        dy = images[:, 0, 1][:, None] - y0[None, :]
        return (a_[None, :] * xp.exp(a * dx**2 + b * dx * dy + c * dy**2)).sum(1)

    return energy


def _linear_band(p0, p1, n):
    t = np.linspace(0.0, 1.0, n)[:, None]
    band = np.zeros((n, 1, 3), np.float32)
    band[:, 0, :2] = (1 - t) * np.asarray(p0) + t * np.asarray(p1)
    return band


def _leaves(tree):
    return {
        jax.tree_util.keystr(p): np.asarray(x)
        for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


def _assert_same_band(st, jst, band, atol):
    assert st.step == int(jst.step)
    np.testing.assert_array_equal(st.n_pos.numpy(), np.asarray(jst.n_pos))
    np.testing.assert_array_equal(st.dt.numpy(), np.asarray(jst.dt))
    np.testing.assert_allclose(st.images.numpy(), np.asarray(jst.images), atol=atol, rtol=0)
    assert torch.equal(st.images[0], torch.as_tensor(band[0]))
    assert torch.equal(st.images[-1], torch.as_tensor(band[-1]))


def test_tangents_match_jax():
    rng = np.random.RandomState(0)
    images = rng.randn(6, 4, 3).astype(np.float32)
    # uphill, downhill, a maximum and a minimum among the interior images
    energies = np.array([0.0, 1.0, 2.0, 1.5, 0.5, 0.7], np.float32)
    np.testing.assert_allclose(
        _tangents(torch.as_tensor(images), torch.as_tensor(energies)).numpy(),
        np.asarray(j_tangents(jnp.asarray(images), jnp.asarray(energies))), rtol=1e-6, atol=1e-7,
    )


def test_mueller_brown_matches_jax_and_finds_the_saddle():
    band = _linear_band(MIN_A, MIN_C, 13)
    kw = dict(k_spring=1.0, climb=True, dt_start=0.005, dt_max=0.02)
    jst = j_neb_path(_mueller_brown(jnp), jnp.asarray(band), max_steps=100, fmax=1e-12, **kw)
    st = neb_path(_mueller_brown(torch), band, max_steps=100, fmax=1e-12, device=CPU, **kw)
    _assert_same_band(st, jst, band, atol=1e-5)
    assert int(torch.argmax(st.energies[1:-1])) == int(jnp.argmax(jst.energies[1:-1]))

    st = neb_path(_mueller_brown(torch), band, max_steps=1500, fmax=0.02, device=CPU, **kw)
    assert float(st.fmax) <= 0.02 and st.step < 1500
    assert torch.equal(st.images[0], torch.as_tensor(band[0]))
    assert torch.equal(st.images[-1], torch.as_tensor(band[-1]))
    ci = int(torch.argmax(st.energies[1:-1])) + 1
    x, y = float(st.images[ci, 0, 0]), float(st.images[ci, 0, 1])
    assert abs(x - SADDLE_AC[0]) < 0.03 and abs(y - SADDLE_AC[1]) < 0.03
    assert abs(float(st.energies[ci]) - (-40.665)) < 0.5


def test_ani_band_matches_jax():
    jmodel = tt.simple_ani(("H", "C", "N", "O"), ensemble_size=1)
    pmodel = load_jax_arrays(simple_ani(("H", "C", "N", "O"), ensemble_size=1, device=CPU),
                             _leaves(jmodel))
    start = np.array([[0.0, 0.0, 0.12], [0.0, 0.76, -0.48], [0.0, -0.76, -0.48]], np.float32)
    end = start.copy()
    end[1] = [0.0, 1.05, -0.2]
    t = np.linspace(0.0, 1.0, 5)[:, None, None]
    band = ((1 - t) * start + t * end).astype(np.float32)
    band[1:-1] += 0.02 * np.random.RandomState(3).randn(3, 3, 3).astype(np.float32)
    species = np.array([[8, 1, 1]] * 5)
    kw = dict(k_spring=0.1, climb=True, max_steps=20, fmax=1e-12)
    jst = j_neb_path(lambda x: jmodel(species, x), jnp.asarray(band), **kw)
    st = neb_path(lambda x: pmodel(species, x), band, device=CPU, **kw)
    assert st.step == 20
    _assert_same_band(st, jst, band, atol=1e-5)
    np.testing.assert_allclose(st.energies.numpy(), np.asarray(jst.energies), rtol=1e-6)
    assert torch.equal(st.neb_forces[0], torch.zeros(3, 3))


def test_neb_rejects_a_short_band():
    with pytest.raises(ValueError, match="I >= 3"):
        neb_path(_mueller_brown(torch), _linear_band(MIN_A, MIN_C, 2), device=CPU)
