"""PyTorch port: FIRE (`optimize.minimize_fire`, `minimize_fire_batched`)
against the JAX package's, on the CPU.

A Lennard-Jones energy of a perturbed 9-atom water cluster and of four
perturbations of it (the same arithmetic in jax.numpy and torch), each for a
fixed number of iterations under an unreachable ``fmax``: coordinates within
1e-5 A, and the same ``dt``, ``alpha`` and ``n_pos`` (f32 schedules rounded as
JAX rounds them).  A padded batch (conformers of 3 and 4 atoms, ``-1``
species) with ``atom_mask`` through a one-member `simple_ani` whose weights
come through `torchani_tpu_torch.interop`, the same way.  Convergence and the
freezing of converged conformers on a separable quadratic, against JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchani_tpu as tt
from torchani_tpu.optimize import minimize_fire as j_minimize_fire
from torchani_tpu.optimize import minimize_fire_batched as j_minimize_fire_batched
from torchani_tpu_torch.arch import simple_ani
from torchani_tpu_torch.interop import load_jax_arrays
from torchani_tpu_torch.optimize import minimize_fire, minimize_fire_batched
from torchani_tpu_torch.testing import make_water_box

torch.set_num_threads(2)
CPU = "cpu"
ITERS = 15
UNREACHABLE = 1e-12


def _leaves(tree):
    return {
        jax.tree_util.keystr(p): np.asarray(x)
        for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


@pytest.fixture(scope="module")
def both_models():
    jmodel = tt.simple_ani(("H", "C", "N", "O"), ensemble_size=1)
    pmodel = simple_ani(("H", "C", "N", "O"), ensemble_size=1, device=CPU)
    return jmodel, load_jax_arrays(pmodel, _leaves(jmodel))


@pytest.fixture(scope="module")
def cluster():
    species, coords, _ = make_water_box(96)
    rng = np.random.RandomState(1)
    base = coords[0, :9] + 0.05 * rng.randn(9, 3).astype(np.float32)
    batch = base[None] + 0.05 * rng.randn(4, 9, 3).astype(np.float32)
    return species[:, :9], base.astype(np.float32), batch.astype(np.float32)


def _lennard_jones(c):
    """Pair energy 4 eps ((s/r)^12 - (s/r)^6) over the atoms of each
    system; ``c`` is (..., A, 3), a jax or torch array."""
    i, j = np.triu_indices(c.shape[-2], 1)
    d = c[..., i, :] - c[..., j, :]
    s6 = (0.9**2 / (d * d).sum(-1)) ** 3
    return (4 * 0.01 * (s6 * s6 - s6)).sum(-1)


def _assert_same_schedule(st, jst):
    np.testing.assert_array_equal(st.dt.numpy(), np.asarray(jst.dt))
    np.testing.assert_array_equal(st.alpha.numpy(), np.asarray(jst.alpha))
    np.testing.assert_array_equal(st.n_pos.numpy(), np.asarray(jst.n_pos))
    assert st.dt.dtype == torch.float32 and st.n_pos.dtype == torch.int32
    assert st.step == int(jst.step)


def test_minimize_fire_matches_jax(cluster):
    _, base, _ = cluster
    jst = j_minimize_fire(_lennard_jones, jnp.asarray(base), max_steps=ITERS, fmax=UNREACHABLE)
    st = minimize_fire(_lennard_jones, base, max_steps=ITERS, fmax=UNREACHABLE, device=CPU)
    assert st.step == ITERS
    _assert_same_schedule(st, jst)
    assert float(st.dt) != 0.1
    np.testing.assert_allclose(st.coords.numpy(), np.asarray(jst.coords), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(st.energy), float(jst.energy), rtol=1e-5)
    np.testing.assert_allclose(float(st.fmax), float(jst.fmax), rtol=1e-4, atol=1e-6)


def test_minimize_fire_batched_matches_jax(cluster):
    _, _, batch = cluster
    jst = j_minimize_fire_batched(_lennard_jones, jnp.asarray(batch), max_steps=ITERS,
                                  fmax=UNREACHABLE)
    st = minimize_fire_batched(_lennard_jones, batch, max_steps=ITERS, fmax=UNREACHABLE,
                               device=CPU)
    _assert_same_schedule(st, jst)
    assert st.dt.shape == (4,) and st.fmax.shape == (4,)
    np.testing.assert_allclose(st.coords.numpy(), np.asarray(jst.coords), atol=1e-5, rtol=0)
    np.testing.assert_allclose(st.energy.numpy(), np.asarray(jst.energy), rtol=1e-5)


def test_padded_batch_with_atom_mask_matches_jax(both_models):
    """Conformers of 3 and 4 atoms in one batch (species -1 pads the
    water): the padding atom feels no force and never moves."""
    jmodel, pmodel = both_models
    sp = np.array([[8, 1, 1, -1], [6, 1, 1, 8]])
    co = np.array(
        [[[0.0, 0.0, 0.12], [0.0, 0.78, -0.47], [0.0, -0.74, -0.49], [0.0, 0.0, 0.0]],
         [[0.0, 0.0, 0.0], [1.1, 0.0, 0.0], [-0.4, 1.0, 0.0], [0.0, -0.6, 1.1]]],
        dtype=np.float32,
    )
    mask = sp >= 0
    jst = j_minimize_fire_batched(lambda c: jmodel(sp, c), jnp.asarray(co),
                                  atom_mask=jnp.asarray(mask), max_steps=ITERS, fmax=UNREACHABLE)
    st = minimize_fire_batched(lambda c: pmodel(sp, c), co, atom_mask=mask, max_steps=ITERS,
                               fmax=UNREACHABLE, device=CPU)
    _assert_same_schedule(st, jst)
    np.testing.assert_allclose(st.coords.numpy(), np.asarray(jst.coords), atol=1e-5, rtol=0)
    np.testing.assert_allclose(st.energy.numpy(), np.asarray(jst.energy), rtol=1e-6)
    assert torch.equal(st.coords[0, 3], torch.zeros(3)) and float(st.forces[0, 3].abs().max()) == 0


def _quadratic(k, x0):
    def energy(c):
        return 0.5 * (k * (c - x0) ** 2).sum(axis=(-1, -2))

    return energy


def test_convergence_and_frozen_conformers_match_jax():
    """A separable quadratic, each conformer with its own stiffness: every
    one converges, the stiff ones first; a converged conformer keeps its
    state and has zero velocity while the others go on."""
    rng = np.random.RandomState(0)
    x0 = rng.randn(3, 5, 3).astype(np.float32)
    start = (x0 + rng.randn(3, 5, 3)).astype(np.float32)
    k = np.array([4.0, 1.0, 0.25], np.float32)[:, None, None]
    fmax = 1e-3
    jst = j_minimize_fire_batched(_quadratic(jnp.asarray(k), jnp.asarray(x0)), jnp.asarray(start),
                                  max_steps=400, fmax=fmax)
    st = minimize_fire_batched(_quadratic(torch.as_tensor(k), torch.as_tensor(x0)), start,
                               max_steps=400, fmax=fmax, device=CPU)
    assert bool((st.fmax <= fmax).all()) and st.step < 400
    _assert_same_schedule(st, jst)
    np.testing.assert_allclose(st.coords.numpy(), np.asarray(jst.coords), atol=1e-5, rtol=0)
    np.testing.assert_allclose(st.coords.numpy(), x0, atol=2 * fmax / 0.25)
    # one iteration short of the end some conformers had converged already:
    # through the last iteration they kept their state, with zero velocity
    early = minimize_fire_batched(_quadratic(torch.as_tensor(k), torch.as_tensor(x0)), start,
                                  max_steps=st.step - 1, fmax=fmax, device=CPU)
    frozen = early.fmax <= fmax
    assert bool(frozen.any()) and not bool(frozen.all())
    assert torch.equal(early.coords[frozen], st.coords[frozen])
    assert torch.equal(early.dt[frozen], st.dt[frozen])
    assert torch.equal(st.velocities[frozen], torch.zeros_like(st.velocities[frozen]))
    assert bool((st.velocities[~frozen] != 0).any())

    one = minimize_fire(_quadratic(torch.tensor(1.0), torch.as_tensor(x0[0])), start[0],
                        max_steps=400, fmax=fmax, device=CPU)
    jone = j_minimize_fire(_quadratic(1.0, jnp.asarray(x0[0])), jnp.asarray(start[0]),
                           max_steps=400, fmax=fmax)
    assert float(one.fmax) <= fmax and one.step == int(jone.step) < 400
    np.testing.assert_allclose(one.coords.numpy(), np.asarray(jone.coords), atol=1e-5, rtol=0)
