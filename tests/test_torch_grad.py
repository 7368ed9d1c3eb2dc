"""PyTorch port: Hessians, vibrational analysis, ensemble forces, stress and
force-loss weight gradients (`torchani_tpu_torch.grad`) against the JAX
package's and the goldens, on the CPU.

Hessians against ``tests/resources/vib_goldens.npz`` at the JAX test's
tolerance (atol 2e-4, rtol 1e-3; symmetric to 1e-4), through the plain
angular path and through the kernel strategy (whose second derivative runs
K3bb's plain version); against ``torchani_tpu.grad.hessians`` on a padded
batch of two molecules with fewer replicated rows a pass than 3A, so that
several passes run, at the same tolerance.  Vibrational analysis of one
Hessian in both packages: frequencies, force constants and reduced masses
rtol 1e-4 (f32 eigendecompositions by two libraries), modes up to their sign
atol 1e-4.  Ensemble energies and forces atol 5e-5 and 1e-5 (the f32
tolerances of ``tests/test_energies.py``); stress atol 5e-6 Ha/A^3 between
the packages and between the two kinds (``tests/test_ase.py``), 5e-4
against a central finite difference (``tests/test_gradcheck.py``).  Weight
gradients of the force loss of ``tests/test_grad.py`` against ``jax.grad``,
scaled by max|ref|, atol 1e-5, rtol 1e-4.

The ANI-2dr-style model of ``tests/test_torch_hetero_md.py`` (networks,
xTB repulsion and D3 dispersion on a ``cell_list``, which takes a single
system): the Hessian of the first 9 atoms of the 96-atom water box, with and
without its periodic cell, against JAX's at the Hessian tolerance above;
`single_point(vibrational=True)` on the same atoms against JAX's analysis of
JAX's Hessian, frequencies above 100 cm^-1 rtol 1e-3 (below it the
eigenvalues sit within the Hessians' rounding of zero); both stresses of the
whole box against JAX's, atol 5e-6 of max|s| (f32 sums over the box's lanes
in another order: ~1.6e-6 of max|s| seen).  A model without an ensemble
makes `members_energies_and_forces` and `force_qbc` raise, as in JAX.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchani_tpu as tt
import torchani_tpu.grad as jgrad
import torchani_tpu.neighbors as jneighbors
from torchani_tpu.convert import load_state_dict as jload_state_dict
from torchani_tpu_torch import convert, grad
from torchani_tpu_torch.aev.kernels import angular_aev_bwd_bwd
from torchani_tpu_torch.arch import simple_ani
from torchani_tpu_torch.interop import _resolve, load_jax_arrays
from torchani_tpu_torch.testing import make_molecs, make_water_box

from conftest import load_golden
from test_torch_hetero_md import ani2dr_style_models

torch.set_num_threads(2)
CPU = "cpu"


def _leaves(tree):
    return {
        jax.tree_util.keystr(p): np.asarray(x)
        for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


@pytest.fixture(scope="module")
def vib():
    g = load_golden("vib_goldens.npz")
    sd = {k[3:]: v for k, v in g.items() if k.startswith("sd.")}
    pmodel = convert.load_state_dict(simple_ani(("H", "C", "N", "O"), ensemble_size=1,
                                                device=CPU), sd)
    jmodel = jload_state_dict(tt.simple_ani(("H", "C", "N", "O"), ensemble_size=1), sd)
    return g, pmodel, jmodel


@pytest.fixture(scope="module")
def ensemble():
    jmodel = tt.simple_ani(("H", "C", "N", "O"), ensemble_size=4, key=jax.random.PRNGKey(4))
    pmodel = simple_ani(("H", "C", "N", "O"), ensemble_size=4, device=CPU)
    return jmodel, load_jax_arrays(pmodel, _leaves(jmodel))


@pytest.mark.parametrize("strategy", ["plain", "cuda"])
def test_hessian_matches_goldens(vib, strategy):
    g, pmodel, _ = vib
    pmodel.aev_computer.strategy = strategy
    try:
        before = angular_aev_bwd_bwd.launches
        h = grad.hessians(pmodel, g["species"], g["coords"]).numpy()
        assert angular_aev_bwd_bwd.launches == before
    finally:
        pmodel.aev_computer.strategy = "auto"
    np.testing.assert_allclose(h, g["hessians"], atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(h[0], h[0].T, atol=1e-4)
    f, hh = grad.forces_and_hessians(pmodel, g["species"], g["coords"])
    np.testing.assert_allclose(f.numpy(), g["forces"], atol=1e-5)
    e, f2, h2 = grad.energies_forces_and_hessians(pmodel, g["species"], g["coords"])
    np.testing.assert_allclose(e.numpy(), g["energies"], atol=5e-5)
    assert torch.equal(f, f2) and torch.equal(hh, h2)
    np.testing.assert_allclose(grad.grads(pmodel, g["species"], g["coords"]).numpy(), -g["forces"],
                               atol=1e-5)


@pytest.mark.parametrize("strategy", ["plain", "cuda"])
def test_hessian_matches_jax_on_a_padded_batch(ensemble, strategy, monkeypatch):
    jmodel, pmodel = ensemble
    species, coords = make_molecs(2, 5, seed=3, box=2.5)
    assert (species < 0).any()  # a padded molecule
    c, a = species.shape
    rows = 4
    monkeypatch.setattr(grad, "_HESSIAN_BUDGET_BYTES", rows * c * a * grad._HESSIAN_ATOM_BYTES)
    assert grad.hessian_rows(c, a) == rows < 3 * a
    calls = []
    real_grad = torch.autograd.grad

    def counting_grad(*args, **kwargs):
        calls.append(kwargs.get("create_graph", False))
        return real_grad(*args, **kwargs)

    monkeypatch.setattr(torch.autograd, "grad", counting_grad)
    pmodel.aev_computer.strategy = strategy
    try:
        h = grad.hessians(pmodel, species, coords).numpy()
    finally:
        pmodel.aev_computer.strategy = "auto"
    assert calls.count(True) == -(-3 * a // rows)  # one pass per chunk of rows
    ref = np.asarray(jax.jit(lambda sp, co: jgrad.hessians(jmodel, sp, co))(
        jnp.asarray(species), jnp.asarray(coords)))
    assert h.shape == ref.shape == (c, 3 * a, 3 * a)
    np.testing.assert_allclose(h, ref, atol=2e-4, rtol=1e-3)
    pad = np.repeat(species < 0, 3, axis=1)
    assert (h[pad] == 0).all()


def _same_up_to_sign(a, b, atol):
    """Each mode (row along axis 1) equal up to its sign."""
    a = a.reshape(a.shape[0], a.shape[1], -1)
    b = b.reshape(b.shape[0], b.shape[1], -1)
    sign = np.sign(np.sum(a * b, axis=-1, keepdims=True))
    np.testing.assert_allclose(a * sign, b, atol=atol)


@pytest.mark.parametrize("unit", ["cm^-1", "meV"])
@pytest.mark.parametrize("mode_type", ["MDU", "MDN", "MWN"])
def test_vibrational_analysis_matches_jax(mode_type, unit):
    """A random symmetric Hessian (well separated eigenvalues, some
    negative) and masses.  The JAX function returns cm^-1 whatever ``unit``
    says; the port converts to meV, so the JAX frequencies are converted
    here."""
    rng = np.random.RandomState(5)
    c, a = 2, 4
    q = np.linalg.qr(rng.randn(c, 3 * a, 3 * a))[0]
    lam = np.linspace(-0.2, 1.5, 3 * a) + 0.01 * rng.rand(c, 3 * a)
    hess = np.einsum("cij,cj,ckj->cik", q, lam, q).astype(np.float32)
    hess = 0.5 * (hess + hess.transpose(0, 2, 1))
    masses = rng.uniform(1.0, 16.0, (c, a)).astype(np.float32)
    out = grad.vibrational_analysis(torch.as_tensor(masses), torch.as_tensor(hess), mode_type, unit)
    ref = jgrad.vibrational_analysis(jnp.asarray(masses), jnp.asarray(hess), mode_type, unit)
    freqs = np.asarray(ref.freqs)
    if unit == "meV":
        freqs = freqs * tt.units.SQRT_MHESSIAN_TO_MILLIEV / tt.units.SQRT_MHESSIAN_TO_INVCM
    np.testing.assert_allclose(out.freqs.numpy(), freqs, rtol=1e-4)
    np.testing.assert_allclose(out.fconstants.numpy(), np.asarray(ref.fconstants), rtol=1e-4,
                               atol=1e-4 * np.abs(np.asarray(ref.fconstants)).max())
    np.testing.assert_allclose(out.rmasses.numpy(), np.asarray(ref.rmasses), rtol=1e-4)
    assert out.modes.shape == (c, 3 * a, a, 3)
    _same_up_to_sign(out.modes.numpy(), np.asarray(ref.modes), atol=1e-4)
    with pytest.raises(ValueError):
        grad.vibrational_analysis(torch.as_tensor(masses), torch.as_tensor(hess), unit="Hz")


def test_single_point_vibrational(vib):
    g, pmodel, jmodel = vib
    out = grad.single_point(pmodel, g["species"], g["coords"], vibrational=True, forces=True)
    # JAX's single_point analyses its own Hessian, which equals the golden
    # one to the tolerance above: analyse the golden one
    jmasses = tt.utils.get_atomic_masses(jnp.asarray(g["species"]))
    vib = jgrad.vibrational_analysis(jmasses, jnp.asarray(g["hessians"]))
    ref = {"freqs": vib.freqs, "force_constants": vib.fconstants, "reduced_masses": vib.rmasses}
    freqs = out["freqs"].numpy()[0]
    assert freqs.shape == (9,) and np.isfinite(freqs).all()
    assert freqs[-1] >= freqs[-2] >= freqs[-3] > 0
    # the two stretches (under these weights the other modes are imaginary
    # or near zero, where rounding decides)
    np.testing.assert_allclose(freqs[-2:], np.asarray(ref["freqs"])[0, -2:], rtol=1e-3)
    np.testing.assert_allclose(out["hessians"].numpy(), g["hessians"], atol=2e-4, rtol=1e-3)
    assert out["modes"].shape == (1, 9, 3, 3)
    for key in ("force_constants", "reduced_masses"):
        assert out[key].shape == (1, 9)
        np.testing.assert_allclose(out[key].numpy()[0, -2:], np.asarray(ref[key])[0, -2:],
                                   rtol=2e-3)


def test_members_energies_and_forces_match_jax(ensemble):
    jmodel, pmodel = ensemble
    species, coords = make_molecs(3, 8, seed=6)
    e, f = grad.members_energies_and_forces(pmodel, species, coords)
    je, jf = jax.jit(lambda sp, co: jgrad.members_energies_and_forces(jmodel, sp, co))(
        jnp.asarray(species), jnp.asarray(coords))
    assert e.shape == (4, 3) and f.shape == (4, 3, 8, 3)
    np.testing.assert_allclose(e.numpy(), np.asarray(je), atol=5e-5)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), atol=1e-5)
    np.testing.assert_allclose(f.mean(0).numpy(), grad.forces(pmodel, species, coords).numpy(),
                               atol=1e-5)
    qbc = grad.force_qbc(pmodel, species, coords)
    np.testing.assert_allclose(
        qbc.numpy(),
        np.asarray(jax.jit(lambda sp, co: jgrad.force_qbc(jmodel, sp, co))(
            jnp.asarray(species), jnp.asarray(coords))),
        atol=1e-5,
    )


@pytest.fixture(scope="module")
def box():
    species, coords, cell = make_water_box(30)
    return species, coords, cell, np.ones(3, dtype=bool)


def test_stress_matches_jax_and_the_other_kind(ensemble, box):
    jmodel, pmodel = ensemble
    species, coords, cell, pbc = box
    jargs = tuple(jnp.asarray(x) for x in box)
    out = {}
    for kind in ("scaling", "fdotr"):
        s = getattr(grad, f"stress_{kind}")(pmodel, species, coords, cell, pbc).numpy()
        fn = getattr(jgrad, f"stress_{kind}")
        # the cell is a constant of the trace: the JAX neighbor list reads it
        ref = np.asarray(jax.jit(lambda sp, co: fn(jmodel, sp, co, cell, pbc))(*jargs[:2]))
        assert s.shape == (3, 3)
        np.testing.assert_allclose(s, ref, atol=5e-6)
        out[kind] = s
    np.testing.assert_allclose(out["scaling"], out["fdotr"], atol=5e-6)
    # without a cell the virial is not divided by a volume
    virial = grad.stress_fdotr(pmodel, species, coords, None, None).numpy()
    ref = np.asarray(jax.jit(lambda sp, co: jgrad.stress_fdotr(jmodel, sp, co, None, None))(
        *jargs[:2]))
    np.testing.assert_allclose(virial, ref, atol=5e-6 * abs(np.linalg.det(cell)))


def test_stress_matches_finite_difference(ensemble, box):
    _, pmodel = ensemble
    species, coords, cell, pbc = box
    analytic = grad.stress_scaling(pmodel, species, coords, cell, pbc).numpy()
    volume = float(abs(np.linalg.det(cell)))
    eps = 1e-4
    for axis in range(3):
        scaled = []
        for sign in (1, -1):
            m = np.eye(3, dtype=np.float32)
            m[axis, axis] += sign * eps
            scaled.append(float(grad.energies(pmodel, species, coords @ m, cell @ m, pbc)[0]))
        numerical = (scaled[0] - scaled[1]) / (2 * eps) / volume
        np.testing.assert_allclose(analytic[axis, axis], numerical, atol=5e-4)


def test_force_loss_weight_gradients_match_jax(vib):
    """The energy + force loss of ``tests/test_grad.py`` through the kernel
    strategy's CPU path (its second derivative runs K3bb's plain version,
    whose J u half carries the force loss to the weights), against
    ``jax.grad`` of the same loss, and against the plain strategy."""
    g, pmodel, jmodel = vib
    species, coords, target = g["species"], g["coords"], g["forces"]

    def jloss(m):
        def esum(mm, c):
            return jnp.sum(mm(jnp.asarray(species), c))

        e = m(jnp.asarray(species), jnp.asarray(coords))
        f = -jax.grad(esum, argnums=1)(m, jnp.asarray(coords))
        return jnp.mean(e**2) + jnp.mean((f - jnp.asarray(target)) ** 2)

    ref = _leaves(jax.jit(jax.grad(jloss))(jmodel))

    def port_grads(strategy):
        pmodel.aev_computer.strategy = strategy
        pmodel.zero_grad()
        try:
            e = pmodel(species, coords)
            f = grad.forces_for_training(pmodel, species, coords)
            assert f.requires_grad
            loss = torch.mean(e**2) + torch.mean((f - torch.as_tensor(target)) ** 2)
            loss.backward()
        finally:
            pmodel.aev_computer.strategy = "auto"
        return {n: p.grad.clone() for n, p in pmodel.named_parameters()}

    kernel, plain = port_grads("cuda"), port_grads("plain")
    params = dict(pmodel.named_parameters())
    by_id = {id(t): name for name, t in params.items()}
    compared = 0
    for path, jg in ref.items():
        try:
            target_t = _resolve(pmodel, path)
        except KeyError:
            continue
        name = by_id.get(id(target_t))
        if name is None:
            continue  # a constant of the JAX tree, a buffer in the port
        scale = np.abs(jg).max() + 1e-12
        np.testing.assert_allclose(kernel[name].numpy() / scale, jg / scale, atol=1e-5, rtol=1e-4)
        np.testing.assert_allclose(kernel[name].numpy() / scale, plain[name].numpy() / scale,
                                   atol=1e-5, rtol=1e-4)
        compared += 1
    assert compared == len(params) > 0
    assert any(float(t.abs().max()) > 0 for t in kernel.values())


@pytest.fixture(scope="module")
def dr():
    """The ANI-2dr-style model in both packages and the 96-atom water box."""
    jmodel, pmodel = ani2dr_style_models()
    return (jmodel, pmodel) + make_water_box(96) + (np.ones(3, dtype=bool),)


def _jax_cell_list_model(jmodel, coords):
    """``jmodel`` whose cell list has the bucket grid that it would take from
    the bounding cell of ``coords`` (1, A, 3) outside jit: under jit that
    cell is traced, and the grid shape must be static."""
    _, cell = jneighbors.compute_bounding_cell(jnp.asarray(coords[0]), eps=1e-3)
    shape = jneighbors._static_grid_shape(np.asarray(cell), jmodel.cutoff)
    return jmodel.replace(neighborlist=functools.partial(jneighbors.cell_list, grid_shape=shape))


@pytest.fixture(scope="module")
def dr_hessians(dr):
    """JAX's Hessians of the box's first 9 atoms, isolated and periodic."""
    jmodel, _, species, coords, cell, pbc = dr
    sp, co = jnp.asarray(species[:, :9]), jnp.asarray(coords[:, :9])
    isolated = _jax_cell_list_model(jmodel, coords[:, :9])
    both = jax.jit(lambda s, c: (jgrad.hessians(isolated, s, c),
                                 jgrad.hessians(jmodel, s, c, cell, pbc)))(sp, co)
    return dict(zip(("isolated", "periodic"), map(np.asarray, both)))


@pytest.mark.parametrize("periodic", [False, True], ids=["isolated", "periodic"])
def test_cell_list_hessian_matches_jax(dr, dr_hessians, periodic):
    """`hessians` of a model whose neighbor list takes a single system: the
    topology is built once and replicated, as for any other model."""
    _, pmodel, species, coords, cell, pbc = dr
    args = (species[:, :9], coords[:, :9]) + ((cell, pbc) if periodic else ())
    ref = dr_hessians["periodic" if periodic else "isolated"]
    e, f, h = grad.energies_forces_and_hessians(pmodel, *args)
    assert ref.shape == h.shape == (1, 27, 27)
    np.testing.assert_allclose(h.numpy(), ref, atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(h[0].numpy(), h[0].T.numpy(), atol=1e-4)
    e_ref, f_ref = grad.energies_and_forces(pmodel, *args)
    assert torch.equal(e, e_ref) and torch.equal(f, f_ref)


def test_cell_list_single_point_vibrational(dr, dr_hessians):
    _, pmodel, species, coords, cell, pbc = dr
    out = grad.single_point(pmodel, species[:, :9], coords[:, :9], cell, pbc, vibrational=True)
    ref_h = dr_hessians["periodic"]
    np.testing.assert_allclose(out["hessians"].numpy(), ref_h, atol=2e-4, rtol=1e-3)
    jmasses = tt.utils.get_atomic_masses(jnp.asarray(species[:, :9]))
    vib = jgrad.vibrational_analysis(jmasses, jnp.asarray(ref_h))
    freqs, ref_freqs = out["freqs"].numpy()[0], np.asarray(vib.freqs)[0]
    assert freqs.shape == (27,) and np.isfinite(freqs).all()
    clear = np.abs(ref_freqs) > 100.0
    assert clear.sum() >= 9
    np.testing.assert_allclose(freqs[clear], ref_freqs[clear], rtol=1e-3)
    assert out["modes"].shape == (1, 27, 9, 3)
    for key, ref in (("force_constants", vib.fconstants), ("reduced_masses", vib.rmasses)):
        ref = np.asarray(ref)[0]
        np.testing.assert_allclose(out[key].numpy()[0][clear], ref[clear], rtol=2e-3,
                                   atol=1e-3 * np.abs(ref[clear]).max())


def test_cell_list_stress_matches_jax(dr):
    jmodel, pmodel, species, coords, cell, pbc = dr
    refs = jax.jit(lambda sp, co: (jgrad.stress_scaling(jmodel, sp, co, cell, pbc),
                                   jgrad.stress_fdotr(jmodel, sp, co, cell, pbc)))(
        jnp.asarray(species), jnp.asarray(coords))
    for kind, ref in zip(("scaling", "fdotr"), map(np.asarray, refs)):
        s = getattr(grad, f"stress_{kind}")(pmodel, species, coords, cell, pbc).numpy()
        assert s.shape == (3, 3) and np.abs(ref).max() > 0
        np.testing.assert_allclose(s, ref, rtol=0, atol=5e-6 * np.abs(ref).max())


def test_members_and_force_qbc_raise_without_an_ensemble(vib):
    """A one-member model's ``ensemble_values=True`` output is ``(C,)``: no
    member axis, so neither package gives members' forces."""
    _, pmodel, jmodel = vib
    species, coords = make_molecs(3, 8, seed=6)
    assert tuple(pmodel(species, coords, ensemble_values=True).shape) == (3,)
    with pytest.raises(ValueError, match="no ensemble"):
        grad.members_energies_and_forces(pmodel, species, coords)
    with pytest.raises(ValueError, match="no ensemble"):
        grad.force_qbc(pmodel, species, coords)
    with pytest.raises(ValueError):
        jax.jit(lambda sp, co: jgrad.members_energies_and_forces(jmodel, sp, co))(
            jnp.asarray(species), jnp.asarray(coords))
