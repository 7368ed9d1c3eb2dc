"""PyTorch port: the ASE `Calculator` against the JAX package's, on the CPU,
with ``tests/test_ase.py``'s stub of ``ase`` (the real package is not
installed here, nor on the card's machine).

A one-member `simple_ani` (H, O) whose weights come through
`torchani_tpu_torch.interop`: energy and free energy in eV within rtol 1e-6,
forces in eV/A within 1e-5 of the JAX calculator's; on a periodic 24-atom
water box the ``scaling`` and ``fdotr`` stresses agree with each other
(atol 5e-6 eV/A^3, as in ``tests/test_ase.py``) and with the JAX
calculator's; the errors for stress without a cell and an unknown kind.
"""

import importlib

import jax
import numpy as np
import pytest

import torchani_tpu as tt
from torchani_tpu_torch.arch import simple_ani
from torchani_tpu_torch.interop import load_jax_arrays
from torchani_tpu_torch.testing import make_water_box

from test_ase import _Atoms, _install_ase_stub

WATER_POS = [[0.0, 0.0, 0.119], [0.0, 0.763, -0.477], [0.0, -0.763, -0.477]]


def _leaves(tree):
    return {
        jax.tree_util.keystr(p): np.asarray(x)
        for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


@pytest.fixture(scope="module")
def calcs():
    _install_ase_stub()
    import torchani_tpu.ase as jase
    import torchani_tpu_torch.ase as pase

    jase, pase = importlib.reload(jase), importlib.reload(pase)
    jmodel = tt.simple_ani(("H", "O"), ensemble_size=1)
    pmodel = load_jax_arrays(simple_ani(("H", "O"), ensemble_size=1, device="cpu"),
                             _leaves(jmodel))
    return jase, pase, jmodel, pmodel


def test_energy_forces_ev_match_jax(calcs):
    jase, pase, jmodel, pmodel = calcs
    atoms = _Atoms([8, 1, 1], WATER_POS)
    ours, theirs = pase.Calculator(pmodel), jase.Calculator(jmodel)
    for calc in (ours, theirs):
        calc.calculate(atoms, properties=["energy", "forces"])
    assert ours.results["energy"] == pytest.approx(theirs.results["energy"], rel=1e-6)
    assert ours.results["free_energy"] == ours.results["energy"]
    assert isinstance(ours.results["forces"], np.ndarray) and ours.results["forces"].shape == (3, 3)
    np.testing.assert_allclose(ours.results["forces"], theirs.results["forces"], atol=1e-5)


def test_stress_kinds_agree_and_match_jax(calcs):
    jase, pase, jmodel, pmodel = calcs
    species, coords, cell = make_water_box(24)
    atoms = _Atoms(species[0], coords[0], cell=cell, pbc=True)
    results = {}
    for kind in ("scaling", "fdotr"):
        calc, jcalc = pase.Calculator(pmodel, stress_kind=kind), jase.Calculator(jmodel, stress_kind=kind)
        for c in (calc, jcalc):
            c.calculate(atoms, properties=["energy", "forces", "stress"])
        assert calc.results["stress"].shape == (6,)
        np.testing.assert_allclose(calc.results["stress"], jcalc.results["stress"], atol=1e-6)
        np.testing.assert_allclose(calc.results["forces"], jcalc.results["forces"], atol=1e-5)
        results[kind] = calc.results["stress"]
    np.testing.assert_allclose(results["scaling"], results["fdotr"], atol=5e-6)
    assert np.abs(results["scaling"]).max() > 1e-4


def test_errors(calcs):
    _, pase, _, pmodel = calcs
    calc = pase.Calculator(pmodel)
    atoms = _Atoms([8, 1, 1], np.random.RandomState(0).rand(3, 3) * 2)
    with pytest.raises(RuntimeError, match="periodic cell"):
        calc.calculate(atoms, properties=["energy", "stress"])
    with pytest.raises(ValueError, match="stress kind"):
        pase.Calculator(pmodel, stress_kind="bogus")
