"""PyTorch port: the published-scheme weight converter (`torchani_tpu_torch.convert`)
and the ANI-1x / ANI-1ccx factories, against the reference goldens and the
JAX package.

The goldens hold the reference TorchANI's seeded random weights in the
published key scheme with its energies and forces.  Tolerances: the zoo
goldens at the BASELINE gate (1e-5 Ha, 1e-5 Ha/A); `model_goldens.npz` at
`tests/test_energies.py`'s (totals atol 1e-5 + rtol 2.4e-7, atomic energies
and forces atol 1e-5, members atol 5e-5); the port against the JAX factories
forces atol 1e-5 Ha/A and atomic energies atol 5e-5 Ha (as
`tests/test_torch_models.py`).
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import RESOURCES, load_golden
from torchani_tpu import convert as jconvert
from torchani_tpu import models as jzoo
from torchani_tpu.arch import simple_ani as jsimple_ani
from torchani_tpu.grad import single_point as j_single_point
from torchani_tpu_torch import convert, models
from torchani_tpu_torch.arch import simple_ani
from torchani_tpu_torch.grad import energies_and_forces, single_point
from torchani_tpu_torch.testing import make_water_box

torch.set_num_threads(2)
CPU = "cpu"


def _sd(golden):
    return {k[len("sd."):]: v for k, v in golden.items() if k.startswith("sd.")}


_NO_JAX_LOAD = """
import sys
import numpy as np
from torchani_tpu_torch import convert, models
from torchani_tpu_torch.grad import energies_and_forces
g = dict(np.load(sys.argv[1]))
sd = {{k[3:]: v for k, v in g.items() if k.startswith("sd.")}}
model = convert.load_state_dict(models.{factory}(device="cpu"), sd)
e, f = energies_and_forces(model, g["species"], g["coords"])
print(float(np.abs(e.numpy() - g["energies"]).max()), float(np.abs(f.numpy() - g["forces"]).max()))
roots = ("jax", "jaxlib", "flax", "torchani_tpu")
print(sorted(m for m in sys.modules if m.split(".")[0] in roots))
"""


@pytest.mark.parametrize("name,factory", [("ani2x", "ANI2x"), ("ani2xr", "ANI2xr")])
def test_zoo_goldens_through_the_ports_converter(name, factory):
    """In a fresh interpreter that never imports JAX."""
    out = subprocess.run(
        [sys.executable, "-c", _NO_JAX_LOAD.format(factory=factory),
         f"{RESOURCES}/zoo_goldens_{name}.npz"],
        capture_output=True, text=True, check=True,
    ).stdout.splitlines()
    de, df = (float(x) for x in out[0].split())
    assert de < 1e-5 and df < 1e-5
    assert out[1] == "[]"


@pytest.fixture(scope="module")
def small():
    g = load_golden("model_goldens.npz")
    model = simple_ani(("H", "C", "N", "O"), ensemble_size=2, device=CPU)
    return g, convert.load_state_dict(model, _sd(g))


def test_model_goldens(small):
    g, model = small
    sp, co = g["species"], g["coords"]
    with torch.no_grad():
        e = model(sp, co).numpy()
        atomic = model(sp, co, atomic=True).numpy()
        members = model(sp, co, ensemble_values=True).numpy()
    _, f = energies_and_forces(model, sp, co)
    np.testing.assert_allclose(e, g["energies"], atol=1e-5, rtol=2.4e-7)
    np.testing.assert_allclose(atomic, g["atomic"], atol=1e-5)
    np.testing.assert_allclose(members, g["members"], atol=5e-5)
    np.testing.assert_allclose(f.numpy(), g["forces"], atol=1e-5)


def _to_legacy(k: str) -> str:
    """The pre-refactor key scheme of `tests/test_zoo_convert.py`."""
    k = k.replace(".atomics.", ".")
    if ".layers." in k:
        head, rest = k.split(".layers.", 1)
        idx, leaf = rest.split(".", 1)
        k = f"{head}.{2 * int(idx)}.{leaf}"
    k = k.replace(".final_layer.", ".6.")
    if k.startswith("potentials.nnp."):
        k = k[len("potentials.nnp."):]
    elif k.startswith("potentials.repulsion_xtb."):
        k = "potentials.1." + k[len("potentials.repulsion_xtb."):]
    return k


def test_legacy_keys_canonicalize_as_in_jax():
    g = load_golden("zoo_goldens_ani2xr.npz")
    sd = _sd(g)
    legacy = {_to_legacy(k): v for k, v in sd.items()}
    legacy["potentials.0.some_table"] = np.zeros(2)
    legacy["potentials.2.aev_computer.angular.eta"] = np.ones(1)
    canon = convert.canonicalize_torch_keys(legacy)
    assert list(canon) == list(jconvert.canonicalize_torch_keys(legacy))
    assert set(canon) == set(sd) | {
        "potentials.dispersion_d3.some_table", "potentials.nnp.aev_computer.angular.eta"
    }
    del legacy["potentials.0.some_table"], legacy["potentials.2.aev_computer.angular.eta"]
    model = convert.load_state_dict(models.ANI2xr(device=CPU), legacy)
    e, f = energies_and_forces(model, g["species"], g["coords"])
    assert np.abs(e.numpy() - g["energies"]).max() < 1e-5
    assert np.abs(f.numpy() - g["forces"]).max() < 1e-5


FACTORIES = {"ANI1x": (models.ANI1x, jzoo.ANI1x), "ANI1ccx": (models.ANI1ccx, jzoo.ANI1ccx)}


@pytest.fixture(scope="module")
def water300():
    return make_water_box(300)


def _compare(pmodel, jmodel, species, coords, cell=None):
    pbc = None if cell is None else np.ones(3, dtype=bool)
    out = single_point(pmodel, species, coords, cell, pbc, forces=True, atomic_energies=True)
    # jitted (eager JAX takes ten times as long); the cell stays a constant
    jcell = None if cell is None else jnp.asarray(cell)
    jpbc = None if pbc is None else jnp.asarray(pbc)
    ref = jax.jit(
        lambda m, s, c: j_single_point(m, s, c, jcell, jpbc, forces=True, atomic_energies=True)
    )(jmodel, jnp.asarray(species), jnp.asarray(coords))
    np.testing.assert_allclose(out["forces"].numpy(), np.asarray(ref["forces"]), atol=1e-5, rtol=0)
    np.testing.assert_allclose(out["energies"].numpy(), np.asarray(ref["energies"]), rtol=1e-6)
    np.testing.assert_allclose(
        out["atomic_energies"].numpy(), np.asarray(ref["atomic_energies"]), atol=5e-5, rtol=0
    )


@pytest.mark.parametrize("name", sorted(FACTORIES))
def test_ani1_family_matches_jax(name, water300):
    """JAX's factory saves its weights; the port's loads them."""
    pfactory, jfactory = FACTORIES[name]
    jmodel = jfactory(pretrained=False, key=jax.random.PRNGKey(3))
    pmodel = convert.load_state_dict(pfactory(device=CPU), jconvert.save_state_dict(jmodel))
    assert pmodel.aev_computer.out_dim == 384 and len(pmodel.symbols) == 4
    np.testing.assert_array_equal(
        pmodel.energy_shifter.self_energies.numpy(), np.asarray(jmodel.energy_shifter.self_energies)
    )
    g = load_golden("model_goldens.npz")
    _compare(pmodel, jmodel, g["species"], g["coords"])
    species, coords, cell = water300
    _compare(pmodel, jmodel, species, coords, cell)


def test_save_round_trips_both_ways():
    """JAX -> port -> JAX and port -> JAX -> port, with equal key sets, on a
    two-member model with every kind of key (AEV constants, networks,
    repulsion tables, self energies)."""
    jsd = jconvert.save_state_dict(
        jsimple_ani(("H", "C", "N", "O"), ensemble_size=2, key=jax.random.PRNGKey(5))
    )
    pmodel = convert.load_state_dict(
        simple_ani(("H", "C", "N", "O"), ensemble_size=2, device=CPU), jsd
    )
    psd = convert.save_state_dict(pmodel)
    assert set(psd) == set(jsd)
    for k in jsd:
        np.testing.assert_array_equal(psd[k], np.asarray(jsd[k]), err_msg=k)
    own = simple_ani(("H", "C", "N", "O"), ensemble_size=2, seed=7, device=CPU)
    own_sd = convert.save_state_dict(own)
    jmodel = jconvert.load_state_dict(jsimple_ani(("H", "C", "N", "O"), ensemble_size=2), own_sd)
    back = jconvert.save_state_dict(jmodel)
    assert set(back) == set(own_sd)
    for k in own_sd:
        np.testing.assert_array_equal(np.asarray(back[k]), own_sd[k], err_msg=k)
    g = load_golden("model_goldens.npz")
    _compare(own, jmodel, g["species"], g["coords"])


@pytest.mark.parametrize("form", ["plain", "lightning"])
def test_pt_files_load(form, tmp_path, small):
    g, _ = small
    sd = {k: torch.as_tensor(v) for k, v in _sd(g).items()}
    if form == "lightning":
        sd = {"state_dict": {"model." + k: v for k, v in sd.items()}, "epoch": 3}
    path = tmp_path / "weights.pt"
    torch.save(sd, path)
    loaded = convert.load_torch_state_dict(path)
    assert set(loaded) == set(_sd(g))
    model = convert.load_state_dict(
        simple_ani(("H", "C", "N", "O"), ensemble_size=2, device=CPU), loaded
    )
    with torch.no_grad():
        e = model(g["species"], g["coords"]).numpy()
    np.testing.assert_allclose(e, g["energies"], atol=1e-5, rtol=2.4e-7)


def _broken(sd, case):
    sd = dict(sd)
    w = "potentials.nnp.neural_networks.members.1.atomics.C.layers.1.weight"
    if case == "missing_final_layer":
        del sd["potentials.nnp.neural_networks.members.0.atomics.N.final_layer.weight"]
    elif case == "wider_layer":
        sd[w] = np.zeros((sd[w].shape[0] + 1, sd[w].shape[1]), np.float32)
    elif case == "transposed_layer":
        sd[w] = sd[w].T.copy()
    elif case == "bias_of_another_width":
        sd["potentials.nnp.neural_networks.members.0.atomics.H.layers.0.bias"] = np.zeros(3)
    elif case == "aev_constant_size":
        sd["potentials.nnp.aev_computer.radial.shifts"] = np.zeros(3, np.float32)
    elif case == "self_energies_size":
        sd["energy_shifter.self_energies"] = np.zeros(2, np.float32)
    return sd


@pytest.mark.parametrize(
    "case,error",
    [
        ("missing_final_layer", KeyError),
        ("wider_layer", ValueError),
        ("transposed_layer", ValueError),
        ("bias_of_another_width", ValueError),
        ("aev_constant_size", ValueError),
        ("self_energies_size", ValueError),
    ],
)
def test_bad_state_dicts_raise(case, error, small):
    g, _ = small
    model = simple_ani(("H", "C", "N", "O"), ensemble_size=2, device=CPU)
    with pytest.raises(error):
        convert.load_state_dict(model, _broken(_sd(g), case))


def test_absent_constants_keep_the_models_values(small):
    g, _ = small
    sd = {k: v for k, v in _sd(g).items() if "aev_computer" not in k}
    model = simple_ani(("H", "C", "N", "O"), ensemble_size=2, device=CPU)
    before = model.aev_computer.radial.shifts.clone()
    convert.load_state_dict(model, sd)
    assert torch.equal(model.aev_computer.radial.shifts, before)


def test_numpy_state_dict_matches_jax():
    layer = torch.nn.Linear(3, 2)
    ours, ref = convert.numpy_state_dict(layer), jconvert.numpy_state_dict(layer)
    assert set(ours) == set(ref) == {"weight", "bias"}
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k])
