"""PyTorch port: the public names of the JAX package's reference surface
(`tests/test_api_parity.py:REFERENCE_SURFACE`) that the port has, and an
explicit list of those it still lacks; then every module of the JAX package
against the port's module of the same name: each name of its ``__all__``
(or, without one, each public function and class it defines) must be in
the port, but for an explicit list of names left out, each with its reason.

Each test fails when a listed name is missing from the port, and also when
a name on a list of missing or left-out ones appears: it then leaves the
list, so the lists can only shrink as the port grows.
"""

import importlib
import inspect
import os
import pkgutil

import pytest

import torchani_tpu
from test_api_parity import REFERENCE_SURFACE
from test_torch_io import jax_csrc_module

#: the names of REFERENCE_SURFACE the port does not have yet, by module
#: (a module that the port lacks altogether lists all of its names)
MISSING: dict = {}

#: the JAX package's public names that the port leaves out, by module
#: (relative to the package), with the reason
LEFT_OUT = {
    "aev.pallas_kernels": (
        "angular_aev_pallas",
        "the TPU kernel; its port is K3, `torchani_tpu_torch.aev.kernels.angular_aev`",
    ),
    "profiling": (
        "PRINT_AEV_BRANCH",
        "a flag from the environment that no code of either package reads",
    ),
}
#: modules of the JAX package that are not Python (compiled extensions)
NATIVE = {"csrc.xyzparse": "the native xyz parser's extension module"}

#: the names that the charge models, the remaining pair potentials and the
#: rest of the model zoo brought
CHARGES_AND_ZOO = {
    "arch": "ANIq simple_aniq",
    "electro": "BaseChargeNormalizer ChargeNormalizer DipoleComputer compute_dipole",
    "models": "ANImbis ANIr2s ANIr2s_water ANIr2s_chcl3 ANIr2s_ch3cn SnnANI2xr",
    "potentials": (
        "DispersionLJ DummyPotential FixedCoulomb FixedMNOK LennardJones "
        "MergedChargesNNPotential RepulsionLJ SeparateChargesNNPotential"
    ),
    "nn": "SingleNN ANISharedNetworks",
    "tuples": "EnergiesAtomicCharges SpeciesAtomicCharges SpeciesEnergiesAtomicCharges",
}


def _port_module(mod: str):
    try:
        return importlib.import_module("torchani_tpu_torch" + ("." + mod if mod else ""))
    except ModuleNotFoundError:
        return None


def test_the_missing_list_names_only_reference_names():
    for mod, names in MISSING.items():
        assert mod in REFERENCE_SURFACE, mod
        assert set(names.split()) <= set(REFERENCE_SURFACE[mod].split()), mod


@pytest.mark.parametrize("mod", sorted(REFERENCE_SURFACE))
def test_module_surface(mod):
    m = _port_module(mod)
    missing = set(MISSING.get(mod, "").split())
    present = [n for n in REFERENCE_SURFACE[mod].split() if m is not None and hasattr(m, n)]
    absent = [n for n in REFERENCE_SURFACE[mod].split() if n not in present]
    assert sorted(absent) == sorted(missing), (
        f"torchani_tpu_torch.{mod}: lacks {sorted(set(absent) - missing)} that the list does "
        f"not name; has {sorted(missing - set(absent))} that the list still names"
    )


def test_charges_and_zoo_names_resolve():
    count = 0
    for mod, names in CHARGES_AND_ZOO.items():
        m = _port_module(mod)
        for n in names.split():
            assert hasattr(m, n), f"{mod}.{n}"
            count += 1
    assert count == 25


def _jax_modules():
    """The JAX package's modules, found on disk.  `pkgutil.walk_packages`
    would import each package to walk into it, and importing
    `torchani_tpu.csrc` builds its parser in the JAX package's directory
    (`test_torch_io.jax_csrc_module`); this list is made while every test
    process collects."""

    def walk(path, prefix):
        for info in pkgutil.iter_modules([path]):
            yield prefix + info.name
            if info.ispkg:
                yield from walk(os.path.join(path, info.name), f"{prefix}{info.name}.")

    return sorted(m for m in walk(torchani_tpu.__path__[0], "") if m not in NATIVE)


def _jax_module(mod: str):
    if mod == "csrc":  # without its import-time build
        return jax_csrc_module()
    return importlib.import_module("torchani_tpu." + mod)


def _public_names(module) -> set:
    if hasattr(module, "__all__"):
        return set(module.__all__)
    return {
        n for n, o in vars(module).items()
        if not n.startswith("_") and (inspect.isfunction(o) or inspect.isclass(o))
        and getattr(o, "__module__", None) == module.__name__
    }


def test_left_out_lists_name_jax_modules():
    modules = set(_jax_modules())
    assert set(LEFT_OUT) <= modules and set(NATIVE).isdisjoint(modules)
    assert all(reason for _, reason in LEFT_OUT.values())


@pytest.mark.parametrize("mod", _jax_modules())
def test_every_jax_module_surface(mod):
    names = _public_names(_jax_module(mod))
    port = _port_module(mod)
    absent = {n for n in names if port is None or not hasattr(port, n)}
    left_out = set(LEFT_OUT.get(mod, ("", ""))[0].split())
    assert absent == left_out, (
        f"torchani_tpu_torch.{mod}: lacks {sorted(absent - left_out)} that LEFT_OUT does not "
        f"name; has {sorted(left_out - absent)} that LEFT_OUT still names"
    )
