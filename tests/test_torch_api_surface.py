"""PyTorch port: the public names of the JAX package's reference surface
(`tests/test_api_parity.py:REFERENCE_SURFACE`) that the port has, and an
explicit list of those it still lacks.

Each module's test fails when a listed name is missing from the port, and
also when a name on the list of missing ones appears: it then leaves the
list, so the list can only shrink as the port grows.
"""

import importlib

import pytest

from test_api_parity import REFERENCE_SURFACE

#: the names of REFERENCE_SURFACE the port does not have yet, by module
#: (a module that the port lacks altogether lists all of its names)
MISSING = {
    "neurochem": REFERENCE_SURFACE["neurochem"],
    "legacy_data": REFERENCE_SURFACE["legacy_data"],
}

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
