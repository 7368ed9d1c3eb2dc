"""Atomic constants, ground-state atomic energies and the constants of the
pair potentials (xTB repulsion, DFT-D3(BJ) dispersion).

Plain Python data read from the port's own copies of the resources
(``resources/atomic_constants.json``, ``resources/gsaes.json``,
``resources/functional_d3bj_constants.json``, ``resources/c6_constants.npz``),
the same files the JAX package bundles.
"""

import functools
import json
import math
import typing as tp

import numpy as np

from torchani_tpu_torch.paths import resources_dir

__all__ = [
    "ATOMIC_CONSTANTS",
    "ATOMIC_NUMBER",
    "ATOMIC_MASS",
    "MASS",
    "PERIODIC_TABLE",
    "GSAES",
    "FUNCTIONAL_D3BJ_CONSTANTS",
    "COVALENT_RADIUS",
    "SQRT_EMPIRICAL_CHARGE",
    "XTB_REPULSION_ALPHA",
    "XTB_REPULSION_YEFF",
    "load_c6_constants",
]


def _load_json(name: str) -> dict:
    with open(resources_dir() / name, "rt") as f:
        return json.load(f)


#: Per-element constants table: symbol -> {znumber, mass, hardness, ...}
ATOMIC_CONSTANTS: tp.Dict[str, tp.Dict[str, float]] = _load_json(
    "atomic_constants.json"
)

#: Ground-state atomic energies (Hartree), keyed by level-of-theory string
#: then by element symbol
GSAES: tp.Dict[str, tp.Dict[str, float]] = _load_json("gsaes.json")

#: DFT-D3(BJ) damping parameters (s6, s8, a1, a2) per density functional
FUNCTIONAL_D3BJ_CONSTANTS: tp.Dict[str, tp.Dict[str, float]] = _load_json(
    "functional_d3bj_constants.json"
)

#: symbol -> atomic number
ATOMIC_NUMBER: tp.Dict[str, int] = {
    s: int(v["znumber"])
    for s, v in ATOMIC_CONSTANTS.items()
    if s and v.get("znumber") is not None
}

#: ``PERIODIC_TABLE[z]`` is the chemical symbol of atomic number ``z``
#: (index 0 is the empty string)
PERIODIC_TABLE: tp.Tuple[str, ...] = ("",) + tuple(
    s for s, _ in sorted(ATOMIC_NUMBER.items(), key=lambda kv: kv[1])
)

#: symbol -> atomic mass (AMU)
ATOMIC_MASS: tp.Dict[str, float] = {
    s: float(v["mass"])
    for s, v in ATOMIC_CONSTANTS.items()
    if s and v.get("mass") is not None
}

#: ``MASS[z]`` is the mass (AMU) of atomic number ``z`` (index 0 is NaN, as
#: are elements the table has no mass for)
MASS: tp.Tuple[float, ...] = tuple(
    ATOMIC_MASS.get(s, math.nan) if s else math.nan for s in PERIODIC_TABLE
)


def _znumber_indexed(key: str) -> tp.Tuple[float, ...]:
    """``seq[z]`` is property ``key`` of atomic number ``z`` (index 0 is NaN,
    as are elements the table has no value for)."""
    return tuple(
        float(ATOMIC_CONSTANTS[s][key])
        if s and ATOMIC_CONSTANTS[s].get(key) is not None
        else math.nan
        for s in PERIODIC_TABLE
    )


#: covalent radii (Angstrom), D3 coordination numbers
COVALENT_RADIUS = _znumber_indexed("covalent_radius")
#: square roots of the empirical charges, D3 C8 coefficients and BJ radii
SQRT_EMPIRICAL_CHARGE = _znumber_indexed("sqrt_empirical_charge")
#: GFN2-xTB repulsion parameters
XTB_REPULSION_ALPHA = _znumber_indexed("xtb_repulsion_alpha")
XTB_REPULSION_YEFF = _znumber_indexed("xtb_repulsion_yeff")


@functools.lru_cache(maxsize=None)
def load_c6_constants() -> tp.Dict[str, np.ndarray]:
    """The DFT-D3 reference-C6 interpolation tables: ``constants``,
    ``coordnums_a`` and ``coordnums_b``, each ``(95, 95, 5, 5)`` (the two
    atomic numbers and the 5x5 grid of reference coordination numbers).
    Grid entries that do not exist are negative in ``constants``."""
    with np.load(resources_dir() / "c6_constants.npz") as data:
        return {
            "constants": np.asarray(data["all.constants"]),
            "coordnums_a": np.asarray(data["all.coordnums_a"]),
            "coordnums_b": np.asarray(data["all.coordnums_b"]),
        }
