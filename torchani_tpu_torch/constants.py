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
    "ATOMIC_HARDNESS",
    "ATOMIC_ELECTRONEGATIVITY",
    "ATOMIC_COVALENT_RADIUS",
    "ATOMIC_SQRT_EMPIRICAL_CHARGE",
    "ATOMIC_XTB_REPULSION_ALPHA",
    "ATOMIC_XTB_REPULSION_YEFF",
    "MASS",
    "HARDNESS",
    "ELECTRONEGATIVITY",
    "PERIODIC_TABLE",
    "GSAES",
    "FUNCTIONAL_D3BJ_CONSTANTS",
    "COVALENT_RADIUS",
    "SQRT_EMPIRICAL_CHARGE",
    "XTB_REPULSION_ALPHA",
    "XTB_REPULSION_YEFF",
    "load_c6_constants",
    "mapping_to_znumber_indexed_seq",
    "znumber_indexed_seq_to_mapping",
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


def _symbol_map(key: str) -> tp.Dict[str, float]:
    """symbol -> property ``key``, for the elements the table gives it."""
    return {
        s: float(v[key]) for s, v in ATOMIC_CONSTANTS.items() if s and v.get(key) is not None
    }


#: symbol -> atomic mass (AMU)
ATOMIC_MASS: tp.Dict[str, float] = _symbol_map("mass")
#: symbol -> chemical hardness and electronegativity (eV), the charge
#: normalizer's weights
ATOMIC_HARDNESS: tp.Dict[str, float] = _symbol_map("hardness")
ATOMIC_ELECTRONEGATIVITY: tp.Dict[str, float] = _symbol_map("electronegativity")
#: symbol -> covalent radius (Angstrom), square root of the empirical
#: charge, and the GFN2-xTB repulsion parameters
ATOMIC_COVALENT_RADIUS: tp.Dict[str, float] = _symbol_map("covalent_radius")
ATOMIC_SQRT_EMPIRICAL_CHARGE: tp.Dict[str, float] = _symbol_map("sqrt_empirical_charge")
ATOMIC_XTB_REPULSION_ALPHA: tp.Dict[str, float] = _symbol_map("xtb_repulsion_alpha")
ATOMIC_XTB_REPULSION_YEFF: tp.Dict[str, float] = _symbol_map("xtb_repulsion_yeff")


def mapping_to_znumber_indexed_seq(
    symbols_map: tp.Mapping[str, float],
) -> tp.Tuple[float, ...]:
    """The values of a {symbol: value} map in atomic-number order.

    Index 0 (no element) is NaN.  The map must cover every atomic number up
    to the highest it holds, else `ValueError`.
    """
    seq = [math.nan] * (len(symbols_map) + 1)
    try:
        for k, v in symbols_map.items():
            seq[ATOMIC_NUMBER[k]] = v
    except IndexError:
        raise ValueError(f"There are missing elements in {symbols_map}") from None
    return tuple(seq)


def znumber_indexed_seq_to_mapping(seq: tp.Sequence[float]) -> tp.Dict[str, float]:
    """Inverse of `mapping_to_znumber_indexed_seq`; ``seq[0]`` must be NaN."""
    if not math.isnan(seq[0]):
        raise ValueError("The first element of the input iterable must be NaN")
    return {PERIODIC_TABLE[j]: v for j, v in enumerate(seq) if j != 0}


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
#: chemical hardness and electronegativity (eV)
HARDNESS = _znumber_indexed("hardness")
ELECTRONEGATIVITY = _znumber_indexed("electronegativity")
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
