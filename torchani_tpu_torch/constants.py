"""Atomic constants and ground-state atomic energies.

Plain Python data read from the port's own copies of the JSON resources
(``resources/atomic_constants.json``, ``resources/gsaes.json``), the same
files the JAX package bundles.
"""

import json
import typing as tp

from torchani_tpu_torch.paths import resources_dir

__all__ = [
    "ATOMIC_CONSTANTS",
    "ATOMIC_NUMBER",
    "PERIODIC_TABLE",
    "GSAES",
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
