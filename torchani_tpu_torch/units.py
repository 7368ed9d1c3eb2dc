"""Unit conversion factors (CODATA 2014, as in ``torchani_tpu/units.py``).

The ANI models work in Hartree (energy), Angstrom (distance) and AMU (mass).
The factors are consistent with ASE's defaults; the port keeps its own copy.
"""

import math

__all__ = [
    "ANGSTROM_TO_BOHR",
    "HARTREE_TO_EV",
    "EV_TO_JOULE",
    "JOULE_TO_KCAL",
    "HARTREE_TO_JOULE",
    "AVOGADROS_NUMBER",
    "SPEED_OF_LIGHT",
    "AMU_TO_KG",
    "ANGSTROM_TO_METER",
    "NEWTON_TO_MILLIDYNE",
    "HARTREE_TO_KCALPERMOL",
    "HARTREE_TO_KJOULEPERMOL",
    "EV_TO_KCALPERMOL",
    "EV_TO_KJOULEPERMOL",
    "DEBYE_TO_ELECTRON_ANGSTROM",
    "INVCM_TO_EV",
    "SQRT_MHESSIAN_TO_INVCM",
    "SQRT_MHESSIAN_TO_MILLIEV",
    "MHESSIAN_TO_FCONST",
    "hartree2ev",
    "ev2kcalpermol",
    "ev2kjoulepermol",
    "hartree2kcalpermol",
    "hartree2kjoulepermol",
    "angstrom2bohr",
    "bohr2angstrom",
    "sqrt_mhessian2invcm",
    "sqrt_mhessian2milliev",
    "mhessian2fconst",
]

ANGSTROM_TO_BOHR = 1.8897261258369282
HARTREE_TO_EV = 27.211386024367243
EV_TO_JOULE = 1.6021766208e-19
JOULE_TO_KCAL = 1 / 4184.0
HARTREE_TO_JOULE = HARTREE_TO_EV * EV_TO_JOULE
AVOGADROS_NUMBER = 6.022140857e23
SPEED_OF_LIGHT = 299792458.0
AMU_TO_KG = 1.660539040e-27
ANGSTROM_TO_METER = 1e-10
NEWTON_TO_MILLIDYNE = 1e8
HARTREE_TO_KCALPERMOL = HARTREE_TO_JOULE * JOULE_TO_KCAL * AVOGADROS_NUMBER
HARTREE_TO_KJOULEPERMOL = HARTREE_TO_JOULE * AVOGADROS_NUMBER / 1000
EV_TO_KCALPERMOL = EV_TO_JOULE * JOULE_TO_KCAL * AVOGADROS_NUMBER
EV_TO_KJOULEPERMOL = EV_TO_JOULE * AVOGADROS_NUMBER / 1000
DEBYE_TO_ELECTRON_ANGSTROM = 0.2081943

INVCM_TO_EV = 0.0001239841973964072
SQRT_MHESSIAN_TO_INVCM = (
    math.sqrt(HARTREE_TO_JOULE / AMU_TO_KG) / ANGSTROM_TO_METER / SPEED_OF_LIGHT
) / 100
SQRT_MHESSIAN_TO_MILLIEV = SQRT_MHESSIAN_TO_INVCM * INVCM_TO_EV * 1000
MHESSIAN_TO_FCONST = HARTREE_TO_JOULE * NEWTON_TO_MILLIDYNE / ANGSTROM_TO_METER


def hartree2ev(x):
    """Hartree to electronvolt."""
    return x * HARTREE_TO_EV


def ev2kcalpermol(x):
    """Electronvolt to kcal/mol."""
    return x * EV_TO_KCALPERMOL


def ev2kjoulepermol(x):
    """Electronvolt to kJ/mol."""
    return x * EV_TO_KJOULEPERMOL


def hartree2kcalpermol(x):
    """Hartree to kcal/mol."""
    return x * HARTREE_TO_KCALPERMOL


def hartree2kjoulepermol(x):
    """Hartree to kJ/mol."""
    return x * HARTREE_TO_KJOULEPERMOL


def angstrom2bohr(x):
    """Angstrom to Bohr."""
    return x * ANGSTROM_TO_BOHR


def bohr2angstrom(x):
    """Bohr to Angstrom."""
    return x / ANGSTROM_TO_BOHR


def sqrt_mhessian2invcm(x):
    """sqrt(mass-scaled Hessian units) to cm^-1."""
    return x * SQRT_MHESSIAN_TO_INVCM


def sqrt_mhessian2milliev(x):
    """sqrt(mass-scaled Hessian units) to meV."""
    return x * SQRT_MHESSIAN_TO_MILLIEV


def mhessian2fconst(x):
    """Mass-scaled Hessian units to mDyne/Angstrom."""
    return x * MHESSIAN_TO_FCONST


def ea2debye(x):
    """Electron-Angstrom (dipole) to Debye."""
    return x / DEBYE_TO_ELECTRON_ANGSTROM


# Legacy aliases ("-mol" spellings, kept for reference API parity)
HARTREE_TO_KCALMOL = HARTREE_TO_KCALPERMOL
EV_TO_KCALMOL = EV_TO_KCALPERMOL
HARTREE_TO_KJOULEMOL = HARTREE_TO_KJOULEPERMOL
EV_TO_KJOULEMOL = EV_TO_KJOULEPERMOL
