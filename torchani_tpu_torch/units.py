"""Unit conversion factors (CODATA 2014, as in ``torchani_tpu/units.py``).

The ANI models work in Hartree (energy), Angstrom (distance) and AMU (mass).
"""

__all__ = ["ANGSTROM_TO_BOHR"]

ANGSTROM_TO_BOHR = 1.8897261258369282
