"""ASE calculator adapter (counterpart of ``torchani_tpu/ase.py``).

Energy, free energy, forces and stress through the port's model, with the
stress kinds ``scaling`` (`grad.stress_scaling`, the strain derivative),
``fdotr`` (`grad.stress_fdotr`, the pair virial) and ``numerical`` (ASE's
finite differences).  The ``ase`` package is an optional dependency: without
it this module imports, and the calculator raises when it is built.
"""

import typing as tp

import numpy as np

from torchani_tpu_torch.grad import energies_and_forces, stress_fdotr, stress_scaling
from torchani_tpu_torch.units import HARTREE_TO_EV

__all__ = ["Calculator"]

try:
    import ase.calculators.calculator as _ase_calc

    _BASE: tp.Any = _ase_calc.Calculator
    _ASE_AVAILABLE = True
except ImportError:  # pragma: no cover - environment dependent
    _BASE = object
    _ASE_AVAILABLE = False


class Calculator(_BASE):
    """ASE calculator backed by a `torchani_tpu_torch.arch.ANI` model, on
    the model's device.

    Energies are returned in eV and forces in eV/Angstrom (ASE units).
    """

    implemented_properties = ["energy", "forces", "stress", "free_energy"]

    def __init__(
        self,
        model,
        overwrite: bool = False,
        stress_kind: str = "scaling",
        **kwargs,
    ):
        if not _ASE_AVAILABLE:
            raise ImportError("The 'ase' package is required for torchani_tpu_torch.ase.Calculator")
        super().__init__(**kwargs)
        self.model = model
        self.overwrite = overwrite
        if stress_kind not in ("scaling", "fdotr", "numerical"):
            raise ValueError(f"Unsupported stress kind: {stress_kind}")
        self.stress_kind = stress_kind

    def calculate(self, atoms=None, properties=("energy",), system_changes=None):
        from ase.calculators.calculator import all_changes
        from ase.stress import full_3x3_to_voigt_6_stress

        super().calculate(atoms, list(properties), system_changes or all_changes)
        atoms = self.atoms
        species = np.asarray(atoms.numbers, dtype=np.int64)[None]
        coords = np.asarray(atoms.positions, dtype=np.float32)[None]
        if atoms.pbc.any():
            cell = np.asarray(atoms.cell, dtype=np.float32)
            pbc = np.asarray(atoms.pbc)
        else:
            cell = pbc = None

        energies, forces = energies_and_forces(self.model, species, coords, cell, pbc)
        energy = float(energies[0]) * HARTREE_TO_EV
        self.results["energy"] = energy
        self.results["free_energy"] = energy
        self.results["forces"] = forces[0].cpu().numpy() * HARTREE_TO_EV

        if "stress" in properties:
            if cell is None:
                raise RuntimeError("Stress requires a periodic cell")
            if self.stress_kind == "numerical":
                stress = self.calculate_numerical_stress(atoms)
            else:
                fn = stress_scaling if self.stress_kind == "scaling" else stress_fdotr
                s = fn(self.model, species, coords, cell, pbc).cpu().numpy()
                stress = full_3x3_to_voigt_6_stress(s * HARTREE_TO_EV)
            self.results["stress"] = stress
