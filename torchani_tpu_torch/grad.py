"""Energies and forces by autograd (counterpart of ``torchani_tpu/grad.py``,
without Hessians and vibrational analysis).

Inputs may be numpy arrays or tensors; they are moved to the model's device.
Returned tensors are detached.
"""

import typing as tp

import torch

from torchani_tpu_torch.annotations import Tensor
from torchani_tpu_torch.arch import as_tensor

__all__ = ["energies", "forces", "energies_and_forces", "single_point"]


def _inputs(model, coords, cell, pbc):
    dev = model.device
    coords = as_tensor(coords, torch.float32, dev).detach().requires_grad_(True)
    cell = None if cell is None else as_tensor(cell, torch.float32, dev)
    pbc = None if pbc is None else as_tensor(pbc, torch.bool, dev)
    return coords, cell, pbc


def energies(model, species, coords, cell=None, pbc=None, **kwargs) -> Tensor:
    with torch.no_grad():
        return model(species, coords, cell, pbc, **kwargs)


def energies_and_forces(
    model, species, coords, cell=None, pbc=None, **kwargs
) -> tp.Tuple[Tensor, Tensor]:
    """One forward serves both: energies ``(molecules,)`` and forces
    ``-dE/dr`` ``(molecules, atoms, 3)``."""
    coords, cell, pbc = _inputs(model, coords, cell, pbc)
    e = model(species, coords, cell, pbc, **kwargs)
    (g,) = torch.autograd.grad(e.sum(), coords)
    return e.detach(), -g


def forces(model, species, coords, cell=None, pbc=None, **kwargs) -> Tensor:
    """Forces = -dE/dr, shape ``(molecules, atoms, 3)``."""
    return energies_and_forces(model, species, coords, cell, pbc, **kwargs)[1]


def single_point(
    model,
    species,
    coords,
    cell=None,
    pbc=None,
    forces: bool = False,
    atomic_energies: bool = False,
    ensemble_values: bool = False,
) -> tp.Dict[str, Tensor]:
    """Energies and the requested derived quantities, as a dict.

    Keys: ``energies``; with ``ensemble_values`` also ``ensemble_energies``,
    ``ensemble_std`` and ``qbcs``; ``atomic_energies``; ``forces``.
    """
    out: tp.Dict[str, Tensor] = {}
    if ensemble_values:
        with torch.no_grad():
            member = model(species, coords, cell, pbc, ensemble_values=True)
            num_atoms = (model._convert(species) >= 0).sum(-1)
        out["energies"] = member.mean(0)
        out["ensemble_energies"] = member
        out["ensemble_std"] = member.std(0, unbiased=True)
        out["qbcs"] = out["ensemble_std"] / num_atoms.to(member.dtype).sqrt()
    elif forces:
        out["energies"], out["forces"] = energies_and_forces(
            model, species, coords, cell, pbc
        )
    else:
        out["energies"] = energies(model, species, coords, cell, pbc)
    if atomic_energies:
        out["atomic_energies"] = energies(model, species, coords, cell, pbc, atomic=True)
    if forces and "forces" not in out:
        out["forces"] = energies_and_forces(model, species, coords, cell, pbc)[1]
    return out
