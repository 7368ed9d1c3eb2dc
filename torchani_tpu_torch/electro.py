"""Charged systems: charge normalization and dipoles (counterpart of
``torchani_tpu/electro.py``).

A charge normalizer redistributes the excess of a molecule's raw atomic
charges over its atoms, so that they sum to the molecule's total charge.
``charge`` is an int, or a tensor that broadcasts against ``(C, 1)``: a
``(C,)`` tensor does not (its excess becomes ``(C, C)``), and raises as it
does in the JAX package.
"""

import typing as tp

import numpy as np
import torch

from torchani_tpu_torch.annotations import DeviceArg, Tensor
from torchani_tpu_torch.constants import ATOMIC_NUMBER, ELECTRONEGATIVITY, HARDNESS
from torchani_tpu_torch.utils import get_atomic_masses, resolve_device

__all__ = [
    "BaseChargeNormalizer",
    "ChargeNormalizer",
    "DipoleComputer",
    "compute_dipole",
]

Reference = tp.Literal["center_of_mass", "center_of_geometry", "origin"]
Charge = tp.Union[int, Tensor]


class BaseChargeNormalizer(torch.nn.Module):
    """No-op normalizer: passes the raw charges through.  Subclass and
    override ``forward`` to normalize."""

    def forward(self, elem_idxs: Tensor, raw_charges: Tensor, charge: Charge = 0) -> Tensor:
        return raw_charges


class ChargeNormalizer(BaseChargeNormalizer):
    """Spread the excess charge over the atoms in proportion to per-element
    weights (all ones by default; `from_electronegativity_and_hardness` takes
    (chi / eta)^2), optionally scaled by each atom's raw charge squared.
    The weights are the buffer ``weights`` ``(S,)``."""

    weights: Tensor

    def __init__(
        self,
        symbols: tp.Sequence[str],
        weights: tp.Sequence[float] = (),
        scale_weights_by_charges_squared: bool = False,
        device: DeviceArg = None,
    ) -> None:
        super().__init__()
        self.symbols = tuple(symbols)
        if not len(weights):
            weights = [1.0] * len(self.symbols)
        self.scale_weights_by_charges_squared = scale_weights_by_charges_squared
        self.register_buffer(
            "weights",
            torch.as_tensor(np.asarray(weights, dtype=np.float32), device=resolve_device(device)),
        )

    @classmethod
    def make(
        cls,
        symbols: tp.Sequence[str],
        weights: tp.Sequence[float] = (),
        scale_weights_by_charges_squared: bool = False,
        device: DeviceArg = None,
    ) -> "ChargeNormalizer":
        """The constructor under the JAX package's name."""
        return cls(symbols, weights, scale_weights_by_charges_squared, device)

    @classmethod
    def from_electronegativity_and_hardness(
        cls,
        symbols: tp.Sequence[str],
        electronegativity: tp.Sequence[float] = (),
        hardness: tp.Sequence[float] = (),
        scale_weights_by_charges_squared: bool = False,
        device: DeviceArg = None,
    ) -> "ChargeNormalizer":
        """Weights (chi / eta)^2, from the per-element tables unless given."""
        znums = [ATOMIC_NUMBER[s] for s in symbols]
        if not len(electronegativity):
            electronegativity = [ELECTRONEGATIVITY[z] for z in znums]
        if not len(hardness):
            hardness = [HARDNESS[z] for z in znums]
        weights = [(e / h) ** 2 for e, h in zip(electronegativity, hardness)]
        return cls(symbols, weights, scale_weights_by_charges_squared, device)

    def factor(self, elem_idxs: Tensor, raw_charges: Tensor) -> Tensor:
        """Each atom's share of the excess ``(C, A)``; padding atoms 0."""
        pad = elem_idxs < 0
        w = torch.where(pad, 0.0, self.weights[elem_idxs.clamp(min=0)])
        if self.scale_weights_by_charges_squared:
            w = w * raw_charges**2
        return w / torch.sum(w, dim=-1, keepdim=True)

    def forward(self, elem_idxs: Tensor, raw_charges: Tensor, charge: Charge = 0) -> Tensor:
        excess = charge - torch.sum(raw_charges, dim=-1, keepdim=True)
        return raw_charges + excess * self.factor(elem_idxs, raw_charges)


class DipoleComputer(torch.nn.Module):
    """`compute_dipole` about a fixed reference frame; with ``masses`` (one
    per atomic number, from 0) the center of mass uses those masses."""

    masses: tp.Optional[Tensor]

    def __init__(
        self,
        masses: tp.Iterable[float] = (),
        reference: Reference = "center_of_mass",
        device: DeviceArg = None,
    ) -> None:
        super().__init__()
        self.reference = reference
        m = tuple(masses)
        self.register_buffer(
            "masses",
            torch.as_tensor(np.asarray(m, np.float32), device=resolve_device(device)) if m else None,
        )

    @classmethod
    def make(
        cls,
        masses: tp.Iterable[float] = (),
        reference: Reference = "center_of_mass",
        device: DeviceArg = None,
    ) -> "DipoleComputer":
        """The constructor under the JAX package's name."""
        return cls(masses, reference, device)

    def forward(self, species: Tensor, coordinates: Tensor, charges: Tensor) -> Tensor:
        if self.masses is not None and self.reference == "center_of_mass":
            pad = species < 0
            w = torch.where(pad, 0.0, self.masses[species.clamp(min=0)])
            w = w / torch.sum(w, dim=-1, keepdim=True)
            center = torch.sum(coordinates * w[..., None], dim=1, keepdim=True)
            coordinates = torch.where(pad[..., None], 0.0, coordinates - center)
            return torch.sum(charges[..., None] * coordinates, dim=1)
        return compute_dipole(species, coordinates, charges, self.reference)


def compute_dipole(
    species: Tensor,  # (C, A) atomic numbers, -1 padding
    coordinates: Tensor,  # (C, A, 3)
    charges: Tensor,  # (C, A) in e
    reference: Reference = "center_of_mass",
) -> Tensor:
    """Dipoles (e * Angstrom) ``(C, 3)`` about a reference frame."""
    pad = species < 0
    if reference != "origin":
        if reference == "center_of_mass":
            weights = get_atomic_masses(species)
        elif reference == "center_of_geometry":
            weights = (~pad).to(coordinates.dtype)
        else:
            raise ValueError(f"Unsupported reference: {reference}")
        weights = weights / torch.sum(weights, dim=-1, keepdim=True)
        center = torch.sum(coordinates * weights[..., None], dim=1, keepdim=True)
        coordinates = torch.where(pad[..., None], 0.0, coordinates - center)
    return torch.sum(charges[..., None] * coordinates, dim=1)
