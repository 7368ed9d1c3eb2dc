"""Atomic potentials."""

from torchani_tpu_torch.potentials.core import (
    BasePairPotential,
    PairPotential,
    Potential,
)
from torchani_tpu_torch.potentials.dispersion import TwoBodyDispersionD3
from torchani_tpu_torch.potentials.nnp import NNPotential
from torchani_tpu_torch.potentials.repulsion import RepulsionXTB, RepulsionZBL

__all__ = [
    "Potential",
    "BasePairPotential",
    "PairPotential",
    "NNPotential",
    "RepulsionXTB",
    "RepulsionZBL",
    "TwoBodyDispersionD3",
]
