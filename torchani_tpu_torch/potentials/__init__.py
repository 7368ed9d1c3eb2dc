"""Atomic potentials."""

from torchani_tpu_torch.potentials.core import (
    BasePairPotential,
    DummyPotential,
    PairPotential,
    Potential,
)
from torchani_tpu_torch.potentials.dispersion import TwoBodyDispersionD3
from torchani_tpu_torch.potentials.fixed_coulomb import FixedCoulomb, FixedMNOK
from torchani_tpu_torch.potentials.lj import DispersionLJ, LennardJones, RepulsionLJ
from torchani_tpu_torch.potentials.nnp import NNPotential
from torchani_tpu_torch.potentials.nnp_charges import (
    MergedChargesNNPotential,
    SeparateChargesNNPotential,
)
from torchani_tpu_torch.potentials.repulsion import RepulsionXTB, RepulsionZBL

__all__ = [
    "Potential",
    "DummyPotential",
    "BasePairPotential",
    "PairPotential",
    "NNPotential",
    "MergedChargesNNPotential",
    "SeparateChargesNNPotential",
    "RepulsionXTB",
    "RepulsionZBL",
    "TwoBodyDispersionD3",
    "FixedCoulomb",
    "FixedMNOK",
    "LennardJones",
    "RepulsionLJ",
    "DispersionLJ",
]
