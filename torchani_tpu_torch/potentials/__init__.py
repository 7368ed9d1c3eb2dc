"""Atomic potentials."""

from torchani_tpu_torch.potentials.core import Potential
from torchani_tpu_torch.potentials.nnp import NNPotential

__all__ = ["Potential", "NNPotential"]
