"""Atomic environment vectors: terms, the computer and the fused kernel."""

from torchani_tpu_torch.aev.computer import AEVComputer
from torchani_tpu_torch.aev.kernels import angular_aev, angular_aev_reference
from torchani_tpu_torch.aev.terms import ANIAngular, ANIRadial

__all__ = [
    "AEVComputer",
    "ANIAngular",
    "ANIRadial",
    "angular_aev",
    "angular_aev_reference",
]
