"""Atomic environment vectors: terms, the computer and the fused kernel."""

from torchani_tpu_torch.aev.computer import AEVComputer
from torchani_tpu_torch.aev.kernels import angular_aev, angular_aev_reference
from torchani_tpu_torch.aev.terms import (
    ANIAngular,
    ANIRadial,
    Angular,
    AngularArg,
    BaseAngular,
    BaseRadial,
    Radial,
    RadialArg,
    parse_angular_term,
    parse_radial_term,
)

__all__ = [
    "AEVComputer",
    "ANIAngular",
    "ANIRadial",
    "Angular",
    "AngularArg",
    "BaseAngular",
    "BaseRadial",
    "Radial",
    "RadialArg",
    "angular_aev",
    "angular_aev_reference",
    "parse_angular_term",
    "parse_radial_term",
]
