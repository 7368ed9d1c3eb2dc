"""Cutoff (envelope) functions (counterparts of ``torchani_tpu/cutoffs.py``).

Each cutoff is a frozen dataclass; the math runs on tensors.  Cutoffs assume
their input distances are within ``cutoff``: callers mask the rest.
"""

import dataclasses
import math
import typing as tp

import torch

from torchani_tpu_torch.annotations import Tensor

__all__ = [
    "Cutoff",
    "CutoffDummy",
    "CutoffCosine",
    "CutoffSmooth",
    "CutoffBiweight",
    "CutoffTriweight",
    "AltCutoffSmooth",
    "CutoffArg",
    "parse_cutoff_fn",
]


@dataclasses.dataclass(frozen=True)
class Cutoff:
    """Base class for cutoff functions."""

    def __call__(self, distances: Tensor, cutoff: float) -> Tensor:
        raise NotImplementedError

    def is_same(self, other: object) -> bool:
        return self == other


@dataclasses.dataclass(frozen=True)
class CutoffDummy(Cutoff):
    """No-op cutoff: returns ones."""

    def __call__(self, distances: Tensor, cutoff: float) -> Tensor:
        return torch.ones_like(distances)


@dataclasses.dataclass(frozen=True)
class CutoffCosine(Cutoff):
    r"""Cosine cutoff: :math:`0.5\cos(\pi r / r_c) + 0.5`."""

    def __call__(self, distances: Tensor, cutoff: float) -> Tensor:
        return 0.5 * torch.cos(distances * (math.pi / cutoff)) + 0.5


@dataclasses.dataclass(frozen=True)
class CutoffSmooth(Cutoff):
    r"""Infinitely differentiable cutoff.

    :math:`\exp(1 - 1/\max(\epsilon, 1 - (r/r_c)^n))` with order :math:`n`.
    """

    order: int = 2
    eps: float = 1.0e-10

    def __call__(self, distances: Tensor, cutoff: float) -> Tensor:
        e = 1 - 1 / torch.clamp(1 - (distances / cutoff) ** self.order, min=self.eps)
        return torch.exp(e)


@dataclasses.dataclass(frozen=True)
class CutoffBiweight(Cutoff):
    r"""Bi-weight cutoff: :math:`(1 - (r/r_c)^2)^2`."""

    def __call__(self, distances: Tensor, cutoff: float) -> Tensor:
        return (1 - (distances / cutoff) ** 2) ** 2


@dataclasses.dataclass(frozen=True)
class CutoffTriweight(Cutoff):
    r"""Tri-weight cutoff: :math:`(1 - (r/r_c)^2)^3`."""

    def __call__(self, distances: Tensor, cutoff: float) -> Tensor:
        return (1 - (distances / cutoff) ** 2) ** 3


@dataclasses.dataclass(frozen=True)
class AltCutoffSmooth(Cutoff):
    r"""The smooth cutoff variant of the r2SCAN models:
    :math:`\exp(-1/(1 - \mathrm{clamp}(r/r_c)^2)) / e^{-1}`."""

    def __call__(self, distances: Tensor, cutoff: float) -> Tensor:
        x = torch.clamp(distances / cutoff, 0.0, 1.0 - 1e-4)
        return torch.exp(-1.0 / (1.0 - x**2)) / 0.3678794411714423


CutoffArg = tp.Union[str, Cutoff]


def parse_cutoff_fn(cutoff_fn: CutoffArg) -> Cutoff:
    """String-dispatch registry for cutoff functions."""
    if cutoff_fn == "dummy":
        return CutoffDummy()
    if cutoff_fn == "cosine":
        return CutoffCosine()
    if cutoff_fn == "smooth":
        return CutoffSmooth()
    if cutoff_fn == "biweight":
        return CutoffBiweight()
    if cutoff_fn == "triweight":
        return CutoffTriweight()
    if not isinstance(cutoff_fn, Cutoff):
        raise ValueError(f"Unsupported cutoff fn: {cutoff_fn}")
    return cutoff_fn
