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


CutoffArg = tp.Union[str, Cutoff]


def parse_cutoff_fn(cutoff_fn: CutoffArg) -> Cutoff:
    """String-dispatch registry for cutoff functions."""
    if cutoff_fn == "dummy":
        return CutoffDummy()
    if cutoff_fn == "cosine":
        return CutoffCosine()
    if cutoff_fn == "smooth":
        return CutoffSmooth()
    if not isinstance(cutoff_fn, Cutoff):
        raise ValueError(f"Unsupported cutoff fn: {cutoff_fn}")
    return cutoff_fn
