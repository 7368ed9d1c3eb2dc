"""Base class of atomic potentials (counterpart of
``torchani_tpu/potentials/core.py``, as far as the neural-network potential
needs it)."""

import math
import typing as tp

import torch

from torchani_tpu_torch.annotations import Symbols, Tensor
from torchani_tpu_torch.neighbors import Neighbors
from torchani_tpu_torch.nn.containers import SpeciesRanges
from torchani_tpu_torch.tuples import EnergiesScalars

__all__ = ["Potential"]


class Potential(torch.nn.Module):
    """Base class for all atomic potentials.

    Subclasses implement `compute_from_neighbors` and set ``cutoff``
    (``math.inf`` means "needs all pairs").
    """

    def __init__(self, symbols: Symbols, cutoff: float = math.inf) -> None:
        super().__init__()
        self.symbols = tuple(symbols)
        self.cutoff = float(cutoff)

    def compute_from_neighbors(
        self,
        elem_idxs: Tensor,
        coords: tp.Optional[Tensor],
        neighbors: Neighbors,
        atomic: bool = False,
        ensemble_values: bool = False,
        species_ranges: tp.Optional[SpeciesRanges] = None,
    ) -> EnergiesScalars:
        raise NotImplementedError("Must be implemented by subclasses")
