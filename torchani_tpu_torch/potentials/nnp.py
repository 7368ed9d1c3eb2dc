"""The neural-network potential as a `Potential` term (counterpart of
``torchani_tpu/potentials/nnp.py``)."""

import typing as tp

from torchani_tpu_torch.aev import AEVComputer
from torchani_tpu_torch.annotations import Tensor
from torchani_tpu_torch.neighbors import Neighbors
from torchani_tpu_torch.nn import Ensemble
from torchani_tpu_torch.nn.containers import SpeciesRanges
from torchani_tpu_torch.potentials.core import Potential
from torchani_tpu_torch.profiling import scope
from torchani_tpu_torch.tuples import EnergiesScalars

__all__ = ["NNPotential"]


class NNPotential(Potential):
    """AEV computer + atomic networks (an `Ensemble` or `AtomicNetworks`)."""

    def __init__(
        self,
        symbols: tp.Sequence[str],
        aev_computer: AEVComputer,
        neural_networks: Ensemble,
    ) -> None:
        super().__init__(tuple(symbols), aev_computer.radial.cutoff)
        self.aev_computer = aev_computer
        self.neural_networks = neural_networks

    def compute_from_neighbors(
        self,
        elem_idxs: Tensor,
        coords: tp.Optional[Tensor],
        neighbors: Neighbors,
        charge: int = 0,
        atomic: bool = False,
        ensemble_values: bool = False,
        species_ranges: tp.Optional[SpeciesRanges] = None,
    ) -> EnergiesScalars:
        aevs = self._aevs(elem_idxs, coords, neighbors, species_ranges)
        with scope("nnp.networks"):
            energies = self.neural_networks(
                elem_idxs, aevs, atomic=atomic, ensemble_values=ensemble_values,
                species_ranges=species_ranges,
            )
        return EnergiesScalars(energies)

    def _aevs(
        self,
        elem_idxs: Tensor,
        coords: tp.Optional[Tensor],
        neighbors: Neighbors,
        species_ranges: tp.Optional[SpeciesRanges],
    ) -> Tensor:
        present = None
        if species_ranges is not None:
            present = tuple(s for s, _, _ in species_ranges)
        with scope("nnp.aev"):
            return self.aev_computer.compute_from_neighbors(
                elem_idxs, coords, neighbors, present=present
            )
