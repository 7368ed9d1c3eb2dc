"""Neural-network potentials that also predict atomic charges (counterpart
of ``torchani_tpu/potentials/nnp_charges.py``).

The energy networks and the charge networks read one AEV.  The raw charges
are normalized so that each molecule's sum is its total charge.  On an
energy path (`ANI.forward`, `grad`, `MolecularDynamics`) nothing reads the
charges, and `_energies_from_neighbors` does not compute them: the charge
networks do not run.
"""

import typing as tp

import torch

from torchani_tpu_torch.aev import AEVComputer
from torchani_tpu_torch.annotations import Tensor
from torchani_tpu_torch.electro import ChargeNormalizer
from torchani_tpu_torch.neighbors import Neighbors
from torchani_tpu_torch.nn.containers import SpeciesRanges
from torchani_tpu_torch.potentials.nnp import NNPotential
from torchani_tpu_torch.tuples import EnergiesScalars

__all__ = ["MergedChargesNNPotential", "SeparateChargesNNPotential"]


def _default_normalizer(
    symbols: tp.Sequence[str], networks: torch.nn.Module
) -> ChargeNormalizer:
    """Uniform weights, on the networks' device."""
    return ChargeNormalizer(symbols, device=next(networks.parameters()).device)


class MergedChargesNNPotential(NNPotential):
    """One network with a head of two: column 0 is the atom's energy, column
    1 its raw charge."""

    def __init__(
        self,
        symbols: tp.Sequence[str],
        aev_computer: AEVComputer,
        neural_networks: torch.nn.Module,
        charge_normalizer: tp.Optional[ChargeNormalizer] = None,
    ) -> None:
        super().__init__(symbols, aev_computer, neural_networks)
        if charge_normalizer is None:
            charge_normalizer = _default_normalizer(symbols, neural_networks)
        self.charge_normalizer = charge_normalizer

    @classmethod
    def make(cls, symbols, aev_computer, neural_networks, charge_normalizer=None):
        """The constructor under the JAX package's name."""
        return cls(symbols, aev_computer, neural_networks, charge_normalizer)

    def _outputs(self, elem_idxs, coords, neighbors, ensemble_values, species_ranges):
        aevs = self._aevs(elem_idxs, coords, neighbors, species_ranges)
        return self.neural_networks(
            elem_idxs, aevs, atomic=True, ensemble_values=ensemble_values,
            species_ranges=species_ranges,
        )  # (..., C, A, 2)

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
        out = self._outputs(elem_idxs, coords, neighbors, ensemble_values, species_ranges)
        energies = out[..., 0]
        if not atomic:
            energies = torch.sum(energies, dim=-1)
        return EnergiesScalars(energies, self.charge_normalizer(elem_idxs, out[..., 1], charge))

    def _energies_from_neighbors(
        self,
        elem_idxs: Tensor,
        coords: tp.Optional[Tensor],
        neighbors: Neighbors,
        charge: int = 0,
        atomic: bool = False,
        ensemble_values: bool = False,
        species_ranges: tp.Optional[SpeciesRanges] = None,
    ) -> Tensor:
        energies = self._outputs(
            elem_idxs, coords, neighbors, ensemble_values, species_ranges
        )[..., 0]
        return energies if atomic else torch.sum(energies, dim=-1)


class SeparateChargesNNPotential(NNPotential):
    """Energy networks and separate charge networks over one AEV."""

    def __init__(
        self,
        symbols: tp.Sequence[str],
        aev_computer: AEVComputer,
        neural_networks: torch.nn.Module,
        charge_networks: torch.nn.Module,
        charge_normalizer: tp.Optional[ChargeNormalizer] = None,
    ) -> None:
        super().__init__(symbols, aev_computer, neural_networks)
        if charge_normalizer is None:
            charge_normalizer = _default_normalizer(symbols, charge_networks)
        self.charge_networks = charge_networks
        self.charge_normalizer = charge_normalizer

    @classmethod
    def make(cls, symbols, aev_computer, neural_networks, charge_networks,
             charge_normalizer=None):
        """The constructor under the JAX package's name."""
        return cls(symbols, aev_computer, neural_networks, charge_networks, charge_normalizer)

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
        energies = self.neural_networks(
            elem_idxs, aevs, atomic=atomic, ensemble_values=ensemble_values,
            species_ranges=species_ranges,
        )
        raw = self.charge_networks(elem_idxs, aevs, atomic=True)
        return EnergiesScalars(energies, self.charge_normalizer(elem_idxs, raw, charge))

    def _energies_from_neighbors(
        self,
        elem_idxs: Tensor,
        coords: tp.Optional[Tensor],
        neighbors: Neighbors,
        charge: int = 0,
        atomic: bool = False,
        ensemble_values: bool = False,
        species_ranges: tp.Optional[SpeciesRanges] = None,
    ) -> Tensor:
        return NNPotential.compute_from_neighbors(
            self, elem_idxs, coords, neighbors, atomic=atomic,
            ensemble_values=ensemble_values, species_ranges=species_ranges,
        ).energies
