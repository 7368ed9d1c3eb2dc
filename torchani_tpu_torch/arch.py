"""Model core and declarative assembly (counterpart of
``torchani_tpu/arch.py``).

`ANI` holds a dict of potentials (always including ``"nnp"``), the self
energies and the species table.  One neighbor table is built at the largest
cutoff and every potential reads a narrowed view of it.
"""

import typing as tp

import numpy as np
import torch

from torchani_tpu_torch.aev import AEVComputer
from torchani_tpu_torch.annotations import DeviceArg, Symbols, Tensor
from torchani_tpu_torch.neighbors import (
    NeighborlistArg,
    Neighbors,
    narrow_to_cutoff,
    parse_neighborlist,
)
from torchani_tpu_torch.nn import AtomicNetworks, Ensemble, SpeciesConverter
from torchani_tpu_torch.nn.containers import SpeciesRanges, layer_dims_for
from torchani_tpu_torch.potentials import NNPotential, Potential
from torchani_tpu_torch.sae import SelfEnergy
from torchani_tpu_torch.tuples import SpeciesEnergies
from torchani_tpu_torch.utils import resolve_device

__all__ = ["ANI", "Assembler", "as_tensor"]


def as_tensor(x, dtype: torch.dtype, device: torch.device) -> Tensor:
    """An input (numpy array, list or tensor) as a tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


class ANI(torch.nn.Module):
    """An ANI-style model: potentials + self energies + species conversion.

    Inputs are atomic numbers, shape ``(molecules, atoms)`` with -1 padding,
    and coordinates in Angstrom ``(molecules, atoms, 3)``; outputs are
    energies in Hartree.  Inputs are moved to the model's device.
    """

    def __init__(
        self,
        potentials: tp.Dict[str, Potential],
        energy_shifter: SelfEnergy,
        symbols: Symbols,
        neighborlist: NeighborlistArg = "adaptive",
    ) -> None:
        super().__init__()
        self.potentials = torch.nn.ModuleDict(potentials)
        self.energy_shifter = energy_shifter
        self.symbols = tuple(symbols)
        self.neighborlist = parse_neighborlist(neighborlist)

    # ---- properties ----
    @property
    def device(self) -> torch.device:
        return self.energy_shifter.self_energies.device

    @property
    def species_converter(self) -> SpeciesConverter:
        return SpeciesConverter(self.symbols)

    @property
    def cutoff(self) -> float:
        return max(p.cutoff for p in self.potentials.values())

    @property
    def neural_networks(self) -> Ensemble:
        return self.potentials["nnp"].neural_networks

    @property
    def aev_computer(self) -> AEVComputer:
        return self.potentials["nnp"].aev_computer

    # ---- core computation ----
    def _convert(self, species: Tensor) -> Tensor:
        """Atomic numbers to element indices on the model's device."""
        return self.species_converter(as_tensor(species, torch.int64, self.device))

    def forward(
        self,
        species: Tensor,
        coords: Tensor,
        cell: tp.Optional[Tensor] = None,
        pbc: tp.Optional[Tensor] = None,
        atomic: bool = False,
        ensemble_values: bool = False,
    ) -> Tensor:
        """Total energies (Hartree), shape ``(molecules,)``.

        With ``atomic=True``: per-atom energies ``(molecules, atoms)``.
        With ``ensemble_values=True``: a leading ensemble-member axis.
        """
        elem_idxs = self._convert(species)
        coords = as_tensor(coords, torch.float32, self.device)
        if elem_idxs.dim() != 2 or coords.shape != elem_idxs.shape + (3,):
            raise ValueError(
                f"Expected species (molecules, atoms) and coords "
                f"(molecules, atoms, 3); got {tuple(elem_idxs.shape)} and "
                f"{tuple(coords.shape)}"
            )
        if cell is not None:
            cell = as_tensor(cell, torch.float32, self.device)
        if pbc is not None:
            pbc = as_tensor(pbc, torch.bool, self.device)
        neighbors = self.neighborlist(self.cutoff, elem_idxs, coords, cell, pbc)
        return self.compute_from_neighbors(
            elem_idxs, coords, neighbors, atomic, ensemble_values
        ).energies

    def compute_from_neighbors(
        self,
        elem_idxs: Tensor,
        coords: tp.Optional[Tensor],
        neighbors: Neighbors,
        atomic: bool = False,
        ensemble_values: bool = False,
        species_ranges: tp.Optional[SpeciesRanges] = None,
    ) -> SpeciesEnergies:
        """Energies from a neighbor table.  ``species_ranges`` is for a caller
        whose flattened ``elem_idxs`` is sorted by species and known on the
        host (`MolecularDynamics`): no potential then reads the species back from
        the device."""
        energies = None
        for name in sorted(self.potentials):
            pot = self.potentials[name]
            pot_neighbors = (
                narrow_to_cutoff(neighbors, pot.cutoff)
                if pot.cutoff < self.cutoff
                else neighbors
            )
            e = pot.compute_from_neighbors(
                elem_idxs, coords, pot_neighbors,
                atomic=atomic, ensemble_values=ensemble_values,
                species_ranges=species_ranges,
            ).energies
            energies = e if energies is None else energies + e
        energies = energies + self.energy_shifter(elem_idxs, atomic=atomic)
        return SpeciesEnergies(elem_idxs, energies)

    def members_energies(self, species, coords, cell=None, pbc=None) -> Tensor:
        """Per-member energies, shape ``(E, molecules)``."""
        return self(species, coords, cell, pbc, ensemble_values=True)


class Assembler:
    """Declarative assembly of ANI-style models, as far as the model
    factories use it: symbols, AEV terms and self energies, then
    ``assemble(ensemble_size)`` with ANI-2x network widths and the adaptive
    neighborlist."""

    def __init__(self) -> None:
        self.symbols: tp.Optional[Symbols] = None
        self._global_cutoff_fn = "smooth"
        self._aev_terms: tp.Tuple[str, str] = ("ani2x", "ani2x")
        self._lot: tp.Optional[str] = None

    def set_symbols(self, symbols: tp.Sequence[str]) -> "Assembler":
        self.symbols = tuple(symbols)
        return self

    def set_global_cutoff_fn(self, cutoff_fn: str) -> "Assembler":
        self._global_cutoff_fn = cutoff_fn
        return self

    def set_aev_computer(
        self, radial: str = "ani2x", angular: tp.Optional[str] = None
    ) -> "Assembler":
        self._aev_terms = (radial, radial if angular is None else angular)
        return self

    def set_gsaes_as_self_energies(self, lot: str) -> "Assembler":
        self._lot = lot
        return self

    def assemble(
        self, ensemble_size: int = 1, seed: int = 0, device: DeviceArg = None
    ) -> ANI:
        """Build the model with random network weights drawn from ``seed``
        (on the CPU, then moved to ``device``)."""
        if self.symbols is None:
            raise ValueError("Symbols must be set before assembling")
        dev = resolve_device(device)
        aev = AEVComputer.make(
            *self._aev_terms,
            num_species=len(self.symbols),
            cutoff_fn=self._global_cutoff_fn,
            device=dev,
        )
        layer_dims = layer_dims_for(self.symbols, aev.out_dim)
        generator = torch.Generator().manual_seed(seed)
        if ensemble_size == 1:
            networks: Ensemble = AtomicNetworks.random(
                self.symbols, layer_dims, generator, dev
            )
        else:
            networks = Ensemble.random(
                ensemble_size, self.symbols, layer_dims, generator, dev
            )
        if self._lot is not None:
            shifter = SelfEnergy.from_lot(self.symbols, self._lot, dev)
        else:
            shifter = SelfEnergy(self.symbols, [0.0] * len(self.symbols), dev)
        return ANI(
            potentials={"nnp": NNPotential(self.symbols, aev, networks)},
            energy_shifter=shifter,
            symbols=self.symbols,
        )
