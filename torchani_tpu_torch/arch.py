"""Model core and declarative assembly (counterpart of
``torchani_tpu/arch.py``).

`ANI` holds a dict of potentials (always including ``"nnp"``), the self
energies and the species table.  One neighbor table is built at the largest
cutoff of the enabled potentials and each of them reads a narrowed view of
it; their energies are summed.
"""

import math
import typing as tp

import numpy as np
import torch

from torchani_tpu_torch.aev import AEVComputer
from torchani_tpu_torch.aev.terms import ANIAngular, ANIRadial
from torchani_tpu_torch.annotations import DeviceArg, Symbols, Tensor
from torchani_tpu_torch.neighbors import (
    NeighborlistArg,
    Neighbors,
    narrow_to_cutoff,
    parse_neighborlist,
)
from torchani_tpu_torch.nn import AtomicNetworks, Ensemble, SpeciesConverter
from torchani_tpu_torch.nn.containers import SpeciesRanges, layer_dims_for
from torchani_tpu_torch.potentials import (
    NNPotential,
    Potential,
    RepulsionXTB,
    TwoBodyDispersionD3,
)
from torchani_tpu_torch.sae import SelfEnergy
from torchani_tpu_torch.tuples import SpeciesEnergies
from torchani_tpu_torch.utils import resolve_device

__all__ = ["ANI", "Assembler", "as_tensor", "simple_ani"]


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
        return max(p.cutoff for p in self.potentials.values() if p.enabled)

    def set_enabled(self, name: str, enabled: bool = True) -> "ANI":
        """Switch one potential on or off (in place; returned)."""
        self.potentials[name].enabled = enabled
        return self

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
            if not pot.enabled:
                continue
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
    """Declarative assembly of ANI-style models: set symbols, AEV terms, the
    atomic networks, self energies and extra potentials, then
    ``assemble(ensemble_size)``."""

    def __init__(self) -> None:
        self.symbols: tp.Optional[Symbols] = None
        self._global_cutoff_fn = "smooth"
        self._aev_terms: tp.Tuple[tp.Any, tp.Any] = ("ani2x", "ani2x")
        self._networks: tp.Dict[str, tp.Any] = dict(activation="celu", bias=True)
        self._lot: tp.Optional[str] = None
        self._extra_potentials: tp.Dict[str, tp.Callable[[torch.device], Potential]] = {}
        self._neighborlist: NeighborlistArg = "adaptive"

    def set_symbols(self, symbols: tp.Sequence[str]) -> "Assembler":
        self.symbols = tuple(symbols)
        return self

    def set_global_cutoff_fn(self, cutoff_fn: str) -> "Assembler":
        self._global_cutoff_fn = cutoff_fn
        return self

    def set_aev_computer(self, radial="ani2x", angular=None) -> "Assembler":
        """``radial`` and ``angular`` are names (``"ani1x"``, ``"ani2x"``) or
        functions of a device that build the term there."""
        self._aev_terms = (radial, radial if angular is None else angular)
        return self

    def set_atomic_networks(
        self, ctor: str = "ani2x", activation: str = "celu", bias: bool = True
    ) -> "Assembler":
        """The per-element networks: ``ctor`` names the layer widths (only
        ANI-2x's, ``"ani2x"``, are ported)."""
        if ctor != "ani2x":
            raise NotImplementedError(
                f"network constructor {ctor!r} is not ported; only 'ani2x' is"
            )
        self._networks = dict(activation=activation, bias=bias)
        return self

    def set_gsaes_as_self_energies(self, lot: str) -> "Assembler":
        self._lot = lot
        return self

    def set_neighborlist(self, neighborlist: NeighborlistArg) -> "Assembler":
        self._neighborlist = neighborlist
        return self

    def add_potential(
        self, name: str, potential: tp.Union[Potential, tp.Callable[[torch.device], Potential]]
    ) -> "Assembler":
        """An extra potential, summed with the networks': a `Potential`
        (moved to the model's device at assembly) or a function of the device
        that builds it."""
        if isinstance(potential, Potential):
            built = potential
            self._extra_potentials[name] = lambda dev: built.to(dev)
        else:
            self._extra_potentials[name] = potential
        return self

    def assemble(
        self, ensemble_size: int = 1, seed: int = 0, device: DeviceArg = None
    ) -> ANI:
        """Build the model with random network weights drawn from ``seed``
        (on the CPU, then moved to ``device``)."""
        if self.symbols is None:
            raise ValueError("Symbols must be set before assembling")
        dev = resolve_device(device)
        radial, angular = (t(dev) if callable(t) else t for t in self._aev_terms)
        aev = AEVComputer.make(
            radial,
            angular,
            num_species=len(self.symbols),
            cutoff_fn=self._global_cutoff_fn,
            device=dev,
        )
        layer_dims = layer_dims_for(self.symbols, aev.out_dim)
        generator = torch.Generator().manual_seed(seed)
        if ensemble_size == 1:
            networks: Ensemble = AtomicNetworks.random(
                self.symbols, layer_dims, generator, dev, **self._networks
            )
        else:
            networks = Ensemble.random(
                ensemble_size, self.symbols, layer_dims, generator, dev, **self._networks
            )
        if self._lot is not None:
            shifter = SelfEnergy.from_lot(self.symbols, self._lot, dev)
        else:
            shifter = SelfEnergy(self.symbols, [0.0] * len(self.symbols), dev)
        potentials: tp.Dict[str, Potential] = {
            "nnp": NNPotential(self.symbols, aev, networks)
        }
        for name, build in self._extra_potentials.items():
            potentials[name] = build(dev)
        return ANI(
            potentials=potentials,
            energy_shifter=shifter,
            symbols=self.symbols,
            neighborlist=self._neighborlist,
        )


def simple_ani(
    symbols: tp.Sequence[str],
    lot: str = "wb97x-631gd",
    ensemble_size: int = 1,
    radial_start: float = 0.9,
    angular_start: float = 0.9,
    radial_cutoff: float = 5.2,
    angular_cutoff: float = 3.5,
    radial_shifts: int = 16,
    angular_shifts: int = 8,
    sections: int = 4,
    radial_precision: float = 19.7,
    angular_precision: float = 12.5,
    angular_zeta: float = 14.1,
    cutoff_fn: str = "smooth",
    repulsion: bool = True,
    dispersion: bool = False,
    container: str = "ANINetworks",
    container_ctor: str = "default",
    activation: str = "gelu",
    bias: bool = False,
    neighborlist: NeighborlistArg = "all_pairs",
    repulsion_cutoff: bool = True,
    seed: int = 0,
    device: DeviceArg = None,
) -> ANI:
    """One-call model factory with the JAX package's defaults: an ANI-2x-like
    AEV with the smooth cutoff, gelu networks without bias, xTB repulsion
    enveloped at the radial cutoff and, with ``dispersion``, D3(BJ) dispersion
    of ``lot``'s functional at 8 A.  Random weights from ``seed``.

    Only the ``"ANINetworks"`` container is ported; ``"SingleNN"`` and
    ``"ANISharedNetworks"`` raise.
    """
    if container != "ANINetworks":
        raise NotImplementedError(
            f"network container {container!r} is not ported yet; only 'ANINetworks' is"
        )
    symbols = tuple(symbols)
    asm = Assembler()
    asm.set_symbols(symbols)
    asm.set_global_cutoff_fn(cutoff_fn)
    asm.set_aev_computer(
        radial=lambda dev: ANIRadial.cover_linearly(
            start=radial_start, cutoff=radial_cutoff, eta=radial_precision,
            num_shifts=radial_shifts, cutoff_fn=cutoff_fn, device=dev,
        ),
        angular=lambda dev: ANIAngular.cover_linearly(
            start=angular_start, cutoff=angular_cutoff, eta=angular_precision,
            zeta=angular_zeta, num_shifts=angular_shifts, num_sections=sections,
            cutoff_fn=cutoff_fn, device=dev,
        ),
    )
    # the "default" constructor of this container is ANI-2x's widths with
    # the activation and bias passed here
    ctor = "ani2x" if container_ctor == "default" else container_ctor
    asm.set_atomic_networks(ctor=ctor, activation=activation, bias=bias)
    asm.set_neighborlist(neighborlist)
    asm.set_gsaes_as_self_energies(lot)
    if repulsion:
        asm.add_potential(
            "repulsion_xtb",
            lambda dev: RepulsionXTB(
                symbols, cutoff=radial_cutoff if repulsion_cutoff else math.inf,
                cutoff_fn=cutoff_fn, device=dev,
            ),
        )
    if dispersion:
        asm.add_potential(
            "dispersion_d3",
            lambda dev: TwoBodyDispersionD3(
                symbols, functional=lot.split("-")[0], cutoff=8.0, device=dev
            ),
        )
    return asm.assemble(ensemble_size, seed=seed, device=device)
