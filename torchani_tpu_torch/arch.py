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
from torchani_tpu_torch.electro import ChargeNormalizer
from torchani_tpu_torch.nn import (
    ANISharedNetworks,
    AtomicNetworks,
    Ensemble,
    GenericEnsemble,
    SingleNN,
    SpeciesConverter,
)
from torchani_tpu_torch.nn.containers import NETWORK_WIDTHS, SpeciesRanges, layer_dims_for
from torchani_tpu_torch.potentials import (
    MergedChargesNNPotential,
    NNPotential,
    Potential,
    RepulsionXTB,
    SeparateChargesNNPotential,
    TwoBodyDispersionD3,
)
from torchani_tpu_torch.profiling import scope
from torchani_tpu_torch.sae import SelfEnergy
from torchani_tpu_torch.tuples import EnergiesScalars, SpeciesEnergies
from torchani_tpu_torch.utils import resolve_device

__all__ = ["ANI", "ANIq", "Assembler", "as_tensor", "simple_ani", "simple_aniq"]

#: `Assembler.set_atomic_networks`' constructor names, by the width table
#: each selects
_NETWORK_CTORS = {
    "ani1x": "like_1x",
    "ani1ccx": "like_1x",
    "ani2x": "like_2x",
    "anidr": "like_dr",
    "aniala": "like_ala",
}


def as_tensor(x, dtype: torch.dtype, device: torch.device) -> Tensor:
    """An input (numpy array, list or tensor) as a tensor on ``device``.  A
    copy from the host onto a card waits for the card's stream
    (``arch.copy_in``)."""
    if isinstance(x, torch.Tensor) and x.device == device:
        return x.to(dtype=dtype)
    with scope("arch.copy_in", wait=True):
        if isinstance(x, torch.Tensor):
            return x.to(device=device, dtype=dtype)
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


class ANI(torch.nn.Module):
    """An ANI-style model: potentials + self energies + species conversion.

    Inputs are atomic numbers, shape ``(molecules, atoms)`` with -1 padding,
    and coordinates in Angstrom ``(molecules, atoms, 3)``; outputs are
    energies in Hartree.  Inputs are moved to the model's device.  With
    ``periodic_table_index=False`` the species are the model's 0-based
    element indices instead (``species_converter(znums)``), at every entry
    point that takes species.
    """

    #: whether the model takes charged molecules (an `ANIq` does)
    takes_charge = False

    def __init__(
        self,
        potentials: tp.Dict[str, Potential],
        energy_shifter: SelfEnergy,
        symbols: Symbols,
        neighborlist: NeighborlistArg = "adaptive",
        periodic_table_index: bool = True,
    ) -> None:
        super().__init__()
        self.potentials = torch.nn.ModuleDict(potentials)
        self.energy_shifter = energy_shifter
        self.symbols = tuple(symbols)
        self.neighborlist = parse_neighborlist(neighborlist)
        self.periodic_table_index = periodic_table_index

    # ---- properties ----
    @property
    def device(self) -> torch.device:
        return self.energy_shifter.self_energies.device

    @property
    def species_converter(self) -> SpeciesConverter:
        return SpeciesConverter(self.symbols)

    @property
    def atomic_numbers(self) -> tp.Tuple[int, ...]:
        return self.species_converter.atomic_numbers

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
        """The species input as element indices on the model's device:
        converted from atomic numbers, or taken as they are with
        ``periodic_table_index=False``."""
        species = as_tensor(species, torch.int64, self.device)
        if not self.periodic_table_index:
            return species
        return self.species_converter(species)

    def atomic_numbers_of(self, species: Tensor) -> Tensor:
        """The atomic numbers of a species input, on the model's device (-1
        padding kept): the input itself, or the model's elements at the
        given indices with ``periodic_table_index=False``."""
        species = as_tensor(species, torch.int64, self.device)
        if self.periodic_table_index:
            return species
        znums = torch.as_tensor(self.atomic_numbers, device=self.device)
        return torch.where(species < 0, -1, znums[species.clamp(min=0)])

    def forward(
        self,
        species: Tensor,
        coords: Tensor,
        cell: tp.Optional[Tensor] = None,
        pbc: tp.Optional[Tensor] = None,
        charge: int = 0,
        atomic: bool = False,
        ensemble_values: bool = False,
    ) -> Tensor:
        """Total energies (Hartree), shape ``(molecules,)``.

        With ``atomic=True``: per-atom energies ``(molecules, atoms)``.
        With ``ensemble_values=True``: a leading ensemble-member axis.  A
        ``charge`` other than 0 raises unless the model `takes_charge`.
        """
        if charge != 0 and not self.takes_charge:
            raise ValueError("Model only supports neutral molecules")
        elem_idxs, coords, neighbors = self._prepare(species, coords, cell, pbc)
        return self.compute_from_neighbors(
            elem_idxs, coords, neighbors, charge, atomic, ensemble_values
        ).energies

    def _prepare(
        self, species, coords, cell, pbc
    ) -> tp.Tuple[Tensor, Tensor, Neighbors]:
        """Element indices, coordinates and the neighbor table of an input,
        on the model's device."""
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
        with scope("neighbors"):
            neighbors = self.neighborlist(self.cutoff, elem_idxs, coords, cell, pbc)
        return elem_idxs, coords, neighbors

    def _narrowed(self, neighbors: Neighbors) -> tp.Iterator[tp.Tuple[str, Potential, Neighbors]]:
        """Each enabled potential by name, with its view of the table."""
        for name in sorted(self.potentials):
            pot = self.potentials[name]
            if pot.enabled:
                yield name, pot, (
                    narrow_to_cutoff(neighbors, pot.cutoff)
                    if pot.cutoff < self.cutoff
                    else neighbors
                )

    def compute_from_neighbors(
        self,
        elem_idxs: Tensor,
        coords: tp.Optional[Tensor],
        neighbors: Neighbors,
        charge: int = 0,
        atomic: bool = False,
        ensemble_values: bool = False,
        species_ranges: tp.Optional[SpeciesRanges] = None,
    ) -> SpeciesEnergies:
        """Energies from a neighbor table.  ``species_ranges`` is for a caller
        whose flattened ``elem_idxs`` is sorted by species and known on the
        host (`MolecularDynamics`): no potential then reads the species back from
        the device.  Charge networks do not run: nothing here reads them."""
        energies = None
        for name, pot, pot_neighbors in self._narrowed(neighbors):
            with scope(f"potential.{name}"):
                e = pot._energies_from_neighbors(
                    elem_idxs, coords, pot_neighbors, charge=charge,
                    atomic=atomic, ensemble_values=ensemble_values,
                    species_ranges=species_ranges,
                )
            energies = e if energies is None else energies + e
        if self.energy_shifter.enabled:
            energies = energies + self.energy_shifter(elem_idxs, atomic=atomic)
        return SpeciesEnergies(elem_idxs, energies)

    def members_energies(self, species, coords, cell=None, pbc=None) -> Tensor:
        """Per-member energies, shape ``(E, molecules)``."""
        return self(species, coords, cell, pbc, ensemble_values=True)


class ANIq(ANI):
    """An ANI-style model that also predicts normalized atomic charges: its
    ``"nnp"`` potential is a `MergedChargesNNPotential` or a
    `SeparateChargesNNPotential`.  `forward` gives the energies alone (the
    charge networks do not run, whatever ``charge``);
    `energies_and_charges` gives both."""

    takes_charge = True

    def compute_with_charges(
        self,
        species: Tensor,
        coords: Tensor,
        cell: tp.Optional[Tensor] = None,
        pbc: tp.Optional[Tensor] = None,
        charge: tp.Union[int, Tensor] = 0,
        atomic: bool = False,
        ensemble_values: bool = False,
    ) -> EnergiesScalars:
        """Energies and the ``"nnp"`` potential's charges ``(molecules,
        atoms)``, which sum to ``charge`` (an int, or a tensor that
        broadcasts against ``(molecules, 1)``)."""
        elem_idxs, coords, neighbors = self._prepare(species, coords, cell, pbc)
        if not isinstance(charge, int):
            charge = as_tensor(charge, torch.float32, self.device)
        energies = charges = None
        for name, pot, pot_neighbors in self._narrowed(neighbors):
            e, qs = pot.compute_from_neighbors(
                elem_idxs, coords, pot_neighbors, charge=charge,
                atomic=atomic, ensemble_values=ensemble_values,
            )
            energies = e if energies is None else energies + e
            if name == "nnp":
                charges = qs
        if self.energy_shifter.enabled:
            energies = energies + self.energy_shifter(elem_idxs, atomic=atomic)
        return EnergiesScalars(energies, charges)

    def energies_and_charges(self, species, coords, cell=None, pbc=None, charge=0) -> EnergiesScalars:
        return self.compute_with_charges(species, coords, cell, pbc, charge)

    def atomic_charges(self, species, coords, cell=None, pbc=None, charge=0) -> Tensor:
        return self.compute_with_charges(species, coords, cell, pbc, charge).scalars


def simple_aniq(
    symbols: tp.Sequence[str],
    lot: str = "wb97x-631gd",
    ensemble_size: int = 1,
    merge_charge_networks: bool = False,
    repulsion: bool = True,
    scale_charge_normalizer_weights: bool = True,
    normalize: bool = True,
    seed: int = 0,
    device: DeviceArg = None,
    **kwargs,
) -> ANIq:
    """`simple_ani` with charges: separate like-2x charge networks (gelu, no
    bias) by default, or with ``merge_charge_networks`` energy networks with
    a head of two; the normalizer's weights are (chi / eta)^2 scaled by q^2
    (``normalize=False``: uniform).  The charge networks' random weights come
    from a generator of their own (seed ``seed + 7``)."""
    symbols = tuple(symbols)
    base = simple_ani(
        symbols, lot, ensemble_size, repulsion=repulsion, seed=seed, device=device, **kwargs
    )
    nnp = base.potentials["nnp"]
    dev = base.device
    if normalize:
        normalizer = ChargeNormalizer.from_electronegativity_and_hardness(
            symbols, scale_weights_by_charges_squared=scale_charge_normalizer_weights,
            device=dev,
        )
    else:
        normalizer = ChargeNormalizer(symbols, device=dev)
    generator = torch.Generator().manual_seed(seed + 7)
    in_dim = nnp.aev_computer.out_dim
    if merge_charge_networks:
        dims, default_dims, _, _ = NETWORK_WIDTHS["like_2x"]
        layer_dims = layer_dims_for(symbols, in_dim, dims, default_dims, out_dim=2)
        kw = dict(activation="gelu", bias=False)
        if ensemble_size == 1:
            networks = AtomicNetworks.random(symbols, layer_dims, generator, dev, **kw)
        else:
            networks = Ensemble.random(ensemble_size, symbols, layer_dims, generator, dev, **kw)
        new_nnp: Potential = MergedChargesNNPotential(
            symbols, nnp.aev_computer, networks, normalizer
        )
    else:
        charge_networks = AtomicNetworks.like_2x(
            symbols, in_dim, out_dim=1, activation="gelu", bias=False,
            generator=generator, device=dev,
        )
        new_nnp = SeparateChargesNNPotential(
            symbols, nnp.aev_computer, nnp.neural_networks, charge_networks, normalizer
        )
    potentials = dict(base.potentials)
    potentials["nnp"] = new_nnp
    return ANIq(
        potentials=potentials,
        energy_shifter=base.energy_shifter,
        symbols=base.symbols,
        neighborlist=base.neighborlist,
        periodic_table_index=base.periodic_table_index,
    )


class Assembler:
    """Declarative assembly of ANI-style models: set symbols, AEV terms, the
    atomic networks, self energies and extra potentials, then
    ``assemble(ensemble_size)``.  ``periodic_table_index`` is the assembled
    model's (see `ANI`)."""

    def __init__(self, periodic_table_index: bool = True) -> None:
        self.periodic_table_index = periodic_table_index
        self.symbols: tp.Optional[Symbols] = None
        self._global_cutoff_fn = "smooth"
        self._aev_terms: tp.Tuple[tp.Any, tp.Any] = ("ani2x", "ani2x")
        self._networks: tp.Dict[str, tp.Any] = {}
        self.set_atomic_networks("ani2x")
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
        self,
        ctor: str = "ani2x",
        activation: tp.Optional[str] = None,
        bias: tp.Optional[bool] = None,
        cls: tp.Optional[type] = None,
    ) -> "Assembler":
        """The per-element networks: ``ctor`` names the layer widths
        (``"ani1x"``, ``"ani1ccx"``, ``"ani2x"``, ``"anidr"``, ``"aniala"``);
        ``activation`` and ``bias`` default to that family's.  With ``cls``
        the same names (or any other) resolve to constructors of that class,
        e.g. ``cls=SingleNN, ctor="large"``; its members are stacked into a
        `GenericEnsemble`."""
        if cls is not None:
            factory = getattr(cls, _NETWORK_CTORS.get(ctor, ctor))
            kw = {k: v for k, v in (("activation", activation), ("bias", bias)) if v is not None}
            self._networks = dict(factory=factory, kw=kw)
            return self
        try:
            dims, default_dims, default_act, default_bias = NETWORK_WIDTHS[_NETWORK_CTORS[ctor]]
        except KeyError:
            raise ValueError(
                f"unknown network constructor {ctor!r}; expected one of {sorted(_NETWORK_CTORS)}"
            ) from None
        self._networks = dict(
            dims=dims,
            default_dims=default_dims,
            activation=default_act if activation is None else activation,
            bias=default_bias if bias is None else bias,
        )
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
        nets = self._networks
        generator = torch.Generator().manual_seed(seed)
        if "factory" in nets:
            members = [
                nets["factory"](
                    self.symbols, aev.out_dim, generator=generator, device=dev, **nets["kw"]
                )
                for _ in range(ensemble_size)
            ]
            networks = members[0] if ensemble_size == 1 else GenericEnsemble.from_members(members)
        else:
            layer_dims = layer_dims_for(
                self.symbols, aev.out_dim, nets["dims"], nets["default_dims"]
            )
            kw = dict(activation=nets["activation"], bias=nets["bias"])
            if ensemble_size == 1:
                networks = AtomicNetworks.random(self.symbols, layer_dims, generator, dev, **kw)
            else:
                networks = Ensemble.random(
                    ensemble_size, self.symbols, layer_dims, generator, dev, **kw
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
            periodic_table_index=self.periodic_table_index,
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

    ``container`` picks the network family (``"ANINetworks"``,
    ``"SingleNN"``, ``"ANISharedNetworks"``) and ``container_ctor`` its
    constructor (e.g. ``"large"``, SnnANI2xr's head).
    """
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
    if container == "ANINetworks":
        # the "default" constructor of this container is ANI-2x's widths; the
        # activation and bias passed here override the family's
        ctor = "ani2x" if container_ctor == "default" else container_ctor
        asm.set_atomic_networks(ctor=ctor, activation=activation, bias=bias)
    else:
        cls = {"SingleNN": SingleNN, "ANISharedNetworks": ANISharedNetworks}[container]
        asm.set_atomic_networks(ctor=container_ctor, activation=activation, bias=bias, cls=cls)
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
