"""Base classes of atomic potentials (counterpart of
``torchani_tpu/potentials/core.py``).

Pair potentials work on the padded *full* neighbor table (`Neighbors`,
``(C, A, K)``): per-lane energies under a mask, reduced by masked sums.  Each
true pair appears in two lanes, hence the factor 0.5.
"""

import math
import typing as tp

import numpy as np
import torch

from torchani_tpu_torch.annotations import DeviceArg, Symbols, Tensor
from torchani_tpu_torch.cutoffs import Cutoff, CutoffArg, CutoffDummy, parse_cutoff_fn
from torchani_tpu_torch.neighbors import Neighbors, adaptive_list, all_pairs
from torchani_tpu_torch.nn.containers import SpeciesConverter, SpeciesRanges
from torchani_tpu_torch.tuples import EnergiesScalars
from torchani_tpu_torch.units import ANGSTROM_TO_BOHR
from torchani_tpu_torch.utils import resolve_device

__all__ = ["Potential", "DummyPotential", "BasePairPotential", "PairPotential"]


class Potential(torch.nn.Module):
    """Base class for all atomic potentials.

    Subclasses implement `compute_from_neighbors` and set ``cutoff``
    (``math.inf`` means "needs all pairs").  A potential with ``enabled``
    False is skipped by `torchani_tpu_torch.arch.ANI` and does not count
    towards the model's cutoff.
    """

    def __init__(self, symbols: Symbols, cutoff: float = math.inf) -> None:
        super().__init__()
        self.symbols = tuple(symbols)
        self.cutoff = float(cutoff)
        self.enabled = True

    def forward(
        self,
        species: Tensor,
        coords: Tensor,
        cell: tp.Optional[Tensor] = None,
        pbc: tp.Optional[Tensor] = None,
        atomic: bool = False,
        ensemble_values: bool = False,
        atomic_nums_input: bool = True,
    ) -> Tensor:
        """Standalone evaluation: build a neighbor table, then compute.
        Inputs are tensors on the potential's device."""
        elem_idxs = SpeciesConverter(self.symbols)(species) if atomic_nums_input else species
        if elem_idxs.dim() != 2 or coords.shape != elem_idxs.shape + (3,):
            raise ValueError(
                f"Expected species (molecules, atoms) and coords (molecules, atoms, 3); "
                f"got {tuple(elem_idxs.shape)} and {tuple(coords.shape)}"
            )
        if math.isinf(self.cutoff) or elem_idxs.shape[0] != 1:
            neighbors = all_pairs(self.cutoff, elem_idxs, coords, cell, pbc)
        else:
            neighbors = adaptive_list(self.cutoff, elem_idxs, coords, cell, pbc)
        return self.compute_from_neighbors(
            elem_idxs, coords, neighbors, atomic=atomic, ensemble_values=ensemble_values
        ).energies

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
        """Energies (and, for a potential that predicts them, per-atom
        scalars) from a neighbor table.  ``species_ranges`` is for a caller
        whose flattened ``elem_idxs`` is sorted by species and known on the
        host (`MolecularDynamics`)."""
        raise NotImplementedError("Must be implemented by subclasses")

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
        """The energies alone, which `ANI` and `MolecularDynamics` sum.  A
        potential that also predicts charges overrides this to skip them:
        nothing on an energy path reads them."""
        return self.compute_from_neighbors(
            elem_idxs, coords, neighbors, charge=charge, atomic=atomic,
            ensemble_values=ensemble_values, species_ranges=species_ranges,
        ).energies


class DummyPotential(Potential):
    """A potential of zero energy."""

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
        shape = elem_idxs.shape if atomic else elem_idxs.shape[:1]
        return EnergiesScalars(
            torch.zeros(shape, dtype=torch.float32, device=elem_idxs.device)
        )


class BasePairPotential(Potential):
    """Template for 2-body potentials.

    Subclasses implement `pair_energies` over the lanes of a neighbor table.
    The base wraps it with the cutoff-function envelope and the masked
    reductions.
    """

    ANGSTROM_TO_BOHR: tp.ClassVar[float] = ANGSTROM_TO_BOHR

    def __init__(
        self,
        symbols: Symbols,
        cutoff: float = math.inf,
        cutoff_fn: CutoffArg = "smooth",
    ) -> None:
        super().__init__(symbols, cutoff)
        self.cutoff_fn: Cutoff = (
            CutoffDummy() if math.isinf(cutoff) else parse_cutoff_fn(cutoff_fn)
        )

    @staticmethod
    def clamp(distances: Tensor) -> Tensor:
        return torch.clamp(distances, min=1e-7)

    def pair_energies(self, elem_flat: Tensor, neighbors: Neighbors) -> Tensor:
        """Per-lane pair energies ``(N, K)``.

        ``elem_flat`` is flat ``(N,)`` over all atoms of the (flattened)
        batch; ``neighbors.idx`` indexes into it.  Masked lanes may hold any
        finite value: the caller masks them out.
        """
        raise NotImplementedError("Must be overriden by subclasses")

    def elem_pairs(
        self, elem_flat: Tensor, neighbors: Neighbors
    ) -> tp.Tuple[Tensor, Tensor]:
        """(center, neighbor) element indices per lane ``(N, K)``, 0 in masked
        lanes.  Reads the table's neighbor species (``Neighbors.elem``) where
        it has them, else gathers them."""
        nbr = torch.where(neighbors.mask, neighbors.nbr_elem(elem_flat), 0)
        center = torch.where(neighbors.mask, elem_flat[:, None], 0)
        return center, nbr

    def pair_tables(
        self, elem_center: Tensor, elem_nbr: Tensor, *tables: Tensor
    ) -> tp.List[Tensor]:
        """Look up several element-pair-keyed constant tables ``(S, S[, ...])``
        with ONE row gather: the tables are folded into one ``(S * S,
        channels)`` payload.  Constants: no backward."""
        s = tables[0].shape[0]
        folded = torch.cat([t.reshape(s * s, -1) for t in tables], dim=1)
        code = elem_center * s + elem_nbr  # masked lanes ride as class 0
        out = folded.index_select(0, code.reshape(-1)).reshape(
            tuple(code.shape) + (folded.shape[-1],)
        )
        res: tp.List[Tensor] = []
        o = 0
        for t in tables:
            if t.dim() > 2:
                c = int(np.prod(t.shape[2:]))
                res.append(out[..., o: o + c].reshape(tuple(code.shape) + tuple(t.shape[2:])))
            else:
                c = 1
                res.append(out[..., o])
            o += c
        return res

    def compute_from_neighbors(
        self,
        elem_idxs: Tensor,  # (C, A)
        coords: tp.Optional[Tensor],
        neighbors: Neighbors,  # (C, A, K)
        charge: int = 0,
        atomic: bool = False,
        ensemble_values: bool = False,
        species_ranges: tp.Optional[SpeciesRanges] = None,
    ) -> EnergiesScalars:
        c, a = elem_idxs.shape
        k = neighbors.capacity
        offsets = (torch.arange(c, device=elem_idxs.device) * a)[:, None, None]
        nb = Neighbors(
            idx=(neighbors.idx + offsets).reshape(c * a, k),
            mask=neighbors.mask.reshape(c * a, k),
            diff=neighbors.diff.reshape(c * a, k, 3),
            dist=neighbors.dist.reshape(c * a, k),
            overflow=neighbors.overflow,
            elem=None if neighbors.elem is None else neighbors.elem.reshape(c * a, k),
            # the lane-select tables and the frozen channels live in flat
            # single-system atom space: valid only for a trivial batch axis
            select_tables=neighbors.select_tables if c == 1 else None,
            pair_aux=neighbors.pair_aux if c == 1 else None,
        )
        e = self.pair_energies(elem_idxs.reshape(-1), nb)  # (N, K)
        if not isinstance(self.cutoff_fn, CutoffDummy) and not math.isinf(self.cutoff):
            e = e * self.cutoff_fn(nb.dist, self.cutoff)
        e = torch.where(nb.mask, e, 0.0)
        atomic_e = 0.5 * torch.sum(e, dim=-1).reshape(c, a)  # full table: x2 lanes
        if atomic:
            return EnergiesScalars(atomic_e)
        return EnergiesScalars(torch.sum(atomic_e, dim=-1))

    # ---- element-pair constant helpers ----
    @staticmethod
    def pack_pair_table(values: tp.Sequence[float], num_species: int) -> np.ndarray:
        """Pack triu-ordered pair values (HH, HC, HO, CC, ...) into a
        symmetric ``(S, S)`` table."""
        values = np.asarray(values, dtype=np.float32)
        iu = np.triu_indices(num_species)
        table = np.zeros((num_species, num_species), dtype=np.float32)
        table[iu] = values
        return table + np.triu(table, 1).T

    def to_pair_values(self, table: Tensor, elem_center: Tensor, elem_nbr: Tensor) -> Tensor:
        """Look up per-lane values from a symmetric ``(S, S)`` table."""
        return table[elem_center, elem_nbr]


class PairPotential(BasePairPotential):
    """Declarative pair potential.

    Subclasses name their parameters in three class attributes: ``tensors``
    (scalars or same-length vectors), ``elem_tensors`` (shape ``(S,)``) and
    ``pair_elem_tensors`` (triu order ``HH, HC, HO, CC, ...``, length
    ``S (S + 1) / 2``, stored as a symmetric ``(S, S)`` table), and implement
    `pair_energies`, reading each value as ``self.<name>``::

        class Square(PairPotential):
            tensors = ["bias"]
            pair_elem_tensors = ["k", "eq"]

            def pair_energies(self, elem_flat, neighbors):
                center, nbr = self.elem_pairs(elem_flat, neighbors)
                eq = self.to_pair_values(self.eq, center, nbr)
                k = self.to_pair_values(self.k, center, nbr)
                return self.bias + k / 2 * (neighbors.dist - eq) ** 2

        pot = Square.make(symbols=("H", "C", "O"), k=k, eq=eq, bias=0.1)

    Every value is a buffer of the module.
    """

    tensors: tp.ClassVar[tp.List[str]] = []
    elem_tensors: tp.ClassVar[tp.List[str]] = []
    pair_elem_tensors: tp.ClassVar[tp.List[str]] = []

    @classmethod
    def make(
        cls,
        symbols: tp.Sequence[str],
        *,
        cutoff: float = math.inf,
        cutoff_fn: CutoffArg = "smooth",
        device: DeviceArg = None,
        **kwargs,
    ) -> "PairPotential":
        symbols = tuple(symbols)
        s = len(symbols)
        dev = resolve_device(device)
        names = set(cls.tensors) | set(cls.elem_tensors) | set(cls.pair_elem_tensors)
        if set(kwargs) != names:
            raise ValueError(
                f"{cls.__name__} takes exactly {sorted(names)}, got {sorted(kwargs)}"
            )
        pot = cls(symbols, cutoff, cutoff_fn)
        for k, v in kwargs.items():
            arr = np.asarray(v, dtype=np.float32)
            if k in cls.elem_tensors and arr.shape != (s,):
                raise ValueError(f"{k} must have shape ({s},), got {arr.shape}")
            if k in cls.pair_elem_tensors:
                if arr.shape != (s * (s + 1) // 2,):
                    raise ValueError(
                        f"{k} must have {s * (s + 1) // 2} triu-ordered "
                        f"values, got shape {arr.shape}"
                    )
                arr = cls.pack_pair_table(arr, s)
            pot.register_buffer(k, torch.as_tensor(arr, device=dev))
        return pot
