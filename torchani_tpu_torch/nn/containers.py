"""Per-element atomic networks, ensembles and the species converter
(counterparts of ``torchani_tpu/nn/containers.py``).

Element networks are stored as zero-padded weight stacks: ``(S, in, out)``
per layer for `AtomicNetworks` and ``(E, S, in, out)`` for an `Ensemble`,
the layout of the JAX package (so its arrays load as they are).  Each
present species runs its own MLP at its true layer widths over the rows of
its atoms, picked with real index tensors; the ensemble's member axis rides
the batch dimension of one matmul per layer.  With ``partition`` (static
per-species row budgets, `torchani_tpu_torch.nn.partition`) the rows move
into species blocks on the device instead, and nothing is read back.
"""

import functools
import math
import typing as tp

import torch

from torchani_tpu_torch.annotations import DeviceArg, Symbols, Tensor
from torchani_tpu_torch.constants import ATOMIC_NUMBER, PERIODIC_TABLE
from torchani_tpu_torch.nn.partition import block_rows, species_blocks, unblock_rows
from torchani_tpu_torch.profiling import scope
from torchani_tpu_torch.utils import resolve_device

__all__ = [
    "AtomicNetworks",
    "ANINetworks",
    "AtomicNetworksDiscardFirstScalar",
    "Ensemble",
    "GenericEnsemble",
    "SpeciesConverter",
    "parse_activation",
    "DIMS_1X",
    "DIMS_2X",
    "DIMS_DR",
    "DIMS_ALA",
    "NETWORK_WIDTHS",
    "SpeciesRanges",
    "layer_dims_for",
]

#: per-symbol hidden dims of the pretrained model families
DIMS_1X: tp.Dict[str, tp.Tuple[int, ...]] = {
    "H": (160, 128, 96),
    "C": (144, 112, 96),
    "N": (128, 112, 96),
    "O": (128, 112, 96),
}
DIMS_2X: tp.Dict[str, tp.Tuple[int, ...]] = {
    "H": (256, 192, 160),
    "C": (224, 192, 160),
    "N": (192, 160, 128),
    "O": (192, 160, 128),
    "S": (160, 128, 96),
    "F": (160, 128, 96),
    "Cl": (160, 128, 96),
}
DIMS_DR: tp.Dict[str, tp.Tuple[int, ...]] = {
    "H": (256, 192, 160),
    "C": (256, 192, 160),
    "N": (192, 160, 128),
    "O": (192, 160, 128),
    "S": (160, 128, 96),
    "F": (160, 128, 96),
    "Cl": (160, 128, 96),
}
DIMS_ALA: tp.Dict[str, tp.Tuple[int, ...]] = {
    "H": (256, 192, 160),
    "C": (224, 196, 160),
    "N": (192, 160, 128),
    "O": (192, 160, 128),
    "S": (160, 128, 96),
    "F": (160, 128, 96),
    "Cl": (160, 128, 96),
}
_DEFAULT_DIMS = (160, 128, 96)
_DEFAULT_DIMS_1X = (128, 112, 96)

#: the network constructors by name: (hidden dims per symbol, dims of any
#: other symbol, activation, bias), as the JAX package's ``like_*``
NETWORK_WIDTHS: tp.Dict[
    str, tp.Tuple[tp.Dict[str, tp.Tuple[int, ...]], tp.Tuple[int, ...], str, bool]
] = {
    "like_1x": (DIMS_1X, _DEFAULT_DIMS_1X, "celu", True),
    "like_2x": (DIMS_2X, _DEFAULT_DIMS, "celu", True),
    "like_dr": (DIMS_DR, _DEFAULT_DIMS, "gelu", False),
    "like_ala": (DIMS_ALA, _DEFAULT_DIMS, "celu", True),
}

LayerDims = tp.Tuple[tp.Tuple[int, ...], ...]
#: ``(species, start, stop)`` row ranges of a flat element array that is
#: sorted by species, in row order; rows outside every range are padding
SpeciesRanges = tp.Tuple[tp.Tuple[int, int, int], ...]


def parse_activation(name: str) -> tp.Callable[[Tensor], Tensor]:
    """Activation registry. ``celu`` is CELU(alpha=0.1)."""
    if name == "gelu":
        return lambda x: torch.nn.functional.gelu(x, approximate="none")
    if name == "celu":
        return lambda x: torch.nn.functional.celu(x, alpha=0.1)
    raise ValueError(f"Unsupported activation: {name}")


def layer_dims_for(
    symbols: tp.Sequence[str],
    in_dim: int,
    dims: tp.Dict[str, tp.Tuple[int, ...]] = DIMS_2X,
    default_dims: tp.Tuple[int, ...] = _DEFAULT_DIMS,
    out_dim: int = 1,
) -> LayerDims:
    """Per-species ``(in, hidden..., out)`` widths (ANI-2x's by default)."""
    if any(s not in PERIODIC_TABLE for s in symbols):
        raise ValueError("All modules should be mapped to valid chemical symbols")
    return tuple(
        (in_dim,) + tuple(dims.get(s, default_dims)) + (out_dim,) for s in symbols
    )


def _random_stacks(
    num_members: int,
    layer_dims: LayerDims,
    generator: torch.Generator,
) -> tp.Tuple[tp.List[Tensor], tp.List[Tensor]]:
    """Zero-padded ``(E, S, in, out)`` / ``(E, S, out)`` stacks drawn like
    ``torch.nn.Linear``'s default, ``U(-1/sqrt(in), 1/sqrt(in))``, on the
    CPU (so every device gets the same weights from one seed)."""
    num_layers = len(layer_dims[0]) - 1
    if any(len(d) - 1 != num_layers for d in layer_dims):
        raise ValueError("All species must have the same number of layers")
    s = len(layer_dims)
    weights, biases = [], []
    for li in range(num_layers):
        in_max = max(d[li] for d in layer_dims)
        out_max = max(d[li + 1] for d in layer_dims)
        weights.append(torch.zeros((num_members, s, in_max, out_max)))
        biases.append(torch.zeros((num_members, s, out_max)))
    for e in range(num_members):
        for li in range(num_layers):
            for si, d in enumerate(layer_dims):
                bound = 1.0 / d[li] ** 0.5
                w = torch.rand((d[li], d[li + 1]), generator=generator)
                b = torch.rand((d[li + 1],), generator=generator)
                weights[li][e, si, : d[li], : d[li + 1]] = (2 * w - 1) * bound
                biases[li][e, si, : d[li + 1]] = (2 * b - 1) * bound
    return weights, biases


class Ensemble(torch.nn.Module):
    """Average of E member networks over per-element MLPs.

    ``weights[l]`` is ``(E, S, in, out)`` and ``biases[l]`` ``(E, S, out)``,
    zero-padded past each species' true widths ``layer_dims[s]``.

    ``partition``: static per-species row budgets (one per species, e.g.
    from `torchani_tpu_torch.nn.partition.measure_caps`).  When set, an
    evaluation without ``species_ranges`` permutes the atom rows into
    species blocks of those sizes on the device (`nn.partition`), runs each
    species' MLP over its own block and permutes back: no wait for the
    device, where the default reads the present species and their rows.
    A species with more atoms than its budget poisons the energies with
    NaN.
    """

    def __init__(
        self,
        weights: tp.Sequence[Tensor],
        biases: tp.Optional[tp.Sequence[Tensor]],
        layer_dims: LayerDims,
        symbols: Symbols,
        activation: str = "celu",
        partition: tp.Optional[tp.Sequence[int]] = None,
    ) -> None:
        super().__init__()
        self.weights = torch.nn.ParameterList(
            [torch.nn.Parameter(w) for w in weights]
        )
        self.biases = (
            None
            if biases is None
            else torch.nn.ParameterList([torch.nn.Parameter(b) for b in biases])
        )
        self.layer_dims = tuple(tuple(d) for d in layer_dims)
        self.symbols = tuple(symbols)
        self.activation = activation
        self.partition = partition

    @property
    def partition(self) -> tp.Optional[tp.Tuple[int, ...]]:
        return self._partition

    @partition.setter
    def partition(self, caps: tp.Optional[tp.Sequence[int]]) -> None:
        if caps is not None:
            caps = tuple(int(c) for c in caps)
            if len(caps) != self.num_species:
                raise ValueError(
                    f"partition has {len(caps)} entries for {self.num_species} species"
                )
        self._partition = caps

    @property
    def num_species(self) -> int:
        return len(self.symbols)

    @property
    def out_dim(self) -> int:
        return self.layer_dims[0][-1]

    @property
    def total_members_num(self) -> int:
        return self._stacks()[0][0].shape[0]

    def _stacks(self) -> tp.Tuple[tp.List[Tensor], tp.Optional[tp.List[Tensor]]]:
        """Per-layer ``(E, S, in, out)`` weights and ``(E, S, out)`` biases."""
        return list(self.weights), None if self.biases is None else list(self.biases)

    @classmethod
    def from_members(cls, members: tp.Sequence["Ensemble"]) -> "Ensemble":
        """An ensemble of the members' networks, stacked in order (copies
        of their weights); every member must share the architecture."""
        first = members[0]
        for m in members[1:]:
            if m.layer_dims != first.layer_dims or m.symbols != first.symbols:
                raise ValueError("All ensemble members must share an architecture")
        stacks = [m._stacks() for m in members]
        weights = [
            torch.cat([w[li] for w, _ in stacks]).detach().clone()
            for li in range(len(stacks[0][0]))
        ]
        biases = None
        if stacks[0][1] is not None:
            biases = [
                torch.cat([b[li] for _, b in stacks]).detach().clone()
                for li in range(len(stacks[0][1]))
            ]
        return Ensemble(weights, biases, first.layer_dims, first.symbols, first.activation)

    @classmethod
    def random(
        cls,
        num_members: int,
        symbols: tp.Sequence[str],
        layer_dims: LayerDims,
        generator: torch.Generator,
        device: DeviceArg = None,
        activation: str = "celu",
        bias: bool = True,
        partition: tp.Optional[tp.Sequence[int]] = None,
    ) -> "Ensemble":
        """Networks with random weights from ``generator`` (CELU with biases
        by default, as the JAX package's ``like_2x``)."""
        dev = resolve_device(device)
        weights, biases = _random_stacks(num_members, layer_dims, generator)
        return cls(
            [w.to(dev) for w in weights], [b.to(dev) for b in biases] if bias else None,
            layer_dims, tuple(symbols), activation, partition,
        )

    def member(self, idx: int) -> "AtomicNetworks":
        """One member as a plain `AtomicNetworks` (with its own copy of the
        member's weights)."""
        weights, biases = self._stacks()
        if not 0 <= idx < weights[0].shape[0]:
            raise IndexError(f"Idx {idx} should be 0 <= idx < {weights[0].shape[0]}")
        return AtomicNetworks(
            [w[idx].detach().clone() for w in weights],
            None if biases is None else [b[idx].detach().clone() for b in biases],
            self.layer_dims, self.symbols, self.activation, self.partition,
        )

    def _species_mlp(self, s: int, x: Tensor) -> Tensor:
        """Rows ``x (n, in)`` of species ``s`` through its MLP at its true
        widths, all members at once: ``(E, n, out_dim)``."""
        act = parse_activation(self.activation)
        weights, biases = self._stacks()
        num_layers = len(weights)
        dims = self.layer_dims[s]
        for li in range(num_layers):
            w = weights[li][:, s, : dims[li], : dims[li + 1]]
            x = torch.matmul(x, w)  # (E, n_s, out)
            if biases is not None:
                x = x + biases[li][:, s, None, : dims[li + 1]]
            if li + 1 < num_layers:
                x = act(x)
        return x

    def member_values(
        self,
        elem_idxs: Tensor,
        aevs: Tensor,
        species_ranges: tp.Optional[SpeciesRanges] = None,
    ) -> Tensor:
        """Per-member atomic scalars ``(E, C, A, out_dim)``; padding atoms 0.

        Each present species' rows go through that species' MLP.  By default
        the rows are found from ``elem_idxs``, which waits for the device.
        A caller whose flattened element array is sorted by species passes
        its ``species_ranges``: the rows are then slices, and nothing is
        read from the tensor.  Without them, ``partition`` moves the rows
        into species blocks on the device (`_blocked_values`).
        """
        c, a = elem_idxs.shape
        # aevs ``(C, A, F)``, or ``(E, C, A, F)`` with a row per member (the
        # heads of a stacked `ANISharedNetworks`)
        x0 = aevs.reshape(tuple(aevs.shape[:-3]) + (c * a, aevs.shape[-1]))
        e = self._stacks()[0][0].shape[0]
        if species_ranges is not None:
            pieces, pos = [], 0
            for s, start, stop in species_ranges:
                if start > pos:
                    pieces.append(x0.new_zeros((e, start - pos, self.out_dim)))
                pieces.append(self._species_mlp(s, x0[..., start:stop, :]))
                pos = stop
            if pos < c * a:
                pieces.append(x0.new_zeros((e, c * a - pos, self.out_dim)))
            return torch.cat(pieces, dim=1).reshape(e, c, a, self.out_dim)
        elem = elem_idxs.reshape(-1)
        if self.partition is not None:
            return self._blocked_values(elem, x0).reshape(e, c, a, self.out_dim)
        out = x0.new_zeros((e, c * a, self.out_dim))
        with scope("nn.present_species", wait=True):
            present = torch.unique(elem).tolist()
        for s in present:
            if not 0 <= s < self.num_species:
                continue
            with scope("nn.species_rows", wait=True):
                rows = torch.nonzero(elem == s).squeeze(1)
            out = out.index_copy(1, rows, self._species_mlp(s, x0.index_select(-2, rows)))
        return out.reshape(e, c, a, self.out_dim)

    def _blocked_values(self, elem: Tensor, x0: Tensor) -> Tensor:
        """Species-blocked evaluation over ``partition``: ``(E, N, out)``
        for rows ``x0 (N, F)`` or ``(E, N, F)``; padding rows 0, NaN
        everywhere if a species overflowed its budget.  A species whose
        budget is 0 runs no network."""
        blocks = species_blocks(elem, self.partition)
        xb = block_rows(x0.movedim(-2, 0), blocks).movedim(0, -2)  # (..., P, F)
        outs = [
            self._species_mlp(s, xb[..., off:off + cap, :])
            for s, (off, cap) in enumerate(zip(blocks.offsets, blocks.caps))
            if cap > 0
        ]
        yb = torch.cat(outs, dim=1)  # (E, P, out)
        y = unblock_rows(yb.movedim(1, 0), blocks).movedim(0, 1)  # (E, N, out)
        return y * torch.where(blocks.ok, 1.0, math.nan).to(y.dtype)

    def forward(
        self,
        elem_idxs: Tensor,
        aevs: Tensor,
        atomic: bool = False,
        ensemble_values: bool = False,
        species_ranges: tp.Optional[SpeciesRanges] = None,
    ) -> Tensor:
        scalars = self.member_values(elem_idxs, aevs, species_ranges)  # (E, C, A, out)
        if self.out_dim == 1:
            scalars = scalars[..., 0]
        if not ensemble_values:
            scalars = torch.mean(scalars, dim=0)
        if atomic:
            return scalars
        return torch.sum(scalars, dim=-1)


class AtomicNetworks(Ensemble):
    """A single set of per-element MLPs: weight stacks ``(S, in, out)`` and
    biases ``(S, out)``, the JAX package's layout; evaluated as a one-member
    ensemble."""

    def _stacks(self) -> tp.Tuple[tp.List[Tensor], tp.Optional[tp.List[Tensor]]]:
        w = [p[None] for p in self.weights]
        return w, None if self.biases is None else [p[None] for p in self.biases]

    @classmethod
    def random(
        cls,
        symbols: tp.Sequence[str],
        layer_dims: LayerDims,
        generator: torch.Generator,
        device: DeviceArg = None,
        activation: str = "celu",
        bias: bool = True,
    ) -> "AtomicNetworks":
        """Networks with random weights from ``generator`` (CELU with biases
        by default)."""
        dev = resolve_device(device)
        weights, biases = _random_stacks(1, layer_dims, generator)
        return cls(
            [w[0].to(dev) for w in weights], [b[0].to(dev) for b in biases] if bias else None,
            layer_dims, tuple(symbols), activation,
        )

    @classmethod
    def _like(
        cls,
        ctor: str,
        symbols: tp.Sequence[str],
        in_dim: int,
        out_dim: int,
        activation: tp.Optional[str],
        bias: tp.Optional[bool],
        generator: tp.Optional[torch.Generator],
        device: DeviceArg,
    ) -> "AtomicNetworks":
        dims, default_dims, default_act, default_bias = NETWORK_WIDTHS[ctor]
        return cls.random(
            symbols,
            layer_dims_for(symbols, in_dim, dims, default_dims, out_dim),
            generator if generator is not None else torch.Generator().manual_seed(0),
            device,
            activation=default_act if activation is None else activation,
            bias=default_bias if bias is None else bias,
        )

    @classmethod
    def like_1x(
        cls, symbols: tp.Sequence[str] = ("H", "C", "N", "O"), in_dim: int = 384,
        out_dim: int = 1, activation: tp.Optional[str] = None, bias: tp.Optional[bool] = None,
        generator: tp.Optional[torch.Generator] = None, device: DeviceArg = None,
    ) -> "AtomicNetworks":
        """ANI-1x widths (CELU with biases by default)."""
        return cls._like("like_1x", symbols, in_dim, out_dim, activation, bias, generator, device)

    @classmethod
    def like_2x(
        cls, symbols: tp.Sequence[str] = ("H", "C", "N", "O", "S", "F", "Cl"),
        in_dim: int = 1008, out_dim: int = 1, activation: tp.Optional[str] = None,
        bias: tp.Optional[bool] = None, generator: tp.Optional[torch.Generator] = None,
        device: DeviceArg = None,
    ) -> "AtomicNetworks":
        """ANI-2x widths (CELU with biases by default)."""
        return cls._like("like_2x", symbols, in_dim, out_dim, activation, bias, generator, device)

    @classmethod
    def like_dr(
        cls, symbols: tp.Sequence[str] = ("H", "C", "N", "O", "S", "F", "Cl"),
        in_dim: int = 1008, out_dim: int = 1, activation: tp.Optional[str] = None,
        bias: tp.Optional[bool] = None, generator: tp.Optional[torch.Generator] = None,
        device: DeviceArg = None,
    ) -> "AtomicNetworks":
        """ANI-dr widths (gelu without biases by default)."""
        return cls._like("like_dr", symbols, in_dim, out_dim, activation, bias, generator, device)

    @classmethod
    def like_ala(
        cls, symbols: tp.Sequence[str] = ("H", "C", "N", "O", "S", "F", "Cl"),
        in_dim: int = 1008, out_dim: int = 1, activation: tp.Optional[str] = None,
        bias: tp.Optional[bool] = None, generator: tp.Optional[torch.Generator] = None,
        device: DeviceArg = None,
    ) -> "AtomicNetworks":
        """ANI-ala widths (CELU with biases by default)."""
        return cls._like("like_ala", symbols, in_dim, out_dim, activation, bias, generator, device)

    def forward(
        self,
        elem_idxs: Tensor,
        aevs: Tensor,
        atomic: bool = False,
        ensemble_values: bool = False,
        species_ranges: tp.Optional[SpeciesRanges] = None,
    ) -> Tensor:
        return super().forward(elem_idxs, aevs, atomic=atomic, species_ranges=species_ranges)


#: The reference's name of `AtomicNetworks`
ANINetworks = AtomicNetworks


class AtomicNetworksDiscardFirstScalar(AtomicNetworks):
    """Networks with ``out_dim >= 2`` whose first output is discarded: each
    atom's value is output column 1 (the published ANI-mbis charge networks
    have a head of two, the first unused)."""

    def forward(
        self,
        elem_idxs: Tensor,
        aevs: Tensor,
        atomic: bool = False,
        ensemble_values: bool = False,
        species_ranges: tp.Optional[SpeciesRanges] = None,
    ) -> Tensor:
        scalars = self.member_values(elem_idxs, aevs, species_ranges)[0, ..., 1]
        if atomic:
            return scalars
        return torch.sum(scalars, dim=-1)


class GenericEnsemble(torch.nn.Module):
    """Average of E members of a container whose parameters are not
    per-element stacks (`SingleNN`, `ANISharedNetworks`).

    ``stacked`` is one container whose every parameter carries a leading
    member axis, so that the members run as one batched product per layer:
    the counterpart of the JAX package's ``vmap`` over its stacked pytree
    (the leaf paths are the same, ``.stacked.weights[0]``, ...).
    """

    def __init__(self, stacked: torch.nn.Module) -> None:
        super().__init__()
        self.stacked = stacked

    @classmethod
    def from_members(cls, members: tp.Sequence[torch.nn.Module]) -> "GenericEnsemble":
        return cls(type(members[0]).stack(members))

    @property
    def symbols(self) -> Symbols:
        return self.stacked.symbols

    @property
    def num_species(self) -> int:
        return len(self.symbols)

    @property
    def total_members_num(self) -> int:
        return next(self.stacked.parameters()).shape[0]

    def member(self, idx: int) -> torch.nn.Module:
        """One member as a plain container (with its own copy of the
        member's weights)."""
        if not 0 <= idx < self.total_members_num:
            raise IndexError(f"Idx {idx} should be 0 <= idx < {self.total_members_num}")
        return self.stacked.unstack(idx)

    def forward(
        self,
        elem_idxs: Tensor,
        aevs: Tensor,
        atomic: bool = False,
        ensemble_values: bool = False,
        species_ranges: tp.Optional[SpeciesRanges] = None,
    ) -> Tensor:
        vals = self.stacked.member_values(elem_idxs, aevs, species_ranges)  # (E, C, A)
        if not atomic:
            vals = torch.sum(vals, dim=-1)
        if ensemble_values:
            return vals
        return torch.mean(vals, dim=0)


class SpeciesConverter:
    """Convert atomic numbers to 0-based model element indices; padding (-1)
    and elements the model lacks map to -1."""

    def __init__(self, symbols: tp.Sequence[str]) -> None:
        self.symbols = tuple(symbols)

    @property
    def atomic_numbers(self) -> tp.Tuple[int, ...]:
        return tuple(ATOMIC_NUMBER[s] for s in self.symbols)

    def __call__(self, species: Tensor) -> Tensor:
        table = _species_table(self.atomic_numbers, species.device)
        return torch.where(species < 0, -1, table[species.clamp(0, 119)])


@functools.lru_cache(maxsize=16)
def _species_table(atomic_numbers: tp.Tuple[int, ...], device: torch.device) -> Tensor:
    """Atomic number -> element index (-1 where absent), kept on ``device``."""
    table = torch.full((120,), -1, dtype=torch.int64)
    for i, z in enumerate(atomic_numbers):
        table[z] = i
    return table.to(device)
