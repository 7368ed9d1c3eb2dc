"""Per-element atomic networks, ensembles and the species converter
(counterparts of ``torchani_tpu/nn/containers.py``).

Element networks are stored as zero-padded weight stacks: ``(S, in, out)``
per layer for `AtomicNetworks` and ``(E, S, in, out)`` for an `Ensemble`,
the layout of the JAX package (so its arrays load as they are).  Each
present species runs its own MLP at its true layer widths over the rows of
its atoms, picked with real index tensors; the ensemble's member axis rides
the batch dimension of one matmul per layer.
"""

import functools
import typing as tp

import torch

from torchani_tpu_torch.annotations import DeviceArg, Symbols, Tensor
from torchani_tpu_torch.constants import ATOMIC_NUMBER, PERIODIC_TABLE
from torchani_tpu_torch.utils import resolve_device

__all__ = [
    "AtomicNetworks",
    "Ensemble",
    "SpeciesConverter",
    "parse_activation",
    "DIMS_2X",
    "SpeciesRanges",
    "layer_dims_for",
]

#: per-symbol hidden dims of the ANI-2x networks
DIMS_2X: tp.Dict[str, tp.Tuple[int, ...]] = {
    "H": (256, 192, 160),
    "C": (224, 192, 160),
    "N": (192, 160, 128),
    "O": (192, 160, 128),
    "S": (160, 128, 96),
    "F": (160, 128, 96),
    "Cl": (160, 128, 96),
}
_DEFAULT_DIMS = (160, 128, 96)

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
    """

    def __init__(
        self,
        weights: tp.Sequence[Tensor],
        biases: tp.Optional[tp.Sequence[Tensor]],
        layer_dims: LayerDims,
        symbols: Symbols,
        activation: str = "celu",
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

    @property
    def num_species(self) -> int:
        return len(self.symbols)

    @property
    def out_dim(self) -> int:
        return self.layer_dims[0][-1]

    def _stacks(self) -> tp.Tuple[tp.List[Tensor], tp.Optional[tp.List[Tensor]]]:
        """Per-layer ``(E, S, in, out)`` weights and ``(E, S, out)`` biases."""
        return list(self.weights), None if self.biases is None else list(self.biases)

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
    ) -> "Ensemble":
        """Networks with random weights from ``generator`` (CELU with biases
        by default, as the JAX package's ``like_2x``)."""
        dev = resolve_device(device)
        weights, biases = _random_stacks(num_members, layer_dims, generator)
        return cls(
            [w.to(dev) for w in weights], [b.to(dev) for b in biases] if bias else None,
            layer_dims, tuple(symbols), activation,
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
            self.layer_dims, self.symbols, self.activation,
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
        read from the tensor.
        """
        c, a = elem_idxs.shape
        x0 = aevs.reshape(c * a, aevs.shape[-1])
        e = self._stacks()[0][0].shape[0]
        if species_ranges is not None:
            pieces, pos = [], 0
            for s, start, stop in species_ranges:
                if start > pos:
                    pieces.append(x0.new_zeros((e, start - pos, self.out_dim)))
                pieces.append(self._species_mlp(s, x0[start:stop]))
                pos = stop
            if pos < c * a:
                pieces.append(x0.new_zeros((e, c * a - pos, self.out_dim)))
            return torch.cat(pieces, dim=1).reshape(e, c, a, self.out_dim)
        elem = elem_idxs.reshape(-1)
        out = x0.new_zeros((e, c * a, self.out_dim))
        for s in torch.unique(elem).tolist():
            if not 0 <= s < self.num_species:
                continue
            rows = torch.nonzero(elem == s).squeeze(1)
            out = out.index_copy(1, rows, self._species_mlp(s, x0.index_select(0, rows)))
        return out.reshape(e, c, a, self.out_dim)

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

    def forward(
        self,
        elem_idxs: Tensor,
        aevs: Tensor,
        atomic: bool = False,
        ensemble_values: bool = False,
        species_ranges: tp.Optional[SpeciesRanges] = None,
    ) -> Tensor:
        return super().forward(elem_idxs, aevs, atomic=atomic, species_ranges=species_ranges)


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
