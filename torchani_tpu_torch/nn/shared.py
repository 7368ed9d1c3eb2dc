"""Shared-weight network containers, `SingleNN` and `ANISharedNetworks`
(counterparts of ``torchani_tpu/nn/shared.py``).

`SingleNN` runs one network for every atom, with a species embedding
appended to the AEV and one output column per element: each atom's scalar
is its element's column.  `ANISharedNetworks` puts a shared trunk before
per-element heads.  Both are plain dense products (``torch.matmul``); the
JAX package computes them outside any Pallas kernel too.

Every parameter may carry a leading member axis: `GenericEnsemble` holds the
members of an ensemble as one such container (`stack`), and `member_values`
then runs them all in one batched product per layer.  Padding atoms give 0.
"""

import typing as tp

import torch

from torchani_tpu_torch.annotations import DeviceArg, Symbols, Tensor
from torchani_tpu_torch.nn.containers import (
    AtomicNetworks,
    Ensemble,
    SpeciesRanges,
    layer_dims_for,
    parse_activation,
)
from torchani_tpu_torch.utils import resolve_device

__all__ = ["SingleNN", "ANISharedNetworks"]


def _uniform_layers(
    dims: tp.Sequence[int], generator: torch.Generator
) -> tp.Tuple[tp.List[Tensor], tp.List[Tensor]]:
    """``(in, out)`` weights and ``(out,)`` biases of dense layers of widths
    ``dims``, drawn like ``torch.nn.Linear``'s default (on the CPU)."""
    weights, biases = [], []
    for din, dout in zip(dims[:-1], dims[1:]):
        bound = 1.0 / din**0.5
        weights.append((2 * torch.rand((din, dout), generator=generator) - 1) * bound)
        biases.append((2 * torch.rand((dout,), generator=generator) - 1) * bound)
    return weights, biases


def _dense(x: Tensor, weights, biases, act, last_act: bool) -> Tensor:
    """Rows ``x (..., N, in)`` through dense layers whose parameters may
    have a leading member axis: ``(..., N, out)``."""
    num_layers = len(weights)
    for li, w in enumerate(weights):
        x = torch.matmul(x, w)
        if biases is not None:
            x = x + biases[li].unsqueeze(-2)
        if last_act or li < num_layers - 1:
            x = act(x)
    return x


def _params(tensors: tp.Optional[tp.Sequence[Tensor]]) -> tp.Optional[torch.nn.ParameterList]:
    if tensors is None:
        return None
    return torch.nn.ParameterList([torch.nn.Parameter(t) for t in tensors])


def _stack(members, get) -> tp.Optional[tp.List[Tensor]]:
    """Each member's tensors from ``get(member)`` stacked on a new leading
    axis, layer by layer (None where the members have none)."""
    lists = [get(m) for m in members]
    if lists[0] is None:
        return None
    return [torch.stack([ts[i].detach() for ts in lists]) for i in range(len(lists[0]))]


def _pick(tensors, idx: int) -> tp.Optional[tp.List[Tensor]]:
    return None if tensors is None else [t[idx].detach().clone() for t in tensors]


class SingleNN(torch.nn.Module):
    """One fully shared network with a per-element output column.

    ``embed_kind``: ``"continuous"`` appends a trainable ``(S, embed_dims)``
    embedding to the AEV, ``"one-hot"`` the one-hot species, ``"none"``
    nothing.  ``weights[l]`` is ``(in, out)`` and ``biases[l]`` ``(out,)``
    (with a leading member axis when stacked).
    """

    def __init__(
        self,
        weights: tp.Sequence[Tensor],
        biases: tp.Optional[tp.Sequence[Tensor]],
        embedding: tp.Optional[Tensor],
        symbols: Symbols,
        embed_kind: str = "continuous",
        activation: str = "gelu",
    ) -> None:
        super().__init__()
        self.weights = _params(weights)
        self.biases = _params(biases)
        self.embedding = None if embedding is None else torch.nn.Parameter(embedding)
        self.symbols = tuple(symbols)
        self.embed_kind = embed_kind
        self.activation = activation

    @property
    def num_species(self) -> int:
        return len(self.symbols)

    @property
    def total_members_num(self) -> int:
        return 1

    def member_values(
        self,
        elem_idxs: Tensor,
        aevs: Tensor,
        species_ranges: tp.Optional[SpeciesRanges] = None,
    ) -> Tensor:
        """Per-member atomic scalars ``(E, C, A)`` (E = 1 unless stacked)."""
        c, a = elem_idxs.shape
        x = aevs.reshape(c * a, aevs.shape[-1])
        elem = elem_idxs.reshape(-1)
        valid = elem >= 0
        safe = elem.clamp(min=0)
        emb = None
        if self.embed_kind == "one-hot":
            emb = torch.nn.functional.one_hot(safe, self.num_species).to(x.dtype)
            emb = emb * valid[:, None]
        elif self.embed_kind == "continuous":
            emb = torch.where(valid[:, None], self.embedding[..., safe, :], 0.0)
        if emb is not None:
            x = torch.cat([x.expand(tuple(emb.shape[:-1]) + (x.shape[-1],)), emb], dim=-1)
        x = _dense(x, self.weights, self.biases, parse_activation(self.activation), False)
        # each atom's scalar is the output column of its element
        index = safe.expand(x.shape[:-1]).unsqueeze(-1)
        scalars = torch.where(valid, torch.gather(x, -1, index)[..., 0], 0.0)
        if scalars.dim() == 1:
            scalars = scalars[None]
        return scalars.reshape(scalars.shape[0], c, a)

    def forward(
        self,
        elem_idxs: Tensor,
        aevs: Tensor,
        atomic: bool = False,
        ensemble_values: bool = False,
        species_ranges: tp.Optional[SpeciesRanges] = None,
    ) -> Tensor:
        scalars = self.member_values(elem_idxs, aevs)[0]
        if atomic:
            return scalars
        return torch.sum(scalars, dim=-1)

    def member(self, idx: int) -> "SingleNN":
        if idx != 0:
            raise IndexError("SingleNN has one member")
        return self

    @classmethod
    def stack(cls, members: tp.Sequence["SingleNN"]) -> "SingleNN":
        """The members as one container with a leading member axis."""
        first = members[0]
        embedding = None
        if first.embedding is not None:
            embedding = torch.stack([m.embedding.detach() for m in members])
        return cls(
            _stack(members, lambda m: m.weights), _stack(members, lambda m: m.biases),
            embedding, first.symbols, first.embed_kind, first.activation,
        )

    def unstack(self, idx: int) -> "SingleNN":
        """Member ``idx`` of a stacked container, with its own weights."""
        return SingleNN(
            _pick(self.weights, idx), _pick(self.biases, idx),
            None if self.embedding is None else self.embedding[idx].detach().clone(),
            self.symbols, self.embed_kind, self.activation,
        )

    # ---- construction ----
    @classmethod
    def build(
        cls,
        symbols: tp.Sequence[str],
        in_dim: int,
        dims: tp.Tuple[int, ...] = (256, 160, 128, 512),
        out_dim: int = 1,
        activation: str = "gelu",
        bias: bool = False,
        embed_kind: str = "continuous",
        embed_dims: tp.Optional[int] = None,
        generator: tp.Optional[torch.Generator] = None,
        device: DeviceArg = None,
    ) -> "SingleNN":
        """Random weights from ``generator`` (seed 0 by default), drawn on the
        CPU and moved to ``device``; a continuous embedding from a normal."""
        if out_dim != 1:
            raise ValueError("out_dim != 1 is not implemented for SingleNN")
        symbols = tuple(symbols)
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        if embed_kind == "continuous":
            extra = 10 if embed_dims is None else embed_dims
        elif embed_kind == "one-hot":
            if embed_dims is not None:
                raise ValueError("embed_dims is incompatible with 'one-hot'")
            extra = len(symbols)
        elif embed_kind == "none":
            if embed_dims is not None:
                raise ValueError("embed_dims is incompatible with embed_kind='none'")
            extra = 0
        else:
            raise ValueError(f"Unsupported embedding kind {embed_kind}")
        weights, biases = _uniform_layers(
            (in_dim + extra,) + tuple(dims) + (len(symbols),), generator
        )
        embedding = None
        if embed_kind == "continuous":
            embedding = torch.randn((len(symbols), extra), generator=generator).to(dev)
        return cls(
            [w.to(dev) for w in weights], [b.to(dev) for b in biases] if bias else None,
            embedding, symbols, embed_kind, activation,
        )

    @classmethod
    def default(cls, symbols, in_dim, **kwargs) -> "SingleNN":
        return cls.build(symbols, in_dim, (256, 160, 128, 512), **kwargs)

    @classmethod
    def no_embed(cls, symbols, in_dim, **kwargs) -> "SingleNN":
        return cls.build(symbols, in_dim, (256, 160, 128, 512), embed_kind="none", **kwargs)

    @classmethod
    def one_hot(cls, symbols, in_dim, **kwargs) -> "SingleNN":
        return cls.build(symbols, in_dim, (256, 160, 128, 512), embed_kind="one-hot", **kwargs)

    @classmethod
    def large(cls, symbols, in_dim, **kwargs) -> "SingleNN":
        return cls.build(symbols, in_dim, (320, 256, 256, 512), **kwargs)


class ANISharedNetworks(torch.nn.Module):
    """A shared trunk (every layer activated, the last too) feeding
    per-element heads: an `AtomicNetworks`, or an `Ensemble` when stacked."""

    def __init__(
        self,
        trunk_weights: tp.Sequence[Tensor],
        trunk_biases: tp.Optional[tp.Sequence[Tensor]],
        heads: Ensemble,
        symbols: Symbols,
        activation: str = "gelu",
    ) -> None:
        super().__init__()
        self.trunk_weights = _params(trunk_weights)
        self.trunk_biases = _params(trunk_biases)
        self.heads = heads
        self.symbols = tuple(symbols)
        self.activation = activation

    @property
    def num_species(self) -> int:
        return len(self.symbols)

    @property
    def total_members_num(self) -> int:
        return 1

    def member_values(
        self,
        elem_idxs: Tensor,
        aevs: Tensor,
        species_ranges: tp.Optional[SpeciesRanges] = None,
    ) -> Tensor:
        """Per-member atomic scalars ``(E, C, A)`` (E = 1 unless stacked)."""
        c, a = elem_idxs.shape
        x = aevs.reshape(c * a, aevs.shape[-1])
        x = _dense(x, self.trunk_weights, self.trunk_biases,
                   parse_activation(self.activation), True)
        x = x.reshape(tuple(x.shape[:-2]) + (c, a, x.shape[-1]))
        return self.heads.member_values(elem_idxs, x, species_ranges)[..., 0]

    def forward(
        self,
        elem_idxs: Tensor,
        aevs: Tensor,
        atomic: bool = False,
        ensemble_values: bool = False,
        species_ranges: tp.Optional[SpeciesRanges] = None,
    ) -> Tensor:
        scalars = self.member_values(elem_idxs, aevs, species_ranges)[0]
        if atomic:
            return scalars
        return torch.sum(scalars, dim=-1)

    def member(self, idx: int) -> "ANISharedNetworks":
        if idx != 0:
            raise IndexError("Single container has one member")
        return self

    @classmethod
    def stack(cls, members: tp.Sequence["ANISharedNetworks"]) -> "ANISharedNetworks":
        """The members as one container with a leading member axis (the
        heads an `Ensemble`)."""
        first = members[0]
        heads = Ensemble(
            _stack(members, lambda m: m.heads.weights), _stack(members, lambda m: m.heads.biases),
            first.heads.layer_dims, first.heads.symbols, first.heads.activation,
        )
        return cls(
            _stack(members, lambda m: m.trunk_weights), _stack(members, lambda m: m.trunk_biases),
            heads, first.symbols, first.activation,
        )

    def unstack(self, idx: int) -> "ANISharedNetworks":
        """Member ``idx`` of a stacked container, with its own weights."""
        return ANISharedNetworks(
            _pick(self.trunk_weights, idx), _pick(self.trunk_biases, idx),
            self.heads.member(idx), self.symbols, self.activation,
        )

    @classmethod
    def build(
        cls,
        symbols: tp.Sequence[str],
        in_dim: int,
        shared_dims: tp.Tuple[int, ...] = (256,),
        dims: tp.Optional[tp.Dict[str, tp.Tuple[int, ...]]] = None,
        out_dim: int = 1,
        activation: str = "gelu",
        bias: bool = False,
        default_dims: tp.Tuple[int, ...] = (128, 96),
        generator: tp.Optional[torch.Generator] = None,
        device: DeviceArg = None,
    ) -> "ANISharedNetworks":
        """Random weights from ``generator`` (seed 0 by default)."""
        symbols = tuple(symbols)
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        if dims is None:
            dims = {
                "H": (192, 160), "C": (192, 160), "N": (160, 128),
                "O": (160, 128), "S": (128, 96), "F": (128, 96),
                "Cl": (128, 96),
            }
        tw, tb = _uniform_layers((in_dim,) + tuple(shared_dims), generator)
        heads = AtomicNetworks.random(
            symbols, layer_dims_for(symbols, shared_dims[-1], dims, default_dims, out_dim),
            generator, dev, activation=activation, bias=bias,
        )
        return cls(
            [w.to(dev) for w in tw], [b.to(dev) for b in tb] if bias else None,
            heads, symbols, activation,
        )

    default = build
