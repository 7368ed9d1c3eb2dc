"""Standalone network building blocks and the reference's inference
container names (counterpart of ``torchani_tpu/nn/core.py``).

`TightCELU`, `AtomicOneHot`, `AtomicEmbedding`, `AtomicContainer` and
`AtomicNetwork` are the building blocks; `Sequential` is the legacy
pipeline.  The port's `Ensemble` already keeps its members' weights in
stacked ``(E, S, in, out)`` tensors and evaluates them in one batched
product per layer, the computation the reference's fused inference
containers build, so `BmmEnsemble` and `MNPNetworks` return the container
they are given; `BmmLinear` and `BmmAtomicNetwork` are the batched layers
for a stack of `AtomicNetwork`s.
"""

import typing as tp
import warnings

import torch

from torchani_tpu_torch.annotations import DeviceArg, Symbols, Tensor
from torchani_tpu_torch.constants import ATOMIC_NUMBER
from torchani_tpu_torch.nn.containers import AtomicNetworks, Ensemble, parse_activation
from torchani_tpu_torch.utils import resolve_device

__all__ = [
    "TightCELU",
    "AtomicOneHot",
    "AtomicEmbedding",
    "AtomicContainer",
    "AtomicNetwork",
    "Sequential",
    "BmmLinear",
    "BmmAtomicNetwork",
    "BmmEnsemble",
    "MNPNetworks",
]


class TightCELU(torch.nn.Module):
    """CELU activation with alpha = 0.1."""

    def forward(self, x: Tensor) -> Tensor:
        return torch.nn.functional.celu(x, alpha=0.1)


class AtomicOneHot(torch.nn.Module):
    """One-hot element embedding (f32); padding atoms (-1) become zero
    rows."""

    def __init__(self, symbols: tp.Sequence[str]) -> None:
        super().__init__()
        self.symbols: Symbols = tuple(symbols)

    @property
    def num_species(self) -> int:
        return len(self.symbols)

    @property
    def atomic_numbers(self) -> tp.Tuple[int, ...]:
        return tuple(ATOMIC_NUMBER[s] for s in self.symbols)

    def forward(self, elem_idxs: Tensor) -> Tensor:
        oh = torch.nn.functional.one_hot(elem_idxs.clamp(min=0), self.num_species)
        return (oh * (elem_idxs >= 0)[..., None]).to(torch.float32)


class AtomicEmbedding(torch.nn.Module):
    """Trainable continuous element embedding ``weight (S, dim)``; padding
    atoms (-1) embed to zeros."""

    def __init__(self, symbols: tp.Sequence[str], weight: Tensor) -> None:
        super().__init__()
        self.symbols: Symbols = tuple(symbols)
        self.weight = torch.nn.Parameter(weight)

    @classmethod
    def make(
        cls,
        symbols: tp.Sequence[str],
        dim: int = 10,
        generator: tp.Optional[torch.Generator] = None,
        device: DeviceArg = None,
    ) -> "AtomicEmbedding":
        """Standard-normal weights from ``generator`` (a CPU generator seeded
        with 0 by default)."""
        symbols = tuple(symbols)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        weight = torch.randn((len(symbols), dim), generator=generator)
        return cls(symbols, weight.to(resolve_device(device)))

    @property
    def num_species(self) -> int:
        return len(self.symbols)

    def forward(self, elem_idxs: Tensor) -> Tensor:
        emb = self.weight[elem_idxs.clamp(min=0)]
        return torch.where((elem_idxs < 0)[..., None], 0.0, emb)


class AtomicContainer(torch.nn.Module):
    """Base of the atomic-network containers, and the zero-energy container
    of tests: ``forward(elem_idxs, aevs, atomic, ensemble_values)`` gives
    zeros, per molecule or per atom."""

    num_species: int = 0
    total_members_num: int = 1
    active_members_idxs: tp.Tuple[int, ...] = (0,)

    def forward(
        self,
        elem_idxs: Tensor,
        aevs: tp.Optional[Tensor] = None,
        atomic: bool = False,
        ensemble_values: bool = False,
    ) -> Tensor:
        shape = tuple(elem_idxs.shape) if atomic else tuple(elem_idxs.shape[:1])
        return torch.zeros(shape, dtype=torch.float32, device=elem_idxs.device)

    def get_active_members_num(self) -> int:
        return len(self.active_members_idxs)

    def to_infer_model(self, use_mnp: bool = False) -> "AtomicContainer":
        return self


class AtomicNetwork(torch.nn.Module):
    """One plain MLP: hidden linear layers each followed by the activation,
    then a linear output layer.  ``weights[l]`` is ``(in, out)`` (the
    transpose of a ``torch.nn.Linear``'s), ``biases[l]`` ``(out,)`` or
    none."""

    def __init__(
        self,
        weights: tp.Sequence[Tensor],
        biases: tp.Optional[tp.Sequence[Tensor]] = None,
        activation: str = "gelu",
    ) -> None:
        super().__init__()
        self.weights = torch.nn.ParameterList([torch.nn.Parameter(w) for w in weights])
        self.biases = (
            None if biases is None
            else torch.nn.ParameterList([torch.nn.Parameter(b) for b in biases])
        )
        self.activation = activation

    @classmethod
    def make(
        cls,
        layer_dims: tp.Sequence[int],
        activation: str = "gelu",
        bias: bool = False,
        generator: tp.Optional[torch.Generator] = None,
        device: DeviceArg = None,
    ) -> "AtomicNetwork":
        """Weights drawn like ``torch.nn.Linear``'s, ``U(-1/sqrt(in),
        1/sqrt(in))``, from ``generator`` (seeded with 0 by default); zero
        biases."""
        dims = tuple(int(d) for d in layer_dims)
        if any(d <= 0 for d in dims):
            raise ValueError("Layer dims must be strict positive integers")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        dev = resolve_device(device)
        weights = [
            ((2 * torch.rand((i, o), generator=generator) - 1) / i**0.5).to(dev)
            for i, o in zip(dims[:-1], dims[1:])
        ]
        biases = [torch.zeros((o,), device=dev) for o in dims[1:]] if bias else None
        return cls(weights, biases, activation)

    @property
    def layer_dims(self) -> tp.Tuple[int, ...]:
        return tuple(w.shape[0] for w in self.weights) + (self.weights[-1].shape[1],)

    def forward(self, features: Tensor) -> Tensor:
        act = parse_activation(self.activation)
        for li, w in enumerate(self.weights):
            features = features @ w
            if self.biases is not None:
                features = features + self.biases[li]
            if li != len(self.weights) - 1:
                features = act(features)
        return features


class Sequential:
    """Legacy pipeline of callables each called as ``m(input, cell, pbc)``;
    `torchani_tpu_torch.arch.Assembler` is the way to build models."""

    def __init__(self, *modules) -> None:
        warnings.warn(
            "Use of `torchani_tpu_torch.nn.Sequential` is discouraged; please use "
            "`torchani_tpu_torch.arch.Assembler` or compose functions directly."
        )
        self.modules = list(modules)

    def __call__(self, input_, cell=None, pbc=None):
        for m in self.modules:
            input_ = m(input_, cell, pbc)
        return input_


class BmmLinear(torch.nn.Module):
    """Linear layer over a leading member axis: ``(E, N, in) @ (E, in, out)
    + (E, 1, out)``."""

    def __init__(self, weight: Tensor, bias: tp.Optional[Tensor] = None) -> None:
        super().__init__()
        self.weight = torch.nn.Parameter(weight)
        self.bias = None if bias is None else torch.nn.Parameter(bias)

    def forward(self, x: Tensor) -> Tensor:
        out = torch.matmul(x, self.weight)
        if self.bias is not None:
            out = out + self.bias
        return out


class BmmAtomicNetwork(torch.nn.Module):
    """E same-shaped `AtomicNetwork`s evaluated as batched products:
    ``(E, N, in) -> (E, N, out)``."""

    def __init__(self, layers: tp.Sequence[BmmLinear], activation: str = "celu") -> None:
        super().__init__()
        self.layers = torch.nn.ModuleList(layers)
        self.activation = activation

    @classmethod
    def from_networks(cls, networks: tp.Sequence[AtomicNetwork]) -> "BmmAtomicNetwork":
        first = networks[0]
        layers = []
        for li in range(len(first.weights)):
            w = torch.stack([n.weights[li].detach() for n in networks])
            b = None
            if first.biases is not None:
                b = torch.stack([n.biases[li].detach()[None, :] for n in networks])
            layers.append(BmmLinear(w, b))
        return cls(layers, first.activation)

    def forward(self, features: Tensor) -> Tensor:
        act = parse_activation(self.activation)
        for li, layer in enumerate(self.layers):
            features = layer(features)
            if li != len(self.layers) - 1:
                features = act(features)
        return features


def BmmEnsemble(ensemble: Ensemble) -> Ensemble:
    """The fused-ensemble inference container: an `Ensemble` already holds
    its members in stacked tensors and evaluates them as one batched
    product per layer, so it is returned as it is.  Anything else (a single
    `AtomicNetworks` too) raises `TypeError`."""
    if not isinstance(ensemble, Ensemble) or isinstance(ensemble, AtomicNetworks):
        raise TypeError("BmmEnsemble expects an Ensemble")
    return ensemble


def MNPNetworks(container, use_mnp: bool = False):
    """The multi-net-parallel inference container: the per-species networks
    of the port's containers already run as one product per species and
    layer, so the container is returned as it is."""
    return container
