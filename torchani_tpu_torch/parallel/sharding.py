"""Process meshes and sharding for data- and ensemble-parallel training
(counterpart of ``torchani_tpu/parallel/sharding.py``).

The JAX package places arrays on a ``(data, model)`` device mesh and lets
GSPMD insert the collectives.  Here each process of a ``torch.distributed``
group is one cell of a ``(data, model)`` `DeviceMesh`, and the collectives
are explicit:

- ``data``: the molecules of a batch.  `shard_batch` gives a process its
  contiguous block; the training step (`training.make_train_step`) then sums
  the loss's numerator and molecule count and all-reduces the weight
  gradients over the ``data`` group.
- ``model``: the members of an `Ensemble`, whose ``(E, S, in, out)`` stacks
  split along E.  `shard_ensemble` keeps a process's ``E / n_model`` members
  (`ShardedEnsemble`); their mean is a sum over the ``model`` group inside
  the autograd graph, differentiable to any order (force training
  differentiates twice).
"""

import typing as tp

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from torchani_tpu_torch.annotations import Tensor
from torchani_tpu_torch.nn.containers import AtomicNetworks, Ensemble, SpeciesRanges

__all__ = ["make_mesh", "shard_batch", "shard_ensemble"]


class _ReduceFrom(torch.autograd.Function):
    """Sum of per-process partial values over ``group`` (forward).  The sum
    is replicated, so its cotangent goes back to each part as it is."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return _CopyTo.apply(grad, ctx.group), None


class _CopyTo(torch.autograd.Function):
    """A replicated value used by every process of ``group`` (forward:
    itself).  Its cotangent is the sum of the processes' (`_ReduceFrom`)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _ReduceFrom.apply(grad, ctx.group), None


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This process's device on ``mesh``: its current CUDA device, or the
    CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def make_mesh(
    n_data: tp.Optional[int] = None,
    n_model: int = 1,
    device_type: str = "cuda",
) -> DeviceMesh:
    """A ``(data, model)`` mesh over the initialized default process group:
    rank ``d * n_model + m`` holds data block ``d`` and member block ``m``.
    ``device_type`` ``"cpu"`` for processes without a card (gloo)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed.init_process_group first")
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"mesh {n_data}x{n_model} does not cover {world} processes")
    return init_device_mesh(device_type, (n_data, n_model), mesh_dim_names=("data", "model"))


class ShardedBatch(dict):
    """A process's block of a batch (`shard_batch`); ``mesh`` names the
    ``data`` group that holds the other blocks."""

    def __init__(self, arrays: tp.Mapping[str, Tensor], mesh: DeviceMesh) -> None:
        super().__init__(arrays)
        self.mesh = mesh


def shard_batch(batch: tp.Mapping[str, tp.Any], mesh: DeviceMesh) -> ShardedBatch:
    """This process's contiguous block of every array along its leading
    (molecule) axis, on its device.  Raises where an axis does not divide by
    the ``data`` size, as the JAX package's placement does."""
    n = mesh.size(mesh.mesh_dim_names.index("data"))
    i = mesh.get_local_rank("data")
    dev = mesh_device(mesh)
    out = {}
    for k, v in batch.items():
        t = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
        if t.dim() == 0 or t.shape[0] % n:
            raise ValueError(
                f"shard_batch: {k!r} of shape {tuple(t.shape)} does not split into {n} blocks"
            )
        m = t.shape[0] // n
        out[k] = t[i * m:(i + 1) * m].to(dev)
    return ShardedBatch(out, mesh)


class ShardedEnsemble(Ensemble):
    """The members ``[m * E_l, (m + 1) * E_l)`` of an E-member `Ensemble`
    (`shard_ensemble`), where ``m`` is this process's place on the mesh's
    ``model`` axis and ``E_l = E / n_model``.  Its forward gives the mean
    over all E members: each process sums its own, `_ReduceFrom` sums over
    the ``model`` group, and the AEVs enter through `_CopyTo` so that their
    gradient is the whole ensemble's (both differentiable to any order)."""

    def __init__(self, weights, biases, layer_dims, symbols, activation, partition,
                 mesh: DeviceMesh, total_members: int) -> None:
        super().__init__(weights, biases, layer_dims, symbols, activation, partition)
        self.mesh = mesh
        self.group = mesh.get_group("model")
        self.members = int(total_members)

    @property
    def total_members_num(self) -> int:
        return self.members

    def forward(
        self,
        elem_idxs: Tensor,
        aevs: Tensor,
        atomic: bool = False,
        ensemble_values: bool = False,
        species_ranges: tp.Optional[SpeciesRanges] = None,
    ) -> Tensor:
        if ensemble_values:
            raise ValueError("a member-sharded ensemble gives the members' mean only")
        scalars = self.member_values(elem_idxs, _CopyTo.apply(aevs, self.group), species_ranges)
        if self.out_dim == 1:
            scalars = scalars[..., 0]
        local = torch.sum(scalars, dim=0)
        if not atomic:
            local = torch.sum(local, dim=-1)
        return _ReduceFrom.apply(local, self.group) / self.members


def shard_ensemble(networks: torch.nn.Module, mesh: DeviceMesh) -> torch.nn.Module:
    """An `Ensemble` split along its members over the mesh's ``model`` axis
    (`ShardedEnsemble`, copies of this process's members on its device); any
    other container stays whole, on the process's device (replicated)."""
    dev = mesh_device(mesh)
    if not isinstance(networks, Ensemble) or isinstance(networks, AtomicNetworks):
        return networks.to(dev)
    n = mesh.size(mesh.mesh_dim_names.index("model"))
    m = mesh.get_local_rank("model")
    e = networks.total_members_num
    if e % n:
        raise ValueError(f"shard_ensemble: {e} members do not split over {n} processes")
    lo, hi = m * (e // n), (m + 1) * (e // n)
    weights, biases = networks._stacks()
    take = lambda ts: [t[lo:hi].detach().clone().to(dev) for t in ts]  # noqa: E731
    return ShardedEnsemble(
        take(weights), None if biases is None else take(biases), networks.layer_dims,
        networks.symbols, networks.activation, networks.partition, mesh, e,
    )
