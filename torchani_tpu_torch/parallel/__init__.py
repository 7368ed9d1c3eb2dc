"""Multi-process execution over ``torch.distributed``: atom-sharded MD
(`ShardedMolecularDynamics`) and data- and ensemble-parallel training
(`make_mesh`, `shard_batch`, `shard_ensemble`); the counterpart of
``torchani_tpu/parallel``."""

from torchani_tpu_torch.parallel.md import ShardedMolecularDynamics
from torchani_tpu_torch.parallel.sharding import (
    make_mesh,
    shard_batch,
    shard_ensemble,
)

__all__ = [
    "ShardedMolecularDynamics",
    "make_mesh",
    "shard_batch",
    "shard_ensemble",
]
