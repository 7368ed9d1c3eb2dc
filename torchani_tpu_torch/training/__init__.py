"""Training stack of the port (counterpart of ``torchani_tpu/training``):
losses, the train step, epochs, checkpoints, schedules and metrics."""

from torchani_tpu_torch.training.checkpoints import (
    load_checkpoint,
    merge_members,
    save_checkpoint,
)
from torchani_tpu_torch.training.metrics import MetricsWriter, read_metrics
from torchani_tpu_torch.training.schedules import ReduceLROnPlateau, adamw_with_plateau
from torchani_tpu_torch.training.loop import (
    EpochRunner,
    TrainState,
    energy_force_loss,
    make_bucketed_train_step,
    make_train_step,
    tune_angular_capacity,
    tune_angular_split,
    tune_species_partition,
)

__all__ = [
    "EpochRunner",
    "MetricsWriter",
    "read_metrics",
    "TrainState",
    "energy_force_loss",
    "make_train_step",
    "make_bucketed_train_step",
    "tune_angular_capacity",
    "tune_angular_split",
    "tune_species_partition",
    "save_checkpoint",
    "load_checkpoint",
    "merge_members",
    "ReduceLROnPlateau",
    "adamw_with_plateau",
]
