"""Learning-rate schedule: reduce on plateau, over AdamW (counterpart of
``torchani_tpu/training/schedules.py``).

An optimizer here is a factory: a callable that takes the parameters to
train and returns a ``torch.optim.Optimizer`` (e.g.
``functools.partial(torch.optim.Adam, lr=1e-3)``); `make_train_step` calls
it on the networks it trains.  `adamw_with_plateau` returns one for
``torch.optim.AdamW`` with optax's ``adamw`` numbers (betas 0.9 and 0.999,
eps 1e-8, the weight decay given, on every parameter; not torch's default
decay of 1e-2) and a host-side plateau controller, which writes its rate
into the optimizer's ``param_groups``.
"""

import functools
import typing as tp

import torch

__all__ = ["ReduceLROnPlateau", "adamw_with_plateau"]

#: a callable from the parameters to train to their optimizer
OptimizerFactory = tp.Callable[[tp.Iterable[torch.Tensor]], torch.optim.Optimizer]


class ReduceLROnPlateau:
    """Host-side plateau controller: call ``update(metric)`` per validation.

    The rate is multiplied by ``factor`` (not below ``min_lr``) once the
    metric has not improved by more than ``threshold`` for more than
    ``patience`` validations.  ``update(metric, optimizer)`` also writes the
    rate into ``optimizer``'s parameter groups."""

    def __init__(
        self,
        initial_lr: float = 1e-3,
        factor: float = 0.5,
        patience: int = 100,
        threshold: float = 0.0,
        min_lr: float = 1e-9,
    ) -> None:
        self.lr = initial_lr
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.best: tp.Optional[float] = None
        self.bad_epochs = 0

    def update(
        self, metric: float, optimizer: tp.Optional[torch.optim.Optimizer] = None
    ) -> float:
        """Record a validation metric; returns the (possibly reduced) rate."""
        if self.best is None or metric < self.best - self.threshold:
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.bad_epochs = 0
        if optimizer is not None:
            for group in optimizer.param_groups:
                group["lr"] = self.lr
        return self.lr


def adamw_with_plateau(
    initial_lr: float = 1e-3, weight_decay: float = 1e-6
) -> tp.Tuple[OptimizerFactory, ReduceLROnPlateau]:
    """An AdamW factory and its plateau controller.

    Usage::

        optimizer, plateau = adamw_with_plateau(1e-3)
        runner = EpochRunner(model, optimizer)
        ...
        plateau.update(val_rmse, state.opt_state)
    """
    optimizer = functools.partial(
        torch.optim.AdamW, lr=initial_lr, betas=(0.9, 0.999), eps=1e-8,
        weight_decay=weight_decay,
    )
    return optimizer, ReduceLROnPlateau(initial_lr)
