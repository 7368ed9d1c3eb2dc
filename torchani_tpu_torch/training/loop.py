"""Training step: energy (and force) loss and a torch optimizer over the
networks (counterpart of ``torchani_tpu/training/loop.py``).

Only the atomic networks train; the AEV constants and self energies stay
frozen.  The energy loss is the MSE of the energies over sqrt(atoms); force
training adds ``force_weight`` times the force MSE per atom, with forces
from `grad.energies_and_forces_for_training` (``create_graph=True``).  One
backward to the networks' parameters then gives the weight gradient: on the
card a force step launches the angular AEV's kernels K3 (forward), K3b (the
forces) and K3bb (the forces' backward) once each, an energy step K3 alone.

A step waits for the device only where the model does (it reads the
present species back); `EpochRunner` keeps the summed loss on the device
and reads it once per epoch.  ``nn_precision`` is accepted for the JAX
package's signature and changes nothing: every product stays f32 (no TF32,
no bf16).
"""

import copy
import dataclasses
import math
import typing as tp

import numpy as np
import torch
import torch.distributed as dist

from torchani_tpu_torch.annotations import Tensor
from torchani_tpu_torch.arch import ANI, as_tensor
from torchani_tpu_torch.grad import energies_and_forces_for_training
from torchani_tpu_torch.md import _shallow_copy, _with_aev_fields
from torchani_tpu_torch.profiling import scope
from torchani_tpu_torch.training.schedules import OptimizerFactory
from torchani_tpu_torch.utils import _host

__all__ = [
    "EpochRunner",
    "TrainState",
    "energy_force_loss",
    "make_train_step",
    "make_bucketed_train_step",
    "tune_angular_capacity",
    "tune_angular_split",
    "tune_species_partition",
]

#: the values of ``nn_precision`` that the JAX package takes
_PRECISIONS = (None, "default", "high", "highest")

Batch = tp.Mapping[str, tp.Any]


@dataclasses.dataclass
class TrainState:
    """The trained networks, their optimizer and the number of steps
    taken.  A step updates the networks and the optimizer in place."""

    networks: torch.nn.Module
    opt_state: torch.optim.Optimizer
    step: int = 0


def _model_with_networks(model: ANI, networks: torch.nn.Module) -> ANI:
    """A model copy that runs ``networks`` (weights shared, the template
    unchanged).  The template's species partition, a static execution
    setting, carries over to ``networks``."""
    nnp = _shallow_copy(model.potentials["nnp"])
    part = getattr(nnp.neural_networks, "partition", None)
    if part is not None and getattr(networks, "partition", None) != part:
        networks.partition = part
    nnp.neural_networks = networks
    potentials = _shallow_copy(model.potentials)
    potentials["nnp"] = nnp
    new = _shallow_copy(model)
    new.potentials = potentials
    return new


def _model_with_angular_capacity(model: ANI, capacity: int) -> ANI:
    return _with_aev_fields(model, angular_capacity=int(capacity))


def _device_batch(batch: Batch, device: torch.device) -> tp.Dict[str, Tensor]:
    """A batch's arrays or (pinned) host tensors on ``device``: species
    int64, every floating key f32 (the JAX package's f32 targets)."""
    out = {}
    for k, v in batch.items():
        if k == "angular_capacity":
            continue
        t = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
        dtype = torch.int64 if k == "species" else (
            torch.float32 if t.is_floating_point() else t.dtype
        )
        out[k] = t.to(device=device, dtype=dtype, non_blocking=True)
    return out


def energy_force_loss(
    model: ANI,
    species: Tensor,
    coords: Tensor,
    target_energies: Tensor,
    target_forces: tp.Optional[Tensor] = None,
    force_weight: float = 0.1,
) -> Tensor:
    """MSE(E) / sqrt(atoms), plus ``force_weight`` times the mean over
    molecules of the squared force error summed over atoms and divided by
    their number.  Inputs go to the model's device."""
    dev = model.device
    elem = model._convert(species)
    num_atoms = torch.sum(elem >= 0, dim=-1).to(torch.float32)
    target_energies = as_tensor(target_energies, torch.float32, dev)
    if target_forces is None:
        energies = model(species, coords)
        return torch.mean((energies - target_energies) ** 2 / torch.sqrt(num_atoms))
    energies, forces = energies_and_forces_for_training(model, species, coords)
    target_forces = as_tensor(target_forces, torch.float32, dev)
    e_loss = torch.mean((energies - target_energies) ** 2 / torch.sqrt(num_atoms))
    f_loss = torch.mean(torch.sum((forces - target_forces) ** 2, dim=(-1, -2)) / num_atoms)
    return e_loss + force_weight * f_loss


def _force_loss_fwdrev(
    model: ANI,
    species: Tensor,
    coords: Tensor,
    target_energies: Tensor,
    target_forces: Tensor,
    force_weight: float,
) -> tp.Tuple[Tensor, Tensor]:
    """The force loss and a scalar whose gradient to the weights is the
    loss's, by the JAX package's reverse-over-forward contraction: with
    ``u = 2 w (F - F*) / (C n)`` held constant, the force term's weight
    gradient is ``-d/dtheta <u, dE/dx>``, so the gradient of
    ``e_loss - <u, dE/dx>`` is the loss's.  (K3 has no forward-mode kernel:
    ``<u, dE/dx>`` is taken from the reverse forces with their graph.)"""
    elem = model._convert(species)
    num_atoms = torch.sum(elem >= 0, dim=-1).to(torch.float32)
    energies, forces = energies_and_forces_for_training(model, species, coords)
    e_loss = torch.mean((energies - target_energies) ** 2 / torch.sqrt(num_atoms))
    f_res = forces - target_forces
    f_loss = torch.mean(torch.sum(f_res**2, dim=(-1, -2)) / num_atoms)
    loss = e_loss + force_weight * f_loss
    u = (2.0 * force_weight * f_res / (coords.shape[0] * num_atoms[:, None, None])).detach()
    # F = -dE/dx, so <u, dE/dx> = -<u, F>
    return loss, e_loss + torch.sum(u * forces)


def _apply_grads(
    opt: torch.optim.Optimizer, params: tp.Sequence[Tensor], grads: tp.Sequence[tp.Optional[Tensor]]
) -> None:
    """One optimizer step with ``grads``; a parameter that the loss does not
    reach (a species absent from the batch) gets a zero gradient, so that
    its moments and weight decay advance as the JAX package's do."""
    for p, g in zip(params, grads):
        p.grad = torch.zeros_like(p) if g is None else g
    opt.step()


def _data_parallel(
    mesh, batch: Batch, loss: Tensor, n: int, params: tp.Sequence[Tensor],
    grads: tp.Sequence[tp.Optional[Tensor]],
) -> tp.Tuple[Tensor, tp.List[Tensor]]:
    """The global loss and weight gradients of a step whose molecules are
    split over the mesh's ``data`` group: the loss's numerator and molecule
    count summed over the group, and each process's gradient weighted by
    its share of the molecules and summed (one all-reduce of every
    gradient).  ``n`` is this process's molecule count."""
    group = mesh.get_group("data")
    if dist.get_world_size(group) > 1 and getattr(batch, "mesh", None) is None:
        raise ValueError(
            "the networks are sharded over a data axis of more than one process: pass "
            "this process's block of the batch (parallel.shard_batch)"
        )
    sums = torch.stack([loss.detach() * n, loss.new_tensor(float(n))])
    dist.all_reduce(sums, group=group)
    flat = torch.cat([
        (torch.zeros_like(p) if g is None else g).reshape(-1) for p, g in zip(params, grads)
    ]) * (n / sums[1])
    dist.all_reduce(flat, group=group)
    pieces = flat.split([p.numel() for p in params])
    return sums[0] / sums[1], [g.reshape(p.shape) for g, p in zip(pieces, params)]


def make_train_step(
    model_template: ANI,
    optimizer: OptimizerFactory,
    force_training: bool = False,
    force_weight: float = 0.1,
    nn_precision: tp.Optional[str] = "high",
    force_grad_mode: str = "revrev",
):
    """``(init_fn, step_fn)`` training functions over the networks.

    ``optimizer`` is a factory (`training.schedules`): ``init_fn(networks=
    None)`` calls it on the networks' parameters; by default the networks
    are a copy of the template's, which stays as it was.  ``step_fn(state,
    batch) -> (state, {"loss": tensor})`` takes a batch dict (``species``,
    ``coordinates``, ``energies`` and, with ``force_training``,
    ``forces``; numpy arrays or tensors), updates ``state`` in place and
    returns it.  ``force_grad_mode``: ``"revrev"`` differentiates the
    force loss through the forces' graph; ``"fwdrev"`` takes the same
    gradient by the JAX package's contraction (`_force_loss_fwdrev`).
    ``nn_precision`` changes nothing (module docs).

    Sharded training (`torchani_tpu_torch.parallel`): where the networks
    come from ``shard_ensemble`` or the batch from ``shard_batch``, each
    process steps on its block of the batch and its members; the loss and
    the gradients are then summed over the mesh's ``data`` group
    (`_data_parallel`), so every process reports the global loss and takes
    the same step.
    """
    if nn_precision not in _PRECISIONS:
        raise ValueError(f"nn_precision must be one of {_PRECISIONS}, got {nn_precision!r}")
    if force_grad_mode not in ("revrev", "fwdrev"):
        raise ValueError(f"Unknown force_grad_mode {force_grad_mode!r}")

    def init_fn(networks: tp.Optional[torch.nn.Module] = None) -> TrainState:
        if networks is None:
            networks = copy.deepcopy(model_template.neural_networks)
        return TrainState(networks, optimizer(list(networks.parameters())), 0)

    def step_fn(state: TrainState, batch: Batch) -> tp.Tuple[TrainState, tp.Dict[str, Tensor]]:
        with scope("train.step"):
            model = _model_with_networks(model_template, state.networks)
            with scope("train.batch"):
                b = _device_batch(batch, model.device)
            params = list(state.networks.parameters())
            if force_training and force_grad_mode == "fwdrev":
                loss, surrogate = _force_loss_fwdrev(
                    model, b["species"], b["coordinates"], b["energies"], b["forces"], force_weight
                )
            else:
                loss = surrogate = energy_force_loss(
                    model, b["species"], b["coordinates"], b["energies"],
                    b["forces"] if force_training else None, force_weight=force_weight,
                )
            with scope("train.backward"):
                grads = torch.autograd.grad(surrogate, params, allow_unused=True)
            mesh = getattr(state.networks, "mesh", None)
            if mesh is None:
                mesh = getattr(batch, "mesh", None)
            if mesh is not None:
                n = b["species"].shape[0]
                loss, grads = _data_parallel(mesh, batch, loss, n, params, grads)
            with scope("train.optimizer"):
                _apply_grads(state.opt_state, params, grads)
            state.step += 1
            return state, {"loss": loss.detach()}

    return init_fn, step_fn


def make_bucketed_train_step(
    model_template: ANI,
    optimizer: OptimizerFactory,
    force_training: bool = False,
    force_weight: float = 0.1,
):
    """`make_train_step` honoring each batch's ``angular_capacity`` (set by
    ``Batcher.gather_batches(density_cutoff=...)``): the batch runs on a
    model whose AEV computer has that capacity, so a calm batch's angular
    table is narrower.  Batches without the key run the template's."""
    cache: tp.Dict[tp.Optional[int], tp.Callable] = {}

    def get_step(capacity: tp.Optional[int]):
        if capacity not in cache:
            model = (
                model_template
                if capacity is None
                else _model_with_angular_capacity(model_template, capacity)
            )
            cache[capacity] = make_train_step(model, optimizer, force_training, force_weight)[1]
        return cache[capacity]

    init_fn, _ = make_train_step(model_template, optimizer, force_training, force_weight)

    def step_fn(state: TrainState, batch: Batch):
        cap = batch.get("angular_capacity")
        return get_step(None if cap is None else int(cap))(state, batch)

    return init_fn, step_fn


class EpochRunner:
    """Epoch driver: consecutive batches of one shape and one
    ``angular_capacity`` run as a group of up to ``chunk`` steps on the
    model of that capacity; the summed loss stays on the device and is read
    once per epoch (`fetches` counts those reads), and so is the
    validation's squared error.  The JAX package runs each group as one
    compiled scan; here the group's batches go to the device together
    (asynchronously from pinned memory, see `BatchedDataset.cache`) and
    the steps run one after the other.
    """

    def __init__(
        self,
        model_template: ANI,
        optimizer: OptimizerFactory,
        force_training: bool = False,
        force_weight: float = 0.1,
        nn_precision: tp.Optional[str] = "high",
        chunk: int = 50,
    ) -> None:
        self._template = model_template
        self._optimizer = optimizer
        self._force_training = force_training
        self._force_weight = force_weight
        self._nn_precision = nn_precision
        self._chunk = int(chunk)
        self._steps: tp.Dict[tp.Optional[int], tp.Callable] = {}
        self._models: tp.Dict[tp.Optional[int], ANI] = {}
        self.fetches = 0
        self.init, _ = make_train_step(
            model_template, optimizer, force_training, force_weight, nn_precision
        )

    @staticmethod
    def _shape_key(batch: Batch) -> tp.Tuple:
        return tuple(sorted(
            (k, tuple(np.shape(v)), str(getattr(v, "dtype", None)))
            for k, v in batch.items() if k != "angular_capacity"
        ))

    def _group(self, batches: tp.Iterable[Batch]):
        """Yield (capacity, [batches]) runs of one shape and capacity, at
        most ``chunk`` long."""
        cur_key, cur = None, []
        for b in batches:
            cap = int(b["angular_capacity"]) if "angular_capacity" in b else None
            key = (cap, self._shape_key(b))
            if key != cur_key or len(cur) == self._chunk:
                if cur:
                    yield cur_key[0], cur
                cur_key, cur = key, []
            cur.append(b)
        if cur:
            yield cur_key[0], cur

    def _model_for(self, capacity: tp.Optional[int]) -> ANI:
        if capacity not in self._models:
            self._models[capacity] = (
                self._template
                if capacity is None
                else _model_with_angular_capacity(self._template, capacity)
            )
        return self._models[capacity]

    def _step_for(self, capacity: tp.Optional[int]) -> tp.Callable:
        if capacity not in self._steps:
            self._steps[capacity] = make_train_step(
                self._model_for(capacity), self._optimizer, self._force_training,
                self._force_weight, self._nn_precision,
            )[1]
        return self._steps[capacity]

    def epoch(
        self, state: TrainState, batches: tp.Iterable[Batch]
    ) -> tp.Tuple[TrainState, tp.Dict[str, float]]:
        """One epoch; returns ``(state, {"loss": mean, "steps": n})``.
        ``batches`` may be any iterable of batch dicts (e.g.
        ``divisions["training"].shuffled(seed=epoch)``)."""
        dev = self._template.device
        total, n = None, 0
        for cap, group in self._group(batches):
            step = self._step_for(cap)
            on_device = [_device_batch(b, dev) for b in group]
            for b in on_device:
                state, m = step(state, b)
                total = m["loss"] if total is None else total + m["loss"]
            n += len(group)
        if n == 0:
            return state, {"loss": float("nan"), "steps": 0}
        self.fetches += 1
        return state, {"loss": float(total) / n, "steps": n}

    def validate(self, state: TrainState, batches: tp.Iterable[Batch]) -> float:
        """Energy RMSE (Ha) over ``batches`` (every molecule row of a batch
        counts, as in the JAX package), read from the device once."""
        dev = self._template.device
        total, count = None, 0
        with torch.no_grad():
            for cap, group in self._group(batches):
                model = _model_with_networks(self._model_for(cap), state.networks)
                for b in group:
                    b = _device_batch(b, dev)
                    err = model(b["species"], b["coordinates"]) - b["energies"]
                    sq = torch.sum(err * err)
                    total = sq if total is None else total + sq
                    count += err.shape[0]
        if count == 0:
            return float("nan")
        self.fetches += 1
        return math.sqrt(float(total) / count)


def _max_neighbor_counts(species: np.ndarray, coords: np.ndarray, cutoff: float):
    """Per molecule of a host batch: its real atoms' within-cutoff neighbor
    counts (None for a molecule of fewer than 2 atoms)."""
    for m in range(species.shape[0]):
        real = species[m] >= 0
        n = int(real.sum())
        if n < 2:
            yield m, None
            continue
        pos = coords[m][real][:n]
        d = np.linalg.norm(pos[:, None] - pos[None, :], axis=-1)
        np.fill_diagonal(d, np.inf)
        yield m, (d < cutoff).sum(axis=1)


def tune_angular_capacity(
    model: ANI,
    batches: tp.Iterable[Batch],
    margin: float = 1.15,
    extra: int = 2,
    max_batches: int = 8,
) -> ANI:
    """A model copy whose AEV angular capacity fits the data: the largest
    within-angular-cutoff neighbor count over the first ``max_batches``
    batches (host numpy), times ``margin`` plus ``extra``, rounded up to a
    multiple of 4 and at least 8 (the JAX package's rule).  A row over the
    capacity at run time poisons the outputs with NaN."""
    r_ang = float(model.aev_computer.angular.cutoff)
    max_count = 0
    for bi, batch in enumerate(batches):
        if bi >= max_batches:
            break
        for _, counts in _max_neighbor_counts(
            _host(batch["species"]), _host(batch["coordinates"]), r_ang
        ):
            if counts is not None:
                max_count = max(max_count, int(counts.max()))
    cap = int(-(-int(max_count * margin + extra) // 4) * 4)
    return _model_with_angular_capacity(model, max(cap, 8))


def tune_angular_split(
    model: ANI,
    batches: tp.Iterable[Batch],
    margin: float = 1.3,
    max_batches: int = 8,
    tail_margin: tp.Optional[float] = None,
) -> ANI:
    """A model copy with the count-class angular split measured on the data,
    by the JAX package's cost rule (its ``tune_angular_split``): per-row
    angular counts of the first ``max_batches`` batches, the ``(k_small,
    n_dense)`` pair that minimises the estimated pair work with a
    ``margin`` on the dense rows, and a third entry ``n_rows`` (headroom
    ``tail_margin``, by default a quarter of ``margin``'s excess, at least
    1.05) where padding rows can be skipped.  Needs an explicit
    ``angular_capacity``; the model is returned as it is when the estimated
    saving is under 15%.  The split runs on the plain angular path only
    (the kernel path ignores it, as `AEVComputer` documents)."""
    aevc = model.aev_computer
    cap = aevc.angular_capacity
    if aevc.angular_split is not None or cap is None or cap < 10:
        return model
    r_ang = float(aevc.angular.cutoff)
    per_batch_counts = []
    rows = 0
    for bi, batch in enumerate(batches):
        if bi >= max_batches:
            break
        species = _host(batch["species"])
        nmol, matoms = species.shape
        counts = np.zeros(nmol * matoms, np.int64)
        for m, c in _max_neighbor_counts(species, _host(batch["coordinates"]), r_ang):
            if c is not None:
                counts[m * matoms: m * matoms + c.shape[0]] = c
        per_batch_counts.append(np.minimum(counts, cap))
        rows = max(rows, nmol * matoms)
    if not per_batch_counts or rows == 0:
        return model
    kp = lambda k_: k_ * max(k_ - 1, 0) / 2.0  # noqa: E731
    base = rows * kp(cap)
    if tail_margin is None:
        tail_margin = max(1.05, 1.0 + (margin - 1.0) * 0.25)
    nonzero = max(int((c > 0).sum()) for c in per_batch_counts)
    n_rows = min(rows, int(-(-int(nonzero * tail_margin + 64) // 64) * 64))
    best = None
    # k_small == cap is the pure row-skip policy (no lane slicing)
    for k_small in list(range(6, cap - 1, 2)) + [cap]:
        over = max(int((c > k_small).sum()) for c in per_batch_counts)
        n_dense = int(-(-int(over * margin + 64) // 64) * 64)
        if n_dense >= n_rows:
            continue
        cost = n_dense * kp(cap) + (n_rows - n_dense) * kp(k_small)
        if best is None or cost < best[0]:
            best = (cost, k_small, n_dense)
    if best is None or best[0] > 0.85 * base:
        return model
    _, k_small, n_dense = best
    split = (k_small, n_dense, n_rows) if n_rows < rows else (k_small, n_dense)
    return _with_aev_fields(model, angular_split=split)


def tune_species_partition(
    model: ANI,
    batches: tp.Iterable[Batch],
    margin: float = 1.2,
    quantum: int = 256,
    max_batches: int = 16,
) -> ANI:
    """A model copy whose networks evaluate in species blocks sized to the
    data (`nn.partition.measure_caps` over the first ``max_batches``
    batches' element indices); the model as it is where
    `nn.partition.supports` refuses the shape.  A species over its budget
    at run time poisons the energies with NaN."""
    from torchani_tpu_torch.nn.partition import measure_caps, supports

    networks = model.neural_networks
    rows = 0
    species_iter = []
    for bi, batch in enumerate(batches):
        if bi >= max_batches:
            break
        arr = model._convert(batch["species"]).cpu().numpy()
        rows = max(rows, arr.size)
        species_iter.append(arr)
    caps = measure_caps(species_iter, networks.num_species, margin=margin, quantum=quantum)
    if not supports(networks.num_species, rows):
        return model
    blocked = _shallow_copy(networks)
    blocked.partition = caps
    return _model_with_networks(model, blocked)
