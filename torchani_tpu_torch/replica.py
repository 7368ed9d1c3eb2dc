"""Replica-exchange (parallel-tempering) MD over a temperature ladder
(counterpart of ``torchani_tpu/replica.py``).

R replicas of an A-atom system are one ``(R, A)`` batch through the model, so
each Langevin (BAOAB) step makes one energy-and-forces evaluation.  Between
segments an even/odd sweep proposes to swap the configurations of
temperature-adjacent replicas, accepted with ``min(1, exp((beta_i - beta_j)
(E_i - E_j)))``; velocities are rescaled by ``sqrt(T_new / T_old)``.  The sweep
runs on the device and the swap counters stay device tensors: nothing waits
for the device until `ReplicaExchange.acceptance_rate` reads them.

Designed for small and medium systems (the model's own neighbor list every
step); for large boxes `MolecularDynamics`' Verlet cache is the tool.  The
Langevin noise and the swaps' uniforms are drawn from the state's
`torch.Generator`, on the generator's device, and moved to the model's: a CPU
generator gives the card and the CPU the same draws.
"""

import dataclasses
import math
import typing as tp

import numpy as np
import torch

from torchani_tpu_torch.annotations import DeviceArg, Tensor
from torchani_tpu_torch.arch import as_tensor
from torchani_tpu_torch.md import ACCEL_UNIT, KB_HARTREE, maxwell_boltzmann_velocities
from torchani_tpu_torch.utils import get_atomic_masses, resolve_device

__all__ = ["ReplicaExchange", "ReplicaState"]


@dataclasses.dataclass(frozen=True)
class ReplicaState:
    """Per-replica dynamic state (tensors carry a leading replica axis)."""

    coords: Tensor  # (R, A, 3)
    velocities: Tensor  # (R, A, 3)
    forces: Tensor  # (R, A, 3)
    energy: Tensor  # (R,)
    generator: torch.Generator  # the noise's and the uniforms' source
    step: int = 0  # MD steps taken per replica
    swaps_attempted: tp.Optional[Tensor] = None  # () int32, pair attempts over all sweeps
    swaps_accepted: tp.Optional[Tensor] = None  # () int32
    segment: int = 0  # sweeps done (the even/odd pairing alternates)

    def replace(self, **changes) -> "ReplicaState":
        return dataclasses.replace(self, **changes)


class ReplicaExchange:
    """Parallel tempering: batched Langevin steps and swap sweeps on
    the model's device (CUDA unless ``device="cpu"`` with a CPU model).

    Args:
        model: an ANI-family model (called as ``model(species, coords, cell,
            pbc)``)
        species: atomic numbers, ``(A,)`` or ``(1, A)`` (one molecule, the
            same in every replica); element indices for a model with
            ``periodic_table_index=False`` (the masses then come through its
            `atomic_numbers_of`)
        temperatures: the ladder, one per replica (ascending recommended)
        timestep_fs: Langevin timestep
        friction_per_fs: BAOAB friction
        cell, pbc: optional periodic box
    """

    def __init__(
        self,
        model,
        species,
        temperatures: tp.Sequence[float],
        timestep_fs: float = 0.5,
        friction_per_fs: float = 0.02,
        cell=None,
        pbc=None,
        device: DeviceArg = None,
    ) -> None:
        dev = resolve_device(device)
        if model.device.type != dev.type:
            raise ValueError(f"the model is on {model.device}, ReplicaExchange was asked for {dev}")
        self.device = dev = model.device
        znums = np.asarray(
            species.cpu() if isinstance(species, torch.Tensor) else species
        ).reshape(-1)
        temps = np.asarray(temperatures, np.float32).reshape(-1)
        self.n_replicas = temps.shape[0]
        if self.n_replicas < 2:
            raise ValueError("replica exchange needs >= 2 replicas")
        self._host_temperatures = temps
        self.temperatures = torch.as_tensor(temps, device=dev)
        self.betas = 1.0 / (KB_HARTREE * self.temperatures)
        self.model = model
        self.species = torch.as_tensor(np.tile(znums, (self.n_replicas, 1)), device=dev)
        to_znums = getattr(model, "atomic_numbers_of", None)
        znums_t = self.species[0] if to_znums is None else to_znums(self.species[0])
        self.masses = get_atomic_masses(znums_t)
        self.dt = float(timestep_fs)
        self.friction = float(friction_per_fs)
        self.cell = None if cell is None else as_tensor(cell, torch.float32, dev)
        self.pbc = None if pbc is None else as_tensor(pbc, torch.bool, dev)

    # ---- draws ----
    def _draw(self, gen: torch.Generator, shape: tp.Tuple[int, ...], normal: bool) -> Tensor:
        """Standard normal or uniform [0, 1) draws on ``gen``'s device, on the
        model's device.  From the host they go through pinned memory without
        a wait for the device."""
        draw = torch.randn if normal else torch.rand
        x = draw(shape, generator=gen, device=gen.device, dtype=torch.float32)
        if x.device.type == self.device.type:
            return x
        if x.device.type == "cpu":
            return x.pin_memory().to(self.device, non_blocking=True)
        return x.to(self.device)

    # ---- energetics ----
    def _energy_and_forces(self, coords: Tensor) -> tp.Tuple[Tensor, Tensor]:
        c = coords.detach().requires_grad_(True)
        with torch.enable_grad():
            e = self.model(self.species, c, self.cell, self.pbc)
            (g,) = torch.autograd.grad(e.sum(), c)
        return e.detach(), -g

    # ---- dynamics ----
    def init(self, coords, generator: tp.Optional[torch.Generator] = None) -> ReplicaState:
        """The initial state.  ``coords`` is ``(A, 3)`` (replicated) or ``(R, A,
        3)``; velocities are Maxwell-Boltzmann at each replica's temperature,
        drawn from ``generator`` (a CPU generator seeded with 0 by default),
        which the state keeps for the noise and the uniforms."""
        coords = as_tensor(coords, torch.float32, self.device)
        if coords.dim() == 2:
            coords = coords[None].expand(self.n_replicas, -1, -1).contiguous()
        if coords.shape[0] != self.n_replicas:
            raise ValueError(f"expected {self.n_replicas} replicas, got {coords.shape[0]}")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        v = torch.stack([
            maxwell_boltzmann_velocities(generator, self.masses, float(t))
            for t in self._host_temperatures
        ])
        e, f = self._energy_and_forces(coords)
        zero = torch.zeros((), dtype=torch.int32, device=self.device)
        return ReplicaState(
            coords=coords, velocities=v, forces=f, energy=e, generator=generator,
            swaps_attempted=zero, swaps_accepted=zero.clone(),
        )

    def _step_langevin(self, st: ReplicaState, noise: tp.Optional[Tensor] = None) -> ReplicaState:
        """One BAOAB step of every replica at its own temperature; ``noise``
        ``(R, A, 3)`` (standard normal) is drawn from the state's generator
        unless given."""
        dt = self.dt
        inv_m = (ACCEL_UNIT / self.masses)[None, :, None]
        with torch.no_grad():
            v = st.velocities + 0.5 * dt * st.forces * inv_m
            coords = st.coords + 0.5 * dt * v
            c1 = math.exp(-self.friction * dt)
            sigma = torch.sqrt(
                (1 - c1**2) * KB_HARTREE * self.temperatures[:, None, None]
                / self.masses[None, :, None]
            ) * math.sqrt(ACCEL_UNIT)
            if noise is None:
                noise = self._draw(st.generator, tuple(v.shape), normal=True)
            v = c1 * v + sigma * noise
            coords = coords + 0.5 * dt * v
        e, f = self._energy_and_forces(coords)
        with torch.no_grad():
            v = v + 0.5 * dt * f * inv_m
        return st.replace(coords=coords, velocities=v, forces=f, energy=e, step=st.step + 1)

    # ---- swap move ----
    def _swap(self, st: ReplicaState, u: tp.Optional[Tensor] = None) -> ReplicaState:
        """One even/odd swap sweep; ``u`` ``(R,)`` (uniform in [0, 1)) is
        drawn from the state's generator unless given.  Both members of a
        pair read the pair's lower replica's uniform, so they agree."""
        r = self.n_replicas
        idx = torch.arange(r, device=self.device)
        up = (idx - st.segment % 2) % 2 == 0
        partner = torch.where(up, idx + 1, idx - 1)
        valid = (partner >= 0) & (partner < r)
        partner = torch.clamp(partner, 0, r - 1)
        delta = (self.betas - self.betas[partner]) * (st.energy - st.energy[partner])
        if u is None:
            u = self._draw(st.generator, (r,), normal=False)
        accept = valid & (u[torch.minimum(idx, partner)] < torch.exp(torch.clamp(delta, max=0.0)))
        perm = torch.where(accept, partner, idx)
        vel_scale = torch.sqrt(self.temperatures / self.temperatures[perm])
        n_pairs = torch.sum(valid, dtype=torch.int32) // 2
        n_acc = torch.sum(accept & (partner > idx), dtype=torch.int32)
        return st.replace(
            coords=st.coords[perm],
            velocities=st.velocities[perm] * vel_scale[:, None, None],
            forces=st.forces[perm],
            energy=st.energy[perm],
            swaps_attempted=st.swaps_attempted + n_pairs,
            swaps_accepted=st.swaps_accepted + n_acc,
            segment=st.segment + 1,
        )

    # ---- runner ----
    def run(self, state: ReplicaState, segments: int, steps_per_segment: int = 50) -> ReplicaState:
        """``segments`` times: ``steps_per_segment`` Langevin steps, then one
        swap sweep."""
        for _ in range(segments):
            for _ in range(steps_per_segment):
                state = self._step_langevin(state)
            state = self._swap(state)
        return state

    def acceptance_rate(self, state: ReplicaState) -> float:
        """Accepted over attempted swaps (0 before any attempt); reads both
        counters from the device in one copy."""
        att, acc = torch.stack((state.swaps_attempted, state.swaps_accepted)).tolist()
        return acc / att if att else 0.0
