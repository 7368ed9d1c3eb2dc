"""Geometry optimization with FIRE, the Fast Inertial Relaxation Engine
(counterpart of ``torchani_tpu/optimize.py``).

``energy_fn`` maps a coordinate tensor to energies; the forces are
`torch.autograd.grad` of the summed energy, so a batch of independent
conformers gets each conformer's own forces from one backward.  The FIRE
schedule (``dt``, ``alpha``, ``n_pos``) and ``fmax`` stay f32/int32 tensors on
the coordinates' device, rounded as the JAX package rounds them: the one wait
for the device an iteration makes is the loop's condition, where the JAX
package's ``while_loop`` tests its ``cond``.
"""

import dataclasses
import typing as tp

import torch

from torchani_tpu_torch.annotations import DeviceArg, Tensor
from torchani_tpu_torch.arch import as_tensor
from torchani_tpu_torch.utils import tensor_on

__all__ = ["FireState", "minimize_fire", "minimize_fire_batched"]


@dataclasses.dataclass(frozen=True)
class FireState:
    """A FIRE state; in `minimize_fire_batched` every field but ``step``
    has a leading conformer axis."""

    coords: Tensor  # (A, 3)
    velocities: Tensor
    forces: Tensor
    energy: Tensor
    dt: Tensor  # f32
    alpha: Tensor  # f32
    n_pos: Tensor  # int32
    step: int
    fmax: Tensor

    def replace(self, **changes) -> "FireState":
        return dataclasses.replace(self, **changes)


def _energy_and_forces(
    energy_fn: tp.Callable[[Tensor], Tensor], coords: Tensor
) -> tp.Tuple[Tensor, Tensor]:
    """``energy_fn(coords)`` and the forces ``-d(sum E)/d coords``."""
    c = coords.detach().requires_grad_(True)
    with torch.enable_grad():
        e = energy_fn(c)
        (g,) = torch.autograd.grad(e.sum(), c)
    return e.detach(), -g


def _fire_schedule(
    power: Tensor,
    dt: Tensor,
    alpha: Tensor,
    n_pos: Tensor,
    n_min: int,
    f_inc: float,
    f_dec: float,
    dt_max: float,
    alpha_start: float,
    f_alpha: float,
) -> tp.Tuple[Tensor, Tensor, Tensor, Tensor]:
    """FIRE's schedule for one iteration, per system: ``(uphill, dt, alpha,
    n_pos)`` from the power ``F . v`` and the previous schedule."""
    uphill = power <= 0
    n_pos = torch.where(uphill, 0, n_pos + 1)
    grow = (~uphill) & (n_pos > n_min)
    new_dt = torch.where(
        grow, torch.clamp(dt * f_inc, max=dt_max), torch.where(uphill, dt * f_dec, dt)
    )
    alpha = torch.where(grow, alpha * f_alpha, torch.where(uphill, alpha_start, alpha))
    return uphill, new_dt, alpha, n_pos


def _fire_move(
    x: Tensor, v: Tensor, f: Tensor, dt: Tensor, alpha: Tensor, n_pos: Tensor, **schedule
) -> tp.Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """One FIRE move of a whole system (one schedule for all of ``x``):
    ``(new x, v, dt, alpha, n_pos)``."""
    f_norm = torch.sqrt(torch.sum(f * f)) + 1e-30
    v_mixed = (1 - alpha) * v + alpha * torch.sqrt(torch.sum(v * v)) * f / f_norm
    uphill, dt, alpha, n_pos = _fire_schedule(torch.sum(f * v), dt, alpha, n_pos, **schedule)
    v = torch.where(uphill, 0.0, v_mixed) + dt * f
    return x + dt * v, v, dt, alpha, n_pos


def minimize_fire(
    energy_fn: tp.Callable[[Tensor], Tensor],  # (A, 3) -> scalar energy
    coords,
    max_steps: int = 500,
    fmax: float = 0.02,  # Hartree/Angstrom convergence threshold
    dt_start: float = 0.1,
    dt_max: float = 1.0,
    n_min: int = 5,
    f_inc: float = 1.1,
    f_dec: float = 0.5,
    alpha_start: float = 0.1,
    f_alpha: float = 0.99,
    device: DeviceArg = None,
) -> FireState:
    """Minimize ``energy_fn`` with FIRE until ``max|F| <= fmax`` or
    ``max_steps`` iterations.  ``coords`` ``(A, 3)`` (or ``(1, A, 3)``)
    keeps its device if it is a tensor; other input goes to CUDA unless
    ``device="cpu"``."""
    coords = tensor_on(coords, torch.float32, device)
    if coords.dim() == 3:
        coords = coords[0]
    e0, f0 = _energy_and_forces(energy_fn, coords)
    st = FireState(
        coords=coords,
        velocities=torch.zeros_like(coords),
        forces=f0,
        energy=e0,
        dt=coords.new_tensor(dt_start),
        alpha=coords.new_tensor(alpha_start),
        n_pos=torch.zeros((), dtype=torch.int32, device=coords.device),
        step=0,
        fmax=torch.amax(torch.abs(f0)),
    )
    schedule = dict(n_min=n_min, f_inc=f_inc, f_dec=f_dec, dt_max=dt_max,
                    alpha_start=alpha_start, f_alpha=f_alpha)
    while st.step < max_steps and bool(st.fmax > fmax):
        x, v, dt, alpha, n_pos = _fire_move(
            st.coords, st.velocities, st.forces, st.dt, st.alpha, st.n_pos, **schedule
        )
        e, f = _energy_and_forces(energy_fn, x)
        st = FireState(
            coords=x, velocities=v, forces=f, energy=e, dt=dt, alpha=alpha, n_pos=n_pos,
            step=st.step + 1, fmax=torch.amax(torch.abs(f)),
        )
    return st


def minimize_fire_batched(
    energy_fn: tp.Callable[[Tensor], Tensor],  # (C, A, 3) -> (C,) energies
    coords,  # (C, A, 3)
    atom_mask=None,  # (C, A) bool, True = real atom
    max_steps: int = 500,
    fmax: float = 0.02,
    dt_start: float = 0.1,
    dt_max: float = 1.0,
    n_min: int = 5,
    f_inc: float = 1.1,
    f_dec: float = 0.5,
    alpha_start: float = 0.1,
    f_alpha: float = 0.99,
    device: DeviceArg = None,
) -> FireState:
    """Relax a conformer batch, each conformer on its own FIRE schedule.

    ``dt``, ``alpha``, ``n_pos`` and ``fmax`` are ``(C,)``.  A conformer that
    reaches ``fmax`` is frozen: its coordinates, forces, energy and schedule
    stay as they were and its velocities are zero, while the others go on;
    the loop ends when every conformer has converged or after ``max_steps``
    iterations.  ``atom_mask`` zeroes the forces on padding atoms.
    ``state.fmax <= fmax`` tells which conformers converged.
    """
    coords = tensor_on(coords, torch.float32, device)
    if coords.dim() != 3:
        raise ValueError(f"expected coordinates (conformers, atoms, 3), got {tuple(coords.shape)}")
    if atom_mask is None:
        maskf = torch.ones(coords.shape[:2] + (1,), dtype=coords.dtype, device=coords.device)
    else:
        maskf = as_tensor(atom_mask, torch.bool, coords.device)[..., None].to(coords.dtype)

    def energy_and_masked_forces(x: Tensor) -> tp.Tuple[Tensor, Tensor]:
        e, f = _energy_and_forces(energy_fn, x)
        return e, f * maskf

    e0, f0 = energy_and_masked_forces(coords)
    c = coords.shape[0]
    st = FireState(
        coords=coords,
        velocities=torch.zeros_like(coords),
        forces=f0,
        energy=e0,
        dt=coords.new_full((c,), dt_start),
        alpha=coords.new_full((c,), alpha_start),
        n_pos=torch.zeros((c,), dtype=torch.int32, device=coords.device),
        step=0,
        fmax=torch.amax(torch.abs(f0), dim=(1, 2)),
    )
    schedule = dict(n_min=n_min, f_inc=f_inc, f_dec=f_dec, dt_max=dt_max,
                    alpha_start=alpha_start, f_alpha=f_alpha)
    while st.step < max_steps and bool(torch.any(st.fmax > fmax)):
        active = st.fmax > fmax
        v, f = st.velocities, st.forces
        f_norm = torch.sqrt(torch.sum(f * f, dim=(1, 2))) + 1e-30
        mix = (torch.sqrt(torch.sum(v * v, dim=(1, 2))) / f_norm)[:, None, None]
        a3 = st.alpha[:, None, None]
        v_mixed = (1 - a3) * v + a3 * mix * f
        uphill, dt, alpha, n_pos = _fire_schedule(
            torch.sum(f * v, dim=(1, 2)), st.dt, st.alpha, st.n_pos, **schedule
        )
        v = torch.where(uphill[:, None, None], 0.0, v_mixed)
        v = (v + dt[:, None, None] * f) * active[:, None, None]
        x = st.coords + dt[:, None, None] * v
        e, f = energy_and_masked_forces(x)
        keep = ~active
        keep3 = keep[:, None, None]
        st = FireState(
            coords=torch.where(keep3, st.coords, x),
            velocities=v,
            forces=torch.where(keep3, st.forces, f),
            energy=torch.where(keep, st.energy, e),
            dt=torch.where(keep, st.dt, dt),
            alpha=torch.where(keep, st.alpha, alpha),
            n_pos=torch.where(keep, st.n_pos, n_pos),
            step=st.step + 1,
            fmax=torch.where(keep, st.fmax, torch.amax(torch.abs(f), dim=(1, 2))),
        )
    return st
