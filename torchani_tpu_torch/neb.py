"""Nudged-elastic-band (NEB) transition-state search, the whole band in one
batch (counterpart of ``torchani_tpu/neb.py``).

The band of I images is one ``(I, A)`` batch: every iteration evaluates all
images' energies and forces with one forward and one backward, projects the
NEB forces and takes a FIRE step over the whole band.  The standard
formulation:

- improved tangents (Henkelman & Jonsson 2000): the uphill neighbor
  difference, an energy-weighted mix at extrema;
- interior force = perpendicular true force + parallel spring force;
- climbing image: the highest-energy interior image (the first, where
  energies tie) feels ``F - 2 (F . tau) tau`` and no spring;
- the endpoints are frozen (zero band force).

One FIRE state serves the whole band, as in ASE; its schedule stays f32/int32
tensors on the band's device, and the loop's condition is the iteration's one
wait for the device.
"""

import dataclasses
import typing as tp

import torch

from torchani_tpu_torch.annotations import DeviceArg, Tensor
from torchani_tpu_torch.optimize import _energy_and_forces, _fire_move
from torchani_tpu_torch.utils import tensor_on

__all__ = ["NEBState", "neb_path"]


@dataclasses.dataclass(frozen=True)
class NEBState:
    images: Tensor  # (I, A, 3)
    energies: Tensor  # (I,)
    neb_forces: Tensor  # (I, A, 3) projected band forces (0 at the endpoints)
    velocities: Tensor
    dt: Tensor  # f32
    alpha: Tensor  # f32
    n_pos: Tensor  # int32
    step: int
    fmax: Tensor  # () max |band force|

    def replace(self, **changes) -> "NEBState":
        return dataclasses.replace(self, **changes)


def _tangents(images: Tensor, energies: Tensor) -> Tensor:
    """Improved (energy-weighted) unit tangents of the interior images,
    ``(I - 2, A, 3)``."""
    r_prev = images[1:-1] - images[:-2]  # R_i - R_{i-1}
    r_next = images[2:] - images[1:-1]  # R_{i+1} - R_i
    e_prev, e_mid, e_next = energies[:-2], energies[1:-1], energies[2:]
    uphill = (e_next > e_mid) & (e_mid > e_prev)
    downhill = (e_next < e_mid) & (e_mid < e_prev)
    d_next, d_prev = torch.abs(e_next - e_mid), torch.abs(e_prev - e_mid)
    de_max = torch.maximum(d_next, d_prev)
    de_min = torch.minimum(d_next, d_prev)
    hi_next = e_next > e_prev
    w_next = torch.where(hi_next, de_max, de_min)[:, None, None]
    w_prev = torch.where(hi_next, de_min, de_max)[:, None, None]
    mix = w_next * r_next + w_prev * r_prev
    tau = torch.where(
        uphill[:, None, None], r_next, torch.where(downhill[:, None, None], r_prev, mix)
    )
    norm = torch.sqrt(torch.sum(tau * tau, dim=(1, 2), keepdim=True)) + 1e-30
    return tau / norm


def neb_path(
    energy_fn: tp.Callable[[Tensor], Tensor],  # (I, A, 3) -> (I,)
    images,  # (I, A, 3) initial band, fixed endpoints included
    k_spring: float = 0.1,  # Hartree / Angstrom^2
    climb: bool = True,
    max_steps: int = 500,
    fmax: float = 0.005,  # Hartree/Angstrom on the projected forces
    dt_start: float = 0.1,
    dt_max: float = 0.6,
    n_min: int = 5,
    f_inc: float = 1.1,
    f_dec: float = 0.5,
    alpha_start: float = 0.1,
    f_alpha: float = 0.99,
    device: DeviceArg = None,
) -> NEBState:
    """Relax a band to the minimum-energy path; returns the final `NEBState`
    (``state.energies[1:-1].argmax() + 1`` is the transition-state image
    when ``climb``).  ``images`` keeps its device if it is a tensor; other
    input goes to CUDA unless ``device="cpu"``."""
    images = tensor_on(images, torch.float32, device)
    if images.dim() != 3 or images.shape[0] < 3:
        raise ValueError(f"need a band (I >= 3, A, 3), got {tuple(images.shape)}")

    def band_forces(x: Tensor) -> tp.Tuple[Tensor, Tensor]:
        e, f_true = _energy_and_forces(energy_fn, x)
        tau = _tangents(x, e)
        f_int = f_true[1:-1]
        f_par = torch.sum(f_int * tau, dim=(1, 2), keepdim=True)
        len_next = torch.sqrt(torch.sum((x[2:] - x[1:-1]) ** 2, dim=(1, 2), keepdim=True))
        len_prev = torch.sqrt(torch.sum((x[1:-1] - x[:-2]) ** 2, dim=(1, 2), keepdim=True))
        f_neb = f_int - f_par * tau + k_spring * (len_next - len_prev) * tau
        if climb:
            ci = torch.argmax(e[1:-1])
            is_ci = (torch.arange(f_neb.shape[0], device=x.device) == ci)[:, None, None]
            f_neb = torch.where(is_ci, f_int - 2.0 * f_par * tau, f_neb)
        zeros = torch.zeros_like(f_true[:1])
        return e, torch.cat([zeros, f_neb, zeros], dim=0)

    e0, f0 = band_forces(images)
    st = NEBState(
        images=images,
        energies=e0,
        neb_forces=f0,
        velocities=torch.zeros_like(images),
        dt=images.new_tensor(dt_start),
        alpha=images.new_tensor(alpha_start),
        n_pos=torch.zeros((), dtype=torch.int32, device=images.device),
        step=0,
        fmax=torch.amax(torch.abs(f0)),
    )
    schedule = dict(n_min=n_min, f_inc=f_inc, f_dec=f_dec, dt_max=dt_max,
                    alpha_start=alpha_start, f_alpha=f_alpha)
    while st.step < max_steps and bool(st.fmax > fmax):
        x, v, dt, alpha, n_pos = _fire_move(
            st.images, st.velocities, st.neb_forces, st.dt, st.alpha, st.n_pos, **schedule
        )
        e, f_new = band_forces(x)
        st = NEBState(
            images=x, energies=e, neb_forces=f_new, velocities=v, dt=dt, alpha=alpha,
            n_pos=n_pos, step=st.step + 1, fmax=torch.amax(torch.abs(f_new)),
        )
    return st
