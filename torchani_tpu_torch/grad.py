"""Energies, forces, Hessians, vibrational analysis, ensemble forces and
stress by autograd (counterpart of ``torchani_tpu/grad.py``).

Inputs may be numpy arrays or tensors; they are moved to the model's device.
Returned tensors are detached, except those of `forces_for_training`.

Where the JAX package takes one ``jacfwd`` of the gradient for the Hessian,
the port writes the batch out: the neighbor table is built once without a
graph, each molecule's table is replicated once per Hessian row of a chunk
and its pair vectors rebuilt from each replica's coordinates, the forces
are taken with ``create_graph=True`` and one backward with one-hot row
directions gives the chunk's rows (`hessian_rows` rows a pass).  So a
neighbor list that takes a single system (``cell_list``) serves too.  On
the card each pass launches the angular AEV's kernels K3 and K3bb once each
and K3b twice: once for the forces, once for the second backward's pass
through the AEV.
"""

import math
import typing as tp

import torch

from torchani_tpu_torch.annotations import Tensor
from torchani_tpu_torch.arch import as_tensor
from torchani_tpu_torch.neighbors import _finalize, _gather_atoms
from torchani_tpu_torch.profiling import scope
from torchani_tpu_torch.tuples import EnergiesForcesHessians, ForcesHessians, VibAnalysis
from torchani_tpu_torch.units import mhessian2fconst, sqrt_mhessian2invcm, sqrt_mhessian2milliev
from torchani_tpu_torch.utils import get_atomic_masses

__all__ = [
    "energies",
    "forces",
    "grads",
    "calc_forces",
    "calc_grads",
    "calc_hessians",
    "calc_forces_and_hessians",
    "energies_and_forces",
    "forces_and_hessians",
    "energies_forces_and_hessians",
    "forces_for_training",
    "energies_and_forces_for_training",
    "hessian_rows",
    "hessians",
    "members_energies_and_forces",
    "force_qbc",
    "stress_scaling",
    "stress_fdotr",
    "vibrational_analysis",
    "single_point",
]

#: device memory one pass of replicated Hessian rows may take
_HESSIAN_BUDGET_BYTES = 2 << 30
#: memory a replicated atom takes through the forces' double backward under
#: ANI-2x (8 members), rounded up from chip_smoke.py's measurement on an H100
_HESSIAN_ATOM_BYTES = 256 << 10


def _inputs(model, coords, cell, pbc):
    dev = model.device
    coords = as_tensor(coords, torch.float32, dev).detach().requires_grad_(True)
    cell = None if cell is None else as_tensor(cell, torch.float32, dev)
    pbc = None if pbc is None else as_tensor(pbc, torch.bool, dev)
    return coords, cell, pbc


def energies(model, species, coords, cell=None, pbc=None, **kwargs) -> Tensor:
    with torch.no_grad():
        return model(species, coords, cell, pbc, **kwargs)


def energies_and_forces(
    model, species, coords, cell=None, pbc=None, **kwargs
) -> tp.Tuple[Tensor, Tensor]:
    """One forward serves both: energies ``(molecules,)`` and forces
    ``-dE/dr`` ``(molecules, atoms, 3)``."""
    with scope("grad.energies_and_forces"):
        coords, cell, pbc = _inputs(model, coords, cell, pbc)
        e = model(species, coords, cell, pbc, **kwargs)
        with scope("grad.backward"):
            (g,) = torch.autograd.grad(e.sum(), coords)
        return e.detach(), -g


def forces(model, species, coords, cell=None, pbc=None, **kwargs) -> Tensor:
    """Forces = -dE/dr, shape ``(molecules, atoms, 3)``."""
    return energies_and_forces(model, species, coords, cell, pbc, **kwargs)[1]


def grads(model, species, coords, cell=None, pbc=None, **kwargs) -> Tensor:
    """Raw energy gradients dE/dr (= -forces), ``(molecules, atoms, 3)``."""
    return -forces(model, species, coords, cell, pbc, **kwargs)


def energies_and_forces_for_training(
    model, species, coords, cell=None, pbc=None
) -> tp.Tuple[Tensor, Tensor]:
    """Energies and forces from one forward, both with their graph kept
    (the forces by ``create_graph=True``), so that a loss on them has
    gradients with respect to the model's weights; through the kernel
    strategy the loss's backward launches K3bb once (and K3b not again
    unless the coordinates' gradient is asked for too)."""
    coords, cell, pbc = _inputs(model, coords, cell, pbc)
    e = model(species, coords, cell, pbc)
    with scope("grad.backward"):
        (g,) = torch.autograd.grad(e.sum(), coords, create_graph=True)
    return e, -g


def forces_for_training(model, species, coords, cell=None, pbc=None) -> Tensor:
    """The forces of `energies_and_forces_for_training`."""
    return energies_and_forces_for_training(model, species, coords, cell, pbc)[1]


def forces_and_hessians(model, species, coords, cell=None, pbc=None) -> ForcesHessians:
    return ForcesHessians(
        forces(model, species, coords, cell, pbc), hessians(model, species, coords, cell, pbc)
    )


def energies_forces_and_hessians(
    model, species, coords, cell=None, pbc=None
) -> EnergiesForcesHessians:
    e, f = energies_and_forces(model, species, coords, cell, pbc)
    return EnergiesForcesHessians(e, f, hessians(model, species, coords, cell, pbc))


def hessian_rows(num_molecules: int, num_atoms: int) -> int:
    """Hessian rows that one pass of `hessians` takes for a batch of
    ``num_molecules`` molecules of ``num_atoms`` atoms: the replicas that
    fit ``_HESSIAN_BUDGET_BYTES``, at least 1, at most the ``3 A`` rows."""
    per_row = max(1, num_molecules * num_atoms) * _HESSIAN_ATOM_BYTES
    return max(1, min(3 * num_atoms, _HESSIAN_BUDGET_BYTES // per_row))


def hessians(model, species, coords, cell=None, pbc=None) -> Tensor:
    """Hessian of each molecule, shape ``(molecules, 3A, 3A)`` (padded atoms
    included, with zero rows).

    The neighbor table of the configuration is built once, without a graph
    (its selection carries no derivative), with each lane's image shift.
    Per pass, R = `hessian_rows` replicas of the batch on that table, their
    pair vectors rebuilt from the replicas' coordinates, the forces with
    ``create_graph=True`` and one backward whose direction is row ``i0 + r``
    of the identity on replica r: ``ceil(3A / R)`` passes."""
    elem, coords, _, nb = _fixed_neighbors(model, species, coords, cell, pbc)
    c, a = elem.shape
    n = 3 * a
    shift = torch.where(
        nb.mask[..., None], nb.diff - (_gather_atoms(coords, nb.idx) - coords[:, :, None]), 0.0
    )
    rows = hessian_rows(c, a)
    eye = torch.eye(n, dtype=coords.dtype, device=coords.device)
    out = coords.new_empty((c, n, n))
    for start in range(0, n, rows):
        r = min(rows, n - start)

        def rep(t: Tensor) -> Tensor:
            return t.expand((r,) + t.shape).reshape((r * c,) + t.shape[1:])

        x = rep(coords).clone().requires_grad_(True)
        nb_r = _finalize(x, rep(nb.idx), rep(nb.mask), rep(shift), nb.overflow,
                         None if nb.elem is None else rep(nb.elem))
        e = model.compute_from_neighbors(rep(elem), x, nb_r).energies
        (g,) = torch.autograd.grad(e.sum(), x, create_graph=True)
        v = eye[start:start + r, None, :].expand(r, c, n).reshape(r * c, a, 3)
        (h,) = torch.autograd.grad(g, x, v)
        out[:, start:start + r] = h.reshape(r, c, n).transpose(0, 1)
    return out


calc_forces = forces
calc_grads = grads
calc_forces_and_hessians = forces_and_hessians
calc_hessians = hessians


def vibrational_analysis(
    masses: Tensor,  # (C, A)
    hessian: Tensor,  # (C, 3A, 3A)
    mode_type: str = "MDU",
    unit: str = "cm^-1",
) -> VibAnalysis:
    """Normal modes from the eigendecomposition of the mass-weighted Hessian.

    Frequencies in ``unit`` (``"cm^-1"`` or ``"meV"``), imaginary ones as
    negative numbers; modes ``(C, 3A, A, 3)``, mass-deweighted and
    unnormalized (``"MDU"``), mass-deweighted and normalized (``"MDN"``) or
    mass-weighted and normalized (``"MWN"``); force constants (mDyne/A) and
    reduced masses (AMU) ``(C, 3A)``."""
    if unit not in ("cm^-1", "meV"):
        raise ValueError("Only cm^-1 and meV are supported right now")
    if mode_type not in ("MDU", "MDN", "MWN"):
        raise ValueError(f"Unsupported mode type {mode_type}")
    c, a = masses.shape
    inv_sqrt_m3 = torch.repeat_interleave(1.0 / torch.sqrt(masses), 3, dim=-1)  # (C, 3A)
    mass_scaled = hessian * inv_sqrt_m3[:, :, None] * inv_sqrt_m3[:, None, :]
    eigenvalues, eigenvectors = torch.linalg.eigh(mass_scaled)
    angular = torch.sqrt(eigenvalues.abs()) * torch.sign(eigenvalues)
    to_unit = sqrt_mhessian2invcm if unit == "cm^-1" else sqrt_mhessian2milliev
    freqs = to_unit(angular / (2 * math.pi))
    mw_normalized = eigenvectors.transpose(-1, -2)  # rows are modes
    md_unnormalized = mw_normalized * inv_sqrt_m3[:, None, :]
    norm = torch.linalg.norm(md_unnormalized, dim=-1, keepdim=True)
    rmasses = 1.0 / (norm**2)[..., 0]
    fconstants = mhessian2fconst(eigenvalues) * rmasses
    modes = {"MDU": md_unnormalized, "MDN": md_unnormalized / norm, "MWN": mw_normalized}
    return VibAnalysis(freqs, modes[mode_type].reshape(c, 3 * a, a, 3), fconstants, rmasses)


def members_energies_and_forces(
    model, species, coords, cell=None, pbc=None
) -> tp.Tuple[Tensor, Tensor]:
    """Each ensemble member's energies ``(E, C)`` and forces ``(E, C, A,
    3)``: one forward and one backward per member (on the card, one K3 and
    E K3b launches).  Raises `ValueError` for a model without an ensemble."""
    coords, cell, pbc = _inputs(model, coords, cell, pbc)
    e = model(species, coords, cell, pbc, ensemble_values=True)
    if e.dim() != 2 or e.shape[1] != coords.shape[0]:
        raise ValueError(
            f"the model has no ensemble: its ensemble_values=True output has shape "
            f"{tuple(e.shape)}, not (members, {coords.shape[0]})"
        )
    members = e.shape[0]
    out = [
        -torch.autograd.grad(e[i].sum(), coords, retain_graph=i + 1 < members)[0]
        for i in range(members)
    ]
    return e.detach(), torch.stack(out)


def force_qbc(model, species, coords, cell=None, pbc=None) -> Tensor:
    """Per-atom force disagreement across the members: the standard
    deviation (ddof 1) of |F|, ``(C, A)``."""
    _, f = members_energies_and_forces(model, species, coords, cell, pbc)
    return torch.linalg.norm(f, dim=-1).std(0, unbiased=True)


def _fixed_neighbors(model, species, coords, cell, pbc):
    """Element indices, coordinates, cell and the neighbor table of the
    configuration, built once without a graph."""
    coords, cell, pbc = _inputs(model, coords, cell, pbc)
    coords = coords.detach()
    elem = model._convert(species)
    with torch.no_grad():
        nb = model.neighborlist(model.cutoff, elem, coords, cell, pbc)
    return elem, coords, cell, nb


def _with_diff(nb, diff: Tensor):
    return nb.replace(
        diff=diff, dist=torch.sqrt(torch.where(nb.mask, torch.sum(diff * diff, dim=-1), 1.0))
    )


def stress_scaling(model, species, coords, cell, pbc) -> Tensor:
    """Stress ``(1 / V) dE/d(eps)`` at zero strain, shape ``(3, 3)``: coords
    and pair vectors scaled by ``(I + eps)`` on the neighbor topology of the
    unstrained configuration (it cannot change to first order)."""
    elem, coords, cell, nb = _fixed_neighbors(model, species, coords, cell, pbc)
    eps = torch.zeros((3, 3), dtype=coords.dtype, device=coords.device, requires_grad=True)
    scaling = torch.eye(3, dtype=coords.dtype, device=coords.device) + eps
    e = model.compute_from_neighbors(
        elem, coords @ scaling, _with_diff(nb, nb.diff @ scaling)
    ).energies
    (g,) = torch.autograd.grad(e.sum(), eps)
    return g / torch.linalg.det(cell).abs()


def stress_fdotr(model, species, coords, cell, pbc) -> Tensor:
    """Virial stress ``sum dE/d(diff) x diff`` over the pair lanes, divided
    by the volume where there is a cell, shape ``(3, 3)``.  Each lane's
    derivative covers only that lane's share, so the full (two-lane) table
    needs no double-count correction."""
    elem, coords, cell, nb = _fixed_neighbors(model, species, coords, cell, pbc)
    diff = nb.diff.detach().requires_grad_(True)
    e = model.compute_from_neighbors(elem, coords, _with_diff(nb, diff)).energies
    (de,) = torch.autograd.grad(e.sum(), diff)
    virial = torch.einsum("...x,...y->xy", de, nb.diff)
    return virial if cell is None else virial / torch.linalg.det(cell).abs()


def single_point(
    model,
    species,
    coords,
    cell=None,
    pbc=None,
    charge: int = 0,
    forces: bool = False,
    hessians: bool = False,
    atomic_energies: bool = False,
    ensemble_values: bool = False,
    vibrational: bool = False,
) -> tp.Dict[str, Tensor]:
    """Energies and the requested derived quantities, as a dict.  ``charge``
    goes to every call of the model (an `ANIq` takes charged molecules; any
    other model raises for a charge other than 0).

    Keys: ``energies``; with ``ensemble_values`` also ``ensemble_energies``,
    ``ensemble_std`` and ``qbcs``; ``atomic_energies``; ``forces``;
    ``hessians``; with ``vibrational`` also ``freqs`` (cm^-1), ``modes``,
    ``force_constants`` and ``reduced_masses``.
    """
    out: tp.Dict[str, Tensor] = {}
    if ensemble_values:
        with torch.no_grad():
            member = model(species, coords, cell, pbc, charge=charge, ensemble_values=True)
            num_atoms = (model._convert(species) >= 0).sum(-1)
        out["energies"] = member.mean(0)
        out["ensemble_energies"] = member
        out["ensemble_std"] = member.std(0, unbiased=True)
        out["qbcs"] = out["ensemble_std"] / num_atoms.to(member.dtype).sqrt()
    elif forces:
        out["energies"], out["forces"] = energies_and_forces(
            model, species, coords, cell, pbc, charge=charge
        )
    else:
        out["energies"] = energies(model, species, coords, cell, pbc, charge=charge)
    if atomic_energies:
        out["atomic_energies"] = energies(
            model, species, coords, cell, pbc, charge=charge, atomic=True
        )
    if forces and "forces" not in out:
        out["forces"] = energies_and_forces(model, species, coords, cell, pbc, charge=charge)[1]
    if hessians or vibrational:
        h = globals()["hessians"](model, species, coords, cell, pbc)
        out["hessians"] = h
        if vibrational:
            masses = get_atomic_masses(model.atomic_numbers_of(species))
            vib = vibrational_analysis(masses, h)
            out["freqs"] = vib.freqs
            out["modes"] = vib.modes
            out["force_constants"] = vib.fconstants
            out["reduced_masses"] = vib.rmasses
    return out
