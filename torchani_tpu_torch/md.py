"""Molecular dynamics with Verlet-cached neighbors (counterpart of
``torchani_tpu/md.py``: NVE, Langevin (BAOAB), the Nose-Hoover chain (NVT),
Berendsen NPT, recorded trajectories of each (`MolecularDynamics.trajectory`),
multiple-timestep RESPA (`MultipleTimestepMD`) and `CachedSinglePoint`, for
models of one or several potentials).

The neighbor topology is a cell list built at ``cutoff + skin`` and reused
until a pair can have closed the skin gap.  Each step recomputes only the
differentiable pair vectors from the cached topology (`_refresh_neighbors`),
the model and its gradient.  For periodic cells the refresh is bucket-local
(`torchani_tpu_torch.bucket_refresh`: the CUDA kernels K1 forward, K2
backward; with ``bucket_refresh="packed"``
`torchani_tpu_torch.bucket_refresh_packed`: K5f and K5b); otherwise it is an
``index_select`` whose backward is an ``index_add``.

A model with a long-cutoff potential (D3 dispersion at 8 A) sets the build
radius; the lanes are sorted by build distance, and each shorter potential
(the networks' AEV, the repulsion) runs on its own static prefix of them.
The slot-layout bucket tables ride on the refreshed table as the lane-select
service for runtime per-atom values (`bucket_refresh.select_lane_values`:
K4f and K4b inside D3).

Where the JAX package compiles the whole step and scans over it, this is
a Python loop over `MolecularDynamics.step_nve` (or `step_langevin`); the
rebuild decision is one boolean read on the host per step.  Langevin noise
is drawn from a `torch.Generator` on the model's device that the state
carries, where the JAX package carries a PRNG key.

Under NPT (``npt_compression``) the topology is built from reduced
coordinates (physical / scale) against the initial cell, at a radius that
still covers the cutoff once the box has shrunk by ``npt_compression``; the
refreshed pair vectors are scaled by the state's ``scale`` after the
selection, so the refresh kernels are the same, and one backward gives the
energy, the forces and dU/dscale (the pair virial).

Units: Angstrom, Hartree, AMU, femtoseconds.
"""

import copy
import dataclasses
import math
import typing as tp

import numpy as np
import torch

from torchani_tpu_torch.annotations import DeviceArg, Tensor
from torchani_tpu_torch.arch import as_tensor
from torchani_tpu_torch.bucket_refresh import (
    MAX_SLOTS,
    BucketTables,
    bucket_nbr_pos,
    make_wrapshift,
    tables_from_cell_aux,
)
from torchani_tpu_torch.bucket_refresh_packed import (
    PackedTables,
    choose_span,
    pack_tables,
    packed_nbr_pos,
)
from torchani_tpu_torch.neighbors import (
    Neighbors,
    _static_grid_shape,
    cell_list,
    estimate_capacity,
    lane_permute,
    narrow_to_cutoff,
)
from torchani_tpu_torch.nn.containers import SpeciesRanges
from torchani_tpu_torch.profiling import scope
from torchani_tpu_torch.utils import get_atomic_masses, resolve_device

__all__ = [
    "ACCEL_UNIT",
    "KB_HARTREE",
    "PRESSURE_UNIT_BAR",
    "CachedSinglePoint",
    "MDState",
    "MTSState",
    "MolecularDynamics",
    "MultipleTimestepMD",
    "langevin_o_step",
    "maxwell_boltzmann_velocities",
    "kinetic_temperature",
]

#: Hartree/(Angstrom * AMU) -> Angstrom/fs^2
ACCEL_UNIT = 0.2625499785
#: Boltzmann constant in Hartree/K
KB_HARTREE = 3.166811563e-06
#: Hartree/Angstrom^3 -> bar
PRESSURE_UNIT_BAR = 4.35974465e7


@dataclasses.dataclass(frozen=True)
class MDState:
    """Dynamic MD state: detached tensors on the model's device.

    ``coords``, ``velocities`` and ``forces`` are in the USER's atom order.
    The neighbor cache (and every table derived from it) lives in the
    species-sorted "internal" order; ``nbr_perm`` maps internal rows to user
    atoms (None when the user's order is already sorted).
    """

    coords: Tensor  # (A, 3)
    velocities: Tensor  # (A, 3)
    forces: Tensor  # (A, 3)
    energy: Tensor  # ()
    # Verlet cache: neighbor topology built at cutoff + skin
    nbr_idx: Tensor  # (A, K) int64
    nbr_mask: Tensor  # (A, K) bool
    nbr_shift: Tensor  # (A, K, 3) cartesian image shifts ((1, 1, 3) in bucket mode)
    nbr_elem: Tensor  # (A, K) neighbor species, -1 in masked lanes
    ref_coords: Tensor  # (A, 3) coords at the last rebuild
    overflow: Tensor  # () bool
    rebuilds: int = 0
    step: int = 0
    nbr_perm: tp.Optional[Tensor] = None  # (A,) int64
    # bucket refresh tables (periodic cell-list systems): `BucketTables` for
    # the slot-row layout, `PackedTables` for the atom-packed one; None
    # selects the gather refresh
    bucket: tp.Optional[tp.Union[BucketTables, PackedTables]] = None
    # frozen per-window pair channels (potential name -> (A, K, P)),
    # recomputed at every rebuild for the potentials named in `MolecularDynamics`'
    # ``freeze_pair_window`` (see `Neighbors.pair_aux`); None when off
    pair_aux: tp.Optional[tp.Dict[str, Tensor]] = None
    # the Langevin noise's generator, on the model's device; advanced in
    # place by every draw, so states of one run share it
    generator: tp.Optional[torch.Generator] = None
    # NPT: the isotropic cell scale s (physical cell = s * initial cell), a
    # () tensor; the topology lives in reduced coordinates (coords / s).
    # None outside NPT
    scale: tp.Optional[Tensor] = None
    # Nose-Hoover chain state (2, M): chain velocities (1/fs), chain
    # positions (diagnostics only); None until `run_nvt_nose_hoover` sets it
    nhc: tp.Optional[Tensor] = None

    def replace(self, **changes) -> "MDState":
        return dataclasses.replace(self, **changes)


def maxwell_boltzmann_velocities(
    generator: torch.Generator, masses: Tensor, temperature: float
) -> Tensor:
    """Sample velocities (Angstrom/fs) at a temperature (Kelvin).

    The normal deviates are drawn on ``generator``'s device and moved to
    ``masses``' device, so a CPU generator gives every device the same
    velocities from one seed."""
    # v ~ N(0, sqrt(kB T / m)), in (Ha/amu)^(1/2) -> A/fs via sqrt(ACCEL_UNIT)
    # dummy atoms carry mass 0; give them zero velocity instead of inf
    safe_m = torch.where(masses > 0, masses, 1.0)
    sigma = torch.where(masses > 0, torch.sqrt(KB_HARTREE * temperature / safe_m), 0.0)
    noise = torch.randn(
        tuple(masses.shape) + (3,), generator=generator, device=generator.device,
        dtype=masses.dtype,
    )
    return noise.to(masses.device) * sigma[:, None] * math.sqrt(ACCEL_UNIT)


def kinetic_temperature(velocities: Tensor, masses: Tensor) -> Tensor:
    """Instantaneous kinetic temperature (Kelvin)."""
    ke = 0.5 * torch.sum(masses[:, None] * velocities**2) / ACCEL_UNIT  # Hartree
    dof = 3 * velocities.shape[0]
    return 2 * ke / (dof * KB_HARTREE)


def langevin_o_step(
    velocities: Tensor,
    masses: Tensor,
    dt: float,
    temperature: float,
    friction_per_fs: float,
    noise: Tensor,
) -> Tensor:
    """The O step of BAOAB: the exact Ornstein-Uhlenbeck update of the
    velocities over ``dt`` fs, ``c1 v + sigma noise`` with ``c1 = exp(-gamma
    dt)`` and ``sigma = sqrt((1 - c1^2) kB T / m)``, ``noise`` a standard
    normal draw of the velocities' shape."""
    c1 = math.exp(-friction_per_fs * dt)
    sigma = torch.sqrt(
        (1 - c1**2) * KB_HARTREE * temperature / masses
    )[:, None] * math.sqrt(ACCEL_UNIT)
    return c1 * velocities + sigma * noise


def _nhc_update(
    v: Tensor, nhc: Tensor, masses: Tensor, dof: int, kt: float,
    q: tp.Sequence[float], dt2: float,
) -> tp.Tuple[Tensor, Tensor]:
    """Half-step Nose-Hoover chain update (Martyna-Tuckerman-Klein).

    ``nhc`` (2, M): chain velocities and positions; ``q`` (M,) chain masses
    (Hartree fs^2); ``kt`` Hartree; ``dt2`` fs (half the MD step).  Returns
    the scaled particle velocities and the new chain state."""
    m = len(q)
    vx = [nhc[0, j] for j in range(m)]
    xx = [nhc[1, j] for j in range(m)]
    dt4, dt8 = dt2 / 2.0, dt2 / 4.0
    ke2 = torch.sum(masses[:, None] * v**2) / ACCEL_UNIT  # 2 KE, Hartree

    def force(j, ke2):
        if j == 0:
            return (ke2 - dof * kt) / q[0]
        return (q[j - 1] * vx[j - 1] ** 2 - kt) / q[j]

    # reverse sweep: chain velocities from the tail to the head
    vx[m - 1] = vx[m - 1] + force(m - 1, ke2) * dt4
    for j in range(m - 2, -1, -1):
        e = torch.exp(-dt8 * vx[j + 1])
        vx[j] = (vx[j] * e + force(j, ke2) * dt4) * e
    # scale the particle velocities; the chain positions advance
    s = torch.exp(-dt2 * vx[0])
    v = v * s
    ke2 = ke2 * s**2
    for j in range(m):
        xx[j] = xx[j] + dt2 * vx[j]
    # forward sweep, head to tail, with the updated kinetic energy
    for j in range(m - 1):
        e = torch.exp(-dt8 * vx[j + 1])
        vx[j] = (vx[j] * e + force(j, ke2) * dt4) * e
    vx[m - 1] = vx[m - 1] + force(m - 1, ke2) * dt4
    return v, torch.stack([torch.stack(vx), torch.stack(xx)])


def _shallow_copy(module: torch.nn.Module) -> torch.nn.Module:
    """A copy of ``module`` with its own attribute and submodule tables that
    shares every parameter, buffer and submodule with the original."""
    new = copy.copy(module)
    new._modules = dict(module._modules)
    new._parameters = dict(module._parameters)
    new._buffers = dict(module._buffers)
    return new


def _with_aev_fields(model, **fields):
    """A model copy whose AEV computer has ``fields`` set (the angular
    preslice, the count-class split).  The caller's model, and its AEV
    computer, stay as they were; weights and buffers are shared."""
    nnp = _shallow_copy(model.potentials["nnp"])
    aevc = _shallow_copy(nnp.aev_computer)
    for name, value in fields.items():
        setattr(aevc, name, value)
    nnp.aev_computer = aevc
    potentials = _shallow_copy(model.potentials)
    potentials["nnp"] = nnp
    model = _shallow_copy(model)
    model.potentials = potentials
    return model


def _with_enabled(model, names: tp.Collection[str], self_energies: bool):
    """A model copy in which only the potentials in ``names`` (of those
    enabled) are enabled, and the self energies only if ``self_energies``.
    The caller's model stays as it was; weights and buffers are shared."""
    potentials = _shallow_copy(model.potentials)
    for name, pot in model.potentials.items():
        lane_pot = _shallow_copy(pot)
        lane_pot.enabled = pot.enabled and name in names
        potentials[name] = lane_pot
    new = _shallow_copy(model)
    new.potentials = potentials
    if not self_energies:
        shifter = _shallow_copy(model.energy_shifter)
        shifter.enabled = False
        new.energy_shifter = shifter
    return new


def _slice_lanes(nb: Neighbors, p: int) -> Neighbors:
    """Static lane-prefix view of a distance-sorted table.  The lane-select
    tables are dropped: they describe the full lane layout."""
    return Neighbors(
        idx=nb.idx[:, :p],
        mask=nb.mask[:, :p],
        diff=nb.diff[:, :p, :],
        dist=nb.dist[:, :p],
        overflow=nb.overflow,
        elem=None if nb.elem is None else nb.elem[:, :p],
    )


def _batch1(nb: Neighbors) -> Neighbors:
    """Leading molecule axis on the per-lane tensors only (the lane-select
    tables and the frozen channels live in flat atom space)."""
    return nb.replace(
        idx=nb.idx[None],
        mask=nb.mask[None],
        diff=nb.diff[None],
        dist=nb.dist[None],
        elem=None if nb.elem is None else nb.elem[None],
    )


def _refresh_neighbors(
    state: MDState, coords: Tensor, scale: tp.Optional[Tensor] = None
) -> Neighbors:
    """Recompute differentiable diff/dist from the cached topology.

    ``coords`` is in user order; the cached topology is in species-sorted
    internal order (see `MDState`), so the produced tables are internal-order
    rows matching `MolecularDynamics`' (sorted) ``elem_idxs``.

    ``scale`` (NPT): ``coords`` are then reduced (physical / scale), the
    frame of the cached topology, and the physical pair vectors are scale
    times the reduced ones (isotropic scaling commutes with the image
    shifts); differentiating with respect to ``scale`` at fixed reduced
    coordinates gives the pair virial.
    """
    if state.nbr_perm is not None:
        coords = coords.index_select(0, state.nbr_perm)
    mask = state.nbr_mask
    if state.bucket is not None:
        # bucket path: the selection reproduces coords[idx] + shift exactly
        # (canonical coordinates; see bucket_refresh.py)
        tables = state.bucket
        canon = coords - tables.wrap_offset
        if isinstance(tables, PackedTables):
            nbr_pos = packed_nbr_pos(canon, tables)[:, : state.nbr_idx.shape[1]]
        else:
            nbr_pos = bucket_nbr_pos(
                canon, tables.keys, tables.atom_of_slot, tables.slot_of_atom, tables.wrapshift
            )
        diff = nbr_pos - canon[:, None, :]
    else:
        # index_select's backward is an index_add (atomic adds on the card);
        # the JAX package's partner-lane map, which turns that backward into
        # a gather, has no counterpart here
        a, k = state.nbr_idx.shape
        idx_safe = torch.where(mask, state.nbr_idx, 0)
        nbr_pos = coords.index_select(0, idx_safe.reshape(-1)).reshape(a, k, 3)
        diff = nbr_pos - coords[:, None, :] + state.nbr_shift
    if scale is not None:
        diff = diff * scale
    diff = torch.where(mask[..., None], diff, 0.0)
    d2 = torch.sum(diff * diff, dim=-1)
    dist = torch.sqrt(torch.where(mask, d2, 1.0))
    return Neighbors(
        idx=state.nbr_idx, mask=mask, diff=diff, dist=dist,
        overflow=state.overflow, elem=state.nbr_elem,
        # the slot-layout tables double as the lane-select service for
        # runtime per-atom values (bucket_refresh.select_lane_values)
        select_tables=state.bucket if isinstance(state.bucket, BucketTables) else None,
    )


def choose_angular_split(
    counts: np.ndarray, cap: int
) -> tp.Optional[tp.Tuple[int, int]]:
    """The count-class split of the JAX package's `MolecularDynamics` for
    per-atom angular counts ``(A,)`` at capacity ``cap``: over every even
    ``k_small`` in ``[8, cap - 4]``, ``n_dense`` covers the rows over
    ``k_small`` lanes with a 30% and 64-row margin (a multiple of 64), and
    the pair with the least estimated pair-lane work wins; None where it
    saves under 15%."""
    a = int(counts.shape[0])
    kp = lambda k: k * (k - 1) / 2.0  # noqa: E731
    base = a * kp(cap)
    best = None
    for k_small in range(8, cap - 3, 2):
        over = int((counts > k_small).sum())
        n_dense = int(-(-int(over * 1.3 + 64) // 64) * 64)
        if n_dense >= a:
            continue
        cost = n_dense * kp(cap) + (a - n_dense) * kp(k_small)
        if best is None or cost < best[0]:
            best = (cost, k_small, n_dense)
    if best is None or best[0] > 0.85 * base:
        return None
    return best[1], best[2]


class MolecularDynamics:
    """Molecular dynamics of a single (optionally periodic) system.

    Wraps a `torchani_tpu_torch.arch.ANI` model.  The neighbor list is a cell
    list built at ``cutoff + skin`` and reused until the two largest atomic
    displacements since the build sum to more than the skin.  Runs on the
    model's device, which must be CUDA unless ``device="cpu"`` is passed.

    ``nn_precision`` is kept for the JAX class's signature: there ``"high"``
    (the MD default) evaluates the networks in three bf16 passes.  Here every
    value evaluates the networks in full f32, since TF32 stays off.

    ``bucket_refresh``: ``"auto"`` (on for periodic cells), ``True``,
    ``"slot"``, ``False``, or ``"packed"`` for the atom-packed layout.
    ``freeze_pair_window`` names potentials that implement
    ``frozen_window_channels`` (D3 dispersion): their per-lane constants are
    then computed once per REBUILD and carried in ``MDState.pair_aux``
    instead of being gathered at every evaluation.  Exact: the channels are
    constants keyed by the elements.

    ``npt_compression`` (in [0, 0.5), periodic cells only) is the linear
    compression the neighbor table must cover under `run_npt_berendsen`:
    the build radius becomes ``(cutoff + skin) / (1 - npt_compression)``,
    and the angular preslice and the per-potential lane prefixes are off
    (their bounds compare reduced build distances with physical reaches).
    """

    def __init__(
        self,
        model,
        species,  # (1, A) atomic numbers, or element indices (periodic_table_index=False)
        cell=None,
        pbc: bool = False,
        skin: float = 0.75,
        capacity: tp.Optional[int] = None,
        bucket_capacity: tp.Optional[int] = None,
        timestep_fs: float = 1.0,
        nn_precision: str = "high",
        auto_capacity: bool = True,
        bucket_refresh: tp.Union[bool, str] = "auto",
        freeze_pair_window: tp.Sequence[str] = (),
        device: DeviceArg = None,
        npt_compression: float = 0.0,
    ) -> None:
        # the constructor's arguments, the caller's model among them, for
        # `rebaseline`
        self._ctor = dict(
            model=model, species=species, pbc=pbc, skin=skin, capacity=capacity,
            bucket_capacity=bucket_capacity, timestep_fs=timestep_fs,
            nn_precision=nn_precision, auto_capacity=auto_capacity,
            bucket_refresh=bucket_refresh, freeze_pair_window=freeze_pair_window,
            device=device, npt_compression=npt_compression,
        )
        if npt_compression and cell is None:
            raise ValueError("npt_compression requires a periodic cell")
        if not 0.0 <= npt_compression < 0.5:
            raise ValueError("npt_compression must be in [0, 0.5)")
        dev = resolve_device(device)
        if model.device.type != dev.type:
            raise ValueError(
                f"the model is on {model.device}, MolecularDynamics was asked for {dev}"
            )
        self.device = dev = model.device
        self.model = model
        self._freeze_pair = tuple(
            n for n in freeze_pair_window
            if n in model.potentials and hasattr(model.potentials[n], "frozen_window_channels")
        )
        self.nn_precision = nn_precision
        self.species = as_tensor(species, torch.int64, dev)
        if self.species.dim() != 2 or self.species.shape[0] != 1:
            raise ValueError(f"species must be (1, A), got {tuple(self.species.shape)}")
        # Species-sort the internal atom order (stable, so spatial locality
        # within a species block is kept): the networks' per-species rows are
        # then contiguous slices, known here once.  `elem_idxs` is INTERNAL
        # order from here on; user-facing tensors (coords, velocities,
        # forces, masses) stay in user order.
        host_elem = model._convert(self.species)[0].cpu().numpy()
        order = np.argsort(host_elem, kind="stable")
        self._species_perm: tp.Optional[Tensor] = None
        if not (order == np.arange(order.shape[0])).all():
            self._species_perm = torch.as_tensor(order, dtype=torch.int64, device=dev)
            host_elem = host_elem[order]
        self.elem_idxs = torch.as_tensor(host_elem[None], dtype=torch.int64, device=dev)
        # the internal element array is sorted: species-of-atom-index is a
        # step function, and each species' rows are one range
        vals, starts = np.unique(host_elem, return_index=True)
        stops = list(starts[1:]) + [host_elem.shape[0]]
        self._elem_steps = (tuple(int(v) for v in vals), tuple(int(s) for s in starts))
        self._species_ranges: SpeciesRanges = tuple(
            (int(v), int(s), int(e)) for v, s, e in zip(vals, starts, stops) if v >= 0
        )
        self._valid_atom = host_elem >= 0
        # the thermostats' and the barostat's degrees of freedom: real atoms
        self._n_real = int(self._valid_atom.sum())
        self._cell_np = None if cell is None else np.asarray(
            cell.detach().cpu().numpy() if isinstance(cell, torch.Tensor) else cell,
            dtype=np.float64,
        )
        self.cell = None if cell is None else as_tensor(cell, torch.float32, dev)
        self.pbc = torch.ones(3, dtype=torch.bool, device=dev) if pbc else None
        self.skin = skin
        self.cutoff = model.cutoff
        self.dt = timestep_fs
        self._s_min = 1.0 - npt_compression
        self.build_radius = (self.cutoff + skin) / self._s_min
        self._volume0 = 0.0 if self._cell_np is None else float(abs(np.linalg.det(self._cell_np)))
        masses = get_atomic_masses(model.atomic_numbers_of(self.species[0]))
        # dummy (-1) padding atoms feel zero force; unit mass keeps the
        # integrator's 1/m finite so they simply never move
        self.masses = torch.where(self.species[0] < 0, 1.0, masses)
        self._inv_m = (ACCEL_UNIT / self.masses)[:, None]
        a = self.species.shape[1]
        self.capacity = capacity or estimate_capacity(self.build_radius, a, periodic=pbc)
        # auto_capacity: after the first build, shrink the static neighbor
        # capacity to the measured max occupancy (+12% and 4 lanes margin).
        # Only when the user didn't pin a capacity; overflow stays flagged
        # either way.
        self._auto_capacity = auto_capacity and capacity is None
        self.bucket_capacity = bucket_capacity
        # Verlet-cache lanes are distance-sorted at build time, so any lane
        # that can come within the angular cutoff before the next rebuild
        # (build-dist <= r_ang + skin, by the same displacement bound as the
        # skin criterion) lives in a static prefix.  The bound is verified
        # per build (overflow flag) in _build_cache.
        self._ang_prefix: tp.Optional[int] = None
        if not npt_compression and model.potentials["nnp"].enabled:
            r_ang = float(model.aev_computer.angular.cutoff)
            prefix = estimate_capacity(r_ang + skin, a, periodic=pbc)
            if prefix < self.capacity:
                self._ang_prefix = prefix
                self.model = _with_aev_fields(model, angular_preslice=prefix)
        # Per-POTENTIAL static lane prefixes: where a long-cutoff potential
        # (D3 dispersion at 8 A) sets the build radius, the short-cutoff
        # potentials (the AEV at 5.2 A, the repulsion) must not pay for the
        # wider K: their reach lives in a static prefix of the
        # distance-sorted lanes, by the same displacement bound as the
        # angular prefix, verified per build.  `_potential_energy` then
        # gives each potential its own lane slice.
        self._lane_prefixes: tp.Dict[str, int] = {}
        self._prefix_checks: tp.List[tp.Tuple[float, int]] = []
        for pname, pot in self.model.potentials.items():
            r_pot = float(pot.cutoff)
            if npt_compression or not pot.enabled or not math.isfinite(r_pot):
                continue
            if r_pot + skin >= self.cutoff + skin - 1e-9:
                continue  # already the build cutoff
            p = estimate_capacity(r_pot + skin, a, periodic=pbc)
            if p < self.capacity:
                self._lane_prefixes[pname] = p
        for p in sorted(set(self._lane_prefixes.values())):
            r_phys = max(
                float(self.model.potentials[n].cutoff)
                for n, pp in self._lane_prefixes.items()
                if pp == p
            )
            self._prefix_checks.append((r_phys, p))
        # bucket refresh (periodic systems): "auto" = on for periodic cells;
        # the slot capacity is measured at the first init
        self._bucket_on = (
            bool(bucket_refresh) if bucket_refresh != "auto" else cell is not None
        ) and cell is not None
        self._bucket_packed = bucket_refresh == "packed"
        self._bucket_c: tp.Optional[int] = None
        self._bucket_span: tp.Optional[tp.Tuple[int, int]] = None
        self._wrapshift: tp.Optional[Tensor] = None
        self.grid_shape: tp.Optional[tp.Tuple[int, int, int]] = None
        if self._cell_np is not None:
            self.grid_shape = _static_grid_shape(self._cell_np, self.build_radius)
        self._angular_split_done = False

    # ---- static capacities, measured once ----
    def _ensure_grid(self, coords: Tensor) -> None:
        """Non-periodic: fix the bucket-grid shape from the initial extent
        (the bounding cell itself is recomputed at each build; a fixed grid
        shape only affects bucket occupancy, not results)."""
        if self.grid_shape is None and self.cell is None:
            extent = coords.detach().cpu().numpy().reshape(-1, 3)
            span = extent.max(axis=0) - extent.min(axis=0) + 2e-3
            cell = np.diag(np.maximum(span, self.build_radius))
            self.grid_shape = _static_grid_shape(cell, self.build_radius)

    def _bucket_histogram(self, coords: Tensor) -> tp.Optional[np.ndarray]:
        """(G,) atoms-per-bucket of the initial configuration (host numpy);
        None when there is no periodic cell to bin against."""
        if self._cell_np is None:
            return None
        gx, gy, gz = self.grid_shape
        pos = self._to_internal(coords).detach().cpu().numpy().astype(np.float64)
        pos = pos.reshape(-1, 3)[self._valid_atom]
        u = pos @ np.linalg.inv(self._cell_np)
        m = np.clip(u - np.floor(u), 0.0, 1.0 - 1e-9)
        gdims = np.array([gx, gy, gz])
        idx3 = np.minimum((m * gdims).astype(np.int64), gdims - 1)
        bucket = (idx3[:, 0] * gy + idx3[:, 1]) * gz + idx3[:, 2]
        return np.bincount(bucket, minlength=gx * gy * gz)

    def _measure_occupancy(self, coords: Tensor) -> tp.Optional[int]:
        """Max atoms-per-bucket of the initial configuration (host numpy)."""
        counts = self._bucket_histogram(coords)
        return None if counts is None else int(counts.max())

    def _ensure_bucket_capacity(self, coords: Tensor) -> None:
        """Pin the cell list's bucket capacity to the measured occupancy: the
        default (twice the mean) under-allocates for clustered
        configurations.  Overflow during the run is still flagged per
        rebuild."""
        if self.bucket_capacity is not None:
            return
        occ = self._measure_occupancy(coords)
        if occ is not None:
            self.bucket_capacity = int(-(-int(occ * 1.12 + 2) // 8) * 8)

    def _ensure_bucket(self, coords: Tensor) -> None:
        """Fix the bucket refresh's slot capacity from the initial occupancy
        (host).  ``c`` gets a margin over the measured max atoms-per-bucket,
        rounded up by the JAX package's rule (so ``c * K`` is a multiple of
        128 there), which keeps the two packages' tables the same shape.  The
        refresh turns itself off only where the JAX package's does: no
        periodic cell, a grid under 3 buckets per axis, or more slots than a
        key's 8 rank bits hold."""
        if not self._bucket_on or self._bucket_c is not None:
            return
        if min(self.grid_shape) < 3:
            # cell_list falls back to all-pairs images here (no bucket aux)
            self._bucket_on = False
            return
        counts = self._bucket_histogram(coords)
        if counts is None:
            self._bucket_on = False
            return
        want = int(int(counts.max()) * 1.08 + 2)
        step = -(-128 // math.gcd(self.capacity, 128) // 16) * 16
        c = -(-want // step) * step
        if c > MAX_SLOTS:
            self._bucket_on = False
            return
        self._bucket_c = c
        if self._bucket_packed:
            # static (buckets per span, rows per span) of the atom-packed
            # layout, measured like the other capacities
            try:
                kl = -(-self.capacity // 128) * 128
                self._bucket_span = choose_span(self.grid_shape, counts, c, kl)
            except ValueError:
                self._bucket_packed = False
        self._wrapshift = torch.as_tensor(
            make_wrapshift(self.grid_shape, self._cell_np), device=self.device
        )

    @torch.no_grad()
    def _ensure_angular_split(self, state: MDState, coords: Tensor) -> None:
        """Set the count-class angular split (`AEVComputer.angular_split`)
        from the counts measured at the first `init`, by the JAX package's
        rule.

        In a liquid most atoms have far fewer neighbors within the angular
        cutoff than the static capacity holds, and the plain angular path's
        work grows as the square of the lanes it runs.  One host read of the
        ``(A,)`` counts picks the ``(k_small, n_dense)`` of least estimated
        pair-lane work, with a drift margin, or none when the saving is
        under 15% (or for fewer than 2,048 atoms, a capacity under 16, or a
        disabled network potential); the split goes on this instance's model
        copy.  The plain path then NaN-poisons a step whose counts outgrow
        it; on the card K3 runs over the whole table and ignores it.
        """
        if self._angular_split_done:
            return
        self._angular_split_done = True
        if not self.model.potentials["nnp"].enabled:
            return
        a = int(coords.shape[0])
        if a < 2048:
            return  # the split's sort would cost more than it saves
        aevc = self.model.aev_computer
        r_ang = float(aevc.angular.cutoff)
        cap = aevc._angular_capacity(self.capacity)
        if cap < 16:
            return
        nb = narrow_to_cutoff(_refresh_neighbors(state, coords), r_ang)
        counts = np.minimum(nb.mask.sum(dim=1).cpu().numpy(), cap)
        split = choose_angular_split(counts, cap)
        if split is not None:
            self.model = _with_aev_fields(self.model, angular_split=split)

    def _to_internal(self, coords: Tensor) -> Tensor:
        if self._species_perm is None:
            return coords
        return coords.index_select(0, self._species_perm)

    # ---- neighbor (re)builds ----
    @torch.no_grad()
    def _build_cache(self, coords: Tensor):
        """The Verlet cache at ``coords`` (user order): ``(idx, mask, shift,
        nbr_elem, overflow, tables, pair_aux)``, all detached, in internal
        order."""
        coords = self._to_internal(coords.detach())
        bucket_on = self._bucket_c is not None
        built = cell_list(
            self.build_radius,
            self.elem_idxs,
            coords[None],
            self.cell,
            self.pbc,
            capacity=self.capacity,
            bucket_capacity=self._bucket_c if bucket_on else self.bucket_capacity,
            grid_shape=self.grid_shape,
            bucket_aux=bucket_on,
        )
        nbrs, aux = built if bucket_on else (built, None)
        idx, mask, dist = nbrs.idx[0], nbrs.mask[0], nbrs.dist[0]
        overflow = nbrs.overflow
        if bucket_on:
            keys_atom = aux["keys"]
            # broadcastable placeholder: nothing reads shifts in bucket mode
            shift = coords.new_zeros((1, 1, 3))
        else:
            # reconstruct cartesian shifts: diff - (x_j - x_i)
            a, k = idx.shape
            nbr_pos = coords.index_select(0, idx.reshape(-1)).reshape(a, k, 3)
            shift = nbrs.diff[0] - (nbr_pos - coords[:, None, :])
            shift = torch.where(mask[..., None], shift, 0.0)
        if self._ang_prefix is not None or self._lane_prefixes:
            # Sort lanes by build distance (amortized over the Verlet window)
            # so every short-reach lane set occupies a static prefix; verify
            # that each prefix bound holds for this build.  Stable: equal
            # distances keep the lower lane first, masked lanes sort last.
            skeys = torch.where(mask, dist, math.inf)
            order = torch.sort(skeys, dim=-1, stable=True).indices
            if bucket_on:
                idx, mask, keys_atom, skeys = lane_permute((idx, mask, keys_atom, skeys), order)
            else:
                idx, mask, shift, skeys = lane_permute((idx, mask, shift, skeys), order)
            dist = torch.where(mask, skeys, 1.0)  # keep dist lane-aligned
            checks = list(self._prefix_checks)
            if self._ang_prefix is not None:
                r_ang = float(self.model.aev_computer.angular.cutoff)
                checks.append((r_ang, self._ang_prefix))
            for r_phys, p in checks:
                in_reach = torch.sum(mask & (skeys <= r_phys + self.skin), dim=-1)
                overflow = overflow | torch.any(in_reach > p)
        # cache neighbor species (topology only): with the species-sorted
        # internal order, species-of-atom-index is a step function
        vals, starts = self._elem_steps
        nbr_elem = torch.full_like(idx, vals[0])
        for v, s in zip(vals[1:], starts[1:]):
            nbr_elem = torch.where(idx >= s, v, nbr_elem)
        nbr_elem = torch.where(mask, nbr_elem, -1)
        # frozen per-window pair channels (see freeze_pair_window), from the
        # build-time table: the configuration every other cached quantity
        # reflects
        pair_aux = None
        if self._freeze_pair:
            nb_build = Neighbors(
                idx=idx, mask=mask, diff=coords.new_zeros(tuple(idx.shape) + (3,)),
                dist=torch.where(mask, dist, 1.0), overflow=overflow, elem=nbr_elem,
            )
            pair_aux = {}
            for n in self._freeze_pair:
                ch = self.model.potentials[n].frozen_window_channels(
                    self.elem_idxs.reshape(-1), nb_build
                )
                if ch is not None:
                    pair_aux[n] = ch
            pair_aux = pair_aux or None
        tables = None
        if bucket_on:
            tables = tables_from_cell_aux(
                keys_atom, mask, aux["atom_of_slot"], aux["slot_of_atom"],
                coords - aux["central"], self._wrapshift, self._bucket_c,
            )
            if self._bucket_span is not None:
                tables, packed_overflow = pack_tables(tables, *self._bucket_span)
                overflow = overflow | packed_overflow
        return idx, mask, shift, nbr_elem, overflow, tables, pair_aux

    def _potential_energy(
        self,
        nb: Neighbors,
        cs: Tensor,
        pair_aux: tp.Optional[tp.Dict[str, Tensor]] = None,
        model=None,
    ) -> Tensor:
        """Total potential energy from a refreshed table (internal order), of
        ``model`` (a copy of ``self.model`` with some terms disabled) or by
        default of ``self.model``.

        Without lane prefixes and frozen channels this is
        ``model.compute_from_neighbors`` with the species known here.  With
        them each short-cutoff potential runs on its own STATIC prefix of the
        distance-sorted lanes instead of the full K, and ``pair_aux`` (the
        state's frozen window channels) is attached per potential, cut to
        the same prefix."""
        model = self.model if model is None else model
        if not self._lane_prefixes and not self._freeze_pair:
            nbn = narrow_to_cutoff(nb, self.cutoff)
            out = model.compute_from_neighbors(
                self.elem_idxs, cs[None], _batch1(nbn), species_ranges=self._species_ranges
            )
            return torch.sum(out.energies)
        e = cs.new_zeros(())
        for name in sorted(model.potentials):
            pot = model.potentials[name]
            if not pot.enabled:
                continue
            p = self._lane_prefixes.get(name)
            nbp = _slice_lanes(nb, p) if p is not None else nb
            nbp = narrow_to_cutoff(nbp, min(float(pot.cutoff), self.cutoff))
            if pair_aux is not None and name in pair_aux:
                aux = pair_aux[name]
                nbp = nbp.replace(pair_aux=aux if p is None else aux[:, :p])
            with scope(f"potential.{name}"):
                e = e + torch.sum(
                    pot._energies_from_neighbors(
                        self.elem_idxs, cs[None], _batch1(nbp),
                        species_ranges=self._species_ranges,
                    )
                )
        if model.energy_shifter.enabled:
            e = e + torch.sum(model.energy_shifter(self.elem_idxs))
        return e

    def _energy_and_forces(self, state: MDState, coords: Tensor) -> tp.Tuple[Tensor, Tensor]:
        """Energy and forces at ``coords`` (user order) on the cached
        topology; a fresh graph per call, nothing of it is kept."""
        with scope("md.forces"), torch.enable_grad():
            c = coords.detach().requires_grad_(True)
            with scope("md.refresh"):
                nb = _refresh_neighbors(state, c)
            e = self._potential_energy(nb, self._to_internal(c), state.pair_aux)
            with scope("md.backward"):
                (g,) = torch.autograd.grad(e, c)
        return e.detach(), -g

    def _energy_forces_virial(
        self, state: MDState, coords: Tensor, scale: Tensor
    ) -> tp.Tuple[Tensor, Tensor, Tensor]:
        """Energy, forces and dU/dscale in one backward (NPT), evaluated in
        the reduced frame: the pair vectors are scale times the reduced ones,
        so the derivative with respect to scale at fixed reduced coordinates
        is the pair virial G = sum_pairs r_ij . dU/dr_ij = scale dU/dscale.
        The physical forces are the reduced gradient over scale."""
        red = (coords / scale).detach().requires_grad_(True)
        s = scale.detach().clone().requires_grad_(True)
        with torch.enable_grad():
            nb = _refresh_neighbors(state, red, s)
            e = self._potential_energy(nb, self._to_internal(red * s), state.pair_aux)
            gr, gs = torch.autograd.grad(e, (red, s))
        return e.detach(), -gr / scale, gs

    def init(
        self,
        coords,  # (A, 3) or (1, A, 3)
        temperature: tp.Optional[float] = None,
        generator: tp.Optional[torch.Generator] = None,
    ) -> MDState:
        """The state at ``coords``: capacities measured (first call only),
        the Verlet cache built, energy and forces evaluated.  Velocities are
        zero, or drawn at ``temperature`` from ``generator`` (a CPU generator
        seeded with 0 by default).  The state's Langevin generator is
        ``generator`` itself where it lies on the model's device, else a
        generator there seeded by one draw from ``generator``."""
        coords = as_tensor(coords, torch.float32, self.device).detach()
        if coords.dim() == 3:
            coords = coords[0]
        self._ensure_grid(coords)
        self._ensure_bucket_capacity(coords)  # before any build runs
        if self._auto_capacity:
            self._auto_capacity = False  # measure once, on the first init
            mask0 = self._build_cache(coords)[1]
            occ = int(mask0.sum(dim=-1).max())
            tight = int(-(-int(occ * 1.12 + 4) // 8) * 8)
            if tight < self.capacity:
                self.capacity = tight
        self._ensure_bucket(coords)  # after the final K is known
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        if temperature is not None:
            velocities = maxwell_boltzmann_velocities(generator, self.masses, temperature)
        else:
            velocities = torch.zeros_like(coords)
        noise_gen = generator
        if generator.device.type != self.device.type:
            seed = int(torch.randint(0, 2**62, (), generator=generator, device=generator.device))
            noise_gen = torch.Generator(device=self.device).manual_seed(seed)
        idx, mask, shift, nbr_elem, overflow, tables, pair_aux = self._build_cache(coords)
        state = MDState(
            coords=coords,
            velocities=velocities,
            forces=torch.zeros_like(coords),
            energy=coords.new_zeros(()),
            nbr_idx=idx,
            nbr_mask=mask,
            nbr_shift=shift,
            nbr_elem=nbr_elem,
            ref_coords=coords,
            overflow=overflow,
            nbr_perm=self._species_perm,
            bucket=tables,
            pair_aux=pair_aux,
            generator=noise_gen,
        )
        self._ensure_angular_split(state, coords)
        e, f = self._energy_and_forces(state, coords)
        return state.replace(energy=e, forces=f)

    @torch.no_grad()
    def _maybe_rebuild(self, state: MDState, coords: Tensor) -> MDState:
        """Rebuild the cache at ``coords`` if a pair can have closed the skin
        gap: when the SUM of the two largest per-atom displacements since the
        last build exceeds the skin.  The decision is read on the host
        (``md.rebuild_check``, a wait for the device); the rebuild, when
        taken, is ``md.rebuild``.  A rebuild changes no static size; an
        overflow sets the flag (and poisons the AEV with NaN).

        NPT (``state.scale`` set): the table covers physical pair distances
        up to ``scale * build_radius``, so the gap is that less the cutoff;
        displacements are physical, which charges the barostat's affine
        motion twice (conservative).  The build takes the reduced
        coordinates, and flags an overflow once the box has shrunk past the
        ``npt_compression`` margin."""
        with scope("md.rebuild_check", wait=True):
            moved2 = torch.sum((coords - state.ref_coords) ** 2, dim=-1)
            top2 = torch.topk(moved2, min(2, moved2.shape[0])).values
            if state.scale is None:
                gap = self.build_radius - self.cutoff
            else:
                gap = state.scale * self.build_radius - self.cutoff
            need = bool(torch.sum(torch.sqrt(top2)) > gap)
        if not need:
            return state
        with scope("md.rebuild"):
            red = coords if state.scale is None else coords / state.scale
            idx, mask, shift, nbr_elem, overflow, tables, pair_aux = self._build_cache(red)
            if state.scale is not None:
                overflow = overflow | (state.scale * self.build_radius < self.cutoff)
        return state.replace(
            nbr_idx=idx,
            nbr_mask=mask,
            nbr_shift=shift,
            nbr_elem=nbr_elem,
            ref_coords=coords,
            rebuilds=state.rebuilds + 1,
            overflow=state.overflow | overflow,
            bucket=tables,
            pair_aux=pair_aux,
        )

    # ---- integrator ----
    def step_nve(self, state: MDState) -> MDState:
        """One Velocity-Verlet step."""
        dt = self.dt
        with scope("md.step"):
            with scope("md.integrate"), torch.no_grad():
                v_half = state.velocities + 0.5 * dt * state.forces * self._inv_m
                coords = state.coords + dt * v_half
            state = self._maybe_rebuild(state, coords)
            e, f = self._energy_and_forces(state, coords)
            with scope("md.integrate"), torch.no_grad():
                v = v_half + 0.5 * dt * f * self._inv_m
            return state.replace(
                coords=coords, velocities=v, forces=f, energy=e, step=state.step + 1
            )

    def run_nve(self, state: MDState, num_steps: int) -> MDState:
        """Run ``num_steps`` NVE steps."""
        for _ in range(num_steps):
            state = self.step_nve(state)
        return state

    def step_langevin(
        self,
        state: MDState,
        temperature: float,
        friction_per_fs: float = 0.01,
        noise: tp.Optional[Tensor] = None,
    ) -> MDState:
        """One BAOAB Langevin (NVT) step: half kick, half drift, the O step
        (`langevin_o_step`), half drift, then the rebuild check and forces,
        and a half kick.  ``noise`` (``(A, 3)``, standard normal) is drawn
        from ``state.generator`` unless given.

        Nothing reads the position between the two half drifts, so their sum
        is added to the coordinates at once: one rounding, as in
        `step_nve`'s drift, so that without friction the step is velocity
        Verlet to the bit (the JAX package rounds after each half drift)."""
        dt = self.dt
        with torch.no_grad():
            v_half = state.velocities + 0.5 * dt * state.forces * self._inv_m
            if noise is None:
                gen = state.generator
                if gen is None:
                    raise ValueError(
                        "the state has no generator for the Langevin noise; set one with "
                        "state.replace(generator=torch.Generator(device).manual_seed(seed))"
                    )
                noise = torch.randn(
                    tuple(v_half.shape), generator=gen, device=gen.device, dtype=v_half.dtype
                ).to(v_half.device)
            v = langevin_o_step(v_half, self.masses, dt, temperature, friction_per_fs, noise)
            coords = state.coords + 0.5 * dt * (v_half + v)
        state = self._maybe_rebuild(state, coords)
        e, f = self._energy_and_forces(state, coords)
        with torch.no_grad():
            v = v + 0.5 * dt * f * self._inv_m
        return state.replace(
            coords=coords, velocities=v, forces=f, energy=e, step=state.step + 1
        )

    def run_langevin(
        self,
        state: MDState,
        num_steps: int,
        temperature: float,
        friction_per_fs: float = 0.01,
    ) -> MDState:
        """Run ``num_steps`` Langevin steps at ``temperature`` (Kelvin)."""
        for _ in range(num_steps):
            state = self.step_langevin(state, temperature, friction_per_fs)
        return state

    def step_nvt_nose_hoover(
        self, state: MDState, temperature: float, tau_fs: float = 25.0
    ) -> MDState:
        """One deterministic NVT step: a Nose-Hoover chain half step around
        velocity Verlet on each side (`run_nvt_nose_hoover` installs the
        chain state)."""
        if state.nhc is None:
            raise ValueError("the state has no Nose-Hoover chain; use run_nvt_nose_hoover")
        dt = self.dt
        kt = KB_HARTREE * temperature
        dof = 3 * self._n_real
        m = state.nhc.shape[1]
        q = [dof * kt * tau_fs**2] + [kt * tau_fs**2] * (m - 1)
        with torch.no_grad():
            v, nhc = _nhc_update(state.velocities, state.nhc, self.masses, dof, kt, q, 0.5 * dt)
            v_half = v + 0.5 * dt * state.forces * self._inv_m
            coords = state.coords + dt * v_half
        state = self._maybe_rebuild(state, coords)
        e, f = self._energy_and_forces(state, coords)
        with torch.no_grad():
            v = v_half + 0.5 * dt * f * self._inv_m
            v, nhc = _nhc_update(v, nhc, self.masses, dof, kt, q, 0.5 * dt)
        return state.replace(
            coords=coords, velocities=v, forces=f, energy=e, nhc=nhc, step=state.step + 1
        )

    def run_nvt_nose_hoover(
        self,
        state: MDState,
        num_steps: int,
        temperature: float,
        tau_fs: float = 25.0,
        chain: int = 3,
    ) -> MDState:
        """Deterministic NVT through a Nose-Hoover chain of ``chain``
        thermostats (installed at rest where the state has none)."""
        state, step = self._ensemble_step(
            state, "nvt-nhc", dict(temperature=temperature, tau_fs=tau_fs, chain=chain)
        )
        for _ in range(num_steps):
            state = step(state)
        return state

    def step_npt_berendsen(
        self,
        state: MDState,
        temperature: float,
        pressure_bar: float = 1.0,
        tau_t_fs: float = 100.0,
        tau_p_fs: float = 1000.0,
        kappa_per_bar: float = 4.6e-5,
    ) -> MDState:
        """One isothermal-isobaric step: Berendsen weak coupling of the
        temperature and the (isotropic) pressure around velocity Verlet
        (`run_npt_berendsen` installs ``state.scale``).  The pressure is
        ``(2 K - G) / (3 V)`` with the pair virial ``G = scale dU/dscale``
        of the force backward; ``kappa_per_bar`` is the isothermal
        compressibility (liquid water by default)."""
        if state.scale is None:
            raise ValueError("the state has no cell scale; use run_npt_berendsen")
        dt = self.dt
        with torch.no_grad():
            v_half = state.velocities + 0.5 * dt * state.forces * self._inv_m
            coords = state.coords + dt * v_half
        state = self._maybe_rebuild(state, coords)
        e, f, du_ds = self._energy_forces_virial(state, coords, state.scale)
        with torch.no_grad():
            v = v_half + 0.5 * dt * f * self._inv_m
            # Berendsen thermostat: a weak-coupling velocity rescale
            ke = 0.5 * torch.sum(self.masses[:, None] * v**2) / ACCEL_UNIT  # Hartree
            t_inst = 2.0 * ke / (3 * self._n_real * KB_HARTREE)
            lam2 = 1.0 + (dt / tau_t_fs) * (temperature / torch.clamp(t_inst, min=1.0) - 1.0)
            v = v * torch.sqrt(torch.clamp(lam2, 0.81, 1.21))
            # Berendsen barostat: an isotropic rescale toward the pressure
            volume = self._volume0 * state.scale**3
            p_bar = (2.0 * ke - state.scale * du_ds) / (3.0 * volume) * PRESSURE_UNIT_BAR
            mu3 = 1.0 - (dt / tau_p_fs) * kappa_per_bar * (pressure_bar - p_bar)
            mu = torch.clamp(mu3, 0.97, 1.03) ** (1.0 / 3.0)
        return state.replace(
            coords=coords * mu, velocities=v, forces=f, energy=e, scale=state.scale * mu,
            step=state.step + 1,
        )

    def run_npt_berendsen(
        self,
        state: MDState,
        num_steps: int,
        temperature: float,
        pressure_bar: float = 1.0,
        tau_t_fs: float = 100.0,
        tau_p_fs: float = 1000.0,
        kappa_per_bar: float = 4.6e-5,
    ) -> MDState:
        """Isotropic Berendsen NPT (periodic systems only).  Construct this
        object with ``npt_compression`` (e.g. 0.1) for the box's headroom;
        past that margin the ``overflow`` flag trips (`rebaseline` then
        re-centres it).  The physical cell is ``state.scale * cell``."""
        state, step = self._ensemble_step(state, "npt", dict(
            temperature=temperature, pressure_bar=pressure_bar, tau_t_fs=tau_t_fs,
            tau_p_fs=tau_p_fs, kappa_per_bar=kappa_per_bar,
        ))
        for _ in range(num_steps):
            state = step(state)
        return state

    def rebaseline(self, state: MDState) -> tp.Tuple["MolecularDynamics", MDState]:
        """Fold an NPT state's scale into a new `MolecularDynamics` whose initial cell is
        ``scale * cell`` (grids, capacities and the compression margin
        re-centred, scale back to 1), and a state that continues the same
        trajectory: coordinates, velocities, generator, step and chain kept,
        the cache rebuilt and the forces evaluated anew (the same physical
        system, so the same energy)."""
        if state.scale is None:
            raise ValueError("rebaseline applies to NPT states (scale set)")
        if self.cell is None:
            raise ValueError("rebaseline requires a periodic cell")
        kw = dict(self._ctor)
        kw["cell"] = self._cell_np * float(state.scale)
        md = MolecularDynamics(**kw)
        st = md.init(state.coords)
        return md, st.replace(
            velocities=state.velocities, generator=state.generator, step=state.step,
            nhc=state.nhc, scale=state.coords.new_ones(()),
        )

    def _ensemble_step(
        self, state: MDState, ensemble: str, params: tp.Dict[str, tp.Any]
    ) -> tp.Tuple[MDState, tp.Callable[[MDState], MDState]]:
        """``(prepared state, one-step function)`` of an ensemble name:
        ``"nve"``; ``"langevin"`` / ``"nvt"`` (``temperature``,
        ``friction_per_fs``); ``"nvt-nhc"`` (``temperature``, ``tau_fs``,
        ``chain``: a chain at rest is installed where the state has none);
        ``"npt"`` (``temperature``, ``pressure_bar``, ``tau_t_fs``,
        ``tau_p_fs``, ``kappa_per_bar``: scale 1 is installed where the state
        has none).  Shared by the ``run_*`` methods, `trajectory` and
        `MultipleTimestepMD.run`."""
        p = dict(params)
        if ensemble == "nve":
            step = self.step_nve
        elif ensemble in ("langevin", "nvt"):
            t = float(p.pop("temperature"))
            fr = float(p.pop("friction_per_fs", 0.01))

            def step(st: MDState) -> MDState:
                return self.step_langevin(st, t, fr)
        elif ensemble == "nvt-nhc":
            t = float(p.pop("temperature"))
            tau = float(p.pop("tau_fs", 25.0))
            chain = int(p.pop("chain", 3))
            if state.nhc is None:
                state = state.replace(nhc=state.coords.new_zeros((2, chain)))

            def step(st: MDState) -> MDState:
                return self.step_nvt_nose_hoover(st, t, tau)
        elif ensemble == "npt":
            if self.cell is None:
                raise ValueError("NPT requires a periodic cell")
            t = float(p.pop("temperature"))
            pb = float(p.pop("pressure_bar", 1.0))
            tau_t = float(p.pop("tau_t_fs", 100.0))
            tau_p = float(p.pop("tau_p_fs", 1000.0))
            kappa = float(p.pop("kappa_per_bar", 4.6e-5))
            if state.scale is None:
                state = state.replace(scale=state.coords.new_ones(()))

            def step(st: MDState) -> MDState:
                return self.step_npt_berendsen(st, t, pb, tau_t, tau_p, kappa)
        else:
            raise ValueError(f"unknown ensemble {ensemble!r}")
        if p:
            raise TypeError(f"unused {ensemble} parameters: {sorted(p)}")
        return state, step

    def trajectory(
        self,
        state: MDState,
        num_steps: int,
        record_every: int = 10,
        ensemble: str = "nve",
        **params,
    ) -> tp.Tuple[MDState, tp.Dict[str, Tensor]]:
        """Run ``num_steps`` steps of ``ensemble`` (parameters as
        `_ensemble_step` takes them), recording a frame every
        ``record_every`` steps.

        Returns ``(final state, traj)`` with ``traj["coords"] (F, A, 3)``,
        ``"energies" (F,)``, ``"temperatures" (F,)`` (Kelvin, over the real
        atoms' degrees of freedom) and, under NPT, ``"scales" (F,)``.  The
        frames are preallocated on the model's device and copied in there:
        recording adds no wait for the device to the steps' own."""
        if num_steps % record_every:
            raise ValueError("num_steps must be a multiple of record_every")
        state, step = self._ensemble_step(state, ensemble, params)
        frames = num_steps // record_every
        new = state.coords.new_empty
        traj = {
            "coords": new((frames,) + tuple(state.coords.shape)),
            "energies": new((frames,)),
            "temperatures": new((frames,)),
        }
        if state.scale is not None:
            traj["scales"] = new((frames,))
        dof_kb = 3 * self._n_real * KB_HARTREE
        for frame in range(frames):
            for _ in range(record_every):
                state = step(state)
            with torch.no_grad():
                ke = 0.5 * torch.sum(self.masses[:, None] * state.velocities**2) / ACCEL_UNIT
                traj["coords"][frame] = state.coords
                traj["energies"][frame] = state.energy
                traj["temperatures"][frame] = 2.0 * ke / dof_kb
                if state.scale is not None:
                    traj["scales"][frame] = state.scale
        return state, traj


@dataclasses.dataclass(frozen=True)
class MTSState:
    """State of a multiple-timestep (RESPA) run: the fast lane's full MD
    state and the slow lane's (its ``forces`` and ``energy`` hold the slow
    component; its ``coords`` mirror the fast state's at outer steps)."""

    fast: MDState
    slow: MDState

    # combined views, valid at outer-step boundaries
    @property
    def coords(self) -> Tensor:
        return self.fast.coords

    @property
    def velocities(self) -> Tensor:
        return self.fast.velocities

    @property
    def energy(self) -> Tensor:
        """Total potential energy (fast + slow lanes)."""
        return self.fast.energy + self.slow.energy

    @property
    def forces(self) -> Tensor:
        """Total forces (fast + slow lanes), user atom order."""
        return self.fast.forces + self.slow.forces

    @property
    def overflow(self) -> Tensor:
        return self.fast.overflow | self.slow.overflow

    @property
    def rebuilds(self) -> int:
        return self.fast.rebuilds + self.slow.rebuilds

    @property
    def step(self) -> int:
        return self.fast.step

    def replace(self, **changes) -> "MTSState":
        return dataclasses.replace(self, **changes)


class MultipleTimestepMD:
    """RESPA (impulse) multiple-timestep MD for models with a long-cutoff
    smooth tail, such as ANI-2dr's 8 A D3 dispersion over a 5.2 A network
    core.  Two independent Verlet-cached lanes, each a `MolecularDynamics`
    on its own copy of the model (the caller's model is left as it was):

    - **fast lane**: every enabled potential not in ``slow_names`` and the
      self energies, with its own cell grid and neighbor table at the
      fast cutoff + ``skin``, stepped every ``timestep_fs``;
    - **slow lane**: the ``slow_names`` potentials only (by default every
      enabled potential whose cutoff is past the networks'), evaluated
      once per ``every`` inner steps as a velocity impulse of ``every * dt
      * F_slow``, half before the inner steps and half after.  Its wide
      table is checked for a rebuild only then, at ``slow_skin`` (default
      ``skin``).  With ``cache_slow_constants`` its potentials' per-window
      constants are frozen per rebuild (``freeze_pair_window``).

    With ``every=1`` the scheme is velocity Verlet on the full model.  Keep
    ``every * timestep_fs`` at or below ~4 fs (impulse RESPA resonates near
    half the fastest period, ~10 fs X-H stretches).

    >>> mts = MultipleTimestepMD(model, species, cell=cell, pbc=True, every=4)
    >>> state = mts.init(coords, temperature=300.0)
    >>> state = mts.run(state, 1000)            # 1000 fs of NVE
    >>> e, f = state.energy, state.forces       # total (fast + slow)
    """

    def __init__(
        self,
        model,
        species,  # (1, A) atomic numbers, or element indices (periodic_table_index=False)
        cell=None,
        pbc: bool = False,
        every: int = 4,
        slow_names: tp.Optional[tp.Sequence[str]] = None,
        skin: float = 0.75,
        slow_skin: tp.Optional[float] = None,
        timestep_fs: float = 1.0,
        cache_slow_constants: bool = True,
        **md_kwargs,
    ) -> None:
        if every < 1:
            raise ValueError("every must be >= 1")
        self.every = int(every)
        self.dt = timestep_fs
        if slow_names is None:
            r_fast = float(model.potentials["nnp"].cutoff)
            slow_names = tuple(
                n for n, p in model.potentials.items()
                if p.enabled and float(p.cutoff) > r_fast
            )
        self.slow_names = tuple(slow_names)
        if not self.slow_names:
            raise ValueError(
                "MTS needs at least one enabled potential with a cutoff "
                "beyond the fast set (e.g. D3 dispersion over an NNP core)"
            )
        fast_names = [
            n for n, p in model.potentials.items() if p.enabled and n not in self.slow_names
        ]
        if not fast_names:
            raise ValueError("MTS fast set is empty; check slow_names")
        # self energies do not depend on the coordinates: the fast lane
        # alone carries them (state.energy sums the lanes)
        self.fast = MolecularDynamics(
            _with_enabled(model, fast_names, self_energies=True), species, cell=cell,
            pbc=pbc, skin=skin, timestep_fs=timestep_fs, **md_kwargs,
        )
        self.slow = MolecularDynamics(
            _with_enabled(model, self.slow_names, self_energies=False), species, cell=cell,
            pbc=pbc, skin=slow_skin if slow_skin is not None else skin,
            timestep_fs=timestep_fs,
            freeze_pair_window=self.slow_names if cache_slow_constants else (),
            **md_kwargs,
        )

    @property
    def masses(self) -> Tensor:
        return self.fast.masses

    def init(
        self,
        coords,
        temperature: tp.Optional[float] = None,
        generator: tp.Optional[torch.Generator] = None,
    ) -> MTSState:
        """Both lanes' states at ``coords``; velocities (and the Langevin
        generator) as `MolecularDynamics.init` makes them, on the fast lane."""
        fast = self.fast.init(coords, temperature=temperature, generator=generator)
        return MTSState(fast=fast, slow=self.slow.init(coords))

    def _outer_step(
        self, s: MTSState, inner_step: tp.Callable[[MDState], MDState]
    ) -> MTSState:
        """One RESPA outer step: slow half-impulse, ``every`` inner steps of
        the fast lane, the slow lane's rebuild check and forces, slow
        half-impulse."""
        half = 0.5 * self.every * self.dt
        inv_m = self.fast._inv_m
        with torch.no_grad():
            fast = s.fast.replace(velocities=s.fast.velocities + half * s.slow.forces * inv_m)
        for _ in range(self.every):
            fast = inner_step(fast)
        slow = self.slow._maybe_rebuild(s.slow, fast.coords)
        es, fs = self.slow._energy_and_forces(slow, fast.coords)
        slow = slow.replace(coords=fast.coords, energy=es, forces=fs)
        with torch.no_grad():
            fast = fast.replace(velocities=fast.velocities + half * fs * inv_m)
        return MTSState(fast=fast, slow=slow)

    def run(
        self, state: MTSState, num_steps: int, ensemble: str = "nve", **params
    ) -> MTSState:
        """Run ``num_steps`` INNER steps, a multiple of ``every``.
        Ensembles: ``"nve"``, or ``"langevin"`` / ``"nvt"`` with
        ``temperature`` and optionally ``friction_per_fs`` (the thermostat
        acts on the fast dynamics; the slow impulses stay outside it).  NPT
        and Nose-Hoover are not supported under MTS."""
        if num_steps % self.every:
            raise ValueError("num_steps must be a multiple of `every`")
        if ensemble in ("npt", "nvt-nhc"):
            raise ValueError(f"ensemble {ensemble!r} not supported under MTS")
        _, inner_step = self.fast._ensemble_step(state.fast, ensemble, params)
        for _ in range(num_steps // self.every):
            state = self._outer_step(state, inner_step)
        return state


class CachedSinglePoint:
    """Repeated same-system energy+force evaluation at MD-step cost.

    One-shot `torchani_tpu_torch.single_point` rebuilds the neighbor list
    from scratch at every call; workflows that evaluate many nearby
    geometries of ONE system (geometry optimization, dynamics loops run
    from outside, active-learning rescoring) should instead reuse
    `MolecularDynamics`' Verlet cache: each call recomputes only the differentiable
    refresh and the model, and the cached topology is rebuilt only when the
    displacement criterion demands it.

    >>> sp = CachedSinglePoint(model, species, cell=cell, pbc=True)
    >>> e0, f0 = sp(coords0)
    >>> e1, f1 = sp(coords1)   # same topology: no neighbor rebuild

    ``overflow`` reports whether ANY call's rebuild overflowed a static
    capacity (results are then unreliable, like the MD flag).
    """

    def __init__(
        self,
        model,
        species,  # (1, A) atomic numbers, or element indices (periodic_table_index=False)
        cell=None,
        pbc: bool = False,
        skin: float = 0.75,
        nn_precision: str = "highest",
        **md_kwargs,
    ) -> None:
        self._md = MolecularDynamics(
            model, species, cell=cell, pbc=pbc, skin=skin,
            nn_precision=nn_precision, **md_kwargs,
        )
        self._state: tp.Optional[MDState] = None

    @property
    def overflow(self) -> bool:
        if self._state is None:
            return False
        return bool(self._state.overflow)

    def reset(self) -> None:
        """Drop the cached topology (e.g. after changing the system)."""
        self._state = None

    def __call__(self, coords) -> tp.Tuple[Tensor, Tensor]:
        """Energy (scalar) and forces (A, 3) at ``coords`` (user order)."""
        if self._state is None:
            self._state = self._md.init(coords)
            return self._state.energy, self._state.forces
        coords = as_tensor(coords, torch.float32, self._md.device).detach()
        if coords.dim() == 3:
            coords = coords[0]
        state = self._md._maybe_rebuild(self._state, coords)
        e, f = self._md._energy_and_forces(state, coords)
        self._state = state.replace(coords=coords, energy=e, forces=f)
        return e, f
