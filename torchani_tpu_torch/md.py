"""Molecular dynamics with Verlet-cached neighbors (counterpart of
``torchani_tpu/md.py``, as far as the NVE loop and `CachedSinglePoint`, for
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
a Python loop over `MolecularDynamics.step_nve`; the rebuild decision is one
boolean read on the host per step.

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
from torchani_tpu_torch.utils import get_atomic_masses, resolve_device

__all__ = [
    "ACCEL_UNIT",
    "KB_HARTREE",
    "CachedSinglePoint",
    "MDState",
    "MolecularDynamics",
    "maxwell_boltzmann_velocities",
    "kinetic_temperature",
]

#: Hartree/(Angstrom * AMU) -> Angstrom/fs^2
ACCEL_UNIT = 0.2625499785
#: Boltzmann constant in Hartree/K
KB_HARTREE = 3.166811563e-06


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


def _shallow_copy(module: torch.nn.Module) -> torch.nn.Module:
    """A copy of ``module`` with its own attribute and submodule tables that
    shares every parameter, buffer and submodule with the original."""
    new = copy.copy(module)
    new._modules = dict(module._modules)
    new._parameters = dict(module._parameters)
    new._buffers = dict(module._buffers)
    return new


def _with_angular_preslice(model, prefix: int):
    """A model copy whose AEV computer pre-slices the (sorted) table.  The
    caller's model, and its AEV computer, stay as they were; weights and
    buffers are shared."""
    nnp = _shallow_copy(model.potentials["nnp"])
    aevc = _shallow_copy(nnp.aev_computer)
    aevc.angular_preslice = prefix
    nnp.aev_computer = aevc
    potentials = _shallow_copy(model.potentials)
    potentials["nnp"] = nnp
    model = _shallow_copy(model)
    model.potentials = potentials
    return model


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


def _refresh_neighbors(state: MDState, coords: Tensor) -> Neighbors:
    """Recompute differentiable diff/dist from the cached topology.

    ``coords`` is in user order; the cached topology is in species-sorted
    internal order (see `MDState`), so the produced tables are internal-order
    rows matching `MolecularDynamics`' (sorted) ``elem_idxs``.
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
    """

    def __init__(
        self,
        model,
        species,  # (1, A) atomic numbers
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
    ) -> None:
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
        host_elem = model.species_converter(self.species)[0].cpu().numpy()
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
        self._cell_np = None if cell is None else np.asarray(
            cell.detach().cpu().numpy() if isinstance(cell, torch.Tensor) else cell,
            dtype=np.float64,
        )
        self.cell = None if cell is None else as_tensor(cell, torch.float32, dev)
        self.pbc = torch.ones(3, dtype=torch.bool, device=dev) if pbc else None
        self.skin = skin
        self.cutoff = model.cutoff
        self.dt = timestep_fs
        self.build_radius = self.cutoff + skin
        masses = get_atomic_masses(self.species[0].clamp(min=0))
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
        if model.potentials["nnp"].enabled:
            r_ang = float(model.aev_computer.angular.cutoff)
            prefix = estimate_capacity(r_ang + skin, a, periodic=pbc)
            if prefix < self.capacity:
                self._ang_prefix = prefix
                self.model = _with_angular_preslice(model, prefix)
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
            if not pot.enabled or not math.isfinite(r_pot):
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
    ) -> Tensor:
        """Total potential energy from a refreshed table (internal order).

        Without lane prefixes and frozen channels this is
        ``model.compute_from_neighbors`` with the species known here.  With
        them each short-cutoff potential runs on its own STATIC prefix of the
        distance-sorted lanes instead of the full K, and ``pair_aux`` (the
        state's frozen window channels) is attached per potential, cut to
        the same prefix."""
        if not self._lane_prefixes and not self._freeze_pair:
            nbn = narrow_to_cutoff(nb, self.cutoff)
            out = self.model.compute_from_neighbors(
                self.elem_idxs, cs[None], _batch1(nbn), species_ranges=self._species_ranges
            )
            return torch.sum(out.energies)
        e = cs.new_zeros(())
        for name in sorted(self.model.potentials):
            pot = self.model.potentials[name]
            if not pot.enabled:
                continue
            p = self._lane_prefixes.get(name)
            nbp = _slice_lanes(nb, p) if p is not None else nb
            nbp = narrow_to_cutoff(nbp, min(float(pot.cutoff), self.cutoff))
            if pair_aux is not None and name in pair_aux:
                aux = pair_aux[name]
                nbp = nbp.replace(pair_aux=aux if p is None else aux[:, :p])
            e = e + torch.sum(
                pot.compute_from_neighbors(
                    self.elem_idxs, cs[None], _batch1(nbp),
                    species_ranges=self._species_ranges,
                ).energies
            )
        return e + torch.sum(self.model.energy_shifter(self.elem_idxs))

    def _energy_and_forces(self, state: MDState, coords: Tensor) -> tp.Tuple[Tensor, Tensor]:
        """Energy and forces at ``coords`` (user order) on the cached
        topology; a fresh graph per call, nothing of it is kept."""
        c = coords.detach().requires_grad_(True)
        with torch.enable_grad():
            nb = _refresh_neighbors(state, c)
            e = self._potential_energy(nb, self._to_internal(c), state.pair_aux)
            (g,) = torch.autograd.grad(e, c)
        return e.detach(), -g

    def init(
        self,
        coords,  # (A, 3) or (1, A, 3)
        temperature: tp.Optional[float] = None,
        generator: tp.Optional[torch.Generator] = None,
    ) -> MDState:
        """The state at ``coords``: capacities measured (first call only),
        the Verlet cache built, energy and forces evaluated.  Velocities are
        zero, or drawn at ``temperature`` from ``generator`` (a CPU generator
        seeded with 0 by default)."""
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
        if temperature is not None:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            velocities = maxwell_boltzmann_velocities(generator, self.masses, temperature)
        else:
            velocities = torch.zeros_like(coords)
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
        )
        e, f = self._energy_and_forces(state, coords)
        return state.replace(energy=e, forces=f)

    @torch.no_grad()
    def _maybe_rebuild(self, state: MDState, coords: Tensor) -> MDState:
        """Rebuild the cache at ``coords`` if a pair can have closed the skin
        gap: when the SUM of the two largest per-atom displacements since the
        last build exceeds the skin.  The decision is read on the host: the
        step's one wait for the device.  A rebuild changes no static size; an
        overflow sets the flag (and poisons the AEV with NaN)."""
        moved2 = torch.sum((coords - state.ref_coords) ** 2, dim=-1)
        top2 = torch.topk(moved2, min(2, moved2.shape[0])).values
        need = torch.sum(torch.sqrt(top2)) > self.build_radius - self.cutoff
        if not bool(need):
            return state
        idx, mask, shift, nbr_elem, overflow, tables, pair_aux = self._build_cache(coords)
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
        with torch.no_grad():
            v_half = state.velocities + 0.5 * dt * state.forces * self._inv_m
            coords = state.coords + dt * v_half
        state = self._maybe_rebuild(state, coords)
        e, f = self._energy_and_forces(state, coords)
        with torch.no_grad():
            v = v_half + 0.5 * dt * f * self._inv_m
        return state.replace(
            coords=coords, velocities=v, forces=f, energy=e, step=state.step + 1
        )

    def run_nve(self, state: MDState, num_steps: int) -> MDState:
        """Run ``num_steps`` NVE steps."""
        for _ in range(num_steps):
            state = self.step_nve(state)
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
        species,  # (1, A) atomic numbers
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
