"""Atom-sharded molecular dynamics over a process group (counterpart of
``torchani_tpu/parallel/md.py``).

The dominant work, the AEV and the networks, is independent over the atom
ROWS of the cached neighbor table.  So every process of the group holds the
whole system's coordinates (10,002 atoms are 120 KB), evaluates the NNP
energy of its own block of rows (neighbor indices stay global), takes the
gradient of that partial energy with respect to the coordinates, and one
all-reduce sums the partial gradients and energies.  The integrator, the
rebuild decision and the cell-list rebuild run replicated and keep every
process's topology the same; the cheap terms (pair potentials, self
energies) run replicated too and are added once, after the reduce.

Rows are blocks of `MolecularDynamics`' species-sorted internal order, padded with
``-1`` dummy atoms to a multiple of the group size.

For a periodic NNP-only model on the slot-row bucket refresh the per-step
refresh is domain-decomposed as well (`ShardedMolecularDynamics`): each
process runs K1 (and in the backward K2) on its block of the bucket grid,
and the slot rows go to the processes that own their atoms' rows through
one ``all_to_all`` with routing tables built at each rebuild
(`ExchangeTables`, `_exchange_maps`); both sides of the exchange are
`utils.perm_gather`s, so no step adds with atomics outside K2.
"""

import dataclasses
import math
import typing as tp

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from torchani_tpu_torch.annotations import Tensor
from torchani_tpu_torch.arch import as_tensor
from torchani_tpu_torch.bucket_refresh import (
    _SENTINEL,
    BucketTables,
    _occupied_lanes,
    cand_table_from_slots,
    select_slot_rows,
    slot_positions,
)
from torchani_tpu_torch.md import (
    MDState,
    MolecularDynamics,
    _refresh_neighbors,
    _slice_lanes,
    _with_enabled,
    maxwell_boltzmann_velocities,
)
from torchani_tpu_torch.neighbors import Neighbors, narrow_to_cutoff, repack_to_capacity
from torchani_tpu_torch.nn.containers import SpeciesRanges
from torchani_tpu_torch.utils import perm_gather, resolve_device

__all__ = ["ShardedMolecularDynamics"]


def _nnp_shard_energy(
    model,
    elem_rows: Tensor,  # (R,) this block's element indices
    elem_flat: Tensor,  # (A,) every atom's, for the global neighbor indices
    nbrs: Neighbors,  # (R, K) this block's rows, narrowed to the cutoff
    present: tp.Tuple[int, ...],
    species_ranges: SpeciesRanges,
) -> Tensor:
    """NNP energy of one block of atom rows: the angular table narrowed and
    repacked to the capacity the AEV computer takes for the table, NaN where
    either table overflowed.  A block without atoms still goes through the
    AEV, so every process's graph reaches the same collectives."""
    nnp = model.potentials["nnp"]
    aevc = nnp.aev_computer
    rn = narrow_to_cutoff(nbrs, aevc.radial.cutoff)
    an = narrow_to_cutoff(nbrs, aevc.angular.cutoff)
    cap = aevc._angular_capacity(nbrs.capacity)
    if cap < an.capacity:
        an = repack_to_capacity(an, cap)
    aev = aevc._aev_flat(elem_flat, rn, an, present)
    overflow = nbrs.overflow | an.overflow
    aev = aev * torch.where(overflow, math.nan, 1.0).to(aev.dtype)
    if not species_ranges:
        return torch.sum(aev) * 0.0
    return nnp.neural_networks(elem_rows[None], aev[None], species_ranges=species_ranges)[0]


@dataclasses.dataclass(frozen=True)
class ExchangeTables(BucketTables):
    """`BucketTables` plus the rebuild-time routing of the domain-decomposed
    refresh (`ShardedMolecularDynamics`); every single-device path takes it
    as the `BucketTables` it is.  ``D`` processes, ``G'`` buckets padded to
    a multiple of D, ``T`` the rows one process sends another."""

    keys_pad: Tensor  # (G', C*K) int32, padded with the sentinel key
    aos_pad: Tensor  # (G'*C,) int64 atom of slot, padded with A
    nlanes: Tensor  # (G',) int32 occupied lanes per bucket
    send_idx: Tensor  # (D, D*T): per source, the local slot row at send position dst*T + t
    send_inv: Tensor  # (D, G'C/D): per source, each local slot row's send position
    recv_idx: Tensor  # (D, R): per destination, each atom row's receive position src*T + t
    recv_inv: Tensor  # (D, D*T): per destination, each receive position's atom row


def _exchange_maps(slot_of_atom: Tensor, d: int, t_cap: int, gpc: int):
    """Routing tables of the slot-row ``all_to_all`` for ``D`` processes:
    ``(send_idx, send_inv, recv_idx, recv_inv, overflow)``.

    Each occupied slot row (computed by the process that owns its bucket)
    is read by exactly one atom row (owned by its atom's process), so the
    exchange is a permutation: a gather into the send buffer, the
    ``all_to_all``, a gather out of the receive buffer.  Sentinels: ``G'C /
    D`` (send_idx), ``D*T`` (send_inv, recv_idx), ``R`` (recv_inv).
    ``t_cap`` bounds the rows one process sends another; past it
    ``overflow`` is set."""
    a = slot_of_atom.shape[0]
    dev = slot_of_atom.device
    r = a // d
    per = gpc // d
    valid = slot_of_atom >= 0
    slot = torch.where(valid, slot_of_atom, gpc)
    src = torch.clamp(slot // per, max=d - 1)
    pos = torch.arange(a, device=dev)
    dst = pos // r
    # rank of each row within its (dst, src) group, in row order: a stable
    # sort by group puts each group together, and a running max of the
    # group starts gives each row's place in its group
    key = torch.where(valid, dst * d + src, d * d)
    order = torch.argsort(key, stable=True)
    sk = key[order]
    is_new = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), sk[1:] != sk[:-1]])
    seg_start = torch.cummax(torch.where(is_new, pos, 0), dim=0).values
    t_row = torch.zeros_like(pos).scatter(0, order, pos - seg_start)
    overflow = torch.any(valid & (t_row >= t_cap))
    t_row = torch.clamp(t_row, max=t_cap - 1)

    def scattered(size: int, fill: int, index: Tensor, values: Tensor) -> Tensor:
        # rows that are not valid go to a trash entry past the end
        out = torch.full((size + 1,), fill, dtype=torch.int64, device=dev)
        out.scatter_(0, torch.where(valid, index, size), torch.where(valid, values, fill))
        return out[:size]

    dt = d * t_cap
    send_pos = dst * t_cap + t_row
    send_idx = scattered(d * dt, per, src * dt + send_pos, slot - src * per).reshape(d, dt)
    send_inv = scattered(gpc, dt, slot, send_pos).reshape(d, per)
    recv_idx = torch.where(valid, src * t_cap + t_row, dt).reshape(d, r)
    recv_inv = scattered(d * dt, r, dst * dt + src * t_cap + t_row, pos % r).reshape(d, dt)
    return send_idx, send_inv, recv_idx, recv_inv, overflow


class _AllToAll(torch.autograd.Function):
    """Equal blocks of rows exchanged over ``group`` (block ``j`` of a
    process's input goes to process ``j``); the transpose is the same
    exchange."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllToAll.apply(grad, ctx.group), None


class ShardedMolecularDynamics(MolecularDynamics):
    """`MolecularDynamics` with the NNP force evaluation sharded over atom
    rows across the processes of a group.

    ``mesh``: a 1-D `DeviceMesh` (its one axis, e.g. ``"atoms"``) or a
    process group; the other arguments are `MolecularDynamics`' (on the
    process's current CUDA device unless ``device="cpu"``).  The atom count
    is padded to a multiple of the group size with ``-1`` dummy atoms, which
    the neighbor list masks by species and the networks give no energy;
    states carry them at the end, parked far outside the cell, with zero
    force.

    Every process gets the same forces and energy: one all-reduce a step
    sums the blocks' partial gradients and energies.  For a periodic
    NNP-only model on the slot-row bucket refresh, the refresh is sharded
    too: at the first `init` the rows one process sends another are counted
    on the host and fixed with a 35% margin (``_exch_T``); a later rebuild
    that needs more sets the overflow flag and poisons the energy with NaN.
    Other models keep the replicated refresh and run their pair potentials
    on every process.
    """

    def __init__(self, model, species, mesh, **kwargs) -> None:
        resolve_device(kwargs.get("device"))  # the card unless the CPU is asked for
        if isinstance(mesh, DeviceMesh):
            if mesh.ndim != 1:
                raise ValueError("ShardedMolecularDynamics takes a 1D mesh")
            group = mesh.get_group()
        else:
            group = mesh
        self.mesh = mesh
        self.group = group
        self.num_shards = d = dist.get_world_size(group)
        self.shard = dist.get_rank(group)
        sp = species.detach().cpu().numpy() if isinstance(species, torch.Tensor) else np.asarray(species)
        sp = sp.reshape(1, -1)
        pad = (-sp.shape[1]) % d
        if pad:
            sp = np.concatenate([sp, np.full((1, pad), -1, sp.dtype)], axis=1)
        self._atom_pad = pad
        #: rows one process sends another in the sharded refresh; None until
        #: the first `init` measures them
        self._exch_T: tp.Optional[int] = None
        super().__init__(model, sp, **kwargs)
        if not self.model.potentials["nnp"].enabled:
            raise ValueError("ShardedMolecularDynamics shards the networks: enable 'nnp'")
        a = sp.shape[1]
        r = a // d
        lo, hi = self.shard * r, (self.shard + 1) * r
        self._rows = (lo, hi)
        self._row_ranges: SpeciesRanges = tuple(
            (v, max(s, lo) - lo, min(e, hi) - lo)
            for v, s, e in self._species_ranges
            if min(e, hi) > max(s, lo)
        )
        self._present = tuple(v for v, _, _ in self._species_ranges)
        others = [n for n, p in self.model.potentials.items() if n != "nnp" and p.enabled]
        #: the replicated terms: every enabled potential but the networks
        self._others = (
            _with_enabled(self.model, others, self_energies=False) if others else None
        )

    def _only_nnp(self) -> bool:
        pots = self.model.potentials
        if "nnp" not in pots or not pots["nnp"].enabled:
            return False
        return all(name == "nnp" or not p.enabled for name, p in pots.items())

    def _build_cache(self, coords: Tensor):
        idx, mask, shift, nbr_elem, overflow, tables, pair_aux = super()._build_cache(coords)
        if self._exch_T is not None and type(tables) is BucketTables:
            d = self.num_shards
            gx, gy, gz = tables.wrapshift.shape[:3]
            g = gx * gy * gz
            c = tables.atom_of_slot.shape[0] // g
            k = tables.keys.shape[1] // c
            gp = -(-g // d) * d
            a = coords.shape[-2]
            keys_pad = torch.nn.functional.pad(tables.keys, (0, 0, 0, gp - g), value=_SENTINEL)
            aos_pad = torch.nn.functional.pad(tables.atom_of_slot, (0, (gp - g) * c), value=a)
            sidx, sinv, ridx, rinv, ovf = _exchange_maps(
                tables.slot_of_atom, d, self._exch_T, gp * c
            )
            overflow = overflow | ovf
            tables = ExchangeTables(
                **{f.name: getattr(tables, f.name) for f in dataclasses.fields(BucketTables)},
                keys_pad=keys_pad, aos_pad=aos_pad,
                nlanes=_occupied_lanes(aos_pad, a, gp, c, k),
                send_idx=sidx, send_inv=sinv, recv_idx=ridx, recv_inv=rinv,
            )
        return idx, mask, shift, nbr_elem, overflow, tables, pair_aux

    def init(self, coords, temperature=None, generator=None) -> MDState:
        """`MolecularDynamics.init` on the padded system; at the first call
        for an NNP-only model on the slot-row refresh, also the exchange
        capacity (a host read of the slot map) and the exchange tables.
        Velocities at ``temperature`` are drawn for the real atoms alone, as
        `MolecularDynamics` draws them, and the dummies' are zero."""
        coords = as_tensor(coords, torch.float32, self.device).detach()
        if coords.dim() == 3:
            coords = coords[0]
        velocities = None
        if self._atom_pad:
            # dummy atoms parked far outside the cell; the neighbor list masks
            # them by species, and they feel no force
            park = torch.max(torch.abs(coords)) + 100.0
            coords = torch.cat([coords, park.expand(self._atom_pad, 3)])
            if temperature is not None:
                if generator is None:
                    generator = torch.Generator().manual_seed(0)
                real = maxwell_boltzmann_velocities(
                    generator, self.masses[: -self._atom_pad], temperature
                )
                velocities = torch.cat([real, real.new_zeros((self._atom_pad, 3))])
                temperature = None
        state = super().init(coords, temperature, generator)
        if velocities is not None:
            state = state.replace(velocities=velocities)
        if self._exch_T is None and type(state.bucket) is BucketTables and self._only_nnp():
            soa = state.bucket.slot_of_atom.cpu().numpy()
            d = self.num_shards
            a = soa.shape[0]
            g = int(np.prod(state.bucket.wrapshift.shape[:3]))
            c = state.bucket.atom_of_slot.shape[0] // g
            per = (-(-g // d) * d) * c // d
            valid = soa >= 0
            src = np.minimum(soa[valid] // per, d - 1)
            dst = (np.arange(a) // (a // d))[valid]
            counts = np.zeros((d, d), np.int64)
            np.add.at(counts, (dst, src), 1)
            self._exch_T = max(8, -(-int(counts.max() * 1.35 + 4) // 8) * 8)
            idx, mask, shift, nbr_elem, overflow, tables, pair_aux = self._build_cache(
                state.coords
            )
            state = state.replace(
                nbr_idx=idx, nbr_mask=mask, nbr_shift=shift, nbr_elem=nbr_elem,
                overflow=overflow, bucket=tables, ref_coords=state.coords, pair_aux=pair_aux,
            )
            e, f = self._energy_and_forces(state, state.coords)
            state = state.replace(energy=e, forces=f)
        return state

    def _rows_energy(self, nb: Neighbors) -> Tensor:
        """The NNP energy of this process's rows of a refreshed table."""
        p = self._lane_prefixes.get("nnp")
        if p is not None:
            nb = _slice_lanes(nb, p)
        nb = narrow_to_cutoff(nb, self.cutoff)
        lo, hi = self._rows
        elem = self.elem_idxs[0]
        return _nnp_shard_energy(
            self.model, elem[lo:hi], elem, nb, self._present, self._row_ranges
        )

    def _reduced(self, e_part: Tensor, g_part: Tensor) -> tp.Tuple[Tensor, Tensor]:
        """Sum of the processes' partial energies and gradients: one
        all-reduce."""
        flat = torch.cat([g_part.reshape(-1), e_part.detach().reshape(1)])
        dist.all_reduce(flat, group=self.group)
        e = flat[-1]
        shifter = self.model.energy_shifter
        if shifter.enabled:
            e = e + torch.sum(shifter(self.elem_idxs))
        return e, flat[:-1].reshape(g_part.shape)

    def _sharded_refresh_ef(self, state: MDState, coords: Tensor) -> tp.Tuple[Tensor, Tensor]:
        """Energy and forces with the refresh domain-decomposed: K1 on this
        process's block of buckets, the slot rows to their atoms' processes
        through one ``all_to_all``, the NNP on this process's rows, and the
        gradient of that partial energy summed over the group."""
        bucket: ExchangeTables = state.bucket
        d, s = self.num_shards, self.shard
        grid = tuple(bucket.wrapshift.shape[:3])
        g = grid[0] * grid[1] * grid[2]
        c = bucket.atom_of_slot.shape[0] // g
        k = state.nbr_idx.shape[1]
        gl = bucket.keys_pad.shape[0] // d
        b0 = s * gl
        lo, hi = self._rows
        x = coords.detach().requires_grad_(True)
        with torch.enable_grad():
            canon = self._to_internal(x) - bucket.wrap_offset
            posb = slot_positions(canon, bucket.atom_of_slot, bucket.slot_of_atom)
            cand = cand_table_from_slots(posb, bucket.wrapshift, grid, c)
            cand = torch.nn.functional.pad(cand, (0, 0, 0, 0, 0, 0, 0, d * gl - g))
            rows = select_slot_rows(
                cand[b0:b0 + gl], bucket.keys_pad[b0:b0 + gl], bucket.nlanes[b0:b0 + gl]
            )  # (G'C / D, K*3); rows of empty slots are unwritten
            send = perm_gather(rows, bucket.send_idx[s], bucket.send_inv[s])
            recv = _AllToAll.apply(send, self.group)
            nbr_pos = perm_gather(recv, bucket.recv_idx[s], bucket.recv_inv[s]).reshape(-1, k, 3)
            mask = state.nbr_mask[lo:hi]
            diff = torch.where(mask[..., None], nbr_pos - canon[lo:hi, None, :], 0.0)
            dist_ = torch.sqrt(torch.where(mask, torch.sum(diff * diff, dim=-1), 1.0))
            nb = Neighbors(
                idx=state.nbr_idx[lo:hi], mask=mask, diff=diff, dist=dist_,
                overflow=state.overflow, elem=state.nbr_elem[lo:hi],
            )
            e_part = self._rows_energy(nb)
            (g_part,) = torch.autograd.grad(e_part, x)
        e, grad = self._reduced(e_part, g_part)
        return e, -grad

    def _energy_and_forces(self, state: MDState, coords: Tensor) -> tp.Tuple[Tensor, Tensor]:
        """Energy and forces at ``coords`` (user order, padded): the sharded
        refresh where the state has `ExchangeTables`; otherwise the
        replicated refresh, the NNP on this process's rows and the other
        terms on every process, whose gradient only the first process adds
        to its part of the sum."""
        if isinstance(state.bucket, ExchangeTables):
            return self._sharded_refresh_ef(state, coords)
        x = coords.detach().requires_grad_(True)
        with torch.enable_grad():
            nb = _refresh_neighbors(state, x)
            lo, hi = self._rows
            e_part = self._rows_energy(
                Neighbors(
                    idx=nb.idx[lo:hi], mask=nb.mask[lo:hi], diff=nb.diff[lo:hi],
                    dist=nb.dist[lo:hi], overflow=nb.overflow, elem=nb.elem[lo:hi],
                )
            )
            e_rep = None
            if self._others is not None:
                e_rep = self._potential_energy(
                    nb, self._to_internal(x), state.pair_aux, model=self._others
                )
            target = e_part if e_rep is None or self.shard else e_part + e_rep
            (g_part,) = torch.autograd.grad(target, x)
        e, grad = self._reduced(e_part, g_part)
        if e_rep is not None:
            e = e + e_rep.detach()
        return e, -grad
