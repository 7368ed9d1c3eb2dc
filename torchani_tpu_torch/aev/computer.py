"""The AEV computer (counterpart of ``torchani_tpu/aev/computer.py``).

Features are ``[radial | angular]``: radial species-major ``(S, R)``,
angular pair-major ``(P, Z)`` with ``Z`` shift-major/section-minor, the
layout of the JAX package and of the reference.

Angular strategies:
- ``"plain"``: atom-blocked ``(M, Ka, Ka, Z)`` PyTorch computation through
  the angular term (`angular_grid`), the counterpart of ``_angular_xla``;
  any cutoff;
- ``"cuda"``: the fused kernel (`angular_aev`, K3) and its backward kernel
  (`angular_aev_bwd`, K3b), one launch each (`_AngularAEVFunction`; on CPU
  tensors their plain versions, the backward in atom blocks).  The JAX
  package's ``_angular_pallas_op`` differentiates an XLA recompute instead.
  The cosine cutoff and the default smooth one only (other cutoffs raise);
- ``"auto"``: ``"cuda"`` for CUDA tensors with a cutoff the kernel
  evaluates, ``"plain"`` otherwise.
"""

import math
import typing as tp

import torch
import torch.utils.checkpoint
from torch.autograd.function import once_differentiable

from torchani_tpu_torch.aev.kernels import (
    angular_aev,
    angular_aev_bwd,
    angular_grid,
    lane_species,
)
from torchani_tpu_torch.aev.terms import (
    ANIAngular,
    ANIRadial,
    AngularArg,
    RadialArg,
    parse_angular_term,
    parse_radial_term,
)
from torchani_tpu_torch.annotations import DeviceArg, Tensor
from torchani_tpu_torch.cutoffs import Cutoff, CutoffArg, CutoffCosine, CutoffSmooth
from torchani_tpu_torch.neighbors import (
    NeighborlistArg,
    Neighbors,
    narrow_to_cutoff,
    parse_neighborlist,
    repack_to_capacity,
)

__all__ = ["AEVComputer", "STRATEGIES"]

STRATEGIES = ("auto", "plain", "cuda")

#: bytes the plain angular path holds per element of a block's
#: (blk, Ka, Ka, Z) grid while its backward recomputes it: 21 measured on an
#: H100 (E+F peak memory against the number of blocks), rounded up.  The
#: kernel path on the card holds no grid; on the CPU its backward's plain
#: version takes the same blocks
_GRID_BYTES = 24
#: memory one block of the plain angular path may hold, on any device
#: (3,566 atoms at Ka = 28, Z = 32: three blocks for the 10,002-atom box)
_BLOCK_BYTES = 2 << 30


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def _cutoff_kind(cutoff_fn: Cutoff) -> tp.Optional[str]:
    """The kernel's name for a cutoff it evaluates; None for the others."""
    if cutoff_fn == CutoffCosine():
        return "cosine"
    if cutoff_fn == CutoffSmooth():
        return "smooth"
    return None


def _blocks(n: int, block: int) -> tp.Iterator[slice]:
    for start in range(0, n, block):
        yield slice(start, min(start + block, n))


def _angular_plain(
    angular: ANIAngular,
    num_species: int,
    atom_block: int,
    dist: Tensor,
    diff: Tensor,
    mask: Tensor,
    oh: Tensor,
) -> Tensor:
    """Atom-blocked plain angular path.  With more than one block, each block
    is checkpointed under autograd (recomputed in backward), so memory holds
    about one block of ``(blk, Ka, Ka, Z)`` residuals, like the JAX path's
    remat."""
    n = dist.shape[0]
    if n <= atom_block:
        return angular_grid(angular, num_species, dist, diff, mask, oh)
    remat = torch.is_grad_enabled() and (dist.requires_grad or diff.requires_grad)
    outs = []
    for sl in _blocks(n, atom_block):
        args = (angular, num_species, dist[sl], diff[sl], mask[sl], oh[sl])
        if remat:
            outs.append(torch.utils.checkpoint.checkpoint(angular_grid, *args, use_reentrant=False))
        else:
            outs.append(angular_grid(*args))
    return torch.cat(outs, dim=0)


class _AngularAEVFunction(torch.autograd.Function):
    """K3 forward and K3b backward, one launch each on CUDA tensors (the
    port's counterpart of ``_angular_pallas_op``, whose backward recomputes
    through XLA); on CPU tensors their plain versions, the backward
    ``atom_block`` atoms at a time.  The lane species are computed once and
    serve both.  First order only: force training (double backward) needs
    a kernel of its own."""

    @staticmethod
    def forward(ctx, dist, diff, mask, oh, kwargs, atom_block):
        species = lane_species(mask, oh)
        ctx.save_for_backward(dist, diff, mask, oh, species)
        ctx.kwargs = kwargs
        ctx.atom_block = atom_block
        return angular_aev(dist, diff, mask, oh, species=species, **kwargs)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        dist, diff, mask, oh, species = ctx.saved_tensors
        if grad.stride(-1) != 1:
            grad = grad.contiguous()  # an expanded cotangent (the gradient of a sum)
        gdist, gdiff = angular_aev_bwd(
            grad, dist, diff, mask, oh, species, atom_block=ctx.atom_block, **ctx.kwargs
        )
        return gdist, gdiff, None, None, None, None


class AEVComputer(torch.nn.Module):
    """Computes atomic environment vectors for batches of molecules.

    Args:
        radial: radial term module
        angular: angular term module
        num_species: number of supported elements
        strategy: ``"auto"`` | ``"plain"`` | ``"cuda"`` (see module docs)
        neighborlist: neighborlist used when called on raw coordinates
        atom_block: atoms per block of the plain angular path and, on the
            CPU, of the kernel path's plain backward (memory knob); None sizes
            a block to hold at most 2 GiB on any device
        angular_preslice: static lane prefix that the angular table is cut
            to before it is narrowed to the angular cutoff.  Only valid for
            a table whose lanes are sorted by distance, with every lane that
            can come within the angular cutoff inside the prefix: `MolecularDynamics`
            sets it on its own copy of the computer and verifies the
            bound at every rebuild
    """

    def __init__(
        self,
        radial: ANIRadial,
        angular: ANIAngular,
        num_species: int,
        strategy: str = "auto",
        neighborlist: NeighborlistArg = "all_pairs",
        atom_block: tp.Optional[int] = None,
        angular_preslice: tp.Optional[int] = None,
    ) -> None:
        super().__init__()
        if not angular.cutoff_fn.is_same(radial.cutoff_fn):
            raise ValueError("Cutoff fn must be the same for angular and radial terms")
        if angular.cutoff > radial.cutoff:
            raise ValueError(
                f"Angular cutoff {angular.cutoff} should be smaller "
                f"than radial cutoff {radial.cutoff}"
            )
        if strategy not in STRATEGIES:
            raise ValueError(f"Unsupported strategy {strategy}")
        self.radial = radial
        self.angular = angular
        self.num_species = num_species
        self.strategy = strategy
        self.neighborlist = parse_neighborlist(neighborlist)
        self.atom_block = atom_block
        self.angular_preslice = angular_preslice
        self._kernel_kwargs: tp.Optional[tp.Dict[str, tp.Any]] = None
        self._kernel_kwargs_key: tp.Optional[tp.Tuple] = None

    # ---- dims ----
    @property
    def num_species_pairs(self) -> int:
        return self.num_species * (self.num_species + 1) // 2

    @property
    def radial_len(self) -> int:
        return self.radial.num_feats * self.num_species

    @property
    def angular_len(self) -> int:
        return self.angular.num_feats * self.num_species_pairs

    @property
    def out_dim(self) -> int:
        return self.radial_len + self.angular_len

    # ---- construction ----
    @classmethod
    def make(
        cls,
        radial: RadialArg,
        angular: AngularArg,
        num_species: int,
        strategy: str = "auto",
        cutoff_fn: CutoffArg = "cosine",
        neighborlist: NeighborlistArg = "all_pairs",
        device: DeviceArg = None,
        **kwargs,
    ) -> "AEVComputer":
        return cls(
            parse_radial_term(radial, cutoff_fn, device),
            parse_angular_term(angular, cutoff_fn, device),
            num_species,
            strategy=strategy,
            neighborlist=neighborlist,
            **kwargs,
        )

    @classmethod
    def like_1x(cls, num_species: int = 4, **kwargs) -> "AEVComputer":
        return cls.make("ani1x", "ani1x", num_species, **kwargs)

    @classmethod
    def like_2x(cls, num_species: int = 7, **kwargs) -> "AEVComputer":
        return cls.make("ani2x", "ani2x", num_species, **kwargs)

    # ---- entry points ----
    def forward(
        self,
        elem_idxs: Tensor,  # (C, A) int, -1 padding
        coords: Tensor,  # (C, A, 3)
        cell: tp.Optional[Tensor] = None,
        pbc: tp.Optional[Tensor] = None,
        neighbors: tp.Optional[Neighbors] = None,
    ) -> Tensor:
        """Compute AEVs, shape ``(C, A, out_dim)``."""
        if elem_idxs.dim() != 2 or coords.shape != elem_idxs.shape + (3,):
            raise ValueError(
                f"Expected elem_idxs (C, A) and coords (C, A, 3); got "
                f"{tuple(elem_idxs.shape)} and {tuple(coords.shape)}"
            )
        if neighbors is None:
            neighbors = self.neighborlist(self.radial.cutoff, elem_idxs, coords, cell, pbc)
        return self.compute_from_neighbors(elem_idxs, coords, neighbors)

    def compute_from_neighbors(
        self,
        elem_idxs: Tensor,  # (C, A)
        coords: tp.Optional[Tensor],
        neighbors: Neighbors,  # (C, A, K)
        present: tp.Optional[tp.Tuple[int, ...]] = None,
    ) -> Tensor:
        """AEVs from a padded neighbor table; NaN if the table overflowed.

        ``present`` names the species of ``elem_idxs`` for a caller that
        knows them; by default they are read from the tensor, which waits
        for the device."""
        c, a = elem_idxs.shape
        if present is None:
            present = self._present_species(elem_idxs)
        radial_nbrs, angular_nbrs, overflow = self.flat_tables(elem_idxs, neighbors)
        # silent truncation would give plausibly-wrong physics: poison instead
        poison = torch.where(overflow, math.nan, 1.0).to(neighbors.dist.dtype)
        aev = self._aev_flat(elem_idxs.reshape(-1), radial_nbrs, angular_nbrs, present)
        return aev.reshape(c, a, self.out_dim) * poison

    def flat_tables(
        self, elem_idxs: Tensor, neighbors: Neighbors
    ) -> tp.Tuple[Neighbors, Neighbors, Tensor]:
        """Radial ``(N, K)`` and angular ``(N, Ka)`` tables over the flattened
        atoms (``N = C * A``, neighbor indices offset per molecule), and the
        overflow flag of both.  The angular table is cut to
        ``angular_preslice`` lanes (if set), narrowed to the angular cutoff
        and, for large tables, repacked to `_angular_capacity`."""
        c, a = elem_idxs.shape
        radial_nbrs = narrow_to_cutoff(neighbors, self.radial.cutoff)
        angular_src = neighbors
        lslice = self.angular_preslice
        if lslice is not None and lslice < neighbors.capacity:
            angular_src = Neighbors(
                idx=neighbors.idx[..., :lslice],
                mask=neighbors.mask[..., :lslice],
                diff=neighbors.diff[..., :lslice, :],
                dist=neighbors.dist[..., :lslice],
                overflow=neighbors.overflow,
                elem=None if neighbors.elem is None else neighbors.elem[..., :lslice],
            )
        angular_nbrs = narrow_to_cutoff(angular_src, self.angular.cutoff)
        cap = self._angular_capacity(neighbors.capacity)
        if cap < angular_nbrs.capacity:
            angular_nbrs = repack_to_capacity(angular_nbrs, cap)
        offsets = (torch.arange(c, device=elem_idxs.device) * a)[:, None, None]

        def flat(nb: Neighbors) -> Neighbors:
            k = nb.capacity
            return Neighbors(
                idx=(nb.idx + offsets).reshape(c * a, k),
                mask=nb.mask.reshape(c * a, k),
                diff=nb.diff.reshape(c * a, k, 3),
                dist=nb.dist.reshape(c * a, k),
                overflow=nb.overflow,
                elem=None if nb.elem is None else nb.elem.reshape(c * a, k),
            )

        overflow = neighbors.overflow | angular_nbrs.overflow
        return flat(radial_nbrs), flat(angular_nbrs), overflow

    def angular_inputs(
        self, elem_flat: Tensor, angular_nbrs: Neighbors
    ) -> tp.Tuple[Tensor, Tensor, Tensor, Tensor]:
        """The angular kernel's inputs from a flat angular table: ``dist``
        (1.0 in masked lanes), ``diff``, ``mask`` and the lane one-hot."""
        amask = angular_nbrs.mask
        adist = torch.where(amask, angular_nbrs.dist, 1.0).contiguous()
        adiff = angular_nbrs.diff.contiguous()
        aelem = torch.where(amask, angular_nbrs.nbr_elem(elem_flat), 0)
        aoh = torch.nn.functional.one_hot(aelem, self.num_species).to(adist.dtype)
        return adist, adiff, amask, aoh * amask[..., None]

    def kernel_kwargs(self) -> tp.Dict[str, tp.Any]:
        """Static arguments of `angular_aev` for this computer's terms.

        Read from the term's buffers on the host once, and again only after a
        buffer was replaced or written in place (as the weight bridge does):
        a read on every forward would wait for the card."""
        ang = self.angular
        buffers = (ang.eta, ang.zeta, ang.shifts, ang.sections)
        key = tuple((t.data_ptr(), t._version) for t in buffers)
        if key != self._kernel_kwargs_key:
            kind = _cutoff_kind(ang.cutoff_fn)
            if kind is None:
                raise ValueError(
                    f"The angular kernel evaluates the cosine and default smooth "
                    f"cutoffs only, not {ang.cutoff_fn}"
                )
            self._kernel_kwargs = dict(
                eta=float(ang.eta[0]),
                zeta=float(ang.zeta[0]),
                shifts=tuple(ang.shifts.tolist()),
                sections=tuple(ang.sections.tolist()),
                cutoff=float(ang.cutoff),
                cutoff_kind=kind,
                num_species=self.num_species,
            )
            self._kernel_kwargs_key = key
        return self._kernel_kwargs

    def _present_species(self, elem: Tensor) -> tp.Tuple[int, ...]:
        """Species present in the element array (a host decision)."""
        return tuple(
            t for t in torch.unique(elem).tolist() if 0 <= t < self.num_species
        )

    def _angular_capacity(self, radial_capacity: int) -> int:
        """The JAX package's angular repack capacity: small tables keep
        their capacity; large ones shrink to a liquid-density estimate at
        the angular cutoff (15% margin, multiple of 4, at least 24)."""
        if radial_capacity <= 40:
            return radial_capacity
        est = int(math.ceil(4.0 / 3.0 * math.pi * self.angular.cutoff**3 * 0.12 * 1.15))
        est = max(24, _ceil_to(est, 4))
        return min(est, radial_capacity)

    def _atom_block(self, ka: int) -> int:
        if self.atom_block is not None:
            return self.atom_block
        per_atom = _GRID_BYTES * ka * ka * self.angular.num_feats
        return max(1, _BLOCK_BYTES // max(per_atom, 1))

    def _use_kernel(self, t: Tensor) -> bool:
        if self.strategy == "plain":
            return False
        if self.strategy == "cuda":
            return True  # `kernel_kwargs` raises for a cutoff it lacks
        return t.is_cuda and _cutoff_kind(self.angular.cutoff_fn) is not None

    # ---- core ----
    def _aev_flat(
        self,
        elem_flat: Tensor,  # (N,)
        radial_nbrs: Neighbors,  # (N, K)
        angular_nbrs: Neighbors,  # (N, Ka)
        present: tp.Tuple[int, ...],
    ) -> Tensor:
        n = radial_nbrs.idx.shape[0]
        s = self.num_species

        # radial: per-species masked sums over lanes, absent species are zero
        rmask = radial_nbrs.mask
        rterms = self.radial(radial_nbrs.dist) * rmask[..., None]  # (N, K, R)
        relem = torch.where(rmask, radial_nbrs.nbr_elem(elem_flat), -1)
        zeros = rterms.new_zeros((n, self.radial.num_feats))
        radial_aev = torch.stack(
            [
                torch.sum(rterms * (relem == t)[..., None], dim=1)
                if t in present else zeros
                for t in range(s)
            ],
            dim=1,
        ).reshape(n, self.radial_len)

        # angular
        adist, adiff, amask, aoh = self.angular_inputs(elem_flat, angular_nbrs)
        block = self._atom_block(angular_nbrs.capacity)
        if self._use_kernel(adist):
            angular_aev_ = _AngularAEVFunction.apply(
                adist, adiff, amask, aoh, self.kernel_kwargs(), block
            )
        else:
            angular_aev_ = _angular_plain(
                self.angular, s, block, adist, adiff, amask, aoh
            )
        return torch.cat([radial_aev, angular_aev_], dim=-1)
