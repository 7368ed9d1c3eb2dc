"""The AEV computer (counterpart of ``torchani_tpu/aev/computer.py``).

Features are ``[radial | angular]``: radial species-major ``(S, R)``,
angular pair-major ``(P, Z)`` with ``Z`` shift-major/section-minor, the
layout of the JAX package and of the reference.

Angular strategies:
- ``"plain"``: atom-blocked ``(M, Ka, Ka, Z)`` PyTorch computation through
  the angular term (`angular_grid`), the counterpart of ``_angular_xla``;
  any term (`ANIAngular` or a user `Angular`) and any cutoff.  With an
  ``angular_split`` and a repacked table it runs the count-class split of
  ``_angular_split_xla`` (`_angular_split_plain`);
- ``"cuda"``: the fused kernel (`angular_aev`, K3) and its backward kernel
  (`angular_aev_bwd`, K3b), one launch each (`_AngularAEVFunction`; on CPU
  tensors their plain versions, the backward in atom blocks); a second
  derivative launches K3bb (`angular_aev_bwd_bwd`) once; a third and any
  higher one differentiate a plain recompute of K3bb's function
  (`_bwd_bwd_vjp`), as the JAX package's ``_angular_pallas_op``
  differentiates an XLA recompute above its first order.
  `ANIAngular` with the cosine cutoff or the default smooth one only (any
  other term or cutoff raises), as the JAX package's Pallas path; the
  kernel runs once over the whole table and ``angular_split`` changes
  nothing, as there;
- ``"auto"``: ``"cuda"`` for CUDA tensors with a term and a cutoff the
  kernel evaluates, ``"plain"`` otherwise (the routing of the JAX package,
  whose Pallas path takes the same terms and cutoffs).

The radial terms take the same route where their kernels evaluate them
(`ANIRadial` with the cosine or the default smooth cutoff, at most
``MAX_RADIAL_SPECIES`` species and ``MAX_RADIAL_SHIFTS`` shifts): K6
(`radial_aev`) forward, K6b (`radial_aev_bwd`) backward and K6bb
(`radial_aev_bwd_bwd`) for a second derivative, one launch each
(`_RadialAEVFunction`; on CPU tensors under ``"cuda"`` their plain
versions); a third and higher derivative differentiates a plain recompute.
Any other radial term keeps the plain masked sums under every strategy,
``"cuda"`` included: the JAX package leaves them all to XLA.
"""

import math
import typing as tp

import torch
import torch.utils.checkpoint

from torchani_tpu_torch.aev.kernels import (
    angular_aev,
    angular_aev_bwd,
    angular_aev_bwd_bwd,
    angular_aev_reference,
    angular_grid,
    lane_species,
)
from torchani_tpu_torch.aev.radial_kernels import (
    MAX_RADIAL_SHIFTS,
    MAX_RADIAL_SPECIES,
    radial_aev,
    radial_aev_bwd,
    radial_aev_bwd_bwd,
    radial_aev_reference,
    species_sums,
)
from torchani_tpu_torch.aev.terms import (
    ANIAngular,
    ANIRadial,
    AngularArg,
    BaseAngular,
    BaseRadial,
    RadialArg,
    parse_angular_term,
    parse_radial_term,
)
from torchani_tpu_torch.annotations import DeviceArg, Tensor
from torchani_tpu_torch.cutoffs import Cutoff, CutoffArg, CutoffCosine, CutoffSmooth
from torchani_tpu_torch.profiling import scope
from torchani_tpu_torch.utils import perm_gather
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
#: the same for K3bb's backward (`_bwd_bwd_vjp`), whose recompute holds the
#: graph of the grid's second derivative while it takes the third: 242-265
#: measured on the CPU (peak resident memory against the grid's elements),
#: rounded up; 78 on an H100 (peak device memory of the recompute against a
#: block's grid, at the 10,002-atom box), where a block so holds ~0.6 GiB.
#: Its blocks are ``atom_block * _GRID_BYTES // _THIRD_ORDER_GRID_BYTES``
#: atoms, within the same 2 GiB
_THIRD_ORDER_GRID_BYTES = 256
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
    angular: BaseAngular,
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
    serve every order.  The backward is `_AngularAEVBwdFunction`, so that
    a second derivative (Hessians, force training) runs K3bb; a third or
    higher one also runs `_bwd_bwd_vjp`."""

    @staticmethod
    def forward(ctx, dist, diff, mask, oh, kwargs, atom_block):
        species = lane_species(mask, oh)
        ctx.save_for_backward(dist, diff, mask, oh, species)
        ctx.kwargs = kwargs
        ctx.atom_block = atom_block
        return angular_aev(dist, diff, mask, oh, species=species, **kwargs)

    @staticmethod
    def backward(ctx, grad):
        dist, diff, mask, oh, species = ctx.saved_tensors
        if grad.stride(-1) != 1:
            grad = grad.contiguous()  # an expanded cotangent (the gradient of a sum)
        gdist, gdiff = _AngularAEVBwdFunction.apply(
            grad, dist, diff, mask, oh, species, ctx.kwargs, ctx.atom_block
        )
        return gdist, gdiff, None, None, None, None


class _AngularAEVBwdFunction(torch.autograd.Function):
    """K3b as a differentiable function of the cotangent ``g`` and the lanes:
    its backward is K3bb (`_AngularAEVBwdBwdFunction`), one launch, which
    gives the cotangent of ``g`` (the AEV's derivative along the direction)
    and the second-order term on ``dist`` and ``diff``."""

    @staticmethod
    def forward(ctx, g, dist, diff, mask, oh, species, kwargs, atom_block):
        ctx.save_for_backward(g, dist, diff, mask, oh, species)
        ctx.kwargs = kwargs
        ctx.atom_block = atom_block
        return angular_aev_bwd(g, dist, diff, mask, oh, species, atom_block=atom_block, **kwargs)

    @staticmethod
    def backward(ctx, u_dist, u_diff):
        g, dist, diff, mask, oh, species = ctx.saved_tensors
        gg, hdist, hdiff = _AngularAEVBwdBwdFunction.apply(
            g, dist, diff, mask, oh, u_dist.contiguous(), u_diff.contiguous(), species,
            ctx.kwargs, ctx.atom_block,
        )
        return gg, hdist, hdiff, None, None, None, None, None


class _AngularAEVBwdBwdFunction(torch.autograd.Function):
    """K3bb (`angular_aev_bwd_bwd`).  Its backward, a third derivative of
    the angular AEV, is `_bwd_bwd_vjp`: autograd through a plain recompute,
    differentiable again where the caller asks for a graph, so that every
    higher order works as in the JAX package."""

    @staticmethod
    def forward(ctx, g, dist, diff, mask, oh, u_dist, u_diff, species, kwargs, atom_block):
        ctx.save_for_backward(g, dist, diff, mask, oh, u_dist, u_diff)
        ctx.kwargs = kwargs
        ctx.atom_block = atom_block
        return angular_aev_bwd_bwd(
            g, dist, diff, mask, oh, u_dist, u_diff, species, atom_block=atom_block, **kwargs
        )

    @staticmethod
    def backward(ctx, w_gg, w_hdist, w_hdiff):
        g, dist, diff, mask, oh, u_dist, u_diff = ctx.saved_tensors
        block = max(1, ctx.atom_block * _GRID_BYTES // _THIRD_ORDER_GRID_BYTES)
        gg, gdist, gdiff, gu_dist, gu_diff = _bwd_bwd_vjp(
            ctx.kwargs, block, (g, dist, diff, u_dist, u_diff), mask, oh,
            (w_gg, w_hdist, w_hdiff),
        )
        return gg, gdist, gdiff, None, None, gu_dist, gu_diff, None, None, None


def _bwd_bwd_vjp(
    kwargs: tp.Dict[str, tp.Any],
    atom_block: int,
    inputs: tp.Tuple[Tensor, ...],  # g, dist, diff, u_dist, u_diff
    mask: Tensor,
    oh: Tensor,
    cotangents: tp.Tuple[Tensor, Tensor, Tensor],  # of gg, hdist, hdiff
) -> tp.List[Tensor]:
    """The vector-Jacobian product of K3bb's function: the cotangents of
    ``g``, ``dist``, ``diff``, ``u_dist`` and ``u_diff`` from those of
    ``(gg, hdist, hdiff)``.

    The counterpart of differentiating ``_angular_pallas_bwd``'s XLA
    recompute: autograd through the plain forward (`angular_aev_reference`,
    one `angular_grid` call a block), differentiated twice to K3bb's
    outputs and once more to their cotangents, ``atom_block`` atoms at a
    time (rows are independent), so that memory holds one block's graph.
    With grad mode on (a fourth or higher derivative) the inputs that carry
    a graph are used as they are and the result carries one too; each
    block's graph then lives until the caller's backward."""
    create_graph = torch.is_grad_enabled()
    n = inputs[1].shape[0]
    parts = []
    for sl in _blocks(n, atom_block):
        with torch.enable_grad():
            ins = [
                t[sl] if create_graph and t.requires_grad else t[sl].detach().requires_grad_()
                for t in inputs
            ]
            g, dist, diff, u_dist, u_diff = ins
            aev = angular_aev_reference(dist, diff, mask[sl], oh[sl], **kwargs)
            gdist, gdiff = torch.autograd.grad(aev, (dist, diff), g, create_graph=True)
            phi = torch.sum(gdist * u_dist) + torch.sum(gdiff * u_diff)
            outs = torch.autograd.grad(phi, (g, dist, diff), create_graph=True)
            psi = sum(torch.sum(o * w[sl]) for o, w in zip(outs, cotangents))
            parts.append(torch.autograd.grad(psi, ins, create_graph=create_graph))
    if not parts:
        return [torch.zeros_like(t) for t in inputs]
    return [torch.cat(p) for p in zip(*parts)]


class _RadialAEVFunction(torch.autograd.Function):
    """K6 forward and K6b backward, one launch each on CUDA tensors; on CPU
    tensors their plain versions.  The backward is `_RadialAEVBwdFunction`,
    so that a second derivative runs K6bb."""

    @staticmethod
    def forward(ctx, dist, species, kwargs):
        ctx.save_for_backward(dist, species)
        ctx.kwargs = kwargs
        return radial_aev(dist, species, **kwargs)

    @staticmethod
    def backward(ctx, grad):
        dist, species = ctx.saved_tensors
        if grad.stride(-1) != 1 or grad.stride(0) < grad.shape[1]:
            grad = grad.contiguous()  # an expanded cotangent (the gradient of a sum)
        return _RadialAEVBwdFunction.apply(grad, dist, species, ctx.kwargs), None, None


class _RadialAEVBwdFunction(torch.autograd.Function):
    """K6b as a differentiable function of the cotangent ``g`` and ``dist``:
    its backward is K6bb (`_RadialAEVBwdBwdFunction`), one launch, which
    gives the cotangents of both."""

    @staticmethod
    def forward(ctx, g, dist, species, kwargs):
        ctx.save_for_backward(g, dist, species)
        ctx.kwargs = kwargs
        return radial_aev_bwd(g, dist, species, **kwargs)

    @staticmethod
    def backward(ctx, w):
        g, dist, species = ctx.saved_tensors
        gg, gdist = _RadialAEVBwdBwdFunction.apply(g, dist, species, w.contiguous(), ctx.kwargs)
        return gg, gdist, None, None


class _RadialAEVBwdBwdFunction(torch.autograd.Function):
    """K6bb (`radial_aev_bwd_bwd`).  Its backward, a third derivative of the
    radial AEV, is autograd through a plain recompute (`radial_aev_reference`
    differentiated twice), differentiable again where the caller asks for a
    graph, as `_bwd_bwd_vjp` is for the angular terms."""

    @staticmethod
    def forward(ctx, g, dist, species, w, kwargs):
        ctx.save_for_backward(g, dist, species, w)
        ctx.kwargs = kwargs
        return radial_aev_bwd_bwd(g, dist, species, w, **kwargs)

    @staticmethod
    def backward(ctx, v_gg, v_gdist):
        g, dist, species, w = ctx.saved_tensors
        create_graph = torch.is_grad_enabled()
        inputs = (g, dist, w)
        with torch.enable_grad():
            # fresh views: the gradients stop at them, not where ``g``'s own
            # history meets ``dist``
            ins = [t.view_as(t) if create_graph and t.requires_grad
                   else t.detach().requires_grad_() for t in inputs]
            g_, dist_, w_ = ins
            aev = radial_aev_reference(dist_, species, **ctx.kwargs)
            (gdist,) = torch.autograd.grad(aev, dist_, g_, create_graph=True)
            phi = torch.sum(gdist * w_)
            outs = torch.autograd.grad(phi, (g_, dist_), create_graph=True)
            psi = torch.sum(outs[0] * v_gg) + torch.sum(outs[1] * v_gdist)
            grads = torch.autograd.grad(psi, ins, create_graph=create_graph, allow_unused=True)
        grads = [torch.zeros_like(t) if x is None else x for x, t in zip(grads, inputs)]
        return grads[0], grads[1], None, grads[2], None


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
        angular_split: count-class split ``(k_small, n_dense)`` or
            ``(k_small, n_dense, n_rows)`` of the plain angular path over a
            repacked table (see `_angular_split_plain`); `MolecularDynamics`
            measures and sets it on its own copy, as the JAX package's does.
            The kernel path ignores it
        angular_capacity: lanes of the angular table: a table wider than
            this is repacked to it, and a row with more angular neighbors
            poisons the AEVs with NaN (the JAX package's field; training
            sets it per batch).  None derives it from the radial table's
            capacity (`_angular_capacity`)
    """

    def __init__(
        self,
        radial: BaseRadial,
        angular: BaseAngular,
        num_species: int,
        strategy: str = "auto",
        neighborlist: NeighborlistArg = "all_pairs",
        atom_block: tp.Optional[int] = None,
        angular_preslice: tp.Optional[int] = None,
        angular_split: tp.Optional[tp.Tuple[int, ...]] = None,
        angular_capacity: tp.Optional[int] = None,
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
        self.angular_split = (
            None if angular_split is None else tuple(int(x) for x in angular_split)
        )
        self.angular_capacity = None if angular_capacity is None else int(angular_capacity)
        self._kernel_kwargs: tp.Optional[tp.Dict[str, tp.Any]] = None
        self._kernel_kwargs_key: tp.Optional[tp.Tuple] = None
        self._radial_kwargs: tp.Optional[tp.Dict[str, tp.Any]] = None
        self._radial_kwargs_key: tp.Optional[tp.Tuple] = None

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
        knows them; by default the plain radial path reads them from the
        tensor, which waits for the device (the radial kernel needs none)."""
        c, a = elem_idxs.shape
        radial_nbrs, angular_nbrs, overflow = self.flat_tables(elem_idxs, neighbors)
        # silent truncation would give plausibly-wrong physics: poison instead
        poison = torch.where(overflow, math.nan, 1.0).to(neighbors.dist.dtype)
        lanes = min(neighbors.capacity, self.angular_preslice or neighbors.capacity)
        aev = self._aev_flat(
            elem_idxs.reshape(-1), radial_nbrs, angular_nbrs, present,
            packed_prefix=angular_nbrs.capacity < lanes,
        )
        return aev.reshape(c, a, self.out_dim) * poison

    def flat_tables(
        self, elem_idxs: Tensor, neighbors: Neighbors
    ) -> tp.Tuple[Neighbors, Neighbors, Tensor]:
        """Radial ``(N, K)`` and angular ``(N, Ka)`` tables over the flattened
        atoms (``N = C * A``, neighbor indices offset per molecule), and the
        overflow flag of both.  The angular table is cut to
        ``angular_preslice`` lanes (if set), narrowed to the angular cutoff
        and, if wider than `_angular_capacity`, repacked to it."""
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

    def radial_kernel_kwargs(self) -> tp.Dict[str, tp.Any]:
        """Static arguments of `radial_aev` for this computer's radial term,
        read and cached as `kernel_kwargs` reads the angular term's."""
        rad = self.radial
        key = tuple((t.data_ptr(), t._version) for t in (rad.eta, rad.shifts))
        if key != self._radial_kwargs_key:
            self._radial_kwargs = dict(
                eta=float(rad.eta[0]),
                shifts=tuple(rad.shifts.tolist()),
                cutoff=float(rad.cutoff),
                cutoff_kind=_cutoff_kind(rad.cutoff_fn),
                num_species=self.num_species,
            )
            self._radial_kwargs_key = key
        return self._radial_kwargs

    def _present_species(self, elem: Tensor) -> tp.Tuple[int, ...]:
        """Species present in the element array (a host decision)."""
        with scope("aev.present_species", wait=True):
            present = torch.unique(elem).tolist()
        return tuple(t for t in present if 0 <= t < self.num_species)

    def _angular_capacity(self, radial_capacity: int) -> int:
        """The JAX package's angular repack capacity: ``angular_capacity``
        if set; else small tables keep their capacity and large ones shrink
        to a liquid-density estimate at the angular cutoff (15% margin,
        multiple of 4, at least 24)."""
        if self.angular_capacity is not None:
            return self.angular_capacity
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

    def _kernel_evaluates(self) -> bool:
        """Whether K3 evaluates this computer's angular term: `ANIAngular`
        (not a subclass) with the cosine or default smooth cutoff."""
        ang = self.angular
        return type(ang) is ANIAngular and _cutoff_kind(ang.cutoff_fn) is not None

    def _radial_kernel_evaluates(self) -> bool:
        """Whether K6 evaluates this computer's radial term: `ANIRadial` (not
        a subclass) with the cosine or default smooth cutoff, at widths the
        kernel takes."""
        rad = self.radial
        return (
            type(rad) is ANIRadial
            and _cutoff_kind(rad.cutoff_fn) is not None
            and rad.num_feats <= MAX_RADIAL_SHIFTS
            and self.num_species <= MAX_RADIAL_SPECIES
        )

    def _use_radial_kernel(self, t: Tensor) -> bool:
        if self.strategy == "plain" or not self._radial_kernel_evaluates():
            return False
        return self.strategy == "cuda" or t.is_cuda

    def _use_kernel(self, t: Tensor) -> bool:
        if self.strategy == "plain":
            return False
        if self.strategy == "cuda":
            if not self._kernel_evaluates():
                raise ValueError(
                    f"The angular kernel evaluates ANIAngular with the cosine or default "
                    f"smooth cutoff only, not {type(self.angular).__name__} with "
                    f"{self.angular.cutoff_fn}"
                )
            return True
        return t.is_cuda and self._kernel_evaluates()

    # ---- core ----
    def _aev_flat(
        self,
        elem_flat: Tensor,  # (N,)
        radial_nbrs: Neighbors,  # (N, K)
        angular_nbrs: Neighbors,  # (N, Ka)
        present: tp.Optional[tp.Tuple[int, ...]] = None,
        packed_prefix: bool = False,
    ) -> Tensor:
        n = radial_nbrs.idx.shape[0]
        s = self.num_species

        rmask = radial_nbrs.mask
        relem = torch.where(rmask, radial_nbrs.nbr_elem(elem_flat), -1)
        if self._use_radial_kernel(radial_nbrs.dist):
            radial_aev = _RadialAEVFunction.apply(
                radial_nbrs.dist.contiguous(), relem.to(torch.int64).contiguous(),
                self.radial_kernel_kwargs(),
            )
        else:
            # per-species sums over the valid lanes, absent species are zero
            if present is None:
                present = self._present_species(elem_flat)
            radial_aev = species_sums(self.radial(radial_nbrs.dist), relem, s, present)

        # angular
        adist, adiff, amask, aoh = self.angular_inputs(elem_flat, angular_nbrs)
        block = self._atom_block(angular_nbrs.capacity)
        split = self.angular_split if packed_prefix else None
        if self._use_kernel(adist):
            angular_aev_ = _AngularAEVFunction.apply(
                adist, adiff, amask, aoh, self.kernel_kwargs(), block
            )
        elif (
            split is not None
            and 0 < split[1] < n
            and (split[0] < angular_nbrs.capacity or (len(split) > 2 and split[2] < n))
        ):
            angular_aev_ = self._angular_split_plain(adist, adiff, amask, aoh)
        else:
            angular_aev_ = _angular_plain(
                self.angular, s, block, adist, adiff, amask, aoh
            )
        return torch.cat([radial_aev, angular_aev_], dim=-1)

    def _angular_split_plain(
        self,
        adist: Tensor,  # (N, Ka), masked lanes 1.0
        adiff: Tensor,  # (N, Ka, 3)
        amask: Tensor,  # (N, Ka) bool, each row's valid lanes a prefix
        aoh: Tensor,  # (N, Ka, S)
    ) -> Tensor:
        """The count-class angular split of the JAX package's
        ``_angular_split_xla``, on the plain path.

        Rows go in descending order of their valid-lane count (a stable
        sort: ties keep row order, as ``top_k`` keeps them); the
        ``n_dense`` densest run at the full capacity, the rest at their
        first ``k_small`` lanes only (a repacked table holds each row's
        valid lanes as a prefix), and the rows go back through the inverse
        permutation.  Both permutations are `perm_gather`s.  With more than
        ``n_dense`` rows over ``k_small`` lanes the split would truncate:
        the result is NaN instead.  A third entry ``n_rows`` evaluates
        only that many rows in count order; the rest (rows with no lane)
        come out as zeros, and a row with lanes among them poisons too.
        """
        s = self.num_species
        split = tp.cast(tp.Tuple[int, ...], self.angular_split)
        n, ka = adist.shape
        n_rows = min(split[2], n) if len(split) > 2 else n
        k_small = min(split[0], ka)
        n_dense = min(split[1], n_rows)
        counts = amask.sum(dim=1)
        order = torch.sort(counts, descending=True, stable=True).indices
        inv = torch.empty_like(order)
        inv[order] = torch.arange(n, device=order.device)
        ok = torch.sum(counts > k_small) <= n_dense
        if n_rows < n:
            ok = ok & (torch.sum(counts > 0) <= n_rows)
            order = order[:n_rows]
            inv = torch.where(inv < n_rows, inv, n_rows)
        adist, adiff, amask, aoh = (perm_gather(x, order, inv) for x in (adist, adiff, amask, aoh))
        if k_small >= ka:
            body = _angular_plain(
                self.angular, s, self._atom_block(ka), adist, adiff, amask, aoh
            )
        else:
            dense = _angular_plain(
                self.angular, s, self._atom_block(ka),
                adist[:n_dense], adiff[:n_dense], amask[:n_dense], aoh[:n_dense],
            )
            small = _angular_plain(
                self.angular, s, self._atom_block(k_small),
                adist[n_dense:, :k_small], adiff[n_dense:, :k_small],
                amask[n_dense:, :k_small], aoh[n_dense:, :k_small],
            )
            body = torch.cat([dense, small], dim=0)
        out = perm_gather(body, inv, order)
        return out * torch.where(ok, 1.0, math.nan).to(out.dtype)
