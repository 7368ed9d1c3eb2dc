"""DFT-D3(BJ) two-body dispersion (counterpart of
``torchani_tpu/potentials/dispersion.py``).

Grimme's DFT-D3 with Becke-Johnson damping: per-atom coordination numbers,
Gaussian-weighted interpolation of the 5x5 reference-C6 tables, C8 from
empirical-charge products, s6/s8/a1/a2 per density functional.

Coordination numbers are masked row sums over the padded neighbor table (no
``index_add_``); the 25-reference interpolation is a lane-broadcast ``(N, K,
25)`` computation.  The one per-lane dependence on a runtime per-atom value
(the neighbor's coordination number, or its 5 Gaussian factors) goes through
`torchani_tpu_torch.bucket_refresh.select_lane_values`: the CUDA kernels K4f
and K4b where `MolecularDynamics` attached its bucket tables, a gather
otherwise.
"""

import math
import typing as tp

import numpy as np
import torch

from torchani_tpu_torch.annotations import DeviceArg, Tensor
from torchani_tpu_torch.bucket_refresh import select_lane_values
from torchani_tpu_torch.constants import (
    ATOMIC_NUMBER,
    COVALENT_RADIUS,
    FUNCTIONAL_D3BJ_CONSTANTS,
    SQRT_EMPIRICAL_CHARGE,
    load_c6_constants,
)
from torchani_tpu_torch.cutoffs import CutoffArg
from torchani_tpu_torch.neighbors import Neighbors
from torchani_tpu_torch.potentials.core import BasePairPotential
from torchani_tpu_torch.potentials.repulsion import _buffer, _elem_seq
from torchani_tpu_torch.units import ANGSTROM_TO_BOHR
from torchani_tpu_torch.utils import resolve_device

__all__ = ["TwoBodyDispersionD3"]


class TwoBodyDispersionD3(BasePairPotential):
    """Two-body part of the DFT-D3(BJ) dispersion correction.

    ``cn_refs (S, 5)`` is the factorised table of coordination-number
    references: Grimme's 25 interpolation channels of a pair (i, j) are the
    product grid of i's and j's at most 5 per-ELEMENT references (verified
    from the C6 tables at construction), so the ``(N, K, 25)`` Gaussian
    weights factor into per-ATOM ``(N, 5)`` exponentials combined per lane
    by products: 25 exponentials per PAIR become 5 per ATOM.  Rows with fewer
    than 5 references pad with 1e4 (their exponential underflows to an exact
    0, and the ``c6 <= 0`` channel mask removes them anyway).  None where the
    factorisation could not be verified: the literal 25-channel pair form
    runs instead.
    """

    precalc_coeff6: Tensor  # (S, S, 25)
    precalc_cn_a: Tensor  # (S, S, 25)
    precalc_cn_b: Tensor  # (S, S, 25)
    sqrt_charge_ab: Tensor  # (S, S)
    damp_radii: Tensor  # (S, S) BJ cutoff radii (Bohr)
    covalent_radii: Tensor  # (S,) Bohr
    cn_refs: tp.Optional[Tensor]  # (S, 5)

    # Grimme's constants
    _K1: tp.ClassVar[int] = 16
    _K2: tp.ClassVar[float] = 4 / 3
    _K3: tp.ClassVar[int] = 4
    _EPS: tp.ClassVar[float] = 1e-35

    def __init__(
        self,
        symbols: tp.Sequence[str],
        s6: tp.Optional[float] = None,
        s8: tp.Optional[float] = None,
        damp_a1: tp.Optional[float] = None,
        damp_a2: tp.Optional[float] = None,
        functional: tp.Optional[str] = None,
        sqrt_empirical_charge: tp.Sequence[float] = (),
        covalent_radii: tp.Sequence[float] = (),
        cutoff: float = math.inf,
        cutoff_fn: CutoffArg = "smooth",
        device: DeviceArg = None,
    ) -> None:
        super().__init__(tuple(symbols), cutoff, cutoff_fn)
        dev = resolve_device(device)
        if functional is not None:
            d = FUNCTIONAL_D3BJ_CONSTANTS[functional.lower()]
            s6 = d["s6"] if s6 is None else s6
            s8 = d["s8"] if s8 is None else s8
            damp_a1 = d["a1"] if damp_a1 is None else damp_a1
            damp_a2 = d["a2"] if damp_a2 is None else damp_a2
        if None in (s6, s8, damp_a1, damp_a2):
            raise ValueError("Provide either a functional name or s6/s8/a1/a2")
        self.s6, self.s8 = float(s6), float(s8)
        self.a1, self.a2 = float(damp_a1), float(damp_a2)

        sqrt_q = _elem_seq(
            "sqrt_empirical_charge", self.symbols, sqrt_empirical_charge, SQRT_EMPIRICAL_CHARGE
        )
        rcov = _elem_seq(
            "covalent_radii", self.symbols, covalent_radii, COVALENT_RADIUS
        ) * ANGSTROM_TO_BOHR

        c6 = load_c6_constants()
        znums = np.asarray([ATOMIC_NUMBER[s] for s in self.symbols])
        s = len(self.symbols)

        def sel(t: np.ndarray) -> np.ndarray:
            return np.asarray(t)[znums][:, znums].reshape(s, s, 25)

        # Derive and VERIFY the per-element CN reference factorisation; fall
        # back to the literal pair grid on any inconsistency rather than risk
        # wrong physics.
        grid_a = sel(c6["coordnums_a"]).reshape(s, s, 5, 5)
        grid_b = sel(c6["coordnums_b"]).reshape(s, s, 5, 5)
        grid_c = sel(c6["constants"]).reshape(s, s, 5, 5)
        cn_refs = np.full((s, 5), 1.0e4, np.float32)
        factorized = True
        for zi in range(s):
            for r in range(5):
                va = grid_a[zi, :, r, :][grid_c[zi, :, r, :] > 0]
                vb = grid_b[:, zi, :, r][grid_c[:, zi, :, r] > 0]
                vals = np.concatenate([va, vb])
                if vals.size == 0:
                    continue
                if float(vals.max() - vals.min()) > 1e-6:
                    factorized = False
                cn_refs[zi, r] = float(vals[0])

        self.register_buffer("precalc_coeff6", _buffer(sel(c6["constants"]), dev))
        self.register_buffer("precalc_cn_a", _buffer(sel(c6["coordnums_a"]), dev))
        self.register_buffer("precalc_cn_b", _buffer(sel(c6["coordnums_b"]), dev))
        self.register_buffer("sqrt_charge_ab", _buffer(np.outer(sqrt_q, sqrt_q), dev))
        self.register_buffer("damp_radii", _buffer(np.sqrt(3 * np.outer(sqrt_q, sqrt_q)), dev))
        self.register_buffer("covalent_radii", _buffer(rcov, dev))
        self.register_buffer("cn_refs", _buffer(cn_refs, dev) if factorized else None)

    @classmethod
    def make(cls, symbols: tp.Sequence[str], **kwargs) -> "TwoBodyDispersionD3":
        """The constructor under the JAX package's name."""
        return cls(symbols, **kwargs)

    @classmethod
    def from_functional(
        cls, symbols: tp.Sequence[str], functional: str, **kwargs
    ) -> "TwoBodyDispersionD3":
        return cls(symbols, functional=functional, **kwargs)

    @staticmethod
    def _select_rows(values: Tensor, neighbors: Neighbors) -> Tensor:
        """Per-lane selection of a runtime per-atom value, ``values[idx]``:
        the one per-lane value dependence of the D3 stack that cannot be
        cached at a rebuild (coordination numbers change every step)."""
        return select_lane_values(values, neighbors)

    def _rcov_pair(self) -> Tensor:
        return self.covalent_radii[:, None] + self.covalent_radii[None, :]

    def frozen_window_channels(
        self, elem_flat: Tensor, neighbors: Neighbors
    ) -> tp.Optional[Tensor]:
        """``(N, K, 33)`` per-lane TOPOLOGY CONSTANTS for Verlet-window
        caching: rcov sum (1), the 5x5 C6 reference grid (25), sqrt charge
        (1), damping radius (1) and the NEIGHBOR element's 5 CN references
        (5).  All are constants keyed by the element (pair), so caching them
        between rebuilds is EXACT: it moves the per-evaluation folded gather
        to rebuild time.  With them `pair_energies` selects the live
        coordination number at P = 1 instead of the 5 Gaussian factors, and
        contracts the interpolation without building the ``(N, K, 25)``
        Gaussian tensor.

        None where the factorised form is not available (``cn_refs is
        None``): `MolecularDynamics` then caches nothing.
        """
        if self.cn_refs is None:
            return None
        ec, en = self.elem_pairs(elem_flat, neighbors)
        rcov_sum, pre_c6, sqrt_charge, damp_radii = self.pair_tables(
            ec, en, self._rcov_pair(), self.precalc_coeff6, self.sqrt_charge_ab,
            self.damp_radii,
        )
        refs_nbr = self.cn_refs.index_select(0, en.reshape(-1)).reshape(tuple(en.shape) + (5,))
        return torch.cat(
            [
                rcov_sum[..., None],
                pre_c6,  # (N, K, 25), channel c = 5 * r_i + r_j
                sqrt_charge[..., None],
                damp_radii[..., None],
                refs_nbr,
            ],
            dim=-1,
        )

    def pair_energies(self, elem_flat: Tensor, neighbors: Neighbors) -> Tensor:
        dists = self.clamp(neighbors.dist) * self.ANGSTROM_TO_BOHR  # (N, K)
        if neighbors.pair_aux is not None and self.cn_refs is not None:
            c6_coeff, c8_coeff, damp = self._c6_c8_damp_cached(
                elem_flat, neighbors, neighbors.pair_aux
            )
        else:
            c6_coeff, c8_coeff, damp = self._c6_c8_damp(elem_flat, neighbors)
        e6 = self.s6 * c6_coeff / (dists**6 + damp**6)
        e8 = self.s8 * c8_coeff / (dists**8 + damp**8)
        return -(e6 + e8)

    def _coordnums(self, neighbors: Neighbors, rcov_sum: Tensor) -> Tensor:
        """(N,) coordination numbers: a masked row sum (the full table holds
        both directions of a pair)."""
        dists = self.clamp(neighbors.dist) * self.ANGSTROM_TO_BOHR
        count_fn = 1.0 / (1.0 + torch.exp(-self._K1 * (self._K2 * rcov_sum / dists - 1.0)))
        return torch.sum(torch.where(neighbors.mask, count_fn, 0.0), dim=-1)

    def _atom_gaussians(self, elem_flat: Tensor, coordnums: Tensor) -> Tensor:
        """(N, 5) Gaussian factors of each atom's own CN references."""
        refs = self.cn_refs.index_select(0, elem_flat.clamp(min=0))
        return torch.exp(-self._K3 * (coordnums[:, None] - refs) ** 2)

    def _interpolate(self, z_factor: Tensor, w_factor: Tensor) -> Tensor:
        """C6 = z / w, guarded.  Where every weight underflows (masked lanes
        of the factorised path; absurd coordination numbers in either) the
        quotient's BACKWARD computes z / w^2 with w^2 underflown to 0: inf,
        then NaN gradients, also through the untaken branch of a ``where``.
        Such lanes carry no meaningful interpolation (the eps-over-eps limit
        is 1): they go through a safe denominator."""
        z_factor = z_factor + self._EPS
        w_factor = w_factor + self._EPS
        ok = w_factor > 1e-12
        return torch.where(ok, z_factor / torch.clamp(w_factor, min=1e-12), 1.0)

    def _c6_c8_damp_cached(
        self, elem_flat: Tensor, neighbors: Neighbors, aux: Tensor
    ) -> tp.Tuple[Tensor, Tensor, Tensor]:
        """Exact C6, C8 and damping from the cached constant channels (see
        `frozen_window_channels`): the live CN selected at P = 1, per-lane
        Gaussian factors, and a bilinear interpolation without the ``(N, K,
        25)`` Gaussian tensor."""
        rcov_sum = aux[..., 0]
        pre_c6 = aux[..., 1:26].reshape(tuple(aux.shape[:-1]) + (5, 5))
        sqrt_charge = aux[..., 26]
        damp_radii = aux[..., 27]
        refs_nbr = aux[..., 28:33]  # (N, K, 5)

        coordnums = self._coordnums(neighbors, rcov_sum)
        e_atom = self._atom_gaussians(elem_flat, coordnums)  # (N, 5)
        cn_nbr = torch.where(
            neighbors.mask, self._select_rows(coordnums, neighbors), 0.0
        )  # (N, K): the P = 1 selection
        e_nbr = torch.exp(-self._K3 * (cn_nbr[..., None] - refs_nbr) ** 2)  # (N, K, 5)
        e_nbr = torch.where(neighbors.mask[..., None], e_nbr, 0.0)

        # z = e_atom^T C6ref e_nbr, w = e_atom^T S e_nbr with S the support
        # of the reference grid (absent references ride as pre_c6 == 0: the
        # guard of the uncached path)
        support = (pre_c6 > 0.0).to(e_nbr.dtype)  # (N, K, 5, 5)
        zc = torch.sum(pre_c6 * e_nbr[..., None, :], dim=-1)  # (N, K, 5)
        wc = torch.sum(support * e_nbr[..., None, :], dim=-1)
        c6_coeff = self._interpolate(
            torch.sum(e_atom[:, None, :] * zc, dim=-1),
            torch.sum(e_atom[:, None, :] * wc, dim=-1),
        )
        c8_coeff = 3 * c6_coeff * sqrt_charge
        damp = self.a1 * damp_radii + self.a2
        return c6_coeff, c8_coeff, damp

    def _c6_c8_damp(
        self, elem_flat: Tensor, neighbors: Neighbors
    ) -> tp.Tuple[Tensor, Tensor, Tensor]:
        ec, en = self.elem_pairs(elem_flat, neighbors)
        # ONE folded gather for every pair-class constant: 28 channels in
        # the factorised path (rcov sum, 25 C6 references, sqrt charge,
        # damping radius), 78 in the literal one (plus the 2 x 25 CN grids)
        if self.cn_refs is not None:
            rcov_sum, pre_c6, sqrt_charge, damp_radii = self.pair_tables(
                ec, en, self._rcov_pair(), self.precalc_coeff6, self.sqrt_charge_ab,
                self.damp_radii,
            )
        else:
            rcov_sum, pre_c6, pre_cn_a, pre_cn_b, sqrt_charge, damp_radii = self.pair_tables(
                ec, en, self._rcov_pair(), self.precalc_coeff6, self.precalc_cn_a,
                self.precalc_cn_b, self.sqrt_charge_ab, self.damp_radii,
            )
        coordnums = self._coordnums(neighbors, rcov_sum)

        if self.cn_refs is not None:
            # exp(-K3 ((cn_i - A)^2 + (cn_j - B)^2))
            #   == exp(-K3 (cn_i - A)^2) * exp(-K3 (cn_j - B)^2)
            # with A, B per-ELEMENT reference lists: (N, 5) per-atom tables,
            # the neighbor's selected per lane at P = 5
            e_atom = self._atom_gaussians(elem_flat, coordnums)
            e_nbr = torch.where(
                neighbors.mask[..., None], self._select_rows(e_atom, neighbors), 0.0
            )  # (N, K, 5)
            gauss = (e_atom[:, None, :, None] * e_nbr[..., None, :]).reshape(
                pre_c6.shape
            )  # (N, K, 25), channel c = 5 * r_i + r_j
        else:
            cn_nbr = torch.where(neighbors.mask, self._select_rows(coordnums, neighbors), 0.0)
            gauss = (coordnums[:, None, None] - pre_cn_a) ** 2 + (
                cn_nbr[..., None] - pre_cn_b
            ) ** 2
            gauss = torch.exp(-self._K3 * gauss)

        gauss = torch.where(pre_c6 <= 0.0, 0.0, gauss)
        c6_coeff = self._interpolate(
            torch.sum(pre_c6 * gauss, dim=-1), torch.sum(gauss, dim=-1)
        )  # (N, K)
        c8_coeff = 3 * c6_coeff * sqrt_charge
        damp = self.a1 * damp_radii + self.a2
        return c6_coeff, c8_coeff, damp
