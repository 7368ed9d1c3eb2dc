"""Short-range repulsion pair potentials, xTB and ZBL (counterpart of
``torchani_tpu/potentials/repulsion.py``): Grimme's GFN2-xTB repulsion and
the Ziegler-Biersack-Littmark screened nuclear repulsion with the LAMMPS
parameters, over masked padded neighbor tables.
"""

import math
import typing as tp

import numpy as np
import torch

from torchani_tpu_torch.annotations import DeviceArg, Tensor
from torchani_tpu_torch.constants import (
    ATOMIC_NUMBER,
    XTB_REPULSION_ALPHA,
    XTB_REPULSION_YEFF,
)
from torchani_tpu_torch.cutoffs import CutoffArg
from torchani_tpu_torch.neighbors import Neighbors
from torchani_tpu_torch.potentials.core import BasePairPotential
from torchani_tpu_torch.utils import resolve_device

__all__ = ["RepulsionXTB", "RepulsionZBL"]


def _elem_seq(
    name: str,
    symbols: tp.Sequence[str],
    values: tp.Sequence[float],
    default_by_znum: tp.Optional[tp.Sequence[float]] = None,
) -> np.ndarray:
    """Resolve a per-element parameter sequence (model order)."""
    if len(values):
        if len(values) != len(symbols):
            raise ValueError(f"{name} must have one value per symbol")
        return np.asarray(values, dtype=np.float32)
    if default_by_znum is None:
        raise ValueError(f"{name} must be provided")
    return np.asarray(
        [default_by_znum[ATOMIC_NUMBER[s]] for s in symbols], dtype=np.float32
    )


def _buffer(values: np.ndarray, device: torch.device) -> Tensor:
    return torch.as_tensor(np.asarray(values, dtype=np.float32), device=device)


class RepulsionXTB(BasePairPotential):
    r"""Grimme GFN2-xTB repulsion: :math:`(Y_{ab}/r) e^{-\sqrt{\alpha_a \alpha_b} r^{k}}`.

    ``k`` is 1.5 except 1.0 for H-H.  The default per-element alpha and yeff
    are Grimme's tables in `torchani_tpu_torch.constants`.
    """

    y_ab: Tensor  # (S, S)
    sqrt_alpha_ab: Tensor  # (S, S)
    k_rep_ab: Tensor  # (S, S)

    def __init__(
        self,
        symbols: tp.Sequence[str],
        krep_hydrogen: float = 1.0,
        krep: float = 1.5,
        alpha: tp.Sequence[float] = (),
        yeff: tp.Sequence[float] = (),
        cutoff: float = math.inf,
        cutoff_fn: CutoffArg = "smooth",
        device: DeviceArg = None,
    ) -> None:
        super().__init__(tuple(symbols), cutoff, cutoff_fn)
        dev = resolve_device(device)
        alpha_v = _elem_seq("alpha", self.symbols, alpha, XTB_REPULSION_ALPHA)
        yeff_v = _elem_seq("yeff", self.symbols, yeff, XTB_REPULSION_YEFF)
        s = len(self.symbols)
        k_rep = np.full((s, s), krep, dtype=np.float32)
        for i, sym in enumerate(self.symbols):
            if ATOMIC_NUMBER[sym] == 1:
                k_rep[i, i] = krep_hydrogen
        self.register_buffer("y_ab", _buffer(np.outer(yeff_v, yeff_v), dev))
        self.register_buffer("sqrt_alpha_ab", _buffer(np.sqrt(np.outer(alpha_v, alpha_v)), dev))
        self.register_buffer("k_rep_ab", _buffer(k_rep, dev))

    @classmethod
    def make(cls, symbols: tp.Sequence[str], **kwargs):
        """The constructor under the JAX package's name."""
        return cls(symbols, **kwargs)

    def pair_energies(self, elem_flat: Tensor, neighbors: Neighbors) -> Tensor:
        dists = self.clamp(neighbors.dist) * self.ANGSTROM_TO_BOHR
        ec, en = self.elem_pairs(elem_flat, neighbors)
        y_ab, sqrt_alpha_ab, k_rep_ab = self.pair_tables(
            ec, en, self.y_ab, self.sqrt_alpha_ab, self.k_rep_ab
        )
        return (y_ab / dists) * torch.exp(-sqrt_alpha_ab * dists**k_rep_ab)


class RepulsionZBL(BasePairPotential):
    r"""ZBL universal screened nuclear repulsion (LAMMPS parameters).

    :math:`E = (Z^{eff}_a Z^{eff}_b / r) \phi(r (Z_a^{0.23} + Z_b^{0.23})/k)`
    with a 4-term exponential screening function :math:`\phi`.
    """

    eff_atomic_nums: Tensor  # (S,)
    coeffs: Tensor  # (4,)
    exponents: Tensor  # (4,)

    def __init__(
        self,
        symbols: tp.Sequence[str],
        k: float = 0.8853,
        screen_coeffs: tp.Sequence[float] = (),
        screen_exponents: tp.Sequence[float] = (),
        eff_exponent: float = 0.23,
        eff_atomic_nums: tp.Sequence[float] = (),
        cutoff: float = math.inf,
        cutoff_fn: CutoffArg = "smooth",
        device: DeviceArg = None,
    ) -> None:
        super().__init__(tuple(symbols), cutoff, cutoff_fn)
        dev = resolve_device(device)
        if len(screen_exponents) != len(screen_coeffs):
            raise ValueError("screen_exponents and screen_coeffs must have the same len")
        if not len(screen_coeffs):
            # LAMMPS values; the last coefficient makes the sum exactly 1
            screen_coeffs = [0.18175, 0.50986, 0.28022, 0.02817]
            screen_exponents = [3.19980, 0.94229, 0.40290, 0.20162]
        if not math.isclose(sum(screen_coeffs), 1.0):
            raise ValueError("Screen coeffs must sum to 1")
        eff = _elem_seq("eff_atomic_nums", self.symbols, eff_atomic_nums, list(range(118)))
        self.k = k
        self.kz = eff_exponent
        self.register_buffer("eff_atomic_nums", _buffer(eff, dev))
        self.register_buffer("coeffs", _buffer(screen_coeffs, dev))
        self.register_buffer("exponents", _buffer(screen_exponents, dev))

    @classmethod
    def make(cls, symbols: tp.Sequence[str], **kwargs):
        """The constructor under the JAX package's name."""
        return cls(symbols, **kwargs)

    def screen_fn(self, dists: Tensor) -> Tensor:
        return torch.sum(self.coeffs * torch.exp(-self.exponents * dists[..., None]), dim=-1)

    def pair_energies(self, elem_flat: Tensor, neighbors: Neighbors) -> Tensor:
        dists = self.clamp(neighbors.dist) * self.ANGSTROM_TO_BOHR
        ec, en = self.elem_pairs(elem_flat, neighbors)
        z = self.eff_atomic_nums
        za_zb = z[:, None] * z[None, :]
        kz_sum = z[:, None] ** self.kz + z[None, :] ** self.kz
        prod_ab, kzsum_ab = self.pair_tables(ec, en, za_zb, kz_sum)
        return (prod_ab / dists) * self.screen_fn(dists * kzsum_ab / self.k)
