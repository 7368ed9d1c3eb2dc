"""The Lennard-Jones 12-6 potential and its repulsive and dispersive halves
(counterpart of ``torchani_tpu/potentials/lj.py``): Lorentz-Berthelot
combination rules, an ff19SB preset.  ``sigma`` in Angstrom, ``eps`` in
Hartree, one each per element (buffers ``eps`` and ``sigma``).  An infinite
cutoff takes no envelope (`CutoffDummy`).
"""

import math
import typing as tp

import numpy as np
import torch

from torchani_tpu_torch.annotations import DeviceArg, Tensor
from torchani_tpu_torch.cutoffs import CutoffArg
from torchani_tpu_torch.neighbors import Neighbors
from torchani_tpu_torch.potentials.core import BasePairPotential
from torchani_tpu_torch.units import HARTREE_TO_KCALPERMOL
from torchani_tpu_torch.utils import resolve_device

__all__ = ["LennardJones", "RepulsionLJ", "DispersionLJ"]

_EPS_DEFAULT = 0.1 / HARTREE_TO_KCALPERMOL  # Hartree
_SIGMA_DEFAULT = 1.5  # Angstrom

# ff19SB presets (Amber atom types): sigma in Angstrom, eps in kcal/mol
_FF19SB_SIGMAS = {
    "H": 1.4870, "C": 1.9080, "N": 1.8240, "O": 1.6612, "F": 1.7500,
    "Ne": 2.782, "P": 2.1000, "S": 1.9825, "Cl": 1.948, "Ar": 3.346,
    "Br": 2.22, "I": 2.35,
}
_FF19SB_EPS = {
    "H": 0.0157, "C": 0.0860, "N": 0.1700, "O": 0.2100, "F": 0.0610,
    "Ne": 0.0711, "P": 0.2000, "S": 0.2824, "Cl": 0.265, "Ar": 0.24979,
    "Br": 0.320, "I": 0.40,
}


class _LJ(BasePairPotential):
    """Base of the Lennard-Jones family."""

    eps: Tensor  # (S,)
    sigma: Tensor  # (S,)

    def __init__(
        self,
        symbols: tp.Sequence[str],
        eps: tp.Sequence[float] = (),
        sigma: tp.Sequence[float] = (),
        cutoff: float = math.inf,
        cutoff_fn: CutoffArg = "smooth",
        device: DeviceArg = None,
    ) -> None:
        super().__init__(tuple(symbols), cutoff, cutoff_fn)
        s = len(self.symbols)
        eps_v = np.asarray(eps if len(eps) else [_EPS_DEFAULT] * s, dtype=np.float32)
        sigma_v = np.asarray(sigma if len(sigma) else [_SIGMA_DEFAULT] * s, dtype=np.float32)
        if len(eps_v) != s or len(sigma_v) != s:
            raise ValueError("eps and sigma need one value per symbol")
        dev = resolve_device(device)
        self.register_buffer("eps", torch.as_tensor(eps_v, device=dev))
        self.register_buffer("sigma", torch.as_tensor(sigma_v, device=dev))

    @classmethod
    def make(cls, symbols: tp.Sequence[str], eps=(), sigma=(), **kwargs):
        """The constructor under the JAX package's name."""
        return cls(symbols, eps, sigma, **kwargs)

    @classmethod
    def ff19SB(cls, symbols: tp.Sequence[str], **kwargs):
        """The ff19SB-derived parameters of ``symbols``."""
        sigma = [_FF19SB_SIGMAS[s] for s in symbols]
        eps = [_FF19SB_EPS[s] / HARTREE_TO_KCALPERMOL for s in symbols]
        return cls(symbols, eps, sigma, **kwargs)

    def _combined(self, elem_flat: Tensor, neighbors: Neighbors) -> tp.Tuple[Tensor, Tensor]:
        """Per-lane eps (Berthelot) and sigma / r (Lorentz)."""
        ec, en = self.elem_pairs(elem_flat, neighbors)
        eps_t = torch.sqrt(self.eps[:, None] * self.eps[None, :])
        sigma_t = (self.sigma[:, None] + self.sigma[None, :]) / 2
        eps, sigma = self.pair_tables(ec, en, eps_t, sigma_t)
        return eps, sigma / self.clamp(neighbors.dist)


class LennardJones(_LJ):
    def pair_energies(self, elem_flat: Tensor, neighbors: Neighbors) -> Tensor:
        eps, x = self._combined(elem_flat, neighbors)
        return 4 * eps * (x**12 - x**6)


class RepulsionLJ(_LJ):
    def pair_energies(self, elem_flat: Tensor, neighbors: Neighbors) -> Tensor:
        eps, x = self._combined(elem_flat, neighbors)
        return 4 * eps * x**12


class DispersionLJ(_LJ):
    def pair_energies(self, elem_flat: Tensor, neighbors: Neighbors) -> Tensor:
        eps, x = self._combined(elem_flat, neighbors)
        return -4 * eps * x**6
