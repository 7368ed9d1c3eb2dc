"""Fixed-charge electrostatics, plain Coulomb and MNOK-damped (counterpart
of ``torchani_tpu/potentials/fixed_coulomb.py``): one charge (e) per element
(buffer ``charges``), distances in Bohr, energies in Hartree.  An infinite
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
from torchani_tpu_torch.utils import resolve_device

__all__ = ["FixedCoulomb", "FixedMNOK"]


def _per_element(name: str, values: tp.Sequence[float], symbols, device) -> Tensor:
    if len(values) != len(symbols):
        raise ValueError(f"{name} needs one value per symbol")
    return torch.as_tensor(np.asarray(values, dtype=np.float32), device=device)


class FixedCoulomb(BasePairPotential):
    """q_a q_b / (eps_r r)."""

    charges: Tensor  # (S,)

    def __init__(
        self,
        symbols: tp.Sequence[str],
        charges: tp.Sequence[float],
        dielectric: float = 1.0,
        cutoff: float = math.inf,
        cutoff_fn: CutoffArg = "smooth",
        device: DeviceArg = None,
    ) -> None:
        super().__init__(tuple(symbols), cutoff, cutoff_fn)
        dev = resolve_device(device)
        self.register_buffer("charges", _per_element("charges", charges, self.symbols, dev))
        self.dielectric = dielectric

    @classmethod
    def make(cls, symbols: tp.Sequence[str], charges: tp.Sequence[float], **kwargs):
        """The constructor under the JAX package's name."""
        return cls(symbols, charges, **kwargs)

    def pair_energies(self, elem_flat: Tensor, neighbors: Neighbors) -> Tensor:
        dists = self.clamp(neighbors.dist) * self.ANGSTROM_TO_BOHR
        ec, en = self.elem_pairs(elem_flat, neighbors)
        (charge_prod,) = self.pair_tables(ec, en, self.charges[:, None] * self.charges[None, :])
        return charge_prod / self.dielectric / dists


class FixedMNOK(BasePairPotential):
    """Mataga-Nishimoto-Ohno-Klopman damped fixed charges:
    q_a q_b / sqrt(r^2 + (2 / (eta_a + eta_b))^2).  ``dielectric`` is stored
    and not applied, as in the JAX package and its reference."""

    charges: Tensor  # (S,)
    eta: Tensor  # (S,)

    def __init__(
        self,
        symbols: tp.Sequence[str],
        charges: tp.Sequence[float],
        eta: tp.Sequence[float],
        dielectric: float = 1.0,
        cutoff: float = math.inf,
        cutoff_fn: CutoffArg = "smooth",
        device: DeviceArg = None,
    ) -> None:
        super().__init__(tuple(symbols), cutoff, cutoff_fn)
        if len(charges) != len(self.symbols) or len(eta) != len(self.symbols):
            raise ValueError("charges and eta need one value per symbol")
        dev = resolve_device(device)
        self.register_buffer("charges", _per_element("charges", charges, self.symbols, dev))
        self.register_buffer("eta", _per_element("eta", eta, self.symbols, dev))
        self.dielectric = dielectric

    @classmethod
    def make(cls, symbols: tp.Sequence[str], charges: tp.Sequence[float],
             eta: tp.Sequence[float], **kwargs):
        """The constructor under the JAX package's name."""
        return cls(symbols, charges, eta, **kwargs)

    def pair_energies(self, elem_flat: Tensor, neighbors: Neighbors) -> Tensor:
        dists = neighbors.dist * self.ANGSTROM_TO_BOHR
        ec, en = self.elem_pairs(elem_flat, neighbors)
        inv_eta_t = 2.0 / (self.eta[:, None] + self.eta[None, :])
        qq_t = self.charges[:, None] * self.charges[None, :]
        inv_eta, charge_prod = self.pair_tables(ec, en, inv_eta_t, qq_t)
        return charge_prod / torch.sqrt(dists**2 + inv_eta**2)
