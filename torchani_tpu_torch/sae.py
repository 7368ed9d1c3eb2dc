"""1-body self energies (counterpart of ``torchani_tpu/sae.py``)."""

import typing as tp

import numpy as np
import torch

from torchani_tpu_torch.annotations import DeviceArg, Tensor
from torchani_tpu_torch.constants import GSAES
from torchani_tpu_torch.utils import resolve_device

__all__ = ["EnergyShifter", "SelfEnergy", "sorted_gsaes"]


def sorted_gsaes(
    symbols: tp.Sequence[str], functional: str, basis_set: str
) -> tp.List[float]:
    """GSAEs for ``symbols`` in order; functional/basis are case-insensitive."""
    gsaes = GSAES[f"{functional.lower()}-{basis_set.lower()}"]
    return [gsaes[e] for e in symbols]


class SelfEnergy(torch.nn.Module):
    """Adds constant atomic energies depending only on the element.

    The per-atom values are f32 and are summed in f32 over the atom axis,
    as the JAX ``SelfEnergy`` does.  A model whose ``energy_shifter`` has
    ``enabled`` False adds none (the slow lane of
    `torchani_tpu_torch.md.MultipleTimestepMD`).
    """

    self_energies: Tensor  # (S,)

    def __init__(
        self,
        symbols: tp.Sequence[str],
        self_energies: tp.Sequence[float],
        device: DeviceArg = None,
    ) -> None:
        super().__init__()
        self.symbols = tuple(symbols)
        self.enabled = True
        if len(self_energies) != len(self.symbols):
            raise ValueError("self_energies must have one value per symbol")
        values = np.asarray(self_energies, dtype=np.float64).astype(np.float32)
        self.register_buffer(
            "self_energies", torch.as_tensor(values, device=resolve_device(device))
        )

    @classmethod
    def from_lot(
        cls, symbols: tp.Sequence[str], lot: str, device: DeviceArg = None
    ) -> "SelfEnergy":
        """``lot`` is e.g. ``"wb97x-631gd"`` (functional-basis)."""
        functional, basis = lot.split("-")
        return cls(symbols, sorted_gsaes(symbols, functional, basis), device)

    def forward(self, elem_idxs: Tensor, atomic: bool = False) -> Tensor:
        e = self.self_energies[elem_idxs.clamp(min=0)]
        e = torch.where(elem_idxs < 0, 0.0, e)
        if atomic:
            return e
        return torch.sum(e, dim=-1)


#: The reference's name of `SelfEnergy`
EnergyShifter = SelfEnergy
