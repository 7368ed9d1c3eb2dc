"""Output NamedTuples (counterparts of ``torchani_tpu/tuples.py``)."""

import typing as tp

from torchani_tpu_torch.annotations import Tensor


class SpeciesEnergies(tp.NamedTuple):
    species: Tensor
    energies: Tensor


class EnergiesScalars(tp.NamedTuple):
    energies: Tensor
    scalars: tp.Optional[Tensor] = None
