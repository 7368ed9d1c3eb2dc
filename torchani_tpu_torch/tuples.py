"""Output NamedTuples (counterparts of ``torchani_tpu/tuples.py``)."""

import typing as tp

from torchani_tpu_torch.annotations import Tensor


class SpeciesEnergies(tp.NamedTuple):
    species: Tensor
    energies: Tensor


class SpeciesAEV(tp.NamedTuple):
    species: Tensor
    aevs: Tensor


class SpeciesCoordinates(tp.NamedTuple):
    species: Tensor
    coordinates: Tensor


class SpeciesEnergiesQBC(tp.NamedTuple):
    species: Tensor
    energies: Tensor
    qbcs: Tensor


class SpeciesForces(tp.NamedTuple):
    species: Tensor
    energies: Tensor
    forces: Tensor


class ForceStress(tp.NamedTuple):
    energies: Tensor
    forces: Tensor
    stress: Tensor


class EnergiesForces(tp.NamedTuple):
    energies: Tensor
    forces: Tensor


class EnergiesScalars(tp.NamedTuple):
    energies: Tensor
    scalars: tp.Optional[Tensor] = None


class VibAnalysis(tp.NamedTuple):
    freqs: Tensor
    modes: Tensor
    fconstants: Tensor
    rmasses: Tensor


class EnergiesForcesHessians(tp.NamedTuple):
    energies: Tensor
    forces: Tensor
    hessians: Tensor


class ForcesHessians(tp.NamedTuple):
    forces: Tensor
    hessians: Tensor


class SpeciesEnergiesAtomicCharges(tp.NamedTuple):
    species: Tensor
    energies: Tensor
    atomic_charges: Tensor


class EnergiesAtomicCharges(tp.NamedTuple):
    energies: Tensor
    atomic_charges: Tensor


class SpeciesAtomicCharges(tp.NamedTuple):
    # the field names are the JAX package's, ``energies`` in the first slot
    # despite the class name
    energies: Tensor
    atomic_charges: Tensor


class AtomicStdev(tp.NamedTuple):
    species: Tensor
    energies: Tensor
    stdev_atomic_energies: Tensor


class ForceStdev(tp.NamedTuple):
    species: Tensor
    magnitudes: Tensor
    relative_stdev: Tensor
    relative_range: Tensor


class ForceMagnitudes(tp.NamedTuple):
    species: Tensor
    magnitudes: Tensor
