"""Composable batch transforms (counterpart of ``torchani_tpu/transforms.py``),
applied at batching or training time.

Transforms are callables over property dicts, numpy in and numpy out:
subtract self energies or an analytical potential's energies (and forces)
from the targets, or convert atomic numbers to model element indices.  The
ones that evaluate a module (`SubtractSAE`, `SubtractEnergyAndForce` and
the xTB and D3 ones over it) run it on its device (CUDA unless the caller
names another) and take forces by ``torch.autograd.grad`` there.
"""

import typing as tp

import numpy as np
import torch

from torchani_tpu_torch.annotations import DeviceArg
from torchani_tpu_torch.nn import SpeciesConverter
from torchani_tpu_torch.sae import SelfEnergy
from torchani_tpu_torch.utils import resolve_device

__all__ = [
    "Transform",
    "Compose",
    "Identity",
    "AtomicNumbersToIndices",
    "SubtractSAE",
    "SubtractEnergyAndForce",
    "SubtractRepulsionXTB",
    "SubtractTwoBodyDispersionD3",
    "identity",
]

Properties = tp.Dict[str, np.ndarray]


class Transform:
    """Base transform: maps a property dict to a property dict."""

    def __call__(self, properties: Properties) -> Properties:
        raise NotImplementedError


class Compose(Transform):
    def __init__(self, transforms: tp.Sequence[Transform]) -> None:
        self.transforms = list(transforms)

    def __call__(self, properties: Properties) -> Properties:
        for t in self.transforms:
            properties = t(properties)
        return properties


class Identity(Transform):
    """Pass-through transform."""

    def __call__(self, properties: Properties) -> Properties:
        return properties


identity = Identity()


class AtomicNumbersToIndices(Transform):
    """Convert the ``species`` key from atomic numbers to element indices
    (int32, -1 padding kept, as the JAX package's)."""

    def __init__(self, symbols: tp.Sequence[str]) -> None:
        self.converter = SpeciesConverter(tuple(symbols))

    def __call__(self, properties: Properties) -> Properties:
        out = dict(properties)
        species = torch.as_tensor(np.asarray(properties["species"]))
        out["species"] = self.converter(species).numpy().astype(np.int32)
        return out


class SubtractSAE(Transform):
    """Subtract per-element self energies from the ``energies`` key.  The
    species may be atomic numbers or element indices (told apart by their
    range, as in the JAX package)."""

    def __init__(
        self,
        symbols: tp.Sequence[str],
        self_energies: tp.Union[tp.Sequence[float], SelfEnergy],
        device: DeviceArg = None,
    ) -> None:
        if isinstance(self_energies, SelfEnergy):
            self.shifter = self_energies
        else:
            self.shifter = SelfEnergy(tuple(symbols), self_energies, device)
        self.converter = SpeciesConverter(self.shifter.symbols)

    def __call__(self, properties: Properties) -> Properties:
        out = dict(properties)
        dev = self.shifter.self_energies.device
        species = torch.as_tensor(np.asarray(properties["species"]), device=dev)
        if int(np.asarray(properties["species"]).max(initial=0)) >= len(self.shifter.symbols):
            species = self.converter(species)
        with torch.no_grad():
            sae = self.shifter(species).cpu().numpy().astype(np.float64)
        out["energies"] = np.asarray(properties["energies"]) - sae
        return out


def _module_device(module: torch.nn.Module) -> torch.device:
    for t in module.buffers():
        return t.device
    return resolve_device(None)


class SubtractEnergyAndForce(Transform):
    """Subtract an analytical potential's energies (and forces) from the
    targets, e.g. to train networks on what repulsion and dispersion leave.
    The potential runs on its own device."""

    def __init__(self, potential, subtract_forces: bool = True) -> None:
        self.potential = potential
        self.subtract_forces = subtract_forces

    def __call__(self, properties: Properties) -> Properties:
        out = dict(properties)
        dev = _module_device(self.potential)
        species = torch.as_tensor(np.asarray(properties["species"]), device=dev)
        coords = torch.as_tensor(
            np.asarray(properties["coordinates"], dtype=np.float32), device=dev
        )
        if self.subtract_forces and "forces" in properties:
            coords.requires_grad_(True)
            pot_e = self.potential(species, coords)
            (g,) = torch.autograd.grad(pot_e.sum(), coords)
            out["forces"] = np.asarray(properties["forces"]) - (-g).cpu().numpy()
            pot_e = pot_e.detach()
        else:
            with torch.no_grad():
                pot_e = self.potential(species, coords)
        out["energies"] = np.asarray(properties["energies"]) - pot_e.cpu().numpy().astype(
            np.float64
        )
        return out


class SubtractRepulsionXTB(Transform):
    """Subtract xTB repulsion energies and forces.  Takes the arguments of
    `torchani_tpu_torch.potentials.RepulsionXTB` (``device`` among them)."""

    def __init__(self, *args, subtract_force: bool = True, **kwargs) -> None:
        from torchani_tpu_torch.potentials import RepulsionXTB

        self._transform = SubtractEnergyAndForce(
            RepulsionXTB.make(*args, **kwargs), subtract_forces=subtract_force
        )

    def __call__(self, properties: Properties) -> Properties:
        return self._transform(properties)


class SubtractTwoBodyDispersionD3(Transform):
    """Subtract two-body DFT-D3 energies and forces.  Takes the arguments of
    `torchani_tpu_torch.potentials.TwoBodyDispersionD3.from_functional`
    (``device`` among them)."""

    def __init__(self, *args, subtract_force: bool = True, **kwargs) -> None:
        from torchani_tpu_torch.potentials import TwoBodyDispersionD3

        self._transform = SubtractEnergyAndForce(
            TwoBodyDispersionD3.from_functional(*args, **kwargs),
            subtract_forces=subtract_force,
        )

    def __call__(self, properties: Properties) -> Properties:
        return self._transform(properties)
