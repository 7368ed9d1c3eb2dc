"""Misc utilities: symbol tables, AEV constant construction, cell mapping,
device resolution, and the host-side padding of property batches."""

import math
import typing as tp

import numpy as np
import torch

from torchani_tpu_torch.annotations import DeviceArg, Symbols, Tensor
from torchani_tpu_torch.constants import ATOMIC_NUMBER, MASS, PERIODIC_TABLE

__all__ = [
    "ATOMIC_KEYS",
    "PADDING",
    "SYMBOLS_1X",
    "SYMBOLS_2X",
    "SYMBOLS_2X_ZNUM_ORDER",
    "linspace",
    "map_to_central",
    "resolve_device",
    "tensor_on",
    "symbols_to_atomic_numbers",
    "atomic_numbers_to_symbols",
    "get_atomic_masses",
    "pad_atomic_properties",
    "strip_redundant_padding",
]

#: Elements used in the ANI-1x and ANI-1ccx models, in model order
SYMBOLS_1X: Symbols = ("H", "C", "N", "O")
#: Elements used in the ANI-2x model, in ani2x model order
SYMBOLS_2X: Symbols = ("H", "C", "N", "O", "S", "F", "Cl")
#: Elements used in the ANI-2x model, in atomic-number order
SYMBOLS_2X_ZNUM_ORDER: Symbols = ("H", "C", "N", "O", "F", "S", "Cl")

#: Padding value of each property key in batches of molecules
PADDING: tp.Dict[str, float] = {
    "species": -1,
    "numbers": -1,
    "atomic_numbers": -1,
    "coordinates": 0.0,
    "forces": 0.0,
    "energies": 0.0,
}

#: Keys whose second axis is "number of atoms"
ATOMIC_KEYS = (
    "species",
    "numbers",
    "atomic_numbers",
    "coordinates",
    "forces",
    "coefficients",
    "atomic_charges",
    "atomic_volumes_mbis",
    "atomic_charges_mbis",
    "atomic_dipole_magnitudes_mbis",
    "atomic_quadrupole_magnitudes_mbis",
    "atomic_octupole_magnitudes_mbis",
    "atomic_dipoles",
    "atomic_polarizabilities",
)


def linspace(start: float, stop: float, steps: int) -> tp.Tuple[float, ...]:
    """Pure-python linspace, *excluding* the endpoint.

    Bit-matches the construction of the AEV shift constants in the JAX
    package (``torchani_tpu.utils.linspace``).
    """
    return tuple(start + ((stop - start) / steps) * j for j in range(steps))


def symbols_to_atomic_numbers(symbols: tp.Sequence[str]) -> tp.Tuple[int, ...]:
    return tuple(ATOMIC_NUMBER[s] for s in symbols)


def atomic_numbers_to_symbols(znums: tp.Sequence[int]) -> Symbols:
    return tuple(PERIODIC_TABLE[int(z)] for z in znums)


def get_atomic_masses(atomic_numbers: Tensor) -> Tensor:
    """Masses (AMU) of a tensor of atomic numbers, on its device; -1 padding
    maps to 0."""
    table = torch.tensor(
        [0.0] + [0.0 if math.isnan(m) else m for m in MASS[1:]],
        dtype=torch.float32, device=atomic_numbers.device,
    )
    return table[atomic_numbers.clamp(min=0)]


def map_to_central(coords: Tensor, cell: Tensor, pbc: Tensor) -> Tensor:
    """Wrap atoms into the central cell along periodic axes.

    Fractionalise, wrap into [0, 1) where ``pbc`` is set, convert back.
    Differentiable (the wrap's ``floor`` has zero gradient).
    """
    frac = coords @ torch.linalg.inv(cell)
    frac = frac - torch.floor(frac) * pbc.to(frac.dtype)
    return frac @ cell


def resolve_device(device: DeviceArg = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names another.

    Raises where CUDA is asked for (explicitly or by default) and there is no
    CUDA device: the port never moves to the CPU on its own.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "torchani_tpu_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU"
        )
    return dev


def tensor_on(x, dtype: torch.dtype, device: DeviceArg = None) -> Tensor:
    """An entry point's array input as a ``dtype`` tensor: a tensor stays on
    its device unless ``device`` names one; anything else goes to
    `resolve_device`'s (CUDA by default)."""
    if isinstance(x, torch.Tensor) and device is None:
        return x.detach().to(dtype)
    if isinstance(x, torch.Tensor):
        return x.detach().to(dtype=dtype, device=resolve_device(device))
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=resolve_device(device))


def pad_atomic_properties(
    properties: tp.Sequence[tp.Mapping[str, np.ndarray]],
    padding_values: tp.Optional[tp.Dict[str, float]] = None,
) -> tp.Dict[str, np.ndarray]:
    """Combine a sequence of property dicts into single padded arrays.

    Host-side (numpy).  Inputs are ``[{'species': arr, ...}, ...]`` where each
    array's leading axis is molecules and (for atomic keys) second axis is
    atoms; output pads the atom axis to the max across inputs (with
    ``padding_values``, by default `PADDING`, else 0) and concatenates along
    molecules.  Integer arrays come out as int64.
    """
    if padding_values is None:
        padding_values = PADDING
    properties = [{k: np.asarray(v) for k, v in p.items()} for p in properties]
    vectors = [k for k in properties[0] if properties[0][k].ndim > 1]
    scalars = [k for k in properties[0] if properties[0][k].ndim == 1]
    padded_sizes = {k: max(p[k].shape[1] for p in properties) for k in vectors}
    num_molecules = [p[vectors[0]].shape[0] for p in properties]
    total = sum(num_molecules)
    output: tp.Dict[str, np.ndarray] = {}
    for k in scalars:
        output[k] = np.concatenate([p[k] for p in properties])
    for k in vectors:
        first = properties[0][k]
        dtype = np.int64 if np.issubdtype(first.dtype, np.integer) else first.dtype
        shape = [total, padded_sizes[k]] + list(first.shape[2:])
        out = np.full(shape, padding_values.get(k, 0.0), dtype=dtype)
        i0 = 0
        for n, p in zip(num_molecules, properties):
            out[i0:i0 + n, : p[k].shape[1], ...] = p[k]
            i0 += n
        output[k] = out
    return output


def strip_redundant_padding(
    properties: tp.Dict[str, np.ndarray],
    atomic_properties: tp.Iterable[str] = ATOMIC_KEYS,
) -> tp.Dict[str, np.ndarray]:
    """Drop the atom-axis columns that are padding (species < 0) in every
    molecule, from each of ``atomic_properties`` present (in place;
    returned)."""
    species = np.asarray(properties["species"])
    non_padding = np.flatnonzero((species >= 0).any(axis=0))
    for k in atomic_properties:
        if k in properties:
            properties[k] = np.asarray(properties[k])[:, non_padding, ...]
    return properties
