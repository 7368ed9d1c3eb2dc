"""Misc utilities: symbol tables and converters, AEV constant construction,
cell mapping, device resolution, the host-side padding of property batches,
and the permutation gather whose backward is the inverse gather."""

import math
import typing as tp

import numpy as np
import torch

from torchani_tpu_torch.annotations import DeviceArg, Symbols, Tensor
from torchani_tpu_torch.constants import ATOMIC_NUMBER, MASS, PERIODIC_TABLE
from torchani_tpu_torch.profiling import scope

__all__ = [
    "ATOMIC_KEYS",
    "PADDING",
    "SYMBOLS_1X",
    "SYMBOLS_2X",
    "SYMBOLS_2X_ZNUM_ORDER",
    "linspace",
    "map_to_central",
    "exact_matmul",
    "resolve_device",
    "tensor_on",
    "symbols_to_atomic_numbers",
    "atomic_numbers_to_symbols",
    "get_atomic_masses",
    "pad_atomic_properties",
    "strip_redundant_padding",
    "cumsum_from_zero",
    "species_to_formula",
    "sort_by_atomic_num",
    "ChemicalSymbolsToInts",
    "AtomicNumbersToMasses",
    "ChemicalSymbolsToAtomicNumbers",
    "AtomicNumbersToChemicalSymbols",
    "IntsToChemicalSymbols",
    "atomic_numbers_to_masses",
    "download_and_extract",
    "perm_gather",
    "nonzero_in_chunks",
    "fast_masked_select",
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


def cumsum_from_zero(x: Tensor, dim: int = 0) -> Tensor:
    """Exclusive cumulative sum along ``dim`` (first element 0)."""
    return torch.cumsum(x, dim=dim) - x


def species_to_formula(species: np.ndarray) -> tp.List[str]:
    """Chemical symbols ``(A,)`` or ``(C, A)`` (``""`` padding) -> one
    formula per molecule, elements in alphabetical order."""
    species = np.asarray(species)
    if species.ndim == 1:
        species = species[None]
    elif species.ndim != 2:
        raise ValueError("Species needs to have two dims/axes")
    formulas = []
    for row in species:
        symbols, counts = np.unique(row[row != ""], return_counts=True)
        formulas.append(
            "".join(f"{s}{c}" if c > 1 else str(s) for s, c in zip(symbols, counts))
        )
    return formulas


def sort_by_atomic_num(symbols: tp.Sequence[str]) -> Symbols:
    """Chemical symbols sorted by atomic number."""
    return tuple(sorted(symbols, key=lambda s: ATOMIC_NUMBER[s]))


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


class ChemicalSymbolsToInts:
    """Chemical symbols -> 0-based model element indices (int64 numpy).

    ``ChemicalSymbolsToInts(("H", "C"))(["C", "H", "H"])`` is ``[1, 0, 0]``.
    """

    def __init__(self, symbols: tp.Sequence[str]) -> None:
        self._symbols = tuple(symbols)
        self._map = {s: i for i, s in enumerate(self._symbols)}

    def __call__(self, symbols: tp.Sequence[str]) -> np.ndarray:
        return np.array([self._map[s] for s in symbols], dtype=np.int64)

    def __len__(self) -> int:
        return len(self._symbols)


class AtomicNumbersToMasses:
    """Atomic numbers -> masses (AMU) on their device; -1 padding maps to 0."""

    def __call__(self, atomic_numbers: Tensor) -> Tensor:
        return get_atomic_masses(atomic_numbers)


class ChemicalSymbolsToAtomicNumbers:
    """Chemical symbols -> atomic numbers (int64 numpy)."""

    def __call__(self, symbols: tp.Sequence[str]) -> np.ndarray:
        return np.array(symbols_to_atomic_numbers(symbols), dtype=np.int64)


class AtomicNumbersToChemicalSymbols:
    """Atomic numbers -> chemical symbols; -1 padding is dropped."""

    def __call__(self, atomic_numbers) -> tp.List[str]:
        return list(atomic_numbers_to_symbols(
            [int(z) for z in _host(atomic_numbers).reshape(-1) if int(z) >= 0]
        ))


class IntsToChemicalSymbols:
    """0-based model element indices -> chemical symbols; -1 padding is
    dropped."""

    def __init__(self, symbols: tp.Sequence[str]) -> None:
        self._symbols = tuple(symbols)

    def __call__(self, idxs) -> tp.List[str]:
        return [self._symbols[int(i)] for i in _host(idxs).reshape(-1) if int(i) >= 0]


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def atomic_numbers_to_masses(atomic_numbers: Tensor) -> Tensor:
    """Alias of `get_atomic_masses`."""
    return get_atomic_masses(atomic_numbers)


def download_and_extract(*args: tp.Any, **kwargs: tp.Any) -> None:
    """Unavailable: the package fetches nothing over the network.  Place the
    files under the data root (`torchani_tpu_torch.paths.data_dir`)."""
    raise RuntimeError(
        "download_and_extract is unavailable: this package fetches nothing over the "
        "network. Place the archive under the torchani_tpu_torch data root instead."
    )


def _perm_gather_rows(x: Tensor, fwd_idx: Tensor) -> Tensor:
    n = x.shape[0]
    out = x.index_select(0, fwd_idx.clamp(max=max(n - 1, 0)))
    keep = (fwd_idx < n).reshape((-1,) + (1,) * (x.dim() - 1))
    return torch.where(keep, out, torch.zeros((), dtype=x.dtype, device=x.device))


class _PermGather(torch.autograd.Function):
    """`perm_gather` as an autograd function: its backward is itself, with
    the indices swapped, so every order of differentiation stays a gather."""

    @staticmethod
    def forward(ctx, x, fwd_idx, bwd_idx):
        ctx.save_for_backward(fwd_idx, bwd_idx)
        return _perm_gather_rows(x, fwd_idx)

    @staticmethod
    def backward(ctx, grad):
        fwd_idx, bwd_idx = ctx.saved_tensors
        return _PermGather.apply(grad, bwd_idx, fwd_idx), None, None


def perm_gather(x: Tensor, fwd_idx: Tensor, bwd_idx: Tensor) -> Tensor:
    """Sentinel-padded permutation row gather whose backward is the inverse
    gather, at every order of differentiation.

    ``out[j] = x[fwd_idx[j]]`` for in-range indices, 0 for sentinel indices
    (``>= len(x)``).  ``bwd_idx`` must be the inverse on the real entries
    (``fwd_idx[bwd_idx[i]] == i`` whenever ``bwd_idx[i]`` is in range),
    with sentinels ``>= len(fwd_idx)`` for dropped rows; the backward is
    then ``perm_gather(grad, bwd_idx, fwd_idx)``, a gather where a plain
    row gather's backward would add with atomics.  The counterpart of the
    JAX package's primitive of the same name.
    """
    return _PermGather.apply(x, fwd_idx, bwd_idx)


def nonzero_in_chunks(x: Tensor, chunk_size: int = 2**31 - 1) -> Tensor:
    """Flat indices of the nonzero elements of ``x``, found ``chunk_size``
    elements at a time (``torch.nonzero`` takes at most 2^31 - 1)."""
    flat = x.reshape(-1)
    chunks = [
        torch.nonzero(flat[start:start + chunk_size]).reshape(-1) + start
        for start in range(0, flat.numel(), chunk_size)
    ]
    if not chunks:
        return torch.zeros((0,), dtype=torch.int64, device=x.device)
    return torch.cat(chunks)


def fast_masked_select(x: Tensor, mask: Tensor, idx: int = 0) -> Tensor:
    """``x`` at the nonzero entries of the flat ``mask`` along axis ``idx``
    (an ``index_select``; the result's size waits for the device)."""
    return x.index_select(idx, nonzero_in_chunks(mask))


def exact_matmul(x: Tensor, m: Tensor) -> Tensor:
    """``x @ m`` in strict f32.

    The JAX package pins position-carrying products to
    ``Precision.HIGHEST`` because a TPU rounds f32 matmul inputs to bf16 by
    default.  On the card the only such rounding is TF32, which the package
    switches off at import (``torch.backends.cuda.matmul.allow_tf32 =
    False``), so a plain ``torch.matmul`` is already strict f32.
    """
    return torch.matmul(x, m)


def map_to_central(coords: Tensor, cell: Tensor, pbc: Tensor) -> Tensor:
    """Wrap atoms into the central cell along periodic axes.

    Fractionalise, wrap into [0, 1) where ``pbc`` is set, convert back.
    Differentiable (the wrap's ``floor`` has zero gradient).  The inverse
    reads its singularity check back to the host: a wait for a card.
    """
    with scope("utils.cell_inverse", wait=True):
        inverse = torch.linalg.inv(cell)
    frac = coords @ inverse
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


def __getattr__(name: str):
    # imported lazily: sae and the training modules import this module
    if name == "EnergyShifter":
        from torchani_tpu_torch.sae import SelfEnergy

        return SelfEnergy
    if name == "merge_state_dicts":
        from torchani_tpu_torch.training.checkpoints import merge_state_dicts

        return merge_state_dicts
    raise AttributeError(f"module 'torchani_tpu_torch.utils' has no attribute {name!r}")
