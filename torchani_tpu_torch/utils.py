"""Misc utilities: symbol tables, AEV constant construction, cell mapping,
and device resolution."""

import typing as tp

import torch

from torchani_tpu_torch.annotations import DeviceArg, Symbols, Tensor
from torchani_tpu_torch.constants import ATOMIC_NUMBER, PERIODIC_TABLE

__all__ = [
    "SYMBOLS_1X",
    "SYMBOLS_2X",
    "SYMBOLS_2X_ZNUM_ORDER",
    "linspace",
    "map_to_central",
    "resolve_device",
    "symbols_to_atomic_numbers",
    "atomic_numbers_to_symbols",
]

#: Elements used in the ANI-1x and ANI-1ccx models, in model order
SYMBOLS_1X: Symbols = ("H", "C", "N", "O")
#: Elements used in the ANI-2x model, in ani2x model order
SYMBOLS_2X: Symbols = ("H", "C", "N", "O", "S", "F", "Cl")
#: Elements used in the ANI-2x model, in atomic-number order
SYMBOLS_2X_ZNUM_ORDER: Symbols = ("H", "C", "N", "O", "F", "S", "Cl")


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
