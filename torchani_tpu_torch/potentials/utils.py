"""Dimer curves of pair potentials (counterpart of
``torchani_tpu/potentials/utils.py``).

The whole r grid is one batch of ``(steps, 2)`` dimers, evaluated in one
call on the potential's device; forces come from one `torch.autograd.grad`
through that batch.  `pair_curves` returns numpy arrays; `plot` draws them
with matplotlib.
"""

import itertools
import math
import typing as tp

import numpy as np
import torch

from torchani_tpu_torch.constants import ATOMIC_NUMBER
from torchani_tpu_torch.potentials.core import BasePairPotential
from torchani_tpu_torch.units import ANGSTROM_TO_BOHR, HARTREE_TO_EV, HARTREE_TO_KCALPERMOL

__all__ = ["pair_curves", "plot"]

_EFACTORS = {"ev": HARTREE_TO_EV, "kcalpermol": HARTREE_TO_KCALPERMOL, "hartree": 1.0}
_RFACTORS = {"angstrom": 1.0, "bohr": ANGSTROM_TO_BOHR}


def pair_curves(
    pot: BasePairPotential,
    symbol_pairs: tp.Sequence[tp.Tuple[str, str]] = (),
    xmin: float = 0.1,
    xmax: tp.Optional[float] = None,
    steps: int = 1000,
    force: bool = False,
    eunits: str = "hartree",
    runits: str = "angstrom",
) -> tp.Tuple[np.ndarray, tp.Dict[tp.Tuple[str, str], np.ndarray]]:
    """Dimer energy curves (or the force on atom 0 along r) of element pairs.

    Returns ``(r, {pair: values})``, ``r`` in ``runits`` and the values in
    ``eunits`` (per ``runits`` for forces).  By default every
    ``combinations_with_replacement`` of the potential's symbols, ``steps``
    points from 0.1 to the cutoff (10 where it is infinite).
    """
    efactor = _EFACTORS.get(eunits.lower())
    if efactor is None:
        raise ValueError(f"Unsupported unit {eunits}. Supported are {set(_EFACTORS)}")
    rfactor = _RFACTORS.get(runits.lower())
    if rfactor is None:
        raise ValueError(f"Unsupported unit {runits}. Supported are {set(_RFACTORS)}")
    if not symbol_pairs:
        symbol_pairs = tuple(itertools.combinations_with_replacement(pot.symbols, 2))
    if xmax is None:
        xmax = pot.cutoff if not math.isinf(pot.cutoff) else 10.0
    dev = next(itertools.chain(pot.buffers(), pot.parameters())).device
    # the grid is made in display units and taken as Angstrom times rfactor
    r_display = np.linspace(xmin, xmax, steps, dtype=np.float32)
    r_ang = torch.as_tensor(r_display * rfactor, device=dev)
    curves: tp.Dict[tp.Tuple[str, str], np.ndarray] = {}
    for pair in symbol_pairs:
        atomic_nums = torch.tensor(
            [[ATOMIC_NUMBER[pair[0]], ATOMIC_NUMBER[pair[1]]]], device=dev
        ).expand(steps, 2)
        r = r_ang.detach().requires_grad_(force)
        with torch.set_grad_enabled(force):
            first = torch.stack([r, torch.zeros_like(r), torch.zeros_like(r)], dim=-1)
            coords = torch.stack([first, torch.zeros_like(first)], dim=1)
            values = pot(atomic_nums, coords) * efactor
            if force:
                # d/dr in display units: the chain rule gives rfactor
                (g,) = torch.autograd.grad(values.sum(), r)
                values = -g * rfactor
        curves[tuple(pair)] = values.detach().cpu().numpy()
    return r_display, curves


def plot(
    pot: BasePairPotential,
    title: str = "",
    symbol_pairs: tp.Sequence[tp.Tuple[str, str]] = (),
    xmin: float = 0.1,
    xmax: tp.Optional[float] = None,
    ymin: tp.Optional[float] = None,
    ymax: tp.Optional[float] = None,
    steps: int = 1000,
    force: bool = False,
    eunits: str = "hartree",
    runits: str = "angstrom",
    ylog: bool = False,
    block: bool = True,
) -> None:
    """Plot `pair_curves` with matplotlib (`RuntimeError` without it)."""
    try:
        import matplotlib.pyplot as plt
    except ImportError as e:
        raise RuntimeError("Please install matplotlib to plot this potential") from e
    r, curves = pair_curves(
        pot, symbol_pairs=symbol_pairs, xmin=xmin, xmax=xmax, steps=steps,
        force=force, eunits=eunits, runits=runits,
    )
    fig, ax = plt.subplots()
    for (s0, s1), values in curves.items():
        ax.plot(r, values, label=f"{s0}-{s1}")
    ax.legend()
    if not title:
        title = pot.__class__.__name__
    if title != "no":
        ax.set_title(title)
    runit_sym = {"angstrom": r"\AA", "bohr": r"a_0"}[runits.lower()]
    eunit_sym = {
        "hartree": r"E_h",
        "ev": r"\mathrm{eV}",
        "kcalpermol": r"\text{kcal}/\text{mol}",
    }[eunits.lower()]
    ax.set_xlabel(r"Inter atomic distance, $\left(" f"{runit_sym}" r"\right)$")
    if force:
        ax.set_ylabel(r"Force, $\left(" f"{eunit_sym}/{runit_sym}" r"\right)$")
    else:
        ax.set_ylabel(r"Energy, $\left(" f"{eunit_sym}" r"\right)$")
    if ylog:
        ax.set_yscale("log")
    ax.set_ylim(ymin, ymax)
    plt.show(block=block)
