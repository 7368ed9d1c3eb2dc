"""Test and benchmark system factories (the same systems, from the same
seeds, as ``torchani_tpu/testing.py``), and a unittest harness over the
devices.

Every random draw comes from ``numpy.random.RandomState(seed)`` in the JAX
package's order, so both packages make the same molecules.  `make_molecs`,
`make_chain_molecs`, `make_water_box` and `make_solvated_system` give numpy arrays; the reference-style factories
(`make_tensor`, `make_elem_idxs`, `make_molec`, `make_reference_molecs`,
`make_neighbors`) give tensors on ``device``, CUDA unless the caller names
another.
"""

import sys
import typing as tp
import unittest

import numpy as np
import torch

from torchani_tpu_torch.annotations import DeviceArg, Tensor
from torchani_tpu_torch.constants import ATOMIC_NUMBER
from torchani_tpu_torch.utils import resolve_device

__all__ = [
    "make_molecs",
    "make_chain_molecs",
    "make_water_box",
    "make_solvated_system",
    "Molecs",
    "make_tensor",
    "make_elem_idxs",
    "make_molec",
    "make_reference_molecs",
    "make_neighbors",
    "expand",
    "ANITestCase",
    "TestCase",
]


def make_molecs(
    num: int,
    max_atoms: int,
    seed: int = 0,
    znums: tp.Sequence[int] = (1, 6, 7, 8),
    box: float = 4.0,
) -> tp.Tuple[np.ndarray, np.ndarray]:
    """Random padded molecule batch: (species znums (C,A), coords (C,A,3))."""
    rng = np.random.RandomState(seed)
    species = np.full((num, max_atoms), -1, dtype=np.int64)
    coords = np.zeros((num, max_atoms, 3), dtype=np.float32)
    for i in range(num):
        n = rng.randint(3, max_atoms + 1)
        species[i, :n] = rng.choice(znums, size=n)
        coords[i, :n] = rng.rand(n, 3) * box
    return species, coords


def make_chain_molecs(
    num: int,
    max_atoms: int,
    seed: int = 0,
    znums: tp.Sequence[int] = (1, 6, 7, 8),
) -> tp.Tuple[np.ndarray, np.ndarray]:
    """Random tree-bonded (GDB-like) molecule batch: ``(species (C, A),
    coords (C, A, 3))`` with -1 / zero padding.

    Each molecule holds 3 to ``max_atoms`` atoms grown as a random tree
    with ~1.4 A bonds and a 1.6 A non-bonded exclusion, so an atom has
    O(10) neighbors within the 3.5 A angular cutoff (`make_molecs` puts
    every atom within every cutoff of every other).
    """
    rng = np.random.RandomState(seed)
    species = np.full((num, max_atoms), -1, dtype=np.int64)
    coords = np.zeros((num, max_atoms, 3), dtype=np.float32)
    for i in range(num):
        n = rng.randint(3, max_atoms + 1)
        species[i, :n] = rng.choice(znums, size=n)
        pos = np.zeros((n, 3))
        degree = np.zeros(n, dtype=np.int64)
        for a in range(1, n):
            for _attempt in range(20):
                # attach to a random atom, favouring low degrees
                weights = 1.0 / (1.0 + degree[:a]) ** 2
                parent = rng.choice(a, p=weights / weights.sum())
                direction = rng.randn(3)
                direction /= np.linalg.norm(direction)
                bond = 1.4 + rng.randn() * 0.08
                cand = pos[parent] + direction * bond
                d = np.linalg.norm(pos[:a] - cand, axis=1)
                d[parent] = np.inf  # the bonded parent is exempt
                if np.all(d > 1.6):
                    break
            pos[a] = cand
            degree[parent] += 1
            degree[a] += 1
        coords[i, :n] = pos + rng.randn(1, 3) * 0.01
    return species, coords


def make_water_box(
    target_atoms: int = 10000,
    density_molec_per_a3: float = 0.0334,
    seed: int = 0,
) -> tp.Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Periodic water box: (species (1, A), coords (1, A, 3), cell (3, 3)).

    Rigid TIP3P-like molecules (r_OH = 0.9572 A, angle 104.52 deg), randomly
    oriented on a perturbed cubic lattice at liquid density (0.0334
    molecules/A^3); partial lattices get vacancies rather than over-packing.
    """
    n_water = target_atoms // 3
    n_side = int(np.ceil(n_water ** (1 / 3)))
    spacing = (1.0 / density_molec_per_a3) ** (1 / 3)
    box = n_side * spacing
    rng = np.random.RandomState(seed)

    r_oh = 0.9572
    theta = np.deg2rad(104.52)
    base = np.array(
        [
            [0.0, 0.0, 0.0],
            [r_oh, 0.0, 0.0],
            [r_oh * np.cos(theta), r_oh * np.sin(theta), 0.0],
        ],
        dtype=np.float64,
    )

    species_list = []
    coords_list = []
    count = 0
    for ix in range(n_side):
        for iy in range(n_side):
            for iz in range(n_side):
                if count >= n_water:
                    break
                origin = (np.array([ix, iy, iz]) + 0.5) * spacing
                q = rng.randn(4)
                q /= np.linalg.norm(q)
                w, x, y, z = q
                rot = np.array(
                    [
                        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
                    ]
                )
                mol = base @ rot.T + origin + rng.randn(3) * 0.05
                coords_list.append(mol)
                species_list.extend([8, 1, 1])
                count += 1
    species = np.asarray(species_list, dtype=np.int64)[None]
    coords = np.concatenate(coords_list, axis=0).astype(np.float32)[None]
    cell = np.eye(3, dtype=np.float32) * box
    return species, coords, cell


def make_solvated_system(
    solute_pdb,
    water_pdb,
    box: float,
    clash: float = 1.7,
) -> tp.Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Solvate a PDB solute in tiled PDB water: ``(species (A,), coords
    (A, 3), cell (3, 3))``, species as atomic numbers.

    The water template's ``CRYST1`` cell is tiled to fill an orthorhombic
    ``box`` (A), each molecule (consecutive O, H, H records) wrapped into
    the template cell by its centroid first; molecules whose centroid falls
    outside the box go.  The solute is centered in the box, and every water
    with an atom within ``clash`` A of a solute atom (minimum image) is
    removed.  A box smaller than the solute's extent plus twice ``clash``
    warns: the solute then overlaps its own periodic image.  Without a
    solute (None) the result is the tiled water.
    """
    from torchani_tpu_torch.io import read_pdb

    wz, wc, wcell = read_pdb(water_pdb)
    if wcell is None:
        raise ValueError("water template must have a CRYST1 cell")
    side = float(wcell[0, 0])
    n_rep = int(np.ceil(box / side))
    cell = np.diag([box, box, box]).astype(np.float32)
    mols = wc.reshape(-1, 3, 3)
    centroid = mols.mean(axis=1, keepdims=True)
    mols = mols - np.floor(centroid / side) * side
    offsets = np.stack(
        np.meshgrid(*[np.arange(n_rep) * side] * 3, indexing="ij"), axis=-1
    ).reshape(-1, 3)
    tiled = (mols[None] + offsets[:, None, None, :]).reshape(-1, 3, 3)
    tiled_z = np.tile(wz.reshape(-1, 3), (len(offsets), 1))
    inside = (tiled.mean(axis=1) < box).all(axis=-1)
    waters_xyz = tiled[inside]
    waters_z = tiled_z[inside]

    if solute_pdb is None:
        return (
            waters_z.reshape(-1).astype(np.int64),
            waters_xyz.reshape(-1, 3).astype(np.float32),
            cell,
        )
    sz, sc, _ = read_pdb(solute_pdb)
    extent = float((sc.max(axis=0) - sc.min(axis=0)).max())
    if box < extent + 2.0 * clash:
        import warnings

        warnings.warn(
            f"box {box} A smaller than solute extent {extent:.1f} A "
            f"(+ {clash} A clash margin): periodic self-overlap",
            stacklevel=2,
        )
    sc = sc - sc.mean(axis=0) + box / 2.0
    # minimum-image distance of each water atom to the solute, in chunks
    flat = waters_xyz.reshape(-1, 3)
    mind = np.empty(len(flat), dtype=np.float64)
    for i0 in range(0, len(flat), 4096):
        d = flat[i0 : i0 + 4096, None, :] - sc[None, :, :]
        d -= np.round(d / box) * box
        mind[i0 : i0 + 4096] = np.sqrt((d**2).sum(-1)).min(axis=1)
    keep = (mind.reshape(-1, 3) > clash).all(axis=1)
    species = np.concatenate([sz, waters_z[keep].reshape(-1)])
    coords = np.concatenate([sc, waters_xyz[keep].reshape(-1, 3)], axis=0)
    return species.astype(np.int64), coords.astype(np.float32), cell


class Molecs(tp.NamedTuple):
    """A group of molecules: coordinates ``(C, A, 3)``, atomic numbers
    ``(C, A)``, and the cell and pbc (None without a box)."""

    coords: Tensor
    atomic_nums: Tensor
    cell: tp.Optional[Tensor]
    pbc: tp.Optional[Tensor]


def make_tensor(
    shape, low: float = 0.0, high: float = 1.0, seed: int = 0, device: DeviceArg = None
) -> Tensor:
    """Uniform f32 tensor in ``[low, high)``."""
    rng = np.random.RandomState(seed)
    values = (rng.rand(*shape) * (high - low) + low).astype(np.float32)
    return torch.as_tensor(values, device=resolve_device(device))


def make_elem_idxs(
    molecs_num: int,
    atoms_num: int,
    symbols: tp.Sequence[str] = ("H", "C", "N", "O"),
    seed: tp.Optional[int] = None,
    device: DeviceArg = None,
) -> Tensor:
    """Random element indices ``(C, A)`` into ``symbols`` (int64)."""
    rng = np.random.RandomState(seed)
    idxs = rng.randint(0, len(symbols), size=(molecs_num, atoms_num))
    return torch.as_tensor(idxs.astype(np.int64), device=resolve_device(device))


def make_molec(
    atoms: int,
    cell_size: float = 10.0,
    pbc: bool = False,
    symbols: tp.Sequence[str] = ("H", "C", "N", "O"),
    seed: tp.Optional[int] = None,
    device: DeviceArg = None,
) -> Molecs:
    """One random molecule as a `Molecs`."""
    return make_reference_molecs(1, atoms, cell_size, pbc, symbols, seed, device)


def make_reference_molecs(
    molecs_num: int,
    atoms_num: int,
    cell_size: float = 10.0,
    pbc: bool = False,
    symbols: tp.Sequence[str] = ("H", "C", "N", "O"),
    seed: tp.Optional[int] = None,
    device: DeviceArg = None,
) -> Molecs:
    """Random molecules in a cube of ``cell_size`` A (uniform positions,
    elements from ``symbols``); with ``pbc`` a cubic cell slightly larger
    than the cube, periodic along every axis."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    coords = (rng.rand(molecs_num, atoms_num, 3) * cell_size + 1e-3).astype(np.float32)
    kinds = np.asarray([ATOMIC_NUMBER[s] for s in symbols], dtype=np.int64)
    nums = kinds[rng.randint(0, len(symbols), size=(molecs_num, atoms_num))]
    cell = pbc_t = None
    if pbc:
        cell = torch.eye(3, dtype=torch.float32, device=dev) * (cell_size + 2e-3)
        pbc_t = torch.ones(3, dtype=torch.bool, device=dev)
    return Molecs(
        torch.as_tensor(coords, device=dev), torch.as_tensor(nums, device=dev), cell, pbc_t
    )


def make_neighbors(
    atoms: int,
    cutoff: float = 5.2,
    symbols: tp.Sequence[str] = ("H", "C", "N", "O"),
    seed: tp.Optional[int] = None,
    device: DeviceArg = None,
):
    """The neighbor table (`neighbors.adaptive_list`) of one random
    molecule."""
    from torchani_tpu_torch.neighbors import adaptive_list
    from torchani_tpu_torch.nn import SpeciesConverter

    molec = make_molec(atoms, 10.0, False, symbols, seed, device)
    elem = SpeciesConverter(tuple(symbols))(molec.atomic_nums)
    return adaptive_list(cutoff, elem, molec.coords)


def expand(device: tp.Optional[str] = None):
    """Class decorator multiplying an `ANITestCase` over the devices: one
    subclass per device, named ``<Class>_<device>``, in the class's module;
    ``cpu``, and ``cuda`` where a CUDA device is present (or only
    ``device``).  The original class is skipped."""
    if device is not None:
        devices: tp.Tuple[str, ...] = (device,)
    else:
        devices = ("cpu", "cuda") if torch.cuda.is_available() else ("cpu",)

    def decorator(cls):
        module = sys.modules[cls.__module__]
        for dev in devices:
            name = f"{cls.__name__}_{dev}"
            # not skipped: `unittest.skip` below marks the original class,
            # whose attributes the subclasses would inherit
            attrs = {"_device": dev, "__unittest_skip__": False}
            setattr(module, name, type(name, (cls,), attrs))
        return unittest.skip("expanded into per-device variants")(cls)

    return decorator


TestCase = unittest.TestCase


class ANITestCase(unittest.TestCase):
    """`unittest.TestCase` with a device axis (see `expand`): ``self.device``
    is the variant's device, and ``self._setup(x)`` moves a module or a
    tensor there."""

    _device: str = "cpu"

    @property
    def device(self) -> torch.device:
        return torch.device(self._device)

    def _setup(self, x):
        if isinstance(x, (torch.nn.Module, torch.Tensor)):
            return x.to(self.device)
        return x
