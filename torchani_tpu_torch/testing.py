"""Test and benchmark system factories (numpy; the same systems, from the
same seeds, as ``torchani_tpu/testing.py``)."""

import typing as tp

import numpy as np

__all__ = ["make_molecs", "make_water_box"]


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
