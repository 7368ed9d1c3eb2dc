"""The benchmark's input generators, seeded by ``--seed``.

Frozen, vectorised copies of `torchani_tpu_torch.testing.make_water_box` and
`make_chain_molecs` (commit b90920e, lines 104-156 and 59-101): the same
constructions and distributions, drawn in bulk from a numpy ``Generator``
instead of one molecule at a time, so that set-up stays short.  What a seed
changes is never how much work there is: a water box has its size from the
traffic file and only its orientations and jitter from the seed; a batch of
molecules has a fixed multiset of sizes and a fixed count of each element,
which the seed shuffles and arranges in space.
"""

import typing as tp

import numpy as np

from benchmark.reference.model import ACCEL_UNIT, KB_HARTREE


def rng(seed: int, stream: int) -> np.random.Generator:
    """Independent numpy stream ``stream`` of ``seed`` (any non-negative
    integer)."""
    return np.random.default_rng([int(seed) % 2**64, stream])


def water_box(target_atoms: int, seed: int, density_molec_per_a3: float = 0.0334
              ) -> tp.Tuple[np.ndarray, np.ndarray, float]:
    """Periodic water box: atomic numbers ``(A,)``, coordinates ``(A, 3)``
    (float32, Angstrom) and the cubic box's length.

    Rigid TIP3P-like molecules (r_OH 0.9572 A, 104.52 degrees), randomly
    oriented on a cubic lattice of ``ceil((target / 3)^(1/3))`` sites a side
    at liquid density, each jittered by 0.05 A; sites past ``target / 3``
    molecules stay empty."""
    g = rng(seed, 0)
    n_water = target_atoms // 3
    n_side = int(np.ceil(n_water ** (1 / 3)))
    spacing = (1.0 / density_molec_per_a3) ** (1 / 3)
    box = n_side * spacing
    r_oh, theta = 0.9572, np.deg2rad(104.52)
    base = np.array([[0.0, 0.0, 0.0], [r_oh, 0.0, 0.0],
                     [r_oh * np.cos(theta), r_oh * np.sin(theta), 0.0]])
    sites = np.stack(np.meshgrid(*[np.arange(n_side)] * 3, indexing="ij"), -1).reshape(-1, 3)
    origin = (sites[:n_water] + 0.5) * spacing
    q = g.standard_normal((n_water, 4))
    w, x, y, z = (q / np.linalg.norm(q, axis=1, keepdims=True)).T
    rot = np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], 1)  # (n, 3, 3)
    jitter = g.standard_normal((n_water, 1, 3)) * 0.05
    mols = np.einsum("ad,nkd->nak", base, rot) + origin[:, None] + jitter
    species = np.tile(np.array([8, 1, 1], dtype=np.int64), n_water)
    return species, mols.reshape(-1, 3).astype(np.float32), float(box)


def maxwell_boltzmann(seed: int, masses: np.ndarray, temperature: float) -> np.ndarray:
    """Velocities (Angstrom/fs) at ``temperature`` K: normal deviates of
    ``sqrt(kB T / m)`` per component, in float32."""
    g = rng(seed, 1)
    sigma = np.sqrt(KB_HARTREE * temperature / masses.astype(np.float64)) * np.sqrt(ACCEL_UNIT)
    return (g.standard_normal((masses.shape[0], 3)) * sigma[:, None]).astype(np.float32)


def chain_batch(seed: int, stream: int, num: int, atoms_min: int, atoms_max: int,
                elements: tp.Sequence[int], attempts: int = 20
                ) -> tp.Tuple[np.ndarray, np.ndarray]:
    """A padded batch of tree-bonded (GDB-like) molecules: atomic numbers
    ``(num, atoms_max)`` (-1 padding) and coordinates ``(num, atoms_max, 3)``
    (float32, zeros in the padding).

    The sizes are ``atoms_min`` to ``atoms_max`` in turn, shuffled; the
    batch's atoms are split equally among ``elements`` and shuffled (the
    frozen generator draws each atom's element uniformly from them).  Each
    atom after the first bonds to an earlier one chosen with weight ``1 /
    (1 + degree)^2``, 1.4 A (sd 0.08) away in a random direction, redrawn
    until it lies over 1.6 A from every earlier atom but its parent; after
    ``attempts`` draws the last one stands (`make_chain_molecs`' rule)."""
    g = rng(seed, stream)
    span = atoms_max - atoms_min + 1
    sizes = g.permutation(atoms_min + np.arange(num) % span)
    total = int(sizes.sum())
    znums = np.asarray(elements, dtype=np.int64)
    counts = np.full(znums.size, total // znums.size, dtype=np.int64)
    counts[: total - counts.sum()] += 1
    valid = np.arange(atoms_max)[None, :] < sizes[:, None]
    species = np.full((num, atoms_max), -1, dtype=np.int64)
    species[valid] = g.permutation(np.repeat(znums, counts))
    pos = np.zeros((num, atoms_max, 3))
    degree = np.zeros((num, atoms_max))
    rows = np.arange(num)
    for a in range(1, atoms_max):
        todo = rows[sizes > a]
        placed = np.zeros((num, 3))
        parent_of = np.zeros(num, dtype=np.int64)
        for _attempt in range(attempts):
            if todo.size == 0:
                break
            weights = 1.0 / (1.0 + degree[todo, :a]) ** 2
            cdf = np.cumsum(weights, axis=1)
            u = g.random(todo.size) * cdf[:, -1]
            parent = np.minimum((cdf < u[:, None]).sum(1), a - 1)
            direction = g.standard_normal((todo.size, 3))
            direction /= np.linalg.norm(direction, axis=1, keepdims=True)
            bond = 1.4 + g.standard_normal(todo.size) * 0.08
            cand = pos[todo, parent] + direction * bond[:, None]
            d = np.linalg.norm(pos[todo, :a] - cand[:, None], axis=-1)
            d[np.arange(todo.size), parent] = np.inf
            ok = np.all(d > 1.6, axis=1)
            placed[todo], parent_of[todo] = cand, parent
            todo = todo[~ok]
        grown = rows[sizes > a]
        pos[grown, a] = placed[grown]
        degree[grown, parent_of[grown]] += 1
        degree[grown, a] += 1
    pos += g.standard_normal((num, 1, 3)) * 0.01
    coords = np.where(valid[..., None], pos, 0.0).astype(np.float32)
    return species, coords


def force_labels(seed: int, stream: int, species: np.ndarray, energy_sd: float,
                 force_sd: float) -> tp.Tuple[np.ndarray, np.ndarray]:
    """Training targets for a batch, self energies subtracted: a normal
    deviate of ``energy_sd`` Ha times the square root of each molecule's
    atom count, and normal forces of ``force_sd`` Ha/A per component (zeros
    in the padding)."""
    g = rng(seed, stream)
    valid = species >= 0
    n = valid.sum(1)
    energies = g.standard_normal(species.shape[0]) * energy_sd * np.sqrt(n)
    forces = g.standard_normal(species.shape + (3,)) * force_sd * valid[..., None]
    return energies.astype(np.float32), forces.astype(np.float32)
