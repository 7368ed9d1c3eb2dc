"""Read and write molecules in ``.xyz`` (extxyz-compatible) and ``.pdb``
format (counterpart of ``torchani_tpu/io.py``).

Multi-conformer files, ``Lattice="..."`` cell parsing, and the padding
conventions: -1 element padding in arrays, atomic number 100 as the on-disk
padding marker.  Host-side, numpy in and out.  Parsing is plain Python; the
JAX package's native fast path is not part of this package.
"""

import shlex
import typing as tp
from pathlib import Path

import numpy as np

from torchani_tpu_torch.constants import ATOMIC_NUMBER, PERIODIC_TABLE
from torchani_tpu_torch.utils import pad_atomic_properties

__all__ = ["read_xyz", "write_xyz", "read_pdb", "TorchaniIOError"]


class TorchaniIOError(IOError):
    pass


def write_xyz(
    species: np.ndarray,  # (C, A) atomic numbers, -1 padding
    coordinates: np.ndarray,  # (C, A, 3)
    dest,
    cell: tp.Optional[np.ndarray] = None,
    pad: bool = False,
    pad_coord_value: float = 0.0,
    pad_species_value: int = 100,
) -> None:
    """Write an (ext)xyz file with possibly many conformations.  Without
    ``pad`` padding atoms are left out; with it they are written as element
    ``pad_species_value`` at ``pad_coord_value``."""
    species = np.asarray(species)
    coordinates = np.asarray(coordinates)
    if species.ndim != 2:
        raise ValueError("Species should be a 2 dim array")
    if coordinates.shape != species.shape + (3,):
        raise ValueError("Coordinates should have shape (molecules, atoms, 3)")
    if cell is not None and np.shape(cell) != (3, 3):
        raise ValueError("Cell should be an array of shape (3, 3)")

    with open(Path(dest), "wt", encoding="utf-8") as f:
        for znums, coords in zip(species.copy(), coordinates.copy()):
            if not pad:
                mask = znums != -1
                coords = coords[mask]
                znums = znums[mask]
            else:
                if (znums == pad_species_value).any():
                    raise ValueError(
                        "Can't pad if there are elements with atomic number "
                        f"{pad_species_value}"
                    )
                mask = znums == -1
                znums = np.where(mask, pad_species_value, znums)
                coords = np.where(mask[:, None], pad_coord_value, coords)
            f.write(f"{len(coords)}\n")
            props = "species:S:1:pos:R:3"
            if cell is not None:
                cell_str = " ".join(
                    f"{e:.10f}" if e != 0.0 else "0.0" for e in np.asarray(cell).reshape(-1)
                )
                f.write(f'Lattice="{cell_str}" Properties={props} pbc="T T T"\n')
            else:
                f.write(f'Properties={props} pbc="F F F"\n')
            for z, atom in zip(znums, coords):
                f.write(
                    f"{PERIODIC_TABLE[int(z)]} "
                    f"{atom[0]:.10f} {atom[1]:.10f} {atom[2]:.10f}\n"
                )


def _parse_comment(
    comment: str,
) -> tp.Tuple[tp.Optional[np.ndarray], tp.Optional[np.ndarray]]:
    cell = None
    pbc = None
    for token in shlex.split(comment):
        key, _, value = token.partition("=")
        if key.lower() == "lattice":
            vals = [float(v) for v in value.split()]
            if len(vals) != 9:
                raise TorchaniIOError(f"Malformed Lattice in comment: {comment}")
            cell = np.asarray(vals, dtype=np.float32).reshape(3, 3)
        elif key.lower() == "pbc":
            pbc = np.asarray([v.upper().startswith("T") for v in value.split()])
    return cell, pbc


def read_xyz(
    path,
    detect_padding: bool = True,
    pad_species_value: int = 100,
    return_comments: bool = False,
):
    """Read a (multi-conformer) xyz file.

    Returns ``(species (C, A), coordinates (C, A, 3), cell | None, pbc |
    None)`` (plus the comment lines if ``return_comments``).  Conformers with
    fewer atoms are padded with species -1 / coordinates 0; with
    ``detect_padding`` so are atoms of element ``pad_species_value``.
    """
    frames: tp.List[tp.Dict[str, np.ndarray]] = []
    comments: tp.List[str] = []
    cell = None
    pbc = None
    with open(Path(path), "rt", encoding="utf-8") as f:
        lines = f.read().splitlines()
    i = 0
    while i < len(lines):
        line = lines[i].strip()
        if not line:
            i += 1
            continue
        try:
            natoms = int(line)
        except ValueError as e:
            raise TorchaniIOError(f"Expected an atom count at line {i + 1} of {path}") from e
        comment = lines[i + 1] if i + 1 < len(lines) else ""
        comments.append(comment)
        frame_cell, frame_pbc = _parse_comment(comment)
        if frame_cell is not None:
            if cell is not None and not np.allclose(cell, frame_cell):
                raise TorchaniIOError("Multiple distinct cells are not supported")
            cell = frame_cell
        if frame_pbc is not None:
            pbc = frame_pbc
        znums = np.empty(natoms, dtype=np.int64)
        coords = np.empty((natoms, 3), dtype=np.float32)
        for j in range(natoms):
            parts = lines[i + 2 + j].split()
            label = parts[0]
            znums[j] = int(label) if label.isdigit() else ATOMIC_NUMBER[label]
            coords[j] = [float(parts[1]), float(parts[2]), float(parts[3])]
        if detect_padding:
            padmask = znums == pad_species_value
            znums[padmask] = -1
            coords[padmask] = 0.0
        frames.append({"species": znums[None], "coordinates": coords[None]})
        i += 2 + natoms
    merged = pad_atomic_properties(frames)
    out = (merged["species"], merged["coordinates"], cell, pbc)
    if return_comments:
        return out + (comments,)
    return out


def read_pdb(
    path,
) -> tp.Tuple[np.ndarray, np.ndarray, tp.Optional[np.ndarray]]:
    """Read a PDB file's atoms: ``(species (A,), coords (A, 3), cell | None)``.

    A dependency-free column parser of ``ATOM``/``HETATM`` records (element
    from columns 77-78, else from the atom-name field) and an orthorhombic
    ``CRYST1`` cell.  Species are atomic numbers.
    """
    znums: tp.List[int] = []
    coords: tp.List[tp.Tuple[float, float, float]] = []
    cell = None
    with open(Path(path), "rt", encoding="utf-8") as f:
        for line in f:
            rec = line[:6]
            if rec == "CRYST1":
                a, b, c = float(line[6:15]), float(line[15:24]), float(line[24:33])
                alpha, beta, gamma = float(line[33:40]), float(line[40:47]), float(line[47:54])
                if not (alpha == beta == gamma == 90.0):
                    raise TorchaniIOError("Only orthorhombic PDB cells are supported")
                cell = np.diag([a, b, c]).astype(np.float32)
            elif rec.startswith(("ATOM", "HETATM")):
                elem = line[76:78].strip()
                if not elem:
                    # the atom-name column (13-16): its first two letters
                    # where they name an element ("CL1" -> Cl, " CA " ->
                    # Ca), else its first ("HD21" -> H)
                    name = line[12:16].strip()
                    elem = name[:2].capitalize()
                    if elem not in ATOMIC_NUMBER:
                        elem = name[0].upper()
                else:
                    elem = elem.capitalize()
                if elem not in ATOMIC_NUMBER:
                    raise TorchaniIOError(f"Unknown element {elem!r} in {path}")
                znums.append(ATOMIC_NUMBER[elem])
                coords.append((float(line[30:38]), float(line[38:46]), float(line[46:54])))
    if not znums:
        raise TorchaniIOError(f"No ATOM/HETATM records in {path}")
    return (
        np.asarray(znums, dtype=np.int64),
        np.asarray(coords, dtype=np.float32),
        cell,
    )
