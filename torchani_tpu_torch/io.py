"""Read and write molecules in ``.xyz`` (extxyz-compatible) and ``.pdb``
format (counterpart of ``torchani_tpu/io.py``).

Multi-conformer files, ``Lattice="..."`` cell parsing, and the padding
conventions: -1 element padding in arrays, atomic number 100 as the on-disk
padding marker.  Host-side, numpy in and out.  `read_xyz` parses through
the native C++ parser (`csrc.load_xyzparse`) where it is available, as the
JAX package's does, and through Python otherwise.
"""

import ctypes
import re
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


#: a header line's atom count (leading spaces, tabs and CRs, as the parser
#: skips them), and an integer at an offset where the parser stopped
_COUNT = re.compile(rb"[ \t\r]*([+-]?\d+)?")
_INT = re.compile(rb"\s*([+-]?\d+)")
#: the largest frame the JAX package's native route reads: its cap grows
#: 1024 -> 8192 -> ... while below 10,000,000
_CAP_LIMIT = 1024 * 8**5


def _frame_guess(raw: bytes) -> tp.Tuple[int, int]:
    """Frames and largest atom count of a file laid out as count line,
    comment line and one line an atom, read from its count lines alone: a
    guess, which the parse then confirms or corrects."""
    starts = np.flatnonzero(np.frombuffer(raw, np.uint8) == ord("\n")) + 1
    starts = np.concatenate(([0], starts))
    frames = cap = i = 0
    while i < len(starts):
        m = _COUNT.match(raw, int(starts[i]))
        if m.group(1) is None:
            if m.end() < len(raw) and raw[m.end()] != ord("\n"):
                break  # not a count line: the parse finds what it is
            i += 1  # a blank line, skipped as the parser skips it
            continue
        natoms = int(m.group(1))
        if natoms <= 0 or i + 2 + natoms > len(starts):
            break  # not a frame that the file's lines can hold
        frames, cap = frames + 1, max(cap, natoms)
        i += natoms + 2
    return max(frames, 1), max(cap, 1)


def _native_read_xyz(path, detect_padding: bool, pad_species_value: int):
    """`read_xyz` through the C++ parser; None where it is unavailable, the
    parse fails or finds no frame.

    The JAX package's native route, with its buffers sized from the file:
    frames and largest frame are guessed from the count lines
    (`_frame_guess`), and the parse confirms them.  It parses to the end
    of the text only if it stops below its frame bound, and a frame over
    the cap fails at that frame's count: a failed guess grows the frame
    bound twofold or the cap to that count, and parses again.  The parse
    that succeeds is the one JAX's route keeps, whose frame bound (lines
    / 3 + 1) and cap (1024 · 8^k up to `_CAP_LIMIT`) are upper bounds
    whose buffers take their product, whatever the file holds.

    Cell and pbc come from the file's second line alone (parsed in Python;
    the native parser skips comment lines), as on the JAX package's native
    route."""
    from torchani_tpu_torch.csrc import load_xyzparse

    lib = load_xyzparse()
    if lib is None:
        return None
    raw = Path(path).read_bytes()
    newlines = raw.count(b"\n")
    # JAX's frame bound: a frame takes at least three lines
    frame_bound = max(1, newlines // 3 + 1)
    frames, cap = _frame_guess(raw)
    while True:
        max_frames = min(frames + 1, frame_bound)
        counts = np.zeros(max_frames, dtype=np.int32)
        znums = np.zeros(max_frames * cap, dtype=np.int32)
        coords = np.zeros(max_frames * cap * 3, dtype=np.float32)
        nf = lib.parse_xyz(
            raw,
            len(raw),
            max_frames,
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            znums.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            coords.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            cap,
        )
        if nf >= 0:
            if nf < max_frames or max_frames == frame_bound:
                break
            frames *= 2  # more frames than guessed
            continue
        m = _INT.match(raw, -nf - 1)
        natoms = int(m.group(1)) if m else 0
        if natoms <= cap or natoms > min(_CAP_LIMIT, newlines + 1):
            return None  # a genuine parse failure (an atom takes a line): the Python route
        cap = natoms  # a frame larger than the cap
    if nf == 0:
        return None
    counts = counts[:nf]
    a_max = int(counts.max())
    species = np.full((nf, a_max), -1, dtype=np.int64)
    out_coords = np.zeros((nf, a_max, 3), dtype=np.float32)
    zn = znums.reshape(max_frames, cap)
    co = coords.reshape(max_frames, cap, 3)
    for i in range(nf):
        c = counts[i]
        species[i, :c] = zn[i, :c]
        out_coords[i, :c] = co[i, :c]
    if detect_padding:
        padmask = species == pad_species_value
        species[padmask] = -1
        out_coords[padmask] = 0.0
    # the text through its second newline holds the second line whole
    cut = raw.find(b"\n", raw.find(b"\n") + 1)
    text = raw[: cut + 1 if cut >= 0 else len(raw)].decode("utf-8", errors="replace").splitlines()
    cell = pbc = None
    if len(text) >= 2:
        try:
            cell, pbc = _parse_comment(text[1])
        except TorchaniIOError:
            cell = pbc = None
    return species, out_coords, cell, pbc


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

    Without ``return_comments`` the native parser reads the file where it
    is available (`_native_read_xyz`: cell and pbc from the second line
    only); the Python route below reads every comment line, takes the last
    pbc and raises on two distinct cells.  Both are the JAX package's.
    """
    if not return_comments:
        native = _native_read_xyz(path, detect_padding, pad_species_value)
        if native is not None:
            return native
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
