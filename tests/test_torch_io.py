"""PyTorch port: `io` (xyz, pdb) and the padding helpers of `utils` against
the JAX package's, on the CPU.

`write_xyz` writes the JAX package's bytes; `read_xyz` returns the JAX
package's arrays on files written by either package (padded conformers, the
on-disk padding marker, a cell with pbc, comments); `read_pdb` reads a small
synthetic PDB as the JAX package does; `pad_atomic_properties` and
`strip_redundant_padding` give the JAX package's arrays.
"""

import numpy as np
import pytest

from torchani_tpu import io as jio
from torchani_tpu import utils as jutils
from torchani_tpu_torch import io, utils

SPECIES = np.array([[8, 1, 1, -1], [6, 1, 1, 8], [1, 1, -1, -1]])
COORDS = np.random.RandomState(0).randn(3, 4, 3).astype(np.float32)
COORDS[SPECIES < 0] = 0.0
CELL = np.array([[10.0, 0.0, 0.0], [1.5, 11.0, 0.0], [0.0, 0.25, 12.5]], np.float32)


def _write_kw():
    return [
        ("plain", {}),
        ("cell", {"cell": CELL}),
        ("pad", {"pad": True}),
        ("pad-cell", {"pad": True, "cell": CELL, "pad_coord_value": 1.5}),
    ]


@pytest.mark.parametrize("kw", [k for _, k in _write_kw()], ids=[n for n, _ in _write_kw()])
def test_write_xyz_bytes_match_jax(tmp_path, kw):
    io.write_xyz(SPECIES, COORDS, tmp_path / "port.xyz", **kw)
    jio.write_xyz(SPECIES, COORDS, tmp_path / "jax.xyz", **kw)
    assert (tmp_path / "port.xyz").read_bytes() == (tmp_path / "jax.xyz").read_bytes()


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("kw", [k for _, k in _write_kw()], ids=[n for n, _ in _write_kw()])
def test_read_xyz_matches_jax(tmp_path, writer, kw):
    path = tmp_path / "mols.xyz"
    (io if writer == "port" else jio).write_xyz(SPECIES, COORDS, path, **kw)
    for detect in (True, False):
        ours = io.read_xyz(path, detect_padding=detect)
        theirs = jio.read_xyz(path, detect_padding=detect)
        for a, b in zip(ours[:2], theirs[:2]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        for a, b in zip(ours[2:], theirs[2:]):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
    sp, co, cell, pbc, comments = io.read_xyz(path, return_comments=True)
    assert comments == jio.read_xyz(path, return_comments=True)[4] and len(comments) == 3
    np.testing.assert_array_equal(sp, SPECIES)
    np.testing.assert_allclose(co, COORDS, atol=1e-9)
    if "cell" in kw:
        np.testing.assert_allclose(cell, CELL, rtol=1e-7)
        assert pbc.tolist() == [True] * 3


def test_read_xyz_padding_marker_and_errors(tmp_path):
    path = tmp_path / "marked.xyz"
    path.write_text(
        "3\ncomment\nO 0 0 0\nH 0 0 1\n100 5 5 5\n2\nLattice=\"1 0 0 0 1 0 0 0 1\"\nC 0 0 0\n6 1 0 0\n"
    )
    for detect in (True, False):
        ours, theirs = io.read_xyz(path, detect_padding=detect), jio.read_xyz(path, detect_padding=detect)
        np.testing.assert_array_equal(ours[0], theirs[0])
        np.testing.assert_array_equal(ours[1], theirs[1])
    assert io.read_xyz(path)[0].tolist() == [[8, 1, -1], [6, 6, -1]]
    bad = tmp_path / "bad.xyz"
    bad.write_text("x\ncomment\n")
    with pytest.raises(io.TorchaniIOError, match="atom count"):
        io.read_xyz(bad)
    two = tmp_path / "two_cells.xyz"
    two.write_text('1\nLattice="1 0 0 0 1 0 0 0 1"\nH 0 0 0\n1\nLattice="2 0 0 0 2 0 0 0 2"\nH 0 0 0\n')
    with pytest.raises(io.TorchaniIOError, match="distinct cells"):
        io.read_xyz(two)
    with pytest.raises(ValueError, match="Can't pad"):
        io.write_xyz(np.array([[100, 1]]), np.zeros((1, 2, 3)), tmp_path / "x.xyz", pad=True)


PDB = """\
CRYST1   20.000   21.000   22.000  90.00  90.00  90.00 P 1           1
ATOM      1  OW  HOH A   1       1.000   2.000   3.000  1.00  0.00           O
ATOM      2  HW1 HOH A   1       1.500   2.500   3.000  1.00  0.00           H
HETATM    3  CA  LIG A   2      -4.250  10.125   0.500  1.00  0.00
HETATM    4 CL1  LIG A   2       7.000   8.000   9.000  1.00  0.00
ATOM      5 HD21 ASN A   3       0.000   0.000   0.000  1.00  0.00
END
"""


def test_read_pdb_matches_jax(tmp_path):
    path = tmp_path / "small.pdb"
    path.write_text(PDB)
    ours, theirs = io.read_pdb(path), jio.read_pdb(path)
    np.testing.assert_array_equal(ours[0], theirs[0])
    np.testing.assert_array_equal(ours[1], theirs[1])
    np.testing.assert_array_equal(ours[2], theirs[2])
    assert ours[0].tolist() == [8, 1, 20, 17, 1]
    tri = tmp_path / "tri.pdb"
    tri.write_text(PDB.replace("90.00  90.00  90.00", "90.00  90.00 120.00"))
    with pytest.raises(io.TorchaniIOError, match="orthorhombic"):
        io.read_pdb(tri)
    empty = tmp_path / "empty.pdb"
    empty.write_text("END\n")
    with pytest.raises(io.TorchaniIOError, match="No ATOM"):
        io.read_pdb(empty)


def test_padding_helpers_match_jax():
    props = [
        {"species": np.array([[8, 1, 1]]), "coordinates": np.ones((1, 3, 3), np.float32),
         "energies": np.array([1.0])},
        {"species": np.array([[6, 1, 1, 1, 1], [6, 1, 1, 1, -1]]),
         "coordinates": np.full((2, 5, 3), 2.0, np.float32), "energies": np.array([2.0, 3.0])},
    ]
    ours, theirs = utils.pad_atomic_properties(props), jutils.pad_atomic_properties(props)
    assert set(ours) == set(theirs)
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype
        np.testing.assert_array_equal(ours[k], theirs[k])
    ours["species"][:, 4] = -1
    theirs = {k: v.copy() for k, v in ours.items()}
    stripped, jstripped = utils.strip_redundant_padding(ours), jutils.strip_redundant_padding(theirs)
    assert stripped["species"].shape == (3, 4)
    for k in stripped:
        np.testing.assert_array_equal(stripped[k], jstripped[k])
