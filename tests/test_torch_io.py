"""PyTorch port: `io` (xyz, pdb), the native xyz parser (`csrc`) and the
padding helpers of `utils` against the JAX package's, on the CPU.

`write_xyz` writes the JAX package's bytes; `read_xyz` returns the JAX
package's arrays on files written by either package (padded conformers, the
on-disk padding marker, a cell with pbc, comments), on each of its two
routes: the native parser (the default where ``g++`` builds it; cell and pbc
from the second line) and the Python one (``return_comments=True``, or the
port's ``TORCHANI_TPU_TORCH_DISABLE_EXTENSIONS=1`` against JAX with
``_native_read_xyz`` returning None; every comment line read).  Files whose
cells or pbc differ between frames are where the routes part.  `parse_xyz`'s
raw outputs equal those of the JAX package's library on the same bytes.
`read_pdb` reads a small synthetic PDB as the JAX package does;
`pad_atomic_properties` and `strip_redundant_padding` give the JAX
package's arrays.

The JAX package's parser reaches these tests only as `jax_parser` hands
it to JAX's loader: built from its source into each test process's own
temporary directory.  Nothing here imports `torchani_tpu.csrc` while the
module is collected, and nothing builds in the JAX package's directory,
whose loader writes ``xyzparse.so`` in place: under ``-n 6`` the workers
that each imported it while collecting raced on that one path, and one
worker's loader gave None.  `test_parsers_load_whole_in_processes_at_once`
holds both parsers' loading in four processes started together.
"""

import ctypes
import importlib
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from torchani_tpu import io as jio
from torchani_tpu import utils as jutils
from torchani_tpu_torch import csrc, io, utils

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None, reason="no g++ to build the parser")

#: the JAX package's parser source, which the tests build for themselves
JAX_PARSER_SRC = Path(jio.__file__).resolve().parent / "csrc" / "xyzparse.cpp"


def jax_csrc_module():
    """The JAX package's `torchani_tpu.csrc`, imported without the build that
    its import runs where ``xyzparse.so`` is missing or stale.  That build
    writes ``g++``'s output straight onto ``xyzparse.so`` in the JAX
    package's directory, with no temporary file and no lock: processes that
    import the module at once (test workers collecting the same files) write
    that one path while others load it.  So the import here runs with the
    module's switch ``TORCHANI_TPU_DISABLE_EXTENSIONS=1`` on; then the
    switch is set back to what the environment says and the loader left
    untried, as after a fresh import (``XYZPARSE_IS_AVAILABLE`` stays
    False).  A module that this process imported before is returned as it
    is."""
    name = "torchani_tpu.csrc"
    if name not in sys.modules:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("TORCHANI_TPU_DISABLE_EXTENSIONS", "1")
            module = importlib.import_module(name)
        module._DISABLED = os.getenv("TORCHANI_TPU_DISABLE_EXTENSIONS") == "1"
        module._TRIED, module._LIB = False, None
    return sys.modules[name]


def build_jax_parser(directory: Path):
    """The JAX package's parser built from its source (read only) into
    ``directory``: ``g++`` with its loader's flags onto a temporary name,
    then `os.replace`; loaded with its loader's argument types.  None where
    it cannot be built or loaded, as its loader degrades."""
    out = Path(directory) / "xyzparse.so"
    tmp = out.with_name(f"xyzparse.{os.getpid()}.tmp.so")
    try:
        subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-o", str(tmp), str(JAX_PARSER_SRC)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return None
    lib.parse_xyz.restype = ctypes.c_long
    lib.parse_xyz.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_long, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float), ctypes.c_long,
    ]
    return lib


@pytest.fixture(scope="session")
def jax_parser_lib(tmp_path_factory):
    """The JAX package's parser, built once in each test process into that
    process's own temporary directory."""
    return build_jax_parser(tmp_path_factory.mktemp("jax_xyzparse"))


@pytest.fixture(autouse=True)
def jax_parser(jax_parser_lib, monkeypatch):
    """JAX's loader (`torchani_tpu.csrc.load_xyzparse`) hands out
    `jax_parser_lib` during each test here, so that `jio.read_xyz` takes its
    native route with a library known to be whole and nothing builds in the
    JAX package's directory."""
    module = jax_csrc_module()
    monkeypatch.setattr(module, "_LIB", jax_parser_lib)
    monkeypatch.setattr(module, "_TRIED", True)
    return jax_parser_lib

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
    for package in (io, jio):  # the Python route raises in both packages
        with pytest.raises(package.TorchaniIOError, match="distinct cells"):
            package.read_xyz(two, return_comments=True)
    if csrc.XYZPARSE_IS_AVAILABLE:  # the native route takes the first cell, as JAX's
        np.testing.assert_array_equal(io.read_xyz(two)[2], np.eye(3, dtype=np.float32))
        np.testing.assert_array_equal(io.read_xyz(two)[2], jio.read_xyz(two)[2])
    with pytest.raises(ValueError, match="Can't pad"):
        io.write_xyz(np.array([[100, 1]]), np.zeros((1, 2, 3)), tmp_path / "x.xyz", pad=True)


#: files where the native and the Python route differ (cell and pbc), and
#: files where they agree (padding, ragged frames, numeric labels, a heavy
#: element, extra columns, blank lines)
LATTICE1, LATTICE2 = 'Lattice="1 0 0 0 1 0 0 0 1"', 'Lattice="2 0 0 0 2.5 0 0 0.5 3"'
XYZ_FILES = {
    "distinct_cells": f"1\n{LATTICE1}\nH 0 0 0\n1\n{LATTICE2}\nH 0 0 0\n",
    "second_frame_cell": f'1\ncomment\nH 0 0 0\n1\n{LATTICE2} pbc="T T T"\nH 0 0 1\n',
    "changing_pbc": (f'2\n{LATTICE2} pbc="T T T"\nO 0 0 0\nH 0 0 1\n'
                     f'2\n{LATTICE2} pbc="F F F"\nO 0 0 0\nH 0 1 0\n'),
    "padded": "3\nx\nO 0 0 0\nH 0 0 0.96\n100 0 0 0\n3\nx\nC 1 2 3\nH 1 2 4.09\nH 0.5 2 3\n",
    "ragged": "1\n\nH -1.5 2.25e-3 7\n4\nc\nN 0 0 0\nH 0 0 1\nH 0 1 0\nH 1 0 0\n",
    "numeric_labels": "2\npbc=\"T F T\"\n8 0.1 0.2 0.3\n1 1.1 1.2 1.3\n",
    "heavy_element": "3\n\nCl 0 0 0\nBr 2.1 0 0\nFe 0 2.2 0.123456789\n",
    "extra_columns": "2\nProperties=species:S:1:pos:R:3:forces:R:3\nO 0 0 0 0.1 0.2 0.3\nH 0 0 1 1 2 3\n",
    "blank_lines": "\n1\ncomment\nH 0 0 0\n\n\n1\ncomment\nO 1 1 1\n",
    # a frame over the JAX route's first cap of 1024 atoms
    "large_frame": ("2\nx\nO 0 0 0\nH 0 0 1\n1500\nbig\n"
                    + "".join(f"C {i} {i % 7} -{i % 3}.5\n" for i in range(1500))
                    + "3\nx\nN 0 0 0\nH 1 0 0\nH 0 1 0\n"),
    # coordinates that run onto the next line: the parser reads on (strtod
    # skips newlines), so its frames are not those of the count lines
    "wrapped_frames": "1\nc\nH 0 0\n0\n1\nc\nH 1 1 1\n",
    "wrapped_count": "1\nc\nH 0 0\n1\n2\nc\nH 0 0 0\nH 1 1 1\n",
    # a count over the lines that follow it
    "overlong_count": "1\nc\nH 0 0 0\n9999\nc\nH 0 0 0\n",
}
#: the Python route's error on two distinct cells (both packages)
DISTINCT = "distinct_cells"
#: bytes that both parsers refuse at the 17th byte (a coordinate that is no number)
MALFORMED = b"2\nc\nO 0 0 0\nH 0 zero 1\n"


def _read_all(reader, path, **kw):
    try:
        return reader(path, **kw)[:4]
    except Exception as e:  # the same error class and message in both packages
        return type(e).__name__, str(e)


def _assert_same_read(ours, theirs):
    if isinstance(theirs[0], str):
        assert ours == theirs
        return
    for a, b in zip(ours[:2], theirs[:2]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ours[2:], theirs[2:]):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@needs_gxx
@pytest.mark.parametrize("route", ["default", "comments", "switched_off"])
@pytest.mark.parametrize("name", sorted(XYZ_FILES))
def test_read_xyz_routes_match_jax(tmp_path, monkeypatch, name, route):
    """Each file through the same route in both packages: the native one by
    default, the Python one with ``return_comments`` or with the native
    parser switched off (the port's environment switch; JAX's
    `_native_read_xyz` returning None)."""
    path = tmp_path / f"{name}.xyz"
    path.write_text(XYZ_FILES[name])
    kw = {"return_comments": True} if route == "comments" else {}
    if route == "switched_off":
        monkeypatch.setenv("TORCHANI_TPU_TORCH_DISABLE_EXTENSIONS", "1")
        monkeypatch.setattr(jio, "_native_read_xyz", lambda *a, **k: None)
        assert csrc.load_xyzparse() is None and not csrc.XYZPARSE_IS_AVAILABLE
    else:
        assert csrc.XYZPARSE_IS_AVAILABLE
    ours, theirs = _read_all(io.read_xyz, path, **kw), _read_all(jio.read_xyz, path, **kw)
    _assert_same_read(ours, theirs)
    if route != "default" and name == DISTINCT:
        assert ours[0] == "TorchaniIOError" and "distinct cells" in ours[1]


@needs_gxx
def test_native_and_python_routes_part_on_cells_and_pbc(tmp_path):
    """The three files where the routes part, with the values each route
    gives: the native route reads the second line only."""
    cell2 = np.array([[2, 0, 0], [0, 2.5, 0], [0, 0.5, 3]], np.float32)
    got = {}
    for name in ("distinct_cells", "second_frame_cell", "changing_pbc"):
        path = tmp_path / f"{name}.xyz"
        path.write_text(XYZ_FILES[name])
        got[name] = io.read_xyz(path), _read_all(io.read_xyz, path, return_comments=True)
    (native, python) = got["distinct_cells"]
    np.testing.assert_array_equal(native[2], np.eye(3, dtype=np.float32))
    assert native[3] is None and python[0] == "TorchaniIOError"
    native, python = got["second_frame_cell"]
    assert native[2] is None and native[3] is None
    np.testing.assert_array_equal(python[2], cell2)
    assert python[3].tolist() == [True] * 3
    native, python = got["changing_pbc"]
    assert native[3].tolist() == [True] * 3 and python[3].tolist() == [False] * 3
    np.testing.assert_array_equal(native[2], python[2])


@needs_gxx
def test_native_route_taken_exactly_where_jax_takes_it(tmp_path, monkeypatch):
    """`read_xyz` calls the native reader without ``return_comments`` and
    returns its result; with ``return_comments``, or where the reader
    returns None (no library, a failed parse, no frame), the Python route
    reads the file."""
    path = tmp_path / "mols.xyz"
    io.write_xyz(SPECIES, COORDS, path, cell=CELL)
    calls = []
    real = io._native_read_xyz

    def spy(*args):
        calls.append(args)
        return real(*args)

    monkeypatch.setattr(io, "_native_read_xyz", spy)
    native = io.read_xyz(path, detect_padding=False, pad_species_value=7)
    assert calls == [(path, False, 7)]
    io.read_xyz(path, return_comments=True)
    assert len(calls) == 1
    _assert_same_read(native, real(path, False, 7))
    monkeypatch.setattr(io, "_native_read_xyz", lambda *a: None)
    _assert_same_read(io.read_xyz(path), io.read_xyz(path, return_comments=True))
    bad = tmp_path / "bad_symbol.xyz"  # the parser refuses a 4-letter label
    bad.write_text("1\nc\nXxxx 0 0 0\n")
    assert real(bad, True, 100) is None
    empty = tmp_path / "empty.xyz"
    empty.write_text("\n\n")
    assert real(empty, True, 100) is None
    assert _read_all(io.read_xyz, empty) == _read_all(jio.read_xyz, empty)


@needs_gxx
@pytest.mark.parametrize("name", ["large_frame", "trajectory"])
def test_native_buffers_sized_from_the_frames(tmp_path, monkeypatch, name):
    """The native route's buffers hold (frames + 1) x largest frame, not
    JAX's (lines / 3 + 1) x cap, and it reads what JAX's native route
    reads: a frame over 1,024 atoms, and a trajectory of 1,100-atom frames
    (JAX's route asks for 1,468 x 8,192 atoms of buffers here)."""
    path = tmp_path / f"{name}.xyz"
    if name == "trajectory":
        rng = np.random.RandomState(3)
        species = rng.choice([1, 6, 8], size=(4, 1100))
        io.write_xyz(species, rng.randn(4, 1100, 3).astype(np.float32) * 9, path, cell=CELL)
    else:
        path.write_text(XYZ_FILES[name])
    theirs = jio.read_xyz(path)
    sizes = []
    zeros = np.zeros

    def spy(shape, *args, **kwargs):
        sizes.append(int(np.prod(shape)))
        return zeros(shape, *args, **kwargs)

    monkeypatch.setattr(io.np, "zeros", spy)
    ours = io.read_xyz(path)
    monkeypatch.setattr(io.np, "zeros", zeros)
    _assert_same_read(ours, theirs)
    frames, a_max = ours[0].shape
    assert a_max > 1024
    assert 0 < max(sizes) <= (frames + 1) * a_max * 3


def _parse(lib, raw: bytes, max_frames: int, cap: int):
    counts = np.zeros(max_frames, np.int32)
    znums = np.zeros(max_frames * cap, np.int32)
    coords = np.zeros(max_frames * cap * 3, np.float32)
    nf = lib.parse_xyz(
        raw, len(raw), max_frames,
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        znums.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        coords.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        cap,
    )
    return nf, counts, znums, coords


@needs_gxx
@pytest.mark.parametrize("cap", [2, 1024])
@pytest.mark.parametrize("name", sorted(XYZ_FILES) + ["written", "malformed"])
def test_parse_xyz_raw_outputs_match_jax(tmp_path, jax_parser, name, cap):
    """`parse_xyz` of both libraries on the same bytes: the return value
    (frames, or the negative offset of an error: a frame over the cap, an
    unknown label), counts, atomic numbers and f32 coordinates."""
    if name == "written":
        io.write_xyz(SPECIES, COORDS, tmp_path / "w.xyz", cell=CELL, pad=True)
        raw = (tmp_path / "w.xyz").read_bytes()
    elif name == "malformed":
        raw = MALFORMED
    else:
        raw = XYZ_FILES[name].encode()
    lib, jlib = csrc.load_xyzparse(), jax_parser
    assert lib is not None and jlib is not None
    max_frames = max(1, raw.count(b"\n") // 3 + 1)
    ours, theirs = _parse(lib, raw, max_frames, cap), _parse(jlib, raw, max_frames, cap)
    assert ours[0] == theirs[0]
    for a, b in zip(ours[1:], theirs[1:]):
        np.testing.assert_array_equal(a, b)
    if cap == 1024:
        assert (ours[0] < 0) == (name in ("malformed", "large_frame", "overlong_count"))


#: one process of `test_parsers_load_whole_in_processes_at_once`: once
#: every process has imported (a file each in the shared directory), the
#: port's parser from the shared build directory in its environment, and
#: the JAX package's as `jax_parser` gives it, built into the process's own
#: directory (argv: the tests' directory, that directory, the output file,
#: the processes)
_LOADER_PROCESS = """
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, sys.argv[1])
import test_torch_io as t

own = Path(sys.argv[2])
(own.parent / (own.name + ".ready")).touch()
deadline = time.monotonic() + 60
while len(list(own.parent.glob("*.ready"))) < int(sys.argv[4]) and time.monotonic() < deadline:
    time.sleep(0.01)
module = t.jax_csrc_module()
module._LIB, module._TRIED = t.build_jax_parser(own), True
out = {}
for name, lib in (("port", t.csrc.load_xyzparse()), ("jax", module.load_xyzparse())):
    out[name + "_malformed"] = np.asarray(t._parse(lib, t.MALFORMED, 2, 1024)[0])
    for i, a in enumerate(t._parse(lib, *t._RACE_PARSE)):
        out[f"{name}_raw{i}"] = np.asarray(a)
path = own / "frames.xyz"
path.write_text(t.XYZ_FILES[t.RACE_FILE])
for name, reader in (("port", t.io.read_xyz), ("jax", t.jio.read_xyz)):
    for i, a in enumerate(reader(path)):
        out[f"{name}_read{i}"] = np.asarray(a)
np.savez(sys.argv[3], **out)
"""
#: the file those processes parse (a frame over JAX's first cap), and its
#: raw parse's arguments (the bytes, frames, a cap over its largest frame)
RACE_FILE = "large_frame"
_RACE_PARSE = (XYZ_FILES[RACE_FILE].encode(), XYZ_FILES[RACE_FILE].count("\n") // 3 + 1, 2048)


@needs_gxx
def test_parsers_load_whole_in_processes_at_once(tmp_path, jax_parser):
    """Four processes, each loading at the same moment the port's parser from
    one empty build directory (each builds it, onto its own temporary name)
    and the JAX package's the way `jax_parser` does: every process gets two
    whole libraries, which refuse `MALFORMED` at its 17th byte and parse
    `RACE_FILE` as this process's JAX library does, and reads it to JAX's
    arrays on both packages' native routes.  No process builds or rewrites
    ``xyzparse.so`` in the JAX package's directory."""
    jax_so = JAX_PARSER_SRC.with_suffix(".so")
    before = jax_so.stat() if jax_so.exists() else None
    env = {**os.environ, "TORCHANI_TPU_TORCH_BUILD_DIR": str(tmp_path / "build")}
    runs, processes = [], 4
    for i in range(processes):
        own = tmp_path / f"process{i}"
        own.mkdir()
        runs.append((own / "out.npz", subprocess.Popen(
            [sys.executable, "-c", _LOADER_PROCESS, str(Path(__file__).parent), str(own),
             str(own / "out.npz"), str(processes)],
            cwd=Path(__file__).resolve().parent.parent, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE)))
    errors = []
    for _, proc in runs:
        try:
            errors.append(proc.communicate(timeout=120)[1].decode()[-3000:])
        except subprocess.TimeoutExpired:
            proc.kill()
            errors.append(proc.communicate()[1].decode()[-3000:] + "\n(killed after 120 s)")
    assert all(proc.returncode == 0 for _, proc in runs), "\n".join(errors)
    assert len(list((tmp_path / "build").glob("libxyzparse_*.so"))) == 1
    assert not list((tmp_path / "build").glob("*.tmp.so"))
    path = tmp_path / "frames.xyz"
    path.write_text(XYZ_FILES[RACE_FILE])
    raw = _parse(jax_parser, *_RACE_PARSE)
    read = jio.read_xyz(path)
    assert raw[0] == 3 and read[0].shape == (3, 1500)
    for out, _ in runs:
        with np.load(out) as got:
            for name in ("port", "jax"):
                assert int(got[name + "_malformed"]) == -17
                for i, want in enumerate(raw):
                    np.testing.assert_array_equal(got[f"{name}_raw{i}"], want)
                for i, want in enumerate(read[:2]):
                    assert got[f"{name}_read{i}"].dtype == want.dtype
                    np.testing.assert_array_equal(got[f"{name}_read{i}"], want)
    after = jax_so.stat() if jax_so.exists() else None
    assert (before is None) == (after is None)
    if before is not None:
        assert (after.st_ino, after.st_mtime_ns) == (before.st_ino, before.st_mtime_ns)


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
