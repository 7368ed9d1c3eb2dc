"""Build and load the hand-written CUDA kernels and the native xyz parser.

Each ``*.cu`` file in this directory is one kernel library with a plain C
interface.  It is compiled by ``nvcc`` for ``sm_90a`` into a shared library
and loaded with ``ctypes``.  Libraries are named by a hash of their source
and flags, so an edited source is rebuilt and an unchanged one is reused.
Nothing here runs at import: the first CUDA call of a kernel builds it.

``xyzparse.cpp`` is host C++ (the counterpart of the JAX package's
``csrc``): `load_xyzparse` builds it with ``g++`` at its first call into the
same directory and returns None where it cannot be built or loaded, and
`io.read_xyz` then reads through Python.  ``XYZPARSE_IS_AVAILABLE`` is
resolved at each access.  ``TORCHANI_TPU_TORCH_DISABLE_EXTENSIONS=1``
switches the parser off (never a CUDA kernel).
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import typing as tp
from pathlib import Path

from torchani_tpu_torch.paths import csrc_dir, kernel_build_dir

__all__ = [
    "NVCC_FLAGS", "XYZPARSE_IS_AVAILABLE", "build", "load_library", "load_xyzparse", "sources",
]

#: Hopper target, full-precision math (no --use_fast_math), plain C ABI
NVCC_FLAGS: tp.Tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
#: the xyz parser's host build (the JAX package's flags)
GXX_FLAGS: tp.Tuple[str, ...] = ("-O2", "-shared", "-fPIC")


def sources() -> tp.Dict[str, Path]:
    """Kernel sources by library name (the file stem)."""
    return {p.stem: p for p in sorted(csrc_dir().glob("*.cu"))}


def _nvcc() -> str:
    cuda_home = os.getenv("CUDA_HOME") or os.getenv("CUDA_PATH") or "/usr/local/cuda"
    for cand in (str(Path(cuda_home) / "bin" / "nvcc"), shutil.which("nvcc")):
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _library_path(src: Path, flags: tp.Sequence[str] = NVCC_FLAGS) -> Path:
    digest = hashlib.sha1(src.read_bytes() + " ".join(flags).encode())
    return kernel_build_dir() / f"lib{src.stem}_{digest.hexdigest()[:16]}.so"


def build(names: tp.Optional[tp.Sequence[str]] = None) -> tp.Dict[str, str]:
    """Compile the named kernel libraries (all by default) that have no
    current build, one ``nvcc`` process per source, all started together.

    Returns the compiler output (``-Xptxas=-v`` register and spill report)
    of each library built now; raises if any compile fails.
    """
    srcs = sources()
    names = list(srcs) if names is None else list(names)
    kernel_build_dir().mkdir(parents=True, exist_ok=True)
    running = []
    for name in names:
        src = srcs[name]
        out = _library_path(src)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        running.append((name, proc, tmp, out))
    logs: tp.Dict[str, str] = {}
    failed = []
    for name, proc, tmp, out in running:
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return logs


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load one kernel library."""
    build([name])
    return ctypes.CDLL(str(_library_path(sources()[name])))


@functools.lru_cache(maxsize=None)
def _xyzparse() -> tp.Optional[ctypes.CDLL]:
    src = csrc_dir() / "xyzparse.cpp"
    out = _library_path(src, GXX_FLAGS)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    try:
        if not out.exists():
            out.parent.mkdir(parents=True, exist_ok=True)
            subprocess.run(
                ["g++", *GXX_FLAGS, "-o", str(tmp), str(src)],
                check=True, capture_output=True, timeout=120,
            )
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return None
    lib.parse_xyz.restype = ctypes.c_long
    lib.parse_xyz.argtypes = [
        ctypes.c_char_p,
        ctypes.c_long,
        ctypes.c_long,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_long,
    ]
    return lib


def load_xyzparse() -> tp.Optional[ctypes.CDLL]:
    """Load (building if needed) the native xyz parser; None if it is
    switched off or cannot be built or loaded."""
    if os.getenv("TORCHANI_TPU_TORCH_DISABLE_EXTENSIONS") == "1":
        return None
    return _xyzparse()


def __getattr__(name: str) -> tp.Any:
    if name == "XYZPARSE_IS_AVAILABLE":
        return load_xyzparse() is not None
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
