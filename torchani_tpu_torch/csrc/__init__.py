"""Build and load the hand-written CUDA kernels.

Each ``*.cu`` file in this directory is one kernel library with a plain C
interface.  It is compiled by ``nvcc`` for ``sm_90a`` into a shared library
and loaded with ``ctypes``.  Libraries are named by a hash of their source
and flags, so an edited source is rebuilt and an unchanged one is reused.
Nothing here runs at import: the first CUDA call of a kernel builds it.
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

__all__ = ["NVCC_FLAGS", "build", "load_library", "sources"]

#: Hopper target, full-precision math (no --use_fast_math), plain C ABI
NVCC_FLAGS: tp.Tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)


def sources() -> tp.Dict[str, Path]:
    """Kernel sources by library name (the file stem)."""
    return {p.stem: p for p in sorted(csrc_dir().glob("*.cu"))}


def _nvcc() -> str:
    cuda_home = os.getenv("CUDA_HOME") or os.getenv("CUDA_PATH") or "/usr/local/cuda"
    for cand in (str(Path(cuda_home) / "bin" / "nvcc"), shutil.which("nvcc")):
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _library_path(src: Path) -> Path:
    digest = hashlib.sha1(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
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
