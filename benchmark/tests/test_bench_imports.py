"""Nothing under ``benchmark/`` imports JAX or the JAX package, and the plain
reference imports nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "torchani_tpu"}


def imported(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


@pytest.mark.parametrize("path", sorted(BENCH_DIR.rglob("*.py")), ids=lambda p: p.name)
def test_no_jax(path):
    assert not {m.split(".")[0] for m in imported(path)} & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH_DIR / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not any(m.split(".")[0] == "torchani_tpu_torch" for m in imported(path))


def test_a_run_loads_no_jax():
    """A CPU run of a tiny cell, in a process of its own, ends with no
    forbidden top-level module loaded."""
    code = (
        "import time, torch\n"
        "from benchmark import harness\n"
        "res, _ = harness.run('ani2x-ef-comp6', 3, 0.1, False, torch.device('cpu'), 1,\n"
        "    time.perf_counter(), traffic_overrides=dict(batch=8, pool=1, check_batches=1,\n"
        "    reference_chunk=8))\n"
        "assert res['attempted'] > 0\n"
        "print(harness.forbidden_modules())\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=BENCH_DIR.parent, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
