"""Shared sizes of the benchmark's CPU tests: each cell's traffic cut to
what a test run holds (the benchmark runs them on an NVIDIA GPU at the
sizes in ``traffic/``)."""

import sys
from pathlib import Path

import pytest
import torch

# the checkout's root, so that `benchmark` imports however pytest is started
sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

#: traffic overrides that make each cell a CPU test's size
TINY = {
    "ani2x-md-water59k": dict(box_atoms=300, box_seed=0, stretch_steps=3, reference_block=128, trace_units=1),
    "ani2x-ef-comp6": dict(batch=16, pool=2, check_batches=1, reference_chunk=8, trace_units=2),
    "ani2x-train-force": dict(batch=16, pool=4, reference_chunk=8, trace_units=2),
}


@pytest.fixture
def cpu():
    torch.set_num_threads(4)
    return torch.device("cpu")
