"""The control of each cell's output check, at a CPU test's size: the plain
reference in TF32 (rounded operands on the CPU) in the program's place must
fail at least one of the cell's limits; for the training cell so must half
of each batch left out and a state never updated."""

import pytest

from benchmark import control
from conftest import TINY


@pytest.mark.parametrize("workload", sorted(TINY))
def test_tf32_control_fails(workload, cpu):
    assert not control.readings(workload, 5, "tf32", cpu, TINY[workload])["correct"]


@pytest.mark.parametrize("variant", ["half_batch", "unchanged"])
def test_training_faults_fail(variant, cpu):
    workload = "ani2x-train-force"
    assert not control.readings(workload, 5, variant, cpu, TINY[workload])["correct"]
