"""The output check at a CPU test's size: a sound run comes out correct,
and a run with the timed path broken underneath comes out not correct, for
each fault the cell can have (the harness's look for a chip skipped)."""

import time

import pytest
import torch

from benchmark import harness
from conftest import TINY


def correct(workload: str, device) -> dict:
    result, _ = harness.run(workload, 2**35 + 11, 0.2, False, device, 1, time.perf_counter(),
                            traffic_overrides=TINY[workload])
    return result


@pytest.mark.parametrize("workload", sorted(TINY))
def test_sound_run_is_correct(workload, cpu):
    result = correct(workload, cpu)
    assert result["correct"], result["checks"]


def test_md_state_returned_unchanged(monkeypatch, cpu):
    from torchani_tpu_torch.md import MolecularDynamics

    monkeypatch.setattr(MolecularDynamics, "run_nve", lambda self, state, n: state)
    assert not correct("ani2x-md-water59k", cpu)["correct"]


def test_md_answer_altered(monkeypatch, cpu):
    from torchani_tpu_torch.md import MolecularDynamics

    run_nve = MolecularDynamics.run_nve

    def altered(self, state, n):
        out = run_nve(self, state, n)
        return out.replace(coords=out.coords.index_add(
            0, torch.tensor([0]), torch.tensor([[0.05, 0.0, 0.0]])))

    monkeypatch.setattr(MolecularDynamics, "run_nve", altered)
    assert not correct("ani2x-md-water59k", cpu)["correct"]


def test_ef_half_batch_left_out(monkeypatch, cpu):
    import torchani_tpu_torch.grad as grad

    energies_and_forces = grad.energies_and_forces

    def half(model, species, coords, *args, **kwargs):
        n = species.shape[0] // 2
        e, f = energies_and_forces(model, species[:n], coords[:n], *args, **kwargs)
        return (torch.cat([e, e.mean().expand(species.shape[0] - n)]),
                torch.cat([f, torch.zeros_like(f)[: species.shape[0] - n]]))

    monkeypatch.setattr(grad, "energies_and_forces", half)
    assert not correct("ani2x-ef-comp6", cpu)["correct"]


def test_ef_answer_altered(monkeypatch, cpu):
    import torchani_tpu_torch.grad as grad

    energies_and_forces = grad.energies_and_forces

    def altered(*args, **kwargs):
        e, f = energies_and_forces(*args, **kwargs)
        return e, f.index_add(0, torch.tensor([0]), torch.full((1,) + f.shape[1:], 0.01))

    monkeypatch.setattr(grad, "energies_and_forces", altered)
    assert not correct("ani2x-ef-comp6", cpu)["correct"]


def test_training_state_returned_unchanged(monkeypatch, cpu):
    import torchani_tpu_torch.training as training

    make_train_step = training.make_train_step

    def frozen(*args, **kwargs):
        init_fn, step_fn = make_train_step(*args, **kwargs)
        return init_fn, lambda state, batch: (state, {"loss": torch.tensor(1.0)})

    monkeypatch.setattr(training, "make_train_step", frozen)
    assert not correct("ani2x-train-force", cpu)["correct"]


def test_training_half_batch_left_out(monkeypatch, cpu):
    import torchani_tpu_torch.training.loop as loop

    energy_force_loss = loop.energy_force_loss

    def half(model, species, coords, energies, forces=None, **kwargs):
        n = species.shape[0] // 2
        return energy_force_loss(model, species[:n], coords[:n], energies[:n],
                                 None if forces is None else forces[:n], **kwargs)

    monkeypatch.setattr(loop, "energy_force_loss", half)
    assert not correct("ani2x-train-force", cpu)["correct"]


def test_verdict():
    within = {"force_gap": {"value": 1e-6, "limit": 2e-6}}
    assert harness.verdict(3, 0, within)
    assert not harness.verdict(0, 0, within)
    assert not harness.verdict(3, 1, within)
    assert not harness.verdict(3, 0, {})
    assert not harness.verdict(3, 0, {"force_gap": {"value": float("nan"), "limit": 2e-6}})
    assert not harness.verdict(3, 0, {"force_gap": {"value": 1e-6, "limit": None}})
    assert not harness.verdict(3, 0, dict(within, loss_gap={"value": 3e-5, "limit": 1e-5}))
