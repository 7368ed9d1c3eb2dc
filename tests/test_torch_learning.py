"""PyTorch port: ``tests/test_learning.py``'s two tests on the port, on the
CPU: a student trained with `EpochRunner` and AdamW on teacher-labelled
conformers lowers its validation RMSE below 0.8 of its start, and 2 epochs,
a checkpoint, a fresh runner and 2 more epochs equal 4 uninterrupted
epochs (rtol 1e-6, the JAX test's tolerance).

The teacher and the student are the JAX test's (`simple_ani` from
``PRNGKey(99)`` and ``PRNGKey(3)``), their weights bridged into the port's
models by `interop.load_jax_arrays`; the conformers are
``make_chain_molecs(48, 10, seed=11)``, each repeated 4 times with a seeded
0.05 A perturbation, as there.  (A 5-epoch curve on 5 batches of 32 depends
on the weights drawn: from the port's own seeds 99 and 3 it ends at 0.93 of
its start at this rate.)
"""

import jax
import numpy as np
import pytest
import torch

import torchani_tpu as tt
from torchani_tpu_torch.arch import simple_ani
from torchani_tpu_torch.interop import load_jax_arrays
from torchani_tpu_torch.testing import make_chain_molecs
from torchani_tpu_torch.training import EpochRunner
from torchani_tpu_torch.training.checkpoints import load_checkpoint, save_checkpoint
from torchani_tpu_torch.training.schedules import adamw_with_plateau

torch.set_num_threads(2)
SYMBOLS = ("H", "C", "N", "O")


def _bridged(key: int, **kwargs):
    """The JAX test's `simple_ani` from ``PRNGKey(key)`` as a port model
    without self energies."""
    jmodel = tt.simple_ani(SYMBOLS, key=jax.random.PRNGKey(key), **kwargs)
    arrays = {jax.tree_util.keystr(p): np.asarray(x)
              for p, x in jax.tree_util.tree_flatten_with_path(jmodel)[0]}
    model = load_jax_arrays(simple_ani(SYMBOLS, device="cpu", **kwargs), arrays)
    model.energy_shifter.enabled = False
    return model


@pytest.fixture(scope="module")
def labeled_batches():
    teacher = _bridged(99)
    rng = np.random.RandomState(5)
    base_sp, base_xyz = make_chain_molecs(48, 10, seed=11)
    sp = np.repeat(base_sp, 4, axis=0)
    xyz = np.repeat(base_xyz, 4, axis=0)
    xyz = xyz + rng.randn(*xyz.shape).astype(np.float32) * 0.05
    with torch.no_grad():
        energies = teacher(sp, xyz).numpy()
    batches = [
        {"species": sp[i0: i0 + 32].astype(np.int32), "coordinates": xyz[i0: i0 + 32],
         "energies": energies[i0: i0 + 32]}
        for i0 in range(0, sp.shape[0], 32)
    ]
    return batches[:-1], batches[-1:]  # train, validation


@pytest.fixture(scope="module")
def student_weights():
    return _bridged(3, ensemble_size=1).state_dict()


def _student(weights):
    model = simple_ani(SYMBOLS, ensemble_size=1, device="cpu")
    model.load_state_dict(weights)
    model.energy_shifter.enabled = False
    return model


def test_val_rmse_descends(labeled_batches, student_weights):
    train_b, val_b = labeled_batches
    optimizer, _ = adamw_with_plateau(3e-4)
    runner = EpochRunner(_student(student_weights), optimizer, nn_precision=None)
    state = runner.init()
    rmses = [runner.validate(state, val_b)]
    for _ in range(5):
        state, m = runner.epoch(state, train_b)
        assert np.isfinite(m["loss"])
        rmses.append(runner.validate(state, val_b))
    assert rmses[-1] < rmses[0] * 0.8, rmses
    assert min(rmses[1:]) < rmses[0], rmses
    assert runner.fetches == 11  # one read per epoch and per validation


def test_resume_matches_uninterrupted(labeled_batches, student_weights, tmp_path):
    train_b, val_b = labeled_batches
    results = []
    for interrupted in (False, True):
        optimizer, plateau = adamw_with_plateau(1e-3)
        plateau.patience = 1
        runner = EpochRunner(_student(student_weights), optimizer, nn_precision=None)
        state = runner.init()
        for _ in range(2):
            state, _ = runner.epoch(state, train_b)
            plateau.update(runner.validate(state, val_b), state.opt_state)
        if interrupted:
            save_checkpoint(tmp_path / "ck", (state, plateau.lr, plateau.best, plateau.bad_epochs), 2)
            # fresh runner and optimizer: the "new process"
            optimizer, plateau = adamw_with_plateau(1e-3)
            plateau.patience = 1
            runner = EpochRunner(_student(student_weights), optimizer, nn_precision=None)
            state, plateau.lr, plateau.best, plateau.bad_epochs = load_checkpoint(
                tmp_path / "ck", (runner.init(), 0.0, 0.0, 0)
            )
        for _ in range(2, 4):
            state, m = runner.epoch(state, train_b)
            plateau.update(runner.validate(state, val_b), state.opt_state)
        results.append((m["loss"], runner.validate(state, val_b), state.opt_state.param_groups[0]["lr"]))
    (loss_a, rmse_a, lr_a), (loss_b, rmse_b, lr_b) = results
    np.testing.assert_allclose(loss_a, loss_b, rtol=1e-6)
    np.testing.assert_allclose(rmse_a, rmse_b, rtol=1e-6)
    assert lr_a == lr_b
