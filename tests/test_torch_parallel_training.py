"""PyTorch port: data- and ensemble-parallel training (`parallel.make_mesh`,
`shard_batch`, `shard_ensemble` and the unchanged `training.make_train_step`)
on four spawned processes of a gloo group, as 2 data x 2 model.

``tests/test_training.py::test_data_parallel_step_matches_single_device``'s
claim on its model and batch: one force-training step on the mesh gives the
unsharded step's loss within rel 1e-6 and its parameters within rtol 2e-5 /
atol 2e-7, for ``revrev`` and ``fwdrev``, under SGD at 1e-3 (an update
proportional to the gradient, so a wrongly weighted reduction shows).  Under
AdamW at 1e-3 (the JAX test's optimizer) the loss within rel 1e-6 and the
step's gradients, read from AdamW's first moment, within 1e-6 of max|g|:
Adam divides each element by its own magnitude, so where |g| is near its
eps (1e-8) the f32 rounding of the reordered sum (~2e-7 of max|g|) moves the
update by up to 2e-6, past atol 2e-7.  Against JAX at
``tests/test_torch_training.py``'s tolerances: the loss within rtol 1e-5, the
gradients (AdamW's first moment) within atol 1e-5 / rtol 1e-4 of each leaf's
max against ``jax.grad`` of JAX's loss, and the SGD step's parameters within
atol 1e-5 of JAX's weights less 1e-3 times that gradient.  The processes
import no JAX (`test_torch_parallel.spawn`).
"""

import copy
import functools

import numpy as np
import pytest
import torch

from test_torch_parallel import _leaves, _port_model, join, spawn

torch.set_num_threads(2)
WORLD = 4
MODEL = dict(symbols=("H", "O"), ensemble_size=2)


def _optimizers():
    return {
        "sgd_1e-3": functools.partial(torch.optim.SGD, lr=1e-3),
        "adamw_1e-3": functools.partial(torch.optim.AdamW, lr=1e-3, weight_decay=1e-4),
    }


STEPS = ("sgd_1e-3/revrev", "sgd_1e-3/fwdrev", "adamw_1e-3/revrev")


def _steps(model, batch, sharded=None):
    """One force step of each of `STEPS` (optimizer / gradient mode):
    ``{name: (loss, {parameter: value}, {parameter: AdamW's first moment or
    None})}``; on the mesh where ``sharded`` is ``(mesh, shard_batch,
    shard_ensemble)``."""
    from torchani_tpu_torch.training import make_train_step

    optimizers = _optimizers()
    out = {}
    for name in STEPS:
        opt_name, mode = name.split("/")
        init_fn, step_fn = make_train_step(model, optimizers[opt_name], force_training=True,
                                           force_grad_mode=mode)
        nets = copy.deepcopy(model.neural_networks)
        b = batch
        if sharded is not None:
            mesh, shard_batch, shard_ensemble = sharded
            nets, b = shard_ensemble(nets, mesh), shard_batch(batch, mesh)
        state, metrics = step_fn(init_fn(nets), b)
        params = dict(state.networks.named_parameters())
        out[name] = (
            float(metrics["loss"]),
            {n: p.detach().numpy().copy() for n, p in params.items()},
            {n: state.opt_state.state[p].get("exp_avg", torch.zeros(0)).numpy().copy()
             for n, p in params.items()},
        )
    return out


def _training_worker(rank: int, world: int, p):
    from torchani_tpu_torch.parallel import make_mesh, shard_batch, shard_ensemble
    from torchani_tpu_torch.training import make_train_step

    mesh = make_mesh(n_data=2, n_model=2, device_type="cpu")
    model = _port_model(MODEL, p["leaves"])
    out = {"steps": _steps(model, p["batch"], (mesh, shard_batch, shard_ensemble)),
           "place": (mesh.get_local_rank("data"), mesh.get_local_rank("model"))}
    try:
        shard_batch({k: v[:7] for k, v in p["batch"].items()}, mesh)
        out["uneven"] = "accepted"
    except ValueError as e:
        out["uneven"] = str(e)
    # sharded networks with the whole batch on every process: refused
    init_fn, step_fn = make_train_step(model, _optimizers()["adamw_1e-3"], force_training=True)
    try:
        step_fn(init_fn(shard_ensemble(copy.deepcopy(model.neural_networks), mesh)), p["batch"])
        out["unsharded_batch"] = "accepted"
    except ValueError as e:
        out["unsharded_batch"] = str(e)
    try:
        make_mesh(n_data=3, n_model=2, device_type="cpu")
        out["mesh_3x2"] = "accepted"
    except ValueError as e:
        out["mesh_3x2"] = str(e)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    import torchani_tpu as tt
    import torchani_tpu.training as jtr
    from torchani_tpu.testing import make_molecs
    from torchani_tpu.training.loop import _model_with_networks as jwith_networks

    jm = tt.simple_ani(MODEL["symbols"], ensemble_size=2, key=jax.random.PRNGKey(5))
    species, coords = make_molecs(8, 6, seed=2, znums=(1, 8))
    rng = np.random.RandomState(3)
    batch = {
        "species": np.asarray(species),
        "coordinates": np.asarray(coords, np.float32),
        "energies": rng.randn(8).astype(np.float32) * 0.01,
        "forces": rng.randn(8, 6, 3).astype(np.float32) * 0.01,
    }
    leaves = _leaves(jm)
    started = spawn(_training_worker, WORLD, tmp_path_factory.mktemp("training"),
                    dict(leaves=leaves, batch=batch))
    single = _steps(_port_model(MODEL, leaves), batch)

    def jloss(nets):
        return jtr.energy_force_loss(jwith_networks(jm, nets), *jbatch)

    jbatch = [jnp.asarray(batch[k]) for k in ("species", "coordinates", "energies", "forces")]
    jloss_, jgrads = jax.jit(jax.value_and_grad(jloss))(jm.potentials["nnp"].neural_networks)
    jweights = _leaves(jm.potentials["nnp"].neural_networks)
    return single, (float(jloss_), jweights, _leaves(jgrads)), join(started)


def _member_slice(name: str, value: np.ndarray, m: int, n_model: int) -> np.ndarray:
    e = value.shape[0]
    return value[m * (e // n_model):(m + 1) * (e // n_model)]


@pytest.mark.parametrize("step", ["sgd_1e-3/revrev", "sgd_1e-3/fwdrev"])
def test_data_parallel_step_matches_single_device(runs, step):
    single, _, sharded = runs
    loss1, params1, _ = single[step]
    for rank in sharded:
        loss, params, _ = rank["steps"][step]
        _, m = rank["place"]
        assert loss == pytest.approx(loss1, rel=1e-6)
        assert sorted(params) == sorted(params1)
        for name, value in params.items():
            np.testing.assert_allclose(
                value, _member_slice(name, params1[name], m, 2), rtol=2e-5, atol=2e-7,
                err_msg=name,
            )


def test_data_parallel_adamw_step_matches_single_device(runs):
    single, _, sharded = runs
    loss1, _, moments1 = single["adamw_1e-3/revrev"]
    for rank in sharded:
        loss, _, moments = rank["steps"]["adamw_1e-3/revrev"]
        _, m = rank["place"]
        assert loss == pytest.approx(loss1, rel=1e-6)
        for name, value in moments.items():
            want = _member_slice(name, moments1[name], m, 2)
            np.testing.assert_allclose(value, want, rtol=0, atol=1e-6 * np.abs(want).max(),
                                       err_msg=name)


def test_data_parallel_step_matches_jax(runs):
    _, (jloss, jweights, jgrads), sharded = runs
    for rank in sharded:
        _, m = rank["place"]
        loss, _, moments = rank["steps"]["adamw_1e-3/revrev"]
        np.testing.assert_allclose(loss, jloss, rtol=1e-5)
        _, params, _ = rank["steps"]["sgd_1e-3/revrev"]
        assert len(jgrads) == len(params)
        for path, jg in jgrads.items():
            name = _resolve_name(path)
            jg = _member_slice(name, jg, m, 2)
            scale = np.abs(jg).max() + 1e-12
            # AdamW's first moment after one step is (1 - 0.9) times the gradient
            np.testing.assert_allclose(moments[name] / 0.1 / scale, jg / scale, atol=1e-5,
                                       rtol=1e-4, err_msg=path)
            want = _member_slice(name, jweights[path], m, 2) - 1e-3 * jg
            np.testing.assert_allclose(params[name], want, rtol=0, atol=1e-5, err_msg=path)


def _resolve_name(path: str) -> str:
    """The port's parameter name of a JAX ensemble leaf path, e.g.
    ``.weights[0]`` -> ``weights.0``."""
    import re

    m = re.fullmatch(r"\.(weights|biases)\[(\d+)\]", path)
    assert m, path
    return f"{m.group(1)}.{m.group(2)}"


def test_sharding_refuses_what_it_cannot_split(runs):
    rank0 = runs[2][0]
    assert "does not split into 2 blocks" in rank0["uneven"]
    assert "shard_batch" in rank0["unsharded_batch"]
    assert rank0["mesh_3x2"] == "mesh 3x2 does not cover 4 processes"
