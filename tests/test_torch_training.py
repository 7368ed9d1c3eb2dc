"""PyTorch port: the training stack (`torchani_tpu_torch.training`) and the
AEV computer's ``angular_capacity`` against the JAX package's, on the CPU.

``angular_capacity``: on a padded `make_chain_molecs` batch, energies and
forces of the port (plain path and the kernel strategy's CPU path) equal
JAX's at capacities 8, 12 and the full table (energies atol 5e-5 Ha,
forces 1e-5 Ha/A, the f32 tolerances of ``tests/test_energies.py``), the
field carried by the weight bridge; one lane short of the batch's largest
angular count, NaN in both.  Train steps: 3 AdamW steps (optax's numbers,
rate 3e-4), energy-only and force, against ``make_train_step`` with
``optax.adamw``:
step-1 gradients atol 1e-5 / rtol 1e-4 of each leaf's max, losses rtol
1e-5, parameters after 3 steps atol 1e-5.  ``fwdrev`` against ``revrev``
at JAX's ``test_fwdrev_force_grads_match`` tolerances (loss rtol 1e-7,
parameters rtol 2e-4 / atol 1e-7).  The bucketed step at a no-op capacity
against the plain step (rtol 1e-6) and on density-bucketed batches;
`EpochRunner` against a per-batch loop (loss rtol 1e-5, parameters rtol
2e-5 / atol 1e-7, validation RMSE rtol 1e-4) and on two capacity buckets;
the ``tune_*`` picks equal to JAX's on the same batches; the plateau
controller and AdamW against optax (1e-7); `merge_members`,
`merge_state_dicts` (``.pt`` and ``.npz``) equal to JAX's; a
`MetricsWriter` file read by JAX's `read_metrics` and back; a checkpoint
round trip with pruning.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torchani_tpu as tt
import torchani_tpu.training as jtr
from torchani_tpu.testing import make_chain_molecs as jmake_chain_molecs
from torchani_tpu.testing import make_molecs
from torchani_tpu.training.loop import _model_with_angular_capacity as jwith_capacity
from torchani_tpu.training.loop import _model_with_networks as jwith_networks
from torchani_tpu_torch import grad, training, utils
from torchani_tpu_torch.arch import simple_ani
from torchani_tpu_torch.interop import _resolve, load_jax_arrays
from torchani_tpu_torch.nn import AtomicNetworks
from torchani_tpu_torch.testing import make_chain_molecs
from torchani_tpu_torch.training import checkpoints
from torchani_tpu_torch.training.loop import _model_with_networks, energy_force_loss

torch.set_num_threads(2)
CPU = "cpu"
SYMBOLS = ("H", "C", "N", "O")
CAPACITY_PATH = ".potentials['nnp'].aev_computer.angular_capacity"


def _leaves(tree):
    return {
        jax.tree_util.keystr(p): np.asarray(x)
        for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


def _pair(seed=0, **kwargs):
    """A JAX simple_ani without self energies and the port's, bridged."""
    jm = tt.simple_ani(SYMBOLS, ensemble_size=1, key=jax.random.PRNGKey(seed), **kwargs)
    jm = jm.replace(energy_shifter=jm.energy_shifter.replace(enabled=False))
    pm = load_jax_arrays(simple_ani(SYMBOLS, ensemble_size=1, device=CPU, **kwargs), _leaves(jm))
    pm.energy_shifter.enabled = False
    return jm, pm


def _max_angular_count(species, coords, cutoff=3.5):
    worst = 0
    for s, c in zip(species, coords):
        pos = c[s >= 0]
        d = np.linalg.norm(pos[:, None] - pos[None], axis=-1)
        np.fill_diagonal(d, np.inf)
        worst = max(worst, int((d < cutoff).sum(1).max()))
    return worst


@pytest.fixture(scope="module")
def models():
    return _pair(0)


@pytest.fixture(scope="module")
def chain_batch():
    sp, co = make_chain_molecs(16, 12, seed=3)
    rng = np.random.RandomState(0)
    return {
        "species": sp.astype(np.int32), "coordinates": co,
        "energies": rng.randn(16).astype(np.float32) * 0.01,
        "forces": rng.randn(16, 12, 3).astype(np.float32) * 0.01,
    }


def test_angular_capacity_matches_jax(models):
    jm, pm = models
    sp, co = make_chain_molecs(16, 10, seed=2)
    worst = _max_angular_count(sp, co)
    assert worst == 8

    def jef(m):
        def esum(c):
            e = m(jnp.asarray(sp), c)
            return jnp.sum(e), e

        (_, e), g = jax.jit(jax.value_and_grad(esum, has_aux=True))(jnp.asarray(co))
        return np.asarray(e), -np.asarray(g)

    for cap in (8, 12, None, worst - 1):
        jmc = jm if cap is None else jwith_capacity(jm, cap)
        arrays = _leaves(jmc)
        arrays[CAPACITY_PATH] = np.asarray([] if cap is None else [cap], np.int64)
        pmc = load_jax_arrays(simple_ani(SYMBOLS, ensemble_size=1, device=CPU), arrays)
        pmc.energy_shifter.enabled = False
        assert pmc.aev_computer.angular_capacity == cap
        je, jf = jef(jmc)
        for strategy in ("plain", "cuda"):
            pmc.aev_computer.strategy = strategy
            pe, pf = grad.energies_and_forces(pmc, sp, co)
            if cap == worst - 1:
                assert np.isnan(je).all() and torch.isnan(pe).all(), strategy
                continue
            np.testing.assert_allclose(pe.numpy(), je, rtol=0, atol=5e-5)
            np.testing.assert_allclose(pf.numpy(), jf, rtol=0, atol=1e-5)


def _port_grads(pm, batch, force):
    params = dict(pm.neural_networks.named_parameters())
    loss = energy_force_loss(pm, batch["species"], batch["coordinates"], batch["energies"],
                             batch["forces"] if force else None)
    gs = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return {n: (torch.zeros_like(p) if g is None else g).numpy()
            for (n, p), g in zip(params.items(), gs)}


def _compare_networks(pnets, jnets, atol, rtol=0.0, scaled=False):
    compared = 0
    by_id = {id(t): n for n, t in pnets.named_parameters()}
    for path, jv in _leaves(jnets).items():
        t = _resolve(pnets, path)
        assert id(t) in by_id, path
        pv = t.detach().numpy() if isinstance(t, torch.Tensor) else t
        scale = (np.abs(jv).max() + 1e-12) if scaled else 1.0
        np.testing.assert_allclose(pv / scale, jv / scale, atol=atol, rtol=rtol, err_msg=path)
        compared += 1
    assert compared == len(by_id) > 0


@pytest.mark.parametrize("force", [False, True], ids=["energy", "force"])
def test_train_steps_match_jax(models, chain_batch, force):
    jm, pm = models
    jbatch = {k: jnp.asarray(v) for k, v in chain_batch.items()}

    def jloss(nets):
        m = jwith_networks(jm, nets)
        return jtr.energy_force_loss(m, jbatch["species"], jbatch["coordinates"],
                                     jbatch["energies"], jbatch["forces"] if force else None)

    jgrads = jax.jit(jax.grad(jloss))(jm.potentials["nnp"].neural_networks)
    pgrads = _port_grads(pm, chain_batch, force)
    by_id = {id(t): n for n, t in pm.neural_networks.named_parameters()}
    for path, jg in _leaves(jgrads).items():
        name = by_id[id(_resolve(pm.neural_networks, path))]
        scale = np.abs(jg).max() + 1e-12
        np.testing.assert_allclose(pgrads[name] / scale, jg / scale, atol=1e-5, rtol=1e-4)

    # at 3e-4, the rate of tests/test_learning.py: at 1e-3 Adam's first step
    # moves every weight by ~lr, also those whose gradients are ~eps (1e-8)
    # and differ by ~0.3% in f32 between the packages, and the step-2 losses
    # of the energy step then differ by 1.7e-5
    ji, js = jtr.make_train_step(jm, optax.adamw(3e-4, weight_decay=1e-6),
                                 force_training=force, nn_precision=None)
    optimizer, _ = training.adamw_with_plateau(3e-4)
    pi, ps = training.make_train_step(pm, optimizer, force_training=force)
    jstate, pstate = ji(), pi()
    js = jax.jit(js)
    for _ in range(3):
        jstate, jmet = js(jstate, jbatch)
        pstate, pmet = ps(pstate, chain_batch)
        np.testing.assert_allclose(float(pmet["loss"]), float(jmet["loss"]), rtol=1e-5)
    assert pstate.step == 3
    _compare_networks(pstate.networks, jstate.networks, atol=1e-5)
    # the template keeps its weights
    _compare_networks(pm.neural_networks, jm.potentials["nnp"].neural_networks, atol=0)


def test_fwdrev_matches_revrev(models, chain_batch):
    _, pm = models
    outs = {}
    for mode in ("revrev", "fwdrev"):
        init, step = training.make_train_step(
            pm, functools.partial(torch.optim.Adam, lr=1e-3), force_training=True,
            nn_precision=None, force_grad_mode=mode,
        )
        state, m = step(init(), chain_batch)
        outs[mode] = (float(m["loss"]), state.networks)
    np.testing.assert_allclose(outs["revrev"][0], outs["fwdrev"][0], rtol=1e-7)
    for a, b in zip(outs["revrev"][1].parameters(), outs["fwdrev"][1].parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=2e-4, atol=1e-7)
    with pytest.raises(ValueError, match="force_grad_mode"):
        training.make_train_step(pm, torch.optim.Adam, force_grad_mode="fwd")


def test_bucketed_step(tmp_path):
    """A no-op capacity gives the plain step's loss; density-bucketed
    batches train through their capacities, with JAX's losses."""
    jm, pm = _pair(1, repulsion=False)
    sp, co = make_chain_molecs(8, 10, seed=11)
    batch = {"species": sp, "coordinates": co,
             "energies": np.random.RandomState(2).randn(8).astype(np.float32),
             "forces": np.zeros((8, 10, 3), np.float32)}
    opt = functools.partial(torch.optim.AdamW, lr=1e-3, weight_decay=1e-4)
    init, plain = training.make_train_step(pm, opt, force_training=True)
    _, bucketed = training.make_bucketed_train_step(pm, opt, force_training=True)
    _, m_plain = plain(init(), batch)
    _, m_b = bucketed(init(), {**batch, "angular_capacity": np.int32(9)})
    np.testing.assert_allclose(float(m_plain["loss"]), float(m_b["loss"]), rtol=1e-6)

    from torchani_tpu.datasets import ANIDataset as JDataset
    from torchani_tpu.datasets import Batcher as JBatcher
    from torchani_tpu_torch.datasets import ANIDataset, Batcher

    group = {"species": None, "coordinates": None}
    group["species"], group["coordinates"] = make_chain_molecs(48, 12, seed=3)
    group["energies"] = np.random.RandomState(0).randn(48) - 40
    group["forces"] = np.random.RandomState(1).randn(48, 12, 3) * 0.01
    ds, jds_ = ANIDataset(), JDataset()
    ds.append_conformers("g0", group)
    jds_.append_conformers("g0", group)
    divs = Batcher(rng_seed=5).divide(ds, splits={"training": 1.0})
    batches = Batcher(rng_seed=5).gather_batches(ds, divs["training"], 16, density_cutoff=3.5)
    jbatches = JBatcher(rng_seed=5).gather_batches(jds_, divs["training"], 16, density_cutoff=3.5)
    caps = [int(b["angular_capacity"]) for b in batches]
    assert caps == sorted(caps) and len(set(caps)) > 1
    init, step = training.make_bucketed_train_step(pm, opt, force_training=True)
    jinit, jstep = jtr.make_bucketed_train_step(jm, optax.adamw(1e-3), force_training=True)
    state, jstate = init(), jinit()
    for b, jb in zip(batches, jbatches):
        state, m = step(state, b)
        jstate, jm_ = jstep(jstate, {k: jnp.asarray(v) for k, v in jb.items()})
        np.testing.assert_allclose(float(m["loss"]), float(jm_["loss"]), rtol=1e-5)
    assert state.step == len(batches)


def _molecs_batches():
    rng = np.random.RandomState(0)
    batches = []
    for i in range(5):
        species, coords = make_molecs(8, 6, seed=i)
        batches.append({"species": species, "coordinates": coords,
                        "energies": rng.randn(8).astype(np.float64) * 0.01})
    species, coords = make_molecs(8, 7, seed=9)  # another shape class
    batches.append({"species": species, "coordinates": coords,
                    "energies": rng.randn(8).astype(np.float64) * 0.01})
    return batches


def test_epoch_runner_matches_per_batch_loop(models):
    _, pm = models
    batches = _molecs_batches()
    opt = functools.partial(torch.optim.Adam, lr=1e-3)
    runner = training.EpochRunner(pm, opt, chunk=3, nn_precision=None)
    state_r, metrics = runner.epoch(runner.init(), batches)
    assert metrics["steps"] == 6 and runner.fetches == 1
    init, step = training.make_train_step(pm, opt, nn_precision=None)
    state_n, losses = init(), []
    for b in batches:
        state_n, m = step(state_n, b)
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(metrics["loss"], np.mean(losses), rtol=1e-5)
    for a, b in zip(state_n.networks.parameters(), state_r.networks.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=2e-5, atol=1e-7)
    rmse = runner.validate(state_r, batches)
    assert runner.fetches == 2
    m = _model_with_networks(pm, state_r.networks)
    with torch.no_grad():
        errs = [m(b["species"], b["coordinates"]).numpy() - b["energies"] for b in batches]
    np.testing.assert_allclose(rmse, float(np.sqrt(np.mean(np.concatenate(errs) ** 2))), rtol=1e-4)

    # two capacity buckets in one epoch
    rng = np.random.RandomState(1)
    bucketed = []
    for cap in (8, 12):
        for i in range(2):
            species, coords = make_molecs(6, 8, seed=10 * cap + i)
            bucketed.append({"species": species, "coordinates": coords,
                             "energies": rng.randn(6) * 0.01,
                             "angular_capacity": np.asarray(cap, np.int32)})
    runner = training.EpochRunner(pm, opt, chunk=4)
    state, metrics = runner.epoch(runner.init(), bucketed)
    assert metrics["steps"] == 4 and np.isfinite(metrics["loss"])
    assert sorted(runner._models) == [8, 12]
    assert np.isfinite(runner.validate(state, bucketed))


def test_tune_picks_match_jax(models):
    jm, pm = models
    sp, co = make_chain_molecs(64, 20, seed=7)
    jsp, jco = jmake_chain_molecs(64, 20, seed=7)
    np.testing.assert_array_equal(sp, jsp)
    np.testing.assert_array_equal(co, jco)
    host = [{"species": sp, "coordinates": co}]
    p = training.tune_angular_capacity(pm, host)
    j = jtr.tune_angular_capacity(jm, host)
    assert p.aev_computer.angular_capacity == j.potentials["nnp"].aev_computer.angular_capacity
    assert pm.aev_computer.angular_capacity is None  # the caller's model stays
    base_p = training.loop._model_with_angular_capacity(pm, 12)
    base_j = jwith_capacity(jm, 12)
    for margin in (1.3, 2.0):
        ps = training.tune_angular_split(base_p, host, margin=margin)
        js = jtr.tune_angular_split(base_j, host, margin=margin)
        assert ps.aev_computer.angular_split == js.potentials["nnp"].aev_computer.angular_split
    assert len(training.tune_angular_split(base_p, host, margin=2.0).aev_computer.angular_split) == 3
    assert training.tune_angular_split(pm, host) is pm  # no explicit capacity
    pp = training.tune_species_partition(pm, host, quantum=64)
    jp = jtr.tune_species_partition(jm, host, quantum=64)
    assert pp.neural_networks.partition == jp.potentials["nnp"].neural_networks.partition
    assert pm.neural_networks.partition is None
    with torch.no_grad():
        np.testing.assert_allclose(pp(sp, co).numpy(), pm(sp, co).numpy(), rtol=0, atol=1e-5)


def test_plateau_and_adamw_match_optax():
    sched = training.ReduceLROnPlateau(initial_lr=1.0, factor=0.5, patience=2)
    for metric in [1.0, 0.9, 0.8]:
        assert sched.update(metric) == 1.0
    for metric in [0.85, 0.85, 0.85]:
        lr = sched.update(metric)
    assert lr == 0.5

    factory, plateau = training.adamw_with_plateau(1e-3)
    w0 = np.random.RandomState(0).randn(4, 3).astype(np.float32)
    grads = [np.random.RandomState(i + 1).randn(4, 3).astype(np.float32) for i in range(3)]
    p = torch.nn.Parameter(torch.as_tensor(w0.copy()))
    opt = factory([p])
    jopt, _ = jtr.adamw_with_plateau(1e-3)
    jw, jstate = jnp.asarray(w0), jopt.init(jnp.asarray(w0))
    for i, g in enumerate(grads):
        lr = 1e-3 if i < 2 else 5e-4
        plateau.lr = lr
        plateau.patience, plateau.best = 10, -1.0  # keep the rate: record no improvement
        plateau.update(0.0, opt)
        assert all(group["lr"] == lr for group in opt.param_groups)
        jstate.hyperparams["learning_rate"] = jnp.asarray(lr, jnp.float32)
        p.grad = torch.as_tensor(g)
        opt.step()
        upd, jstate = jopt.update(jnp.asarray(g), jstate, jw)
        jw = optax.apply_updates(jw, upd)
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jw), rtol=0, atol=1e-7)
    assert opt.defaults["weight_decay"] == 1e-6 and opt.defaults["eps"] == 1e-8


def test_merge_members_and_state_dicts(tmp_path):
    from torchani_tpu.training.checkpoints import merge_state_dicts as jmerge

    members = [AtomicNetworks.like_1x(generator=torch.Generator().manual_seed(i), device=CPU)
               for i in range(3)]
    ens = training.merge_members(members)
    assert ens.total_members_num == 3 and members[0].total_members_num == 1
    elem = torch.as_tensor(np.random.RandomState(0).randint(-1, 4, (2, 5)))
    aev = torch.randn(2, 5, 384, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        mean = torch.stack([m(elem, aev) for m in members]).mean(0)
        np.testing.assert_allclose(ens(elem, aev).numpy(), mean.numpy(), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="architecture"):
        training.merge_members([members[0], AtomicNetworks.like_2x(device=CPU)])

    rng = np.random.RandomState(2)
    for j in range(2):
        sd = {"neural_networks.0.weight": rng.randn(3, 2).astype(np.float32),
              "aev_computer.radial.eta": np.float32([16.0])}
        np.savez(tmp_path / f"m{j}.npz", **sd)
        torch.save({k: torch.as_tensor(v) for k, v in sd.items()}, tmp_path / f"m{j}.pt")
    assert utils.merge_state_dicts is checkpoints.merge_state_dicts
    for suffix in ("npz", "pt"):
        paths = [tmp_path / f"m{j}.{suffix}" for j in (1, 0)]
        mine, ref = utils.merge_state_dicts(paths), jmerge(paths)
        assert sorted(mine) == sorted(ref) == [
            "aev_computer.radial.eta", "neural_networks.0.0.weight", "neural_networks.1.0.weight"
        ]
        for k in ref:
            np.testing.assert_array_equal(mine[k], ref[k])
    with pytest.raises(ValueError, match="existing files"):
        utils.merge_state_dicts([tmp_path / "none.pt"])


def test_metrics_files_cross_read(tmp_path):
    from torchani_tpu.training import MetricsWriter as JWriter

    path = tmp_path / "run" / "metrics.jsonl"
    with training.MetricsWriter(path, csv_mirror=True) as w:
        w.write(0, {"loss": torch.tensor(1.5), "lr": 1e-3})
        w.write(1, {"loss": 1.25, "lr": 1e-3, "val_rmse": 0.2})
    cols = jtr.read_metrics(path)
    assert cols["step"] == [0.0, 1.0] and cols["loss"] == [1.5, 1.25]
    assert np.isnan(cols["val_rmse"][0]) and cols["val_rmse"][1] == 0.2
    assert (tmp_path / "run" / "metrics.csv").read_text().startswith("step,time,loss,lr")
    with JWriter(path) as w:
        w.write(2, {"loss": 1.0})
    mine = training.read_metrics(path)
    assert mine["step"] == [0.0, 1.0, 2.0]
    assert mine.keys() == jtr.read_metrics(path).keys()


def test_checkpoint_roundtrip(models, chain_batch, tmp_path):
    _, pm = models
    optimizer, plateau = training.adamw_with_plateau(1e-3)
    init, step = training.make_train_step(pm, optimizer, force_training=True)
    state = init()
    for _ in range(2):
        state, _ = step(state, chain_batch)
    for s in range(1, 5):
        training.save_checkpoint(tmp_path, (state, 5e-4, 0.25, 1), s, keep=2)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_0000000003", "step_0000000004"]
    assert checkpoints.latest_step(tmp_path) == 4
    assert training.load_checkpoint(tmp_path / "empty", (init(), 0.0, 0.0, 0)) is None
    restored, lr, best, bad = training.load_checkpoint(tmp_path, (init(), 0.0, 0.0, 0))
    assert (lr, best, bad) == (5e-4, 0.25, 1) and restored.step == 2
    for a, b in zip(state.networks.parameters(), restored.networks.parameters()):
        assert torch.equal(a, b)
    s0, s1 = state.opt_state.state_dict(), restored.opt_state.state_dict()
    assert s0["param_groups"] == s1["param_groups"]
    for k, v in s0["state"].items():
        for name, t in v.items():
            assert torch.equal(t, s1["state"][k][name]), name
    # one more step from each gives the same networks
    state, m0 = step(state, chain_batch)
    restored, m1 = step(restored, chain_batch)
    assert float(m0["loss"]) == float(m1["loss"])
    for a, b in zip(state.networks.parameters(), restored.networks.parameters()):
        assert torch.equal(a, b)
