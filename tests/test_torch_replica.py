"""PyTorch port: `replica.ReplicaExchange` against the JAX package's, on the
CPU.

Four replicas of two water molecules (280-410 K) through a one-member
`simple_ani` whose weights come through `torchani_tpu_torch.interop`: two
segments of three Langevin steps and a swap sweep, the port replaying the
JAX run's normal draws (``noise=``) and uniforms (``u=``): coordinates within
1e-5 A after every step and sweep, the same accept decisions and counters.
Equal temperatures accept every swap; a swap permutes coordinates,
velocities, forces and energies together; one seed gives one run.
"""

import jax
import numpy as np
import pytest
import torch

import torchani_tpu as tt
from torchani_tpu.replica import ReplicaExchange as JReplicaExchange
from torchani_tpu_torch.arch import simple_ani
from torchani_tpu_torch.interop import load_jax_arrays
from torchani_tpu_torch.replica import ReplicaExchange, ReplicaState

torch.set_num_threads(2)
CPU = "cpu"
SPECIES = np.array([8, 1, 1, 8, 1, 1])
COORDS = np.array(
    [[0.0, 0.0, 0.12], [0.0, 0.76, -0.48], [0.0, -0.76, -0.48],
     [2.9, 0.1, 0.0], [3.3, 0.9, 0.3], [3.4, -0.6, 0.4]], np.float32,
)
LADDER = (280.0, 320.0, 360.0, 410.0)


def _leaves(tree):
    return {
        jax.tree_util.keystr(p): np.asarray(x)
        for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


@pytest.fixture(scope="module")
def both_models():
    jmodel = tt.simple_ani(("H", "C", "N", "O"), ensemble_size=1)
    pmodel = simple_ani(("H", "C", "N", "O"), ensemble_size=1, device=CPU)
    return jmodel, load_jax_arrays(pmodel, _leaves(jmodel))


def _t(x):
    return torch.as_tensor(np.array(x))


def test_replay_matches_jax(both_models):
    jmodel, pmodel = both_models
    jre = JReplicaExchange(jmodel, SPECIES, LADDER, timestep_fs=0.5, friction_per_fs=0.05)
    pre = ReplicaExchange(pmodel, SPECIES, LADDER, timestep_fs=0.5, friction_per_fs=0.05,
                          device=CPU)
    jst = jre.init(COORDS, seed=2)
    st = pre.init(COORDS).replace(velocities=_t(jst.velocities))
    np.testing.assert_allclose(st.energy.numpy(), np.asarray(jst.energy), rtol=1e-6)
    np.testing.assert_allclose(st.forces.numpy(), np.asarray(jst.forces), atol=1e-5)
    j_step, j_swap = jax.jit(jre._step_langevin), jax.jit(jre._swap)
    accepted = []
    for _ in range(2):
        for _ in range(3):
            noise = jax.random.normal(jax.random.split(jst.key)[1], jst.velocities.shape)
            jst = j_step(jst)
            st = pre._step_langevin(st, noise=_t(noise))
            np.testing.assert_allclose(st.coords.numpy(), np.asarray(jst.coords), atol=1e-5, rtol=0)
        u = jax.random.uniform(jax.random.split(jst.key)[1], (len(LADDER),))
        before, j_before = st.coords, np.asarray(jst.coords)
        jst = j_swap(jst)
        st = pre._swap(st, u=_t(u))
        moved = [not torch.equal(st.coords[i], before[i]) for i in range(len(LADDER))]
        assert moved == [not np.array_equal(np.asarray(jst.coords)[i], j_before[i])
                         for i in range(len(LADDER))]
        accepted.append(moved)
        np.testing.assert_allclose(st.coords.numpy(), np.asarray(jst.coords), atol=1e-5, rtol=0)
        np.testing.assert_allclose(st.velocities.numpy(), np.asarray(jst.velocities), atol=1e-5)
        np.testing.assert_allclose(st.energy.numpy(), np.asarray(jst.energy), rtol=1e-6)
        assert int(st.swaps_attempted) == int(jst.swaps_attempted)
        assert int(st.swaps_accepted) == int(jst.swaps_accepted)
        assert st.segment == int(jst.segment) and st.step == int(jst.step)
    assert int(st.swaps_attempted) == 2 + 1
    assert st.swaps_attempted.dtype == torch.int32
    assert pre.acceptance_rate(st) == pytest.approx(jre.acceptance_rate(jst))
    # this run proposes three pairs and accepts some, not all
    assert 0 < int(st.swaps_accepted) < 3 and sum(map(sum, accepted)) == 2 * int(st.swaps_accepted)


def test_equal_temperatures_accept_every_swap(both_models):
    _, pmodel = both_models
    re = ReplicaExchange(pmodel, SPECIES, (300.0,) * 5, device=CPU)
    st = re.run(re.init(COORDS, generator=torch.Generator().manual_seed(1)), 4, 2)
    assert int(st.swaps_attempted) == 2 + 2 + 2 + 2
    assert re.acceptance_rate(st) == 1.0


def test_swap_permutes_the_state_together(both_models):
    _, pmodel = both_models
    re = ReplicaExchange(pmodel, SPECIES, LADDER, device=CPU)
    st = re.init(COORDS, generator=torch.Generator().manual_seed(4))
    st = re._step_langevin(st)
    # u = 0 accepts every proposed pair; the even sweep pairs (0, 1), (2, 3)
    sw = re._swap(st, u=torch.zeros(len(LADDER)))
    perm = torch.tensor([1, 0, 3, 2])
    assert torch.equal(sw.coords, st.coords[perm])
    assert torch.equal(sw.forces, st.forces[perm])
    assert torch.equal(sw.energy, st.energy[perm])
    scale = torch.sqrt(re.temperatures / re.temperatures[perm])
    assert torch.equal(sw.velocities, st.velocities[perm] * scale[:, None, None])
    e, f = re._energy_and_forces(sw.coords)
    np.testing.assert_allclose(e.numpy(), sw.energy.numpy(), rtol=1e-6)
    # the odd sweep pairs (1, 2) only; replicas 0 and 3 sit out
    odd = re._swap(sw, u=torch.zeros(len(LADDER)))
    assert torch.equal(odd.coords, sw.coords[torch.tensor([0, 2, 1, 3])])
    assert int(odd.swaps_attempted) == 3 and int(odd.swaps_accepted) == 3


def test_one_seed_one_run(both_models):
    _, pmodel = both_models
    re = ReplicaExchange(pmodel, SPECIES, LADDER, device=CPU)
    runs = [re.run(re.init(COORDS, generator=torch.Generator().manual_seed(9)), 2, 3)
            for _ in range(2)]
    for name in ("coords", "velocities", "energy", "swaps_accepted"):
        assert torch.equal(getattr(runs[0], name), getattr(runs[1], name))
    assert isinstance(runs[0], ReplicaState) and runs[0].step == 6 and runs[0].segment == 2


def test_needs_two_replicas(both_models):
    _, pmodel = both_models
    with pytest.raises(ValueError, match=">= 2 replicas"):
        ReplicaExchange(pmodel, SPECIES, (300.0,), device=CPU)
