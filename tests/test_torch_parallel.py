"""PyTorch port: `parallel` (atom-sharded MD over ``torch.distributed``) and
the slot-row helpers of `bucket_refresh` that its sharded refresh runs,
against the JAX package's.

The slot-row helpers and `_exchange_maps` run here in process.  The sharded
MD runs in four spawned processes on a gloo group (``file://`` rendezvous in
``tmp_path``, a 60 s collective timeout); they import no JAX, so this module
imports JAX inside the functions that only this process runs, and the
processes get numpy arrays: the JAX models' leaves, the systems and the JAX
state's velocities.  One spawn runs every check of the module.

The five checks of ``tests/test_parallel_md.py`` (a world of 4 in place of
its 8 devices): against the port's `MolecularDynamics` at that file's
tolerances (energy and forces atol 2e-5, coordinates atol 1e-4, energy after
the run atol 5e-5), and against JAX's `MolecularDynamics` at
``tests/test_torch_md.py``'s (forces atol 1e-5, energy rtol 1e-6;
coordinates atol 1e-4 after the run).  Every process must end with the same
coordinates, to the bit.
"""

import concurrent.futures
import datetime
import importlib
import multiprocessing
import os
import pickle
import time
import traceback

import numpy as np
import pytest
import torch

torch.set_num_threads(2)
WORLD = 4
SYMBOLS = ("H", "C", "N", "O")
#: the models of tests/test_parallel_md.py: (simple_ani arguments, JAX key)
MODELS = {
    "base": (dict(symbols=SYMBOLS, ensemble_size=2), 0),
    "hetero": (dict(symbols=SYMBOLS, ensemble_size=2, repulsion=True, dispersion=True), 1),
    "ho": (dict(symbols=("H", "O"), ensemble_size=1, repulsion=False), 0),
}
TRAJ_KW = dict(pbc=True, timestep_fs=0.5)
REFRESH_KW = dict(pbc=True, timestep_fs=0.25, skin=0.35)
REFRESH_STEPS = 30


# ---------------------------------------------------------------------------
# spawned processes (no JAX)
# ---------------------------------------------------------------------------


def _entry(module: str, name: str, rank: int, world: int, root: str) -> None:
    torch.set_num_threads(1)
    try:
        with open(os.path.join(root, "payload.pkl"), "rb") as f:
            payload = pickle.load(f)
        torch.distributed.init_process_group(
            "gloo", init_method=f"file://{root}/rendezvous", world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=60),
        )
        out = getattr(importlib.import_module(module), name)(rank, world, payload)
        with open(os.path.join(root, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        torch.distributed.destroy_process_group()
    except BaseException:
        with open(os.path.join(root, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def spawn(fn, world: int, root, payload):
    """Start ``fn(rank, world, payload)`` in ``world`` spawned processes on
    one gloo group; `join` waits for them.  The payload goes through a file
    in ``root``: a large one through the processes' start pipes would start
    them one after the other."""
    with open(os.path.join(root, "payload.pkl"), "wb") as f:
        pickle.dump(payload, f)
    ctx = multiprocessing.get_context("spawn")
    procs = [
        ctx.Process(
            target=_entry, args=(fn.__module__, fn.__name__, r, world, str(root)), daemon=True
        )
        for r in range(world)
    ]
    for p in procs:
        p.start()
    return procs, str(root)


def join(started, timeout: float = 120.0):
    """The results of `spawn`'s processes, by rank.  A process that fails or
    outlives ``timeout`` fails the caller."""
    procs, root = started
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    errors = [
        open(os.path.join(root, f)).read() for f in sorted(os.listdir(root)) if f.endswith(".err")
    ]
    assert not hung, f"{len(hung)} of {len(procs)} processes hung past {timeout} s\n" + "\n".join(
        errors
    )
    assert all(p.exitcode == 0 for p in procs), "\n".join(errors)
    results = []
    for r in range(len(procs)):
        with open(os.path.join(root, f"rank{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


def _port_model(kwargs, leaves):
    from torchani_tpu_torch.arch import simple_ani
    from torchani_tpu_torch.interop import load_jax_arrays

    return load_jax_arrays(simple_ani(**kwargs, device="cpu"), leaves)


def _md_worker(rank: int, world: int, p):
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    from torchani_tpu_torch.md import MolecularDynamics
    from torchani_tpu_torch.parallel import ShardedMolecularDynamics
    from torchani_tpu_torch.parallel.md import ExchangeTables

    mesh = DeviceMesh("cpu", torch.arange(world), mesh_dim_names=("atoms",))
    models = {k: _port_model(MODELS[k][0], p["leaves"][k]) for k in MODELS}
    sp, co, ce = p["box"]
    out = {}

    md = ShardedMolecularDynamics(models["base"], sp, mesh, cell=ce, device="cpu", **TRAJ_KW)
    st = md.init(co)
    out["base"] = dict(energy=float(st.energy), forces=st.forces.numpy(), atoms=st.coords.shape[0])
    st = md.run_nve(st, 5)
    out["traj"] = dict(energy=float(st.energy), coords=st.coords.numpy())

    md = ShardedMolecularDynamics(models["hetero"], sp, mesh, cell=ce, pbc=True, device="cpu")
    st = md.init(co)
    out["hetero"] = dict(energy=float(st.energy), forces=st.forces.numpy())
    models["hetero"].set_enabled("dispersion_d3", False)
    md = ShardedMolecularDynamics(models["hetero"], sp, mesh, cell=ce, pbc=True, device="cpu")
    out["hetero"]["energy_no_d3"] = float(md.init(co).energy)

    sp49, co49 = p["uneven"]
    md = ShardedMolecularDynamics(models["base"], sp49, mesh, cell=ce, pbc=True, device="cpu")
    st = md.init(co49)
    out["uneven"] = dict(energy=float(st.energy), forces=st.forces.numpy(), atoms=st.coords.shape[0])

    sp, co, ce = p["refresh_box"]
    md = ShardedMolecularDynamics(models["ho"], sp, mesh, cell=ce, device="cpu", **REFRESH_KW)
    st = md.init(co)
    v = torch.zeros_like(st.velocities)
    v[: p["velocities"].shape[0]] = torch.as_tensor(p["velocities"])
    st = st.replace(velocities=v)
    out["refresh"] = dict(
        exchange=isinstance(st.bucket, ExchangeTables), t_cap=md._exch_T,
        energy0=float(st.energy), forces0=st.forces.numpy(),
    )
    st = md.run_nve(st, REFRESH_STEPS)
    out["refresh"].update(
        energy=float(st.energy), coords=st.coords.numpy(), rebuilds=st.rebuilds,
        overflow=bool(st.overflow), exchange_after=isinstance(st.bucket, ExchangeTables),
    )

    # 3 waters of that box in its 20 A cell: 9 atoms padded to 12, so the
    # first process's rows are all dummies (they sort first)
    sp9, co9 = sp[:, :9], co[:, :9]
    v9 = torch.as_tensor(p["velocities"][:9])
    out["sparse"] = {}
    for name, md in (
        ("sharded", ShardedMolecularDynamics(models["ho"], sp9, mesh, cell=ce, device="cpu",
                                             **REFRESH_KW)),
        ("single", MolecularDynamics(models["ho"], sp9, cell=ce, device="cpu", **REFRESH_KW)),
    ):
        st = md.init(co9)
        v = torch.zeros_like(st.velocities)
        v[:9] = v9
        st = md.run_nve(st.replace(velocities=v), 5)
        out["sparse"][name] = dict(
            coords=st.coords.numpy(), forces=st.forces.numpy(), energy=float(st.energy),
            exchange=isinstance(st.bucket, ExchangeTables),
        )
        if name == "sharded":
            lo, hi = md._rows
            out["sparse"]["dummy_rows"] = bool((md.elem_idxs[0, lo:hi] < 0).all())

    try:
        ShardedMolecularDynamics(
            models["base"], sp, init_device_mesh("cpu", (2, 2)), cell=ce, pbc=True, device="cpu"
        )
        out["mesh_2d"] = "accepted"
    except ValueError as e:
        out["mesh_2d"] = str(e)
    return out


# ---------------------------------------------------------------------------
# this process: the references and the comparisons
# ---------------------------------------------------------------------------


def _leaves(tree):
    import jax

    return {
        jax.tree_util.keystr(p): np.asarray(x)
        for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


@pytest.fixture(scope="module")
def systems():
    from torchani_tpu_torch.testing import make_water_box

    sp, co, ce = make_water_box(48)
    sp49 = np.concatenate([sp, [[1]]], axis=1)
    co49 = np.concatenate([co, co[:, -1:, :] + np.array([1.5, 0.0, 0.0])], axis=1).astype(np.float32)
    return dict(box=(sp, co, ce), uneven=(sp49, co49),
                refresh_box=make_water_box(150, density_molec_per_a3=0.008))


@pytest.fixture(scope="module")
def runs(systems, tmp_path_factory):
    """The sharded runs (started first: they run while this process runs
    the references), JAX's single-device runs and the port's.  The 150-atom
    box starts from thermal velocities of a seeded generator, the same in
    every run."""
    import jax

    import torchani_tpu as tt
    from torchani_tpu.md import MolecularDynamics as JMD
    from torchani_tpu_torch.md import MolecularDynamics, maxwell_boltzmann_velocities
    from torchani_tpu_torch.utils import get_atomic_masses

    jmodels = {
        k: tt.simple_ani(kw["symbols"], **{n: v for n, v in kw.items() if n != "symbols"},
                         key=jax.random.PRNGKey(seed))
        for k, (kw, seed) in MODELS.items()
    }
    leaves = {k: _leaves(m) for k, m in jmodels.items()}
    rsp, rco, rce = systems["refresh_box"]
    velocities = maxwell_boltzmann_velocities(
        torch.Generator().manual_seed(4), get_atomic_masses(torch.as_tensor(rsp[0])), 300.0
    ).numpy()
    payload = dict(leaves=leaves, box=systems["box"], uneven=systems["uneven"],
                   refresh_box=systems["refresh_box"], velocities=velocities)
    started = spawn(_md_worker, WORLD, tmp_path_factory.mktemp("md"), payload)

    pmodels = {k: _port_model(MODELS[k][0], leaves[k]) for k in MODELS}
    sp, co, ce = systems["box"]
    jax_, port = {}, {}

    def both(key, name, species, coords, cell, steps=0, v=None, **kw):
        jmd = JMD(jmodels[key], species, cell=cell, nn_precision="highest", **kw)
        pmd = MolecularDynamics(pmodels[key], species, cell=cell, device="cpu", **kw)
        js, ps = jmd.init(coords), pmd.init(coords)
        if v is not None:
            js, ps = js.replace(velocities=jax.numpy.asarray(v)), ps.replace(velocities=torch.tensor(v))
        jax_[name] = dict(energy=float(js.energy), forces=np.asarray(js.forces))
        port[name] = dict(energy=float(ps.energy), forces=ps.forces.numpy())
        if steps:
            js, ps = jmd.run_nve(js, steps), pmd.run_nve(ps, steps)
            jax_[name].update(energy_end=float(js.energy), coords=np.asarray(js.coords),
                              forces_end=np.asarray(js.forces), rebuilds=int(js.rebuilds))
            port[name].update(energy_end=float(ps.energy), coords=ps.coords.numpy(),
                              forces_end=ps.forces.numpy(), rebuilds=ps.rebuilds)

    # in threads: the MD runs' compiles overlap
    with concurrent.futures.ThreadPoolExecutor(5) as pool:
        for f in [
            pool.submit(both, "base", "base", sp, co, ce, steps=5, **TRAJ_KW),
            pool.submit(both, "hetero", "hetero", sp, co, ce, pbc=True),
            pool.submit(both, "base", "uneven", *systems["uneven"], ce, pbc=True),
            pool.submit(both, "ho", "refresh", rsp, rco, rce, steps=REFRESH_STEPS, v=velocities,
                        **REFRESH_KW),
            pool.submit(both, "ho", "sparse", rsp[:, :9], rco[:, :9], rce, steps=5,
                        v=velocities[:9], **REFRESH_KW),
        ]:
            f.result()
    return jax_, port, join(started)


def test_sharded_forces_match_single_device(runs, systems):
    jax_, port, sharded = runs
    got = sharded[0]["base"]
    a = systems["box"][0].shape[1]
    assert got["atoms"] == a  # 48 atoms split evenly: no padding
    np.testing.assert_allclose(got["energy"], port["base"]["energy"], rtol=0, atol=2e-5)
    np.testing.assert_allclose(got["forces"], port["base"]["forces"], rtol=0, atol=2e-5)
    np.testing.assert_allclose(got["energy"], jax_["base"]["energy"], rtol=1e-6)
    np.testing.assert_allclose(got["forces"], jax_["base"]["forces"], rtol=0, atol=1e-5)


def test_sharded_trajectory_matches(runs):
    jax_, port, sharded = runs
    got = sharded[0]["traj"]
    for rank in sharded[1:]:
        np.testing.assert_array_equal(rank["traj"]["coords"], got["coords"])
    np.testing.assert_allclose(got["coords"], port["base"]["coords"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["energy"], port["base"]["energy_end"], rtol=0, atol=5e-5)
    np.testing.assert_allclose(got["coords"], jax_["base"]["coords"], rtol=0, atol=1e-4)


def test_sharded_hetero_potentials_match_single_device(runs):
    """xTB repulsion + D3 dispersion run replicated beside the sharded NNP."""
    jax_, port, sharded = runs
    got = sharded[0]["hetero"]
    np.testing.assert_allclose(got["energy"], port["hetero"]["energy"], rtol=0, atol=2e-5)
    np.testing.assert_allclose(got["forces"], port["hetero"]["forces"], rtol=0, atol=2e-5)
    np.testing.assert_allclose(got["energy"], jax_["hetero"]["energy"], rtol=1e-6)
    np.testing.assert_allclose(got["forces"], jax_["hetero"]["forces"], rtol=0, atol=1e-5)
    # the extra potentials contribute on the sharded path
    assert abs(got["energy_no_d3"] - got["energy"]) > 1e-6


def test_sharded_uneven_padding(runs):
    """49 atoms on 4 processes: padded to 52 with dummies."""
    jax_, port, sharded = runs
    got = sharded[0]["uneven"]
    assert got["atoms"] == 52
    np.testing.assert_allclose(got["energy"], port["uneven"]["energy"], rtol=0, atol=2e-5)
    np.testing.assert_allclose(got["forces"][:49], port["uneven"]["forces"], rtol=0, atol=2e-5)
    np.testing.assert_allclose(got["forces"][:49], jax_["uneven"]["forces"], rtol=0, atol=1e-5)
    # dummy padding rows feel no force
    assert np.abs(got["forces"][49:]).max() == 0.0


def test_sharded_refresh_matches_single_device(runs):
    """The domain-decomposed refresh: K1/K2's plain versions per bucket
    block and one all_to_all, through rebuilds."""
    jax_, port, sharded = runs
    got = sharded[0]["refresh"]
    assert got["exchange"] and got["exchange_after"], "sharded refresh engaged"
    a = port["refresh"]["forces"].shape[0]
    np.testing.assert_allclose(got["energy0"], port["refresh"]["energy"], rtol=0, atol=2e-5)
    np.testing.assert_allclose(got["forces0"][:a], port["refresh"]["forces"], rtol=0, atol=2e-5)
    np.testing.assert_allclose(got["forces0"][:a], jax_["refresh"]["forces"], rtol=0, atol=1e-5)
    assert got["rebuilds"] >= 1, "a rebuild must fire inside the sharded run"
    assert got["rebuilds"] == port["refresh"]["rebuilds"] == jax_["refresh"]["rebuilds"]
    assert not got["overflow"]
    for rank in sharded[1:]:
        np.testing.assert_array_equal(rank["refresh"]["coords"], got["coords"])
    np.testing.assert_allclose(got["coords"][:a], port["refresh"]["coords"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["energy"], port["refresh"]["energy_end"], rtol=0, atol=5e-5)
    np.testing.assert_allclose(got["coords"][:a], jax_["refresh"]["coords"], rtol=0, atol=1e-4)


def test_sharded_refresh_with_a_process_of_dummies(runs):
    """Every process runs the same collectives, also one whose rows are all
    dummies: 9 atoms on 4 processes, 5 steps through the sharded refresh,
    at the after-run tolerances against the port's single-device driver
    (energy atol 5e-5, coordinates atol 1e-4, forces atol 1e-4 as
    ``tests/test_torch_md.py`` after its steps) and against JAX's (the same
    coordinates and forces, energy rtol 1e-6)."""
    jax_ = runs[0]["sparse"]
    for rank, out in enumerate(runs[2]):
        got, want = out["sparse"]["sharded"], out["sparse"]["single"]
        assert out["sparse"]["dummy_rows"] == (rank == 0)
        assert got["exchange"] and not want["exchange"]
        np.testing.assert_allclose(got["energy"], want["energy"], rtol=0, atol=5e-5)
        np.testing.assert_allclose(got["forces"][:9], want["forces"], rtol=0, atol=1e-4)
        np.testing.assert_allclose(got["coords"][:9], want["coords"], rtol=0, atol=1e-4)
        assert np.abs(got["forces"][9:]).max() == 0.0
        np.testing.assert_allclose(got["energy"], jax_["energy_end"], rtol=1e-6)
        np.testing.assert_allclose(got["forces"][:9], jax_["forces_end"], rtol=0, atol=1e-4)
        np.testing.assert_allclose(got["coords"][:9], jax_["coords"], rtol=0, atol=1e-4)


def test_sharded_md_refuses_a_2d_mesh(runs):
    assert runs[2][0]["mesh_2d"] == "ShardedMolecularDynamics takes a 1D mesh"


# ---------------------------------------------------------------------------
# the slot-row helpers and the exchange maps, in process
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tables(systems):
    """The bucket tables of the 150-atom box's `MolecularDynamics` (3 x 3 x 3
    buckets), with seeded canonical coordinates."""
    from torchani_tpu_torch.arch import simple_ani
    from torchani_tpu_torch.md import MolecularDynamics

    sp, co, ce = systems["refresh_box"]
    model = simple_ani(("H", "O"), repulsion=False, device="cpu")
    md = MolecularDynamics(model, sp, cell=ce, device="cpu", **REFRESH_KW)
    st = md.init(co)
    rng = np.random.RandomState(0)
    canon = (st.coords[st.nbr_perm] - st.bucket.wrap_offset).numpy()
    canon = canon + rng.uniform(-0.1, 0.1, canon.shape).astype(np.float32)
    return st.bucket, canon, md.grid_shape, rng


def _jax_value_and_vjp(fn, x, cot):
    """``fn(x)`` and its vjp at ``cot``, jitted (one compile, where eager JAX
    dispatches each operation on its own)."""
    import jax

    def both(x, cot):
        y, vjp = jax.vjp(fn, x)
        return y, vjp(cot)[0]

    return tuple(np.asarray(t) for t in jax.jit(both)(x, cot))


def test_slot_row_helpers_match_jax(tables):
    import jax.numpy as jnp

    from torchani_tpu import bucket_refresh as jbr
    from torchani_tpu_torch import bucket_refresh as pbr

    bt, canon, grid, rng = tables
    g = int(np.prod(grid))
    c = bt.atom_of_slot.shape[0] // g
    k = bt.keys.shape[1] // c
    aos, soa, keys = (
        jnp.asarray(t.numpy().astype(np.int32)) for t in (bt.atom_of_slot, bt.slot_of_atom, bt.keys)
    )
    wrapshift = jnp.asarray(bt.wrapshift.numpy())
    nlanes = pbr._occupied_lanes(bt.atom_of_slot, canon.shape[0], g, c, k)

    # slot_positions: values and the gather transpose
    x = torch.tensor(canon, requires_grad=True)
    ppos = pbr.slot_positions(x, bt.atom_of_slot, bt.slot_of_atom)
    cot = rng.randn(*ppos.shape).astype(np.float32)
    jpos, jg = _jax_value_and_vjp(lambda z: jbr.slot_positions(z, aos, soa), canon, cot)
    np.testing.assert_array_equal(ppos.detach().numpy(), jpos)
    (pg,) = torch.autograd.grad(ppos, x, torch.as_tensor(cot))
    np.testing.assert_array_equal(pg.numpy(), jg)

    # cand_table_from_slots: JAX (G, 3, 27, C) against the port's (G, 27, C, 3)
    pb = torch.tensor(jpos, requires_grad=True)
    pc = pbr.cand_table_from_slots(pb, bt.wrapshift, grid, c)
    cot = rng.randn(*pc.shape).astype(np.float32)
    jc, jg = _jax_value_and_vjp(
        lambda z: jbr.cand_table_from_slots(z, wrapshift, grid, c), jpos, cot.transpose(0, 3, 1, 2)
    )
    np.testing.assert_array_equal(pc.detach().numpy(), jc.transpose(0, 2, 3, 1))
    (pg,) = torch.autograd.grad(pc, pb, torch.as_tensor(cot))
    np.testing.assert_allclose(pg.numpy(), jg, rtol=0, atol=1e-5)

    # select_slot_rows (K1 forward, K2 backward: their plain versions here)
    xc = pc.detach().clone().requires_grad_(True)
    pr = pbr.select_slot_rows(xc, bt.keys, nlanes)
    assert pr.shape == (g * c, k * 3)
    cot = rng.randn(*pr.shape).astype(np.float32)
    jr, jg = _jax_value_and_vjp(
        lambda z: jbr.select_slot_rows(z, keys, jnp.asarray(nlanes.numpy())), jc, cot
    )
    np.testing.assert_array_equal(pr.detach().numpy(), jr)
    (pg,) = torch.autograd.grad(pr, xc, torch.as_tensor(cot))
    np.testing.assert_allclose(pg.numpy(), jg.transpose(0, 2, 3, 1), rtol=0, atol=1e-5)

    # the three together are bucket_nbr_pos' slot rows
    nbr = pbr.bucket_nbr_pos(torch.as_tensor(canon), bt.keys, bt.atom_of_slot,
                             bt.slot_of_atom, bt.wrapshift)
    rows = pr.detach().reshape(g * c, k, 3)
    has = bt.slot_of_atom >= 0
    np.testing.assert_array_equal(rows[bt.slot_of_atom[has]].numpy(), nbr[has].numpy())


@pytest.mark.parametrize("d", [2, 4, 8])
def test_exchange_maps_match_jax(tables, d):
    import jax
    import jax.numpy as jnp

    from torchani_tpu.parallel.md import _exchange_maps as jmaps
    from torchani_tpu_torch.parallel.md import _exchange_maps

    bt, _, grid, _ = tables
    g = int(np.prod(grid))
    c = bt.atom_of_slot.shape[0] // g
    gpc = -(-g // d) * d * c
    soa = bt.slot_of_atom
    soa = torch.cat([soa, soa.new_full(((-soa.shape[0]) % d,), -1)])  # dummies at the end
    # the capacity `ShardedMolecularDynamics.init` measures, and one too small
    a = soa.shape[0]
    valid = soa >= 0
    per = gpc // d
    pair = (torch.arange(a)[valid] // (a // d)) * d + torch.clamp(soa[valid] // per, max=d - 1)
    most = int(torch.bincount(pair).max())
    for t_cap, overflows in ((most, False), (most - 1, True)):
        ours = _exchange_maps(soa, d, t_cap, gpc)
        theirs = jax.jit(jmaps, static_argnums=(1, 2, 3))(
            jnp.asarray(soa.numpy().astype(np.int32)), d, t_cap, gpc
        )
        assert bool(ours[4]) == bool(theirs[4]) == overflows
        if not overflows:
            for o, t in zip(ours[:4], theirs[:4]):
                np.testing.assert_array_equal(o.numpy(), np.asarray(t))
