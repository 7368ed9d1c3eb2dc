"""PyTorch port: molecular dynamics of a model with several potentials (the
networks, xTB repulsion, D3 dispersion) against the JAX package, on the CPU.

The system is a 375-atom water box at liquid density (15.5 A, a 3 x 3 x 3
bucket grid) under a `simple_ani`-style model cut to size: radial cutoff 3.2
A, angular 2.6 A, repulsion at 3.2 A and D3 dispersion at 4.6 A, skin 0.4 A.
The dispersion sets the build radius, so the networks and the repulsion run
on static prefixes of the distance-sorted lanes, the bucket tables ride on
the refreshed table (`select_tables`), and D3 selects its neighbors' values
through `bucket_lane_values`.  Three runs: the default, the frozen pair
window (``freeze_pair_window``) and the atom-packed refresh.

Tolerances: `init` forces against single point atol 1e-5 Ha/A (energy rtol
1e-6); against the JAX class the same; frozen against unfrozen forces atol
1e-5 Ha/A; packed against slot forces atol 1e-6; after 8 steps from the JAX
run's cached topology coordinates atol 1e-4 A and forces atol 1e-4 Ha/A.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchani_tpu.aev.terms import ANIAngular as JAngular
from torchani_tpu.aev.terms import ANIRadial as JRadial
from torchani_tpu.arch import Assembler as JAssembler
from torchani_tpu.md import MolecularDynamics as JMolecularDynamics
from torchani_tpu.potentials.dispersion import TwoBodyDispersionD3 as JD3
from torchani_tpu.potentials.repulsion import RepulsionXTB as JXTB
from torchani_tpu_torch.aev.terms import ANIAngular, ANIRadial
from torchani_tpu_torch.arch import Assembler
from torchani_tpu_torch.bucket_refresh import BucketTables
from torchani_tpu_torch.bucket_refresh_packed import PackedTables
from torchani_tpu_torch.grad import energies_and_forces
from torchani_tpu_torch.interop import load_jax_arrays, load_jax_md_state
from torchani_tpu_torch.md import CachedSinglePoint, MolecularDynamics, _refresh_neighbors
from torchani_tpu_torch.neighbors import CellList
from torchani_tpu_torch.potentials import RepulsionXTB, TwoBodyDispersionD3
from torchani_tpu_torch.testing import make_water_box

torch.set_num_threads(2)
CPU = "cpu"
SYM = ("H", "O")
STEPS = 8
MD_KW = dict(pbc=True, timestep_fs=0.25, skin=0.4)
RADIAL = dict(start=0.9, cutoff=3.2, eta=19.7, num_shifts=8, cutoff_fn="smooth")
ANGULAR = dict(
    start=0.9, cutoff=2.6, eta=12.5, zeta=14.1, num_shifts=4, num_sections=4, cutoff_fn="smooth"
)
D3_CUTOFF = 4.6
VARIANTS = {
    "default": {},
    "frozen": dict(freeze_pair_window=("dispersion_d3",)),
    "packed": dict(bucket_refresh="packed"),
}


def _leaves(tree):
    return {
        jax.tree_util.keystr(p): np.asarray(x)
        for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


def _assemble(asm, radial, angular, xtb, d3):
    asm.set_symbols(SYM)
    asm.set_global_cutoff_fn("smooth")
    asm.set_aev_computer(radial=radial, angular=angular)
    asm.set_atomic_networks(ctor="ani2x", activation="gelu", bias=False)
    asm.set_gsaes_as_self_energies("wb97x-631gd")
    asm.set_neighborlist("cell_list")
    asm.add_potential("repulsion_xtb", xtb)
    asm.add_potential("dispersion_d3", d3)
    return asm


@pytest.fixture(scope="module")
def both_models():
    jmodel = _assemble(
        JAssembler(), JRadial.cover_linearly(**RADIAL), JAngular.cover_linearly(**ANGULAR),
        JXTB.make(SYM, cutoff=RADIAL["cutoff"], cutoff_fn="smooth"),
        JD3.make(SYM, functional="wb97x", cutoff=D3_CUTOFF),
    ).assemble(1)
    pmodel = _assemble(
        Assembler(),
        lambda dev: ANIRadial.cover_linearly(**RADIAL, device=dev),
        lambda dev: ANIAngular.cover_linearly(**ANGULAR, device=dev),
        RepulsionXTB(SYM, cutoff=RADIAL["cutoff"], cutoff_fn="smooth", device=CPU),
        lambda dev: TwoBodyDispersionD3(SYM, functional="wb97x", cutoff=D3_CUTOFF, device=dev),
    ).assemble(1, device=CPU)
    return jmodel, load_jax_arrays(pmodel, _leaves(jmodel))


@pytest.fixture(scope="module")
def box():
    species, coords, cell = make_water_box(375)
    velocities = (np.random.RandomState(4).randn(species.shape[1], 3) * 0.004).astype(np.float32)
    return species, coords, cell, velocities


@pytest.fixture(scope="module")
def single_point(both_models, box):
    _, pmodel = both_models
    species, coords, cell, _ = box
    return energies_and_forces(pmodel, species, coords, cell, np.ones(3, dtype=bool))


@pytest.fixture(scope="module")
def port_runs(both_models, box):
    """The port's `MolecularDynamics` three ways, each with its `init` state."""
    _, pmodel = both_models
    species, coords, cell, _ = box
    runs = {}
    for name, kw in VARIANTS.items():
        md = MolecularDynamics(pmodel, species, cell=cell, device=CPU, **MD_KW, **kw)
        runs[name] = (md, md.init(coords))
    return runs


@pytest.fixture(scope="module")
def jax_runs(both_models, box):
    """The JAX `MolecularDynamics` once each way: `init`, then 8 NVE steps from numpy
    velocities (``nn_precision="highest"``: the port evaluates in full f32)."""
    jmodel, _ = both_models
    species, coords, cell, velocities = box
    runs = {}
    for name, kw in VARIANTS.items():
        jmd = JMolecularDynamics(
            jmodel, species, cell=cell, nn_precision="highest", **MD_KW, **kw
        )
        start = jmd.init(coords).replace(velocities=jnp.asarray(velocities))
        runs[name] = (jmd, start, jmd.run_nve(start, STEPS))
    return runs


def test_the_runs_engage_what_they_test(port_runs, jax_runs):
    md, state = port_runs["default"]
    jmd = jax_runs["default"][0]
    assert md.cutoff == D3_CUTOFF and md.grid_shape == jmd.grid_shape == (3, 3, 3)
    assert md.capacity == jmd.capacity and md._bucket_c == jmd._bucket_c
    assert md._lane_prefixes == jmd._lane_prefixes
    assert set(md._lane_prefixes) == {"nnp", "repulsion_xtb"}
    assert max(md._lane_prefixes.values()) < md.capacity, "the prefixes must cut lanes"
    assert md._prefix_checks == jmd._prefix_checks
    assert md._ang_prefix == jmd._ang_prefix and md._ang_prefix is not None
    assert isinstance(state.bucket, BucketTables) and state.pair_aux is None
    nb = _refresh_neighbors(state, state.coords)
    assert nb.select_tables is state.bucket, "D3 must select through the bucket tables"
    fmd, fstate = port_runs["frozen"]
    assert fmd._freeze_pair == ("dispersion_d3",)
    assert fstate.pair_aux["dispersion_d3"].shape == tuple(fstate.nbr_idx.shape) + (33,)
    pmd, pstate = port_runs["packed"]
    assert pmd._bucket_span == jax_runs["packed"][0]._bucket_span
    assert isinstance(pstate.bucket, PackedTables)
    assert _refresh_neighbors(pstate, pstate.coords).select_tables is None
    for _, st in port_runs.values():
        assert not bool(st.overflow)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_init_matches_single_point_and_jax(variant, port_runs, jax_runs, single_point):
    _, state = port_runs[variant]
    e, f = single_point
    np.testing.assert_allclose(state.forces.numpy(), f[0].numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(state.energy), float(e[0]), rtol=1e-6)
    jstart = jax_runs[variant][1]
    assert not bool(jstart.overflow)
    np.testing.assert_allclose(state.forces.numpy(), np.asarray(jstart.forces), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(state.energy), float(jstart.energy), rtol=1e-6)
    # the same lane sets, up to the order of lanes whose distances tie
    np.testing.assert_array_equal(state.nbr_mask.numpy(), np.asarray(jstart.nbr_mask))
    np.testing.assert_array_equal(
        np.sort(state.nbr_idx.numpy(), axis=1), np.sort(np.asarray(jstart.nbr_idx), axis=1)
    )


def test_frozen_and_packed_forces_equal_the_default_runs(port_runs):
    """The frozen window is exact (atol 1e-5 Ha/A), and the packed refresh
    selects the same positions as the slot refresh (atol 1e-6)."""
    ref = port_runs["default"][1]
    frozen, packed = port_runs["frozen"][1], port_runs["packed"][1]
    np.testing.assert_allclose(frozen.forces.numpy(), ref.forces.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(frozen.energy), float(ref.energy), rtol=1e-6)
    np.testing.assert_allclose(packed.forces.numpy(), ref.forces.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(float(packed.energy), float(ref.energy), rtol=1e-6)


def test_prefix_dispatch_matches_full_table(both_models, box, port_runs):
    """Every potential on the full lane table gives the energies and forces of
    the per-potential prefixes (atol 1e-5 Ha/A)."""
    _, pmodel = both_models
    species, coords, cell, _ = box
    full = MolecularDynamics(pmodel, species, cell=cell, device=CPU, **MD_KW)
    full._lane_prefixes, full._prefix_checks = {}, []
    state = full.init(coords)
    ref = port_runs["default"][1]
    assert not bool(state.overflow)
    np.testing.assert_allclose(state.forces.numpy(), ref.forces.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(state.energy), float(ref.energy), rtol=1e-6)


def test_a_violated_prefix_bound_sets_overflow(both_models, box):
    _, pmodel = both_models
    species, coords, cell, _ = box
    md = MolecularDynamics(pmodel, species, cell=cell, device=CPU, **MD_KW)
    md._prefix_checks = [(r, 2) for r, _ in md._prefix_checks]
    assert bool(md.init(coords).overflow)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_nve_from_bridged_state_matches_jax(variant, port_runs, jax_runs):
    """The port on the JAX run's cached topology, lane for lane: the state
    bridge carries the bucket tables of either layout and ``pair_aux``."""
    md, _ = port_runs[variant]
    _, jstart, jend = jax_runs[variant]
    start = load_jax_md_state(_leaves(jstart), CPU)
    assert type(start.bucket).__name__ == type(jstart.bucket).__name__
    assert (start.pair_aux is None) == (jstart.pair_aux is None)
    end = md.run_nve(start, STEPS)
    assert end.step == int(jend.step) == STEPS and end.rebuilds == int(jend.rebuilds)
    assert not bool(end.overflow) and not bool(jend.overflow)
    np.testing.assert_allclose(end.coords.numpy(), np.asarray(jend.coords), atol=1e-4, rtol=0)
    np.testing.assert_allclose(end.forces.numpy(), np.asarray(jend.forces), atol=1e-4, rtol=0)
    np.testing.assert_allclose(float(end.energy), float(jend.energy), rtol=1e-6)


def test_bridged_tables_equal_the_ports_own(port_runs, jax_runs):
    """`frozen_window_channels` and `pack_tables` at `init` give what the JAX
    class gives, up to the order of tied lanes (channels compared as sorted
    per-row sums; packed tables by shape and occupied rows)."""
    fstate = port_runs["frozen"][1]
    jaux = np.asarray(jax_runs["frozen"][1].pair_aux["dispersion_d3"])
    aux = fstate.pair_aux["dispersion_d3"].numpy()
    assert aux.shape == jaux.shape
    np.testing.assert_allclose(
        np.sort(aux.sum(-1), axis=1), np.sort(jaux.sum(-1), axis=1), rtol=1e-6
    )
    pt, jpt = port_runs["packed"][1].bucket, jax_runs["packed"][1].bucket
    for name in ("keys_flat", "tile_bucket", "atom_of_row", "row_of_atom"):
        assert tuple(getattr(pt, name).shape) == tuple(getattr(jpt, name).shape), name
    for name in ("tile_bucket", "atom_of_row", "row_of_atom"):
        np.testing.assert_array_equal(getattr(pt, name).numpy(), np.asarray(getattr(jpt, name)))


def test_rebuild_keeps_forces_and_refreshes_the_channels(both_models, port_runs):
    _, pmodel = both_models
    md, state = port_runs["frozen"]
    moved = md.step_nve(state.replace(ref_coords=state.ref_coords + 1.0))
    assert moved.rebuilds == state.rebuilds + 1 and not bool(moved.overflow)
    assert moved.pair_aux["dispersion_d3"] is not state.pair_aux["dispersion_d3"]
    species = md.species.numpy()
    _, f = energies_and_forces(
        pmodel, species, moved.coords[None], md.cell, np.ones(3, dtype=bool)
    )
    np.testing.assert_allclose(moved.forces.numpy(), f[0].numpy(), atol=1e-4, rtol=0)


def test_cached_single_point_with_several_potentials(both_models, box, single_point):
    _, pmodel = both_models
    species, coords, cell, _ = box
    sp = CachedSinglePoint(
        pmodel, species, cell=cell, pbc=True, skin=0.4,
        freeze_pair_window=("dispersion_d3",), device=CPU,
    )
    e, f = sp(coords)
    np.testing.assert_allclose(f.numpy(), single_point[1][0].numpy(), atol=1e-5, rtol=0)
    noise = np.random.RandomState(9).randn(*coords[0].shape).astype(np.float32) * 0.01
    e2, f2 = sp(coords[0] + noise)
    _, f_ref = energies_and_forces(
        pmodel, species, (coords[0] + noise)[None], cell, np.ones(3, dtype=bool)
    )
    assert not sp.overflow and sp._state.rebuilds == 0
    np.testing.assert_allclose(f2.numpy(), f_ref[0].numpy(), atol=1e-5, rtol=0)


def test_forces_stay_finite_with_a_dummy_and_a_lone_atom(both_models):
    """A box with a padding atom (masked lanes only) and a molecule far from
    every other: D3's guarded quotient gives finite forces, exact zeros on
    the padding atom."""
    _, pmodel = both_models
    species, coords, cell = make_water_box(375)
    species = np.concatenate([species, [[-1]]], axis=1)
    coords = np.concatenate([coords, [[[1.0, 1.0, 1.0]]]], axis=1).astype(np.float32)
    md = MolecularDynamics(pmodel, species, cell=cell, device=CPU, **MD_KW)
    state = md.init(coords)
    assert _refresh_neighbors(state, state.coords).select_tables is not None
    assert torch.isfinite(state.forces).all() and torch.isfinite(state.energy)
    assert (state.forces[-1] == 0).all()
    state = md.run_nve(state, 2)
    assert torch.isfinite(state.forces).all() and not bool(state.overflow)
    iso = np.array([[8, 1, 1, 8]])
    xyz = np.array([[[0, 0, 0.12], [0, 0.76, -0.48], [0, -0.76, -0.48], [30.0, 30.0, 30.0]]])
    e, f = energies_and_forces(pmodel, iso, xyz.astype(np.float32))
    assert torch.isfinite(f).all() and (f[0, 3] == 0).all()
