#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``torchani_tpu_torch``).

Run from the root of a checkout, on a machine with one NVIDIA GPU::

    python3 chip_smoke.py

In order: prints the card, builds every CUDA kernel from ``csrc/`` (one
``nvcc`` per source, all at once), holds each kernel against its plain
PyTorch version on the card (K3, the fused angular AEV, and K3b, its
backward, on contiguous and column-sliced cotangents, with K3b's persistent
grid printed; K1 and K2, the bucket refresh's selection and its transpose,
with K1's split S and K2's cluster split S, blocks, threads and shared
memory printed), runs ANI-2x energies and
forces on the 10,002-atom periodic water box through the public entry points
(counting kernel launches), compares the card with the CPU on a ~1,000-atom
box, then drives the MD main path: `MolecularDynamics` with its defaults,
`init` at 300 K and 50 NVE steps on the 10,002-atom box (launch counts,
energy drift), a forced neighbor rebuild, MD forces against single-point
forces, 10 MD steps on the card against the CPU, and `CachedSinglePoint`.
It times E+F, the MD step, a rebuild, each kernel, its plain version and the
PyTorch call that computes the same function (for K3b also the blocked
autograd recompute of the plain forward that it replaced), and the bucket
refresh against the gather refresh, with the card's SM clock beside the
kernels' times.  On every main path K3 and K3b launch once per evaluation
and the plain angular grid is never built.  Then the ANI-2dr paths
(networks, xTB repulsion and D3 dispersion): K4f and K4b (the per-lane
selection of runtime values, at P = 1 and P = 5 channels; K4b's launch
shape printed as K2's), K5f and K5b (the atom-packed refresh; their split S,
blocks, threads and shared memory printed at the box's tables and at
C = 256, where hand-made tables check them too) and K1 and K2 against their
plain versions at the ANI-2dr box's own tables, with their times, bounds,
plain versions and library calls; ANI-2dr energies and forces on the same
box; `MolecularDynamics` under ANI-2dr three ways (its defaults, the frozen
pair window, the atom-packed refresh), each with `init` at 300 K, NVE steps,
launch counts, energy drift, MD forces against single-point forces, a forced
rebuild, frozen and packed forces against the default run's, and each
backward kernel launched once per evaluation; and the
card against the CPU on a 2,001-atom box.  Then ANI-1x (8 members, HCNO, AEV
of 384): the card against the CPU, K3 and K3b at the model's own 4 x 8
tables against their plain versions, E+F on the 10,002-atom box (one K3 and
one K3b launch), Langevin with no friction against NVE, and a thermostatted
Langevin run (K1, K2, K3 and K3b once per step); ANI-2dr under
`MultipleTimestepMD` (every 4 inner steps of 0.25 fs, Langevin 0.1/fs): per
outer step 4 launches of K3 and K3b and 4 of K1 and K2 on the fast lane, 1 of
K1, K2, K4f and K4b (P = 1, the frozen D3 window) on the slow lane, every=1
against velocity Verlet, the card against the CPU; and a model written in
the published key scheme (`convert.save_state_dict`, `torch.save`) into a
temporary data directory and loaded back with ``pretrained=True``.  Then the
second-derivative and ensemble paths of ANI-2x: K3bb (K3b's backward)
against its plain version at the water box's tables and at those of one
Hessian pass, with its persistent grid, time, plain time and bound at both;
`hessians` and `single_point(vibrational=True)` of a 30-water cluster (per
pass one K3 and one K3bb launch and two of K3b), card against CPU; the
Hessian of ANI-2dr under `cell_list` (a neighbor list that takes a single
system) on 9 atoms in a periodic cell, with the same launches per pass,
card against CPU; `members_energies_and_forces`,
`force_qbc`, `stress_scaling` and `stress_fdotr` on the water box (one K3
launch, one K3b per member or one), card against CPU at 1,002 atoms; and 20
steps each of `run_nvt_nose_hoover` and `run_npt_berendsen`
(``npt_compression=0.05``) on the water box (K1, K2, K3 and K3b once per
step), card against CPU at 1,002 atoms.  Then the tools on top of MD and
the user surface, each with its launch counts: `trajectory` (50 NVE steps
of the box, a frame every 10, from the main path's start, against
`run_nve`, alternating; 20 NHC and 20 NPT steps, a frame every 5, against
their runs); the O-O RDF of those frames (its peak device memory, card
against CPU: per-bin counts equal but for pairs at a bin edge), MSD and the
diffusion coefficient; `minimize_fire` on the 30-water cluster and
`minimize_fire_batched` on 64 perturbations of it (30 iterations each, host
syncs per iteration counted in CUDA's sync debug mode, card against CPU
after 10); `neb_path` over 9 images (endpoints fixed to the bit); replica
exchange of 8 replicas of the cluster at 280-420 K (5 segments of 10
steps, card against CPU over one segment with one CPU generator, a ladder
of equal temperatures accepting every swap); and `cli.main` in process:
`sp -f` of the box from an xyz file, `md --nvt-nhc --traj` (4 frames read
back), `opt` of a 4-conformer file.  Then the charge models, the remaining
pair potentials and the rest of the model zoo: K3, K3b and K3bb at
SnnANI2xr's tables (6 angular sections, Z = 48 terms a species pair) on the
box against their plain versions, with times, bounds, launch shapes and
shared memory; ANI-mbis E+F (one K3 and one K3b, the charge networks never
run, counted with a forward hook) and `energies_and_charges` at total
charge 0 and +1 (one K3 each; the charges sum to the total within the
rounding of an f32 sum), `compute_dipole` and `DipoleComputer`, card
against CPU at 1,002 atoms, its times beside ANI-2x's E+F; 10 NVE steps of
ANI-mbis from the ANI-2x MD phase's start (K1 = K2 = K3 = K3b = 10, no
charge network), on ANI-2x's trajectory; SnnANI2xr E+F (time, peak memory,
card against CPU); ANI-r2s in water, chloroform, acetonitrile and vacuum on
the 90-atom cluster (all pairs), card against CPU; Lennard-Jones, its
repulsive and dispersive halves, fixed Coulomb and MNOK alone on the cluster
and on the box at 8 A, card against CPU, and `pair_curves`; and 10 NVE steps
of ANI-2x + Lennard-Jones (8 A, TIP3P's O-O parameters) through
`Assembler.add_potential`, the networks on a lane prefix.  Then the data
and training path (phases 41-45, `training_phases`): a Zarr store of three
TestData-style groups read back, regrouped by atom count, checksummed;
`create_batched_dataset` with angular-capacity buckets read back, self
energies fitted by `exact_saes` and subtracted, ``cli data ls|info|pack|
verify`` in process, and a force-training epoch over the batches from
pinned memory through `make_bucketed_train_step` (K3, K3b, K3bb once a
batch); the repo's training configuration (tools/training_benchmark.py:
ANI-1x-width `simple_ani`, a batch of 2,560 molecules of up to 26 atoms)
with the force loss and with energies only (ms per step, samples/s, exact
launches, host syncs, peak memory, device busy share and K3/K3b/K3bb's
time inside the step), `tune_angular_capacity`'s pick timed beside the full
table, K3, K3b and K3bb against their plain versions at that batch's
tables; the weight gradients and three losses card against CPU on 64
conformers; the 8-member ANI-2x ensemble trained with the force loss;
and `EpochRunner` over teacher-labelled chain molecules (the validation
RMSE must fall below 0.8 of its start in 5 epochs; one read of the loss an
epoch), a checkpoint at epoch 2 resumed in a fresh runner against 4
uninterrupted epochs, and the checkpoint loaded onto the CPU.  Then phases
46-49 (`loader_phases`): ANI-2x (8 members, seed 0) written as a NeuroChem
model directory and loaded back by `neurochem.load_model_from_info` (every
stack bit for bit, E+F on the box against the source model with one K3 and
one K3b, load time, E+F beside the source's, peak memory; member 0 alone and
through `load_atomic_networks`); an ANI-1x member through
`modules_from_info_file` (K3 at 4 x 8); `make_molecs(2560, 26)` with a
teacher's labels through the legacy chain (`species_to_indices`,
`subtract_self_energies`, `shuffle`, `cache`, `collate`,
`Transformations.pin_memory`; the same molecules through `datasets`), then
force training steps in ``revrev`` and ``fwdrev`` modes (gradients and
losses against each other, one K3, K3b and K3bb a step, ms, samples/s, host
syncs, peak memory); and a chain solute solvated by
`testing.make_solvated_system` from PDB files written here (E+F, 10 NVE
steps with their launches, `profiling.Timer` beside CUDA events,
`profiling.trace` naming a `scope` and K3, `utils.exact_matmul` against an
f64 product).  Then phases 50-52 (`parallel_phases`, ANI-2x seed 0 at full
width): `parallel.ShardedMolecularDynamics` on the 10,002-atom box with the
domain-decomposed refresh, on an NCCL group of this one process (50) and on
a gloo group of two processes that it spawns on the one card (51): `init`
and 10 NVE steps against `MolecularDynamics`, K1, K2, K3 and K3b once a
step on each process, K1 and K2 at each process's block of buckets against
their plain versions, the exchange capacity and the rows each process
sends; and the sharded training step (`make_mesh`, `shard_batch`,
`shard_ensemble`, the unchanged `make_train_step`, SGD, phase 42's batch)
as 1 x 1 on NCCL and 1 data x 2 model on gloo against the unsharded step,
K3, K3b and K3bb once a step on each process.  The card is one H100, so
these phases time nothing as scaling.  Then phase 53 (`higher_order_phases`):
third derivatives of ANI-2x on the 30-water cluster and the weight gradient
of a Hessian-vector loss, card against CPU, with exact launches (the third
pass differentiates a plain recompute, one `angular_grid` call a block),
then a third derivative of the 10,002-atom box (blocks, time, memory);
and phase 54 (`xyz_phases`): the native xyz parser must build, and 20
frames of the box go through `write_xyz` and both `read_xyz` routes, bit
for bit, with E+F of a frame read back; and phase 55 (`triclinic_phases`):
ANI-2x MD on the 10,002-atom box with its cell sheared (b += 0.2 a, c +=
0.1 a + 0.15 b), 10 NVE steps through each refresh (gather, slot-row with
K1 and K2, atom-packed with K5f and K5b) with exact launches, the four
refresh kernels against their plain versions at the sheared tables, and the
slot and packed coordinates against the gather run's.  Then phase 56
(`radial_phases`): K6, K6b and K6bb, the radial AEV's kernels, once an E+F
(2,560 chain molecules of up to 60 atoms, the E+F cell's shape), once a
step of NVE on the 59,049-atom box (the MD cell's), K6bb once a force
training step and in a Hessian; each kernel against its plain version at
the E+F and MD tables, its ms beside its bound and the plain version's, the
memory a call allocates (its outputs only), and E+F and the MD step against
the plain radial sums (ms, peak memory, forces, coordinates).  Every number it
prints was measured or computed in the run.  It prints a ``kernels`` JSON
line (all twelve kernels; K3, K3b and K3bb also at the training batch; K1 and
K2 also at the shards' buckets; K1, K2, K5f and K5b also at the sheared
box's tables) and,
last, ``{"ok": true, "device": {...}}``.  Any failed check raises, and the script exits non-zero without that last line; so does
a machine with no CUDA device, or a directory without the package.  A few
minutes of command time on an H100.
"""

import contextlib
import io as io_mod
import json
import os
import subprocess
import sys
import tempfile
import time
import typing as tp
import warnings

import numpy as np
import torch

#: H100 SXM peaks (NVIDIA data sheet, dense, 700 W): non-tensor f32 and HBM
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
#: special-function instructions (exp2, log2, rcp, rsqrt, sin, cos): 16 a
#: clock on each of the 132 SMs (CUDA programming guide, compute capability
#: 9.0) at the 1,980 MHz boost clock that the f32 peak assumes
PEAK_SFU_OPS = 132 * 16 * 1.98e9
#: kernel vs plain version on the card: |k - p| <= ATOL + RTOL |p| (f32 sums
#: taken in another order, as in tests/test_pallas.py).  K3b: |k - p| <=
#: ATOL max|p| + RTOL |p| (its sums run over shared-memory atomics), and
#: exact zeros on masked lanes
ATOL, RTOL = 1e-5, 1e-4
#: card vs CPU, same model from the same seed: forces and atomic energies
#: (f32 sums over ~100 neighbours and 8 members taken in another order)
FORCE_ATOL, ATOMIC_E_ATOL = 1e-5, 5e-5
#: K2 vs its plain version: |k - p| <= K2_TOL (1 + |p|); the kernel sums with
#: atomics in shared memory, in an order that changes from run to run.  K1 is
#: a selection and must differ by exactly 0.
K2_TOL = 1e-5
#: MD steps of the main path, and of each timed stretch after it
MD_STEPS = 50
#: the same for each of the three ANI-2dr runs.  Under random weights the
#: ANI-2dr box heats faster than the ANI-2x one: between steps 20 and 25 an
#: atom gathers more angular neighbors than the AEV's capacity of 28 holds and
#: the AEV poisons the forces with NaN, as designed; the stretches stay short
DR_STEPS = 10
#: K4b and K5b vs their plain versions, as K2; K4f and K5f are selections
#: and must differ by exactly 0.  The frozen pair window is exact and the
#: packed refresh selects the same positions: forces within FORCE_ATOL of the
#: default run's.
SUM_TOL = K2_TOL
#: after a rebuild, MD forces vs one-shot E+F forces at the same coordinates;
#: card vs CPU after 10 MD steps (rounding grows along a trajectory)
REBUILD_FORCE_ATOL = 1e-4
MD_COORD_ATOL, MD_FORCE_ATOL = 1e-4, 1e-4
#: ANI-1x Langevin: steps and friction of the timed run (1 fs); without
#: friction BAOAB is velocity Verlet: coordinates within LANGEVIN_NVE_ATOL of
#: `run_nve`'s after 10 steps (K3b's shared-memory sums may round forces
#: differently from one launch to the next)
X1_STEPS, X1_FRICTION = 20, 0.1
LANGEVIN_NVE_ATOL = 1e-5
#: ANI-2dr under `MultipleTimestepMD`: the JAX bench's equilibration
#: settings (every 4 inner steps of 0.25 fs, Langevin friction 0.1/fs), and
#: the outer steps run.  every = 1 against velocity Verlet at the tolerance
#: of tests/test_md_mts.py: |dx| <= 2e-6 + 2e-5 |x|, |dE| <= 1e-5 (1 + |E|)
MTS_EVERY, MTS_DT, MTS_FRICTION, MTS_OUTER = 4, 0.25, 0.1, 10
MTS_COORD_ATOL, MTS_COORD_RTOL, MTS_E_TOL = 2e-6, 2e-5, 1e-5
#: a model saved in the published key scheme and loaded back: the same
#: weights on the same card
PRETRAINED_FORCE_ATOL = 1e-6
#: Hessians of the 30-water cluster, card against CPU: the tolerance of
#: tests/test_grad.py against the goldens
HESSIAN_ATOL, HESSIAN_RTOL = 2e-4, 1e-3
#: members' forces and stress (scaled by max|ref|), card against CPU
STRESS_TOL = 1e-5
#: the Nose-Hoover and Berendsen NPT runs: steps, thermostat and barostat
#: settings (the JAX package's defaults, water's compressibility)
THERMO_STEPS, NHC_TAU_FS, NPT_COMPRESSION = 20, 25.0, 0.05
#: `trajectory`: a frame every TRAJ_EVERY of the MD_STEPS NVE steps, every
#: THERMO_EVERY of the THERMO_STEPS Nose-Hoover and NPT steps
TRAJ_EVERY, THERMO_EVERY = 10, 5
#: the O-O RDF of the NVE frames; card against CPU: per-bin counts equal but
#: for pairs within RDF_EDGE_TOL A of a bin edge (tests/test_torch_observables.py)
RDF_RMAX, RDF_BINS, RDF_EDGE_TOL = 8.0, 100, 1e-5
#: FIRE and NEB on the 30-water cluster: iterations (under an unreachable
#: fmax), conformers of the batch and their seeded perturbation (A), images
FIRE_ITERS, FIRE_CONFS, FIRE_SIGMA, NEB_IMAGES = 30, 64, 0.05, 9
#: replica exchange of the cluster: replicas (280-420 K, geometric),
#: segments and Langevin steps a segment
REPLICAS, REX_SEGMENTS, REX_STEPS = 8, 5, 10
#: ANI-mbis: charges card against CPU (e), and the total charge on the box
#: within CHARGE_SUM_ATOL plus the worst-case rounding of a pairwise f32 sum
#: of its atoms (2 log2(N) F32_EPS sum |q|; F32_EPS is f32's unit roundoff)
CHARGE_ATOL, CHARGE_SUM_ATOL, F32_EPS = 1e-5, 1e-5, 2.0**-24
#: the pair potentials on the box (smooth envelope) and in ANI-2x + LJ MD:
#: cutoff (A); card against CPU |k - c| <= PAIR_TOL (1 + |c|) (f32 sums over
#: ~300 lanes and the powers x^12, x^6 in another order)
PAIR_CUTOFF, PAIR_TOL = 8.0, 1e-5
#: fixed charges (e) of TIP3P water on the ANI-2x elements (H, C, N, O, S, F,
#: Cl); and TIP3P's Lennard-Jones (O-O only: the hydrogens carry no eps; the
#: other elements at the JAX package's defaults), eps in kcal/mol, sigma in A
WATER_CHARGES = (0.417, 0.0, 0.0, -0.834, 0.0, 0.0, 0.0)
TIP3P_EPS_KCAL = (0.0, 0.1, 0.1, 0.1521, 0.1, 0.1, 0.1)
TIP3P_SIGMA = (1.5, 1.5, 1.5, 3.1507, 1.5, 1.5, 1.5)

#: training (phases 41-45).  The repo's training configuration
#: (tools/training_benchmark.py:64-77): ANI-1x-width `simple_ani` over HCNO
#: without repulsion or self energies, a batch of `make_molecs(2560, 26)`;
#: AdamW at TRAIN_LR; TRAIN_WARMUP steps, then TRAIN_STEPS timed ones
TRAIN_BATCH, TRAIN_ATOMS, TRAIN_LR, TRAIN_WARMUP, TRAIN_STEPS = 2560, 26, 1e-3, 2, 10
#: card against CPU on the first TRAIN_CPU conformers: the weight gradients
#: of one force step at the tolerance of tests/test_torch_grad.py:299
#: (|k - c| <= 1e-5 max|c| + 1e-4 |c|), and the losses of 3 steps at
#: TRAIN_LOSS_RTOL, at the rate of tests/test_torch_training.py (3e-4: at
#: 1e-3 Adam's first step also moves the weights whose gradients are ~eps
#: by ~lr, and f32 sums taken in another order move those gradients)
TRAIN_CPU, GRAD_ATOL, GRAD_RTOL, TRAIN_LOSS_RTOL, CMP_LR = 64, 1e-5, 1e-4, 1e-5, 3e-4
#: ANI-2x (8 members, 7 elements) force training: molecules, atoms, steps
X2_TRAIN_MOLECS, X2_TRAIN_STEPS = 256, 5
#: epochs: a student (seed 3) on the labels of a teacher (seed 99), as
#: tests/test_learning.py builds them, from LEARN_MOLECS chain molecules of
#: 10 atoms (ten times that test's 48: 5 epochs of its 5 batches of 32 move
#: the validation RMSE by a seed-dependent amount), each 4 times with a
#: 0.05 A perturbation, in batches of 32; the last 2 batches validate.  The
#: RMSE must fall below LEARN_DROP of its start in LEARN_EPOCHS epochs at
#: the rate of that test (3e-4).  The resumed run (2 epochs, a checkpoint,
#: a fresh runner, 2 more) must end within RESUME_RTOL of an uninterrupted
#: run's loss and RMSE: on the card the networks' backward sums atoms with
#: atomics in a run-dependent order, so two uninterrupted runs differ too
LEARN_MOLECS, LEARN_EPOCHS, LEARN_DROP, RESUME_RTOL = 480, 5, 0.8, 1e-3
#: the parallel phases (50-52): NVE steps of the sharded MD (phase 23's rule:
#: coordinates within PAR_COORD_ATOL of the single-device run; K2's atomics
#: make longer runs drift), the sharded `init` against
#: `MolecularDynamics`' (energy relative, forces Ha/A: the same kernels, K2's
#: and K3b's sums in another order); the sharded training step against the
#: unsharded one under SGD at TRAIN_LR (an update proportional to the
#: gradient: loss relative, parameters rtol / atol as
#: tests/test_torch_parallel_training.py); steps timed; the seconds a
#: collective and the spawned ranks may take
PAR_MD_STEPS, PAR_COORD_ATOL, PAR_E_RTOL, PAR_F_ATOL = 10, 1e-4, 1e-6, 1e-5
PAR_LOSS_RTOL, PAR_P_RTOL, PAR_P_ATOL, PAR_TIMED = 1e-6, 2e-5, 2e-7, 5
PAR_COLLECTIVE_S, PAR_JOIN_S = 120, 600
#: NeuroChem models (phases 46-47) against their source models on the box:
#: the same weights through the same kernels, whose sums (K3b's atomics)
#: run in a run-dependent order: energies relative, forces Ha/A
NC_E_RTOL, NC_F_ATOL = 1e-6, 1e-5
#: the legacy batch (phase 48): fwdrev's loss against revrev's, relative (the
#: same forces; the weight gradients at GRAD_ATOL, GRAD_RTOL)
LEGACY_LOSS_RTOL = 1e-6
#: the solvated system (phase 49): the water template's atoms (tiled 2 x 2 x
#: 2, then cut to the box), the solute chain's most atoms, the box (A, the
#: headline box's side) and the NVE steps
SOLV_TEMPLATE_ATOMS, SOLV_SOLUTE_ATOMS, SOLV_BOX, SOLV_MD_STEPS = 1500, 160, 46.577, 10
#: third derivatives (phase 53) of ANI-2x on phase 20's 30-water cluster:
#: seeded (u, v) pairs of grad <grad <grad E, u>, v>; card against CPU
#: |k - c| <= THIRD_ATOL max|c| + THIRD_RTOL |c| (three f32 backward passes
#: over 8 members, K3b's and K3bb's sums in another order than the CPU's
#: plain path), for the weight gradient of sum (H w)^2 too, tensor by tensor
THIRD_PAIRS, THIRD_ATOL, THIRD_RTOL = 2, 1e-4, 1e-3
#: then one third derivative of the water box on the card alone (blocks,
#: time, peak memory)
THIRD_BOX_ATOMS = 10002
#: the xyz round trip (phase 54): frames of the 10,002-atom box written with
#: `write_xyz` and read back by both routes
XYZ_FRAMES = 20
#: triclinic MD (phase 55): NVE steps of each refresh on the sheared box; the
#: slot and packed coordinates within MD_COORD_ATOL of the gather run's
#: (phase 23's 10-step rule: K2's and K3b's atomics make longer runs drift)
TRI_STEPS = 10


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def count_syncs(fn):
    """``fn()`` under CUDA's sync debug mode: its result and the number of
    operations that made the host wait for the device."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchronizing" in str(w.message) for w in caught)


def kernels_ms(fn, reps: int) -> float:
    """Device time of the kernels that ``fn()`` launches, per call, summed
    by ``torch.profiler`` (no idle time of the stream in it).  A window in
    which the profiler recorded fewer device events than calls (each call
    launches at least one kernel) is taken again, with a line that says so,
    up to three times; after three such windows (the profiler's device
    tracing drops a window, or part of one, now and then) the time between
    CUDA events stands in, launch gaps included, and the line says so."""
    fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):
        with torch.profiler.profile(activities=activities) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        device = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        device_us = sum(e.self_device_time_total for e in device)
        events = sum(e.count for e in device)
        if device_us > 0 and events >= reps:
            return device_us / reps / 1e3
        print(f"torch.profiler recorded {events} device events for {reps} calls: window taken "
              f"again")
    ms = cuda_ms(fn, reps)
    print(f"torch.profiler recorded no device time in three windows: {ms:.4f} ms between "
          f"CUDA events instead")
    return ms


def kernel_errors(out: torch.Tensor, ref: torch.Tensor, what: str) -> float:
    err = (out - ref).abs()
    max_abs = float(err.max())
    max_rel = float((err / ref.abs().clamp(min=1e-6)).max())
    print(f"{what}: max abs err {max_abs:.3e}, max rel err {max_rel:.3e}")
    check(bool(torch.isfinite(out).all()), f"{what}: kernel output finite")
    check(bool((err <= ATOL + RTOL * ref.abs()).all()), f"{what}: within tolerance")
    return max_abs


def bwd_errors(out, ref, mask: torch.Tensor, what: str) -> float:
    """K3b's (gdist, gdiff) against its plain version's; returns the
    largest absolute error."""
    max_abs = 0.0
    for name, k, p in zip(("gdist", "gdiff"), out, ref):
        err = (k - p).abs()
        max_abs = max(max_abs, float(err.max()))
        check(bool(torch.isfinite(k).all()), f"{what}: {name} finite")
        check(bool((err <= ATOL * p.abs().max() + RTOL * p.abs()).all()),
              f"{what}: {name} within tolerance")
        check(bool((k[~mask] == 0).all()), f"{what}: {name} exactly 0 on masked lanes")
    print(f"{what}: max abs err {max_abs:.3e} (max |p| {float(ref[0].abs().max()):.3e}, "
          f"{float(ref[1].abs().max()):.3e})")
    return max_abs


def angular_bound_ms(pairs: float, lanes: float, sh: int, se: int, nbytes: int,
                     backward: bool) -> tuple:
    """Least time for K3 or K3b: the bytes moved once (``nbytes``), against
    the operations of the separable term per valid pair (f32 operations
    and special-function instructions, each unit at its own peak).  K3 per
    pair: sh exp, se pow (log2 and exp2), a sqrt and a division on the
    special-function units; an FMA per feature, ~4 operations per shift and
    6 per section, 15 for the geometry.  K3b: the same functions (pow of
    zeta - 1) and 4 more divisions; two FMAs per feature, ~10 operations per
    shift and per section, 50 for the geometry and the chain rule.  Per
    valid lane the cutoff (and its derivative): 3 special-function
    instructions."""
    z = sh * se
    if backward:
        sfu, f32 = sh + 2 * se + 6, 4 * z + 10 * (sh + se) + 50
    else:
        sfu, f32 = sh + 2 * se + 2, 2 * z + 4 * sh + 6 * se + 15
    by_f32 = pairs * f32 / PEAK_F32_FLOPS * 1e3
    by_sfu = (pairs * sfu + 3 * lanes) / PEAK_SFU_OPS * 1e3
    by_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    by_ops = max(by_f32, by_sfu)
    return (max(by_ops, by_bytes), "operations" if by_ops > by_bytes else "bytes",
            nbytes, by_f32, by_sfu)


def k3b_bytes(lanes, species: torch.Tensor, num_species: int, nz: int) -> int:
    """Bytes K3b must move: its lane inputs (dist, diff, the int32 lane
    species) read and its two gradients written once, and of the cotangent
    only the rows that meet a pair: for each atom the slots of the species
    pairs among its valid lanes, (s, s) where s holds two lanes or more."""
    n, ka = species.shape
    counts = torch.zeros((n, num_species + 1), dtype=torch.int64, device=species.device)
    counts.scatter_add_(1, (species.long() + 1), torch.ones_like(species, dtype=torch.int64))
    counts = counts[:, 1:]  # column 0 took the masked lanes
    held = (counts > 0).sum(1)
    rows = int((held * (held - 1) // 2 + (counts > 1).sum(1)).sum())
    lane_bytes = sum(t.numel() * t.element_size() for t in (lanes[0], lanes[1], species))
    return 2 * lane_bytes - species.numel() * 4 + rows * nz * 4


def k3bb_bound_ms(pairs: float, lanes: float, sh: int, se: int, nbytes: int) -> tuple:
    """Least time for K3bb: the bytes moved once (``nbytes``) against the
    operations per valid pair, each unit at its own peak.  Special-function
    instructions: sh exp, se pow (log2 and exp2), se reciprocals (base^(zeta
    - 2) from base^(zeta - 1)) and a reciprocal square root; per valid lane
    the cutoff and its two derivatives, 5.  f32: per feature the three sums
    over the cotangent (A, A', A'') and the directional derivative's two
    terms, 10 operations; ~25 per shift (R, R', R'' and six sums), ~20 per
    section, ~120 for the geometry and the chain rule."""
    sfu, f32 = sh + 3 * se + 1, 10 * sh * se + 25 * sh + 20 * se + 120
    by_f32 = pairs * f32 / PEAK_F32_FLOPS * 1e3
    by_sfu = (pairs * sfu + 5 * lanes) / PEAK_SFU_OPS * 1e3
    by_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    by_ops = max(by_f32, by_sfu)
    return (max(by_ops, by_bytes), "operations" if by_ops > by_bytes else "bytes",
            nbytes, by_f32, by_sfu)


def bwd_bwd_errors(out, ref, mask: torch.Tensor, what: str) -> float:
    """K3bb's (gg, hdist, hdiff) against its plain version's, at K3b's
    tolerance; returns the largest absolute error."""
    err = bwd_errors(out[1:], ref[1:], mask, what + " (hdist, hdiff)")
    k, p = out[0], ref[0]
    check(bool(torch.isfinite(k).all()), f"{what}: gg finite")
    check(bool(((k - p).abs() <= ATOL * p.abs().max() + RTOL * p.abs()).all()),
          f"{what}: gg within tolerance")
    gg_err = float((k - p).abs().max())
    print(f"{what}: gg max abs err {gg_err:.3e} (max |p| {float(p.abs().max()):.3e})")
    return max(err, gg_err)


def select_bound_ms(lanes: int, g: int, c: int, adds: bool) -> tuple:
    """Least time for K1 or K2: the occupied lanes' keys (4 bytes) and
    positions or cotangents (12 bytes), the (G, 27, C, 3) candidate table and
    the (G,) lane counts, each moved once; K2 also does 3 adds a lane."""
    nbytes = 16 * lanes + g * 27 * c * 12 + 4 * g
    by_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    by_ops = (3 * lanes if adds else 0) / PEAK_F32_FLOPS * 1e3
    return max(by_bytes, by_ops), "operations" if by_ops > by_bytes else "bytes", nbytes


def vals_bound_ms(lanes: int, g: int, c: int, p: int, adds: bool) -> tuple:
    """Least time for K4f or K4b at P channels: the occupied lanes' keys (4
    bytes) and values or cotangents (4 P bytes), the (G, 27, C, P) candidate
    table and the (G,) lane counts, each moved once; K4b does P adds a lane."""
    nbytes = (4 + 4 * p) * lanes + g * 27 * c * p * 4 + 4 * g
    by_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    by_ops = (p * lanes if adds else 0) / PEAK_F32_FLOPS * 1e3
    return max(by_bytes, by_ops), "operations" if by_ops > by_bytes else "bytes", nbytes


def packed_bound_ms(lanes: int, value_lanes: int, g: int, c: int, tiles: int,
                    adds: bool) -> tuple:
    """Least time for K5f or K5b: every lane of every row's keys (4 bytes),
    the positions or cotangents (12 bytes) of ``value_lanes`` of them (K5f
    writes every lane's; K5b needs only the cotangents of the lanes that hold
    a neighbor), the (G, 27, C, 3) candidate table and the tile table, each
    moved once."""
    nbytes = 4 * lanes + 12 * value_lanes + g * 27 * c * 12 + 4 * tiles
    by_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    by_ops = (3 * lanes if adds else 0) / PEAK_F32_FLOPS * 1e3
    return max(by_bytes, by_ops), "operations" if by_ops > by_bytes else "bytes", nbytes


def launch_shape(what: str, g: int, c: int, p: int) -> dict:
    """Print and return how K2 (p = 3) or K4b launch at G buckets of C
    slots: the cluster split S, blocks, threads a block, shared memory."""
    from torchani_tpu_torch.bucket_refresh import bwd_launch_shape

    shape = bwd_launch_shape(g, c, p, torch.device("cuda"))
    print(f"{what} launch: G={g}, C={c}, P={p}: S={shape['split']} blocks a cluster, "
          f"{shape['blocks']} blocks of {shape['threads']} threads, "
          f"{shape['smem_bytes']} bytes of shared memory a block")
    return shape


def k1_launch_shape(what: str, g: int, c: int, r: int) -> dict:
    """Print and return how K1 launches at G buckets of C slots and R
    lanes: the split S (independent blocks a bucket), blocks, threads a
    block, shared memory."""
    from torchani_tpu_torch.bucket_refresh import fwd_launch_shape

    shape = fwd_launch_shape(g, c, r, torch.device("cuda"))
    print(f"{what} launch: G={g}, C={c}, R={r}: S={shape['split']} blocks a bucket, "
          f"{shape['blocks']} blocks of {shape['threads']} threads, "
          f"{shape['smem_bytes']} bytes of shared memory a block")
    return shape


def k3b_launch_shape(what: str, lanes, kw: dict, second_order: bool = False) -> dict:
    """Print and return K3b's persistent grid (K3bb's with ``second_order``)
    at these lanes and widths: blocks, threads a block, shared memory a
    block (each warp's one buffer of the cotangent rows that meet a pair,
    lanes and gradient planes; K3bb's also its pair tile and J u rows),
    atoms a warp."""
    from torchani_tpu_torch.aev.kernels import bwd_launch_shape as k3b_shape

    n, ka = lanes[0].shape
    shape = k3b_shape(n, ka, kw["num_species"], len(kw["shifts"]), len(kw["sections"]),
                      lanes[0].device, second_order=second_order)
    print(f"{what} launch: N={n}, Ka={ka}: {shape['blocks']} blocks of {shape['threads']} "
          f"threads, {shape['smem_bytes']} bytes of shared memory a block, at most "
          f"{shape['atoms_per_warp']} atoms a warp")
    return shape


def k5_launch_shape(what: str, g: int, c: int, tiles: int) -> dict:
    """Print and return how K5f and K5b launch at G buckets of C slots that
    own ``tiles`` row tiles each: the split S (independent blocks in K5f, a
    cluster in K5b), blocks, threads a block, each kernel's shared memory."""
    from torchani_tpu_torch.bucket_refresh import packed_launch_shape

    shape = packed_launch_shape(g, c, tiles, torch.device("cuda"))
    print(f"{what} launch: G={g}, C={c}, {tiles} tiles a bucket: S={shape['split']} blocks a "
          f"bucket, {shape['blocks']} blocks of {shape['threads']} threads, "
          f"{shape['fwd_smem_bytes']} (K5f) and {shape['bwd_smem_bytes']} (K5b) bytes of shared "
          f"memory a block")
    return shape


def held_gib() -> float:
    """Device memory allocated now, in GiB (part of every peak measured
    after it)."""
    return torch.cuda.memory_allocated() / 2**30


def within(out: torch.Tensor, ref: torch.Tensor, tol: float) -> bool:
    """|out - ref| <= tol (1 + |ref|) everywhere, and out finite."""
    return bool(torch.isfinite(out).all()) and bool(
        ((out - ref).abs() <= tol * (1 + ref.abs())).all()
    )


def total_energy(md, state) -> float:
    """Potential plus kinetic energy of an MD state, in Hartree."""
    from torchani_tpu_torch.md import ACCEL_UNIT

    kinetic = 0.5 * torch.sum(md.masses[:, None].double() * state.velocities.double() ** 2)
    return float(state.energy) + float(kinetic) / ACCEL_UNIT


def random_angular_inputs(n: int, ka: int, s: int, seed: int):
    """Random lanes: masked ones at 1.0 / 0, and every 7th row fully masked."""
    rng = np.random.RandomState(seed)
    dist = rng.uniform(0.8, 3.4, (n, ka)).astype(np.float32)
    diff = rng.randn(n, ka, 3).astype(np.float32)
    diff *= (dist / np.linalg.norm(diff, axis=-1))[..., None]
    mask = rng.rand(n, ka) < 0.7
    mask[::7] = False
    elem = rng.randint(0, s, (n, ka))
    oh = np.eye(s, dtype=np.float32)[elem] * mask[..., None]
    dev = torch.device("cuda")
    return (
        torch.as_tensor(np.where(mask, dist, 1.0).astype(np.float32), device=dev),
        torch.as_tensor(diff * mask[..., None], device=dev),
        torch.as_tensor(mask, device=dev),
        torch.as_tensor(oh, device=dev),
    )


def step_kernel_ms(fn, reps: int) -> tuple:
    """``torch.profiler`` over ``reps`` calls of ``fn()`` (after one): device
    ms per call of K3, K3b and K3bb inside it, and of every kernel."""
    fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    symbols = {"angular_aev": "angular_aev_kernel", "angular_aev_bwd": "angular_aev_bwd_kernel",
               "angular_aev_bwd_bwd": "angular_aev_bwd_bwd_kernel"}
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per, total = {k: 0.0 for k in symbols}, 0.0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            total += e.self_device_time_total
            for k, sym in symbols.items():
                if sym in e.key:
                    per[k] += e.self_device_time_total
    return {k: v / reps / 1e3 for k, v in per.items()}, total / reps / 1e3


def blocked(fn, n: int, block: int = 8192):
    """``fn(sl)`` over row slices of ``n`` rows, concatenated (a plain
    version whose grid would not fit at once)."""
    outs = [fn(slice(i, min(i + block, n))) for i in range(0, n, block)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


def training_phases(card: str, kernels_fn: dict, reset_counts, read_counts) -> dict:
    """Phases 41-45: the data and training path on the card.  Returns the
    launches of each training path and K3, K3b and K3bb at the training
    batch's tables."""
    import pathlib

    from torchani_tpu_torch import cli
    from torchani_tpu_torch.aev.kernels import (
        angular_aev,
        angular_aev_bwd,
        angular_aev_bwd_bwd,
        angular_aev_bwd_bwd_reference,
        angular_aev_bwd_reference,
        angular_aev_reference,
        angular_grid,
        lane_species,
    )
    from torchani_tpu_torch.arch import simple_ani
    from torchani_tpu_torch.datasets import (
        ANIBatchedDataset,
        ANIBatchedInMemoryDataset,
        ANIDataset,
        create_batched_dataset,
    )
    from torchani_tpu_torch.models import ANI2x
    from torchani_tpu_torch.profiling import peak_gib, wall_times_ms
    from torchani_tpu_torch.sae_estimation import exact_saes
    from torchani_tpu_torch.testing import make_chain_molecs, make_molecs
    from torchani_tpu_torch.training import (
        EpochRunner,
        adamw_with_plateau,
        load_checkpoint,
        make_bucketed_train_step,
        make_train_step,
        save_checkpoint,
        tune_angular_capacity,
    )
    from torchani_tpu_torch.training.loop import energy_force_loss
    from torchani_tpu_torch.transforms import AtomicNumbersToIndices, SubtractSAE

    t_train = time.perf_counter()
    dev = torch.device("cuda")
    symbols = ("H", "C", "N", "O")
    paths = {}  # launches of each training path
    force_want = {k_: int(k_.startswith("angular")) for k_ in kernels_fn}
    energy_want = {k_: int(k_ == "angular_aev") for k_ in kernels_fn}

    def train_model(seed=0, device=None):
        """The training configuration's model (tools/training_benchmark.py)."""
        m = simple_ani(symbols, ensemble_size=1, repulsion=False, cutoff_fn="cosine",
                       radial_start=0.9, radial_cutoff=5.2, angular_start=0.9, activation="celu",
                       bias=True, seed=seed, device=device)
        m.energy_shifter.enabled = False
        return m

    adamw = adamw_with_plateau(TRAIN_LR)[0]

    # ---- 41. data: a Zarr store, ANIDataset, batching, SAEs, cli data ----
    gsaes = np.array([-0.500607632585, -37.8302333826, -54.5680045287, -75.0362229210])
    rng = np.random.RandomState(1234)
    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp)
        loc = root / "data.zarr"
        ds = ANIDataset(loc)
        written = {}
        for gi, max_atoms in enumerate((6, 9, 12)):  # TestData's three groups
            sp_g, co_g = make_chain_molecs(64, max_atoms, seed=20 + gi)
            counts = np.stack([(sp_g == z).sum(1) for z in (1, 6, 7, 8)], 1)
            written[f"group{gi}"] = {
                "species": sp_g, "coordinates": co_g,
                "energies": counts @ gsaes + rng.randn(64) * 1e-3,
                "forces": (rng.randn(64, max_atoms, 3) * 0.01 * (sp_g >= 0)[..., None]
                           ).astype(np.float32),
            }
            ds.append_conformers(f"group{gi}", written[f"group{gi}"])
        back = ANIDataset(loc)
        same = back.keys() == sorted(written) and all(
            np.array_equal(back[g][k_], v) and back[g][k_].dtype == v.dtype
            for g, grp in written.items() for k_, v in grp.items())
        check(same, "the Zarr store reads back what was written, dtypes included")
        regrouped = ANIDataset(loc).to_backend(root / "by_atoms.zarr").regroup_by_num_atoms()
        sizes = regrouped.group_sizes()
        check(sum(sizes.values()) == 192
              and all(int((regrouped[g]["species"] >= 0).sum(1).min()) == int(g) for g in sizes),
              "regroup_by_num_atoms keeps every conformer, each group one atom count")
        sums = ds.record_checksums()
        check(ds.verify_checksums()["ok"] and len(sums) == len(ds.store.files()),
              "md5 manifest recorded and verified")
        dest = create_batched_dataset(ds, root / "batched", batch_size=32, rng_seed=7,
                                      density_cutoff=3.5)
        train_div = ANIBatchedDataset(dest, "training")
        caps = [int(b["angular_capacity"]) for b in train_div]
        check(sum(b["species"].shape[0] for b in train_div)
              + sum(b["species"].shape[0] for b in ANIBatchedDataset(dest, "validation")) == 192
              and caps == sorted(caps), "batched dataset: every conformer once, capacities sorted")
        to_idx = AtomicNumbersToIndices(symbols)
        saes, _ = exact_saes((to_idx(b) for b in train_div), 4)
        subtract = SubtractSAE(symbols, saes)
        shifted = ANIBatchedInMemoryDataset([subtract(b) for b in train_div])
        residual = np.concatenate([b["energies"] for b in shifted])
        print(f"data: {len(ds)} groups, {ds.num_conformers} conformers in a Zarr store; by atom "
              f"count {sorted(sizes.items(), key=lambda kv: int(kv[0]))}; {len(train_div)} "
              f"training batches at capacities {caps}; exact SAEs {np.round(saes, 6).tolist()} "
              f"(largest error {np.abs(saes - gsaes).max():.2e} Ha); residual RMS after "
              f"SubtractSAE {np.sqrt(np.mean(residual ** 2)):.3e} Ha")
        check(np.abs(saes - gsaes).max() < 1e-2 and np.sqrt(np.mean(residual ** 2)) < 5e-3,
              "exact_saes recovers the energies' self energies")
        cli_out = {}
        for argv in (["ls", str(loc)], ["info", str(loc)],
                     ["pack", str(loc), str(root / "packed"), "--batch-size", "32"],
                     ["verify", str(loc)]):
            text = io_mod.StringIO()
            with contextlib.redirect_stdout(text):
                cli.main(["data"] + argv)
            cli_out[argv[0]] = text.getvalue()
        check(cli_out["ls"] == "".join(f"group{g}\t64\n" for g in range(3))
              and json.loads(cli_out["info"])["conformers"] == 192
              and "integrity ok" in cli_out["verify"]
              and len(ANIBatchedDataset(root / "packed", "training")) > 0,
              "cli data ls, info, pack and verify")

        # force training over the packed batches: pinned host memory, each
        # batch at its capacity
        pinned = shifted.cache(pin_memory=True)
        check(all(t.is_pinned() for b in pinned for t in b.values()), "cached batches are pinned")
        init, step = make_bucketed_train_step(train_model(), adamw, force_training=True)
        state = init()
        reset_counts()
        losses = []
        for b in pinned:
            state, m = step(state, b)
            losses.append(m["loss"])
        torch.cuda.synchronize()
        paths["train_bucketed_epoch"] = read_counts()
        nb = len(pinned)
        check(paths["train_bucketed_epoch"] == {k_: nb * v for k_, v in force_want.items()}
              and angular_grid.calls == 0 and all(bool(torch.isfinite(x)) for x in losses),
              "bucketed force training: K3, K3b and K3bb once a batch, finite losses")
        print(f"bucketed force epoch over {nb} pinned batches: launches "
              f"{paths['train_bucketed_epoch']}; losses {[round(float(x), 6) for x in losses]}")

    # ---- 42. force training at the repo's training width ----
    sp_t, co_t = make_molecs(TRAIN_BATCH, TRAIN_ATOMS, seed=0)
    host_batch = {
        "species": sp_t, "coordinates": co_t,
        "energies": np.random.RandomState(1).randn(TRAIN_BATCH).astype(np.float32),
        "forces": np.zeros(co_t.shape, np.float32),
    }
    batch = {k_: torch.as_tensor(v, device=dev) for k_, v in host_batch.items()}
    model = train_model()
    rows, real = sp_t.size, int((sp_t >= 0).sum())
    step_ms, syncs, peaks, busy = {}, {}, {}, {}
    states = {}
    for kind, force in (("force", True), ("energy", False)):
        init, step = make_train_step(model, adamw, force_training=force)
        state = init()
        for _ in range(TRAIN_WARMUP):
            state, m = step(state, batch)
        torch.cuda.synchronize()
        reset_counts()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        paths[f"train_{kind}_step"] = read_counts()
        want = force_want if force else energy_want
        check(paths[f"train_{kind}_step"] == want and angular_grid.calls == 0,
              f"one {kind} step launches {'K3, K3b and K3bb' if force else 'K3 alone'} once")
        check(bool(torch.isfinite(m["loss"])), f"{kind} step: finite loss")
        _, syncs[kind] = count_syncs(lambda step=step, state=state: step(state, batch))
        times = []
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        step_ms[kind] = times
        peaks[kind] = peak_gib(lambda step=step, state=state: step(state, batch))
        busy[kind] = step_kernel_ms(lambda step=step, state=state: step(state, batch), reps=3)
        states[kind] = state
        ms = float(np.median(times))
        print(f"{card}: {kind} training step, batch {TRAIN_BATCH} x {TRAIN_ATOMS} ({real} atoms, "
              f"{rows} rows): median {ms:.3f} ms (min {min(times):.3f}, max {max(times):.3f}, "
              f"{TRAIN_STEPS} steps after {TRAIN_WARMUP}), {TRAIN_BATCH / ms * 1e3:,.0f} samples/s; "
              f"launches {paths[f'train_{kind}_step']}; {syncs[kind]} host syncs a step; peak "
              f"memory {peaks[kind]:.3f} GiB ({held_gib():.3f} held); device "
              f"{busy[kind][1]:.3f} ms a step ({busy[kind][1] / ms:.1%} busy), of it K3 "
              f"{busy[kind][0]['angular_aev']:.4f}, K3b {busy[kind][0]['angular_aev_bwd']:.4f}, "
              f"K3bb {busy[kind][0]['angular_aev_bwd_bwd']:.4f} ms")

    # K3, K3b and K3bb at the training batch's own tables
    aevc = model.aev_computer
    elem = model._convert(batch["species"])
    nbrs = model.neighborlist(model.cutoff, elem, batch["coordinates"], None, None)
    _, ang, overflow = aevc.flat_tables(elem, nbrs)
    check(not bool(overflow), "the training batch's tables do not overflow")
    t_in = aevc.angular_inputs(elem.reshape(-1), ang)
    kw = aevc.kernel_kwargs()
    n, ka = t_in[0].shape
    sh, se = len(kw["shifts"]), len(kw["sections"])
    t_species = lane_species(t_in[2], t_in[3])
    t_out = angular_aev(*t_in, species=t_species, **kw)
    torch.cuda.synchronize()

    def rows_of(sl, *ts):
        return tuple(t[sl] for t in ts)

    k = {"K3": {}, "K3b": {}, "K3bb": {}}
    k["K3"]["err"] = kernel_errors(
        t_out, blocked(lambda sl: angular_aev_reference(*rows_of(sl, *t_in), **kw), n),
        "K3 training batch vs plain")
    gen = torch.Generator(dev).manual_seed(15)
    g = torch.randn(t_out.shape, device=dev, generator=gen)
    u = (torch.randn(t_in[0].shape, device=dev, generator=gen),
         torch.randn(t_in[1].shape, device=dev, generator=gen))
    block = aevc._atom_block(ka)
    k["K3b"]["err"] = bwd_errors(
        angular_aev_bwd(g, *t_in, t_species, **kw),
        angular_aev_bwd_reference(g, *t_in, atom_block=block, **kw), t_in[2],
        "K3b training batch vs plain")
    k["K3bb"]["err"] = bwd_bwd_errors(
        angular_aev_bwd_bwd(g, *t_in, *u, t_species, **kw),
        angular_aev_bwd_bwd_reference(g, *t_in, *u, atom_block=max(1, block // 4), **kw),
        t_in[2], "K3bb training batch vs plain")
    lanes = t_in[2].sum(1).to(torch.float64)
    pairs, valid = float((lanes * (lanes - 1) / 2).sum()), float(lanes.sum())
    lane_bytes = sum(t.numel() * t.element_size() for t in (t_in[0], t_in[1], t_species))
    b3b = k3b_bytes(t_in, t_species, kw["num_species"], sh * se)
    k["K3"].update(
        ms=kernels_ms(lambda: angular_aev(*t_in, species=t_species, **kw), reps=20),
        plain=kernels_ms(lambda: blocked(
            lambda sl: angular_aev_reference(*rows_of(sl, *t_in), **kw), n), reps=1),
        bound=angular_bound_ms(pairs, valid, sh, se, lane_bytes + t_out.numel() * 4, False))
    k["K3b"].update(
        ms=kernels_ms(lambda: angular_aev_bwd(g, *t_in, t_species, **kw), reps=20),
        plain=kernels_ms(lambda: angular_aev_bwd_reference(
            g, *t_in, atom_block=block, **kw), reps=1),
        bound=angular_bound_ms(pairs, valid, sh, se, b3b, True),
        grid=k3b_launch_shape("K3b at the training batch", t_in, kw))
    k["K3bb"].update(
        ms=kernels_ms(lambda: angular_aev_bwd_bwd(g, *t_in, *u, t_species, **kw), reps=20),
        plain=kernels_ms(lambda: angular_aev_bwd_bwd_reference(
            g, *t_in, *u, atom_block=max(1, block // 4), **kw), reps=1),
        bound=k3bb_bound_ms(pairs, valid, sh, se,
                            b3b + sum(t.numel() * 4 for t in u) + t_out.numel() * 4),
        grid=k3b_launch_shape("K3bb at the training batch", t_in, kw, second_order=True))
    k["K3"]["in_step"] = busy["force"][0]["angular_aev"]
    k["K3b"]["in_step"] = busy["force"][0]["angular_aev_bwd"]
    k["K3bb"]["in_step"] = busy["force"][0]["angular_aev_bwd_bwd"]
    for name, v in k.items():
        print(f"{card}: {name} at the training batch (N={n}, Ka={ka}, {sh} x {se}, "
              f"{pairs:.0f} valid pairs): {v['ms']:.4f} ms alone, {v['in_step']:.4f} ms in the "
              f"force step; plain {v['plain']:.3f} ms; bound {v['bound'][0]:.4f} ms by "
              f"{v['bound'][1]} ({v['bound'][2] / 1e6:.1f} MB)")
    del nbrs, ang, t_in, t_out, g, u, t_species, lanes
    tuned = tune_angular_capacity(model, [host_batch])
    cap = tuned.aev_computer.angular_capacity
    init, step = make_train_step(tuned, adamw, force_training=True)
    state = init()
    for _ in range(TRAIN_WARMUP):
        state, _ = step(state, batch)
    tuned_ms = wall_times_ms(lambda: step(state, batch), reps=TRAIN_STEPS)
    print(f"{card}: tune_angular_capacity picks {cap} (the table holds {ka} lanes): "
          f"force step {np.median(tuned_ms):.3f} ms against {np.median(step_ms['force']):.3f} at "
          f"the full table")
    del states, state, tuned

    # ---- 43. card against CPU on the first conformers ----
    small = {k_: v[:TRAIN_CPU] for k_, v in host_batch.items()}
    cmp_models = {"cuda": train_model(), "cpu": train_model(device="cpu")}
    grads_by = {}
    for where, m in cmp_models.items():
        params = list(m.neural_networks.parameters())
        loss = energy_force_loss(m, small["species"], small["coordinates"], small["energies"],
                                 small["forces"])
        grads_by[where] = [x.detach().cpu() for x in torch.autograd.grad(loss, params)]
    grad_err = max(float(((a - b).abs() / (b.abs().max() + 1e-12)).max())
                   for a, b in zip(grads_by["cuda"], grads_by["cpu"]))
    check(all(bool(((a - b).abs() <= GRAD_ATOL * b.abs().max() + GRAD_RTOL * b.abs()).all())
              for a, b in zip(grads_by["cuda"], grads_by["cpu"])),
          "force-step weight gradients: card against CPU")
    cmp_losses = {}
    for where, m in cmp_models.items():
        init, step = make_train_step(m, adamw_with_plateau(CMP_LR)[0], force_training=True)
        state, out = init(), []
        for _ in range(3):
            state, met = step(state, small)
            out.append(float(met["loss"]))
        cmp_losses[where] = out
    loss_gap = max(abs(a / b - 1) for a, b in zip(cmp_losses["cuda"], cmp_losses["cpu"]))
    print(f"training card vs CPU, {TRAIN_CPU} conformers: weight gradients max |dg| / max|g| "
          f"{grad_err:.3e}; losses of 3 steps {cmp_losses['cuda']} vs {cmp_losses['cpu']} "
          f"(largest relative gap {loss_gap:.3e})")
    check(loss_gap <= TRAIN_LOSS_RTOL, "3 training steps: card losses against the CPU's")
    del cmp_models, grads_by

    # ---- 44. ANI-2x at full width: the 8-member ensemble with the force loss ----
    x2 = ANI2x(seed=0)
    x2.energy_shifter.enabled = False
    sp2, co2 = make_molecs(X2_TRAIN_MOLECS, TRAIN_ATOMS, seed=2, znums=(1, 6, 7, 8, 9, 16, 17))
    x2_batch = {
        "species": torch.as_tensor(sp2, device=dev), "coordinates": torch.as_tensor(co2, device=dev),
        "energies": torch.as_tensor(np.random.RandomState(3).randn(X2_TRAIN_MOLECS)
                                    .astype(np.float32) * 0.01, device=dev),
        "forces": torch.zeros(co2.shape, device=dev),
    }
    init, step = make_train_step(x2, adamw, force_training=True)
    state = init()
    state, m = step(state, x2_batch)
    torch.cuda.synchronize()
    reset_counts()
    state, m = step(state, x2_batch)
    torch.cuda.synchronize()
    paths["ani2x_force_step"] = read_counts()
    check(paths["ani2x_force_step"] == force_want and bool(torch.isfinite(m["loss"])),
          "ANI-2x force step: K3, K3b and K3bb once each, finite loss")
    x2_ms = wall_times_ms(lambda: step(state, x2_batch), reps=X2_TRAIN_STEPS)
    x2_peak = peak_gib(lambda: step(state, x2_batch))
    print(f"{card}: ANI-2x (8 members) force training, {X2_TRAIN_MOLECS} x {TRAIN_ATOMS} "
          f"({int((sp2 >= 0).sum())} atoms, 7 elements): median {np.median(x2_ms):.3f} ms a step "
          f"({X2_TRAIN_MOLECS / np.median(x2_ms) * 1e3:,.0f} samples/s; min {min(x2_ms):.3f}, max "
          f"{max(x2_ms):.3f}); launches {paths['ani2x_force_step']}; peak memory {x2_peak:.3f} GiB")
    del x2, state, x2_batch

    # ---- 45. epochs: a student on a teacher's labels, checkpoint and resume ----
    teacher = simple_ani(symbols, seed=99)
    teacher.energy_shifter.enabled = False
    base_sp, base_co = make_chain_molecs(LEARN_MOLECS, 10, seed=11)
    l_sp = np.repeat(base_sp, 4, axis=0)
    l_co = np.repeat(base_co, 4, axis=0) + (
        np.random.RandomState(5).randn(4 * LEARN_MOLECS, 10, 3).astype(np.float32) * 0.05)
    with torch.no_grad():
        l_e = teacher(l_sp, l_co).cpu().numpy()
    l_batches = [{"species": l_sp[i:i + 32].astype(np.int32), "coordinates": l_co[i:i + 32],
                  "energies": l_e[i:i + 32]} for i in range(0, l_sp.shape[0], 32)]
    l_train, l_val = l_batches[:-2], l_batches[-2:]

    def student(device=None):
        s_ = simple_ani(symbols, ensemble_size=1, seed=3, device=device)
        s_.energy_shifter.enabled = False
        return s_

    optimizer, plateau = adamw_with_plateau(3e-4)
    runner = EpochRunner(student(), optimizer)
    state = runner.init()
    rmses = [runner.validate(state, l_val)]
    epoch_s = []
    for ep in range(LEARN_EPOCHS):
        fetched = runner.fetches
        t0 = time.perf_counter()
        if ep == 0:
            reset_counts()
        state, met = runner.epoch(state, l_train)
        if ep == 0:
            torch.cuda.synchronize()
            paths["train_epoch"] = read_counts()
        epoch_s.append(time.perf_counter() - t0)
        check(runner.fetches - fetched == 1 and np.isfinite(met["loss"]),
              "an epoch reads its loss from the card once")
        rmses.append(runner.validate(state, l_val))
        plateau.update(rmses[-1], state.opt_state)
    check(paths["train_epoch"] == {k_: len(l_train) * v for k_, v in energy_want.items()},
          "an energy epoch launches K3 once a step, nothing else")
    _, epoch_syncs = count_syncs(lambda: runner.epoch(state, l_train[:10]))
    print(f"{card}: {LEARN_EPOCHS} epochs of {len(l_train)} steps (32 conformers of <= 10 atoms): "
          f"{np.median(epoch_s):.3f} s an epoch (median); validation RMSE {rmses} Ha; one fetch "
          f"of the loss an epoch; {epoch_syncs / 10:.1f} host syncs a step (the model's)")
    check(rmses[-1] < LEARN_DROP * rmses[0], "the student's validation RMSE falls below 0.8 of "
          "its start")

    def run(interrupt: bool, tmp: tp.Optional[pathlib.Path]):
        opt, plat = adamw_with_plateau(1e-3)
        plat.patience = 1
        r = EpochRunner(student(), opt)
        st = r.init()
        for _ in range(2):
            st, _ = r.epoch(st, l_train)
            plat.update(r.validate(st, l_val), st.opt_state)
        if interrupt:
            save_checkpoint(tmp, (st, plat.lr, plat.best, plat.bad_epochs), 2)
            on_cpu = load_checkpoint(tmp, (EpochRunner(student("cpu"), opt).init(), 0.0, 0.0, 0))
            check(all(torch.equal(a.cpu(), b) for a, b in zip(
                st.networks.parameters(), on_cpu[0].networks.parameters()))
                and on_cpu[0].step == st.step, "a card checkpoint loads onto the CPU bit for bit")
            opt, plat = adamw_with_plateau(1e-3)
            plat.patience = 1
            r = EpochRunner(student(), opt)
            st, plat.lr, plat.best, plat.bad_epochs = load_checkpoint(tmp, (r.init(), 0.0, 0.0, 0))
        for _ in range(2):
            st, met_ = r.epoch(st, l_train)
            plat.update(r.validate(st, l_val), st.opt_state)
        return met_["loss"], r.validate(st, l_val)

    with tempfile.TemporaryDirectory() as tmp:
        first, second = run(False, None), run(False, None)
        resumed = run(True, pathlib.Path(tmp) / "ck")
    gap_runs = max(abs(a / b - 1) for a, b in zip(second, first))
    gap_resume = max(abs(a / b - 1) for a, b in zip(resumed, first))
    print(f"resume: loss and RMSE after 4 epochs {first}; two uninterrupted runs differ by "
          f"{gap_runs:.3e} (relative), the resumed run by {gap_resume:.3e}")
    check(gap_resume <= RESUME_RTOL, "2 epochs + checkpoint + 2 epochs match 4 epochs")
    print(f"new phases (data and training): {time.perf_counter() - t_train:.1f} s of wall time")
    return {"launches": paths, "kernels": k, "step_ms": step_ms}



def write_pdb(path, znums, coords, cell=None, resname: str = "HOH") -> None:
    """ATOM records (element in columns 77-78; three atoms a residue) and,
    with ``cell``, a cubic CRYST1 record: a PDB file for `io.read_pdb`."""
    from torchani_tpu_torch.constants import PERIODIC_TABLE

    lines = []
    if cell is not None:
        lines.append(f"CRYST1{cell:9.3f}{cell:9.3f}{cell:9.3f}{90:7.2f}{90:7.2f}{90:7.2f} P 1\n")
    for i, (z, (x, y, w)) in enumerate(zip(znums, coords)):
        sym = PERIODIC_TABLE[int(z)]
        lines.append(f"ATOM  {(i + 1) % 100000:5d} {sym:<4s} {resname} A{(i // 3 + 1) % 10000:4d}    "
                     f"{x:8.3f}{y:8.3f}{w:8.3f}{1.0:6.2f}{0.0:6.2f}          {sym:>2s}\n")
    path.write_text("".join(lines) + "END\n")


def write_neurochem_zoo(root, model, kind: str):
    """``model`` (an `ANI` with one `NNPotential` over an `Ensemble`) as a
    NeuroChem model directory: ``{kind}.info``, ``{kind}.params`` (the AEV
    constants as f32-exact decimals), ``sae_linfit.dat`` and, per member,
    ``train{e}/networks/ANN-{symbol}.nnf`` (a ``XX==`` header before the bz2
    layer specs, activation 9 = CELU(0.1) on hidden layers, 6 on the output)
    with raw f32 ``(out, in)`` ``.wparam`` and ``.bparam`` files.  Returns
    the ``.info`` path."""
    import bz2

    def f32_list(t):
        return "[" + ",".join(repr(float(v)) for v in t.detach().cpu().reshape(-1).tolist()) + "]"

    aev = model.aev_computer
    r, a = aev.radial, aev.angular
    symbols = model.symbols
    (root / f"{kind}.params").write_text("\n".join([
        "TM = 1", f"Rcr = {float(r.cutoff)!r}", f"Rca = {float(a.cutoff)!r}",
        f"EtaR = {f32_list(r.eta)}", f"ShfR = {f32_list(r.shifts)}",
        f"Zeta = {f32_list(a.zeta)}", f"ShfZ = {f32_list(a.sections)}",
        f"EtaA = {f32_list(a.eta)}", f"ShfA = {f32_list(a.shifts)}",
        "Atyp = [" + ",".join(symbols) + "]"]) + "\n")
    saes = model.energy_shifter.self_energies.cpu().tolist()
    (root / "sae_linfit.dat").write_text(
        "".join(f"{sym},{i}={e!r}\n" for i, (sym, e) in enumerate(zip(symbols, saes))))
    nets = model.neural_networks
    weights, biases = ([t.detach().cpu().numpy() for t in ts] for ts in nets._stacks())
    members = weights[0].shape[0]
    for e in range(members):
        net_dir = root / f"train{e}" / "networks"
        net_dir.mkdir(parents=True)
        for si, sym in enumerate(symbols):
            dims = nets.layer_dims[si]
            blocks = []
            for li in range(len(dims) - 1):
                w = np.ascontiguousarray(weights[li][e, si, : dims[li], : dims[li + 1]].T)
                b = np.ascontiguousarray(biases[li][e, si, : dims[li + 1]])
                wname, bname = f"ANN-{sym}-l{li}.wparam", f"ANN-{sym}-l{li}.bparam"
                (net_dir / wname).write_bytes(w.astype(np.float32).tobytes())
                (net_dir / bname).write_bytes(b.astype(np.float32).tobytes())
                act = 9 if li < len(dims) - 2 else 6
                blocks.append(f"layer [ nodes={dims[li + 1]}; activation={act}; "
                              f"weights=FILE: {wname}[{w.size}]; biases=FILE: {bname}[{b.size}]; ]")
            text = ("\n".join(blocks) + "\n$\n").encode("ascii") + b"\n"
            (net_dir / f"ANN-{sym}.nnf").write_bytes(b"XX==" + bz2.compress(text))
    info = root / f"{kind}.info"
    info.write_text(f"{kind}.params\nsae_linfit.dat\ntrain\n{members}\n")
    return info


def loader_phases(card: str, kernels_fn: dict, reset_counts, read_counts,
                  revrev_ms: tp.Sequence[float]) -> dict:
    """Phases 46-49: the NeuroChem loaders at full width, the legacy data
    pipeline feeding force training in both gradient modes,
    `make_solvated_system` under E+F and MD, and the profiling API.
    ``revrev_ms`` is phase 42's force step.  Returns the launches of each
    path."""
    import pathlib

    from torchani_tpu_torch import profiling
    from torchani_tpu_torch.arch import ANI, simple_ani
    from torchani_tpu_torch.datasets import ANIDataset
    from torchani_tpu_torch.grad import energies_and_forces
    from torchani_tpu_torch.legacy_data import (
        TransformableIterable,
        Transformations,
        _Regenerable,
        _split_conformers,
    )
    from torchani_tpu_torch.md import MolecularDynamics
    from torchani_tpu_torch.models import ANI1x, ANI2x
    from torchani_tpu_torch.neighbors import CellList, narrow_to_cutoff
    from torchani_tpu_torch.neurochem import (
        load_atomic_networks,
        load_model_from_info,
        modules_from_info_file,
    )
    from torchani_tpu_torch.potentials import NNPotential
    from torchani_tpu_torch.profiling import peak_gib, wall_times_ms
    from torchani_tpu_torch.testing import (
        make_chain_molecs,
        make_molecs,
        make_solvated_system,
        make_water_box,
    )
    from torchani_tpu_torch.training import adamw_with_plateau, make_train_step
    from torchani_tpu_torch.training.loop import (
        _device_batch,
        _force_loss_fwdrev,
        energy_force_loss,
    )
    from torchani_tpu_torch.transforms import AtomicNumbersToIndices, SubtractSAE
    from torchani_tpu_torch.utils import exact_matmul, strip_redundant_padding

    t_phases = time.perf_counter()
    dev = torch.device("cuda")
    paths = {}
    ef_want = {k_: int(k_ in ("angular_aev", "angular_aev_bwd")) for k_ in kernels_fn}
    force_want = {k_: int(k_.startswith("angular")) for k_ in kernels_fn}
    sp_np, co_np, cell_np = make_water_box(10002)
    box = tuple(torch.as_tensor(x, device=dev) for x in (sp_np, co_np, cell_np))
    pbc = torch.ones(3, dtype=torch.bool, device=dev)

    def ef(m):
        return energies_and_forces(m, box[0], box[1], box[2], pbc)

    def ef_counted(m, what):
        torch.cuda.synchronize()
        reset_counts()
        out = ef(m)
        torch.cuda.synchronize()
        counts = read_counts()
        check(counts == ef_want, f"{what}: one E+F launches K3 and K3b once each, nothing else")
        check(all(bool(torch.isfinite(t).all()) for t in out), f"{what}: finite E+F")
        return out, counts

    def same_ef(out, ref, what):
        e_rel = float(((out[0] - ref[0]).abs() / ref[0].abs()).max())
        f_err = float((out[1] - ref[1]).abs().max())
        print(f"{what}: energies {out[0].tolist()} against {ref[0].tolist()} (relative "
              f"{e_rel:.3e}), forces max |dF| {f_err:.3e} Ha/A")
        check(e_rel <= NC_E_RTOL and f_err <= NC_F_ATOL, f"{what}: E+F as the source model's")

    def same_stacks(nets, ref, what):
        got, want = nets._stacks(), ref._stacks()
        check(nets.layer_dims == ref.layer_dims and nets.symbols == ref.symbols
              and nets.activation == ref.activation
              and all(torch.equal(a_, b_) for xs, ys in zip(got, want) for a_, b_ in zip(xs, ys)),
              f"{what}: every weight and bias stack equals the source model's bit for bit")

    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp)

        # ---- 46. a NeuroChem ANI-2x ensemble at full width ----
        src = ANI2x(seed=0)
        (root / "ani2x").mkdir()
        t0 = time.perf_counter()
        info = write_neurochem_zoo(root / "ani2x", src, "ani2x")
        write_s = time.perf_counter() - t0
        nbytes = sum(f.stat().st_size for f in (root / "ani2x").rglob("*") if f.is_file())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nc = load_model_from_info(info)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        check(nc.device.type == "cuda", "the NeuroChem model is on the card by default")
        same_stacks(nc.neural_networks, src.neural_networks, "NeuroChem ANI-2x (8 members)")
        aev_n, aev_s = nc.aev_computer, src.aev_computer
        check(nc.symbols == src.symbols and aev_n.out_dim == aev_s.out_dim == 1008
              and torch.equal(nc.energy_shifter.self_energies, src.energy_shifter.self_energies)
              and all(torch.equal(x_, y_) for x_, y_ in zip(
                  list(aev_n.radial.buffers()) + list(aev_n.angular.buffers()),
                  list(aev_s.radial.buffers()) + list(aev_s.angular.buffers()))),
              "NeuroChem ANI-2x: symbols, AEV constants and self energies as the source's")
        kw = aev_n.kernel_kwargs()
        check((len(kw["shifts"]), len(kw["sections"])) == (8, 4), "ANI-2x AEV at K3's 8 x 4")
        for m in (nc, src):
            m.neighborlist = CellList(capacity=96)
        out_nc, paths["neurochem_ani2x_ef"] = ef_counted(nc, "NeuroChem ANI-2x")
        same_ef(out_nc, ef(src), "NeuroChem ANI-2x vs models.ANI2x(seed=0) on the box")
        times = {"neurochem": [], "source": []}
        for _ in range(2):
            for name, m in (("neurochem", nc), ("source", src)):
                times[name] += wall_times_ms(lambda m=m: ef(m), reps=5)
        peak = peak_gib(lambda: ef(nc))
        print(f"{card}: NeuroChem ANI-2x (8 members, {nbytes / 1e6:.1f} MB of files written in "
              f"{write_s:.2f} s): load {load_s:.3f} s; E+F on the {int(sp_np.shape[1])}-atom box "
              f"median {np.median(times['neurochem']):.3f} ms (min {min(times['neurochem']):.3f}) "
              f"against the source model's {np.median(times['source']):.3f} ms (min "
              f"{min(times['source']):.3f}), alternating, 10 each; peak memory {peak:.3f} GiB; "
              f"launches {paths['neurochem_ani2x_ef']}")
        member0 = load_model_from_info(info, model_index=0)
        nets0 = load_atomic_networks(root / "ani2x" / "train0" / "networks", nc.symbols, 1008)
        src0 = ANI2x(model_index=0, seed=0)
        same_stacks(member0.neural_networks, src0.neural_networks, "NeuroChem ANI-2x member 0")
        same_stacks(nets0, src0.neural_networks, "load_atomic_networks of member 0")
        for m in (member0, src0):
            m.neighborlist = CellList(capacity=96)
        out0, paths["neurochem_ani2x_member0_ef"] = ef_counted(member0, "NeuroChem member 0")
        same_ef(out0, ef(src0), "NeuroChem ANI-2x member 0 vs models.ANI2x(model_index=0)")
        del nc, src, member0, src0, nets0, out_nc, out0

        # ---- 47. a NeuroChem ANI-1x member through modules_from_info_file ----
        src1 = ANI1x(seed=0)
        (root / "ani1x").mkdir()
        info1 = write_neurochem_zoo(root / "ani1x", src1, "ani1x")
        aev1, nets1, sae1, sym1 = modules_from_info_file(info1, model_index=0)
        x1 = ANI({"nnp": NNPotential(sym1, aev1, nets1)}, sae1, sym1)
        ref1 = ANI1x(model_index=0, seed=0)
        same_stacks(nets1, ref1.neural_networks, "NeuroChem ANI-1x member 0")
        kw1 = aev1.kernel_kwargs()
        check(aev1.out_dim == 384 and (len(kw1["shifts"]), len(kw1["sections"])) == (4, 8),
              "ANI-1x AEV: 384 wide, K3 at 4 x 8")
        for m in (x1, ref1):
            m.neighborlist = CellList(capacity=96)
        out1, paths["neurochem_ani1x_ef"] = ef_counted(x1, "NeuroChem ANI-1x member 0")
        same_ef(out1, ef(ref1), "NeuroChem ANI-1x member 0 vs models.ANI1x(model_index=0)")
        x1_ms = wall_times_ms(lambda: ef(x1), reps=5)
        print(f"{card}: NeuroChem ANI-1x member 0 E+F on the box: median {np.median(x1_ms):.3f} "
              f"ms; launches {paths['neurochem_ani1x_ef']}")
        del src1, x1, ref1, out1

        # ---- 48. the legacy pipeline feeding force training, revrev and fwdrev ----
        symbols = ("H", "C", "N", "O")
        gsaes = (-0.500607632585, -37.8302333826, -54.5680045287, -75.0362229210)
        teacher = simple_ani(symbols, repulsion=False, seed=99)
        teacher.energy_shifter.enabled = False
        sp_t, co_t = make_molecs(TRAIN_BATCH, TRAIN_ATOMS, seed=0)
        t_e, t_f = energies_and_forces(teacher, sp_t, co_t)
        table = np.zeros(9)
        table[[1, 6, 7, 8]] = gsaes
        labels_e = t_e.double().cpu().numpy() + np.where(sp_t >= 0, table[sp_t], 0.0).sum(1)
        labels_f = t_f.cpu().numpy()
        # pyanitools groups of 256 conformers, per-conformer atomic numbers.
        # The card's machine has no h5py, so `datapacker` and `load` do not
        # run here (the CPU tests hold them against the JAX package's); the
        # chain starts from the same groups as `load` yields them
        groups = [{"species": sp_t[i:i + 256], "coordinates": co_t[i:i + 256],
                   "energies": labels_e[i:i + 256], "forces": labels_f[i:i + 256]}
                  for i in range(0, TRAIN_BATCH, 256)]
        t0 = time.perf_counter()
        loaded = TransformableIterable(_Regenerable(
            lambda: (c for g in groups for c in _split_conformers(g))))
        chain = (loaded.species_to_indices(symbols).subtract_self_energies(gsaes)
                 .shuffle(0).cache().collate(TRAIN_BATCH))
        collated = list(chain)
        chain_s = time.perf_counter() - t0
        check(len(collated) == 1 and collated[0]["species"].shape == (TRAIN_BATCH, TRAIN_ATOMS),
              "the chain collates the 2,560 conformers into one batch")
        pinned = list(Transformations.pin_memory(collated))
        batch = pinned[0]
        check(all(isinstance(t, torch.Tensor) and t.is_pinned() for t in batch.values()),
              "Transformations.pin_memory: every array of the batch is a pinned tensor")
        # the same molecules through `datasets`: an in-memory ANIDataset of
        # the groups, AtomicNumbersToIndices and SubtractSAE
        ds = ANIDataset()
        for gi, g in enumerate(groups):
            ds.append_conformers(f"group{gi:02d}", g)
        whole = {k_: np.concatenate([ds[g][k_] for g in ds.keys()]) for k_ in groups[0]}
        whole = SubtractSAE(symbols, gsaes)(AtomicNumbersToIndices(symbols)(whole))
        order = list(range(TRAIN_BATCH))
        np.random.RandomState(0).shuffle(order)
        ours = strip_redundant_padding({k_: v.numpy() for k_, v in batch.items()})
        theirs = strip_redundant_padding({k_: v[order] for k_, v in whole.items()})
        sae_sum = np.where(theirs["species"] >= 0, np.abs(np.asarray(gsaes))[
            theirs["species"].clip(0)], 0.0).sum(1)
        e_gap = float(np.abs(ours["energies"] - theirs["energies"]).max())
        check(np.array_equal(ours["species"], theirs["species"])
              and np.array_equal(ours["coordinates"], theirs["coordinates"])
              and np.array_equal(ours["forces"], theirs["forces"])
              and bool(np.all(np.abs(ours["energies"] - theirs["energies"])
                              <= 4 * TRAIN_ATOMS * F32_EPS * sae_sum)),
              "the chain's batch equals the same molecules through datasets and transforms "
              "(energies within the f32 rounding of SubtractSAE's sums)")
        model = simple_ani(symbols, ensemble_size=1, repulsion=False, cutoff_fn="cosine",
                           radial_start=0.9, radial_cutoff=5.2, angular_start=0.9,
                           activation="celu", bias=True, seed=0)
        model.energy_shifter.enabled = False
        model.periodic_table_index = False
        b = _device_batch(batch, dev)
        params = list(model.neural_networks.parameters())
        loss_r = energy_force_loss(model, b["species"], b["coordinates"], b["energies"],
                                   b["forces"])
        g_r = torch.autograd.grad(loss_r, params)
        loss_f, surrogate = _force_loss_fwdrev(model, b["species"], b["coordinates"],
                                               b["energies"], b["forces"], 0.1)
        g_f = torch.autograd.grad(surrogate, params)
        loss_r, loss_f = float(loss_r.detach()), float(loss_f.detach())
        loss_gap = abs(loss_f / loss_r - 1)
        grad_err = max(float(((x_ - y_).abs() / y_.abs().max()).max()) for x_, y_ in zip(g_f, g_r))
        print(f"legacy batch: revrev and fwdrev losses {loss_r:.9f} / {loss_f:.9f} "
              f"(relative gap {loss_gap:.3e}); weight gradients max |dg| / max|g| {grad_err:.3e}")
        check(loss_gap <= LEGACY_LOSS_RTOL, "fwdrev's loss as revrev's")
        check(all(bool(((x_ - y_).abs() <= GRAD_ATOL * y_.abs().max() + GRAD_RTOL * y_.abs()).all())
                  for x_, y_ in zip(g_f, g_r)), "fwdrev's weight gradients as revrev's")
        del loss_r, loss_f, surrogate, g_r, g_f
        adamw = adamw_with_plateau(TRAIN_LR)[0]
        modes = {}
        for mode in ("revrev", "fwdrev"):
            init, step = make_train_step(model, adamw, force_training=True, force_grad_mode=mode)
            state = init()
            for _ in range(TRAIN_WARMUP):
                state, m_ = step(state, batch)
            torch.cuda.synchronize()
            reset_counts()
            state, m_ = step(state, batch)
            torch.cuda.synchronize()
            paths[f"legacy_train_{mode}_step"] = read_counts()
            check(paths[f"legacy_train_{mode}_step"] == force_want and bool(torch.isfinite(m_["loss"])),
                  f"legacy batch, {mode}: K3, K3b and K3bb once a step, finite loss")
            _, syncs = count_syncs(lambda step=step, state=state: step(state, batch))
            ms = wall_times_ms(lambda step=step, state=state: step(state, batch), reps=TRAIN_STEPS)
            modes[mode] = {"ms": ms, "syncs": syncs,
                           "peak": peak_gib(lambda step=step, state=state: step(state, batch))}
        for mode, v in modes.items():
            med = float(np.median(v["ms"]))
            print(f"{card}: legacy batch force step, {mode}: median {med:.3f} ms (min "
                  f"{min(v['ms']):.3f}, max {max(v['ms']):.3f}, {TRAIN_STEPS} steps after "
                  f"{TRAIN_WARMUP + 1}), {TRAIN_BATCH / med * 1e3:,.0f} samples/s; launches "
                  f"{paths[f'legacy_train_{mode}_step']}; {v['syncs']} host syncs a step; peak "
                  f"memory {v['peak']:.3f} GiB")
        print(f"{card}: fwdrev / revrev {np.median(modes['fwdrev']['ms']) / np.median(modes['revrev']['ms']):.3f}; "
              f"phase 42's revrev step in this call median {np.median(revrev_ms):.3f} ms; one "
              f"pass of the legacy chain over {TRAIN_BATCH} conformers {chain_s:.3f} s of host time")
        del model, teacher, batch, pinned, b, state

        # ---- 49. make_solvated_system and the profiling API on the card ----
        wz, wc, wcell = make_water_box(SOLV_TEMPLATE_ATOMS, seed=4)
        write_pdb(root / "water.pdb", wz[0], wc[0], float(wcell[0, 0]))
        ssp, sco = make_chain_molecs(1, SOLV_SOLUTE_ATOMS, seed=6)
        real = ssp[0] >= 0
        write_pdb(root / "solute.pdb", ssp[0][real], sco[0][real], resname="LIG")
        s_species, s_coords, s_cell = make_solvated_system(
            root / "solute.pdb", root / "water.pdb", SOLV_BOX)
        n_sol = int(real.sum())
        d = s_coords[n_sol:, None, :] - s_coords[None, :n_sol, :]
        d -= np.round(d / SOLV_BOX) * SOLV_BOX
        min_d = float(np.sqrt((d ** 2).sum(-1)).min())
        check(min_d > 1.7 and (s_species[n_sol:].reshape(-1, 3) == [8, 1, 1]).all()
              and float(s_cell[0, 0]) == np.float32(SOLV_BOX),
              "solvated system: whole waters, none within 1.7 A of the solute")
        solv = ANI2x(seed=0)
        solv.neighborlist = CellList(capacity=96)
        s_sp = torch.as_tensor(s_species[None], device=dev)
        s_co = torch.as_tensor(s_coords[None], device=dev)
        s_ce = torch.as_tensor(s_cell, device=dev)

        def s_ef():
            return energies_and_forces(solv, s_sp, s_co, s_ce, pbc)

        # the chain solute is denser than the liquid that the AEV's default
        # angular table is sized for (its generator keeps non-bonded atoms
        # 1.6 A apart): past that table's lanes the AEV poisons the energies
        # with NaN, as designed in both packages.  The model takes the JAX
        # rule's capacity for the densest atom (15% margin, a multiple of 4)
        aevc = solv.aev_computer
        nb_s = solv.neighborlist(solv.cutoff, solv._convert(s_sp), s_co, s_ce, pbc)
        ang_max = int(narrow_to_cutoff(nb_s, float(aevc.angular.cutoff)).mask.sum(-1).max())
        default_cap = aevc._angular_capacity(nb_s.capacity)
        solv_cap = 4 * int(np.ceil(ang_max * 1.15 / 4))
        e_default = s_ef()[0]
        check(ang_max <= default_cap or bool(torch.isnan(e_default).all()),
              "solvated system: an atom past the default angular table gives NaN energies")
        aevc.angular_capacity = solv_cap
        del nb_s
        torch.cuda.synchronize()
        reset_counts()
        e_s, f_s = s_ef()
        torch.cuda.synchronize()
        paths["solvated_ef"] = read_counts()
        check(bool(torch.isfinite(e_s).all()) and bool(torch.isfinite(f_s).all()),
              "solvated E+F: finite energies and forces")
        check(paths["solvated_ef"] == ef_want, "solvated E+F: K3 and K3b once each")
        timer = profiling.Timer()
        out = timer.time_fn("ef", s_ef, iters=10)
        check(profiling.sync(out) is out, "profiling.sync returns its tree")
        ev_ms = cuda_ms(s_ef, reps=10)
        # a window whose trace holds no kernel (the profiler's device
        # tracing drops one now and then, see `kernels_ms`) is taken again,
        # up to three times, each into a directory of its own
        for attempt in range(3):
            with profiling.trace(str(root / f"trace{attempt}")) as log_dir:
                with profiling.scope("aev"):
                    s_ef()
                torch.cuda.synchronize()
            trace_files = sorted(pathlib.Path(log_dir).glob("*.json"))
            trace_text = trace_files[0].read_text() if trace_files else ""
            if "angular_aev_kernel" in trace_text:
                break
        check(len(trace_files) == 1 and '"aev"' in trace_text and "angular_aev_kernel" in trace_text,
              f"profiling.trace wrote one trace naming the scope and K3 ({attempt + 1} windows)")
        md = MolecularDynamics(solv, s_sp, cell=s_ce, pbc=True)
        st = md.init(s_co, temperature=300.0, generator=torch.Generator().manual_seed(0))
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        st = md.run_nve(st, SOLV_MD_STEPS)
        torch.cuda.synchronize()
        md_ms = (time.perf_counter() - t0) * 1e3 / SOLV_MD_STEPS
        paths["solvated_md"] = read_counts()
        check(st.step == SOLV_MD_STEPS and not bool(st.overflow)
              and bool(torch.isfinite(st.forces).all()), "solvated NVE: finite, no overflow")
        check(paths["solvated_md"]["angular_aev"] == paths["solvated_md"]["angular_aev_bwd"]
              == paths["solvated_md"]["bucket_select_bwd"] == SOLV_MD_STEPS
              and paths["solvated_md"]["bucket_select_fwd"] >= SOLV_MD_STEPS,
              "solvated NVE: K2, K3 and K3b once a step, K1 at least once")
        rng = np.random.RandomState(8)
        xm = torch.as_tensor((rng.randn(s_coords.shape[0], 3) * 20).astype(np.float32), device=dev)
        mm = torch.as_tensor(rng.randn(3, 3).astype(np.float32), device=dev)
        got = exact_matmul(xm, mm).double()
        exact = xm.double() @ mm.double()
        bound = 4 * F32_EPS * (xm.double().abs() @ mm.double().abs())
        check(torch.backends.cuda.matmul.allow_tf32 is False
              and bool(((got - exact).abs() <= bound).all()),
              "exact_matmul on the card: an f64 product within f32 rounding (no TF32)")
        print(f"{card}: solvated system: {n_sol}-atom solute in {SOLV_BOX} A of water tiled from "
              f"a {int(wz.shape[1])}-atom template: {s_species.shape[0]} atoms, closest water "
              f"atom {min_d:.3f} A; the densest atom has {ang_max} angular neighbours (the "
              f"default table {default_cap} lanes, energies then {e_default.tolist()}), so the "
              f"angular table takes {solv_cap}; E+F launches {paths['solvated_ef']}; Timer.time_fn "
              f"{timer.totals['ef'] / timer.counts['ef'] * 1e3:.3f} ms a call (10 after one, one "
              f"sync) against cuda_ms {ev_ms:.3f} ms; {SOLV_MD_STEPS} NVE steps at 300 K "
              f"{md_ms:.3f} ms a step, {st.rebuilds} rebuilds, launches {paths['solvated_md']}; "
              f"trace {trace_files[0].name} ({len(trace_text) / 1e6:.1f} MB, window "
              f"{attempt + 1}) names 'aev' and angular_aev_kernel; exact_matmul max |d| {float((got - exact).abs().max()):.3e}")
        print(timer.report())
        del solv, md, st, out
    print(f"new phases (NeuroChem, legacy data, solvation, profiling): "
          f"{time.perf_counter() - t_phases:.1f} s of wall time")
    return {"launches": paths}

def kernel_wrappers() -> dict:
    """The nine kernels' wrappers by name; each counts its launches in
    ``launches``."""
    from torchani_tpu_torch.aev.kernels import angular_aev, angular_aev_bwd, angular_aev_bwd_bwd
    from torchani_tpu_torch.bucket_refresh import (
        bucket_select_bwd,
        bucket_select_fwd,
        vals_select_bwd,
        vals_select_fwd,
    )
    from torchani_tpu_torch.bucket_refresh_packed import packed_select_bwd, packed_select_fwd

    return {
        "angular_aev": angular_aev,
        "angular_aev_bwd": angular_aev_bwd,
        "angular_aev_bwd_bwd": angular_aev_bwd_bwd,
        "bucket_select_fwd": bucket_select_fwd,
        "bucket_select_bwd": bucket_select_bwd,
        "vals_select_fwd": vals_select_fwd,
        "vals_select_bwd": vals_select_bwd,
        "packed_select_fwd": packed_select_fwd,
        "packed_select_bwd": packed_select_bwd,
    }


def launch_counts(kernels: dict) -> tuple:
    """``(reset, read)``: set every wrapper's count to 0; read them all, by name."""
    def reset():
        for fn in kernels.values():
            fn.launches = 0

    def read():
        return {name: fn.launches for name, fn in kernels.items()}

    return reset, read


def shard_select_errors(smd, state) -> tuple:
    """K1 and K2 at a `ShardedMolecularDynamics`' own block of buckets (G' / D of them)
    against their plain versions: K1's max error over the occupied lanes
    (it leaves the others unwritten; 0 required), K2's max error (within
    1e-5 (1 + |p|) required), and the block's G."""
    from torchani_tpu_torch.bucket_refresh import (
        bucket_select_bwd,
        bucket_select_bwd_reference,
        bucket_select_fwd,
        bucket_select_reference,
        cand_table_from_slots,
        slot_positions,
    )

    b = state.bucket
    grid = tuple(b.wrapshift.shape[:3])
    g = grid[0] * grid[1] * grid[2]
    c = b.atom_of_slot.shape[0] // g
    gl = b.keys_pad.shape[0] // smd.num_shards
    blk = slice(smd.shard * gl, (smd.shard + 1) * gl)
    with torch.no_grad():
        canon = smd._to_internal(state.coords) - b.wrap_offset
        cand = cand_table_from_slots(slot_positions(canon, b.atom_of_slot, b.slot_of_atom),
                                     b.wrapshift, grid, c)
        cand = torch.nn.functional.pad(cand, (0, 0, 0, 0, 0, 0, 0, b.keys_pad.shape[0] - g))
        cand_l, keys_l, nl_l = cand[blk].contiguous(), b.keys_pad[blk], b.nlanes[blk]
        out = bucket_select_fwd(cand_l, keys_l, nl_l)
        ref = bucket_select_reference(cand_l, keys_l, nl_l)
        occupied = (torch.arange(keys_l.shape[1], device=out.device)[None, :] < nl_l[:, None])
        k1_err = float(torch.where(occupied[..., None], (out - ref).abs(), 0.0).max())
        gen = torch.Generator(out.device).manual_seed(50 + smd.shard)
        g_out = torch.randn(out.shape, device=out.device, generator=gen)
        d_k = bucket_select_bwd(g_out, keys_l, c, nl_l)
        d_ref = bucket_select_bwd_reference(g_out, keys_l, c, nl_l)
    check(k1_err == 0.0, f"K1 at the shard's {gl} buckets equals its plain version")
    check(within(d_k, d_ref, 1e-5), f"K2 at the shard's {gl} buckets within 1e-5 of its plain version")
    return k1_err, float((d_k - d_ref).abs().max()), gl


def sharded_md_run(smd, state, steps: int, counts) -> tuple:
    """``steps`` NVE steps of an MD runner, each timed to a synchronize,
    with the kernels' launches counted over them: ``(state, ms a step,
    launches, peak GiB)``."""
    reset, read = counts
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        state = smd.step_nve(state)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return state, times, read(), torch.cuda.max_memory_allocated() / 2**30


def sharded_md_case(model, box, mesh, velocities, counts) -> tuple:
    """Phases 50 and 51 on one process: `ShardedMolecularDynamics` on the
    water box ``box`` over ``mesh``, `init`, K1 and K2 at this process's
    block of buckets (`shard_select_errors`), then PAR_MD_STEPS NVE steps
    from ``velocities`` (`sharded_md_run`).  Returns the results, the driver
    and its last state."""
    from torchani_tpu_torch.parallel import ShardedMolecularDynamics
    from torchani_tpu_torch.parallel.md import ExchangeTables

    species, coords, cell = box
    smd = ShardedMolecularDynamics(model, species, mesh, cell=cell, pbc=True)
    st = smd.init(coords)
    out = {"exchange": isinstance(st.bucket, ExchangeTables), "init_energy": float(st.energy),
           "init_forces": st.forces.cpu().numpy()}
    st = st.replace(velocities=torch.as_tensor(velocities, device=st.coords.device))
    out["k1_err"], out["k2_err"], out["g_block"] = shard_select_errors(smd, st)
    st, out["md_ms"], out["md_launches"], out["md_peak"] = sharded_md_run(
        smd, st, PAR_MD_STEPS, counts)
    out.update(coords=st.coords.cpu().numpy(), overflow=bool(st.overflow), rebuilds=st.rebuilds,
               t_cap=smd._exch_T)
    return out, smd, st


def training_batch(dev) -> dict:
    """Phase 42's batch: `make_molecs(TRAIN_BATCH, TRAIN_ATOMS, seed=0)`."""
    from torchani_tpu_torch.testing import make_molecs

    sp_t, co_t = make_molecs(TRAIN_BATCH, TRAIN_ATOMS, seed=0)
    return {
        "species": torch.as_tensor(sp_t, device=dev), "coordinates": torch.as_tensor(co_t, device=dev),
        "energies": torch.as_tensor(np.random.RandomState(1).randn(TRAIN_BATCH).astype(np.float32),
                                    device=dev),
        "forces": torch.zeros(co_t.shape, device=dev),
    }


def sharded_training(mesh, counts) -> dict:
    """One SGD force step of the 8-member ANI-2x (seed 0, no self energies)
    on phase 42's batch with the networks from `shard_ensemble` and the
    batch from `shard_batch` (this process's members and molecules), its
    launches, then PAR_TIMED more steps timed."""
    import copy
    import functools

    from torchani_tpu_torch.models import ANI2x
    from torchani_tpu_torch.parallel import shard_batch, shard_ensemble
    from torchani_tpu_torch.training import make_train_step

    reset, read = counts
    model = ANI2x(seed=0)
    model.energy_shifter.enabled = False
    init, step = make_train_step(model, functools.partial(torch.optim.SGD, lr=TRAIN_LR),
                                 force_training=True)
    state = init(shard_ensemble(copy.deepcopy(model.neural_networks), mesh))
    batch = shard_batch(training_batch(torch.device("cuda")), mesh)
    torch.cuda.synchronize()
    reset()
    state, m = step(state, batch)
    torch.cuda.synchronize()
    launches = read()
    params = {n: p.detach().cpu().numpy().copy() for n, p in state.networks.named_parameters()}
    times = []
    for _ in range(PAR_TIMED):
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return {"loss": float(m["loss"]), "params": params, "launches": launches, "ms": times,
            "model_rank": mesh.get_local_rank("model"), "members": state.networks.weights[0].shape[0]}


def parallel_rank(rank: int, root: str) -> None:
    """One of the two processes of phases 51 and 52 (gloo, both on the one
    card): the sharded MD on the water box and the sharded training step;
    results, or the traceback, into ``root``."""
    import datetime
    import pickle
    import traceback

    try:
        torch.cuda.set_device(0)
        with open(f"{root}/payload.pkl", "rb") as f:
            p = pickle.load(f)
        torch.distributed.init_process_group(
            "gloo", init_method=f"file://{root}/rendezvous", world_size=2, rank=rank,
            timeout=datetime.timedelta(seconds=PAR_COLLECTIVE_S))
        from torch.distributed.device_mesh import init_device_mesh

        from torchani_tpu_torch.models import ANI2x
        from torchani_tpu_torch.parallel import make_mesh
        from torchani_tpu_torch.testing import make_water_box

        counts = launch_counts(kernel_wrappers())
        out, smd, st = sharded_md_case(
            ANI2x(seed=0), make_water_box(10002),
            init_device_mesh("cuda", (2,), mesh_dim_names=("atoms",)), p["velocities"], counts)
        b = st.bucket
        per = b.aos_pad.shape[0] // 2
        sent = (b.send_idx[rank] < per).reshape(2, -1).sum(dim=1).cpu().numpy()
        out["rows_sent"] = {"to_self": int(sent[rank]), "to_other": int(sent[1 - rank])}
        del smd, st, b
        torch.cuda.empty_cache()
        out["train"] = sharded_training(make_mesh(n_data=1, n_model=2), counts)
        torch.distributed.destroy_process_group()
        with open(f"{root}/rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    except BaseException:
        with open(f"{root}/rank{rank}.err", "w") as f:
            f.write(traceback.format_exc())
        raise


def gloo_ranks(root: str, velocities) -> list:
    """Phases 51 and 52 b: `parallel_rank` in two spawned processes, joined
    (or killed) within PAR_JOIN_S; their results, by rank."""
    import multiprocessing
    import pickle

    with open(f"{root}/payload.pkl", "wb") as f:
        pickle.dump({"velocities": velocities}, f)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=parallel_rank, args=(r, root)) for r in range(2)]
    t0 = time.perf_counter()
    for p_ in procs:
        p_.start()
    for p_ in procs:
        p_.join(max(0.0, PAR_JOIN_S - (time.perf_counter() - t0)))
    hung = [p_ for p_ in procs if p_.is_alive()]
    for p_ in hung:
        p_.kill()
        p_.join()
    errs = [open(f"{root}/{n}").read() for n in sorted(os.listdir(root)) if n.endswith(".err")]
    check(not hung and all(p_.exitcode == 0 for p_ in procs),
          f"phases 51-52: both gloo processes end within {PAR_JOIN_S} s\n" + "\n".join(errs))
    ranks = []
    for r in range(2):
        with open(f"{root}/rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ranks


def parallel_phases(card: str) -> dict:
    """Phases 50-52: `parallel` on the card.  50: `ShardedMolecularDynamics`
    on an NCCL group of one process; 51: on a gloo group of two processes
    on the one card; 52: `make_mesh`, `shard_batch`, `shard_ensemble` and
    the unchanged `make_train_step` as 1 x 1 on NCCL and 1 data x 2 model
    on gloo.  The card is one H100: these phases prove results and launch
    counts, not scaling.  Returns the launches of each path and K1's and
    K2's errors at the shards' tables."""
    import copy
    import datetime
    import functools

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from torchani_tpu_torch.md import MolecularDynamics
    from torchani_tpu_torch.models import ANI2x
    from torchani_tpu_torch.parallel import make_mesh
    from torchani_tpu_torch.profiling import wall_times_ms
    from torchani_tpu_torch.testing import make_water_box
    from torchani_tpu_torch.training import make_train_step

    t_phases = time.perf_counter()
    kernels = kernel_wrappers()
    counts = launch_counts(kernels)
    md_want = {n: PAR_MD_STEPS if n in ("angular_aev", "angular_aev_bwd", "bucket_select_fwd",
                                        "bucket_select_bwd") else 0 for n in kernels}
    train_want = {n: int(n.startswith("angular")) for n in kernels}
    paths, errors = {}, {}
    box = make_water_box(10002)
    species, coords, cell = box

    # the single-device references on the card: init at 300 K (phase 5's
    # start), PAR_MD_STEPS NVE steps; the unsharded SGD force step
    model = ANI2x(seed=0)
    md1 = MolecularDynamics(model, species, cell=cell, pbc=True)
    start1 = md1.init(coords, temperature=300.0, generator=torch.Generator().manual_seed(0))
    end1, ms1, _, peak1 = sharded_md_run(md1, start1, PAR_MD_STEPS, counts)
    t_model = ANI2x(seed=0)
    t_model.energy_shifter.enabled = False
    init, step = make_train_step(t_model, functools.partial(torch.optim.SGD, lr=TRAIN_LR),
                                 force_training=True)
    t_batch = training_batch(torch.device("cuda"))
    t_state, t_m = step(init(copy.deepcopy(t_model.neural_networks)), t_batch)
    ref_params = {n: p.detach().cpu().numpy().copy() for n, p in t_state.networks.named_parameters()}
    ref_loss = float(t_m["loss"])
    t_ms = wall_times_ms(lambda: step(t_state, t_batch), reps=PAR_TIMED)
    del t_state, t_model, t_batch

    def check_md(tag, out):
        check(out["exchange"], f"{tag}: the sharded refresh is engaged")
        de = abs(out["init_energy"] - float(start1.energy)) / abs(float(start1.energy))
        df = float(np.abs(out["init_forces"] - start1.forces.cpu().numpy()).max())
        dx = float(np.abs(out["coords"] - end1.coords.cpu().numpy()).max())
        check(de <= PAR_E_RTOL and df <= PAR_F_ATOL,
              f"{tag}: init energy (rel {de:.2e}) and forces ({df:.2e}) equal MolecularDynamics'")
        check(dx <= PAR_COORD_ATOL, f"{tag}: {PAR_MD_STEPS} NVE steps within {PAR_COORD_ATOL} A "
              f"of the single-device run ({dx:.2e})")
        check(out["md_launches"] == md_want,
              f"{tag}: K1, K2, K3 and K3b once per step, no other kernel ({out['md_launches']})")
        check(not out["overflow"], f"{tag}: no overflow")
        return de, df, dx

    def check_train(tag, tr):
        rel = abs(tr["loss"] - ref_loss) / abs(ref_loss)
        check(rel <= PAR_LOSS_RTOL, f"{tag}: the loss equals the unsharded step's (rel {rel:.2e})")
        worst, m, r = 0.0, tr["members"], tr["model_rank"]
        for n, v in tr["params"].items():
            want = ref_params[n][r * m:(r + 1) * m]
            check(bool(np.all(np.abs(v - want) <= PAR_P_ATOL + PAR_P_RTOL * np.abs(want))),
                  f"{tag}: {n} equals the unsharded step's members")
            worst = max(worst, float(np.abs(v - want).max()))
        check(tr["launches"] == train_want,
              f"{tag}: K3, K3b and K3bb once in the step, no other kernel ({tr['launches']})")
        return rel, worst

    with tempfile.TemporaryDirectory(prefix="chip_smoke_parallel_") as root:
        # ---- 50. ShardedMolecularDynamics on NCCL, a world of one ----
        dist.init_process_group("nccl", init_method=f"file://{root}/nccl", world_size=1, rank=0,
                                timeout=datetime.timedelta(seconds=PAR_COLLECTIVE_S))
        try:
            out, smd, st = sharded_md_case(
                model, box, init_device_mesh("cuda", (1,), mesh_dim_names=("atoms",)),
                start1.velocities, counts)
            paths["sharded_md_nccl1"] = out["md_launches"]
            errors["nccl1"] = {"k1": out["k1_err"], "k2": out["k2_err"], "g": out["g_block"]}
            de, df, dx = check_md("phase 50 (NCCL, 1 process)", out)
            # single-device and sharded steps alternately, for the times
            alt = {"single": [end1, md1, []], "sharded": [st, smd, []]}
            for _ in range(PAR_MD_STEPS):
                for run in alt.values():
                    t0 = time.perf_counter()
                    run[0] = run[1].step_nve(run[0])
                    torch.cuda.synchronize()
                    run[2].append((time.perf_counter() - t0) * 1e3)
            alt1, alt50 = alt["single"][2], alt["sharded"][2]
            print(f"{card}: phase 50, ShardedMolecularDynamics on NCCL (1 process, 10,002 atoms, "
                  f"exchange T = {out['t_cap']}, {out['g_block']} buckets): init |dE|/E {de:.2e}, "
                  f"max |dF| {df:.2e} Ha/A, {PAR_MD_STEPS} steps max |dx| {dx:.2e} A against "
                  f"MolecularDynamics; K1 at the shard's tables err {out['k1_err']:.1e}, K2 "
                  f"{out['k2_err']:.2e}; launches {out['md_launches']}; ms a step: counted run "
                  f"median {np.median(out['md_ms']):.3f} (single-device {np.median(ms1):.3f}), "
                  f"alternating median {np.median(alt50):.3f} against {np.median(alt1):.3f}; "
                  f"peak {out['md_peak']:.3f} GiB (single-device {peak1:.3f}), {held_gib():.3f} held")
            del smd, st, alt

            # ---- 52 a. sharded training on NCCL, 1 x 1 ----
            tr = sharded_training(make_mesh(n_data=1, n_model=1), counts)
            paths["train_sharded_nccl1"] = tr["launches"]
            rel, worst = check_train("phase 52 (NCCL, 1 x 1)", tr)
            print(f"{card}: phase 52, sharded SGD force step of the 8-member ANI-2x on NCCL, 1 x 1, "
                  f"batch {TRAIN_BATCH} x {TRAIN_ATOMS}: loss rel {rel:.2e}, parameters max |d| "
                  f"{worst:.2e} against the unsharded step; launches {tr['launches']}; median "
                  f"{np.median(tr['ms']):.3f} ms a step against the unsharded {np.median(t_ms):.3f}")
        finally:
            dist.destroy_process_group()
        torch.cuda.empty_cache()

        # ---- 51 and 52 b. two processes on gloo, both on the one card ----
        ranks = gloo_ranks(root, start1.velocities.cpu().numpy())
    check(np.array_equal(ranks[0]["coords"], ranks[1]["coords"]),
          "phase 51: both processes hold the same coordinates, to the bit")
    for r, out in enumerate(ranks):
        tag = f"phase 51 (gloo, rank {r} of 2)"
        de, df, dx = check_md(tag, out)
        paths[f"sharded_md_gloo2_rank{r}"] = out["md_launches"]
        errors[f"gloo2_rank{r}"] = {"k1": out["k1_err"], "k2": out["k2_err"], "g": out["g_block"]}
        print(f"{card}: {tag}: exchange T = {out['t_cap']}, slot rows sent {out['rows_sent']}, "
              f"K1 at the shard's {out['g_block']} buckets err {out['k1_err']:.1e}, K2 "
              f"{out['k2_err']:.2e}; init |dE|/E {de:.2e}, max |dF| {df:.2e} Ha/A, "
              f"{PAR_MD_STEPS} steps max |dx| {dx:.2e} A, {out['rebuilds']} rebuilds; launches "
              f"{out['md_launches']}; median {np.median(out['md_ms']):.3f} ms a step (gloo through "
              f"host memory, two processes on one card: not a scaling number); peak "
              f"{out['md_peak']:.3f} GiB")
        tr = out["train"]
        tag = f"phase 52 (gloo, 1 data x 2 model, rank {r})"
        rel, worst = check_train(tag, tr)
        check(tr["members"] == 4, f"{tag}: 4 members a process")
        paths[f"train_sharded_gloo2_rank{r}"] = tr["launches"]
        print(f"{card}: {tag}: {tr['members']} members, loss rel {rel:.2e}, parameters max |d| "
              f"{worst:.2e} against the unsharded step; launches {tr['launches']}; median "
              f"{np.median(tr['ms']):.3f} ms a step (gloo through host memory: not a scaling "
              f"number)")
    print(f"new phases (parallel): {time.perf_counter() - t_phases:.1f} s of wall time")
    return {"launches": paths, "errors": errors}


def higher_order_phases(card: str, kernels_fn: dict, reset_counts, read_counts) -> dict:
    """Phase 53: third derivatives of ANI-2x (8 members, seed 0) on phase
    20's 30-water cluster, card against CPU.  For THIRD_PAIRS seeded (u, v),
    grad <grad <grad E, u>, v>; then the weight gradient of sum (H w)^2 for
    one Hessian-vector product H w.  On the card the third pass runs K3bb's
    backward, `_bwd_bwd_vjp`, a plain recompute in atom blocks (one
    `angular_grid` call a block); every other angular step is a kernel.
    Exact launches a third derivative: K3 once, K3b and K3bb three times
    (the third pass reaches K3b's first node through the lanes' second
    derivative as well as K3b's second node); the weight gradient: K3 once,
    K3b twice, K3bb three times (nothing below the AEV leads to a weight).
    Then one third derivative of the THIRD_BOX_ATOMS-atom box (a cell list,
    periodic): the same launches, the recompute's blocks, its time and peak
    memory, and the bytes the recompute holds per element of a block's grid
    (against `_THIRD_ORDER_GRID_BYTES`, measured on the CPU).  Returns the
    launches of each path and the numbers printed."""
    from torchani_tpu_torch.aev import computer as aev_computer
    from torchani_tpu_torch.aev.computer import _GRID_BYTES, _THIRD_ORDER_GRID_BYTES
    from torchani_tpu_torch.aev.kernels import angular_grid
    from torchani_tpu_torch.models import ANI2x
    from torchani_tpu_torch.neighbors import CellList
    from torchani_tpu_torch.profiling import peak_gib, wall_times_ms
    from torchani_tpu_torch.testing import make_water_box

    t_phase = time.perf_counter()
    sp, co, _ = make_water_box(90)
    rng = np.random.RandomState(53)
    uv = [tuple(rng.randn(*co.shape).astype(np.float32) for _ in range(2))
          for _ in range(THIRD_PAIRS)]
    w = rng.randn(*co.shape).astype(np.float32)
    models = {where: ANI2x(pretrained=False, seed=0, device=where) for where in ("cuda", "cpu")}

    def grad_e(m, x, species=sp, box=()):
        (f,) = torch.autograd.grad(m(species, x, *box).sum(), x, create_graph=True)
        return f

    def hvp(m, x, d, **system):
        d = torch.as_tensor(d, device=x.device)
        (h,) = torch.autograd.grad((grad_e(m, x, **system) * d).sum(), x, create_graph=True)
        return h

    def third(m, u, v, coords=co, **system):
        x = torch.as_tensor(coords, device=m.device).clone().requires_grad_(True)
        (t,) = torch.autograd.grad(
            (hvp(m, x, u, **system) * torch.as_tensor(v, device=x.device)).sum(), x)
        return t

    def recompute_blocks(m, species, coords, box=()):
        """Rows, lanes, rows a block and blocks of `_bwd_bwd_vjp`'s recompute."""
        aevc = m.aev_computer
        elem = m._convert(torch.as_tensor(species, device="cuda"))
        x = torch.as_tensor(coords, device="cuda")
        nbrs = m.neighborlist(m.cutoff, elem, x, *(box or (None, None)))
        _, ang, _ = aevc.flat_tables(elem, nbrs)
        ka, rows_n = ang.capacity, ang.idx.shape[0]
        block = max(1, aevc._atom_block(ka) * _GRID_BYTES // _THIRD_ORDER_GRID_BYTES)
        return rows_n, ka, block, -(-rows_n // block)

    def weight_grads(m):
        x = torch.as_tensor(co, device=m.device).clone().requires_grad_(True)
        params = list(m.parameters())
        grads = torch.autograd.grad((hvp(m, x, w) ** 2).sum(), params, allow_unused=True)
        return [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]

    def close(out, ref) -> float:
        ref = ref.detach().cpu()
        diff = (out.detach().cpu() - ref).abs()
        check(bool(torch.isfinite(out).all()), "phase 53: finite")
        check(bool((diff <= THIRD_ATOL * ref.abs().max() + THIRD_RTOL * ref.abs()).all()),
              "phase 53: card against CPU")
        return float(diff.max() / ref.abs().max().clamp(min=1e-30))

    card_model = models["cuda"]
    rows_n, ka, block, blocks = recompute_blocks(card_model, sp, co)
    launches, errs = {}, []
    want_third = {"angular_aev": 1, "angular_aev_bwd": 3, "angular_aev_bwd_bwd": 3}
    for i, (u, v) in enumerate(uv):
        reset_counts()
        t_card = third(card_model, u, v)
        torch.cuda.synchronize()
        launches[f"third_derivative_{i}"] = counts = read_counts()
        grid = angular_grid.calls
        print(f"phase 53: third derivative {i}: launches {counts}, angular_grid calls {grid} "
              f"(predicted {blocks}: {rows_n} rows, Ka = {ka}, blocks of {block})")
        check(counts == {k_: want_third.get(k_, 0) for k_ in kernels_fn} and grid == blocks,
              "phase 53: a third derivative launches K3 once, K3b and K3bb three times, "
              "and calls angular_grid once a recompute block")
        errs.append(close(t_card, third(models["cpu"], u, v)))
    reset_counts()
    g_card = weight_grads(card_model)
    torch.cuda.synchronize()
    launches["hessian_loss_weight_grad"] = counts = read_counts()
    grid = angular_grid.calls
    print(f"phase 53: weight gradient of sum (H w)^2: launches {counts}, angular_grid calls {grid}")
    check(counts == {k_: {"angular_aev": 1, "angular_aev_bwd": 2,
                          "angular_aev_bwd_bwd": 3}.get(k_, 0) for k_ in kernels_fn}
          and grid == blocks,
          "phase 53: the Hessian-loss weight gradient launches K3 once, K3b twice, K3bb three "
          "times, and calls angular_grid once a recompute block")
    g_cpu = weight_grads(models["cpu"])
    g_err = max(close(a, b) for a, b in zip(g_card, g_cpu))
    check(any(float(g.abs().max()) > 0 for g in g_card), "phase 53: some weight gradient is nonzero")
    u, v = uv[0]
    third_ms = wall_times_ms(lambda: third(card_model, u, v), reps=3)
    held = held_gib()
    third_peak = peak_gib(lambda: third(card_model, u, v))
    wg_ms = wall_times_ms(lambda: weight_grads(card_model), reps=3)
    wg_peak = peak_gib(lambda: weight_grads(card_model))
    print(f"{card}: phase 53: third derivative of {co.shape[1]} atoms: max |dt| / max|t| card vs "
          f"CPU {max(errs):.2e}; median {np.median(third_ms):.3f} ms ({third_ms}); peak device "
          f"memory {third_peak:.3f} GiB ({held:.3f} held before the call); Hessian-loss weight "
          f"gradient max |dg| / max|g| {g_err:.2e}, median {np.median(wg_ms):.3f} ms, peak "
          f"{wg_peak:.3f} GiB")

    # the box: the recompute in many blocks, on the card alone
    del models["cpu"]
    b_sp, b_co, b_cell = make_water_box(THIRD_BOX_ATOMS)
    box_model = ANI2x(pretrained=False, seed=0)
    box_model.neighborlist = CellList(capacity=96)
    box = (torch.as_tensor(b_cell, dtype=torch.float32, device="cuda"),
           torch.ones(3, dtype=torch.bool, device="cuda"))
    b_rows, b_ka, b_block, b_blocks = recompute_blocks(box_model, b_sp, b_co, box)
    b_u, b_v = (rng.randn(*b_co.shape).astype(np.float32) for _ in range(2))

    def third_box():
        return third(box_model, b_u, b_v, coords=b_co, species=b_sp, box=box)

    # the recompute's own peak: each call of `_bwd_bwd_vjp` measured alone
    real_vjp, vjp_peaks = aev_computer._bwd_bwd_vjp, []

    def measured_vjp(*args):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = real_vjp(*args)
        torch.cuda.synchronize()
        vjp_peaks.append(torch.cuda.max_memory_allocated() - base)
        return out

    reset_counts()
    aev_computer._bwd_bwd_vjp = measured_vjp
    try:
        t_box = third_box()
        torch.cuda.synchronize()
    finally:
        aev_computer._bwd_bwd_vjp = real_vjp
    launches["third_derivative_box"] = counts = read_counts()
    grid = angular_grid.calls
    print(f"phase 53: third derivative of the {b_co.shape[1]}-atom box: launches {counts}, "
          f"angular_grid calls {grid} (predicted {b_blocks}: {b_rows} rows, Ka = {b_ka}, "
          f"blocks of {b_block})")
    check(counts == {k_: want_third.get(k_, 0) for k_ in kernels_fn} and grid == b_blocks,
          "phase 53: the box's third derivative launches K3 once, K3b and K3bb three times, "
          "and calls angular_grid once a recompute block")
    check(bool(torch.isfinite(t_box).all()) and float(t_box.abs().max()) > 0,
          "phase 53: the box's third derivative is finite and nonzero")
    box_ms = wall_times_ms(third_box, reps=2)
    held = held_gib()
    box_peak = peak_gib(third_box)
    grid_elems = b_block * b_ka * b_ka * box_model.aev_computer.angular.num_feats
    per_elem = max(vjp_peaks) / grid_elems
    print(f"{card}: phase 53: third derivative of the {b_co.shape[1]}-atom box: median "
          f"{np.median(box_ms):.3f} ms ({box_ms}); peak device memory {box_peak:.3f} GiB "
          f"({held:.3f} held before the call); the recompute ({len(vjp_peaks)} call(s)) peaks "
          f"at {max(vjp_peaks) / 2**30:.3f} GiB above what it was given: {per_elem:.1f} B a "
          f"grid element of one block (the blocks' size takes {_THIRD_ORDER_GRID_BYTES})")
    wall_s = time.perf_counter() - t_phase
    print(f"new phase (53, third derivatives): {wall_s:.1f} s of wall time")
    return {"launches": launches, "third_ms": third_ms, "third_peak": third_peak,
            "weight_grad_ms": wg_ms, "weight_grad_peak": wg_peak, "blocks": blocks,
            "err": max(errs), "weight_grad_err": g_err, "box_ms": box_ms, "box_peak": box_peak,
            "box_blocks": b_blocks, "grid_bytes": per_elem}


def xyz_phases(card: str, kernels_fn: dict, reset_counts, read_counts) -> dict:
    """Phase 54: the native xyz parser.  It must build and load here (no
    degrade).  XYZ_FRAMES frames of the 10,002-atom box (shifted by 0.5 A,
    so that every coordinate is at least 0.45 A and ``%.10f`` gives each f32
    back exactly; 0.01 A seeded perturbations after frame 0) written with
    `write_xyz` and its cell, read natively and through Python: species,
    coordinates, cell and pbc equal bit for bit, and equal to what was
    written; both reads timed.  One E+F of frame 0 as read back (one K3,
    one K3b)."""
    from torchani_tpu_torch import csrc
    from torchani_tpu_torch.grad import energies_and_forces
    from torchani_tpu_torch.io import read_xyz, write_xyz
    from torchani_tpu_torch.models import ANI2x
    from torchani_tpu_torch.neighbors import CellList
    from torchani_tpu_torch.testing import make_water_box

    t_phase = time.perf_counter()
    check(csrc.XYZPARSE_IS_AVAILABLE, "phase 54: the native xyz parser builds and loads (g++)")
    species, coords, cell = make_water_box(10002)
    rng = np.random.RandomState(54)
    shifts = np.concatenate([np.zeros((1,) + coords.shape[1:]),
                             0.01 * rng.randn(XYZ_FRAMES - 1, *coords.shape[1:])])
    frames = (coords + 0.5 + shifts).astype(np.float32)
    frame_species = np.repeat(species, XYZ_FRAMES, axis=0)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "box.xyz")
        t0 = time.perf_counter()
        write_xyz(frame_species, frames, path, cell=cell)
        write_s = time.perf_counter() - t0
        size_mb = os.path.getsize(path) / 1e6
        t0 = time.perf_counter()
        native = read_xyz(path)
        native_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        python = read_xyz(path, return_comments=True)[:4]
        python_s = time.perf_counter() - t0
    for a, b, what in zip(native, python, ("species", "coordinates", "cell", "pbc")):
        check(a is not None and b is not None and a.dtype == b.dtype and a.shape == b.shape
              and a.tobytes() == b.tobytes(), f"phase 54: native and Python {what} bit for bit")
    check(native[0].tobytes() == frame_species.astype(np.int64).tobytes()
          and native[1].tobytes() == frames.tobytes(), "phase 54: the frames read back as written")
    check(native[2].tobytes() == np.asarray(cell, np.float32).tobytes()
          and native[3].tolist() == [True] * 3, "phase 54: cell and pbc read back")
    print(f"{card}: phase 54: {XYZ_FRAMES} frames x {species.shape[1]} atoms, {size_mb:.1f} MB: "
          f"write_xyz {write_s:.3f} s; read_xyz native {native_s:.3f} s, Python route "
          f"{python_s:.3f} s ({python_s / native_s:.1f}x); equal bit for bit")

    # the frame read back is the frame written (above, bit for bit): one E+F
    # of it shows the arrays go into the model as they are
    model = ANI2x(pretrained=False, seed=0)
    model.neighborlist = CellList(capacity=96)
    reset_counts()
    e_read, f_read = energies_and_forces(model, native[0][:1], native[1][:1], native[2], native[3])
    torch.cuda.synchronize()
    counts = read_counts()
    check(counts == {k_: {"angular_aev": 1, "angular_aev_bwd": 1}.get(k_, 0) for k_ in kernels_fn},
          "phase 54: the E+F of the frame read back launches K3 and K3b once")
    check(bool(torch.isfinite(e_read).all() and torch.isfinite(f_read).all())
          and f_read.shape == (1, species.shape[1], 3), "phase 54: E+F finite, of the box's shape")
    print(f"phase 54: E+F of frame 0 read back: launches {counts}, energy {float(e_read[0]):.6f} Ha")
    wall_s = time.perf_counter() - t_phase
    print(f"new phase (54, xyz parser): {wall_s:.1f} s of wall time")
    return {"launches": {"xyz_frame_ef": counts}, "native_s": native_s, "python_s": python_s,
            "write_s": write_s}


def sheared_water_box(n: int) -> tuple:
    """`make_water_box(n)` with its cell's rows sheared as
    tests/test_torch_cells.py shears them (b += 0.2 a, c += 0.1 a + 0.15 b;
    the volume unchanged), each rigid molecule moved with its oxygen's
    fractional position: ``(species (1, A), coords (1, A, 3), cell (3, 3))``."""
    from torchani_tpu_torch.testing import make_water_box

    species, coords, cell = make_water_box(n)
    edge = float(cell[0, 0])
    tri = np.array([[1.0, 0.0, 0.0], [0.2, 1.0, 0.0], [0.1, 0.15, 1.0]]) * edge
    xyz = coords[0].astype(np.float64).reshape(-1, 3, 3)  # molecules of O, H, H
    check(bool((species[0].reshape(-1, 3) == [8, 1, 1]).all()),
          "the water box is O, H, H molecules")
    shift = (xyz[:, 0] / edge) @ tri - xyz[:, 0]
    moved = (xyz + shift[:, None, :]).reshape(1, -1, 3).astype(np.float32)
    return species, moved, tri.astype(np.float32)


def triclinic_phases(card: str, kernels_fn: dict, reset_counts, read_counts) -> dict:
    """Phase 55: ANI-2x (8 members, seed 0) on the sheared 10,002-atom box
    (`sheared_water_box`), `MolecularDynamics` with each refresh: gather
    (``bucket_refresh=False``), slot-row (``True``) and atom-packed
    (``"packed"``), each from its own `init` with the gather run's
    velocities.  Launches exactly: at `init` K3, K3b and the refresh's
    backward once and its forward twice (the angular split's count refresh
    of a driver of 2,048 atoms or more runs it too, as on the cubic box's
    MD path); over TRI_STEPS NVE steps K3 and K3b once a step, K1 and K2
    (slot) or K5f and K5b (packed) once a step, no other kernel, no plain
    angular grid.  K1 and K2 at the slot run's tables and K5f and K5b at the
    packed run's against their plain versions, timed beside their bounds;
    `init` forces and the coordinates after TRI_STEPS steps of the slot and
    packed runs against the gather run's; each refresh's step timed."""
    from torchani_tpu_torch.aev.kernels import angular_grid
    from torchani_tpu_torch.bucket_refresh import (
        BucketTables,
        _cand_table,
        _occupied_lanes,
        _statics,
        bucket_select_bwd,
        bucket_select_bwd_reference,
        bucket_select_fwd,
        bucket_select_reference,
    )
    from torchani_tpu_torch.bucket_refresh_packed import (
        PackedTables,
        _flat_rows_index,
        packed_select_bwd,
        packed_select_bwd_reference,
        packed_select_fwd,
        packed_select_reference,
    )
    from torchani_tpu_torch.bucket_refresh_packed import _statics as _packed_statics
    from torchani_tpu_torch.md import MolecularDynamics
    from torchani_tpu_torch.models import ANI2x

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    species_np, coords_np, cell_np = sheared_water_box(10002)
    species = torch.as_tensor(species_np, device=dev)
    coords = torch.as_tensor(coords_np, device=dev)
    cell = torch.as_tensor(cell_np, device=dev)
    num_atoms = species_np.shape[1]
    model = ANI2x(pretrained=False, seed=0)
    refreshes = {  # bucket_refresh, the tables' type, the refresh's kernels
        "gather": (False, type(None), ()),
        "slot": (True, BucketTables, ("bucket_select_fwd", "bucket_select_bwd")),
        "packed": ("packed", PackedTables, ("packed_select_fwd", "packed_select_bwd")),
    }
    launches, starts, ends, step_ms, kernels = {}, {}, {}, {}, {}
    for name, (refresh, tables_type, refresh_kernels) in refreshes.items():
        md = MolecularDynamics(model, species, cell=cell, pbc=True, bucket_refresh=refresh)
        reset_counts()
        start = md.init(coords, temperature=300.0, generator=torch.Generator().manual_seed(0))
        torch.cuda.synchronize()
        launches[f"triclinic_init_{name}"] = init_counts = read_counts()
        if name != "gather":
            start = start.replace(velocities=starts["gather"].velocities)
        check(type(start.bucket) is tables_type and not bool(start.overflow),
              f"phase 55 ({name}): the sheared box takes the {name} refresh, without overflow")
        want = {"angular_aev": 1, "angular_aev_bwd": 1}
        if refresh_kernels:  # the forward twice: also the angular split's count refresh
            want.update({refresh_kernels[0]: 2, refresh_kernels[1]: 1})
        check(init_counts == {k_: want.get(k_, 0) for k_ in kernels_fn} and angular_grid.calls == 0,
              f"phase 55 ({name}): init launches K3, K3b and the refresh's backward once, its "
              f"forward twice")
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        end = md.run_nve(start, TRI_STEPS)
        torch.cuda.synchronize()
        run_ms = (time.perf_counter() - t0) * 1e3 / TRI_STEPS
        launches[f"triclinic_md_{name}"] = counts = read_counts()
        want = {k_: TRI_STEPS for k_ in ("angular_aev", "angular_aev_bwd", *refresh_kernels)}
        check(counts == {k_: want.get(k_, 0) for k_ in kernels_fn} and angular_grid.calls == 0,
              f"phase 55 ({name}): {TRI_STEPS} NVE steps launch K3, K3b and the refresh's kernels "
              f"once a step and no other kernel")
        check(end.step == TRI_STEPS and not bool(end.overflow)
              and type(end.bucket) is tables_type
              and all(bool(torch.isfinite(t).all()) for t in (end.energy, end.forces, end.coords)),
              f"phase 55 ({name}): {TRI_STEPS} finite steps on the {name} refresh, no overflow")
        # the same stretch again, step by step, for the step's time
        state, times = start, []
        for _ in range(TRI_STEPS):
            t0 = time.perf_counter()
            state = md.step_nve(state)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        step_ms[name] = {"median": float(np.median(times)), "min": float(np.min(times)),
                         "max": float(np.max(times)), "run": run_ms}
        starts[name], ends[name] = start, end
        print(f"phase 55 ({name}): {TRI_STEPS} NVE steps, {end.rebuilds} rebuilds, init launches "
              f"{init_counts}, run launches {counts}")

        tables = start.bucket
        if name == "slot":
            grid, g_, c_, k_ = _statics(tables.atom_of_slot, tables.keys, tables.wrapshift)
            r_ = c_ * k_
            canon = md._to_internal(start.coords) - tables.wrap_offset
            cand = _cand_table(canon, tables.atom_of_slot, tables.wrapshift, grid, c_)
            nlanes = _occupied_lanes(tables.atom_of_slot, num_atoms, g_, c_, k_)
            lanes = int(nlanes.sum())
            occupied = torch.arange(r_, device=dev)[None, :] < nlanes[:, None]
            k1_launch_shape("phase 55: K1 at the triclinic tables", g_, c_, r_)
            k1_out = bucket_select_fwd(cand, tables.keys, nlanes)
            torch.cuda.synchronize()
            k1_err = float((k1_out - bucket_select_reference(cand, tables.keys, nlanes))[occupied]
                           .abs().max())
            check(k1_err == 0.0, "phase 55: K1 is an exact selection at the triclinic tables")
            g_rows = torch.randn((g_, r_, 3), device=dev,
                                 generator=torch.Generator(dev).manual_seed(55))
            launch_shape("phase 55: K2 at the triclinic tables", g_, c_, 3)
            k2_out = bucket_select_bwd(g_rows, tables.keys, c_, nlanes)
            torch.cuda.synchronize()
            k2_ref = bucket_select_bwd_reference(g_rows, tables.keys, c_, nlanes)
            k2_err = float((k2_out - k2_ref).abs().max())
            check(within(k2_out, k2_ref, K2_TOL),
                  "phase 55: K2 within tolerance at the triclinic tables")
            def k1_fn():
                return bucket_select_fwd(cand, tables.keys, nlanes)

            kernels["bucket_select_fwd"] = dict(
                max_abs_err=k1_err, ms=kernels_ms(k1_fn, reps=20), events_ms=cuda_ms(k1_fn, 20),
                plain_ms=kernels_ms(lambda: bucket_select_reference(cand, tables.keys, nlanes),
                                    reps=10),
                bound_ms=select_bound_ms(lanes, g_, c_, adds=False)[0])
            def k2_fn():
                return bucket_select_bwd(g_rows, tables.keys, c_, nlanes)

            kernels["bucket_select_bwd"] = dict(
                max_abs_err=k2_err, ms=kernels_ms(k2_fn, reps=20), events_ms=cuda_ms(k2_fn, 20),
                plain_ms=kernels_ms(
                    lambda: bucket_select_bwd_reference(g_rows, tables.keys, c_, nlanes), reps=10),
                bound_ms=select_bound_ms(lanes, g_, c_, adds=True)[0])
            print(f"phase 55: slot tables: grid {grid} (G={g_}), C={c_} slots, K={k_} lanes; "
                  f"occupied lanes {lanes} of {g_ * r_}")
            del cand, k1_out, g_rows, k2_out, k2_ref
        elif name == "packed":
            pgrid, pg, pc, pns, ps_cap, pkl = _packed_statics(tables)
            planes = pns * ps_cap * pkl
            pindex = _flat_rows_index(tables.keys_flat, tables.tile_bucket, pg, pc).reshape(-1)
            pvalid = int((pindex < pg * 27 * pc).sum())
            k5_launch_shape("phase 55: K5f and K5b at the triclinic packed tables", pg, pc,
                            max(1, ps_cap // 8 * pns // pg))
            pcanon = md._to_internal(start.coords) - tables.wrap_offset
            pcand = _cand_table(pcanon, tables.atom_of_slot, tables.wrapshift, pgrid, pc)
            pout = packed_select_fwd(pcand, tables.keys_flat, tables.tile_bucket)
            torch.cuda.synchronize()
            k5f_err = float(
                (pout - packed_select_reference(pcand, tables.keys_flat, tables.tile_bucket))
                .abs().max())
            check(k5f_err == 0.0, "phase 55: K5f is an exact selection at the triclinic tables")
            pgout = torch.randn(pout.shape, device=dev,
                                generator=torch.Generator(dev).manual_seed(56))
            pback = packed_select_bwd(pgout, tables.keys_flat, tables.tile_bucket, pc, pg)
            torch.cuda.synchronize()
            pbref = packed_select_bwd_reference(pgout, tables.keys_flat, tables.tile_bucket, pc, pg)
            k5b_err = float((pback - pbref).abs().max())
            check(within(pback, pbref, SUM_TOL),
                  "phase 55: K5b within tolerance at the triclinic tables")
            tiles = tables.tile_bucket.numel()
            def k5f_fn():
                return packed_select_fwd(pcand, tables.keys_flat, tables.tile_bucket)

            kernels["packed_select_fwd"] = dict(
                max_abs_err=k5f_err, ms=kernels_ms(k5f_fn, reps=20), events_ms=cuda_ms(k5f_fn, 20),
                plain_ms=kernels_ms(
                    lambda: packed_select_reference(pcand, tables.keys_flat, tables.tile_bucket),
                    reps=10),
                bound_ms=packed_bound_ms(planes, planes, pg, pc, tiles, adds=False)[0])
            def k5b_fn():
                return packed_select_bwd(pgout, tables.keys_flat, tables.tile_bucket, pc, pg)

            kernels["packed_select_bwd"] = dict(
                max_abs_err=k5b_err, ms=kernels_ms(k5b_fn, reps=20), events_ms=cuda_ms(k5b_fn, 20),
                plain_ms=kernels_ms(
                    lambda: packed_select_bwd_reference(pgout, tables.keys_flat, tables.tile_bucket,
                                                        pc, pg), reps=10),
                bound_ms=packed_bound_ms(planes, pvalid, pg, pc, tiles, adds=True)[0])
            print(f"phase 55: packed tables: {pns} spans of {pg // pns} bucket(s), S_cap={ps_cap} "
                  f"rows, KL={pkl} lanes, {planes} lanes ({pvalid} hold a neighbor)")
            del pindex, pcand, pout, pgout, pback, pbref
        del md, state
    for name in ("slot", "packed"):
        df = float((starts[name].forces - starts["gather"].forces).abs().max())
        dx = float((ends[name].coords - ends["gather"].coords).abs().max())
        print(f"phase 55: {name} against gather: init max |dF| {df:.3e} Ha/A, after {TRI_STEPS} "
              f"steps max |dx| {dx:.3e} A")
        check(df <= FORCE_ATOL, f"phase 55: {name} init forces equal the gather run's")
        check(dx <= MD_COORD_ATOL,
              f"phase 55: {name} coordinates within {MD_COORD_ATOL} A of the gather run's after "
              f"{TRI_STEPS} steps")
    for short, name in (("K1", "bucket_select_fwd"), ("K2", "bucket_select_bwd"),
                        ("K5f", "packed_select_fwd"), ("K5b", "packed_select_bwd")):
        k_ = kernels[name]
        print(f"{card}: phase 55: {short} at the triclinic tables: max abs err "
              f"{k_['max_abs_err']:.3e}; {k_['ms']:.4f} ms ({k_['events_ms']:.4f} between CUDA "
              f"events); plain {k_['plain_ms']:.4f} ms; bound {k_['bound_ms']:.4f} ms")
    print(f"{card}: phase 55: ANI-2x MD on the sheared {num_atoms}-atom box, ms a step (median, "
          f"min, max of {TRI_STEPS} steps; as one run): "
          + "; ".join(f"{n_} {v['median']:.3f}, {v['min']:.3f}, {v['max']:.3f}; {v['run']:.3f}"
                      for n_, v in step_ms.items()))
    print(f"new phase (55, triclinic MD): {time.perf_counter() - t_phase:.1f} s of wall time")
    return {"launches": launches, "kernels": kernels, "step_ms": step_ms}


#: the radial kernels (phase 56): the E+F cell's shape (2,560 chain molecules
#: of up to 60 atoms over ANI-2x's seven elements, the angular table tuned to
#: the batch) and the MD cell's 59,049-atom water box; each kernel against
#: its plain version at |k - p| <= RADIAL_ATOL max|p| + RADIAL_RTOL |p| (f32
#: sums over lanes or shifts in another order), exact zeros on masked lanes
RADIAL_EF_BATCH, RADIAL_EF_ATOMS, RADIAL_MD_ATOMS, RADIAL_MD_STEPS = 2560, 60, 59049, 10
RADIAL_ATOL, RADIAL_RTOL = 1e-6, 1e-5
ANI2X_ZNUMS = (1, 6, 7, 8, 9, 16, 17)


def radial_bound_ms(which: str, dist: torch.Tensor, species: torch.Tensor, nr: int,
                    ns: int) -> tuple:
    """The least time of K6, K6b or K6bb at a table: bytes (each lane's
    species at the 4 B that K3 takes them in, not the 8 B of the int64 table
    these kernels read; the valid lanes' distance and K6bb's direction; the
    output or cotangent rows: those of the rows with a valid lane where
    read) over the HBM peak, or its special-function instructions (an exp a
    valid lane and shift, K6bb two; a cos, K6b and K6bb also a sin) over
    their peak; ``(ms, "bytes" or "sfu")``."""
    n, k = dist.shape
    valid = int((species >= 0).sum())
    rows = int((species >= 0).any(dim=1).sum())
    row_bytes = 4 * ns * nr
    nbytes = {
        "K6": 4 * n * k + 4 * valid + n * row_bytes,
        "K6b": 4 * n * k + 4 * valid + rows * row_bytes + 4 * n * k,
        "K6bb": 4 * n * k + 8 * valid + rows * row_bytes + n * row_bytes + 4 * n * k,
    }[which]
    sfu = valid * {"K6": nr + 1, "K6b": nr + 2, "K6bb": 2 * nr + 2}[which]
    by_bytes, by_sfu = nbytes / PEAK_HBM_BYTES * 1e3, sfu / PEAK_SFU_OPS * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_sfu else (by_sfu, "sfu")


def radial_errors(out: torch.Tensor, ref: torch.Tensor, what: str) -> float:
    err = (out - ref).abs()
    print(f"{what}: max abs err {float(err.max()):.3e} (max |plain| {float(ref.abs().max()):.3e})")
    check(bool(torch.isfinite(out).all()), f"{what}: finite")
    check(bool((err <= RADIAL_ATOL * ref.abs().max() + RADIAL_RTOL * ref.abs()).all()),
          f"{what}: within tolerance of its plain version")
    return float(err.max())


def radial_phases(card: str) -> dict:
    """Phase 56: K6, K6b and K6bb (`aev.radial_kernels`).  Their launches on
    the E+F, MD, force-training and Hessian paths (one K6 an evaluation, one
    K6b a force evaluation, one K6bb a force-training step; 3 K6, 6 K6b and
    3 K6bb a Hessian of 90 atoms, one K6 and K6bb and two K6b a pass), each kernel against its plain version at the E+F and MD
    tables that those paths hand it, its card ms beside its bound and the
    plain version's, the device memory a call adds (no ``(N, K, R)``
    tensor), and E+F and the MD step with the radial sums of the plain path
    (the route before these kernels: K3 and K3b unchanged) against the
    kernels' route: ms, peak memory, forces.  Returns ``kernels`` entries
    and ``launches`` by path."""
    from torchani_tpu_torch import csrc, training
    from torchani_tpu_torch.aev import computer as aev_computer
    from torchani_tpu_torch.aev.radial_kernels import (
        radial_aev,
        radial_aev_bwd,
        radial_aev_bwd_bwd,
        radial_aev_bwd_bwd_reference,
        radial_aev_bwd_reference,
        radial_aev_reference,
    )
    from torchani_tpu_torch.grad import energies_and_forces, hessians
    from torchani_tpu_torch.md import MolecularDynamics
    from torchani_tpu_torch.models import ANI2x
    from torchani_tpu_torch.profiling import peak_gib, wall_times_ms
    from torchani_tpu_torch.testing import make_chain_molecs, make_water_box
    from torchani_tpu_torch.training import make_train_step

    log = csrc.build(["radial_aev"]).get("radial_aev")
    if log:
        print("phase 56: radial_aev.cu, nvcc -Xptxas=-v:\n" + log)
    wrappers = {"radial_aev": radial_aev, "radial_aev_bwd": radial_aev_bwd,
                "radial_aev_bwd_bwd": radial_aev_bwd_bwd}

    def read():
        return {name: fn.launches for name, fn in wrappers.items()}

    def since(before):
        torch.cuda.synchronize()
        return {name: n - before[name] for name, n in read().items()}

    def want(k6, k6b, k6bb):
        return {"radial_aev": k6, "radial_aev_bwd": k6b, "radial_aev_bwd_bwd": k6bb}

    tables = {}
    real = aev_computer.radial_aev

    def spy(dist, species, **kw):
        if spy.tag is not None and spy.tag not in tables:
            tables[spy.tag] = (dist.detach(), species, kw)
        return real(dist, species, **kw)

    spy.tag = None
    launches = {}
    dev = torch.device("cuda")
    aev_computer.radial_aev = spy
    try:
        # E+F at the E+F cell's shape
        sp, co = make_chain_molecs(RADIAL_EF_BATCH, RADIAL_EF_ATOMS, seed=0, znums=ANI2X_ZNUMS)
        batch = {"species": torch.as_tensor(sp, device=dev),
                 "coordinates": torch.as_tensor(co, device=dev)}
        model = training.tune_angular_capacity(ANI2x(seed=0, device=dev), [batch])

        def ef():
            return energies_and_forces(model, batch["species"], batch["coordinates"])

        ef()
        before, spy.tag = read(), "ef"
        e_k, f_k = ef()
        spy.tag = None
        launches["ef"] = since(before)
        check(launches["ef"] == want(1, 1, 0), "phase 56: one E+F launches K6 and K6b once")
        ef_ms = float(np.median(wall_times_ms(ef, reps=5)))
        ef_peak = peak_gib(ef)
        model.aev_computer._use_radial_kernel = lambda t: False  # the plain radial sums
        e_p, f_p = ef()
        ef_plain_ms = float(np.median(wall_times_ms(ef, reps=5)))
        ef_plain_peak = peak_gib(ef)
        del model.aev_computer._use_radial_kernel
        ef_df = float((f_k - f_p).abs().max())
        ef_de = float(((e_k - e_p).abs() / e_p.abs()).max())
        print(f"{card}: phase 56: E+F of {RADIAL_EF_BATCH} chain molecules ({int((sp >= 0).sum())} "
              f"atoms, {sp.size} rows): radial kernels {ef_ms:.3f} ms, peak {ef_peak:.3f} GiB; "
              f"plain radial sums {ef_plain_ms:.3f} ms, peak {ef_plain_peak:.3f} GiB; max |dF| "
              f"{ef_df:.3e} Ha/A, max |dE|/|E| {ef_de:.3e}")
        check(ef_df <= FORCE_ATOL and ef_de <= 1e-6, "phase 56: E+F forces equal the plain sums'")
        check(ef_peak < ef_plain_peak, "phase 56: E+F peak memory below the plain sums'")

        # force training at the same batch
        batch["energies"] = torch.as_tensor(
            np.random.RandomState(1).randn(RADIAL_EF_BATCH).astype(np.float32), device=dev)
        batch["forces"] = torch.zeros(co.shape, device=dev)
        tmodel = ANI2x(seed=0, device=dev)
        tmodel.energy_shifter.enabled = False
        tmodel = training.tune_angular_capacity(tmodel, [batch])
        init, step = make_train_step(tmodel, training.adamw_with_plateau(TRAIN_LR)[0],
                                     force_training=True)
        state = init()
        state, _ = step(state, batch)
        before = read()
        state, m = step(state, batch)
        launches["train_force_step"] = since(before)
        check(launches["train_force_step"] == want(1, 1, 1) and bool(torch.isfinite(m["loss"])),
              "phase 56: a force-training step launches K6, K6b and K6bb once each")
        del state, init, step, tmodel

        # the MD cell's box
        box_sp, box_co, cell = make_water_box(RADIAL_MD_ATOMS)
        md = MolecularDynamics(ANI2x(seed=0, device=dev), box_sp, cell=cell, pbc=True, device=dev)
        spy.tag = "md"
        state = md.init(box_co, temperature=300.0, generator=torch.Generator().manual_seed(0))
        spy.tag = None
        before = read()
        end = md.run_nve(state, RADIAL_MD_STEPS)
        launches["md"] = since(before)
        check(launches["md"] == want(RADIAL_MD_STEPS, RADIAL_MD_STEPS, 0)
              and bool(torch.isfinite(end.coords).all()),
              f"phase 56: {RADIAL_MD_STEPS} NVE steps launch K6 and K6b once a step")
        md_ms = float(np.median(wall_times_ms(lambda: md.run_nve(state, RADIAL_MD_STEPS),
                                              reps=3))) / RADIAL_MD_STEPS
        md_peak = peak_gib(lambda: md.run_nve(state, 1))
        md.model.aev_computer._use_radial_kernel = lambda t: False
        end_p = md.run_nve(state, RADIAL_MD_STEPS)
        md_plain_ms = float(np.median(wall_times_ms(lambda: md.run_nve(state, RADIAL_MD_STEPS),
                                                    reps=3))) / RADIAL_MD_STEPS
        md_plain_peak = peak_gib(lambda: md.run_nve(state, 1))
        del md.model.aev_computer._use_radial_kernel
        md_dx = float((end.coords - end_p.coords).abs().max())
        print(f"{card}: phase 56: NVE on the {RADIAL_MD_ATOMS}-atom box: radial kernels "
              f"{md_ms:.3f} ms a step, peak {md_peak:.3f} GiB; plain radial sums "
              f"{md_plain_ms:.3f} ms a step, peak {md_plain_peak:.3f} GiB; max |dx| after "
              f"{RADIAL_MD_STEPS} steps {md_dx:.3e} A")
        check(md_dx <= MD_COORD_ATOL, f"phase 56: MD coordinates within {MD_COORD_ATOL} A of "
              f"the plain sums' run")
        del md, state, end, end_p

        # a Hessian of the 30-water cluster's size
        h_sp, h_co, _ = make_water_box(90)
        h_model = ANI2x(seed=0, device=dev)
        hessians(h_model, h_sp, h_co)
        before = read()
        hess = hessians(h_model, h_sp, h_co)
        launches["hessian"] = since(before)
        check(launches["hessian"] == want(3, 6, 3) and bool(torch.isfinite(hess).all()),
              "phase 56: a Hessian of 90 atoms (3 passes) launches 3 K6, 6 K6b and 3 K6bb")
    finally:
        aev_computer.radial_aev = real
    print(f"phase 56: launches by path {launches}")

    # the kernels at the tables the E+F and MD paths handed K6
    results = {}
    for at, (dist, species, kw) in tables.items():
        n, k = dist.shape
        nr, ns = len(kw["shifts"]), kw["num_species"]
        rng = np.random.RandomState(56)
        g = torch.as_tensor(rng.randn(n, ns * nr + 1008).astype(np.float32), device=dev)
        g = g[:, :ns * nr]  # the AEV cotangent's radial columns
        w = torch.as_tensor(rng.randn(n, k).astype(np.float32), device=dev)
        gc = g.contiguous()
        masked = species < 0
        errs, ms, plain, bounds, added = {}, {}, {}, {}, {}
        calls = {
            "K6": (lambda: radial_aev(dist, species, **kw),
                   lambda: radial_aev_reference(dist, species, **kw)),
            "K6b": (lambda: radial_aev_bwd(g, dist, species, **kw),
                    lambda: radial_aev_bwd_reference(gc, dist, species, **kw)),
            "K6bb": (lambda: radial_aev_bwd_bwd(g, dist, species, w, **kw),
                     lambda: radial_aev_bwd_bwd_reference(gc, dist, species, w, **kw)),
        }
        for short, (kern, ref_fn) in calls.items():
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out = kern()
            torch.cuda.synchronize()
            added[short] = torch.cuda.max_memory_allocated() - base
            ref = ref_fn()
            outs = out if isinstance(out, tuple) else (out,)
            refs = ref if isinstance(ref, tuple) else (ref,)
            errs[short] = max(radial_errors(o, r, f"phase 56: {short} at the {at} tables "
                                                  f"({n} x {k})")
                              for o, r in zip(outs, refs))
            if short != "K6":
                lane_out = outs[-1]
                check(bool((lane_out[masked] == 0).all()),
                      f"phase 56: {short} writes exact zeros on masked lanes")
            out_bytes = sum(o.numel() * o.element_size() for o in outs)
            check(added[short] <= out_bytes + (1 << 20),
                  f"phase 56: {short} allocates its outputs and nothing else")
            ms[short] = kernels_ms(kern, reps=20)
            plain[short] = kernels_ms(ref_fn, reps=3)
            bounds[short] = radial_bound_ms(short, dist, species, nr, ns)
            print(f"{card}: phase 56: {short} at the {at} tables ({n} x {k}, "
                  f"{int((~masked).sum())} valid lanes, {int((~masked).any(dim=1).sum())} rows "
                  f"with one): {ms[short]:.4f} ms, bound {bounds[short][0]:.4f} ms by "
                  f"{bounds[short][1]} ({bounds[short][0] / ms[short]:.1%}), plain "
                  f"{plain[short]:.3f} ms; {added[short] / 2**20:.1f} MiB allocated "
                  f"(outputs {out_bytes / 2**20:.1f} MiB; one (N, K, R) f32 tensor "
                  f"{n * k * nr * 4 / 2**20:.1f} MiB)")
        results[at] = {"err": errs, "ms": ms, "plain": plain, "bound": bounds, "added": added,
                       "n": n, "k": k}
    check(set(results) == {"ef", "md"}, "phase 56: tables captured on the E+F and MD paths")

    source = "torchani_tpu_torch/csrc/radial_aev.cu"
    replaces = "none: the JAX package leaves the radial terms to XLA's fusion"
    entries = []
    for short, name in (("K6", "radial_aev"), ("K6b", "radial_aev_bwd"),
                        ("K6bb", "radial_aev_bwd_bwd")):
        entries.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches_by_path": {path: c[name] for path, c in launches.items()},
            **{f"at_{at}": {"max_abs_err": r["err"][short], "ms": r["ms"][short],
                            "plain_ms": r["plain"][short], "bound_ms": r["bound"][short][0],
                            "bound_by": r["bound"][short][1], "rows": r["n"], "lanes": r["k"],
                            "allocated_bytes": r["added"][short]}
               for at, r in results.items()},
        })
    return {"kernels": entries, "launches": launches,
            "ef": {"ms": ef_ms, "plain_ms": ef_plain_ms, "peak_gib": ef_peak,
                   "plain_peak_gib": ef_plain_peak},
            "md": {"ms": md_ms, "plain_ms": md_plain_ms, "peak_gib": md_peak,
                   "plain_peak_gib": md_plain_peak}}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")

    from torchani_tpu_torch import cli, convert, csrc, paths
    from torchani_tpu_torch.aev.kernels import (
        angular_aev,
        angular_aev_bwd,
        angular_aev_bwd_bwd,
        angular_aev_bwd_bwd_reference,
        angular_aev_bwd_reference,
        angular_aev_reference,
        angular_grid,
        lane_species,
    )
    from torchani_tpu_torch.aev.terms import ANIAngular, Angular, Radial
    from torchani_tpu_torch.bucket_refresh import (
        BucketTables,
        _cand_table,
        _flat_index,
        _occupied_lanes,
        _slot_sections,
        _statics,
        bucket_select_bwd,
        bucket_select_bwd_reference,
        bucket_select_fwd,
        bucket_select_reference,
        vals_select_bwd,
        vals_select_bwd_reference,
        vals_select_fwd,
        vals_select_reference,
    )
    from torchani_tpu_torch.bucket_refresh_packed import (
        PackedTables,
        _flat_rows_index,
        packed_select_bwd,
        packed_select_bwd_reference,
        packed_select_fwd,
        packed_select_reference,
    )
    from torchani_tpu_torch.bucket_refresh_packed import _statics as _packed_statics
    from torchani_tpu_torch.grad import (
        energies_and_forces,
        force_qbc,
        hessian_rows,
        hessians,
        members_energies_and_forces,
        single_point,
        stress_fdotr,
        stress_scaling,
    )
    from torchani_tpu_torch.md import (
        CachedSinglePoint,
        MolecularDynamics,
        MultipleTimestepMD,
        _refresh_neighbors,
        choose_angular_split,
        kinetic_temperature,
    )
    from torchani_tpu_torch.arch import Assembler
    from torchani_tpu_torch.constants import ATOMIC_NUMBER, HARDNESS, MASS
    from torchani_tpu_torch.electro import DipoleComputer, compute_dipole
    from torchani_tpu_torch.io import read_xyz, write_xyz
    from torchani_tpu_torch.models import ANI1x, ANI2dr, ANI2x, ANImbis, ANIr2s, SnnANI2xr
    from torchani_tpu_torch.neb import neb_path
    from torchani_tpu_torch.neighbors import (
        CellList,
        VerletCellList,
        _static_grid_shape,
        atom_image_converters,
        coords_to_fractional,
        coords_to_grid_idx3,
        count_atoms_in_buckets,
        flatten_idx3,
        narrow_down,
        neighbors_to_triples,
        parse_neighborlist,
        reconstruct_shifts,
        setup_grid,
    )
    from torchani_tpu_torch.nn.partition import measure_caps
    from torchani_tpu_torch.observables import (
        _min_image_dist2,
        diffusion_coefficient,
        mean_squared_displacement,
        radial_distribution,
    )
    from torchani_tpu_torch.optimize import _energy_and_forces as _fire_forces
    from torchani_tpu_torch.optimize import minimize_fire, minimize_fire_batched
    from torchani_tpu_torch.potentials import (
        DispersionLJ,
        FixedCoulomb,
        FixedMNOK,
        LennardJones,
        RepulsionLJ,
    )
    from torchani_tpu_torch.potentials.utils import pair_curves
    from torchani_tpu_torch.profiling import peak_gib, wall_times_ms
    from torchani_tpu_torch.replica import ReplicaExchange
    from torchani_tpu_torch.testing import make_water_box
    from torchani_tpu_torch.units import HARTREE_TO_EV, HARTREE_TO_KCALPERMOL
    from torchani_tpu_torch.utils import SYMBOLS_2X, get_atomic_masses

    dev = torch.device("cuda")

    # ---- 1. build every kernel ----
    t0 = time.perf_counter()
    logs = csrc.build()
    print(f"build: {time.perf_counter() - t0:.1f} s for {sorted(csrc.sources())}")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # ---- 2. each kernel against its plain version ----
    model = ANI2x(pretrained=False, seed=0)
    model.neighborlist = CellList(capacity=96)
    aevc = model.aev_computer
    species_np, coords_np, cell_np = make_water_box(10002)
    species = torch.as_tensor(species_np, device=dev)
    coords = torch.as_tensor(coords_np, device=dev)
    cell = torch.as_tensor(cell_np, device=dev)
    pbc = torch.ones(3, dtype=torch.bool, device=dev)
    num_atoms = species_np.shape[1]
    print(f"water box: {num_atoms} atoms, cell {float(cell_np[0, 0]):.3f} A; single-point "
          f"cell list at {model.cutoff} A: grid {_static_grid_shape(cell_np, model.cutoff)}")

    elem = model._convert(species)
    nbrs = model.neighborlist(model.cutoff, elem, coords, cell, pbc)
    _, angular_nbrs, overflow = aevc.flat_tables(elem, nbrs)
    check(not bool(overflow), "water-box neighbor tables do not overflow")
    k3_in = aevc.angular_inputs(elem.reshape(-1), angular_nbrs)
    k3_kw = aevc.kernel_kwargs()
    n, ka = k3_in[0].shape
    print(f"K3 inputs: N={n}, Ka={ka}, S={k3_kw['num_species']}, "
          f"Z={len(k3_kw['shifts']) * len(k3_kw['sections'])}")
    out = angular_aev(*k3_in, **k3_kw)
    torch.cuda.synchronize()
    ref = angular_aev_reference(*k3_in, **k3_kw)
    k3_err = kernel_errors(out, ref, "K3 ANI-2x water box vs plain")

    ani1x_smooth = ANIAngular.like_1x("smooth", device=dev)
    small_kw = dict(
        eta=float(ani1x_smooth.eta[0]), zeta=float(ani1x_smooth.zeta[0]),
        shifts=tuple(ani1x_smooth.shifts.tolist()),
        sections=tuple(ani1x_smooth.sections.tolist()),
        cutoff=ani1x_smooth.cutoff, cutoff_kind="smooth", num_species=4,
    )
    small_in = random_angular_inputs(257, 19, 4, seed=1)
    small = angular_aev(*small_in, **small_kw)
    torch.cuda.synchronize()
    kernel_errors(small, angular_aev_reference(*small_in, **small_kw),
                  "K3 ANI-1x smooth random lanes vs plain")
    check(bool((small[::7] == 0).all()), "fully masked rows give exact zeros")

    # K3b at the same inputs: a seeded random cotangent, contiguous and as a
    # column slice of a wider tensor (as the AEV's cat hands it back)
    k3_species = lane_species(k3_in[2], k3_in[3])
    k3_block = aevc._atom_block(ka)
    k3b_shape = k3b_launch_shape("K3b at the ANI-2x water box", k3_in, k3_kw)
    gen = torch.Generator(dev).manual_seed(11)
    g3 = torch.randn(out.shape, device=dev, generator=gen)
    k3b = angular_aev_bwd(g3, *k3_in, k3_species, **k3_kw)
    torch.cuda.synchronize()
    k3b_err = bwd_errors(k3b, angular_aev_bwd_reference(g3, *k3_in, atom_block=k3_block, **k3_kw),
                         k3_in[2], "K3b ANI-2x water box vs plain")
    wide = torch.randn((n, out.shape[1] + 112), device=dev, generator=gen)
    g3_slice = wide[:, 112:]
    check(not g3_slice.is_contiguous(), "the sliced cotangent is not contiguous")
    k3b_slice = angular_aev_bwd(g3_slice, *k3_in, k3_species, **k3_kw)
    torch.cuda.synchronize()
    k3b_err = max(k3b_err, bwd_errors(
        k3b_slice, angular_aev_bwd_reference(g3_slice, *k3_in, atom_block=k3_block, **k3_kw),
        k3_in[2], f"K3b ANI-2x water box, cotangent strides {g3_slice.stride()}, vs plain"))
    g_small = torch.randn(small.shape, device=dev, generator=gen)
    small_b = angular_aev_bwd(g_small, *small_in, **small_kw)
    torch.cuda.synchronize()
    bwd_errors(small_b, angular_aev_bwd_reference(g_small, *small_in, **small_kw), small_in[2],
               "K3b ANI-1x smooth random lanes vs plain")
    check(bool((small_b[0][::7] == 0).all()) and bool((small_b[1][::7] == 0).all()),
          "K3b: fully masked rows give exact zeros")

    # K1 and K2 at the water box's own MD tables (from `MolecularDynamics.init`)
    md0 = MolecularDynamics(model, species, cell=cell, pbc=True)
    state0 = md0.init(coords, temperature=300.0, generator=torch.Generator().manual_seed(0))
    check(not bool(state0.overflow), "the MD cache of the water box does not overflow")
    tables = state0.bucket
    check(tables is not None, "the bucket refresh is on for the periodic water box")
    grid, g_, c_, k_ = _statics(tables.atom_of_slot, tables.keys, tables.wrapshift)
    r_ = c_ * k_
    print(f"MD tables: grid {grid} (G={g_}), C={c_} slots, K={k_} lanes, R={r_}; "
          f"angular prefix {md0._ang_prefix} lanes")
    canon = md0._to_internal(state0.coords) - tables.wrap_offset
    cand = _cand_table(canon, tables.atom_of_slot, tables.wrapshift, grid, c_)
    nlanes = _occupied_lanes(tables.atom_of_slot, num_atoms, g_, c_, k_)
    lanes = int(nlanes.sum())
    real_lanes = int(state0.nbr_mask.sum())
    print(f"occupied lanes: {lanes} of {g_ * r_} ({lanes / (g_ * r_):.1%}); "
          f"{real_lanes} of them hold a neighbor")
    occupied = torch.arange(r_, device=dev)[None, :] < nlanes[:, None]
    k1_shape = k1_launch_shape("K1 at the ANI-2x tables", g_, c_, r_)
    k1_out = bucket_select_fwd(cand, tables.keys, nlanes)
    torch.cuda.synchronize()
    k1_ref = bucket_select_reference(cand, tables.keys, nlanes)
    k1_err = float((k1_out - k1_ref)[occupied].abs().max())
    print(f"K1 water-box tables vs plain: max abs err {k1_err:.3e} over occupied lanes")
    check(k1_err == 0.0, "K1 is an exact selection")
    g_rows = torch.randn((g_, r_, 3), device=dev, generator=torch.Generator(dev).manual_seed(1))
    k2_shape = launch_shape("K2 at the ANI-2x tables", g_, c_, 3)
    k2_out = bucket_select_bwd(g_rows, tables.keys, c_, nlanes)
    torch.cuda.synchronize()
    k2_ref = bucket_select_bwd_reference(g_rows, tables.keys, c_, nlanes)
    k2_err = float((k2_out - k2_ref).abs().max())
    print(f"K2 water-box tables vs plain: max abs err {k2_err:.3e} "
          f"({int((k2_ref != 0).any(-1).sum())} candidates receive a sum)")
    check(bool(torch.isfinite(k2_out).all()), "K2 output finite")
    check(bool(((k2_out - k2_ref).abs() <= K2_TOL * (1 + k2_ref.abs())).all()),
          "K2 within tolerance")

    # small random keys with repeats and sentinels, C = 256 (83 KB of shared memory)
    rng = np.random.RandomState(3)
    sg, sc, sk = 5, 256, 5
    sec = np.where(rng.rand(sg, sc * sk) < 0.75, rng.randint(0, 27, (sg, sc * sk)), 27)
    rank = np.where(sec < 27, rng.randint(0, sc, (sg, sc * sk)), 0)
    skeys = torch.as_tensor(((sec << 8) | rank).astype(np.int32), device=dev)
    scand = torch.as_tensor(rng.randn(sg, 27, sc, 3).astype(np.float32) * 20, device=dev)
    sgout = torch.as_tensor(rng.randn(sg, sc * sk, 3).astype(np.float32), device=dev)
    k1_launch_shape("K1 on random keys", sg, sc, sc * sk)
    s1 = bucket_select_fwd(scand, skeys)
    launch_shape("K2 on random keys", sg, sc, 3)
    s2 = bucket_select_bwd(sgout, skeys, sc)
    torch.cuda.synchronize()
    s1_err = float((s1 - bucket_select_reference(scand, skeys)).abs().max())
    s2_ref = bucket_select_bwd_reference(sgout, skeys, sc)
    s2_err = float((s2 - s2_ref).abs().max())
    print(f"K1, K2 random keys (C=256) vs plain: max abs err {s1_err:.3e}, {s2_err:.3e}")
    check(s1_err == 0.0, "K1 exact on random keys")
    check(bool(((s2 - s2_ref).abs() <= K2_TOL * (1 + s2_ref.abs())).all()),
          "K2 within tolerance on random keys")

    # ---- 3. the main path: ANI-2x E+F on the water box ----
    angular_aev.launches = angular_aev_bwd.launches = angular_grid.calls = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    energies, forces = energies_and_forces(model, species, coords, cell, pbc)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {"angular_aev": angular_aev.launches, "angular_aev_bwd": angular_aev_bwd.launches}
    print(f"E+F main path: E = {float(energies[0]):.6f} Ha, first call {first_s:.3f} s, "
          f"launches {launches}, angular_grid calls {angular_grid.calls}")
    check(launches == {"angular_aev": 1, "angular_aev_bwd": 1} and angular_grid.calls == 0,
          "one E+F launches K3 and K3b once each and builds no plain angular grid")
    check(tuple(energies.shape) == (1,), "energies shape (1,)")
    check(tuple(forces.shape) == (1, num_atoms, 3), "forces shape (1, A, 3)")
    check(bool(torch.isfinite(energies).all()), "energies finite")
    check(bool(torch.isfinite(forces).all()), "forces finite")
    check(all(v > 0 for v in launches.values()), "every kernel launched on the E+F path")

    # ---- 4. card vs CPU, same model from the same seed ----
    sp_s, co_s, cell_s = make_water_box(1002)
    pbc_np = np.ones(3, dtype=bool)
    outs = {}
    for where in ("cuda", "cpu"):
        m = ANI2x(pretrained=False, seed=0, device=where)
        m.neighborlist = CellList()
        outs[where] = single_point(
            m, sp_s, co_s, cell_s, pbc_np, forces=True, atomic_energies=True
        )
    df = float((outs["cuda"]["forces"].cpu() - outs["cpu"]["forces"]).abs().max())
    dae = float(
        (outs["cuda"]["atomic_energies"].cpu() - outs["cpu"]["atomic_energies"]).abs().max()
    )
    de_rel = float(
        ((outs["cuda"]["energies"].cpu() - outs["cpu"]["energies"])
         / outs["cpu"]["energies"]).abs().max()
    )
    print(f"card vs CPU, {sp_s.shape[1]} atoms: max |dF| {df:.3e} Ha/A, "
          f"max |dE_atomic| {dae:.3e} Ha, rel dE total {de_rel:.3e}")
    check(df <= FORCE_ATOL, "forces agree with the CPU")
    check(dae <= ATOMIC_E_ATOL, "atomic energies agree with the CPU")

    # ---- 5. the MD main path: init at 300 K and 50 NVE steps ----
    kernels_fn = kernel_wrappers()
    reset_launches, read_counts = launch_counts(kernels_fn)

    def reset_counts():
        reset_launches()
        angular_grid.calls = 0

    def k3b_once_per_evaluation(counts, what):
        check(counts["angular_aev_bwd"] == counts["angular_aev"] and angular_grid.calls == 0,
              f"{what}: K3b launched as often as K3 (once per evaluation), no plain angular grid")

    reset_counts()
    md_model = ANI2x(pretrained=False, seed=0)
    md = MolecularDynamics(md_model, species, cell=cell, pbc=True)
    md_start = md.init(coords, temperature=300.0, generator=torch.Generator().manual_seed(0))
    e_start = total_energy(md, md_start)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = md.run_nve(md_start, MD_STEPS)
    torch.cuda.synchronize()
    run1_ms = (time.perf_counter() - t0) * 1e3 / MD_STEPS
    md_launches = read_counts()
    e_end = total_energy(md, state)
    drift = e_end - e_start
    temps = [float(kinetic_temperature(st.velocities, md.masses)) for st in (md_start, state)]
    print(f"MD main path: {MD_STEPS} NVE steps at 1 fs, E_pot {float(state.energy):.6f} Ha, "
          f"total-energy drift {drift:.6f} Ha of {e_start:.3f}, kinetic temperature "
          f"{temps[0]:.1f} -> {temps[1]:.1f} K (random weights), rebuilds {state.rebuilds}, "
          f"launches {md_launches}")
    check(state.step == MD_STEPS, f"state.step == {MD_STEPS}")
    check(not bool(state.overflow), "no overflow along the MD run")
    for name, t in (("energy", state.energy), ("forces", state.forces),
                    ("coords", state.coords), ("velocities", state.velocities)):
        check(bool(torch.isfinite(t).all()), f"MD {name} finite")
    check(tuple(state.forces.shape) == (num_atoms, 3), "MD forces shape (A, 3)")
    check(all(md_launches[n] >= MD_STEPS
              for n in ("angular_aev", "angular_aev_bwd", "bucket_select_fwd",
                        "bucket_select_bwd")),
          f"K1, K2, K3 and K3b each launched at least {MD_STEPS} times on the MD path")
    k3b_once_per_evaluation(md_launches, "ANI-2x MD")
    check(md_launches["bucket_select_bwd"] == md_launches["angular_aev"],
          "ANI-2x MD: K2 launched once per evaluation")
    check(abs(drift) <= 5e-3 * abs(e_start) + 0.05, "total energy drift bounded")

    # ---- 6. a forced rebuild ----
    before = state.rebuilds
    state = md.step_nve(state.replace(ref_coords=state.ref_coords + 1.0))
    torch.cuda.synchronize()
    check(state.rebuilds == before + 1, "a displaced reference rebuilds the cache")
    check(not bool(state.overflow), "no overflow after the rebuild")
    check(bool(torch.isfinite(state.forces).all()), "forces finite after the rebuild")
    _, f_ref = energies_and_forces(model, species, state.coords[None], cell, pbc)
    df = float((state.forces - f_ref[0]).abs().max())
    print(f"after a forced rebuild: max |dF| vs one-shot E+F {df:.3e} Ha/A")
    check(df <= REBUILD_FORCE_ATOL, "forces after the rebuild equal one-shot E+F forces")

    # ---- 7. MD against single point on the card ----
    df = float((state0.forces - forces[0]).abs().max())
    de = abs(float(state0.energy) - float(energies[0]))
    print(f"MD init vs single point: max |dF| {df:.3e} Ha/A, |dE| {de:.3e} Ha")
    check(df <= FORCE_ATOL, "MD forces equal single-point forces")

    # ---- 8. card vs CPU for MD: 10 NVE steps from the same velocities ----
    vel_s = (np.random.RandomState(7).randn(sp_s.shape[1], 3) * 0.005).astype(np.float32)
    ends = {}
    for where in ("cuda", "cpu"):
        m = ANI2x(pretrained=False, seed=0, device=where)
        runner = MolecularDynamics(m, sp_s, cell=cell_s, pbc=True, device=where)
        start = runner.init(co_s)
        check(start.bucket is not None, f"bucket refresh on for the small box ({where})")
        start = start.replace(velocities=torch.as_tensor(vel_s, device=where))
        ends[where] = runner.run_nve(start, 10)
    dc = float((ends["cuda"].coords.cpu() - ends["cpu"].coords).abs().max())
    df = float((ends["cuda"].forces.cpu() - ends["cpu"].forces).abs().max())
    print(f"MD card vs CPU, {sp_s.shape[1]} atoms, 10 steps: max |dx| {dc:.3e} A, "
          f"max |dF| {df:.3e} Ha/A")
    check(dc <= MD_COORD_ATOL, "MD coordinates agree with the CPU")
    check(df <= MD_FORCE_ATOL, "MD forces agree with the CPU")

    # ---- 9. CachedSinglePoint at three nearby geometries ----
    cached = CachedSinglePoint(model, species, cell=cell, pbc=True)
    noise = torch.randn(coords[0].shape, device=dev, generator=torch.Generator(dev).manual_seed(2))
    geoms = [coords[0], coords[0] + 0.02 * noise, coords[0] - 0.03 * noise]
    for geom in geoms:
        e_c, f_c = cached(geom)
    e_1, f_1 = energies_and_forces(model, species, geoms[-1][None], cell, pbc)
    df = float((f_c - f_1[0]).abs().max())
    print(f"CachedSinglePoint, 3 geometries: E {float(e_c):.6f} Ha, max |dF| vs one-shot "
          f"{df:.3e} Ha/A, rebuilds {cached._state.rebuilds}, overflow {cached.overflow}")
    check(not cached.overflow, "CachedSinglePoint does not overflow")
    check(bool(torch.isfinite(f_c).all()) and bool(torch.isfinite(e_c)), "cached E+F finite")
    check(df <= REBUILD_FORCE_ATOL, "cached forces equal one-shot forces")

    # ---- 10. timings ----
    def ef():
        energies_and_forces(model, species, coords, cell, pbc)

    times = wall_times_ms(ef, reps=10)
    print(f"{card}: E+F {num_atoms} atoms: median {np.median(times):.3f} ms, "
          f"min {np.min(times):.3f} ms, max {np.max(times):.3f} ms "
          f"over {len(times)} calls (host clock, each ending in a synchronize)")
    print(f"{card}: E+F peak device memory: {peak_gib(ef):.3f} GiB")

    # device time of the kernels alone (torch.profiler), and the time between
    # CUDA events around back-to-back calls, which also holds the host's
    # dispatch where that is slower than the kernel
    def both_ms(fn, reps=20):
        return kernels_ms(fn, reps=reps), cuda_ms(fn, reps=reps)

    print("SM clock, max SM clock, temperature, power draw: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,temperature.gpu,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
    ).stdout.strip())
    k3_ms, k3_ev = both_ms(lambda: angular_aev(*k3_in, species=k3_species, **k3_kw))
    plain_ms = kernels_ms(lambda: angular_aev_reference(*k3_in, **k3_kw), reps=3)
    k3_lanes = k3_in[2].sum(1).to(torch.float64)
    pairs = float((k3_lanes * (k3_lanes - 1) / 2).sum())
    valid_lanes = float(k3_lanes.sum())
    sh, se = len(k3_kw["shifts"]), len(k3_kw["sections"])
    # the kernels' inputs: dist, diff and the int32 lane species
    lane_bytes = sum(t.numel() * t.element_size() for t in (k3_in[0], k3_in[1], k3_species))
    k3_bound = angular_bound_ms(pairs, valid_lanes, sh, se, lane_bytes + out.numel() * 4, False)
    print(f"{card}: K3 alone: {k3_ms:.4f} ms ({k3_ev:.4f} between events); plain version "
          f"{plain_ms:.3f} ms; "
          f"{pairs:.0f} valid pairs ({pairs / n:.1f} per atom); bound {k3_bound[0]:.4f} ms "
          f"by {k3_bound[1]} ({k3_bound[2] / 1e6:.1f} MB; by operations {k3_bound[3]:.4f} ms "
          f"f32, {k3_bound[4]:.4f} ms special functions)")
    # K3b on the sliced cotangent, as the main path hands it over; its plain
    # version at the computer's block; and what it replaced: autograd of the
    # plain forward, recomputed per block of at most 2 GiB
    k3b_ms, k3b_ev = both_ms(lambda: angular_aev_bwd(g3_slice, *k3_in, k3_species, **k3_kw))
    k3b_plain_ms = kernels_ms(
        lambda: angular_aev_bwd_reference(g3_slice, *k3_in, atom_block=k3_block, **k3_kw),
        reps=3,
    )

    def recompute():
        for start in range(0, n, k3_block):
            sl = slice(start, start + k3_block)
            with torch.enable_grad():
                d = k3_in[0][sl].detach().requires_grad_(True)
                df = k3_in[1][sl].detach().requires_grad_(True)
                grid_out = angular_grid(aevc.angular, k3_kw["num_species"], d, df,
                                        k3_in[2][sl], k3_in[3][sl])
                torch.autograd.grad(grid_out, (d, df), g3_slice[sl])

    recompute_ms = kernels_ms(recompute, reps=3)
    recompute_peak = peak_gib(recompute)
    k3b_bound = angular_bound_ms(pairs, valid_lanes, sh, se,
                                 k3b_bytes(k3_in, k3_species, k3_kw["num_species"], sh * se), True)
    print(f"{card}: K3b alone: {k3b_ms:.4f} ms ({k3b_ev:.4f} between events); plain version "
          f"{k3b_plain_ms:.3f} ms "
          f"(blocks of {k3_block} atoms); the recompute it replaced {recompute_ms:.3f} ms, "
          f"peak {recompute_peak:.3f} GiB; bound {k3b_bound[0]:.4f} ms by {k3b_bound[1]} "
          f"({k3b_bound[2] / 1e6:.1f} MB; by operations {k3b_bound[3]:.4f} ms f32, "
          f"{k3b_bound[4]:.4f} ms special functions)")

    # MD: the main path's 50 steps again from the same start, step by step
    # (each ending in a synchronize), and a third time as one run.  The same
    # trajectory each time: with random weights the box heats up, and a
    # longer run would leave the capacities measured at the start
    state = md_start
    step_ms = []
    for _ in range(MD_STEPS):
        t0 = time.perf_counter()
        state = md.step_nve(state)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    check(not bool(state.overflow) and bool(torch.isfinite(state.forces).all()),
          "MD stays finite over the second stretch")
    t0 = time.perf_counter()
    state = md.run_nve(md_start, MD_STEPS)
    torch.cuda.synchronize()
    run3_ms = (time.perf_counter() - t0) * 1e3 / MD_STEPS
    check(not bool(state.overflow) and bool(torch.isfinite(state.forces).all()),
          "MD stays finite over the third stretch")
    md_ms = float(np.median(step_ms))
    print(f"{card}: MD step {num_atoms} atoms: median {md_ms:.3f} ms, min {np.min(step_ms):.3f}, "
          f"max {np.max(step_ms):.3f} over {MD_STEPS} steps (host clock, each ending in a "
          f"synchronize); as one run {run1_ms:.3f} ms/step (first {MD_STEPS}) and "
          f"{run3_ms:.3f} ms/step (third {MD_STEPS}); {state.rebuilds} rebuilds in "
          f"{MD_STEPS} steps")
    print(f"{card}: MD {86.4 / md_ms:.3f} ns/day at 1 fs (from the median step)")
    print(f"{card}: MD step peak device memory: {peak_gib(lambda: md.step_nve(state)):.3f} GiB")
    sp_ms = wall_times_ms(lambda: [cached(geom) for geom in geoms[1:]], reps=5)
    print(f"{card}: CachedSinglePoint {np.median(sp_ms) / 2:.3f} ms per call "
          f"(median of 5 pairs of calls)")
    rebuild_ms = wall_times_ms(lambda: md._build_cache(state.coords), reps=5)
    print(f"{card}: neighbor rebuild (cell list at {md.build_radius:.2f} A, lane sort, "
          f"tables): median {np.median(rebuild_ms):.3f} ms")

    # K1 and K2 alone, their plain versions and the one PyTorch call that
    # computes the same function (over every lane: it cannot skip the
    # unoccupied ones)
    index3 = _flat_index(tables.keys, c_)[:, :, None].expand(-1, -1, 3)
    flat = torch.nn.functional.pad(cand.reshape(g_, 27 * c_, 3), (0, 0, 0, c_))
    d_flat = torch.empty((g_, 28 * c_, 3), device=dev)
    k1_ms, k1_ev = both_ms(lambda: bucket_select_fwd(cand, tables.keys, nlanes))
    k1_plain_ms, k1_plain_ev = both_ms(
        lambda: bucket_select_reference(cand, tables.keys, nlanes)
    )
    k1_lib_ms, k1_lib_ev = both_ms(lambda: torch.gather(flat, 1, index3))
    k2_ms, k2_ev = both_ms(lambda: bucket_select_bwd(g_rows, tables.keys, c_, nlanes))
    k2_plain_ms, k2_plain_ev = both_ms(
        lambda: bucket_select_bwd_reference(g_rows, tables.keys, c_, nlanes)
    )
    k2_lib_ms, k2_lib_ev = both_ms(lambda: d_flat.zero_().scatter_add_(1, index3, g_rows))
    k1_bound, k1_by, k1_bytes = select_bound_ms(lanes, g_, c_, adds=False)
    k2_bound, k2_by, k2_bytes = select_bound_ms(lanes, g_, c_, adds=True)
    print(f"{card}: K1 alone: {k1_ms:.4f} ms ({k1_ev:.4f} between events); plain version "
          f"{k1_plain_ms:.4f} ms ({k1_plain_ev:.4f}); torch.gather {k1_lib_ms:.4f} ms "
          f"({k1_lib_ev:.4f}); bound {k1_bound:.4f} ms by {k1_by} ({k1_bytes / 1e6:.1f} MB)")
    print(f"{card}: K2 alone: {k2_ms:.4f} ms ({k2_ev:.4f} between events); plain version "
          f"{k2_plain_ms:.4f} ms ({k2_plain_ev:.4f}); zero_ + scatter_add_ {k2_lib_ms:.4f} ms "
          f"({k2_lib_ev:.4f}); bound {k2_bound:.4f} ms by {k2_by} ({k2_bytes / 1e6:.1f} MB)")

    # the whole refresh, forward and backward: bucket (K1, K2) against gather
    # (index_select, index_add) on the same cached topology
    with torch.no_grad():
        ci = md0._to_internal(state0.coords)
        nb = _refresh_neighbors(state0, state0.coords)
        nbr_pos = ci.index_select(0, state0.nbr_idx.reshape(-1)).reshape(nb.diff.shape)
        shift = torch.where(
            state0.nbr_mask[..., None], nb.diff - (nbr_pos - ci[:, None, :]), 0.0
        )
    gather_state = state0.replace(bucket=None, nbr_shift=shift)
    weights = torch.randn(nb.diff.shape, device=dev, generator=torch.Generator(dev).manual_seed(4))

    def refresh(st):
        c = state0.coords.detach().requires_grad_(True)
        diff = _refresh_neighbors(st, c).diff
        return diff.detach(), torch.autograd.grad((diff * weights).sum(), c)[0]

    (diff_b, grad_b), (diff_g, grad_g) = refresh(state0), refresh(gather_state)
    d_diff = float((diff_b - diff_g).abs().max())
    d_grad = float((grad_b - grad_g).abs().max() / grad_g.abs().max())
    print(f"bucket vs gather refresh: max |d diff| {d_diff:.3e} A, relative gradient "
          f"difference {d_grad:.3e}")
    check(d_diff <= 2e-4, "bucket refresh reproduces the gather refresh")
    check(d_grad <= 1e-5, "bucket refresh gradient equals the gather refresh's")
    bucket_ms = cuda_ms(lambda: refresh(state0), reps=20)
    gather_ms = cuda_ms(lambda: refresh(gather_state), reps=20)
    bucket_kernels = kernels_ms(lambda: refresh(state0), reps=10)
    gather_kernels = kernels_ms(lambda: refresh(gather_state), reps=10)
    print(f"{card}: refresh forward+backward at (A={num_atoms}, K={k_}): bucket "
          f"{bucket_kernels:.4f} ms of kernels ({bucket_ms:.4f} ms between CUDA events, "
          f"the host's dispatch included), gather {gather_kernels:.4f} ms of kernels "
          f"({gather_ms:.4f} ms between events)")


    # ---- 11. ANI-2dr: K4f, K4b, K5f and K5b at the box's own tables ----
    del cached, md, md0, state0, nb, gather_state, weights, diff_b, diff_g
    torch.cuda.empty_cache()
    dr_model = ANI2dr(pretrained=False, seed=0)
    gen0 = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    dr_md = {
        "default": MolecularDynamics(dr_model, species, cell=cell, pbc=True),
        "frozen": MolecularDynamics(
            dr_model, species, cell=cell, pbc=True, freeze_pair_window=("dispersion_d3",)
        ),
        "packed": MolecularDynamics(dr_model, species, cell=cell, pbc=True, bucket_refresh="packed"),
    }
    probe = dr_md["default"].init(coords, temperature=300.0, generator=gen0())
    check(not bool(probe.overflow), "the ANI-2dr MD cache of the water box does not overflow")
    dt = probe.bucket
    check(dt is not None and not isinstance(dt, PackedTables),
          "the slot-layout bucket refresh is on under ANI-2dr (C <= 256)")
    dgrid, dg, dc, dk = _statics(dt.atom_of_slot, dt.keys, dt.wrapshift)
    dr = dc * dk
    dnl = _occupied_lanes(dt.atom_of_slot, num_atoms, dg, dc, dk)
    dlanes = int(dnl.sum())
    print(f"ANI-2dr MD tables: build radius {dr_md['default'].build_radius:.2f} A, grid {dgrid} "
          f"(G={dg}), C={dc} slots, K={dk} lanes, R={dr}; lane prefixes "
          f"{dr_md['default']._lane_prefixes}, angular prefix {dr_md['default']._ang_prefix}; "
          f"occupied lanes {dlanes} of {dg * dr} ({dlanes / (dg * dr):.1%}), "
          f"{int(probe.nbr_mask.sum())} of them hold a neighbor")
    docc = torch.arange(dr, device=dev)[None, :] < dnl[:, None]
    idx_flat = torch.where(probe.nbr_mask, probe.nbr_idx, 0).reshape(-1)
    k4 = {}
    for p_ in (1, 5):
        vals = torch.rand((num_atoms, p_), device=dev, generator=torch.Generator(dev).manual_seed(p_))
        vcand = _slot_sections(vals, dt.atom_of_slot, dgrid, dc)
        vout = vals_select_fwd(vcand, dt.keys, dnl)
        torch.cuda.synchronize()
        vref = vals_select_reference(vcand, dt.keys, dnl)
        f_err = float((vout - vref)[docc].abs().max())
        check(f_err == 0.0, f"K4f is an exact selection at P = {p_}")
        vg = torch.randn((dg, dr, p_), device=dev, generator=torch.Generator(dev).manual_seed(9))
        vshape = launch_shape(f"K4b at the ANI-2dr tables, P={p_},", dg, dc, p_)
        vback = vals_select_bwd(vg, dt.keys, dc, dnl)
        torch.cuda.synchronize()
        vbref = vals_select_bwd_reference(vg, dt.keys, dc, dnl)
        b_err = float((vback - vbref).abs().max())
        check(within(vback, vbref, SUM_TOL), f"K4b within tolerance at P = {p_}")
        # the library calls: values[idx] over the (A, K) lanes, and its transpose
        lane_g = torch.randn((idx_flat.shape[0], p_), device=dev)
        acc = torch.empty((num_atoms, p_), device=dev)
        times = dict(
            f=kernels_ms(lambda: vals_select_fwd(vcand, dt.keys, dnl), reps=20),
            f_plain=kernels_ms(lambda: vals_select_reference(vcand, dt.keys, dnl), reps=10),
            f_lib=kernels_ms(lambda: vals.index_select(0, idx_flat), reps=20),
            b=kernels_ms(lambda: vals_select_bwd(vg, dt.keys, dc, dnl), reps=20),
            b_plain=kernels_ms(lambda: vals_select_bwd_reference(vg, dt.keys, dc, dnl), reps=10),
            b_lib=kernels_ms(lambda: acc.zero_().index_add_(0, idx_flat, lane_g), reps=20),
        )
        fb = vals_bound_ms(dlanes, dg, dc, p_, adds=False)
        bb = vals_bound_ms(dlanes, dg, dc, p_, adds=True)
        k4[p_] = dict(f_err=f_err, b_err=b_err, fb=fb, bb=bb, split=vshape["split"],
                      threads=vshape["threads"], **times)
        print(f"{card}: K4f at P={p_}: max abs err {f_err:.3e}; {times['f']:.4f} ms; plain "
              f"{times['f_plain']:.4f} ms; index_select {times['f_lib']:.4f} ms; bound "
              f"{fb[0]:.4f} ms by {fb[1]} ({fb[2] / 1e6:.1f} MB)")
        print(f"{card}: K4b at P={p_}: max abs err {b_err:.3e}; {times['b']:.4f} ms; plain "
              f"{times['b_plain']:.4f} ms; zero_ + index_add_ {times['b_lib']:.4f} ms; bound "
              f"{bb[0]:.4f} ms by {bb[1]} ({bb[2] / 1e6:.1f} MB)")
        del vals, vcand, vout, vref, vg, vback, vbref, lane_g, acc
    # C = 256 at P = 5: 138 KB of shared memory
    wcand = torch.randn((3, 27, 256, 5), device=dev) * 20
    wg = torch.randn((3, 256 * 5, 5), device=dev)
    check(float((vals_select_fwd(wcand, skeys[:3]) - vals_select_reference(wcand, skeys[:3]))
                .abs().max()) == 0.0, "K4f exact at C = 256, P = 5")
    launch_shape("K4b on random keys", 3, 256, 5)
    check(within(vals_select_bwd(wg, skeys[:3], 256), vals_select_bwd_reference(wg, skeys[:3], 256),
                 SUM_TOL), "K4b within tolerance at C = 256, P = 5")

    pprobe = dr_md["packed"].init(coords, temperature=300.0, generator=gen0())
    pt = pprobe.bucket
    check(isinstance(pt, PackedTables) and not bool(pprobe.overflow),
          "the packed run packs its tables without overflow")
    _, pg, pc, pns, ps_cap, pkl = _packed_statics(pt)
    planes = pns * ps_cap * pkl
    pindex = _flat_rows_index(pt.keys_flat, pt.tile_bucket, pg, pc).reshape(-1)
    pvalid = int((pindex < pg * 27 * pc).sum())
    print(f"ANI-2dr packed tables: {pns} spans of {pg // pns} bucket(s), S_cap={ps_cap} rows, "
          f"KL={pkl} lanes: {pns * ps_cap} rows for {num_atoms} atoms ({planes} lanes against the "
          f"slot layout's {dlanes} occupied; {pvalid} of them hold a neighbor)")
    k5_shape = k5_launch_shape("K5f and K5b at the ANI-2dr packed tables", pg, pc,
                               max(1, ps_cap // 8 * pns // pg))
    pcanon = dr_md["packed"]._to_internal(pprobe.coords) - pt.wrap_offset
    pcand = _cand_table(pcanon, pt.atom_of_slot, pt.wrapshift, dgrid, pc)
    pout = packed_select_fwd(pcand, pt.keys_flat, pt.tile_bucket)
    torch.cuda.synchronize()
    pref = packed_select_reference(pcand, pt.keys_flat, pt.tile_bucket)
    k5f_err = float((pout - pref).abs().max())
    check(k5f_err == 0.0, "K5f is an exact selection")
    pgout = torch.randn(pout.shape, device=dev, generator=torch.Generator(dev).manual_seed(8))
    pback = packed_select_bwd(pgout, pt.keys_flat, pt.tile_bucket, pc, pg)
    torch.cuda.synchronize()
    pbref = packed_select_bwd_reference(pgout, pt.keys_flat, pt.tile_bucket, pc, pg)
    k5b_err = float((pback - pbref).abs().max())
    check(within(pback, pbref, SUM_TOL), "K5b within tolerance")
    # C = 256 (an 83 KB candidate tile), hand-made tables: a bucket owning
    # separate runs of tiles, one owning a single tile, a span of sentinels
    # only
    rng = np.random.RandomState(9)
    hg, hc, hns, htiles, hkl = 6, 256, 3, 4, 128
    hlanes = htiles * 8 * hkl
    hsec = np.where(rng.rand(hns, hlanes) < 0.8, rng.randint(0, 27, (hns, hlanes)), 27)
    hkeys_np = (hsec << 8) | np.where(hsec < 27, rng.randint(0, hc, (hns, hlanes)), 0)
    hkeys_np[1] = 27 << 8
    hkeys = torch.as_tensor(hkeys_np.astype(np.int32), device=dev).reshape(hns, 1, hlanes)
    htb = torch.tensor([[1, 0, 1, 1], [0, 0, 1, 1], [0, 1, 1, 0]], dtype=torch.int32, device=dev)
    hcand = torch.as_tensor(rng.randn(hg, 27, hc, 3).astype(np.float32), device=dev)
    hgout = torch.as_tensor(rng.randn(hns, hlanes, 3).astype(np.float32), device=dev)
    k5_launch_shape("K5f and K5b on hand-made tables", hg, hc, htiles * hns // hg)
    h5f = packed_select_fwd(hcand, hkeys, htb)
    h5b = packed_select_bwd(hgout, hkeys, htb, hc, hg)
    torch.cuda.synchronize()
    h5f_err = float((h5f - packed_select_reference(hcand, hkeys, htb)).abs().max())
    h5b_ref = packed_select_bwd_reference(hgout, hkeys, htb, hc, hg)
    print(f"K5f, K5b hand-made tables (C=256) vs plain: max abs err {h5f_err:.3e}, "
          f"{float((h5b - h5b_ref).abs().max()):.3e}")
    check(h5f_err == 0.0, "K5f exact at C = 256")
    check(within(h5b, h5b_ref, SUM_TOL), "K5b within tolerance at C = 256")
    check(bool((h5b[2:4] == 0).all()), "K5b: a span of sentinels only gives zero tiles")
    pflat = torch.cat([pcand.reshape(-1, 3), pcand.new_zeros((1, 3))])
    pacc = torch.empty_like(pflat)
    k5 = dict(
        f=kernels_ms(lambda: packed_select_fwd(pcand, pt.keys_flat, pt.tile_bucket), reps=20),
        f_plain=kernels_ms(
            lambda: packed_select_reference(pcand, pt.keys_flat, pt.tile_bucket), reps=10),
        f_lib=kernels_ms(lambda: pflat.index_select(0, pindex), reps=20),
        b=kernels_ms(
            lambda: packed_select_bwd(pgout, pt.keys_flat, pt.tile_bucket, pc, pg), reps=20),
        b_plain=kernels_ms(
            lambda: packed_select_bwd_reference(pgout, pt.keys_flat, pt.tile_bucket, pc, pg),
            reps=10),
        b_lib=kernels_ms(lambda: pacc.zero_().index_add_(0, pindex, pgout.reshape(-1, 3)), reps=20),
    )
    k5fb = packed_bound_ms(planes, planes, pg, pc, pt.tile_bucket.numel(), adds=False)
    k5bb = packed_bound_ms(planes, pvalid, pg, pc, pt.tile_bucket.numel(), adds=True)
    k5bb_all = packed_bound_ms(planes, planes, pg, pc, pt.tile_bucket.numel(), adds=True)
    print(f"{card}: K5f: max abs err {k5f_err:.3e}; {k5['f']:.4f} ms; plain {k5['f_plain']:.4f} "
          f"ms; index_select {k5['f_lib']:.4f} ms; bound {k5fb[0]:.4f} ms by {k5fb[1]} "
          f"({k5fb[2] / 1e6:.1f} MB)")
    print(f"{card}: K5b: max abs err {k5b_err:.3e}; {k5['b']:.4f} ms; plain {k5['b_plain']:.4f} "
          f"ms; zero_ + index_add_ {k5['b_lib']:.4f} ms; bound {k5bb[0]:.4f} ms by {k5bb[1]} "
          f"({k5bb[2] / 1e6:.1f} MB: the cotangents of the lanes that hold a neighbor; "
          f"{k5bb_all[0]:.4f} ms, {k5bb_all[2] / 1e6:.1f} MB, with every lane's)")
    # K1 and K2 at the same box, for the slot layout against the packed one;
    # K2 there against its plain version, with its own bound
    scanon = dr_md["default"]._to_internal(probe.coords) - dt.wrap_offset
    scand = _cand_table(scanon, dt.atom_of_slot, dt.wrapshift, dgrid, dc)
    sgrows = torch.randn((dg, dr, 3), device=dev, generator=torch.Generator(dev).manual_seed(10))
    k2_dr_shape = launch_shape("K2 at the ANI-2dr tables", dg, dc, 3)
    k2_dr_out = bucket_select_bwd(sgrows, dt.keys, dc, dnl)
    torch.cuda.synchronize()
    k2_dr_ref = bucket_select_bwd_reference(sgrows, dt.keys, dc, dnl)
    k2_dr_err = float((k2_dr_out - k2_dr_ref).abs().max())
    check(within(k2_dr_out, k2_dr_ref, K2_TOL), "K2 within tolerance at the ANI-2dr tables")
    sindex3 = _flat_index(dt.keys, dc)[:, :, None].expand(-1, -1, 3)
    sd_flat = torch.empty((dg, 28 * dc, 3), device=dev)
    k1_dr_shape = k1_launch_shape("K1 at the ANI-2dr tables", dg, dc, dr)
    k1_dr_out = bucket_select_fwd(scand, dt.keys, dnl)
    torch.cuda.synchronize()
    k1_dr_err = float((k1_dr_out - bucket_select_reference(scand, dt.keys, dnl))[docc].abs().max())
    check(k1_dr_err == 0.0, "K1 is an exact selection at the ANI-2dr tables")
    s_flat = torch.nn.functional.pad(scand.reshape(dg, 27 * dc, 3), (0, 0, 0, dc))
    k1_dr_all = dict(
        ms=kernels_ms(lambda: bucket_select_fwd(scand, dt.keys, dnl), reps=20),
        plain=kernels_ms(lambda: bucket_select_reference(scand, dt.keys, dnl), reps=10),
        lib=kernels_ms(lambda: torch.gather(s_flat, 1, sindex3), reps=20),
    )
    k1_dr = k1_dr_all["ms"]
    k2_dr = dict(
        ms=kernels_ms(lambda: bucket_select_bwd(sgrows, dt.keys, dc, dnl), reps=20),
        plain=kernels_ms(lambda: bucket_select_bwd_reference(sgrows, dt.keys, dc, dnl), reps=10),
        lib=kernels_ms(lambda: sd_flat.zero_().scatter_add_(1, sindex3, sgrows), reps=20),
    )
    k1_dr_bound = select_bound_ms(dlanes, dg, dc, adds=False)
    k2_dr_bound = select_bound_ms(dlanes, dg, dc, adds=True)
    print(f"{card}: K1 at the ANI-2dr tables: max abs err {k1_dr_err:.3e}; {k1_dr:.4f} ms; plain "
          f"{k1_dr_all['plain']:.4f} ms; torch.gather {k1_dr_all['lib']:.4f} ms; bound "
          f"{k1_dr_bound[0]:.4f} ms by {k1_dr_bound[1]} ({k1_dr_bound[2] / 1e6:.1f} MB)")
    print(f"{card}: K2 at the ANI-2dr tables: max abs err {k2_dr_err:.3e}; {k2_dr['ms']:.4f} ms; "
          f"plain {k2_dr['plain']:.4f} ms; zero_ + scatter_add_ {k2_dr['lib']:.4f} ms; bound "
          f"{k2_dr_bound[0]:.4f} ms by {k2_dr_bound[1]} ({k2_dr_bound[2] / 1e6:.1f} MB)")
    del pcand, pout, pref, pgout, pback, pbref, pindex, pflat, pacc, scand, sgrows, wcand, wg
    del hkeys, htb, hcand, hgout, h5f, h5b, h5b_ref
    del k2_dr_out, k2_dr_ref, sindex3, sd_flat, k1_dr_out, s_flat

    # ---- 12. ANI-2dr energies and forces on the water box ----
    dr_model.neighborlist = CellList()
    reset_counts()
    e_dr, f_dr = energies_and_forces(dr_model, species, coords, cell, pbc)
    torch.cuda.synchronize()
    dr_ef_launches = read_counts()
    print(f"ANI-2dr E+F: E = {float(e_dr[0]):.6f} Ha, launches {dr_ef_launches}")
    check(tuple(f_dr.shape) == (1, num_atoms, 3), "ANI-2dr forces shape (1, A, 3)")
    check(bool(torch.isfinite(e_dr).all()) and bool(torch.isfinite(f_dr).all()),
          "ANI-2dr energies and forces finite")
    check(dr_ef_launches["angular_aev"] == 1, "K3 launched once on the ANI-2dr E+F path")
    k3b_once_per_evaluation(dr_ef_launches, "ANI-2dr E+F")
    check(dr_ef_launches["vals_select_fwd"] == 0,
          "without bucket tables D3 gathers its neighbors' values")

    def dr_ef():
        energies_and_forces(dr_model, species, coords, cell, pbc)

    dr_ef_ms = wall_times_ms(dr_ef, reps=5)
    print(f"{card}: ANI-2dr E+F {num_atoms} atoms: median {np.median(dr_ef_ms):.3f} ms, min "
          f"{np.min(dr_ef_ms):.3f}, max {np.max(dr_ef_ms):.3f} over 5 calls; peak device memory "
          f"{peak_gib(dr_ef):.3f} GiB")

    # ---- 13. ANI-2dr MD three ways: defaults, frozen pair window, packed ----
    dr_launches, dr_start, dr_forces = {}, {}, {}
    for name, runner in dr_md.items():
        reset_counts()
        start = runner.init(coords, temperature=300.0, generator=gen0())
        e0 = total_energy(runner, start)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        end = runner.run_nve(start, DR_STEPS)
        torch.cuda.synchronize()
        run_ms = (time.perf_counter() - t0) * 1e3 / DR_STEPS
        dr_launches[name] = counts = read_counts()
        drift = total_energy(runner, end) - e0
        temps = [float(kinetic_temperature(st.velocities, runner.masses)) for st in (start, end)]
        check(end.step == DR_STEPS and not bool(end.overflow),
              f"ANI-2dr MD ({name}): {DR_STEPS} steps without overflow")
        for what, t in (("energy", end.energy), ("forces", end.forces), ("coords", end.coords)):
            check(bool(torch.isfinite(t).all()), f"ANI-2dr MD ({name}) {what} finite")
        check(abs(drift) <= 5e-3 * abs(e0) + 0.05, f"ANI-2dr MD ({name}) energy drift bounded")
        df = float((start.forces - f_dr[0]).abs().max())
        check(df <= FORCE_ATOL, f"ANI-2dr MD ({name}) init forces equal single-point forces")
        per_step = {k_: v / (DR_STEPS + 1) for k_, v in counts.items()}
        k3b_once_per_evaluation(counts, f"ANI-2dr MD ({name})")
        want = {"angular_aev", "angular_aev_bwd"}
        want |= {"packed_select_fwd", "packed_select_bwd"} if name == "packed" else {
            "bucket_select_fwd", "bucket_select_bwd", "vals_select_fwd", "vals_select_bwd"}
        check(all(counts[k_] >= DR_STEPS for k_ in want),
              f"ANI-2dr MD ({name}): {sorted(want)} launched at least once per step")
        check(all(v == 0 for k_, v in counts.items() if k_ not in want),
              f"ANI-2dr MD ({name}): no other kernel launched")
        backward = ("packed_select_bwd",) if name == "packed" else (
            "bucket_select_bwd", "vals_select_bwd")
        check(all(counts[k_] == counts["angular_aev"] for k_ in backward),
              f"ANI-2dr MD ({name}): {backward} launched once per evaluation")
        # the same stretch again, step by step, for the step's time
        state, step_ms = start, []
        for _ in range(DR_STEPS):
            t0 = time.perf_counter()
            state = runner.step_nve(state)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        check(bool(torch.isfinite(state.forces).all()), f"ANI-2dr MD ({name}) second stretch finite")
        peak = peak_gib(lambda: runner.step_nve(state))
        rebuild = wall_times_ms(lambda: runner._build_cache(state.coords), reps=3)
        moved = runner.step_nve(state.replace(ref_coords=state.ref_coords + 1.0))
        check(moved.rebuilds == state.rebuilds + 1 and not bool(moved.overflow),
              f"ANI-2dr MD ({name}): a displaced reference rebuilds the cache")
        _, f_one = energies_and_forces(dr_model, species, moved.coords[None], cell, pbc)
        df_rebuild = float((moved.forces - f_one[0]).abs().max())
        print(f"ANI-2dr MD ({name}) after a forced rebuild at step {moved.step}: max |dF| vs "
              f"one-shot E+F {df_rebuild:.3e} Ha/A, max |F| {float(f_one.abs().max()):.3e} Ha/A, "
              f"one-shot forces finite {bool(torch.isfinite(f_one).all())}")
        check(df_rebuild <= REBUILD_FORCE_ATOL,
              f"ANI-2dr MD ({name}): forces after a rebuild equal one-shot forces")
        dr_start[name], dr_forces[name] = start, start.forces
        print(f"{card}: ANI-2dr MD ({name}): step median {np.median(step_ms):.3f} ms, min "
              f"{np.min(step_ms):.3f}, max {np.max(step_ms):.3f} over {DR_STEPS} steps "
              f"({86.4 / np.median(step_ms):.3f} ns/day at 1 fs); as one run {run_ms:.3f} ms/step; "
              f"{end.rebuilds} rebuilds; rebuild {np.median(rebuild):.3f} ms; step peak memory "
              f"{peak:.3f} GiB; drift {drift:.6f} Ha of {e0:.3f}, kinetic temperature "
              f"{temps[0]:.1f} -> {temps[1]:.1f} K (random weights); max |dF| vs single point "
              f"{df:.3e} at init, {df_rebuild:.3e} Ha/A after a forced rebuild; launches per "
              f"evaluation { {k_: round(v, 2) for k_, v in per_step.items() if v} }")
        del start, end, state, moved
    for name in ("frozen", "packed"):
        df = float((dr_forces[name] - dr_forces["default"]).abs().max())
        print(f"ANI-2dr MD: {name} against default forces: max |dF| {df:.3e} Ha/A")
        check(df <= FORCE_ATOL, f"{name} forces equal the default run's")

    # ---- 14. ANI-2dr MD, card vs CPU: a 2,001-atom box (3 x 3 x 3 buckets) ----
    sp_m, co_m, cell_m = make_water_box(2001)
    ends = {}
    for where, kw in (("cuda", {}), ("cuda", dict(freeze_pair_window=("dispersion_d3",))),
                      ("cuda", dict(bucket_refresh="packed")), ("cpu", {})):
        m = ANI2dr(pretrained=False, seed=0, device=where)
        runner = MolecularDynamics(m, sp_m, cell=cell_m, pbc=True, device=where, **kw)
        start = runner.init(co_m, temperature=300.0, generator=gen0())
        check(start.bucket is not None, f"bucket refresh on for the 2,001-atom box ({where})")
        ends[(where, tuple(kw))] = runner.run_nve(start, 3)
    ref_end = ends[("cpu", ())]
    for (where, kw), end in ends.items():
        if where == "cpu":
            continue
        dc_ = float((end.coords.cpu() - ref_end.coords).abs().max())
        df = float((end.forces.cpu() - ref_end.forces).abs().max())
        print(f"ANI-2dr MD card {kw or 'default'} vs CPU, {sp_m.shape[1]} atoms, 3 steps: "
              f"max |dx| {dc_:.3e} A, max |dF| {df:.3e} Ha/A")
        check(dc_ <= MD_COORD_ATOL and df <= MD_FORCE_ATOL,
              f"ANI-2dr MD {kw or 'default'} agrees with the CPU")

    # ---- 15. ANI-1x: card vs CPU, E+F at the model's own K3/K3b inputs ----
    # free what the earlier phases hold (the frozen window's start state
    # alone holds over a GiB): each peak below also prints what was still
    # allocated before its call
    del dr_md, probe, pprobe, dt, pt, dnl, docc, idx_flat, dr_start, dr_forces, ends, ref_end
    del e_dr, f_dr, dr_model
    torch.cuda.empty_cache()
    x1_outs = {}
    for where in ("cuda", "cpu"):
        m = ANI1x(seed=0, device=where)
        x1_outs[where] = single_point(
            m, sp_s, co_s, cell_s, pbc_np, forces=True, atomic_energies=True
        )
    df = float((x1_outs["cuda"]["forces"].cpu() - x1_outs["cpu"]["forces"]).abs().max())
    dae = float((x1_outs["cuda"]["atomic_energies"].cpu()
                 - x1_outs["cpu"]["atomic_energies"]).abs().max())
    print(f"ANI-1x card vs CPU, {sp_s.shape[1]} atoms: max |dF| {df:.3e} Ha/A, "
          f"max |dE_atomic| {dae:.3e} Ha")
    check(df <= FORCE_ATOL, "ANI-1x forces agree with the CPU")
    check(dae <= ATOMIC_E_ATOL, "ANI-1x atomic energies agree with the CPU")

    x1_model = ANI1x(seed=0)
    x1_aevc = x1_model.aev_computer
    x1_elem = x1_model._convert(species)
    x1_nbrs = x1_model.neighborlist(x1_model.cutoff, x1_elem, coords, cell, pbc)
    _, x1_angular, x1_overflow = x1_aevc.flat_tables(x1_elem, x1_nbrs)
    check(not bool(x1_overflow), "ANI-1x water-box neighbor tables do not overflow")
    x1_in = x1_aevc.angular_inputs(x1_elem.reshape(-1), x1_angular)
    x1_kw = x1_aevc.kernel_kwargs()
    x1_sh, x1_se = len(x1_kw["shifts"]), len(x1_kw["sections"])
    check((x1_sh, x1_se, x1_kw["num_species"]) == (4, 8, 4), "ANI-1x's K3 template is 4 x 8, S = 4")
    x1_out = angular_aev(*x1_in, **x1_kw)
    torch.cuda.synchronize()
    x1_k3_err = kernel_errors(x1_out, angular_aev_reference(*x1_in, **x1_kw),
                              "K3 ANI-1x water box vs plain")
    x1_species = lane_species(x1_in[2], x1_in[3])
    x1_block = x1_aevc._atom_block(x1_in[0].shape[1])
    x1_g = torch.randn(x1_out.shape, device=dev, generator=torch.Generator(dev).manual_seed(12))
    x1_k3b_err = bwd_errors(
        angular_aev_bwd(x1_g, *x1_in, x1_species, **x1_kw),
        angular_aev_bwd_reference(x1_g, *x1_in, atom_block=x1_block, **x1_kw),
        x1_in[2], "K3b ANI-1x water box vs plain")
    x1_lanes = x1_in[2].sum(1).to(torch.float64)
    x1_pairs = float((x1_lanes * (x1_lanes - 1) / 2).sum())
    x1_lane_bytes = sum(t.numel() * t.element_size() for t in (x1_in[0], x1_in[1], x1_species))
    x1_k3 = dict(
        ms=kernels_ms(lambda: angular_aev(*x1_in, species=x1_species, **x1_kw), reps=20),
        plain=kernels_ms(lambda: angular_aev_reference(*x1_in, **x1_kw), reps=3),
        bound=angular_bound_ms(x1_pairs, float(x1_lanes.sum()), x1_sh, x1_se,
                               x1_lane_bytes + x1_out.numel() * 4, False),
    )
    x1_k3b_shape = k3b_launch_shape("K3b at the ANI-1x water box", x1_in, x1_kw)
    x1_k3b = dict(
        ms=kernels_ms(lambda: angular_aev_bwd(x1_g, *x1_in, x1_species, **x1_kw), reps=20),
        plain=kernels_ms(lambda: angular_aev_bwd_reference(
            x1_g, *x1_in, atom_block=x1_block, **x1_kw), reps=3),
        bound=angular_bound_ms(x1_pairs, float(x1_lanes.sum()), x1_sh, x1_se,
                               k3b_bytes(x1_in, x1_species, x1_kw["num_species"], x1_sh * x1_se),
                               True),
    )
    for name, k in (("K3", x1_k3), ("K3b", x1_k3b)):
        print(f"{card}: {name} at the ANI-1x tables (N={x1_in[0].shape[0]}, "
              f"Ka={x1_in[0].shape[1]}, {x1_sh} x {x1_se}): {k['ms']:.4f} ms; plain "
              f"{k['plain']:.3f} ms; bound "
              f"{k['bound'][0]:.4f} ms by {k['bound'][1]}")
    del x1_nbrs, x1_angular, x1_in, x1_out, x1_g, x1_species, x1_lanes

    reset_counts()
    e_x1, f_x1 = energies_and_forces(x1_model, species, coords, cell, pbc)
    torch.cuda.synchronize()
    x1_ef_launches = read_counts()
    print(f"ANI-1x E+F: E = {float(e_x1[0]):.6f} Ha, launches {x1_ef_launches}, "
          f"angular_grid calls {angular_grid.calls}")
    check(tuple(f_x1.shape) == (1, num_atoms, 3), "ANI-1x forces shape (1, A, 3)")
    check(bool(torch.isfinite(e_x1).all()) and bool(torch.isfinite(f_x1).all()),
          "ANI-1x energies and forces finite")
    check(x1_ef_launches["angular_aev"] == 1 and x1_ef_launches["angular_aev_bwd"] == 1
          and angular_grid.calls == 0,
          "one ANI-1x E+F launches K3 and K3b once each and builds no plain angular grid")
    check(all(v == 0 for k_, v in x1_ef_launches.items() if not k_.startswith("angular")),
          "ANI-1x E+F launches no other kernel")

    def x1_ef():
        energies_and_forces(x1_model, species, coords, cell, pbc)

    # the model's default neighbor list (a cell list of estimated capacity),
    # then the capacity that the ANI-2x E+F above runs with
    for nl in (x1_model.neighborlist, CellList(capacity=96)):
        x1_model.neighborlist = nl
        x1_ef_ms = wall_times_ms(x1_ef, reps=10)
        held = held_gib()
        print(f"{card}: ANI-1x E+F {num_atoms} atoms ({nl}): median {np.median(x1_ef_ms):.3f} ms, "
              f"min {np.min(x1_ef_ms):.3f}, max {np.max(x1_ef_ms):.3f} over 10 calls; peak device "
              f"memory {peak_gib(x1_ef):.3f} GiB ({held:.3f} held before the call)")

    # ---- 16. ANI-1x Langevin MD: friction 0 against NVE, then a thermostatted run ----
    x1_md = MolecularDynamics(x1_model, species, cell=cell, pbc=True)
    x1_start = x1_md.init(coords, temperature=300.0, generator=gen0())
    check(isinstance(x1_start.bucket, BucketTables) and not bool(x1_start.overflow),
          "the ANI-1x MD cache has slot-layout bucket tables and does not overflow")
    check(x1_start.generator is not None and x1_start.generator.device.type == "cuda",
          "the Langevin generator lies on the card")
    no_friction = x1_md.run_langevin(x1_start, 10, 300.0, friction_per_fs=0.0)
    nve = x1_md.run_nve(x1_start, 10)
    dx = float((no_friction.coords - nve.coords).abs().max())
    print(f"ANI-1x Langevin with friction 0 against NVE, 10 steps: max |dx| {dx:.3e} A")
    check(dx <= LANGEVIN_NVE_ATOL, "Langevin without friction is velocity Verlet")
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x1_end = x1_md.run_langevin(x1_start, X1_STEPS, 300.0, friction_per_fs=X1_FRICTION)
    torch.cuda.synchronize()
    x1_run_ms = (time.perf_counter() - t0) * 1e3 / X1_STEPS
    x1_md_launches = read_counts()
    x1_temp = float(kinetic_temperature(x1_end.velocities, x1_md.masses))
    check(x1_end.step == X1_STEPS and not bool(x1_end.overflow),
          f"ANI-1x Langevin: {X1_STEPS} steps without overflow")
    for what, t in (("energy", x1_end.energy), ("forces", x1_end.forces),
                    ("coords", x1_end.coords), ("velocities", x1_end.velocities)):
        check(bool(torch.isfinite(t).all()), f"ANI-1x Langevin {what} finite")
    want = {"angular_aev", "angular_aev_bwd", "bucket_select_fwd", "bucket_select_bwd"}
    check(all(x1_md_launches[k_] == X1_STEPS for k_ in want) and angular_grid.calls == 0,
          f"ANI-1x Langevin: K1, K2, K3 and K3b each launched once per step, no plain grid")
    check(all(v == 0 for k_, v in x1_md_launches.items() if k_ not in want),
          "ANI-1x Langevin: no other kernel launched")
    state, step_ms = x1_start, []
    for _ in range(10):
        t0 = time.perf_counter()
        state = x1_md.step_langevin(state, 300.0, X1_FRICTION)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    held = held_gib()
    x1_peak = peak_gib(lambda: x1_md.step_langevin(state, 300.0, X1_FRICTION))
    print(f"{card}: ANI-1x Langevin MD {num_atoms} atoms (1 fs, {X1_FRICTION}/fs): step median "
          f"{np.median(step_ms):.3f} ms, min {np.min(step_ms):.3f}, max {np.max(step_ms):.3f} "
          f"over 10 steps; as one run of {X1_STEPS} {x1_run_ms:.3f} ms/step; launches per step "
          f"{ {k_: x1_md_launches[k_] / X1_STEPS for k_ in sorted(want)} }; {x1_end.rebuilds} "
          f"rebuilds; kinetic temperature 300 -> {x1_temp:.1f} K; E_pot "
          f"{float(x1_end.energy):.6f} Ha; step peak memory {x1_peak:.3f} GiB ({held:.3f} "
          f"held before the step)")
    del x1_md, x1_start, x1_end, no_friction, nve, state, x1_model
    torch.cuda.empty_cache()

    # ---- 17. ANI-2dr under MultipleTimestepMD (RESPA, every = 4) ----
    mts_model = ANI2dr(pretrained=False, seed=0)
    mts = MultipleTimestepMD(mts_model, species, cell=cell, pbc=True, every=MTS_EVERY,
                             timestep_fs=MTS_DT)
    mts_start = mts.init(coords, temperature=300.0, generator=gen0())
    for lane, st in (("fast", mts_start.fast), ("slow", mts_start.slow)):
        check(isinstance(st.bucket, BucketTables) and not bool(st.overflow),
              f"MTS {lane} lane: slot-layout bucket tables, no overflow")
    check(mts.slow_names == ("dispersion_d3",) and mts_start.slow.pair_aux is not None,
          "MTS: D3 on the slow lane with its frozen window")
    print(f"MTS lanes: fast cutoff {mts.fast.cutoff} A, build {mts.fast.build_radius:.2f} A, grid "
          f"{mts.fast.grid_shape}, K={mts_start.fast.nbr_idx.shape[1]}, angular prefix "
          f"{mts.fast._ang_prefix}; slow cutoff {mts.slow.cutoff} A, build "
          f"{mts.slow.build_radius:.2f} A, grid {mts.slow.grid_shape}, "
          f"K={mts_start.slow.nbr_idx.shape[1]}")
    lang = dict(ensemble="langevin", temperature=300.0, friction_per_fs=MTS_FRICTION)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mts_end = mts.run(mts_start, MTS_EVERY * MTS_OUTER, **lang)
    torch.cuda.synchronize()
    mts_run_ms = (time.perf_counter() - t0) * 1e3 / MTS_OUTER
    mts_launches = read_counts()
    per_outer = {
        "angular_aev": MTS_EVERY, "angular_aev_bwd": MTS_EVERY,
        "bucket_select_fwd": MTS_EVERY + 1, "bucket_select_bwd": MTS_EVERY + 1,
        "vals_select_fwd": 1, "vals_select_bwd": 1,
        "packed_select_fwd": 0, "packed_select_bwd": 0, "angular_aev_bwd_bwd": 0,
    }
    print(f"MTS launches in {MTS_OUTER} outer steps: {mts_launches}")
    check(mts_launches == {k_: v * MTS_OUTER for k_, v in per_outer.items()}
          and angular_grid.calls == 0,
          f"MTS: per outer step {per_outer}, and no plain angular grid")
    check(mts_end.step == MTS_EVERY * MTS_OUTER and not bool(mts_end.overflow),
          "MTS run: every inner step taken, no overflow")
    for what, t in (("energy", mts_end.energy), ("forces", mts_end.forces),
                    ("coords", mts_end.coords), ("velocities", mts_end.velocities)):
        check(bool(torch.isfinite(t).all()), f"MTS {what} finite")
    mts_temp = float(kinetic_temperature(mts_end.velocities, mts.masses))
    outer_ms, state = [], mts_start
    for _ in range(MTS_OUTER):
        t0 = time.perf_counter()
        state = mts.run(state, MTS_EVERY, **lang)
        torch.cuda.synchronize()
        outer_ms.append((time.perf_counter() - t0) * 1e3)
    inner_ms, fast = [], state.fast
    for _ in range(2 * MTS_EVERY):
        t0 = time.perf_counter()
        fast = mts.fast.step_langevin(fast, 300.0, MTS_FRICTION)
        torch.cuda.synchronize()
        inner_ms.append((time.perf_counter() - t0) * 1e3)
    held = held_gib()
    mts_peak = peak_gib(lambda: mts.run(state, MTS_EVERY, **lang))
    print(f"{card}: ANI-2dr MTS {num_atoms} atoms (every {MTS_EVERY}, {MTS_DT} fs, Langevin "
          f"{MTS_FRICTION}/fs): outer step median {np.median(outer_ms):.3f} ms, min "
          f"{np.min(outer_ms):.3f}, max {np.max(outer_ms):.3f} over {MTS_OUTER}; inner (fast-lane) "
          f"step median {np.median(inner_ms):.3f} ms over {len(inner_ms)}; as one run "
          f"{mts_run_ms:.3f} ms per outer step; rebuilds fast {mts_end.fast.rebuilds}, slow "
          f"{mts_end.slow.rebuilds} in {MTS_OUTER} outer steps; kinetic temperature 300 -> "
          f"{mts_temp:.1f} K; outer-step peak memory {mts_peak:.3f} GiB ({held:.3f} held "
          f"before the step)")
    del mts_start, mts_end, state, fast

    # every = 1 is velocity Verlet on the whole model: against the plain
    # `MolecularDynamics` with the same frozen D3 window, 6 NVE steps at 1 fs
    mts1 = MultipleTimestepMD(mts_model, species, cell=cell, pbc=True, every=1)
    plain = MolecularDynamics(mts_model, species, cell=cell, pbc=True,
                              freeze_pair_window=("dispersion_d3",))
    end1 = mts1.run(mts1.init(coords, temperature=300.0, generator=gen0()), 6)
    endp = plain.run_nve(plain.init(coords, temperature=300.0, generator=gen0()), 6)
    dx = (end1.coords - endp.coords).abs()
    de = abs(float(end1.energy) - float(endp.energy))
    print(f"MTS every=1 against plain MolecularDynamics, 6 NVE steps: max |dx| "
          f"{float(dx.max()):.3e} A, |dE| {de:.3e} Ha of {float(endp.energy):.3f}")
    check(bool((dx <= MTS_COORD_ATOL + MTS_COORD_RTOL * endp.coords.abs()).all()),
          "MTS every=1 coordinates equal velocity Verlet's")
    check(de <= MTS_E_TOL * (1 + abs(float(endp.energy))),
          "MTS every=1 energy equals velocity Verlet's")
    del mts1, plain, end1, endp, mts
    torch.cuda.empty_cache()

    # the card against the CPU: 8 inner NVE steps on the 2,001-atom box
    mts_ends = {}
    for where in ("cuda", "cpu"):
        m = ANI2dr(pretrained=False, seed=0, device=where)
        runner = MultipleTimestepMD(m, sp_m, cell=cell_m, pbc=True, every=MTS_EVERY,
                                    timestep_fs=MTS_DT, device=where)
        start = runner.init(co_m, temperature=300.0, generator=gen0())
        check(start.fast.bucket is not None and start.slow.bucket is not None,
              f"bucket refresh on both MTS lanes of the 2,001-atom box ({where})")
        mts_ends[where] = runner.run(start, 2 * MTS_EVERY)
    dc_ = float((mts_ends["cuda"].coords.cpu() - mts_ends["cpu"].coords).abs().max())
    print(f"MTS card vs CPU, {sp_m.shape[1]} atoms, {2 * MTS_EVERY} inner steps: max |dx| "
          f"{dc_:.3e} A")
    check(dc_ <= MD_COORD_ATOL, "MTS coordinates agree with the CPU")

    # ---- 18. pretrained: a model written in the published key scheme loads back ----
    src = ANI2x(pretrained=False, seed=3)
    with tempfile.TemporaryDirectory() as tmp:
        paths.set_data_dir(tmp)
        try:
            sd = {k_: torch.as_tensor(v) for k_, v in convert.save_state_dict(src).items()}
            torch.save(sd, paths.state_dicts_dir() / "ani2x_state_dict.pt")
            loaded = ANI2x(pretrained=True)
        finally:
            paths.set_data_dir(None)
    check(loaded.device.type == "cuda", "the pretrained model lies on the card")
    e_src, f_src = energies_and_forces(src, species, coords, cell, pbc)
    e_ld, f_ld = energies_and_forces(loaded, species, coords, cell, pbc)
    df = float((f_ld - f_src).abs().max())
    print(f"pretrained ANI-2x ({len(sd)} keys through torch.save and the data directory): max "
          f"|dF| {df:.3e} Ha/A, |dE| {float((e_ld - e_src).abs().max()):.3e} Ha against the source")
    check(df <= PRETRAINED_FORCE_ATOL, "the loaded model's forces equal the source model's")

    del src, loaded, sd, e_src, f_src, e_ld, f_ld, mts_model, mts_ends
    torch.cuda.empty_cache()

    # ---- 19. K3bb, K3b's backward, against its plain version ----
    # at the water box's tables: the column-sliced cotangent of the main
    # path and a seeded random direction on the lanes
    dgen = torch.Generator(dev).manual_seed(13)
    u3 = (torch.randn(k3_in[0].shape, device=dev, generator=dgen),
          torch.randn(k3_in[1].shape, device=dev, generator=dgen))
    k3bb_block = max(1, k3_block // 4)  # the plain version holds ~4x K3b's grid
    k3bb = angular_aev_bwd_bwd(g3_slice, *k3_in, *u3, k3_species, **k3_kw)
    torch.cuda.synchronize()
    k3bb_err = bwd_bwd_errors(
        k3bb, angular_aev_bwd_bwd_reference(g3_slice, *k3_in, *u3, atom_block=k3bb_block, **k3_kw),
        k3_in[2], "K3bb ANI-2x water box vs plain")
    small_u = (torch.randn(small_in[0].shape, device=dev, generator=dgen),
               torch.randn(small_in[1].shape, device=dev, generator=dgen))
    small_bb = angular_aev_bwd_bwd(g_small, *small_in, *small_u, **small_kw)
    torch.cuda.synchronize()
    bwd_bwd_errors(small_bb, angular_aev_bwd_bwd_reference(g_small, *small_in, *small_u, **small_kw),
                   small_in[2], "K3bb ANI-1x smooth random lanes vs plain")
    check(all(bool((t[::7] == 0).all()) for t in small_bb),
          "K3bb: fully masked rows give exact zeros")
    k3bb_ms, k3bb_ev = both_ms(
        lambda: angular_aev_bwd_bwd(g3_slice, *k3_in, *u3, k3_species, **k3_kw))
    k3bb_plain_ms = kernels_ms(lambda: angular_aev_bwd_bwd_reference(
        g3_slice, *k3_in, *u3, atom_block=k3bb_block, **k3_kw), reps=1)
    k3bb_bytes = (k3b_bytes(k3_in, k3_species, k3_kw["num_species"], sh * se)
                  + sum(t.numel() * 4 for t in u3) + out.numel() * 4)
    k3bb_bound = k3bb_bound_ms(pairs, valid_lanes, sh, se, k3bb_bytes)
    k3bb_shape = k3b_launch_shape("K3bb at the ANI-2x water box", k3_in, k3_kw, second_order=True)
    print(f"{card}: K3bb alone: {k3bb_ms:.4f} ms ({k3bb_ev:.4f} between events); plain version "
          f"{k3bb_plain_ms:.3f} ms (blocks of {k3bb_block} atoms); bound {k3bb_bound[0]:.4f} ms "
          f"by {k3bb_bound[1]} ({k3bb_bound[2] / 1e6:.1f} MB; by operations {k3bb_bound[3]:.4f} "
          f"ms f32, {k3bb_bound[4]:.4f} ms special functions)")

    # ---- 20. Hessians and vibrational analysis of a 30-water cluster ----
    cl_sp, cl_co, _ = make_water_box(90)  # 30 waters, taken as a cluster (no cell)
    cl_atoms = cl_sp.shape[1]
    h_model = ANI2x(pretrained=False, seed=0)
    rows = hessian_rows(1, cl_atoms)
    passes = -(-3 * cl_atoms // rows)
    # K3bb at the tables of one pass: the cluster replicated `rows` times
    rep_elem = h_model._convert(torch.as_tensor(cl_sp, device=dev).repeat(rows, 1))
    rep_co = torch.as_tensor(cl_co, device=dev).repeat(rows, 1, 1)
    h_aevc = h_model.aev_computer
    _, h_ang, _ = h_aevc.flat_tables(
        rep_elem, h_model.neighborlist(h_model.cutoff, rep_elem, rep_co, None, None))
    h_in = h_aevc.angular_inputs(rep_elem.reshape(-1), h_ang)
    h_g = torch.randn((h_in[0].shape[0], out.shape[1]), device=dev, generator=dgen)
    h_u = (torch.randn(h_in[0].shape, device=dev, generator=dgen),
           torch.randn(h_in[1].shape, device=dev, generator=dgen))
    h_species = lane_species(h_in[2], h_in[3])
    h_k3bb_err = bwd_bwd_errors(
        angular_aev_bwd_bwd(h_g, *h_in, *h_u, h_species, **k3_kw),
        angular_aev_bwd_bwd_reference(h_g, *h_in, *h_u, atom_block=k3bb_block, **k3_kw),
        h_in[2], f"K3bb at the Hessian pass's tables (N={h_in[0].shape[0]}, Ka={h_in[0].shape[1]})")
    h_k3bb_ms, h_k3bb_ev = both_ms(
        lambda: angular_aev_bwd_bwd(h_g, *h_in, *h_u, h_species, **k3_kw))
    h_k3bb_plain_ms = kernels_ms(lambda: angular_aev_bwd_bwd_reference(
        h_g, *h_in, *h_u, atom_block=k3bb_block, **k3_kw), reps=1)
    h_lanes = h_in[2].sum(1).to(torch.float64)
    h_pairs = float((h_lanes * (h_lanes - 1) / 2).sum())
    h_k3bb_bound = k3bb_bound_ms(
        h_pairs, float(h_lanes.sum()), sh, se,
        k3b_bytes(h_in, h_species, k3_kw["num_species"], sh * se)
        + sum(t.numel() * 4 for t in h_u) + h_g.numel() * 4)
    h_k3bb_shape = k3b_launch_shape("K3bb at the Hessian pass's tables", h_in, k3_kw,
                                    second_order=True)
    print(f"{card}: K3bb at the Hessian pass's tables: {h_k3bb_ms:.4f} ms ({h_k3bb_ev:.4f} between "
          f"events); plain version {h_k3bb_plain_ms:.3f} ms; {h_pairs:.0f} valid pairs; bound "
          f"{h_k3bb_bound[0]:.4f} ms by {h_k3bb_bound[1]} ({h_k3bb_bound[2] / 1e6:.1f} MB; by "
          f"operations {h_k3bb_bound[3]:.4f} ms f32, {h_k3bb_bound[4]:.4f} ms special functions)")
    del rep_elem, rep_co, h_ang, h_in, h_g, h_u, h_species
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    h_card = hessians(h_model, cl_sp, cl_co)
    torch.cuda.synchronize()
    hess_first_ms = (time.perf_counter() - t0) * 1e3
    hess_launches = read_counts()
    want = {"angular_aev": passes, "angular_aev_bwd": 2 * passes, "angular_aev_bwd_bwd": passes}
    print(f"Hessian of {cl_atoms} atoms: {rows} rows a pass, {passes} passes, launches "
          f"{hess_launches}, angular_grid calls {angular_grid.calls}")
    check(hess_launches == {k_: want.get(k_, 0) for k_ in kernels_fn} and angular_grid.calls == 0,
          f"Hessian: per pass K3 and K3bb once, K3b twice, nothing else, no plain grid")
    check(tuple(h_card.shape) == (1, 3 * cl_atoms, 3 * cl_atoms) and bool(torch.isfinite(h_card).all()),
          "Hessian finite, of shape (1, 3A, 3A)")
    asym = float((h_card[0] - h_card[0].T).abs().max())
    reset_counts()
    vib = single_point(h_model, cl_sp, cl_co, vibrational=True)
    vib_launches = read_counts()
    check(vib_launches == {**hess_launches, "angular_aev": passes + 1},
          "single_point(vibrational=True): its energies' K3 and one Hessian's kernels")
    freqs = vib["freqs"][0]
    check(tuple(vib["modes"].shape) == (1, 3 * cl_atoms, cl_atoms, 3)
          and bool(torch.isfinite(freqs).all()), "vibrational analysis finite, modes (1, 3A, A, 3)")
    h_cpu = hessians(ANI2x(pretrained=False, seed=0, device="cpu"), cl_sp, cl_co)
    dh = (h_card.cpu() - h_cpu).abs()
    print(f"Hessian card vs CPU: max |dH| {float(dh.max()):.3e} Ha/A^2 (max |H| "
          f"{float(h_cpu.abs().max()):.3e}); max |H - H^T| {asym:.3e}; frequencies "
          f"{float(freqs.min()):.1f} to {float(freqs.max()):.1f} cm^-1 (random weights)")
    check(bool((dh <= HESSIAN_ATOL + HESSIAN_RTOL * h_cpu.abs()).all()),
          "the Hessian agrees with the CPU")
    hess_ms = wall_times_ms(lambda: hessians(h_model, cl_sp, cl_co), reps=3)
    held = held_gib()
    hess_peak = peak_gib(lambda: hessians(h_model, cl_sp, cl_co))
    vib_ms = wall_times_ms(lambda: single_point(h_model, cl_sp, cl_co, vibrational=True), reps=3)
    print(f"{card}: Hessian {cl_atoms} atoms: median {np.median(hess_ms):.3f} ms (first call "
          f"{hess_first_ms:.3f}); single_point(vibrational=True) median {np.median(vib_ms):.3f} ms; "
          f"peak device memory {hess_peak:.3f} GiB ({held:.3f} held before the call; "
          f"{(hess_peak - held) * 2**30 / (rows * cl_atoms) / 1024:.1f} KiB a replicated atom)")
    del h_card, h_cpu, dh, vib, freqs

    # the Hessian of ANI-2dr (networks, xTB, D3) under `cell_list`, a neighbor
    # list that takes a single system: the first 9 atoms of a 96-atom water
    # box in its periodic cell, card against CPU
    dr_sp, dr_co, dr_cell = make_water_box(96)
    dr_sp, dr_co = dr_sp[:, :9], dr_co[:, :9]
    dr_rows = hessian_rows(1, dr_sp.shape[1])
    dr_passes = -(-3 * dr_sp.shape[1] // dr_rows)
    dr_h = {}
    for where in ("cuda", "cpu"):
        m = ANI2dr(pretrained=False, seed=0, device=where)
        m.neighborlist = CellList()
        reset_counts()
        dr_h[where] = hessians(m, dr_sp, dr_co, dr_cell, pbc_np)
        if where == "cuda":
            torch.cuda.synchronize()
            dr_hess_launches, dr_grid_calls = read_counts(), angular_grid.calls
            dr_hess_ms = wall_times_ms(lambda m=m: hessians(m, dr_sp, dr_co, dr_cell, pbc_np),
                                       reps=3)
    want = {"angular_aev": dr_passes, "angular_aev_bwd": 2 * dr_passes,
            "angular_aev_bwd_bwd": dr_passes}
    dh = (dr_h["cuda"].cpu() - dr_h["cpu"]).abs()
    print(f"{card}: Hessian of ANI-2dr under cell_list, {dr_sp.shape[1]} atoms (periodic): "
          f"{dr_passes} pass of {dr_rows} rows, launches {dr_hess_launches}; median "
          f"{np.median(dr_hess_ms):.3f} ms; card vs CPU max |dH| {float(dh.max()):.3e} Ha/A^2 "
          f"(max |H| {float(dr_h['cpu'].abs().max()):.3e})")
    check(dr_hess_launches == {k_: want.get(k_, 0) for k_ in kernels_fn} and dr_grid_calls == 0,
          "ANI-2dr cell_list Hessian: per pass K3 and K3bb once, K3b twice, no plain grid")
    check(tuple(dr_h["cuda"].shape) == (1, 27, 27) and bool(torch.isfinite(dr_h["cuda"]).all()),
          "ANI-2dr cell_list Hessian finite, (1, 27, 27)")
    check(bool((dh <= HESSIAN_ATOL + HESSIAN_RTOL * dr_h["cpu"].abs()).all()),
          "the ANI-2dr cell_list Hessian agrees with the CPU")
    del dr_h, dh

    # ---- 21. ensemble forces and stress on the water box ----
    ens_launches, ens_ms = {}, {}
    ens_calls = {
        "members": lambda: members_energies_and_forces(model, species, coords, cell, pbc),
        "force_qbc": lambda: force_qbc(model, species, coords, cell, pbc),
        "stress_scaling": lambda: stress_scaling(model, species, coords, cell, pbc),
        "stress_fdotr": lambda: stress_fdotr(model, species, coords, cell, pbc),
    }
    ens_out = {}
    for name, fn in ens_calls.items():
        reset_counts()
        ens_out[name] = fn()
        torch.cuda.synchronize()
        ens_launches[name] = read_counts()
        ens_ms[name] = float(np.median(wall_times_ms(fn, reps=3)))
    m_e, m_f = ens_out["members"]
    num_members = m_e.shape[0]
    print(f"ensemble and stress on {num_members} members: launches {ens_launches}")
    for name, counts in ens_launches.items():
        k3b_want = num_members if name in ("members", "force_qbc") else 1
        want = {"angular_aev": 1, "angular_aev_bwd": k3b_want}
        check(counts == {k_: want.get(k_, 0) for k_ in kernels_fn} and angular_grid.calls == 0,
              f"{name}: one K3 launch and {k3b_want} of K3b, nothing else")
    check(tuple(m_f.shape) == (num_members, 1, num_atoms, 3) and bool(torch.isfinite(m_f).all()),
          "members' forces finite, (E, 1, A, 3)")
    check(float((m_f.mean(0) - forces).abs().max()) <= FORCE_ATOL,
          "the members' mean force is the model's force")
    for name in ("stress_scaling", "stress_fdotr"):
        check(tuple(ens_out[name].shape) == (3, 3) and bool(torch.isfinite(ens_out[name]).all()),
              f"{name} finite, (3, 3)")
    d_kinds = float((ens_out["stress_scaling"] - ens_out["stress_fdotr"]).abs().max())
    print(f"{card}: members {ens_ms['members']:.3f} ms, force_qbc {ens_ms['force_qbc']:.3f} ms, "
          f"stress_scaling {ens_ms['stress_scaling']:.3f} ms, stress_fdotr "
          f"{ens_ms['stress_fdotr']:.3f} ms ({num_atoms} atoms, medians of 3); the two stresses "
          f"differ by {d_kinds:.3e} Ha/A^3 (max |s| {float(ens_out['stress_scaling'].abs().max()):.3e})")
    del ens_out, m_e, m_f
    # card against CPU at 1,002 atoms
    ens_sides = {}
    for where in ("cuda", "cpu"):
        m = ANI2x(pretrained=False, seed=0, device=where)
        m.neighborlist = CellList()
        ens_sides[where] = (
            members_energies_and_forces(m, sp_s, co_s, cell_s, pbc_np)[1],
            force_qbc(m, sp_s, co_s, cell_s, pbc_np),
            stress_scaling(m, sp_s, co_s, cell_s, pbc_np),
            stress_fdotr(m, sp_s, co_s, cell_s, pbc_np),
        )
    (mf_c, qbc_c, ss_c, sf_c), (mf_p, qbc_p, ss_p, sf_p) = (
        [t.cpu() for t in ens_sides["cuda"]], ens_sides["cpu"])
    d_mf = float((mf_c - mf_p).abs().max())
    d_qbc = float((qbc_c - qbc_p).abs().max())
    d_ss = float((ss_c - ss_p).abs().max() / ss_p.abs().max())
    d_sf = float((sf_c - sf_p).abs().max() / sf_p.abs().max())
    print(f"ensemble and stress card vs CPU, {sp_s.shape[1]} atoms: members' forces max |dF| "
          f"{d_mf:.3e} Ha/A, force QBC {d_qbc:.3e}; stress (scaled by max|ref|) scaling {d_ss:.3e}, "
          f"fdotr {d_sf:.3e}")
    check(d_mf <= FORCE_ATOL and d_qbc <= FORCE_ATOL, "members' forces agree with the CPU")
    check(d_ss <= STRESS_TOL and d_sf <= STRESS_TOL, "stress agrees with the CPU")
    del ens_sides

    # ---- 22. Nose-Hoover chain and Berendsen NPT on the water box ----
    thermo = {}
    for name in ("nhc", "npt"):
        kw = dict(npt_compression=NPT_COMPRESSION) if name == "npt" else {}
        runner = MolecularDynamics(model, species, cell=cell, pbc=True, **kw)
        start = runner.init(coords, temperature=300.0, generator=gen0())
        check(isinstance(start.bucket, BucketTables) and not bool(start.overflow),
              f"{name}: slot-layout bucket tables, no overflow")

        def run(st, n, runner=runner, name=name):
            if name == "nhc":
                return runner.run_nvt_nose_hoover(st, n, temperature=300.0, tau_fs=NHC_TAU_FS)
            return runner.run_npt_berendsen(st, n, temperature=300.0, pressure_bar=1.0)

        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        end = run(start, THERMO_STEPS)
        torch.cuda.synchronize()
        run_ms = (time.perf_counter() - t0) * 1e3 / THERMO_STEPS
        counts = read_counts()
        want = {k_: THERMO_STEPS for k_ in
                ("angular_aev", "angular_aev_bwd", "bucket_select_fwd", "bucket_select_bwd")}
        check(counts == {k_: want.get(k_, 0) for k_ in kernels_fn} and angular_grid.calls == 0,
              f"{name}: K1, K2, K3 and K3b once per step, nothing else, no plain grid")
        check(end.step == THERMO_STEPS and not bool(end.overflow), f"{name}: no overflow")
        for what, t in (("energy", end.energy), ("forces", end.forces), ("coords", end.coords),
                        ("velocities", end.velocities)):
            check(bool(torch.isfinite(t).all()), f"{name} {what} finite")
        step_ms, st = [], end
        for _ in range(5):
            t0 = time.perf_counter()
            st = run(st, 1)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        extra = (f"chain {end.nhc[0].tolist()}" if name == "nhc" else
                 f"scale {float(end.scale):.6f}, build radius {runner.build_radius:.3f} A, "
                 f"angular prefix {runner._ang_prefix}")
        print(f"{card}: {name} {num_atoms} atoms: {THERMO_STEPS} steps as one run {run_ms:.3f} "
              f"ms/step, step median {np.median(step_ms):.3f} ms over 5; {end.rebuilds} rebuilds; "
              f"kinetic temperature 300 -> "
              f"{float(kinetic_temperature(end.velocities, runner.masses)):.1f} K; {extra}")
        thermo[name] = dict(launches=counts, run_ms=run_ms, step_ms=float(np.median(step_ms)))
        del runner, start, end, st
    torch.cuda.empty_cache()
    # card against CPU at 1,002 atoms
    for name in ("nhc", "npt"):
        ends = {}
        for where in ("cuda", "cpu"):
            m = ANI2x(pretrained=False, seed=0, device=where)
            kw = dict(npt_compression=NPT_COMPRESSION) if name == "npt" else {}
            runner = MolecularDynamics(m, sp_s, cell=cell_s, pbc=True, device=where, **kw)
            start = runner.init(co_s, temperature=300.0, generator=gen0())
            ends[where] = (runner.run_nvt_nose_hoover(start, THERMO_STEPS, 300.0, NHC_TAU_FS)
                           if name == "nhc" else runner.run_npt_berendsen(start, THERMO_STEPS, 300.0))
        dc_ = float((ends["cuda"].coords.cpu() - ends["cpu"].coords).abs().max())
        extra = "" if name == "nhc" else (
            f", scale {float(ends['cuda'].scale):.8f} vs {float(ends['cpu'].scale):.8f}")
        print(f"{name} card vs CPU, {sp_s.shape[1]} atoms, {THERMO_STEPS} steps: max |dx| "
              f"{dc_:.3e} A{extra}")
        check(dc_ <= MD_COORD_ATOL, f"{name} coordinates agree with the CPU")

    # ---- 23. a: trajectory on the water box ----
    t_phases = time.perf_counter()
    tools = {}  # launches of each new path
    traj_md = MolecularDynamics(md_model, species, cell=cell, pbc=True)
    traj_start = traj_md.init(coords, temperature=300.0, generator=torch.Generator().manual_seed(0))
    traj_ms = {"run_nve": [], "trajectory": []}
    runs = {"run_nve": [], "trajectory": []}  # (end, frames) of every run, in order
    want = {k_: MD_STEPS for k_ in
            ("angular_aev", "angular_aev_bwd", "bucket_select_fwd", "bucket_select_bwd")}
    for name in ("run_nve", "trajectory", "trajectory", "run_nve"):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if name == "run_nve":
            runs[name].append((traj_md.run_nve(traj_start, MD_STEPS), None))
        else:
            runs[name].append(traj_md.trajectory(traj_start, MD_STEPS, record_every=TRAJ_EVERY))
        torch.cuda.synchronize()
        traj_ms[name].append((time.perf_counter() - t0) * 1e3 / MD_STEPS)
        counts = read_counts()
        check(counts == {k_: want.get(k_, 0) for k_ in kernels_fn} and angular_grid.calls == 0,
              f"{name}: K1, K2, K3 and K3b {MD_STEPS} times each")
        if name == "trajectory":
            tools["trajectory_nve"] = counts
    frames = MD_STEPS // TRAJ_EVERY
    # what the recording can alter, held where the kernels' summation order
    # cannot hide it: the first frame against `run_nve` over as many steps
    first = traj_md.run_nve(traj_start, TRAJ_EVERY)
    dx_first = []
    for end, rec in runs["trajectory"]:
        check(tuple(rec["coords"].shape) == (frames, num_atoms, 3)
              and all(bool(torch.isfinite(t).all()) for t in rec.values()),
              f"trajectory: {frames} finite frames")
        check(torch.equal(rec["coords"][-1], end.coords), "the last frame is the final state")
        dx_first.append(float((rec["coords"][0] - first.coords).abs().max()))
    check(max(dx_first) <= MD_COORD_ATOL,
          f"trajectory's first frame is where run_nve is after {TRAJ_EVERY} steps")

    def spread(a, b):
        return float((a[0].coords - b[0].coords).abs().max())

    # measurements, not checks: after MD_STEPS steps the two paths differ by
    # what K2's cluster sums and K3b's shared-memory atomics add in another
    # order, grown by the random-weight dynamics; so do two runs of one path
    dx_runs = [spread(t_, n_) for t_, n_ in zip(runs["trajectory"], runs["run_nve"])]
    dx_nve = spread(*runs["run_nve"])
    dx_traj = spread(*runs["trajectory"])
    traj_end, nve_traj = runs["trajectory"][0]
    print(f"{card}: trajectory NVE {MD_STEPS} steps, a frame every {TRAJ_EVERY}: "
          f"{traj_ms['trajectory']} ms/step against run_nve's {traj_ms['run_nve']} (alternating, "
          f"host clock to a synchronize); first frame against run_nve({TRAJ_EVERY}) max |dx| "
          f"{dx_first} A; after {MD_STEPS} steps, trajectory against run_nve max |dx| {dx_runs} A, "
          f"run_nve against run_nve {dx_nve:.3e} A, trajectory against trajectory {dx_traj:.3e} A "
          f"(the run-to-run spread of the atomics); launches {tools['trajectory_nve']}; "
          f"temperatures {nve_traj['temperatures'].tolist()}")
    del runs, first
    for name, ensemble, kw, params in (
        ("nvt_nhc", "nvt-nhc", {}, dict(temperature=300.0, tau_fs=NHC_TAU_FS)),
        ("npt", "npt", dict(npt_compression=NPT_COMPRESSION),
         dict(temperature=300.0, pressure_bar=1.0)),
    ):
        runner = MolecularDynamics(model, species, cell=cell, pbc=True, **kw)
        start = runner.init(coords, temperature=300.0, generator=gen0())
        end_run = (runner.run_nvt_nose_hoover(start, THERMO_STEPS, **params) if name == "nvt_nhc"
                   else runner.run_npt_berendsen(start, THERMO_STEPS, **params))
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        end, traj = runner.trajectory(start, THERMO_STEPS, record_every=THERMO_EVERY,
                                      ensemble=ensemble, **params)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / THERMO_STEPS
        tools[f"trajectory_{name}"] = read_counts()
        want = {k_: THERMO_STEPS for k_ in
                ("angular_aev", "angular_aev_bwd", "bucket_select_fwd", "bucket_select_bwd")}
        check(tools[f"trajectory_{name}"] == {k_: want.get(k_, 0) for k_ in kernels_fn},
              f"trajectory {ensemble}: K1, K2, K3 and K3b once a step")
        dx = float((end.coords - end_run.coords).abs().max())
        check(dx <= MD_COORD_ATOL, f"trajectory {ensemble} ends where its run ends")
        check(tuple(traj["coords"].shape) == (THERMO_STEPS // THERMO_EVERY, num_atoms, 3)
              and (("scales" in traj) == (name == "npt")), f"trajectory {ensemble} frames")
        extra = f", scales {traj['scales'].tolist()}" if name == "npt" else ""
        print(f"{card}: trajectory {ensemble} {THERMO_STEPS} steps, a frame every {THERMO_EVERY}: "
              f"{ms:.3f} ms/step; against its run max |dx| {dx:.3e} A; launches "
              f"{tools[f'trajectory_{name}']}{extra}")
        del runner, start, end_run, end, traj

    # ---- 24. b: observables on the NVE frames ----
    frames_card = nve_traj["coords"]
    frames_cpu = frames_card.cpu()
    o_idx = torch.nonzero(species[0] == 8).reshape(-1)
    held = held_gib()
    t0 = time.perf_counter()
    rdf_peak = peak_gib(lambda: radial_distribution(frames_card, cell, RDF_RMAX, RDF_BINS,
                                                    species=species[0], pair=(8, 8)))
    r_c, g_card = radial_distribution(frames_card, cell, RDF_RMAX, RDF_BINS,
                                      species=species[0], pair=(8, 8))
    torch.cuda.synchronize()
    rdf_ms = (time.perf_counter() - t0) * 1e3 / 2
    t0 = time.perf_counter()
    _, g_cpu = radial_distribution(frames_cpu, cell_np, RDF_RMAX, RDF_BINS,
                                   species=species_np[0], pair=(8, 8))
    rdf_cpu_s = time.perf_counter() - t0
    # per-bin pair counts, card against CPU: equal but for pairs within
    # RDF_EDGE_TOL of a bin edge (float64 distances, on the card)
    n_o = o_idx.numel()
    ideal = (4.0 * np.pi * r_c**2 * (RDF_RMAX / RDF_BINS) * (n_o / float(np.linalg.det(cell_np)))
             * n_o)
    counts_card = np.rint(g_card * ideal * frames).astype(np.int64)
    counts_cpu = np.rint(g_cpu * ideal * frames).astype(np.int64)
    near_edge = np.zeros(RDF_BINS + 2, np.int64)
    cell64 = cell.double()
    inv64 = torch.linalg.inv(cell64)
    for fr in frames_card.double():
        cols = fr.index_select(0, o_idx)
        for start in range(0, n_o, 64):
            rows_idx = o_idx[start:start + 64]
            d = torch.sqrt(_min_image_dist2(fr.index_select(0, rows_idx), cols, cell64, inv64))
            d = d[rows_idx[:, None] != o_idx[None, :]]
            scaled = d / RDF_RMAX * RDF_BINS
            near = (scaled - torch.round(scaled)).abs() * (RDF_RMAX / RDF_BINS) < RDF_EDGE_TOL
            near_edge += np.bincount(torch.round(scaled[near]).long().cpu().numpy(),
                                     minlength=RDF_BINS + 2)[:RDF_BINS + 2]
    off = np.flatnonzero(counts_card != counts_cpu)
    check(all(abs(int(counts_card[k]) - int(counts_cpu[k])) <= near_edge[k] + near_edge[k + 1]
              for k in off), "O-O RDF: card counts equal the CPU's but for pairs at a bin edge")
    check(int(counts_card.sum()) > 0 and bool(np.isfinite(g_card).all()), "RDF counted pairs")
    msd = mean_squared_displacement(frames_card)
    diff_coef = diffusion_coefficient(frames_card, float(TRAJ_EVERY))
    check(msd.shape == (frames,) and msd[0] == 0.0 and bool(np.isfinite(msd).all()),
          "MSD finite, (F,)")
    print(f"{card}: O-O RDF of {frames} frames ({n_o} O, r_max {RDF_RMAX} A, {RDF_BINS} bins): "
          f"{rdf_ms:.3f} ms, peak device memory {rdf_peak:.3f} GiB ({held:.3f} held before); "
          f"first peak g = {float(g_card.max()):.3f} at {float(r_c[int(np.argmax(g_card))]):.3f} A; "
          f"CPU {rdf_cpu_s:.1f} s; bins that differ from the CPU's {off.tolist()} "
          f"(pairs at a bin edge: {int(near_edge.sum())}); MSD {msd.tolist()} A^2; "
          f"D {diff_coef:.4e} A^2/fs")
    del frames_card, frames_cpu, nve_traj, traj_end

    # ---- 25. c: FIRE on the 90-atom cluster ----
    def iteration_syncs(run):
        """Host syncs an iteration of ``run(n)`` (n iterations): a run of
        FIRE_ITERS less a run of none, over FIRE_ITERS."""
        base = count_syncs(lambda: run(0))[1]
        return (count_syncs(lambda: run(FIRE_ITERS))[1] - base) / FIRE_ITERS

    def linear(c):
        """An energy that makes no host sync and never converges."""
        return 0.01 * torch.sum(c, dim=(-2, -1))

    cl_t = torch.as_tensor(cl_sp, device=dev)
    e_one = lambda c: torch.sum(h_model(cl_t, c[None]))  # noqa: E731
    x_one = torch.as_tensor(cl_co[0], device=dev)
    batch_co = torch.as_tensor(
        cl_co + FIRE_SIGMA * np.random.RandomState(5).randn(FIRE_CONFS, cl_atoms, 3),
        dtype=torch.float32, device=dev)
    batch_sp = torch.as_tensor(np.repeat(cl_sp, FIRE_CONFS, axis=0), device=dev)
    e_batch = lambda c: h_model(batch_sp, c)  # noqa: E731
    fire_runs = {
        "fire": (minimize_fire, e_one, x_one),
        "fire_batched": (minimize_fire_batched, e_batch, batch_co),
    }
    for name, (minimizer, energy_fn, x) in fire_runs.items():
        def run(n, minimizer=minimizer, energy_fn=energy_fn, x=x):
            return minimizer(energy_fn, x, max_steps=n, fmax=1e-12)

        fn = lambda run=run: run(FIRE_ITERS)  # noqa: E731
        reset_counts()
        st = fn()
        torch.cuda.synchronize()
        tools[name] = read_counts()
        want = {"angular_aev": FIRE_ITERS + 1, "angular_aev_bwd": FIRE_ITERS + 1}
        check(tools[name] == {k_: want.get(k_, 0) for k_ in kernels_fn} and st.step == FIRE_ITERS,
              f"{name}: K3 and K3b once an evaluation ({FIRE_ITERS + 1}), nothing else")
        check(bool(torch.isfinite(st.coords).all()) and st.dt.dtype == torch.float32
              and st.dt.device.type == "cuda", f"{name}: finite, f32 schedule on the card")
        ms = float(np.median(wall_times_ms(fn, reps=3))) / FIRE_ITERS
        syncs = iteration_syncs(run)
        eval_syncs = count_syncs(lambda e=energy_fn, x=x: _fire_forces(e, x))[1]
        own = iteration_syncs(
            lambda n, minimizer=minimizer, x=x: minimizer(linear, x, max_steps=n, fmax=1e-12))
        check(own == 1.0, f"{name}: one host sync an iteration of its own (the loop's condition)")
        print(f"{card}: {name} ({FIRE_CONFS if name == 'fire_batched' else 1} x {cl_atoms} atoms): "
              f"{ms:.3f} ms per iteration (median of 3 runs of {FIRE_ITERS}); {syncs:.2f} host "
              f"syncs an iteration: the energy evaluation's {eval_syncs} and FIRE's own {own:.2f} "
              f"(under an energy that makes none); fmax {float(st.fmax.max()):.4e}")
    cpu_model = ANI2x(pretrained=False, seed=0, device="cpu")
    ends = {}
    for where, m in (("cuda", h_model), ("cpu", cpu_model)):
        sp_w = torch.as_tensor(cl_sp, device=where)
        ends[where] = minimize_fire(lambda c, m=m, sp_w=sp_w: torch.sum(m(sp_w, c[None])),
                                    torch.as_tensor(cl_co[0], device=where), max_steps=10,
                                    fmax=1e-12)
    dx = float((ends["cuda"].coords.cpu() - ends["cpu"].coords).abs().max())
    same = (float(ends["cuda"].dt) == float(ends["cpu"].dt)
            and int(ends["cuda"].n_pos) == int(ends["cpu"].n_pos))
    print(f"FIRE card vs CPU, {cl_atoms} atoms, 10 iterations: max |dx| {dx:.3e} A, the same "
          f"schedule {same}")
    check(dx <= MD_COORD_ATOL and same, "FIRE agrees with the CPU")

    # ---- 26. d: NEB between the cluster and a perturbation of it ----
    far = cl_co[0] + FIRE_SIGMA * 4 * np.random.RandomState(6).randn(cl_atoms, 3)
    t_img = np.linspace(0.0, 1.0, NEB_IMAGES)[:, None, None]
    band = ((1 - t_img) * cl_co[0] + t_img * far).astype(np.float32)
    band_sp = torch.as_tensor(np.repeat(cl_sp, NEB_IMAGES, axis=0), device=dev)
    band_t = torch.as_tensor(band, device=dev)
    neb_fn = lambda: neb_path(lambda x: h_model(band_sp, x), band_t,  # noqa: E731
                              max_steps=FIRE_ITERS, fmax=1e-12)
    reset_counts()
    nst = neb_fn()
    torch.cuda.synchronize()
    tools["neb"] = read_counts()
    want = {"angular_aev": FIRE_ITERS + 1, "angular_aev_bwd": FIRE_ITERS + 1}
    check(tools["neb"] == {k_: want.get(k_, 0) for k_ in kernels_fn} and nst.step == FIRE_ITERS,
          f"NEB: K3 and K3b once an evaluation ({FIRE_ITERS + 1}), nothing else")
    check(torch.equal(nst.images[0], band_t[0]) and torch.equal(nst.images[-1], band_t[-1]),
          "NEB endpoints fixed to the bit")
    check(bool(torch.isfinite(nst.images).all()), "NEB band finite")
    neb_ms = float(np.median(wall_times_ms(neb_fn, reps=3))) / FIRE_ITERS
    neb_syncs = iteration_syncs(
        lambda n: neb_path(lambda x: h_model(band_sp, x), band_t, max_steps=n, fmax=1e-12))
    neb_own = iteration_syncs(lambda n: neb_path(linear, band_t, max_steps=n, fmax=1e-12))
    check(neb_own == 1.0, "NEB: one host sync an iteration of its own (the loop's condition)")
    print(f"{card}: NEB {NEB_IMAGES} images x {cl_atoms} atoms: {neb_ms:.3f} ms per iteration "
          f"(median of 3 runs of {FIRE_ITERS}); {neb_syncs:.2f} host syncs an iteration, "
          f"{neb_own:.2f} of them NEB's own; climbing image "
          f"{int(torch.argmax(nst.energies[1:-1])) + 1}, fmax {float(nst.fmax):.4e}")
    del nst, band_t

    # ---- 27. e: replica exchange of the cluster ----
    ladder = [280.0 * (420.0 / 280.0) ** (i / (REPLICAS - 1)) for i in range(REPLICAS)]
    rex = ReplicaExchange(h_model, cl_sp, ladder)
    reset_counts()
    rex_start = rex.init(cl_co[0], generator=torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rst = rex.run(rex_start, REX_SEGMENTS, REX_STEPS)
    torch.cuda.synchronize()
    rex_ms = (time.perf_counter() - t0) * 1e3 / (REX_SEGMENTS * REX_STEPS)
    tools["replica"] = read_counts()
    steps = REX_SEGMENTS * REX_STEPS
    want = {"angular_aev": steps + 1, "angular_aev_bwd": steps + 1}
    check(tools["replica"] == {k_: want.get(k_, 0) for k_ in kernels_fn},
          f"replica: K3 and K3b once a step and once in init ({steps + 1}), nothing else")
    check(bool(torch.isfinite(rst.coords).all()) and rst.step == steps, "replica run finite")
    _, rex_syncs = count_syncs(lambda: rex.run(rex_start, 1, REX_STEPS))

    class LinearModel(torch.nn.Module):
        """A stand-in model that makes no host sync."""

        device = dev

        def forward(self, species, coords, cell=None, pbc=None):
            return linear(coords)

    lin_rex = ReplicaExchange(LinearModel(), cl_sp, ladder)
    lin_start = lin_rex.init(cl_co[0], generator=torch.Generator().manual_seed(0))
    _, rex_own = count_syncs(lambda: lin_rex.acceptance_rate(lin_rex.run(lin_start, 2, REX_STEPS)))
    check(rex_own == 1, "replica exchange: no host sync of its own but acceptance_rate's one")
    rate = rex.acceptance_rate(rst)
    print(f"{card}: replica exchange {REPLICAS} x {cl_atoms} atoms, {ladder[0]:.0f}-{ladder[-1]:.0f} "
          f"K: {rex_ms:.3f} ms per step ({REX_SEGMENTS} segments of {REX_STEPS}); acceptance "
          f"{rate:.3f} ({int(rst.swaps_accepted)} of {int(rst.swaps_attempted)}); {rex_syncs} host "
          f"syncs in a segment of {REX_STEPS} steps and a sweep, all of them the model's (under a "
          f"model that makes none, 2 segments and acceptance_rate make {rex_own})")
    sides = {}
    for where, m in (("cuda", h_model), ("cpu", cpu_model)):
        r_w = ReplicaExchange(m, cl_sp, ladder, device=where)
        st_w = r_w.init(cl_co[0], generator=torch.Generator().manual_seed(0))
        sides[where] = r_w.run(st_w, 1, REX_STEPS)
    dx = float((sides["cuda"].coords.cpu() - sides["cpu"].coords).abs().max())
    same = int(sides["cuda"].swaps_accepted) == int(sides["cpu"].swaps_accepted)
    print(f"replica card vs CPU, one segment: max |dx| {dx:.3e} A, accepted "
          f"{int(sides['cuda'].swaps_accepted)} and {int(sides['cpu'].swaps_accepted)}")
    check(dx <= MD_COORD_ATOL and same, "replica exchange agrees with the CPU")
    flat = ReplicaExchange(h_model, cl_sp, [300.0] * REPLICAS)
    fst = flat.run(flat.init(cl_co[0], generator=torch.Generator().manual_seed(1)), 2, 1)
    check(flat.acceptance_rate(fst) == 1.0, "a ladder of equal temperatures accepts every swap")
    del rex, rex_start, rst, sides, flat, fst

    # ---- 28. f: the command line in process ----
    with tempfile.TemporaryDirectory() as tmp:
        box_xyz, out_json = f"{tmp}/box.xyz", f"{tmp}/sp.json"
        write_xyz(species_np, coords_np, box_xyz, cell=cell_np)
        conf = (cl_co + FIRE_SIGMA * np.random.RandomState(7).randn(4, cl_atoms, 3)).astype(np.float32)
        write_xyz(np.repeat(cl_sp, 4, axis=0), conf, f"{tmp}/confs.xyz")
        commands = {
            "cli_sp": ["sp", box_xyz, "-f", "--compact", "-o", out_json],
            "cli_md": ["md", box_xyz, "--nvt-nhc", "-n", "20", "--traj", f"{tmp}/traj.xyz",
                       "--record-every", "5"],
            "cli_opt": ["opt", f"{tmp}/confs.xyz", "-n", "10", "--fmax", "1e-12", "-o",
                        f"{tmp}/opt.xyz"],
        }
        cli_ms, printed = {}, {}
        for name, argv in commands.items():
            reset_counts()
            text = io_mod.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(text):
                cli.main(argv)
            torch.cuda.synchronize()
            cli_ms[name] = (time.perf_counter() - t0) * 1e3
            tools[name] = read_counts()
            printed[name] = text.getvalue()
        want = {
            "cli_sp": {"angular_aev": 1, "angular_aev_bwd": 1},
            # init's E+F and 20 steps; one more K1 at init, where
            # `MolecularDynamics` refreshes the table to count angular
            # neighbors for the count-class split (from 2,048 atoms, as the
            # JAX package's does)
            "cli_md": {"angular_aev": 21, "angular_aev_bwd": 21, "bucket_select_bwd": 21,
                       "bucket_select_fwd": 21 + (num_atoms >= 2048)},
            "cli_opt": {"angular_aev": 11, "angular_aev_bwd": 11},
        }
        for name, w in want.items():
            check(tools[name] == {k_: w.get(k_, 0) for k_ in kernels_fn},
                  f"{name}: launches {w}")
        with open(out_json) as f:
            sp_out = json.load(f)
        sp_f = np.asarray(sp_out["forces"])
        check(sp_f.shape == (1, num_atoms, 3) and bool(np.isfinite(sp_f).all()),
              "cli sp: finite forces of the box")
        check(float(np.abs(sp_f[0] - forces[0].cpu().numpy()).max()) <= FORCE_ATOL,
              "cli sp forces equal the E+F path's")
        _, t_co, t_cell, _ = read_xyz(f"{tmp}/traj.xyz")
        check(t_co.shape == (4, num_atoms, 3) and bool(np.isfinite(t_co).all())
              and "wrote 4 frames" in printed["cli_md"], "cli md: 4 frames read back")
        o_sp, o_co, _, _ = read_xyz(f"{tmp}/opt.xyz")
        check(o_co.shape == (4, cl_atoms, 3) and printed["cli_opt"].count("converged=") == 4,
              "cli opt: 4 relaxed conformers")
    print(f"{card}: cli (in process, model built each time): sp {cli_ms['cli_sp']:.0f} ms, md "
          f"{cli_ms['cli_md']:.0f} ms, opt {cli_ms['cli_opt']:.0f} ms; launches "
          f"{ {k_: tools[k_] for k_ in commands} }")
    print(f"new phases (trajectory to CLI): {time.perf_counter() - t_phases:.1f} s of wall time")

    # ---- 29. g: K3, K3b and K3bb at Z = 48 (SnnANI2xr's tables on the box) ----
    t_zoo = time.perf_counter()
    zoo = {}  # launches of each new path
    snn = SnnANI2xr(pretrained=False, seed=0)
    snn.neighborlist = CellList(capacity=96)
    z_aevc = snn.aev_computer
    z_elem = snn._convert(species)
    _, z_ang, z_over = z_aevc.flat_tables(
        z_elem, snn.neighborlist(snn.cutoff, z_elem, coords, cell, pbc))
    check(not bool(z_over), "SnnANI2xr's water-box tables do not overflow")
    z_in = z_aevc.angular_inputs(z_elem.reshape(-1), z_ang)
    z_kw = z_aevc.kernel_kwargs()
    z_sh, z_se = len(z_kw["shifts"]), len(z_kw["sections"])
    z_n, z_ka = z_in[0].shape
    z_species = lane_species(z_in[2], z_in[3])
    z_pairs_n = z_kw["num_species"] * (z_kw["num_species"] + 1) // 2
    # K3's shared memory a block (csrc/angular_aev.cu:fwd_warp_floats): 4 warps of
    # the (P, Z) sums, a (32, (sh + se) | 1) tile, 32 slots and 6 lane planes
    z_k3_smem = 4 * 4 * (z_pairs_n * z_sh * z_se + 32 * ((z_sh + z_se) | 1) + 32 + 6 * z_ka)
    print(f"K3 at Z = 48: N={z_n}, Ka={z_ka}, S={z_kw['num_species']}, Z={z_sh * z_se} "
          f"({z_sh} shifts x {z_se} sections, {snn.cutoff} A, {z_kw['cutoff_kind']} cutoff); "
          f"{-(-z_n // 4)} blocks of 128 threads, {z_k3_smem} bytes of shared memory a block")
    z_out = angular_aev(*z_in, **z_kw)
    torch.cuda.synchronize()
    z_k3_err = kernel_errors(z_out, angular_aev_reference(*z_in, **z_kw),
                             "K3 SnnANI2xr water box (Z = 48) vs plain")
    z_block = z_aevc._atom_block(z_ka)
    z_gen = torch.Generator(dev).manual_seed(17)
    z_g = torch.randn((z_n, z_out.shape[1] + 112), device=dev, generator=z_gen)[:, 112:]
    z_k3b_shape = k3b_launch_shape("K3b at Z = 48", z_in, z_kw)
    z_k3b_err = bwd_errors(
        angular_aev_bwd(z_g, *z_in, z_species, **z_kw),
        angular_aev_bwd_reference(z_g, *z_in, atom_block=z_block, **z_kw),
        z_in[2], "K3b SnnANI2xr water box (Z = 48) vs plain")
    z_u = (torch.randn(z_in[0].shape, device=dev, generator=z_gen),
           torch.randn(z_in[1].shape, device=dev, generator=z_gen))
    z_bb_block = max(1, z_block // 4)
    z_k3bb_shape = k3b_launch_shape("K3bb at Z = 48", z_in, z_kw, second_order=True)
    z_k3bb_err = bwd_bwd_errors(
        angular_aev_bwd_bwd(z_g, *z_in, *z_u, z_species, **z_kw),
        angular_aev_bwd_bwd_reference(z_g, *z_in, *z_u, atom_block=z_bb_block, **z_kw),
        z_in[2], "K3bb SnnANI2xr water box (Z = 48) vs plain")
    z_lanes = z_in[2].sum(1).to(torch.float64)
    z_pairs = float((z_lanes * (z_lanes - 1) / 2).sum())
    z_valid = float(z_lanes.sum())
    z_lane_bytes = sum(t.numel() * t.element_size() for t in (z_in[0], z_in[1], z_species))
    z_k3b_bytes = k3b_bytes(z_in, z_species, z_kw["num_species"], z_sh * z_se)
    z48 = {
        "K3": dict(
            err=z_k3_err,
            ms=both_ms(lambda: angular_aev(*z_in, species=z_species, **z_kw)),
            plain=kernels_ms(lambda: angular_aev_reference(*z_in, **z_kw), reps=3),
            bound=angular_bound_ms(z_pairs, z_valid, z_sh, z_se,
                                   z_lane_bytes + z_out.numel() * 4, False),
            smem=z_k3_smem,
        ),
        "K3b": dict(
            err=z_k3b_err,
            ms=both_ms(lambda: angular_aev_bwd(z_g, *z_in, z_species, **z_kw)),
            plain=kernels_ms(lambda: angular_aev_bwd_reference(
                z_g, *z_in, atom_block=z_block, **z_kw), reps=3),
            bound=angular_bound_ms(z_pairs, z_valid, z_sh, z_se, z_k3b_bytes, True),
            smem=z_k3b_shape["smem_bytes"], grid=z_k3b_shape,
        ),
        "K3bb": dict(
            err=z_k3bb_err,
            ms=both_ms(lambda: angular_aev_bwd_bwd(z_g, *z_in, *z_u, z_species, **z_kw)),
            plain=kernels_ms(lambda: angular_aev_bwd_bwd_reference(
                z_g, *z_in, *z_u, atom_block=z_bb_block, **z_kw), reps=1),
            bound=k3bb_bound_ms(z_pairs, z_valid, z_sh, z_se, z_k3b_bytes
                                + sum(t.numel() * 4 for t in z_u) + z_out.numel() * 4),
            smem=z_k3bb_shape["smem_bytes"], grid=z_k3bb_shape,
        ),
    }
    for name, r in z48.items():
        print(f"{card}: {name} at Z = 48 alone: {r['ms'][0]:.4f} ms ({r['ms'][1]:.4f} between "
              f"events); plain version {r['plain']:.3f} ms; {z_pairs:.0f} valid pairs; bound "
              f"{r['bound'][0]:.4f} ms by {r['bound'][1]} ({r['bound'][2] / 1e6:.1f} MB; by "
              f"operations {r['bound'][3]:.4f} ms f32, {r['bound'][4]:.4f} ms special "
              f"functions); {r['smem']} bytes of shared memory a block")
    del z_in, z_ang, z_out, z_g, z_u, z_species, z_elem

    # ---- 30. h: ANI-mbis single point on the water box ----
    mbis = ANImbis(pretrained=False, seed=0)
    mbis.neighborlist = CellList(capacity=96)
    charge_calls = []
    mbis.potentials["nnp"].charge_networks.register_forward_hook(
        lambda *_: charge_calls.append(1))
    reset_counts()
    mb_e, mb_f = energies_and_forces(mbis, species, coords, cell, pbc)
    torch.cuda.synchronize()
    zoo["animbis_ef"] = read_counts()
    check(zoo["animbis_ef"] == {k_: int(k_ in ("angular_aev", "angular_aev_bwd"))
                                for k_ in kernels_fn} and not charge_calls,
          "ANI-mbis E+F: K3 and K3b once, the charge networks never")
    check(bool(torch.isfinite(mb_e).all()) and bool(torch.isfinite(mb_f).all())
          and tuple(mb_f.shape) == (1, num_atoms, 3), "ANI-mbis E+F finite, forces (1, A, 3)")
    d_2x = float((mb_f - forces).abs().max())
    print(f"ANI-mbis E+F: E = {float(mb_e[0]):.6f} Ha; max |dF| against ANI-2x's E+F (the same "
          f"energy networks) {d_2x:.3e} Ha/A")
    check(d_2x <= FORCE_ATOL, "ANI-mbis forces equal ANI-2x's of the same seed")
    reset_counts()
    with torch.no_grad():
        mb_q = {q: mbis.energies_and_charges(species, coords, cell, pbc, charge=q) for q in (0, 1)}
    torch.cuda.synchronize()
    zoo["animbis_charges"] = read_counts()
    check(zoo["animbis_charges"] == {k_: 2 * int(k_ == "angular_aev") for k_ in kernels_fn}
          and len(charge_calls) == 2,
          "energies_and_charges: one K3 launch and one run of the charge networks each")
    for q, r in mb_q.items():
        qs = r.scalars
        total = float(qs.double().sum())
        # the worst-case rounding of a pairwise f32 sum of N terms
        tol = CHARGE_SUM_ATOL + 2 * np.log2(num_atoms) * F32_EPS * float(qs.abs().sum())
        print(f"ANI-mbis charges at total charge {q}: sum {total:.6e} e (tolerance {tol:.2e}), "
              f"range {float(qs.min()):.4f} to {float(qs.max()):.4f} e")
        check(bool(torch.isfinite(qs).all()) and abs(total - q) <= tol,
              f"ANI-mbis charges finite, summing to {q}")
        check(float((r.energies - mb_e).abs().max()) <= 1e-6 * abs(float(mb_e[0])),
              "energies_and_charges gives the E+F path's energies")
    qs0 = mb_q[0].scalars
    dip = compute_dipole(species, coords, qs0)
    masses_by_z = [0.0 if np.isnan(m_) else m_ for m_ in MASS]
    dip_c = DipoleComputer(masses=masses_by_z)(species, coords, qs0)
    d_dip = float((dip - dip_c).abs().max() / dip.abs().max())
    print(f"ANI-mbis dipole of the box (center of mass): {dip[0].tolist()} e A; DipoleComputer "
          f"with the mass table, relative difference {d_dip:.3e}")
    check(tuple(dip.shape) == (1, 3) and bool(torch.isfinite(dip).all()) and d_dip <= 1e-5,
          "compute_dipole and DipoleComputer agree")
    mb_cpu = {}
    for where in ("cuda", "cpu"):
        m = ANImbis(pretrained=False, seed=0, device=where)
        m.neighborlist = CellList()
        e_, f_ = energies_and_forces(m, sp_s, co_s, cell_s, pbc_np)
        with torch.no_grad():
            q_ = m.atomic_charges(sp_s, co_s, cell_s, pbc_np, charge=1)
        mb_cpu[where] = (f_.cpu(), q_.cpu())
    df = float((mb_cpu["cuda"][0] - mb_cpu["cpu"][0]).abs().max())
    dq = float((mb_cpu["cuda"][1] - mb_cpu["cpu"][1]).abs().max())
    print(f"ANI-mbis card vs CPU, {sp_s.shape[1]} atoms: max |dF| {df:.3e} Ha/A, max |dq| "
          f"{dq:.3e} e (total charge 1)")
    check(df <= FORCE_ATOL and dq <= CHARGE_ATOL, "ANI-mbis forces and charges agree with the CPU")
    zoo_ms = {
        "ani2x_ef": wall_times_ms(lambda: energies_and_forces(model, species, coords, cell, pbc),
                                  reps=10),
        "animbis_ef": wall_times_ms(lambda: energies_and_forces(mbis, species, coords, cell, pbc),
                                    reps=10),
    }
    with torch.no_grad():
        zoo_ms["animbis_charges"] = wall_times_ms(
            lambda: mbis.energies_and_charges(species, coords, cell, pbc), reps=10)
    print(f"{card}: {num_atoms} atoms, median of 10 (host clock to a synchronize): ANI-2x E+F "
          f"{np.median(zoo_ms['ani2x_ef']):.3f} ms, ANI-mbis E+F "
          f"{np.median(zoo_ms['animbis_ef']):.3f} ms, ANI-mbis energies_and_charges "
          f"{np.median(zoo_ms['animbis_charges']):.3f} ms")
    del mb_q, qs0, mb_cpu

    # ---- 31. i: ANI-mbis MD from the start of the ANI-2x MD phase ----
    mb_md = MolecularDynamics(mbis, species, cell=cell, pbc=True)
    mb_start = mb_md.init(coords, temperature=300.0, generator=torch.Generator().manual_seed(0))
    check(torch.equal(mb_start.velocities, md_start.velocities),
          "ANI-mbis MD starts from the ANI-2x MD phase's velocities")
    charge_calls.clear()
    reset_counts()
    mb_end = mb_md.run_nve(mb_start, DR_STEPS)
    torch.cuda.synchronize()
    zoo["animbis_md"] = read_counts()
    x2_md = MolecularDynamics(md_model, species, cell=cell, pbc=True)
    x2_end = x2_md.run_nve(
        x2_md.init(coords, temperature=300.0, generator=torch.Generator().manual_seed(0)),
        DR_STEPS)
    dx = float((mb_end.coords - x2_end.coords).abs().max())
    print(f"ANI-mbis MD, {DR_STEPS} NVE steps: launches {zoo['animbis_md']}, charge networks run "
          f"{len(charge_calls)} times; max |dx| against ANI-2x's {DR_STEPS} steps {dx:.3e} A")
    md_want = {k_: DR_STEPS if k_ in ("angular_aev", "angular_aev_bwd", "bucket_select_fwd",
                                      "bucket_select_bwd") else 0 for k_ in kernels_fn}
    check(zoo["animbis_md"] == md_want and not charge_calls,
          f"ANI-mbis MD: K1, K2, K3 and K3b {DR_STEPS} times each, the charge networks never")
    check(not bool(mb_end.overflow) and dx <= MD_COORD_ATOL,
          "ANI-mbis MD follows ANI-2x's trajectory")
    del mbis, mb_md, mb_start, mb_end, x2_md, x2_end

    # ---- 32. j: SnnANI2xr E+F on the water box ----
    reset_counts()
    held = held_gib()
    sn_e, sn_f = energies_and_forces(snn, species, coords, cell, pbc)
    torch.cuda.synchronize()
    zoo["snnani2xr_ef"] = read_counts()
    check(zoo["snnani2xr_ef"] == {k_: int(k_ in ("angular_aev", "angular_aev_bwd"))
                                  for k_ in kernels_fn}, "SnnANI2xr E+F: K3 and K3b once")
    check(bool(torch.isfinite(sn_e).all()) and bool(torch.isfinite(sn_f).all()),
          "SnnANI2xr E+F finite")
    sn_ms = wall_times_ms(lambda: energies_and_forces(snn, species, coords, cell, pbc), reps=10)
    sn_peak = peak_gib(lambda: energies_and_forces(snn, species, coords, cell, pbc))
    sn_cpu = {}
    for where in ("cuda", "cpu"):
        m = SnnANI2xr(pretrained=False, seed=0, device=where)
        m.neighborlist = CellList()
        sn_cpu[where] = energies_and_forces(m, sp_s, co_s, cell_s, pbc_np)[1].cpu()
    df = float((sn_cpu["cuda"] - sn_cpu["cpu"]).abs().max())
    print(f"{card}: SnnANI2xr E+F {num_atoms} atoms: median {np.median(sn_ms):.3f} ms over 10; "
          f"peak device memory {sn_peak:.3f} GiB ({held:.3f} held before); card vs CPU at "
          f"{sp_s.shape[1]} atoms max |dF| {df:.3e} Ha/A")
    check(df <= FORCE_ATOL, "SnnANI2xr forces agree with the CPU")
    del snn, sn_e, sn_f, sn_cpu

    # ---- 33. k: ANI-r2s in four solvents on the 90-atom cluster ----
    r2s_e = {}
    for solvent in ("water", "chcl3", "ch3cn", "vacuum"):
        outs_ = {}
        for where in ("cuda", "cpu"):
            m = ANIr2s(solvent, pretrained=False, seed=0, device=where)
            check(m.cutoff == float("inf"), "ANI-r2s: an infinite cutoff (all pairs)")
            reset_counts()
            outs_[where] = energies_and_forces(m, cl_sp, cl_co)
            if where == "cuda":
                torch.cuda.synchronize()
                zoo[f"anir2s_{solvent}_ef"] = read_counts()
        (e_k, f_k), (e_c, f_c) = outs_["cuda"], outs_["cpu"]
        df = float((f_k.cpu() - f_c).abs().max())
        de = abs(float(e_k[0]) - float(e_c[0]))
        r2s_e[solvent] = float(e_k[0])
        print(f"ANI-r2s ({solvent}), {cl_atoms} atoms: E = {r2s_e[solvent]:.6f} Ha, card vs CPU "
              f"|dE| {de:.3e} Ha, max |dF| {df:.3e} Ha/A; launches {zoo[f'anir2s_{solvent}_ef']}")
        check(zoo[f"anir2s_{solvent}_ef"] == {k_: int(k_ in ("angular_aev", "angular_aev_bwd"))
                                              for k_ in kernels_fn},
              f"ANI-r2s ({solvent}) E+F: K3 and K3b once")
        check(df <= FORCE_ATOL and de <= 1e-6 * abs(float(e_c[0])),
              f"ANI-r2s ({solvent}) agrees with the CPU")
    check(len(set(r2s_e.values())) == 4, "the four solvents give four energies")

    # ---- 34. l: the pair potentials alone, and their dimer curves ----
    mnok_eta = [HARDNESS[ATOMIC_NUMBER[s_]] / HARTREE_TO_EV for s_ in SYMBOLS_2X]  # Ha
    pair_pots = {
        "LennardJones": lambda cut, where: LennardJones(SYMBOLS_2X, cutoff=cut, device=where),
        "RepulsionLJ": lambda cut, where: RepulsionLJ(SYMBOLS_2X, cutoff=cut, device=where),
        "DispersionLJ": lambda cut, where: DispersionLJ(SYMBOLS_2X, cutoff=cut, device=where),
        "FixedCoulomb": lambda cut, where: FixedCoulomb(
            SYMBOLS_2X, WATER_CHARGES, cutoff=cut, device=where),
        "FixedMNOK": lambda cut, where: FixedMNOK(
            SYMBOLS_2X, WATER_CHARGES, mnok_eta, cutoff=cut, device=where),
    }
    systems = {"cluster": (cl_sp, cl_co, None, None, float("inf")),
               "box": (species_np, coords_np, cell_np, pbc_np, PAIR_CUTOFF)}
    pair_ms = {}
    for pname, make in pair_pots.items():
        for sname, (sp_, co_, cell_, pbc_, cut) in systems.items():
            res = {}
            for where in ("cuda", "cpu"):
                pot = make(cut, where)
                c_ = torch.as_tensor(co_, device=where).requires_grad_(True)
                args = (torch.as_tensor(sp_, device=where), c_,
                        None if cell_ is None else torch.as_tensor(cell_, device=where),
                        None if pbc_ is None else torch.as_tensor(pbc_, device=where))
                reset_counts()
                e_ = pot(*args)
                (g_,) = torch.autograd.grad(e_.sum(), c_)
                res[where] = (e_.detach().cpu(), -g_.cpu())
                if where == "cuda":
                    torch.cuda.synchronize()
                    check(all(v == 0 for v in read_counts().values()),
                          f"{pname} alone launches no hand kernel")

                    def pair_ef(pot=pot, args=args):
                        c2 = args[1].detach().requires_grad_(True)
                        torch.autograd.grad(pot(args[0], c2, *args[2:]).sum(), c2)

                    pair_ms[f"{pname}_{sname}"] = float(np.median(wall_times_ms(pair_ef, reps=5)))
            (e_k, f_k), (e_c, f_c) = res["cuda"], res["cpu"]
            print(f"{pname} on the {sname} (cutoff {cut} A): E = {float(e_k[0]):.6f} Ha, card vs "
                  f"CPU |dE| {float((e_k - e_c).abs().max()):.3e} Ha, max |dF| "
                  f"{float((f_k - f_c).abs().max()):.3e} Ha/A; "
                  f"{pair_ms[f'{pname}_{sname}']:.3f} ms E+F")
            check(within(e_k, e_c, PAIR_TOL) and within(f_k, f_c, PAIR_TOL),
                  f"{pname} on the {sname} agrees with the CPU")
    curves = {where: pair_curves(LennardJones(SYMBOLS_2X, cutoff=PAIR_CUTOFF, device=where),
                                 force=True)[1] for where in ("cuda", "cpu")}
    d_curve = max(float(np.max(np.abs(curves["cuda"][k_] - v) / (1 + np.abs(v))))
                  for k_, v in curves["cpu"].items())
    print(f"pair_curves(LennardJones, force=True), {len(curves['cpu'])} element pairs x 1000 "
          f"points: card vs CPU max |d| / (1 + |f|) {d_curve:.3e}")
    check(d_curve <= PAIR_TOL, "pair_curves agree with the CPU")

    # ---- 35. m: ANI-2x + Lennard-Jones (8 A) MD on the water box ----
    lj_asm = Assembler()
    lj_asm.set_symbols(SYMBOLS_2X)
    lj_asm.set_global_cutoff_fn("cosine")
    lj_asm.set_aev_computer(radial="ani2x", angular="ani2x")
    lj_asm.set_atomic_networks(ctor="ani2x")
    lj_asm.set_gsaes_as_self_energies("wb97x-631gd")
    tip3p_eps = [e_ / HARTREE_TO_KCALPERMOL for e_ in TIP3P_EPS_KCAL]
    lj_asm.add_potential("lj", lambda d: LennardJones(
        SYMBOLS_2X, eps=tip3p_eps, sigma=TIP3P_SIGMA, cutoff=PAIR_CUTOFF, device=d))
    lj_model = lj_asm.assemble(8, seed=0)
    lj_md = MolecularDynamics(lj_model, species, cell=cell, pbc=True)
    lj_start = lj_md.init(coords, temperature=300.0, generator=torch.Generator().manual_seed(0))
    print(f"ANI-2x + LJ MD: build radius {lj_md.build_radius:.2f} A, grid {lj_md.grid_shape}, "
          f"K={lj_md.capacity} lanes, lane prefixes {lj_md._lane_prefixes}, angular prefix "
          f"{lj_md._ang_prefix}")
    check("nnp" in lj_md._lane_prefixes and "lj" not in lj_md._lane_prefixes,
          "the networks run on a lane prefix, Lennard-Jones on every lane")
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lj_end = lj_md.run_nve(lj_start, DR_STEPS)
    torch.cuda.synchronize()
    lj_step_ms = (time.perf_counter() - t0) * 1e3 / DR_STEPS
    zoo["ani2x_lj_md"] = read_counts()
    check(zoo["ani2x_lj_md"] == md_want,
          f"ANI-2x + LJ MD: K1, K2, K3 and K3b {DR_STEPS} times each")
    check(not bool(lj_end.overflow) and bool(torch.isfinite(lj_end.forces).all()),
          "ANI-2x + LJ MD finite, no overflow")
    lj_e, lj_f = energies_and_forces(lj_model, species, lj_end.coords[None], cell, pbc)
    de = abs(float(lj_end.energy) - float(lj_e[0]))
    df = float((lj_end.forces - lj_f[0]).abs().max())
    print(f"{card}: ANI-2x + LJ MD, {DR_STEPS} NVE steps: {lj_step_ms:.3f} ms a step, "
          f"{lj_end.rebuilds} rebuilds; final state against its single point |dE| {de:.3e} Ha, "
          f"max |dF| {df:.3e} Ha/A; launches {zoo['ani2x_lj_md']}")
    check(de <= 1e-6 * abs(float(lj_e[0])) and df <= REBUILD_FORCE_ATOL,
          "ANI-2x + LJ MD energy and forces equal a single point of the final state")
    del lj_model, lj_md, lj_start, lj_end
    print(f"new phases (Z = 48 kernels to ANI-2x + LJ MD): {time.perf_counter() - t_zoo:.1f} s "
          f"of wall time")

    # ---- 36. n: element indices (periodic_table_index=False) ----
    t_slice = time.perf_counter()
    slice14 = {}  # launches of each path of this block
    ef_ms = {"ani2x": np.median(wall_times_ms(
        lambda: energies_and_forces(model, species, coords, cell, pbc), reps=5))}
    idx_model = ANI2x(pretrained=False, seed=0)
    idx_model.neighborlist = CellList(capacity=96)
    idx_model.periodic_table_index = False
    elem_box = model.species_converter(species)
    ef_want = {k_: 1 if k_ in ("angular_aev", "angular_aev_bwd") else 0 for k_ in kernels_fn}

    def ef_against_main(name, m, sp):
        """One E+F of ``m`` on the box: its launches, and its energies and
        forces against the main path's."""
        reset_counts()
        e_, f_ = energies_and_forces(m, sp, coords, cell, pbc)
        torch.cuda.synchronize()
        slice14[name] = read_counts()
        de_ = abs(float(e_[0]) - float(energies[0]))
        df_ = float((f_ - forces).abs().max())
        check(slice14[name] == ef_want and angular_grid.calls == 0,
              f"{name}: one E+F launches K3 and K3b once each, nothing else")
        check(de_ <= 1e-6 * abs(float(energies[0])) and df_ <= FORCE_ATOL,
              f"{name}: energies and forces equal the atomic-number model's")
        ef_ms[name] = np.median(wall_times_ms(lambda: energies_and_forces(m, sp, coords, cell, pbc),
                                              reps=5))
        return de_, df_

    de, df = ef_against_main("element_index_ef", idx_model, elem_box)
    print(f"element-index E+F: |dE| {de:.3e} Ha, max |dF| {df:.3e} Ha/A against the atomic-number "
          f"model; launches {slice14['element_index_ef']}")
    z_md = MolecularDynamics(md_model, species, cell=cell, pbc=True)
    z_start = z_md.init(coords, temperature=300.0, generator=torch.Generator().manual_seed(0))
    idx_md = MolecularDynamics(idx_model, elem_box, cell=cell, pbc=True)
    idx_start = idx_md.init(coords, temperature=300.0, generator=torch.Generator().manual_seed(0))
    check(torch.equal(idx_md.masses, z_md.masses)
          and torch.equal(idx_start.velocities, md_start.velocities)
          and torch.equal(z_start.velocities, md_start.velocities),
          "element-index MD: the masses and start of the ANI-2x MD phase")
    step_ms = {}
    for name, runner, start in (("ani2x_md", z_md, z_start),
                                ("element_index_md", idx_md, idx_start)):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        end = runner.run_nve(start, DR_STEPS)
        torch.cuda.synchronize()
        step_ms[name] = (time.perf_counter() - t0) * 1e3 / DR_STEPS
        slice14[name] = read_counts()
        check(slice14[name] == md_want and not bool(end.overflow),
              f"{name}: K1, K2, K3 and K3b {DR_STEPS} times each, no overflow")
        if name == "ani2x_md":
            z_end = end
    dx = float((end.coords - z_end.coords).abs().max())
    print(f"element-index MD, {DR_STEPS} NVE steps: max |dx| {dx:.3e} A against the atomic-number "
          f"run; launches {slice14['element_index_md']}")
    check(dx <= MD_COORD_ATOL, "element-index MD follows the atomic-number trajectory")
    h_idx = ANI2x(pretrained=False, seed=0)
    h_idx.periodic_table_index = False
    cl_elem = h_model.species_converter(torch.as_tensor(cl_sp, device=dev))
    vib = single_point(h_model, cl_sp, cl_co, vibrational=True)
    reset_counts()
    vib_i = single_point(h_idx, cl_elem, cl_co, vibrational=True)
    slice14["element_index_vibrational"] = read_counts()
    check(slice14["element_index_vibrational"] == vib_launches,
          "element-index single_point(vibrational=True): the atomic-number run's launches")
    dh = (vib_i["hessians"] - vib["hessians"]).abs()
    check(bool((dh <= HESSIAN_ATOL + HESSIAN_RTOL * vib["hessians"].abs()).all()),
          "element-index Hessian equals the atomic-number model's")
    dfreq = float((vib_i["freqs"] - vib["freqs"]).abs().max())
    check(torch.equal(get_atomic_masses(h_idx.atomic_numbers_of(cl_elem)),
                      get_atomic_masses(h_model.atomic_numbers_of(cl_sp))),
          "element-index masses come through the model's atomic numbers")
    print(f"element-index vibrational analysis, {cl_atoms} atoms: max |dH| {float(dh.max()):.3e} "
          f"Ha/A^2, max |d freq| {dfreq:.3e} cm^-1 against the atomic-number model's; launches "
          f"{slice14['element_index_vibrational']}")
    del idx_md, idx_start, z_md, z_start, end, z_end, vib_i, vib, h_idx

    # ---- 37. o: VerletCellList as the model's neighbor list ----
    v_model = ANI2x(pretrained=False, seed=0)
    v_model.neighborlist = VerletCellList(capacity=96)
    check(isinstance(parse_neighborlist("verlet_cell_list"), VerletCellList),
          "\"verlet_cell_list\" builds a VerletCellList")
    de, df = ef_against_main("verlet_cell_list_ef", v_model, species)
    print(f"VerletCellList E+F (skin {v_model.neighborlist.skin} A, a plain cell list on its own): "
          f"|dE| {de:.3e} Ha, max |dF| {df:.3e} Ha/A against CellList's; launches "
          f"{slice14['verlet_cell_list_ef']}")
    del v_model

    # ---- 38. p: species-blocked networks (nn.partition) ----
    p_model = ANI2x(pretrained=False, seed=0)
    p_model.neighborlist = CellList(capacity=96)
    caps = measure_caps([elem_box], p_model.neural_networks.num_species)
    p_model.neural_networks.partition = caps
    de, df = ef_against_main("partition_ef", p_model, species)
    syncs = {
        name: count_syncs(lambda m=m: energies_and_forces(m, species, coords, cell, pbc))[1]
        for name, m in (("default", model), ("partition", p_model))
    }
    counts_s = [int((elem_box == s_).sum()) for s_ in range(len(caps))]
    # the same budgets but 0 for the five species the box lacks: their
    # networks do not run
    p_model.neural_networks.partition = tuple(c_ if n_ else 0 for c_, n_ in zip(caps, counts_s))
    de0, df0 = ef_against_main("partition_present_ef", p_model, species)
    s_big = int(np.argmax(counts_s))
    p_model.neural_networks.partition = tuple(
        c_ - 1 if s_ == s_big else c_ for s_, c_ in enumerate(counts_s))
    e_bad = p_model(species, coords, cell, pbc)
    check(bool(torch.isnan(e_bad).all()), "a cap one row too small gives NaN energies")
    print(f"species-blocked E+F: caps {caps} for counts {counts_s}; |dE| {de:.3e} Ha, max |dF| "
          f"{df:.3e} Ha/A against the default container (caps of 0 for the absent species: "
          f"{de0:.3e} Ha, {df0:.3e} Ha/A); host syncs of one E+F {syncs} "
          f"(CUDA's sync debug mode); caps one row short of {counts_s[s_big]}: energies NaN; "
          f"launches {slice14['partition_ef']}")
    del p_model, e_bad

    # ---- 39. q: the count-class angular split in MD ----
    s_md = MolecularDynamics(md_model, species, cell=cell, pbc=True)
    s_start = s_md.init(coords, temperature=300.0, generator=torch.Generator().manual_seed(0))
    split = s_md.model.aev_computer.angular_split
    s_aevc = s_md.model.aev_computer
    s_cap = s_aevc._angular_capacity(s_md.capacity)
    with torch.no_grad():
        s_nb = _refresh_neighbors(s_start, s_start.coords)
        s_counts = np.minimum(
            (s_nb.mask & (s_nb.dist <= s_aevc.angular.cutoff)).sum(1).cpu().numpy(), s_cap)
    rule = choose_angular_split(s_counts, s_cap)
    check(split == (rule if num_atoms >= 2048 else None),
          "the MD split is the JAX package's rule on the measured counts")
    n_md = MolecularDynamics(md_model, species, cell=cell, pbc=True)
    n_start = n_md.init(coords, temperature=300.0, generator=torch.Generator().manual_seed(0))
    n_md.model.aev_computer.angular_split = None
    ends = {}
    for name, runner, start in (("split_md", s_md, s_start), ("no_split_md", n_md, n_start)):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ends[name] = runner.run_nve(start, DR_STEPS)
        torch.cuda.synchronize()
        step_ms[name] = (time.perf_counter() - t0) * 1e3 / DR_STEPS
        slice14[name] = read_counts()
        check(slice14[name] == md_want and not bool(ends[name].overflow),
              f"{name}: K1, K2, K3 and K3b {DR_STEPS} times each, no overflow")
    dx = float((ends["split_md"].coords - ends["no_split_md"].coords).abs().max())
    check(dx <= MD_COORD_ATOL, "the split changes nothing on the card: the no-split trajectory")
    print(f"angular split in MD ({num_atoms} atoms, capacity {s_cap}): picked "
          f"{split if split is not None else 'none'}, the JAX rule (from 2,048 atoms) "
          f"on the counts gives {rule} (counts: mean {float(s_counts.mean()):.2f}, max "
          f"{int(s_counts.max())}); on the card K3 runs over the whole table: {DR_STEPS} NVE "
          f"steps against the no-split run max |dx| {dx:.3e} A; launches {slice14['split_md']}")
    del s_md, s_start, n_md, n_start, ends, s_nb

    # ---- 40. r: user AEV terms and the new cutoffs on the 30-water cluster ----
    class GaussRadial(Radial):
        tensors = ["eta", "shifts"]

        def compute(self, d):
            return 0.25 * torch.exp(-self.eta * (d[..., None] - self.shifts) ** 2)

    class CosAngular(Angular):
        radial_tensors = ["eta", "shifts"]
        angles_tensors = ["zeta", "sections"]

        def compute_radial(self, a, b):
            return torch.exp(-self.eta * ((a + b)[..., None] / 2 - self.shifts) ** 2)

        def compute_cos_angles(self, c):
            theta = torch.arccos(0.95 * c)
            return 2 * ((1 + torch.cos(theta[..., None] - self.sections)) / 2) ** self.zeta

    def term_model(where, kind):
        asm = Assembler()
        asm.set_symbols(SYMBOLS_2X)
        if kind == "user":
            asm.set_global_cutoff_fn("cosine")
            asm.set_aev_computer(
                radial=lambda d: GaussRadial.make(
                    5.1, device=d, eta=19.7, shifts=[0.8 + 0.26875 * i for i in range(16)]),
                angular=lambda d: CosAngular.make(
                    3.5, device=d, eta=12.5, shifts=[0.8 + 0.3375 * i for i in range(8)],
                    zeta=14.1, sections=[np.pi / 8 + np.pi / 4 * i for i in range(4)]),
            )
        else:
            asm.set_global_cutoff_fn(kind)
            asm.set_aev_computer(radial="ani2x", angular="ani2x")
        asm.set_atomic_networks(ctor="ani2x")
        asm.set_gsaes_as_self_energies("wb97x-631gd")
        return asm.assemble(1, seed=0, device=where)

    for kind in ("user", "biweight"):
        outs_ = []  # the card's E+F, then the CPU's
        for where in ("cuda", "cpu"):
            m = term_model(where, kind)
            reset_counts()
            outs_.append(energies_and_forces(m, cl_sp, cl_co))
            if len(outs_) == 1:
                slice14[f"{kind}_terms_ef"] = read_counts()
                calls = angular_grid.calls
                m.aev_computer.strategy = "cuda"
                try:
                    energies_and_forces(m, cl_sp, cl_co)
                    raised = False
                except ValueError:
                    raised = True
        (e_card, f_card), (e_cpu, f_cpu) = outs_
        df = float((f_card.cpu() - f_cpu).abs().max())
        de = abs(float(e_card[0]) - float(e_cpu[0]))
        print(f"{kind} AEV terms, {cl_atoms}-atom cluster: card vs CPU |dE| {de:.3e} Ha, max |dF| "
              f"{df:.3e} Ha/A; under \"auto\" K3 and K3b launch "
              f"{slice14[f'{kind}_terms_ef']['angular_aev']} times and the plain grid runs {calls} "
              f"times (the JAX package routes these to its XLA path too); under \"cuda\" raises "
              f"{raised}")
        check(slice14[f"{kind}_terms_ef"] == {k_: 0 for k_ in kernels_fn} and calls > 0,
              f"{kind} terms: the plain path under \"auto\", no kernel")
        check(raised, f"{kind} terms: strategy \"cuda\" raises")
        check(df <= FORCE_ATOL and de <= 1e-6 * abs(float(e_cpu[0])),
              f"{kind} terms: the card agrees with the CPU")

    # the reference's neighbor helpers on the box's table, card against CPU
    box_nb = model.neighborlist(model.cutoff, elem, coords, cell, pbc)
    cpu_nb = box_nb.replace(**{f_: getattr(box_nb, f_).cpu()
                               for f_ in ("idx", "mask", "diff", "dist", "overflow")})
    helper_err = {}
    for name, fn in (
        ("reconstruct_shifts", lambda nb, x, e: reconstruct_shifts(x, nb)),
        ("narrow_down", lambda nb, x, e: narrow_down(3.5, e, x, nb).dist),
        ("neighbors_to_triples", lambda nb, x, e: neighbors_to_triples(nb.replace(
            **{f_: getattr(nb, f_)[:, :1000] for f_ in ("idx", "mask", "diff", "dist")}
        )).side_dist),
    ):
        out_card = fn(box_nb, coords, elem)
        out_cpu = fn(cpu_nb, coords.cpu(), elem.cpu())
        helper_err[name] = float((out_card.cpu() - out_cpu).abs().max())
        check(helper_err[name] <= 1e-5, f"{name}: the card agrees with the CPU")
    grid = setup_grid(cell_np, model.cutoff)
    frac_card, frac_cpu = (coords_to_fractional(coords[0].to(w_), cell.to(w_))
                           for w_ in ("cuda", "cpu"))
    idx3_card, idx3_cpu = (coords_to_grid_idx3(coords[0].to(w_), cell.to(w_), grid)
                           for w_ in ("cuda", "cpu"))
    scaled = frac_cpu * torch.as_tensor(grid)
    near = ((scaled - scaled.round()).abs() < 1e-4).any(-1)  # at a bucket face
    same_idx = (idx3_card.cpu() == idx3_cpu).all(-1)
    helper_err["coords_to_fractional"] = float((frac_card.cpu() - frac_cpu).abs().max())
    check(helper_err["coords_to_fractional"] <= 1e-5 and bool((same_idx | near).all()),
          "fractional coordinates and grid indices agree with the CPU's (but at a bucket face)")
    flat_c = flatten_idx3(idx3_card, grid)
    cnt, cum = count_atoms_in_buckets(flat_c, grid)
    i2a, a2i = atom_image_converters(flat_c)
    check(int(cnt.sum()) == num_atoms and torch.equal(i2a[a2i], torch.arange(num_atoms, device=dev))
          and bool((flat_c[i2a][1:] >= flat_c[i2a][:-1]).all()),
          "bucket counts and image converters are consistent")
    print(f"neighbor helpers on the box's table, card against CPU: max abs differences "
          f"{helper_err}; grid {grid.tolist()}, {int((~same_idx).sum())} atoms in another bucket "
          f"(at a face), {int(cnt.max())} atoms in the fullest bucket")
    del box_nb, cpu_nb
    print(f"{card}: E+F on the box (median of 5, host clock to a synchronize): "
          f"{ {k_: round(float(v), 3) for k_, v in ef_ms.items()} } ms; NVE steps "
          f"{ {k_: round(v, 3) for k_, v in step_ms.items()} } ms")
    print(f"new phases (element indices to the neighbor helpers): "
          f"{time.perf_counter() - t_slice:.1f} s of wall time")

    # ---- 41-45. data and training (`training_phases`) ----
    torch.cuda.empty_cache()
    train = training_phases(card, kernels_fn, reset_counts, read_counts)

    # ---- 46-49. NeuroChem, legacy data, solvation, profiling (`loader_phases`) ----
    torch.cuda.empty_cache()
    loaders = loader_phases(card, kernels_fn, reset_counts, read_counts, train["step_ms"]["force"])

    # ---- 50-52. atom-sharded MD and sharded training (`parallel_phases`) ----
    torch.cuda.empty_cache()
    parallel = parallel_phases(card)

    # ---- 53. third derivatives (`higher_order_phases`) ----
    torch.cuda.empty_cache()
    higher = higher_order_phases(card, kernels_fn, reset_counts, read_counts)

    # ---- 54. the native xyz parser (`xyz_phases`) ----
    xyz = xyz_phases(card, kernels_fn, reset_counts, read_counts)

    # ---- 55. triclinic MD through the three refreshes (`triclinic_phases`) ----
    torch.cuda.empty_cache()
    tri = triclinic_phases(card, kernels_fn, reset_counts, read_counts)
    radial = radial_phases(card)

    def entry(name, source, replaces, err, ms, plain, bound, by, library):
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": main_launches[name],
            "launches_by_path": {
                "ef": launches.get(name, 0), "md": md_launches[name],
                "ani2dr_ef": dr_ef_launches[name],
                **{f"ani2dr_md_{v}": dr_launches[v][name] for v in dr_launches},
                "ani1x_ef": x1_ef_launches[name], "ani1x_langevin": x1_md_launches[name],
                "ani2dr_mts_langevin": mts_launches[name],
                "hessian": hess_launches[name], "vibrational": vib_launches[name],
                "hessian_ani2dr_cell_list": dr_hess_launches[name],
                **{k_: v[name] for k_, v in ens_launches.items()},
                **{k_: v["launches"][name] for k_, v in thermo.items()},
                **{k_: v[name] for k_, v in tools.items()},
                **{k_: v[name] for k_, v in zoo.items()},
                **{k_: v[name] for k_, v in slice14.items()},
                **{k_: v[name] for k_, v in train["launches"].items()},
                **{k_: v[name] for k_, v in loaders["launches"].items()},
                **{k_: v[name] for k_, v in parallel["launches"].items()},
                **{k_: v[name] for k_, v in higher["launches"].items()},
                **{k_: v[name] for k_, v in xyz["launches"].items()},
                **{k_: v[name] for k_, v in tri["launches"].items()},
            },
            "max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": bound,
            "bound_by": by, "library_ms": library,
        }

    # the count of the main path that runs the kernel: the ANI-2x MD run for
    # K1-K3, the default ANI-2dr MD run for K4 (P = 5; the frozen run's P = 1
    # is in launches_by_path), the packed one for K5
    main_launches = dict(md_launches)
    for name in ("vals_select_fwd", "vals_select_bwd"):
        main_launches[name] = dr_launches["default"][name]
    for name in ("packed_select_fwd", "packed_select_bwd"):
        main_launches[name] = dr_launches["packed"][name]
    main_launches["angular_aev_bwd_bwd"] = hess_launches["angular_aev_bwd_bwd"]
    angular_cu = "torchani_tpu_torch/csrc/angular_aev.cu"
    select_cu = "torchani_tpu_torch/csrc/bucket_select.cu"
    vals_cu = "torchani_tpu_torch/csrc/vals_select.cu"
    packed_cu = "torchani_tpu_torch/csrc/packed_select.cu"
    kernels = [
        {**entry("angular_aev", angular_cu, "torchani_tpu/aev/pallas_kernels.py:186", k3_err,
                 k3_ms, plain_ms, k3_bound[0], k3_bound[1], None),
         "at_ani1x": {"max_abs_err": x1_k3_err, "ms": x1_k3["ms"], "plain_ms": x1_k3["plain"],
                      "bound_ms": x1_k3["bound"][0]},
         "at_z48": {"max_abs_err": z48["K3"]["err"], "ms": z48["K3"]["ms"][0],
                    "plain_ms": z48["K3"]["plain"], "bound_ms": z48["K3"]["bound"][0],
                    "bound_by": z48["K3"]["bound"][1], "smem_bytes": z48["K3"]["smem"]}},
        {**entry("angular_aev_bwd", angular_cu,
                 "torchani_tpu/aev/computer.py:1045 (_angular_pallas_bwd, XLA recompute; "
                 "no pallas_call)", k3b_err, k3b_ms, k3b_plain_ms, k3b_bound[0], k3b_bound[1],
                 None),
         "replaced_recompute_ms": recompute_ms, "grid": k3b_shape,
         "at_ani1x": {"max_abs_err": x1_k3b_err, "ms": x1_k3b["ms"], "plain_ms": x1_k3b["plain"],
                      "bound_ms": x1_k3b["bound"][0], "grid": x1_k3b_shape},
         "at_z48": {"max_abs_err": z48["K3b"]["err"], "ms": z48["K3b"]["ms"][0],
                    "plain_ms": z48["K3b"]["plain"], "bound_ms": z48["K3b"]["bound"][0],
                    "bound_by": z48["K3b"]["bound"][1], "smem_bytes": z48["K3b"]["smem"], "grid": z48["K3b"]["grid"]}},
        {**entry("angular_aev_bwd_bwd", angular_cu,
                 "torchani_tpu/aev/computer.py:1045 (second derivative through "
                 "_angular_pallas_bwd's XLA recompute; no pallas_call)", k3bb_err, k3bb_ms,
                 k3bb_plain_ms, k3bb_bound[0], k3bb_bound[1], None),
         "grid": k3bb_shape,
         "at_hessian_pass": {"max_abs_err": h_k3bb_err, "ms": h_k3bb_ms,
                             "plain_ms": h_k3bb_plain_ms, "bound_ms": h_k3bb_bound[0],
                             "bound_by": h_k3bb_bound[1], "rows": rows, "passes": passes,
                             "grid": h_k3bb_shape},
         "at_z48": {"max_abs_err": z48["K3bb"]["err"], "ms": z48["K3bb"]["ms"][0],
                    "plain_ms": z48["K3bb"]["plain"], "bound_ms": z48["K3bb"]["bound"][0],
                    "bound_by": z48["K3bb"]["bound"][1], "smem_bytes": z48["K3bb"]["smem"], "grid": z48["K3bb"]["grid"]}},
        {**entry("bucket_select_fwd", select_cu, "torchani_tpu/bucket_refresh.py:504",
                 k1_err, k1_ms, k1_plain_ms, k1_bound, k1_by, k1_lib_ms),
         "split": k1_shape["split"], "threads": k1_shape["threads"],
         "at_ani2dr": {
             "max_abs_err": k1_dr_err, "ms": k1_dr, "plain_ms": k1_dr_all["plain"],
             "bound_ms": k1_dr_bound[0], "library_ms": k1_dr_all["lib"],
             "split": k1_dr_shape["split"], "threads": k1_dr_shape["threads"],
         }},
        {**entry("bucket_select_bwd", select_cu, "torchani_tpu/bucket_refresh.py:544",
                 k2_err, k2_ms, k2_plain_ms, k2_bound, k2_by, k2_lib_ms),
         "split": k2_shape["split"], "threads": k2_shape["threads"],
         "at_ani2dr": {
             "max_abs_err": k2_dr_err, "ms": k2_dr["ms"], "plain_ms": k2_dr["plain"],
             "bound_ms": k2_dr_bound[0], "library_ms": k2_dr["lib"],
             "split": k2_dr_shape["split"], "threads": k2_dr_shape["threads"],
         }},
        entry("vals_select_fwd", vals_cu, "torchani_tpu/bucket_refresh.py:660",
              k4[5]["f_err"], k4[5]["f"], k4[5]["f_plain"], k4[5]["fb"][0], k4[5]["fb"][1],
              k4[5]["f_lib"]),
        {**entry("vals_select_bwd", vals_cu, "torchani_tpu/bucket_refresh.py:686",
                 k4[5]["b_err"], k4[5]["b"], k4[5]["b_plain"], k4[5]["bb"][0], k4[5]["bb"][1],
                 k4[5]["b_lib"]),
         "split": k4[5]["split"], "threads": k4[5]["threads"]},
        {**entry("packed_select_fwd", packed_cu, "torchani_tpu/bucket_refresh_packed.py:290",
                 k5f_err, k5["f"], k5["f_plain"], k5fb[0], k5fb[1], k5["f_lib"]),
         "split": k5_shape["split"], "threads": k5_shape["threads"]},
        {**entry("packed_select_bwd", packed_cu, "torchani_tpu/bucket_refresh_packed.py:316",
                 k5b_err, k5["b"], k5["b_plain"], k5bb[0], k5bb[1], k5["b_lib"]),
         "split": k5_shape["split"], "threads": k5_shape["threads"],
         "bound_every_lane_ms": k5bb_all[0]},
    ]
    # K3, K3b and K3bb at the training batch's tables (phase 42)
    for short, name in (("K3", "angular_aev"), ("K3b", "angular_aev_bwd"),
                        ("K3bb", "angular_aev_bwd_bwd")):
        t_k = train["kernels"][short]
        next(k_ for k_ in kernels if k_["name"] == name)["at_training"] = {
            "max_abs_err": t_k["err"], "ms": t_k["ms"], "in_step_ms": t_k["in_step"],
            "plain_ms": t_k["plain"], "bound_ms": t_k["bound"][0], "bound_by": t_k["bound"][1],
            **({"grid": t_k["grid"]} if "grid" in t_k else {}),
            "launches_force_step": train["launches"]["train_force_step"][name],
            "launches_energy_step": train["launches"]["train_energy_step"][name],
        }
    # K1 and K2 at the sharded MD's blocks of buckets (phases 50-51)
    for key, name in (("k1", "bucket_select_fwd"), ("k2", "bucket_select_bwd")):
        next(k_ for k_ in kernels if k_["name"] == name)["at_shards"] = {
            where: {"max_abs_err": e[key], "buckets": e["g"]}
            for where, e in parallel["errors"].items()
        }
    for p_, name in ((1, "vals_select_fwd"), (1, "vals_select_bwd")):
        side = "f" if name.endswith("fwd") else "b"
        next(k_ for k_ in kernels if k_["name"] == name)["at_p1"] = {
            "max_abs_err": k4[p_][f"{side}_err"], "ms": k4[p_][side],
            "plain_ms": k4[p_][f"{side}_plain"], "bound_ms": k4[p_][f"{side}b"][0],
            "library_ms": k4[p_][f"{side}_lib"],
            **({"split": k4[p_]["split"], "threads": k4[p_]["threads"]} if side == "b" else {}),
        }
    # K1, K2, K5f and K5b at the sheared box's tables (phase 55)
    for name, at in tri["kernels"].items():
        next(k_ for k_ in kernels if k_["name"] == name)["at_triclinic"] = at
    kernels.extend(radial["kernels"])  # K6, K6b and K6bb (phase 56)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
