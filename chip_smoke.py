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
temporary data directory and loaded back with ``pretrained=True``.  Every
number it prints was measured or computed in the run.  It prints a
``kernels`` JSON line (all eight kernels) and, last, ``{"ok": true,
"device": {...}}``.  Any failed check raises, and the script exits non-zero
without that last line; so does a machine with no CUDA device, or a
directory without the package.  A little over a minute of command time on
an H100.
"""

import json
import subprocess
import sys
import tempfile
import time

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


def kernels_ms(fn, reps: int) -> float:
    """Device time of the kernels that ``fn()`` launches, per call, summed
    by ``torch.profiler`` (no idle time of the stream in it).  A window in
    which the profiler recorded no device time at all is taken again, up to
    three times; then the measurement fails."""
    fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):
        with torch.profiler.profile(activities=activities) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        device_us = sum(
            e.self_device_time_total
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
        )
        if device_us > 0:
            return device_us / reps / 1e3
    raise RuntimeError("torch.profiler recorded no device time in three windows")


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


def k3b_launch_shape(what: str, lanes, kw: dict) -> dict:
    """Print and return K3b's persistent grid at these lanes and widths:
    blocks, threads a block, shared memory a block (each warp's one buffer
    of the cotangent rows that meet a pair, lanes and gradient planes),
    atoms a warp."""
    from torchani_tpu_torch.aev.kernels import bwd_launch_shape as k3b_shape

    n, ka = lanes[0].shape
    shape = k3b_shape(n, ka, kw["num_species"], len(kw["shifts"]), len(kw["sections"]),
                      lanes[0].device)
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

    from torchani_tpu_torch import convert, csrc, paths
    from torchani_tpu_torch.aev.kernels import (
        angular_aev,
        angular_aev_bwd,
        angular_aev_bwd_reference,
        angular_aev_reference,
        angular_grid,
        lane_species,
    )
    from torchani_tpu_torch.aev.terms import ANIAngular
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
    from torchani_tpu_torch.grad import energies_and_forces, single_point
    from torchani_tpu_torch.md import (
        CachedSinglePoint,
        MolecularDynamics,
        MultipleTimestepMD,
        _refresh_neighbors,
        kinetic_temperature,
    )
    from torchani_tpu_torch.models import ANI1x, ANI2dr, ANI2x
    from torchani_tpu_torch.neighbors import CellList, _static_grid_shape
    from torchani_tpu_torch.profiling import peak_gib, wall_times_ms
    from torchani_tpu_torch.testing import make_water_box

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
    kernels_fn = {
        "angular_aev": angular_aev,
        "angular_aev_bwd": angular_aev_bwd,
        "bucket_select_fwd": bucket_select_fwd,
        "bucket_select_bwd": bucket_select_bwd,
        "vals_select_fwd": vals_select_fwd,
        "vals_select_bwd": vals_select_bwd,
        "packed_select_fwd": packed_select_fwd,
        "packed_select_bwd": packed_select_bwd,
    }

    def reset_counts():
        for fn in kernels_fn.values():
            fn.launches = 0
        angular_grid.calls = 0

    def k3b_once_per_evaluation(counts, what):
        check(counts["angular_aev_bwd"] == counts["angular_aev"] and angular_grid.calls == 0,
              f"{what}: K3b launched as often as K3 (once per evaluation), no plain angular grid")

    def read_counts():
        return {name: fn.launches for name, fn in kernels_fn.items()}

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
        "packed_select_fwd": 0, "packed_select_bwd": 0,
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
    angular_cu = "torchani_tpu_torch/csrc/angular_aev.cu"
    select_cu = "torchani_tpu_torch/csrc/bucket_select.cu"
    vals_cu = "torchani_tpu_torch/csrc/vals_select.cu"
    packed_cu = "torchani_tpu_torch/csrc/packed_select.cu"
    kernels = [
        {**entry("angular_aev", angular_cu, "torchani_tpu/aev/pallas_kernels.py:186", k3_err,
                 k3_ms, plain_ms, k3_bound[0], k3_bound[1], None),
         "at_ani1x": {"max_abs_err": x1_k3_err, "ms": x1_k3["ms"], "plain_ms": x1_k3["plain"],
                      "bound_ms": x1_k3["bound"][0]}},
        {**entry("angular_aev_bwd", angular_cu,
                 "torchani_tpu/aev/computer.py:1045 (_angular_pallas_bwd, XLA recompute; "
                 "no pallas_call)", k3b_err, k3b_ms, k3b_plain_ms, k3b_bound[0], k3b_bound[1],
                 None),
         "replaced_recompute_ms": recompute_ms, "grid": k3b_shape,
         "at_ani1x": {"max_abs_err": x1_k3b_err, "ms": x1_k3b["ms"], "plain_ms": x1_k3b["plain"],
                      "bound_ms": x1_k3b["bound"][0], "grid": x1_k3b_shape}},
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
    for p_, name in ((1, "vals_select_fwd"), (1, "vals_select_bwd")):
        side = "f" if name.endswith("fwd") else "b"
        next(k_ for k_ in kernels if k_["name"] == name)["at_p1"] = {
            "max_abs_err": k4[p_][f"{side}_err"], "ms": k4[p_][side],
            "plain_ms": k4[p_][f"{side}_plain"], "bound_ms": k4[p_][f"{side}b"][0],
            "library_ms": k4[p_][f"{side}_lib"],
            **({"split": k4[p_]["split"], "threads": k4[p_]["threads"]} if side == "b" else {}),
        }
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
