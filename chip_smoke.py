#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``torchani_tpu_torch``).

Run from the root of a checkout, on a machine with one NVIDIA GPU::

    python3 chip_smoke.py

In order: prints the card, builds every CUDA kernel from ``csrc/`` (one
``nvcc`` per source, all at once), holds each kernel against its plain
PyTorch version on the card, runs ANI-2x energies and forces on the
10,002-atom periodic water box through the public entry points (counting
kernel launches), compares the card with the CPU on a ~1,000-atom box, times
the main path, each kernel and its plain version, and prints a ``kernels``
JSON line and, last, ``{"ok": true, "device": {...}}``.  Any failed check
raises, and the script exits non-zero without that last line; so does a
machine with no CUDA device, or a directory without the package.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

#: H100 SXM peaks (NVIDIA data sheet, dense, 700 W): non-tensor f32 and HBM
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
#: FP32 operations per angular term and per neighbour pair, with exp and pow
#: counted as one operation each (so the bound is optimistic)
OPS_PER_TERM = 15
OPS_PER_PAIR = 15
#: kernel vs plain version on the card: |k - p| <= ATOL + RTOL |p| (f32 sums
#: taken in another order, as in tests/test_pallas.py)
ATOL, RTOL = 1e-5, 1e-4
#: card vs CPU, same model from the same seed: forces and atomic energies
#: (f32 sums over ~100 neighbours and 8 members taken in another order)
FORCE_ATOL, ATOMIC_E_ATOL = 1e-5, 5e-5


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


def kernel_errors(out: torch.Tensor, ref: torch.Tensor, what: str) -> float:
    err = (out - ref).abs()
    max_abs = float(err.max())
    max_rel = float((err / ref.abs().clamp(min=1e-6)).max())
    print(f"{what}: max abs err {max_abs:.3e}, max rel err {max_rel:.3e}")
    check(bool(torch.isfinite(out).all()), f"{what}: kernel output finite")
    check(bool((err <= ATOL + RTOL * ref.abs()).all()), f"{what}: within tolerance")
    return max_abs


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

    from torchani_tpu_torch import csrc
    from torchani_tpu_torch.aev.kernels import angular_aev, angular_aev_reference
    from torchani_tpu_torch.aev.terms import ANIAngular
    from torchani_tpu_torch.grad import energies_and_forces, single_point
    from torchani_tpu_torch.models import ANI2x
    from torchani_tpu_torch.neighbors import CellList
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
    print(f"water box: {num_atoms} atoms, cell {float(cell_np[0, 0]):.3f} A")

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

    # ---- 3. the main path: ANI-2x E+F on the water box ----
    angular_aev.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    energies, forces = energies_and_forces(model, species, coords, cell, pbc)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {"angular_aev": angular_aev.launches}
    print(f"main path: E = {float(energies[0]):.6f} Ha, first call {first_s:.3f} s, "
          f"launches {launches}")
    check(tuple(energies.shape) == (1,), "energies shape (1,)")
    check(tuple(forces.shape) == (1, num_atoms, 3), "forces shape (1, A, 3)")
    check(bool(torch.isfinite(energies).all()), "energies finite")
    check(bool(torch.isfinite(forces).all()), "forces finite")
    check(all(v > 0 for v in launches.values()), "every kernel launched on the main path")

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

    # ---- 5. timings ----
    def ef():
        energies_and_forces(model, species, coords, cell, pbc)

    times = wall_times_ms(ef, reps=10)
    print(f"E+F {num_atoms} atoms: median {np.median(times):.3f} ms, "
          f"min {np.min(times):.3f} ms, max {np.max(times):.3f} ms "
          f"over {len(times)} calls (host clock, each ending in a synchronize)")
    print(f"E+F peak device memory: {peak_gib(ef):.3f} GiB")

    k3_ms = cuda_ms(lambda: angular_aev(*k3_in, **k3_kw), reps=20)
    plain_ms = cuda_ms(lambda: angular_aev_reference(*k3_in, **k3_kw), reps=5, warmup=1)
    mask = k3_in[2]
    lanes = mask.sum(1).to(torch.float64)
    pairs = float((lanes * (lanes - 1) / 2).sum())
    num_z = len(k3_kw["shifts"]) * len(k3_kw["sections"])
    ops = pairs * (num_z * OPS_PER_TERM + OPS_PER_PAIR)
    nbytes = sum(t.numel() * t.element_size() for t in k3_in) + out.numel() * 4
    bound_ops_ms = ops / PEAK_F32_FLOPS * 1e3
    bound_bytes_ms = nbytes / PEAK_HBM_BYTES * 1e3
    print(f"K3 alone: {k3_ms:.4f} ms; plain version {plain_ms:.3f} ms; "
          f"{pairs:.0f} valid pairs ({pairs / n:.1f} per atom); bound "
          f"{bound_ops_ms:.4f} ms by operations, {bound_bytes_ms:.4f} ms by bytes "
          f"({nbytes / 1e6:.1f} MB)")

    kernels = [{
        "name": "angular_aev",
        "route": "cuda",
        "source": "torchani_tpu_torch/csrc/angular_aev.cu",
        "replaces": "torchani_tpu/aev/pallas_kernels.py:186",
        "launches": launches["angular_aev"],
        "max_abs_err": k3_err,
        "ms": k3_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bound_ops_ms, bound_bytes_ms),
        "bound_by": "operations" if bound_ops_ms >= bound_bytes_ms else "bytes",
        "library_ms": None,
    }]
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
