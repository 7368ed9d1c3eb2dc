"""Where the time and memory of one energies-and-forces call go, on the card.

Run on a machine with an NVIDIA GPU, from the root of a checkout::

    python3 -m torchani_tpu_torch.profiling

Prints, for ANI-2x (random weights, seed 0) on the 10,002-atom periodic
water box with ``CellList(capacity=96)``: the E+F wall time; the wall time
of each forward stage run alone (neighbor table, AEV, networks; each ends in
a synchronize); E+F time and peak device memory with the angular backward
recompute in 1 to 4 atom blocks and with the default block size, and the
recompute's bytes per grid element that follow from them; the same for a
30,000-atom box; and, from ``torch.profiler`` over 10 calls, the device-busy
share and the CUDA kernels that take the most device time.
"""

import math
import time
import typing as tp

import numpy as np
import torch

from torchani_tpu_torch.grad import energies_and_forces
from torchani_tpu_torch.models import ANI2x
from torchani_tpu_torch.neighbors import CellList
from torchani_tpu_torch.testing import make_water_box

#: the headline box (``bench.py``'s) and the box for memory past many blocks
ATOMS, LARGE_ATOMS = 10002, 30000
#: timed calls per measurement, after one warm-up call
STEPS = 10
#: numbers of angular recompute blocks swept at ATOMS
BLOCK_COUNTS = (1, 2, 3, 4)


def wall_times_ms(fn: tp.Callable[[], tp.Any], reps: int) -> tp.List[float]:
    """Host times of ``reps`` calls of ``fn()``, each ending in a device
    synchronize, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def peak_gib(fn: tp.Callable[[], tp.Any]) -> float:
    """Peak device memory allocated during one call of ``fn()``, in GiB."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 2**30


def _water(num_atoms: int, dev: torch.device) -> tp.Tuple[torch.Tensor, ...]:
    species, coords, cell = make_water_box(num_atoms)
    return (
        torch.as_tensor(species, device=dev),
        torch.as_tensor(coords, device=dev),
        torch.as_tensor(cell, device=dev),
        torch.ones(3, dtype=torch.bool, device=dev),
    )


def main() -> None:
    dev = torch.device("cuda")
    model = ANI2x(pretrained=False, seed=0, device=dev)
    model.neighborlist = CellList(capacity=96)
    aevc = model.aev_computer
    species, coords, cell, pbc = _water(ATOMS, dev)
    num_atoms = species.shape[1]
    print(f"{torch.cuda.get_device_name(0)}; {num_atoms} atoms")

    elem = model._convert(species)
    nbrs = model.neighborlist(model.cutoff, elem, coords, cell, pbc)
    aevs = aevc.compute_from_neighbors(elem, coords, nbrs)
    stages = {
        "E+F": lambda: energies_and_forces(model, species, coords, cell, pbc),
        "forward (energies only)": lambda: model(species, coords, cell, pbc),
        "species conversion": lambda: model._convert(species),
        "neighbor table": lambda: model.neighborlist(model.cutoff, elem, coords, cell, pbc),
        "AEV (radial + angular)": lambda: aevc.compute_from_neighbors(elem, coords, nbrs),
        "networks (8 members)": lambda: model.neural_networks(elem, aevs),
    }
    with torch.no_grad():
        for name, fn in stages.items():
            with torch.enable_grad() if name == "E+F" else torch.no_grad():
                ms = float(np.median(wall_times_ms(fn, STEPS)))
            print(f"{name}: {ms:.3f} ms (median of {STEPS})")

    # the angular backward's memory and host time against its block size
    ka = aevc._angular_capacity(nbrs.capacity)
    grid = ka * ka * aevc.angular.num_feats
    print(f"angular recompute: Ka = {ka}, default block {aevc._atom_block(ka)} atoms")
    peaks = {}
    for count in BLOCK_COUNTS + (None,):
        aevc.atom_block = None if count is None else math.ceil(num_atoms / count)
        times = wall_times_ms(stages["E+F"], STEPS)
        peaks[count] = peak_gib(stages["E+F"])
        blocks = "default block" if count is None else f"{count} block(s)"
        print(f"E+F with {blocks}: median {np.median(times):.3f} ms, "
              f"peak device memory {peaks[count]:.3f} GiB")
    aevc.atom_block = None
    lo, hi = BLOCK_COUNTS[0], BLOCK_COUNTS[-1]
    atoms_saved = math.ceil(num_atoms / lo) - math.ceil(num_atoms / hi)
    print(f"recompute bytes per grid element: "
          f"{(peaks[lo] - peaks[hi]) * 2**30 / (atoms_saved * grid):.2f} "
          f"({lo} vs {hi} blocks)")

    large = _water(LARGE_ATOMS, dev)
    times = wall_times_ms(lambda: energies_and_forces(model, *large), STEPS)
    print(f"E+F {large[0].shape[1]} atoms, default block: median "
          f"{np.median(times):.3f} ms, peak device memory "
          f"{peak_gib(lambda: energies_and_forces(model, *large)):.3f} GiB")
    del large

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    stages["E+F"]()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            stages["E+F"]()
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    device_us = sum(
        e.self_device_time_total for e in events if e.device_type == torch.autograd.DeviceType.CUDA
    )
    print(
        f"profiled window: {window_us / 1e3 / STEPS:.3f} ms per E+F, device busy "
        f"{device_us / window_us:.1%} (kernel time / wall time)"
    )
    rows = sorted(
        (e for e in events if e.device_type == torch.autograd.DeviceType.CUDA),
        key=lambda e: e.self_device_time_total,
        reverse=True,
    )
    print("device time per E+F by kernel (top 20):")
    for e in rows[:20]:
        print(
            f"  {e.self_device_time_total / STEPS / 1e3:9.4f} ms  "
            f"{e.count // STEPS:5d}x  {e.key[:100]}"
        )
    print(
        "host ops by self CPU time (top 15):\n"
        + events.table(sort_by="self_cpu_time_total", row_limit=15)
    )


if __name__ == "__main__":
    main()
