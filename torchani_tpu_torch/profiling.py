"""Where the time and memory of one energies-and-forces call and of one MD
step go, on the card.

Run on a machine with an NVIDIA GPU, from the root of a checkout::

    python3 -m torchani_tpu_torch.profiling

Prints, for ANI-2x (random weights, seed 0) on the 10,002-atom periodic
water box with ``CellList(capacity=96)``: the E+F wall time; the wall time
of each forward stage run alone (neighbor table, AEV, networks; each ends in
a synchronize); E+F time and peak device memory at 10,002 and at 30,000
atoms; and, from ``torch.profiler`` over 10 calls, the device-busy share and
the CUDA kernels that take the most device time (K3 and K3b, the angular
AEV's forward and backward, wherever they rank).  Then, for
`MolecularDynamics` with its defaults on the same box (`MolecularDynamics`, 300 K, 1 fs):
the step's wall time, the wall time of each stage run alone (refresh, AEV,
networks, the whole forward, forward and backward, integrator, a neighbor
rebuild), and, from ``torch.profiler`` over 20 steps, the device-busy share,
kernel launches and host waits per step and the top kernels (K3 and K3b
among them); the kernels of
the bucket refresh and of the gather refresh, forward and backward, on the
same cached topology; and how long the box lasts under random weights (it
heats up until a static capacity overflows).  Last, for ANI-2dr (networks,
xTB repulsion, D3 dispersion) under `MolecularDynamics` three ways (its
defaults, the frozen pair window, the atom-packed refresh): the step's wall
time, the forward-and-backward wall time of each potential alone on its own
lane prefix (the networks with their AEV, the repulsion, D3 with its K4
launches) and of the refresh, and the profiled window's launches, host waits
and top kernels.  ``python3 -m torchani_tpu_torch.profiling ani2dr`` prints
that last part alone.
"""

import sys
import time
import typing as tp

import numpy as np
import torch

from torchani_tpu_torch.grad import energies_and_forces
from torchani_tpu_torch.bucket_refresh import vals_select_bwd, vals_select_fwd
from torchani_tpu_torch.md import (
    MolecularDynamics,
    _batch1,
    _refresh_neighbors,
    _slice_lanes,
    kinetic_temperature,
)
from torchani_tpu_torch.models import ANI2dr, ANI2x
from torchani_tpu_torch.neighbors import CellList, narrow_to_cutoff
from torchani_tpu_torch.testing import make_water_box

#: the headline box (``bench.py``'s) and the box for memory past many blocks
ATOMS, LARGE_ATOMS = 10002, 30000
#: timed calls per measurement, after one warm-up call
STEPS = 10
#: MD steps in the profiled window
MD_STEPS = 20
#: CUDA runtime calls on which the host waits for the device
HOST_WAITS = (
    "cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy",
)


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

    # E+F time and peak memory at the two boxes (the angular backward is one
    # K3b launch: no recompute block to size)
    for system in ((species, coords, cell, pbc), _water(LARGE_ATOMS, dev)):
        ef = lambda: energies_and_forces(model, *system)  # noqa: E731
        times = wall_times_ms(ef, STEPS)
        print(f"E+F {system[0].shape[1]} atoms: median {np.median(times):.3f} ms, "
              f"peak device memory {peak_gib(ef):.3f} GiB")
    del system, ef

    _profile("E+F", stages["E+F"], STEPS, also=("angular_aev",))
    del stages, nbrs, aevs
    md_report(model, species, coords, cell)
    del model
    torch.cuda.empty_cache()
    dr_report()


def _profile(
    what: str, fn: tp.Callable[[], tp.Any], reps: int, top: int = 20, host_ops: bool = True,
    also: tp.Sequence[str] = (),
) -> None:
    """Print, from ``torch.profiler`` over ``reps`` calls of ``fn()``: the
    device-busy share of the window, kernel launches, host waits and copies
    per call, the ``top`` kernels by device time, the kernels whose name
    holds one of ``also`` wherever they rank, and (with ``host_ops``) the
    host operations that take the most time."""
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    rows = sorted(
        (e for e in events if e.device_type == torch.autograd.DeviceType.CUDA),
        key=lambda e: e.self_device_time_total,
        reverse=True,
    )
    device_us = sum(e.self_device_time_total for e in rows)
    print(
        f"profiled window: {window_us / 1e3 / reps:.3f} ms per {what}, device busy "
        f"{device_us / window_us:.1%} (kernel time / wall time), "
        f"{device_us / 1e3 / reps:.3f} ms of kernels per {what}"
    )
    runtime = {e.key: e.count for e in events if e.key.startswith("cuda")}
    launches = sum(n for key, n in runtime.items() if "Launch" in key)
    waits = {key: n / reps for key, n in runtime.items() if key.startswith(HOST_WAITS)}
    # the window's own closing synchronize is not the program's
    waits["cudaDeviceSynchronize"] = waits.get("cudaDeviceSynchronize", 0) - 1 / reps
    print(f"per {what}: {launches / reps:.1f} kernel launches; host waits and copies "
          f"{ {k: round(v, 2) for k, v in sorted(waits.items()) if v > 0} }")
    print(f"device time per {what} by kernel (top {top}):")
    for e in rows[:top] + [e for e in rows[top:] if any(name in e.key for name in also)]:
        print(
            f"  {e.self_device_time_total / reps / 1e3:9.4f} ms  "
            f"{e.count / reps:7.1f}x  {e.key[:100]}"
        )
    if host_ops:
        print(
            "host ops by self CPU time (top 15):\n"
            + events.table(sort_by="self_cpu_time_total", row_limit=15)
        )


def md_report(model, species, coords, cell) -> None:
    """The MD step of `MolecularDynamics` with its defaults: stage times, and
    the profiled window."""
    md = MolecularDynamics(model, species, cell=cell, pbc=True)
    state = md.init(coords, temperature=300.0, generator=torch.Generator().manual_seed(0))
    state = md.run_nve(state, 5)
    tables = state.bucket
    print(f"MD: K = {md.capacity} lanes, C = {md._bucket_c} slots, grid {md.grid_shape}, "
          f"angular prefix {md._ang_prefix}, bucket refresh {tables is not None}")
    holder = [state]

    def step():
        holder[0] = md.step_nve(holder[0])

    times = wall_times_ms(step, MD_STEPS)
    print(f"MD step: median {np.median(times):.3f} ms, min {np.min(times):.3f}, "
          f"max {np.max(times):.3f} over {MD_STEPS} steps; rebuilds {holder[0].rebuilds}")
    state = holder[0]
    crd = state.coords
    elem = md.elem_idxs
    nnp = md.model.potentials["nnp"]
    ranges = md._species_ranges
    present = tuple(s for s, _, _ in ranges)

    def tables_of(c):
        return _batch1(narrow_to_cutoff(_refresh_neighbors(state, c), md.cutoff))

    nbn = tables_of(crd)
    aevs = nnp.aev_computer.compute_from_neighbors(elem, None, nbn, present=present)

    def forward(c):
        return md._potential_energy(_refresh_neighbors(state, c), md._to_internal(c))

    def refresh_both_ways():
        c = crd.detach().requires_grad_(True)
        torch.autograd.grad(_refresh_neighbors(state, c).diff.sum(), c)

    def integrator():
        v_half = state.velocities + 0.5 * md.dt * state.forces * md._inv_m
        return state.coords + md.dt * v_half, v_half + 0.5 * md.dt * state.forces * md._inv_m

    stages = {
        "refresh (forward)": (lambda: _refresh_neighbors(state, crd), False),
        "refresh (forward + backward)": (refresh_both_ways, True),
        "AEV (radial + angular, K3 forward)": (
            lambda: nnp.aev_computer.compute_from_neighbors(elem, None, nbn, present=present),
            False,
        ),
        "networks (8 members)": (
            lambda: nnp.neural_networks(elem, aevs, species_ranges=ranges), False
        ),
        "forward (energy only)": (lambda: forward(crd), False),
        "forward + backward (energy and forces)": (
            lambda: md._energy_and_forces(state, crd), True
        ),
        "rebuild decision + integrator": (
            lambda: (md._maybe_rebuild(state, crd), integrator()), False
        ),
        "neighbor rebuild": (lambda: md._build_cache(crd), False),
    }
    for name, (fn, grad) in stages.items():
        with torch.enable_grad() if grad else torch.no_grad():
            ms = float(np.median(wall_times_ms(fn, STEPS)))
        print(f"MD {name}: {ms:.3f} ms (median of {STEPS})")
    _profile("MD step", step, MD_STEPS, also=("angular_aev",))

    # the two refreshes on the same cached topology, forward and backward
    with torch.no_grad():
        ci = md._to_internal(crd)
        diff = _refresh_neighbors(state, crd).diff
        nbr_pos = ci.index_select(0, state.nbr_idx.reshape(-1)).reshape(diff.shape)
        shift = torch.where(state.nbr_mask[..., None], diff - (nbr_pos - ci[:, None, :]), 0.0)
    gather_state = state.replace(bucket=None, nbr_shift=shift)
    weights = torch.randn(diff.shape, device=diff.device)

    def refresh(st):
        c = crd.detach().requires_grad_(True)
        nb = _refresh_neighbors(st, c)
        torch.autograd.grad((nb.diff * weights).sum() + nb.dist.sum(), c)

    for name, st in (("bucket", state), ("gather", gather_state)):
        _profile(f"{name} refresh (forward + backward)", lambda: refresh(st), STEPS,
                 top=12, host_ops=False)
    heating_report(md, coords)


def heating_report(md: MolecularDynamics, coords, max_steps: int = 100) -> None:
    """Run NVE from 300 K until the forces stop being finite (or
    ``max_steps``) and print, every 10 steps and at the end, what the
    random weights do to the box: temperature, the closest pair, and the
    fullest angular row against the AEV's angular capacity."""
    aevc = md.model.aev_computer
    r_ang = aevc.angular.cutoff
    cap = aevc._angular_capacity(md.capacity)
    state = md.init(coords, temperature=300.0, generator=torch.Generator().manual_seed(0))
    while state.step < max_steps:
        state = md.step_nve(state)
        finite = bool(torch.isfinite(state.forces).all())
        if finite and state.step % 10:
            continue
        nb = _refresh_neighbors(state, state.coords)
        print(
            f"heating: step {state.step}, forces finite {finite}, overflow flag "
            f"{bool(state.overflow)}, T {float(kinetic_temperature(state.velocities, md.masses)):.1f} K, "
            f"closest pair {float(torch.where(nb.mask, nb.dist, 9.0).min()):.3f} A, fullest "
            f"angular row {int((nb.mask & (nb.dist <= r_ang)).sum(-1).max())} of {cap} lanes, "
            f"fullest radial row {int(nb.mask.sum(-1).max())} of {md.capacity}, "
            f"rebuilds {state.rebuilds}"
        )
        if not finite:
            break


#: MD steps of an ANI-2dr window: with its 3 steps of run-in, the warm-up
#: step and the window, a stretch stays under the ~20 steps that the box
#: lasts under random weights (then an atom exceeds the AEV's angular
#: capacity and the forces go NaN by design)
DR_MD_STEPS = 8
#: the three ways `dr_report` drives ANI-2dr
DR_VARIANTS = {
    "default": {},
    "frozen": dict(freeze_pair_window=("dispersion_d3",)),
    "packed": dict(bucket_refresh="packed"),
}


def dr_report() -> None:
    """The ANI-2dr MD step three ways: stage times per potential and the
    profiled window."""
    dev = torch.device("cuda")
    model = ANI2dr(pretrained=False, seed=0, device=dev)
    species, coords, cell, _ = _water(ATOMS, dev)
    print(f"{torch.cuda.get_device_name(0)}; ANI-2dr, {species.shape[1]} atoms")
    for variant, kw in DR_VARIANTS.items():
        md = MolecularDynamics(model, species, cell=cell, pbc=True, **kw)
        state = md.init(coords, temperature=300.0, generator=torch.Generator().manual_seed(0))
        run_in = md.run_nve(state, 3)
        print(f"ANI-2dr MD ({variant}): K = {md.capacity} lanes, C = {md._bucket_c} slots, grid "
              f"{md.grid_shape}, lane prefixes {md._lane_prefixes}, angular prefix "
              f"{md._ang_prefix}, packed span {md._bucket_span}")
        holder = [run_in]

        def step():
            holder[0] = md.step_nve(holder[0])

        times = wall_times_ms(step, DR_MD_STEPS)
        print(f"ANI-2dr MD ({variant}) step: median {np.median(times):.3f} ms, min "
              f"{np.min(times):.3f}, max {np.max(times):.3f} over {DR_MD_STEPS} steps; rebuilds "
              f"{holder[0].rebuilds}; forces finite {bool(torch.isfinite(holder[0].forces).all())}")
        state = holder[0]
        crd = state.coords

        def potential(name: str, backward: bool):
            """Energy (and gradient) of one potential on its own lane prefix,
            as `MolecularDynamics._potential_energy` dispatches it."""
            c = crd.detach().requires_grad_(backward)
            nb = _refresh_neighbors(state, c)
            pot = md.model.potentials[name]
            p = md._lane_prefixes.get(name)
            nbp = narrow_to_cutoff(_slice_lanes(nb, p) if p is not None else nb, pot.cutoff)
            if state.pair_aux is not None and name in state.pair_aux:
                aux = state.pair_aux[name]
                nbp = nbp.replace(pair_aux=aux if p is None else aux[:, :p])
            e = pot.compute_from_neighbors(
                md.elem_idxs, None, _batch1(nbp), species_ranges=md._species_ranges
            ).energies.sum()
            if backward:
                torch.autograd.grad(e, c)

        def refresh_both_ways():
            c = crd.detach().requires_grad_(True)
            torch.autograd.grad(_refresh_neighbors(state, c).diff.sum(), c)

        stages = {"refresh (forward + backward)": refresh_both_ways}
        for name in sorted(md.model.potentials):
            stages[f"{name} + refresh (forward)"] = lambda n=name: potential(n, False)
            stages[f"{name} + refresh (forward + backward)"] = lambda n=name: potential(n, True)
        stages["all (forward + backward)"] = lambda: md._energy_and_forces(state, crd)
        stages["neighbor rebuild"] = lambda: md._build_cache(crd)
        for name, fn in stages.items():
            ms = float(np.median(wall_times_ms(fn, STEPS)))
            print(f"ANI-2dr MD ({variant}) {name}: {ms:.3f} ms (median of {STEPS})")
        before = vals_select_fwd.launches, vals_select_bwd.launches
        md._energy_and_forces(state, crd)
        print(f"ANI-2dr MD ({variant}) K4f, K4b launches per evaluation: "
              f"{vals_select_fwd.launches - before[0]}, {vals_select_bwd.launches - before[1]}")
        holder[0] = run_in  # the same stretch again: the box does not last a third one
        _profile(
            f"ANI-2dr MD step ({variant})", step, DR_MD_STEPS, top=14, host_ops=False,
            also=("vals_select", "packed_select", "bucket_select", "angular_aev"),
        )
        print(f"ANI-2dr MD ({variant}): forces finite after the profiled window "
              f"{bool(torch.isfinite(holder[0].forces).all())}")
        del md, state, run_in, holder
        torch.cuda.empty_cache()


if __name__ == "__main__":
    if sys.argv[1:] == ["ani2dr"]:
        dr_report()
    else:
        main()
