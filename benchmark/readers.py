"""What the per-layer metrics read, shared by the files in ``metrics/``.

Each reader takes the run's context: ``config`` and ``traffic``; ``trace``,
the ``--trace 1`` window (``kernels``: device seconds and launches by
kernel name; ``runtime``: CUDA runtime calls by name; ``busy_s``,
``window_s``; ``work``: `yardstick.count_work` counts summed over its units,
with the units under ``steps`` or ``batches``); and ``window``, the untimed
run's measured window (``work``, ``seconds``, ``counters`` the program
kept).  A reader that finds nothing to read returns None, and the metric
is left out of the result line.
"""

import typing as tp

from benchmark import yardstick

#: CUDA runtime calls in which the host waits for the device
HOST_WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy")
#: the kernels of each layer, by a part of their names
ANGULAR = ("angular_aev_kernel", "angular_aev_bwd_kernel")
ANGULAR_2ND = ANGULAR + ("angular_aev_bwd_bwd_kernel",)
REFRESH = ("bucket_select_fwd_kernel", "bucket_select_bwd_kernel")


def kernel_seconds(ctx, names: tp.Sequence[str]) -> float:
    """Device seconds of the traced kernels whose names hold one of
    ``names``."""
    return sum(s for key, (s, _) in ctx.trace.kernels.items() if any(n in key for n in names))


def device_idle(ctx) -> tp.Optional[float]:
    """% of the traced window in which no operation ran on the device."""
    if ctx.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)


def mfu(ctx, products: int, aev_order: int, members: int) -> tp.Optional[float]:
    """% of the f32 peak that the measured window's counted work fills: the
    networks' ``products`` passes of matrix products over ``members``
    members, and the AEV's operations to derivative ``aev_order``."""
    w = ctx.window.work
    if not w or ctx.window.seconds <= 0:
        return None
    flops = (yardstick.network_flops(ctx.config, w, products, members)
             + yardstick.aev_flops(ctx.config, w, aev_order))
    return 100.0 * flops / (ctx.window.seconds * yardstick.PEAK_F32_FLOPS)


def angular_roofline(ctx, second_order: bool) -> tp.Optional[float]:
    """% of K3 and K3b's (and K3bb's) device time that their least time
    fills."""
    names = ANGULAR_2ND if second_order else ANGULAR
    seconds = kernel_seconds(ctx, names)
    if seconds <= 0:
        return None
    w = ctx.trace.work
    ang = ctx.config["aev"]["angular"]
    sh, se = ang["num_shifts"], ang["num_sections"]
    nbytes = yardstick.angular_bytes(ctx.config, w)
    pairs, lanes = w["angular_pairs"], w["angular_lanes"]
    bound = (yardstick.angular_bound_s(pairs, lanes, sh, se, nbytes["k3"], False)
             + yardstick.angular_bound_s(pairs, lanes, sh, se, nbytes["k3b"], True))
    if second_order:
        bound += yardstick.k3bb_bound_s(pairs, lanes, sh, se, nbytes["k3bb"])
    return 100.0 * bound / seconds


def refresh_roofline(ctx) -> tp.Optional[float]:
    """% of K1 and K2's device time that their least time fills, over the
    pairs within the MD table's build radius."""
    seconds = kernel_seconds(ctx, REFRESH)
    if seconds <= 0:
        return None
    w = ctx.trace.work
    lanes, atoms = w["lanes.refresh"], w["atoms"]
    bound = (yardstick.select_bound_s(lanes, atoms, adds=False)
             + yardstick.select_bound_s(lanes, atoms, adds=True))
    return 100.0 * bound / seconds


def launches(ctx, unit: str) -> tp.Optional[float]:
    """Kernel launches in the traced window per ``unit``."""
    n = sum(c for key, c in ctx.trace.runtime.items() if "Launch" in key)
    if n == 0:
        return None
    return n / ctx.trace.work[unit]


def host_waits(ctx, unit: str) -> tp.Optional[float]:
    """CUDA runtime calls in which the host waited for the device, per
    ``unit``, without the traced window's closing synchronize."""
    if not ctx.trace.runtime:
        return None
    n = sum(c for key, c in ctx.trace.runtime.items() if key.startswith(HOST_WAITS)) - 1
    return n / ctx.trace.work[unit]


def rebuilds_per_kstep(ctx) -> tp.Optional[float]:
    """Neighbor rebuilds per thousand MD steps in the measured window, from
    the program's ``MDState.rebuilds``."""
    steps = ctx.window.work.get("steps", 0.0)
    if "rebuilds" not in ctx.window.counters or steps <= 0:
        return None
    return 1000.0 * ctx.window.counters["rebuilds"] / steps
