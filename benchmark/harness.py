"""Runs one cell of ``BENCHMARK.json`` once and prints its result line.

The cell's entry names a configuration (``configs/<config>.json``) and a
traffic mix (``traffic/<traffic>.json``, whose ``driver`` names the module
of `benchmark.drivers` that generates and drives it); its output check's
limits are ``limits/<workload>.json`` and each per-layer metric is read by
``metrics/<metric>.py``.  So a new cell, configuration, traffic mix or
metric is new files and new entries, and no edit.

A run: set-up (import, the program's kernels built or loaded from the
checkout's ``build/``, inputs and weights made from the seed, the program
built and warmed up on every shape the traffic uses), a window of
``--seconds`` of whole units, with ``--trace 1`` a further ``trace_units``
units under ``torch.profiler``, then the program's state is freed and the
output check runs against the plain reference.
"""

import gc
import importlib
import importlib.util
import json
import math
import os
import sys
import time
import types
import typing as tp
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
#: top-level modules that must not be loaded in a run: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "torchani_tpu")


def set_cache_dirs() -> None:
    """The program's kernel builds and Triton's cache at fixed paths inside
    the checkout, so that only a checkout's first run compiles."""
    os.environ["TORCHANI_TPU_TORCH_BUILD_DIR"] = str(ROOT / "build" / "torch_kernels")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton_cache")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(bench: dict, workload: str) -> tp.Tuple[dict, dict, dict]:
    """The workload's configuration, traffic mix and limits."""
    entry = {w["name"]: w for w in bench["workloads"]}[workload]
    config = load_json(BENCH_DIR / "configs" / f"{entry['config']}.json")
    traffic = load_json(BENCH_DIR / "traffic" / f"{entry['traffic']}.json")
    limits_path = BENCH_DIR / "limits" / f"{workload}.json"
    limits = load_json(limits_path)["limits"] if limits_path.exists() else {}
    return config, traffic, limits


def reported(bench: dict, workload: str, section: str) -> tp.List[dict]:
    """The metrics of ``section`` that this cell reports: those that list it
    under ``workloads``; without that key, every end-to-end metric, and a
    per-layer metric wherever the metric it moves is reported."""
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    if section == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", [workload] if m["moves"] in names else [])]


def make_driver(config: dict, traffic: dict, seed: int, device):
    module = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    return module.DRIVER(config, traffic, seed, device)


def reader(name: str) -> tp.Callable[[types.SimpleNamespace], tp.Optional[float]]:
    """``metrics/<name>.py``'s ``read``."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def merged(works: tp.Iterable[tp.Mapping[str, float]]) -> tp.Dict[str, float]:
    out: tp.Dict[str, float] = {}
    for w in works:
        for k, v in w.items():
            out[k] = out.get(k, 0.0) + v
    return out


def _union_length(intervals: tp.List[tp.Tuple[float, float]]) -> float:
    total, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def traced(driver, units: int) -> types.SimpleNamespace:
    """``units`` units under ``torch.profiler``: device time by kernel,
    CUDA runtime calls, the device-busy seconds, the window, the work, and
    the breakdown of device time and of idle gaps by what the host ran."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    on_card = driver.device.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    first = len(driver.work)
    driver.finish()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(units):
            with record_function(f"benchmark.{driver.unit}"):
                driver.step()
        if on_card:  # the window's one wait of its own (`readers.host_waits`)
            torch.cuda.synchronize(driver.device)
        window_s = time.perf_counter() - t0
    driver.finish()
    def on_device(e) -> bool:
        # a record_function span also shows as a range on the device's
        # timeline; it is no operation
        name = getattr(e, "name", None) or e.key
        return (e.device_type == DeviceType.CUDA and not name.startswith("benchmark.")
                and not getattr(e, "is_user_annotation", False))

    averages = prof.key_averages()
    kernels = {e.key: (e.self_device_time_total * 1e-6, e.count) for e in averages
               if on_device(e) and e.self_device_time_total > 0}
    runtime = {e.key: e.count for e in averages if e.key.startswith("cuda")}
    events = prof.events()
    device = [(e.time_range.start, e.time_range.end, e.name) for e in events if on_device(e)]
    busy_s = _union_length([(a, b) for a, b, _ in device]) * 1e-6
    if not device:
        busy_s = sum(s for s, _ in kernels.values())
    host = [e for e in events if e.device_type == DeviceType.CPU]
    starts = np.asarray([e.time_range.start for e in host], dtype=np.float64)
    ends = np.asarray([e.time_range.end for e in host], dtype=np.float64)
    gaps: tp.Dict[str, float] = {}
    device.sort()
    end = None
    pending = []
    for a, b, _ in device:
        if end is not None and a > end:
            pending.append((end, a))
        end = b if end is None else max(end, b)
    # each of the longest gaps goes to the innermost host operation running
    # at its middle
    pending.sort(key=lambda g: g[0] - g[1])
    for a, b in pending[:1000]:
        mid = 0.5 * (a + b)
        inside = np.nonzero((starts <= mid) & (ends >= mid))[0]
        name = (host[inside[np.argmin(ends[inside] - starts[inside])]].name
                if inside.size else "(no host operation)")
        gaps[name] = gaps.get(name, 0.0) + (b - a) * 1e-6
    breakdown = {
        "device_ops": [[k[:120], s] for k, (s, _) in
                       sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]],
        "idle_gaps": [[k[:120], s] for k, s in sorted(gaps.items(), key=lambda kv: -kv[1])[:10]],
    }
    return types.SimpleNamespace(
        kernels=kernels, runtime=runtime, busy_s=busy_s, window_s=window_s,
        work=merged(driver.work[first:]), breakdown=breakdown,
    )


def compared(readings: tp.Mapping[str, float], limits: tp.Mapping[str, float]
             ) -> tp.Dict[str, dict]:
    """Each number of the output check beside its limit."""
    return {name: {"value": value, "limit": limits.get(name)} for name, value in readings.items()}


def verdict(attempted: int, failed: int, checks: tp.Mapping[str, dict]) -> bool:
    """``correct``: units ran, none failed, and every number compared is
    within its limit (a NaN is within none)."""
    return (attempted > 0 and failed == 0 and bool(checks)
            and all(c["limit"] is not None and c["value"] <= c["limit"]
                    for c in checks.values()))


def run(workload: str, seed: int, seconds: float, trace: bool, device, chips: int,
        t_start: float, bench: tp.Optional[dict] = None,
        traffic_overrides: tp.Optional[dict] = None) -> tp.Tuple[dict, tp.List[str]]:
    """One run of a cell: the result line's object and the check lines."""
    import torch

    bench = load_json(ROOT / "BENCHMARK.json") if bench is None else bench
    config, traffic, limits = cell(bench, workload)
    traffic = dict(traffic, **(traffic_overrides or {}))
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    driver = make_driver(config, traffic, seed, device)
    driver.setup()
    setup_s = time.perf_counter() - t_start

    t0 = time.perf_counter()
    while True:
        driver.step()
        if time.perf_counter() - t0 >= seconds:
            break
    driver.finish()
    window_s = time.perf_counter() - t0
    end_to_end = driver.end_to_end(window_s)
    end_to_end["setup_s"] = setup_s
    window = types.SimpleNamespace(work=merged(driver.work), seconds=window_s,
                                   counters=dict(driver.counters))
    trace_ns = traced(driver, int(traffic["trace_units"])) if trace else None
    memory_peak = int(torch.cuda.max_memory_allocated(device)) if on_card else 0
    attempted, failed = driver.attempted, driver.failed

    driver.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    readings = driver.readings()
    checks = compared(readings, limits)
    correct = verdict(attempted, failed, checks)

    if trace:
        ctx = types.SimpleNamespace(config=config, traffic=traffic, unit=driver.unit,
                                    trace=trace_ns, window=window)
        metrics = {}
        for m in reported(bench, workload, "per_layer"):
            value = reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": end_to_end[m["name"]], "unit": m["unit"]}
                   for m in reported(bench, workload, "end_to_end")}
    info = {
        "platform": "gpu" if on_card else device.type,
        "kind": torch.cuda.get_device_name(device) if on_card else device.type,
        "count": chips,
        "memory_peak_bytes": memory_peak,
    }
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": info}
    if trace:
        info["busy_s"] = trace_ns.busy_s
        info["window_s"] = trace_ns.window_s
        result["breakdown"] = trace_ns.breakdown
    result["checks"] = checks
    lines = [f"check {name}: {c['value']!r} (limit {c['limit']!r})" for name, c in checks.items()]
    lines.append(f"units {attempted}, failed {failed}")
    return result, lines


def forbidden_modules() -> tp.List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def main(argv: tp.Optional[tp.Sequence[str]] = None, t_start: tp.Optional[float] = None) -> int:
    import argparse

    t_start = time.perf_counter() if t_start is None else t_start
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    set_cache_dirs()
    import torch

    bench = load_json(ROOT / "BENCHMARK.json")
    chips = {w["name"]: w for w in bench["workloads"]}[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: {chips} CUDA device(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    result, lines = run(args.workload, args.seed, args.seconds, bool(args.trace),
                        torch.device("cuda", 0), chips, t_start, bench)
    loaded = forbidden_modules()
    if loaded:
        print(f"benchmark: the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0
