"""The per-layer readers on a canned trace, and the harness's choice of
metrics per cell."""

import json
import types
from pathlib import Path

import pytest

from benchmark import harness, readers, yardstick

ROOT = Path(__file__).resolve().parents[2]
CONFIG = json.loads((ROOT / "benchmark" / "configs" / "ani2x.json").read_text())
WORK = {"atoms": 1000.0, "atoms.H": 600.0, "atoms.O": 400.0, "angular_lanes": 18000.0,
        "angular_pairs": 150000.0, "k3b_rows": 5000.0, "radial_lanes": 55000.0,
        "lanes.refresh": 70000.0, "steps": 10.0, "batches": 2.0}


def context(**trace) -> types.SimpleNamespace:
    base = dict(kernels={}, runtime={}, busy_s=0.75, window_s=1.0, work=WORK)
    base.update(trace)
    return types.SimpleNamespace(
        config=CONFIG, traffic={"members": 1}, unit="steps",
        trace=types.SimpleNamespace(**base),
        window=types.SimpleNamespace(work=WORK, seconds=2.0, counters={"rebuilds": 3}))


def test_device_idle():
    assert readers.device_idle(context()) == pytest.approx(25.0)
    assert readers.device_idle(context(busy_s=0.0)) is None


def test_launches_and_waits():
    ctx = context(runtime={"cudaLaunchKernel": 300, "cudaLaunchKernelExC": 20,
                           "cudaStreamSynchronize": 40, "cudaMemcpyAsync": 11,
                           "cudaDeviceSynchronize": 1, "cudaMalloc": 7})
    assert readers.launches(ctx, "steps") == pytest.approx(32.0)
    assert readers.launches(ctx, "batches") == pytest.approx(160.0)
    # 40 + 11 + 1 less the window's closing synchronize, over 10 steps
    assert readers.host_waits(ctx, "steps") == pytest.approx(5.1)
    assert readers.launches(context(), "steps") is None


def test_angular_roofline():
    k3 = "void angular_aev_kernel<8, 4>(float const*, ...)"
    k3b = "void angular_aev_bwd_kernel<8, 4>(float const*, ...)"
    ctx = context(kernels={k3: (0.002, 10), k3b: (0.003, 10), "elementwise_kernel": (1.0, 99)})
    nbytes = yardstick.angular_bytes(CONFIG, WORK)
    bound = (yardstick.angular_bound_s(150000.0, 18000.0, 8, 4, nbytes["k3"], False)
             + yardstick.angular_bound_s(150000.0, 18000.0, 8, 4, nbytes["k3b"], True))
    assert readers.angular_roofline(ctx, second_order=False) == pytest.approx(100 * bound / 0.005)
    k3bb = yardstick.k3bb_bound_s(150000.0, 18000.0, 8, 4, nbytes["k3bb"])
    ctx.trace.kernels["void angular_aev_bwd_bwd_kernel<8, 4>(...)"] = (0.004, 10)
    assert readers.angular_roofline(ctx, second_order=True) == pytest.approx(
        100 * (bound + k3bb) / 0.009)
    assert readers.angular_roofline(context(), second_order=False) is None


def test_refresh_roofline():
    ctx = context(kernels={"bucket_select_fwd_kernel": (0.001, 10),
                           "bucket_select_bwd_kernel": (0.001, 10)})
    nbytes = 16 * 70000.0 + 12 * 1000.0
    assert readers.refresh_roofline(ctx) == pytest.approx(
        100 * 2 * nbytes / yardstick.PEAK_HBM_BYTES / 0.002)


def test_mfu_and_rebuilds():
    in_dim = 1008
    macs_h = in_dim * 256 + 256 * 192 + 192 * 160 + 160
    macs_o = in_dim * 192 + 192 * 160 + 160 * 128 + 128
    flops = 2 * 2 * (600 * macs_h + 400 * macs_o) * 8 + yardstick.aev_flops(CONFIG, WORK, 1)
    assert readers.mfu(context(), products=2, aev_order=1, members=8) == pytest.approx(
        100 * flops / (2.0 * yardstick.PEAK_F32_FLOPS))
    assert readers.rebuilds_per_kstep(context()) == pytest.approx(300.0)


def test_each_metric_has_a_reader():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        assert callable(harness.reader(m["name"]))


def test_reported_metrics():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    e2e = {m["name"] for m in harness.reported(bench, "ani2x-ef-comp6", "end_to_end")}
    assert e2e == {"conformers_per_s", "ef_batch_ms_p95", "setup_s"}
    layers = {m["name"] for m in harness.reported(bench, "ani2x-ef-comp6", "per_layer")}
    assert "mfu.ef" in layers and "mfu.md" not in layers
