"""Control runs of a cell's output check, from the root of a checkout::

    python3 -m benchmark.control --workload <name> --seeds 11 12 13 [--variant tf32]

Each seed's inputs are made as a run makes them; in place of the program
the plain reference produces the outputs, at the precision below the one
the configuration states (``tf32``: float32 products in TF32), or, for
the training cells, with half of each batch left out and the mean taken
over the rest (``half_batch``) or with the state never updated
(``unchanged``).  The check then compares those outputs
with the float32 reference, and each seed prints one JSON line of its
numbers beside the cell's limits and the run's verdict on them,
``correct`` (`harness.verdict`, the control's outputs counted as one unit
that did not fail).  The benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
import typing as tp

from benchmark import harness


def readings(workload: str, seed: int, variant: str, device,
             traffic_overrides: tp.Optional[dict] = None) -> tp.Dict[str, tp.Any]:
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    config, traffic, limits = harness.cell(bench, workload)
    traffic = dict(traffic, **(traffic_overrides or {}))
    driver = harness.make_driver(config, traffic, seed, device)
    t0 = time.perf_counter()
    outputs = driver.control(variant)
    checks = harness.compared(driver.readings(outputs), limits)
    return {"workload": workload, "seed": seed, "variant": variant,
            "correct": harness.verdict(1, 0, checks), "checks": checks,
            "seconds": time.perf_counter() - t0}


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--variant", default="tf32", choices=("tf32", "half_batch", "unchanged"))
    args = parser.parse_args(argv)
    harness.set_cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("benchmark.control: no CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        print(json.dumps(readings(args.workload, seed, args.variant, torch.device("cuda", 0))),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
