"""The controls of the cells' output checks, and the program's readings
beside them, on several seeds in one process:

    python3 benchmark/control.py --workload CELL --seeds 11,12,13 [--seconds S]

For each seed: the cell's inputs and set-up, the program's steps for S
seconds (at least one), then the numbers the run's check compares
(program against the plain reference) and the same numbers for the
control (the reference itself, in the program's place, at the nearest
lower precision the configuration states, or with the guarantee it
states broken: see the driver's control()). One JSON line a seed. The
benchmark's own runs do not run this.
"""
import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import harness  # noqa: E402


def readings(workload, seed, seconds, device="cuda",
             manifest_path=os.path.join(harness.ROOT, "BENCHMARK.json"),
             bench_dir=HERE):
    """One run of the cell through the harness (harness.run_cell, untraced),
    with the control read on the same inputs once the run's checks are."""
    out = {"seed": seed}

    def control(ctx, driver):
        t0 = time.perf_counter()
        out.update(steps=ctx.steps, program=ctx.checks,
                   control=driver.control(ctx), reference_s=ctx.reference_s,
                   control_s=time.perf_counter() - t0)

    harness.run_cell(workload, seed, seconds, 0, device=device,
                     manifest_path=manifest_path, bench_dir=bench_dir,
                     after_checks=control)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=0)
    a = ap.parse_args()
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(harness.CACHE,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(harness.CACHE, "triton")
    for s in a.seeds.split(","):
        print(json.dumps(readings(a.workload, int(s), a.seconds)),
              flush=True)


if __name__ == "__main__":
    main()
