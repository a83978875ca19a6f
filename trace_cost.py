"""What the program's span recorder costs when on, and whether it changes a
result, on one card.

    python3 trace_cost.py [--cells v4_denoise,fl16s_denoise] [--seed N]
                          [--reps 3] [--out FILE] [--root DIR --device cpu]

For each cell, the benchmark's generator makes the inputs from the seed
and its driver sets up and warms up the program (sync_sweep.setup_cell);
then the same step (the first batch of the study) runs 2 x reps times,
alternating tracing off and on (trace.enable(); off first, then on
first, and so on). Prints each step's seconds, the medians, the spans a
traced step records with their sync.* seconds and the per-sample syncs
over compares, and whether every traced step's results equal the first
untraced step's bit for bit (clustering, birth_subs, map, pval, trans of
every sample). Writes the whole as JSON to FILE (default
chiprun_out/trace_cost.json). Needs a CUDA card; --root (a checkout, or
a copy of BENCHMARK.json and benchmark/ with small mixes) and --device
cpu make a dry run on the CPU.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def same(a, b) -> bool:
    import numpy as np

    return (a.clustering.equals(b.clustering)
            and a.birth_subs.equals(b.birth_subs)
            and np.array_equal(a.map, b.map)
            and np.array_equal(a.pval, b.pval, equal_nan=True)
            and np.array_equal(a.trans, b.trans))


def cost_cell(workload, seed, reps, root=HERE, device="cuda"):
    import torch

    from sync_sweep import setup_cell

    driver, ctx = setup_cell(root, workload, seed, device)
    # what set-up made stays, as in the benchmark's harness
    gc.collect()
    gc.freeze()

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    from dada2_tpu_torch import trace

    times = {False: [], True: []}
    traced = []
    first = None
    identical = True
    for r in range(reps):
        for on in ((False, True) if r % 2 == 0 else (True, False)):
            trace.reset()
            if on:
                trace.enable()
            sync()
            t0 = time.perf_counter()
            driver.step(ctx, 0)
            sync()
            times[on].append(time.perf_counter() - t0)
            trace.disable()
            _, out = ctx.results[-1]
            if not on and first is None:
                first = out
            elif first is not None:
                identical &= all(same(out[k], first[k]) for k in first)
            if on:
                spans = trace.spans()
                samples = [s for s in spans if s.name == "sample"]
                syncs = sum(s.counters.get("syncs", 0) for s in samples)
                comps = sum(s.counters.get("compares", 0) for s in samples)
                traced.append(dict(
                    spans=len(spans),
                    sync_s=sum(s.seconds for s in spans
                               if s.name.startswith("sync.")),
                    syncs_per_compare=syncs / comps if comps else None))
            ctx.results.clear()
    trace.reset()
    driver.release(ctx)
    gc.unfreeze()
    off, on = statistics.median(times[False]), statistics.median(times[True])
    return {"workload": workload, "seed": seed, "off_s": times[False],
            "on_s": times[True], "median_off_s": off, "median_on_s": on,
            "cost_pct": 100.0 * (on - off) / off, "traced": traced,
            "identical": identical}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", default="v4_denoise,fl16s_denoise")
    ap.add_argument("--seed", type=int, default=3_000_000_019)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default=os.path.join(HERE, "chiprun_out",
                                                  "trace_cost.json"))
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    from sync_sweep import card

    out = {"card": card(), "cells": []}
    print(f"card: {out['card']}", flush=True)
    for w in a.cells.split(","):
        res = cost_cell(w, a.seed, a.reps, os.path.abspath(a.root),
                        a.device)
        out["cells"].append(res)
        print(json.dumps(res), flush=True)
    os.makedirs(os.path.dirname(a.out), exist_ok=True)
    with open(a.out, "w") as fh:
        json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
