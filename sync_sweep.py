"""Find every point where the host blocks on the card in one benchmark step.

    python3 sync_sweep.py [ROOT] [--cells v4_denoise,v4_bimera] [--seed N]
                          [--out FILE] [--probe]

ROOT (default: this script's directory) is a checkout whose
dada2_tpu_torch and benchmark/ are used. For each cell, the benchmark's
generator makes the inputs from the seed and its driver sets up and warms
up the program (benchmark/harness.py, benchmark/drivers/); then one step
runs under torch.cuda.set_sync_debug_mode("warn"), which warns at every
synchronising CUDA call (stream and device synchronise, blocking copies
in either direction, .item(), nonzero). Each warning is attributed to its
site: the innermost frame inside dada2_tpu_torch, and whether the stack
passes through one of the program's counted crossing helpers
(trace.SYNC_HELPERS, or backend_cuda._put / _fetch in a checkout without
it). A site outside every helper is a blocking crossing that the program's
`syncs` counter misses. Prints one line per site and the counters'
deltas over the step, and writes the whole sweep as JSON to FILE (default
chiprun_out/sync_sweep.json). --probe also prints whether
torch.autograd.profiler._is_profiler_enabled is set inside a
torch.profiler session of CUDA activities alone. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback
import warnings
from collections import defaultdict
from types import SimpleNamespace

HERE = os.path.dirname(os.path.abspath(__file__))


def card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def probe(torch):
    from torch.autograd import profiler as P

    out = {"before": bool(P._is_profiler_enabled)}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]):
        out["cuda_only"] = bool(P._is_profiler_enabled)
        out["cuda_only_c"] = bool(torch.autograd._profiler_enabled())
    out["after"] = bool(P._is_profiler_enabled)
    return out


def setup_cell(root, workload, seed, device="cuda"):
    """(driver, ctx) of a benchmark cell of the checkout at root: inputs
    generated from the seed, the program set up and warmed up by the
    cell's driver, as benchmark/harness.py::run_cell does (device "cpu"
    for a dry run)."""
    import torch

    bench = os.path.join(root, "benchmark")
    for p in (bench, root):
        if p not in sys.path:
            sys.path.insert(0, p)
    import harness

    manifest = harness.load_json(os.path.join(root, "BENCHMARK.json"))
    cell, config, mix, driver, _, _ = harness.cell_of(manifest, workload,
                                                      bench)
    generate = harness.load_module(os.path.join(bench, "generate.py"),
                                   "bench_generate")
    ctx = SimpleNamespace(workload=workload, seed=seed, seconds=0, trace=0,
                          device=device, config=config, mix=mix,
                          torch=torch, marks=[])
    ctx.inputs = generate.generate(config, mix, seed)
    driver.setup(ctx)
    if device == "cuda":
        torch.cuda.synchronize()
    return driver, ctx


def sweep_cell(root, workload, seed):
    import torch

    driver, ctx = setup_cell(root, workload, seed)
    from dada2_tpu_torch import trace

    helpers = set(getattr(trace, "SYNC_HELPERS", ("_put", "_fetch")))
    pkg = os.path.join(root, "dada2_tpu_torch") + os.sep
    sites = defaultdict(lambda: {"n": 0, "counted": 0, "chain": None})
    total = [0]

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchronizing CUDA operation" not in str(message):
            return
        total[0] += 1
        stack = traceback.extract_stack()[:-1]
        own = [f for f in stack if f.filename.startswith(pkg)]
        counted = any(f.name in helpers for f in own)
        # the site: the innermost frame of the program outside the helpers
        own = [f for f in own if f.name not in helpers
               and os.path.basename(f.filename) != "trace.py"] or own
        if own:
            inner = own[-1]
            key = (f"{os.path.relpath(inner.filename, root)}:{inner.lineno}"
                   f" {inner.name}")
        else:
            key = f"{filename}:{lineno} (outside the program)"
        s = sites[key]
        s["n"] += 1
        s["counted"] += counted
        if s["chain"] is None:
            s["chain"] = [f"{os.path.relpath(f.filename, root)}:{f.lineno} "
                          f"{f.name}" for f in own[-5:]]

    c0 = dict(trace.COUNTERS.as_dict())
    old = warnings.showwarning
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            driver.step(ctx, 0)
        finally:
            torch.cuda.set_sync_debug_mode(0)
            warnings.showwarning = old
    dt = time.perf_counter() - t0
    c1 = dict(trace.COUNTERS.as_dict())
    deltas = {k: c1[k] - c0.get(k, 0) for k in c1
              if isinstance(c1[k], (int, float))}
    driver.release(ctx)
    return {"workload": workload, "seed": seed, "step_s": dt,
            "warnings": total[0], "counters": deltas,
            "sites": dict(sorted(sites.items(), key=lambda kv: -kv[1]["n"]))}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root", nargs="?", default=HERE)
    ap.add_argument("--cells", default="v4_denoise,v4_bimera")
    ap.add_argument("--seed", type=int, default=3_000_000_019)
    ap.add_argument("--out", default=os.path.join(HERE, "chiprun_out",
                                                  "sync_sweep.json"))
    ap.add_argument("--probe", action="store_true")
    a = ap.parse_args(argv)
    import torch

    root = os.path.abspath(a.root)
    out = {"card": card(), "torch": torch.__version__,
           "cuda": torch.version.cuda, "cells": []}
    print(f"card: {out['card']}; torch {out['torch']}, CUDA {out['cuda']}",
          flush=True)
    if a.probe:
        out["probe"] = probe(torch)
        print(f"profiler flag: {out['probe']}", flush=True)
    for w in a.cells.split(","):
        res = sweep_cell(root, w, a.seed)
        out["cells"].append(res)
        print(f"[{w}] step {res['step_s']:.3f} s, {res['warnings']} "
              f"synchronising calls; counters: {res['counters']}",
              flush=True)
        for key, s in res["sites"].items():
            mark = ("counted" if s["counted"] == s["n"] else
                    f"UNCOUNTED {s['n'] - s['counted']}")
            print(f"  {s['n']:7d} {mark:>16}  {key}  <- "
                  + " <- ".join(reversed(s["chain"][:-1] or [])),
                  flush=True)
    os.makedirs(os.path.dirname(a.out), exist_ok=True)
    with open(a.out, "w") as fh:
        json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
