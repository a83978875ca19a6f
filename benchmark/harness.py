"""Run one cell of BENCHMARK.json once and print its result line.

    python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1

Everything a cell needs is found by name: the cell's configuration file
(BENCHMARK.json "configs"), its traffic mix benchmark/mixes/<traffic>.json,
the driver the mix names, benchmark/drivers/<driver>.py, and one reader
per metric, benchmark/metrics/<metric>.py. A run generates its inputs from
the seed (generate.py), lets the driver set up and warm up the program,
runs the driver's steps until --seconds have passed (the step running
then is finished and counted), and checks the outputs against the plain
reference (reference/) once the window has closed. With --trace 1 the
window is one step, run under torch.profiler and the benchmark's spans
(the traced window), and the line carries the per-layer metrics instead
of the end-to-end ones.
"""
from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import sys
import time
from types import SimpleNamespace

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "dada2_tpu")
CACHE = os.path.join(HERE, ".cache")


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(path):
    with open(path) as fh:
        return json.load(fh)


def cell_of(manifest, workload, bench_dir=HERE):
    """(cell, config, mix, driver module, end-to-end metric entries,
    per-layer metric entries) of a cell, all found by name."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}")
    cell = cells[workload]
    conf = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    config = load_json(os.path.join(os.path.dirname(bench_dir), conf["file"]))
    mix = load_json(os.path.join(bench_dir, "mixes", cell["traffic"] + ".json"))
    driver = load_module(os.path.join(bench_dir, "drivers",
                                      mix["driver"] + ".py"),
                         "bench_driver_" + mix["driver"])
    e2e = [m for m in manifest["end_to_end"]
           if workload in m.get("workloads", [workload])]
    moved = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"]
             if workload in m.get("workloads", [workload] if m["moves"]
                                  in moved else [])]
    return cell, config, mix, driver, e2e, layer


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def device_info(torch, count):
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count,
            "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(d)
                                         for d in range(count)))}


def card_limits():
    """(power limit in W, max SM clock in MHz) as nvidia-smi reads them,
    or (None, None)."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit,clocks.max.sm",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30).stdout
        pw, clk = (float(x) for x in out.strip().split(","))
        return pw, clk
    except (OSError, ValueError, subprocess.SubprocessError):
        return None, None


def run_cell(workload, seed, seconds, trace, device="cuda",
             manifest_path=os.path.join(ROOT, "BENCHMARK.json"),
             bench_dir=HERE, after_checks=None):
    """One run of a cell: returns (result dict, check lines). device
    "cpu" skips the look for a card (the harness's own tests).
    after_checks(ctx, driver), where given, runs once the checks are
    read (control.py reads the controls there)."""
    t_start = time.perf_counter()
    marks = [("start", t_start)]
    manifest = load_json(manifest_path)
    cell, config, mix, driver, e2e, layer = cell_of(manifest, workload,
                                                    bench_dir)
    import torch

    if device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: torch.cuda.is_available() is "
                             "false")
        if torch.cuda.device_count() < cell["chips"]:
            raise SystemExit(f"the cell needs {cell['chips']} cards, "
                             f"{torch.cuda.device_count()} found")
        torch.zeros(1, device="cuda")          # the card's context
    marks.append(("torch", time.perf_counter()))
    sys.path.insert(0, os.path.dirname(bench_dir))
    sys.path.insert(0, bench_dir)
    generate = load_module(os.path.join(bench_dir, "generate.py"),
                           "bench_generate")

    ctx = SimpleNamespace(
        workload=workload, seed=seed, seconds=seconds, trace=trace,
        device=device, config=config, mix=mix, torch=torch, marks=marks)
    ctx.inputs = generate.generate(config, mix, seed)
    marks.append(("inputs", time.perf_counter()))
    driver.setup(ctx)
    if device == "cuda":
        torch.cuda.synchronize()
    marks.append(("program set-up", time.perf_counter()))
    # what set-up made stays: later collections need not walk it
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start

    rec = prof = None
    if trace:
        from tracing import Recorder

        rec = Recorder()
        driver.instrument(ctx, rec)
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        prof.__enter__()
        torch.cuda._sleep(1000)
        marker = time.perf_counter()
        torch.cuda.synchronize()
    steps = []
    w0 = time.perf_counter()
    # a traced run's window is one step: reading the trace of a whole
    # window would take longer than the run may
    while not steps or (not trace and time.perf_counter() - w0 < seconds):
        t0 = time.perf_counter()
        if rec is None:
            units = driver.step(ctx, len(steps))
        else:
            with rec.span("step"):
                units = driver.step(ctx, len(steps))
        steps.append(dict(t0=t0, t1=time.perf_counter(), units=units))
    w1 = steps[-1]["t1"]
    dev = None
    t_read = time.perf_counter()
    if trace:
        prof.__exit__(None, None, None)
        rec.undo()
        from tracing import device_trace

        dev = device_trace(prof, marker, (w0, w1),
                           lambda n: "spin" in n.lower())
    info = (device_info(torch, cell["chips"]) if device == "cuda" else
            {"platform": "cpu", "kind": "cpu", "count": 1,
             "memory_peak_bytes": 0})
    run = SimpleNamespace(
        ctx=ctx, setup_s=setup_s, window=(w0, w1), steps=steps, rec=rec,
        traced_steps=1 if trace else 0,
        dev=dev, card=card_limits() if trace and device == "cuda" else
        (None, None), sm_count=(torch.cuda.get_device_properties(0)
                                .multi_processor_count
                                if device == "cuda" else None))
    metrics = {}
    for m in (layer if trace else e2e):
        reader = load_module(os.path.join(bench_dir, "metrics",
                                          m["name"] + ".py"),
                             "bench_metric_" + m["name"].replace(".", "_"))
        value = reader.read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    launched = []
    if trace and dev is not None:
        from tracing import idle_gaps, launched_by

        info["busy_s"] = dev["busy_s"]
        info["window_s"] = dev["window_s"]
        top = sorted(dev["by_kernel"].items(), key=lambda kv: -kv[1])[:10]
        breakdown = {"device_ops": [[k, v] for k, v in top],
                     "idle_gaps": idle_gaps(dev, rec.spans)}
        launched = [
            "device s by the span that launched it (" f"{dev['linked']} of "
            f"{len(dev['kernels'])} kernels by their launch call, the rest "
            "by their start): " + ", ".join(
                f"{k} {v!r}" for k, v in launched_by(dev, rec.spans))]
    elif trace:
        info["busy_s"] = info["window_s"] = None
        breakdown = None
    t_read = time.perf_counter() - t_read
    # the trace's events and spans are read: free them before the
    # reference, whose collections would walk them
    prof = rec = run = dev = None
    ctx.compares = None
    driver.release(ctx)
    gc.collect()
    t_ref = time.perf_counter()
    checks = driver.verify(ctx)
    t_ref = time.perf_counter() - t_ref
    attempted, failed = driver.counts(ctx)
    if after_checks is not None:
        ctx.steps, ctx.reference_s = len(steps), t_ref
        ctx.checks = {c["name"]: c["value"] for c in checks}
        after_checks(ctx, driver)
    found = forbidden_modules()
    if found:
        raise SystemExit("loaded in this process: " + ", ".join(found))
    result = {"correct": all(c["value"] <= c["limit"] for c in checks)
              and failed == 0,
              "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": info}
    if trace and breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {c["name"]: {"value": c["value"],
                                    "limit": c["limit"]} for c in checks}
    lines = [f"set-up {setup_s:.3f} s ("
             + ", ".join(f"{b[0]} {b[1] - a[1]:.3f}"
                         for a, b in zip(marks, marks[1:]))
             + "); steps (s): "
             + " ".join(f"{s['t1'] - s['t0']:.3f}" for s in steps)
             + f"; metrics and trace read {t_read:.3f} s; reference "
             f"{t_ref:.3f} s"]
    lines += launched
    lines += [f"check {c['name']}: {c['value']!r} (limit {c['limit']!r})"
              for c in checks]
    return result, lines


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    # build and kernel caches at fixed paths inside the checkout
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    try:
        result, lines = run_cell(a.workload, a.seed, a.seconds, a.trace)
    except SystemExit as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    sys.stderr.write("\n".join(lines) + "\n")
    sys.stderr.flush()
    print(json.dumps(result))
    return 0
