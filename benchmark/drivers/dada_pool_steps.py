"""Driver: a study's pooled denoising, one dada(pool=True) call a step.

The study's samples fall into fixed sets of `samples_per_step` (samples
0-7, 8-15, ...); step k hands dada2_tpu_torch.dada() set k mod the number
of sets, always in the same order (a pooled result depends on the order
of its samples through ties, in DADA2 as in the program, so a repeat has
to be the same call), with pool=True, selfConsist off, the
configuration's error matrix, options and `multithread`, and counts the
set's reads. Once the window has closed, every step must have returned a
result for each of its samples; every sample's split-back result is held
to its own reads and map; every later result of a set is held to the
set's first; and `check_sets` sets drawn from the seed are denoised again
by the plain reference (reference/pool_ref.py) and every result the
window returned for their samples is held to it.
"""
from __future__ import annotations

import importlib.util
import os
import time
from types import SimpleNamespace

import numpy as np

_spec = importlib.util.spec_from_file_location(
    "bench_driver_dada_steps_for_pool",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "dada_steps.py"))
steps = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(steps)

instrument = steps.instrument
release = steps.release
counts = steps.counts


def sets(ctx):
    """The study's pooled sets of sample indices, in call order."""
    per = ctx.mix["samples_per_step"]
    n = len(ctx.inputs["samples"])
    return [list(range(k, min(k + per, n))) for k in range(0, n, per)]


def setup(ctx):
    import dada2_tpu_torch as dt

    ctx.dt = dt
    ctx.__dict__.setdefault("marks", []).append(("program import",
                                                 time.perf_counter()))
    inp = ctx.inputs
    ctx.dereps = [(s[0], steps._derep(dt, *s)) for s in inp["samples"]]
    dev = None if ctx.device == "cuda" else ctx.device

    def call(batch):
        return dt.dada(dict(batch), err=inp["err"], selfConsist=False,
                       pool=bool(ctx.config["pool"]),
                       multithread=ctx.config["multithread"], verbose=False,
                       device=dev, **ctx.config["dada"])

    ctx.call = call
    ctx.results = []
    ctx.set_of_step = []
    # the warm-up: its one sample pooled with itself
    w = inp["warmup"][0]
    call([(f"{w[0]}{k}", steps._derep(dt, *w)) for k in range(2)])


def step(ctx, k):
    s = k % len(sets(ctx))
    batch = [ctx.dereps[i] for i in sets(ctx)[s]]
    out = ctx.call(batch)
    ctx.results.append(([name for name, _ in batch], out))
    ctx.set_of_step.append(s)
    return sum(int(d.abundances.sum()) for _, d in batch)


def checked_sets(ctx):
    """The sets the reference checks: drawn from the seed among those the
    window processed."""
    from generate import rng_of

    seen = sorted(set(ctx.set_of_step))
    k = min(ctx.mix["check_sets"], len(seen))
    pick = rng_of(ctx.seed, 7919).choice(len(seen), k, replace=False)
    return [seen[i] for i in sorted(pick)]


def reference(ctx, s, lam_dtype=None):
    """The reference's results for set s, by sample name: lambdas in
    float64, as the configuration states, or in lam_dtype (the
    control)."""
    from reference import dada_ref, pool_ref

    torch = ctx.torch
    key = (s, str(lam_dtype or torch.float64))
    cache = ctx.__dict__.setdefault("refs", {})
    if key not in cache:
        chosen = [ctx.inputs["samples"][i] for i in sets(ctx)[s]]
        res = pool_ref.dada_pooled(
            [x[1:] for x in chosen], ctx.inputs["err"],
            dada_ref.options(**ctx.config["dada"]), device=ctx.device,
            lam_dtype=lam_dtype or torch.float64)
        cache[key] = {x[0]: r for x, r in zip(chosen, res)}
    return cache[key]


def control(ctx):
    """The control's readings: the reference computed with float32
    lambdas, in the program's place, held to the float64 reference."""
    from reference.compare import dada_gaps

    out = {}
    for s in checked_sets(ctx):
        want = reference(ctx, s)
        for name, got in reference(ctx, s, ctx.torch.float32).items():
            g = dada_gaps(SimpleNamespace(
                clustering=got["clustering"], birth_subs=got["birth_subs"],
                trans=got["subqual"], map=got["map"], pval=got["pval"]),
                want[name])
            out = {k: max(out.get(k, 0), v) for k, v in g.items()}
    return out


def tally_diffs(res, reads) -> int:
    """ASVs of one sample's split-back result that disagree with its own
    map and reads by unique: an abundance other than the reads of the
    uniques mapped to the ASV, no unique mapped to it, or more uniques
    mapped to it than the pooled ASV's unique count (its nunq, n0 and n1
    are the pool's); every ASV where the map does not fit the sample."""
    cl = res.clustering
    k = len(cl)
    m = np.asarray(res.map)
    if m.shape != reads.shape or ((m < -1) | (m >= k)).any():
        return max(k, 1)
    on = m >= 0
    ab = np.zeros(k, np.int64)
    np.add.at(ab, m[on], reads[on])
    nunq = np.bincount(m[on], minlength=k)
    bad = ((cl["abundance"].to_numpy() != ab) | (nunq == 0)
           | (cl["nunq"].to_numpy() < nunq))
    return int(bad.sum())


def verify(ctx):
    from reference.compare import dada_gaps

    worst = {"table_diffs": 0, "map_diffs": 0, "stat_rel_gap": 0.0}
    for s in checked_sets(ctx):
        want = reference(ctx, s)
        for (names, out), t in zip(ctx.results, ctx.set_of_step):
            if t != s or not isinstance(out, dict):
                continue
            for name in names:
                if out.get(name) is not None:
                    g = dada_gaps(out[name], want[name])
                    worst = {k: max(worst[k], g[k]) for k in worst}
    # every sample of every step: its own tallies, and each repeat
    reads = {x[0]: x[2] for x in ctx.inputs["samples"]}
    first = {}
    every = {"tally_diffs": 0, "repeat_diffs": 0, "repeat_rel_gap": 0.0}
    for names, out in ctx.results:
        for name in names:
            res = out.get(name) if isinstance(out, dict) else None
            if res is None:
                continue
            every["tally_diffs"] = max(every["tally_diffs"],
                                       tally_diffs(res, reads[name]))
            if name not in first:
                first[name] = steps._as_reference(res)
                continue
            g = dada_gaps(res, first[name])
            every["repeat_diffs"] = max(every["repeat_diffs"],
                                        g["table_diffs"] + g["map_diffs"])
            every["repeat_rel_gap"] = max(every["repeat_rel_gap"],
                                          g["stat_rel_gap"])
    _, failed = counts(ctx)
    lim = ctx.mix["limits"]
    return [dict(name="missing_results", value=failed, limit=0)] + [
        dict(name=k, value=v, limit=lim[k])
        for k, v in {**worst, **every}.items()]
