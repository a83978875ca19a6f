"""Driver: a study's denoising, one dada() call a step.

Each step hands dada2_tpu_torch.dada() the next `samples_per_step` of the
study's samples in turn (selfConsist off, the configuration's error
matrix, options and `multithread` threads) and counts their reads; each
pass over the study rotates the batch by one place, so a sample that
comes again sits at another position in its batch. Once the window has
closed, every step must have returned a result for each of its samples;
every result is held to its sample's reads and to its own map (each
ASV's abundance and unique count are those of the uniques mapped to it,
n0 + n1 within the abundance); every result of a sample that came again
is held to its first; and `check_samples` samples drawn from the seed
are denoised again by the plain reference (reference/dada_ref.py) and
every result the window returned for them is held to it.
"""
from __future__ import annotations

import gc
import time
from types import SimpleNamespace

import numpy as np


def _derep(dt, name, seqs, ab, quals):
    return dt.Derep(uniques=dict(zip(seqs, ab.tolist())), quals=quals,
                    map=np.zeros(0, np.int64), name=name)


def setup(ctx):
    import dada2_tpu_torch as dt

    ctx.dt = dt
    ctx.__dict__.setdefault("marks", []).append(("program import",
                                                 time.perf_counter()))
    inp, mix = ctx.inputs, ctx.mix
    ctx.dereps = [(s[0], _derep(dt, *s)) for s in inp["samples"]]
    dev = None if ctx.device == "cuda" else ctx.device
    opts = dict(ctx.config["dada"])

    def call(batch):
        return dt.dada(dict(batch), err=inp["err"], selfConsist=False,
                       multithread=ctx.config["multithread"], verbose=False,
                       device=dev, **opts)

    ctx.call = call
    ctx.results = []
    call([(s[0], _derep(dt, *s)) for s in inp["warmup"]])


def step(ctx, k):
    per = ctx.mix["samples_per_step"]
    n = len(ctx.dereps)
    batch = [ctx.dereps[(k * per + i) % n] for i in range(per)]
    r = (k * per // n) % per          # one place further each pass
    batch = batch[r:] + batch[:r]
    out = ctx.call(batch)
    ctx.results.append(([name for name, _ in batch], out))
    return sum(int(d.abundances.sum()) for _, d in batch)


def instrument(ctx, rec):
    """Spans around the program's phases, its per-sample call and its
    compare backend; each compare's inputs are kept for the B1 roofline."""
    import importlib

    from dada2_tpu_torch import trace
    from dada2_tpu_torch.core.backend_cuda import CudaBackend

    dada_mod = importlib.import_module("dada2_tpu_torch.dada")

    ctx.compares = []
    rec.wrap_context(trace.PhaseTimer, "__call__")
    rec.wrap(dada_mod, "dada_uniques", "dada.sample")
    orig = CudaBackend.compare

    def compare(be, center, skip, opts, err, use_kmers, kdist_cutoff,
                *a, **kw):
        ctx.compares.append(SimpleNamespace(
            seqs=be.rs.seqs, lens=be.rs.lens, center=int(center),
            skip=np.array(skip, dtype=bool), use_kmers=bool(use_kmers),
            cutoff=float(kdist_cutoff), band=int(opts.BAND_SIZE),
            gapless=bool(opts.GAPLESS)))
        return orig(be, center, skip, opts, err, use_kmers, kdist_cutoff,
                    *a, **kw)

    CudaBackend.compare = compare
    rec._undo.append((CudaBackend, "compare", orig))
    rec.wrap(CudaBackend, "compare", "backend.compare")
    rec.wrap(CudaBackend, "cluster_stats_all", "backend.cluster_stats_all")
    rec.wrap(CudaBackend, "subs_pairs", "backend.subs_pairs")
    ctx.counters0 = dict(trace.COUNTERS.as_dict())
    rec.on_stop.append(lambda: setattr(ctx, "counters1",
                                       dict(trace.COUNTERS.as_dict())))


def release(ctx):
    ctx.call = None
    gc.collect()
    if ctx.device == "cuda":
        ctx.torch.cuda.empty_cache()


def counts(ctx):
    attempted = sum(len(names) for names, _ in ctx.results)
    failed = sum(1 for names, out in ctx.results for n in names
                 if not isinstance(out, dict) or out.get(n) is None)
    return attempted, failed


def checked_names(ctx):
    """The samples the reference checks: drawn from the seed among those
    the window processed."""
    from generate import rng_of

    seen = []
    for names, _ in ctx.results:
        for n in names:
            if n not in seen:
                seen.append(n)
    k = min(ctx.mix["check_samples"], len(seen))
    pick = rng_of(ctx.seed, 7919).choice(len(seen), k, replace=False)
    return [seen[i] for i in sorted(pick)]


def reference(ctx, name, lam_dtype=None):
    """The reference's result for one sample: lambdas in float64, as the
    configuration states, or in lam_dtype (the control)."""
    from reference import dada_ref

    torch = ctx.torch
    key = (name, str(lam_dtype or torch.float64))
    cache = ctx.__dict__.setdefault("refs", {})
    if key not in cache:
        s = {x[0]: x for x in ctx.inputs["samples"]}[name]
        cache[key] = dada_ref.dada_sample(
            s[1], s[2], s[3], ctx.inputs["err"],
            dada_ref.options(**ctx.config["dada"]), device=ctx.device,
            lam_dtype=lam_dtype or torch.float64)
    return cache[key]


def control(ctx):
    """The control's readings: the reference computed with float32
    lambdas, in the program's place, held to the float64 reference."""
    from reference.compare import dada_gaps

    out = {}
    for name in checked_names(ctx):
        got = reference(ctx, name, ctx.torch.float32)
        g = dada_gaps(SimpleNamespace(
            clustering=got["clustering"], birth_subs=got["birth_subs"],
            trans=got["subqual"], map=got["map"], pval=got["pval"]),
            reference(ctx, name))
        out = {k: max(out.get(k, 0), v) for k, v in g.items()}
    return out


def tally_diffs(res, reads) -> int:
    """ASVs of one result that disagree with its own map and the sample's
    reads by unique: abundance or unique count other than those of the
    uniques mapped to the ASV, or n0 + n1 above the abundance; every ASV
    where the map does not fit the sample."""
    cl = res.clustering
    k = len(cl)
    m = np.asarray(res.map)
    if m.shape != reads.shape or ((m < -1) | (m >= k)).any():
        return max(k, 1)
    on = m >= 0
    ab = np.zeros(k, np.int64)
    np.add.at(ab, m[on], reads[on])
    nunq = np.bincount(m[on], minlength=k)
    a = cl["abundance"].to_numpy()
    bad = ((a != ab) | (cl["nunq"].to_numpy() != nunq)
           | (cl["n0"].to_numpy() + cl["n1"].to_numpy() > a))
    return int(bad.sum())


def _as_reference(res):
    return {"clustering": res.clustering, "birth_subs": res.birth_subs,
            "subqual": res.trans, "map": res.map, "pval": res.pval}


def verify(ctx):
    from reference.compare import dada_gaps

    worst = {"table_diffs": 0, "map_diffs": 0, "stat_rel_gap": 0.0}
    for name in checked_names(ctx):
        want = reference(ctx, name)
        for names, out in ctx.results:
            if name in names and isinstance(out, dict) and name in out:
                g = dada_gaps(out[name], want)
                worst = {k: max(worst[k], g[k]) for k in worst}
    # every sample of every step: its own tallies, and each repeat
    reads = {s[0]: s[2] for s in ctx.inputs["samples"]}
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
                first[name] = _as_reference(res)
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
