"""Driver: a study's chimera removal, one remove_bimera_denovo() call a
step.

Each step hands dada2_tpu_torch.remove_bimera_denovo() the study's
sequence table (samples x ASVs) with the configuration's method and
settings; the ASVs it drops are its bimera flags. Once the window has
closed, every step's flags are held to the plain reference's
(reference/bimera_ref.py), computed once over the whole table.
"""
from __future__ import annotations

import gc
import time

import numpy as np


def _table(counts, seqs):
    import pandas as pd

    return pd.DataFrame(counts, columns=list(seqs),
                        index=[f"s{k}" for k in range(len(counts))])


def setup(ctx):
    import dada2_tpu_torch as dt

    ctx.dt = dt
    ctx.__dict__.setdefault("marks", []).append(("program import",
                                                 time.perf_counter()))
    inp = ctx.inputs
    ctx.table = _table(inp["counts"], inp["seqs"])
    dev = None if ctx.device == "cuda" else ctx.device
    params = dict(ctx.config["chimera"])
    method = params.pop("method")

    def call(table):
        return dt.remove_bimera_denovo(table, method=method, verbose=False,
                                       device=dev, **params)

    ctx.call = call
    ctx.flags = []
    w = ctx.mix["warmup_asvs"]
    call(_table(inp["counts"][:, :w], inp["seqs"][:w]))


def step(ctx, k):
    out = ctx.call(ctx.table)
    kept = set(out.columns)
    ctx.flags.append(np.array([s not in kept for s in ctx.table.columns])
                     if kept <= set(ctx.table.columns) else None)
    return 1


def instrument(ctx, rec):
    """Spans around the program's phases (chimera.pairs, .stats, .vote)."""
    from dada2_tpu_torch import trace

    rec.wrap_context(trace.PhaseTimer, "__call__")


def release(ctx):
    ctx.call = None
    gc.collect()
    if ctx.device == "cuda":
        ctx.torch.cuda.empty_cache()


def counts(ctx):
    return len(ctx.flags), sum(f is None for f in ctx.flags)


def reference(ctx, gapless=False):
    """The reference's flags: banded alignments, as the configuration
    states, or gapless ones (the control)."""
    from reference import bimera_ref

    cache = ctx.__dict__.setdefault("refs", {})
    if gapless not in cache:
        params = dict(ctx.config["chimera"])
        params.pop("method")
        cache[gapless] = bimera_ref.bimera_flags(
            ctx.inputs["counts"], ctx.inputs["seqs"], device=ctx.device,
            gapless=gapless, **params)
    return cache[gapless]


def control(ctx):
    """The control's readings: the reference with gapless alignments, in
    the program's place, held to the banded reference."""
    want = reference(ctx)
    return {"flags_differ": int((reference(ctx, True) != want).sum()),
            "flagged": int(want.sum())}


def verify(ctx):
    want = reference(ctx)
    worst = max((int((f != want).sum()) for f in ctx.flags if f is not None),
                default=0)
    return [dict(name="missing_results", value=counts(ctx)[1], limit=0),
            dict(name="flags_differ", value=worst,
                 limit=ctx.mix["limits"]["flags_differ"])]
