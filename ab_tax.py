"""Time the taxonomy classifier of a checkout of this repo on one card, for
comparing two checkouts.

    python3 ab_tax.py [ROOT] [--reps N]

ROOT (default: this script's directory) is a checkout whose
dada2_tpu_torch is imported. The inputs are chip_smoke.py phase 15b's,
made here from seed 15 and in-repo data, the same for every checkout: a
synthetic six-rank training set of 3,000 genera x 4 references (~1,450
nt, mutated from tests/extdata/ten_16s.100.fa.gz) and 2,000 V4 reads
(253 nt, half reverse-complemented). Measured:
  - assign_taxonomy(tryRC=True, outputBootstraps=True) on the card: wall
    seconds and the seconds of each taxonomy.* phase (trace.PHASES);
  - the lgk build on the host alone (_build_lgk), with cProfile's top
    functions by own time;
  - one batch of 256 reads through _score_batch: the call (CUDA events
    around it, its host work and fetches included, N calls per reading,
    two readings), the device work alone (CUDA events around
    _score_device on inputs already on the card, where the checkout has
    it) and the device time by kernel under torch.profiler, this
    process's only profile; with a checksum of the three outputs.
Prints the card's nvidia-smi name and power limit, then one JSON line.
Needs a CUDA card. For parent against change, unpack the parent with `git
archive` into a git-ignored directory and run parent, change, change,
parent in one command.
"""
from __future__ import annotations

import cProfile
import hashlib
import io
import json
import os
import pstats
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def events_ms(torch, fn, reps):
    """Mean ms per call of fn over reps calls, CUDA events, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def main(argv) -> int:
    reps = 10
    if "--reps" in argv:
        k = argv.index("--reps")
        reps = int(argv[k + 1])
        argv = argv[:k] + argv[k + 2:]
    root = os.path.abspath(argv[0]) if argv else HERE
    sys.path.insert(0, HERE)
    import chip_smoke as cs

    sys.path.insert(0, root)
    import numpy as np
    import torch

    import dada2_tpu_torch as dt
    from dada2_tpu_torch import taxonomy as tt

    if not torch.cuda.is_available():
        print("ab_tax: no CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)
    rng = np.random.default_rng(15)
    out = dict(root=root, card=card)
    with tempfile.TemporaryDirectory() as tmp:
        fa = os.path.join(tmp, "train.fa")
        refs = cs.synthetic_train_set(rng, fa)
        queries, _ = cs.v4_queries(rng, refs, 2000)
        dt.PHASES.reset()
        t0 = time.time()
        dt.assign_taxonomy(queries, fa, tryRC=True, outputBootstraps=True,
                           device="cuda")
        torch.cuda.synchronize()
        out["assign_taxonomy_s"] = time.time() - t0
        out["phases_s"] = dt.PHASES.as_dict()
        refs_s, r2g, levels = tt.load_reference(fa)
    prof = cProfile.Profile()
    t0 = time.time()
    lgk = prof.runcall(tt._build_lgk, refs_s, r2g, len(levels))
    out["lgk_build_s"] = time.time() - t0
    text = io.StringIO()
    pstats.Stats(prof, stream=text).sort_stats("tottime").print_stats(8)
    out["lgk_build_profile"] = [
        line.strip() for line in text.getvalue().splitlines()
        if line.strip()[:1].isdigit()][:8]
    G = len(levels)
    lgk_dev = tt.device_lgk(lgk, "cuda")
    _, fwd, u, _, _ = cs.score_batches(tt, queries[:256])[0]
    call = lambda: tt._score_batch(fwd, lgk_dev, u, G)  # noqa: E731
    out["call_ms"] = [events_ms(torch, call, reps) for _ in range(2)]
    if hasattr(tt, "_score_device"):
        A = max(max(len(a) for a in fwd), 8)
        karr = np.zeros((len(fwd), A), np.int64)
        for i, a in enumerate(fwd):
            karr[i, : len(a)] = a
        args = (torch.from_numpy(karr).cuda(),
                torch.tensor([len(a) for a in fwd], dtype=torch.int32,
                             device="cuda"), u.cuda(), lgk_dev, 1 << 27)
        out["device_ms"] = [events_ms(torch, lambda: tt._score_device(*args),
                                      reps) for _ in range(2)]
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as p:
        res = call()
        torch.cuda.synchronize()
    by_name = {}
    for e in p.events():
        if e.device_type.name == "CUDA":
            us = e.time_range.end - e.time_range.start
            tot, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (tot + us, n + 1)
    out["profile_ms"] = sum(v[0] for v in by_name.values()) / 1e3
    out["profile_by_kernel"] = [
        [round(us / 1e3, 4), n, name[:80]] for name, (us, n) in
        sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]]
    h = hashlib.sha1()
    for a in res:
        h.update(np.ascontiguousarray(a).tobytes())
    out["checksum"] = h.hexdigest()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
