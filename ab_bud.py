"""Measure the compare transport of a checkout of this repo on one card, for
comparing two checkouts (two designs of the budded compare's kernel B5, or
a checkout without it).

    python3 ab_bud.py [ROOT]

ROOT (default: this script's directory) is a checkout whose
dada2_tpu_torch is imported. Two workloads, each through
dada(selfConsist=True) on the card, with the compare backend instrumented
by chip_smoke.py's transport_run (the budded compares by the JAX package's
rule, whatever route ROOT takes for them):
  - phase 5: chip_smoke.py's simulated 120,000-read sample (seed 42, drawn
    from the ASVs of sam1F's dada() on the card), one warm-up run, then
    two measured runs: wall, compares and budded compares, bytes fetched
    per budded compare (min, median, max), device fetches and bytes,
    follow-up and dense fetches, the be.* phases (seconds, bytes), the
    rows whose exact lambda the host multiplied, B5's launches;
  - 16a: phase 16a's 8 samples of 15,000 reads, meshless (samples on
    threads, so no per-compare bytes): the same totals.
Each run has a checksum of its results (err_out, denoised and map of
every sample), equal between two checkouts that compute the same
results. Prints the card's nvidia-smi name and power limit, then one
JSON line. Needs a CUDA card.
"""
from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def checksum(results) -> str:
    import numpy as np

    h = hashlib.sha256()
    for name in sorted(results):
        r = results[name]
        h.update(name.encode())
        h.update(np.ascontiguousarray(r.err_out, np.float64).tobytes())
        h.update(json.dumps(sorted(r.denoised.items())).encode())
        h.update(np.ascontiguousarray(r.map, np.int64).tobytes())
    return h.hexdigest()[:16]


def main(argv) -> int:
    root = os.path.abspath(argv[0]) if argv else HERE
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("ab_bud: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from chip_smoke import SAM1F, simulate_sample, transport_run

    sys.path.insert(0, root)
    import dada2_tpu_torch as dt
    from dada2_tpu_torch.encode import pack_sequences
    from dada2_tpu_torch.ops import nw_wavefront as nww

    if not os.path.dirname(nww.__file__).startswith(root):
        print(f"ab_bud: imported {nww.__file__}, not from {root}",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)

    err41 = dt.data.tperr1()
    res = dt.dada(dt.derep_fastq(SAM1F), err=err41, device=dev,
                  verbose=False)
    err = np.hstack([err41] + [err41[:, -1:]] * 10)
    seqs, quals = res.sequence, res.quality
    ab0 = np.array([res.denoised[s] for s in seqs], float)
    sim = simulate_sample(np.random.default_rng(42), dt.Derep,
                          pack_sequences, seqs, ab0, quals, err, 120_000,
                          "sim0")
    samples = {}
    for k in range(8):
        prof = ab0 * np.exp(np.random.default_rng(200 + k).normal(
            0.0, 1.0, len(ab0)))
        samples[f"s{k}"] = simulate_sample(
            np.random.default_rng(100 + k), dt.Derep, pack_sequences, seqs,
            prof, quals, err, 15_000, f"s{k}")

    def phase5():
        return {"sim0": dt.dada(sim, err=None, selfConsist=True,
                                device=dev, verbose=False)}

    def study():
        return dt.dada(samples, err=None, selfConsist=True, device=dev,
                       verbose=False)

    out = {"root": root, "card": card,
           "device": torch.cuda.get_device_name(0),
           "uniques": {"phase5": len(sim.uniques),
                       "16a": [len(s.uniques) for s in samples.values()]}}
    phase5()                                     # warm-up, builds
    for key, fn, per in (("phase5", phase5, True), ("phase5 again", phase5,
                                                    True),
                         ("16a", study, False)):
        results, stats, _ = transport_run(fn, per_compare=per)
        stats["checksum"] = checksum(results)
        out[key] = stats
        print(f"ab_bud {key}: {json.dumps(stats, sort_keys=True)}",
              flush=True)
    print(json.dumps(out, sort_keys=True), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
