"""Time the engine's host scans on the CPU, a sample at a time, for sizing
a change to the engine (core/engine.py) without the card.

    python3 ab_engine.py [ROOT] [--samples N] [--seed S]

ROOT (default: this script's directory) is a checkout whose
dada2_tpu_torch is imported. The inputs are the benchmark's: the cells
v4_denoise (configuration miseq_v4_gut, mix study_60k: about 16,000
uniques a sample) and fl16s_denoise (pacbio_fl16s_gut, study_30k: about
7,000), generated from the seed by benchmark/generate.py. The first N
samples of each (default 4) run through ROOT's Engine on the CPU with the
gapless stand-in backend (core/backend_ref.py GaplessBackend: exact
lambdas without gaps or a k-mer screen, so the engine sees about the
clusters and shuffle passes of the real run at a fraction of its compare
cost). Prints, per sample, the uniques, clusters, shuffle passes, the
seconds in Engine.shuffle, Engine.bud and Engine.p_update, and the
engine's own time (Engine.run less the backend's compares); then one
JSON line with each cell's medians and the CPU it ran on.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import platform
import statistics
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CELLS = (("v4_denoise", "miseq_v4_gut", "study_60k"),
         ("fl16s_denoise", "pacbio_fl16s_gut", "study_30k"))
TIMED = ("shuffle", "bud", "p_update")


def _timed(obj, name, acc):
    """Wrap obj.name so its calls add their seconds to acc[name]."""
    fn = getattr(obj, name)

    def wrapped(*a, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            acc[name] = acc.get(name, 0.0) + time.perf_counter() - t0
            acc[name + "_calls"] = acc.get(name + "_calls", 0) + 1
    setattr(obj, name, wrapped)


def run_sample(seqs, abundances, quals, err, opts):
    from dada2_tpu_torch.core.backend_ref import GaplessBackend
    from dada2_tpu_torch.core.engine import Engine
    from dada2_tpu_torch.core.raws import make_rawset

    rs = make_rawset(seqs, abundances, None, quals)
    be = GaplessBackend(rs)
    eng = Engine(rs, err, opts, be)
    acc = {}
    for name in TIMED:
        _timed(eng, name, acc)
    _timed(be, "compare", acc)
    t0 = time.perf_counter()
    eng.run()
    total = time.perf_counter() - t0
    return dict(uniques=rs.n, clusters=len(eng.clusters),
                shuffle_passes=acc["shuffle_calls"],
                **{f"{k}_s": acc[k] for k in TIMED},
                engine_self_s=total - acc["compare"],
                compare_s=acc["compare"])


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root", nargs="?", default=HERE)
    ap.add_argument("--samples", type=int, default=4)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    from benchmark import generate

    sys.path.insert(0, os.path.abspath(args.root))
    from dada2_tpu_torch.options import DEFAULT_OPTIONS

    out = dict(root=os.path.abspath(args.root), seed=args.seed,
               cpu=platform.processor() or platform.machine(),
               cpus=os.cpu_count(), cells={})
    for cell, config_name, mix_name in CELLS:
        with open(os.path.join(HERE, "benchmark", "configs",
                               config_name + ".json")) as fh:
            config = json.load(fh)
        with open(os.path.join(HERE, "benchmark", "mixes",
                               mix_name + ".json")) as fh:
            mix = json.load(fh)
        inp = generate.amplicon_samples(config, mix, args.seed)
        opts = dataclasses.replace(DEFAULT_OPTIONS, **config["dada"])
        rows = []
        for name, seqs, ab, quals in inp["samples"][:args.samples]:
            row = run_sample(seqs, ab, quals, inp["err"], opts)
            rows.append(row)
            print(f"{cell} {name}: " + ", ".join(
                f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                for k, v in row.items()), flush=True)
        out["cells"][cell] = {k: statistics.median(r[k] for r in rows)
                              for k in rows[0]}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
