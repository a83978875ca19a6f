"""Helpers of the harness's tests: a copy of the benchmark in a temporary
directory whose cells run at a size a CPU test can hold."""
from __future__ import annotations

import json
import os
import shutil
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)
if ROOT not in sys.path:
    sys.path.insert(1, ROOT)

TINY = {
    "study_60k": dict(reads_per_sample=600, asvs_per_sample=5, samples=3,
                      samples_per_step=2, pool_asvs=40,
                      warmup=dict(asvs=2, reads=100)),
    "study_30k": dict(reads_per_sample=300, asvs_per_sample=4, samples=3,
                      samples_per_step=2, pool_asvs=40,
                      warmup=dict(asvs=2, reads=100)),
    # enough recombinants of few parents that some are flagged
    "table_5000x20": dict(asvs=200, parents=12, samples=8,
                          mutant_share=0.3, recombinant_share=0.6,
                          occupancy=[4, 8], warmup_asvs=20),
}


def load_json(path):
    with open(path) as fh:
        return json.load(fh)


def tiny_copy(tmp):
    """A copy of BENCHMARK.json and benchmark/ under tmp with the mixes cut
    to TINY; returns (manifest path, benchmark dir)."""
    dst = os.path.join(str(tmp), "benchmark")
    shutil.copytree(BENCH, dst, ignore=shutil.ignore_patterns(
        "tests", "__pycache__", ".cache"))
    for name, upd in TINY.items():
        path = os.path.join(dst, "mixes", name + ".json")
        mix = load_json(path)
        mix.update(upd)
        with open(path, "w") as fh:
            json.dump(mix, fh)
    manifest = os.path.join(str(tmp), "BENCHMARK.json")
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), manifest)
    return manifest, dst
