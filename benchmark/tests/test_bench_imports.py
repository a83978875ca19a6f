"""What the harness and the reference load, compared by whole top-level
module names: no jax, jaxlib, flax or dada2_tpu anywhere (dada2_tpu_torch
begins with dada2_tpu, hence whole names), and nothing of dada2_tpu_torch
in the reference."""
import json
import subprocess
import sys

from bench_tiny import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "dada2_tpu"}


def loaded_after(code):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport json, sys\nprint(json.dumps("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, cwd=ROOT, timeout=600,
        env={"PATH": "/usr/bin:/bin", "HOME": ROOT, "PYTHONPATH": ""})
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_nothing_forbidden(tmp_path):
    names = loaded_after(f"""
import sys
sys.path[:0] = [{BENCH!r}, {ROOT!r}, {str(tmp_path)!r}]
sys.path.insert(0, {BENCH + '/tests'!r})
from bench_tiny import tiny_copy
import harness
man, bench = tiny_copy({str(tmp_path)!r})
res, _ = harness.run_cell("v4_bimera", 3, 0, 0, device="cpu",
                          manifest_path=man, bench_dir=bench)
assert res["correct"]
""")
    assert "dada2_tpu_torch" in names
    assert not names & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    names = loaded_after(f"""
import sys
sys.path[:0] = [{BENCH!r}]
import numpy as np, torch
from reference import bimera_ref, compare, dada_ref, nw
import generate
cfg = {{"amplicons": "data/v4_asvs.txt.gz", "quality_profile": "sam1F",
       "error_model": {{"kind": "matrix", "file": "data/tperr1.npy",
                        "max_q": 50}}}}
mix = dict(generator="amplicon_samples", pool_asvs=20, asvs_per_sample=3,
           reads_per_sample=200, samples=1, abundance_sigma=1.6,
           warmup=dict(asvs=1, reads=10))
x = generate.generate(cfg, mix, 1)
_, seqs, ab, q = x["samples"][0]
dada_ref.dada_sample(seqs, ab, q, x["err"], dada_ref.options(), device="cpu")
bimera_ref.bimera_flags(np.ones((2, 3), np.int64) * 9, seqs[:3], device="cpu")
""")
    assert "torch" in names
    assert not names & (FORBIDDEN | {"dada2_tpu_torch"})
