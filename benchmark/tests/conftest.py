"""Test sizes of the mixes added after bench_tiny.py, registered in its
TINY table before any test runs, so that every test that cuts the mixes
by name (bench_tiny.tiny_copy, test_bench_generate.py) finds them."""
from bench_tiny import TINY

TINY.setdefault("study_60k_pool8", dict(
    reads_per_sample=600, asvs_per_sample=6, samples=4, samples_per_step=2,
    pool_asvs=20, warmup=dict(asvs=2, reads=100)))
