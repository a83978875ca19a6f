"""The pooled cell v4_denoise_pool at a test size on the CPU: a sound run
is correct; a split-back abundance altered where it is produced fails
tally_diffs and table_diffs; the float32-lambda control fails its limits
where the program passes; the cell's two new readers give their known
answers on synthetic spans and counters and None where the program keeps
neither (a checkout without them); the pooled reference loads nothing of
the program."""
import os
from types import SimpleNamespace

import pytest

from bench_tiny import BENCH, tiny_copy
from harness import load_module

CELL = "v4_denoise_pool"
SEED = 2 ** 31 + 7


@pytest.fixture()
def tiny(tmp_path):
    """The tiny copy: the pooled mix cut to 4 samples of 600 reads, 2
    pooled a step (conftest.py)."""
    return tiny_copy(tmp_path)


def checks(tiny, nsteps=3, seed=SEED):
    """The checks of a tiny run of nsteps steps (both sets, the first
    twice), driven step by step."""
    import torch

    import harness

    man, bench = tiny
    _, config, mix, driver, _, _ = harness.cell_of(harness.load_json(man),
                                                   CELL, bench)
    gen = harness.load_module(os.path.join(bench, "generate.py"),
                              "bench_generate")
    ctx = SimpleNamespace(workload=CELL, seed=seed, seconds=0, trace=0,
                          device="cpu", config=config, mix=mix, torch=torch)
    ctx.inputs = gen.generate(config, mix, seed)
    driver.setup(ctx)
    for k in range(nsteps):
        driver.step(ctx, k)
    driver.release(ctx)
    return {c["name"]: c["value"] for c in driver.verify(ctx)}, ctx


def test_the_pooled_cell_runs_and_is_correct(tiny):
    import harness

    man, bench = tiny
    res, lines = harness.run_cell(CELL, SEED, 0, 0, device="cpu",
                                  manifest_path=man, bench_dir=bench)
    assert res["correct"], lines
    assert res["attempted"] == 2 and res["failed"] == 0
    assert set(res["metrics"]) == {"denoise_reads_per_s", "setup_s"}


def abundance_off(real):
    def split(*a, **kw):
        out = real(*a, **kw)
        out.clustering.loc[len(out.clustering) - 1, "abundance"] += 1
        return out
    return split


@pytest.mark.parametrize("fault", ["none", "split_abundance"])
def test_a_wrong_split_back_fails(tiny, monkeypatch, fault):
    import importlib

    dm = importlib.import_module("dada2_tpu_torch.dada")
    if fault != "none":
        monkeypatch.setattr(dm, "_split_pooled",
                            abundance_off(dm._split_pooled))
    got, ctx = checks(tiny)
    assert ctx.set_of_step == [0, 1, 0]
    if fault == "none":
        assert all(v == 0 for v in got.values()), got
    else:
        assert got["tally_diffs"] >= 1 and got["table_diffs"] >= 1, got


def test_control_fails_where_the_program_passes(tiny):
    import control
    from harness import cell_of, load_json

    man, bench = tiny
    limits = cell_of(load_json(man), CELL, bench)[2]["limits"]
    r = control.readings(CELL, 2 ** 31 + 21, 0, device="cpu",
                         manifest_path=man, bench_dir=bench)
    assert all(r["program"][k] <= v for k, v in limits.items())
    assert any(r["control"].get(k, 0) > v for k, v in limits.items())


def reader(name):
    return load_module(os.path.join(BENCH, "metrics", name + ".py"),
                       "test_metric_" + name.replace(".", "_"))


def span(id, name, t0, t1, parent=None):
    return SimpleNamespace(id=id, name=name, start_ns=int(t0 * 1e9),
                           end_ns=int(t1 * 1e9), parent=parent, sample=None,
                           counters=None, attrs=None, thread=1)


@pytest.mark.parametrize("spans,want", [
    ([span(1, "dada.pool", 1.0, 3.0),             # before the window
      span(2, "dada.call", 10.0, 19.0),
      span(3, "dada.pool", 10.0, 10.5, 2),
      span(4, "sync.put", 10.1, 10.2, 3),
      span(5, "dada.split", 18.0, 18.25, 2)], 0.4 + 0.25),
    ([span(2, "dada.call", 10.0, 19.0)], None),
    ([], None),
    (None, None)])
def test_pool_host_seconds(monkeypatch, spans, want):
    import program_spans

    monkeypatch.setattr(program_spans, "recorded", lambda: spans)
    run = SimpleNamespace(window=(9.5, 20.0), traced_steps=1)
    got = reader("pool_host_s.pool").read(run)
    assert got == (None if want is None else pytest.approx(want, rel=1e-9))


@pytest.mark.parametrize("c0,c1,want", [
    ({"align_sweeps": 10, "align_resweeps": 1},
     {"align_sweeps": 30, "align_resweeps": 5}, 4 / 16),
    ({"align_sweeps": 10, "align_resweeps": 1},
     {"align_sweeps": 30, "align_resweeps": 1}, 0.0),
    ({"align_sweeps": 3, "align_resweeps": 0},
     {"align_sweeps": 3, "align_resweeps": 0}, None),
    ({"compares": 1}, {"compares": 9}, None)])
def test_resweeps_per_center(c0, c1, want):
    run = SimpleNamespace(rec=object(), ctx=SimpleNamespace(
        counters0=c0, counters1=c1))
    assert reader("b1_resweeps_per_center.pool").read(run) == want


def test_the_pool_reference_loads_nothing_of_the_program():
    from test_bench_imports import FORBIDDEN, loaded_after

    names = loaded_after(f"""
import sys
sys.path[:0] = [{BENCH!r}]
from reference import dada_ref, pool_ref
import generate
cfg = {{"amplicons": "data/v4_asvs.txt.gz", "quality_profile": "sam1F",
       "error_model": {{"kind": "matrix", "file": "data/tperr1.npy",
                        "max_q": 50}}}}
mix = dict(generator="amplicon_samples", pool_asvs=10, asvs_per_sample=3,
           reads_per_sample=200, samples=2, abundance_sigma=1.6,
           warmup=dict(asvs=1, reads=10))
x = generate.generate(cfg, mix, 1)
out = pool_ref.dada_pooled([s[1:] for s in x["samples"]], x["err"],
                           dada_ref.options(), device="cpu")
assert len(out) == 2
""")
    assert "torch" in names
    assert not names & (FORBIDDEN | {"dada2_tpu_torch"})
