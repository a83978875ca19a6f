"""The port's span and counter recorder (dada2_tpu_torch.trace) on the CPU:
the span tree of a two-sample dada() on two threads, per-sample counters
against the process-wide ones, tracing off, results with tracing on and
off, a torch.profiler session, profile_trace's Chrome trace, and the
chimera table's span."""
import json

import numpy as np
import pandas as pd
import pytest
import torch

import dada2_tpu_torch as dt
from dada2_tpu_torch import trace


def _subset(drp, name, keep):
    seqs = drp.sequences[:keep]
    return dt.Derep(uniques={s: int(drp.uniques[s]) for s in seqs},
                    quals=drp.quals[:keep].copy(),
                    map=np.zeros(0, np.int64), name=name)


@pytest.fixture(scope="module")
def full(extdata):
    return {n: dt.derep_fastq(str(extdata / f"{n}.fastq.gz"))
            for n in ("sam1F", "sam2F")}


@pytest.fixture(scope="module")
def dereps(full):
    return {n: _subset(d, n, 200) for n, d in full.items()}


@pytest.fixture(scope="module")
def small(full):
    """A few uniques a sample, for runs at BAND_SIZE=0 (gapless on the
    host, no kernel): the CPU profiler records every operation of the
    kernels' plain versions."""
    return {n: _subset(d, n, 60) for n, d in full.items()}


def _dada(dereps, **kw):
    return dt.dada(dict(dereps), err=dt.data.tperr1(), multithread=2,
                   verbose=False, device="cpu", **kw)


@pytest.fixture(scope="module")
def runs(dereps):
    """The same two-sample dada() with tracing off, then on: (results,
    spans, counter deltas) for each."""
    trace.disable()
    trace.reset()
    out = {}
    for on in (False, True):
        c0 = trace.COUNTERS.as_dict()
        with trace.tracing(on):
            res = _dada(dereps)
        c1 = trace.COUNTERS.as_dict()
        out[on] = (res, trace.spans(), {k: c1[k] - c0[k] for k in c1})
        trace.reset()
    return out


def _same_result(a, b):
    pd.testing.assert_frame_equal(a.clustering, b.clustering)
    pd.testing.assert_frame_equal(a.birth_subs, b.birth_subs)
    np.testing.assert_array_equal(a.map, b.map)
    np.testing.assert_array_equal(a.pval, b.pval)
    np.testing.assert_array_equal(a.trans, b.trans)


def test_off_records_no_span_and_counts(runs):
    _, spans, delta = runs[False]
    assert spans == []
    assert delta["compares"] > 0 and delta["syncs"] > 0
    assert delta["syncs"] >= delta["device_puts"] + delta["device_fetches"]
    assert delta["sync_bytes"] >= delta["put_bytes"] + delta["fetch_bytes"]


def test_results_bit_identical_on_and_off(runs):
    off, on = runs[False][0], runs[True][0]
    assert set(off) == set(on) == {"sam1F", "sam2F"}
    for k in off:
        _same_result(off[k], on[k])


def test_off_costs_no_clock_read():
    trace.disable()
    assert trace.PHASES("engine.bud") is trace.PHASES("finalize")


@pytest.mark.parametrize("prop", ["order", "enclosed", "one_sample"])
def test_span_tree(runs, prop):
    _, spans, _ = runs[True]
    by = {s.id: s for s in spans}
    assert len(by) == len(spans)
    if prop == "order":
        assert all(s.start_ns <= s.end_ns for s in spans)
        assert sum(s.name == "dada.call" for s in spans) == 1
    elif prop == "enclosed":
        for s in spans:
            if s.parent is None:
                continue
            p = by[s.parent]
            assert p.thread == s.thread
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    else:
        work = [s for s in spans if s.name.startswith(
            ("engine.", "be.", "finalize", "sync."))]
        assert {s.name for s in work} >= {"engine.compare", "be.compare",
                                          "finalize", "sync.fetch",
                                          "sync.put", "be.cluster_stats"}
        for s in work:
            up, chain = s, []
            while up.parent is not None:
                up = by[up.parent]
                chain.append(up)
            samples = [a for a in chain if a.name == "sample"]
            assert len(samples) == 1, s
            assert s.sample == samples[0].id


def test_sample_attributes(runs, dereps):
    _, spans, _ = runs[True]
    call = [s for s in spans if s.name == "dada.call"][0]
    assert call.attrs == {"samples": 2, "workers": 2}
    samples = {s.attrs["name"]: s for s in spans if s.name == "sample"}
    assert set(samples) == set(dereps)
    for name, d in dereps.items():
        a = samples[name].attrs
        assert a["uniques"] == len(d.uniques)
        assert a["reads"] == int(d.abundances.sum())
        assert a["round"] == 1
    # the two samples ran on two threads
    assert len({s.thread for s in samples.values()}) == 2
    for s in samples.values():
        under = [x for x in spans if x.sample == s.id and x.id != s.id]
        assert {x.thread for x in under} == {s.thread}
        assert {"dada.backend_init", "dada.setup"} <= {x.name for x in under}


@pytest.mark.parametrize("field", ["compares", "syncs", "sync_bytes",
                                   "device_fetches", "fetch_bytes",
                                   "alignments"])
def test_sample_counters_sum_to_totals(runs, field):
    _, spans, delta = runs[True]
    samples = [s for s in spans if s.name == "sample"]
    assert len(samples) == 2
    assert sum(s.counters.get(field, 0) for s in samples) == delta[field]
    assert all(s.counters.get(field, 0) > 0 for s in samples)


def test_sync_spans_carry_bytes(runs):
    _, spans, delta = runs[True]
    syncs = [s for s in spans if s.name.startswith("sync.")]
    assert len(syncs) == delta["syncs"]
    assert sum(s.attrs["bytes"] for s in syncs) == delta["sync_bytes"]
    fetched = trace.PHASES.bytes_dict()    # the buffer was reset: a view
    assert fetched == {}


def test_counters_lose_no_update_across_threads():
    import threading

    trace.COUNTERS.reset()

    def work():
        for _ in range(20000):
            trace.COUNTERS.add("gapless")

    ts = [threading.Thread(target=work) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    work()        # a new thread state folds the ended threads' tallies
    assert trace.COUNTERS.gapless == 100000
    assert trace.COUNTERS.as_dict()["gapless"] == 100000


def test_profiler_session_records_without_enable(small):
    trace.disable()
    d = {"sam1F": small["sam1F"]}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        _dada(d, BAND_SIZE=0)
    first = trace.spans()
    assert [s.name for s in first].count("sample") == 1
    # off again: nothing more is recorded, and the spans stay readable
    _dada(d, BAND_SIZE=0)
    assert len(trace.spans()) == len(first)
    # the next session starts a fresh buffer
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        _dada(d, BAND_SIZE=0)
    again = trace.spans()
    assert [s.name for s in again].count("sample") == 1
    assert min(s.id for s in again) > max(s.id for s in first)
    trace.reset()


def test_profile_trace_holds_program_spans(small, tmp_path):
    trace.disable()
    with trace.profile_trace(str(tmp_path)):
        _dada({"sam2F": small["sam2F"]}, BAND_SIZE=0)
    names = {e.get("name") for e in json.loads(
        (tmp_path / "trace.json").read_text())["traceEvents"]}
    assert {"dada.call", "sample", "engine.compare", "be.compare"} <= names
    # a benchmark reads CPU events named cu* as launch calls
    assert not any(s.name.startswith("cu") for s in trace.spans())
    trace.reset()


def test_verbose_prints_each_sample(small, capsys):
    trace.disable()
    dt.dada(dict(small), err=dt.data.tperr1(), multithread=1, verbose=2,
            device="cpu", BAND_SIZE=0)
    out = capsys.readouterr().out
    assert out.count("counters: ") == 2 and out.count("phases: ") == 2
    assert "engine.compare" in out and "syncs" in out
    assert not trace.is_on()
    trace.reset()


def test_chimera_table_span(runs):
    res, _, _ = runs[False]
    table = dt.make_sequence_table(res)
    trace.reset()
    c0 = trace.COUNTERS.as_dict()
    with trace.tracing():
        out = dt.remove_bimera_denovo(table, method="consensus",
                                      device="cpu")
    c1 = trace.COUNTERS.as_dict()
    spans = trace.spans()
    trace.reset()
    tables = [s for s in spans if s.name == "chimera.table"]
    assert len(tables) == 1
    t = tables[0]
    assert t.attrs == {"asvs": table.shape[1], "samples": table.shape[0],
                       "method": "consensus"}
    assert t.counters.get("syncs", 0) == c1["syncs"] - c0["syncs"] > 0
    under = [s for s in spans if s.sample == t.id and s.id != t.id]
    assert {"chimera.pairs", "chimera.stats", "chimera.vote"} <= {
        s.name for s in under}
    assert out.shape[1] <= table.shape[1]
