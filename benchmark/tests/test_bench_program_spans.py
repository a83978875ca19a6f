"""The readers of the program's own spans and per-sample counters
(program_spans.py and the metrics sample_setup_s.denoise,
sync_wait_s.denoise and syncs_per_compare.denoise) on a synthetic span
list with a known answer, and None where the program recorded no span."""
import os
from types import SimpleNamespace

import pytest

import program_spans
from bench_tiny import BENCH
from harness import load_module

NS = 1_000_000_000


def reader(name):
    return load_module(os.path.join(BENCH, "metrics", name + ".py"),
                       "test_metric_" + name.replace(".", "_"))


def span(id, name, t0, t1, sample=None, parent=None, counters=None):
    return SimpleNamespace(id=id, name=name, start_ns=int(t0 * NS),
                           end_ns=int(t1 * NS), sample=sample, parent=parent,
                           counters=counters, attrs=None, thread=1)


def synthetic():
    """Two samples inside the window (10 s, 20 s) and one before it, whose
    spans must not count."""
    return [
        span(1, "sample", 1.0, 2.0, sample=1,
             counters={"syncs": 1000, "compares": 1}),
        span(2, "dada.backend_init", 1.0, 1.5, sample=1, parent=1),
        span(3, "sync.fetch", 1.6, 1.7, sample=1, parent=1),
        span(10, "dada.call", 10.0, 19.0),
        span(11, "sample", 10.0, 14.0, sample=11, parent=10,
             counters={"syncs": 30, "compares": 10, "sync_bytes": 5}),
        span(12, "dada.backend_init", 10.0, 10.5, sample=11, parent=11),
        span(13, "dada.setup", 10.5, 10.75, sample=11, parent=11),
        span(14, "engine.compare", 11.0, 12.0, sample=11, parent=11),
        span(15, "sync.put", 11.0, 11.25, sample=11, parent=14),
        span(16, "sync.fetch", 11.5, 12.0, sample=11, parent=14),
        span(21, "sample", 14.0, 19.0, sample=21, parent=10,
             counters={"syncs": 70, "compares": 30}),
        span(22, "dada.backend_init", 14.0, 15.0, sample=21, parent=21),
        span(23, "dada.setup", 15.0, 15.25, sample=21, parent=21),
        span(24, "sync.fetch", 16.0, 16.25, sample=21, parent=21),
        span(25, "finalize", 16.0, 17.0, sample=21, parent=21),
    ]


RUN = SimpleNamespace(window=(9.5, 20.0))
WANT = {"sample_setup_s.denoise": (0.5 + 0.25 + 1.0 + 0.25) / 2,
        "sync_wait_s.denoise": (0.25 + 0.5 + 0.25) / 2,
        "syncs_per_compare.denoise": (30 + 70) / (10 + 30)}


@pytest.mark.parametrize("name", sorted(WANT))
def test_known_answer(monkeypatch, name):
    monkeypatch.setattr(program_spans, "recorded", synthetic)
    assert reader(name).read(RUN) == pytest.approx(WANT[name], rel=1e-9)


@pytest.mark.parametrize("name", sorted(WANT))
@pytest.mark.parametrize("spans", [None, [], "outside"])
def test_none_without_spans(monkeypatch, name, spans):
    if spans == "outside":      # spans, but no sample in the window
        got = synthetic()[:3]
    else:
        got = spans
    monkeypatch.setattr(program_spans, "recorded", lambda: got)
    assert reader(name).read(RUN) is None


def test_no_compares_reads_none(monkeypatch):
    monkeypatch.setattr(program_spans, "recorded", lambda: [
        span(1, "sample", 10.0, 11.0, sample=1, counters={"syncs": 4})])
    assert reader("syncs_per_compare.denoise").read(RUN) is None


def test_the_programs_recorder_is_read():
    from dada2_tpu_torch import trace

    trace.reset()
    with trace.tracing(), trace.PHASES("sample"), trace.PHASES(
            "dada.setup"):
        pass
    got = program_spans.recorded()
    trace.reset()
    assert [s.name for s in got] == ["dada.setup", "sample"]
    assert got[0].sample == got[1].id
