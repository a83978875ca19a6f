"""The end-to-end arithmetic: a rate and a time per table are taken over
every step of the window, the one that ran past --seconds included."""
import os
from types import SimpleNamespace

import pytest

from bench_tiny import BENCH
from harness import load_module


def metric(name):
    return load_module(os.path.join(BENCH, "metrics", name + ".py"),
                       "t_" + name.replace(".", "_"))


def run_of(steps, w0=100.0):
    st = [dict(t0=a, t1=b, units=u) for a, b, u in steps]
    return SimpleNamespace(steps=st, window=(w0, st[-1]["t1"]), setup_s=7.5)


def test_rate_counts_the_step_over_the_window():
    # a 30 s window: the third step starts at 128 s (before 130) and ends
    # at 141 s, so 3 x 480,000 reads over 41 s
    run = run_of([(100, 114, 480_000), (114, 128, 480_000),
                  (128, 141, 480_000)])
    assert metric("denoise_reads_per_s").read(run) == pytest.approx(
        1_440_000 / 41.0)


def test_time_per_table_counts_the_step_over_the_window():
    run = run_of([(100, 104, 1), (104, 108.5, 1), (108.5, 113, 1)])
    assert metric("bimera_table_s").read(run) == pytest.approx(13.0 / 3)


def test_setup_and_idle_share():
    run = run_of([(100, 101, 1)])
    assert metric("setup_s").read(run) == 7.5
    run.dev = dict(busy_s=2.0, window_s=40.0)
    assert metric("device_idle_pct.denoise").read(run) == pytest.approx(95.0)
    run.dev = None
    assert metric("device_idle_pct.bimera").read(run) is None


def test_idle_gaps_are_named_by_the_innermost_span():
    from tracing import idle_gaps

    dev = dict(intervals=[[0.5, 1.0], [2.0, 3.0], [5.0, 6.0], [8.0, 9.0],
                          [9.5, 10.0]], window=(0.0, 11.0))
    spans = [("step", 1, 0.0, 9.0), ("engine.bud", 1, 1.2, 1.9),
             ("engine.shuffle", 2, 3.5, 4.8), ("engine.vote", 1, 10.0, 11.0)]
    got = dict(idle_gaps(dev, spans))
    assert got == pytest.approx({"engine.bud": 0.7, "engine.shuffle": 1.3,
                                 "step": 3.5, "engine.vote": 1.0,
                                 "host outside any span": 0.5})


def fake_prof(events):
    from torch.autograd import DeviceType

    kinds = {"cpu": DeviceType.CPU, "cuda": DeviceType.CUDA}
    evs = [SimpleNamespace(device_type=kinds[d], name=n, id=i,
                           time_range=SimpleNamespace(start=a, end=b))
           for d, n, i, a, b in events]
    return SimpleNamespace(events=lambda: evs)


def test_kernels_are_timed_by_the_span_that_launched_them():
    from tracing import device_trace, launched_by, launched_within

    # trace clock in us; the marker's launch call ends at 1,000 us, which
    # is host time 50.0 s, so trace time t maps to 49.999 + t * 1e-6
    prof = fake_prof([
        ("cpu", "cudaLaunchKernel", 1, 990, 1000),
        ("cuda", "spin_kernel", 1, 1005, 1900),
        ("cpu", "cudaLaunchKernel", 2, 2000, 2010),      # in compare
        ("cuda", "nw_compare_kernel<2, 1>", 2, 3000, 3500),
        ("cpu", "cudaLaunchKernel", 3, 4000, 4010),      # in the tallies
        ("cuda", "nw_compare_kernel<2, 1>", 3, 4100, 4300),
        ("cuda", "nw_compare_kernel<3, 1>", 4, 2500, 2600),  # no call
        ("cpu", "cudaMemcpyAsync", 5, 2020, 2030),
        ("cuda", "Memcpy DtoH", 5, 2040, 2050),
    ])
    spans = [("step", 1, 50.0, 50.01),
             ("backend.compare", 1, 50.0005, 50.0028),
             ("backend.cluster_stats_all", 1, 50.0029, 50.0035)]
    dev = device_trace(prof, 50.0, (50.0, 50.01), lambda n: "spin" in n)
    assert dev["linked"] == 3 and len(dev["kernels"]) == 4
    b1 = r"nw_compare_kernel<\s*\d+\s*,\s*1\s*>"
    # launched in compare: the kernel of call 2 (0.5 ms) and the one with
    # no call, placed by its start (0.1 ms); not the tallies' (0.2 ms)
    assert launched_within(dev, spans, "backend.compare", b1) == \
        pytest.approx(0.6e-3)
    got = dict(launched_by(dev, spans))
    assert got == pytest.approx({"backend.compare": 0.6e-3 + 0.01e-3,
                                 "backend.cluster_stats_all": 0.2e-3})
