"""The program's own spans and per-sample counters, read for the traced
window. dada2_tpu_torch.trace records a span for each phase of the
program (and for each sample of a dada() call, its `sample` span, with
that sample's counters) while a torch.profiler session records, as the
traced window's does; a span's start and end are on perf_counter_ns, the
clock of run.window. A checkout whose program keeps no spans
(trace.spans missing) or recorded no `sample` span in the window gives
None for every metric read here."""
from __future__ import annotations


def recorded():
    """The program's recorded spans, or None where it keeps none."""
    try:
        from dada2_tpu_torch import trace
    except ImportError:
        return None
    spans = getattr(trace, "spans", None)
    return spans() if spans is not None else None


def window_samples(run):
    """(the `sample` spans that started inside run.window, every recorded
    span), or None."""
    spans = recorded()
    if not spans:
        return None
    w0, w1 = (int(t * 1e9) for t in run.window)
    samples = [s for s in spans
               if s.name == "sample" and w0 <= s.start_ns <= w1]
    return (samples, spans) if samples else None


def per_sample_seconds(run, keep):
    """Seconds a sample of the spans under the window's sample spans
    (each span whose sample is one of them) whose name keep(name)
    accepts, summed and divided by the samples; None as above."""
    got = window_samples(run)
    if got is None:
        return None
    samples, spans = got
    ids = {s.id for s in samples}
    ns = sum(s.end_ns - s.start_ns for s in spans
             if s.sample in ids and s.id not in ids and keep(s.name))
    return ns * 1e-9 / len(samples)


def counter_ratio(run, num, den):
    """The window's samples' counter num summed over their counter den
    summed; None as above or where den sums to 0."""
    got = window_samples(run)
    if got is None:
        return None
    samples, _ = got
    n = sum((s.counters or {}).get(num, 0) for s in samples)
    d = sum((s.counters or {}).get(den, 0) for s in samples)
    return n / d if d else None
