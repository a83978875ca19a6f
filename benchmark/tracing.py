"""What a traced run (--trace 1) reads besides the clock: spans kept in
memory from the benchmark's own wrappers around the program's calls and
around the program's own phase timer (trace.PHASES), with their self
times; and the device trace of the window from torch.profiler, reduced to
the device's busy time, the time by kernel, and the idle gaps named by
the span the host was in.
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict


class Recorder:
    """Spans (name, thread, start, end) on time.perf_counter, and each
    name's self time: its span's length less the part its child spans on
    the same thread cover."""

    def __init__(self):
        self.spans = []
        self.self_s = defaultdict(float)
        self.total_s = defaultdict(float)
        self._tls = threading.local()
        self._lock = threading.Lock()
        self._undo = []
        self.on_stop = []      # callables run when the trace stops

    @contextlib.contextmanager
    def span(self, name):
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        frame = [0.0]
        stack.append(frame)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            stack.pop()
            dur = t1 - t0
            if stack:
                stack[-1][0] += dur
            with self._lock:
                self.spans.append((name, threading.get_ident(), t0, t1))
                self.self_s[name] += dur - frame[0]
                self.total_s[name] += dur

    def wrap(self, owner, attr, name):
        """Run owner.attr inside a span named name (undone by undo())."""
        orig = getattr(owner, attr)
        rec = self

        def wrapped(*a, **kw):
            with rec.span(name):
                return orig(*a, **kw)

        setattr(owner, attr, wrapped)
        self._undo.append((owner, attr, orig))
        return orig

    def wrap_context(self, owner, attr):
        """owner.attr is a context-manager factory taking a name (the
        program's phase timer): each context also records a span."""
        orig = getattr(owner, attr)
        rec = self

        @contextlib.contextmanager
        def both(timer, name):
            with orig(timer, name), rec.span(name):
                yield

        setattr(owner, attr, both)
        self._undo.append((owner, attr, orig))

    def undo(self):
        for fn in self.on_stop:
            fn()
        for owner, attr, orig in reversed(self._undo):
            setattr(owner, attr, orig)
        self._undo.clear()


def device_trace(prof, marker_host_s, window_host, is_marker):
    """Reduce a torch.profiler session over the window.

    The marker kernel was launched just before host time marker_host_s
    (perf counter, seconds) and synchronised; the end of its launch call
    (or, where the trace holds no launch calls, its device start) maps
    the trace's timestamps onto the host clock. A device event's launch
    call is the CUDA runtime or driver call of its correlation id. Returns None if the
    profiler recorded no device event, else dict(busy_s, window_s,
    by_kernel {name: s}, intervals [(start, end)] merged busy intervals
    in host seconds, kernels [(name, start, end, launch)] clipped to the
    window, launch the host time of its launch call or, where the trace
    has none, its device start; linked, the kernels with a launch
    call)."""
    from torch.autograd import DeviceType

    allev = list(prof.events())
    evs = [e for e in allev if e.device_type == DeviceType.CUDA]
    calls = {e.id: e for e in allev if e.device_type == DeviceType.CPU
             and e.name.startswith("cu")}
    marks = [e for e in evs if is_marker(e.name)]
    if not marks:
        return None
    mc = calls.get(marks[0].id)
    off = marker_host_s - (mc.time_range.end if mc is not None else
                           marks[0].time_range.start) * 1e-6
    w0, w1 = window_host
    spans, by, kernels, linked = [], defaultdict(float), [], 0
    for e in evs:
        if is_marker(e.name):
            continue
        s0 = e.time_range.start * 1e-6 + off
        s, t = max(s0, w0), min(e.time_range.end * 1e-6 + off, w1)
        if t <= s:
            continue
        spans.append((s, t))
        by[e.name] += t - s
        call = calls.get(e.id)
        linked += call is not None
        kernels.append((e.name, s, t, s0 if call is None else
                        call.time_range.start * 1e-6 + off))
    if not spans:
        return None
    spans.sort()
    merged = [list(spans[0])]
    for s, t in spans[1:]:
        if s > merged[-1][1]:
            merged.append([s, t])
        else:
            merged[-1][1] = max(merged[-1][1], t)
    busy = sum(t - s for s, t in merged)
    return dict(busy_s=busy, window_s=w1 - w0, by_kernel=dict(by),
                intervals=merged, window=(w0, w1), kernels=kernels,
                linked=linked)


def launched_within(dev, spans, name, pattern):
    """Device seconds of the kernels matching pattern (a regex) that were
    launched inside a span called name."""
    import bisect
    import re

    rx = re.compile(pattern)
    iv = []
    for a, b in sorted((sp[2], sp[3]) for sp in spans if sp[0] == name):
        if iv and a <= iv[-1][1]:
            iv[-1][1] = max(iv[-1][1], b)
        else:
            iv.append([a, b])
    starts = [a for a, _ in iv]
    total = 0.0
    for kname, s, t, launch in dev["kernels"]:
        if not rx.search(kname):
            continue
        k = bisect.bisect_right(starts, launch) - 1
        if k >= 0 and launch <= iv[k][1]:
            total += t - s
    return total


def launched_by(dev, spans, top=10):
    """Device seconds by the innermost span open on the host when each
    kernel was launched (see innermost_segments), "host outside any span"
    where none was."""
    import bisect

    segs = innermost_segments(spans)
    starts = [a for a, _, _ in segs]
    out = defaultdict(float)
    for _, s, t, launch in dev["kernels"]:
        k = bisect.bisect_right(starts, launch) - 1
        name = (segs[k][2] if k >= 0 and launch < segs[k][1] else
                "host outside any span")
        out[name] += t - s
    return sorted(([k, v] for k, v in out.items()),
                  key=lambda kv: -kv[1])[:top]


def innermost_segments(spans):
    """The host's timeline as [(start, end, name)]: at each instant the
    innermost span (the latest started that has not ended) on any
    thread."""
    import heapq

    bounds = sorted({t for sp in spans for t in sp[2:4]})
    spans = sorted(spans, key=lambda sp: sp[2])
    heap, k, out = [], 0, []
    for a, b in zip(bounds, bounds[1:]):
        while k < len(spans) and spans[k][2] <= a:
            heapq.heappush(heap, (-spans[k][2], spans[k][3], spans[k][0]))
            k += 1
        while heap and heap[0][1] <= a:
            heapq.heappop(heap)
        if heap:
            out.append((a, b, heap[0][2]))
    return out


def idle_gaps(dev, spans, top=10):
    """The window's idle time (before, between and after the busy
    intervals), each instant named by the innermost span then open on the
    host (see innermost_segments), "host outside any span" where none
    is."""
    w0, w1 = dev["window"]
    iv = [(w0, w0)] + [tuple(x) for x in dev["intervals"]] + [(w1, w1)]
    gaps = [(a[1], b[0]) for a, b in zip(iv, iv[1:]) if b[0] > a[1]]
    segs = innermost_segments(spans)
    out = defaultdict(float)
    k = 0
    for g0, g1 in gaps:
        covered = 0.0
        while k < len(segs) and segs[k][1] <= g0:
            k += 1
        j = k
        while j < len(segs) and segs[j][0] < g1:
            o = min(g1, segs[j][1]) - max(g0, segs[j][0])
            if o > 0:
                out[segs[j][2]] += o
                covered += o
            j += 1
        if g1 - g0 - covered > 0:
            out["host outside any span"] += g1 - g0 - covered
    return sorted(([k, v] for k, v in out.items()),
                  key=lambda kv: -kv[1])[:top]
