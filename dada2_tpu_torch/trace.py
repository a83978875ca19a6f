"""Observability: the port's one recorder of spans and counters.

The reference has only commented-out counters and verbose prints
(reference: src/nwalign_endsfree.cpp:15-18, src/dada.h:113-114,
src/Rmain.cpp:333); here counters are first-class and every phase of the
program is a span.

Spans. Every phase opens through ``PHASES(name)``. While tracing is on
(after ``enable()`` until ``disable()``, and while a torch.profiler session
records) each span is kept in memory with its name, its start and end on
``time.perf_counter_ns()`` (the clock of a benchmark's window and of the
device trace mapped onto it), its thread, its parent (the enclosing span
of the same thread), the ``sample`` span it belongs to (for chimera
removal, its ``chimera.table`` span) and a few attributes (``attrs()``).
``spans()`` returns the finished spans; ``reset()`` clears them; a
profiler session that starts after tracing was off starts a fresh buffer,
and its spans stay readable after it ends. Tracing off costs one flag
test per span: no clock read, no lock. Inside ``profile_trace`` each span
also opens ``torch.profiler.record_function(name)``, so the Chrome trace
shows the program's spans and, under each, the kernels it launched.

Counters. ``COUNTERS.add(name, n)`` adds to the process-wide total (per
thread, summed on read, so no update is lost across threads) and, while
tracing is on, to the calling thread's current ``sample`` or
``chimera.table`` span (its ``counters``).

Crossings. Every blocking host <-> device crossing of dada() and
chimera removal goes through ``put``, ``fetch``, ``item``, ``scalar``,
``select`` or ``nonzero`` (SYNC_HELPERS): each is counted in ``syncs`` and
``sync_bytes`` and, while tracing is on, recorded as a ``sync.put`` or
``sync.fetch`` span with its ``bytes``. Those spans go straight into the
recorder, never through ``PHASES``.
"""
from __future__ import annotations

import functools
import itertools
import os
import threading
import time
import weakref
from contextlib import contextmanager, nullcontext
from typing import Dict, List, Optional

from torch.autograd import profiler as _profiler

# the functions through which every blocking crossing goes
SYNC_HELPERS = ("put", "fetch", "item", "scalar", "select", "nonzero")
# spans whose counters tally their thread's work: a sample of dada() and
# a sequence table of chimera removal
UNITS = ("sample", "chimera.table")

_ON = False              # enable() .. disable()
_RF = False              # inside profile_trace: spans open record_function
_fresh = True            # the next profiler-driven span starts a new buffer
_ids = itertools.count(1)
_done: List["Span"] = []
_lock = threading.Lock()
_tls = threading.local()
_NOOP = nullcontext()


class Span:
    """One finished (or open) span. start_ns / end_ns on
    time.perf_counter_ns(); parent and sample are span ids (None where
    there is none); counters is a dict on unit spans (UNITS), else None."""

    __slots__ = ("id", "name", "start_ns", "end_ns", "thread", "parent",
                 "sample", "attrs", "counters")

    def __init__(self, name, parent, sample, thread):
        self.id = next(_ids)
        self.name = name
        self.parent = parent
        self.sample = sample
        self.thread = thread
        self.attrs = None
        self.counters = None
        self.start_ns = self.end_ns = 0

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9

    def __repr__(self):
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"sample={self.sample}, {self.seconds:.6f} s)")


class _Thread:
    """Per-thread state: the open spans, the current unit span and the
    thread's counter tallies."""

    __slots__ = ("stack", "unit", "tally", "ident")

    def __init__(self):
        self.stack: List[Span] = []
        self.unit: Optional[Span] = None
        self.tally = dict.fromkeys(Counters.FIELDS, 0)
        self.ident = threading.get_ident()


_threads: list = []      # (weakref to the thread, its _Thread)
_base: Dict[str, int] = {}   # tallies of threads that have ended


def _state() -> _Thread:
    try:
        return _tls.t
    except AttributeError:
        t = _tls.t = _Thread()
        with _lock:
            live = []
            for ref, st in _threads:
                if ref() is None:
                    for k, v in st.tally.items():
                        _base[k] = _base.get(k, 0) + v
                else:
                    live.append((ref, st))
            live.append((weakref.ref(threading.current_thread()), t))
            _threads[:] = live
        return t


def is_on() -> bool:
    """Whether spans are being recorded."""
    return _ON or _profiler._is_profiler_enabled


def enable() -> None:
    """Record spans (and per-sample counters) until disable()."""
    global _ON
    _ON = True


def disable() -> None:
    global _ON
    _ON = False


def reset() -> None:
    """Drop every recorded span."""
    with _lock:
        _done.clear()


def spans() -> List[Span]:
    """The finished spans recorded since the last reset, in the order
    they ended."""
    with _lock:
        return list(_done)


@contextmanager
def tracing(on: bool = True):
    """Tracing on for the body (unchanged when on is false)."""
    global _ON
    was = _ON
    _ON = was or on
    try:
        yield
    finally:
        _ON = was


def _new(name: str, t: _Thread) -> Span:
    """A span of the calling thread (state t) under its innermost open
    span and in its current unit."""
    return Span(name, t.stack[-1].id if t.stack else None,
                t.unit.id if t.unit is not None else None, t.ident)


class _Open:
    """The context of one recorded span."""

    __slots__ = ("sp", "t", "rf", "prev_unit")

    def __init__(self, name):
        global _fresh
        if not _ON and _fresh:
            # the first span of a profiler session: a fresh buffer
            with _lock:
                if _fresh:
                    _fresh = False
                    _done.clear()
        t = self.t = _state()
        self.sp = _new(name, t)

    def __enter__(self):
        sp, t = self.sp, self.t
        t.stack.append(sp)
        if sp.name in UNITS:
            self.prev_unit = t.unit
            t.unit = sp
            sp.sample = sp.id
            sp.counters = {}
        self.rf = None
        if _RF:
            self.rf = _profiler.record_function(sp.name)
            self.rf.__enter__()
        sp.start_ns = time.perf_counter_ns()
        return sp

    def __exit__(self, *exc):
        sp, t = self.sp, self.t
        sp.end_ns = time.perf_counter_ns()
        t.stack.pop()
        with _lock:
            _done.append(sp)
        if sp.counters is not None:
            t.unit = self.prev_unit
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


class PhaseTimer:
    """The entry every phase of the program goes through:
    ``with PHASES(name):``. Off, it returns one shared no-op context; on,
    it records a span. The methods below are views over the recorded
    spans."""

    def __call__(self, name: str):
        global _fresh
        if _ON or _profiler._is_profiler_enabled:
            return _Open(name)
        _fresh = True
        return _NOOP

    def bytes_dict(self) -> Dict[str, int]:
        """Bytes fetched from the device by the phase that fetched them
        (the parent of each sync.fetch span; "(unphased)" at top level)."""
        done = spans()
        names = {sp.id: sp.name for sp in done}
        out: Dict[str, int] = {}
        for sp in done:
            if sp.name == "sync.fetch":
                k = names.get(sp.parent, "(unphased)")
                out[k] = out.get(k, 0) + sp.attrs["bytes"]
        return dict(sorted(out.items(), key=lambda kv: -kv[1]))

    def reset(self) -> None:
        reset()

    def summary(self) -> str:
        return _summary(spans())

    def as_dict(self) -> Dict[str, float]:
        """Thread-summed seconds per span name (for bench artifacts)."""
        t, _ = _sums(spans())
        return {k: round(v, 3) for k, v in
                sorted(t.items(), key=lambda kv: -kv[1])}


def _sums(done):
    """(seconds, count) per span name."""
    t: Dict[str, float] = {}
    n: Dict[str, int] = {}
    for sp in done:
        t[sp.name] = t.get(sp.name, 0.0) + sp.seconds
        n[sp.name] = n.get(sp.name, 0) + 1
    return t, n


def _summary(done) -> str:
    t, n = _sums(done)
    return " | ".join(f"{k}: {v:.2f}s/{n[k]}x" for k, v in
                      sorted(t.items(), key=lambda kv: -kv[1])
                      ) or "(no phases)"


PHASES = PhaseTimer()


def phase(name: str):
    """Decorator: every call of the function is a span, PHASES(name)."""
    def deco(fn):
        @functools.wraps(fn)
        def spanned(*a, **kw):
            with PHASES(name):
                return fn(*a, **kw)
        return spanned
    return deco


def attrs(**kw) -> None:
    """Attach attributes to the calling thread's innermost open span
    (nothing while tracing is off)."""
    if not (_ON or _profiler._is_profiler_enabled):
        return
    stk = _state().stack
    if stk:
        sp = stk[-1]
        if sp.attrs is None:
            sp.attrs = {}
        sp.attrs.update(kw)


def unit_report() -> str:
    """The calling thread's current unit span's counters and the phases
    recorded under it so far, for dada(verbose >= 2)."""
    unit = _state().unit
    if unit is None:
        return "(not traced)"
    tallies = ", ".join(f"{k} {v}" for k, v in unit.counters.items() if v)
    under = [sp for sp in spans() if sp.sample == unit.id]
    return (f"counters: {tallies or '(none)'}\n   phases: "
            f"{_summary(under)}")


class Counters:
    """Process-wide tallies of the program's work. Read a tally as an
    attribute (``COUNTERS.fetch_bytes``); add to it with ``add``."""

    FIELDS = (
        "compares",          # compare sweeps dispatched
        "alignments",        # pairwise alignments computed (post-screen)
        "shrouded",          # pairs rejected by the kmer screen
        "gapless",           # pairs resolved by the gapless screen
        # blocking host <-> device crossings (put / fetch / item)
        "syncs",
        "sync_bytes",
        "device_puts",       # host -> device uploads
        "device_fetches",    # forcing device -> host reads
        "put_bytes",
        "fetch_bytes",
        # the speculative budded-compare transport (backend_cuda): hits
        # consume a prefetched segment with no fetch of their own; misses
        # pay one fetch and refill the stash; wasted counts prefetched
        # segments dropped unconsumed
        "spec_hits",
        "spec_misses",
        "spec_wasted",
        # budded compares (kernel B5): shortlist buffers that overflowed
        # into a follow-up fetch, and shortlist rows whose substitutions
        # overflowed their records into a dense tvec fetch
        "followup_fetches",
        "dense_refetches",
        # the engine's shuffle: passes of the best-E scan, and raws its
        # surgery moved to another cluster
        "shuffle_passes",
        "shuffle_moved",
        # the compare backend's per-center alignment cache
        # (backend_cuda._align_ent): kernel B1 sweeps made, sweeps of a
        # center swept before and evicted since, sweeps evicted
        "align_sweeps",
        "align_resweeps",
        "align_evictions",
        # dada(pool=True): the uniques of each pool
        "pooled_uniques",
        # chimera removal: the (query, parent) pairs of a consensus table
        "chimera_pairs",
    )

    def add(self, name: str, n: int = 1) -> None:
        t = _state()
        t.tally[name] += n
        u = t.unit
        if u is not None:
            c = u.counters
            c[name] = c.get(name, 0) + n

    def __getattr__(self, name: str) -> int:
        if name not in Counters.FIELDS:
            raise AttributeError(name)
        with _lock:
            return _base.get(name, 0) + sum(st.tally[name]
                                            for _, st in _threads)

    def reset(self) -> None:
        with _lock:
            _base.clear()
            for _, st in _threads:
                for k in st.tally:
                    st.tally[k] = 0

    def as_dict(self) -> dict:
        with _lock:
            out = dict.fromkeys(Counters.FIELDS, 0)
            for k, v in _base.items():
                out[k] += v
            for _, st in _threads:
                for k, v in st.tally.items():
                    out[k] += v
        return out

    def summary(self) -> str:
        d = self.as_dict()
        return (f"{d['alignments']} alignments ({d['shrouded']} shrouded, "
                f"{d['gapless']} gapless) in {d['compares']} compares; "
                f"{d['syncs']} syncs ({d['sync_bytes'] / 1e6:.1f}MB): "
                f"{d['device_puts']} puts ({d['put_bytes'] / 1e6:.1f}MB), "
                f"{d['device_fetches']} fetches "
                f"({d['fetch_bytes'] / 1e6:.1f}MB); "
                f"spec {d['spec_hits']}H/{d['spec_misses']}M/"
                f"{d['spec_wasted']}W, {d['followup_fetches']} follow-ups, "
                f"{d['dense_refetches']} dense re-fetches")


COUNTERS = Counters()


# ---- crossings ------------------------------------------------------------

def _cross(kind: str, nbytes: int, fn, *args):
    """fn(*args), a blocking crossing of nbytes: counted, and while
    tracing is on recorded as a `kind` span under the calling thread's
    innermost open span."""
    COUNTERS.add("syncs")
    COUNTERS.add("sync_bytes", nbytes)
    if not (_ON or _profiler._is_profiler_enabled):
        return fn(*args)
    t0 = time.perf_counter_ns()
    out = fn(*args)
    sp = _new(kind, _state())
    sp.start_ns, sp.end_ns = t0, time.perf_counter_ns()
    sp.attrs = {"bytes": nbytes}
    with _lock:
        _done.append(sp)
    return out


def put(x, device):
    """Host -> device upload of a numpy array (a pageable copy, which
    PyTorch ends with a stream synchronise on a card)."""
    import numpy as np
    import torch

    x = np.ascontiguousarray(x)
    COUNTERS.add("device_puts")
    COUNTERS.add("put_bytes", x.nbytes)
    return _cross("sync.put", x.nbytes, torch.from_numpy(x).to, device)


def _host(x):
    return x.cpu().numpy()


def fetch(x):
    """Device -> host read of a tensor as a numpy array."""
    COUNTERS.add("device_fetches")
    COUNTERS.add("fetch_bytes", x.nbytes)
    return _cross("sync.fetch", x.nbytes, _host, x)


def item(x):
    """Device -> host read of a one-element tensor as a Python number
    (a data-dependent branch's flag, a count)."""
    return _cross("sync.fetch", x.element_size(), x.item)


def scalar(value, dtype, device):
    """A constant one-element tensor made on the device (an upload of
    one value)."""
    import torch

    return _cross("sync.put", dtype.itemsize,
                  lambda: torch.tensor(value, dtype=dtype, device=device))


def select(x, mask):
    """x[mask] for a boolean mask on the device: the host reads the
    number of selected elements (nonzero) before the result exists."""
    return _cross("sync.fetch", 8, x.__getitem__, mask)


def nonzero(x):
    """torch.nonzero(x) on the device ([n, x.dim()] int64, row-major): the
    host reads n before the result exists."""
    import torch

    return _cross("sync.fetch", 8, torch.nonzero, x)


# ---- device traces --------------------------------------------------------

@contextmanager
def profile_trace(logdir: str):
    """Capture a CPU + CUDA device trace with torch.profiler, the
    program's spans on the same timeline (record_function).

    Usage:
        with profile_trace("/tmp/dada2-trace"):
            dada(...)
    Writes a Chrome trace (chrome://tracing, Perfetto) into logdir.
    """
    global _RF, _fresh
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    was = _RF
    _fresh = True
    with torch.profiler.profile(activities=acts) as prof:
        _RF = True
        try:
            yield prof
        finally:
            _RF = was
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
