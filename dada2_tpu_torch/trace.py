"""Observability: engine counters, phase timers and device tracing.

The reference has only commented-out counters and verbose prints
(reference: src/nwalign_endsfree.cpp:15-18, src/dada.h:113-114,
src/Rmain.cpp:333); here counters are first-class and device work can be
captured with torch.profiler (Chrome-trace / TensorBoard compatible).
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, Optional


@dataclass
class Counters:
    """Process-wide tallies of engine work."""

    compares: int = 0          # compare sweeps dispatched
    alignments: int = 0        # pairwise alignments computed (post-screen)
    shrouded: int = 0          # pairs rejected by the kmer screen
    gapless: int = 0           # pairs resolved by the gapless screen
    compare_seconds: float = 0.0
    # host <-> device transfer tallies (backend_cuda._put / _fetch)
    device_puts: int = 0       # host -> device uploads
    device_fetches: int = 0    # forcing device -> host reads
    put_bytes: int = 0
    fetch_bytes: int = 0
    # the speculative budded-compare transport (backend_cuda): hits
    # consume a prefetched segment with no fetch of their own; misses
    # pay one fetch and refill the stash; wasted counts prefetched
    # segments dropped unconsumed
    spec_hits: int = 0
    spec_misses: int = 0
    spec_wasted: int = 0
    # budded compares (kernel B5): shortlist buffers that overflowed into
    # a follow-up fetch, and shortlist rows whose substitutions overflowed
    # their records into a dense tvec fetch
    followup_fetches: int = 0
    dense_refetches: int = 0

    def reset(self) -> None:
        self.compares = 0
        self.alignments = 0
        self.shrouded = 0
        self.gapless = 0
        self.compare_seconds = 0.0
        self.device_puts = 0
        self.device_fetches = 0
        self.put_bytes = 0
        self.fetch_bytes = 0
        self.spec_hits = 0
        self.spec_misses = 0
        self.spec_wasted = 0
        self.followup_fetches = 0
        self.dense_refetches = 0

    def alignments_per_sec(self) -> float:
        if self.compare_seconds == 0:
            return 0.0
        return self.alignments / self.compare_seconds

    def as_dict(self) -> dict:
        return {
            "compares": self.compares,
            "alignments": self.alignments,
            "device_puts": self.device_puts,
            "device_fetches": self.device_fetches,
            "put_bytes": self.put_bytes,
            "fetch_bytes": self.fetch_bytes,
            "spec_hits": self.spec_hits,
            "spec_misses": self.spec_misses,
            "spec_wasted": self.spec_wasted,
            "followup_fetches": self.followup_fetches,
            "dense_refetches": self.dense_refetches,
        }

    def summary(self) -> str:
        return (f"{self.alignments} alignments ({self.shrouded} shrouded, "
                f"{self.gapless} gapless) in {self.compares} compares, "
                f"{self.compare_seconds:.2f}s "
                f"({self.alignments_per_sec():.0f} aligns/s); "
                f"device ops: {self.device_puts} puts "
                f"({self.put_bytes / 1e6:.1f}MB), "
                f"{self.device_fetches} fetches "
                f"({self.fetch_bytes / 1e6:.1f}MB); "
                f"spec {self.spec_hits}H/{self.spec_misses}M/"
                f"{self.spec_wasted}W, {self.followup_fetches} follow-ups, "
                f"{self.dense_refetches} dense re-fetches")


COUNTERS = Counters()


class PhaseTimer:
    """Wall-clock accumulation per named engine phase, summed across
    threads — the breakdown that tells which side (device round-trips,
    host bookkeeping, finalize tallies) bounds an e2e run."""

    def __init__(self):
        import threading
        from collections import defaultdict

        self._t = defaultdict(float)
        self._n = defaultdict(int)
        self._b = defaultdict(int)       # fetch bytes per phase
        self._tls = threading.local()
        self._lock = threading.Lock()

    @contextmanager
    def __call__(self, name: str):
        stk = getattr(self._tls, "stack", None)
        if stk is None:
            stk = self._tls.stack = []
        stk.append(name)
        t0 = time.time()
        try:
            yield
        finally:
            stk.pop()
            dt = time.time() - t0
            with self._lock:
                self._t[name] += dt
                self._n[name] += 1

    def add_bytes(self, nbytes: int) -> None:
        """Attribute fetched bytes to the innermost active phase of the
        calling thread (see backend_cuda._fetch)."""
        stk = getattr(self._tls, "stack", None)
        name = stk[-1] if stk else "(unphased)"
        with self._lock:
            self._b[name] += nbytes

    def bytes_dict(self) -> Dict[str, int]:
        with self._lock:
            return {k: v for k, v in
                    sorted(self._b.items(), key=lambda kv: -kv[1])}

    def reset(self) -> None:
        with self._lock:
            self._t.clear()
            self._n.clear()
            self._b.clear()

    def summary(self) -> str:
        with self._lock:
            items = sorted(self._t.items(), key=lambda kv: -kv[1])
            return " | ".join(f"{k}: {v:.2f}s/{self._n[k]}x"
                              for k, v in items) or "(no phases)"

    def as_dict(self) -> Dict[str, float]:
        """Thread-summed seconds per phase (for bench artifacts)."""
        with self._lock:
            return {k: round(v, 3) for k, v in
                    sorted(self._t.items(), key=lambda kv: -kv[1])}


PHASES = PhaseTimer()


@contextmanager
def timed_compare(n_aligned: int, n_shrouded: int, n_gapless: int = 0):
    """Record one compare sweep in the global counters."""
    t0 = time.time()
    try:
        yield
    finally:
        COUNTERS.compares += 1
        COUNTERS.alignments += int(n_aligned)
        COUNTERS.shrouded += int(n_shrouded)
        COUNTERS.gapless += int(n_gapless)
        COUNTERS.compare_seconds += time.time() - t0


@contextmanager
def profile_trace(logdir: str):
    """Capture a CPU + CUDA device trace with torch.profiler.

    Usage:
        with profile_trace("/tmp/dada2-trace"):
            dada(...)
    Writes a Chrome trace (chrome://tracing, Perfetto) into logdir.
    """
    import os

    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@contextmanager
def annotate(name: str):
    """Named region in the device trace (torch.profiler.record_function)."""
    import torch

    with torch.profiler.record_function(name):
        yield
