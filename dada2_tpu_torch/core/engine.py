"""The DADA2 divisive partitioning engine.

Host-driven control loop over device-batched comparisons. The reference
implements this as pointer-graph surgery plus TBB-parallel alignment sweeps
(reference: src/Rmain.cpp:297-336 run_dada, src/cluster.cpp); here the raws
live in struct-of-arrays (RawSet), each round's "compare all raws to the new
cluster center" is one batched call into a pluggable backend (NumPy oracle or
the TPU kernels in ops/), and the inherently sequential decisions (budding,
shuffling, p-value updates) are exact float64 host bookkeeping.

Slot-order semantics: the reference stores cluster members in arrays mutated
by swap-with-last pops (src/containers.cpp:183-197); member order affects
tie-breaking in b_bud and the order of floating-point accumulations in the
outputs, so we reproduce the same slot discipline. Membership is kept as
flat arrays, updated in place (Membership), so shuffle and bud scan every
raw with vector operations instead of walking the clusters.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
from scipy import special as _sp

from ..encode import GAP_GLYPH
from ..options import DadaOptions
from .raws import RawSet
from ..ops.subs import Sub, calc_pA

MAX_SHUFFLE = 10  # reference: src/dada.h:30


@dataclass(eq=False)
class Cluster:
    """One partition (Bi). reference: src/dada.h:85-105.

    Its members, read total and center live in the engine's Membership
    at index i, its stored comparisons in the engine's Comparisons; this
    object reads them there and holds the birth record. It refers to
    neither the engine nor the other clusters, so an engine and its
    backend's device memory are freed as soon as the engine is dropped,
    without waiting for the cycle collector."""

    mem: "Membership" = field(repr=False)
    cmp: "Comparisons" = field(repr=False)
    i: int
    birth_type: str = "I"
    birth_from: int = 0
    birth_pval: float = 0.0
    birth_fold: float = 1.0
    birth_e: float = 0.0
    birth_comp_i: int = 0
    birth_comp_lam: float = 0.0
    birth_comp_ham: int = 0

    @property
    def slots(self) -> np.ndarray:
        """Member raw indices in slot order (a live view: valid until
        the membership next changes)."""
        return self.mem.slots(self.i)

    @property
    def reads(self) -> int:
        return int(self.mem.reads[self.i])

    @property
    def center(self) -> int:
        return int(self.mem.center[self.i])

    def comps(self):
        """(index, lam, ham) arrays over this cluster's stored
        comparisons, in insertion order."""
        return self.cmp.of(self.i)


class Comparisons:
    """Every cluster's stored comparisons (raw index, lambda, ham), flat
    in cluster order: cluster i's are [end[i], end[i + 1]). A cluster is
    compared once, as the newest, so its chunk always goes at the end."""

    def __init__(self, nmax: int):
        self.end = np.zeros(nmax + 1, dtype=np.int64)
        self.idx = np.zeros(0, dtype=np.int64)
        self.lam = np.zeros(0)
        self.ham = np.zeros(0, dtype=np.int64)
        self.nclust = 0

    def open(self, i: int) -> None:
        """Cluster i is new: it holds no comparison yet."""
        self.nclust = i + 1
        self.end[i + 1] = self.end[i]

    def of(self, i: int):
        lo, hi = self.end[i], self.end[i + 1]
        return self.idx[lo:hi], self.lam[lo:hi], self.ham[lo:hi]

    def add(self, i: int, idx: np.ndarray, lam: np.ndarray,
            ham: np.ndarray) -> None:
        if i != self.nclust - 1 or self.end[i + 1] != self.end[i]:
            raise RuntimeError("a cluster is compared once, as the newest")
        lo = int(self.end[i])
        hi = lo + len(idx)
        if hi > len(self.idx):
            cap = max(hi, 2 * len(self.idx))
            for name in ("idx", "lam", "ham"):
                old = getattr(self, name)
                buf = np.empty(cap, dtype=old.dtype)
                buf[:lo] = old[:lo]
                setattr(self, name, buf)
        self.idx[lo:hi] = idx
        self.lam[lo:hi] = lam
        self.ham[lo:hi] = ham
        self.end[i + 1] = hi


class Membership:
    """Which raws each cluster holds, in slot order, as flat arrays kept
    up to date in place.

    Per cluster: its slots (a growable int64 array and a length), its
    read total and its center. Per raw: its cluster and its slot. A pop
    moves the last slot into the hole and an append goes to the end
    (reference: src/containers.cpp:183-197), so slot order is the
    reference's. Every raw is in exactly one cluster and every cluster
    keeps its center, so there are at most n clusters."""

    def __init__(self, reads: np.ndarray):
        n = len(reads)
        self.raw_reads = np.ascontiguousarray(reads, dtype=np.int64)
        self.cluster_of = np.zeros(n, dtype=np.int64)
        self.slot_of = np.arange(n, dtype=np.int64)
        cap = max(n, 1)
        self.lens = np.zeros(cap, dtype=np.int64)
        self.caps = np.zeros(cap, dtype=np.int64)
        self.reads = np.zeros(cap, dtype=np.int64)
        self.center = np.full(cap, -1, dtype=np.int64)
        # each slot array's address, for the native surgery
        self.ptrs = np.zeros(cap, dtype=np.uintp)
        self.bufs: List[np.ndarray] = []
        self.nclust = 0
        self.new_cluster(capacity=n)
        self.bufs[0][:n] = self.slot_of
        self.lens[0] = n
        self.reads[0] = self.raw_reads.sum()

    def new_cluster(self, capacity: int = 8) -> int:
        i = self.nclust
        self.nclust += 1
        self.bufs.append(np.empty(0, dtype=np.int64))
        self._reserve(i, capacity)
        return i

    def _reserve(self, i: int, size: int) -> None:
        """Grow cluster i's slot array, by doubling, to hold size slots."""
        cap = int(self.caps[i])
        if size <= cap:
            return
        buf = np.empty(max(size, 2 * cap, 8), dtype=np.int64)
        k = int(self.lens[i])
        buf[:k] = self.bufs[i][:k]
        self.bufs[i] = buf
        self.caps[i] = len(buf)
        self.ptrs[i] = buf.ctypes.data

    def slots(self, i: int) -> np.ndarray:
        return self.bufs[i][:self.lens[i]]

    def pop(self, i: int, slot: int) -> int:
        buf = self.bufs[i]
        last = int(self.lens[i]) - 1
        raw = int(buf[slot])
        moved = buf[last]
        buf[slot] = moved
        self.slot_of[moved] = slot
        self.lens[i] = last
        self.reads[i] -= self.raw_reads[raw]
        return raw

    def append(self, i: int, raw: int) -> None:
        k = int(self.lens[i])
        self._reserve(i, k + 1)
        self.bufs[i][k] = raw
        self.lens[i] = k + 1
        self.slot_of[raw] = k
        self.cluster_of[raw] = i
        self.reads[i] += self.raw_reads[raw]

    def move(self, raws: np.ndarray, tgts: np.ndarray) -> None:
        """Move raws[k] to cluster tgts[k]: first every pop, in the given
        order (ascending cluster, descending slot: each mover still sits
        at its slot when popped, since only tail slots, already visited,
        move into holes), then the appends grouped by ascending target,
        in the given order within a target."""
        from ..native import shuffle_move_native

        app = np.argsort(tgts, kind="stable")
        app_raws, app_tgts = raws[app], tgts[app]
        nc = self.nclust
        need = self.lens[:nc] + np.bincount(tgts, minlength=nc)
        for i in np.flatnonzero(need > self.caps[:nc]):
            self._reserve(int(i), int(need[i]))
        if shuffle_move_native(raws, app_raws, app_tgts, self.ptrs,
                               self.lens, self.reads, self.cluster_of,
                               self.slot_of, self.raw_reads):
            return
        for r in raws.tolist():
            self.pop(int(self.cluster_of[r]), int(self.slot_of[r]))
        for r, t in zip(app_raws.tolist(), app_tgts.tolist()):
            self.append(t, r)


class CompareBackend:
    """Interface for the batched alignment/lambda computation.

    compare(center, skip, ...) must return (lam[n] float64, ham[n] int64)
    where skipped raws get lam=0/ham=-1, screened-out ("shrouded") raws get
    lam=0/ham=-1, and aligned raws get their exact sequential-float64 lambda
    and substitution count.

    e_thresh (optional, = E_minmax/total_reads per raw) lets a backend
    return lam=0 for rows it can PROVE fall below the engine's store
    threshold (lam*total_reads > E_minmax, reference:
    src/cluster.cpp:179-201) — the engine discards such rows identically,
    so results are unchanged while the backend skips their exact-lambda
    work. Backends may ignore it.

    A backend that screens may return ham == -2 for rows it aligned but
    never fetched (exact ham/lam unknown and provably irrelevant); it
    must then set self.last_stats = (naligned, nshrouded) so the
    engine's counters stay exact. last_stats is consumed and cleared by
    the engine after every compare.
    """

    last_stats = None
    # speculation hint, set by the engine before each budded compare:
    # raw indices most likely to bud next (ranked). A backend MAY
    # prefetch their compare sweeps alongside the requested one so later
    # compares cost zero round-trips; prefetched results are corrected
    # to the true skip/E_minmax state at consume time, so hints can
    # never change results. Backends are free to ignore it.
    spec_hint = ()

    def compare(self, center: int, skip: np.ndarray, opts: DadaOptions,
                err: np.ndarray, use_kmers: bool, kdist_cutoff: float,
                e_thresh: Optional[np.ndarray] = None):
        raise NotImplementedError

    def subs_pair(self, i0: int, i1: int, opts: DadaOptions,
                  use_kmers: bool, kdist_cutoff: float) -> Optional[Sub]:
        """Full Sub for one pair (used for birth subs)."""
        raise NotImplementedError

    def subs_to_center(self, center: int, members: np.ndarray,
                       opts: DadaOptions) -> List[Optional[Sub]]:
        """Final subs of members vs center, use_kmers=False semantics.

        reference: src/Rmain.cpp:206-235 (FinalSubsParallel).
        """
        raise NotImplementedError

    def subs_pairs(self, pairs, opts: DadaOptions, use_kmers: bool,
                   kdist_cutoff: float):
        """subs_pair for a batch of (from, to) center pairs. Backends
        may override with one fused device fetch."""
        return [self.subs_pair(a, b, opts, use_kmers, kdist_cutoff)
                for a, b in pairs]

    def cluster_stats_all(self, clusters, opts: DadaOptions, ncol: int,
                          use_quals: bool):
        """cluster_stats for EVERY cluster: clusters is a list of
        (center, members, correct) triples; returns the per-cluster
        (trans, qacc, qcnt, nsubs) list. Backends may override with one
        fused device dispatch (one round-trip instead of nclust)."""
        return [self.cluster_stats(c, m, corr, opts, ncol, use_quals)
                for c, m, corr in clusters]

    def subs_info(self, center: int, members: np.ndarray,
                  opts: DadaOptions):
        """Batched final-subs summary: (p1mat [m, len0] int64 query
        positions with GAP_GLYPH at gaps, or -1 rows for screened-out
        members; nsubs [m] int64, -1 for screened-out). Semantically the
        map/nsubs fields of subs_to_center, in matrix form so the output
        assembly can stay vectorized. Backends may override with a
        batched implementation."""
        from ..encode import GAP_GLYPH as _GG

        subs = self.subs_to_center(center, members, opts)
        len0 = int(self.rs.lens[center])
        m = len(members)
        p1mat = np.full((m, len0), -1, dtype=np.int64)
        nsubs = np.full(m, -1, dtype=np.int64)
        for r, s in enumerate(subs):
            if s is None:
                continue
            p1mat[r] = s.map
            nsubs[r] = s.nsubs
        return p1mat, nsubs

    def cluster_stats(self, center: int, members: np.ndarray,
                      correct: np.ndarray, opts: DadaOptions, ncol: int,
                      use_quals: bool):
        """Per-cluster output statistics, batched: returns
        (trans [16, ncol] int64, qacc [len0] int64, qcnt [len0] int64,
        nsubs [m] int64).

        trans counts transitions at non-gap center positions over CORRECT
        members, weighted by reads (reference: src/error.cpp:131-172);
        qacc/qcnt accumulate quality*reads and reads per center position
        (reference: src/error.cpp:225-258 — integer-valued additions into
        doubles, hence order-free and exactly representable); nsubs is
        the substitution count per member (-1 if unaligned). Backends may
        override with a device implementation."""
        from ..encode import GAP_GLYPH as _GG

        rs = self.rs
        p1mat, nsubs = self.subs_info(center, members, opts)
        len0 = int(rs.lens[center])
        if not use_quals:
            ncol = 1
        use = correct & (nsubs >= 0)
        trans = np.zeros(16 * ncol, dtype=np.int64)
        qacc = np.zeros(len0, dtype=np.int64)
        qcnt = np.zeros(len0, dtype=np.int64)
        if use.any():
            mem = members[use]
            pm = p1mat[use]
            ok = pm != _GG
            p1 = np.where(ok, pm, 0)
            cseq = rs.seqs[center, :len0].astype(np.int64)
            nti1 = rs.seqs[mem[:, None], p1].astype(np.int64)
            t = 4 * cseq[None, :] + nti1
            if use_quals:
                q = rs.quals[mem[:, None], p1].astype(np.int64)
            else:
                q = np.zeros_like(t)
            w = rs.reads[mem][:, None]
            wb = np.broadcast_to(w, t.shape)
            trans += np.bincount((t * ncol + q)[ok], weights=wb[ok],
                                 minlength=16 * ncol).astype(np.int64)
            qacc += (np.where(ok, q * w, 0)).sum(axis=0)
            qcnt += (np.where(ok, w, 0)).sum(axis=0)
        return trans.reshape(16, ncol), qacc, qcnt, nsubs


class Engine:
    """The clustering state (B). reference: src/dada.h:108-123."""

    def __init__(self, rawset: RawSet, err: np.ndarray, opts: DadaOptions,
                 backend: CompareBackend, use_quals: bool = True):
        self.rs = rawset
        self.err = np.asarray(err, dtype=np.float64)
        self.opts = opts
        self.backend = backend
        self.use_quals = use_quals
        n = rawset.n
        self.n = n
        self.total_reads = int(rawset.reads.sum())
        self.E_minmax = np.full(n, -999.0)        # reference: containers.cpp:39
        self.p = np.zeros(n)
        self.lock = np.zeros(n, dtype=bool)
        self.correct = np.ones(n, dtype=bool)
        self.comp_i = np.zeros(n, dtype=np.int64)     # raw->comp
        self.comp_lam = np.zeros(n)
        self.comp_ham = np.zeros(n, dtype=np.int64)
        self.mem = Membership(rawset.reads)
        self.cluster_of = self.mem.cluster_of
        # per cluster: its p-values are stale; its locks need a check
        self.update_e = np.zeros(max(n, 1), dtype=bool)
        self.check_locks = np.zeros(max(n, 1), dtype=bool)
        self.cmp = Comparisons(max(n, 1))
        self.cmp.open(0)
        self.nalign = 0
        self.nshroud = 0
        self.bud_candidates = np.zeros(0, np.int64)
        c = Cluster(self.mem, self.cmp, 0)
        c.birth_e = float(self.total_reads)
        self.clusters: List[Cluster] = [c]
        self.update_e[0] = True
        self._assign_center(0)

    # ----- container ops (reference: src/containers.cpp) -----

    def _assign_center(self, i: int):
        """Most abundant member becomes center; ties keep the lowest slot.

        reference: src/cluster.cpp:371-386. Unlocks all members.
        """
        best = -1
        arr = self.mem.slots(i)
        if len(arr):
            self.lock[arr] = False
            reads = self.rs.reads[arr]
            if reads.max() > 0:
                # strict > running max: earliest slot wins ties
                best = int(arr[int(np.argmax(reads))])
        self.mem.center[i] = best
        self.check_locks[i] = True

    # ----- compare (reference: src/cluster.cpp:13-204) -----

    def compare(self, i: int, use_kmers: bool, kdist_cutoff: float):
        from ..trace import COUNTERS

        center = self.clusters[i].center
        center_reads = int(self.rs.reads[center])
        if self.opts.GREEDY:
            skip = (self.rs.reads > center_reads) | self.lock
        else:
            skip = np.zeros(self.n, dtype=bool)
        lam, ham = self.backend.compare(center, skip, self.opts, self.err,
                                        use_kmers, kdist_cutoff,
                                        self.E_minmax / self.total_reads)
        if np.any((lam < 0) | (lam > 1)):
            raise ValueError("Lambda out-of-range error.")
        stats = getattr(self.backend, "last_stats", None)
        if stats is not None:
            naligned, nshrouded = stats
            self.backend.last_stats = None
        else:
            naligned = int((ham >= 0).sum())
            nshrouded = int(((ham < 0) & ~skip).sum())
        self.nalign += naligned
        self.nshroud += nshrouded
        COUNTERS.add("compares")
        COUNTERS.add("alignments", naligned)
        COUNTERS.add("shrouded", nshrouded)

        # Selective store (reference: src/cluster.cpp:179-201): keep the
        # comparison only if this cluster could attract the raw.
        store = lam * self.total_reads > self.E_minmax
        if np.any(ham[store] == -2):
            # a backend store-screen dropped a row the engine stores:
            # the screen's soundness contract is broken
            raise RuntimeError("compare screen dropped a stored row")
        better = store & (lam * center_reads > self.E_minmax)
        self.E_minmax[better] = lam[better] * center_reads
        idx = np.nonzero(store)[0]
        self.cmp.add(i, idx, lam[idx], ham[idx])
        if i == 0:
            self.comp_i[idx] = i
            self.comp_lam[idx] = lam[idx]
            self.comp_ham[idx] = ham[idx]
        elif store[center]:
            self.comp_i[center] = i
            self.comp_lam[center] = lam[center]
            self.comp_ham[center] = ham[center]

    # ----- shuffle (reference: src/cluster.cpp:210-266) -----

    def _best_e(self):
        """For every raw, the cluster maximizing E = lambda * bi_reads over
        its stored comparisons, in ascending cluster order with a strict >
        (ties keep the earlier cluster): (best_i, best_lam, best_ham)."""
        from ..native import shuffle_best_native

        n, nc, mem, cmp = self.n, len(self.clusters), self.mem, self.cmp
        # cluster 0's comparisons hold every raw in index order (the
        # store test always passes against the initial E_minmax)
        c0lam, c0ham = cmp.lam[:n], cmp.ham[:n]
        out = shuffle_best_native(
            c0lam, c0ham, float(mem.reads[0]), cmp.end[1:nc + 1],
            cmp.idx, cmp.lam, cmp.ham, mem.reads[1:nc].astype(np.float64))
        if out is not None:
            return out[:3]
        emax = c0lam * int(mem.reads[0])
        best_i = np.zeros(n, dtype=np.int64)
        best_lam = c0lam.copy()
        best_ham = c0ham.copy()
        for i in range(1, nc):
            idx, lam, ham_c = cmp.of(i)
            if not len(idx):
                continue
            e = lam * int(mem.reads[i])
            upd = e > emax[idx]   # strict: ties keep earlier cluster
            uidx = idx[upd]
            emax[uidx] = e[upd]
            best_i[uidx] = i
            best_lam[uidx] = lam[upd]
            best_ham[uidx] = ham_c[upd]
        return best_i, best_lam, best_ham

    def shuffle(self) -> bool:
        """Move every raw, other than a center, to the cluster that gives
        it the largest E; True if any moved."""
        from ..trace import COUNTERS

        COUNTERS.add("shuffle_passes")
        best_i, best_lam, best_ham = self._best_e()
        mem = self.mem
        cl = mem.cluster_of
        raws = np.flatnonzero(best_i != cl)
        raws = raws[raws != mem.center[cl[raws]]]
        if not len(raws):
            return False
        # the reference's visit order: clusters ascending, slots
        # descending within each
        raws = raws[np.lexsort((-mem.slot_of[raws], cl[raws]))]
        tgts = best_i[raws]
        self.update_e[cl[raws]] = True
        self.update_e[tgts] = True
        mem.move(raws, tgts)
        self.comp_i[raws] = tgts
        self.comp_lam[raws] = best_lam[raws]
        self.comp_ham[raws] = best_ham[raws]
        COUNTERS.add("shuffle_moved", len(raws))
        return True

    # ----- p-value update (reference: src/pval.cpp:14-40) -----

    def p_update(self):
        nc = len(self.clusters)
        mem = self.mem
        for i in np.flatnonzero(self.update_e[:nc]).tolist():
            idx = mem.slots(i)
            self.p[idx] = self._get_pA_vec(idx, int(mem.reads[i]))
        self.update_e[:nc] = False
        if self.opts.GREEDY:
            for i in np.flatnonzero(self.check_locks[:nc]).tolist():
                idx = mem.slots(i)
                center = int(mem.center[i])
                e_center = self.rs.reads[center] * self.comp_lam[idx]
                self.lock[idx[e_center > self.rs.reads[idx]]] = True
                self.lock[center] = True
            self.check_locks[:nc] = False

    def _get_pA_vec(self, idx: np.ndarray, bi_reads: int) -> np.ndarray:
        """Vectorized get_pA (reference: src/pval.cpp:67-89)."""
        opts = self.opts
        reads = self.rs.reads[idx]
        prior = self.rs.priors[idx]
        lam = self.comp_lam[idx]
        ham = self.comp_ham[idx]
        out = np.ones(len(idx))
        singleton = (reads == 1) & ~prior & (not opts.DETECT_SINGLETONS)
        zero = (lam == 0) & ~singleton & (ham != 0)
        out[zero] = 0.0
        need = ~singleton & (ham != 0) & (lam != 0)
        if np.any(need):
            import math

            from ..utils.rmath import ppois_upper_vec

            E = lam[need] * bi_reads
            # R-exact Poisson tail (see ops/subs.py pois_tail): scipy's
            # pdtrc drifts from R's ppois in the last ulp
            pv = ppois_upper_vec(reads[need] - 1, E)
            cond = ~(prior[need] | opts.DETECT_SINGLETONS)
            # libm exp (not numpy's SIMD exp, which can differ in the
            # last ulp): the reference's calc_pA calls C exp()
            # (reference: src/pval.cpp:55). The native batch is the
            # same libm call without the per-element Python loop/GIL.
            from ..native import exp_neg_native

            en = exp_neg_native(E)
            norm = 1.0 - (en if en is not None
                          else np.array([math.exp(-e) for e in E]))
            small = norm < 1e-7  # TAIL_APPROX_CUTOFF, src/dada.h:25
            norm = np.where(small, E - 0.5 * E * E, norm)
            out[need] = np.where(cond, pv / norm, pv)
        return out

    # ----- bud (reference: src/cluster.cpp:274-350) -----

    def bud(self) -> int:
        opts = self.opts
        min_fold, min_hamming, min_abund = (
            opts.MIN_FOLD, opts.MIN_HAMMING, opts.MIN_ABUNDANCE)
        mem = self.mem
        # Sentinel = cluster 0's center (reference init, cluster.cpp:280-281)
        c0 = self.clusters[0].center
        sentinel = (self.p[c0], -int(self.rs.reads[c0]))

        # One vectorized scan over every raw the reference visits: each
        # cluster's slots from 1 on. Ties pick the earliest (cluster,
        # slot) position, exactly like the reference's strict-< running
        # minimum (cluster.cpp:283-311).
        raws = np.flatnonzero(mem.slot_of > 0)
        if not len(raws):
            return 0
        cl = mem.cluster_of[raws]
        sl = mem.slot_of[raws]
        pos = cl * self.n + sl           # (cluster, slot) order
        reads = self.rs.reads[raws]
        elig = reads >= min_abund
        elig &= self.comp_ham[raws] >= min_hamming
        if min_fold > 1:
            # same float op order as the scalar form:
            # (min_fold * lam) * bi.reads
            bireads = mem.reads[cl].astype(np.float64)
            elig &= reads >= (min_fold * self.comp_lam[raws]) * bireads
        pm = self.p[raws]

        def _argbest(mask):
            """Index of the lexicographic min (p, -reads) over mask;
            earliest position wins ties. None if empty/not < sentinel."""
            if not mask.any():
                return None
            best_p = pm[mask].min()
            m2 = mask & (pm == best_p)
            best_reads = reads[m2].max()
            m3 = np.flatnonzero(m2 & (reads == best_reads))
            if (best_p, -int(best_reads)) >= sentinel:
                return None
            return int(m3[np.argmin(pos[m3])])

        jA = _argbest(elig)
        jP = _argbest(elig & self.rs.priors[raws])

        # ranked next-bud candidates for speculative prefetch (pure
        # prediction). Raws captured by the upcoming cluster drop out of
        # contention, so rank by the CURRENT (p, -reads) — the same key
        # bud() minimizes, ties by position — and only raws whose current
        # p could actually pass the OMEGA gates qualify (a hint that
        # cannot bud is a guaranteed-wasted prefetch; p-values only rise
        # as E_minmax tightens).
        # 1e6 slack: shuffle can LOWER a raw's p before the next bud (its
        # cluster shrinks), so only clearly-hopeless hints are filtered
        passable = elig & ((pm * self.n < opts.OMEGA_A * 1e6)
                           | (self.rs.priors[raws]
                              & (pm < opts.OMEGA_P * 1e6)))
        hp = np.flatnonzero(passable)
        order = np.lexsort((pos[hp], -reads[hp], pm[hp]))[:17]
        self.bud_candidates = raws[hp[order]]

        def _at(j):
            return (int(cl[j]), int(sl[j]), int(raws[j]))

        pA = (pm[jA] if jA is not None else sentinel[0]) * self.n
        pP = pm[jP] if jP is not None else sentinel[0]
        # Bonferroni x nraw (reference: cluster.cpp:313)
        if pA < opts.OMEGA_A and jA is not None:
            return self._do_bud(_at(jA), "A", pA)
        elif pP < opts.OMEGA_P and jP is not None:
            return self._do_bud(_at(jP), "P", pP)
        return 0

    def _do_bud(self, at, btype: str, pval: float) -> int:
        mini, minr, raw = at
        mem = self.mem
        expected = self.comp_lam[raw] * int(mem.reads[mini])
        mem.pop(mini, minr)
        self.update_e[mini] = True
        i = mem.new_cluster()
        self.cmp.open(i)
        new = Cluster(mem, self.cmp, i)
        new.birth_type = btype
        # the reference leaves birth_from uninitialized for "P" births
        # (src/cluster.cpp:331-345); we set it to the source cluster.
        new.birth_from = mini
        new.birth_pval = pval
        # expected==0 yields +inf, as the C++ division does silently
        # (reference: src/cluster.cpp:321-327)
        with np.errstate(divide="ignore"):
            new.birth_fold = self.rs.reads[raw] / expected
        new.birth_e = expected
        new.birth_comp_i = int(self.comp_i[raw])
        new.birth_comp_lam = float(self.comp_lam[raw])
        new.birth_comp_ham = int(self.comp_ham[raw])
        self.clusters.append(new)
        mem.append(i, raw)
        self.update_e[i] = True
        self._assign_center(i)
        return i

    # ----- main loop (reference: src/Rmain.cpp:297-336) -----

    def run(self, max_clust: int = 0):
        from ..trace import PHASES

        opts = self.opts
        with PHASES("engine.compare_init"):
            self.compare(0, opts.USE_KMERS, 1.0)  # no screen on init cluster
        with PHASES("engine.p_update"):
            self.p_update()
        if max_clust < 1:
            max_clust = self.n
        while len(self.clusters) < max_clust:
            with PHASES("engine.bud"):
                newi = self.bud()
            if not newi:
                break
            budded_raw = self.clusters[newi].center
            self.backend.spec_hint = tuple(
                int(r) for r in self.bud_candidates if r != budded_raw)
            with PHASES("engine.compare"):
                self.compare(newi, opts.USE_KMERS, opts.KDIST_CUTOFF)
            self.backend.spec_hint = ()
            nshuffle = 0
            with PHASES("engine.shuffle"):
                while self.shuffle() and nshuffle + 1 < MAX_SHUFFLE:
                    nshuffle += 1
            with PHASES("engine.p_update"):
                self.p_update()
        return self
