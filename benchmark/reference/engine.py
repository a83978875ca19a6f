"""The DADA2 divisive partitioning engine: a frozen copy of the program's
host engine (DADA2 src/Rmain.cpp:297-336 run_dada, src/cluster.cpp) with
its plain paths only (no native shuffle, no tracing), driven here by the
reference backend. Slot order follows the reference's swap-with-last pops
(src/containers.cpp:183-197): it decides ties in budding and the order of
floating-point accumulations in the outputs.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from .seqs import GAP_GLYPH, RawSet
from .pvals import Sub

MAX_SHUFFLE = 10  # reference: src/dada.h:30


@dataclass
class Cluster:
    """One partition (Bi). reference: src/dada.h:85-105."""

    slots: List[int]                    # raw indices in slot order
    center: int = -1                    # raw index of the center
    reads: int = 0
    update_e: bool = True
    check_locks: bool = True
    birth_type: str = "I"
    birth_from: int = 0
    birth_pval: float = 0.0
    birth_fold: float = 1.0
    birth_e: float = 0.0
    birth_comp_i: int = 0
    birth_comp_lam: float = 0.0
    birth_comp_ham: int = 0
    # comparisons stored for this cluster: per-compare numpy chunks in
    # insertion order, concatenated lazily (python float lists cost
    # tens of ms per shuffle at production scale)
    comp_chunks: list = field(default_factory=list)
    _comp_cache: Optional[tuple] = field(default=None, repr=False)

    def add_comps(self, idx: np.ndarray, lam: np.ndarray,
                  ham: np.ndarray) -> None:
        if len(idx):
            self.comp_chunks.append((idx, lam, ham))

    def comps(self):
        """(index, lam, ham) arrays over all stored comparisons, in
        insertion order."""
        nch = len(self.comp_chunks)
        if nch == 0:
            return (np.zeros(0, np.int64), np.zeros(0),
                    np.zeros(0, np.int64))
        if nch == 1:
            return self.comp_chunks[0]
        if self._comp_cache is None or self._comp_cache[0] != nch:
            self._comp_cache = (
                nch,
                np.concatenate([c[0] for c in self.comp_chunks]),
                np.concatenate([c[1] for c in self.comp_chunks]),
                np.concatenate([c[2] for c in self.comp_chunks]))
        return self._comp_cache[1:]


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

    def compare(self, center: int, skip: np.ndarray, opts,
                err: np.ndarray, use_kmers: bool, kdist_cutoff: float,
                e_thresh: Optional[np.ndarray] = None):
        raise NotImplementedError

    def subs_pair(self, i0: int, i1: int, opts,
                  use_kmers: bool, kdist_cutoff: float) -> Optional[Sub]:
        """Full Sub for one pair (used for birth subs)."""
        raise NotImplementedError

    def subs_to_center(self, center: int, members: np.ndarray,
                       opts) -> List[Optional[Sub]]:
        """Final subs of members vs center, use_kmers=False semantics.

        reference: src/Rmain.cpp:206-235 (FinalSubsParallel).
        """
        raise NotImplementedError

    def subs_pairs(self, pairs, opts, use_kmers: bool,
                   kdist_cutoff: float):
        """subs_pair for a batch of (from, to) center pairs. Backends
        may override with one fused device fetch."""
        return [self.subs_pair(a, b, opts, use_kmers, kdist_cutoff)
                for a, b in pairs]

    def cluster_stats_all(self, clusters, opts, ncol: int,
                          use_quals: bool):
        """cluster_stats for EVERY cluster: clusters is a list of
        (center, members, correct) triples; returns the per-cluster
        (trans, qacc, qcnt, nsubs) list. Backends may override with one
        fused device dispatch (one round-trip instead of nclust)."""
        return [self.cluster_stats(c, m, corr, opts, ncol, use_quals)
                for c, m, corr in clusters]

    def subs_info(self, center: int, members: np.ndarray,
                  opts):
        """Batched final-subs summary: (p1mat [m, len0] int64 query
        positions with GAP_GLYPH at gaps, or -1 rows for screened-out
        members; nsubs [m] int64, -1 for screened-out). Semantically the
        map/nsubs fields of subs_to_center, in matrix form so the output
        assembly can stay vectorized. Backends may override with a
        batched implementation."""
        _GG = GAP_GLYPH
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
                      correct: np.ndarray, opts, ncol: int,
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
        _GG = GAP_GLYPH
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

    def __init__(self, rawset: RawSet, err: np.ndarray, opts,
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
        self.cluster_of = np.zeros(n, dtype=np.int64)
        self.clusters: List[Cluster] = []
        self.nalign = 0
        self.nshroud = 0
        self.bud_candidates = np.zeros(0, np.int64)
        self._init_clusters()

    # ----- container ops (reference: src/containers.cpp) -----

    def _init_clusters(self):
        c = Cluster(slots=list(range(self.n)))
        c.reads = self.total_reads
        c.birth_e = float(self.total_reads)
        self.clusters = [c]
        self.cluster_of[:] = 0
        self._assign_center(c)

    def _assign_center(self, bi: Cluster):
        """Most abundant member becomes center; ties keep the lowest slot.

        reference: src/cluster.cpp:371-386. Unlocks all members.
        """
        best = -1
        if bi.slots:
            arr = np.asarray(bi.slots, dtype=np.int64)
            self.lock[arr] = False
            reads = self.rs.reads[arr]
            if reads.max() > 0:
                # strict > running max: earliest slot wins ties
                best = int(arr[int(np.argmax(reads))])
        bi.center = best
        bi.check_locks = True

    def _pop_raw(self, bi: Cluster, slot: int) -> int:
        raw = bi.slots[slot]
        bi.slots[slot] = bi.slots[-1]
        bi.slots.pop()
        bi.reads -= int(self.rs.reads[raw])
        bi.update_e = True
        return raw

    def _add_raw(self, bi: Cluster, raw: int):
        bi.slots.append(raw)
        bi.reads += int(self.rs.reads[raw])
        bi.update_e = True

    # ----- compare (reference: src/cluster.cpp:13-204) -----

    def compare(self, i: int, use_kmers: bool, kdist_cutoff: float):
        bi = self.clusters[i]
        center = bi.center
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
        bi.add_comps(idx, lam[idx], ham[idx])
        if i == 0:
            self.comp_i[idx] = i
            self.comp_lam[idx] = lam[idx]
            self.comp_ham[idx] = ham[idx]
        elif store[center]:
            self.comp_i[center] = i
            self.comp_lam[center] = lam[center]
            self.comp_ham[center] = ham[center]

    # ----- shuffle (reference: src/cluster.cpp:210-266) -----

    def shuffle(self) -> bool:
        n = self.n
        # Initialize best-E from cluster 0, whose comp list has one entry per
        # raw in index order (full compare at init).
        _, c0lam, c0ham = self.clusters[0].comps()
        if True:
            emax = c0lam * self.clusters[0].reads
            best_i = np.zeros(n, dtype=np.int64)
            best_lam = c0lam.copy()
            best_ham = np.asarray(c0ham, dtype=np.int64).copy()
            for i in range(1, len(self.clusters)):
                bi = self.clusters[i]
                idx, lam, ham_c = bi.comps()
                if not len(idx):
                    continue
                e = lam * bi.reads
                upd = e > emax[idx]   # strict: ties keep earlier cluster
                uidx = idx[upd]
                emax[uidx] = e[upd]
                best_i[uidx] = i
                best_lam[uidx] = lam[upd]
                best_ham[uidx] = np.asarray(ham_c, dtype=np.int64)[upd]

        # Surgery only at mover positions. Reading movers off the
        # pre-loop slot arrays is exact: the reference's descending
        # visit order means position r still holds its original raw
        # when visited (pops only rewrite the visited position and the
        # tail, both already visited), and tail elements swapped into
        # holes are never revisited.
        shuffled = False
        mv_raws, mv_tgts = [], []
        for i in range(len(self.clusters)):
            bi = self.clusters[i]
            slots = bi.slots
            if not slots:
                continue
            arr = np.asarray(slots, dtype=np.int64)
            pos = np.nonzero((best_i[arr] != i)
                             & (arr != bi.center))[0]
            if not len(pos):
                continue
            raws = arr[pos]
            for r in pos[::-1]:           # descending, movers only
                slots[r] = slots[-1]
                slots.pop()
            bi.reads -= int(self.rs.reads[raws].sum())
            bi.update_e = True
            # append order = clusters ascending, slot position descending
            mv_raws.append(raws[::-1])
            mv_tgts.append(best_i[raws[::-1]])
            shuffled = True
        if not shuffled:
            return False
        raws = np.concatenate(mv_raws)
        tgts = np.concatenate(mv_tgts)
        self.cluster_of[raws] = tgts
        self.comp_i[raws] = tgts
        self.comp_lam[raws] = best_lam[raws]
        self.comp_ham[raws] = best_ham[raws]
        for t in np.unique(tgts):
            ti = self.clusters[t]
            tr = raws[tgts == t]
            ti.slots.extend(tr.tolist())
            ti.reads += int(self.rs.reads[tr].sum())
            ti.update_e = True
        return shuffled

    # ----- p-value update (reference: src/pval.cpp:14-40) -----

    def p_update(self):
        opts = self.opts
        for bi in self.clusters:
            if bi.update_e:
                idx = np.asarray(bi.slots, dtype=np.int64)
                self.p[idx] = self._get_pA_vec(idx, bi.reads)
                bi.update_e = False
            if opts.GREEDY and bi.check_locks:
                idx = np.asarray(bi.slots, dtype=np.int64)
                e_center = self.rs.reads[bi.center] * self.comp_lam[idx]
                self.lock[idx[e_center > self.rs.reads[idx]]] = True
                self.lock[bi.center] = True
                bi.check_locks = False

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

            from .rmath import ppois_upper_vec

            E = lam[need] * bi_reads
            # R-exact Poisson tail (see ops/subs.py pois_tail): scipy's
            # pdtrc drifts from R's ppois in the last ulp
            pv = ppois_upper_vec(reads[need] - 1, E)
            cond = ~(prior[need] | opts.DETECT_SINGLETONS)
            # libm exp (not numpy's SIMD exp, which can differ in the
            # last ulp): the reference's calc_pA calls C exp()
            # (reference: src/pval.cpp:55)
            norm = 1.0 - np.array([math.exp(-e) for e in E])
            small = norm < 1e-7  # TAIL_APPROX_CUTOFF, src/dada.h:25
            norm = np.where(small, E - 0.5 * E * E, norm)
            out[need] = np.where(cond, pv / norm, pv)
        return out

    # ----- bud (reference: src/cluster.cpp:274-350) -----

    def bud(self) -> int:
        opts = self.opts
        min_fold, min_hamming, min_abund = (
            opts.MIN_FOLD, opts.MIN_HAMMING, opts.MIN_ABUNDANCE)
        # Sentinel = cluster 0's center (reference init, cluster.cpp:280-281)
        c0 = self.clusters[0].center
        sentinel = (self.p[c0], -int(self.rs.reads[c0]))

        # Vectorized scan over all non-center slots in (cluster, slot)
        # iteration order; ties pick the earliest position, exactly like
        # the reference's strict-< running minimum (cluster.cpp:283-311).
        parts, ridx, rcl, rslot = [], [], [], []
        for i, bi in enumerate(self.clusters):
            ns = len(bi.slots) - 1
            if ns <= 0:
                continue
            ridx.append(np.asarray(bi.slots[1:], dtype=np.int64))
            parts.append(np.full(ns, float(bi.reads)))
            rcl.append(np.full(ns, i, dtype=np.int64))
            rslot.append(np.arange(1, ns + 1, dtype=np.int64))
        if not parts:
            return 0
        raws = np.concatenate(ridx)
        bireads = np.concatenate(parts)
        reads = self.rs.reads[raws]
        elig = reads >= min_abund
        elig &= self.comp_ham[raws] >= min_hamming
        if min_fold > 1:
            # same float op order as the scalar form:
            # (min_fold * lam) * bi.reads
            elig &= reads >= (min_fold * self.comp_lam[raws]) * bireads

        def _argbest(mask):
            """Index of the lexicographic min (p, -reads) over mask;
            earliest position wins ties. None if empty/not < sentinel."""
            if not mask.any():
                return None
            pm = self.p[raws]
            best_p = pm[mask].min()
            m2 = mask & (pm == best_p)
            best_reads = reads[m2].max()
            m3 = m2 & (reads == best_reads)
            if (best_p, -int(best_reads)) >= sentinel:
                return None
            return int(np.nonzero(m3)[0][0])

        jA = _argbest(elig)
        jP = _argbest(elig & self.rs.priors[raws])
        cl = np.concatenate(rcl)
        sl = np.concatenate(rslot)

        # ranked next-bud candidates for speculative prefetch (pure
        # prediction: tie order does not matter here). Raws captured by
        # the upcoming cluster drop out of contention, so rank by the
        # CURRENT (p, -reads) — the same key bud() minimizes — and only
        # raws whose current p could actually pass the OMEGA gates
        # qualify (a hint that cannot bud is a guaranteed-wasted
        # prefetch; p-values only rise as E_minmax tightens).
        if elig.any():
            pe = self.p[raws[elig]]
            re_ = reads[elig]
            # 1e6 slack: shuffle can LOWER a raw's p before the next
            # bud (its cluster shrinks), so only clearly-hopeless
            # hints are filtered
            passable = ((pe * self.n < opts.OMEGA_A * 1e6)
                        | (self.rs.priors[raws[elig]]
                           & (pe < opts.OMEGA_P * 1e6)))
            order = np.lexsort((-re_, pe))
            order = order[passable[order]][:17]
            self.bud_candidates = raws[elig][order]
        else:
            self.bud_candidates = np.zeros(0, np.int64)

        def _at(j):
            return (int(cl[j]), int(sl[j]), int(raws[j]))

        pA = (self.p[raws[jA]] if jA is not None else sentinel[0]) * self.n
        pP = self.p[raws[jP]] if jP is not None else sentinel[0]
        # Bonferroni x nraw (reference: cluster.cpp:313)
        if pA < opts.OMEGA_A and jA is not None:
            return self._do_bud(_at(jA), "A", pA)
        elif pP < opts.OMEGA_P and jP is not None:
            return self._do_bud(_at(jP), "P", pP)
        return 0

    def _do_bud(self, at, btype: str, pval: float) -> int:
        mini, minr, raw = at
        bi = self.clusters[mini]
        expected = self.comp_lam[raw] * bi.reads
        self._pop_raw(bi, minr)
        new = Cluster(slots=[])
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
        i = len(self.clusters) - 1
        self._add_raw(new, raw)
        self.cluster_of[raw] = i
        self._assign_center(new)
        return i

    # ----- main loop (reference: src/Rmain.cpp:297-336) -----

    def run(self, max_clust: int = 0):
        opts = self.opts
        self.compare(0, opts.USE_KMERS, 1.0)  # no screen on init cluster
        self.p_update()
        if max_clust < 1:
            max_clust = self.n
        while len(self.clusters) < max_clust:
            newi = self.bud()
            if not newi:
                break
            budded_raw = self.clusters[newi].center
            self.backend.spec_hint = tuple(
                int(r) for r in self.bud_candidates if r != budded_raw)
            self.compare(newi, opts.USE_KMERS, opts.KDIST_CUTOFF)
            self.backend.spec_hint = ()
            nshuffle = 0
            while self.shuffle() and nshuffle + 1 < MAX_SHUFFLE:
                nshuffle += 1
            self.p_update()
        return self
