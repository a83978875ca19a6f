"""Output assembly of one sample (clustering table, transition counts,
cluster quality profiles, birth substitutions, uniques -> ASV map): a
frozen copy of the program's host code (DADA2 src/Rmain.cpp:172-295,
src/error.cpp). Every accumulated statistic is integer-valued, so the
tallies are exact in any order.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import pandas as pd

from .engine import Engine
from .pvals import Sub, calc_pA
from .seqs import codes_to_seq

_NT = "ACGT"
TRANS_ROWS = [f"{a}2{b}" for a in _NT for b in _NT]


def finalize(eng: Engine, opts, err_ncol: int,
             omegaC: float) -> dict:
    """Run the final-subs pass and assemble all outputs.

    Returns dict with keys: clustering (DataFrame), birth_subs (DataFrame),
    subqual ([16, Q] int64), clusterquals ([maxlen, nclust] float64),
    map ([n] int64, -1 for NA), pval ([n] float64).
    """
    rs = eng.rs
    nclust = len(eng.clusters)
    has_quals = rs.quals is not None

    # Final within-cluster p and the OMEGA_C correction gate
    # (reference: src/Rmain.cpp:238-252; prior=TRUE there, so the pval is
    # the bare Poisson tail with no presence conditioning). Runs BEFORE
    # the stats pass: the tallies are weighted by the correct mask.
    pvals = np.zeros(rs.n)
    if True:
        for i, bi in enumerate(eng.clusters):
            mem = np.asarray(bi.slots, dtype=np.int64)
            eng.p[bi.center] = 1.0
            notc = mem[mem != bi.center]
            if len(notc):
                from .rmath import ppois_upper_vec

                E = eng.comp_lam[notc] * bi.reads
                # R-exact Poisson tail (see ops/subs.py pois_tail)
                pv = ppois_upper_vec(rs.reads[notc] - 1, E)
                eng.p[notc] = pv
                eng.correct[notc[pv < omegaC]] = False
            pvals[mem] = eng.p[mem]

    # Final subs statistics for every raw vs its cluster center, and
    # birth subs (reference: src/Rmain.cpp:174-236 + src/error.cpp).
    # One batched device tally per cluster (the reference's
    # FinalSubsParallel TBB loop + per-raw Sub walks), interleaved across
    # threads to overlap dispatch latency.
    ncol_t = err_ncol if has_quals else 1
    stats = [None] * nclust    # (members, trans, qacc, qcnt, nsubs)
    birth_subs: List[Optional[Sub]] = [None] * nclust

    if True:
        # every cluster's tallies in one fused device dispatch (one
        # round-trip instead of nclust; reference: FinalSubsParallel's
        # TBB loop, src/Rmain.cpp:179-236)
        member_arrs = [np.asarray(bi.slots, dtype=np.int64)
                       for bi in eng.clusters]
        allstats = eng.backend.cluster_stats_all(
            [(bi.center, mem, eng.correct[mem])
             for bi, mem in zip(eng.clusters, member_arrs)],
            opts, ncol_t, has_quals)
        for i in range(nclust):
            stats[i] = (member_arrs[i], *allstats[i])

    if True:
        # all birth pairs in one fused fetch (one round-trip instead of
        # ~4 per cluster)
        bpairs = [(eng.clusters[eng.clusters[i].birth_comp_i].center,
                   eng.clusters[i].center) for i in range(1, nclust)]
        if bpairs:
            subs = eng.backend.subs_pairs(bpairs, opts, opts.USE_KMERS,
                                          1.0)
            for i, s in zip(range(1, nclust), subs):
                birth_subs[i] = s

    clustering = _clustering_df(eng, stats, birth_subs, has_quals)
    subqual = np.zeros((16, ncol_t), dtype=np.int64)
    for i in range(nclust):
        subqual += stats[i][1]
    clusterquals = _cluster_quality_matrix(eng, stats, has_quals,
                                           rs.max_len)
    birth_df = _birth_subs_df(eng, birth_subs, has_quals)

    # map from uniques to cluster, -1 where not corrected
    # (reference: src/Rmain.cpp:268-279, NA -> -1 here; R adds 1-indexing)
    map_ = np.full(rs.n, -1, dtype=np.int64)
    for i, bi in enumerate(eng.clusters):
        mem = np.asarray(bi.slots, dtype=np.int64)
        map_[mem[eng.correct[mem]]] = i

    return dict(clustering=clustering, birth_subs=birth_df, subqual=subqual,
                clusterquals=clusterquals, map=map_, pval=pvals)


def _clustering_df(eng: Engine, stats, birth_subs, has_quals) -> pd.DataFrame:
    """reference: src/error.cpp:9-127."""
    rs = eng.rs
    nclust = len(eng.clusters)
    seqs, abund, n0, n1, nunq = [], [], [], [], []
    b_from, b_pval, b_fold, b_ham, b_qave = [], [], [], [], []
    for i, bi in enumerate(eng.clusters):
        members, _, _, _, nsubs = stats[i]
        reads = rs.reads[members]
        # representative sequence: most abundant member, first-slot ties
        best = int(members[np.argmax(reads)]) if len(members) else -1
        corr = eng.correct[members]
        withsub = corr & (nsubs >= 0)
        seqs.append(codes_to_seq(rs.seqs[best, : rs.lens[best]]))
        abund.append(int(reads[corr].sum()))
        n0.append(int(reads[withsub & (nsubs == 0)].sum()))
        n1.append(int(reads[withsub & (nsubs == 1)].sum()))
        nunq.append(int(corr.sum()))
        if i == 0:
            b_from.append(np.nan)
            b_pval.append(np.nan)
            b_fold.append(np.nan)
            b_ham.append(np.nan)
            b_qave.append(np.nan)
        else:
            b_from.append(bi.birth_from + 1)  # 1-based like the reference
            b_pval.append(bi.birth_pval)
            b_fold.append(bi.birth_fold)
            b_ham.append(bi.birth_comp_ham)
            if has_quals:
                s = birth_subs[i]
                qave = 0.0
                if s is not None and s.nsubs:
                    q1 = _sub_q1(eng, i, s)
                    qave = float(np.sum(q1.astype(np.float64))) / s.nsubs
                b_qave.append(qave)
            else:
                b_qave.append(np.nan)

    # post-hoc pvalue from summed cross-cluster E (reference: error.cpp:99-119)
    center_map = np.full(rs.n, -1, np.int64)
    for i, bi in enumerate(eng.clusters):
        if bi.center >= 0:
            center_map[bi.center] = i
    tot_e = np.zeros(nclust)
    for i, bi in enumerate(eng.clusters):
        cidx, clam, _ = bi.comps()
        if not len(cidx):
            continue
        j = center_map[cidx]
        keep = (j >= 0) & (j != i)
        # np.add.at applies repeated indices in operand order, so the
        # f64 accumulation order matches the reference's per-comparison
        # walk exactly (src/error.cpp:99-119)
        np.add.at(tot_e, j[keep], clam[keep] * bi.reads)
    pval = np.array([
        calc_pA(int(rs.reads[bi.center]), tot_e[i], True)
        for i, bi in enumerate(eng.clusters)
    ])

    return pd.DataFrame(dict(
        sequence=seqs, abundance=np.array(abund, dtype=np.int64),
        n0=np.array(n0, dtype=np.int64), n1=np.array(n1, dtype=np.int64),
        nunq=np.array(nunq, dtype=np.int64), pval=pval,
        birth_from=b_from, birth_pval=b_pval, birth_fold=b_fold,
        birth_ham=b_ham, birth_qave=b_qave,
    ))


def _sub_q1(eng: Engine, i: int, s: Sub) -> np.ndarray:
    """Qualities of the new center at birth-substitution positions.

    reference: sub_new quality attachment (src/nwalign_endsfree.cpp:650-663).
    """
    raw1 = eng.clusters[i].center
    pos1 = s.map[s.pos]
    return eng.rs.quals[raw1, pos1]


def _cluster_quality_matrix(eng: Engine, stats, has_quals, maxlen) -> np.ndarray:
    """Average positional quality per cluster (reference:
    src/error.cpp:225-258 — integer-valued accumulations, so the exact
    integer tallies divide to the reference's doubles exactly)."""
    rs = eng.rs
    nclust = len(eng.clusters)
    out = np.zeros((maxlen, nclust))
    if not has_quals:
        return out
    for i, bi in enumerate(eng.clusters):
        _, _, qacc, qcnt, _ = stats[i]
        seqlen = int(rs.lens[bi.center])
        with np.errstate(invalid="ignore", divide="ignore"):
            out[:seqlen, i] = qacc.astype(np.float64) / qcnt
        out[seqlen:, i] = np.nan
    return out


def _birth_subs_df(eng: Engine, birth_subs, has_quals) -> pd.DataFrame:
    """reference: src/error.cpp:261-300."""
    pos, nt0, nt1, qual, clust = [], [], [], [], []
    for i, s in enumerate(birth_subs):
        if s is None:
            continue
        for k in range(s.nsubs):
            pos.append(int(s.pos[k]) + 1)
            nt0.append(_NT[s.nt0[k]])
            nt1.append(_NT[s.nt1[k]])
            if has_quals:
                q1 = _sub_q1(eng, i, s)
                qual.append(float(q1[k]))
            else:
                qual.append(np.nan)
            clust.append(i + 1)
    return pd.DataFrame(dict(
        pos=np.array(pos, dtype=np.int64), ref=nt0, sub=nt1,
        qual=np.array(qual), clust=np.array(clust, dtype=np.int64),
    ))
