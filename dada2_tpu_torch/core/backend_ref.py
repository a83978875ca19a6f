"""NumPy oracle compare-backend: exact but slow; used for tests and as the
semantic target for the TPU backend (core/backend_tpu.py).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..options import DadaOptions
from .engine import CompareBackend
from .raws import RawSet
from ..ops.subs import Sub, al2subs, compute_lambda, raw_align_ref


class OracleBackend(CompareBackend):
    def __init__(self, rawset: RawSet, use_quals: bool = True):
        self.rs = rawset
        self.use_quals = use_quals

    def _pair_sub(self, i0: int, i1: int, opts: DadaOptions, use_kmers: bool,
                  kdist_cutoff: float) -> Optional[Sub]:
        rs = self.rs
        l0, l1 = int(rs.lens[i0]), int(rs.lens[i1])
        al = raw_align_ref(
            rs.seqs[i0, :l0], rs.seqs[i1, :l1],
            rs.kmers[i0], rs.kmers[i1], rs.kords[i0, :l0], rs.kords[i1, :l1],
            opts.MATCH, opts.MISMATCH, opts.GAP_PENALTY,
            opts.HOMOPOLYMER_GAP_PENALTY if opts.HOMOPOLYMER_GAP_PENALTY is not None else opts.GAP_PENALTY,
            use_kmers, kdist_cutoff, opts.BAND_SIZE,
            opts.VECTORIZED_ALIGNMENT, opts.SSE, opts.GAPLESS,
        )
        if al is None:
            return None
        return al2subs(*al)

    def compare(self, center: int, skip: np.ndarray, opts: DadaOptions,
                err: np.ndarray, use_kmers: bool, kdist_cutoff: float,
                e_thresh: Optional[np.ndarray] = None):
        # e_thresh is an optimization hint only; the oracle always
        # computes the exact lambda for every candidate row
        rs = self.rs
        n = rs.n
        lam = np.zeros(n)
        ham = np.full(n, -1, dtype=np.int64)
        for j in range(n):
            if skip[j]:
                continue
            sub = self._pair_sub(center, j, opts, use_kmers, kdist_cutoff)
            if sub is None:
                continue
            l1 = int(rs.lens[j])
            q = rs.quals[j, :l1] if rs.quals is not None else None
            lam[j] = compute_lambda(rs.seqs[j, :l1], q, sub, err, self.use_quals)
            ham[j] = sub.nsubs
        return lam, ham

    def subs_pair(self, i0: int, i1: int, opts: DadaOptions,
                  use_kmers: bool, kdist_cutoff: float) -> Optional[Sub]:
        return self._pair_sub(i0, i1, opts, use_kmers, kdist_cutoff)

    def subs_to_center(self, center: int, members: np.ndarray,
                       opts: DadaOptions) -> List[Optional[Sub]]:
        # use_kmers=False: no kmer screen, no gapless screen
        # (reference: src/Rmain.cpp:209 passes use_kmers=false, cutoff=1.0)
        return [self._pair_sub(center, int(m), opts, False, 1.0)
                for m in members]


class GaplessBackend(CompareBackend):
    """A cheap, exact stand-in for sizing and testing the engine on the
    CPU, for substitution-only samples: each raw is compared with the
    center position by position from the start (no gaps, no k-mer
    screen). Its lambda is the product of the error matrix's entries
    over the raw's positions, a position past the center's end read as
    a match; its ham is the mismatches over the shared positions plus
    the difference in length. It provides compare() alone, so the
    engine runs but finalize does not."""

    ROWS = 2048   # rows a block, to bound the gathered [rows, len] floats

    def __init__(self, rawset: RawSet, use_quals: bool = True):
        self.rs = rawset
        self.use_quals = use_quals and rawset.quals is not None

    def compare(self, center: int, skip: np.ndarray, opts: DadaOptions,
                err: np.ndarray, use_kmers: bool, kdist_cutoff: float,
                e_thresh: Optional[np.ndarray] = None):
        rs = self.rs
        W = rs.max_len
        L0 = int(rs.lens[center])
        s0 = rs.seqs[center].astype(np.int64)
        pos = np.arange(W)
        lam = np.zeros(rs.n)
        ham = np.full(rs.n, -1, dtype=np.int64)
        idx = np.flatnonzero(~skip)
        for lo in range(0, len(idx), self.ROWS):
            rows = idx[lo:lo + self.ROWS]
            s1 = rs.seqs[rows].astype(np.int64)
            mine = pos[None, :] < rs.lens[rows, None]
            both = mine & (pos[None, :] < L0)
            t = np.where(both, 4 * s0[None, :] + s1,
                         np.where(mine, 5 * s1, 0))
            q = (rs.quals[rows] if self.use_quals
                 else np.zeros(s1.shape, np.int64))
            lam[rows] = np.prod(np.where(mine, err[t, q], 1.0), axis=1)
            ham[rows] = ((both & (s1 != s0[None, :])).sum(axis=1)
                         + np.abs(rs.lens[rows].astype(np.int64) - L0))
        return lam, ham
