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
