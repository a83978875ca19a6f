"""RawSet: struct-of-arrays container for a set of unique sequences.

Replaces the reference's pointer-based Raw/Bi/B containers (reference:
src/dada.h:42-123, src/containers.cpp) with padded tensors ready for TPU
batching.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..encode import kmer_counts, kmer_ords, pack_sequences


@dataclass
class RawSet:
    seqs: np.ndarray      # [n, L] uint8 codes (A=0..T=3, PAD=255)
    lens: np.ndarray      # [n] int32
    reads: np.ndarray     # [n] int64
    priors: np.ndarray    # [n] bool
    quals: Optional[np.ndarray]  # [n, L] uint8 rounded avg quals, or None
    # host k-mer tables are LAZY: the TPU backend derives its device
    # copies from seqs directly (host tables cost ~2s + ~110MB of
    # uploads per production-scale sample), so only host-path consumers
    # (OracleBackend, tests) ever pay for these
    _kmers: Optional[np.ndarray] = field(default=None, repr=False)
    _kords: Optional[np.ndarray] = field(default=None, repr=False)

    @property
    def kords(self) -> np.ndarray:
        """[n, L] int32 ordered k-mer indices (-1 pad), computed on
        first host access."""
        if self._kords is None:
            self._kords = kmer_ords(self.seqs, self.lens)
        return self._kords

    @property
    def kmers(self) -> np.ndarray:
        """[n, 4^k] int32 k-mer count vectors, computed on first host
        access."""
        if self._kmers is None:
            self._kmers = kmer_counts(self.seqs, self.lens,
                                      kord=self.kords)
        return self._kmers

    @property
    def n(self) -> int:
        return len(self.lens)

    @property
    def max_len(self) -> int:
        return self.seqs.shape[1]


def make_rawset(sequences, abundances, priors=None, quals=None) -> RawSet:
    """Build a RawSet from sequences/abundances (reference: src/Rmain.cpp:102-163).

    quals: optional [n, L] float matrix of average quality per position;
    rounded half-away-from-zero to uint8 as in raw_new
    (reference: src/containers.cpp:30-37).
    """
    n = len(sequences)
    seqs, lens = pack_sequences(sequences)
    reads = np.asarray(abundances, dtype=np.int64)
    if priors is None:
        priors = np.zeros(n, dtype=bool)
    else:
        priors = np.asarray(priors, dtype=bool)
    q8 = None
    if quals is not None:
        quals = np.asarray(quals, dtype=np.float64)
        if quals.shape[1] < seqs.shape[1]:
            raise ValueError("quals must cover every sequence position")
        # round half away from zero, like raw_new's (uint8)(qual + 0.5):
        # trunc(q + 0.5) == floor(q + 0.5) for q >= -0.5, and the uint8
        # cast truncates — one add + one cast instead of the
        # floor/where/astype chain (np.floor alone walks ~1s of large-
        # temporary page faults per production-scale sample, see
        # utils/hostmem.py)
        qn = np.where(np.isnan(quals[:, : seqs.shape[1]]), -0.5,
                      quals[:, : seqs.shape[1]])
        q8 = (qn + 0.5).astype(np.uint8)
        pad = np.arange(seqs.shape[1])[None, :] >= lens[:, None]
        q8[pad] = 0
    return RawSet(seqs=seqs, lens=lens, reads=reads, priors=priors,
                  quals=q8)
