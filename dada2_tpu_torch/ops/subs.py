"""Substitution extraction, k-mer screens, lambda and abundance p-values.

Host-side exact (float64) implementations that define the semantics the TPU
batch kernels must reproduce. These are small-data operations; the heavy
lifting (alignment DP, k-mer min-sums over all pairs) runs on TPU.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
from scipy import special as _sp

from ..encode import GAP_GLYPH, KMER_SIZE
from .nw_ref import GAP, nw_align_ref, nw_gapless

TAIL_APPROX_CUTOFF = 1e-7  # reference: src/dada.h:25


class Sub(NamedTuple):
    """Compressed alignment: substitutions of seq1 relative to seq0.

    reference: src/dada.h:49-62 and al2subs (src/nwalign_endsfree.cpp:570-639).
    map[i0] = position in seq1 aligned to position i0 of seq0, or GAP_GLYPH.
    """

    nsubs: int
    len0: int
    map: np.ndarray  # [len0] int32
    pos: np.ndarray  # [nsubs] int32 (positions in seq0)
    nt0: np.ndarray  # [nsubs] uint8 codes
    nt1: np.ndarray  # [nsubs] uint8 codes


def al2subs(al0: np.ndarray, al1: np.ndarray) -> Sub:
    """Compress a gapped alignment into a Sub (vectorized).

    reference: src/nwalign_endsfree.cpp:570-639. N's (which we do not encode
    in the dada path — input is validated ACGT) would not create subs.
    """
    is_nt0 = al0 != GAP
    is_nt1 = al1 != GAP
    i0 = np.cumsum(is_nt0) - 1  # position in seq0 at each alignment column
    i1 = np.cumsum(is_nt1) - 1
    len0 = int(is_nt0.sum())
    map_ = np.full(len0, GAP_GLYPH, dtype=np.int32)
    both = is_nt0 & is_nt1
    map_[i0[both]] = i1[both]
    subcols = both & (al0 != al1)
    pos = i0[subcols].astype(np.int32)
    return Sub(
        nsubs=int(subcols.sum()),
        len0=len0,
        map=map_,
        pos=pos,
        nt0=al0[subcols],
        nt1=al1[subcols],
    )


def kmer_dist(kv1: np.ndarray, len1: int, kv2: np.ndarray, len2: int,
              k: int = KMER_SIZE) -> float:
    """1 - (k-mer overlap)/(kmers in shorter seq).

    reference: src/kmers.cpp:13-26. Computed from exact integer min-sums in
    float64 — identical to all three reference precisions (the 8-bit path
    falls back on overflow, src/nwalign_endsfree.cpp:23-26).
    """
    dotsum = int(np.minimum(kv1, kv2).sum())
    return 1.0 - dotsum / (min(len1, len2) - k + 1.0)


def kord_matches(kord1: np.ndarray, len1: int, kord2: np.ndarray, len2: int,
                 k: int = KMER_SIZE) -> int:
    """Number of position-wise equal ordered k-mers over the shorter length.

    reference: src/kmers.cpp:121-150 (SSE variant; computes over the shorter
    length even for different-length pairs, unlike the scalar variant).
    """
    klen = min(len1, len2) - k + 1
    return int((kord1[:klen] == kord2[:klen]).sum())


def gapless_screen(kv1, len1, kv2, len2, kord1, kord2, sse: int = 2,
                   k: int = KMER_SIZE) -> bool:
    """True iff the gapless screen passes (kord_dist == kmer_dist).

    The double equality in the reference (src/nwalign_endsfree.cpp:54) is
    equivalent to integer equality of the match counts since both distances
    share the same denominator and the map s -> 1 - s/d is injective at these
    magnitudes. With SSE=0 the scalar kord_dist returns -1 for length
    mismatches, disabling the screen (src/kmers.cpp:102-116).
    """
    if sse < 1 and len1 != len2:
        return False
    minsum = int(np.minimum(kv1, kv2).sum())
    return kord_matches(kord1, len1, kord2, len2, k) == minsum


def raw_align_ref(
    seq0, seq1, kv0, kv1, kord0, kord1,
    match: int, mismatch: int, gap_p: int, homo_gap_p: int,
    use_kmers: bool, kdist_cutoff: float, band: int,
    vectorized: bool, sse: int, gapless: bool,
):
    """Oracle for raw_align (reference: src/nwalign_endsfree.cpp:10-73).

    Returns (al0, al1) or None if screened out ("shrouded").
    """
    len0, len1 = len(seq0), len(seq1)
    kdist = 0.0
    if use_kmers:
        kdist = kmer_dist(kv0, len0, kv1, len1)
        if kdist > kdist_cutoff:
            return None
    use_gapless = False
    if use_kmers and gapless:
        use_gapless = gapless_screen(kv0, len0, kv1, len1, kord0, kord1, sse)
    if band == 0 or use_gapless:
        return nw_gapless(seq0, seq1)
    if vectorized:
        return nw_align_ref(seq0, seq1, match, mismatch, gap_p, 0, band, mode="vec")
    if homo_gap_p != gap_p and homo_gap_p <= 0:
        return nw_align_ref(seq0, seq1, match, mismatch, gap_p, 0, band,
                            mode="scalar", homo_gap_p=homo_gap_p)
    return nw_align_ref(seq0, seq1, match, mismatch, gap_p, 0, band, mode="scalar")


def compute_lambda(
    seq1: np.ndarray, qual1: Optional[np.ndarray], sub: Optional[Sub],
    err: np.ndarray, use_quals: bool,
) -> float:
    """Self-production probability of seq1 from seq0 given the error matrix.

    lambda = prod over seq1 positions of err[transition, qual], where the
    transition defaults to the self-transition of seq1's nucleotide and is
    replaced by (nt0 -> nt1) at substitution positions mapped through
    sub.map. The product is accumulated sequentially in float64 in position
    order, matching the reference bit-for-bit
    (reference: src/pval.cpp:144-197, compute_lambda_ts).
    """
    if sub is None:
        return 0.0
    len1 = len(seq1)
    nti1 = seq1.astype(np.int64)
    tvec = nti1 * 4 + nti1
    if use_quals:
        qind = qual1.astype(np.int64)
    else:
        qind = np.zeros(len1, dtype=np.int64)
    if sub.nsubs:
        pos1 = sub.map[sub.pos]
        tvec[pos1] = sub.nt0.astype(np.int64) * 4 + sub.nt1.astype(np.int64)
    factors = err[tvec, qind]
    lam = 1.0
    for f in factors:  # sequential, order-exact float64 product
        lam *= f
    if lam < 0 or lam > 1:
        raise ValueError("Bad lambda.")
    return lam


def pois_tail(reads: int, e_reads: float) -> float:
    """P(X > reads-1 | Poisson(e_reads)), R-exact.

    The reference calls R's ppois(reads-1, E, lower.tail=FALSE)
    (src/pval.cpp:44-51). utils/rmath.py implements R's own pgamma
    machinery (documented by the reference at src/pval.cpp:199-339) so
    p-values match R bit-for-bit — cephes (scipy pdtrc) differs from R
    in the last ulp and at the subnormal boundary, enough to flip bud
    decisions near OMEGA_A=1e-40.
    """
    from ..utils.rmath import ppois_upper

    return ppois_upper(reads - 1, e_reads)


def calc_pA(reads: int, e_reads: float, prior: bool) -> float:
    """Abundance p-value (reference: src/pval.cpp:44-64).

    Uses libm exp (math.exp), as the reference's C exp() does — numpy's
    SIMD exp can differ in the last ulp."""
    import math

    pval = pois_tail(reads, e_reads)
    if not prior:
        norm = 1.0 - math.exp(-e_reads)
        if norm < TAIL_APPROX_CUTOFF:
            norm = e_reads - 0.5 * e_reads * e_reads
        pval = pval / norm
    return pval


def get_pA(reads: int, prior: bool, lam: float, hamming: int, bi_reads: int,
           detect_singletons: bool) -> float:
    """Abundance p-value of a raw within its partition.

    reference: src/pval.cpp:67-89.
    """
    if reads == 1 and not prior and not detect_singletons:
        return 1.0
    if hamming == 0:
        return 1.0
    if lam == 0:
        return 0.0
    return calc_pA(reads, lam * bi_reads, prior or detect_singletons)
