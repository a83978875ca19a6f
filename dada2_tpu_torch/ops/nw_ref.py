"""NumPy oracle for banded ends-free Needleman–Wunsch with DADA2 semantics.

This module is the *semantic specification* used to validate the TPU kernels
(see ops/nw_batch.py). It implements, in clean row-major (i, j) input
coordinates, exactly the alignments produced by the reference:

* ``mode="vec"`` — the hot-path aligner (reference: src/nwalign_vectorized.cpp
  :71-318). The reference computes this on antidiagonals with a swap trick so
  that results are invariant to argument order; we derived the equivalent
  input-coordinate rules (documented inline) rather than porting the
  antidiagonal index bookkeeping.
* ``mode="scalar"`` — the classic ends-free aligner used by ``nwalign``/
  mergePairs (reference: src/nwalign_endsfree.cpp:76-216) and its
  homopolymer (:220-396) and global (:403-537) variants. Unlike "vec" these
  are NOT symmetric under argument swap.

Conventions: sequences are uint8 code arrays (A=0..T=3). Pointers are
1 = diagonal, 2 = consume s2 / gap in s1 ("left"), 3 = consume s1 / gap in
s2 ("up"). Gap code in output alignment arrays is 254.

Derived input-coordinate semantics of the "vec" aligner
-------------------------------------------------------
Let lband = band + max(0, len1-len2) and rband = band + max(0, len2-len1)
(band < 0 disables banding). Cell (i, j) is in-band iff i-j <= lband and
j-i <= rband. Interior recurrence: U = d[i-1,j]+gap, L = d[i,j-1]+gap,
D = d[i-1,j-1]+sub, with tie precedence U >= L > D (diag only on strict
improvement). The swap trick in the reference makes this hold in input
coordinates for both length orders (verified: dploop_vec/dploop_vec_swap,
src/nwalign_vectorized.cpp:8-59). Boundary: (0,j) = j'th multiple of
end_gap_p with pointer L for j <= min(rband,len2); (i,0) likewise pointer U.
When end_gap_p > gap (ends-free), last-row cells (len1, j) additionally
consider the free candidate d[len1,j-1]+end_gap_p with pointer L, applied
*after* the 3-way max; on ties it overrides only a diagonal pointer. Last-col
cells (i, len2) consider d[i-1,len2]+end_gap_p with pointer U; on ties it
overrides both L and D. The first in-band cell of the last row/col is skipped
(the reference's recalc flags activate one antidiagonal late; verified
against src/nwalign_vectorized.cpp:186-215). At the corner the row rule is
applied before the column rule.
"""
from __future__ import annotations

import numpy as np

GAP = 254
NEG = -(2**29)


def _bands(len1: int, len2: int, band: int):
    if band < 0:
        return len1, len2
    if len2 > len1:
        return band, band + (len2 - len1)
    if len1 > len2:
        return band + (len1 - len2), band
    return band, band


def nw_align_ref(
    s1: np.ndarray,
    s2: np.ndarray,
    match: int,
    mismatch: int,
    gap_p: int,
    end_gap_p: int = 0,
    band: int = -1,
    mode: str = "vec",
    homo_gap_p: int | None = None,
):
    """Align two code arrays; return (al1, al2) gapped uint8 arrays.

    mode="vec": reference src/nwalign_vectorized.cpp:71-318 semantics.
    mode="scalar": reference src/nwalign_endsfree.cpp:76-216 (endsfree when
      end_gap_p != gap_p) or :403-537 (global when end_gap_p == gap_p);
      homo_gap_p enables the homopolymer variant (:220-396).
    """
    if mode == "vec":
        return _nw_vec(s1, s2, match, mismatch, gap_p, end_gap_p, band)
    elif mode == "scalar":
        return _nw_scalar(s1, s2, match, mismatch, gap_p, end_gap_p, band, homo_gap_p)
    raise ValueError(f"unknown mode {mode}")


def _traceback(p: np.ndarray, s1: np.ndarray, s2: np.ndarray):
    len1, len2 = len(s1), len(s2)
    a1, a2 = [], []
    i, j = len1, len2
    while i > 0 or j > 0:
        ptr = p[i, j]
        if ptr == 1:
            i -= 1
            j -= 1
            a1.append(s1[i])
            a2.append(s2[j])
        elif ptr == 2:
            j -= 1
            a1.append(GAP)
            a2.append(s2[j])
        elif ptr == 3:
            i -= 1
            a1.append(s1[i])
            a2.append(GAP)
        else:
            raise RuntimeError("N-W Align out of range.")
    return (
        np.array(a1[::-1], dtype=np.uint8),
        np.array(a2[::-1], dtype=np.uint8),
    )


def _nw_vec(s1, s2, match, mismatch, gap_p, end_gap_p, band):
    len1, len2 = len(s1), len(s2)
    lband, rband = _bands(len1, len2, band)
    d = np.full((len1 + 1, len2 + 1), NEG, dtype=np.int64)
    p = np.zeros((len1 + 1, len2 + 1), dtype=np.int8)

    d[0, 0] = 0
    for i in range(1, min(lband, len1) + 1):
        d[i, 0] = i * end_gap_p
        p[i, 0] = 3
    for j in range(1, min(rband, len2) + 1):
        d[0, j] = j * end_gap_p
        p[0, j] = 2

    endsfree = end_gap_p > gap_p
    # first in-band cells of the last row / last col are skipped by the
    # reference's recalc flags (activated one antidiagonal late) — but
    # ONLY when the band actually clips that side; with lband >= len1 the
    # whole left column is prefilled and the recalc starts at j=1
    # (reference: src/nwalign_vectorized.cpp:186-215, recalc_left
    # activation at i_max==len1-1)
    j_first = len1 - lband if lband < len1 else 0
    i_first = len2 - rband if rband < len2 else 0

    for i in range(1, len1 + 1):
        lo = max(1, i - lband)
        hi = min(len2, i + rband)
        for j in range(lo, hi + 1):
            U = d[i - 1, j] + gap_p
            L = d[i, j - 1] + gap_p
            D = d[i - 1, j - 1] + (match if s1[i - 1] == s2[j - 1] else mismatch)
            if U >= L:
                entry, ptr = U, 3
            else:
                entry, ptr = L, 2
            if D > entry:
                entry, ptr = D, 1
            # ends-free recalc on the last row (free L), then last col (free U)
            if endsfree and i == len1 and j > j_first:
                cand = d[len1, j - 1] + end_gap_p
                if cand > entry:
                    entry, ptr = cand, 2
                elif cand == entry and ptr == 1:
                    ptr = 2
            if endsfree and j == len2 and i > i_first:
                cand = d[i - 1, len2] + end_gap_p
                if cand > entry:
                    entry, ptr = cand, 3
                elif cand == entry and ptr != 3:
                    ptr = 3
            d[i, j] = entry
            p[i, j] = ptr
    return _traceback(p, s1, s2)


def _homo_mask(s: np.ndarray) -> np.ndarray:
    """True at positions inside a homopolymer run of length >= 3.

    reference: src/nwalign_endsfree.cpp:227-255.
    """
    n = len(s)
    out = np.zeros(n, dtype=bool)
    i = 0
    while i < n:
        j = i
        while j + 1 < n and s[j + 1] == s[i]:
            j += 1
        if j - i >= 2:
            out[i : j + 1] = True
        i = j + 1
    return out


def _nw_scalar(s1, s2, match, mismatch, gap_p, end_gap_p, band, homo_gap_p):
    len1, len2 = len(s1), len(s2)
    lband, rband = _bands(len1, len2, band)
    endsfree = end_gap_p != gap_p  # endsfree iff end gaps are free (0)

    use_homo = homo_gap_p is not None and homo_gap_p != gap_p and endsfree
    if use_homo:
        homo1 = _homo_mask(s1)
        homo2 = _homo_mask(s2)

    d = np.zeros((len1 + 1, len2 + 1), dtype=np.int64)
    p = np.zeros((len1 + 1, len2 + 1), dtype=np.int8)
    if endsfree:
        d[:, 0] = 0
        d[0, :] = 0
    else:
        d[:, 0] = np.arange(len1 + 1, dtype=np.int64) * gap_p
        d[0, :] = np.arange(len2 + 1, dtype=np.int64) * gap_p
    p[:, 0] = 3
    p[0, :] = 2
    p[0, 0] = 0

    # band boundary fill: the reference uses the magic value -9999
    # (src/nwalign_endsfree.cpp:113-119) which we reproduce exactly,
    # including its potential to leak for very long sequences.
    banded = band >= 0 and (band < len1 or band < len2)
    if banded:
        for i in range(0, len1 + 1):
            if i - lband - 1 >= 0:
                d[i, i - lband - 1] = -9999
            if i + rband + 1 <= len2:
                d[i, i + rband + 1] = -9999

    for i in range(1, len1 + 1):
        if band >= 0:
            lo = max(1, i - lband)
            hi = min(len2, i + rband)
        else:
            lo, hi = 1, len2
        for j in range(lo, hi + 1):
            if endsfree and i == len1:
                L = d[i, j - 1]
            elif use_homo and homo2[j - 1]:
                L = d[i, j - 1] + homo_gap_p
            else:
                L = d[i, j - 1] + gap_p
            if endsfree and j == len2:
                U = d[i - 1, j]
            elif use_homo and homo1[i - 1]:
                U = d[i - 1, j] + homo_gap_p
            else:
                U = d[i - 1, j] + gap_p
            D = d[i - 1, j - 1] + (match if s1[i - 1] == s2[j - 1] else mismatch)
            # tie precedence (src/nwalign_endsfree.cpp:147-156): U, then L, then D
            if U >= D and U >= L:
                d[i, j] = U
                p[i, j] = 3
            elif L >= D:
                d[i, j] = L
                p[i, j] = 2
            else:
                d[i, j] = D
                p[i, j] = 1
    return _traceback(p, s1, s2)


def nw_gapless(s1: np.ndarray, s2: np.ndarray):
    """Trivial pad-to-length alignment (reference: src/nwalign_endsfree.cpp:539-555)."""
    L = max(len(s1), len(s2))
    a1 = np.full(L, GAP, dtype=np.uint8)
    a2 = np.full(L, GAP, dtype=np.uint8)
    a1[: len(s1)] = s1
    a2[: len(s2)] = s2
    return a1, a2


def alignment_score(
    a1: np.ndarray,
    a2: np.ndarray,
    match: int,
    mismatch: int,
    gap_p: int,
    end_gap_p: int = 0,
) -> int:
    """Score a gapped alignment under the ends-free model (for validation)."""
    n = len(a1)
    is_gap = (a1 == GAP) | (a2 == GAP)
    # identify end-gap runs: leading/trailing maximal runs of gaps in the
    # same sequence
    score = 0
    # leading
    lead = 0
    if n and (a1[0] == GAP or a2[0] == GAP):
        which = a1[0] == GAP
        while lead < n and ((a1[lead] == GAP) if which else (a2[lead] == GAP)):
            lead += 1
    trail = 0
    if n and (a1[-1] == GAP or a2[-1] == GAP):
        which = a1[-1] == GAP
        k = n - 1
        while k >= lead and ((a1[k] == GAP) if which else (a2[k] == GAP)):
            trail += 1
            k -= 1
    for t in range(n):
        if t < lead or t >= n - trail:
            score += end_gap_p if is_gap[t] else (match if a1[t] == a2[t] else mismatch)
        elif is_gap[t]:
            score += gap_p
        else:
            score += match if a1[t] == a2[t] else mismatch
    return score
