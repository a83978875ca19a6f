"""Substitution records and abundance p-values for the plain reference:
frozen copies of the program's host definitions (DADA2 src/dada.h:49-62,
src/pval.cpp:44-64).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

TAIL_APPROX_CUTOFF = 1e-7  # DADA2 src/dada.h:25


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


def pois_tail(reads: int, e_reads: float) -> float:
    """P(X > reads-1 | Poisson(e_reads)), R-exact.

    The reference calls R's ppois(reads-1, E, lower.tail=FALSE)
    (src/pval.cpp:44-51). utils/rmath.py implements R's own pgamma
    machinery (documented by the reference at src/pval.cpp:199-339) so
    p-values match R bit-for-bit — cephes (scipy pdtrc) differs from R
    in the last ulp and at the subnormal boundary, enough to flip bud
    decisions near OMEGA_A=1e-40.
    """
    from .rmath import ppois_upper

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
