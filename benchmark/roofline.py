"""The work a kernel's inputs need and the card's peak, for the roofline
metrics (metrics/*_roofline_pct.*.py).

Work is counted in the in-band dynamic-programming cells of each pair
that DADA2's vectorized aligner fills: for rows i = 1..len1, the columns
j = 1..len2 with -lband <= j - i <= rband (lband = band + max(0, len1 -
len2), rband = band + max(0, len2 - len1)); the first row and column are
set, not computed, and are not counted.

int32 operations a cell needs (the repo's chip_smoke.py derivation):
  2  gap adds (up + gap, left + gap)
  3  match: compare c1 == c2, select match or mismatch, add to diagonal
  3  up >= left: compare, select score, select pointer
  3  diagonal > that: compare, select score, select pointer
  2  pack the 2-bit pointer: shift, or
The band's edges and the ends-free last row and column need more, but
only there, so they are not counted per cell.

Peak: the SM's 64 INT32 lanes (half its 128 FP32 lanes) times the SM
count times the card's maximum SM clock, one operation a lane a cycle;
on an H100 SXM (132 SMs, 1,980 MHz) 16.73 T int32 operations a second,
the published 67 TFLOP/s float32 figure (an FMA counting two) over four.
"""
from __future__ import annotations

import re
from collections import Counter

import numpy as np

OPS_PER_CELL = 13
INT32_LANES_PER_SM = 64


def peak_ops_per_s(sm_count, max_sm_clock_mhz):
    return sm_count * INT32_LANES_PER_SM * max_sm_clock_mhz * 1e6


def band_cells(len1, len2, band):
    """In-band interior cells of one pair."""
    lb = band + max(0, len1 - len2)
    rb = band + max(0, len2 - len1)
    i = np.arange(1, len1 + 1)
    return int(np.clip(np.minimum(len2, i + rb) - np.maximum(1, i - lb) + 1,
                       0, None).sum())


def total_cells(pair_lens: Counter, band) -> int:
    """Cells of every pair, given a Counter of (len1, len2) pairs."""
    return sum(n * band_cells(a, b, band) for (a, b), n in pair_lens.items())


def kernel_seconds(by_kernel, pattern):
    """Device seconds of the kernels whose name matches pattern."""
    rx = re.compile(pattern)
    return sum(s for name, s in by_kernel.items() if rx.search(name))


def share_pct(run, cells, pattern, within=None):
    """The least time the cells need at the peak, over the matching
    kernels' device time (of those launched inside the spans called
    within, where given), in percent; None where nothing was traced."""
    if run.dev is None or run.card[1] is None or not cells:
        return None
    if within is None:
        t = kernel_seconds(run.dev["by_kernel"], pattern)
    else:
        from tracing import launched_within

        t = launched_within(run.dev, run.rec.spans, within, pattern)
    if t <= 0:
        return None
    least = cells * OPS_PER_CELL / peak_ops_per_s(run.sm_count, run.card[1])
    return 100.0 * least / t
