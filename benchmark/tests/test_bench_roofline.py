"""The roofline's cell counts against hand counts."""
from collections import Counter

import pytest

from roofline import band_cells, peak_ops_per_s, total_cells


def brute(len1, len2, band):
    lb = band + max(0, len1 - len2)
    rb = band + max(0, len2 - len1)
    return sum(1 for i in range(1, len1 + 1) for j in range(1, len2 + 1)
               if -lb <= j - i <= rb)


def test_hand_counts():
    # 3 x 4 at band 1: lband 1, rband 2; rows 1, 2, 3 hold j = 1..3,
    # 1..4, 2..4: 3 + 4 + 3 cells
    assert band_cells(3, 4, 1) == 10
    # 4 x 4 at band 0: the diagonal
    assert band_cells(4, 4, 0) == 4
    # a band wider than the matrix holds all of it
    assert band_cells(5, 3, 16) == 15


@pytest.mark.parametrize("len1,len2,band", [(240, 240, 16), (1450, 1402, 32),
                                            (7, 30, 2), (30, 7, 2)])
def test_against_brute_force(len1, len2, band):
    assert band_cells(len1, len2, band) == brute(len1, len2, band)


def test_totals_and_peak():
    c = Counter({(240, 240): 3, (3, 4): 2})
    assert total_cells(c, 1) == 3 * band_cells(240, 240, 1) + 20
    assert peak_ops_per_s(132, 1980) == pytest.approx(16.73e12, rel=1e-3)
