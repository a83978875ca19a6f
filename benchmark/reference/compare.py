"""The numbers that decide `correct`, comparing what the program produced
with the plain reference's answer."""
from __future__ import annotations

import numpy as np

EXACT_COLS = ("sequence", "abundance", "n0", "n1", "nunq", "birth_from",
              "birth_ham")
FLOAT_COLS = ("pval", "birth_pval", "birth_fold", "birth_qave")


def _same(a, b):
    """Elementwise equality with NaN equal to NaN."""
    a, b = np.asarray(a, dtype=object), np.asarray(b, dtype=object)
    out = a == b
    for k in np.nonzero(~out)[0]:
        x, y = a[k], b[k]
        if (isinstance(x, float) and isinstance(y, float)
                and np.isnan(x) and np.isnan(y)):
            out[k] = True
    return out


def rel_gap(a, b) -> float:
    """Largest |a - b| / max(|a|, |b|) over pairs of floats; equal values
    (two NaNs, two equal infinities, two zeros) read 0, one NaN reads 1."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    if a.shape != b.shape:
        return 1.0
    if not a.size:
        return 0.0
    with np.errstate(invalid="ignore", divide="ignore"):
        same = (a == b) | (np.isnan(a) & np.isnan(b))
        g = np.abs(a - b) / np.maximum(np.abs(a), np.abs(b))
    g = np.where(same, 0.0, np.where(np.isfinite(g), g, 1.0))
    return float(g.max())


def dada_gaps(got, want) -> dict:
    """One sample's result (the program's DadaResult) against the
    reference's: table_diffs counts the differing integer and sequence
    entries (clustering rows, birth substitutions, transition counts),
    map_diffs the uniques assigned to another ASV, stat_rel_gap is the
    largest relative gap of the floating-point statistics (p-values, birth
    folds and qualities of the ASVs, each unique's p-value)."""
    cg, cw = got.clustering, want["clustering"]
    n = min(len(cg), len(cw))
    table = abs(len(cg) - len(cw))
    rows_ok = np.ones(n, dtype=bool)
    for col in EXACT_COLS:
        rows_ok &= _same(cg[col].values[:n], cw[col].values[:n])
    table += int((~rows_ok).sum())
    bg, bw = got.birth_subs, want["birth_subs"]
    m = min(len(bg), len(bw))
    table += abs(len(bg) - len(bw))
    brow = np.ones(m, dtype=bool)
    for col in bw.columns:
        brow &= _same(bg[col].values[:m], bw[col].values[:m])
    table += int((~brow).sum())
    tg, tw = np.asarray(got.trans), np.asarray(want["subqual"])
    table += (int((tg != tw).sum()) if tg.shape == tw.shape
              else int(tw.size))
    mg, mw = np.asarray(got.map), np.asarray(want["map"])
    maps = int((mg != mw).sum()) if mg.shape == mw.shape else len(mw)
    gap = max([rel_gap(cg[c].values[:n], cw[c].values[:n])
               for c in FLOAT_COLS] + [rel_gap(got.pval, want["pval"])])
    return {"table_diffs": table, "map_diffs": maps, "stat_rel_gap": gap}
