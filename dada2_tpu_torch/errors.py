"""Error-rate models: loess fit of transition rates vs quality score.

reference: R/errorModels.R. The self-consistency loop lives in dada.py;
here are the error-estimation functions applied to pooled 16xQ transition
counts, plus helpers (getErrors, inflateErr, accumulateTrans).

The loess fit implements R's loess(rlogp ~ q, weights=tot) with
span=0.75/degree=2/family=gaussian, with BOTH evaluation surfaces:

- surface="interpolate" (the default, as in R): a kd-tree is grown over
  the fitted q values until every cell holds <= floor(n*span*cell)
  points (cell=0.2), splitting at the lower-median data value with R's
  tie-adjustment (alternating outward search for a splittable position,
  loessf.f ehg124 incl. the 2006 btyner fix); the local regression value
  AND first derivative are evaluated exactly at every cell vertex, and
  predictions between vertices are cubic Hermite blends (Cleveland &
  Grosse, "Computational methods for local regression", 1991). Points
  outside the fitted range predict NA, exactly like R's predict.loess.
- surface="direct": the mathematically exact local regression at every
  prediction point.

R and its Fortran loess are not installable in this environment, so
interpolate-surface goldens cannot be generated. Validation instead
(tests/test_loess.py): the direct surface is checked against an
INDEPENDENT from-scratch oracle (50-digit mpmath normal equations — a
different formulation and solver); the kd-tree build rules are
property-tested (cell occupancy <= fc between consecutive vertices,
data-valued split points, tie-rule termination on integer-quality
fixtures); the Hermite blend is verified C1 at interior vertices and
shown to converge to the direct surface as cell -> 0; and the two
surfaces cross-check to ~1e-3 log10 units apart (R's own interpolation
error scale), far below the clamping granularity that feeds
selfConsist. Residual risk vs R: limited to R-specific interpolate
quirks not implied by the published algorithm. Everything downstream of
the error matrix is covered by the compiled-reference engine parity
harness (tests/test_reference_parity.py).

docs/loess_interpolate_audit.md is the step-by-step audit mapping every
build/evaluation rule here to its published source (Cleveland & Grosse
1991; the documented R 2.4.0 ehg124 tie fix) and to the test pinning
it, plus the R script to generate a true golden if an R runtime ever
becomes available.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np

_NT = "ACGT"
TRANS_ROWS = [f"{a}2{b}" for a in _NT for b in _NT]
SELF_ROWS = [0, 5, 10, 15]
MAX_ERROR_RATE = 0.25  # reference: R/errorModels.R:54
MIN_ERROR_RATE = 1e-7  # reference: R/errorModels.R:55


def _local_poly(x: np.ndarray, y: np.ndarray, w: np.ndarray, x0: float,
                q: int, degree: int) -> np.ndarray:
    """Local weighted polynomial fit at x0: the floor(n*span) nearest x's,
    weighted by tricube(distance/dmax) * w. Returns the coefficient vector
    of the polynomial in (x - x0); [0] is the fit value, [1] its first
    derivative at x0."""
    d = np.abs(x - x0)
    idx = np.argsort(d, kind="stable")[:q]
    dmax = d[idx].max()
    if dmax <= 0:
        dmax = 1.0
    tri = (1 - np.minimum(d[idx] / dmax, 1.0) ** 3) ** 3
    ww = tri * w[idx]
    X = np.vander(x[idx] - x0, degree + 1, increasing=True)
    sw = np.sqrt(ww)
    beta, *_ = np.linalg.lstsq(X * sw[:, None], y[idx] * sw, rcond=None)
    return beta


def _loess_q(n: int, span: float, degree: int) -> int:
    q = int(math.floor(n * span))
    q = max(q, degree + 1)
    return min(q, n)


def loess_fit(x: np.ndarray, y: np.ndarray, w: np.ndarray, xpred: np.ndarray,
              span: float = 0.75, degree: int = 2) -> np.ndarray:
    """Weighted local polynomial regression (loess), direct surface: the
    exact local regression evaluated at every prediction point."""
    q = _loess_q(len(x), span, degree)
    out = np.empty(len(xpred))
    for k, x0 in enumerate(xpred):
        out[k] = _local_poly(x, y, w, x0, q, degree)[0]
    return out


def _kdtree_vertices(xs: np.ndarray, fc: int) -> np.ndarray:
    """1-D loess kd-tree vertex coordinates over the sorted fitted x's.

    A cell (an index range of the sorted points) is split while it holds
    more than fc points; the split value is the lower-median point, with
    R's tie adjustment: if the median equals the next point, alternately
    try one position left, one right, two left, ... and give up (leaf) as
    soon as a trial position falls outside the cell (loessf.f ehg124,
    incl. the 2006-07-20 tie fix). Vertices are the cell bounds: the data
    range endpoints plus every split value."""
    verts = [xs[0], xs[-1]]
    stack = [(0, len(xs) - 1)]  # inclusive index ranges
    while stack:
        lo, hi = stack.pop()
        if hi - lo + 1 <= fc:
            continue
        m = (lo + hi) // 2
        if xs[m] == xs[m + 1]:
            for k in range(1, hi - lo + 1):
                o = -((k + 1) // 2) if k % 2 else k // 2
                # mirror the Fortran: first out-of-bounds trial => leaf
                if not (lo <= m + o < hi):
                    m = -1
                    break
                if xs[m + o] != xs[m + o + 1]:
                    m = m + o
                    break
            else:
                m = -1
        if m < 0:
            continue
        verts.append(xs[m])
        stack.append((lo, m))
        stack.append((m + 1, hi))
    return np.unique(np.array(verts, dtype=np.float64))


def loess_interp_fit(x: np.ndarray, y: np.ndarray, w: np.ndarray,
                     xpred: np.ndarray, span: float = 0.75,
                     degree: int = 2, cell: float = 0.2) -> np.ndarray:
    """Loess with R's default surface="interpolate": the local regression
    (value and first derivative) is evaluated exactly at the kd-tree cell
    vertices only, and predictions in between are the cubic Hermite blend
    of the two enclosing vertices. Prediction points outside the fitted
    range return NaN (R's predict.loess does not extrapolate)."""
    x = np.asarray(x, dtype=np.float64)
    order = np.argsort(x, kind="stable")
    xs = x[order]
    n = len(xs)
    q = _loess_q(n, span, degree)
    fc = max(int(math.floor(n * span * cell)), 1)
    verts = _kdtree_vertices(xs, fc)

    val = np.empty(len(verts))
    der = np.empty(len(verts))
    for i, v in enumerate(verts):
        beta = _local_poly(x, y, w, v, q, degree)
        val[i] = beta[0]
        der[i] = beta[1] if degree >= 1 else 0.0

    out = np.full(len(xpred), np.nan)
    if len(verts) == 1:
        # degenerate fit range (a single distinct x): the blend
        # collapses to the vertex value; R's loess rejects such input
        # outright, so any in-range behavior is an extension
        out[xpred == verts[0]] = val[0]
        return out
    inside = (xpred >= verts[0]) & (xpred <= verts[-1])
    ci = np.clip(np.searchsorted(verts, xpred, side="right") - 1, 0,
                 len(verts) - 2)
    for k in np.nonzero(inside)[0]:
        i = ci[k]
        v0, v1 = verts[i], verts[i + 1]
        h = v1 - v0
        s = (xpred[k] - v0) / h
        h00 = (1 + 2 * s) * (1 - s) ** 2
        h10 = s * (1 - s) ** 2
        h01 = s * s * (3 - 2 * s)
        h11 = s * s * (s - 1)
        out[k] = (h00 * val[i] + h * h10 * der[i] +
                  h01 * val[i + 1] + h * h11 * der[i + 1])
    return out


def loess_errfun(trans: np.ndarray, surface: str = "interpolate"
                 ) -> np.ndarray:
    """Estimate the 16xQ error matrix from transition counts.

    reference: loessErrfun, R/errorModels.R:28-67. For each of the 12
    off-diagonal transitions, fit log10((errs+1)/tot) ~ q by loess weighted
    by tot (surface: "interpolate" = R's default kd-tree vertex + cubic
    Hermite scheme, "direct" = exact local regression), extend flat
    outside the observed range, clamp to [1e-7, 0.25], and set
    self-transitions to the leftover probability.
    """
    if surface not in ("interpolate", "direct"):
        raise ValueError(f"Unknown loess surface: {surface!r}")
    fit = loess_interp_fit if surface == "interpolate" else loess_fit
    trans = np.asarray(trans, dtype=np.float64)
    ncol = trans.shape[1]
    qq = np.arange(ncol, dtype=np.float64)
    est = np.zeros((12, ncol))
    r = 0
    for i in range(4):
        tot = trans[4 * i : 4 * i + 4].sum(axis=0)
        for j in range(4):
            if i == j:
                continue
            errs = trans[4 * i + j]
            with np.errstate(divide="ignore", invalid="ignore"):
                rlogp = np.log10((errs + 1) / tot)
            rlogp[~np.isfinite(rlogp)] = np.nan
            ok = ~np.isnan(rlogp)
            if ok.sum() == 0:
                raise ValueError(
                    "Error rates could not be estimated (too few reads).")
            pred = np.full(ncol, np.nan)
            oki = np.nonzero(ok)[0]
            # loess predictions cover the whole observed q range (interior
            # unobserved columns are interpolated, like R's predict.loess)
            inner = np.arange(oki[0], oki[-1] + 1)
            pred[inner] = fit(qq[ok], rlogp[ok], tot[ok], qq[inner])
            # extend flat beyond the fitted range (R/errorModels.R:47-50)
            pred[: oki[0]] = pred[oki[0]]
            pred[oki[-1] + 1 :] = pred[oki[-1]]
            est[r] = 10.0 ** pred
            r += 1
    est = np.clip(est, MIN_ERROR_RATE, MAX_ERROR_RATE)
    return _expand_self(est)


def _expand_self(est: np.ndarray) -> np.ndarray:
    """Insert self-transition rows = 1 - sum(others) (R/errorModels.R:59-63)."""
    err = np.empty((16, est.shape[1]))
    err[0] = 1 - est[0:3].sum(axis=0)
    err[1:4] = est[0:3]
    err[4] = est[3]
    err[5] = 1 - est[3:6].sum(axis=0)
    err[6:8] = est[4:6]
    err[8:10] = est[6:8]
    err[10] = 1 - est[6:9].sum(axis=0)
    err[11] = est[8]
    err[12:15] = est[9:12]
    err[15] = 1 - est[9:12].sum(axis=0)
    return err


def noqual_errfun(trans: np.ndarray) -> np.ndarray:
    """Quality-ignoring maximum-likelihood rates (R/errorModels.R:222-249)."""
    trans = np.asarray(trans, dtype=np.float64)
    totals = trans.sum(axis=1)
    err1 = np.empty(16)
    for i in range(4):
        tot = totals[4 * i : 4 * i + 4].sum()
        for j in range(4):
            t = 4 * i + j
            if i == j:
                continue
            err1[t] = (totals[t] + 1) / tot if tot > 0 else np.nan
    for i in range(4):
        t = 5 * i
        off = [4 * i + j for j in range(4) if j != i]
        err1[t] = 1.0 - sum(err1[o] for o in off)
    if np.any(np.isnan(err1)):
        raise ValueError("Error rates could not be estimated.")
    return np.tile(err1[:, None], (1, trans.shape[1]))


def make_binned_qual_errfun(binnedQ):
    """Piecewise-linear fit between binned quality scores.

    reference: makeBinnedQualErrfun, R/errorModels.R:96-156.
    """
    binnedQ = sorted(int(b) for b in binnedQ)

    def errfun(trans: np.ndarray) -> np.ndarray:
        trans = np.asarray(trans, dtype=np.float64)
        ncol = trans.shape[1]
        qq = np.arange(ncol)
        colsums = trans.sum(axis=0)
        obs = qq[colsums > 0]
        if obs.size and (obs.max() > max(binnedQ) or obs.min() < min(binnedQ)):
            raise ValueError(
                "Input data contains quality scores outside the binned values.")
        est = np.zeros((12, ncol))
        r = 0
        for i in range(4):
            tot = trans[4 * i : 4 * i + 4].sum(axis=0)
            for j in range(4):
                if i == j:
                    continue
                errs = trans[4 * i + j]
                with np.errstate(divide="ignore", invalid="ignore"):
                    p = errs / tot
                pred = np.full(ncol, np.nan)
                pts_q = [q for q in binnedQ if q < ncol and tot[q] > 0]
                vals = {q: max(p[q], MIN_ERROR_RATE) for q in pts_q}
                for a, b in zip(pts_q[:-1], pts_q[1:]):
                    xs = np.arange(a, b + 1)
                    pred[a : b + 1] = np.interp(xs, [a, b],
                                                [np.log10(vals[a]), np.log10(vals[b])])
                if pts_q:
                    pred[: pts_q[0]] = np.log10(vals[pts_q[0]])
                    pred[pts_q[-1] + 1 :] = np.log10(vals[pts_q[-1]])
                else:
                    pred[:] = np.log10(MIN_ERROR_RATE)
                est[r] = 10.0 ** pred
                r += 1
        est = np.clip(est, MIN_ERROR_RATE, MAX_ERROR_RATE)
        return _expand_self(est)

    return errfun


def pacbio_errfun(trans: np.ndarray) -> np.ndarray:
    """PacBio CCS error function (reference: PacBioErrfun, R/errorModels.R:183-196).

    Loess fit for q < 93; the q=93 column is estimated by maximum likelihood.
    """
    trans = np.asarray(trans, dtype=np.float64)
    if trans.shape[1] != 94:
        raise ValueError("PacBioErrfun expects quality scores 0..93.")
    err = loess_errfun(trans[:, :93])
    last = np.empty(16)
    for i in range(4):
        tot = trans[4 * i : 4 * i + 4, 93].sum()
        for j in range(4):
            t = 4 * i + j
            if i != j:
                last[t] = (trans[t, 93] + 1) / tot if tot > 0 else MIN_ERROR_RATE
    last = np.clip(last, MIN_ERROR_RATE, MAX_ERROR_RATE)
    for i in range(4):
        off = [4 * i + j for j in range(4) if j != i]
        last[5 * i] = 1.0 - sum(last[o] for o in off)
    return np.hstack([err, last[:, None]])


def accumulate_trans(trans_list: List[np.ndarray]) -> np.ndarray:
    """Sum 16xQ count matrices, ragged-column safe (R/errorModels.R:462-471)."""
    maxcol = max(t.shape[1] for t in trans_list)
    out = np.zeros((16, maxcol), dtype=np.int64)
    for t in trans_list:
        out[:, : t.shape[1]] += t
    return out


def inflate_err(err: np.ndarray, inflation: float,
                inflate_self_transitions: bool = False) -> np.ndarray:
    """Saturating rate inflation (reference: inflateErr, R/errorModels.R:446-455)."""
    err = np.array(get_errors(err), dtype=np.float64)
    off = [t for t in range(16) if t not in SELF_ROWS]
    err[off] = err[off] * inflation / (1 + (inflation - 1) * err[off])
    if inflate_self_transitions:
        err[SELF_ROWS] = (err[SELF_ROWS] * inflation
                          / (1 + (inflation - 1) * err[SELF_ROWS]))
    return err


def get_errors(obj, detailed: bool = False, enforce: bool = True):
    """Extract an error matrix from supported objects (R/errorModels.R:390-423)."""
    rval = {"err_out": None, "err_in": None, "trans": None}
    if isinstance(obj, np.ndarray):
        rval["err_out"] = obj
    elif isinstance(obj, dict) and "err_out" in obj:
        rval = {k: obj.get(k) for k in ("err_out", "err_in", "trans")}
    elif hasattr(obj, "err_out"):  # DadaResult
        rval["err_out"] = obj.err_out
        rval["err_in"] = obj.err_in
        rval["trans"] = obj.trans
    elif isinstance(obj, (list, tuple)) and obj and hasattr(obj[0], "err_out"):
        rval["err_out"] = obj[0].err_out
        rval["err_in"] = obj[0].err_in
        rval["trans"] = accumulate_trans([o.trans for o in obj])
    if enforce:
        e = rval["err_out"]
        if e is None:
            raise ValueError("Error matrix is NULL.")
        e = np.asarray(e, dtype=np.float64)
        if e.shape[0] != 16:
            raise ValueError("Error matrix must have 16 rows (A2A, A2C, ...).")
        if not np.all((e >= 0) & (e <= 1)):
            raise ValueError("All error matrix entries must be in [0, 1].")
        rval["err_out"] = e
    if detailed:
        return rval
    return rval["err_out"]
