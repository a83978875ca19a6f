"""Diagnostic plots: error-rate fits, quality profiles, complexity.

reference: R/plot-methods.R (plotErrors :55-126, plotQualityProfile
:163-243, plotComplexity :293-309), re-implemented with matplotlib.
Each function returns the matplotlib Figure. A copy of dada2_tpu/plot.py:
matplotlib is imported inside the functions (Agg backend), so importing
the package does not need it.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np

_NT = "ACGT"
TRANS_ROWS = [f"{a}2{b}" for a in _NT for b in _NT]


def _get_err_detail(obj):
    from .errors import get_errors

    d = get_errors(obj, detailed=True, enforce=False)
    return d["err_out"], d["err_in"], d["trans"]


def plot_errors(dq, nti: Sequence[str] = _NT, ntj: Sequence[str] = _NT,
                obs: bool = True, err_out: bool = True, err_in: bool = False,
                nominalQ: bool = False):
    """Observed and fitted per-transition error rates vs quality score.

    reference: plotErrors (R/plot-methods.R:55-126): 4x4 facets, log10 y;
    observed points, fitted line, optional input-rate and nominal-Q
    curves."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    e_out, e_in, trans = _get_err_detail(dq)
    if isinstance(e_in, list):
        e_in = e_in[0]
    ncol = None
    for m in (trans, e_out, e_in):
        if m is not None:
            ncol = np.asarray(m).shape[1]
            break
    q = np.arange(ncol)
    fig, axes = plt.subplots(len(nti), len(ntj), figsize=(10, 10),
                             sharex=True, sharey=True)
    for i, a in enumerate(nti):
        for j, b in enumerate(ntj):
            ax = axes[i, j]
            t = 4 * _NT.index(a) + _NT.index(b)
            if obs and trans is not None:
                tot = np.asarray(trans).reshape(4, 4, -1).sum(axis=1)[
                    _NT.index(a)]
                with np.errstate(divide="ignore", invalid="ignore"):
                    rate = np.asarray(trans)[t] / tot
                ok = tot > 0
                ax.scatter(q[ok], rate[ok], s=8, c="gray", label="observed")
            if err_out and e_out is not None:
                ax.plot(q[: e_out.shape[1]], e_out[t], "r-", label="fitted")
            if err_in and e_in is not None:
                ax.plot(q[: np.asarray(e_in).shape[1]],
                        np.asarray(e_in)[t], "b--", label="input")
            if nominalQ:
                nom = 10 ** (-q / 10.0)
                if a == b:
                    nom = 1 - nom
                else:
                    nom = nom / 3
                ax.plot(q, nom, "g:", label="nominal")
            ax.set_yscale("log")
            ax.set_title(f"{a}2{b}", fontsize=8)
    fig.suptitle("Error rates by quality score")
    fig.supxlabel("Consensus quality score")
    fig.supylabel("Error frequency (log10)")
    fig.tight_layout()
    return fig


def plot_quality_profile(fl, n: int = 500_000, aggregate: bool = False):
    """Positional quality heatmap with mean/quartile curves.

    reference: plotQualityProfile (R/plot-methods.R:163-243)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from .io.fastq import quals_to_matrix, stream_fastq

    if isinstance(fl, (str,)):
        fls = [fl]
    else:
        fls = list(fl)
    mats = []
    for f in fls:
        qs = []
        total = 0
        for ch in stream_fastq(f, n=n):
            qs.extend(ch.quals)
            total += len(ch)
            if total >= n:
                break
        mats.append(quals_to_matrix(qs))
    if aggregate:
        L = max(m.shape[1] for m in mats)
        mats = [np.hstack([m, np.full((m.shape[0], L - m.shape[1]),
                                      np.nan)]) for m in mats]
        mats = [np.vstack(mats)]
        fls = ["aggregate"]

    nplot = len(mats)
    fig, axes = plt.subplots(1, nplot, figsize=(6 * nplot, 4),
                             squeeze=False)
    for ax, m, name in zip(axes[0], mats, fls):
        L = m.shape[1]
        cyc = np.arange(1, L + 1)
        with np.errstate(invalid="ignore"):
            mean = np.nanmean(m, axis=0)
            q25 = np.nanpercentile(m, 25, axis=0)
            q50 = np.nanpercentile(m, 50, axis=0)
            q75 = np.nanpercentile(m, 75, axis=0)
        # 2d histogram of qualities per cycle
        H = np.zeros((43, L))
        for c in range(L):
            col = m[:, c]
            col = col[~np.isnan(col)].astype(int)
            if len(col):
                H[:, c] = np.bincount(np.clip(col, 0, 42), minlength=43)
        ax.imshow(H, origin="lower", aspect="auto", cmap="Oranges",
                  extent=(0.5, L + 0.5, -0.5, 42.5))
        ax.plot(cyc, mean, "g-", lw=1, label="mean")
        ax.plot(cyc, q50, color="darkorange", lw=0.8, label="median")
        ax.plot(cyc, q25, color="darkorange", ls="--", lw=0.7)
        ax.plot(cyc, q75, color="darkorange", ls="--", lw=0.7)
        nreads = np.sum(~np.isnan(m[:, 0]))
        ax.set_title(f"{name}  ({m.shape[0]} reads)", fontsize=9)
        ax.set_xlabel("Cycle")
        ax.set_ylabel("Quality Score")
        ax.legend(fontsize=7)
    fig.tight_layout()
    return fig


def plot_complexity(fl, kmerSize: int = 2, window: Optional[int] = None,
                    by: int = 5, n: int = 100_000, bins: int = 100,
                    aggregate: bool = False):
    """Histogram of sequence k-mer complexities.

    reference: plotComplexity (R/plot-methods.R:293-309)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from .filter import seq_complexity
    from .io.fastq import stream_fastq

    fls = [fl] if isinstance(fl, str) else list(fl)
    cplxs = []
    for f in fls:
        seqs = []
        for ch in stream_fastq(f, n=n):
            seqs.extend(s.decode("ascii") for s in ch.seqs)
            if len(seqs) >= n:
                break
        cplxs.append(seq_complexity(seqs, kmerSize=kmerSize, window=window,
                                    by=by))
    if aggregate:
        cplxs = [np.concatenate(cplxs)]
        fls = ["aggregate"]
    fig, axes = plt.subplots(1, len(cplxs), figsize=(5 * len(cplxs), 3.5),
                             squeeze=False)
    for ax, c, name in zip(axes[0], cplxs, fls):
        ax.hist(c, bins=bins)
        ax.set_xlim(0, 4 ** kmerSize)
        ax.set_xlabel("Effective kmer richness")
        ax.set_ylabel("Reads")
        ax.set_title(str(name), fontsize=9)
    fig.tight_layout()
    return fig
