"""Plain reference of DADA2's consensus chimera check on a sequence table
(isBimeraDenovoTable, R/chimeras.R:220-248; C_table_bimera2,
src/chimera.cpp:60-192). The pair list and the vote are frozen copies of
the program's host code; the alignments are the benchmark's own (nw.py,
DADA2's vectorized aligner at band = maxShift, plain torch ops on the
device it is given) and the left/right scans over the gapped rows are
plain torch versions of the program's host scans (get_lr and
get_ham_endsfree, src/chimera.cpp:196-269). It imports nothing of the
program under test.
"""
from __future__ import annotations

import numpy as np
import torch

from . import nw
from .seqs import pack_sequences

# removeBimeraDenovo(method="consensus") defaults (R/chimeras.R)
DEFAULTS = dict(minSampleFraction=0.9, ignoreNNegatives=1,
                minFoldParentOverAbundance=1.5, minParentAbundance=2,
                allowOneOff=False, minOneOffParentDistance=4, maxShift=16,
                MATCH=5, MISMATCH=-4, GAP_PENALTY=-8)


def table_pairs(mat, minFoldParentOverAbundance, minParentAbundance):
    """Every (query column, parent column) pair that some sample admits,
    [P, 2] int64 sorted by query."""
    nsam_tot, ncol = mat.shape
    ge_abund = mat >= minParentAbundance
    U = np.zeros((ncol, ncol), dtype=bool)
    CHUNK_J = max(1, (64 << 20) // (8 * max(ncol, 1)))
    for s in range(nsam_tot):
        row = mat[s]
        parentable = np.nonzero(ge_abund[s] & (row > 0))[0]
        if not len(parentable):
            continue
        pv = row[parentable].astype(np.float64)
        for j0 in range(0, ncol, CHUNK_J):
            j1 = min(j0 + CHUNK_J, ncol)
            thr = minFoldParentOverAbundance * row[j0:j1, None]
            cond = pv[None, :] > thr
            cond[row[j0:j1] == 0, :] = False
            U[j0:j1, parentable] |= cond
    np.fill_diagonal(U, False)
    U &= (mat > 0).any(axis=0)[:, None]
    return np.stack(np.nonzero(U), axis=1).astype(np.int64)


def _first_false(mask, start):
    L = mask.shape[1]
    W = ~mask & (torch.arange(L, device=mask.device)[None, :]
                 >= start[:, None])
    return torch.where(W.any(1), W.to(torch.int8).argmax(1), L)


def _one_side(A, B, m, allow_one_off, shift_bound):
    idx = torch.arange(A.shape[1], device=A.device)[None, :]
    inlen = idx < m[:, None]
    zero = torch.zeros_like(m)
    q0 = _first_false((A == nw.GAP) & inlen, zero)
    s = _first_false((B == nw.GAP) & (idx < shift_bound), q0)
    eq = (A == B) & inlen
    e = _first_false(eq, s)
    credit = e - q0
    credit_oo = credit
    if allow_one_off:
        t = e + 1
        tc = t.clamp(0, A.shape[1] - 1)
        bonus = (t < m) & (A.gather(1, tc[:, None])[:, 0] != nw.GAP)
        f = _first_false(eq, torch.clamp_max(t, A.shape[1]))
        credit_oo = credit + bonus + torch.clamp_min(f - t, 0)
    return credit, credit_oo


def _reverse_rows(X, m):
    L = X.shape[1]
    J = m[:, None] - 1 - torch.arange(L, device=X.device)[None, :]
    return torch.where(J >= 0, X.gather(1, J.clamp(0, L - 1)), nw.PAD)


def lr_ham(A, B, m, allow_one_off, max_shift):
    """(left, right, left_oo, right_oo, ham) of gapped rows: the
    overlap credits from each end (the left overhang creditable while
    idx < max_shift, the right while the reversed idx < max_shift - 1)
    and the hamming distance between the end-gap trims."""
    left, left_oo = _one_side(A, B, m, allow_one_off, max_shift)
    Ar = _reverse_rows(A, m)
    Br = _reverse_rows(B, m)
    right, right_oo = _one_side(Ar, Br, m, allow_one_off, max_shift - 1)
    zero = torch.zeros_like(m)
    idx = torch.arange(A.shape[1], device=A.device)[None, :]
    start = torch.maximum(_first_false(A == nw.GAP, zero),
                          _first_false(B == nw.GAP, zero))
    rtrim = torch.maximum(_first_false(Ar == nw.GAP, zero),
                          _first_false(Br == nw.GAP, zero))
    end = m - rtrim
    ham = ((A != B) & (idx >= start[:, None])
           & (idx < end[:, None])).sum(1)
    return left, right, left_oo, right_oo, ham


def table_votes(mat, sqlens, pairs, stats, minFoldParentOverAbundance,
                minParentAbundance, allowOneOff, minOneOffParentDistance):
    """(nflag, nsam) per column."""
    nsam_tot, ncol = mat.shape
    nflag = np.zeros(ncol, dtype=np.int64)
    nsam = np.zeros(ncol, dtype=np.int64)
    ge_abund = mat >= minParentAbundance
    l_all, r_all, lo_all, ro_all, ham_all = stats
    counts = np.bincount(pairs[:, 0], minlength=ncol)
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
    for j in range(ncol):
        present = np.nonzero(mat[:, j] > 0)[0]
        nsam[j] = len(present)
        if nsam[j] == 0 or counts[j] == 0:
            continue
        sl = slice(offsets[j], offsets[j] + counts[j])
        union = pairs[sl, 1]
        sqlen = sqlens[j]
        keep = l_all[sl] + r_all[sl] < sqlen
        lefts = np.where(keep, l_all[sl], 0)
        rights = np.where(keep, r_all[sl], 0)
        mu = mat[np.ix_(present, union)]
        pm = ((mu > minFoldParentOverAbundance * mat[present, j][:, None])
              & ge_abund[np.ix_(present, union)])
        max_left = np.where(pm, lefts[None, :], 0).max(axis=1)
        max_right = np.where(pm, rights[None, :], 0).max(axis=1)
        flag = max_left + max_right >= sqlen
        if allowOneOff:
            lefts_oo = np.where(keep, lo_all[sl], 0)
            rights_oo = np.where(keep, ro_all[sl], 0)
            allowed = ham_all[sl] >= minOneOffParentDistance
            pa = pm & allowed[None, :]
            oo_l = np.where(pa, lefts[None, :], 0).max(axis=1)
            oo_r = np.where(pa, rights[None, :], 0).max(axis=1)
            oo_lo = np.where(pa, lefts_oo[None, :], 0).max(axis=1)
            oo_ro = np.where(pa, rights_oo[None, :], 0).max(axis=1)
            flag |= (oo_l + oo_ro >= sqlen) | (oo_lo + oo_r >= sqlen)
        nflag[j] = int(flag.sum())
    return nflag, nsam


def _gapless_rows(sq, lq, sp, lp):
    """DADA2's nw_gapless (src/nwalign_endsfree.cpp:539-555): both
    sequences padded with gaps to the longer length."""
    L = max(sq.shape[1], sp.shape[1])
    pos = torch.arange(L, device=sq.device)[None, :]
    m = torch.maximum(lq, lp)

    def rows(s, ls):
        s = torch.nn.functional.pad(s, (0, L - s.shape[1]), value=nw.PAD)
        return torch.where(pos < ls[:, None], s,
                           torch.where(pos < m[:, None], nw.GAP, nw.PAD))
    return rows(sq, lq), rows(sp, lp), m


def bimera_flags(counts, seqs, device="cuda", gapless=False,
                 chunk=nw.CHUNK, **overrides):
    """Each column's consensus bimera flag. gapless=True aligns without
    gaps: the control, which breaks the configuration's banded
    alignments."""
    o = dict(DEFAULTS, **overrides)
    mat = np.asarray(counts, dtype=np.int64)
    pairs = table_pairs(mat, o["minFoldParentOverAbundance"],
                        o["minParentAbundance"])
    codes, lens = pack_sequences(seqs)
    dev = torch.device(device)
    cd = torch.from_numpy(codes.astype(np.int64)).to(dev)
    ld = torch.from_numpy(lens.astype(np.int64)).to(dev)
    parts = []
    for k in range(0, len(pairs), chunk):
        pr = torch.from_numpy(pairs[k:k + chunk]).to(dev)
        q, p = pr[:, 0], pr[:, 1]
        if gapless:
            A, B, m = _gapless_rows(cd[q], ld[q], cd[p], ld[p])
        else:
            _, A, B, m = nw.align(cd[q], ld[q], cd[p], ld[p],
                                  band=o["maxShift"], match=o["MATCH"],
                                  mismatch=o["MISMATCH"],
                                  gap=o["GAP_PENALTY"], rows=True)
        st = lr_ham(A, B, m, o["allowOneOff"], o["maxShift"])
        parts.append(torch.stack(st, 1).cpu().numpy())
    st = (np.concatenate(parts) if parts
          else np.zeros((0, 5), np.int64)).astype(np.int64)
    nflag, nsam = table_votes(
        mat, lens, pairs, tuple(st[:, i] for i in range(5)),
        o["minFoldParentOverAbundance"], o["minParentAbundance"],
        o["allowOneOff"], o["minOneOffParentDistance"])
    return ((nflag >= nsam) | ((nflag > 0) & (
        nflag >= (nsam - o["ignoreNNegatives"]) * o["minSampleFraction"])))
