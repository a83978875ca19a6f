"""Chimera (bimera) identification and removal on the card.

reference: src/chimera.cpp (C_is_bimera :18-58, BimeraTableParallel :60-174,
get_ham_endsfree :196-224, get_lr :228-269) and R/chimeras.R (isBimera :43,
isBimeraDenovo :105, isBimeraDenovoTable :220, removeBimeraDenovo :294).

The PyTorch counterpart of dada2_tpu/chimeras.py. The pairwise alignments
(query vs candidate parents, ends-free vectorized NW with band = maxShift)
run through the wavefront kernel (ops/nw_wavefront.py): first kernel B2
(`nw_pairs_stats`), where every lane carries its own (query, parent) pair
and the kernel computes the left/right overlap credits (get_lr) and the
ends-free hamming from its own traceback, one row of ints per pair; where
the pairs' geometry does not fit it, kernel B1 once per distinct query,
reading the merged map rows, with those scans in torch (`_lr_accum`).
Both compute first-index formulations of the reference's pointer walks
that reproduce their quirks exactly (position-based shift crediting with
the asymmetric right-side bound, the one-off double-credit of the first
post-mismatch match, the AND-carried end-gap trimming). Both routes give
identical statistics; the route is chosen from geometry before any
launch. The host numpy scans (_lr_ham_batch) are kept as the reference
the tests hold the torch scans to.

Pair sets that fit neither kernel route (maxShift < 0, or windows wider
than the wavefront kernel's) go through kernel B4 (ops/nw_batch.py), the
JAX package's nw_batch route, with the same scans in torch over its
traceback steps (`_lr_stats_device`). is_shift_denovo aligns every pair
with B4's unbanded scalar aligner (`_batch_eval_stats`). The JAX package
also sends small pair sets (< 256) through nw_batch, for TPU compile and
dispatch cost; here every pair set that fits takes the B2 or B1 route.

The consensus table (`is_bimera_denovo_table`) crosses to the device once:
its union parent pairs (`_table_pairs`), kernel B2's layout of them
(`_pairs_plan`), their stats and the per-sample votes (`_table_votes`) are
built there, and only each column's (nflag, nsam) crosses back.

Public functions take device=None, which means the CUDA card (raising
without one); device="cpu" runs the kernels' plain PyTorch versions.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import pandas as pd
import torch

from .core.backend_cuda import (CudaBackend, _fetch, _pack_s2_dev,
                                resolve_device)
from .core.raws import make_rawset
from .encode import pack_sequences
from .ops import nw_wavefront as nww
from .ops.nw_batch import PTR_LEFT, PTR_NONE, PTR_UP, nw_batch
from .ops.nw_ref import GAP
# the torch scans over B2's class rows live beside the kernel (its plain
# version uses them); re-exported under their old names here
from .ops.nw_wavefront import (  # noqa: F401
    _first_false_t, _lr_accum_pairs, _take)
from .options import DEFAULT_OPTIONS, current_options
from . import trace
from .trace import PHASES

_PAD = 255  # padding code outside each pair's alignment length
LANES = nww.LANES
CH_BLOCKS = 1024  # blocks (of 128 pairs) per kernel B2 launch
# pairs per kernel B4 launch on the fallback route (its torch scans hold a
# few [pairs, L1 + L2] int64 tensors) and on is_shift_denovo's unbanded one
CHUNK_PAIRS = 16384
CHUNK_PAIRS_UNBANDED = 4096
# elements of the consensus table's device temporaries: the union parent
# matrix's [samples, rows, columns] chunk, the vote's [pairs, samples]
TABLE_CHUNK = 1 << 28
VOTE_CHUNK = 1 << 24


# ---- kernel B4's route (counterparts of dada2_tpu/chimeras.py's nw_batch
# helpers) ------------------------------------------------------------------

def _alignment_code_mats(pairs_chunk, mat, lens, maxShift, match,
                         mismatch, gap_p, device=None):
    """Gapped-alignment code matrices for (query, parent) index pairs:
    kernel B4 (band = maxShift) and one vectorized host reconstruction
    (the batched equivalent of ops/nw_batch.steps_to_alignment). Returns
    (A, B, m): [P, Lmax] uint8 with GAP=254 and _PAD beyond each pair's
    alignment length m[p] (reference: nwalign_vectorized2 calls in
    src/chimera.cpp:27,122). Nothing in the package calls it, as in
    dada2_tpu; it is kept as the counterpart of dada2_tpu's helper."""
    qi = np.fromiter((p[0] for p in pairs_chunk), np.int64,
                     len(pairs_chunk))
    pi = np.fromiter((p[1] for p in pairs_chunk), np.int64,
                     len(pairs_chunk))
    out = nw_batch(mat[qi], lens[qi], mat[pi], lens[pi], match=match,
                   mismatch=mismatch, gap_p=gap_p, end_gap_p=0,
                   band=maxShift, device=resolve_device(device))
    kinds, p0, p1, ok = (_fetch(x) for x in (out[0], out[1], out[2], out[5]))
    if not ok.all():
        raise RuntimeError("N-W Align out of range.")
    live = kinds != PTR_NONE            # contiguous step prefix, reversed
    m = live.sum(axis=1)
    Lmax = int(m.max()) if len(m) else 0
    P = len(pairs_chunk)
    rows = np.arange(P)[:, None]
    J = m[:, None] - 1 - np.arange(Lmax)[None, :]   # un-reverse steps
    valid = J >= 0
    Jc = np.clip(J, 0, kinds.shape[1] - 1)
    kg = kinds[rows, Jc]
    s1g = mat[qi[:, None], np.clip(p0[rows, Jc], 0, mat.shape[1] - 1)]
    s2g = mat[pi[:, None], np.clip(p1[rows, Jc], 0, mat.shape[1] - 1)]
    A = np.where(kg != PTR_LEFT, s1g, GAP).astype(np.uint8)
    B = np.where(kg != PTR_UP, s2g, GAP).astype(np.uint8)
    A[~valid] = _PAD
    B[~valid] = _PAD
    return A, B, m.astype(np.int64)


def _gapped_rows(kinds, p0, p1, sq, sp):
    """(A, B, Ar, Br, m): the gapped alignment rows of traceback steps
    ([P, L] int64 codes, GAP in gaps, _PAD past each pair's m columns) in
    forward order (A, B) and as the steps arrive, end first (Ar, Br)."""
    i64 = torch.int64
    kinds = kinds.to(i64)
    L = kinds.shape[1]
    live = kinds != PTR_NONE
    m = live.sum(1)
    s1g = torch.gather(sq.to(i64), 1, p0.to(i64).clamp(0, sq.shape[1] - 1))
    s2g = torch.gather(sp.to(i64), 1, p1.to(i64).clamp(0, sp.shape[1] - 1))
    Ar = torch.where(live, torch.where(kinds != PTR_LEFT, s1g, GAP), _PAD)
    Br = torch.where(live, torch.where(kinds != PTR_UP, s2g, GAP), _PAD)
    # forward-order rows via one un-reversing gather
    J = m[:, None] - 1 - torch.arange(L, device=kinds.device)[None, :]
    Jc = J.clamp(0, L - 1)
    A = torch.where(J >= 0, torch.gather(Ar, 1, Jc), _PAD)
    B = torch.where(J >= 0, torch.gather(Br, 1, Jc), _PAD)
    return A, B, Ar, Br, m


def _lr_one_side_t(A, B, m, allow_one_off: bool, shift_bound: int):
    """Torch twin of _lr_one_side (one directional credit scan)."""
    L = A.shape[1]
    idx = torch.arange(L, device=A.device)[None, :]
    inlen = idx < m[:, None]
    zero = torch.zeros_like(m)
    q0 = _first_false_t((A == GAP) & inlen, zero, L)
    s = _first_false_t((B == GAP) & (idx < shift_bound), q0, L)
    eq = (A == B) & inlen
    e = _first_false_t(eq, s, L)
    credit = e - q0
    if not allow_one_off:
        return credit, credit
    t = e + 1
    bonus = (t < m) & (_take(A, t.clamp(0, L - 1)) != GAP)
    f = _first_false_t(eq, t.clamp(max=L), L)
    return credit, credit + bonus + (f - t).clamp_min(0)


def _trims(A, B, Ar, Br, m):
    """(start, end) of the columns between the ends-free end-gap runs:
    the longer leading and the longer trailing gap run are cut."""
    L = A.shape[1]
    zero = torch.zeros_like(m)
    start = torch.maximum(_first_false_t(A == GAP, zero, L),
                          _first_false_t(B == GAP, zero, L))
    rtrim = torch.maximum(_first_false_t(Ar == GAP, zero, L),
                          _first_false_t(Br == GAP, zero, L))
    return start, m - rtrim


def _lr_stats_device(kinds, p0, p1, sq, sp, allow_one_off: bool,
                     max_shift: int):
    """The five lr/ham statistics of _lr_ham_batch straight from kernel
    B4's traceback steps, in torch on their device (counterpart of
    dada2_tpu/chimeras.py::_lr_stats_device): [P, 5] int64. The steps
    arrive end first, which is the right-side scan order."""
    A, B, Ar, Br, m = _gapped_rows(kinds, p0, p1, sq, sp)
    left, left_oo = _lr_one_side_t(A, B, m, allow_one_off, max_shift)
    right, right_oo = _lr_one_side_t(Ar, Br, m, allow_one_off,
                                     max_shift - 1)
    start, end = _trims(A, B, Ar, Br, m)
    idx = torch.arange(A.shape[1], device=A.device)[None, :]
    ham = ((A != B) & (idx >= start[:, None])
           & (idx < end[:, None])).sum(1)
    return torch.stack([left, right, left_oo, right_oo, ham],
                       1).to(torch.int64)


def _eval_stats_device(kinds, p0, p1, sq, sp):
    """eval_pair's (match, mismatch, indel) of traceback steps, end-gap
    runs trimmed as the scalar walk trims them (reference: C_eval_pair,
    src/evaluate.cpp:73-113; counterpart of dada2_tpu/chimeras.py::
    _eval_stats_device): [P, 3] int64."""
    A, B, Ar, Br, m = _gapped_rows(kinds, p0, p1, sq, sp)
    start, end = _trims(A, B, Ar, Br, m)
    idx = torch.arange(A.shape[1], device=A.device)[None, :]
    sel = (idx >= start[:, None]) & (idx < end[:, None])
    gap = (A == GAP) | (B == GAP)
    indel = (gap & sel).sum(1)
    match = ((A == B) & sel).sum(1)
    mismatch = (sel & ~gap & (A != B)).sum(1)
    return torch.stack([match, mismatch, indel], 1).to(torch.int64)


def _b4_pair_stats(pairs, seqs, chunk: int, stats, device, **align):
    """stats(kinds, p0, p1, sq, sp) over kernel B4's alignments of
    (query, parent) index pairs, chunk pairs per launch, one fetch per
    chunk; rows in pair order (int64)."""
    dev = resolve_device(device)
    mat, lens = pack_sequences(seqs)
    rows = []
    for lo in range(0, len(pairs), chunk):
        qi = pairs[lo: lo + chunk, 0]
        pi = pairs[lo: lo + chunk, 1]
        sq = trace.put(mat[qi], dev)
        sp = trace.put(mat[pi], dev)
        kinds, p0, p1, _, _, ok = nw_batch(sq, lens[qi], sp, lens[pi],
                                           end_gap_p=0, device=dev, **align)
        if not trace.item(ok.all()):
            raise RuntimeError("N-W Align out of range.")
        rows.append(_fetch(stats(kinds, p0, p1, sq, sp)))
    return np.concatenate(rows).astype(np.int64)


def _nw_batch_lr_stats(pairs, seqs, maxShift, match, mismatch, gap_p,
                       allow_one_off, device=None):
    """lr/ham statistics through kernel B4, the vectorized aligner at
    band = maxShift (dada2_tpu's nw_batch route of _batch_lr_stats)."""
    st = _b4_pair_stats(
        pairs, seqs, CHUNK_PAIRS,
        lambda *a: _lr_stats_device(*a, allow_one_off, maxShift), device,
        match=match, mismatch=mismatch, gap_p=gap_p, band=maxShift)
    return tuple(st[:, k] for k in range(5))


def _batch_eval_stats(pairs, seqs, match, mismatch, gap_p, device=None):
    """eval_pair statistics for arbitrary (query, parent) index pairs:
    kernel B4's unbanded ends-free scalar aligner (the R nwalign band=-1
    configuration), evaluated in torch, [P, 3] fetched per chunk.
    Returns (match, mismatch, indel) int64."""
    pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
    if len(pairs) == 0:
        return tuple(np.zeros(0, np.int64) for _ in range(3))
    st = _b4_pair_stats(pairs, seqs, CHUNK_PAIRS_UNBANDED,
                        _eval_stats_device, device, match=match,
                        mismatch=mismatch, gap_p=gap_p, band=-1,
                        mode="scalar")
    return tuple(st[:, k] for k in range(3))


# ---- host scans (copies of dada2_tpu/chimeras.py; the tests' reference) ---

def _first_false(mask: np.ndarray, start: np.ndarray) -> np.ndarray:
    """Per row: smallest index >= start[p] where mask[p] is False, or
    L if none (rows whose start is past the last False get L)."""
    L = mask.shape[1]
    W = ~mask & (np.arange(L)[None, :] >= start[:, None])
    hit = W.any(axis=1)
    return np.where(hit, W.argmax(axis=1), L)


def _lr_one_side(A, B, m, allow_one_off, shift_bound):
    """One directional credit scan (reference: get_lr one direction,
    src/chimera.cpp:228-269): skip query end-gaps, credit parent
    overhang while idx < shift_bound, credit the match run, then the
    one-off extension past a single mismatch."""
    idx = np.arange(A.shape[1])[None, :]
    inlen = idx < m[:, None]
    q0 = _first_false((A == GAP) & inlen, np.zeros(len(m), np.int64))
    s = _first_false((B == GAP) & (idx < shift_bound), q0)
    eq = (A == B) & inlen
    e = _first_false(eq, s)
    credit = e - q0
    credit_oo = credit
    if allow_one_off:
        t = e + 1
        tc = np.clip(t, 0, A.shape[1] - 1)
        bonus = (t < m) & (A[np.arange(len(m)), tc] != GAP)
        f = _first_false(eq, np.minimum(t, A.shape[1]))
        credit_oo = credit + bonus + np.maximum(f - t, 0)
    return credit, credit_oo


def _reverse_rows(X: np.ndarray, m: np.ndarray) -> np.ndarray:
    """Reverse each row's first m[p] entries; pad stays at the end."""
    L = X.shape[1]
    J = m[:, None] - 1 - np.arange(L)[None, :]
    out = X[np.arange(X.shape[0])[:, None], np.clip(J, 0, L - 1)]
    out[J < 0] = _PAD
    return out


def _lr_ham_batch(A, B, m, allow_one_off, max_shift):
    """Vectorized get_lr + get_ham_endsfree over the whole batch.

    reference: src/chimera.cpp:228-269 (get_lr; note the asymmetric
    bounds — left overhang creditable at idx < max_shift, right at
    reverse-idx < max_shift-1, from `pos > len0 - max_shift`) and
    :196-224 (get_ham_endsfree with AND-carried end trimming).
    Returns (left, right, left_oo, right_oo, ham) int64 [P]."""
    left, left_oo = _lr_one_side(A, B, m, allow_one_off, max_shift)
    Ar = _reverse_rows(A, m)
    Br = _reverse_rows(B, m)
    right, right_oo = _lr_one_side(Ar, Br, m, allow_one_off,
                                   max_shift - 1)
    # ends-free hamming: trim max(leading gap runs), max(trailing runs)
    zero = np.zeros(len(m), np.int64)
    idx = np.arange(A.shape[1])[None, :]
    start = np.maximum(_first_false(A == GAP, zero),
                       _first_false(B == GAP, zero))
    rtrim = np.maximum(_first_false(Ar == GAP, zero),
                       _first_false(Br == GAP, zero))
    end = m - rtrim  # exclusive
    ham = ((A != B) & (idx >= start[:, None])
           & (idx < end[:, None])).sum(axis=1)
    return (left.astype(np.int64), right.astype(np.int64),
            left_oo.astype(np.int64), right_oo.astype(np.int64),
            ham.astype(np.int64))


# ---- the routes ----------------------------------------------------------

def _pairs_params(pblk, scal_c, lens, *, band: int):
    """[CH, 8, 128] per-lane kernel params (l2, lb, rb rows) built on the
    device from the resident lengths."""
    l2 = lens[pblk].to(torch.int32)
    len1 = scal_c[:, 0:1]
    lb = band + (len1 - l2).clamp_min(0)
    rb = band + (l2 - len1).clamp_min(0)
    z = torch.zeros_like(l2)
    return torch.stack([l2, lb, rb, z, z, z, z, z], 1).contiguous()


def _pack_s1_blocks(seqs, qblk, *, L1R: int):
    """[nb, L1R, 128] per-lane query tiles (row i+1 = char i; kernel B2's
    s1 operand)."""
    s = seqs.to(torch.int32).clamp_min(0)[qblk].permute(0, 2, 1)
    W = min(s.shape[1], L1R - 1)
    out = torch.zeros((qblk.shape[0], L1R, LANES), dtype=torch.int32,
                      device=seqs.device)
    out[:, 1: 1 + W] = s[:, :W]
    return out


class _PairsPlan(NamedTuple):
    """Kernel B2's layout of a pair set, on the backend's device: blocks of
    128 pairs grouped by query length (len1 is the only block-uniform
    quantity the kernel needs), and one geometry for every launch."""
    qblk: torch.Tensor   # [nb, 128] int64 query index per lane
    pblk: torch.Tensor   # [nb, 128] int64 parent index per lane
    scal: torch.Tensor   # [nb, 4] int32 len1, l2max, rbmax, l2min per block
    pos: torch.Tensor    # [P] row (block * 128 + lane) of each sorted pair
    order: torch.Tensor  # [P] input pair of each sorted pair
    WP: int
    NDP: int
    L1R: int
    L2R: int
    band: int


def _on_device(be, x) -> torch.Tensor:
    """x on the backend's device; a host array is uploaded (counted)."""
    if torch.is_tensor(x):
        return x.to(be.device)
    return be._put(np.asarray(x, np.int64))


def _pairs_plan(be, opts, qi, pi) -> Optional[_PairsPlan]:
    """Kernel B2's layout for the pairs (qi[k], pi[k]) (index tensors on
    the backend's device, or host arrays, uploaded), built on the device,
    or None where their window does not fit the kernel (WP over 128, or on
    the card one block's shared memory): the route is chosen here, before
    any launch, from one small fetch of the per-length pair counts and
    parent-length extremes."""
    band = int(opts.BAND_SIZE)
    if band < 0:
        return None
    qi, pi = _on_device(be, qi), _on_device(be, pi)
    dev = be.device
    i64 = torch.int64
    P = qi.shape[0]
    lens = be.d_lens
    l1o, order = torch.sort(lens[qi], stable=True)
    qs, ps = qi[order], pi[order]
    l2 = lens[ps]
    # per query length (a group): pairs, and its parents' length extremes
    nl = be.maxlen + 1
    cnt = torch.zeros(nl, dtype=i64, device=dev).index_add_(
        0, l1o, torch.ones_like(l1o))
    l2min = torch.full((nl,), nl, dtype=i64, device=dev).scatter_reduce_(
        0, l1o, l2, "amin")
    l2max = torch.zeros(nl, dtype=i64, device=dev).scatter_reduce_(
        0, l1o, l2, "amax")
    cnt_h, l2min_h, l2max_h = trace.fetch(torch.stack([cnt, l2min, l2max]))
    NDP, L1R = be._pb.geometry()
    L2R = be._pb.L2R
    # one window width for every block of every launch, from the per-
    # GROUP length extremes (a superset of any block's window)
    WPmax = 8
    for len1 in np.nonzero(cnt_h)[0]:
        WPmax = max(WPmax, nww.block_window(
            int(len1), np.array([l2min_h[len1], l2max_h[len1]]), band))
    WP = nww._round_up(WPmax, 32)
    if WP > nww.WP_MAX:
        return None
    if (dev.type == "cuda" and nww.pairs_per_block(
            L1R, L2R, NDP, WP, nww.STATS_MODE) == 0):
        return None
    # pair t of a group lands in block gbase + t//128, lane t%128 (groups
    # in ascending length, as the sort leaves them); padding lanes repeat
    # lane 0 of their block
    nb = int((-(-cnt_h // LANES)).sum())
    gblocks = (cnt + LANES - 1) // LANES
    starts = torch.cumsum(cnt, 0) - cnt
    gbase = torch.cumsum(gblocks, 0) - gblocks
    t_in = torch.arange(P, device=dev) - starts[l1o]
    pos = (gbase[l1o] + t_in // LANES) * LANES + t_in % LANES
    filled = torch.zeros(nb * LANES, dtype=torch.bool, device=dev)
    filled[pos] = True
    filled = filled.view(nb, LANES)

    def lanes(x):
        blk = torch.zeros(nb * LANES, dtype=i64, device=dev)
        blk[pos] = x
        blk = blk.view(nb, LANES)
        return torch.where(filled, blk, blk[:, :1])

    qblk, pblk = lanes(qs), lanes(ps)
    l2b = lens[pblk]
    len1b = lens[qblk[:, 0]]
    l2mx = l2b.amax(1)
    scal = torch.stack([len1b, l2mx, band + (l2mx - len1b).clamp_min(0),
                        l2b.amin(1)], 1).to(torch.int32)
    return _PairsPlan(qblk, pblk, scal, pos, order, WP, NDP, L1R, L2R, band)


def _pairs_launch_inputs(be, plan: _PairsPlan, c0: int, CH: int):
    """Kernel B2's (scal, params, s1, s2q) for blocks [c0, c0 + CH) of the
    plan, sliced and built on the device; a tail past the last block pads
    with its block c0."""
    c1 = min(c0 + CH, plan.qblk.shape[0])
    rows = torch.arange(c0, c0 + CH, device=plan.qblk.device)
    rows[c1 - c0:] = c0
    d_q, d_p, d_sc = plan.qblk[rows], plan.pblk[rows], plan.scal[rows]
    params = _pairs_params(d_p, d_sc, be.d_lens, band=plan.band)
    s2q = _pack_s2_dev(be.d_seqs, None, be.d_lens, d_p, d_sc[:, 1],
                       L2R=plan.L2R)
    s1b = _pack_s1_blocks(be.d_seqs, d_q, L1R=plan.L1R)
    return d_sc, params, s1b, s2q


def _pairs_lr_stats(be, opts, qi, pi, maxShift, allow_one_off):
    """lr/ham stats for arbitrary pairs through kernel B2: every pair its
    own kernel lane, CH_BLOCKS blocks of 128 pairs per launch, the stats
    computed inside the kernel (nww.nw_pairs_stats). Returns [P, 5] int64
    on the backend's device in input pair order (left, right, left_oo,
    right_oo, ham), or None (before any launch) when the pairs' window
    does not fit the kernel, so that the caller takes the per-query
    route. The only crossings: the plan's small fetch and one flag."""
    plan = _pairs_plan(be, opts, qi, pi)
    if plan is None:
        return None
    nb = plan.qblk.shape[0]
    # fixed-size launches (a table-scale pair set is millions of pairs).
    # Each launch's [pairs, 6] stats (the five, then end0 | end1) stay on
    # the device
    CH = min(CH_BLOCKS, 1 << (nb - 1).bit_length())
    parts = []
    for c0 in range(0, nb, CH):
        args = _pairs_launch_inputs(be, plan, c0, CH)
        stats = nww.nw_pairs_stats(
            *args, L1R=plan.L1R, L2R=plan.L2R, NDP=plan.NDP, WP=plan.WP,
            match=int(opts.MATCH), mismatch=int(opts.MISMATCH),
            gap_p=int(opts.GAP_PENALTY), allow_one_off=bool(allow_one_off),
            max_shift=int(maxShift))
        nreal = (min(c0 + CH, nb) - c0) * LANES
        parts.append(stats[:nreal])
    # only real lanes count: pad lanes and pad blocks repeat real pairs
    got = torch.cat(parts)[plan.pos]
    if trace.item(got[:, 5].any()):
        raise RuntimeError("N-W Align out of range.")
    out = torch.empty((len(plan.order), 5), dtype=torch.int64,
                      device=got.device)
    out[plan.order] = got[:, :5].to(torch.int64)
    return out


def _lr_accum(mapq, seqs, lens, center: int, rows, *, mL: int,
              allow_one_off: bool, max_shift: int):
    """lr/ham stats for one query's parents straight from kernel B1's
    merged map rows (CudaBackend._align_ent); the counterpart of
    dada2_tpu/chimeras.py::_lr_accum_trace.

    A map row gives, for every 1-based center (query) position i:
    ``(qual << 17) | (member_pos << 3) | (nt1 + 2)`` for a diagonal
    step, ``1`` for a query-char-vs-member-gap column, 0 past the end.
    The gapped alignment is rebuilt from it as column classes (0 =
    member-insertion column, 1 = query-vs-gap, 2 = substitution,
    3 = match, 4 = past the alignment): the column of center position i
    is (i-1) + members-consumed-before-i, member insertions fill the
    remaining columns, and m = len1 + len2 - ndiag. Returns stats
    [len(rows), 5] int64."""
    i64 = torch.int64
    dev = mapq.device
    CNT = rows.shape[0]
    L1 = mapq.shape[1] - 1
    code = mapq[rows][:, 1:].to(i64)
    len1 = int(lens[center])
    ipos = torch.arange(1, L1 + 1, device=dev)[None, :]
    on = (code != 0) & (ipos <= len1)
    low = code & 7
    cons = on & (low >= 2)
    gapc = on & (low == 1)
    j1 = torch.where(cons, (code >> 3) & 0x3FFF, 0)
    jmax = torch.cummax(j1, 1).values
    zcol = torch.zeros((CNT, 1), dtype=i64, device=dev)
    jmax_excl = torch.cat([zcol, jmax[:, :-1]], 1)
    jbefore = torch.where(cons, j1 - 1, jmax_excl)
    ndiag_excl = torch.cat([zcol, torch.cumsum(cons, 1)[:, :-1]], 1)
    # column of center position i = (center cols before) + (insertion
    # cols before) = (i-1) + (members consumed before i) - (members
    # consumed AT earlier center columns)
    col = torch.where(on, (ipos - 1) + jbefore - ndiag_excl, mL)
    l2 = lens[rows].to(i64)
    ndiag = cons.sum(1)
    m = len1 + l2 - ndiag

    W = seqs.shape[1]
    csq = torch.zeros(L1, dtype=i64, device=dev)
    csq[: min(W, L1)] = seqs[center, : min(W, L1)].to(i64)
    nt1 = low - 2
    cls_i = torch.where(gapc, 1, torch.where(nt1 == csq[None, :], 3, 2))
    cidx = torch.arange(mL, device=dev)[None, :]
    inm = cidx < m[:, None]
    # one scatter builds the class rows; columns off the map (col >= mL)
    # land in a spare last column, which is cut off
    C = torch.where(inm, 0, 4)
    C = torch.cat([C, torch.zeros_like(C[:, :1])], 1)
    C.scatter_(1, col.clamp(max=mL), cls_i)
    C = C[:, :mL]
    J = m[:, None] - 1 - cidx
    Cr = torch.where(J >= 0, torch.gather(C, 1, J.clamp(0, mL - 1)), 4)

    def one_side(Cs, shift_bound):
        inlen = cidx < m[:, None]
        zero = torch.zeros_like(m)
        q0 = _first_false_t((Cs == 0) & inlen, zero, mL)
        s = _first_false_t((Cs == 1) & (cidx < shift_bound), q0, mL)
        eq = (Cs == 3) & inlen
        e = _first_false_t(eq, s, mL)
        credit = e - q0
        if not allow_one_off:
            return credit, credit
        t = e + 1
        bonus = (t < m) & (_take(Cs, t.clamp(0, mL - 1)) != 0)
        f = _first_false_t(eq, t.clamp(max=mL), mL)
        return credit, credit + bonus + (f - t).clamp_min(0)

    left, left_oo = one_side(C, max_shift)
    right, right_oo = one_side(Cr, max_shift - 1)
    zero = torch.zeros_like(m)
    startc = torch.maximum(_first_false_t(C == 0, zero, mL),
                           _first_false_t(C == 1, zero, mL))
    rtrim = torch.maximum(_first_false_t(Cr == 0, zero, mL),
                          _first_false_t(Cr == 1, zero, mL))
    end = m - rtrim
    ham = ((C != 3) & (cidx >= startc[:, None])
           & (cidx < end[:, None])).sum(1)
    return torch.stack([left, right, left_oo, right_oo, ham], 1).to(i64)


def _per_query_lr_stats(be, opts, qi, pi, maxShift, allow_one_off):
    """lr/ham stats through kernel B1: ONE compare sweep per distinct
    query (reference: the per-column parent alignments of
    src/chimera.cpp:120-146), stats computed on the device from the
    merged map rows, one final fetch. Returns (left, right, left_oo,
    right_oo, ham) int64 on the host, in input pair order, or None (before
    any launch) if some query has no kernel geometry."""
    P = len(qi)
    order = np.argsort(qi, kind="stable")
    qs, ps = qi[order], pi[order]
    bounds = np.nonzero(np.diff(qs))[0] + 1
    starts = np.concatenate([[0], bounds])
    ends = np.concatenate([bounds, [P]])
    geoms = {}
    for len1 in np.unique(be.lens[qs[starts]]):
        if be._route(int(len1), opts) != "B1":
            return None
        geoms[int(len1)] = be._kernel_geom(int(len1), opts)
    # m = len1 + insertions; a banded path inserts at most band +
    # length-difference members, so this bound is exact-safe
    spread = int(be.lens.max() - be.lens.min())
    mL = min(2 * be.maxlen, be.maxlen + maxShift + spread + 2)
    mL = nww._round_up(mL, 128)
    d_ps = be._put(ps)
    out = torch.empty((P, 5), dtype=torch.int64, device=be.device)
    for s, e in zip(starts, ends):
        q = int(qs[s])
        ent = be._align_ent(q, opts, geoms[int(be.lens[q])])
        out[s:e] = _lr_accum(ent[0], be.d_seqs, be.d_lens, q, d_ps[s:e],
                             mL=mL, allow_one_off=allow_one_off,
                             max_shift=maxShift)
    stats = np.empty((P, 5), np.int64)
    stats[order] = _fetch(out)
    return tuple(stats[:, k] for k in range(5))


def _chimera_backend(seqs, match, mismatch, gap_p, maxShift, device):
    """A quals-free CudaBackend over the sequence set and the options its
    kernel routes align with."""
    opts = DEFAULT_OPTIONS.replace(
        MATCH=match, MISMATCH=mismatch, GAP_PENALTY=gap_p,
        BAND_SIZE=maxShift)
    rs = make_rawset(seqs, np.ones(len(seqs), np.int64), None, None)
    return CudaBackend(rs, use_quals=False, device=device), opts


def _unplanned_lr_stats(be, opts, pairs, seqs, maxShift, allow_one_off):
    """lr/ham statistics of host (query, parent) pairs that kernel B2's
    plan does not take: kernel B1 per query, else kernel B4. Returns
    (left, right, left_oo, right_oo, ham) int64 on the host."""
    qi = np.ascontiguousarray(pairs[:, 0])
    pi = np.ascontiguousarray(pairs[:, 1])
    out = _per_query_lr_stats(be, opts, qi, pi, maxShift, allow_one_off)
    if out is None:
        out = _nw_batch_lr_stats(pairs, seqs, maxShift, opts.MATCH,
                                 opts.MISMATCH, opts.GAP_PENALTY,
                                 allow_one_off, device=be.device)
    return out


def _batch_lr_stats(pairs, seqs, maxShift, match, mismatch, gap_p,
                    allow_one_off, device=None):
    """lr/ham statistics for arbitrary (query, parent) index pairs (a list
    of pairs or an [P, 2] integer array): uploaded once, aligned and
    scanned on the device, kernel B2 first, else kernel B1 per query,
    else kernel B4; only [P, 5] ints are fetched. Returns (left, right,
    left_oo, right_oo, ham) int64."""
    pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
    if len(pairs) == 0:
        return tuple(np.zeros(0, np.int64) for _ in range(5))
    be, opts = _chimera_backend(seqs, match, mismatch, gap_p, maxShift,
                                device)
    d_pairs = be._put(pairs)
    out = _pairs_lr_stats(be, opts, d_pairs[:, 0], d_pairs[:, 1], maxShift,
                          allow_one_off)
    if out is None:
        return _unplanned_lr_stats(be, opts, pairs, seqs, maxShift,
                                   allow_one_off)
    st = trace.fetch(out)
    return tuple(st[:, k] for k in range(5))


# ---- decisions (host, copies of dada2_tpu/chimeras.py) --------------------

def _vote_from_stats(left, right, left_oo, right_oo, ham, sqlen: int,
                     allowOneOff: bool,
                     minOneOffParentDistance: int) -> bool:
    """Bimera decision from a query's parent lr stats
    (reference: C_is_bimera body, src/chimera.cpp:18-58; the running
    maxima with early return are order-free, so plain maxima)."""
    keep = left + right < sqlen   # toss id/shift/internal-indel parents
    if not keep.any():
        return False
    if left[keep].max() + right[keep].max() >= sqlen:
        return True
    if allowOneOff:
        ok = keep & (ham >= minOneOffParentDistance)
        if ok.any() and (
                left[ok].max() + right_oo[ok].max() >= sqlen
                or left_oo[ok].max() + right[ok].max() >= sqlen):
            return True
    return False


def is_bimera(sq: str, parents: List[str], allowOneOff: bool = False,
              minOneOffParentDistance: int = 4, maxShift: int = 16,
              device=None, **opt_overrides) -> bool:
    """True if sq is consistent with being a two-parent chimera.

    reference: C_is_bimera (src/chimera.cpp:18-58), isBimera
    (R/chimeras.R:43-47)."""
    dev = resolve_device(device)
    opts = current_options().replace(**opt_overrides)
    seqs = [sq] + list(parents)
    pairs = [(0, 1 + k) for k in range(len(parents))]
    left, right, left_oo, right_oo, ham = _batch_lr_stats(
        pairs, seqs, maxShift, opts.MATCH, opts.MISMATCH,
        opts.GAP_PENALTY, allowOneOff, device=dev)
    return _vote_from_stats(left, right, left_oo, right_oo, ham,
                            len(sq), allowOneOff,
                            minOneOffParentDistance)


def is_bimera_denovo(unqs, minFoldParentOverAbundance: float = 2,
                     minParentAbundance: int = 8, allowOneOff: bool = False,
                     minOneOffParentDistance: int = 4, maxShift: int = 16,
                     multithread=False, verbose: bool = False,
                     device=None) -> pd.Series:
    """Flag bimeras among pooled unique sequences.

    reference: isBimeraDenovo (R/chimeras.R:105-154)."""
    from .seqtab import get_sequences, get_uniques

    dev = resolve_device(device)
    opts = current_options()
    unqs_int = get_uniques(unqs)
    seqs = list(unqs_int.keys())
    abunds = np.array(list(unqs_int.values()))
    # all (query, parent) alignments in one device batch
    par_slices = []
    all_pairs = []
    for i, abund in enumerate(abunds):
        sel = (abunds > minFoldParentOverAbundance * abund) & \
            (abunds > minParentAbundance)
        idx = np.nonzero(sel)[0]
        if len(idx) < 2:
            idx = idx[:0]
        lo = len(all_pairs)
        all_pairs.extend((i, int(k)) for k in idx)
        par_slices.append(slice(lo, len(all_pairs)))
    left, right, left_oo, right_oo, ham = _batch_lr_stats(
        all_pairs, seqs, maxShift, opts.MATCH, opts.MISMATCH,
        opts.GAP_PENALTY, allowOneOff, device=dev)
    bims = np.zeros(len(seqs), dtype=bool)
    for i, sl in enumerate(par_slices):
        if sl.stop == sl.start:
            continue
        bims[i] = _vote_from_stats(
            left[sl], right[sl], left_oo[sl], right_oo[sl], ham[sl],
            len(seqs[i]), allowOneOff, minOneOffParentDistance)
    flagged = {s for s, b in zip(seqs, bims) if b}
    seqs_input = get_sequences(unqs)
    out = pd.Series([s in flagged for s in seqs_input], index=seqs_input)
    if verbose:
        print(f"Identified {int(out.sum())} bimeras out of {len(out)} "
              f"input sequences.")
    return out


def is_bimera_denovo_table(seqtab: pd.DataFrame,
                           minSampleFraction: float = 0.9,
                           ignoreNNegatives: int = 1,
                           minFoldParentOverAbundance: float = 1.5,
                           minParentAbundance: int = 2,
                           allowOneOff: bool = False,
                           minOneOffParentDistance: int = 4,
                           maxShift: int = 16, multithread=False,
                           verbose: bool = False, device=None,
                           **opt_overrides) -> pd.Series:
    """Consensus bimera detection across samples.

    reference: isBimeraDenovoTable (R/chimeras.R:220-248) and
    C_table_bimera2 (src/chimera.cpp:60-192)."""
    dev = resolve_device(device)
    opts = current_options().replace(**opt_overrides)
    sqs = list(seqtab.columns)
    if len(set(sqs)) != len(sqs):
        raise ValueError("Duplicate sequences detected in input.")
    mat = seqtab.values.astype(np.int64)
    nflag, nsam = _table_bimera_stats(
        mat, sqs, minFoldParentOverAbundance, minParentAbundance,
        allowOneOff, minOneOffParentDistance, maxShift, opts, device=dev)

    is_bim = (nflag >= nsam) | ((nflag > 0) &
                                (nflag >= (nsam - ignoreNNegatives) *
                                 minSampleFraction))
    out = pd.Series(is_bim, index=sqs)
    if verbose:
        print(f"Identified {int(out.sum())} bimeras out of {len(out)} "
              f"input sequences.")
    return out


def _table_pairs(mat, minFoldParentOverAbundance: float,
                 minParentAbundance: int) -> torch.Tensor:
    """Every (query column, union parent column) pair of a table (a tensor,
    or a host array, which runs on the CPU): [P, 2] int64 on its device,
    in (query, parent) order. Union parent matrix U[j, k] = some sample
    has j present and k qualifying as j's parent there (the reference
    lazily aligns each per-column parent once: the same union,
    src/chimera.cpp:120-146); so a column present in no sample has none.
    The abundances compare in float64, as numpy compares an int64 count
    with a float64 product. U is built over row chunks whose [samples,
    rows, columns] temporaries hold about TABLE_CHUNK elements, each read
    with one nonzero (row-major: the pairs come in np.nonzero's order)."""
    mat = torch.as_tensor(mat)
    nsam, ncol = mat.shape
    matf = mat.to(torch.float64)
    present = mat > 0
    parentable = (mat >= minParentAbundance) & present
    thr = minFoldParentOverAbundance * matf
    rows = max(1, TABLE_CHUNK // max(nsam * ncol, 1))
    out = []
    for j0 in range(0, ncol, rows):
        j1 = min(j0 + rows, ncol)
        U = ((matf[:, None, :] > thr[:, j0:j1, None])
             & parentable[:, None, :] & present[:, j0:j1, None]).any(0)
        r = torch.arange(j1 - j0, device=mat.device)
        U[r, r + j0] = False
        jk = trace.nonzero(U)
        jk[:, 0] += j0
        out.append(jk)
    return torch.cat(out) if out else torch.zeros(
        (0, 2), dtype=torch.int64, device=mat.device)


def _table_bimera_stats(mat: np.ndarray, sqs: List[str],
                        minFoldParentOverAbundance: float,
                        minParentAbundance: int, allowOneOff: bool,
                        minOneOffParentDistance: int, maxShift: int,
                        opts, device=None) -> tuple:
    """(nflag, nsam) per sequence column: in how many samples the
    sequence is present, and in how many it is flagged as a bimera of
    sample-local parents (reference: C_table_bimera2,
    src/chimera.cpp:60-192). The table crosses to the device once; its
    pairs, their stats and the votes stay there, and only (nflag, nsam)
    cross back (the pairs cross only where kernel B2 does not take
    them)."""
    dev = resolve_device(device)
    with PHASES("chimera.pairs"):
        d_mat = trace.put(mat, dev)
        pairs = _table_pairs(d_mat, minFoldParentOverAbundance,
                             minParentAbundance)
        trace.COUNTERS.add("chimera_pairs", len(pairs))
    with PHASES("chimera.stats"):
        be, bopts = _chimera_backend(sqs, opts.MATCH, opts.MISMATCH,
                                     opts.GAP_PENALTY, maxShift, dev)
        stats = (_pairs_lr_stats(be, bopts, pairs[:, 0], pairs[:, 1],
                                 maxShift, allowOneOff) if len(pairs) else
                 torch.zeros((0, 5), dtype=torch.int64, device=dev))
        if stats is None:
            st = _unplanned_lr_stats(be, bopts, trace.fetch(pairs), sqs,
                                     maxShift, allowOneOff)
            stats = be._put(np.stack(st, 1))
    with PHASES("chimera.vote"):
        return _table_votes(d_mat, be.d_lens, pairs, stats,
                            minFoldParentOverAbundance, minParentAbundance,
                            allowOneOff, minOneOffParentDistance)


def _table_votes(mat, sqlen, pairs, stats,
                 minFoldParentOverAbundance: float, minParentAbundance: int,
                 allowOneOff: bool, minOneOffParentDistance: int) -> tuple:
    """(nflag, nsam) per column, int64 on the host, from the lr/ham stats
    ([P, 5], left, right, left_oo, right_oo, ham) of its (query, parent)
    pairs, voted on the pairs' device (the table, the query lengths sqlen
    and the stats are moved there if they are not). Per sample, a
    column's parents are its pairs' parents of more than fold times its
    abundance (float64) and at least minParentAbundance; its vote takes
    the maxima of their credits over chunks of pairs (scatter_reduce amax,
    exact in any order). A column with no pairs is flagged in no sample."""
    pairs = torch.as_tensor(pairs)
    dev = pairs.device
    matT = torch.as_tensor(mat, device=dev).T          # [ncol, nsam]
    sqlen = torch.as_tensor(sqlen, device=dev).to(torch.int64)
    stats = torch.as_tensor(stats, device=dev).to(torch.int64)
    ncol, nsam_tot = matT.shape
    present = matT > 0
    matf = matT.to(torch.float64)
    thr = minFoldParentOverAbundance * matf
    ge_abund = matT >= minParentAbundance
    j, k = pairs[:, 0], pairs[:, 1]
    keep = stats[:, 0] + stats[:, 1] < sqlen[j]  # toss id/shift parents
    cred = torch.where(keep[:, None], stats[:, :4], 0)
    # maxima over each column's parents, per sample: left, right, and
    # under allowOneOff, over the parents far enough for a one-off:
    # left, right, left_oo, right_oo
    nm = 6 if allowOneOff else 2
    M = torch.zeros((nm, ncol, nsam_tot), dtype=torch.int64, device=dev)
    step = max(1, VOTE_CHUNK // max(nsam_tot, 1))
    for p0 in range(0, len(pairs), step):
        sl = slice(p0, p0 + step)
        jj, kk = j[sl], k[sl]
        pm = (matf[kk] > thr[jj]) & ge_abund[kk]       # [pairs, samples]
        idx = jj[:, None].expand(-1, nsam_tot)
        c = cred[sl]
        vals = [torch.where(pm, c[:, m:m + 1], 0) for m in (0, 1)]
        if allowOneOff:
            pa = pm & (stats[sl, 4] >= minOneOffParentDistance)[:, None]
            vals += [torch.where(pa, c[:, m:m + 1], 0) for m in range(4)]
        for m, v in enumerate(vals):
            M[m].scatter_reduce_(0, idx, v, "amax")
    L = sqlen[:, None]
    flag = M[0] + M[1] >= L
    if allowOneOff:
        flag |= (M[2] + M[5] >= L) | (M[4] + M[3] >= L)
    has_pairs = torch.zeros(ncol, dtype=torch.bool, device=dev)
    has_pairs[j] = True
    nflag = (flag & present & has_pairs[:, None]).sum(1)
    out = trace.fetch(torch.stack([nflag, present.sum(1)]))
    return out[0], out[1]


def remove_bimera_denovo(unqs, method: str = "consensus",
                         verbose: bool = False, device=None, **kwargs):
    """Remove chimeric sequences (reference: removeBimeraDenovo,
    R/chimeras.R:294-346)."""
    from .dada import DadaResult
    from .derep import Derep

    dev = resolve_device(device)
    if isinstance(unqs, pd.DataFrame) and "sequence" not in unqs.columns:
        # sequence table: samples x sequences
        with PHASES("chimera.table"):
            trace.attrs(asvs=unqs.shape[1], samples=unqs.shape[0],
                        method=method)
            return _remove_bimera_table(unqs, method, verbose, dev, kwargs)
    if isinstance(unqs, DadaResult):
        bim = is_bimera_denovo(unqs, verbose=verbose, device=dev, **kwargs)
        return {s: a for (s, a), b in zip(unqs.denoised.items(), bim)
                if not b}
    if isinstance(unqs, Derep):
        bim = is_bimera_denovo(unqs, verbose=verbose, device=dev, **kwargs)
        return {s: a for (s, a), b in zip(unqs.uniques.items(), bim)
                if not b}
    if isinstance(unqs, pd.DataFrame):  # clustering df
        bim = is_bimera_denovo(unqs, verbose=verbose, device=dev, **kwargs)
        return unqs.loc[~bim.values]
    if isinstance(unqs, dict):
        bim = is_bimera_denovo(unqs, verbose=verbose, device=dev, **kwargs)
        return {s: a for (s, a), b in zip(unqs.items(), bim) if not b}
    raise TypeError("Unrecognized format: requires uniques dict, "
                    "DadaResult, Derep, clustering DataFrame or sequence "
                    "table.")


def _remove_bimera_table(unqs: pd.DataFrame, method: str, verbose: bool,
                         dev, kwargs) -> pd.DataFrame:
    """remove_bimera_denovo on a sequence table (samples x sequences)."""
    if method == "pooled":
        pooled = {s: int(a) for s, a in
                  zip(unqs.columns, unqs.values.sum(axis=0))}
        bim = is_bimera_denovo(pooled, verbose=verbose, device=dev,
                               **kwargs)
    elif method == "consensus":
        bim = is_bimera_denovo_table(unqs, verbose=verbose, device=dev,
                                     **kwargs)
    elif method == "per-sample":
        out = unqs.copy()
        for i in range(out.shape[0]):
            row = {s: int(a) for s, a in
                   zip(out.columns, out.iloc[i]) if a > 0}
            if not row:
                continue
            bim_i = is_bimera_denovo(row, verbose=verbose, device=dev,
                                     **kwargs)
            for s, b in bim_i.items():
                if b:
                    out.iloc[i, out.columns.get_loc(s)] = 0
        keep = out.values.sum(axis=0) > 0
        return out.loc[:, keep]
    else:
        raise ValueError("Valid values for method: 'pooled', "
                         "'consensus', or 'per-sample'")
    return unqs.loc[:, ~bim.values]


def is_shift_denovo(unqs, minOverlap: int = 20, flagSubseqs: bool = False,
                    verbose: bool = False, device=None) -> pd.Series:
    """Flag sequences identical to a more abundant sequence up to a shift.

    reference: isShiftDenovo (R/chimeras.R:380-421). The reference runs a
    scalar nwalign + C_eval_pair per (sequence, parent) pair; here every
    pair rides kernel B4's unbanded scalar aligner in chunks
    (_batch_eval_stats)."""
    from .seqtab import get_sequences, get_uniques

    dev = resolve_device(device)
    opts = current_options()
    unqs_int = get_uniques(unqs)
    seqs = list(unqs_int.keys())
    abunds = np.array(list(unqs_int.values()))
    n = len(seqs)
    slen = np.array([len(s) for s in seqs], np.int64)

    all_pairs = []
    for i in range(n):
        pars = np.nonzero(abunds > abunds[i])[0]
        if not len(pars):
            if verbose:
                print("No possible parents.")
            continue
        all_pairs.extend((i, int(k)) for k in pars)
    match, mism, ind = _batch_eval_stats(all_pairs, seqs, opts.MATCH,
                                         opts.MISMATCH, opts.GAP_PENALTY,
                                         device=dev)
    shifts = np.zeros(n, dtype=bool)
    if all_pairs:
        pairs = np.asarray(all_pairs, np.int64)
        qi, pi = pairs[:, 0], pairs[:, 1]
        ok = (((match < slen[qi]) | flagSubseqs)
              & ((match < slen[pi]) | flagSubseqs)
              & (match >= minOverlap) & (mism == 0) & (ind == 0))
        shifts[qi[ok]] = True
    flagged = {s for s, b in zip(seqs, shifts) if b}
    seqs_input = get_sequences(unqs)
    return pd.Series([s in flagged for s in seqs_input], index=seqs_input)
