"""Filtering and trimming of fastq reads.

reference: R/filter.R (fastqFilter :613-730, fastqPairedFilter :878-1141,
filterAndTrim :402-497, isPhiX :1180-1187, seqComplexity :1248-1275,
.nFilter :1291-1295) and src/filter.cpp (C_matchRef :7-32, C_matrixEE
:35-49). The filter criteria are applied in exactly the reference's order:
orient.fwd -> maxLen -> trimLeft -> trimRight -> truncQ -> truncLen filter
-> truncate -> minLen -> maxN -> minQ -> maxEE -> phiX -> low-complexity.

Per-file fan-out uses processes (the reference forks via mclapply); the
per-read criteria are vectorized numpy over streaming chunks. A copy of
dada2_tpu/filter.py (host code, no device stage).
"""
from __future__ import annotations

import math
import os
import re
from concurrent.futures import ProcessPoolExecutor
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import pandas as pd

from .encode import rc
from .io.fastq import parse_fastq_directory, stream_fastq, write_fastq

Inf = math.inf


def _pair(v):
    """Double length-1 parameters for (forward, reverse)."""
    if isinstance(v, (list, tuple, np.ndarray)):
        if len(v) == 1:
            return [v[0], v[0]]
        if len(v) != 2:
            raise ValueError("Filter parameters must be length 1 or 2.")
        return list(v)
    return [v, v]


_EE_TABLE = 10.0 ** (-np.arange(256, dtype=np.float64) / 10.0)


def matrix_ee(quals: List[np.ndarray]) -> np.ndarray:
    """Per-read expected errors EE = sum 10^(-q/10).

    reference: src/filter.cpp:35-49 (C_matrixEE). Vectorized across
    reads; the per-read sum runs position-by-position so the float64
    accumulation order matches the reference's sequential loop exactly
    (read boundaries against maxEE must not flip on summation order).
    """
    n = len(quals)
    lens = np.fromiter((len(q) for q in quals), np.int64, count=n)
    L = int(lens.max()) if n else 0
    qm = np.zeros((n, L), np.float64)
    # row-major boolean assignment consumes the concatenation in
    # exactly per-read order (a per-read fill loop costs ~30s/1M reads)
    qm[np.arange(L, dtype=np.int64)[None, :] < lens[:, None]] = (
        np.concatenate(quals) if n else np.zeros(0))
    qi = qm.astype(np.int64)
    tabled = (qm == qi) & (qi >= 0) & (qi < len(_EE_TABLE))
    fac = _EE_TABLE[np.where(tabled, qi, 0)]
    if not tabled.all():
        # negative or non-integer scores: the exact formula, as before
        fac[~tabled] = 10.0 ** (-qm[~tabled] / 10.0)
    fac[np.arange(L)[None, :] >= lens[:, None]] = 0.0
    out = np.zeros(n)
    for pos in range(L):  # sequential in position, vector across reads
        out += fac[:, pos]
    return out


def _word_codes(s: str, word_size: int) -> np.ndarray:
    """2-bit rolling codes of all word_size-mers (uint64; -1 rows where
    the word contains a non-ACGT character)."""
    from .encode import seq_to_codes

    c = seq_to_codes(s).astype(np.int64)
    L = len(c)
    if L < word_size:
        return np.empty(0, np.int64)
    bad = c > 3
    c = np.where(bad, 0, c)
    w = np.zeros(L - word_size + 1, np.int64)
    anybad = np.zeros(L - word_size + 1, bool)
    for j in range(word_size):
        w = (w << 2) | c[j: j + L - word_size + 1]
        anybad |= bad[j: j + L - word_size + 1]
    return np.where(anybad, -1, w)


def match_ref(seqs: Sequence[str], ref: str, word_size: int = 16,
              non_overlapping: bool = True) -> np.ndarray:
    """Count word_size-word matches of each seq against a circularized ref.

    reference: src/filter.cpp:7-32 (C_matchRef), including its skip of
    word_size+1 positions after a non-overlapping hit. Words are hashed
    as 2-bit integer codes and membership is a vectorized sorted search;
    the sequential skip walk only runs over each read's (usually empty)
    hit list.
    """
    if 2 * word_size > 63:
        raise ValueError("word_size too large for 2-bit hashing")
    hits = _match_words(seqs, [_ref_words(ref, word_size)], word_size)[0]
    if not non_overlapping:
        return hits.sum(axis=1).astype(np.int64)
    return _skip_walk(hits, word_size)


def _ref_words(ref: str, word_size: int):
    """Sorted 2-bit word table of a circularized reference, plus the
    literal words containing non-ACGT characters (the reference hashes
    raw strings, src/filter.cpp:21-24)."""
    refc = ref + ref[:word_size]
    rw = _word_codes(refc, word_size)[: len(ref)]
    words = np.unique(rw[rw >= 0])
    odd_words = {refc[i: i + word_size] for i in np.nonzero(rw < 0)[0]}
    return words, odd_words


def _match_words(seqs, tables, word_size: int):
    """Per-position word-hit masks of every read against one or more
    word tables, with ONE rolling-code pass and ONE sorted search over
    the union (words are <= 32 bits for word_size <= 16, halving the
    memory traffic of the searches)."""
    n = len(seqs)
    out = [np.zeros((n, 0), bool) for _ in tables]
    if n == 0:
        return out
    from .encode import pack_sequences

    codes, lens = pack_sequences(seqs)
    L = codes.shape[1]
    W = L - word_size + 1
    if W <= 0:
        return out
    dt = np.uint32 if 2 * word_size <= 32 else np.int64
    c = codes
    bad = c > 3
    c0 = np.where(bad, 0, c).astype(dt)
    w = np.zeros((n, W), dt)
    anybad = np.zeros((n, W), bool)
    for j in range(word_size):
        w = (w << dt(2)) | c0[:, j: j + W]
        anybad |= bad[:, j: j + W]
    inlen = (np.arange(W, dtype=np.int64)[None, :]
             < (lens.astype(np.int64) - word_size + 1)[:, None])
    union = np.unique(np.concatenate(
        [t[0] for t in tables])).astype(dt) if any(
            len(t[0]) for t in tables) else np.zeros(0, dt)
    side = np.zeros((len(tables), len(union)), bool)
    for ti, (words, _odd) in enumerate(tables):
        side[ti, np.searchsorted(union, words.astype(dt))] = True
    if len(union):
        idx = np.minimum(np.searchsorted(union, w), len(union) - 1)
        member = (union[idx] == w) & inlen & ~anybad
    for ti, (words, odd_words) in enumerate(tables):
        hit = (member & side[ti][idx]) if len(union) else np.zeros(
            (n, W), bool)
        if odd_words:
            rr, cc = np.nonzero(anybad & inlen)
            for r, j in zip(rr, cc):
                if seqs[r][j: j + word_size] in odd_words:
                    hit[r, j] = True
        out[ti] = hit
    return out


def _skip_walk(hit: np.ndarray, word_size: int) -> np.ndarray:
    """Non-overlapping hit count: skip word_size+1 positions after each
    counted hit (reference: src/filter.cpp:7-32). Hits are rare, so the
    sequential walk only runs over reads that have any."""
    out = np.zeros(hit.shape[0], dtype=np.int64)
    for k in np.nonzero(hit.any(axis=1))[0]:
        pos = np.nonzero(hit[k])[0]
        cnt = 0
        nxt = 0
        for p in pos:
            if p >= nxt:
                cnt += 1
                nxt = p + word_size + 1
        out[k] = cnt
    return out


def is_phix(seqs, wordSize: int = 16, minMatches: int = 2,
            nonOverlapping: bool = True, **_) -> np.ndarray:
    """Whether each sequence matches the phiX genome.

    reference: R/filter.R:1180-1187 (isPhiX).
    """
    from .seqtab import get_sequences

    seqs = get_sequences(seqs)
    phix_path = os.path.join(os.path.dirname(__file__), "data",
                             "phix_genome.fa")
    with open(phix_path) as f:
        sq = "".join(line.strip() for line in f if not line.startswith(">"))
    # forward and reverse-complement word tables share one rolling-code
    # pass and one sorted search over their union
    hf, hr = _match_words(seqs, [_ref_words(sq, wordSize),
                                 _ref_words(rc(sq), wordSize)], wordSize)
    if nonOverlapping:
        hits = _skip_walk(hf, wordSize)
        hits_rc = _skip_walk(hr, wordSize)
    else:
        hits, hits_rc = hf.sum(axis=1), hr.sum(axis=1)
    return (hits >= minMatches) | (hits_rc >= minMatches)


def _sindex(counts: np.ndarray) -> float:
    """Effective Shannon richness (reference: R/filter.R sindex)."""
    tot = counts.sum()
    if tot == 0:
        return 0.0
    y = counts[counts > 0] / tot
    return float(np.exp(np.sum(-y * np.log(y))))


def _sindex_rows(counts: np.ndarray) -> np.ndarray:
    """Row-wise effective Shannon richness, sum sequential over the (at
    most 4^k) kmer columns as R's sum() is."""
    tot = counts.sum(axis=1, dtype=np.float64)
    safe = np.where(tot > 0, tot, 1.0)
    y = counts / safe[:, None]
    with np.errstate(divide="ignore", invalid="ignore"):
        term = np.where(counts > 0, -y * np.log(y), 0.0)
    acc = np.zeros(len(counts))
    for c in range(term.shape[1]):  # sequential across kmer columns
        acc += term[:, c]
    return np.where(tot > 0, np.exp(acc), 0.0)


def _kmer_hist_rows(codes: np.ndarray, lens: np.ndarray, k: int,
                    start: int = 0, stop: Optional[int] = None):
    """[n, 4^k] kmer counts of each row's [start, stop) slice; non-ACGT
    break kmers, as in the reference's tables()."""
    n, L = codes.shape
    stop = L if stop is None else min(stop, L)
    if stop - start < k:
        return np.zeros((n, 4 ** k), np.int64)
    c = codes[:, start:stop].astype(np.int64)
    W = c.shape[1] - k + 1
    bad = c > 3
    cz = np.where(bad, 0, c)
    w = np.zeros((n, W), np.int64)
    anybad = np.zeros((n, W), bool)
    for j in range(k):
        w = (w << 2) | cz[:, j: j + W]
        anybad |= bad[:, j: j + W]
    # kmers must lie inside each row's real length
    valid = (~anybad) & (np.arange(start, start + W)[None, :]
                         <= (lens[:, None] - k))
    nk = 4 ** k
    rows = np.repeat(np.arange(n, dtype=np.int64), W)
    flat = w.ravel()
    keep = valid.ravel()
    hist = np.bincount(rows[keep] * nk + flat[keep], minlength=n * nk)
    return hist.reshape(n, nk)


def seq_complexity(seqs, kmerSize: int = 2, window: Optional[int] = None,
                   by: int = 5, **_) -> np.ndarray:
    """Shannon kmer richness; min over sliding windows if window given.

    reference: R/filter.R:1248-1275 (seqComplexity). Vectorized: one
    flat-bincount kmer histogram per (window x batch)."""
    from .encode import pack_sequences
    from .seqtab import get_sequences

    if window is not None and kmerSize >= window:
        raise ValueError("The window must be larger than the kmerSize.")
    seqs = get_sequences(seqs)
    si_max = 4.0 ** kmerSize
    if not len(seqs):
        return np.zeros(0)
    codes, lens = pack_sequences(seqs)
    if window is None:
        return _sindex_rows(_kmer_hist_rows(codes, lens, kmerSize))
    out = np.full(len(seqs), si_max)
    maxw = int(lens.max())
    for i in range(0, max(maxw - window, 0), by):
        hist = _kmer_hist_rows(codes, lens, kmerSize, i, i + window)
        si = _sindex_rows(hist)
        inwin = lens >= i + window
        out[inwin] = np.minimum(out[inwin], si[inwin])
    return out


# ---------------------------------------------------------------------------
# chunk-level filtering core
# ---------------------------------------------------------------------------

class _Chunk:
    """Mutable (ids, seqs, quals) triple with vectorized culls."""

    def __init__(self, ids, seqs, quals):
        self.ids = [i.decode("ascii") if isinstance(i, bytes) else i
                    for i in ids]
        self.seqs = [s.decode("ascii") if isinstance(s, bytes) else s
                     for s in seqs]
        self.quals = [np.frombuffer(q, dtype=np.uint8).astype(np.int32) - 33
                      if isinstance(q, bytes) else np.asarray(q)
                      for q in quals]

    def __len__(self):
        return len(self.seqs)

    def keep(self, mask):
        mask = np.asarray(mask, bool)
        self.ids = [x for x, m in zip(self.ids, mask) if m]
        self.seqs = [x for x, m in zip(self.seqs, mask) if m]
        self.quals = [x for x, m in zip(self.quals, mask) if m]

    def widths(self) -> np.ndarray:
        return np.array([len(s) for s in self.seqs], dtype=np.int64)

    def narrow(self, start: int = 1, end: Optional[List[int]] = None):
        """1-based inclusive narrow, like IRanges::narrow."""
        for k in range(len(self.seqs)):
            e = len(self.seqs[k]) if end is None else end[k]
            self.seqs[k] = self.seqs[k][start - 1: e]
            self.quals[k] = self.quals[k][start - 1: e]

    def trim_tails(self, truncQ: int):
        """Truncate at the first quality <= truncQ (ShortRead::trimTails
        with k=1)."""
        for k in range(len(self.seqs)):
            q = self.quals[k]
            bad = np.nonzero(q <= truncQ)[0]
            if len(bad):
                e = int(bad[0])
                self.seqs[k] = self.seqs[k][:e]
                self.quals[k] = q[:e]

    def n_counts(self) -> np.ndarray:
        """Non-ACGT character count per read (reference .nFilter)."""
        return np.array([len(s) - s.count("A") - s.count("C")
                         - s.count("G") - s.count("T")
                         for s in self.seqs], dtype=np.int64)

    def rc_inplace(self, k):
        self.seqs[k] = rc(self.seqs[k])
        self.quals[k] = self.quals[k][::-1]


def _filter_chunk_single(ch: _Chunk, truncQ, truncLen, maxLen, minLen,
                         trimLeft, trimRight, maxN, minQ, maxEE, rm_phix,
                         rm_lowcomplex, orient_fwd, phix_kwargs):
    start = max(1, trimLeft + 1)
    end = truncLen
    end = None if end < start else end - start + 1

    if orient_fwd is not None:
        barlen = len(orient_fwd)
        keepF = np.array([s[:barlen] == orient_fwd for s in ch.seqs])
        rcs = [rc(s) for s in ch.seqs]
        keepR = np.array([r[:barlen] == orient_fwd
                          for r in rcs]) & ~keepF
        for k in np.nonzero(keepR)[0]:
            ch.rc_inplace(int(k))
        ch.keep(keepF | keepR)
    if math.isfinite(maxLen):
        ch.keep(ch.widths() <= maxLen)
    ch.keep(ch.widths() >= start)
    ch.narrow(start=start)
    if trimRight > 0:
        ch.keep(ch.widths() > trimRight)
        ch.narrow(end=list(ch.widths() - trimRight))
    ch.trim_tails(truncQ)
    if end is not None:
        ch.keep(ch.widths() >= end)
        ch.narrow(end=[end] * len(ch))
    ch.keep(ch.widths() >= minLen)
    ch.keep(ch.n_counts() <= maxN)
    keep = np.ones(len(ch), dtype=bool)
    if minQ > truncQ:
        keep &= np.array([q.min() if len(q) else np.inf
                          for q in ch.quals]) > minQ
    if maxEE < Inf:
        keep &= matrix_ee(ch.quals) <= maxEE
    ch.keep(keep)
    if rm_phix and len(ch):
        ch.keep(~is_phix(ch.seqs, **phix_kwargs))
    if rm_lowcomplex > 0 and len(ch):
        ch.keep(seq_complexity(ch.seqs, **phix_kwargs) >= rm_lowcomplex)
    return ch


def fastq_filter(fn: str, fout: str, truncQ=2, truncLen=0, maxLen=Inf,
                 minLen=20, trimLeft=0, trimRight=0, maxN=0, minQ=0,
                 maxEE=Inf, rm_phix=True, rm_lowcomplex=0, orient_fwd=None,
                 n: int = 1_000_000, compress: Optional[bool] = None,
                 verbose: bool = False, **phix_kwargs):
    """Filter and trim a single fastq file (reference: R/filter.R:613-730).

    Returns (reads_in, reads_out)."""
    if fn == fout:
        raise ValueError("The output and input files must be different.")
    if os.path.exists(fout):
        os.remove(fout)
    if compress is None:
        compress = fout.endswith(".gz")
    inseqs = outseqs = 0
    first = True
    for raw in stream_fastq(fn, n=n):
        ch = _Chunk(raw.ids, raw.seqs, raw.quals)
        inseqs += len(ch)
        ch = _filter_chunk_single(ch, truncQ, truncLen, maxLen, minLen,
                                  trimLeft, trimRight, maxN, minQ, maxEE,
                                  rm_phix, rm_lowcomplex, orient_fwd,
                                  phix_kwargs)
        outseqs += len(ch)
        write_fastq(fout, ch.ids, ch.seqs,
                    [(q + 33).astype(np.uint8).tobytes() for q in ch.quals],
                    append=not first, compress=compress)
        first = False
    if verbose:
        pct = round(outseqs * 100 / inseqs, 1) if inseqs else 0
        print(f"Read in {inseqs}, output {outseqs} ({pct}%) filtered "
              f"sequences.")
    if outseqs == 0:
        print(f"The filter removed all reads: {fout} not written.")
        if os.path.exists(fout):
            os.remove(fout)
    return inseqs, outseqs


def _detect_id_field(id1: str, id_sep: str) -> Tuple[str, int]:
    """CASAVA id-field detection (reference: R/filter.R:940-960)."""
    fields = re.split(id_sep, id1)
    ncolon = [f.count(":") for f in fields]
    if max(ncolon, default=0) == 6 and ncolon.count(6) == 1:
        return "Current", ncolon.index(6)
    if max(ncolon, default=0) == 4 and ncolon.count(4) == 1:
        return "Old", ncolon.index(4)
    raise ValueError("Couldn't automatically detect the sequence "
                     "identifier field in the fastq id string.")


def fastq_paired_filter(fn: Sequence[str], fout: Sequence[str], maxN=(0, 0),
                        truncQ=(2, 2), truncLen=(0, 0), maxLen=(Inf, Inf),
                        minLen=(20, 20), trimLeft=(0, 0), trimRight=(0, 0),
                        minQ=(0, 0), maxEE=(Inf, Inf), rm_phix=(True, True),
                        rm_lowcomplex=(0, 0), matchIDs: bool = False,
                        orient_fwd=None, id_sep=r"\s", id_field=None,
                        n: int = 1_000_000, compress: Optional[bool] = None,
                        verbose: bool = False, **phix_kwargs):
    """Jointly filter paired fastq files (reference: R/filter.R:878-1141).

    Returns (reads_in, reads_out)."""
    if len(fn) != 2 or len(fout) != 2:
        raise ValueError("Two paired input and output file names required.")
    if len(set(list(fn) + list(fout))) != 4:
        raise ValueError("The output and input file names must be different.")
    maxN, truncQ, truncLen = _pair(maxN), _pair(truncQ), _pair(truncLen)
    maxLen, minLen = _pair(maxLen), _pair(minLen)
    trimLeft, trimRight = _pair(trimLeft), _pair(trimRight)
    minQ, maxEE = _pair(minQ), _pair(maxEE)
    rm_phix, rm_lowcomplex = _pair(rm_phix), _pair(rm_lowcomplex)

    startF = max(1, trimLeft[0] + 1)
    startR = max(1, trimLeft[1] + 1)
    endF = truncLen[0]
    endF = None if endF < startF else endF - startF + 1
    endR = truncLen[1]
    endR = None if endR < startR else endR - startR + 1

    for f in fout:
        if os.path.exists(f):
            os.remove(f)
    if compress is None:
        compress = fout[0].endswith(".gz")

    genF = stream_fastq(fn[0], n=n)
    genR = stream_fastq(fn[1], n=n)
    first = True
    casava = "Undetermined"
    remF = remR = None
    inseqs = outseqs = 0
    while True:
        rawF = next(genF, None)
        rawR = next(genR, None)
        if rawF is None and rawR is None:
            break
        chF = _Chunk(rawF.ids, rawF.seqs, rawF.quals) if rawF else \
            _Chunk([], [], [])
        chR = _Chunk(rawR.ids, rawR.seqs, rawR.quals) if rawR else \
            _Chunk([], [], [])
        inseqs += len(chF)

        if matchIDs:
            if first:
                if id_field is None:
                    casava, id_field = _detect_id_field(chF.ids[0], id_sep)
            elif remF is not None:
                for attr in ("ids", "seqs", "quals"):
                    setattr(chF, attr, getattr(remF, attr) +
                            getattr(chF, attr))
                    setattr(chR, attr, getattr(remR, attr) +
                            getattr(chR, attr))
            idsF = [re.split(id_sep, i)[id_field] for i in chF.ids]
            idsR = [re.split(id_sep, i)[id_field] for i in chR.ids]
            if casava == "Old":
                idsF = [i.split("#")[0] for i in idsF]
                idsR = [i.split("#")[0] for i in idsR]
            setR = set(idsR)
            setF = set(idsF)
            inF = np.array([i in setR for i in idsF], dtype=bool)
            inR = np.array([i in setF for i in idsR], dtype=bool)
            lastF = int(np.nonzero(inF)[0].max()) + 1 if inF.any() else 0
            lastR = int(np.nonzero(inR)[0].max()) + 1 if inR.any() else 0
            remF = _Chunk(chF.ids[lastF:], chF.seqs[lastF:],
                          chF.quals[lastF:])
            remR = _Chunk(chR.ids[lastR:], chR.seqs[lastR:],
                          chR.quals[lastR:])
            chF.keep(inF)
            chR.keep(inR)
        else:
            if len(chF) != len(chR):
                raise ValueError(
                    f"Mismatched forward and reverse sequence files: "
                    f"{len(chF)}, {len(chR)}.")

        if orient_fwd is not None:
            barlen = len(orient_fwd)
            keepF = np.array([s[:barlen] == orient_fwd for s in chF.seqs],
                             dtype=bool)
            keepR = np.array([s[:barlen] == orient_fwd for s in chR.seqs],
                             dtype=bool) & ~keepF
            # swap flipped pairs: fwd <- rev, rev <- fwd
            for k in np.nonzero(keepR)[0]:
                k = int(k)
                chF.seqs[k], chR.seqs[k] = chR.seqs[k], chF.seqs[k]
                chF.quals[k], chR.quals[k] = chR.quals[k], chF.quals[k]
                chF.ids[k], chR.ids[k] = chR.ids[k], chF.ids[k]
            keep = keepF | keepR
            chF.keep(keep)
            chR.keep(keep)

        if math.isfinite(maxLen[0]) or math.isfinite(maxLen[1]):
            keep = (chF.widths() <= maxLen[0]) & (chR.widths() <= maxLen[1])
            chF.keep(keep)
            chR.keep(keep)
        keep = (chF.widths() >= startF) & (chR.widths() >= startR)
        chF.keep(keep)
        chR.keep(keep)
        chF.narrow(start=startF)
        chR.narrow(start=startR)
        if trimRight[0] > 0:
            keep = chF.widths() > trimRight[0]
            chF.keep(keep)
            chR.keep(keep)
            chF.narrow(end=list(chF.widths() - trimRight[0]))
        if trimRight[1] > 0:
            keep = chR.widths() > trimRight[1]
            chF.keep(keep)
            chR.keep(keep)
            chR.narrow(end=list(chR.widths() - trimRight[1]))
        chF.trim_tails(truncQ[0])
        chR.trim_tails(truncQ[1])
        keep = (chF.widths() > 0) & (chR.widths() > 0)
        chF.keep(keep)
        chR.keep(keep)
        keep = np.ones(len(chF), dtype=bool)
        if endF is not None:
            keep &= chF.widths() >= endF
        if endR is not None:
            keep &= chR.widths() >= endR
        chF.keep(keep)
        chR.keep(keep)
        if endF is not None:
            chF.narrow(end=[endF] * len(chF))
        if endR is not None:
            chR.narrow(end=[endR] * len(chR))
        keep = (chF.widths() >= minLen[0]) & (chR.widths() >= minLen[1])
        chF.keep(keep)
        chR.keep(keep)
        keep = (chF.n_counts() <= maxN[0]) & (chR.n_counts() <= maxN[1])
        chF.keep(keep)
        chR.keep(keep)
        keep = np.ones(len(chF), dtype=bool)
        if minQ[0] > truncQ[0]:
            keep &= np.array([q.min() if len(q) else np.inf
                              for q in chF.quals]) > minQ[0]
        if maxEE[0] < Inf:
            keep &= matrix_ee(chF.quals) <= maxEE[0]
        if minQ[1] > truncQ[1]:
            keep &= np.array([q.min() if len(q) else np.inf
                              for q in chR.quals]) > minQ[1]
        if maxEE[1] < Inf:
            keep &= matrix_ee(chR.quals) <= maxEE[1]
        chF.keep(keep)
        chR.keep(keep)

        if len(chF) and (rm_phix[0] or rm_phix[1]):
            if rm_phix[0] and rm_phix[1]:
                isphi = is_phix(chF.seqs, **phix_kwargs) | \
                    is_phix(chR.seqs, **phix_kwargs)
            elif rm_phix[0]:
                isphi = is_phix(chF.seqs, **phix_kwargs)
            else:
                isphi = is_phix(chR.seqs, **phix_kwargs)
            chF.keep(~isphi)
            chR.keep(~isphi)
        if len(chF) and (rm_lowcomplex[0] or rm_lowcomplex[1]):
            if rm_lowcomplex[0] and rm_lowcomplex[1]:
                lowc = (seq_complexity(chF.seqs) < rm_lowcomplex[0]) | \
                    (seq_complexity(chR.seqs) < rm_lowcomplex[1])
            elif rm_lowcomplex[0]:
                lowc = seq_complexity(chF.seqs) < rm_lowcomplex[0]
            else:
                lowc = seq_complexity(chR.seqs) < rm_lowcomplex[1]
            chF.keep(~lowc)
            chR.keep(~lowc)

        outseqs += len(chF)
        for ch, f in ((chF, fout[0]), (chR, fout[1])):
            write_fastq(f, ch.ids, ch.seqs,
                        [(q + 33).astype(np.uint8).tobytes()
                         for q in ch.quals],
                        append=not first, compress=compress)
        first = False

    if verbose:
        pct = round(outseqs * 100 / inseqs, 1) if inseqs else 0
        print(f"Read in {inseqs} paired-sequences, output {outseqs} "
              f"({pct}%) filtered paired-sequences.")
    if outseqs == 0:
        print(f"The filter removed all reads: {fout[0]} and {fout[1]} "
              f"not written.")
        for f in fout:
            if os.path.exists(f):
                os.remove(f)
    return inseqs, outseqs


def _run_single(args):
    fn, fout, kwargs = args
    return fastq_filter(fn, fout, **kwargs)


def _run_paired(args):
    fn, fout, kwargs = args
    return fastq_paired_filter(fn, fout, **kwargs)


def filter_and_trim(fwd, filt, rev=None, filt_rev=None, compress=None,
                    truncQ=2, truncLen=0, trimLeft=0, trimRight=0,
                    maxLen=Inf, minLen=20, maxN=0, minQ=0, maxEE=Inf,
                    rm_phix=True, rm_lowcomplex=0, orient_fwd=None,
                    matchIDs=False, id_sep=r"\s", id_field=None,
                    multithread: Union[bool, int] = False,
                    n: int = 100_000, verbose: bool = False) -> pd.DataFrame:
    """Filter and trim fastq file(s), paired or single-end.

    reference: R/filterAndTrim (R/filter.R:402-497). Returns a DataFrame
    with reads.in / reads.out per input file."""
    if isinstance(fwd, (str, os.PathLike)):
        fwd = parse_fastq_directory(str(fwd)) if os.path.isdir(str(fwd)) \
            else [str(fwd)]
    else:
        fwd = [str(f) for f in fwd]
    if not all(os.path.exists(f) for f in fwd):
        raise ValueError("Some input files do not exist.")
    if isinstance(filt, (str, os.PathLike)):
        filt = [str(filt)] if len(fwd) == 1 else \
            [os.path.join(str(filt), os.path.basename(f)) for f in fwd]
    else:
        filt = [str(f) for f in filt]
    if len(fwd) != len(filt):
        raise ValueError("Every input file must have a corresponding "
                         "output file.")
    for odir in {os.path.dirname(f) for f in filt}:
        if odir and not os.path.isdir(odir):
            os.makedirs(odir, exist_ok=True)
    if len(set(filt)) != len(filt):
        raise ValueError("All output files must be distinct.")
    if set(filt) & set(fwd):
        raise ValueError("Output files must be distinct from the input "
                         "files.")

    paired = rev is not None
    if paired:
        if filt_rev is None:
            raise ValueError("Output files for the reverse reads are "
                             "required.")
        if isinstance(rev, (str, os.PathLike)):
            rev = parse_fastq_directory(str(rev)) \
                if os.path.isdir(str(rev)) else [str(rev)]
        else:
            rev = [str(f) for f in rev]
        if isinstance(filt_rev, (str, os.PathLike)):
            filt_rev = [str(filt_rev)] if len(rev) == 1 else \
                [os.path.join(str(filt_rev), os.path.basename(f))
                 for f in rev]
        else:
            filt_rev = [str(f) for f in filt_rev]
        if len(rev) != len(fwd) or len(filt_rev) != len(rev):
            raise ValueError("Paired forward and reverse input files must "
                             "correspond.")
        for odir in {os.path.dirname(f) for f in filt_rev}:
            if odir and not os.path.isdir(odir):
                os.makedirs(odir, exist_ok=True)

    kwargs = dict(truncQ=truncQ, truncLen=truncLen, trimLeft=trimLeft,
                  trimRight=trimRight, maxLen=maxLen, minLen=minLen,
                  maxN=maxN, minQ=minQ, maxEE=maxEE, rm_phix=rm_phix,
                  rm_lowcomplex=rm_lowcomplex, orient_fwd=orient_fwd,
                  n=n, compress=compress, verbose=verbose)
    if paired:
        kwargs.update(matchIDs=matchIDs, id_sep=id_sep, id_field=id_field)
        jobs = [((f, r), (ff, fr), kwargs)
                for f, r, ff, fr in zip(fwd, rev, filt, filt_rev)]
        runner = _run_paired
    else:
        jobs = [(f, ff, kwargs) for f, ff in zip(fwd, filt)]
        runner = _run_single

    ncores = 1
    if multithread:
        ncores = os.cpu_count() if multithread is True else int(multithread)
    # Every file is processed even if some fail; per-file errors are
    # collected and reported together at the end (up to 5), like the
    # reference (R/filter.R:479-489) — one corrupt fastq must not
    # abandon the rest of a large batch.
    errors: list[tuple[str, Exception]] = []
    if ncores > 1 and len(jobs) > 1:
        # spawn, not fork: a child forked after the parent initialised
        # CUDA cannot use it (and importing the package in the spawned
        # child initialises none)
        import multiprocessing as mp
        with ProcessPoolExecutor(
                max_workers=ncores,
                mp_context=mp.get_context("spawn")) as ex:
            futs = [ex.submit(runner, j) for j in jobs]
            results = []
            for f, fut in zip(fwd, futs):
                try:
                    results.append(fut.result())
                except Exception as e:  # noqa: BLE001 — reported below
                    errors.append((os.path.basename(f), e))
                    results.append((0, 0))
    else:
        results = []
        for f, j in zip(fwd, jobs):
            try:
                results.append(runner(j))
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append((os.path.basename(f), e))
                results.append((0, 0))
    if errors:
        shown = "\n".join(f"  {name}: {type(e).__name__}: {e}"
                          for name, e in errors[:5])
        raise RuntimeError(
            f"filter_and_trim failed on {len(errors)} of {len(jobs)} "
            f"file(s); the rest were processed. Errors (up to 5):\n"
            f"{shown}")

    out = pd.DataFrame(results, columns=["reads.in", "reads.out"],
                       index=[os.path.basename(f) for f in fwd])
    if (out["reads.out"] == 0).all():
        import warnings
        warnings.warn("No reads passed the filter. Please revisit your "
                      "filtering parameters.")
    elif (out["reads.out"] == 0).any():
        print("Some input samples had no reads pass the filter.")
    return out


# ---------------------------------------------------------------------------
# primer removal (PacBio entry point)
# ---------------------------------------------------------------------------

_IUPAC_SETS = {
    "A": "A", "C": "C", "G": "G", "T": "T", "U": "T",
    "M": "AC", "R": "AG", "W": "AT", "S": "CG", "Y": "CT", "K": "GT",
    "V": "ACG", "H": "ACT", "D": "AGT", "B": "CGT", "N": "ACGT",
}


def _match_matrix(fixed: bool) -> np.ndarray:
    """[256, 256] bool: does primer char p match read char c."""
    m = np.zeros((256, 256), dtype=bool)
    for p, pset in _IUPAC_SETS.items():
        for c, cset in _IUPAC_SETS.items():
            hit = (p == c) if fixed else bool(set(pset) & set(cset))
            m[ord(p), ord(c)] = hit
            m[ord(p.lower()), ord(c)] = hit
            m[ord(p), ord(c.lower())] = hit
    return m


def _primer_dp(pv: np.ndarray, sv: np.ndarray, mm: np.ndarray):
    """Semi-global edit-distance DP matrix (subject start/end free) of
    one primer vs one subject; row-vectorized: the in-row dependency
    D[i,j] = min(cand[j], D[i,j-1]+1) is a running minimum, so each
    primer row is one minimum.accumulate instead of a per-cell loop."""
    plen, slen = len(pv), len(sv)
    D = np.zeros((plen + 1, slen + 1), dtype=np.int64)
    jar = np.arange(slen + 1, dtype=np.int64)
    prev = D[0]
    for i in range(1, plen + 1):
        subc = (~mm[pv[i - 1], sv]).astype(np.int64)
        cand = np.empty(slen + 1, dtype=np.int64)
        cand[0] = i
        np.minimum(prev[:-1] + subc, prev[1:] + 1, out=cand[1:])
        # D[i, j] = min over j' <= j of cand[j'] + (j - j')
        D[i] = jar + np.minimum.accumulate(cand - jar)
        prev = D[i]
    return D


def _match_primer_batch(primer: str, seqs, max_mismatch: int,
                        with_indels: bool, fixed: bool):
    """_match_primer over a whole read list. The no-indel path runs one
    rolling mismatch count over a padded byte matrix (per-read calls pay
    ~plen array overheads each); the indel DP stays per read (it is
    already row-vectorized)."""
    if with_indels:
        return [_match_primer(primer, s, max_mismatch, True, fixed)
                for s in seqs]
    n = len(seqs)
    plen = len(primer)
    lens = np.fromiter((len(s) for s in seqs), np.int64, count=n)
    L = int(lens.max()) if n else 0
    if L < plen:
        return [[] for _ in range(n)]
    mm = _match_matrix(fixed)
    pv = np.frombuffer(primer.encode(), dtype=np.uint8)
    joined = "".join(seqs).encode("ascii")
    sb = np.zeros((n, L), np.uint8)
    sb[np.arange(L, dtype=np.int64)[None, :] < lens[:, None]] = (
        np.frombuffer(joined, dtype=np.uint8))
    W = L - plen + 1
    mism = np.zeros((n, W), dtype=np.int16)
    for j in range(plen):
        mism += ~mm[pv[j], sb[:, j: j + W]]
    ok = (mism <= max_mismatch) & (
        np.arange(W, dtype=np.int64)[None, :]
        <= (lens - plen)[:, None])
    out = [[] for _ in range(n)]
    for r, h in zip(*np.nonzero(ok)):
        out[r].append((int(h), int(h) + plen - 1))
    return out


def _match_primer(primer: str, seq: str, max_mismatch: int,
                  with_indels: bool, fixed: bool):
    """Occurrences of primer in seq: list of (start, end) 0-based
    inclusive ranges. Without indels this reproduces Biostrings
    vmatchPattern; with indels it reports the best-fit windows by edit
    distance (reference: R/filter.R:122-151)."""
    plen = len(primer)
    slen = len(seq)
    if plen > slen:
        return []
    mm = _match_matrix(fixed)
    pv = np.frombuffer(primer.encode(), dtype=np.uint8)
    sv = np.frombuffer(seq.encode(), dtype=np.uint8)
    if not with_indels:
        nwin = slen - plen + 1
        mism = np.zeros(nwin, dtype=np.int64)
        for j in range(plen):
            mism += ~mm[pv[j], sv[j: j + nwin]]
        hits = np.nonzero(mism <= max_mismatch)[0]
        return [(int(h), int(h) + plen - 1) for h in hits]
    D = _primer_dp(pv, sv, mm)
    ends = np.nonzero(D[plen, 1:] <= max_mismatch)[0]
    out = []
    for e in ends:
        # backtrack to find start
        i, j = plen, int(e) + 1
        while i > 0:
            if j > 0 and D[i, j] == D[i - 1, j - 1] + \
                    (0 if mm[pv[i - 1], sv[j - 1]] else 1):
                i -= 1
                j -= 1
            elif D[i, j] == D[i - 1, j] + 1:
                i -= 1
            else:
                j -= 1
        out.append((j, int(e)))
    # drop nested duplicates, keep leftmost-per-end
    return out


def remove_primers(fn, fout, primer_fwd: str, primer_rev: Optional[str] = None,
                   max_mismatch: int = 2, allow_indels: bool = False,
                   trim_fwd: bool = True, trim_rev: bool = True,
                   orient: bool = True, compress: Optional[bool] = None,
                   verbose: bool = False) -> pd.DataFrame:
    """Remove primers and orient reads (intended for PacBio).

    reference: removePrimers (R/filter.R:81-233). Requires a forward-primer
    hit (and reverse if given); flips reads whose reverse complement
    matches; trims to the primer boundaries."""
    from .seqtab import get_sequences

    fn = [fn] if isinstance(fn, (str, os.PathLike)) else list(fn)
    fout = [fout] if isinstance(fout, (str, os.PathLike)) else list(fout)
    if len(fn) != len(fout):
        raise ValueError("Every input file must have a corresponding "
                         "output file.")
    if allow_indels and verbose:
        print("Primer matching with indels allowed is somewhat slower.")
    fixed_fwd = all(c in "ACGT" for c in primer_fwd)
    has_rev = primer_rev is not None
    fixed_rev = has_rev and all(c in "ACGT" for c in primer_rev)
    from .io.fastq import read_fastq

    rows = []
    first_multi_msg = True
    for f, fo in zip(fn, fout):
        ch = read_fastq(str(f))
        seqs = [s.decode("ascii") for s in ch.seqs]
        quals = list(ch.quals)
        ids = list(ch.ids)
        inseqs = len(seqs)

        def matches(primer, ss, fixed):
            return _match_primer_batch(primer, ss, max_mismatch,
                                       allow_indels, fixed)

        m_fwd = matches(primer_fwd, seqs, fixed_fwd)
        m_rev = matches(primer_rev, seqs, fixed_rev) if has_rev else None
        if orient:
            rcs = [rc(s) for s in seqs]
            m_fwd_rc = matches(primer_fwd, rcs, fixed_fwd)
            m_rev_rc = matches(primer_rev, rcs, fixed_rev) if has_rev \
                else None
        outseqs = 0
        keep_rows: List[int] = []
        firsts: List[int] = []
        lasts: List[int] = []
        out_seqs: List[str] = []
        out_quals: List[bytes] = []
        out_ids = []
        for r in range(inseqs):
            s = seqs[r]
            q = ch.quals[r]
            fwd_hits = m_fwd[r]
            rev_hits = m_rev[r] if has_rev else None
            if orient and not fwd_hits and m_fwd_rc[r]:
                s = rcs[r]
                q = q[::-1]
                fwd_hits = m_fwd_rc[r]
                rev_hits = m_rev_rc[r] if has_rev else None
            if not fwd_hits:
                continue
            if has_rev and not rev_hits:
                continue
            if (len(fwd_hits) > 1 or (has_rev and len(rev_hits) > 1)) \
                    and verbose and first_multi_msg:
                print("Multiple matches to the primer(s) in some "
                      "sequences. Using the longest possible match.")
                first_multi_msg = False
            first = fwd_hits[0][1] + 1 if trim_fwd else 0
            if has_rev and trim_rev:
                last = rev_hits[-1][0] - 1
            else:
                last = len(s) - 1
            if last <= first - 1 or last < first:
                continue
            out_seqs.append(s[first: last + 1])
            out_quals.append(q[first: last + 1])
            out_ids.append(ids[r])
            outseqs += 1
        if os.path.exists(str(fo)):
            os.remove(str(fo))
        write_fastq(str(fo), out_ids, out_seqs, out_quals,
                    compress=compress if compress is not None
                    else str(fo).endswith(".gz"))
        if verbose:
            pct = round(outseqs * 100 / inseqs, 1) if inseqs else 0
            print(f"Read in {inseqs}, output {outseqs} ({pct}%) filtered "
                  f"sequences.")
        rows.append((inseqs, outseqs))
    out = pd.DataFrame(rows, columns=["reads.in", "reads.out"],
                       index=[os.path.basename(str(f)) for f in fn])
    if (out["reads.out"] == 0).all():
        import warnings
        warnings.warn("No reads passed the primer detection.")
    elif (out["reads.out"] == 0).any():
        print("Some input samples had no reads pass the primer detection.")
    return out
