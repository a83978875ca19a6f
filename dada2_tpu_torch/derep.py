"""Dereplication of fastq reads into uniques with average quality profiles.

reference: R/sequenceIO.R:45-183 (derepFastq / qtables2). Semantics
reproduced exactly: within a chunk, uniques are discovered in lexical
sequence order; across chunks, new uniques append in encounter order;
finally uniques are stably sorted by decreasing abundance (so ties stay in
lexical/encounter order). Quality profiles are the float64 mean of the
per-read phred scores, NaN past each unique's length.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from .io.fastq import (FastqChunk, parse_fastq_directory, quals_to_matrix,
                       read_fastq, stream_fastq)


@dataclass
class Derep:
    """derep-class equivalent (reference: R/allClasses.R:1-17)."""

    uniques: Dict[str, int]        # sequence -> abundance, sorted desc
    quals: np.ndarray              # [n_uniques, maxlen] float64 mean quals
    map: np.ndarray                # [n_reads] int64, 0-based unique index
    name: Optional[str] = None
    # a pool (combine_dereps): each input's uniques' indices into it
    pool_index: Optional[List[np.ndarray]] = field(default=None, repr=False)

    @property
    def sequences(self) -> List[str]:
        return list(self.uniques.keys())

    @property
    def abundances(self) -> np.ndarray:
        return np.fromiter(self.uniques.values(), dtype=np.int64,
                           count=len(self.uniques))

    def __repr__(self):
        tot = int(sum(self.uniques.values()))
        return (f"Derep({len(self.uniques)} unique sequences from "
                f"{tot} reads)")


def _qtables(chunk: FastqChunk, phred_offset: int = 33):
    """Per-chunk dereplication (reference: qtables2, R/sequenceIO.R:150-183).

    Returns (seqs_in_lexical_order, counts, qual_sums, read_map).
    Zero-length reads are excluded with map entry -1 (R uses NA).
    """
    seqs = chunk.seqs
    nread = len(seqs)
    pos_mask = np.array([len(s) > 0 for s in seqs])
    if not pos_mask.any():
        raise ValueError("Only zero-length sequences detected during dereplication.")
    qmat = quals_to_matrix(chunk.quals, phred_offset)
    order_keys = sorted(range(nread), key=lambda i: seqs[i]) if pos_mask.all() \
        else sorted((i for i in range(nread) if pos_mask[i]), key=lambda i: seqs[i])
    # unique sequences in lexical order, counts, and per-unique qual sums
    uniq_seqs: List[bytes] = []
    counts: List[int] = []
    qsums: List[np.ndarray] = []
    read_map = np.full(nread, -1, dtype=np.int64)
    prev = None
    for i in order_keys:
        s = seqs[i]
        if s != prev:
            uniq_seqs.append(s)
            counts.append(0)
            qsums.append(np.zeros(qmat.shape[1]))
            prev = s
        u = len(uniq_seqs) - 1
        counts[u] += 1
        qsums[u] = qsums[u] + qmat[i]
        read_map[i] = u
    return uniq_seqs, np.array(counts, dtype=np.int64), np.vstack(qsums) if qsums else np.zeros((0, 0)), read_map


def derep_fastq(fls, n: int = 1_000_000, verbose: bool = False,
                qualityType: str = "Auto"):
    """Dereplicate fastq file(s) (reference: derepFastq, R/sequenceIO.R:45-124).

    Returns a Derep, or a dict of name -> Derep for multiple files.
    """
    if isinstance(fls, (str, os.PathLike)):
        if os.path.isdir(fls):
            fls = parse_fastq_directory(str(fls))
        else:
            fls = [str(fls)]
    else:
        fls = [str(f) for f in fls]
    from .io.fastq import phred_offset_for

    offset = phred_offset_for(qualityType)
    rval = {}
    for fl in fls:
        # native C++ loader (dada2_tpu_torch/native): same semantics, much
        # faster host path; falls back to the Python implementation
        from .native import derep_fastq_native

        nat = derep_fastq_native(fl, n, offset)
        if nat is not None:
            seqs_n, counts_n, quals_n, map_n = nat
            uniques = {s: int(c) for s, c in zip(seqs_n, counts_n)}
            d = Derep(uniques=uniques, quals=quals_n, map=map_n,
                      name=os.path.basename(fl))
            if verbose:
                print(f"Encountered {len(uniques)} unique sequences from "
                      f"{int(counts_n.sum())} total sequences read.")
            rval[os.path.basename(fl)] = d
            continue
        seq2idx: Dict[bytes, int] = {}
        uniq_seqs: List[bytes] = []
        counts: List[int] = []
        qsum: Optional[np.ndarray] = None
        maps: List[np.ndarray] = []
        for chunk in stream_fastq(fl, n=n):
            cs, cc, cq, cmap = _qtables(chunk, offset)
            if qsum is None:
                uniq_seqs = list(cs)
                counts = cc.tolist()
                qsum = cq
                seq2idx = {s: i for i, s in enumerate(cs)}
                maps.append(cmap)
            else:
                # pad quality matrices to common width with NaN
                if cq.shape[1] > qsum.shape[1]:
                    pad = np.full((qsum.shape[0], cq.shape[1] - qsum.shape[1]), np.nan)
                    qsum = np.hstack([qsum, pad])
                elif cq.shape[1] < qsum.shape[1]:
                    pad = np.full((cq.shape[0], qsum.shape[1] - cq.shape[1]), np.nan)
                    cq = np.hstack([cq, pad])
                new2old = np.empty(len(cs), dtype=np.int64)
                new_rows = []
                for k, s in enumerate(cs):
                    j = seq2idx.get(s)
                    if j is None:
                        j = len(uniq_seqs)
                        seq2idx[s] = j
                        uniq_seqs.append(s)
                        counts.append(int(cc[k]))
                        new_rows.append(cq[k])
                    else:
                        counts[j] += int(cc[k])
                        qsum[j] = qsum[j] + cq[k]
                    new2old[k] = j
                if new_rows:
                    qsum = np.vstack([qsum] + [r[None, : qsum.shape[1]] for r in new_rows])
                m = cmap.copy()
                ok = m >= 0
                m[ok] = new2old[m[ok]]
                maps.append(m)
        counts_arr = np.asarray(counts, dtype=np.int64)
        quals = qsum / counts_arr[:, None]
        # stable sort by decreasing abundance (reference: R/sequenceIO.R:117)
        ord_ = np.argsort(-counts_arr, kind="stable")
        inv = np.empty_like(ord_)
        inv[ord_] = np.arange(len(ord_))
        full_map = np.concatenate(maps) if maps else np.zeros(0, np.int64)
        ok = full_map >= 0
        full_map[ok] = inv[full_map[ok]]
        uniques = {uniq_seqs[i].decode("ascii"): int(counts_arr[i]) for i in ord_}
        d = Derep(uniques=uniques, quals=quals[ord_], map=full_map,
                  name=os.path.basename(fl))
        if verbose:
            print(f"Encountered {len(uniques)} unique sequences from "
                  f"{int(counts_arr.sum())} total sequences read.")
        rval[os.path.basename(fl)] = d
    if len(rval) == 1:
        return next(iter(rval.values()))
    return rval


def combine_dereps(dereps: List[Derep]) -> Derep:
    """Pool dereps for pool=True (reference: combineDereps2,
    R/multiSample.R:165-203): uniques in order of first encounter, then
    stably sorted by decreasing total abundance, abundance-weighted mean
    qualities. The pool's ``pool_index[i]`` gives each unique of
    dereps[i] its index in the pool."""
    maxlen = max(d.quals.shape[1] for d in dereps)
    seq_order: List[str] = []
    seen: Dict[str, int] = {}
    firsts = []
    for d in dereps:
        idx = np.empty(len(d.uniques), np.int64)
        for k, s in enumerate(d.uniques):
            j = seen.get(s)
            if j is None:
                j = seen[s] = len(seq_order)
                seq_order.append(s)
            idx[k] = j
        firsts.append(idx)
    n = len(seq_order)
    counts = np.zeros(n, dtype=np.int64)
    qsum = np.zeros((n, maxlen))
    maps = []
    for d, idx in zip(dereps, firsts):
        ab = d.abundances
        counts[idx] += ab
        q = d.quals
        if q.shape[1] < maxlen:
            q = np.hstack([q, np.full((q.shape[0], maxlen - q.shape[1]), np.nan)])
        qsum[idx] += q * ab[:, None]
        m = d.map.copy()
        ok = m >= 0
        m[ok] = idx[m[ok]]
        maps.append(m)
    quals = qsum / counts[:, None]
    ord_ = np.argsort(-counts, kind="stable")
    inv = np.empty_like(ord_)
    inv[ord_] = np.arange(n)
    full_map = np.concatenate(maps)
    ok = full_map >= 0
    full_map[ok] = inv[full_map[ok]]
    uniques = {seq_order[i]: int(counts[i]) for i in ord_}
    return Derep(uniques=uniques, quals=quals[ord_], map=full_map,
                 name="pooled", pool_index=[inv[idx] for idx in firsts])


def get_derep(obj) -> Derep:
    """Coerce to Derep (reference: getDerep, R/misc.R)."""
    if isinstance(obj, Derep):
        return obj
    if isinstance(obj, (str, os.PathLike)):
        return derep_fastq(obj)
    raise TypeError(f"Cannot coerce {type(obj)} to Derep")


def derep_fasta(fls, **kwargs):
    """Dereplicate fasta file(s) by conversion to temporary fastq with
    constant quality 26 (reference: derepFasta, R/sequenceIO.R:255-269;
    Biostrings::writeXStringSet defaults base qualities to 26)."""
    import tempfile

    from .io.fastq import write_fastq
    from .seqtab import get_sequences

    if isinstance(fls, (str, os.PathLike)):
        fls = [str(fls)]
    fastqs = []
    for fl in fls:
        seqs = get_sequences([str(fl)])
        tmp = tempfile.NamedTemporaryFile(suffix=".fastq", delete=False)
        tmp.close()
        write_fastq(tmp.name, [f"sq{i}" for i in range(len(seqs))], seqs,
                    [chr(26 + 33) * len(s) for s in seqs], compress=False)
        fastqs.append(tmp.name)
    return derep_fastq(fastqs, **kwargs)
