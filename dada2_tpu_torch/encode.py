"""Sequence encodings: DNA <-> integer tensors, k-mer vectors.

TPU-first data layout: a set of unique sequences becomes a struct-of-arrays —
a padded ``[n, max_len] uint8`` matrix of nucleotide codes plus a length
vector — instead of the reference's per-Raw C structs (reference:
src/dada.h:64-80, src/containers.cpp:19-43). Nucleotide codes here are
A=0, C=1, G=2, T=3 (the reference uses 1..4 internally, src/misc.cpp:38-99);
PAD=255 marks padding.
"""
from __future__ import annotations

import numpy as np

KMER_SIZE = 5  # reference: src/dada.h:27
N_KMERS = 4**KMER_SIZE  # 1024
GAP_GLYPH = 9999  # reference: src/dada.h:31
PAD = 255

# ASCII byte -> code lookup (A/C/G/T only; everything else maps to PAD)
_NT2CODE = np.full(256, PAD, dtype=np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _NT2CODE[_c] = _i
_CODE2NT = np.full(256, ord("N"), dtype=np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _CODE2NT[_i] = _c

_RC_CODE = np.full(256, PAD, dtype=np.uint8)
_RC_CODE[0], _RC_CODE[1], _RC_CODE[2], _RC_CODE[3] = 3, 2, 1, 0


def seq_to_codes(seq: str | bytes) -> np.ndarray:
    """Encode one DNA string to uint8 codes (A=0..T=3)."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    return _NT2CODE[np.frombuffer(seq, dtype=np.uint8)]


def codes_to_seq(codes: np.ndarray) -> str:
    """Decode uint8 codes back to a DNA string (PAD stripped)."""
    codes = codes[codes != PAD]
    return _CODE2NT[codes].tobytes().decode("ascii")


def _bulk_codes(seqs):
    """Encode a whole list of strings in one pass: (flat uint8 codes,
    [n] int64 lens). One join + one LUT instead of a per-string Python
    loop — the loop serialized multi-sample dada() behind the GIL."""
    n = len(seqs)
    lens = np.fromiter((len(s) for s in seqs), np.int64, count=n)
    if n and isinstance(seqs[0], (bytes, bytearray)):
        joined = b"".join(seqs)
    else:
        joined = "".join(seqs).encode("ascii")
    return _NT2CODE[np.frombuffer(joined, dtype=np.uint8)], lens


def is_acgt(seqs) -> np.ndarray:
    """Vector of bools: whether each sequence is A/C/G/T-only.

    reference: src/evaluate.cpp:184-203 (C_isACGT).
    """
    n = len(seqs)
    flat, lens = _bulk_codes(seqs)
    bad = np.zeros(n + 1, np.int64)
    np.add.at(bad, np.searchsorted(np.cumsum(lens), np.nonzero(
        flat == PAD)[0], side="right"), 1)
    return (lens > 0) & (bad[:n] == 0)


def rc(seq: str) -> str:
    """Reverse complement of a DNA string (reference: R/misc.R:272-280).

    Supports IUPAC ambiguity codes like Biostrings::reverseComplement.
    """
    comp = str.maketrans(
        "ACGTMRWSYKVHDBN" + "acgtmrwsykvhdbn",
        "TGCAKYWSRMBDHVN" + "tgcakywsrmbdhvn",
    )
    return seq.translate(comp)[::-1]


def pack_sequences(seqs, max_len: int | None = None):
    """Pack a list of DNA strings into ([n, L] uint8 codes, [n] int32 lens)."""
    n = len(seqs)
    flat, lens64 = _bulk_codes(seqs)
    lens = lens64.astype(np.int32)
    L = int(max_len if max_len is not None else (lens.max() if n else 0))
    if n and lens64.max() > L:
        raise ValueError("sequence longer than max_len")
    mat = np.full((n, L), PAD, dtype=np.uint8)
    # row-major boolean assignment consumes flat in exactly
    # concatenated-row order
    mat[np.arange(L, dtype=np.int64)[None, :] < lens64[:, None]] = flat
    return mat, lens


def kmer_ords(codes: np.ndarray, lens: np.ndarray, k: int = KMER_SIZE) -> np.ndarray:
    """Ordered k-mer indices per position: [n, L] int32.

    kord[i, p] = index of the k-mer starting at position p of sequence i,
    for p < len_i - k + 1; -1 elsewhere. Mirrors assign_kmer_order
    (reference: src/kmers.cpp:246-279) but batched/vectorized.
    """
    n, L = codes.shape
    vals = codes.astype(np.int64)
    vals = np.where(vals == PAD, 0, vals)
    kord = np.zeros((n, max(L - k + 1, 0)), dtype=np.int64)
    for j in range(k):
        kord = kord * 4 + vals[:, j : j + kord.shape[1]]
    out = np.full((n, L), -1, dtype=np.int32)
    if kord.shape[1]:
        out[:, : kord.shape[1]] = kord.astype(np.int32)
    nk = np.maximum(lens - k + 1, 0)
    mask = np.arange(L)[None, :] >= nk[:, None]
    out[mask] = -1
    return out


def kmer_counts(
    codes: np.ndarray, lens: np.ndarray, k: int = KMER_SIZE, dtype=np.int32,
    kord: np.ndarray | None = None,
) -> np.ndarray:
    """k-mer count vectors: [n, 4^k].

    Mirrors assign_kmer (reference: src/kmers.cpp:207-243) batched. Counts are
    exact (no uint8 saturation): the reference's 8-bit path falls back to
    16-bit on any overflow, so exact counts reproduce its results
    (src/kmers.cpp:58-93 + src/nwalign_endsfree.cpp:23-26).
    """
    n, L = codes.shape
    kord = kord if kord is not None else kmer_ords(codes, lens, k)
    nk = 4**k
    rows = np.repeat(np.arange(n, dtype=np.int64), L)
    flat = kord.ravel().astype(np.int64)
    valid = flat >= 0
    # one flat bincount (np.add.at is an order of magnitude slower)
    counts = np.bincount(rows[valid] * nk + flat[valid],
                         minlength=n * nk)
    return counts.reshape(n, nk).astype(dtype)
