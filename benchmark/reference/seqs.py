"""Sequence sets for the plain reference: codes, k-mer tables and the
struct-of-arrays RawSet the engine walks (DADA2 src/dada.h:42-80,
src/containers.cpp:19-43, src/kmers.cpp:207-279). Codes are A=0, C=1,
G=2, T=3 and PAD=255.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

KMER_SIZE = 5      # DADA2 src/dada.h:27
GAP_GLYPH = 9999   # DADA2 src/dada.h:31
PAD = 255

_NT2CODE = np.full(256, PAD, dtype=np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _NT2CODE[_c] = _i
_CODE2NT = np.full(256, ord("N"), dtype=np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _CODE2NT[_i] = _c


def codes_to_seq(codes: np.ndarray) -> str:
    codes = codes[codes != PAD]
    return _CODE2NT[codes].tobytes().decode("ascii")


def pack_sequences(seqs):
    """([n, L] uint8 codes padded with PAD, [n] int32 lengths)."""
    lens = np.fromiter((len(s) for s in seqs), np.int64, count=len(seqs))
    flat = _NT2CODE[np.frombuffer("".join(seqs).encode("ascii"), np.uint8)]
    L = int(lens.max()) if len(seqs) else 0
    mat = np.full((len(seqs), L), PAD, dtype=np.uint8)
    mat[np.arange(L)[None, :] < lens[:, None]] = flat
    return mat, lens.astype(np.int32)


def kmer_ords(codes: np.ndarray, lens: np.ndarray,
              k: int = KMER_SIZE) -> np.ndarray:
    """[n, L] int32 index of the k-mer starting at each position, -1 past
    len - k + 1 (DADA2 assign_kmer_order)."""
    n, L = codes.shape
    vals = np.where(codes == PAD, 0, codes).astype(np.int64)
    kord = np.zeros((n, max(L - k + 1, 0)), dtype=np.int64)
    for j in range(k):
        kord = kord * 4 + vals[:, j:j + kord.shape[1]]
    out = np.full((n, L), -1, dtype=np.int32)
    out[:, :kord.shape[1]] = kord
    out[np.arange(L)[None, :] >= np.maximum(lens - k + 1, 0)[:, None]] = -1
    return out


def kmer_counts(kord: np.ndarray, k: int = KMER_SIZE) -> np.ndarray:
    """[n, 4^k] exact k-mer counts (DADA2 assign_kmer; its 8-bit path
    falls back to 16 bits on overflow, so exact counts are its result)."""
    n, L = kord.shape
    rows = np.repeat(np.arange(n, dtype=np.int64), L)
    flat = kord.ravel().astype(np.int64)
    ok = flat >= 0
    counts = np.bincount(rows[ok] * 4 ** k + flat[ok], minlength=n * 4 ** k)
    return counts.reshape(n, 4 ** k).astype(np.int16)


@dataclass
class RawSet:
    seqs: np.ndarray              # [n, L] uint8
    lens: np.ndarray              # [n] int32
    reads: np.ndarray             # [n] int64
    priors: np.ndarray            # [n] bool
    quals: np.ndarray             # [n, L] uint8 rounded mean qualities

    @property
    def n(self) -> int:
        return len(self.lens)

    @property
    def max_len(self) -> int:
        return self.seqs.shape[1]


def make_rawset(sequences, abundances, quals) -> RawSet:
    """DADA2 src/Rmain.cpp:102-163: mean qualities rounded half away from
    zero to uint8 (raw_new, src/containers.cpp:30-37), NaN and padding
    read as 0."""
    seqs, lens = pack_sequences(sequences)
    q = np.asarray(quals, dtype=np.float64)[:, :seqs.shape[1]]
    q8 = (np.where(np.isnan(q), -0.5, q) + 0.5).astype(np.uint8)
    q8[np.arange(seqs.shape[1])[None, :] >= lens[:, None]] = 0
    return RawSet(seqs=seqs, lens=lens,
                  reads=np.asarray(abundances, dtype=np.int64),
                  priors=np.zeros(len(sequences), dtype=bool), quals=q8)
