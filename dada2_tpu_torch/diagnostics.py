"""Developer diagnostics and exporters.

reference: src/evaluate.cpp:206-356 (kmer_dist/kord_dist/kmer_matches/
kdist_matches R exports) and R/misc.R:282-324 (checkConvergence, pfasta,
seqtab_to_qiime/mothur, samdf_to_qiime2). A copy of
dada2_tpu/diagnostics.py (host code).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from .encode import pack_sequences, kmer_counts, kmer_ords


def _pairwise_prep(s1: Sequence[str], s2: Sequence[str], k: int):
    if len(s1) != len(s2):
        raise ValueError("Mismatched numbers of sequences.")
    m1, l1 = pack_sequences(list(s1))
    m2, l2 = pack_sequences(list(s2))
    return m1, l1, m2, l2


def kmer_dist(s1: Sequence[str], s2: Sequence[str],
              kmer_size: int = 5) -> np.ndarray:
    """Pairwise k-mer count-vector distances (reference:
    src/evaluate.cpp:206-234)."""
    m1, l1, m2, l2 = _pairwise_prep(s1, s2, kmer_size)
    kv1 = kmer_counts(m1, l1, kmer_size)
    kv2 = kmer_counts(m2, l2, kmer_size)
    dots = np.minimum(kv1, kv2).sum(axis=1)
    return 1.0 - dots / (np.minimum(l1, l2) - kmer_size + 1.0)


def kord_dist(s1: Sequence[str], s2: Sequence[str], kmer_size: int = 5,
              SSE: int = 2) -> np.ndarray:
    """Pairwise ordered-k-mer distances (reference:
    src/evaluate.cpp:237-274). With SSE=0 (scalar semantics) pairs of
    unequal length return -1 (reference: src/kmers.cpp:102-116)."""
    m1, l1, m2, l2 = _pairwise_prep(s1, s2, kmer_size)
    ko1 = kmer_ords(m1, l1, kmer_size)
    ko2 = kmer_ords(m2, l2, kmer_size)
    out = np.empty(len(l1))
    for i in range(len(l1)):
        if SSE < 1 and l1[i] != l2[i]:
            out[i] = -1.0
            continue
        klen = min(l1[i], l2[i]) - kmer_size + 1
        matches = int((ko1[i, :klen] == ko2[i, :klen]).sum())
        out[i] = 1.0 - matches / float(klen)
    return out


def kmer_matches(s1: Sequence[str], s2: Sequence[str],
                 kmer_size: int = 5) -> np.ndarray:
    """Pairwise counts of position-wise equal ordered k-mers (reference:
    src/evaluate.cpp:277-321)."""
    m1, l1, m2, l2 = _pairwise_prep(s1, s2, kmer_size)
    ko1 = kmer_ords(m1, l1, kmer_size)
    ko2 = kmer_ords(m2, l2, kmer_size)
    out = np.empty(len(l1), dtype=np.int64)
    for i in range(len(l1)):
        klen = min(l1[i], l2[i]) - kmer_size + 1
        out[i] = int((ko1[i, :klen] == ko2[i, :klen]).sum())
    return out


def kdist_matches(s1: Sequence[str], s2: Sequence[str],
                  kmer_size: int = 5) -> np.ndarray:
    """Pairwise k-mer count-vector overlap (min-sum) counts (reference:
    src/evaluate.cpp:324-356)."""
    m1, l1, m2, l2 = _pairwise_prep(s1, s2, kmer_size)
    kv1 = kmer_counts(m1, l1, kmer_size)
    kv2 = kmer_counts(m2, l2, kmer_size)
    return np.minimum(kv1, kv2).sum(axis=1).astype(np.int64)


def check_convergence(dada_result) -> np.ndarray:
    """Total absolute change of the error matrix per selfConsist round.

    reference: checkConvergence (R/misc.R:282-284)."""
    err_in = dada_result.err_in
    if not isinstance(err_in, list):
        err_in = [err_in]
    return np.array([np.abs(dada_result.err_out - e).sum() for e in err_in])


def pfasta(seqs, ids: Optional[Sequence] = None) -> str:
    """Format sequences as a fasta string (reference: R/misc.R:286-289)."""
    from .seqtab import get_sequences

    seqs = get_sequences(seqs)
    if ids is None:
        ids = range(1, len(seqs) + 1)
    return "\n".join(f">{i}\n{s}" for i, s in zip(ids, seqs))


def seqtab_to_mothur(st, fout: str) -> None:
    """Write a mothur shared-format table (reference: R/misc.R:309-315)."""
    import pandas as pd

    df = pd.DataFrame({"label": ["DADA2"] * st.shape[0],
                       "Group": list(st.index),
                       "numOtus": [st.shape[1]] * st.shape[0]})
    df = pd.concat([df.reset_index(drop=True),
                    st.reset_index(drop=True)], axis=1)
    df.to_csv(fout, sep=" ", index=False)


def samdf_to_qiime2(df, fout: str) -> None:
    """Write a QIIME2 sample-metadata TSV (reference: R/misc.R:317-324)."""
    out = df.copy()
    out.index.name = "#SampleID"
    out.to_csv(fout, sep="\t")
