"""Paired-read merging and pairwise alignment utilities.

reference: R/paired.R (mergePairs), R/misc.R:179-225 (nwalign/nwhamming),
src/evaluate.cpp (C_eval_pair, C_pair_consensus).

A copy of dada2_tpu/paired.py. nwalign and its helpers run on the host
oracle (ops/nw_ref.py), as in dada2_tpu; merge_pairs aligns every unique
(forward ASV, reverse ASV) pairing at once with kernel B4
(ops/nw_batch.py), on the CUDA card unless given device="cpu".
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import pandas as pd

from .encode import pack_sequences, rc, seq_to_codes
from .options import current_options
from .ops.nw_ref import GAP, nw_align_ref

_NT = "ACGT"


def _codes_to_al_str(al: np.ndarray) -> str:
    out = []
    for c in al:
        out.append("-" if c == GAP else _NT[c])
    return "".join(out)


def nwalign(s1: str, s2: str, match: int = None, mismatch: int = None,
            gap: int = None, homo_gap: Optional[int] = None, band: int = -1,
            endsfree: bool = True, vec: bool = False):
    """Needleman-Wunsch alignment of two sequences; returns the two aligned
    strings (reference: nwalign, R/misc.R:179-191)."""
    match = current_options().MATCH if match is None else match
    mismatch = current_options().MISMATCH if mismatch is None else mismatch
    gap = current_options().GAP_PENALTY if gap is None else gap
    c1, c2 = seq_to_codes(s1), seq_to_codes(s2)
    if vec:
        if homo_gap is not None and homo_gap != gap:
            raise ValueError("Homopolymer gap penalties are not implemented "
                             "in the vectorized aligner.")
        end_gap = 0 if endsfree else gap
        al = nw_align_ref(c1, c2, match, mismatch, gap, end_gap, band, mode="vec")
    else:
        end_gap = 0 if endsfree else gap
        hg = homo_gap if (endsfree and homo_gap is not None) else None
        al = nw_align_ref(c1, c2, match, mismatch, gap, end_gap, band,
                          mode="scalar", homo_gap_p=hg)
    return _codes_to_al_str(al[0]), _codes_to_al_str(al[1])


def eval_pair(a1: str, a2: str):
    """Match/mismatch/internal-indel counts of an alignment, ignoring end
    gaps (reference: C_eval_pair, src/evaluate.cpp:73-113)."""
    if len(a1) != len(a2):
        raise ValueError("Aligned strings are not the same length.")
    n = len(a1)
    s1gap = s2gap = True
    start = -1
    while (s1gap or s2gap) and start < n - 1:
        start += 1
        s1gap = s1gap and a1[start] == "-"
        s2gap = s2gap and a2[start] == "-"
    s1gap = s2gap = True
    end = n
    while (s1gap or s2gap) and end > start:
        end -= 1
        s1gap = s1gap and a1[end] == "-"
        s2gap = s2gap and a2[end] == "-"
    match = mismatch = indel = 0
    for i in range(start, end + 1):
        if a1[i] == "-" or a2[i] == "-":
            indel += 1
        elif a1[i] == a2[i]:
            match += 1
        else:
            mismatch += 1
    return match, mismatch, indel


def nwhamming(s1: str, s2: str, **kwargs) -> int:
    """Mismatches + internal indels after NW alignment (R/misc.R:216-219)."""
    a1, a2 = nwalign(s1, s2, **kwargs)
    _, mm, ind = eval_pair(a1, a2)
    return mm + ind


def pair_consensus(a1: str, a2: str, prefer: int, trim_overhang: bool = False) -> str:
    """Merge an aligned pair into a consensus sequence.

    reference: C_pair_consensus, src/evaluate.cpp:124-174. Gaps are filled
    from the other read; mismatches go to the preferred read (1 or 2);
    remaining gaps are stripped.
    """
    if len(a1) != len(a2):
        raise ValueError("Aligned strings are not the same length.")
    out = []
    for c1, c2 in zip(a1, a2):
        if c1 == c2:
            out.append(c1)
        elif c2 == "-":
            out.append(c1)
        elif c1 == "-":
            out.append(c2)
        else:
            out.append(c1 if prefer == 1 else c2)
    if trim_overhang:
        for i in range(len(a1)):
            if a1[i] != "-":
                break
            out[i] = "-"
        for i in range(len(a1) - 1, -1, -1):
            if a2[i] != "-":
                break
            out[i] = "-"
    return "".join(c for c in out if c != "-")


def merge_pairs(
    dadaF, derepF, dadaR, derepR,
    minOverlap: int = 12, maxMismatch: int = 0, returnRejects: bool = False,
    propagateCol: Sequence[str] = (), justConcatenate: bool = False,
    trimOverhang: bool = False, verbose: bool = False, device=None,
) -> Union[pd.DataFrame, Dict[str, pd.DataFrame]]:
    """Merge denoised forward and reverse reads (reference: mergePairs,
    R/paired.R:92-231). device: where kernel B4 aligns (None = the CUDA
    card, "cpu" = its plain version)."""
    from .dada import DadaResult
    from .derep import Derep, get_derep

    single = isinstance(dadaF, DadaResult)
    dadaFs = [dadaF] if single else list(
        dadaF.values() if isinstance(dadaF, dict) else dadaF)
    dadaRs = [dadaR] if isinstance(dadaR, DadaResult) else list(
        dadaR.values() if isinstance(dadaR, dict) else dadaR)

    def _dereps(d):
        if isinstance(d, (Derep, str)):
            return [get_derep(d)]
        if isinstance(d, dict):
            return [get_derep(x) for x in d.values()]
        return [get_derep(x) for x in d]

    derepFs, derepRs = _dereps(derepF), _dereps(derepR)
    ns = {len(dadaFs), len(derepFs), len(dadaRs), len(derepRs)}
    if len(ns) > 1:
        raise ValueError("dadaF/derepF/dadaR/derepR must be the same length.")

    rvals = []
    for ddF, drF, ddR, drR in zip(dadaFs, derepFs, dadaRs, derepRs):
        rvals.append(_merge_one(ddF, drF, ddR, drR, minOverlap, maxMismatch,
                                returnRejects, propagateCol, justConcatenate,
                                trimOverhang, verbose, device))
    if len(rvals) == 1 and single:
        return rvals[0]
    names = [d.name or str(i) for i, d in enumerate(dadaFs)]
    return dict(zip(names, rvals))


def _merge_one(dadaF, derepF, dadaR, derepR, minOverlap, maxMismatch,
               returnRejects, propagateCol, justConcatenate, trimOverhang,
               verbose, device=None) -> pd.DataFrame:
    mapF = derepF.map  # read -> unique (0-based, -1 NA)
    mapR = derepR.map
    # read -> ASV composition; -1 propagates as NA
    rF = np.where(mapF >= 0, dadaF.map[np.maximum(mapF, 0)], -1)
    rR = np.where(mapR >= 0, dadaR.map[np.maximum(mapR, 0)], -1)

    # unique (F, R) pairs in first-encounter order (like
    # unique(data.frame)), vectorized — the read axis can be hundreds of
    # thousands long while distinct ASV pairs number in the hundreds
    counts: Dict[tuple, int] = {}
    if len(rF):
        span = int(rR.max()) + 2 if len(rR) else 1
        key = (rF.astype(np.int64) + 1) * span + (rR.astype(np.int64) + 1)
        uniq, first, cnt = np.unique(key, return_index=True,
                                     return_counts=True)
        pairs = []
        for k in np.argsort(first, kind="stable"):
            f = int(uniq[k] // span) - 1
            r = int(uniq[k] % span) - 1
            pairs.append((f, r))
            if f >= 0 and r >= 0:
                counts[(f, r)] = int(cnt[k])
    else:
        pairs = []
    ups = [p for p in pairs if p[0] >= 0 and p[1] >= 0]
    cols = ["sequence", "abundance", "forward", "reverse",
            "nmatch", "nmismatch", "nindel", "prefer", "accept"]
    if not ups:
        return pd.DataFrame({c: [] for c in cols})

    Fseqs = list(dadaF.clustering["sequence"])
    Rseqs = list(dadaR.clustering["sequence"])
    n0F = dadaF.clustering["n0"].to_numpy()
    n0R = dadaR.clustering["n0"].to_numpy()

    # batched unbanded scalar NW with merge-specific scoring
    # (reference: R/paired.R:152-159; kernel B4 replaces the per-pair
    # C_nwalign .Call)
    als = {}
    if not justConcatenate and ups:
        from .core.backend_cuda import resolve_device
        from .ops.nw_batch import nw_batch, steps_to_alignment

        fs = [Fseqs[f] for f, r in ups]
        rs = [rc(Rseqs[r]) for f, r in ups]
        m1, l1 = pack_sequences(fs)
        m2, l2 = pack_sequences(rs)
        sc = (1, -64, -64) if maxMismatch == 0 else (1, -8, -8)
        out = nw_batch(m1, l1, m2, l2, match=sc[0], mismatch=sc[1],
                       gap_p=sc[2], end_gap_p=0, band=-1, mode="scalar",
                       device=resolve_device(device))
        kinds, p0, p1, ok = (x.cpu().numpy() for x in
                             (out[0], out[1], out[2], out[5]))
        if not ok.all():
            raise RuntimeError("N-W Align out of range.")
        for k, (f, r) in enumerate(ups):
            a0, a1_ = steps_to_alignment(kinds[k], p0[k], p1[k],
                                         m1[k][: l1[k]], m2[k][: l2[k]])
            als[(f, r)] = (_codes_to_al_str(a0), _codes_to_al_str(a1_))

    rows = []
    for f, r in ups:
        fseq = Fseqs[f]
        rseq = rc(Rseqs[r])
        if justConcatenate:
            seq = fseq + "N" * 10 + rseq
            rows.append([seq, counts[(f, r)], f, r, 0, 0, 0, np.nan, True])
            continue
        a1, a2 = als[(f, r)]
        nmatch, nmismatch, nindel = eval_pair(a1, a2)
        prefer = 1 + int(n0R[r] > n0F[f])
        accept = nmatch >= minOverlap and (nmismatch + nindel) <= maxMismatch
        seq = pair_consensus(a1, a2, prefer, trimOverhang)
        if not accept:
            seq = ""
        rows.append([seq, counts[(f, r)], f, r,
                     nmatch, nmismatch, nindel, prefer, accept])

    df = pd.DataFrame(rows, columns=cols)
    for col in propagateCol:
        if col in dadaF.clustering.columns:
            df["F." + col] = dadaF.clustering[col].to_numpy()[df["forward"]]
            df["R." + col] = dadaR.clustering[col].to_numpy()[df["reverse"]]
    # stable sort by decreasing abundance (R/paired.R:180)
    df = df.sort_values("abundance", ascending=False, kind="stable",
                        ignore_index=True)
    if verbose:
        acc = df["accept"].to_numpy(dtype=bool)
        print(f"{int(df['abundance'][acc].sum())} paired-reads (in "
              f"{int(acc.sum())} unique pairings) successfully merged out "
              f"of {int(df['abundance'].sum())} (in {len(df)} pairings) input.")
    if not returnRejects:
        df = df[df["accept"].astype(bool)].reset_index(drop=True)
    return df


def nweval(s1: str, s2: str, **kwargs):
    """(match, mismatch, indel) of the NW alignment of two sequences
    (reference: nweval, R/misc.R:222-225)."""
    a1, a2 = nwalign(s1, s2, **kwargs)
    return eval_pair(a1, a2)


def nwextract(query: str, ref: str, **kwargs) -> str:
    """Extract the aligned region of ref corresponding to query
    (reference: nwextract, R/misc.R:227-233)."""
    a1, a2 = nwalign(query, ref, **kwargs)
    nt = [i for i, c in enumerate(a1) if c in "ACGT"]
    return a2[min(nt): max(nt) + 1] if nt else ""
