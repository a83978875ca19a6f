"""Sequence tables: the samples x ASV-sequences abundance matrix.

reference: R/multiSample.R. A copy of dada2_tpu/seqtab.py (host code);
collapse_no_mismatch aligns through kernel B4 (ops/nw_batch.py).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import pandas as pd

from .encode import rc


def get_uniques(obj) -> Dict[str, int]:
    """Coerce to a uniques dict sequence->abundance (reference: R/misc.R:33-62)."""
    from .dada import DadaResult
    from .derep import Derep

    if isinstance(obj, DadaResult):
        return dict(obj.denoised)
    if isinstance(obj, Derep):
        return dict(obj.uniques)
    if isinstance(obj, pd.DataFrame) and {"sequence", "abundance"} <= set(obj.columns):
        return {s: int(a) for s, a in zip(obj["sequence"], obj["abundance"])}
    if isinstance(obj, dict):
        out = {str(k): int(v) for k, v in obj.items()}
        if len(out) != len(obj):
            raise ValueError("Duplicated sequences in uniques.")
        return out
    if isinstance(obj, pd.Series):
        return {str(k): int(v) for k, v in obj.items()}
    raise TypeError(f"Unable to extract uniques from {type(obj)}")


def get_sequences(obj, collapse: bool = False) -> List[str]:
    """Coerce to a list of DNA sequence strings (reference: getSequences,
    R/misc.R:101-128). Accepts lists of strings, fasta/fastq file paths,
    uniques-coercible objects, and sequence tables."""
    import os

    if isinstance(obj, str):
        obj = [obj]
    if isinstance(obj, np.ndarray) and obj.dtype.kind in "US":
        obj = [str(s) for s in obj]
    if isinstance(obj, (list, tuple)) and all(isinstance(s, str)
                                              for s in obj):
        if len(obj) == 1 and os.path.exists(obj[0]):
            seqs = _read_seq_file(obj[0])
            return [s.upper() for s in seqs]
        if collapse:
            seen = {}
            for s in obj:
                seen.setdefault(s, None)
            obj = list(seen)
        return [s.upper() for s in obj]
    return [s.upper() for s in get_uniques(obj)]


def _read_seq_file(path: str) -> List[str]:
    """Sequences from a fasta or fastq file (possibly gzipped)."""
    import gzip

    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rt") as f:
        first = f.read(1)
    if first == ">":
        seqs = []
        with op(path, "rt") as f:
            cur = []
            for line in f:
                line = line.strip()
                if line.startswith(">"):
                    if cur:
                        seqs.append("".join(cur))
                    cur = []
                elif line:
                    cur.append(line)
            if cur:
                seqs.append("".join(cur))
        return seqs
    from .io.fastq import read_fastq

    return [s.decode("ascii") for s in read_fastq(path).seqs]


def make_sequence_table(samples, orderBy: Optional[str] = "abundance") -> pd.DataFrame:
    """Samples x sequences integer matrix (reference: R/multiSample.R:31-55).

    Columns ordered by decreasing total abundance (stable: ties keep
    first-encounter order), like the reference.
    """
    if not isinstance(samples, (list, dict)):
        samples = [samples]
    if isinstance(samples, dict):
        names = list(samples.keys())
        unqs = [get_uniques(v) for v in samples.values()]
    else:
        names = []
        unqs = [get_uniques(v) for v in samples]
        for i, v in enumerate(samples):
            nm = getattr(v, "name", None)
            names.append(nm if nm else str(i))
    cols: List[str] = []
    seen = set()
    for u in unqs:
        for s in u:
            if s not in seen:
                seen.add(s)
                cols.append(s)
    mat = np.zeros((len(unqs), len(cols)), dtype=np.int64)
    cidx = {s: j for j, s in enumerate(cols)}
    for i, u in enumerate(unqs):
        for s, a in u.items():
            mat[i, cidx[s]] = a
    st = pd.DataFrame(mat, index=names, columns=cols)
    return _order_columns(st, orderBy)


def _order_columns(st: pd.DataFrame, orderBy: Optional[str]) -> pd.DataFrame:
    if orderBy == "abundance":
        key = -st.values.sum(axis=0)
    elif orderBy == "nsamples":
        key = -(st.values > 0).sum(axis=0)
    elif orderBy is None:
        return st
    else:
        raise ValueError(f"Invalid orderBy {orderBy!r}")
    order = np.argsort(key, kind="stable")
    return st.iloc[:, order]


def collapse_no_mismatch(seqtab: pd.DataFrame, minOverlap: int = 20,
                         orderBy: str = "abundance", identicalOnly: bool = False,
                         vec: bool = True, band: int = -1,
                         verbose: bool = False, device=None) -> pd.DataFrame:
    """Greedily collapse sequences identical up to shifts/length.

    reference: collapseNoMismatch, R/multiSample.R:104-160. Every
    prefix-screened candidate pair is aligned up front by kernel B4
    (ops/nw_batch.py); device: None = the CUDA card, "cpu" = its plain
    version.
    """
    # collapse identical duplicates first
    if seqtab.columns.duplicated().any():
        seqtab = seqtab.T.groupby(level=0, sort=False).sum().T
    if identicalOnly:
        return seqtab

    totals = seqtab.values.sum(axis=0)
    order = np.argsort(-totals, kind="stable")
    seqs = [seqtab.columns[i] for i in order]

    # batch-align every prefix-screened candidate pair up front (one
    # device sweep instead of one Python DP per pair); the greedy loop
    # below then only consults precomputed hamming distances
    cand_pairs = []
    for qi in range(1, len(seqs)):
        qprefix = seqs[qi][:minOverlap]
        for ri in range(qi):
            rprefix = seqs[ri][:minOverlap]
            if qprefix in seqs[ri] or rprefix in seqs[qi]:
                cand_pairs.append((qi, ri))
    ham = {}
    if cand_pairs:
        from .core.backend_cuda import resolve_device
        from .encode import pack_sequences
        from .ops.nw_batch import nw_batch, steps_to_alignment
        from .options import current_options
        from .paired import _codes_to_al_str, eval_pair

        mat, lens = pack_sequences(seqs)
        qidx = np.array([p[0] for p in cand_pairs], np.int64)
        ridx = np.array([p[1] for p in cand_pairs], np.int64)
        o = current_options()
        out = nw_batch(mat[qidx], lens[qidx], mat[ridx], lens[ridx],
                       match=o.MATCH, mismatch=o.MISMATCH,
                       gap_p=o.GAP_PENALTY, end_gap_p=0, band=band,
                       mode="vec" if vec else "scalar",
                       device=resolve_device(device))
        kinds, p0s, p1s = (x.cpu().numpy() for x in out[:3])
        for k, pr in enumerate(cand_pairs):
            a0, a1 = steps_to_alignment(kinds[k], p0s[k], p1s[k],
                                        mat[qidx[k]][: lens[qidx[k]]],
                                        mat[ridx[k]][: lens[ridx[k]]])
            _, mm, ind = eval_pair(_codes_to_al_str(a0),
                                   _codes_to_al_str(a1))
            ham[pr] = mm + ind

    seqs_out: List[str] = []
    out_idx: List[int] = []
    collapsed = pd.DataFrame(
        np.zeros_like(seqtab.values), index=seqtab.index, columns=seqtab.columns)
    for qi, query in enumerate(seqs):
        added = False
        for ri in out_idx:
            if (qi, ri) in ham and ham[(qi, ri)] == 0:
                collapsed[seqs[ri]] = collapsed[seqs[ri]] + seqtab[query]
                added = True
                break
        if not added:
            collapsed[query] = seqtab[query]
            seqs_out.append(query)
            out_idx.append(qi)
    collapsed = collapsed.loc[:, collapsed.columns.isin(seqs_out)]
    collapsed = _order_columns(collapsed, orderBy)
    collapsed = _order_columns(collapsed, "abundance")
    if verbose:
        print(f"Output {collapsed.shape[1]} collapsed sequences out of "
              f"{seqtab.shape[1]} input sequences.")
    return collapsed


def merge_sequence_tables(*tables, repeats: str = "error",
                          orderBy: str = "abundance",
                          tryRC: bool = False) -> pd.DataFrame:
    """Union-merge sequence tables (reference: mergeSequenceTables,
    R/multiSample.R:290-364)."""
    tabs = [t for t in tables]
    if len(tabs) == 1 and isinstance(tabs[0], (list, tuple)):
        tabs = list(tabs[0])
    sample_names = [n for t in tabs for n in t.index]
    if len(set(sample_names)) < len(sample_names):
        if repeats == "error":
            raise ValueError(
                "Duplicated sample names detected in the rownames (use "
                "repeats='sum' to sum them).")
        elif repeats != "sum":
            raise ValueError("Invalid repeats argument.")
    if tryRC and len(tabs) > 1:
        ref_cols = set(tabs[0].columns)
        fixed = [tabs[0]]
        for t in tabs[1:]:
            newcols = [rc(c) if (c not in ref_cols and rc(c) in ref_cols) else c
                       for c in t.columns]
            t = t.copy()
            t.columns = newcols
            fixed.append(t)
        tabs = fixed
    merged = pd.concat(tabs, axis=0).fillna(0).astype(np.int64)
    if repeats == "sum":
        merged = merged.groupby(level=0, sort=False).sum()
    return _order_columns(merged, orderBy)


def seqtab_to_qiime(st: pd.DataFrame, fout: str) -> None:
    """Export in QIIME's legacy tab-separated format (R/misc.R:300-311)."""
    with open(fout, "w") as fh:
        fh.write("# Constructed from biom file\n")
        fh.write("#OTU ID\t" + "\t".join(st.index) + "\n")
        for j, seq in enumerate(st.columns):
            vals = "\t".join(str(int(v)) for v in st.values[:, j])
            fh.write(f"{seq}\t{vals}\n")


def uniques_to_fasta(unqs, fout: str, ids=None) -> None:
    """Write a uniques vector as fasta with uchime-style ids
    (reference: uniquesToFasta, R/sequenceIO.R:226-237)."""
    unqs = get_uniques(unqs)
    with open(fout, "w") as fh:
        for i, (s, a) in enumerate(unqs.items()):
            name = ids[i] if ids is not None else f"sq{i + 1};size={a};"
            fh.write(f">{name}\n{s}\n")
