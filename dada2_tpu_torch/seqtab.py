"""Sequence tables: the samples x ASV-sequences abundance matrix.

reference: R/multiSample.R. A copy of dada2_tpu/seqtab.py (host code);
collapse_no_mismatch waits for the scalar aligner (ROADMAP A5).
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
                         verbose: bool = False) -> pd.DataFrame:
    """Greedily collapse sequences identical up to shifts/length.

    reference: collapseNoMismatch, R/multiSample.R:104-160. Not ported yet:
    it aligns with the unbanded scalar aligner (dada2_tpu/ops/nw_batch.py),
    which the port does not have (ROADMAP A5)."""
    raise NotImplementedError(
        "collapse_no_mismatch needs the scalar/unbanded aligner, which is "
        "not ported yet (ROADMAP A5)")


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
