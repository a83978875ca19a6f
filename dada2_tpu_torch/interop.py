"""Carrying engine state across from the JAX package.

DADA2 has no weights: its state is the RawSet (seqs, lens, reads, priors,
quals), the 16 x Q error matrix and the options. dada2_tpu holds all of
them as plain numpy arrays and a dataclass; `state_from_numpy` builds the
port's counterparts from those arrays and the options as a dict
(``dataclasses.asdict`` of dada2_tpu's DadaOptions), so tests can feed
both packages identical state without this package importing the other.
The taxonomy classifier's state, the lgk table, needs no function here:
both packages build it on the host from the same fasta, and
taxonomy.device_lgk takes dada2_tpu's numpy table as it is.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .core.raws import RawSet
from .options import DadaOptions


def state_from_numpy(seqs: np.ndarray, lens: np.ndarray, reads: np.ndarray,
                     priors: np.ndarray, quals: Optional[np.ndarray],
                     err: np.ndarray, opts: dict
                     ) -> Tuple[RawSet, np.ndarray, DadaOptions]:
    """(RawSet, err float64 [16, Q], DadaOptions) from plain arrays:
    seqs uint8 [n, L] (A=0..T=3, PAD=255), lens, reads, priors, quals
    uint8 [n, L] or None, err [16, Q] and an option dict whose keys are
    DadaOptions field names."""
    seqs = np.ascontiguousarray(seqs, np.uint8)
    n = seqs.shape[0]
    arrays = {"lens": lens, "reads": reads, "priors": priors}
    for name, a in arrays.items():
        if np.shape(a) != (n,):
            raise ValueError(f"{name} must have shape ({n},)")
    if quals is not None and np.shape(quals) != seqs.shape:
        raise ValueError("quals must have the shape of seqs")
    err = np.array(err, dtype=np.float64)
    if err.ndim != 2 or err.shape[0] != 16:
        raise ValueError("the error matrix must have 16 rows")
    rs = RawSet(seqs=seqs, lens=np.asarray(lens, np.int32),
                reads=np.asarray(reads, np.int64),
                priors=np.asarray(priors, bool),
                quals=(None if quals is None
                       else np.ascontiguousarray(quals, np.uint8)))
    return rs, err, DadaOptions().replace(**dict(opts))
