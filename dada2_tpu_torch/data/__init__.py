"""Bundled datasets (mirrors the reference's data/: tperr1, errBalancedF/R,
and the phiX genome that filter.is_phix matches against).

These are empirical 16x41 error-rate matrices shipped with the reference
package (documented in R/errorModels.R:571-605) so that dada() can be run
without first learning error rates.
"""
from __future__ import annotations

import functools
import os

import numpy as np

_HERE = os.path.dirname(__file__)


@functools.lru_cache(maxsize=None)
def _load(name: str) -> np.ndarray:
    from ..utils.rdata import load_rda

    d = load_rda(os.path.join(_HERE, f"{name}.rda"))[name]
    return d["value"] if isinstance(d, dict) else d


def tperr1() -> np.ndarray:
    return _load("tperr1")


def err_balanced_f() -> np.ndarray:
    return _load("errBalancedF")


def err_balanced_r() -> np.ndarray:
    return _load("errBalancedR")



def phix_genome() -> str:
    with open(os.path.join(_HERE, "phix_genome.fa")) as fh:
        lines = [l.strip() for l in fh if not l.startswith(">")]
    return "".join(lines)
