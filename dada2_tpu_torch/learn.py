"""Error-rate learning from fastq files (the self-consistency loop driver).

reference: learnErrors (R/errorModels.R:333-363). Streams samples until the
base budget is reached, then runs dada in selfConsist mode with OMEGA_C=0
and extracts the converged error matrix.
"""
from __future__ import annotations

import os
from typing import Callable, List, Optional, Sequence, Union

import numpy as np

from .derep import Derep, derep_fastq
from .errors import get_errors, loess_errfun
from .io.fastq import parse_fastq_directory


def learn_errors(fls, nbases: float = 1e8,
                 errorEstimationFunction: Callable = loess_errfun,
                 multithread: bool = False, randomize: bool = False,
                 MAX_CONSIST: int = 10, OMEGA_C: float = 0.0,
                 qualityType: str = "Auto", verbose: Union[bool, int] = False,
                 seed: int = 100, **dada_kwargs) -> dict:
    """Learn the 16xQ error-rate matrix from (a subset of) the data.

    Returns {"err_out": ..., "err_in": ..., "trans": ...}.
    """
    from .dada import dada

    if isinstance(fls, Derep):
        fls = [fls]
    if isinstance(fls, (str, os.PathLike)):
        fls = parse_fastq_directory(str(fls)) if os.path.isdir(str(fls)) \
            else [str(fls)]
    fls = list(fls)
    if randomize:
        rng = np.random.default_rng(seed)
        fls = [fls[i] for i in rng.permutation(len(fls))]

    nb = 0
    nr = 0
    drps: List[Derep] = []
    for fl in fls:
        drp = fl if isinstance(fl, Derep) else derep_fastq(
            fl, qualityType=qualityType)
        drps.append(drp)
        ab = drp.abundances
        nr += int(ab.sum())
        nb += int(sum(a * len(s) for s, a in drp.uniques.items()))
        if nb > nbases:
            break
    if verbose is True or (not isinstance(verbose, bool) and verbose > 0) \
            or verbose == 1:
        print(f"{nb} total bases in {nr} reads from {len(drps)} samples "
              f"will be used for learning the error rates.")

    dds = dada(drps, err=None,
               errorEstimationFunction=errorEstimationFunction,
               selfConsist=True, multithread=multithread, verbose=verbose,
               MAX_CONSIST=MAX_CONSIST, OMEGA_C=OMEGA_C, **dada_kwargs)
    if isinstance(dds, dict):
        dds = list(dds.values())
    return get_errors(dds, detailed=True)
