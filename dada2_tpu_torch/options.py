"""Algorithm options for the dada2-tpu engine.

Mirrors the reference R package's session-global option environment
(reference: R/dada.R:1-27) as a typed, immutable dataclass. Every option can
be overridden per-call by passing keyword arguments to the public API
functions (reference: R/dada.R:155-163).

Note the reference's documentation/default mismatch for MATCH/MISMATCH
(docs say 4/-5, code says 5/-4; R/dada.R:11-12 vs :525-527) — we follow the
code, as the survey directs.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class DadaOptions:
    """All algorithm knobs, with defaults identical to the reference.

    reference: R/dada.R:1-27 (defaults), R/dada.R:502-603 (docs).
    """

    # Sensitivity (reference: R/dada.R:2-5)
    OMEGA_A: float = 1e-40
    OMEGA_P: float = 1e-4
    OMEGA_C: float = 1e-40
    DETECT_SINGLETONS: bool = False

    # Sequence comparison heuristics (reference: R/dada.R:6-7,23-24)
    USE_KMERS: bool = True
    KDIST_CUTOFF: float = 0.42
    GAPLESS: bool = True
    GREEDY: bool = True

    # Self-consistency (reference: R/dada.R:8)
    MAX_CONSIST: int = 10

    # Alignment (reference: R/dada.R:11-15,21)
    MATCH: int = 5
    MISMATCH: int = -4
    GAP_PENALTY: int = -8
    BAND_SIZE: int = 16
    VECTORIZED_ALIGNMENT: bool = True
    HOMOPOLYMER_GAP_PENALTY: Optional[int] = None

    # New partition conditions (reference: R/dada.R:16-19)
    MAX_CLUST: int = 0
    MIN_FOLD: float = 1.0
    MIN_HAMMING: int = 1
    MIN_ABUNDANCE: int = 1

    # Error model (reference: R/dada.R:20)
    USE_QUALS: bool = True

    # Technical. SSE selects among numerically-identical kmer kernels in the
    # reference (R/dada.R:22,596-603); kept for API compatibility. On TPU all
    # levels map to the same exact integer min-sum kernel, except SSE=0 which
    # reproduces the scalar kord_dist behavior of returning -1 (gapless screen
    # disabled) for different-length pairs (reference: src/kmers.cpp:102-116
    # vs :121-150).
    SSE: int = 2

    # Pseudo-pooling (reference: R/dada.R:25-26)
    PSEUDO_PREVALENCE: int = 2
    PSEUDO_ABUNDANCE: float = math.inf

    def replace(self, **kwargs) -> "DadaOptions":
        valid = {f.name for f in dataclasses.fields(self)}
        bad = set(kwargs) - valid
        if bad:
            raise ValueError(f"Not valid DADA option(s): {sorted(bad)}")
        return dataclasses.replace(self, **kwargs)

    def normalized(self) -> "DadaOptions":
        """Apply the reference's per-call normalizations.

        reference: R/dada.R:222-237 — gap penalties forced negative,
        homopolymer-gap default, vectorized-alignment disabled for
        homopolymer gaps or BAND_SIZE == 0.
        """
        opts = self
        gap = opts.GAP_PENALTY
        if gap > 0:
            gap = -gap
        homo = opts.HOMOPOLYMER_GAP_PENALTY
        if homo is None:
            homo = gap
        if homo > 0:
            homo = -homo
        vec = opts.VECTORIZED_ALIGNMENT
        if homo != gap:
            vec = False  # no homopolymer gapping in the vectorized aligner
        if opts.BAND_SIZE == 0:
            vec = False
        return opts.replace(
            GAP_PENALTY=gap, HOMOPOLYMER_GAP_PENALTY=homo, VECTORIZED_ALIGNMENT=vec
        )

    def validate(self) -> None:
        """Mirrors validation in reference: R/dada.R:207-212."""
        if not (0 <= self.OMEGA_A < 1):
            raise ValueError("OMEGA_A must be between zero and one.")
        if not (0 <= self.OMEGA_P < 1):
            raise ValueError("OMEGA_P must be between zero and one.")


DEFAULT_OPTIONS = DadaOptions()

# session-global options (reference: the dada_opts environment,
# R/dada.R:1-27). setDadaOpt mutates this; every public entry point reads
# it via current_options() and still accepts per-call overrides.
_SESSION_OPTIONS = DEFAULT_OPTIONS


def current_options() -> DadaOptions:
    return _SESSION_OPTIONS


def set_dada_opt(**kwargs) -> None:
    """Set session-wide DADA options (reference: setDadaOpt,
    R/dada.R:615-653)."""
    global _SESSION_OPTIONS
    new = _SESSION_OPTIONS.replace(**kwargs)
    for k, v in kwargs.items():
        old = getattr(DEFAULT_OPTIONS, k)
        if old is not None and v is not None and \
                not isinstance(v, type(old)) and \
                not (isinstance(old, (int, float)) and
                     isinstance(v, (int, float))):
            raise ValueError(f"{k} not set, value provided has different "
                             f"class ({type(v).__name__}) than default "
                             f"value ({type(old).__name__})")
    _SESSION_OPTIONS = new


def get_dada_opt(option: Optional[str] = None):
    """Return current option value(s) (reference: R/dada.R:655-667)."""
    if option is None:
        return dataclasses.asdict(_SESSION_OPTIONS)
    return getattr(_SESSION_OPTIONS, option)
