"""The benchmark's one general generator of inputs. A traffic mix is a
JSON file of parameters under mixes/; its "generator" names one of the
kinds below, and everything else it needs comes from the mix and the
configuration. The same seed gives the same inputs. Nothing here imports
the program under test.

Kinds:
- amplicon_samples: a study's samples, each a dereplicated set of
  simulated amplicon reads (the repo's chip_smoke.py::simulate_sample,
  vectorised): a study pool of ASVs drawn from the configuration's
  candidate amplicons, each sample drawing its own ASVs with log-normal
  abundances and its reads from them with substitution errors at the
  error model's rate for each position's quality.
- chimera_table: a study's sequence table (chip_smoke.py::
  chimera_fixture): sparse samples x ASVs counts, the ASVs being point
  mutants and two-parent recombinants of parents drawn from the
  configuration's candidate amplicons, or novel.

Sizes do not depend on the seed: a sample's abundances are the same set
of log-normal quantiles under every seed, dealt to the ASVs it draws, and
its reads are apportioned to them exactly; a table's occupancies and
counts are likewise fixed sets dealt at random. The seed picks the
sequences, the deal and the errors.
"""
from __future__ import annotations

import gzip
import json
import os

import numpy as np
from scipy.special import ndtri

HERE = os.path.dirname(os.path.abspath(__file__))
NT = np.frombuffer(b"ACGT", np.uint8)


def rng_of(seed: int, stream: int = 0) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 64), stream])


def candidates(config) -> list:
    with gzip.open(os.path.join(HERE, config["amplicons"]), "rt") as fh:
        return fh.read().split()


def quality_profile(config) -> np.ndarray:
    with open(os.path.join(HERE, "data", "quality.json")) as fh:
        return np.asarray(json.load(fh)[config["quality_profile"]])


def error_matrix(config) -> np.ndarray:
    """[16, Q] substitution probabilities by (from * 4 + to, quality)."""
    em = config["error_model"]
    if em["kind"] == "matrix":
        err = np.load(os.path.join(HERE, em["file"]))
        # repeat the last column up to max_q, as the repo's bench_e2e.py
        return np.hstack([err] + [err[:, -1:]] * (em["max_q"] + 1
                                                  - err.shape[1]))
    if em["kind"] == "phred":
        p = 10.0 ** (-np.arange(em["max_q"] + 1) / 10.0)
        err = np.tile(p / 3.0, (16, 1))
        err[[0, 5, 10, 15]] = 1.0 - p
        return err
    raise ValueError(f"unknown error model {em['kind']}")


def lognormal_set(n, mean, sigma):
    """n log-normal values at the midpoints of n equal-probability strata:
    the same set under every seed."""
    return np.exp(mean + sigma * ndtri((np.arange(n) + 0.5) / n))


def apportion(total, weights):
    """Whole counts summing to total in proportion to weights (largest
    remainders, ties to the lower index)."""
    w = np.asarray(weights, dtype=np.float64)
    exact = total * w / w.sum()
    counts = np.floor(exact).astype(np.int64)
    short = total - int(counts.sum())
    counts[np.argsort(-(exact - counts), kind="stable")[:short]] += 1
    return counts


def _codes(seqs):
    lens = np.array([len(s) for s in seqs])
    mat = np.full((len(seqs), lens.max()), 255, np.uint8)
    lut = np.full(256, 255, np.uint8)
    lut[NT] = np.arange(4)
    for k, s in enumerate(seqs):
        mat[k, :lens[k]] = lut[np.frombuffer(s.encode(), np.uint8)]
    return mat, lens


def simulate_sample(rng, codes, lens, weights, q8, err, nreads):
    """(uniques [sequence strings, by decreasing abundance], abundances,
    quals [n, L] float64 with NaN past each length): nreads reads drawn
    from the ASVs (codes, lens) in proportion to weights, each position
    substituted with the error model's probability at its quality q8."""
    counts = apportion(nreads, weights)
    asv = np.repeat(np.arange(len(counts)), counts)
    W = codes.shape[1]
    pos = np.arange(W)[None, :]
    # P(no substitution) by ASV and position, 1 past each ASV's end
    c = np.where(pos < lens[:, None], codes, 0).astype(np.int64)
    keep = np.where(pos < lens[:, None], err[5 * c, q8[None, :W]],
                    1.0).astype(np.float32)
    reads = np.repeat(codes, counts, axis=0)
    # one block of uniform draws per ASV, in row order: the same stream
    # as one draw over all reads, without a read-sized gather of keep
    hits, row = [], 0
    for k, n in enumerate(counts):
        r, p = np.divmod(np.flatnonzero(
            rng.random((n, W), dtype=np.float32) >= keep[k]), W)
        hits.append((r + row, p))
        row += n
    ri = np.concatenate([h[0] for h in hits])
    pi = np.concatenate([h[1] for h in hits])
    if len(ri):
        base = c[asv[ri], pi]
        probs = np.stack([err[4 * base + t, q8[pi]] for t in range(4)], 1)
        probs[np.arange(len(pi)), base] = 0.0
        probs /= probs.sum(axis=1, keepdims=True)
        u = rng.random(len(pi))
        reads[ri, pi] = np.minimum((np.cumsum(probs, 1) < u[:, None]).sum(1),
                                   3)
    rows = np.ascontiguousarray(reads).view(np.dtype((np.void, W)))[:, 0]
    uniq, first, cnt = np.unique(rows, return_index=True, return_counts=True)
    order = np.argsort(-cnt, kind="stable")
    first, cnt = first[order], cnt[order]
    seqs = []
    for k in first:
        r = reads[k, :lens[asv[k]]]
        seqs.append(NT[r].tobytes().decode())
    L = lens[asv[first]]
    quals = np.where(pos < L[:, None], q8[:W][None, :].astype(np.float64),
                     np.nan)
    return seqs, cnt.astype(np.int64), quals


def amplicon_samples(config, mix, seed) -> dict:
    """{"samples": [(name, seqs, abundances, quals)], "warmup": [...],
    "err": [16, Q]} for the study the mix describes."""
    rng = rng_of(seed)
    cand = candidates(config)
    pool = [cand[k] for k in rng.choice(len(cand), mix["pool_asvs"],
                                        replace=False)]
    codes, lens = _codes(pool)
    err = error_matrix(config)
    q8 = np.floor(quality_profile(config) + 0.5).astype(np.int64)

    def draw(r, nasv, nreads):
        pick = r.choice(len(pool), nasv, replace=False)
        w = lognormal_set(nasv, 0.0, mix["abundance_sigma"])
        return simulate_sample(r, codes[pick], lens[pick], w, q8, err,
                               nreads)

    samples = [(f"s{k}", *draw(rng_of(seed, 1 + k), mix["asvs_per_sample"],
                                mix["reads_per_sample"]))
               for k in range(mix["samples"])]
    wu = mix["warmup"]
    warm = [("warmup", *draw(rng_of(seed, 1000), wu["asvs"], wu["reads"]))]
    return {"samples": samples, "warmup": warm, "err": err}


def chimera_table(config, mix, seed) -> dict:
    """{"counts": [samples, ASVs] int64, "seqs": [ASV strings]}."""
    rng = rng_of(seed)
    cand = candidates(config)
    bases = [cand[k] for k in rng.choice(len(cand), mix["parents"],
                                         replace=False)]
    ncol, L = mix["asvs"], len(bases[0])
    n_mut = round(mix["mutant_share"] * ncol)
    n_rec = round(mix["recombinant_share"] * ncol)
    kinds = rng.permutation(np.repeat([0, 1, 2], [n_mut, n_rec,
                                                  ncol - n_mut - n_rec]))
    seqs, out = set(), []
    for kind in kinds:
        while True:        # draw again until the kind gives a new ASV
            if kind == 0:      # a point mutant of a parent
                s = np.frombuffer(bases[rng.integers(len(bases))].encode(),
                                  np.uint8).copy()
                for _ in range(int(rng.integers(1, 6))):
                    s[int(rng.integers(0, len(s)))] = NT[rng.integers(0, 4)]
                s = s.tobytes().decode()
            elif kind == 1:    # a two-parent recombinant
                i, j = rng.integers(0, len(bases), 2)
                cut = int(rng.integers(40, L - 40))
                s = bases[i][:cut] + bases[j][cut:]
            else:              # novel
                s = NT[rng.integers(0, 4, L)].tobytes().decode()
            if s not in seqs:
                break
        seqs.add(s)
        out.append(s)
    nsam = mix["samples"]
    mat = np.zeros((nsam, ncol), np.int64)
    lo, hi = mix["occupancy"]
    occ = rng.permutation(np.resize(np.arange(lo, hi + 1), ncol))
    vals = rng.permutation(np.maximum(1, np.round(lognormal_set(
        int(occ.sum()), mix["log_count_mean"], mix["abundance_sigma"]))))
    k = 0
    for j in range(ncol):
        rows = rng.choice(nsam, size=occ[j], replace=False)
        mat[rows, j] = vals[k:k + occ[j]]
        k += occ[j]
    return {"counts": mat, "seqs": out}


KINDS = {"amplicon_samples": amplicon_samples,
         "chimera_table": chimera_table}


def generate(config, mix, seed):
    return KINDS[mix["generator"]](config, mix, seed)
