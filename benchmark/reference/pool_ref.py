"""Plain reference of DADA2's pooled sample inference, dada(derep, err,
pool=TRUE) at a given error matrix (selfConsist off, no priors): the
samples pooled as combineDereps2 pools them (R/multiSample.R:165-203),
the pool denoised as one sample (dada_ref.dada_sample), and each sample's
result split back out as R/dada.R:443-475 splits it. Plain numpy and
pandas here; it imports nothing of the program under test.
"""
from __future__ import annotations

import numpy as np
import torch

from . import dada_ref


def pool(samples):
    """(sequences, abundances, quals, members) of the pool of samples,
    each (sequences, abundances, quals [n, L] with NaN past a length):
    uniques in order of first encounter, then stably sorted by decreasing
    total abundance; a unique's quality profile the mean of its samples'
    profiles weighted by their abundances; members[i] the index in the
    pool of each unique of samples[i]."""
    first = {}
    order = []
    for seqs, _, _ in samples:
        for s in seqs:
            if s not in first:
                first[s] = len(order)
                order.append(s)
    width = max(q.shape[1] for _, _, q in samples)
    total = np.zeros(len(order), np.int64)
    qsum = np.zeros((len(order), width))
    for seqs, ab, q in samples:
        pad = np.full(width - q.shape[1], np.nan)
        for k, s in enumerate(seqs):
            j = first[s]
            total[j] += int(ab[k])
            qsum[j] += np.concatenate([q[k], pad]) * int(ab[k])
    rank = np.argsort(-total, kind="stable")
    at = np.empty(len(order), np.int64)
    at[rank] = np.arange(len(order))
    members = [np.array([at[first[s]] for s in seqs], np.int64)
               for seqs, _, _ in samples]
    return ([order[j] for j in rank], total[rank],
            (qsum / total[:, None])[rank], members)


def split(pooled, members, abundances):
    """One sample's result out of the pooled one (R/dada.R:443-475): the
    ASVs its uniques map to, in the pool's order, their abundances summed
    over its own uniques; its map; the pool's birth substitutions of
    those ASVs, renumbered; the pool's transition counts; no p-values."""
    pmap = np.asarray(pooled["map"])[members]
    kept = sorted({int(c) for c in pmap if c >= 0})
    new = {c: k for k, c in enumerate(kept)}
    own = np.array([new[int(c)] if c >= 0 else -1 for c in pmap], np.int64)
    ab = np.zeros(len(kept), np.int64)
    for u, c in enumerate(own):
        if c >= 0:
            ab[c] += int(abundances[u])
    cl = pooled["clustering"].iloc[kept].reset_index(drop=True)
    cl["abundance"] = ab
    bs = pooled["birth_subs"]
    bs = bs[bs["clust"].isin([c + 1 for c in kept])].copy()
    bs["clust"] = np.array([new[int(c) - 1] + 1 for c in bs["clust"]],
                           np.int64)
    return {"clustering": cl, "birth_subs": bs,
            "subqual": pooled["subqual"], "map": own, "pval": None}


def dada_pooled(samples, err, opts, device="cuda",
                lam_dtype=torch.float64) -> list:
    """Each sample's result of dada(samples, err, pool=TRUE), in the
    samples' order (the order decides ties in the pool)."""
    seqs, ab, quals, members = pool(samples)
    pooled = dada_ref.dada_sample(seqs, ab, quals, err, opts, device=device,
                                  lam_dtype=lam_dtype)
    return [split(pooled, m, s[1]) for m, s in zip(members, samples)]
