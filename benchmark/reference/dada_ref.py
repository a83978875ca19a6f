"""Plain reference of one sample's denoising: DADA2's dada() at a given
error matrix (selfConsist off, no pooling, no priors). The engine and the
output assembly are frozen copies of the program's host code (engine.py,
output.py); the compare backend below is the benchmark's own: the k-mer
and gapless screens, the banded alignments (nw.py, plain torch ops on the
device it is given) and the exact lambdas, in the precision it is given
(float64 as DADA2; float32 for the control). It imports nothing of the
program under test.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from . import nw
from .engine import CompareBackend, Engine
from .output import finalize
from .pvals import Sub
from .seqs import GAP_GLYPH, KMER_SIZE, kmer_counts, kmer_ords, make_rawset

# DADA2 setDadaOpt() defaults (R/dada.R, the program's options.py)
DEFAULTS = dict(
    OMEGA_A=1e-40, OMEGA_P=1e-4, OMEGA_C=1e-40, DETECT_SINGLETONS=False,
    USE_KMERS=True, KDIST_CUTOFF=0.42, GAPLESS=True, GREEDY=True,
    MATCH=5, MISMATCH=-4, GAP_PENALTY=-8, BAND_SIZE=16,
    VECTORIZED_ALIGNMENT=True, HOMOPOLYMER_GAP_PENALTY=None, MAX_CLUST=0,
    MIN_FOLD=1.0, MIN_HAMMING=1, MIN_ABUNDANCE=1, SSE=2, USE_QUALS=True)


def options(**overrides) -> SimpleNamespace:
    opts = dict(DEFAULTS, **overrides)
    homo = opts["HOMOPOLYMER_GAP_PENALTY"]
    if (not opts["VECTORIZED_ALIGNMENT"] or opts["BAND_SIZE"] <= 0
            or (homo is not None and homo != opts["GAP_PENALTY"])
            or opts["SSE"] < 1 or not opts["USE_QUALS"]):
        raise ValueError("the reference aligns with DADA2's vectorized "
                         "banded aligner only, with qualities")
    return SimpleNamespace(**opts)


class RefBackend(CompareBackend):
    """Compares on `device`, lambdas in `lam_dtype`."""

    def __init__(self, rs, err, device, lam_dtype=torch.float64):
        self.rs = rs
        self.dev = torch.device(device)
        self.lam_dtype = lam_dtype
        dev = self.dev
        kord = kmer_ords(rs.seqs, rs.lens)
        self.kord = torch.from_numpy(kord).to(dev)
        self.kmers = torch.from_numpy(kmer_counts(kord)).to(dev)
        self.seqs = torch.from_numpy(rs.seqs.astype(np.int64)).to(dev)
        self.lens = torch.from_numpy(rs.lens.astype(np.int64)).to(dev)
        self.quals = torch.from_numpy(rs.quals.astype(np.int64)).to(dev)
        # row 16 holds 1.0: the factor of positions past a sequence's end
        errp = np.vstack([err, np.ones((1, err.shape[1]))])
        self.err = torch.from_numpy(errp).to(dev, lam_dtype)
        self._stash = []

    def _maps(self, i0, i1, opts, use_kmers, kdist_cutoff):
        """(aligned [P] bool, map [P, L] int64: the seq1 position aligned
        to each seq0 position, -1 at gaps) for index pairs, as DADA2's
        raw_align (src/nwalign_endsfree.cpp:10-73) decides them."""
        s, L = self.seqs, self.lens
        l0, l1 = L[i0], L[i1]
        P = len(i0)
        ok = torch.ones(P, dtype=torch.bool, device=self.dev)
        gapless = torch.zeros_like(ok)
        if use_kmers:
            minsum = torch.minimum(self.kmers[i0], self.kmers[i1]).sum(1)
            kdist = 1.0 - minsum.double() / (
                torch.minimum(l0, l1) - KMER_SIZE + 1.0).double()
            ok = ~(kdist > kdist_cutoff)
            if opts.GAPLESS:
                klen = torch.minimum(l0, l1) - KMER_SIZE + 1
                pos = torch.arange(self.kord.shape[1], device=self.dev)
                same = ((self.kord[i0] == self.kord[i1])
                        & (pos[None, :] < klen[:, None])).sum(1)
                gapless = same == minsum
        L0 = s.shape[1]
        out = torch.full((P, L0), -1, dtype=torch.int64, device=self.dev)
        pos = torch.arange(L0, device=self.dev)[None, :]
        g = ok & gapless
        out[g] = torch.where(pos < torch.minimum(l0, l1)[g, None], pos, -1)
        a = ok & ~gapless
        if bool(a.any()):
            out[a] = nw.align(s[i0[a]], l0[a], s[i1[a]], l1[a],
                              band=opts.BAND_SIZE, match=opts.MATCH,
                              mismatch=opts.MISMATCH, gap=opts.GAP_PENALTY)
        return ok, out

    def _subs(self, i0, i1, mp):
        """(mismatch mask over seq0 positions, seq1 codes there)."""
        c0 = self.seqs[i0]
        c1 = self.seqs[i1].gather(1, mp.clamp(min=0))
        return (mp >= 0) & (c0 != c1), c1

    def compare(self, center, skip, opts, err, use_kmers, kdist_cutoff,
                e_thresh=None):
        n = self.rs.n
        lam = np.zeros(n)
        ham = np.full(n, -1, dtype=np.int64)
        idx = torch.from_numpy(np.nonzero(~skip)[0]).to(self.dev)
        if len(idx) == 0:
            return lam, ham
        i0 = torch.full_like(idx, center)
        ok, mp = self._maps(i0, idx, opts, use_kmers, kdist_cutoff)
        idx, i0, mp = idx[ok], i0[ok], mp[ok]
        mism, c1 = self._subs(i0, idx, mp)
        # DADA2 compute_lambda (src/pval.cpp:144-197): the product over the
        # raw's positions of err[transition, quality], self-transitions
        # except at substitutions, taken in position order
        raw = self.seqs[idx]
        Lr = raw.shape[1]
        pos = torch.arange(Lr, device=self.dev)[None, :]
        tvec = torch.where(pos < self.lens[idx][:, None], 5 * raw, 16)
        tvec = torch.cat([tvec, torch.zeros_like(tvec[:, :1])], 1)
        tgt = torch.where(mism, mp, Lr)
        tvec.scatter_(1, tgt, torch.where(mism, 4 * self.seqs[i0] + c1, 0))
        f = self.err[tvec[:, :Lr], self.quals[idx]]
        prod = torch.ones(len(idx), dtype=self.lam_dtype, device=self.dev)
        for p in range(Lr):
            prod = prod * f[:, p]
        sel = idx.cpu().numpy()
        lam[sel] = prod.double().cpu().numpy()
        ham[sel] = mism.sum(1).cpu().numpy()
        if np.any((lam < 0) | (lam > 1)):
            raise ValueError("Bad lambda.")
        return lam, ham

    def subs_pairs(self, pairs, opts, use_kmers, kdist_cutoff):
        pr = torch.tensor(pairs, dtype=torch.int64, device=self.dev)
        ok, mp = self._maps(pr[:, 0], pr[:, 1], opts, use_kmers,
                            kdist_cutoff)
        mism, c1 = self._subs(pr[:, 0], pr[:, 1], mp)
        out = []
        for k, (a, _) in enumerate(pairs):
            if not bool(ok[k]):
                out.append(None)
                continue
            len0 = int(self.rs.lens[a])
            m = mp[k, :len0].cpu().numpy()
            where = np.nonzero(mism[k, :len0].cpu().numpy())[0]
            out.append(Sub(
                nsubs=len(where), len0=len0,
                map=np.where(m >= 0, m, GAP_GLYPH).astype(np.int32),
                pos=where.astype(np.int32),
                nt0=self.rs.seqs[a, where],
                nt1=c1[k, :len0].cpu().numpy()[where].astype(np.uint8)))
        return out

    def subs_pair(self, i0, i1, opts, use_kmers, kdist_cutoff):
        return self.subs_pairs([(i0, i1)], opts, use_kmers,
                               kdist_cutoff)[0]

    def cluster_stats_all(self, clusters, opts, ncol, use_quals):
        # every member against its center in one batch; the inherited
        # per-cluster tallies read them back through subs_info
        cen = np.concatenate([np.full(len(m), c, np.int64)
                              for c, m, _ in clusters])
        mem = np.concatenate([m for _, m, _ in clusters])
        i0 = torch.from_numpy(cen).to(self.dev)
        i1 = torch.from_numpy(mem.astype(np.int64)).to(self.dev)
        _, mp = self._maps(i0, i1, opts, False, 1.0)
        mism, _ = self._subs(i0, i1, mp)
        mp = mp.cpu().numpy()
        ns = mism.sum(1).cpu().numpy()
        lo = 0
        self._stash = []
        for c, m, _ in clusters:
            len0 = int(self.rs.lens[c])
            part = mp[lo:lo + len(m), :len0]
            self._stash.append((np.where(part >= 0, part, GAP_GLYPH),
                                ns[lo:lo + len(m)].astype(np.int64)))
            lo += len(m)
        self._stash.reverse()
        return super().cluster_stats_all(clusters, opts, ncol, use_quals)

    def subs_info(self, center, members, opts):
        return self._stash.pop()


def dada_sample(seqs, abundances, quals, err, opts, device="cuda",
                lam_dtype=torch.float64) -> dict:
    """One sample's dada() result (DADA2 R/dada.R dada_uniques at a
    given err): clustering, birth_subs, subqual, clusterquals, map,
    pval."""
    err = np.asarray(err, dtype=np.float64)
    qmax = int(np.ceil(np.nanmax(quals)))
    if err.shape[1] < qmax + 1:     # repeat the last column (R/dada.R:302)
        err = np.hstack([err, np.tile(err[:, -1:],
                                      (1, qmax + 1 - err.shape[1]))])
    rs = make_rawset(seqs, abundances, quals)
    be = RefBackend(rs, err, device, lam_dtype)
    eng = Engine(rs, err, opts, be, use_quals=True)
    eng.run(max_clust=opts.MAX_CLUST)
    return finalize(eng, opts, err.shape[1], opts.OMEGA_C)
