"""Taxonomic classification: naive-Bayes (RDP) classifier + exact species
matching.

reference: src/taxonomy.cpp (C_assign_taxonomy2 :206-338, get_best_genus
:73-110, tax_kvec/tax_karray :35-71) and R/taxonomy.R (assignTaxonomy
:65-160, assignSpecies :240-289, addSpecies :347-360, mapHits :163-171,
matchGenera :175-185).

Design: the per-genus log-probability table lgk is a [ngenus, 4^8 = 65536]
float32 matrix built on the host (as dada2_tpu builds it) and moved to the
card once per assign_taxonomy call, and classifying a batch of queries is
one float32 matrix product -- query 8-mer count vectors (with multiplicity,
exactly the reference's sorted karray sums) against lgk^T. The reference's
rate-limiting per-genus scalar loop with early abandon
(src/taxonomy.cpp:88-89) becomes a dense product. The 100 bootstrap
replicates per query are a second batched product over sampled positions
of each query's k-mer array. Both are torch ops on the card (the PyTorch
counterpart of dada2_tpu's XLA scorer, dada2_tpu/taxonomy.py::_score_batch),
with TF32 off: their f32 values feed argmaxes.

Determinism note: the reference breaks score ties by reservoir sampling
with an OS-seeded mt19937 (src/taxonomy.cpp:80-106, nondeterministic) and
draws bootstrap indices from R's RNG stream; this implementation takes the
first max (deterministic) and draws the bootstrap uniforms from a CPU
torch.Generator seeded with `seed`, so the card and the CPU draw the same
numbers. Taxonomy parity with the reference, and with dada2_tpu (whose
uniforms come from jax's PRNG), is statistical, not bitwise (SURVEY.md
section 7, hard-part 6); given the same uniforms, the scorer follows
dada2_tpu's step by step.

Everything else (fasta parsing, k-mer arrays, the lgk build, species
matching) follows dada2_tpu/taxonomy.py line for line, save that the lgk
build counts with a sort instead of np.unique and np.add.at (the same
table, bit for bit).
"""
from __future__ import annotations

import gzip
import re
from contextlib import contextmanager
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .encode import rc

K = 8
N_KMERS = 4 ** K
NBOOT = 100
MIN_REF_LEN = 20
MIN_TAX_LEN = 50
UNSPEC = "_DADA2_UNSPECIFIED"
DEFAULT_TAX_LEVELS = ["Kingdom", "Phylum", "Class", "Order", "Family",
                      "Genus", "Species"]

_NT2I = {"A": 0, "C": 1, "G": 2, "T": 3}


def read_fasta(path: str) -> Tuple[List[str], List[str]]:
    """(ids, sequences) from a (possibly gzipped) fasta file."""
    op = gzip.open if str(path).endswith(".gz") else open
    ids: List[str] = []
    seqs: List[str] = []
    cur: List[str] = []
    with op(path, "rt") as f:
        for line in f:
            line = line.strip()
            if line.startswith(">"):
                if cur:
                    seqs.append("".join(cur))
                ids.append(line[1:])
                cur = []
            elif line:
                cur.append(line)
    if cur:
        seqs.append("".join(cur))
    return ids, seqs


_NT_TABLE = np.full(256, -1, dtype=np.int8)
for _c, _v in _NT2I.items():
    _NT_TABLE[ord(_c)] = _v


def tax_karray(seq: str) -> np.ndarray:
    """All valid 8-mer indices along the sequence (with multiplicity).

    reference: tax_karray (src/taxonomy.cpp:55-71); the reference sorts,
    which does not affect sums or uniform resampling."""
    return tax_karrays_bulk([seq])[0]


def tax_karrays_bulk(seqs) -> list:
    """Per-sequence valid 8-mer code arrays for a whole batch in
    O(total bases): one byte-table lookup over a separator-joined
    buffer + K rolling passes (the vectorized tax_karray; windows that
    cross a separator or touch a non-ACGT base are masked out).

    reference: src/taxonomy.cpp:55-71, batched over the whole
    reference set instead of per-sequence (SILVA-scale ingestion)."""
    if not seqs:
        return []
    lens = np.fromiter((len(s) for s in seqs), np.int64, len(seqs))
    joined = "\n".join(seqs).encode()
    vals = _NT_TABLE[np.frombuffer(joined, np.uint8)].astype(np.int64)
    nwin = len(vals) - K + 1
    starts = np.concatenate([[0], np.cumsum(lens[:-1] + 1)])
    if nwin <= 0:
        return [np.zeros(0, dtype=np.int64) for _ in seqs]
    idx = np.zeros(nwin, dtype=np.int64)
    ok = np.ones(nwin, dtype=bool)
    for j in range(K):
        v = vals[j: j + nwin]
        ok &= v >= 0
        idx = idx * 4 + np.where(v >= 0, v, 0)
    out = []
    for i in range(len(seqs)):
        n_i = int(lens[i]) - K + 1
        if n_i <= 0:
            out.append(np.zeros(0, dtype=np.int64))
            continue
        sl = slice(int(starts[i]), int(starts[i]) + n_i)
        out.append(idx[sl][ok[sl]])
    return out


def _kmer_presence(seq: str) -> np.ndarray:
    """Distinct 8-mer indices (tax_kvec, src/taxonomy.cpp:35-52)."""
    return np.unique(tax_karray(seq))


def _parse_ref_taxonomy(ids: List[str]) -> List[str]:
    """Clean id lines into ;-terminated taxonomy strings, including UNITE
    format sniffing (reference: R/taxonomy.R:86-94)."""
    tax = [re.sub(r"^\s+|\s+$", "", t) for t in ids]
    if len(tax) >= 10 and all(re.search(r"FU\|re[pf]s", t)
                              for t in tax[:10]):
        print("UNITE fungal taxonomic reference detected.")
        tax = [t.split("|")[4] for t in tax]
        tax = [re.sub(r"[pcofg]__unidentified;", UNSPEC + ";", t)
               for t in tax]
        tax = [re.sub(r";s__(\w+)_", ";s__", t) for t in tax]
        tax = [re.sub(r";s__sp$", ";" + UNSPEC, t) for t in tax]
    if ";" not in tax[0]:
        if len(tax[0].split()) == 3:
            raise ValueError(
                "Incorrect reference file format for assignTaxonomy (this "
                "looks like a file formatted for assignSpecies).")
        raise ValueError("Incorrect reference file format for "
                         "assignTaxonomy.")
    return tax


def _sorted_unique(x: np.ndarray):
    """(sorted distinct values of x, their counts): np.unique(x,
    return_counts=True) by one sort. Newer numpy's np.unique takes a hash
    path for integers that ran ~6 s per call on ~6 M int64 values on an
    H100 machine's host, against ~0.1 s for the sort (ab_tax.py)."""
    a = np.sort(x)
    first = np.empty(len(a), bool)
    first[:1] = True
    np.not_equal(a[1:], a[:-1], out=first[1:])
    starts = np.flatnonzero(first)
    return a[starts], np.diff(np.append(starts, len(a)))


def _build_lgk(refs: List[str], ref_to_genus: np.ndarray, ngenus: int
               ) -> np.ndarray:
    """[ngenus, 65536] float32 log genus-kmer probabilities.

    reference: src/taxonomy.cpp:227-270. lgk[g][m] = log((count_gm +
    prior_m) / (n_g + 1)) with prior_m = (n_m + 0.5) / (nref + 1)."""
    nref = len(refs)
    counts = np.zeros((ngenus, N_KMERS), dtype=np.int32)
    prior = np.zeros(N_KMERS, dtype=np.int64)
    genus_n = np.bincount(np.asarray(ref_to_genus, np.int64),
                          minlength=ngenus).astype(np.float32)
    # chunked bulk ingestion: distinct (ref, kmer) pairs per chunk via
    # one sort, then distinct (genus, kmer) counts via another and one
    # scatter -- O(total bases log) instead of a Python loop per
    # reference (SILVA-scale: minutes -> seconds)
    CH = 4096
    flat = counts.reshape(-1)
    for lo in range(0, nref, CH):
        sub = refs[lo: lo + CH]
        kas = tax_karrays_bulk(sub)
        sizes = np.fromiter((len(a) for a in kas), np.int64, len(kas))
        if not sizes.sum():
            continue
        rid = np.repeat(np.arange(len(sub), dtype=np.int64), sizes)
        kflat = np.concatenate(kas)
        pairs, _ = _sorted_unique(rid * N_KMERS + kflat)  # per ref
        g = np.asarray(ref_to_genus)[lo + (pairs // N_KMERS)]
        km = pairs % N_KMERS
        gk, n = _sorted_unique(g * N_KMERS + km)
        flat[gk] += n.astype(np.int32)
        prior += np.bincount(km, minlength=N_KMERS)
    # float32 arithmetic ordered exactly as the reference's float build
    # (src/taxonomy.cpp:236-270): integer counts are exact in f32. The
    # steps run in place on one [ngenus, 65536] array (the same f32
    # operations as dada2_tpu's expression, without its temporaries)
    priorf = ((prior.astype(np.float32) + np.float32(0.5))
              / np.float32(1.0 + nref))
    lgk = counts.astype(np.float32)
    del counts, flat
    lgk += priorf[None, :]
    lgk /= genus_n[:, None] + np.float32(1.0)
    with np.errstate(divide="ignore"):
        np.log(lgk, out=lgk)
    return lgk


def load_reference(refFasta: str):
    """(refs, ref_to_genus, genus_levels) from a taxonomic training fasta:
    the kept reference sequences, each one's genus index, and each genus's
    levels (padded to the deepest with UNSPEC). assign_taxonomy's reference
    preparation (R/taxonomy.R:80-110), as dada2_tpu does it inline."""
    ids, refs = read_fasta(refFasta)
    keep = [len(r) >= MIN_REF_LEN for r in refs]
    if not all(keep):
        import warnings
        warnings.warn("Some reference sequences were too short "
                      f"(<{MIN_REF_LEN}nts) and were excluded.")
        ids = [i for i, k in zip(ids, keep) if k]
        refs = [r for r, k in zip(refs, keep) if k]
    tax = _parse_ref_taxonomy(ids)
    depth = [len(t.split(";")) if not t.endswith(";")
             else len(t.split(";")) - 1 for t in tax]
    td = max(depth)
    tax = [t if t.endswith(";") else t + ";" for t in tax]
    tax = [t + (UNSPEC + ";") * (td - d) for t, d in zip(tax, depth)]

    genus_unq: List[str] = []
    genus_idx = {}
    ref_to_genus = np.zeros(len(tax), dtype=np.int64)
    for i, t in enumerate(tax):
        j = genus_idx.get(t)
        if j is None:
            j = len(genus_unq)
            genus_idx[t] = j
            genus_unq.append(t)
        ref_to_genus[i] = j
    genus_levels = [g.split(";")[:td] for g in genus_unq]
    return refs, ref_to_genus, genus_levels


def device_lgk(lgk, device=None) -> torch.Tensor:
    """lgk [ngenus, 65536] (numpy or tensor, e.g. dada2_tpu's own table) as
    the scorer holds it on the device: transposed, [65536, ngenus]
    contiguous, so the bootstrap's gather reads each k-mer's genus scores
    as one contiguous row. device: None = the CUDA card, "cpu"."""
    from .core.backend_cuda import resolve_device

    t = lgk if isinstance(lgk, torch.Tensor) else torch.from_numpy(
        np.array(lgk, np.float32))
    return t.to(resolve_device(device), torch.float32).t().contiguous()


def boot_uniforms(karrays: List[np.ndarray], generator: torch.Generator
                  ) -> torch.Tensor:
    """The bootstrap's uniforms for one _score_batch call, [q, NBOOT,
    A // 8 + 1] float32 on the CPU, drawn from `generator` (A: the batch's
    longest k-mer array, at least 8)."""
    A = max(max((len(a) for a in karrays), default=1), 8)
    return torch.rand((len(karrays), NBOOT, A // 8 + 1),
                      generator=generator, dtype=torch.float32)


@contextmanager
def _no_tf32():
    """TF32 off for the products inside (their f32 values feed argmaxes,
    where the numerical contract allows no TF32); the caller's setting
    comes back afterwards."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _score_batch(karrays: List[np.ndarray], lgk_t: torch.Tensor, u,
                 ngenus: int, mem_cap: int = 1 << 27):
    """Best genus + bootstrap genera for a batch of queries, on lgk_t's
    device (lgk_t from device_lgk; u from boot_uniforms, or any [q, NBOOT,
    A // 8 + 1] float32 draws, e.g. dada2_tpu's).

    Scoring is counts @ lgk^T; bootstraps resample each query's k-mer
    array (arraylen/8 draws, NBOOT replicates, reference:
    src/taxonomy.cpp:183-196). Step for step dada2_tpu's _score_batch: the
    same scatters, truncations, genus chunks and running-max merge. Its
    last chunk is padded with rows of -1e30, which can never win; here the
    last chunk is simply cut at ngenus, which picks the same genera."""
    from .core.backend_cuda import _fetch

    _score_batch.calls += 1
    dev = lgk_t.device
    q = len(karrays)
    A = max(max((len(a) for a in karrays), default=1), 8)
    karr = np.zeros((q, A), dtype=np.int64)
    alen = np.zeros(q, dtype=np.int32)
    for i, a in enumerate(karrays):
        karr[i, : len(a)] = a
        alen[i] = len(a)
    u = (u if isinstance(u, torch.Tensor) else torch.from_numpy(
        np.array(u, np.float32))).to(dev, torch.float32)
    if tuple(u.shape) != (q, NBOOT, A // 8 + 1):
        raise ValueError(f"uniforms of shape {tuple(u.shape)}, expected "
                         f"{(q, NBOOT, A // 8 + 1)}")
    out = _score_device(torch.from_numpy(karr).to(dev),
                        torch.from_numpy(alen).to(dev), u, lgk_t, mem_cap)
    return tuple(_fetch(x) for x in out)


def _score_device(karr: torch.Tensor, alen: torch.Tensor, u: torch.Tensor,
                  lgk_t: torch.Tensor, mem_cap: int):
    """_score_batch's device work (dada2_tpu's jitted `run`) on tensors on
    lgk_t's device: karr int64 [q, A] (pad anything), alen int32 [q], u
    float32 [q, NBOOT, A // 8 + 1]. Returns (best, best_logp, boot
    winners) as device tensors."""
    dev = lgk_t.device
    q, A = karr.shape
    mmax = A // 8 + 1
    # genus-axis chunking keeps the bootstrap intermediate at
    # ~[q, A, Gc] instead of [q, A, G] -- SILVA-scale genus counts with
    # PacBio-length queries would otherwise exhaust device memory
    G = int(lgk_t.shape[1])
    Gc = max(16, min(G, mem_cap // max(q * A, 1)))
    nchunk = (G + Gc - 1) // Gc

    with _no_tf32():
        mask = torch.arange(A, device=dev)[None, :] < alen[:, None]
        # counts [q, 65536] via scatter-add; pad dropped via index 65536
        idx = torch.where(mask, karr, N_KMERS)
        counts = torch.zeros((q, N_KMERS + 1), dtype=torch.float32,
                             device=dev)
        counts.scatter_add_(1, idx,
                            torch.ones_like(idx, dtype=torch.float32))
        scores = torch.matmul(counts[:, :N_KMERS], lgk_t)     # [q, G]
        best_logp, best = torch.max(scores, dim=1)           # first max

        # bootstraps: sample m = arraylen//8 positions per replicate
        m = torch.clamp(alen // 8, min=1)
        pos = (u * alen[:, None, None]).to(torch.int32)
        pos = torch.clamp(pos, 0, A - 1)
        bmask = (torch.arange(mmax, device=dev)[None, None, :]
                 < m[:, None, None])
        # S[q, b, a] = times position a was drawn in replicate b
        pos_dropped = torch.where(bmask, pos, A).long()
        S = torch.zeros((q, NBOOT, A + 1), dtype=torch.float32, device=dev)
        S.scatter_add_(2, pos_dropped,
                       torch.ones_like(pos_dropped, dtype=torch.float32))
        S = S[:, :, :A]
        karr_c = torch.where(mask, karr, 0).reshape(-1)

        bb_score = torch.full((q, NBOOT), -float("inf"), device=dev)
        bb_idx = torch.zeros((q, NBOOT), dtype=torch.int64, device=dev)
        for ci in range(nchunk):
            lo, hi = ci * Gc, min(G, (ci + 1) * Gc)
            lgq_c = lgk_t[:, lo:hi].index_select(0, karr_c).view(
                q, A, hi - lo)                               # row gather
            bs = torch.bmm(S, lgq_c)                         # [q, NBOOT, g]
            mx, am = torch.max(bs, dim=2)
            upd = mx > bb_score                # ties keep earlier chunk
            bb_score = torch.where(upd, mx, bb_score)
            bb_idx = torch.where(upd, am + lo, bb_idx)
    return best, best_logp, bb_idx


_score_batch.calls = 0


def assign_taxonomy(seqs, refFasta: str, minBoot: int = 50,
                    tryRC: bool = False, outputBootstraps: bool = False,
                    taxLevels: Sequence[str] = DEFAULT_TAX_LEVELS,
                    multithread=False, verbose: bool = False, seed: int = 100,
                    batch: int = 256, device=None):
    """Classify sequences against a taxonomic training fasta.

    reference: assignTaxonomy (R/taxonomy.R:65-160). Returns a pandas
    DataFrame (rows = sequences, columns = tax levels), or a dict with
    'tax' and 'boot' when outputBootstraps. device: where the scorer runs
    (None = the CUDA card, "cpu"); the bootstrap uniforms are drawn on the
    CPU from `seed` either way."""
    import pandas as pd

    from .core.backend_cuda import resolve_device
    from .seqtab import get_sequences
    from .trace import PHASES

    dev = resolve_device(device)
    seqs = get_sequences(seqs)
    if min(len(s) for s in seqs) < MIN_TAX_LEN:
        import warnings
        warnings.warn(f"Some sequences were shorter than {MIN_TAX_LEN} nts "
                      "and will not receive a taxonomic classification.")
    with PHASES("taxonomy.reference"):
        refs, ref_to_genus, genus_levels = load_reference(refFasta)
    ngenus = len(genus_levels)
    td = len(genus_levels[0])

    if verbose:
        print("Finished processing reference fasta.")
    with PHASES("taxonomy.lgk"):
        lgk = _build_lgk(refs, ref_to_genus, ngenus)
    with PHASES("taxonomy.upload"):
        lgk_t = device_lgk(lgk, dev)
    del lgk

    n = len(seqs)
    best = np.full(n, -1, dtype=np.int64)
    boots = np.zeros((n, td), dtype=np.int64)
    ok_idx = [i for i, s in enumerate(seqs) if len(s) >= MIN_TAX_LEN]
    gen = torch.Generator().manual_seed(seed)
    for lo in range(0, len(ok_idx), batch):
        chunk = ok_idx[lo: lo + batch]
        with PHASES("taxonomy.karrays"):
            karrs = tax_karrays_bulk([seqs[i] for i in chunk])
            u = boot_uniforms(karrs, gen)
            if tryRC:
                karrs_rc = tax_karrays_bulk([rc(seqs[i]) for i in chunk])
                u_rc = boot_uniforms(karrs_rc, gen)
        with PHASES("taxonomy.score"):
            b, logp, bb = _score_batch(karrs, lgk_t, u, ngenus)
            if tryRC:
                b2, logp2, bb2 = _score_batch(karrs_rc, lgk_t, u_rc, ngenus)
                use_rc = logp2 > logp
                b = np.where(use_rc, b2, b)
                bb = np.where(use_rc[:, None], bb2, bb)
        with PHASES("taxonomy.boots"):
            for row, i in enumerate(chunk):
                best[i] = b[row]
                bl = genus_levels[b[row]]
                for g in bb[row]:
                    gl = genus_levels[int(g)]
                    for lev in range(td):
                        if gl[lev] == bl[lev]:
                            boots[i, lev] += 1
                        else:
                            break
    del lgk_t

    tax_out = np.full((n, td), None, dtype=object)
    for i in range(n):
        if best[i] < 0:
            continue
        levels = genus_levels[best[i]]
        kl = 0
        while kl < td and boots[i, kl] >= minBoot:
            tax_out[i, kl] = levels[kl]
            kl += 1
    tax_out[tax_out == UNSPEC] = None
    cols = list(taxLevels)[:td]
    cols += [f"Level{j + 1}" for j in range(len(cols), td)]
    df = pd.DataFrame(tax_out, index=seqs, columns=cols)
    if outputBootstraps:
        bdf = pd.DataFrame(boots, index=seqs, columns=cols)
        return {"tax": df, "boot": bdf}
    return df


# ---------------------------------------------------------------------------
# species-level exact matching
# ---------------------------------------------------------------------------

def _map_hits(hit_idx, refs: List[str], keep: float,
              sep: str = "/") -> Optional[str]:
    """reference: mapHits (R/taxonomy.R:163-171). hit_idx: indices of the
    matching references."""
    h = [refs[i] for i in hit_idx]
    h = ["Escherichia/Shigella" if ("Escherichia" in x or "Shigella" in x)
         else x for x in h]
    unq = sorted(set(h))
    if len(unq) == 0 or len(unq) > keep:
        return None
    return sep.join(unq)


def _containment_hits(queries: List[str], refs: List[str],
                      anchor: int = 16) -> List[set]:
    """Per-query sets of reference indices that contain the query as an
    exact substring.

    The reference uses Biostrings PDict/vcountPDict (Aho-Corasick over
    the query dictionary, R/taxonomy.R:263-276, its ">100x faster"
    path, NEWS:205). The equivalent here: every query's first `anchor`
    bases become a 2-bit integer code; one vectorized rolling-code pass
    over the (chunked, concatenated) references finds anchor occurrences
    via sorted search, and only those candidate positions are verified
    by full string comparison."""
    from .encode import seq_to_codes

    nq = len(queries)
    hits: List[set] = [set() for _ in range(nq)]
    if nq == 0 or len(refs) == 0:
        return hits

    def anchorable(q):
        from .encode import seq_to_codes

        return (len(q) >= anchor
                and not (seq_to_codes(q[:anchor]) > 3).any())

    # queries shorter than the anchor or with non-ACGT characters in the
    # anchor window fall back to a direct scan (rare)
    short = [qi for qi, q in enumerate(queries) if not anchorable(q)]
    long_q = [qi for qi in range(nq) if qi not in set(short)]
    if short:
        for ri, r in enumerate(refs):
            for qi in short:
                if queries[qi] in r:
                    hits[qi].add(ri)
    if not long_q:
        return hits

    # 2-bit anchor codes of the query prefixes
    acodes = np.empty(len(long_q), np.int64)
    for k, qi in enumerate(long_q):
        c = seq_to_codes(queries[qi][:anchor]).astype(np.int64)
        v = 0
        for b in c:
            v = (v << 2) | int(b)
        acodes[k] = v
    order = np.argsort(acodes, kind="stable")
    sorted_codes = acodes[order]
    qids = np.asarray(long_q, np.int64)[order]

    # chunked pass over the concatenated references
    CHUNK = 200
    pos = 0
    ref_list = refs
    for lo in range(0, len(ref_list), CHUNK):
        batch = ref_list[lo: lo + CHUNK]
        cat = "\x00".join(batch)
        c = np.frombuffer(cat.encode("ascii"), np.uint8)
        starts = np.zeros(len(batch), np.int64)
        ln = np.fromiter((len(r) for r in batch), np.int64,
                         count=len(batch))
        starts[1:] = np.cumsum(ln[:-1] + 1)
        from .encode import _NT2CODE

        cc = _NT2CODE[c].astype(np.int64)
        bad = cc > 3
        cz = np.where(bad, 0, cc)
        W = len(cc) - anchor + 1
        if W <= 0:
            continue
        w = np.zeros(W, np.int64)
        anybad = np.zeros(W, bool)
        for j in range(anchor):
            w = (w << 2) | cz[j: j + W]
            anybad |= bad[j: j + W]
        okp = ~anybad
        ins = np.searchsorted(sorted_codes, w)
        cand = okp & (ins < len(sorted_codes))
        cidx = np.nonzero(cand)[0]
        cidx = cidx[sorted_codes[ins[cidx]] == w[cidx]]
        for p in cidx:
            ri_local = int(np.searchsorted(starts, p, side="right")) - 1
            r = batch[ri_local]
            off = int(p - starts[ri_local])
            # all queries sharing this anchor code
            a = int(ins[p])
            b = a
            while b < len(sorted_codes) and sorted_codes[b] == w[p]:
                b += 1
            for k in range(a, b):
                qi = int(qids[k])
                q = queries[qi]
                if r.startswith(q, off):
                    hits[qi].add(lo + ri_local)
    return hits


def assign_species(seqs, refFasta: str,
                   allowMultiple: Union[bool, int] = False,
                   tryRC: bool = False, n: int = 2000,
                   verbose: bool = False):
    """Genus-species binomials by exact sequence containment.

    reference: assignSpecies (R/taxonomy.R:240-289). A query "hits" a
    reference when it occurs as an exact substring (vcountPDict
    semantics)."""
    import pandas as pd

    from .encode import is_acgt
    from .seqtab import get_sequences

    if isinstance(allowMultiple, bool):
        keep = np.inf if allowMultiple else 1
    else:
        keep = int(allowMultiple)
    seqs = get_sequences(seqs)
    if not all(is_acgt(seqs)):
        raise ValueError("Non-ACGT characters present in the query "
                         "sequences.")
    ids, refs = read_fasta(refFasta)
    if not len(ids[0].split()) >= 3:
        if ids[0].count(";") >= 3:
            raise ValueError(
                "Incorrect reference file format for assignSpecies (this "
                "looks like a file formatted for assignTaxonomy).")
        raise ValueError("Incorrect reference file format for "
                         "assignSpecies.")
    genus = [i.split()[1] for i in ids]
    species = [i.split()[2] for i in ids]

    gen_out = []
    spec_out = []
    hits = _containment_hits(list(seqs), refs)
    if tryRC:
        rc_hits = _containment_hits([rc(s) for s in seqs], refs)
        for h, hr in zip(hits, rc_hits):
            h |= hr
    for qi, s in enumerate(seqs):
        idx = sorted(hits[qi])
        gen_out.append(_map_hits(idx, genus, 1))
        spec_out.append(_map_hits(idx, species, keep))
    out = pd.DataFrame({"Genus": gen_out, "Species": spec_out}, index=seqs)
    if verbose:
        print(f"{sum(x is not None for x in spec_out)} out of {len(seqs)} "
              "were assigned to the species level.")
    return out


def match_genera(gen_tax: Optional[str], gen_binom: Optional[str],
                 split_glyph: str = "/") -> bool:
    """reference: matchGenera (R/taxonomy.R:175-185)."""
    if not isinstance(gen_tax, str) or not isinstance(gen_binom, str):
        return False  # None / NaN
    if not gen_tax or not gen_binom:
        return False
    if gen_tax == gen_binom:
        return True
    if re.search(f"^{re.escape(gen_binom)}[ _{re.escape(split_glyph)}]",
                 gen_tax):
        return True
    if re.search(f"{re.escape(split_glyph)}{re.escape(gen_binom)}$",
                 gen_tax):
        return True
    return False


def add_species(taxtab, refFasta: str,
                allowMultiple: Union[bool, int] = False,
                tryRC: bool = False, n: int = 2000,
                verbose: bool = False):
    """Append a Species column by exact matching where genera agree.

    reference: addSpecies (R/taxonomy.R:347-360)."""
    import pandas as pd

    seqs = list(taxtab.index)
    binom = assign_species(seqs, refFasta, allowMultiple=allowMultiple,
                           tryRC=tryRC, n=n, verbose=verbose)
    gcol = "Genus" if "Genus" in taxtab.columns else taxtab.columns[-1]
    out = taxtab.copy()
    species = []
    nmatch = 0
    for s in seqs:
        g_tax = out.loc[s, gcol]
        g_bin = binom.loc[s, "Genus"]
        if match_genera(g_tax, g_bin):
            species.append(binom.loc[s, "Species"])
            if binom.loc[s, "Species"] is not None:
                nmatch += 1
        else:
            species.append(None)
    out["Species"] = species
    if verbose:
        print(f"Of which {nmatch} had genera consistent with the input "
              "table.")
    return out
