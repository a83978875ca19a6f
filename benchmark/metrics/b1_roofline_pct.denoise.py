"""Kernel B1's share of its roofline, in percent: the cells of every pair
DADA2 aligns in the traced window's compares (each compare's uniques that pass
the k-mer screen against its center, KMER_SIZE 5 at its cutoff, less the
pairs the gapless screen settles; worked out here from the compare's
inputs, which the driver records), at the compare's band, at the card's
int32 peak (roofline.py), over the device time of the B1 launches
(nw_compare_kernel<RPT, 1>) made inside the program's compare calls (the
backend.compare span) in the traced window. B1 launched elsewhere (the
final tallies, on an evicted center) is neither counted nor timed."""
from collections import Counter

import numpy as np


def read(run):
    import torch

    from reference.seqs import kmer_counts, kmer_ords
    from roofline import share_pct, total_cells

    comps = getattr(run.ctx, "compares", None)
    if not comps:
        return None
    dev = torch.device(run.ctx.device)
    tables = {}
    by_band = {}
    for c in comps:
        key = id(c.seqs)
        if key not in tables:
            kord = kmer_ords(c.seqs, c.lens)
            tables[key] = (torch.from_numpy(kmer_counts(kord)).to(dev),
                           torch.from_numpy(kord).to(dev),
                           torch.from_numpy(c.lens.astype(np.int64)).to(dev))
        K, O, L = tables[key]
        cand = ~torch.from_numpy(c.skip).to(dev)
        if c.use_kmers:
            minsum = torch.minimum(K, K[c.center]).sum(1)
            den = (torch.minimum(L, L[c.center]) - 4).double()
            cand &= ~(1.0 - minsum.double() / den > c.cutoff)
            if c.gapless:
                pos = torch.arange(O.shape[1], device=dev)[None, :]
                same = ((O == O[c.center]) & (pos < (den.long())[:, None])
                        ).sum(1)
                cand &= same != minsum
        if c.band == 0:
            continue
        lj = L[cand]
        vals, n = torch.unique(lj, return_counts=True)
        cnt = by_band.setdefault(c.band, Counter())
        l0 = int(c.lens[c.center])
        for v, k in zip(vals.tolist(), n.tolist()):
            cnt[(l0, v)] += k
    cells = sum(total_cells(cnt, band) for band, cnt in by_band.items())
    return share_pct(run, cells, r"nw_compare_kernel<\s*\d+\s*,\s*1\s*>",
                     within="backend.compare")
