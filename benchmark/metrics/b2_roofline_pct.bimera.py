"""Kernel B2 stats' share of its roofline, in percent: the cells of every
(query, parent) pair that the table's consensus rule admits (worked out
here from the table, reference/bimera_ref.py::table_pairs), aligned at
band maxShift, at the card's int32 peak (roofline.py), over the device
time of nw_wavefront_kernel in the traced window."""
from collections import Counter

import numpy as np


def read(run):
    from reference.bimera_ref import DEFAULTS, table_pairs
    from roofline import share_pct, total_cells

    ctx = run.ctx
    o = dict(DEFAULTS, **{k: v for k, v in ctx.config["chimera"].items()
                          if k != "method"})
    pairs = table_pairs(np.asarray(ctx.inputs["counts"]),
                        o["minFoldParentOverAbundance"],
                        o["minParentAbundance"])
    lens = np.array([len(s) for s in ctx.inputs["seqs"]])
    a, b = lens[pairs[:, 0]], lens[pairs[:, 1]]
    keys, n = np.unique(np.stack([a, b], 1), axis=0, return_counts=True)
    per_table = total_cells(Counter({(int(x), int(y)): int(c)
                                     for (x, y), c in zip(keys, n)}),
                            o["maxShift"])
    return share_pct(run, per_table * run.traced_steps,
                     r"nw_wavefront_kernel<")
