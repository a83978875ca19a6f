"""Time kernel B2's per-launch work on the chimera route, for comparing
two checkouts of this repo on one card.

    python3 ab_b2.py [ROOT] [--reps N]

ROOT (default: this script's directory) is a checkout whose
dada2_tpu_torch is imported. The inputs are the first full launch (1024
blocks of 128 pairs) of the consensus chimera check on chip_smoke.py's
5000 ASVs x 20 samples table (seed 7), built by ROOT's own route code.
Timed with CUDA events, N launches per reading (default 10), in turns:
  - route: what ROOT's chimera route runs per launch: the stats kernel
    (nw_pairs_stats) where ROOT has it, else the class-row kernel
    (nw_wavefront, emit_kinds="cls") followed by the torch scans
    _lr_accum_pairs and the ends' OR;
  - cls: the class-row kernel alone.
Prints the card's nvidia-smi name and power limit, then one JSON line
with the readings and a checksum of the route's [pairs, 6] statistics,
equal between two checkouts that compute the same statistics. Needs a
CUDA card.
"""
from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def main(argv) -> int:
    reps = 10
    if "--reps" in argv:
        k = argv.index("--reps")
        reps = int(argv[k + 1])
        argv = argv[:k] + argv[k + 2:]
    root = os.path.abspath(argv[0]) if argv else HERE
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("ab_b2: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from chip_smoke import chimera_fixture, cuda_ms

    sys.path.insert(0, root)
    from dada2_tpu_torch import chimeras as chim
    from dada2_tpu_torch.ops import nw_wavefront as nww
    from dada2_tpu_torch.options import current_options

    if not os.path.dirname(nww.__file__).startswith(root):
        print(f"ab_b2: imported {nww.__file__}, not from {root}",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    nww.build_kernel()
    dev = torch.device("cuda", 0)
    mat, seqs = chimera_fixture()
    pairs = chim._table_pairs(mat, 1.5, 2)
    qi = np.ascontiguousarray(pairs[:, 0])
    pi = np.ascontiguousarray(pairs[:, 1])
    opts = current_options()
    be, bopts = chim._chimera_backend(seqs, opts.MATCH, opts.MISMATCH,
                                      opts.GAP_PENALTY, 16, dev)
    plan = chim._pairs_plan(be, bopts, qi, pi)
    args = chim._pairs_launch_inputs(be, plan, 0, chim.CH_BLOCKS)
    g = dict(L1R=plan.L1R, L2R=plan.L2R, NDP=plan.NDP, WP=plan.WP,
             match=bopts.MATCH, mismatch=bopts.MISMATCH,
             gap_p=bopts.GAP_PENALTY)

    def cls():
        return nww.nw_wavefront(*args, emit_kinds="cls", s1_per_block=True,
                                **g)

    if hasattr(nww, "nw_pairs_stats"):
        kind = "stats kernel"

        def route():
            return nww.nw_pairs_stats(*args, allow_one_off=False,
                                      max_shift=16, **g)
    else:
        kind = "class rows + torch scans"

        def route():
            cls_b, _sub, _mapq, end_b = cls()
            rows = cls_b.permute(0, 2, 1).reshape(-1, plan.NDP)
            ends = end_b.permute(0, 2, 1).reshape(-1, 8)
            stats = chim._lr_accum_pairs(rows, allow_one_off=False,
                                         max_shift=16)
            ok = (ends[:, 0] | ends[:, 1]).to(stats.dtype)
            return torch.cat([stats, ok[:, None]], 1).to(torch.int32)

    got = route().cpu().numpy().astype(np.int64)
    checksum = hashlib.sha256(got.tobytes()).hexdigest()[:16]
    t_route = [cuda_ms(route, reps)]
    t_cls = [cuda_ms(cls, reps), cuda_ms(cls, reps)]
    t_route.append(cuda_ms(route, reps))
    print(json.dumps({
        "root": root, "route": kind, "blocks": chim.CH_BLOCKS,
        "WP": plan.WP, "NDP": plan.NDP, "reps": reps,
        "route_ms": t_route, "cls_kernel_ms": t_cls,
        "stats_sha256_16": checksum,
        "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
