"""Time kernel B2 (the class-row kernel and the chimera route's stats
kernel) of a checkout of this repo on one card, for comparing two
checkouts.

    python3 ab_b2.py [ROOT] [--reps N] [--sweep] [--sass]

ROOT (default: this script's directory) is a checkout whose
dada2_tpu_torch is imported. Two class-row launches (nw_wavefront,
emit_kinds="cls", s1_per_block=True), their inputs built the way
chip_smoke.py builds them:
  - phase 10: the first full launch (1024 blocks of 128 pairs) of the
    consensus chimera check on chip_smoke.py's 5000 ASVs x 20 samples
    table (seed 7), built by ROOT's own route code;
  - 1450 nt: chip_smoke.py phase 3b's PacBio full-length case, two blocks
    of 1,450- and 1,447-nt queries (128 and 100 pairs) against mutated
    copies at a 64-row window (chip_smoke.pairs_case, seed 1450).
Each is timed with CUDA events, N launches per reading (default 10), two
readings apart, with its pairs per block P, blocks per SM (0 where ROOT's
class-row kernel is not an instantiation of nw_compare_kernel), its bound
(chip_smoke.bound: bytes at the HBM rate against the in-band cells' int32
operations) and a checksum of its (cls, sub, mapq, end), equal between
two checkouts that compute the same alignments. Between the readings, in
turns, what ROOT's chimera route runs per launch at phase 10's shape: the
stats kernel (nw_pairs_stats) where ROOT has it, else the class-row kernel
followed by the torch scans _lr_accum_pairs and the ends' OR, with a
checksum of its [pairs, 6] statistics. --sweep (a checkout whose mode 2
takes a pairs per block) also times every P at each shape, with its
blocks per SM and whether its outputs equal the default's. --sass runs
sass_fill.py on ROOT's kernel source and prints the fill's SASS
instructions a diagonal and the traceback loop's instructions a step of
the one-row-per-thread instantiations of B1, B2's class rows and B3.
Prints the card's nvidia-smi name and power limit, then one JSON line.
Needs a CUDA card.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

# the one-row-per-thread instantiations, as sass_fill.py names them: this
# tree's nw_compare_kernel<1, MODE>, or an older checkout's bool B3 variant
# and its class rows in the generic body
SASS_KERNELS = {
    "B1": r"nw_compare_kernel<1, (1|false)>",
    "B2 class rows": r"nw_compare_kernel<1, 2>|nw_wavefront_kernel<1, 2>",
    "B3": r"nw_compare_kernel<1, (3|true)>",
    "B2 stats": r"nw_wavefront_kernel<1(, 3)?>",
}


def smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def sass_counts(root: str):
    """{kernel: {"fill": SASS instructions a diagonal, "traceback":
    instructions a step}} of SASS_KERNELS in root's kernel source (the
    smallest loop of each region in sass_fill.py's report), and the
    report."""
    out_dir = os.path.join(root, "build", "sass_b2")
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "sass_fill.py"),
         os.path.join(root, "dada2_tpu_torch", "csrc", "nw_wavefront.cu"),
         "--out", out_dir], capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"sass_fill.py failed: {proc.stderr}")
    found, cur = {}, None
    for line in proc.stdout.splitlines():
        if not line.startswith("  "):
            name = line.split("(")[0].replace("void ", "")
            cur = next((k for k, pat in SASS_KERNELS.items()
                        if re.fullmatch(pat, name)), None)
            if cur:
                found[cur] = {"fill": [], "traceback": []}
            continue
        if not cur:
            continue
        m = re.search(r"fill loop .*; ([\d.]+) per diagonal", line)
        if m:
            found[cur]["fill"].append(float(m.group(1)))
        m = re.search(r"traceback loop at line \d+: (\d+) instructions", line)
        if m:
            found[cur]["traceback"].append(int(m.group(1)))
    return {k: {r: min(v) if v else None for r, v in d.items()}
            for k, d in found.items()}, proc.stdout


def main(argv) -> int:
    reps, sweep, sass = 10, "--sweep" in argv, "--sass" in argv
    argv = [a for a in argv if a not in ("--sweep", "--sass")]
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
    from chip_smoke import bound, chimera_fixture, cuda_ms, pairs_case

    sys.path.insert(0, root)
    from dada2_tpu_torch import chimeras as chim
    from dada2_tpu_torch.ops import nw_wavefront as nww
    from dada2_tpu_torch.options import current_options

    if not os.path.dirname(nww.__file__).startswith(root):
        print(f"ab_b2: imported {nww.__file__}, not from {root}",
              file=sys.stderr)
        return 1
    card = smi("name,power.limit")
    print(card, flush=True)
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
    arrays_pb, g_pb = pairs_case(np.random.default_rng(1450), nww,
                                 [(1450, 128, 30, False),
                                  (1447, 100, 30, False)], 16, 64)
    args_pb = [torch.from_numpy(a).to(dev) for a in arrays_pb]
    shapes = {"phase 10": (args, g), "1450 nt": (args_pb, g_pb)}
    ckw = dict(emit_kinds="cls", s1_per_block=True)

    def cls(a, geom):
        return nww.nw_wavefront(*a, **ckw, **geom)

    if hasattr(nww, "nw_pairs_stats"):
        kind = "stats kernel"

        def route():
            return nww.nw_pairs_stats(*args, allow_one_off=False,
                                      max_shift=16, **g)
    else:
        kind = "class rows + torch scans"

        def route():
            cls_b, _sub, _mapq, end_b = cls(args, g)
            rows = cls_b.permute(0, 2, 1).reshape(-1, plan.NDP)
            ends = end_b.permute(0, 2, 1).reshape(-1, 8)
            stats = chim._lr_accum_pairs(rows, allow_one_off=False,
                                         max_shift=16)
            ok = (ends[:, 0] | ends[:, 1]).to(stats.dtype)
            return torch.cat([stats, ok[:, None]], 1).to(torch.int32)

    got = route().cpu().numpy().astype(np.int64)
    checksum = hashlib.sha256(got.tobytes()).hexdigest()[:16]
    out = {}
    for name, (a, geom) in shapes.items():
        got = cls(a, geom)
        torch.cuda.synchronize()
        blob = b"".join(x.cpu().numpy().astype(np.int32).tobytes()
                        for x in got)
        nb = a[0].shape[0]
        P = nww.pairs_per_block(geom["L1R"], geom["L2R"], geom["NDP"],
                                geom["WP"], 2, nb)
        b_ms, b_by, detail = bound(a, got, a[0].cpu().numpy(),
                                   a[1].cpu().numpy())
        del got
        out[name] = dict(
            blocks=nb, WP=geom["WP"], NDP=geom["NDP"], L1R=geom["L1R"],
            L2R=geom["L2R"], P=P, blocks_per_sm=nww.compare_blocks_per_sm(
                geom["L1R"], geom["L2R"], geom["NDP"], geom["WP"], P, 2),
            bound_ms=b_ms, bound_by=b_by, bound_detail=detail,
            sha256_16=hashlib.sha256(blob).hexdigest()[:16],
            ms=[cuda_ms(lambda: cls(a, geom), reps)])
    t_route = [cuda_ms(route, reps), cuda_ms(route, reps)]
    for name, (a, geom) in shapes.items():
        out[name]["ms"].append(cuda_ms(lambda: cls(a, geom), reps))

    swept = {}
    if sweep:
        lib = nww._load()
        stream = torch.cuda.current_stream(dev).cuda_stream

        def launch(a, geom, P):
            nb = a[3].shape[0]
            o = [torch.empty((nb, rows, nww.LANES), dtype=torch.int32,
                             device=dev)
                 for rows in (geom["NDP"], geom["L2R"], geom["L1R"], 8)]
            rc = lib.nw_wavefront_run(
                *(x.data_ptr() for x in a), *(x.data_ptr() for x in o), nb,
                geom["L1R"], geom["L2R"], geom["NDP"], geom["WP"], 2,
                geom["match"], geom["mismatch"], geom["gap_p"], P, stream)
            if rc != 0:
                raise RuntimeError(f"B2 launch with P={P} failed: {rc}")
            return o

        for name, (a, geom) in shapes.items():
            want = cls(a, geom)
            row = {}
            for P in (1, 2, 4, 8, 16, 32):
                bps = nww.compare_blocks_per_sm(
                    geom["L1R"], geom["L2R"], geom["NDP"], geom["WP"], P, 2)
                if bps == 0:
                    row[P] = dict(blocks_per_sm=0)
                    continue
                got = launch(a, geom, P)
                torch.cuda.synchronize()
                same = all(torch.equal(x, y) for x, y in zip(got, want))
                del got
                row[P] = dict(blocks_per_sm=bps, equal=same,
                              ms=cuda_ms(lambda: launch(a, geom, P), reps))
            del want
            swept[name] = row

    sass_row = None
    if sass:
        sass_row, report = sass_counts(root)
        print(report, flush=True)
    print(json.dumps({"root": root, "card": card, "reps": reps,
                      "device": torch.cuda.get_device_name(0),
                      "shapes": out, "route": kind, "route_ms": t_route,
                      "stats_sha256_16": checksum, "sweep": swept,
                      "sass": sass_row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
