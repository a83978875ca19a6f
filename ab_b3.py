"""Time kernel B3 (the kinds mode of the wavefront kernel) of a checkout of
this repo on one card, for comparing two checkouts.

    python3 ab_b3.py [ROOT] [--reps N] [--sweep] [--floor]

ROOT (default: this script's directory) is a checkout whose
dada2_tpu_torch is imported. Three B3 launches (emit_kinds=True), their
inputs built by ROOT's own code the way chip_smoke.py builds them:
  - phase 8: chip_smoke.py phase 8's, nw_wavefront_grouped's inputs for
    sam1F's most abundant unique against its 896 uniques (band 16);
  - phase 5: kernel B1's shape in chip_smoke.py phase 5 (the most abundant
    unique of its simulated 120,000-read sample, seed 42, against its
    most-populated window bucket), run with the kinds rows;
  - samPB: tests/extdata/samPB.fastq.gz at BAND_SIZE=32, its most abundant
    unique against its most-populated window bucket.
Each is timed with CUDA events, N launches per reading (default 20), two
readings apart, with its pairs per block P, its bound (chip_smoke.bound:
bytes at the HBM rate against the in-band cells' int32 operations) and a
checksum of its (kinds, sub, mapq, end), equal between two checkouts that
compute the same alignments. --sweep (a checkout whose mode 3 takes a
pairs per block and whose compare_blocks_per_sm takes the mode) also
times every P at each shape, with its blocks per SM and whether its
outputs equal the default's. --floor runs sass_fill.py on ROOT's kernel
source and prints phase 8's latency floor: for each block, the longest
pair's diagonals times the fill's SASS instructions a diagonal (its
fastest fill loop) plus its longest traceback's steps times the
traceback loop's instructions, at one instruction a cycle for the warp at
the card's largest SM clock (nvidia-smi clocks.max.sm); the largest over
the blocks. Prints the card's nvidia-smi name and power limit, then one
JSON line. Needs a CUDA card.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def b3_sass(root: str):
    """{"fill": SASS instructions a diagonal, "traceback": instructions a
    step} of B3's one-row-per-thread instantiation in root's kernel source
    (sass_fill.py's report; nw_compare_kernel<1, 3>, nw_compare_kernel<1,
    true> or an older checkout's nw_wavefront_kernel<1, false, 1>)."""
    out_dir = os.path.join(root, "build", "sass_b3")
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "sass_fill.py"),
         os.path.join(root, "dada2_tpu_torch", "csrc", "nw_wavefront.cu"),
         "--out", out_dir], capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"sass_fill.py failed: {proc.stderr}")
    fill, tb, inside = [], [], False
    for line in proc.stdout.splitlines():
        if not line.startswith("  "):
            inside = bool(re.search(r"nw_compare_kernel<1, (3|true)>|"
                                    r"nw_wavefront_kernel<1, false, 1>",
                                    line))
            continue
        if not inside:
            continue
        m = re.search(r"fill loop .*; ([\d.]+) per diagonal", line)
        if m:
            fill.append(float(m.group(1)))
        m = re.search(r"traceback loop at line \d+: (\d+) instructions", line)
        if m:
            tb.append(int(m.group(1)))
    if not fill or not tb:
        raise RuntimeError("B3's fill or traceback loop not found in "
                           "sass_fill.py's report:\n" + proc.stdout)
    return {"fill": min(fill), "traceback": min(tb), "report": proc.stdout}


def main(argv) -> int:
    reps, sweep, floor = 20, "--sweep" in argv, "--floor" in argv
    argv = [a for a in argv if a not in ("--sweep", "--floor")]
    if "--reps" in argv:
        k = argv.index("--reps")
        reps = int(argv[k + 1])
        argv = argv[:k] + argv[k + 2:]
    root = os.path.abspath(argv[0]) if argv else HERE
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("ab_b3: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from chip_smoke import (SAM1F, SAMPB, b1_bucket_inputs, bound, cuda_ms,
                            simulate_sample)

    sys.path.insert(0, root)
    import dada2_tpu_torch as dt
    from dada2_tpu_torch.core.backend_cuda import CudaBackend
    from dada2_tpu_torch.core.raws import make_rawset
    from dada2_tpu_torch.encode import pack_sequences
    from dada2_tpu_torch.ops import nw_wavefront as nww
    from dada2_tpu_torch.options import DEFAULT_OPTIONS

    if not os.path.dirname(nww.__file__).startswith(root):
        print(f"ab_b3: imported {nww.__file__}, not from {root}",
              file=sys.stderr)
        return 1
    card = smi("name,power.limit")
    print(card, flush=True)
    nww.build_kernel()
    dev = torch.device("cuda", 0)

    # phase 8: sam1F's most abundant unique against its uniques
    drp = dt.derep_fastq(SAM1F)
    codes, lens = pack_sequences(drp.sequences)
    _, arrays, ggeom = nww.grouped_inputs(codes[0], int(lens[0]), codes,
                                          lens, 16)
    g8 = [torch.from_numpy(a).to(dev) for a in arrays]
    geom8 = dict(ggeom, match=5, mismatch=-4, gap_p=-8)
    # phase 5's B1 bucket: the simulated sample of chip_smoke.py phase 5
    err41 = dt.data.tperr1()
    res = dt.dada(drp, err=err41, device="cuda", verbose=False)
    err = np.hstack([err41] + [err41[:, -1:]] * 10)
    sim = simulate_sample(
        np.random.default_rng(42), dt.Derep, pack_sequences, res.sequence,
        np.array([res.denoised[s] for s in res.sequence], float),
        res.quality, err, 120_000, "sim0")
    rs = make_rawset(sim.sequences, sim.abundances, None, sim.quals)
    args5, geom5, scal5, params5 = b1_bucket_inputs(
        nww, CudaBackend(rs, device=dev), DEFAULT_OPTIONS.normalized(), dev)
    drp_pb = dt.derep_fastq(SAMPB)
    rs_pb = make_rawset(drp_pb.sequences, drp_pb.abundances, None,
                        drp_pb.quals)
    args_pb, geom_pb, scal_pb, params_pb = b1_bucket_inputs(
        nww, CudaBackend(rs_pb, device=dev),
        DEFAULT_OPTIONS.replace(BAND_SIZE=32).normalized(), dev)
    shapes = {"phase 8": (g8, geom8, arrays[0], arrays[1]),
              "phase 5": (args5, geom5, scal5, params5),
              "samPB": (args_pb, geom_pb, scal_pb, params_pb)}

    def run(a, g):
        return nww.nw_wavefront(*a, emit_kinds=True, **g)

    out, kinds8 = {}, None
    for name, (a, g, scal, params) in shapes.items():
        got = run(a, g)
        torch.cuda.synchronize()
        if name == "phase 8":
            kinds8 = got[0].cpu().numpy()
        blob = b"".join(x.cpu().numpy().astype(np.int32).tobytes()
                        for x in got)
        nb = a[0].shape[0]
        b_ms, b_by, detail = bound(a, got, scal, params)
        out[name] = dict(blocks=nb, WP=g["WP"], NDP=g["NDP"], L1R=g["L1R"],
                         P=nww.pairs_per_block(g["L1R"], g["L2R"], g["NDP"],
                                               g["WP"], 3, nb),
                         bound_ms=b_ms, bound_by=b_by, bound_detail=detail,
                         sha256_16=hashlib.sha256(blob).hexdigest()[:16],
                         ms=[cuda_ms(lambda: run(a, g), reps)])
    for name, (a, g, _, _) in shapes.items():
        out[name]["ms"].append(cuda_ms(lambda: run(a, g), reps))

    swept = {}
    if sweep:
        lib = nww._load()
        stream = torch.cuda.current_stream(dev).cuda_stream

        def launch(a, g, P):
            nb = a[3].shape[0]
            o = [torch.empty((nb, rows, nww.LANES), dtype=torch.int32,
                             device=dev)
                 for rows in (g["NDP"], g["L2R"], g["L1R"], 8)]
            rc = lib.nw_wavefront_run(
                *(x.data_ptr() for x in a), *(x.data_ptr() for x in o), nb,
                g["L1R"], g["L2R"], g["NDP"], g["WP"], 3, g["match"],
                g["mismatch"], g["gap_p"], P, stream)
            if rc != 0:
                raise RuntimeError(f"B3 launch with P={P} failed: {rc}")
            return o

        for name, (a, g, _, _) in shapes.items():
            want = run(a, g)
            row = {}
            for P in (1, 2, 4, 8, 16, 32):
                bps = nww.compare_blocks_per_sm(g["L1R"], g["L2R"], g["NDP"],
                                                g["WP"], P, 3)
                if bps == 0:
                    row[P] = dict(blocks_per_sm=0)
                    continue
                got = launch(a, g, P)
                torch.cuda.synchronize()
                same = all(torch.equal(x, y) for x, y in zip(got, want))
                row[P] = dict(blocks_per_sm=bps, equal=same,
                              ms=cuda_ms(lambda: launch(a, g, P), reps))
            swept[name] = row

    floor_row = None
    if floor:
        sass = b3_sass(root)
        clock_mhz = float(smi("clocks.max.sm").split()[0])
        scal = arrays[0].astype(np.int64)
        l2 = arrays[1][:, 0].astype(np.int64)              # [nb, 128]
        diag = scal[:, :1] + l2                            # len1 + len2
        steps = (kinds8 != 0).sum(axis=1)                  # [nb, 128]
        cycles = (diag.max(axis=1) * sass["fill"]
                  + steps.max(axis=1) * sass["traceback"])
        nsm = torch.cuda.get_device_properties(0).multi_processor_count
        P8 = out["phase 8"]["P"]
        floor_row = dict(
            fill_sass_per_diagonal=sass["fill"],
            traceback_sass_per_step=sass["traceback"],
            diagonals=int(diag.max()), traceback_steps=int(steps.max()),
            clock_mhz=clock_mhz, warps_per_sm=scal.shape[0] * 128 / nsm,
            P=P8, floor_ms=float(cycles.max()) / (clock_mhz * 1e3))
        print(sass["report"], flush=True)
    print(json.dumps({"root": root, "card": card, "reps": reps,
                      "device": torch.cuda.get_device_name(0),
                      "shapes": out, "sweep": swept, "floor": floor_row}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
