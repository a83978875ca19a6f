"""Time kernel B1 (the compare sweep's kernel) of a checkout of this repo on
one card, for comparing two checkouts.

    python3 ab_b1.py [ROOT] [--reps N] [--sweep]

ROOT (default: this script's directory) is a checkout whose
dada2_tpu_torch is imported. Three B1 launches, their inputs built by
ROOT's own backend code the way chip_smoke.py builds them:
  - main: chip_smoke.py phase 5's shapes: the most abundant unique of its
    simulated 120,000-read sample (seed 42, drawn from the ASVs of sam1F's
    dada() on the card) against its most-populated window bucket;
  - one block: the first block of those inputs;
  - samPB: tests/extdata/samPB.fastq.gz at BAND_SIZE=32, its most abundant
    unique against its most-populated window bucket.
Each is timed with CUDA events, N launches per reading (default 20), two
readings apart, with a checksum of its (sub, mapq, end), equal between two
checkouts that compute the same alignments. --sweep (a checkout whose
nw_wavefront_run takes B1's pairs per block) also times every pairs per
block P at each shape, with its blocks per SM and whether its outputs
equal the default choice's. Prints the card's nvidia-smi name and power
limit, then one JSON line. Needs a CUDA card.
"""
from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def main(argv) -> int:
    reps, sweep = 20, "--sweep" in argv
    argv = [a for a in argv if a != "--sweep"]
    if "--reps" in argv:
        k = argv.index("--reps")
        reps = int(argv[k + 1])
        argv = argv[:k] + argv[k + 2:]
    root = os.path.abspath(argv[0]) if argv else HERE
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("ab_b1: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from chip_smoke import (SAM1F, SAMPB, b1_bucket_inputs, cuda_ms,
                            simulate_sample)

    sys.path.insert(0, root)
    import dada2_tpu_torch as dt
    from dada2_tpu_torch.core.backend_cuda import CudaBackend
    from dada2_tpu_torch.core.raws import make_rawset
    from dada2_tpu_torch.encode import pack_sequences
    from dada2_tpu_torch.ops import nw_wavefront as nww
    from dada2_tpu_torch.options import DEFAULT_OPTIONS

    if not os.path.dirname(nww.__file__).startswith(root):
        print(f"ab_b1: imported {nww.__file__}, not from {root}",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    nww.build_kernel()
    dev = torch.device("cuda", 0)

    # the simulated sample of chip_smoke.py phase 5
    err41 = dt.data.tperr1()
    res = dt.dada(dt.derep_fastq(SAM1F), err=err41, device="cuda",
                  verbose=False)
    err = np.hstack([err41] + [err41[:, -1:]] * 10)
    sim = simulate_sample(
        np.random.default_rng(42), dt.Derep, pack_sequences, res.sequence,
        np.array([res.denoised[s] for s in res.sequence], float),
        res.quality, err, 120_000, "sim0")
    rs = make_rawset(sim.sequences, sim.abundances, None, sim.quals)
    args, geom, _, _ = b1_bucket_inputs(
        nww, CudaBackend(rs, device=dev), DEFAULT_OPTIONS.normalized(), dev)
    drp = dt.derep_fastq(SAMPB)
    rs_pb = make_rawset(drp.sequences, drp.abundances, None, drp.quals)
    pb_args, pb_geom, _, _ = b1_bucket_inputs(
        nww, CudaBackend(rs_pb, device=dev),
        DEFAULT_OPTIONS.replace(BAND_SIZE=32).normalized(), dev)
    shapes = {
        "main": (args, geom),
        "one block": ((args[0][:1], args[1][:1], args[2],
                       args[3][:1].contiguous()), geom),
        "samPB": (pb_args, pb_geom),
    }

    def pairs(g, nb):
        try:
            return nww.pairs_per_block(g["L1R"], g["L2R"], g["NDP"],
                                       g["WP"], 1, nb)
        except TypeError:   # a checkout whose fit ignores the launch size
            return nww.pairs_per_block(g["L1R"], g["L2R"], g["NDP"],
                                       g["WP"])

    out = {}
    for name, (a, g) in shapes.items():
        got = nww.nw_compare(*a, **g)
        torch.cuda.synchronize()
        blob = b"".join(x.cpu().numpy().astype(np.int32).tobytes()
                        for x in got)
        nb = a[0].shape[0]
        out[name] = dict(blocks=nb, WP=g["WP"], NDP=g["NDP"], L1R=g["L1R"],
                         P=pairs(g, nb),
                         sha256_16=hashlib.sha256(blob).hexdigest()[:16],
                         ms=[cuda_ms(lambda: nww.nw_compare(*a, **g), reps)])
    for name, (a, g) in shapes.items():
        out[name]["ms"].append(cuda_ms(lambda: nww.nw_compare(*a, **g),
                                       reps))

    swept = {}
    if sweep:
        lib = nww._load()
        stream = torch.cuda.current_stream(dev).cuda_stream

        def launch(a, g, P):
            nb = a[3].shape[0]
            o = [torch.empty((nb, rows, nww.LANES), dtype=torch.int32,
                             device=dev) for rows in (g["L2R"], g["L1R"], 8)]
            rc = lib.nw_wavefront_run(
                *(x.data_ptr() for x in a), None, *(x.data_ptr() for x in o),
                nb, g["L1R"], g["L2R"], g["NDP"], g["WP"], 1, g["match"],
                g["mismatch"], g["gap_p"], P, stream)
            if rc != 0:
                raise RuntimeError(f"B1 launch with P={P} failed: {rc}")
            return o

        for name, (a, g) in shapes.items():
            want = nww.nw_compare(*a, **g)
            row = {}
            for P in (1, 2, 4, 8, 16, 32):
                bps = nww.compare_blocks_per_sm(g["L1R"], g["L2R"], g["NDP"],
                                                g["WP"], P)
                if bps == 0:
                    row[P] = dict(blocks_per_sm=0)
                    continue
                got = launch(a, g, P)
                torch.cuda.synchronize()
                same = all(torch.equal(x, y) for x, y in zip(got, want))
                row[P] = dict(blocks_per_sm=bps, equal=same,
                              ms=cuda_ms(lambda: launch(a, g, P), reps))
            swept[name] = row
    print(json.dumps({"root": root, "card": card, "reps": reps,
                      "device": torch.cuda.get_device_name(0),
                      "shapes": out, "sweep": swept}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
