"""Time kernel B4 (the batch aligner) of a checkout of this repo on one card,
for comparing two checkouts.

    python3 ab_b4.py [ROOT] [--reps N]

ROOT (default: this script's directory) is a checkout whose
dada2_tpu_torch is imported. Three B4 calls, their inputs made here from
seeds and in-repo data, the same for every checkout:
  - merge: chip_smoke.py phase 14's merge shapes: 4,096 pairs of F = 240 nt
    against rc(R) = 200 nt cut from the chimera fixture's ASVs with seeded
    substitutions, scoring (1, -64, -64), scalar aligner, no band
    (merge_pairs' configuration);
  - shift: one 4,096-pair chunk of is_shift_denovo on the fixture's first
    500 ASVs: unbanded 250 x 250 pairs, scalar aligner, dada2's default
    scoring (5, -4, -8);
  - samPB: tests/extdata/samPB.fastq.gz's most abundant unique against
    each of its 259 uniques (full-length PacBio 16S, ~1,450 nt), scalar
    aligner with homopolymer gaps -1 at BAND_SIZE=32 (dada's 454 / Ion
    Torrent / PacBio homopolymer configuration);
  - merge_whole: merge_pairs' alignments of 4,096 whole 2 x 300 read pairs
    of 460-nt V3-V4 amplicons cut from tests/extdata/ten_16s.100.fa.gz
    (chip_smoke.py merge_whole_reads), scoring (1, -64, -64), scalar, no
    band: windows of 301 rows;
  - shift_v34: the first 4,096-pair chunk of is_shift_denovo on 500 such
    amplicons (chip_smoke.py shift_v34_uniques), (5, -4, -8), scalar, no
    band: windows of ~461 rows;
  - shift_pb: is_shift_denovo's 2,016 pairs of samPB's 64 most abundant
    uniques (chip_smoke.py shift_pb_uniques), one chunk: windows of
    ~1,460 rows.
The last three take the wide body where the checkout has one (windows
over 256 rows), the one-block-per-pair body in a checkout without it.
Each is timed two ways, N calls per reading (default 10), two readings
apart: the call (CUDA events around nw_batch, its host work included) and
the kernel (the device time of B4's kernels under torch.profiler, per
call; null where the profiler missed a launch), and, for a checkout that
has ops/nw_batch.py::_launch, its launches alone (CUDA events around
launches of a batch prepared once); with a checksum of its
six outputs (kinds, p0, p1, ham, tvec, ok), equal between two checkouts
that compute the same alignments, and, where the checkout reports them,
the body that served it, its rows per thread and pairs per block. Prints
the card's nvidia-smi name and power limit, then one JSON line. Needs a
CUDA card. For parent against change, unpack the parent with `git
archive` into a git-ignored directory and run parent, change, change,
parent in one command.
"""
from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def shapes(np, pack_sequences, rc, derep_fastq):
    """{name: (s1, len1, s2, len2, keywords)} as numpy arrays."""
    sys.path.insert(0, HERE)
    import dada2_tpu_torch as dt
    from chip_smoke import (SAMPB, chimera_fixture, merge_whole_reads,
                            shift_pairs, shift_pb_uniques, shift_v34_uniques)

    _, seqs = chimera_fixture()
    rng = np.random.default_rng(14)
    fwd, rev = [], []
    for s in seqs[:4096]:
        f, r = list(s[:240]), list(s[50:])
        for x in (f, r):
            for _ in range(2):
                x[int(rng.integers(0, len(x)))] = "ACGT"[rng.integers(4)]
        fwd.append("".join(f))
        rev.append(rc("".join(r)))
    m1, l1 = pack_sequences(fwd)
    m2, l2 = pack_sequences([rc(r) for r in rev])
    out = {"merge": (m1, l1, m2, l2, dict(match=1, mismatch=-64, gap_p=-64,
                                          band=-1, mode="scalar"))}
    codes, lens = pack_sequences(seqs[:500])
    qi, pi = np.nonzero(np.triu(np.ones((500, 500), bool), 1).T)
    qi, pi = qi[:4096], pi[:4096]
    out["shift"] = (codes[qi], lens[qi], codes[pi], lens[pi],
                    dict(match=5, mismatch=-4, gap_p=-8, band=-1,
                         mode="scalar"))
    drp = derep_fastq(SAMPB)
    pc, pl = pack_sequences(drp.sequences)
    n = len(pl)
    out["samPB"] = (np.repeat(pc[:1], n, 0), np.repeat(pl[:1], n), pc, pl,
                    dict(match=5, mismatch=-4, gap_p=-8, end_gap_p=0,
                         band=32, mode="scalar", homo_gap_p=-1))
    whole = dict(match=1, mismatch=-64, gap_p=-64, band=-1, mode="scalar")
    fwd, rrc = merge_whole_reads()
    w1, wl1 = pack_sequences(fwd)
    w2, wl2 = pack_sequences(rrc)
    out["merge_whole"] = (w1, wl1, w2, wl2, whole)
    shift = dict(match=5, mismatch=-4, gap_p=-8, band=-1, mode="scalar")
    for name, unqs, npairs in (
            ("shift_v34", shift_v34_uniques(), 4096),
            ("shift_pb", shift_pb_uniques(dt), None)):
        codes, lens = pack_sequences(list(unqs))
        qi, pi = shift_pairs(unqs)
        qi, pi = qi[:npairs], pi[:npairs]
        out[name] = (codes[qi], lens[qi], codes[pi], lens[pi], shift)
    return out


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
        print("ab_b4: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from chip_smoke import b4_device_ms, b4_launch_ms, cuda_ms

    sys.path.insert(0, root)
    from dada2_tpu_torch import derep_fastq
    from dada2_tpu_torch.encode import pack_sequences, rc
    from dada2_tpu_torch.ops import nw_batch as nwb

    if not os.path.dirname(nwb.__file__).startswith(root):
        print(f"ab_b4: imported {nwb.__file__}, not from {root}",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    nwb.build_kernel()
    dev = torch.device("cuda", 0)
    calls = {}
    for name, (s1, l1, s2, l2, kw) in shapes(np, pack_sequences, rc,
                                             derep_fastq).items():
        args = [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                for x in (s1, l1.astype(np.int64), s2, l2.astype(np.int64))]
        calls[name] = (args, kw)
    out = {}
    for name, (args, kw) in calls.items():
        got = nwb.nw_batch(*args, **kw)
        torch.cuda.synchronize()
        blob = b"".join(x.cpu().numpy().astype(np.int32).tobytes()
                        for x in got)
        n, L1 = args[0].shape
        L2 = args[2].shape[1]
        nd, W = nwb.batch_geometry(args[1].cpu().numpy(),
                                   args[3].cpu().numpy(), kw["band"])
        row = dict(pairs=n, L1=L1, L2=L2, nd=nd, W=W,
                   sha256_16=hashlib.sha256(blob).hexdigest()[:16],
                   ms=[cuda_ms(lambda: nwb.nw_batch(*args, **kw), reps)],
                   kernel_ms=[b4_device_ms(
                       lambda: nwb.nw_batch(*args, **kw), reps,
                       lambda: nwb.nw_batch.launches)[0]])
        if hasattr(nwb, "_launch"):   # a checkout whose launches time alone
            row["launch_ms"] = [b4_launch_ms(nwb, args, kw, reps)]
        if hasattr(nwb, "register_fit"):   # a checkout with two bodies
            homo = kw.get("homo_gap_p") is not None
            r = nwb.route(L1, L2, nd, W, homo)
            row["body"] = nwb.body(r)
            row["route"] = r
            if r == 3 or (r == 4 and hasattr(nwb, "warps_per_pair")):
                row["rpt"], row["P"] = nwb.register_fit(
                    L1, L2, nd, W, kw["mode"] == "scalar", homo, n)
            if hasattr(nwb, "warps_per_pair") and r in (3, 4):
                row["warps"] = nwb.warps_per_pair(W)
        out[name] = row
    for name, (args, kw) in calls.items():
        out[name]["ms"].append(cuda_ms(lambda: nwb.nw_batch(*args, **kw),
                                       reps))
        out[name]["kernel_ms"].append(b4_device_ms(
            lambda: nwb.nw_batch(*args, **kw), reps,
            lambda: nwb.nw_batch.launches)[0])
        if "launch_ms" in out[name]:
            out[name]["launch_ms"].append(b4_launch_ms(nwb, args, kw, reps))
    print(json.dumps({"root": root, "card": card, "reps": reps,
                      "device": torch.cuda.get_device_name(0),
                      "shapes": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
