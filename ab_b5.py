"""Time kernel B5's slot packer (the follow-up and the gather mode) and its
full mode of a checkout of this repo on one card, for comparing two
checkouts.

    python3 ab_b5.py [ROOT] [--reps N]

ROOT (default: this script's directory) is a checkout whose
dada2_tpu_torch is imported. The inputs are made here from seeds and
in-repo data, the same for every checkout:
  - 17c's two budded compares: chip_smoke.py's simulated 120,000-read
    sample (phase 5; seed 42, from the ASVs of sam1F's dada() on the
    card) through dada(selfConsist=True), every budded_pack call recorded
    (chip_smoke.transport_run), and of those that computed their small
    pack the ones at the median and the largest M0, as 17c picks them:
    the budded compare's call (B5's budded kernel, whose launch took the
    per-call occupancy queries before this slice) and its follow-up over
    the first max(M0, 16) compacted rows (`take_subs`);
  - the gather mode at phase 5's init compare: the center's non-gapless
    rows with ham <= 32, K 32 (chip_smoke.gather_args);
  - the full mode at sam1F's init (unscreened, nd 896, M0 896, K 64) and
    at phase 5's screened shape (nd 22,528, M0 1,024, K 48;
    chip_smoke.full_inputs' thresholds);
  - all three at samPB's shape: tests/extdata/samPB.fastq.gz's 259
    uniques (full-length PacBio 16S, W ~1,500) at BAND_SIZE=32 on B1's
    route, the most abundant unique as center: the follow-up over the
    first 256 rows of the screened full mode's order in bits at K 128,
    the gather of every non-gapless row at K 32, the full mode
    unscreened at its init size (M0 nd, K 64).
Each is timed two ways, N calls per reading (default 20), two readings
apart: the call (CUDA events around the wrapper, its host work included)
and the device time (torch.profiler in a fresh process, `--child`, as
chip_smoke.py's b5_device_times; null where the profiler missed a
launch); beside its bound (bytes at the HBM rate, from this run's data)
and one launch's floor (a 1-element add_). A checksum of each call's
outputs must be equal between two checkouts. Prints the card's nvidia-smi
name and power limit, then one JSON line. Needs a CUDA card. For parent against
change, unpack the parent with `git archive` into a git-ignored
directory and run parent, change, change, parent in one command.
"""
from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))


def checksum(out) -> str:
    import torch

    h = hashlib.sha256()
    for x in (out if isinstance(out, (tuple, list)) else [out]):
        h.update(x.detach().cpu().contiguous().view(torch.uint8).numpy()
                 .tobytes())
    return h.hexdigest()[:16]


def child(root: str, path: str) -> None:
    """Device ms per call of {label: (wrapper, args, kwargs)} saved at
    path (CPU tensors), on the card, in this fresh process: one JSON line
    {label: [device ms, kernels per call, {kernel: count}]}."""
    import torch

    sys.path.insert(0, HERE)
    from chip_smoke import device_ms_per_call

    sys.path.insert(0, root)
    from dada2_tpu_torch.ops import store_screen as ss

    dev = torch.device("cuda", 0)

    def card(x):
        return x.to(dev) if torch.is_tensor(x) else x

    out = {}
    for label, (fn, a, kw) in torch.load(path).items():
        a = [card(x) for x in a]
        kw = {k: card(v) for k, v in kw.items()}
        out[label] = device_ms_per_call(lambda: getattr(ss, fn)(*a, **kw))
    print(json.dumps(out), flush=True)


def main(argv) -> int:
    reps = 20
    if "--reps" in argv:
        k = argv.index("--reps")
        reps = int(argv[k + 1])
        argv = argv[:k] + argv[k + 2:]
    if argv[:1] == ["--child"]:
        child(argv[1], argv[2])
        return 0
    root = os.path.abspath(argv[0]) if argv else HERE
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("ab_b5: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from chip_smoke import (SAM1F, SAMPB, cuda_ms, full_adaptive_m0,
                            full_args, full_bound, full_inputs, gather_args,
                            gather_bound, simulate_sample, take_bound,
                            transport_run)

    sys.path.insert(0, root)
    import dada2_tpu_torch as dt
    from dada2_tpu_torch.core.backend_cuda import CudaBackend
    from dada2_tpu_torch.core.raws import make_rawset
    from dada2_tpu_torch.encode import pack_sequences
    from dada2_tpu_torch.ops import store_screen as ss
    from dada2_tpu_torch.options import DEFAULT_OPTIONS

    if not os.path.dirname(ss.__file__).startswith(root):
        print(f"ab_b5: imported {ss.__file__}, not from {root}",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    ss.build_kernel()

    err41 = dt.data.tperr1()
    drp1 = dt.derep_fastq(SAM1F)
    res = dt.dada(drp1, err=err41, device=dev, verbose=False)
    err = np.hstack([err41] + [err41[:, -1:]] * 10)
    sim = simulate_sample(
        np.random.default_rng(42), dt.Derep, pack_sequences, res.sequence,
        np.array([res.denoised[s] for s in res.sequence], float),
        res.quality, err, 120_000, "sim0")
    _, _, calls = transport_run(lambda: dt.dada(
        sim, err=None, selfConsist=True, device=dev, verbose=False))
    computed = [c for c in calls if c[0][0] is None]
    m0s = [kw["M0"] for _, kw in computed]
    timed = {}   # label: (wrapper, args, kwargs, bound (ms, bytes))
    for label, M0 in (("17c median M0", int(np.median(m0s))),
                      ("17c largest M0", max(m0s))):
        a, kw = next(c for c in computed if c[1]["M0"] == M0)
        out = ss.budded_pack(*a, **kw)
        timed[f"{label} budded"] = ("budded_pack", a, kw, None)
        MU = kw["M0U"] if kw["cache_on"] else kw["M0"]
        tk = dict(M0=0, M=min(max(MU, 16), kw["nd"]), K=kw["K"],
                  kind=kw["kind"])
        targs = (out[3], a[1], a[2], a[3], a[5], out[2])
        timed[f"{label} take"] = ("take_subs", targs, tk,
                                  take_bound(targs, tk))

    backends = {
        "sam1F": (CudaBackend(make_rawset(drp1.sequences, drp1.abundances,
                                          None, drp1.quals), device=dev),
                  err41, DEFAULT_OPTIONS),
        "phase 5": (CudaBackend(make_rawset(
            sim.sequences, sim.abundances, None, sim.quals), device=dev),
            err, DEFAULT_OPTIONS)}
    drp_pb = dt.derep_fastq(SAMPB)
    backends["samPB"] = (CudaBackend(make_rawset(
        drp_pb.sequences, drp_pb.abundances, None, drp_pb.quals), device=dev),
        err41, DEFAULT_OPTIONS.replace(BAND_SIZE=32))
    inps = {k: full_inputs(be, e, opts=o) for k, (be, e, o) in
            backends.items()}

    def add_full(label, inp, screened, M0, K):
        a, kw = full_args(inp, screened, M0, K)
        timed[label] = ("full_pack", a, kw, full_bound(
            inp, a, kw, ss.fullbuf_layout(kw["nd"], M0, K)[3]))

    add_full("sam1F init full", inps["sam1F"], False,
             full_adaptive_m0(backends["sam1F"][0], False), 64)
    be5 = backends["phase 5"][0]
    add_full("phase 5 screened full", inps["phase 5"], True,
             full_adaptive_m0(be5, True), be5.FULL_SCREENED_K)
    a, kw = gather_args(ss, inps["phase 5"], 32, hmax=32)
    timed["phase 5 gather"] = ("gather_subs", a, kw, gather_bound(a, kw))
    pb = inps["samPB"]
    add_full("samPB init full", pb, False,
             full_adaptive_m0(backends["samPB"][0], False), 64)
    a, kw = full_args(pb, True, 16, 128)
    _, order_pb = ss.full_pack_ref(*a, **kw)
    targs = (pb["small13"],) + pb["base"] + (order_pb,)
    tk = dict(M0=0, M=min(256, pb["nd"]), K=128, kind="bits")
    timed["samPB take"] = ("take_subs", targs, tk, take_bound(targs, tk))
    a, kw = gather_args(ss, pb, 32)
    timed["samPB gather"] = ("gather_subs", a, kw, gather_bound(a, kw))

    tiny = torch.zeros(1, device=dev)
    out = {}
    for label, (fn, a, kw, bnd) in timed.items():
        got = getattr(ss, fn)(*a, **kw)
        torch.cuda.synchronize()
        row = dict(wrapper=fn,
                   shape={k: v for k, v in kw.items()
                          if isinstance(v, (int, str, bool))},
                   rows=int(a[1].shape[0]), W=int(a[1].shape[1]),
                   sha256_16=checksum(got if fn != "budded_pack"
                                      else got[:3]),
                   ms=[cuda_ms(lambda: getattr(ss, fn)(*a, **kw), reps)],
                   floor_ms=[cuda_ms(lambda: tiny.add_(1), 200)])
        if bnd is not None:
            row.update(bound_ms=bnd[0], bound_bytes=bnd[1],
                       bound_by="bytes")
        out[label] = row
    for label, (fn, a, kw, _) in timed.items():
        out[label]["ms"].append(
            cuda_ms(lambda: getattr(ss, fn)(*a, **kw), reps))
        out[label]["floor_ms"].append(cuda_ms(lambda: tiny.add_(1), 200))

    def cpu(x):
        return x.cpu() if torch.is_tensor(x) else x

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ab_b5.pt")
        torch.save({label: (fn, [cpu(x) for x in a],
                            {k: cpu(v) for k, v in kw.items()})
                    for label, (fn, a, kw, _) in timed.items()}, path)
        for _ in range(2):
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child", root,
                 path], capture_output=True, text=True, timeout=600)
            if proc.returncode != 0:
                print(f"ab_b5: device-time process failed: "
                      f"{proc.stderr[-2000:]}", file=sys.stderr)
                return 1
            dev_t = json.loads(proc.stdout.strip().splitlines()[-1])
            for label, (ms, per_call, names) in dev_t.items():
                r = out[label]
                r.setdefault("device_ms", []).append(
                    ms if per_call == 1 else None)
                r["kernels_per_call"] = per_call
                r["kernels"] = names
    print(json.dumps({"root": root, "card": card, "reps": reps,
                      "device": torch.cuda.get_device_name(0),
                      "shapes": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
