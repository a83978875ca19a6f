"""Drive dada2_tpu_torch on one CUDA card and check it end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. device  — a CUDA card must be present; prints its nvidia-smi name and
               power limit;
  2. build   — builds kernel B1 (csrc/nw_wavefront.cu) with nvcc from the
               checkout and prints its `-Xptxas -v` report;
  3. kernel  — kernel B1 against its plain PyTorch version on the card, on
               seeded fuzz blocks (uniform and mixed lengths, windows of
               32/64/96/128 rows, several blocks, lengths near 250 and
               450): sub, mapq and end must be bitwise equal;
  4. small   — derep_fastq(sam1F) -> dada(err=tperr1()) on the card and on
               the CPU: clustering, map, pval, birth_subs, trans identical;
  5. main    — a simulated 120,000-read MiSeq sample (the DADA2 tutorial
               scale) through dada(selfConsist=True) on the card, with the
               kernel's launch count reset just before and read just after;
               then the kernel's time (CUDA events) against its plain
               version and its bound, at the main path's largest shapes;
  6. profile — the same selfConsist run again under torch.profiler: device
               time by kernel and the device's busy share.
It prints one {"kernels": [...]} line and, last, {"ok": true, ...}.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SAM1F = os.path.join(ROOT, "tests", "extdata", "sam1F.fastq.gz")

# H100 SXM peaks (NVIDIA data sheet): HBM rate, and the int32 rate — 64
# INT32 lanes per SM (half the 128 FP32 lanes behind the 67 TFLOP/s fp32
# figure, one op per lane instead of an FMA's two): 67e12 / 4.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4
# int32 operations the recurrence needs per in-band cell:
#   2  gap adds (up + gap_p, left + gap_p)
#   3  match: compare c1 == c2, select match/mismatch, add to diag
#   3  up >= left: compare, select score, select pointer
#   3  diag > that: compare, select score, select pointer
#   2  pack the 2-bit pointer: shift, or
# The borders (i == 0, j == 0), the band tests and the ends-free
# last-row/last-column recalculations are needed only on the band's edges
# and the last row and column, so they are not counted per cell (the
# kernel runs them on every cell; that is its overhead, not the bound's).
OPS_PER_CELL = 13


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---- phase helpers ---------------------------------------------------------

def fuzz_case(rng, nww, len1, ncand, nops, band, wp, uniform):
    """Kernel B1 inputs for one center vs ncand mutated candidates, laid
    out as the backend lays them (length-sorted 128-lane blocks)."""
    import numpy as np

    s1 = rng.integers(0, 4, len1).astype(np.uint8)
    cands = []
    for _ in range(ncand):
        c = list(s1)
        for _ in range(int(rng.integers(0, nops))):
            p = int(rng.integers(0, len(c)))
            op = 0 if uniform else int(rng.integers(0, 3))
            if op == 0:
                c[p] = int(rng.integers(0, 4))
            elif op == 1:
                del c[p]
            else:
                c.insert(p, int(rng.integers(0, 4)))
        cands.append(np.array(c, np.uint8))
    L2 = max(len(c) for c in cands)
    s2b = np.full((ncand, L2), 255, np.uint8)
    l2b = np.array([len(c) for c in cands], np.int64)
    for k, c in enumerate(cands):
        s2b[k, : len(c)] = c
    quals = rng.integers(2, 41, (ncand, L2))
    merged = (s2b.astype(np.int64) & 3) | (quals << 2)
    bidx = nww.assemble_blocks(s2b, l2b)
    nb = bidx.shape[0]
    need = max(nww.block_window(len1, l2b[bidx[b]], band) for b in range(nb))
    if need > wp:
        raise ValueError(f"case needs a {need}-row window, asked {wp}")
    maxlen = max(len1, L2)
    NDP = nww._round_up(2 * maxlen + 1, 256)
    L1R = nww._round_up(maxlen + 1 + 128, 128)
    L2R = nww._round_up(maxlen + 128, 128)
    s2q = nww.pack_s2_blocks(merged, l2b, bidx, L2R)
    scal = np.zeros((nb, 4), np.int32)
    params = np.zeros((nb, 8, nww.LANES), np.int32)
    for b in range(nb):
        l2 = l2b[bidx[b]]
        rb = band + np.maximum(0, l2 - len1)
        scal[b] = (len1, int(l2.max()), int(rb.max()), int(l2.min()))
        params[b, 0] = l2
        params[b, 1] = band + np.maximum(0, len1 - l2)
        params[b, 2] = rb
    s1t = np.zeros((L1R, nww.LANES), np.int32)
    s1t[1: 1 + len1] = s1.astype(np.int32)[:, None]
    geom = dict(L1R=L1R, L2R=L2R, NDP=NDP, WP=wp, match=5, mismatch=-4,
                gap_p=-8)
    return (scal, params, s1t, s2q), geom


def max_abs_diff(got, want):
    return max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
               for g, w in zip(got, want))


def cuda_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def simulate_sample(rng, Derep, pack_sequences, asv_seqs, asv_ab, asv_quals,
                    err, nreads, name):
    """A production-scale sample: reads drawn from real ASVs with
    substitution errors at the error matrix's per-(transition, quality)
    rates, dereplicated in memory (the DADA2 tutorial's shape: 1e5+
    reads, tens of thousands of uniques)."""
    import numpy as np

    codes, lens = pack_sequences(asv_seqs)
    counts = rng.multinomial(nreads, asv_ab / asv_ab.sum())
    rows = []
    quals_of = []
    for a, m in enumerate(counts):
        if m == 0:
            continue
        L = int(lens[a])
        c = codes[a, :L].astype(np.int64)
        q = np.nan_to_num(asv_quals[a][:L], nan=35.0)
        q8 = np.floor(q + 0.5).astype(np.int64)
        selfp = err[5 * c, q8]                       # P(no substitution)
        reads = np.broadcast_to(c, (m, L)).copy()
        sub = rng.random((m, L)) >= selfp[None, :]
        if sub.any():
            ri, pi = np.nonzero(sub)
            base = c[pi]
            # target nt proportional to err[4*base+t, q], t != base
            probs = np.stack([err[4 * base + t, q8[pi]] for t in range(4)],
                             axis=1)
            probs[np.arange(len(pi)), base] = 0.0
            probs /= probs.sum(axis=1, keepdims=True)
            u = rng.random(len(pi))
            tgt = (np.cumsum(probs, axis=1) < u[:, None]).sum(axis=1)
            reads[ri, pi] = np.minimum(tgt, 3)
        W = codes.shape[1]
        padded = np.full((m, W), 255, np.uint8)
        padded[:, :L] = reads
        rows.append(padded)
        quals_of.append(np.broadcast_to(
            np.pad(q8.astype(np.float64), (0, W - L),
                   constant_values=np.nan), (m, W)))
    allreads = np.concatenate(rows, axis=0)
    allquals = np.concatenate(quals_of, axis=0)
    uniq, first, inv, cnt = np.unique(
        allreads, axis=0, return_index=True, return_inverse=True,
        return_counts=True)
    order = np.argsort(-cnt, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    nt = np.frombuffer(b"ACGT", np.uint8)
    uniques = {}
    for k in order:
        row = uniq[k]
        uniques[nt[row[row != 255]].tobytes().decode()] = int(cnt[k])
    return Derep(uniques=uniques, quals=allquals[first][order],
                 map=rank[np.ravel(inv)], name=name)


def profile_main_path(dt, sim) -> None:
    """Where the main path's device time goes: a second selfConsist run
    (fresh backend, so the kernel runs again) under torch.profiler,
    tracing device activity only. Prints device time by kernel and the
    device's busy share of the wall time (any profiler overhead lengthens
    the wall, so the busy share is a lower bound)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # the wall clock runs inside the profiler's context: its start-up and
    # the event collection on exit take seconds and are not the run's
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        dt.dada(sim, err=None, selfConsist=True, device="cuda",
                verbose=False)
        torch.cuda.synchronize()
        wall_us = (time.time() - t0) * 1e6
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        us = e.time_range.end - e.time_range.start
        tot, cnt = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + us, cnt + 1)
    if not spans:
        log("[profile] device time not measured: the profiler recorded no "
            "CUDA events")
        return
    spans.sort()
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    log(f"[profile] selfConsist run under torch.profiler: wall "
        f"{wall_us / 1e3:.1f} ms, device busy {busy / 1e3:.1f} ms "
        f"({100 * busy / wall_us:.1f}% busy, {len(spans)} device events)")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    for name, (us, cnt) in top:
        log(f"[profile]   {us / 1e3:9.3f} ms {cnt:6d}x  {name[:90]}")


def same_result(a, b, what):
    import numpy as np
    import pandas as pd

    pd.testing.assert_frame_equal(a.clustering, b.clustering, obj=what)
    pd.testing.assert_frame_equal(a.birth_subs, b.birth_subs, obj=what)
    np.testing.assert_array_equal(a.map, b.map, err_msg=what)
    np.testing.assert_array_equal(a.pval, b.pval, err_msg=what)
    np.testing.assert_array_equal(a.trans, b.trans, err_msg=what)


# ---- main ------------------------------------------------------------------

def main() -> None:
    try:
        import numpy as np
        import torch
    except ImportError as e:
        fail(f"missing dependency: {e}")
    sys.path.insert(0, ROOT)
    try:
        import dada2_tpu_torch as dt
        from dada2_tpu_torch.core.backend_cuda import CudaBackend
        from dada2_tpu_torch.core.raws import make_rawset
        from dada2_tpu_torch.encode import pack_sequences
        from dada2_tpu_torch.ops import nw_wavefront as nww
        from dada2_tpu_torch.options import DEFAULT_OPTIONS
    except ImportError as e:
        fail(f"dada2_tpu_torch is not importable next to this script: {e}")
    if "jax" in sys.modules or "dada2_tpu" in sys.modules:
        fail("the port imported jax or dada2_tpu")

    # 1. device
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi could not read the card: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s), python "
        f"{sys.version.split()[0]}")

    # 2. build
    t0 = time.time()
    try:
        ptxas = nww.build_kernel()
    except RuntimeError as e:
        fail(f"kernel build: {e}")
    log(f"[build] nw_wavefront.cu built in {time.time() - t0:.1f}s; "
        "ptxas report:")
    for line in ptxas.strip().splitlines():
        log(f"[build]   {line.strip()}")

    # 3. kernel against its plain version, bitwise
    rng = np.random.default_rng(2024)
    cases = [  # (len1, candidates, max edits, band, WP, substitutions only)
        (250, 400, 12, 16, 32, True),
        (252, 300, 10, 16, 64, False),
        (448, 260, 16, 16, 96, False),
        (452, 390, 8, 16, 128, True),
    ]
    worst = 0
    for len1, ncand, nops, band, wp, uniform in cases:
        arrays, geom = fuzz_case(rng, nww, len1, ncand, nops, band, wp,
                                 uniform)
        t = [torch.from_numpy(a).to(dev) for a in arrays]
        got = nww.nw_compare(*t, **geom)
        torch.cuda.synchronize()
        want = nww.nw_compare_ref(*t, **geom)
        err = max_abs_diff(got, want)
        worst = max(worst, err)
        ok_tb = bool((got[2][:, :2] == 0).all())
        log(f"[kernel] len1={len1} blocks={arrays[0].shape[0]} WP={wp} "
            f"{'uniform' if uniform else 'mixed'}: max |kernel - plain| = "
            f"{err}, tracebacks complete: {ok_tb}")
        if err != 0 or not ok_tb:
            fail(f"kernel B1 disagrees with its plain version (WP={wp})")

    # 4. main path, small: card against CPU, identical
    err41 = dt.data.tperr1()
    drp = dt.derep_fastq(SAM1F)
    t0 = time.time()
    res_gpu = dt.dada(drp, err=err41, device="cuda", verbose=False)
    t_gpu = time.time() - t0
    t0 = time.time()
    res_cpu = dt.dada(dt.derep_fastq(SAM1F), err=err41, device="cpu",
                      verbose=False)
    t_cpu = time.time() - t0
    try:
        same_result(res_gpu, res_cpu, "sam1F card vs CPU")
    except AssertionError as e:
        fail(f"sam1F dada() on the card differs from the CPU run: {e}")
    log(f"[small] sam1F: {len(drp.uniques)} uniques -> "
        f"{len(res_gpu.denoised)} ASVs; card {t_gpu:.2f}s, CPU "
        f"{t_cpu:.2f}s; clustering/map/pval/birth_subs/trans identical")

    # 5. main path at the tutorial scale
    err = np.hstack([err41] + [err41[:, -1:]] * 10)  # cover q <= 50
    sim = simulate_sample(
        np.random.default_rng(42), dt.Derep, pack_sequences,
        res_gpu.sequence,
        np.array([res_gpu.denoised[s] for s in res_gpu.sequence], float),
        res_gpu.quality, err, 120_000, "sim0")
    log(f"[main] simulated sample: 120000 reads, {len(sim.uniques)} uniques")
    dt.PHASES.reset()
    dt.COUNTERS.reset()
    torch.cuda.reset_peak_memory_stats()
    nww.nw_compare.launches = 0
    t0 = time.time()
    res = dt.dada(sim, err=None, selfConsist=True, device="cuda",
                  verbose=False)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = nww.nw_compare.launches
    peak = torch.cuda.max_memory_allocated()
    rounds = len(res.err_in)
    log(f"[main] dada(selfConsist=True): {len(sim.uniques)} uniques, "
        f"{rounds} rounds, {len(res.denoised)} ASVs, {wall:.2f}s wall")
    log(f"[main] phases: {dt.PHASES.summary()}")
    log(f"[main] counters: {dt.COUNTERS.summary()}")
    log(f"[main] kernel B1 launches: {launches}; "
        f"max_memory_allocated: {peak} bytes")
    if launches <= 0:
        fail("the main path never launched kernel B1")
    eo = np.asarray(res.err_out)
    if (eo.shape[0] != 16 or not np.isfinite(eo).all() or (eo < 0).any()
            or (eo > 1).any() or len(res.denoised) == 0
            or res.map.shape != (len(sim.uniques),)):
        fail("the selfConsist run's outputs are malformed")

    # kernel time at the main path's shapes: the init compare's center
    # (the most abundant unique) against its widest-populated window bucket
    rs = make_rawset(sim.sequences, sim.abundances, None, sim.quals)
    be = CudaBackend(rs, device=dev)
    opts = DEFAULT_OPTIONS.normalized()
    len1 = int(rs.lens[0])
    wp, NDP, L1R = be._kernel_geom(len1, opts)
    scal, params = be._pb.scal_params(len1, opts.BAND_SIZE)
    w = int(np.bincount(wp).argmax())
    sel = np.nonzero(wp == w)[0]
    s1t = np.zeros((L1R, nww.LANES), np.int32)
    s1t[1: 1 + len1] = rs.seqs[0, :len1].astype(np.int32)[:, None]
    sel_d = torch.from_numpy(sel).to(dev)
    args = (torch.from_numpy(scal[sel]).to(dev),
            torch.from_numpy(params[sel]).to(dev),
            torch.from_numpy(s1t).to(dev), be._pb.d_s2q[sel_d].contiguous())
    geom = dict(L1R=L1R, L2R=be._pb.L2R, NDP=NDP, WP=w, match=opts.MATCH,
                mismatch=opts.MISMATCH, gap_p=opts.GAP_PENALTY)
    got = nww.nw_compare(*args, **geom)
    want = nww.nw_compare_ref(*args, **geom)
    err_main = max_abs_diff(got, want)
    log(f"[time] main-path inputs: {len(sel)} blocks x 128 lanes, WP={w}, "
        f"L1R={L1R} L2R={be._pb.L2R} NDP={NDP}; max |kernel - plain| = "
        f"{err_main}")
    if err_main != 0:
        fail("kernel B1 disagrees with its plain version on main-path "
             "inputs")
    ms = cuda_ms(lambda: nww.nw_compare(*args, **geom), 20)
    plain_ms = cuda_ms(lambda: nww.nw_compare_ref(*args, **geom), 2)
    # bound: each input read once and each output written once, or the
    # fill's integer work over the in-band cells of these pairs
    nbytes = sum(a.numel() * 4 for a in args) + sum(
        g.numel() * 4 for g in got)
    lanes = params[sel]
    l2 = lanes[:, 0].astype(np.int64)
    lb = lanes[:, 1].astype(np.int64)
    rb = lanes[:, 2].astype(np.int64)
    ii = np.arange(len1 + 1)[None, None, :]
    lo = np.maximum(0, ii - lb[:, :, None])
    hi = np.minimum(l2[:, :, None], ii + rb[:, :, None])
    cells = int(np.clip(hi - lo + 1, 0, None).sum())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = cells * OPS_PER_CELL / INT32_OPS_PER_S * 1e3
    bound_ms = max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    log(f"[time] kernel {ms:.4f} ms, plain {plain_ms:.2f} ms; bound "
        f"{bound_ms:.4f} ms by {bound_by} ({nbytes} bytes -> "
        f"{t_bytes:.4f} ms; {cells} in-band cells x {OPS_PER_CELL} int32 "
        f"ops -> {t_ops:.4f} ms); card {card}")

    profile_main_path(dt, sim)

    log(json.dumps({"kernels": [{
        "name": "nw_wavefront_compare (B1)",
        "route": "cuda",
        "source": "dada2_tpu_torch/csrc/nw_wavefront.cu",
        "replaces": "dada2_tpu/ops/nw_pallas.py:452",
        "launches": launches,
        "max_abs_err": max(worst, err_main),
        "match": True,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
