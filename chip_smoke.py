"""Drive dada2_tpu_torch on one CUDA card and check it end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. device  — a CUDA card must be present; prints its nvidia-smi name and
               power limit;
  2. build   — builds the two kernel sources with nvcc from the checkout,
               one nvcc each, started together: csrc/nw_wavefront.cu (B1's
               nw_compare_kernel and the B2, B3, B2 stats body x windows of
               32..128 rows, sixteen instantiations) and csrc/nw_batch.cu
               (kernel B4: vec, scalar and homopolymer aligners x pointer
               slab in shared or device memory, six); prints their
               `-Xptxas -v` reports;
  3. kernel  — kernel B1 against its plain PyTorch version on the card, on
               seeded fuzz blocks (uniform and mixed lengths, windows of
               32/64/96/128 rows, lengths near 250 and 450, launches of 1
               to 66 blocks so that every pairs-per-block choice runs, a
               PacBio full-length set, and lanes and a block whose geometry
               fails): sub, mapq and end must be bitwise equal;
  3b. modes  — kernels B2 (pairs), B2 stats (nw_pairs_stats, with and
               without one-off, max_shift 1, 4 and 16) and B3 (kinds)
               against their plain versions the same way: windows of
               32/64/96/128 rows, several blocks of different query
               lengths, lengths near 250, and one PacBio full-length 16S
               set (len ~1450: NDP 3072, L1R 1664); every output bitwise
               equal;
  4. small   — derep_fastq(sam1F) -> dada(err=tperr1()) on the card and on
               the CPU: clustering, map, pval, birth_subs, trans identical;
               then the same at BAND_SIZE=0 (every candidate gapless on the
               host), which must launch no kernel;
  5. main    — a simulated 120,000-read MiSeq sample (the DADA2 tutorial
               scale) through dada(selfConsist=True) on the card, with the
               kernels' launch counts reset just before and read just after;
               then kernel B1's time (CUDA events) against its plain version
               and its bound, at the main path's largest shapes, and also at
               one block and at samPB.fastq.gz's geometry (BAND_SIZE=32);
  6. profile — the same selfConsist run again under torch.profiler: device
               time by kernel and the device's busy share;
  7. table   — sam1F and sam2F: derep_fastq -> dada(err=tperr1()) ->
               make_sequence_table -> remove_bimera_denovo with each of the
               three methods, on the card and on the CPU: identical;
  8. grouped — nw_wavefront_grouped (kernel B3's path): one sam1F center
               against every unique on the card and on the CPU, identical,
               with B3's launches counted; then B3's time at those shapes;
  9. chimera — the consensus chimera check at real size (the JAX package's
               bench_chimera.py fixture: 5000 ASVs x 20 samples, L = 250,
               seed 7; 7,114,790 query-parent pairs): is_bimera_denovo_table
               on the card (wall, pairs, blocks, launches, route, flags, peak
               memory); the five lr/ham arrays of kernel B2's route against
               kernel B1's per-query route on the card; (nflag, nsam) of the
               columns with the most pairs against the port on the CPU;
 10. B2 time — at one full launch of that table (1024 blocks), CUDA events
               in turns on one card: the stats kernel (the route's B2)
               against the class-row kernel followed by the torch scans
               it replaces, each checked against its plain version, and
               the stats kernel's plain version time and bound;
 11. profile — the table run again under torch.profiler: no class-row
               kernel and no scan kernel may appear;
 12. batch   — kernel B4 (ops/nw_batch.py) against its plain version on
               the card, on seeded fuzz batches: vec and scalar aligners,
               bands 2, 4, 16, 32 and none, homopolymer gap penalty none,
               -1 and -3, end gaps free and -8, mixed lengths, lengths near
               250, the merge scorings, samPB.fastq.gz's full-length reads
               at band 32 and some unbanded (the device-memory pointer
               slab), chunked and not: all six outputs bitwise equal;
 13. paired  — sam1 and sam2, forward and reverse: dada -> merge_pairs ->
               make_sequence_table -> collapse_no_mismatch ->
               remove_bimera_denovo(consensus) -> is_shift_denovo on the
               card and on the CPU, identical (the forward dada results are
               phase 7's); then dada(sam1F) with HOMOPOLYMER_GAP_PENALTY=-1,
               BAND_SIZE=32 (B4 must launch, B1 must not) and with
               BAND_SIZE=-1, card == CPU; kernel launches printed for
               each;
 14. B4 size — phase 5's sample through dada(selfConsist=True,
               HOMOPOLYMER_GAP_PENALTY=-1, BAND_SIZE=32) (B4's path: its
               launches counted there; wall, B4 device time, bound over the
               run's launches, plain version at its largest launch); B4 at
               merge shapes (4,096 pairs, F = 240 nt against rc(R) = 200 nt
               from phase 9's ASVs with seeded substitutions, scoring
               (1, -64, -64), no band; CUDA events); is_shift_denovo on
               phase 9's first 500 ASVs (124,750 unbanded pairs): wall, B4
               device time, bound, plain version on one 4,096-pair chunk.
It prints one {"kernels": [...]} line and, last, {"ok": true, ...}.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SAM1F = os.path.join(ROOT, "tests", "extdata", "sam1F.fastq.gz")
SAM2F = os.path.join(ROOT, "tests", "extdata", "sam2F.fastq.gz")
SAMPB = os.path.join(ROOT, "tests", "extdata", "samPB.fastq.gz")
SAM1R = os.path.join(ROOT, "tests", "extdata", "sam1R.fastq.gz")
SAM2R = os.path.join(ROOT, "tests", "extdata", "sam2R.fastq.gz")

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
# The same count holds in every mode: B2 and B3 add one store per
# traceback step, not per cell.
OPS_PER_CELL = 13
# kernel B4 (the batch aligner) needs the same 13 per in-band cell in both
# of its aligners (the scalar one's tie rules are as many compares and
# selects), plus 2 selects of the gap penalty by the homopolymer masks
B4_HOMO_OPS = 2
# the table check's per-query route (kernel B1) runs on every column only
# if that is expected to take at most this long
PER_QUERY_SECONDS = 60.0


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---- phase helpers ---------------------------------------------------------

def mutate(rng, s, nops, uniform):
    """s with up to nops random edits (substitutions only if uniform)."""
    import numpy as np

    c = list(s)
    for _ in range(int(rng.integers(0, nops))):
        p = int(rng.integers(0, len(c)))
        op = 0 if uniform else int(rng.integers(0, 3))
        if op == 0:
            c[p] = int(rng.integers(0, 4))
        elif op == 1:
            del c[p]
        else:
            c.insert(p, int(rng.integers(0, 4)))
    return np.array(c, np.uint8)


def geometry(nww, maxlen):
    """The backend's rounding of (NDP, L1R, L2R) for a longest sequence."""
    return (nww._round_up(2 * maxlen + 1, 256),
            nww._round_up(maxlen + 1 + 128, 128),
            nww._round_up(maxlen + 128, 128))


def fuzz_case(rng, nww, len1, ncand, nops, band, wp, uniform):
    """Kernel B1 (and B3) inputs for one center vs ncand mutated
    candidates, laid out as the backend lays them (length-sorted 128-lane
    blocks)."""
    import numpy as np

    s1 = rng.integers(0, 4, len1).astype(np.uint8)
    cands = [mutate(rng, s1, nops, uniform) for _ in range(ncand)]
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
    NDP, L1R, L2R = geometry(nww, max(len1, L2))
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


def pairs_case(rng, nww, blocks, band, wp):
    """Kernel B2 inputs: one block per (len1, npairs, nops, uniform) entry,
    each lane its own random query of length len1 against a mutated copy;
    pad lanes repeat lane 0, as the chimera route lays them out."""
    import numpy as np

    L = nww.LANES
    nb = len(blocks)
    queries, parents = [], []
    for len1, npairs, nops, uniform in blocks:
        q = [rng.integers(0, 4, len1).astype(np.uint8)
             for _ in range(npairs)]
        q += [q[0]] * (L - npairs)
        queries.append(q)
        ps = [mutate(rng, s, nops, uniform) for s in q[:npairs]]
        parents.append(ps + [ps[0]] * (L - npairs))
    maxlen = max(max(len(p) for p in ps) for ps in parents)
    maxlen = max(maxlen, max(b[0] for b in blocks))
    NDP, L1R, L2R = geometry(nww, maxlen)
    scal = np.zeros((nb, 4), np.int32)
    params = np.zeros((nb, 8, L), np.int32)
    s1 = np.zeros((nb, L1R, L), np.int32)
    s2q = np.zeros((nb, L2R, L), np.int32)
    for b, (len1, _, _, _) in enumerate(blocks):
        l2 = np.array([len(p) for p in parents[b]], np.int64)
        need = nww.block_window(len1, l2, band)
        if need > wp:
            raise ValueError(f"case needs a {need}-row window, asked {wp}")
        C = int(l2.max())
        scal[b] = (len1, C, band + max(0, C - len1), int(l2.min()))
        params[b, 0] = l2
        params[b, 1] = band + np.maximum(0, len1 - l2)
        params[b, 2] = band + np.maximum(0, l2 - len1)
        for k in range(L):
            s1[b, 1: 1 + len1, k] = queries[b][k]
            p = parents[b][k]
            s2q[b, C - len(p): C, k] = p[::-1]   # row C - j holds p[j-1]
    geom = dict(L1R=L1R, L2R=L2R, NDP=NDP, WP=wp, match=5, mismatch=-4,
                gap_p=-8)
    return (scal, params, s1, s2q), geom


def b1_bucket_inputs(nww, be, opts, dev, center=0):
    """Kernel B1's inputs as the compare sweep launches them: one center of
    a CudaBackend's rawset against the blocks of its most-populated window
    bucket. Returns (card tensors, geometry, scal, params)."""
    import numpy as np
    import torch

    rs = be.rs
    len1 = int(rs.lens[center])
    wp = be._pb.block_wp(len1, opts.BAND_SIZE)
    NDP, L1R = be._pb.geometry()
    scal, params = be._pb.scal_params(len1, opts.BAND_SIZE)
    w = int(np.bincount(wp).argmax())
    sel = np.nonzero(wp == w)[0]
    s1t = np.zeros((L1R, nww.LANES), np.int32)
    s1t[1: 1 + len1] = rs.seqs[center, :len1].astype(np.int32)[:, None]
    sel_d = torch.from_numpy(sel).to(dev)
    args = (torch.from_numpy(scal[sel]).to(dev),
            torch.from_numpy(params[sel]).to(dev),
            torch.from_numpy(s1t).to(dev), be._pb.d_s2q[sel_d].contiguous())
    geom = dict(L1R=L1R, L2R=be._pb.L2R, NDP=NDP, WP=w, match=opts.MATCH,
                mismatch=opts.MISMATCH, gap_p=opts.GAP_PENALTY)
    return args, geom, scal[sel], params[sel]


def ptxas_registers(ptxas, kernel):
    """{rows per thread: registers} of one kernel's instantiations in an
    `-Xptxas -v` report."""
    import re

    regs = {}
    for chunk in ptxas.split("Compiling entry function")[1:]:
        m = re.search(kernel + r"ILi(\d)E", chunk)
        r = re.search(r"Used (\d+) registers", chunk)
        if m and r and int(m.group(1)) not in regs:
            regs[int(m.group(1))] = int(r.group(1))
    return regs


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


def inband_cells(scal, params):
    """In-band DP cells of every lane of kernel blocks (scal [nb, 4],
    params [nb, 8, 128]): for each row i <= len1, the j in
    [max(0, i - lb), min(len2, i + rb)]."""
    import numpy as np

    len1 = np.repeat(scal[:, 0].astype(np.int64), params.shape[2])
    l2 = params[:, 0].reshape(-1).astype(np.int64)
    lb = params[:, 1].reshape(-1).astype(np.int64)
    rb = params[:, 2].reshape(-1).astype(np.int64)
    cells = 0
    for k in range(0, len(len1), 8192):
        sl = slice(k, k + 8192)
        ii = np.arange(int(len1[sl].max()) + 1)[None, :]
        lo = np.maximum(0, ii - lb[sl, None])
        hi = np.minimum(l2[sl, None], ii + rb[sl, None])
        n = np.clip(hi - lo + 1, 0, None) * (ii <= len1[sl, None])
        cells += int(n.sum())
    return cells


def bound(args, outs, scal, params):
    """(bound_ms, bound_by, detail): the larger of the bytes each input
    read once and each output written once take at the HBM rate, and the
    in-band cells' OPS_PER_CELL int32 operations at the int32 rate."""
    nbytes = sum(a.numel() * a.element_size() for a in list(args) + list(outs))
    cells = inband_cells(scal, params)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = cells * OPS_PER_CELL / INT32_OPS_PER_S * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), by, (
        f"{nbytes} bytes -> {t_bytes:.4f} ms; {cells} in-band cells x "
        f"{OPS_PER_CELL} int32 ops -> {t_ops:.4f} ms")


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


def chimera_fixture(ncol=5000, nsam=20, nbase=300, L=250, seed=7):
    """The JAX package's chimera benchmark table (bench_chimera.py::
    make_fixture, copied): sparse samples x ASVs counts, ASVs being point
    mutants and two-parent recombinants of nbase random sequences, or
    novel."""
    import numpy as np

    rng = np.random.default_rng(seed)
    nt = np.array(list("ACGT"))
    bases = ["".join(nt[rng.integers(0, 4, L)]) for _ in range(nbase)]
    seqs = set()
    out = []
    while len(out) < ncol:
        r = rng.random()
        if r < 0.55:  # point-mutation variant of a base
            s = list(bases[rng.integers(0, nbase)])
            for _ in range(int(rng.integers(1, 6))):
                s[int(rng.integers(0, L))] = nt[rng.integers(0, 4)]
            s = "".join(s)
        elif r < 0.75:  # recombinant of two bases (chimera-like)
            i, j = rng.integers(0, nbase, 2)
            cut = int(rng.integers(40, L - 40))
            s = bases[i][:cut] + bases[j][cut:]
        else:  # novel
            s = "".join(nt[rng.integers(0, 4, L)])
        if s not in seqs:
            seqs.add(s)
            out.append(s)
    # sparse occupancy, log-distributed counts
    mat = np.zeros((nsam, ncol), np.int64)
    occup = rng.integers(1, 8, ncol)            # samples per ASV
    for j in range(ncol):
        rows = rng.choice(nsam, size=occup[j], replace=False)
        mat[rows, j] = np.maximum(
            1, np.round(np.exp(rng.normal(3.0, 1.6, occup[j])))
        ).astype(np.int64)
    return mat, out


def profile_device(label, run) -> None:
    """Where a run's device time goes: run() under torch.profiler, tracing
    device activity only. Prints device time by kernel and the device's
    busy share of the wall time (any profiler overhead lengthens the
    wall, so the busy share is a lower bound); returns {kernel name:
    (device us, count)}, empty if the profiler saw no device events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # the wall clock runs inside the profiler's context: its start-up and
    # the event collection on exit take seconds and are not the run's
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        run()
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
        log(f"[profile] {label}: device time not measured: the profiler "
            "recorded no CUDA events")
        return {}
    spans.sort()
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    log(f"[profile] {label} under torch.profiler: wall "
        f"{wall_us / 1e3:.1f} ms, device busy {busy / 1e3:.1f} ms "
        f"({100 * busy / wall_us:.1f}% busy, {len(spans)} device events)")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    for name, (us, cnt) in top:
        log(f"[profile]   {us / 1e3:9.3f} ms {cnt:6d}x  {name[:90]}")
    return by_name


def same_result(a, b, what):
    import numpy as np
    import pandas as pd

    pd.testing.assert_frame_equal(a.clustering, b.clustering, obj=what)
    pd.testing.assert_frame_equal(a.birth_subs, b.birth_subs, obj=what)
    np.testing.assert_array_equal(a.map, b.map, err_msg=what)
    np.testing.assert_array_equal(a.pval, b.pval, err_msg=what)
    np.testing.assert_array_equal(a.trans, b.trans, err_msg=what)


def kernel_vs_plain(nww, dev, arrays, geom, emit, per_block):
    """Run one mode of the kernel and its plain version on the same card
    tensors; returns (max |kernel - plain|, tracebacks complete, the card
    tensors, the plain outputs)."""
    import torch

    t = [torch.from_numpy(a).to(dev) for a in arrays]
    got = nww.nw_wavefront(*t, emit_kinds=emit, s1_per_block=per_block,
                           **geom)
    torch.cuda.synchronize()
    want = nww.nw_wavefront_ref(*t, emit_kinds=emit, s1_per_block=per_block,
                                **geom)
    return (max_abs_diff(got, want), bool((got[-1][:, :2] == 0).all()), t,
            want)


STATS_SETTINGS = [(oo, ms) for oo in (False, True) for ms in (1, 4, 16)]


def stats_vs_plain(nww, t, want, geom, settings=STATS_SETTINGS):
    """The stats kernel on card tensors t against its plain version,
    nw_pairs_stats_ref = stats_from_cls over nw_wavefront_ref's B2 class
    rows and ends (`want`, computed once for every setting); returns the
    largest |kernel - plain| over the (allow_one_off, max_shift)
    settings."""
    import torch

    err = 0
    for oo, ms in settings:
        got = nww.nw_pairs_stats(*t, allow_one_off=oo, max_shift=ms, **geom)
        torch.cuda.synchronize()
        ref = nww.stats_from_cls(want[0], want[3], allow_one_off=oo,
                                 max_shift=ms)
        err = max(err, max_abs_diff([got], [ref]))
    return err


def b4_pairs(rng, n, len1, nops, lo=None, homo=False):
    """n pairs (s1, s2): random s1 of length len1 (or lo..len1), runs of
    3..7 equal bases planted if homo, and s2 = s1 with up to nops random
    substitutions, insertions and deletions."""
    import numpy as np

    out = []
    for _ in range(n):
        L = len1 if lo is None else int(rng.integers(lo, len1 + 1))
        a = rng.integers(0, 4, L).astype(np.uint8)
        if homo:
            for _ in range(max(1, L // 40)):
                p = int(rng.integers(0, L - 8))
                a[p: p + int(rng.integers(3, 8))] = int(rng.integers(0, 4))
        out.append((a, mutate(rng, a, nops, False)))
    return out


def b4_tensors(pairs, dev):
    """Kernel B4's inputs for pairs: codes padded with 255 and lengths, as
    tensors on dev."""
    import numpy as np
    import torch

    n = len(pairs)
    L1 = max(len(a) for a, _ in pairs)
    L2 = max(len(b) for _, b in pairs)
    s1 = np.full((n, L1), 255, np.uint8)
    s2 = np.full((n, L2), 255, np.uint8)
    for k, (a, b) in enumerate(pairs):
        s1[k, : len(a)] = a
        s2[k, : len(b)] = b
    lens = [np.array([len(x[i]) for x in pairs], np.int64) for i in (0, 1)]
    return [torch.from_numpy(x).to(dev) for x in (s1, lens[0], s2, lens[1])]


def pair_cells(l1, l2, band):
    """In-band DP cells of each pair: for each row i <= len1, the j in
    [max(0, i - lband), min(len2, i + rband)] (every cell if band < 0)."""
    import numpy as np

    l1 = np.asarray(l1, np.int64)
    l2 = np.asarray(l2, np.int64)
    if band < 0:
        return int(((l1 + 1) * (l2 + 1)).sum())
    lb = band + np.maximum(0, l1 - l2)
    rb = band + np.maximum(0, l2 - l1)
    cells = 0
    for k in range(0, len(l1), 8192):
        sl = slice(k, k + 8192)
        ii = np.arange(int(l1[sl].max()) + 1)[None, :]
        lo = np.maximum(0, ii - lb[sl, None])
        hi = np.minimum(l2[sl, None], ii + rb[sl, None])
        n = np.clip(hi - lo + 1, 0, None) * (ii <= l1[sl, None])
        cells += int(n.sum())
    return cells


def b4_bound(nbytes, cells, homo):
    """(bound_ms, bound_by, detail) of kernel B4 for nbytes read and
    written once and cells in-band cells."""
    ops = OPS_PER_CELL + (B4_HOMO_OPS if homo else 0)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = cells * ops / INT32_OPS_PER_S * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), by, (
        f"{nbytes} bytes -> {t_bytes:.4f} ms; {cells} in-band cells x {ops} "
        f"int32 ops -> {t_ops:.4f} ms")


def nbytes_of(tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


# ---- main ------------------------------------------------------------------

def main() -> None:
    try:
        import numpy as np
        import pandas as pd
        import torch
    except ImportError as e:
        fail(f"missing dependency: {e}")
    sys.path.insert(0, ROOT)
    try:
        import dada2_tpu_torch as dt
        from dada2_tpu_torch import chimeras as chim
        from dada2_tpu_torch.core.backend_cuda import CudaBackend
        from dada2_tpu_torch.core.raws import make_rawset
        from dada2_tpu_torch.encode import pack_sequences, rc
        from dada2_tpu_torch.ops import nw_batch as nwb
        from dada2_tpu_torch.ops import nw_wavefront as nww
        from dada2_tpu_torch.options import DEFAULT_OPTIONS
    except ImportError as e:
        fail(f"dada2_tpu_torch is not importable next to this script: {e}")
    if "jax" in sys.modules or "dada2_tpu" in sys.modules:
        fail("the port imported jax or dada2_tpu")
    launches = nww.nw_wavefront.launches

    def reset_launches():
        for k in launches:
            launches[k] = 0
        nwb.nw_batch.launches = 0

    def counts():
        return dict(launches, B4=nwb.nw_batch.launches)

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

    # 2. build: one nvcc per source, started together
    t0 = time.time()
    reports, build_errors = {}, {}

    def build(name, fn):
        try:
            reports[name] = fn()
        except RuntimeError as e:
            build_errors[name] = e

    builders = [threading.Thread(target=build, args=job) for job in (
        ("nw_wavefront.cu", nww.build_kernel),
        ("nw_batch.cu", nwb.build_kernel))]
    for th in builders:
        th.start()
    for th in builders:
        th.join()
    if build_errors:
        fail(f"kernel build: {build_errors}")
    log(f"[build] nw_wavefront.cu and nw_batch.cu built in "
        f"{time.time() - t0:.1f}s; ptxas reports:")
    for name, rep in reports.items():
        for line in rep.strip().splitlines():
            log(f"[build]   {name}: {line.strip()}")
    ptxas = reports["nw_wavefront.cu"]
    entries = ptxas.count("Compiling entry function")
    if entries != 16:
        fail(f"expected 16 kernel instantiations (4 windows x B1's kernel "
             f"and three modes of the other body), ptxas compiled {entries}")
    entries = reports["nw_batch.cu"].count("Compiling entry function")
    if entries != 6:
        fail(f"expected 6 instantiations of kernel B4 (vec, scalar and "
             f"homopolymer x two slab routes), ptxas compiled {entries}")
    b1_regs = ptxas_registers(ptxas, "nw_compare_kernel")
    if sorted(b1_regs) != [1, 2, 3, 4]:
        fail(f"B1's four instantiations not found in the ptxas report: "
             f"{b1_regs}")

    def b1_fit(geom, nb):
        """B1's pairs per block for a launch, its blocks per SM and the
        instantiation's registers, as printed on the [kernel]/[time]
        lines."""
        P = nww.pairs_per_block(geom["L1R"], geom["L2R"], geom["NDP"],
                                geom["WP"], 1, nb)
        bps = nww.compare_blocks_per_sm(geom["L1R"], geom["L2R"],
                                        geom["NDP"], geom["WP"], P)
        return (f"P={P} pairs/block, {bps} blocks/SM, "
                f"{b1_regs[geom['WP'] // 32]} registers"), P

    # 3. kernel B1 against its plain version, bitwise
    rng = np.random.default_rng(2024)
    cases = [  # (len1, candidates, max edits, band, WP, substitutions only)
        (250, 400, 12, 16, 32, True),
        (252, 300, 10, 16, 64, False),
        (448, 260, 16, 16, 96, False),
        (452, 390, 8, 16, 128, True),
    ]
    # B1 launches of 1 to 66 blocks (each pairs-per-block choice the fit
    # makes as the launch grows) and PacBio full-length 16S launches
    b1_cases = cases + [
        (250, 100, 12, 16, 32, True),
        (251, 5 * 128 - 7, 12, 16, 32, True),
        (249, 9 * 128 - 50, 10, 16, 32, True),
        (250, 17 * 128, 12, 16, 32, True),
        (252, 33 * 128 - 1, 12, 16, 32, True),
        (250, 66 * 128, 8, 16, 32, True),
        (253, 17 * 128 - 3, 10, 16, 64, False),
        (1450, 200, 30, 16, 64, False),
        (1450, 9 * 128 - 20, 30, 16, 64, False),
    ]
    err_b = {"B1": 0, "B2": 0, "B2cls": 0, "B3": 0}
    b1_ps = set()
    for len1, ncand, nops, band, wp, uniform in b1_cases:
        arrays, geom = fuzz_case(rng, nww, len1, ncand, nops, band, wp,
                                 uniform)
        err, ok_tb, _, _ = kernel_vs_plain(nww, dev, arrays, geom, False,
                                           False)
        err_b["B1"] = max(err_b["B1"], err)
        fit, P = b1_fit(geom, arrays[0].shape[0])
        b1_ps.add(P)
        log(f"[kernel] len1={len1} blocks={arrays[0].shape[0]} WP={wp} "
            f"NDP={geom['NDP']} {'uniform' if uniform else 'mixed'}, {fit}: "
            f"max |kernel - plain| = {err}, tracebacks complete: {ok_tb}")
        if err != 0 or not ok_tb:
            fail(f"kernel B1 disagrees with its plain version (WP={wp})")
    # geometry that fails: one lane with len2 > len2max, and (NDP cut
    # below len1 + len2max of the longer blocks) whole blocks
    arrays, geom = fuzz_case(rng, nww, 250, 3 * 128, 12, 16, 64, False)
    scal, params = arrays[0].copy(), arrays[1].copy()
    params[0, 0, 5] = scal[0, 1] + 1
    geom = dict(geom, NDP=int(scal[0, 0] + scal[:, 1].min() + 1))
    nfail = int((scal[:, 0] + scal[:, 1] >= geom["NDP"]).sum())
    err, _, t, _ = kernel_vs_plain(nww, dev, (scal, params) + arrays[2:],
                                   geom, False, False)
    got_end = nww.nw_compare(*t, **geom)[2]
    nbad = int(((got_end[:, 0] != 0) | (got_end[:, 1] != 0)).sum())
    err_b["B1"] = max(err_b["B1"], err)
    log(f"[kernel] failed geometry: one lane and {nfail} of "
        f"{scal.shape[0]} blocks (NDP={geom['NDP']}), {b1_fit(geom, 3)[0]}: "
        f"max |kernel - plain| = {err}, {nbad} lanes report a failed "
        "traceback")
    if err != 0 or nbad < 1 + 128 * nfail or nfail < 1:
        fail("kernel B1 disagrees with its plain version where the "
             "geometry fails")
    log(f"[kernel] B1 pairs per block covered: {sorted(b1_ps)}")

    # 3b. kernels B2, B2 stats and B3 against the plain version, bitwise
    pair_cases = [  # ([(len1, pairs, max edits, subs only) per block], WP)
        ([(250, 128, 12, False), (248, 128, 12, False),
          (253, 90, 10, True)], 32),
        ([(251, 128, 10, False), (240, 128, 14, False)], 64),
        ([(252, 128, 16, False), (249, 77, 16, False)], 96),
        ([(250, 128, 8, True), (260, 128, 8, False),
          (245, 128, 8, False)], 128),
        ([(1450, 128, 30, False), (1447, 100, 30, False)], 64),
    ]
    for blocks, wp in pair_cases:
        arrays, geom = pairs_case(rng, nww, blocks, 16, wp)
        ppb = nww.pairs_per_block(geom["L1R"], geom["L2R"], geom["NDP"], wp,
                                  2)
        ppb_s = nww.pairs_per_block(geom["L1R"], geom["L2R"], geom["NDP"],
                                    wp, nww.STATS_MODE)
        err, ok_tb, t, want = kernel_vs_plain(nww, dev, arrays, geom, "cls",
                                              True)
        err_b["B2cls"] = max(err_b["B2cls"], err)
        err_s = stats_vs_plain(nww, t, want, geom)
        err_b["B2"] = max(err_b["B2"], err_s)
        log(f"[modes] B2 len1={[b[0] for b in blocks]} WP={wp} "
            f"NDP={geom['NDP']} L1R={geom['L1R']} pairs/block={ppb} (stats "
            f"{ppb_s}): class rows max |kernel - plain| = {err}, tracebacks "
            f"complete: {ok_tb}; stats over {len(STATS_SETTINGS)} "
            f"(allow_one_off, max_shift) settings max |kernel - plain| = "
            f"{err_s}")
        if err != 0 or not ok_tb or err_s != 0:
            fail(f"kernel B2 disagrees with its plain version (WP={wp})")
    kinds_cases = cases + [(1450, 200, 30, 16, 64, False)]
    for len1, ncand, nops, band, wp, uniform in kinds_cases:
        arrays, geom = fuzz_case(rng, nww, len1, ncand, nops, band, wp,
                                 uniform)
        ppb = nww.pairs_per_block(geom["L1R"], geom["L2R"], geom["NDP"], wp,
                                  3)
        err, ok_tb, _, _ = kernel_vs_plain(nww, dev, arrays, geom, True,
                                           False)
        err_b["B3"] = max(err_b["B3"], err)
        log(f"[modes] B3 len1={len1} blocks={arrays[0].shape[0]} WP={wp} "
            f"NDP={geom['NDP']} pairs/block={ppb}: max |kernel - plain| = "
            f"{err}, tracebacks complete: {ok_tb}")
        if err != 0 or not ok_tb:
            fail(f"kernel B3 disagrees with its plain version (WP={wp})")

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
    # BAND_SIZE=0: every candidate gapless on the host, no kernel
    reset_launches()
    res0_gpu = dt.dada(drp, err=err41, BAND_SIZE=0, device="cuda",
                       verbose=False)
    n_band0 = dict(launches)
    res0_cpu = dt.dada(dt.derep_fastq(SAM1F), err=err41, BAND_SIZE=0,
                       device="cpu", verbose=False)
    try:
        same_result(res0_gpu, res0_cpu, "sam1F BAND_SIZE=0 card vs CPU")
    except AssertionError as e:
        fail(f"sam1F dada(BAND_SIZE=0) on the card differs from the CPU "
             f"run: {e}")
    log(f"[small] sam1F BAND_SIZE=0: {len(res0_gpu.denoised)} ASVs, "
        f"kernel launches {n_band0}; card == CPU")
    if any(n_band0.values()):
        fail("dada(BAND_SIZE=0) launched a kernel")

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
    reset_launches()
    t0 = time.time()
    res = dt.dada(sim, err=None, selfConsist=True, device="cuda",
                  verbose=False)
    torch.cuda.synchronize()
    wall = time.time() - t0
    n_b1 = launches["B1"]
    peak = torch.cuda.max_memory_allocated()
    rounds = len(res.err_in)
    log(f"[main] dada(selfConsist=True): {len(sim.uniques)} uniques, "
        f"{rounds} rounds, {len(res.denoised)} ASVs, {wall:.2f}s wall")
    log(f"[main] phases: {dt.PHASES.summary()}")
    log(f"[main] counters: {dt.COUNTERS.summary()}")
    log(f"[main] kernel launches: {dict(launches)}; "
        f"max_memory_allocated: {peak} bytes")
    if n_b1 <= 0:
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
    be._kernel_geom(int(rs.lens[0]), opts)   # the sweep's own fit check
    args, geom, scal, params = b1_bucket_inputs(nww, be, opts, dev)
    got = nww.nw_compare(*args, **geom)
    want = nww.nw_wavefront_ref(*args, **geom)
    err_main = max_abs_diff(got, want)
    nb = args[0].shape[0]
    fit, P = b1_fit(geom, nb)
    log(f"[time] main-path inputs: {nb} blocks x 128 lanes, WP="
        f"{geom['WP']}, L1R={geom['L1R']} L2R={geom['L2R']} NDP="
        f"{geom['NDP']}, {fit}; max |kernel - plain| = {err_main}")
    if err_main != 0:
        fail("kernel B1 disagrees with its plain version on main-path "
             "inputs")
    err_b["B1"] = max(err_b["B1"], err_main)
    ms = cuda_ms(lambda: nww.nw_compare(*args, **geom), 20)
    plain_ms = cuda_ms(lambda: nww.nw_wavefront_ref(*args, **geom), 2)
    bound_ms, bound_by, detail = bound(args, got, scal, params)
    log(f"[time] kernel B1 {ms:.4f} ms ({fit}), plain {plain_ms:.2f} ms; "
        f"bound {bound_ms:.4f} ms by {bound_by} ({detail}); card {card}")
    rows = {"B1": dict(launches=n_b1, ms=ms, plain_ms=plain_ms,
                       bound_ms=bound_ms, bound_by=bound_by,
                       pairs_per_block=P)}
    # B1 at one block of those inputs, and at samPB's geometry (BAND_SIZE
    # 32: the center is the most abundant unique)
    one = (args[0][:1], args[1][:1], args[2], args[3][:1].contiguous())
    drp_pb = dt.derep_fastq(SAMPB)
    rs_pb = make_rawset(drp_pb.sequences, drp_pb.abundances, None,
                        drp_pb.quals)
    opts_pb = DEFAULT_OPTIONS.replace(BAND_SIZE=32).normalized()
    pb_args, pb_geom, pb_scal, pb_params = b1_bucket_inputs(
        nww, CudaBackend(rs_pb, device=dev), opts_pb, dev)
    for label, a1, g1, sp in (
            ("one block", one, geom, (scal[:1], params[:1])),
            ("samPB", pb_args, pb_geom, (pb_scal, pb_params))):
        got1 = nww.nw_compare(*a1, **g1)
        e1 = max_abs_diff(got1, nww.nw_wavefront_ref(*a1, **g1))
        err_b["B1"] = max(err_b["B1"], e1)
        t1 = cuda_ms(lambda: nww.nw_compare(*a1, **g1), 20)
        b1_ms, b1_by, _ = bound(a1, got1, *sp)
        log(f"[time] kernel B1 at {label} ({a1[0].shape[0]} blocks, WP="
            f"{g1['WP']}, NDP={g1['NDP']}, L1R={g1['L1R']}, "
            f"{b1_fit(g1, a1[0].shape[0])[0]}): {t1:.4f} ms, bound "
            f"{b1_ms:.4f} ms by {b1_by}; max |kernel - plain| = {e1}; card "
            f"{card}")
        if e1 != 0:
            fail(f"kernel B1 disagrees with its plain version at {label}")

    # 6. where the main path's device time goes (fresh backend, so the
    # kernel runs again)
    profile_device("selfConsist run", lambda: dt.dada(
        sim, err=None, selfConsist=True, device="cuda", verbose=False))

    # 7. the chimera slice, small: card against CPU, identical
    def small_table(device):
        dereps = {"sam1": dt.derep_fastq(SAM1F),
                  "sam2": dt.derep_fastq(SAM2F)}
        dadas = dt.dada(dereps, err=err41, device=device, verbose=False)
        st = dt.make_sequence_table(dadas)
        return st, {m: dt.remove_bimera_denovo(st, method=m, device=device)
                    for m in ("consensus", "pooled", "per-sample")}, dadas

    t0 = time.time()
    st_gpu, nochim_gpu, dadas_f_gpu = small_table("cuda")
    t_gpu = time.time() - t0
    t0 = time.time()
    st_cpu, nochim_cpu, dadas_f_cpu = small_table("cpu")
    t_cpu = time.time() - t0
    try:
        pd.testing.assert_frame_equal(st_gpu, st_cpu)
        for m in nochim_gpu:
            pd.testing.assert_frame_equal(nochim_gpu[m], nochim_cpu[m],
                                          obj=m)
    except AssertionError as e:
        fail(f"the sam1F+sam2F chimera slice differs card vs CPU: {e}")
    log(f"[table] sam1F+sam2F: sequence table {st_gpu.shape}; without "
        f"bimeras: " + ", ".join(f"{m} {v.shape[1]} ASVs"
                                 for m, v in nochim_gpu.items())
        + f"; card {t_gpu:.2f}s, CPU {t_cpu:.2f}s; identical")

    # 8. kernel B3's path: one center against every sam1F unique
    codes, lens = pack_sequences(drp.sequences)
    gkw = dict(match=5, mismatch=-4, gap_p=-8, band=16)
    reset_launches()
    t0 = time.time()
    g_gpu = nww.nw_wavefront_grouped(codes[0], int(lens[0]), codes, lens,
                                     device="cuda", **gkw)
    t_gpu = time.time() - t0
    n_b3 = launches["B3"]
    g_cpu = nww.nw_wavefront_grouped(codes[0], int(lens[0]), codes, lens,
                                     device="cpu", **gkw)
    same = all(np.array_equal(a, b) for a, b in zip(g_gpu, g_cpu))
    log(f"[grouped] sam1F center vs {len(lens)} uniques: card {t_gpu:.2f}s, "
        f"B3 launches {n_b3}; kinds/p0/p1/ham/tvec/ok card == CPU: {same}; "
        f"all tracebacks ok: {bool(g_gpu[5].all())}")
    if not same or n_b3 <= 0 or not g_gpu[5].all():
        fail("nw_wavefront_grouped on the card differs from the CPU or "
             "never launched kernel B3")
    _, arrays, ggeom = nww.grouped_inputs(codes[0], int(lens[0]), codes,
                                          lens, 16)
    gargs = [torch.from_numpy(a).to(dev) for a in arrays]
    gkw3 = dict(match=5, mismatch=-4, gap_p=-8, emit_kinds=True, **ggeom)
    got = nww.nw_wavefront(*gargs, **gkw3)
    want = nww.nw_wavefront_ref(*gargs, **gkw3)
    err_b["B3"] = max(err_b["B3"], max_abs_diff(got, want))
    ms = cuda_ms(lambda: nww.nw_wavefront(*gargs, **gkw3), 20)
    plain_ms = cuda_ms(lambda: nww.nw_wavefront_ref(*gargs, **gkw3), 2)
    bound_ms, bound_by, detail = bound(gargs, got, arrays[0], arrays[1])
    log(f"[time] kernel B3 at {arrays[0].shape[0]} blocks, WP="
        f"{ggeom['WP']}: {ms:.4f} ms, plain {plain_ms:.2f} ms; bound "
        f"{bound_ms:.4f} ms by {bound_by} ({detail}); max |kernel - plain| "
        f"= {err_b['B3']}; card {card}")
    if err_b["B3"] != 0:
        fail("kernel B3 disagrees with its plain version on the grouped "
             "path's inputs")
    rows["B3"] = dict(launches=n_b3, ms=ms, plain_ms=plain_ms,
                      bound_ms=bound_ms, bound_by=bound_by)

    # 9. the consensus chimera check at real size
    mat, seqs = chimera_fixture()
    st = pd.DataFrame(mat, index=[f"s{i}" for i in range(mat.shape[0])],
                      columns=seqs)
    copts = dt.options.current_options()
    dt.PHASES.reset()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.time()
    bim = dt.is_bimera_denovo_table(st, device="cuda")
    torch.cuda.synchronize()
    wall = time.time() - t0
    n_b2, n_b1_tab = launches["B2"], launches["B1"]
    peak = torch.cuda.max_memory_allocated()
    pairs = chim._table_pairs(mat, 1.5, 2)
    qi = np.ascontiguousarray(pairs[:, 0])
    pi = np.ascontiguousarray(pairs[:, 1])
    be, bopts = chim._chimera_backend(seqs, copts.MATCH, copts.MISMATCH,
                                      copts.GAP_PENALTY, 16, dev)
    plan = chim._pairs_plan(be, bopts, qi, pi)
    route = ("pairs" if n_b2 > 0 and n_b1_tab == 0 else
             "per-query" if n_b1_tab > 0 and n_b2 == 0 else "none")
    nblocks = plan.qblk.shape[0] if plan is not None else 0
    log(f"[chimera] is_bimera_denovo_table on {mat.shape[1]} ASVs x "
        f"{mat.shape[0]} samples: {wall:.2f}s wall, {len(pairs)} pairs, "
        f"{nblocks} blocks, B2 launches {n_b2}, B1 launches {n_b1_tab}, "
        f"route {route}, {int(bim.sum())} bimeras flagged, "
        f"max_memory_allocated {peak} bytes")
    log(f"[chimera] phases: {dt.PHASES.summary()}")
    if route != "pairs" or n_b2 <= 0:
        fail("the table chimera check did not run through kernel B2")
    rows["B2"] = dict(launches=n_b2)
    t0 = time.time()
    b2 = chim._pairs_lr_stats(be, bopts, qi, pi, 16, False)
    t_b2 = time.time() - t0
    nflag, nsam = chim._table_votes(mat, seqs, pairs, b2, 1.5, 2, False, 4)
    is_bim = (nflag >= nsam) | ((nflag > 0) & (nflag >= (nsam - 1) * 0.9))
    if not np.array_equal(is_bim, bim.values):
        fail("the table run's flags differ from kernel B2's stats' votes")
    # kernel B1's per-query route on the same pairs: the first 1000 query
    # columns, and the rest if they fit PER_QUERY_SECONDS
    cut = int(np.searchsorted(qi, 1000))
    t0 = time.time()
    b1 = chim._per_query_lr_stats(be, bopts, qi[:cut], pi[:cut], 16, False)
    t_first = time.time() - t0
    done = cut
    if t_first * len(qi) / max(cut, 1) <= PER_QUERY_SECONDS:
        rest = chim._per_query_lr_stats(be, bopts, qi[cut:], pi[cut:], 16,
                                        False)
        b1 = tuple(np.concatenate([a, r]) for a, r in zip(b1, rest))
        done = len(qi)
    t_b1 = time.time() - t0
    same = all(np.array_equal(a[:done], b) for a, b in zip(b2, b1))
    ncols = len(np.unique(qi[:done]))
    log(f"[chimera] B2 route {t_b2:.2f}s for all {len(qi)} pairs; B1 "
        f"per-query route {t_b1:.2f}s for {done} pairs of {ncols} query "
        f"columns" + ("" if done == len(qi) else
                      " (restricted to the first 1000 query columns: all "
                      f"would take over {PER_QUERY_SECONDS:.0f}s)")
        + f"; five lr/ham arrays identical: {same}")
    if not same:
        fail("kernel B2's route and kernel B1's per-query route disagree")
    # the port on the CPU over the columns with the most pairs (the fewest
    # such columns whose pairs number at least 5,000)
    cnt = np.bincount(qi, minlength=mat.shape[1])
    top = np.argsort(-cnt, kind="stable")
    cols = top[: int(np.searchsorted(np.cumsum(cnt[top]), 5000)) + 1]
    sub = np.isin(qi, cols)
    t0 = time.time()
    stats_cpu = chim._batch_lr_stats(pairs[sub], seqs, 16, copts.MATCH,
                                     copts.MISMATCH, copts.GAP_PENALTY,
                                     False, device="cpu")
    nflag_c, nsam_c = chim._table_votes(mat, seqs, pairs[sub], stats_cpu,
                                        1.5, 2, False, 4)
    t_cpu = time.time() - t0
    same = (np.array_equal(nflag_c[cols], nflag[cols])
            and np.array_equal(nsam_c[cols], nsam[cols])
            and all(np.array_equal(a, b[sub]) for a, b in zip(stats_cpu,
                                                              b2)))
    log(f"[chimera] CPU check: columns {cols.tolist()} ({int(sub.sum())} "
        f"pairs) in {t_cpu:.2f}s: nflag {nflag[cols].tolist()}, nsam "
        f"{nsam[cols].tolist()}; card == CPU: {same}")
    if not same:
        fail("the table's (nflag, nsam) on the card differ from the CPU")

    # 10. kernel B2 at one full launch of the table: the stats kernel
    # against the class-row kernel plus the torch scans it replaced
    CH = chim.CH_BLOCKS
    args = chim._pairs_launch_inputs(be, plan, 0, CH)
    g2 = dict(L1R=plan.L1R, L2R=plan.L2R, NDP=plan.NDP, WP=plan.WP,
              match=copts.MATCH, mismatch=copts.MISMATCH,
              gap_p=copts.GAP_PENALTY)
    skw = dict(allow_one_off=False, max_shift=16)
    ckw = dict(emit_kinds="cls", s1_per_block=True, **g2)
    got = nww.nw_wavefront(*args, **ckw)
    want = nww.nw_wavefront_ref(*args, **ckw)
    err_b["B2cls"] = max(err_b["B2cls"], max_abs_diff(got, want))
    del got
    err_b["B2"] = max(err_b["B2"], stats_vs_plain(
        nww, args, want, g2, [(False, 16), (True, 16)]))
    del want

    def cls_route():   # what the route ran before: class rows, then scans
        cls_b, _s, _m, end_b = nww.nw_wavefront(*args, **ckw)
        return nww.stats_from_cls(cls_b, end_b, **skw)

    def stats_kernel():
        return nww.nw_pairs_stats(*args, **g2, **skw)

    cls_plain_ms = cuda_ms(lambda: nww.nw_wavefront_ref(*args, **ckw), 1)
    if not torch.equal(cls_route(), stats_kernel()):
        fail("the stats kernel differs from class rows + torch scans on "
             "the table's launch")
    # in turns on one card: class rows + scans, stats, stats, class rows +
    # scans (and the class-row kernel alone, first and last)
    t_cls = [cuda_ms(lambda: nww.nw_wavefront(*args, **ckw), 10)]
    t_route = [cuda_ms(cls_route, 10)]
    t_stats = [cuda_ms(stats_kernel, 10), cuda_ms(stats_kernel, 10)]
    t_route.append(cuda_ms(cls_route, 10))
    t_cls.append(cuda_ms(lambda: nww.nw_wavefront(*args, **ckw), 10))
    ms = t_stats[0]
    plain_ms = cuda_ms(lambda: nww.nw_pairs_stats_ref(*args, **g2, **skw), 1)
    bound_ms, bound_by, detail = bound(args, [stats_kernel()],
                                       args[0].cpu().numpy(),
                                       args[1].cpu().numpy())
    log(f"[time] kernel B2 at one launch ({CH} blocks x 128 pairs, "
        f"WP={plan.WP}, L1R={plan.L1R} L2R={plan.L2R} NDP={plan.NDP}), in "
        f"turns: class rows + torch scans {t_route[0]:.4f} ms, stats kernel "
        f"{t_stats[0]:.4f} ms, {t_stats[1]:.4f} ms, class rows + torch "
        f"scans {t_route[1]:.4f} ms; the class-row kernel alone "
        f"{t_cls[0]:.4f} / {t_cls[1]:.4f} ms; stats plain {plain_ms:.2f} "
        f"ms; bound {bound_ms:.4f} ms by {bound_by} ({detail}); max "
        f"|kernel - plain| = {err_b['B2']} (stats), {err_b['B2cls']} (class "
        f"rows); card {card}")
    if err_b["B2"] != 0 or err_b["B2cls"] != 0:
        fail("kernel B2 disagrees with its plain version on the table's "
             "inputs")
    rows["B2"].update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                      bound_by=bound_by)
    # the class-row mode: no route launches it (launches 0), timed here
    rows["B2cls"] = dict(launches=0, ms=t_cls[0], plain_ms=cls_plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by,
                         with_torch_scans_ms=t_route[0])
    del args, be

    # 11. where the table run's device time goes; the route must launch
    # the stats kernel only: no class rows, no torch scans over them
    by_name = profile_device("is_bimera_denovo_table run", lambda:
                             dt.is_bimera_denovo_table(st, device="cuda"))
    if by_name:
        names = list(by_name)
        scans = [n for n in names
                 if "tensor_kernel_scan_innermost_dim" in n]
        cls_k = [n for n in names if "nw_wavefront_kernel" in n
                 and ", true, 2>" in n]
        stats_k = [n for n in names if "nw_wavefront_kernel" in n
                   and ", true, 3>" in n]
        log(f"[profile] table run: stats kernel {stats_k}, class-row "
            f"kernel {cls_k}, scan kernels {scans}")
        if scans or cls_k or not stats_k:
            fail("the table run launched a class-row or scan kernel, or "
                 "not the stats kernel")

    # 12. kernel B4 against its plain version on the card, bitwise
    rng = np.random.default_rng(2026)
    sc5 = dict(match=5, mismatch=-4, gap_p=-8)
    merge64 = dict(match=1, mismatch=-64, gap_p=-64, mode="scalar", band=-1)
    merge8 = dict(match=1, mismatch=-8, gap_p=-8, mode="scalar", band=-1)
    merge_like = [(a[:240], b[50:]) for a, b in b4_pairs(rng, 200, 250, 4)]
    b4_cases = [
        ("vec band 2", b4_pairs(rng, 300, 250, 6), dict(sc5, band=2)),
        ("vec band 4, end gaps -8", b4_pairs(rng, 300, 248, 8),
         dict(sc5, band=4, end_gap_p=-8)),
        ("vec band 16, mixed lengths", b4_pairs(rng, 500, 300, 12, lo=60),
         dict(sc5, band=16)),
        ("vec band 32", b4_pairs(rng, 300, 252, 16), dict(sc5, band=32)),
        ("vec unbanded", b4_pairs(rng, 200, 250, 20), dict(sc5, band=-1)),
        ("vec unbanded, end gaps -8, mixed lengths",
         b4_pairs(rng, 100, 140, 20, lo=30),
         dict(sc5, band=-1, end_gap_p=-8)),
        ("scalar band 16", b4_pairs(rng, 300, 250, 12),
         dict(sc5, band=16, mode="scalar")),
        ("scalar band 4, end gaps -8", b4_pairs(rng, 300, 251, 8),
         dict(sc5, band=4, end_gap_p=-8, mode="scalar")),
        ("scalar band 32, homopolymer -1",
         b4_pairs(rng, 300, 250, 12, homo=True),
         dict(sc5, band=32, mode="scalar", homo_gap_p=-1)),
        ("scalar band 2, homopolymer -3",
         b4_pairs(rng, 300, 249, 6, homo=True),
         dict(sc5, band=2, mode="scalar", homo_gap_p=-3)),
        ("scalar unbanded, homopolymer -3, mixed lengths",
         b4_pairs(rng, 200, 260, 12, lo=100, homo=True),
         dict(sc5, band=-1, mode="scalar", homo_gap_p=-3)),
        ("scalar unbanded, homopolymer -1, end gaps -8",
         b4_pairs(rng, 150, 250, 12, homo=True),
         dict(sc5, band=-1, mode="scalar", homo_gap_p=-1, end_gap_p=-8)),
        ("merge scoring (1, -64, -64)", merge_like, merge64),
        ("merge scoring (1, -8, -8)", merge_like, merge8),
    ]
    # samPB's full-length reads: the most abundant against the next 127 at
    # band 32 with homopolymer gaps (the PacBio configuration), and four
    # of them unbanded (the device-memory slab), whole and one per chunk
    pb_codes, pb_lens = pack_sequences(drp_pb.sequences[:128])
    pb_pairs = [(pb_codes[0, : pb_lens[0]], pb_codes[k, : pb_lens[k]])
                for k in range(1, 128)]
    pbkw = dict(sc5, mode="scalar", homo_gap_p=-1)
    b4_cases += [
        ("samPB band 32, homopolymer -1", pb_pairs, dict(pbkw, band=32)),
        ("samPB unbanded (device-memory slab)", pb_pairs[:4],
         dict(pbkw, band=-1)),
        ("samPB unbanded, one pair per launch", pb_pairs[:4],
         dict(pbkw, band=-1, one_pair_per_launch=True)),
    ]
    err_b["B4"] = 0
    for label, pairs, kw in b4_cases:
        kw = dict(kw)
        one_per_launch = kw.pop("one_pair_per_launch", False)
        args = b4_tensors(pairs, dev)
        nd, W = nwb.batch_geometry(args[1].cpu().numpy(),
                                   args[3].cpu().numpy(), kw["band"])
        homo = kw.get("homo_gap_p") is not None
        route = nwb.slab_route(args[0].shape[1], args[2].shape[1], nd, W,
                               homo)
        before = nwb.nw_batch.launches
        budget = nwb.MAX_BYTES
        nwb.MAX_BYTES = 1 if one_per_launch else budget
        try:
            got = nwb.nw_batch(*args, **kw)
            torch.cuda.synchronize()
        finally:
            nwb.MAX_BYTES = budget
        nl = nwb.nw_batch.launches - before
        want = nwb.nw_batch_ref(*args, **kw)
        err = max_abs_diff(got, want)
        ok_tb = bool(got[5].all())
        err_b["B4"] = max(err_b["B4"], err)
        log(f"[batch] {label}: {len(pairs)} pairs, L1={args[0].shape[1]} "
            f"L2={args[2].shape[1]} nd={nd} W={W}, pointers in "
            f"{'shared' if route == 1 else 'device'} memory, {nl} "
            f"launch(es): max |kernel - plain| = {err} over kinds, p0, p1, "
            f"ham, tvec, ok; tracebacks complete: {ok_tb}")
        if err != 0 or not ok_tb or route == 0:
            fail(f"kernel B4 disagrees with its plain version ({label})")
        if "slab" in label and route != 2:
            fail("the unbanded samPB pairs did not take the device-memory "
                 "slab")
        if one_per_launch and nl != len(pairs):
            fail(f"the chunked B4 call made {nl} launches for "
                 f"{len(pairs)} pairs")

    # 13. the paired slice and the configurations B1 does not serve: card
    # against CPU, identical
    def paired_slice(device, dadas_f):
        dereps_f = {"sam1": dt.derep_fastq(SAM1F),
                    "sam2": dt.derep_fastq(SAM2F)}
        dereps_r = {"sam1": dt.derep_fastq(SAM1R),
                    "sam2": dt.derep_fastq(SAM2R)}
        dadas_r = dt.dada(dereps_r, err=err41, device=device, verbose=False)
        merged = dt.merge_pairs(dadas_f, dereps_f, dadas_r, dereps_r,
                                returnRejects=True, device=device)
        st = dt.make_sequence_table(
            {s: m[m["accept"].astype(bool)] for s, m in merged.items()})
        col = dt.collapse_no_mismatch(st, device=device)
        nochim = dt.remove_bimera_denovo(col, method="consensus",
                                         device=device)
        shift = dt.is_shift_denovo(
            dict(zip(nochim.columns, nochim.values.sum(axis=0))),
            device=device)
        return merged, st, col, nochim, shift

    reset_launches()
    t0 = time.time()
    pgpu = paired_slice("cuda", dadas_f_gpu)
    t_gpu = time.time() - t0
    n_paired = counts()
    t0 = time.time()
    pcpu = paired_slice("cpu", dadas_f_cpu)
    t_cpu = time.time() - t0
    try:
        for s in pgpu[0]:
            pd.testing.assert_frame_equal(pgpu[0][s], pcpu[0][s], obj=s)
        for g, c, name in zip(pgpu[1:4], pcpu[1:4],
                              ("table", "collapsed", "nochim")):
            pd.testing.assert_frame_equal(g, c, obj=name)
        pd.testing.assert_series_equal(pgpu[4], pcpu[4])
    except AssertionError as e:
        fail(f"the paired slice differs card vs CPU: {e}")
    log(f"[paired] sam1+sam2 F/R: merged pairings "
        f"{[len(m) for m in pgpu[0].values()]} (accepted "
        f"{[int(m['accept'].sum()) for m in pgpu[0].values()]}), table "
        f"{pgpu[1].shape}, collapsed {pgpu[2].shape}, without bimeras "
        f"{pgpu[3].shape}, shifts flagged {int(pgpu[4].sum())}; reverse "
        f"dada + slice: card {t_gpu:.2f}s, CPU {t_cpu:.2f}s; identical; "
        f"card launches {n_paired}")
    if n_paired["B4"] <= 0:
        fail("the paired slice never launched kernel B4")

    hp = dict(HOMOPOLYMER_GAP_PENALTY=-1, BAND_SIZE=32)
    reset_launches()
    t0 = time.time()
    res_h = dt.dada(drp, err=err41, device="cuda", verbose=False, **hp)
    t_gpu = time.time() - t0
    n_h = counts()
    t0 = time.time()
    res_hc = dt.dada(dt.derep_fastq(SAM1F), err=err41, device="cpu",
                     verbose=False, **hp)
    t_cpu = time.time() - t0
    try:
        same_result(res_h, res_hc, "sam1F homopolymer card vs CPU")
    except AssertionError as e:
        fail(f"dada(sam1F, HOMOPOLYMER_GAP_PENALTY=-1, BAND_SIZE=32) on the "
             f"card differs from the CPU: {e}")
    log(f"[misfit] sam1F HOMOPOLYMER_GAP_PENALTY=-1 BAND_SIZE=32: "
        f"{len(res_h.denoised)} ASVs; card {t_gpu:.2f}s, CPU {t_cpu:.2f}s; "
        f"identical; card launches {n_h}")
    if n_h["B4"] <= 0 or n_h["B1"] != 0:
        fail("the homopolymer configuration must launch B4 and not B1")
    reset_launches()
    t0 = time.time()
    res_u = dt.dada(drp, err=err41, device="cuda", verbose=False,
                    BAND_SIZE=-1)
    t_gpu = time.time() - t0
    n_u = counts()
    t0 = time.time()
    res_uc = dt.dada(dt.derep_fastq(SAM1F), err=err41, device="cpu",
                     verbose=False, BAND_SIZE=-1)
    t_cpu = time.time() - t0
    try:
        same_result(res_u, res_uc, "sam1F BAND_SIZE=-1")
    except AssertionError as e:
        fail(f"dada(BAND_SIZE=-1) on the card differs from the CPU: {e}")
    log(f"[misfit] sam1F BAND_SIZE=-1: {len(res_u.denoised)} ASVs from "
        f"{len(drp.uniques)} uniques; card {t_gpu:.2f}s, CPU {t_cpu:.2f}s; "
        f"identical; card launches {n_u}")
    if n_u["B4"] <= 0 or n_u["B1"] != 0:
        fail("dada(BAND_SIZE=-1) must launch B4 and not B1")

    # 14. kernel B4 at real size. (a) B4's path: phase 5's sample in the
    # homopolymer configuration; the calls into B4 are recorded (geometry
    # only) for the bound and the plain version's time at the largest one
    b4_calls = []
    align_batch = CudaBackend._align_batch

    def recorded(be_, center, idx, opts_):
        b4_calls.append((be_, np.array(center), np.array(idx), opts_))
        return align_batch(be_, center, idx, opts_)

    CudaBackend._align_batch = recorded
    try:
        dt.PHASES.reset()
        reset_launches()
        t0 = time.time()
        res14 = dt.dada(sim, err=None, selfConsist=True, device="cuda",
                        verbose=False, **hp)
        torch.cuda.synchronize()
        wall14 = time.time() - t0
        n14 = counts()
    finally:
        CudaBackend._align_batch = align_batch
    if n14["B4"] <= 0:
        fail("the homopolymer selfConsist run never launched kernel B4")
    cells14 = sum(pair_cells(np.broadcast_to(b.lens[c], len(i)),
                             b.lens[i], o.BAND_SIZE)
                  for b, c, i, o in b4_calls)
    big = max(b4_calls, key=lambda x: len(x[2]))
    bbe, bc, bidx, bo = big
    out = bbe._align_batch(bc, bidx, bo)
    # bytes per pair at sequence width L: s1, s2, the two masks (L each),
    # two int32 lengths; kinds (2L), p0 and p1 (2L int32 each), tvec (L),
    # ham (4), ok (1)
    nb14 = sum(len(i) * (23 * b_.d_seqs.shape[1] + 13)
               for b_, c_, i, o_ in b4_calls)
    bound14, by14, det14 = b4_bound(nb14, cells14, True)
    ms_big = cuda_ms(lambda: bbe._align_batch(bc, bidx, bo), 5)
    run_plain = nwb.nw_batch
    nwb.nw_batch = nwb.nw_batch_ref
    try:
        want = bbe._align_batch(bc, bidx, bo)
        plain_big = cuda_ms(lambda: bbe._align_batch(bc, bidx, bo), 1)
    finally:
        nwb.nw_batch = run_plain
    err_b["B4"] = max(err_b["B4"], max_abs_diff(out, want))
    by_name = profile_device("homopolymer selfConsist run", lambda: dt.dada(
        sim, err=None, selfConsist=True, device="cuda", verbose=False, **hp))
    b4_dev = [v for n_, v in by_name.items() if "nw_batch_kernel" in n_]
    b4_dev_ms = sum(v[0] for v in b4_dev) / 1e3 if b4_dev else None
    log(f"[B4 size] dada(selfConsist=True, HOMOPOLYMER_GAP_PENALTY=-1, "
        f"BAND_SIZE=32) on phase 5's sample: {len(sim.uniques)} uniques, "
        f"{len(res14.err_in)} rounds, {len(res14.denoised)} ASVs, "
        f"{wall14:.2f}s wall; launches {n14}; B4 device time "
        f"{b4_dev_ms if b4_dev_ms is None else round(b4_dev_ms, 4)} ms "
        f"(profiled rerun); B4 bound over the run's {len(b4_calls)} calls "
        f"{bound14:.4f} ms by {by14} ({det14}); its largest call "
        f"({len(bidx)} pairs): kernel {ms_big:.4f} ms, plain {plain_big:.2f}"
        f" ms, max |kernel - plain| = {max_abs_diff(out, want)}; card {card}")
    log(f"[B4 size] phases: {dt.PHASES.summary()}")
    eo = np.asarray(res14.err_out)
    if (not np.isfinite(eo).all() or (eo < 0).any() or (eo > 1).any()
            or len(res14.denoised) == 0):
        fail("the homopolymer selfConsist run's outputs are malformed")
    if err_b["B4"] != 0:
        fail("kernel B4 disagrees with its plain version at the dada run's "
             "largest call")

    # (b) B4 at merge shapes: 4,096 F = 240 nt against rc(R) = 200 nt
    mrng = np.random.default_rng(14)
    fwd, rev = [], []
    for s in seqs[:4096]:
        f = list(s[:240])
        r = list(s[50:])
        for x in (f, r):
            for _ in range(2):
                x[int(mrng.integers(0, len(x)))] = "ACGT"[mrng.integers(4)]
        fwd.append("".join(f))
        rev.append(rc("".join(r)))
    m1, l1 = pack_sequences(fwd)
    m2, l2 = pack_sequences([rc(r) for r in rev])
    margs = [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
             for x in (m1, l1.astype(np.int64), m2, l2.astype(np.int64))]
    got = nwb.nw_batch(*margs, **merge64)
    want = nwb.nw_batch_ref(*margs, **merge64)
    err_m = max_abs_diff(got, want)
    err_b["B4"] = max(err_b["B4"], err_m)
    ms_m = cuda_ms(lambda: nwb.nw_batch(*margs, **merge64), 10)
    plain_m = cuda_ms(lambda: nwb.nw_batch_ref(*margs, **merge64), 1)
    bound_m, by_m, det_m = b4_bound(nbytes_of(margs) + nbytes_of(got),
                                    pair_cells(l1, l2, -1), False)
    nd, W = nwb.batch_geometry(l1, l2, -1)
    log(f"[time] kernel B4 at merge shapes (4096 pairs, 240 x 200 nt, "
        f"unbanded, scoring (1, -64, -64), nd={nd} W={W}): {ms_m:.4f} ms, "
        f"plain {plain_m:.2f} ms; bound {bound_m:.4f} ms by {by_m} "
        f"({det_m}); max |kernel - plain| = {err_m}; card {card}")
    if err_m != 0 or not bool(got[5].all()):
        fail("kernel B4 disagrees with its plain version at merge shapes")

    # (c) is_shift_denovo on the table's first 500 ASVs (124,750 pairs)
    unqs = {s: 1000 - k for k, s in enumerate(seqs[:500])}
    reset_launches()
    t0 = time.time()
    shifts = dt.is_shift_denovo(unqs, device="cuda")
    wall_s = time.time() - t0
    n_s = counts()
    by_name = profile_device("is_shift_denovo", lambda: dt.is_shift_denovo(
        unqs, device="cuda"))
    b4_dev = [v for n_, v in by_name.items() if "nw_batch_kernel" in n_]
    shift_dev_ms = sum(v[0] for v in b4_dev) / 1e3 if b4_dev else None
    npairs = 500 * 499 // 2
    bound_s, by_s, det_s = b4_bound(
        npairs * (2 * 250 + 8 + 9 * 500 + 250 + 5),
        pair_cells(np.full(npairs, 250), np.full(npairs, 250), -1), False)
    codes5, lens5 = pack_sequences(seqs[:500])
    qi, pi = np.nonzero(np.triu(np.ones((500, 500), bool), 1).T)
    chunk = [torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in (
        codes5[qi[:4096]], lens5[qi[:4096]].astype(np.int64),
        codes5[pi[:4096]], lens5[pi[:4096]].astype(np.int64))]
    skw = dict(match=copts.MATCH, mismatch=copts.MISMATCH,
               gap_p=copts.GAP_PENALTY, band=-1, mode="scalar")
    got = nwb.nw_batch(*chunk, **skw)
    want = nwb.nw_batch_ref(*chunk, **skw)
    err_s = max_abs_diff(got, want)
    err_b["B4"] = max(err_b["B4"], err_s)
    ms_chunk = cuda_ms(lambda: nwb.nw_batch(*chunk, **skw), 5)
    plain_chunk = cuda_ms(lambda: nwb.nw_batch_ref(*chunk, **skw), 1)
    log(f"[B4 size] is_shift_denovo on {len(unqs)} ASVs ({npairs} unbanded "
        f"pairs): {wall_s:.2f}s wall, launches {n_s}, "
        f"{int(shifts.sum())} flagged; B4 device time "
        f"{shift_dev_ms if shift_dev_ms is None else round(shift_dev_ms, 4)}"
        f" ms (profiled rerun); bound {bound_s:.4f} ms by {by_s} ({det_s}); "
        f"one 4096-pair chunk: kernel {ms_chunk:.4f} ms, plain "
        f"{plain_chunk:.2f} ms, max |kernel - plain| = {err_s}; card {card}")
    if n_s["B4"] <= 0 or err_s != 0:
        fail("is_shift_denovo did not run through kernel B4, or B4 "
             "disagrees with its plain version on its chunk")
    rows["B4"] = dict(launches=n14["B4"], ms=ms_m, plain_ms=plain_m,
                      bound_ms=bound_m, bound_by=by_m,
                      dada_run_b4_device_ms=b4_dev_ms,
                      dada_run_bound_ms=bound14,
                      shift_b4_device_ms=shift_dev_ms,
                      shift_bound_ms=bound_s)

    wave = ("dada2_tpu_torch/csrc/nw_wavefront.cu",
            "dada2_tpu/ops/nw_pallas.py:452")
    kernels = {
        "B1": ("nw_wavefront compare (B1)",) + wave,
        "B2": ("nw_wavefront pairs stats (B2)",) + wave,
        "B2cls": ("nw_wavefront pairs class rows (B2)",) + wave,
        "B3": ("nw_wavefront kinds (B3)",) + wave,
        "B4": ("nw_batch (B4)", "dada2_tpu_torch/csrc/nw_batch.cu",
               "dada2_tpu/ops/nw_batch.py:63")}
    log(json.dumps({"kernels": [dict(
        name=name, route="cuda", source=src, replaces=rep,
        max_abs_err=err_b[k], match=err_b[k] == 0, library_ms=None,
        **rows[k]) for k, (name, src, rep) in kernels.items()]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
