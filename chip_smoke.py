"""Drive dada2_tpu_torch on one CUDA card and check it end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. device  — a CUDA card must be present; prints its nvidia-smi name and
               power limit;
  2. build   — builds the three kernel sources with nvcc from the checkout,
               one nvcc each, started together: csrc/nw_wavefront.cu
               (nw_compare_kernel for B1, B2's class rows and B3, and B2
               stats' body x windows of 32..128 rows, sixteen
               instantiations) and
               csrc/nw_batch.cu
               (kernel B4: the register body, 4 row tiers x vec, scalar
               and homopolymer aligners; the wide body, the three
               aligners; the one-block-per-pair body, the three aligners
               x pointer slab in shared or device memory: twenty-one) and
               csrc/store_screen.cu (kernel B5: the
               one cooperative budded kernel and the follow-up, tiles and
               bits each, the gather mode, the small pack alone and the
               full mode, screened and not: eight);
               prints their `-Xptxas -v` reports;
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
               equal; B2's class rows and B3 also at every pairs per block
               P that fits, and on a lane whose geometry fails, short
               parents (B2) or candidates (B3) of length 0, 1 and 2 and a
               window cut below its band's (tracebacks stuck);
  4. small   — derep_fastq(sam1F) -> dada(err=tperr1()) on the card and on
               the CPU: clustering, map, pval, birth_subs, trans identical,
               the init compare through B5's full mode (its launches
               printed); then the same at BAND_SIZE=0 (every candidate
               gapless on the host), which must launch no kernel;
  5. main    — a simulated 120,000-read MiSeq sample (the DADA2 tutorial
               scale) through dada(selfConsist=True) on the card, with the
               kernels' launch counts reset just before and read just after
               (B1 and B5, the budded compares' one launch, must launch);
               then kernel B1's time (CUDA events) against its plain version
               and its bound, at the main path's largest shapes, and also at
               one block and at samPB.fastq.gz's geometry (BAND_SIZE=32);
  6. profile — the same selfConsist run again under torch.profiler: device
               time by kernel and the device's busy share; one B5 kernel
               per counted wrapper call, in each of its five wrappers;
  7. table   — sam1F and sam2F: derep_fastq -> dada(err=tperr1()) ->
               make_sequence_table -> remove_bimera_denovo with each of the
               three methods, on the card and on the CPU: identical;
  8. grouped — nw_wavefront_grouped (kernel B3's path): one sam1F center
               against every unique on the card and on the CPU, identical,
               with B3's launches counted; then B3's time (CUDA events),
               P, blocks per SM and bound at those shapes (every P that
               fits timed), at phase 5's B1 shape and at samPB's geometry
               (BAND_SIZE 32), each bitwise equal to its plain version;
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
               the stats kernel's plain version time and bound; the
               class-row kernel alone, first and last, with its pairs per
               block P and blocks per SM;
 11. profile — the table run again under torch.profiler: no class-row
               kernel and no scan kernel may appear;
 12. batch   — kernel B4's bodies (ops/nw_batch.py: the route's body,
               the register body up to 256 rows and the wide body above,
               then the one-block-per-pair body forced) against its
               plain version on the card, on seeded fuzz batches: vec and
               scalar aligners, bands 2, 4, 16, 32 and none, homopolymer
               gap penalty none, -1 and -3, end gaps free and -8, mixed
               lengths, lengths near 250, the merge scorings,
               samPB.fastq.gz's full-length reads at band 32 and some
               unbanded (the device-memory pointer slab), chunked and not,
               windows of 32/33, 64/65, 128/129, 256/257, 288, 301, 512
               and 513 rows, band 140 over 256 rows, mixed wide and
               narrow windows, pairs of length 0 and 1, launches of 1, 3,
               4 and 5 pairs at 4 pairs per block and of 4,097 pairs at
               the fit's: all six outputs bitwise equal; each line names
               the body, its rows per thread (RPT), pairs per block (P)
               and warps per pair;
 13. paired  — sam1 and sam2, forward and reverse: dada -> merge_pairs ->
               make_sequence_table -> collapse_no_mismatch ->
               remove_bimera_denovo(consensus) -> is_shift_denovo on the
               card and on the CPU, identical (the forward dada results are
               phase 7's); then dada(sam1F) with HOMOPOLYMER_GAP_PENALTY=-1,
               BAND_SIZE=32 (B4 must launch, B1 must not) and with
               BAND_SIZE=-1 (sam1F's 250 most abundant uniques), card ==
               CPU; kernel launches printed for
               each, B4's by body (the register body must serve them
               all);
 14. B4 size — phase 5's sample through dada(selfConsist=True,
               HOMOPOLYMER_GAP_PENALTY=-1, BAND_SIZE=32) (B4's path: its
               launches counted there; wall, B4 device time, bound over the
               run's launches, plain version at its largest launch); B4 at
               merge shapes (4,096 pairs, F = 240 nt against rc(R) = 200 nt
               from phase 9's ASVs with seeded substitutions, scoring
               (1, -64, -64), no band); is_shift_denovo on phase 9's first
               500 ASVs (124,750 unbanded pairs): wall, B4 device time,
               bound; at merge shapes and on one 4,096-pair chunk both
               bodies in turns, each equal to the plain version, with its
               call time and its launches' time alone (CUDA events),
               and the plain version's time; the register body must serve
               every launch of phase 14.
 15. ends    — (a) the DADA2 tutorial on sam1/sam2 F+R on the card:
               filter_and_trim (truncLen (240, 160), maxN 0, maxEE (2, 2),
               truncQ 2, rm_phix, two spawned worker processes; the
               CPU run below filters in its own process) ->
               derep_fastq -> learn_errors -> dada -> merge_pairs ->
               make_sequence_table -> remove_bimera_denovo(consensus) ->
               assign_taxonomy(example_train_set, tryRC, outputBootstraps)
               -> add_species(example_species_assignment), with the
               kernels' launches counted, then the same on the CPU: the
               filtered files (gunzipped), the error matrices and the
               tables identical; the taxonomy scorer card against CPU on
               the ASVs with assign_taxonomy's own uniforms (best_logp
               within rtol 1e-5; every best genus and bootstrap winner of
               both a top genus within TAX_REL in float64, so equal
               wherever the top-two margin exceeds it; decisions within
               the margin counted), and the taxonomy tables equal on every
               row without such a decision; each stage's wall time on
               both; (b) the scorer at a realistic size: a synthetic
               3,000-genus, six-rank training set (12,000 references
               mutated from ten_16s.100.fa.gz) and 2,000 V4 reads (half
               reverse-complemented) through assign_taxonomy(tryRC,
               outputBootstraps) on the card (wall, stage times, scorer
               calls, genus accuracy, lgk bytes, peak device memory), then
               one batch of 256 reads: the call's time and its device
               work's alone (CUDA events), the CPU's time, the bound, and
               card against CPU as in (a);
 16. dist    — multi-device and multi-process runs on the one card:
               (a) 8 simulated MiSeq samples of 15,000 reads (phase 5's
               120,000 in all; sam1F's ASVs, their own seeds and abundance
               profiles) through dada(selfConsist=True) meshless and with
               mesh=make_mesh(devices=[cuda:0] * 2, samples=2): err_out,
               trans, denoised, clustering and map bitwise equal, B1
               launches equal; (b) phase 5's sample meshless and under
               use_mesh(make_mesh(devices=[cuda:0] * 2)) (each compare
               sweep's B1 blocks split over two shards): both bitwise
               equal to phase 5's result, B1 launches doubled; B1's time
               at phase 5's bucket and at one shard of it; (c) two
               processes (this script with --dist-child) sharing the card
               under torch.distributed's gloo (NCCL refuses two ranks on
               one card), 4 of (a)'s samples each, mesh from pod_mesh:
               selfConsist, pool=True and pool="pseudo" equal to one
               process (every sample's denoised and map, err_out; trans
               for selfConsist), each cross-process tally's time per call;
               then a one-process NCCL group: accumulate_trans_global on
               the card equal to accumulate_trans; (d)
               build_compare_and_tally over two shards of the card (B4
               once per shard) at dryrun_multichip's shapes and at 2
               samples x 4,096 uniques x L 250, band 16, against its plain
               version on two CPU shards (ham and counts bitwise, loglam
               within rtol = atol = 1e-6), then dryrun_multichip(8) on the
               card. Walls, launches and times printed on [dist] lines.
 17. shortlist — the budded compare (kernel B5, one launch from the
               small pack to the shortlist buffer): (b) phase 5's sample
               again with the transport instrumented, then with the budded
               route off (SHORTLIST_MIN_N: every compare the full route,
               its small pack B5's small-only launch), both equal to phase
               5's result; for each the wall, budded compares, B5 launches,
               bytes per budded compare (min, median, max), fetches and
               bytes, the be.* phases and the rows whose lambda the host
               multiplied; (a) B5 against its plain version on the card,
               bitwise (buffer, order, order_u, small13 and the
               follow-up), with small13 computed in the launch and with it
               given, at three buds of that run: as called, greedy
               flipped, M0 = 16, tiles of K = 1, bits at K = 8 and at full
               coverage, cache mode (M0U 16 and 0), and a threshold mixing
               -999, 0 and subnormal values; and the small-only launch
               against small_pack_ref and the budded launch's small13;
               (c) B5's device time (torch.profiler's kernel durations,
               one call after a sync, and the kernels per call) and call
               time (CUDA events over back-to-back calls) at the run's
               median and largest M0 (speculative segments included), the
               follow-up's and the small-only launch's, beside the plain
               versions (torch-ops chains) and the bound (the small pack's
               bytes included).
 18. full    — the full compare's one-fetch transport (B5's full mode), the
               classic path's tile gather (its gather mode) and host tvec
               cache, compare_many and the packed construction upload:
               (a) the full mode against full_pack_ref (buffer and order)
               with the follow-up over its order, and the gather mode
               against gather_subs_ref, bitwise, at sam1F's 896 uniques
               and phase 5's sample, screened and not, M0 16 and the
               adaptive size, K 8 and 48, a threshold mixing -999, 0 and
               subnormal values; (b) sam1F and sam2F through
               dada(selfConsist=True), card == CPU, the first real-err init
               compare through the full mode and every later one a host
               cache hit fetching no tvec row; (c) phase 5's transport
               bytes (17b's run) beside the parent's, dense re-fetches,
               follow-ups, puts, gather launches, and the construction
               blob's bytes beside the parent's two arrays; (d)
               compare_many of five centers == five compare() calls, in
               both halves; (e) the full mode's device time (fresh
               process, torch.profiler) and call time (CUDA events) at
               both sizes and the gather mode's, beside the plain
               versions and the bound by bytes; the 4-bit tvec row gather
               and the construction unpack (torch ops) timed on the card
               against the CPU and their bounds.
 19. spec    — speculation, the multi-bud prefetch (every earlier phase
               already runs at the default SPEC_K = 8): (a) B5's projection
               operand and fold against the plain versions, bitwise
               (buffer, order, order_u, small13, proj_out; small13
               computed and given; the buffer written into a slice of a
               larger one, the bytes around it untouched) at three buds of
               17b's run: the fold alone, an all -inf projection, a mixed
               one (finite on the center's row, which the screen exempts),
               greedy flipped, cache mode, and without the fold; (b) phase
               5's sample at SPEC_K 8, 0, 0, 8, each equal to phase 5's
               result: spec hits, misses and wasted segments, budded
               compares that fetched and their bytes per fetch (segments
               included), B5 and B1 launches, be.* phases (be.spec_consume
               included) and walls; the first run under
               torch.cuda.set_sync_debug_mode("error") from each dispatch's
               first B5 launch to its fetch (a host sync there raises);
               (c) 18b's sam1F and sam2F selfConsist runs, card == CPU at
               SPEC_K 8: their spec hits; (d) B5's device time at 17c's
               shapes without the projection operand and with it and the
               fold (17c's fresh-process child).
 20. wide    — kernel B4's wide body (windows of 257 to 2,048 rows) at
               the shapes it serves, each held bitwise against the plain
               version on the card and launched through the wide body
               alone: merge_whole (merge_pairs' alignments of 4,096 whole
               2 x 300 read pairs of 460-nt V3-V4 amplicons cut from
               ten_16s.100.fa.gz, scoring (1, -64, -64), W 301);
               is_shift_denovo on 500 such ASVs (124,750 pairs, W 461: the
               call's wall and launches, 40 of the ASVs card == CPU, a
               64-pair subset and the first 4,096-pair chunk held) and on
               samPB's 64 most abundant uniques (2,016 pairs, W ~1,500,
               the pointers in device memory; a 64-pair subset and all
               pairs held); at each the kernel's ms (CUDA events around
               its launches alone; device ms from torch.profiler), the
               call's ms, launches by body, the bound, the plain version's
               ms and the one-block-per-pair body's kernel ms on the same
               batch (forced).
It prints one {"device_stages": [...]} line (the taxonomy scorer, the
4-bit tvec row gather and the construction unpack: torch ops, not
hand-written kernels), one {"kernels": [...]} line (B1 to B5, B4's wide
body as its own entry; B5's entry carries the projection's launches and
phase 19's numbers) and, last, {"ok": true, ...}.
"""
from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SAM1F = os.path.join(ROOT, "tests", "extdata", "sam1F.fastq.gz")
SAM2F = os.path.join(ROOT, "tests", "extdata", "sam2F.fastq.gz")
SAMPB = os.path.join(ROOT, "tests", "extdata", "samPB.fastq.gz")
SAM1R = os.path.join(ROOT, "tests", "extdata", "sam1R.fastq.gz")
SAM2R = os.path.join(ROOT, "tests", "extdata", "sam2R.fastq.gz")
TRAIN = os.path.join(ROOT, "tests", "extdata", "example_train_set.fa.gz")
SPECIES = os.path.join(ROOT, "tests", "extdata",
                       "example_species_assignment.fa.gz")
TEN16S = os.path.join(ROOT, "tests", "extdata", "ten_16s.100.fa.gz")
# a taxonomy decision (a query's best genus, a bootstrap replicate's
# winner) whose float64 top-two margin is within this share of its score
# may go either way between two float32 runs that sum in different orders
TAX_REL = 1e-4

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


def b3_inputs(nww, s1, cands, band, wp):
    """Kernel B3's inputs for one center against candidates as
    nw_wavefront_grouped lays them out, with the window given as wp rows
    (which may be narrower than the band needs)."""
    import numpy as np

    s2b = np.full((len(cands), max(len(c) for c in cands)), 255, np.uint8)
    l2b = np.array([len(c) for c in cands], np.int64)
    for k, c in enumerate(cands):
        s2b[k, : len(c)] = c
    _, arrays, geom = nww.grouped_inputs(s1, len(s1), s2b, l2b, band)
    return arrays, dict(geom, WP=wp, match=5, mismatch=-4, gap_p=-8)


def pairs_case(rng, nww, blocks, band, wp):
    """Kernel B2 inputs: one block per (len1, npairs, nops, uniform) entry,
    each lane its own random query of length len1 against a mutated copy;
    pad lanes repeat lane 0, as the chimera route lays them out."""
    import numpy as np

    pairs = []
    for len1, npairs, nops, uniform in blocks:
        q = [rng.integers(0, 4, len1).astype(np.uint8)
             for _ in range(npairs)]
        pairs.append((len1, [(s, mutate(rng, s, nops, uniform)) for s in q]))
    return pairs_arrays(nww, pairs, band, wp)


def pairs_arrays(nww, blocks, band, wp, cut=False, qrng=None):
    """Kernel B2 inputs from (len1, [(query, parent), ...]) blocks, at most
    128 pairs each, pad lanes repeating lane 0; raises if the band needs a
    window wider than wp rows, unless cut (then the tracebacks that leave
    the window get stuck). With qrng, random qualities ride in s2q."""
    import numpy as np

    L = nww.LANES
    nb = len(blocks)
    maxlen = max(max(max(len(q), len(p)) for q, p in ps) for _, ps in blocks)
    NDP, L1R, L2R = geometry(nww, maxlen)
    scal = np.zeros((nb, 4), np.int32)
    params = np.zeros((nb, 8, L), np.int32)
    s1 = np.zeros((nb, L1R, L), np.int32)
    s2q = np.zeros((nb, L2R, L), np.int32)
    for b, (len1, ps) in enumerate(blocks):
        ps = ps + [ps[0]] * (L - len(ps))
        l2 = np.array([len(p) for _, p in ps], np.int64)
        need = nww.block_window(len1, l2, band)
        if need > wp and not cut:
            raise ValueError(f"case needs a {need}-row window, asked {wp}")
        C = int(l2.max())
        scal[b] = (len1, C, band + max(0, C - len1), int(l2.min()))
        params[b, 0] = l2
        params[b, 1] = band + np.maximum(0, len1 - l2)
        params[b, 2] = band + np.maximum(0, l2 - len1)
        for k, (q, p) in enumerate(ps):
            s1[b, 1: 1 + len1, k] = q
            code = p[::-1].astype(np.int32)     # row C - j holds p[j-1]
            if qrng is not None:
                code |= qrng.integers(2, 41, len(p)).astype(np.int32) << 2
            s2q[b, C - len(p): C, k] = code
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


def ptxas_registers(ptxas, kernel, tail=""):
    """{rows per thread: registers} of one kernel's instantiations in an
    `-Xptxas -v` report (tail: the mangled template arguments after the
    rows per thread, e.g. "Li3E" for nw_compare_kernel's B3 variant)."""
    import re

    regs = {}
    for chunk in ptxas.split("Compiling entry function")[1:]:
        m = re.search(kernel + r"ILi(\d)E" + tail, chunk)
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


# nw_compare_kernel's modes with rows besides sub, mapq and end: the
# wrapper's keywords for each
ROW_MODES = {2: dict(emit_kinds="cls", s1_per_block=True),
             3: dict(emit_kinds=True)}


def every_p(nww, t, want, geom, mode, reps=0):
    """Kernel B2's class rows (mode 2) or B3 (mode 3) on card tensors t at
    every pairs per block P that fits (nww.PAIRS_PER_BLOCK forced,
    restored after), each against the plain outputs `want`; returns {P:
    (max |kernel - plain|, ms or None)}, the ms from CUDA events over reps
    launches if reps."""
    import torch

    out = {}
    g = dict(geom, **ROW_MODES[mode])
    try:
        for P in (1, 2, 4, 8, 16, 32):
            if nww.compare_blocks_per_sm(geom["L1R"], geom["L2R"],
                                         geom["NDP"], geom["WP"], P,
                                         mode) == 0:
                continue
            nww.PAIRS_PER_BLOCK = P
            got = nww.nw_wavefront(*t, **g)
            torch.cuda.synchronize()
            out[P] = (max_abs_diff(got, want), cuda_ms(
                lambda: nww.nw_wavefront(*t, **g), reps) if reps else None)
    finally:
        nww.PAIRS_PER_BLOCK = None
    return out


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


def b4_short_pairs():
    """Pairs of length 0 and 1 against each other (and one of 3 against 1)."""
    import numpy as np

    e, a, c = (np.zeros(0, np.uint8), np.array([1], np.uint8),
               np.array([2], np.uint8))
    return [(e, e), (a, e), (e, c), (a, a), (a, c),
            (np.array([0, 1, 2], np.uint8), c)]


def b4_window_pairs(rng, W, n):
    """n unbanded pairs whose batch window is exactly W rows (the first two
    of length W - 1 each), the others of mixed lengths, plus the short
    pairs."""
    import numpy as np

    L = W - 1
    out = [(a, b[:L] if len(b) >= L else np.concatenate(
        [b, rng.integers(0, 4, L - len(b)).astype(np.uint8)]))
        for a, b in b4_pairs(rng, 2, L, 4)]
    out += b4_pairs(rng, max(0, n - 2), L, 6, lo=max(1, L // 3))
    return out + b4_short_pairs()


def v34_amplicons(n, seed=20):
    """n V3-V4 amplicons of 460 nt (E. coli positions about 340-800):
    positions 340..800 of the full-length 16S records of
    ten_16s.100.fa.gz, in record order, bases other than ACGT replaced by
    seeded ones; past the last record the cuts start again from the
    first."""
    import numpy as np
    from dada2_tpu_torch.taxonomy import read_fasta

    _, recs = read_fasta(TEN16S)
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        s = np.frombuffer(recs[k % len(recs)][340:800].upper().encode(),
                          np.uint8).copy()
        bad = ~np.isin(s, np.frombuffer(b"ACGT", np.uint8))
        s[bad] = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4,
                                                               bad.sum())]
        out.append(s.tobytes().decode())
    return out


def merge_whole_reads(n=4096, seed=16):
    """merge_pairs' alignment inputs for n whole 2 x 300 MiSeq read pairs of
    the V3-V4 amplicons: F = the amplicon's first 300 nt and R = the
    reverse complement of its last 300 nt, each read with 2 seeded
    substitutions of its own; merge_pairs aligns F against rc(R) (a
    140-nt overlap). Returns (F, rc(R)) as lists of strings."""
    import numpy as np
    from dada2_tpu_torch.encode import rc

    rng = np.random.default_rng(seed)
    fwd, rrc = [], []
    for a in v34_amplicons(n):
        f, r = list(a[:300]), list(rc(a[160:]))
        for x in (f, r):
            for _ in range(2):
                x[int(rng.integers(0, len(x)))] = "ACGT"[rng.integers(4)]
        fwd.append("".join(f))
        rrc.append(rc("".join(r)))
    return fwd, rrc


def shift_v34_uniques(n=500):
    """is_shift_denovo's input for a V3-V4 study: the first n distinct
    V3-V4 amplicons of ten_16s.100.fa.gz's records, abundances 1000 - k in
    that order (so every pair is aligned: n (n - 1) / 2 of them)."""
    out = {}
    for s in v34_amplicons(4 * n):
        if s not in out:
            out[s] = 1000 - len(out)
        if len(out) == n:
            break
    return out


def shift_pb_uniques(dt, n=64):
    """is_shift_denovo's input for a PacBio full-length 16S study:
    samPB.fastq.gz's n most abundant uniques, abundances n - k in derep
    order (every pair aligned: n (n - 1) / 2 = 2,016 at n = 64)."""
    drp = dt.derep_fastq(SAMPB)
    return {s: n - k for k, s in enumerate(drp.sequences[:n])}


def shift_pairs(uniques):
    """is_shift_denovo's (query, parent) pairs of uniques whose abundances
    fall strictly, in its order: (1, 0), (2, 0), (2, 1), ... as index
    arrays."""
    import numpy as np

    n = len(uniques)
    return np.nonzero(np.triu(np.ones((n, n), bool), 1).T)


def b4_fit(nwb, args, kw):
    """The body, rows per thread and pairs per block that kernel B4 takes
    for a call (as nw_batch decides them), with the batch's nd and W."""
    nd, W = nwb.batch_geometry(args[1].cpu().numpy(), args[3].cpu().numpy(),
                               kw["band"])
    n, L1 = args[0].shape
    L2 = args[2].shape[1]
    scalar = kw.get("mode") == "scalar"
    hg = kw.get("homo_gap_p")
    homo = (scalar and hg is not None and hg != kw["gap_p"]
            and kw.get("end_gap_p", 0) != kw["gap_p"])
    r = nwb.route(L1, L2, nd, W, homo)
    if nwb.BODY == "block" and r in (3, 4):
        r = nwb.block_route(L1, L2, nd, W, homo)
    fit = dict(nd=nd, W=W, body=nwb.body(r), rpt=None, P=None, warps=None,
               route=r)
    if r in (3, 4):
        fit["rpt"], fit["P"] = nwb.register_fit(L1, L2, nd, W, scalar, homo,
                                                n)
        fit["warps"] = nwb.warps_per_pair(W)
    if r == 3:
        fit["P"] = nwb.PAIRS_PER_BLOCK or fit["P"]
    return fit


def b4_launch_ms(nwb, args, kw, reps):
    """Kernel B4's time per call without nw_batch's host work: CUDA events
    around reps launches (nw_batch's own launch code, ops/nw_batch.py::
    _launch) of a batch prepared once."""
    b = nwb._prepare(*args, kw["match"], kw["mismatch"], kw["gap_p"],
                     kw.get("end_gap_p", 0), kw.get("band", -1),
                     kw.get("mode", "vec"), kw.get("homo_gap_p"), None, None,
                     None)
    return cuda_ms(lambda: nwb._launch(b), reps)


def b4_device_ms(run, reps, launched):
    """Kernel B4's device time per call of run() (torch.profiler: the sum of
    its kernels' events over reps calls, over reps) and its launches per
    call; (None, launches) if the profiler recorded another number of B4
    kernels than launched() counted (then the time is not measured)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    n0 = launched()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    n = launched() - n0
    ev = [e for e in prof.events() if is_b4_kernel(e.name)]
    if not ev or len(ev) != n:
        return None, n // reps
    us = sum(e.time_range.end - e.time_range.start for e in ev)
    return us / 1e3 / reps, n // reps


def is_b4_kernel(name):
    """Whether a profiler event is one of kernel B4's three bodies."""
    return ("nw_batch_kernel" in name or "nw_batch_reg_kernel" in name
            or "nw_batch_wide_kernel" in name)


def nbytes_of(tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def tutorial_workflow(dt, device, outdir, multithread, asvs=None):
    """The DADA2 tutorial (vignettes/dada2-intro.Rmd) on sam1/sam2 F+R
    through the port on `device`: filter_and_trim (on `multithread`
    processes) -> learn_errors -> derep_fastq -> dada -> merge_pairs ->
    make_sequence_table -> remove_bimera_denovo -> assign_taxonomy ->
    add_species. Given `asvs` (a reference run for another run's ASVs),
    derep_fastq through remove_bimera_denovo, which phase 13 holds card ==
    CPU on the same samples, are skipped and `asvs` are classified. Returns
    the results and each stage's wall seconds."""
    import torch

    times = {}

    def stage(name, fn):
        t0 = time.time()
        out = fn()
        if device != "cpu":
            torch.cuda.synchronize()
        times[name] = time.time() - t0
        return out

    os.makedirs(outdir, exist_ok=True)
    names = ("sam1", "sam2")
    filt = {d: [os.path.join(outdir, f"{n}{d}.filt.fastq.gz")
                for n in names] for d in "FR"}
    track = stage("filter_and_trim", lambda: dt.filter_and_trim(
        [SAM1F, SAM2F], filt["F"], rev=[SAM1R, SAM2R], filt_rev=filt["R"],
        truncLen=(240, 160), maxN=0, maxEE=(2, 2), truncQ=2, rm_phix=True,
        multithread=multithread))
    errs = stage("learn_errors", lambda: {
        d: dt.learn_errors(filt[d], device=device) for d in "FR"})
    if asvs is not None:
        seqtab = nochim = None
    else:
        asvs, seqtab, nochim = tutorial_asvs(dt, device, filt, errs, stage)
    taxa = stage("assign_taxonomy", lambda: dt.assign_taxonomy(
        asvs, TRAIN, tryRC=True, outputBootstraps=True, device=device))
    species = stage("add_species", lambda: dt.add_species(taxa["tax"],
                                                          SPECIES))
    return dict(track=track, filt=filt["F"] + filt["R"], errs=errs,
                seqtab=seqtab, nochim=nochim, taxa=taxa,
                species=species), times


def tutorial_asvs(dt, device, filt, errs, stage):
    """The tutorial's middle on the filtered files: derep_fastq -> dada ->
    merge_pairs -> make_sequence_table -> remove_bimera_denovo. Returns
    (the ASVs, the table, the table without bimeras)."""
    dereps = stage("derep_fastq", lambda: {
        d: {n: dt.derep_fastq(f) for n, f in zip(("sam1", "sam2"), filt[d])}
        for d in "FR"})
    dadas = stage("dada", lambda: {
        d: dt.dada(dereps[d], err=errs[d]["err_out"], device=device,
                   verbose=False) for d in "FR"})
    merged = stage("merge_pairs", lambda: dt.merge_pairs(
        dadas["F"], dereps["F"], dadas["R"], dereps["R"], device=device))
    seqtab = stage("make_sequence_table",
                   lambda: dt.make_sequence_table(merged))
    nochim = stage("remove_bimera_denovo", lambda: dt.remove_bimera_denovo(
        seqtab, method="consensus", device=device))
    return list(nochim.columns), seqtab, nochim


def gunzipped(path):
    import gzip

    with gzip.open(path, "rb") as f:
        return f.read()


def score_batches(tt, seqs, seed=100, batch=256):
    """assign_taxonomy's _score_batch inputs for `seqs` at its defaults
    (tryRC): per batch, the k-mer arrays and uniforms forward, then the
    reverse complements', drawn from the same seeded generator in the
    same order."""
    import torch
    from dada2_tpu_torch.encode import rc

    gen = torch.Generator().manual_seed(seed)
    ok = [s for s in seqs if len(s) >= tt.MIN_TAX_LEN]
    out = []
    for lo in range(0, len(ok), batch):
        chunk = ok[lo: lo + batch]
        fwd = tt.tax_karrays_bulk(chunk)
        u = tt.boot_uniforms(fwd, gen)
        back = tt.tax_karrays_bulk([rc(s) for s in chunk])
        out.append((chunk, fwd, u, back, tt.boot_uniforms(back, gen)))
    return out


def decision_margins(karrays, lgk, u, runs=()):
    """How clear the taxonomy scorer's decisions are, in float64 on the
    host: the checks' oracle, independent of the scorer's code.

    lgk [ngenus, 65536] and u [q, NBOOT, A // 8 + 1] as given to
    _score_batch; runs: its results (best, best_logp, boot winners) on
    those inputs. Returns (qm, bm, gaps): the relative top-two margins
    (top - second) / |top| of each query's best genus [q] and each
    bootstrap replicate's [q, NBOOT] (inf for one genus), and for each run
    the relative gaps of its picks below the top, ([q], [q, NBOOT]). Two
    float32 runs that sum in different orders (the card and the CPU, or
    the port and dada2_tpu) can pick different genera only where a margin
    is within their rounding (a replicate whose genera tie exactly goes to
    whichever sum rounds up); a right run's gaps are all within it."""
    import numpy as np

    lgk = np.asarray(lgk, np.float32)
    u = np.asarray(u, np.float32)
    q, nboot = u.shape[:2]
    A = max(max((len(a) for a in karrays), default=1), 8)

    def rel(sc):
        if sc.shape[-1] < 2:
            return np.full(sc.shape[:-1], np.inf)
        top2 = np.partition(sc, -2, axis=-1)[..., -2:]
        return (top2[..., 1] - top2[..., 0]) / np.abs(top2[..., 1])

    def gap(sc, pick):
        top = sc.max(axis=-1)
        got = np.take_along_axis(sc, pick[..., None], axis=-1)[..., 0]
        return (top - got) / np.maximum(np.abs(top), 1e-300)

    qm = np.empty(q)
    bm = np.empty((q, nboot))
    gaps = [(np.empty(q), np.empty((q, nboot))) for _ in runs]
    for i, a in enumerate(karrays):
        a = np.asarray(a, np.int64)
        n = len(a)
        lg = lgk[:, a].astype(np.float64)                  # [G, n]
        sc = lg.sum(axis=1)
        qm[i] = rel(sc[None, :])[0] if n else np.inf
        # the scorer's positions: trunc(f32(u * alen)), clipped
        pos = np.clip((u[i] * np.float32(n)).astype(np.int32), 0, A - 1)
        m = max(n // 8, 1)
        S = np.zeros((nboot, A), np.float64)
        np.add.at(S, (np.repeat(np.arange(nboot), m),
                      pos[:, :m].reshape(-1)), 1.0)
        lgp = np.zeros((A, lg.shape[0]))
        lgp[:n] = lg.T
        lgp[n:] = lgk[:, 0].astype(np.float64)[None, :]    # pad k-mer 0
        bs = S @ lgp
        bm[i] = rel(bs)
        for (gq, gb), run in zip(gaps, runs):
            gq[i] = gap(sc[None, :],
                        np.asarray(run[0], np.int64)[i: i + 1])[0]
            gb[i] = gap(bs, np.asarray(run[2], np.int64)[i])
    return qm, bm, gaps


def scores_agree(tt, karrs, lgk, u, got, want):
    """Two _score_batch results (best, best_logp, boot winners) on the same
    inputs: best_logp within rtol 1e-5, and every pick of both (the best
    genus, each bootstrap winner) a top genus in float64 within TAX_REL,
    so the two are equal wherever the top-two margin exceeds TAX_REL.
    Returns (an error or None, the decisions within the margin as boolean
    arrays [q] and [q, NBOOT])."""
    import numpy as np

    qm, bm, gaps = decision_margins(karrs, lgk, u, runs=[got, want])
    ex_q, ex_b = qm <= TAX_REL, bm <= TAX_REL
    rel = np.abs(got[1] - want[1]) / np.maximum(np.abs(want[1]), 1e-30)
    if rel.max(initial=0.0) > 1e-5:
        return f"best_logp differs by {rel.max():.3g} (rtol 1e-5)", ex_q, ex_b
    for name, (gq, gb) in zip(("card", "CPU"), gaps):
        if gq.max(initial=0.0) > TAX_REL or gb.max(initial=0.0) > TAX_REL:
            return (f"the {name} run picked {int((gq > TAX_REL).sum())} "
                    f"best genera and {int((gb > TAX_REL).sum())} bootstrap "
                    f"winners below the top genus"), ex_q, ex_b
    if ((got[0] != want[0]) & ~ex_q).any() or \
            ((got[2] != want[2]) & ~ex_b).any():
        return "the runs differ outside the margin", ex_q, ex_b
    return None, ex_q, ex_b


def scored_both(tt, seqs, lgk, on_card, on_cpu, what):
    """The scorer's decisions for assign_taxonomy(seqs, tryRC=True) at its
    default seed and batch: each batch forward and reverse-complemented,
    on the card and on the CPU with the same uniforms, held by
    scores_agree (fails on a difference). Returns per batch (reads, the
    two orientations' (decisions within the margin [q] and [q, NBOOT],
    the card's run, the CPU's run))."""
    out = []
    for chunk, fwd, u, back, u_rc in score_batches(tt, seqs):
        sides = []
        for karrs, uu in ((fwd, u), (back, u_rc)):
            a = tt._score_batch(karrs, on_card, uu, on_card.shape[1])
            b = tt._score_batch(karrs, on_cpu, uu, on_cpu.shape[1])
            err, ex_q, ex_b = scores_agree(tt, karrs, lgk, uu, a, b)
            if err:
                fail(f"the taxonomy scorer differs card vs CPU on {what}: "
                     f"{err}")
            sides.append((ex_q, ex_b, a, b))
        out.append((chunk, sides))
    return out


def tax_rows_agree(batches, taxa_a, taxa_b, species_a=None,
                   species_b=None, min_boot=50):
    """assign_taxonomy(tryRC=True, outputBootstraps=True) from two runs
    (the card's, the CPU's) with the same uniforms, and add_species on
    each (if given), held row by row against the scorer's decisions
    (`batches` from scored_both; their reads are the tables' first rows,
    in order).

    A row is exempt whole where its orientation (the larger best score) or
    its best genus is a decision within TAX_REL. Otherwise both runs must
    take the same orientation; each rank's boot counts may differ by at
    most the row's number of replicates within the margin; the tax must
    be equal at every rank where both counts fall on the same side of
    min_boot; and the species row must be equal where the tax row is.
    Returns (an error or None, rows exempt, replicates within the margin
    on the rows held)."""
    import numpy as np
    import pandas as pd

    def differ(xs, ys):    # any pair unequal; two empty cells are equal
        return any(not (x == y or (pd.isna(x) and pd.isna(y)))
                   for x, y in zip(xs, ys))

    index = list(taxa_a["tax"].index)
    tax_a, tax_b = taxa_a["tax"].values, taxa_b["tax"].values
    boot_a, boot_b = taxa_a["boot"].values, taxa_b["boot"].values
    sp_a = sp_b = None
    if species_a is not None:
        sp_a, sp_b = species_a.values, species_b.values
    exempt = n_rep = k = 0
    for reads, ((fq, fb, fa, fc), (rq, rb, ra, rcpu)) in batches:
        for i, read in enumerate(reads):
            if index[k] != read:
                return f"row {k} is not the scored read", exempt, n_rep
            lf, lr = float(fa[1][i]), float(ra[1][i])
            if abs(lr - lf) <= TAX_REL * abs(lf):
                exempt += 1
            elif (lr > lf) != (rcpu[1][i] > fc[1][i]):
                return (f"row {k}: the runs took different orientations",
                        exempt, n_rep)
            elif (rq if lr > lf else fq)[i]:
                exempt += 1
            else:
                n = int((rb if lr > lf else fb)[i].sum())
                n_rep += n
                d = int(np.abs(boot_a[k] - boot_b[k]).max())
                same = (boot_a[k] >= min_boot) == (boot_b[k] >= min_boot)
                if d > n:
                    return (f"row {k}: boot counts {boot_a[k].tolist()} vs "
                            f"{boot_b[k].tolist()} with {n} replicates "
                            f"within the margin", exempt, n_rep)
                if differ(tax_a[k][same], tax_b[k][same]):
                    return (f"row {k}: tax {tax_a[k].tolist()} vs "
                            f"{tax_b[k].tolist()}", exempt, n_rep)
                if (sp_a is not None and not differ(tax_a[k], tax_b[k])
                        and differ(sp_a[k], sp_b[k])):
                    return (f"row {k}: species {sp_a[k].tolist()} vs "
                            f"{sp_b[k].tolist()}", exempt, n_rep)
            k += 1
    return None, exempt, n_rep


def synthetic_train_set(rng, path, ngenus=3000, per_genus=4):
    """A training fasta of ngenus genera under a six-rank tree (Bacteria;
    phylum; class; order; family; genus), per_genus references each, all
    mutated from the full-length 16S sequences of ten_16s.100.fa.gz: six
    genera per family, each genus up to 40 edits (indels included) from
    its family's sequence, each reference up to 10 substitutions from its
    genus's. Returns the references' code arrays, [ngenus][per_genus]."""
    import numpy as np
    from dada2_tpu_torch.taxonomy import read_fasta

    _, ten = read_fasta(TEN16S)
    table = np.full(256, 255, np.uint8)
    for k, c in enumerate(b"ACGT"):
        table[c] = k
    fams = [table[np.frombuffer(s.encode(), np.uint8)] for s in ten
            if len(s) >= 1400][: (ngenus + 5) // 6]
    fams = [np.where(f > 3, rng.integers(0, 4, len(f)), f).astype(np.uint8)
            for f in fams]
    nt = np.frombuffer(b"ACGT", np.uint8)
    refs, lines = [], []
    for g in range(ngenus):
        f = g // 6
        o = f // 4
        c = o // 3
        base = mutate(rng, fams[f], 40, False)
        refs.append([mutate(rng, base, 10, True) for _ in range(per_genus)])
        tax = f"Bacteria;P{c // 4};C{c};O{o};F{f};G{g};"
        for r in refs[-1]:
            lines += [">" + tax, nt[r].tobytes().decode()]
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return refs


def v4_queries(rng, refs, n):
    """n V4-length (253 nt) reads cut from random references at the V4
    position (after the 515F primer) with up to 4 substitutions; every
    second one reverse-complemented. Returns (reads, their genera)."""
    import numpy as np

    nt = np.frombuffer(b"ACGT", np.uint8)
    comp = np.array([3, 2, 1, 0], np.uint8)
    seqs, genera = [], []
    for k in range(n):
        g = int(rng.integers(0, len(refs)))
        r = refs[g][int(rng.integers(0, len(refs[g])))]
        v4 = mutate(rng, r[533:786], 4, True)
        if k % 2:
            v4 = comp[v4[::-1]]
        seqs.append(nt[v4].tobytes().decode())
        genera.append(g)
    return seqs, genera


def workflow_ends(dt, dev, card, reset_launches, counts):
    """Phase 15: the tutorial workflow card against CPU (15a) and the
    taxonomy scorer at a realistic size (15b). Fails on any difference;
    returns the scorer's device-stage row."""
    import numpy as np
    import pandas as pd
    import torch

    # 15. the workflow's two ends. (a) the DADA2 tutorial on sam1/sam2 F+R
    # on the card (filter_and_trim on two spawned processes), held against
    # the port on the CPU (filtering in this process: the files must not
    # depend on it; the card's ASVs classified)
    from dada2_tpu_torch import taxonomy as tt

    with tempfile.TemporaryDirectory() as tmp:
        reset_launches()
        calls0 = tt._score_batch.calls
        wf_gpu, t_wf_gpu = tutorial_workflow(dt, "cuda",
                                             os.path.join(tmp, "card"), 2)
        n_wf = counts()
        calls_wf = tt._score_batch.calls - calls0
        asv = list(wf_gpu["nochim"].columns)
        wf_cpu, t_wf_cpu = tutorial_workflow(
            dt, "cpu", os.path.join(tmp, "cpu"), False, asvs=asv)
        for a, b in zip(wf_gpu["filt"], wf_cpu["filt"]):
            if gunzipped(a) != gunzipped(b):
                fail(f"filter_and_trim wrote {os.path.basename(a)} "
                     f"differently on the two runs")
    try:
        pd.testing.assert_frame_equal(wf_gpu["track"], wf_cpu["track"])
        for d in "FR":
            np.testing.assert_array_equal(wf_gpu["errs"][d]["err_out"],
                                          wf_cpu["errs"][d]["err_out"])
    except AssertionError as e:
        fail(f"the tutorial workflow differs card vs CPU: {e}")
    if n_wf["B1"] <= 0 or n_wf["B4"] <= 0:
        fail(f"the tutorial workflow did not run through kernels B1 and B4: "
             f"{n_wf}")
    # the scorer card vs CPU on the workflow's ASVs with assign_taxonomy's
    # own uniforms, then the two runs' tables row by row
    refs_t, r2g_t, levels_t = tt.load_reference(TRAIN)
    lgk_t = tt._build_lgk(refs_t, r2g_t, len(levels_t))
    on_card, on_cpu = tt.device_lgk(lgk_t, dev), tt.device_lgk(lgk_t, "cpu")
    held = scored_both(tt, asv, lgk_t, on_card, on_cpu, "the workflow's ASVs")
    del on_card
    err_t, ex_rows, n_rep = tax_rows_agree(
        held, wf_gpu["taxa"], wf_cpu["taxa"], wf_gpu["species"],
        wf_cpu["species"])
    if err_t:
        fail(f"assign_taxonomy/add_species differ card vs CPU: {err_t}")
    n_ex_b = sum(int(s[1].sum()) for _, sides in held for s in sides)
    n_b = sum(s[1].size for _, sides in held for s in sides)
    same_all = all(wf_gpu["taxa"][k].equals(wf_cpu["taxa"][k])
                   for k in ("tax", "boot"))
    tax_wf = wf_gpu["taxa"]["tax"]
    log(f"[tutorial] sam1/sam2 F+R, truncLen (240, 160), maxEE (2, 2), "
        f"rm_phix, multithread=2 (the CPU run: False): reads in/out "
        f"{wf_gpu['track'].values.tolist()}; table {wf_gpu['seqtab'].shape},"
        f" without bimeras {wf_gpu['nochim'].shape}; genera assigned "
        f"{int(tax_wf['Genus'].notna().sum())} of {len(tax_wf)}, species "
        f"{int(wf_gpu['species']['Species'].notna().sum())}; filtered files "
        f"and error matrices identical card vs CPU; scorer card == CPU "
        f"with {n_ex_b} of {n_b} bootstrap replicates (both orientations) "
        f"within the margin; taxonomy and species tables held row by row: "
        f"{ex_rows} of {len(asv)} rows exempt whole, {n_rep} replicates "
        f"within the margin on the rows held, tables "
        f"{'identical' if same_all else 'equal as held'}; card launches "
        f"{n_wf}, scorer calls {calls_wf}")
    log("[tutorial] stage wall seconds, card / CPU (the CPU run classifies "
        "the card's ASVs): " + ", ".join(
            f"{k} {t:.3f} / " + (f"{t_wf_cpu[k]:.3f}" if k in t_wf_cpu
                                 else "-") for k, t in t_wf_gpu.items())
        + f"; total {sum(t_wf_gpu.values()):.2f} / "
        f"{sum(t_wf_cpu.values()):.2f}; card {card}")

    # (b) the scorer at a realistic size: a synthetic 3,000-genus training
    # set (12,000 references of ~1,450 nt) and 2,000 V4 reads, half of them
    # reverse-complemented, through assign_taxonomy(tryRC=True)
    rng15 = np.random.default_rng(15)
    with tempfile.TemporaryDirectory() as tmp:
        fa = os.path.join(tmp, "train.fa")
        t0 = time.time()
        refs15 = synthetic_train_set(rng15, fa)
        queries, truth = v4_queries(rng15, refs15, 2000)
        t_make = time.time() - t0
        reset_launches()
        calls0 = tt._score_batch.calls
        dt.PHASES.reset()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        res15 = dt.assign_taxonomy(queries, fa, tryRC=True,
                                   outputBootstraps=True, device="cuda")
        torch.cuda.synchronize()
        wall15 = time.time() - t0
        calls15 = tt._score_batch.calls - calls0
        n15 = counts()
        peak15 = torch.cuda.max_memory_allocated()
        phases15 = dt.PHASES.as_dict()
        # the driver on the CPU for the first batch: the same seed draws
        # the same uniforms for it
        t0 = time.time()
        cpu15 = dt.assign_taxonomy(queries[:256], fa, tryRC=True,
                                   outputBootstraps=True, device="cpu")
        t_cpu15 = time.time() - t0
        refs_s, r2g_s, levels_s = tt.load_reference(fa)
    G15 = len(levels_s)
    lgk15 = tt._build_lgk(refs_s, r2g_s, G15)
    del refs_s
    right = sum(res15["tax"]["Genus"].iloc[k] == f"G{g}"
                for k, g in enumerate(truth))
    if res15["tax"].shape != (2000, 6) or calls15 != 16 or right < 1000:
        fail(f"assign_taxonomy at 3,000 genera: table "
             f"{res15['tax'].shape}, {calls15} scorer calls (16 expected), "
             f"{right} of 2000 genera right")
    if any(n15.values()):
        fail(f"assign_taxonomy launched an alignment kernel: {n15}")
    lgk15_dev = tt.device_lgk(lgk15, dev)
    lgk15_cpu = tt.device_lgk(lgk15, "cpu")
    chunk, fwd, u, back, u_rc = score_batches(tt, queries[:256])[0]
    call_ms = cuda_ms(lambda: tt._score_batch(fwd, lgk15_dev, u, G15), 3)
    # the device work alone, on inputs already on the card (this process's
    # earlier profiles leave torch.profiler missing kernels here; ab_tax.py
    # gives the time by kernel)
    A15 = max(max(len(a) for a in fwd), 8)
    karr15 = np.zeros((len(fwd), A15), np.int64)
    for i, a in enumerate(fwd):
        karr15[i, : len(a)] = a
    dev_args = (torch.from_numpy(karr15).to(dev),
                torch.tensor([len(a) for a in fwd], dtype=torch.int32,
                             device=dev), u.to(dev), lgk15_dev, 1 << 27)
    dev_ms = cuda_ms(lambda: tt._score_device(*dev_args), 3)
    t0 = time.time()
    tt._score_batch(fwd, lgk15_cpu, u, G15)
    cpu_ms = (time.time() - t0) * 1e3
    # the first batch's decisions card vs CPU, then the two runs' tables
    held15 = scored_both(tt, queries[:256], lgk15, lgk15_dev, lgk15_cpu,
                         "3,000 genera")
    del lgk15_cpu
    card15 = {k: res15[k].iloc[:256] for k in ("tax", "boot")}
    err_t, ex_rows15, n_rep15 = tax_rows_agree(held15, card15, cpu15)
    if err_t:
        fail(f"assign_taxonomy at 3,000 genera differs card vs CPU: "
             f"{err_t}")
    ex_q, ex_b = held15[0][1][0][:2]
    # the least time for one batch: the additions its data needs (each
    # read's k-mers' genus scores summed, sum(alen)·G, and each
    # replicate's m drawn k-mers', NBOOT·sum(m)·G; the dense products
    # the torch ops run do ~55x more) at 67 TFLOP/s, or lgk, the k-mer
    # arrays and uniforms read once and the three outputs written once at
    # 3.35 TB/s
    q15 = len(fwd)
    alens = np.array([len(a) for a in fwd], np.int64)
    flops = G15 * int(alens.sum() + tt.NBOOT * np.maximum(alens // 8,
                                                          1).sum())
    nbytes = (lgk15.nbytes + q15 * A15 * 8 + u.numel() * 4
              + q15 * (8 + 4 + tt.NBOOT * 8))
    bound_sc = max(flops / 67e12, nbytes / 3.35e12) * 1e3
    by_sc = "operations" if flops / 67e12 >= nbytes / 3.35e12 else "bytes"
    log(f"[taxonomy] synthetic set (made in {t_make:.1f}s): {G15} genera, "
        f"{len(r2g_s)} references, 2000 V4 reads (half reverse-"
        f"complemented): assign_taxonomy(tryRC, outputBootstraps) "
        f"{wall15:.2f}s wall, {calls15} scorer calls, genus right for "
        f"{right} of 2000; stages {phases15}; lgk {lgk15.nbytes} bytes, "
        f"peak device memory {peak15} bytes; card launches {n15}")
    log(f"[taxonomy] one batch (q={q15}, A={A15}, G={G15}): call "
        f"{call_ms:.4f} ms, device work alone {dev_ms:.4f} ms (CUDA "
        f"events), CPU "
        f"{cpu_ms:.1f} ms; bound {bound_sc:.4f} ms by {by_sc} "
        f"({flops} flop, {nbytes} bytes); card == CPU with {int(ex_q.sum())}"
        f" queries and {int(ex_b.sum())} of {ex_b.size} replicates (forward)"
        f" within the margin; assign_taxonomy's first 256 rows card vs CPU "
        f"({t_cpu15:.2f}s) held row by row: {ex_rows15} rows exempt whole, "
        f"{n_rep15} replicates within the margin on the rows held; card "
        f"{card}")
    del lgk15_dev, dev_args
    return [dict(
        name="taxonomy scorer (_score_batch)", route="torch ops",
        source="dada2_tpu_torch/taxonomy.py",
        replaces="dada2_tpu/taxonomy.py:180", calls=calls15, ms=call_ms,
        device_ms=dev_ms, plain_ms=cpu_ms, plain_device="cpu",
        bound_ms=bound_sc, bound_by=by_sc, library_ms=None,
        lgk_bytes=int(lgk15.nbytes), peak_bytes=int(peak15),
        wall_s=wall15, stages_s=phases15)]


# ---- phase 16: multi-device and multi-process runs -------------------------

def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def same_sample(a, b, what, trans=True):
    """One sample's dada results bitwise: err_out, trans, denoised,
    clustering and map."""
    import numpy as np
    import pandas as pd

    np.testing.assert_array_equal(a.err_out, b.err_out, err_msg=what)
    if trans:
        np.testing.assert_array_equal(a.trans, b.trans, err_msg=what)
    if a.denoised != b.denoised:
        raise AssertionError(f"{what}: denoised differ")
    pd.testing.assert_frame_equal(a.clustering, b.clustering, obj=what)
    np.testing.assert_array_equal(a.map, b.map, err_msg=what)


def dist_child(rank: int, port: int, workdir: str) -> None:
    """Phase 16c's child: one of two processes sharing cuda:0 under gloo
    (NCCL refuses two ranks on one card), driving its 4 of the 8 samples
    through dada(mesh=pod_mesh) in selfConsist, pool=True and
    pool="pseudo"; each cross-process tally's time is recorded. Writes
    its results to workdir/rank{rank}.pkl."""
    import pickle

    import torch
    import torch.distributed as tdist

    sys.path.insert(0, ROOT)
    import dada2_tpu_torch as dt
    from dada2_tpu_torch.ops import nw_wavefront as nww
    from dada2_tpu_torch.parallel import dist as pdist

    pdist.init_distributed(f"localhost:{port}", 2, rank, backend="gloo")
    with open(os.path.join(workdir, "samples.pkl"), "rb") as fh:
        names, samples, err, device = pickle.load(fh)
    mesh = pdist.pod_mesh(devices=[device])
    mine = {n: samples[n] for n in names[4 * rank: 4 * rank + 4]}
    collective = pdist.accumulate_trans_global
    seconds = []

    def timed_collective(local, m):
        t0 = time.perf_counter()
        out = collective(local, m)
        seconds.append(time.perf_counter() - t0)
        return out

    pdist.accumulate_trans_global = timed_collective
    out = {"mesh": repr(mesh)}
    tallies = []
    for mode, kw in (("selfconsist", dict(err=None, selfConsist=True)),
                     ("pool", dict(err=err, pool=True)),
                     ("pseudo", dict(err=err, pool="pseudo"))):
        seconds.clear()
        before = nww.nw_wavefront.launches["B1"]
        tdist.barrier()
        t0 = time.time()
        res = dt.dada(mine, mesh=mesh, verbose=False, **kw)
        if mesh.devices[0, 0].device.type == "cuda":
            torch.cuda.synchronize()
        out[mode] = dict(
            wall=time.time() - t0, collective_s=list(seconds),
            b1=nww.nw_wavefront.launches["B1"] - before,
            results={n: (r.denoised, r.map, r.err_out, r.clustering,
                         r.trans) for n, r in res.items()})
        if mode == "selfconsist":
            tallies = [r.trans for r in res.values()]
    # the collective alone: both ranks enter together (a barrier first)
    steady = []
    for _ in range(20):
        tdist.barrier()
        t0 = time.perf_counter()
        collective(tallies, mesh)
        steady.append(time.perf_counter() - t0)
    out["steady_s"] = steady
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as fh:
        pickle.dump(out, fh)
    tdist.destroy_process_group()


def distributed_phase(dt, dev, card, reset_launches, counts, asvs, err,
                      sim, res5, n_b1_5, b1_args, b1_geom,
                      reads_per_sample=15_000, uniques_16d=4096):
    """Phase 16: dada(mesh=) over mesh entries on the one card (16a), a
    compare sweep's blocks sharded by use_mesh (16b), two processes
    sharing the card (16c), and build_compare_and_tally (16d). Fails on
    any difference; returns phase 16's launches of B1 and B4 by run."""
    import pickle
    import shutil

    import numpy as np
    import torch

    from dada2_tpu_torch import parallel
    from dada2_tpu_torch.encode import pack_sequences
    from dada2_tpu_torch.ops import nw_batch as nwb
    from dada2_tpu_torch.ops import nw_wavefront as nww
    from dada2_tpu_torch.parallel import dist as pdist

    launches = {"B1": {}, "B4": {}}

    def run(label, fn):
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
        n = counts()
        launches["B1"][label] = n["B1"]
        launches["B4"][label] = n["B4"]
        log(f"[dist] {label}: {wall:.3f}s wall, launches B1 {n['B1']}, "
            f"B4 {n['B4']}")
        return out, wall, n

    # 16a. the samples axis: 8 simulated MiSeq samples of 15,000 reads
    # (phase 5's 120,000 in all) from sam1F's ASVs under their own seeds
    # and abundance profiles, meshless, then with a (2, 1) mesh of two
    # entries of the one card
    seqs, quals, ab0 = asvs
    t0 = time.time()
    samples = {}
    for k in range(8):
        prof = ab0 * np.exp(np.random.default_rng(200 + k).normal(
            0.0, 1.0, len(ab0)))
        samples[f"s{k}"] = simulate_sample(
            np.random.default_rng(100 + k), dt.Derep, pack_sequences, seqs,
            prof, quals, err, reads_per_sample, f"s{k}")
    names = list(samples)
    log(f"[dist] 16a: 8 samples x {reads_per_sample} reads, "
        f"{[len(samples[n].uniques) for n in names]} uniques, simulated "
        f"in {time.time() - t0:.1f}s")
    base, wall_a0, n_a0 = run("16a meshless", lambda: dt.dada(
        samples, err=None, selfConsist=True, device=dev, verbose=False))
    mesh_a = pdist.make_mesh(devices=[dev, dev], samples=2)
    dt.PHASES.reset()
    meshed, wall_a1, n_a1 = run("16a mesh (2, 1)", lambda: dt.dada(
        samples, err=None, selfConsist=True, mesh=mesh_a, verbose=False))
    trans_mesh = dt.PHASES.summary()
    try:
        for n in names:
            same_sample(base[n], meshed[n], f"16a {n}")
    except AssertionError as e:
        fail(f"16a: dada(mesh=) differs from the meshless run: {e}")
    rounds_a = len(base[names[0]].err_in)
    tallies_a = [meshed[n].trans for n in names]
    t0 = time.perf_counter()
    for _ in range(20):
        summed = pdist.accumulate_trans_mesh(mesh_a, tallies_a)
    ms_mesh = (time.perf_counter() - t0) / 20 * 1e3
    if not np.array_equal(summed, dt.accumulate_trans(tallies_a)):
        fail("16a: accumulate_trans_mesh differs from accumulate_trans")
    if n_a0["B1"] <= 0 or n_a1["B1"] != n_a0["B1"]:
        fail(f"16a: B1 launches {n_a0['B1']} meshless, {n_a1['B1']} on "
             "the mesh (the samples axis must launch the same sweeps)")
    log(f"[dist] 16a: {rounds_a} rounds, "
        f"{[len(base[n].denoised) for n in names]} ASVs; err_out, trans, "
        f"denoised, clustering and map identical; walls meshless "
        f"{wall_a0:.3f}s, mesh {wall_a1:.3f}s; accumulate_trans_mesh "
        f"{ms_mesh:.3f} ms per call (8 tallies); phases on the mesh: "
        f"{trans_mesh}; card {card}")

    # 16b. the pairs axis: phase 5's sample with every compare sweep's
    # blocks sharded over two entries of the card (use_mesh), against a
    # meshless run right before it and phase 5's result
    res_b0, wall_b0, n_b0 = run("16b meshless", lambda: dt.dada(
        sim, err=None, selfConsist=True, verbose=False))
    parallel.use_mesh(pdist.make_mesh(devices=[dev, dev], samples=1))
    try:
        res_b1, wall_b1, n_b1 = run("16b pairs mesh (1, 2)", lambda: dt.dada(
            sim, err=None, selfConsist=True, verbose=False))
    finally:
        parallel.use_mesh(None)
    try:
        same_sample(res5, res_b0, "16b meshless vs phase 5")
        same_sample(res5, res_b1, "16b pairs mesh vs phase 5")
    except AssertionError as e:
        fail(f"16b: the pairs-sharded run differs from phase 5's: {e}")
    if n_b0["B1"] != n_b1_5 or n_b1["B1"] != 2 * n_b1_5:
        fail(f"16b: B1 launches {n_b0['B1']} meshless, {n_b1['B1']} "
             f"sharded; phase 5 had {n_b1_5} (sharded must double)")
    nb = b1_args[0].shape[0]
    half = (nb + 1) // 2
    shard = (b1_args[0][:half], b1_args[1][:half], b1_args[2],
             b1_args[3][:half].contiguous())
    got = nww.nw_compare(*shard, **b1_geom)
    e_sh = max_abs_diff(got, nww.nw_wavefront_ref(*shard, **b1_geom))
    if e_sh != 0:
        fail("kernel B1 disagrees with its plain version at shard size")
    ms_full = cuda_ms(lambda: nww.nw_compare(*b1_args, **b1_geom), 20)
    ms_half = cuda_ms(lambda: nww.nw_compare(*shard, **b1_geom), 20)
    P_half = nww.pairs_per_block(b1_geom["L1R"], b1_geom["L2R"],
                                 b1_geom["NDP"], b1_geom["WP"], 1, half)
    log(f"[dist] 16b: identical to phase 5; B1 launches {n_b0['B1']} -> "
        f"{n_b1['B1']}; walls meshless {wall_b0:.3f}s, sharded "
        f"{wall_b1:.3f}s; B1 at phase 5's timed bucket {nb} blocks "
        f"{ms_full:.4f} ms, one shard ({half} blocks, P={P_half}) "
        f"{ms_half:.4f} ms per launch; max |kernel - plain| = {e_sh}; card "
        f"{card}")

    # 16c. two processes sharing the card (gloo), 4 samples each, against
    # one process: selfConsist (16a's meshless run), pool=True and
    # pool="pseudo" (run here meshless)
    pooled, wall_p, _ = run("16c one process, pool=True", lambda: dt.dada(
        samples, err=err, pool=True, device=dev, verbose=False))
    pseudo, wall_q, _ = run("16c one process, pool=pseudo", lambda: dt.dada(
        samples, err=err, pool="pseudo", device=dev, verbose=False))
    work = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    try:
        with open(os.path.join(work, "samples.pkl"), "wb") as fh:
            pickle.dump((names, samples, err, str(dev)), fh)
        port = free_port()
        t0 = time.time()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dist-child",
             str(r), str(port), work], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for r in (0, 1)]
        try:
            outs = [p.communicate(timeout=600) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        wall_c = time.time() - t0
        for r, (p, (so, se)) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                fail(f"16c: rank {r} exited {p.returncode}: {se[-3000:]}")
        ranks = []
        for r in (0, 1):
            with open(os.path.join(work, f"rank{r}.pkl"), "rb") as fh:
                ranks.append(pickle.load(fh))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    refs = {"selfconsist": base, "pool": pooled, "pseudo": pseudo}
    walls = {"selfconsist": wall_a0, "pool": wall_p, "pseudo": wall_q}
    for mode, ref in refs.items():
        got = {}
        for r, rk in enumerate(ranks):
            mine = names[4 * r: 4 * r + 4]
            if sorted(rk[mode]["results"]) != sorted(mine):
                fail(f"16c {mode}: rank {r} returned "
                     f"{sorted(rk[mode]['results'])}, not its own {mine}")
            got.update(rk[mode]["results"])
        for n in names:
            den, mp, eo, cl, tr = got[n]
            if (den != ref[n].denoised or not np.array_equal(mp, ref[n].map)
                    or not np.array_equal(eo, ref[n].err_out)):
                fail(f"16c {mode}: sample {n} differs from one process")
            if mode == "selfconsist" and not np.array_equal(
                    tr, ref[n].trans):
                fail(f"16c selfconsist: sample {n}'s trans differs")
        log(f"[dist] 16c {mode}: two processes (gloo, both on {dev}) == "
            f"one process; walls rank 0 {ranks[0][mode]['wall']:.3f}s, "
            f"rank 1 {ranks[1][mode]['wall']:.3f}s (one process "
            f"{walls[mode]:.3f}s); accumulate_trans_global per call, ms: "
            f"rank 0 "
            f"{[round(s * 1e3, 3) for s in ranks[0][mode]['collective_s']]}"
            f", rank 1 "
            f"{[round(s * 1e3, 3) for s in ranks[1][mode]['collective_s']]}"
            f"; B1 launches {ranks[0][mode]['b1']} + {ranks[1][mode]['b1']}")
        for r in (0, 1):
            launches["B1"][f"16c rank {r} {mode}"] = ranks[r][mode]["b1"]
    steady = [sorted(rk["steady_s"]) for rk in ranks]
    log(f"[dist] 16c: mesh {ranks[0]['mesh']}; both children {wall_c:.1f}s "
        f"wall from spawn to exit; accumulate_trans_global alone after a "
        f"barrier (20 calls), min / median ms: rank 0 "
        f"{steady[0][0] * 1e3:.3f} / {steady[0][10] * 1e3:.3f}, rank 1 "
        f"{steady[1][0] * 1e3:.3f} / {steady[1][10] * 1e3:.3f}; card {card}")

    # one-process NCCL: accumulate_trans_global on the card against
    # accumulate_trans (NCCL between ranks needs one card per rank)
    import torch.distributed as tdist

    torch.cuda.set_device(dev)
    pdist.init_distributed(f"localhost:{free_port()}", 1, 0,
                           backend="nccl")
    try:
        rng = np.random.default_rng(9)
        for label, tallies in (
                ("16a's tallies", [base[n].trans for n in names]),
                ("counts of 3e9", [rng.integers(0, 3_000_000_000, (16, 41))
                                   for _ in range(8)])):
            pdist.accumulate_trans_global(tallies, None)   # warm-up
            t0 = time.perf_counter()
            got = pdist.accumulate_trans_global(tallies, None)
            t_nccl = time.perf_counter() - t0
            if not np.array_equal(got, dt.accumulate_trans(tallies)):
                fail(f"16c: accumulate_trans_global under NCCL differs "
                     f"from accumulate_trans on {label}")
            log(f"[dist] 16c NCCL, one process: accumulate_trans_global on "
                f"{label} == accumulate_trans, {t_nccl * 1e3:.3f} ms")
    finally:
        tdist.destroy_process_group()

    # 16d. build_compare_and_tally with two shards of the card (B4 once
    # per shard) against its plain version on the CPU (two CPU shards):
    # ham and counts bitwise, loglam to f32 summation order
    rng = np.random.default_rng(16)

    def realistic(S=2, npairs=uniques_16d, L=250):
        seqs = np.zeros((S, npairs, L), np.int8)
        lens = np.zeros((S, npairs), np.int32)
        for s in range(S):
            c = rng.integers(0, 4, L).astype(np.uint8)
            for p in range(npairs):
                m = c if p == 0 else mutate(rng, c, 8, False)[:L]
                seqs[s, p, : len(m)] = m
                lens[s, p] = len(m)
        quals = rng.integers(10, 41, (S, npairs, L)).astype(np.int32)
        reads = rng.integers(1, 100, (S, npairs)).astype(np.int32)
        return seqs, lens, quals, reads

    def dryrun_shaped():
        r0 = np.random.default_rng(0)
        seqs = r0.integers(0, 4, (2, 8, 32)).astype(np.int8)
        lens = np.full((2, 8), 32, np.int32)
        quals = r0.integers(20, 40, (2, 8, 32)).astype(np.int32)
        reads = r0.integers(1, 50, (2, 8)).astype(np.int32)
        return seqs, lens, quals, reads

    logerr = np.log(dt.data.tperr1())
    mesh_d = pdist.make_mesh(devices=[dev, dev], samples=1)
    mesh_c = pdist.make_mesh(devices=pdist.cpu_devices(2), samples=1)
    for label, (seqs, lens, quals, reads) in (
            ("dryrun shapes (2 x 8 x 32)", dryrun_shaped()),
            (f"2 samples x {uniques_16d} uniques x L 250", realistic())):
        S, npairs, L = seqs.shape
        nd, W = nwb.batch_geometry(np.full(S * npairs, L),
                                   lens.reshape(-1), 16)
        kw = dict(match=5, mismatch=-4, gap_p=-8, band=16)
        args = (seqs[:, 0, :], lens[:, 0], seqs, lens, quals, reads, logerr)
        step = pdist.build_compare_and_tally(mesh_d, nd, W, 41, **kw)
        (ham, loglam, tally), _, n_d = run(
            f"16d build_compare_and_tally, {label}",
            lambda: step(*args))
        ref = pdist.build_compare_and_tally(mesh_c, nd, W, 41, **kw)(*args)
        ham, loglam, tally = (x.cpu().numpy() for x in (ham, loglam,
                                                        tally))
        if (not np.array_equal(ham, ref[0].numpy())
                or not np.array_equal(tally, ref[2].numpy())):
            fail(f"16d {label}: ham or counts differ from the plain version")
        if not np.allclose(loglam, ref[1].numpy(), rtol=1e-6, atol=1e-6):
            fail(f"16d {label}: loglam differs from the plain version "
                 f"beyond rtol=atol=1e-6")
        if n_d["B4"] != 2:
            fail(f"16d {label}: {n_d['B4']} B4 launches, not one per shard")
        step_ms = cuda_ms(lambda: step(*args), 5)
        log(f"[dist] 16d {label}: nd {nd}, W {W}; ham, counts bitwise and "
            f"loglam within 1e-6 of the plain version (max |diff| "
            f"{float(np.abs(loglam - ref[1].numpy()).max()):.3g}); "
            f"B4 launches {n_d['B4']}; step {step_ms:.3f} ms "
            f"(CUDA events, inputs from the host); card {card}")
    reset_launches()
    dr = pdist.dryrun_multichip(8)
    log(f"[dist] 16d dryrun_multichip(8) on the card: ham {dr[0].shape}, "
        f"counts sum {int(dr[2].sum())}; launches {counts()['B4']} B4")
    return launches


# ---- main ------------------------------------------------------------------

# ---- phase 17: the budded compare in one launch (kernel B5) ----------------

def transport_run(run, per_compare=True):
    """run() with the port's compare backend instrumented (class and module
    attributes, restored after): for every compare whether the JAX
    package's rule makes it budded (a center on B1's route, k-mers on, the
    engine's own cutoff, some e_thresh > 0) and, with per_compare (one
    sample at a time: the counters are process-wide), the bytes it
    fetched; the rows whose exact lambda the host multiplied; and, where
    the checkout has kernel B5, the arguments of every budded_pack call
    (without its outputs: the shared buffer `out` and the fold's
    `proj_out`; a projection operand is copied). Works on a checkout
    without B5 or speculation too (ab_bud.py's parent). Returns (run's
    result, stats, B5 calls)."""
    import importlib

    import numpy as np
    import torch

    from dada2_tpu_torch.core import backend_cuda as bc
    from dada2_tpu_torch.trace import COUNTERS, PHASES

    try:
        ss = importlib.import_module("dada2_tpu_torch.ops.store_screen")
    except ImportError:
        ss = None
    B = bc.CudaBackend
    saved = {k: B.__dict__[k] for k in ("compare", "_lambdas", "_lam_gapless",
                                        "_lam_subs") if k in B.__dict__}
    per, rows, calls = [], {"n": 0}, []

    def compare(self, center, skip, opts, err, use_kmers, kdist_cutoff,
                e_thresh=None):
        budded = (use_kmers and e_thresh is not None
                  and float(kdist_cutoff) == float(opts.KDIST_CUTOFF)
                  and bool(np.any(e_thresh > 0)) and opts.BAND_SIZE != 0
                  and self._route(int(self.lens[center]), opts) == "B1")
        b0 = COUNTERS.fetch_bytes
        out = saved["compare"](self, center, skip, opts, err, use_kmers,
                               kdist_cutoff, e_thresh)
        per.append((budded, COUNTERS.fetch_bytes - b0))
        return out

    def counted(name, pos):
        def fn(self, *a):
            rows["n"] += len(a[pos])
            return saved[name](self, *a)
        return fn

    B.compare = compare
    B._lambdas = counted("_lambdas", 0)
    B._lam_gapless = counted("_lam_gapless", 1)
    if "_lam_subs" in saved:
        B._lam_subs = counted("_lam_subs", 0)
    if ss is not None:
        pack = ss.budded_pack

        def budded_pack(*a, **kw):
            rec = {k: v for k, v in kw.items()
                   if k not in ("out", "proj_out", "logtotal")}
            if rec.get("proj") is not None:
                rec["proj"] = rec["proj"].clone()
            calls.append((a, rec))
            return pack(*a, **kw)
        ss.budded_pack = budded_pack
        b5_0 = dict(ss.launches)
    from dada2_tpu_torch.ops import nw_wavefront as nww
    b1_0 = nww.nw_wavefront.launches["B1"]
    COUNTERS.reset()
    PHASES.reset()
    try:
        torch.cuda.synchronize()
        t0 = time.time()
        out = run()
        torch.cuda.synchronize()
        wall = time.time() - t0
    finally:
        for k, v in saved.items():
            setattr(B, k, v)
        if ss is not None:
            ss.budded_pack = pack
    budded = [b for f, b in per if f]
    tim, nb = PHASES.as_dict(), PHASES.bytes_dict()
    stats = dict(
        wall_s=wall, compares=len(per), budded_compares=len(budded),
        device_fetches=COUNTERS.device_fetches,
        fetch_bytes=COUNTERS.fetch_bytes,
        device_puts=COUNTERS.device_puts, put_bytes=COUNTERS.put_bytes,
        followup_fetches=getattr(COUNTERS, "followup_fetches", None),
        dense_refetches=getattr(COUNTERS, "dense_refetches", None),
        host_lambda_rows=rows["n"],
        b1_launches=nww.nw_wavefront.launches["B1"] - b1_0,
        spec={k: getattr(COUNTERS, k, None) for k in (
            "spec_hits", "spec_misses", "spec_wasted")},
        phases={k: [tim.get(k, 0.0), nb.get(k, 0)] for k in sorted(
            set(tim) | set(nb)) if k.startswith("be.")})
    if per_compare:
        stats["budded_bytes"] = (
            [int(min(budded)), float(np.median(budded)), int(max(budded))]
            if budded else None)
        # the budded compares that fetched (a consumed segment fetches
        # nothing, or its follow-up alone): each fetch's bytes carry the
        # main buffer and every segment prefetched with it
        fetched = [b for b in budded if b > 0]
        stats["budded_fetches"] = len(fetched)
        stats["bytes_per_budded_fetch"] = (
            [int(min(fetched)), float(np.median(fetched)),
             int(max(fetched))] if fetched else None)
    if ss is not None:
        stats["b5_launches"] = {k: ss.launches[k] - b5_0[k]
                                for k in ss.launches}
        stats["b5_pack_with"] = len([1 for _, kw in calls
                                     if kw.get("proj") is not None])
    return out, stats, calls


def b5_cases(call, ss, rng):
    """The configurations phase 17 holds kernel B5 to its plain version in,
    from one budded_pack call of the main path that computed its small
    pack: as called, greedy flipped, a 16-row buffer, tiles of one entry,
    bits at K = 8 and at full coverage, cache mode (a seeded cached-row
    bitmap, M0U 16 and 0), and a threshold that mixes the -999 init state,
    0 and subnormal values into the captured one. Every case computes
    small13 in the launch (the first argument None). Yields (label, args,
    kwargs)."""
    import torch

    a, kw = call
    W = a[2].shape[1]
    nd = kw["nd"]
    n = a[2].shape[0]
    base = dict(kw, cache_on=False, M0U=None)
    args = [None] + list(a[1:7]) + [None]
    cb = torch.from_numpy(rng.integers(0, 256, nd // 8).astype("uint8")).to(
        a[2].device)
    eth = a[6].clone()
    e = eth[: 2 * nd].view(torch.bfloat16)
    e[0:n:7] = -999.0 / 120_000
    e[1:n:11] = 0.0
    e[2:n:13] = 9.2e-41
    kfull = min(((W + 3) // 4) * 4, 508)
    yield "as called", [None] + list(a[1:8]), dict(kw)
    yield "greedy flipped", args, dict(base, greedy=not kw["greedy"])
    yield "M0 16", args, dict(base, M0=16)
    yield "tiles K=1", args, dict(base, kind="tiles", K=1)
    yield "bits K=8", args, dict(base, kind="bits", K=8)
    yield f"bits K={kfull}", args, dict(base, kind="bits", K=kfull)
    for m0u in (16, 0):
        yield f"cache M0U={m0u}", args[:7] + [cb], dict(
            base, cache_on=True, M0U=m0u)
    yield "mixed e_thresh", args[:6] + [eth, None], dict(base)


def b5_vs_plain(ss, args, kw):
    """Kernel B5 and its plain version on the same card tensors, with
    small13 computed in the launch and then given (the kernel's): the
    largest |difference| over buf, order, order_u and small13, then over
    the follow-up (take_subs) of the rows past the buffer (or the first 64
    compacted rows when the buffer holds them all). Returns (err, buf,
    m_u, small13)."""
    import torch

    got = ss.budded_pack(*args, **kw)
    want = ss.budded_pack_ref(*args, **kw)
    err = max_abs_diff(got, want)
    small13 = got[3]
    given = [small13] + list(args[1:])
    err = max(err, max_abs_diff(ss.budded_pack(*given, **kw),
                                ss.budded_pack_ref(*given, **kw)))
    buf = got[0]
    m_u = int(buf[:16].view(torch.int32)[3 if kw["cache_on"] else 0])
    MU = kw["M0U"] if kw["cache_on"] else kw["M0"]
    nd = kw["nd"]
    M0, M = ((MU, min(ss.bucket15(m_u - MU), nd - MU)) if m_u > MU
             else (0, min(64, nd)))
    tk = dict(M0=M0, M=M, K=kw["K"], kind=kw["kind"])
    targs = given[:4] + [args[5], got[2]]
    err = max(err, max_abs_diff([ss.take_subs(*targs, **tk)],
                                [ss.take_subs_ref(*targs, **tk)]))
    return err, buf, m_u, small13


def small_args(a, kw):
    """small_pack's arguments from a budded_pack call that computed its
    small pack."""
    return (a[1], a[2], a[3], kw["quals"], a[5], kw["lerr"], kw["small5"])


def small_bound_bytes(a, kw):
    """Bytes B5's small pack must move on this call's data (0 when the
    call gives small13): each row's quals and its tvec (or its sequence,
    gapless rows) up to its length, its small5 and length, the lerr table
    and the center's row. The small13 rows (written, or read when given)
    are counted by the caller."""
    if a[0] is not None:
        return 0
    lens = a[3]
    per_pos = 2 if kw["quals"] is not None else 1
    return (per_pos * int(lens.clamp(max=a[2].shape[1]).sum()) + a[3].numel()
            * (5 + 8) + kw["lerr"].numel() * 4 + a[2].shape[1])


def b5_bound(args, kw, buflen):
    """(bound_ms, bound_by, detail) of one budded_pack: the bytes B5 must
    move at the HBM rate — the small pack's (small_bound_bytes), small13
    (written or read), eth2 and reads over every row (and the cached-row
    bitmap, the projection operand and the fold's output, f32 a row), tvec
    and seqs rows and lengths of the MU packed slots and the center's row;
    buf and the order(s) written — against its operations (a few per
    position of the small pack and a few dozen per row for the screen and
    the fold: negligible at the int32 rate)."""
    n, W = args[2].shape
    nd = kw["nd"]
    MU = kw["M0U"] if kw["cache_on"] else kw["M0"]
    small = small_bound_bytes(args, kw)
    nbytes = (small + n * (13 + 4) + 2 * nd + nd // 8
              + (nd // 8 if kw["cache_on"] else 0)
              + 4 * nd * ((kw.get("proj") is not None)
                          + (kw.get("proj_out") is not None))
              + MU * (2 * W + 8) + W
              + buflen + 4 * nd * (2 if kw["cache_on"] else 1))
    ops = 40 * nd + 8 * MU * W + (4 * n * W if small else 0)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), by, (
        f"{nbytes} bytes ({small} of them the small pack's) -> "
        f"{t_bytes:.6f} ms; ~{ops} int32 ops -> {t_ops:.6f} ms")


def device_ms_per_call(fn, calls=20):
    """fn's device time per call from torch.profiler's kernel durations:
    each of `calls` calls after a sync, under the profiler, after a spin
    kernel of ~10 ms (kernels at the very start of a short profiling
    window can be missing from its trace; the spin is not counted).
    Returns (median device ms per call, kernels per call, {kernel name:
    count}); (None, 0, {}) when the profiler saw no device events."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    names = {}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(20_000_000)
        torch.cuda.synchronize()
        for _ in range(calls):
            fn()
            torch.cuda.synchronize()
    kern = sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in prof.events() if e.device_type == DeviceType.CUDA
                  and "spin" not in e.name)
    if not kern:
        return None, 0, {}
    for _, _, name in kern:
        names[name] = names.get(name, 0) + 1
    k = len(kern) // calls
    if k * calls == len(kern):
        per = [sum(e - s for s, e, _ in kern[i * k:(i + 1) * k])
               for i in range(calls)]
        return float(np.median(per)) / 1e3, k, names
    return (sum(e - s for s, e, _ in kern) / calls / 1e3, len(kern) / calls,
            names)


def b5_device_child(path: str) -> None:
    """17c's device times in a fresh process: in chip_smoke's own process,
    after its earlier phases, torch.profiler recorded no kernel of a
    window this short (the cause is not known), where a fresh process
    records them. Loads the budded_pack calls saved at path ({label: (args,
    kwargs)}, CPU tensors) onto the card and prints one JSON line {label:
    {"budded" (small13 computed, as called), "given" (small13 given),
    "take" (the follow-up over the first max(MU, 16) compacted rows),
    "small" (the small-only launch), "no_proj" (as called without a
    projection operand) and "proj_fold" (with one, the call's own or all
    -inf, and the fold into a fresh output, as a chained segment): [device
    ms per call, kernels per call, {kernel name: count}]}}."""
    import torch

    sys.path.insert(0, ROOT)
    from dada2_tpu_torch.ops import store_screen as ss

    dev = torch.device("cuda", 0)

    def card(x):
        return x.to(dev) if torch.is_tensor(x) else x

    out = {}
    for label, (a, kw) in torch.load(path).items():
        a = [card(x) for x in a]
        kw = {k: card(v) for k, v in kw.items()}
        got = ss.budded_pack(*a, **kw)
        given = [got[3]] + a[1:]
        MU = kw["M0U"] if kw["cache_on"] else kw["M0"]
        tk = dict(M0=0, M=min(max(MU, 16), kw["nd"]), K=kw["K"],
                  kind=kw["kind"])
        targs = (got[3], a[1], a[2], a[3], a[5], got[2])
        sa = small_args(a, kw)
        bare = {k: v for k, v in kw.items() if k != "proj"}
        proj = kw.get("proj")
        fold = dict(bare, proj=proj if proj is not None else torch.full(
            (kw["nd"],), float("-inf"), device=dev),
            proj_out=torch.empty(kw["nd"], device=dev),
            logtotal=math.log(max(int(a[4].sum()), 1)))
        out[label] = {
            "no_proj": device_ms_per_call(
                lambda: ss.budded_pack(*a, **bare)),
            "proj_fold": device_ms_per_call(
                lambda: ss.budded_pack(*a, **fold)),
            "budded": device_ms_per_call(lambda: ss.budded_pack(*a, **kw)),
            "given": device_ms_per_call(lambda: ss.budded_pack(*given,
                                                               **kw)),
            "take": device_ms_per_call(lambda: ss.take_subs(*targs, **tk)),
            "small": device_ms_per_call(lambda: ss.small_pack(*sa))}
    print(json.dumps(out), flush=True)


def b5_device_times(calls):
    """Run b5_device_child on {label: (args, kwargs)} in a fresh process;
    returns its {label: {...}}."""
    import torch

    def cpu(x):
        return x.cpu() if torch.is_tensor(x) else x

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "b5_calls.pt")
        torch.save({label: ([cpu(x) for x in a],
                            {k: cpu(v) for k, v in kw.items()})
                    for label, (a, kw) in calls.items()}, path)
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--b5-device-time",
             path], capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        fail(f"17c: the device-time process failed ({proc.returncode}): "
             f"{proc.stderr[-2000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def shortlist_phase(dt, dev, card, sim, res5, n_b5):
    """Phase 17: kernel B5 against its plain version on inputs captured
    from phase 5's path (17a), phase 5's sample through the budded route
    against the full route on the card (17b), and B5's device and call
    times at the run's median and largest buffer (17c). Fails on any
    difference; returns B5's row of the kernels line."""
    import numpy as np
    import torch

    from dada2_tpu_torch.core.backend_cuda import CudaBackend
    from dada2_tpu_torch.ops import store_screen as ss

    def selfconsist():
        return dt.dada(sim, err=None, selfConsist=True, device=dev,
                       verbose=False)

    # 17b. phase 5's sample again, instrumented, then with the budded
    # route off (every compare the full route: the small pack of every
    # row, the host screen, tvec rows): both equal phase 5's result
    res_b, st_b, calls = transport_run(selfconsist)
    saved = CudaBackend.SHORTLIST_MIN_N
    CudaBackend.SHORTLIST_MIN_N = 1 << 40
    try:
        res_f, st_f, _ = transport_run(selfconsist)
    finally:
        CudaBackend.SHORTLIST_MIN_N = saved
    try:
        same_sample(res5, res_b, "17b budded route vs phase 5")
        same_sample(res5, res_f, "17b full route vs phase 5")
    except AssertionError as e:
        fail(f"17b: phase 5's sample differs between routes: {e}")
    if (not calls or st_b["b5_launches"]["pack"] != len(calls)
            or st_f["b5_launches"]["pack"]
            or not st_f["b5_launches"]["small"]
            or not st_f["b5_launches"]["full"]):
        fail(f"17b: B5 launches {st_b['b5_launches']} budded, "
             f"{st_f['b5_launches']} with the route off (its compares must "
             f"be screened full compares: B5's small-only launch and full "
             f"mode)")
    for label, st in (("budded route", st_b), ("full route", st_f)):
        log(f"[shortlist] 17b phase 5's sample, {label}: "
            f"{json.dumps(st, sort_keys=True)}; card {card}")
    computed = [k for k, (a, _) in enumerate(calls) if a[0] is None]
    log(f"[shortlist] 17b: both routes equal phase 5's result (phase 4 "
        f"holds sam1F card == CPU through the budded route; this sample is "
        f"too large for the CPU's plain B1); {len(computed)} of "
        f"{len(calls)} budded compares computed their small pack in B5's "
        f"launch, the rest hit the small13 cache")
    if not computed:
        fail("17b: no budded compare computed its small pack in B5")

    # 17a. B5 against its plain version at three buds of 17b's run (of
    # those that computed their small pack), and the small-only launch
    rng = np.random.default_rng(17)
    err17 = 0
    picks = sorted({computed[0], computed[len(computed) // 2],
                    computed[-1]})
    for k in picks:
        for label, args, kw in b5_cases(calls[k], ss, rng):
            err, buf, m_u, small13 = b5_vs_plain(ss, args, kw)
            err17 = max(err17, err)
            log(f"[shortlist] 17a bud {k} {label}: M0={kw['M0']} "
                f"M0U={kw['M0U']} {kw['kind']} K={kw['K']} "
                f"greedy={kw['greedy']}: {len(buf)} bytes, m_u={m_u}; max "
                f"|kernel - plain| = {err} (small13 computed and given)")
            if err != 0:
                fail(f"kernel B5 disagrees with its plain version (bud {k}, "
                     f"{label})")
        sa = small_args(*calls[k])
        alone = ss.small_pack(*sa)
        err = max_abs_diff([alone, alone], [ss.small_pack_ref(*sa), small13])
        err17 = max(err17, err)
        log(f"[shortlist] 17a bud {k} small-only launch: max |kernel - "
            f"small_pack_ref|, |small-only - budded small13| = {err}")
        if err != 0:
            fail(f"B5's small-only launch disagrees (bud {k})")
    torch.cuda.synchronize()

    # 17c. B5's device and call times at the run's median and largest
    # buffer (calls that computed their small pack), the follow-up and the
    # small-only launch; device times from torch.profiler in a fresh
    # process (b5_device_child)
    m0s = [calls[k][1]["M0"] for k in computed]
    tiny = torch.zeros(1, device=dev)
    floor_ms = cuda_ms(lambda: tiny.add_(1), 200)
    picked = {label: next(calls[k] for k in computed
                          if calls[k][1]["M0"] == M0)
              for label, M0 in (("median M0", int(np.median(m0s))),
                                ("largest M0", max(m0s)))}
    dev_t = b5_device_times(picked)
    timed = []
    for label, (a, kw) in picked.items():
        d = dev_t[label]
        for part, (_, per_call, names) in d.items():
            if per_call != 1:
                fail(f"17c: {part} at {label} ran {per_call} kernels per "
                     f"call, not 1 ({names})")
        ms = cuda_ms(lambda: ss.budded_pack(*a, **kw), 50)
        plain = cuda_ms(lambda: ss.budded_pack_ref(*a, **kw), 5)
        out = ss.budded_pack(*a, **kw)
        buflen = len(out[0])
        b_ms, b_by, det = b5_bound(a, kw, buflen)
        given = [out[3]] + list(a[1:])
        g_ms = cuda_ms(lambda: ss.budded_pack(*given, **kw), 50)
        g_bound, _, _ = b5_bound(given, kw, buflen)
        MU = kw["M0U"] if kw["cache_on"] else kw["M0"]
        tk = dict(M0=0, M=min(max(MU, 16), kw["nd"]), K=kw["K"],
                  kind=kw["kind"])
        targs = (out[3], a[1], a[2], a[3], a[5], out[2])
        t_ms = cuda_ms(lambda: ss.take_subs(*targs, **tk), 50)
        e = max_abs_diff([ss.take_subs(*targs, **tk)],
                         [ss.take_subs_ref(*targs, **tk)])
        err17 = max(err17, e)
        if e != 0:
            fail(f"17c: the follow-up at {label} disagrees with "
                 f"take_subs_ref (max |kernel - plain| = {e})")
        t_plain = cuda_ms(lambda: ss.take_subs_ref(*targs, **tk), 5)
        t_bound, t_bytes = take_bound(targs, tk)
        sa = small_args(a, kw)
        s_ms = cuda_ms(lambda: ss.small_pack(*sa), 50)
        s_plain = cuda_ms(lambda: ss.small_pack_ref(*sa), 5)
        s_bound = ((small_bound_bytes([None] + list(a[1:]), kw)
                    + 13 * a[2].shape[0]) / HBM_BYTES_PER_S * 1e3)
        timed.append(dict(
            shape=label, M0=kw["M0"], K=kw["K"], kind=kw["kind"],
            cache_on=kw["cache_on"], nd=kw["nd"], ms=ms,
            device_ms=d["budded"][0], plain_ms=plain, bound_ms=b_ms,
            bound_by=b_by, buf_bytes=buflen, given_ms=g_ms,
            given_device_ms=d["given"][0], given_bound_ms=g_bound,
            take=dict(rows=tk["M"], K=tk["K"], kind=tk["kind"], ms=t_ms,
                      device_ms=d["take"][0], plain_ms=t_plain,
                      bound_ms=t_bound, bound_by="bytes",
                      launch_floor_ms=floor_ms),
            small=dict(ms=s_ms, device_ms=d["small"][0], plain_ms=s_plain,
                       bound_ms=s_bound)))
        log(f"[shortlist] 17c B5 at {label} (nd={kw['nd']}, M0={kw['M0']}, "
            f"{kw['kind']} K={kw['K']}, cache {kw['cache_on']}): device "
            f"{d['budded'][0]} ms per call (one kernel: "
            f"{list(d['budded'][2])}), call {ms:.4f} ms (CUDA events over 50 "
            f"calls); small13 given: device {d['given'][0]} ms, call "
            f"{g_ms:.4f} ms, bound {g_bound:.6f} ms; plain version "
            f"(torch-ops chain, small pack included) {plain:.4f} ms; bound "
            f"{b_ms:.6f} ms by {b_by} ({det}); follow-up ({tk['M']} rows) "
            f"device {d['take'][0]} ms, call {t_ms:.4f} ms; small-only "
            f"launch device {d['small'][0]} ms, call {s_ms:.4f} ms, bound "
            f"{s_bound:.6f} ms by bytes, plain version (small_pack_ref) "
            f"{s_plain:.4f} ms; one launch's floor {floor_ms:.4f} ms (a "
            f"1-element add_); the follow-up == take_subs_ref bitwise, "
            f"bound {t_bound:.6f} ms by bytes ({t_bytes}), plain version "
            f"{t_plain:.4f} ms; card {card}")
    top = timed[-1]
    budded = {k: n_b5[k] for k in ("pack", "small")}
    packer = {k: n_b5[k] for k in ("take", "gather")}
    take_timed = [dict(shape=f"17c {t['shape']}", mode="take_subs",
                       **t["take"]) for t in timed]
    return dict(launches=sum(budded.values()), launches_by_wrapper=budded,
                ms=top["ms"], device_ms=top["device_ms"],
                plain_ms=top["plain_ms"], bound_ms=top["bound_ms"],
                bound_by=top["bound_by"], launch_floor_ms=floor_ms,
                timed=timed, max_abs_err=err17), dict(
                    stats=st_b, calls=calls, dev_t=dev_t, picked=picked,
                    packer=dict(launches=sum(packer.values()),
                                launches_by_wrapper=packer,
                                timed=take_timed))


# ---- phase 18: the full compare's one-fetch transport (B5's full and ------
# gather modes), compare_many and the packed construction upload

# phase 5's transport bytes before this slice (PERF.md §5: PR 11's run 3,
# the same in PR 12's run 3; NVIDIA H100 80GB HBM3, 700.00 W)
PARENT_PHASE5_BYTES = {"be.tvec": 10_160_750, "be.small_fetch": 432_600}


def full_inputs(be, err, center=0, opts=None):
    """A full compare's device inputs from backend be at its main-path
    state: center's align entry (kernel B1's sweep under opts, default
    DEFAULT_OPTIONS), its small13 under err (B5's small-only launch),
    e_thresh near each row's lambda mixing the -999 init state, 0 and
    subnormal values, and the eth operands (bf16 thresholds then the pad
    bitmap; the pad bitmap alone)."""
    import numpy as np
    import torch

    from dada2_tpu_torch.options import DEFAULT_OPTIONS

    opts = (opts or DEFAULT_OPTIONS).normalized()
    ent = be._align_ent(center, opts, be._kernel_geom(
        int(be.lens[center]), opts))
    small13 = be._small13(ent, center, err)
    n, nd = be.rs.n, be.nd
    rng = np.random.default_rng(18)
    loglam = small13[:, 4:8].contiguous().view(torch.float32).cpu().numpy()
    e = np.exp(np.nan_to_num(loglam[:, 0].astype(np.float64), neginf=-80.0)
               + rng.normal(0, 0.3, n))
    e[0::7], e[1::11], e[2::13] = -999.0 / 120_000, 0.0, 9.2e-41
    eth = np.zeros(2 * nd + nd // 8, np.uint8)
    eth[: 2 * n] = (e.astype(np.float32).view(np.uint32) >> 16).astype(
        np.uint16).view(np.uint8)
    eth[2 * nd:] = np.packbits(np.arange(nd) >= n, bitorder="little")
    dev = small13.device
    return dict(ent=ent, small13=small13, small5=ent[2],
                eth=torch.from_numpy(eth).to(dev),
                pad=torch.from_numpy(eth[2 * nd:].copy()).to(dev),
                base=(ent[1], be.d_seqs, be.d_lens, center), nd=nd, n=n,
                L=be.maxlen, W=be.rs.seqs.shape[1])


def full_args(inp, screened, M0, K):
    """full_pack's (args, kwargs) for inputs from full_inputs."""
    small = inp["small13"] if screened else inp["small5"]
    eth = inp["eth"] if screened else inp["pad"]
    return ((small,) + inp["base"] + (eth,),
            dict(nd=inp["nd"], L=inp["L"], M0=M0, K=K, screened=screened))


def full_adaptive_m0(be, screened):
    """The M0 a first full compare of this backend takes
    (CudaBackend._full_dispatch with no history)."""
    if screened:
        return min(be.FULL_SCREENED_M0, be.nd)
    M0 = 256
    while M0 < be.rs.n:
        M0 *= 2
    return min(M0, be.nd)


def full_vs_plain(ss, inp, screened, M0, K):
    """B5's full mode against full_pack_ref (buffer, order), then the
    follow-up over its order (take over the small rows it read) against
    take_subs_ref. Returns (max |difference|, m, buffer bytes)."""
    import torch

    a, kw = full_args(inp, screened, M0, K)
    got = ss.full_pack(*a, **kw)
    err = max_abs_diff(got, ss.full_pack_ref(*a, **kw))
    m = int(got[0][:16].view(torch.int32)[0])
    nd = kw["nd"]
    T0, M = ((M0, min(ss.bucket15(m - M0), nd - M0)) if m > M0
             else (0, min(64, nd)))
    targs = (a[0],) + inp["base"] + (got[1],)
    tk = dict(M0=T0, M=M, K=K)
    err = max(err, max_abs_diff([ss.take_subs(*targs, **tk)],
                                [ss.take_subs_ref(*targs, **tk)]))
    return err, m, len(got[0])


def gather_args(ss, inp, K, hmax=None):
    """gather_subs's arguments over the center's non-gapless rows (those
    with ham <= hmax, if given), bucketed with copies of the first, as the
    classic path's tile fetch takes them."""
    import numpy as np
    import torch

    s5 = inp["small5"].cpu().numpy()
    ham = s5[:, :4].copy().view(np.int16)[:, 0]
    rows = np.nonzero((s5[:, 4] & 2) == 0)[0]
    if hmax is not None:
        rows = rows[ham[rows] <= hmax]
    idx = np.concatenate([rows, np.full(ss.bucket15(len(rows)) - len(rows),
                                        rows[0])]).astype(np.int32)
    return (inp["base"] + (inp["small5"], torch.from_numpy(idx).to(
        inp["small5"].device)), dict(K=K))


def full_bound(inp, a, kw, buflen):
    """(bound_ms, detail) of one full_pack by bytes at the HBM rate: the
    small rows and eth read, the tvec and sequence rows and lengths of
    the M0 packed slots and the center's row, the buffer and the order
    written (its operations, a few dozen a row and a few a position of
    the slots, are negligible at the int32 rate)."""
    n, nd, W, M0 = inp["n"], kw["nd"], inp["W"], kw["M0"]
    nbytes = (a[0].numel() + a[5].numel() + M0 * (2 * W + 8) + W + buflen
              + 4 * nd)
    return nbytes / HBM_BYTES_PER_S * 1e3, f"{nbytes} bytes"


def slot_bytes(small, seqs, lens, center, rows, K, kind, row5):
    """Bytes the slot packer must move for slots of source rows `rows`
    (int64, into the n rows): per slot its index (4) and length (8), its
    small row (5 bytes read, and written again with row5) or its flags
    byte, and its records written (2K bytes; bits ceil(W/8) + K/4); its
    tvec row up to its length, a gapless row its sequence up to its length
    instead, and the center's sequence once if any slot is gapless."""
    W = seqs.shape[1]
    ln = lens[rows].clamp(max=W)
    gl = (small[rows, -1].int() & 2) != 0
    subw = (W + 7) // 8 + K // 4 if kind == "bits" else 2 * K
    return (len(rows) * (4 + 8 + (10 if row5 else 1) + subw)
            + int(ln.sum()) + (W if bool(gl.any()) else 0))


def take_bound(a, kw):
    """(bound_ms, bytes) of one take_subs (the follow-up) by bytes at the
    HBM rate (slot_bytes over its rows; its operations, a few a position,
    are negligible at the int32 rate)."""
    small, tvec, seqs, lens, center, order = a
    idx = order[kw["M0"]: kw["M0"] + kw["M"]].long()
    src = torch_where_src(idx, seqs.shape[0])
    nbytes = slot_bytes(small, seqs, lens, center, src, kw["K"],
                        kw.get("kind", "tiles"), True)
    return nbytes / HBM_BYTES_PER_S * 1e3, nbytes


def gather_bound(a, kw):
    """(bound_ms, bytes) of one gather_subs by bytes (slot_bytes over its
    row list, tiles)."""
    tvec, seqs, lens, center, small, idx = a
    nbytes = slot_bytes(small, seqs, lens, center,
                        torch_where_src(idx.long(), seqs.shape[0]),
                        kw["K"], "tiles", False)
    return nbytes / HBM_BYTES_PER_S * 1e3, nbytes


def torch_where_src(idx, n):
    """Row n.. (a pad row) reads row 0."""
    return idx.where(idx < n, idx.new_zeros(()))


def b5_call_device_child(path: str) -> None:
    """18e's device times in a fresh process (as 17c's): loads {label:
    (wrapper name in ops/store_screen.py, args, kwargs)} (CPU tensors)
    onto the card and prints one JSON line {label: [device ms per call,
    kernels per call, {kernel name: count}]}."""
    import torch

    sys.path.insert(0, ROOT)
    from dada2_tpu_torch.ops import store_screen as ss

    dev = torch.device("cuda", 0)

    def card(x):
        return x.to(dev) if torch.is_tensor(x) else x

    out = {}
    for label, (fn, a, kw) in torch.load(path).items():
        a = [card(x) for x in a]
        kw = {k: card(v) for k, v in kw.items()}
        out[label] = device_ms_per_call(
            lambda: getattr(ss, fn)(*a, **kw))
    print(json.dumps(out), flush=True)


def b5_call_device_times(calls):
    """Run b5_call_device_child on {label: (wrapper, args, kwargs)}
    in a fresh process; returns its {label: [...]}."""
    import torch

    def cpu(x):
        return x.cpu() if torch.is_tensor(x) else x

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "b5_calls.pt")
        torch.save({label: (fn, [cpu(x) for x in a],
                            {k: cpu(v) for k, v in kw.items()})
                    for label, (fn, a, kw) in calls.items()}, path)
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__),
             "--b5-call-device-time", path], capture_output=True, text=True,
            timeout=600)
    if proc.returncode != 0:
        fail(f"18e: the device-time process failed ({proc.returncode}): "
             f"{proc.stderr[-2000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def init_compare_log(run):
    """run() with every compare recorded: whether it is an init compare
    (no positive e_thresh) under a real error matrix, the be.tvec bytes
    it fetched and the full-mode launches it made (one sample at a time:
    the phases and launches are process-wide). Returns (run's result,
    [(init, tvec bytes, full launches)])."""
    import numpy as np

    from dada2_tpu_torch.core import backend_cuda as bc
    from dada2_tpu_torch.ops import store_screen as ss
    from dada2_tpu_torch.trace import PHASES

    B = bc.CudaBackend
    orig = B.compare
    log_ = []

    def compare(self, center, skip, opts, err, use_kmers, kdist_cutoff,
                e_thresh=None):
        init = (not (err == 1.0).all() and (
            e_thresh is None or not bool(np.any(e_thresh > 0))))
        b0 = PHASES.bytes_dict().get("be.tvec", 0)
        f0 = ss.launches["full"]
        out = orig(self, center, skip, opts, err, use_kmers, kdist_cutoff,
                   e_thresh)
        log_.append((init, PHASES.bytes_dict().get("be.tvec", 0) - b0,
                     ss.launches["full"] - f0))
        return out

    B.compare = compare
    try:
        return run(), log_
    finally:
        B.compare = orig


def full_phase(dt, dev, card, p5, st17):
    """Phase 18: B5's full mode and gather mode against
    their plain versions at sam1F's and phase 5's sizes (18a), sam1F and
    sam2F through dada(selfConsist=True) card against CPU with the host
    tvec cache and samPB through it on the card (18b), phase 5's
    transport bytes against the parent's from 17b's instrumented run and
    the construction upload's bytes (18c),
    compare_many against k compare() calls (18d), and the full mode's,
    the gather mode's and the follow-up's device and call
    times against their bounds at the main path's shapes and samPB's,
    held there bitwise against the plain versions (18e). Fails on any
    difference; returns B5's full-mode and slot-packer entries for the
    kernels line."""
    import numpy as np
    import torch

    from dada2_tpu_torch.core import backend_cuda as bc
    from dada2_tpu_torch.core.backend_cuda import CudaBackend
    from dada2_tpu_torch.core.raws import make_rawset
    from dada2_tpu_torch.ops import store_screen as ss
    from dada2_tpu_torch.options import DEFAULT_OPTIONS

    t_phase = time.time()
    sim = p5["sim"]
    drp1 = dt.derep_fastq(SAM1F)
    bes = {"sam1F": CudaBackend(make_rawset(
        drp1.sequences, drp1.abundances, None, drp1.quals), device=dev),
        "phase 5": CudaBackend(make_rawset(
            sim.sequences, sim.abundances, None, sim.quals), device=dev)}
    errs = {"sam1F": dt.data.tperr1(), "phase 5": p5["err"]}
    inps = {k: full_inputs(be, errs[k]) for k, be in bes.items()}

    # 18a. the full mode (screened and not, M0 16 and the adaptive size,
    # K 8 and 48, the threshold mixing -999, 0 and subnormal values) with
    # the follow-up over its order, and the gather mode, bitwise
    err18 = 0
    for name, inp in inps.items():
        for screened in (False, True):
            for M0 in (16, full_adaptive_m0(bes[name], screened)):
                for K in (8, 48):
                    e, m, blen = full_vs_plain(ss, inp, screened, M0, K)
                    err18 = max(err18, e)
                    log(f"[full] 18a {name} (n={inp['n']}, nd={inp['nd']}) "
                        f"screened={screened} M0={M0} K={K}: m={m}, {blen} "
                        f"bytes; max |kernel - plain| = {e} (buffer, order, "
                        f"follow-up)")
        for K in (8, 48):
            a, kw = gather_args(ss, inp, K)
            for small in (inp["small5"], inp["small13"]):
                a = a[:4] + (small, a[5])
                e = max_abs_diff([ss.gather_subs(*a, **kw)], [
                    ss.gather_subs_ref(*a[:4], small[:, -1], a[5], **kw)])
                err18 = max(err18, e)
            log(f"[full] 18a {name} gather K={K} over {a[5].shape[0]} "
                f"rows (small5 and small13): max |kernel - plain| = {e}")
    if err18 != 0:
        fail("B5's full or gather mode disagrees with its plain version")
    torch.cuda.synchronize()

    # 18b. sam1F and sam2F through selfConsist, card against CPU: the
    # first real-err init compare takes the full mode and seeds the host
    # tvec cache, every later one fetches no tvec row (at the default
    # SPEC_K: phase 19c reads the card runs' spec counters)
    spec18 = {}
    full_by_path = {}
    for f in (SAM1F, SAM2F):
        drp = dt.derep_fastq(f)
        label = os.path.basename(f).split(".")[0]
        f0 = ss.launches["full"]
        s0 = {k: getattr(dt.COUNTERS, k) for k in SPEC_COUNTERS}
        b0 = ss.launches["pack"]
        res_c, clog = init_compare_log(lambda: dt.dada(
            drp, err=None, selfConsist=True, device="cuda", verbose=False))
        spec18[label] = dict(
            {k: getattr(dt.COUNTERS, k) - s0[k] for k in SPEC_COUNTERS},
            rounds=len(res_c.err_in), pack_launches=ss.launches["pack"] - b0)
        n_full = full_by_path[label] = ss.launches["full"] - f0
        t0 = time.time()
        res_h = dt.dada(dt.derep_fastq(f), err=None, selfConsist=True,
                        device="cpu", verbose=False)
        t_cpu = time.time() - t0
        try:
            same_sample(res_c, res_h, f"18b {label} card vs CPU")
        except AssertionError as e:
            fail(f"18b: {label} selfConsist differs card vs CPU: {e}")
        inits = [c for c in clog if c[0]]
        log(f"[full] 18b {label}: {len(res_c.err_in)} rounds, "
            f"{len(res_c.denoised)} ASVs, card == CPU (err_out, trans, "
            f"clustering, map; CPU {t_cpu:.1f}s); full-mode launches "
            f"{n_full}; init compares under a real err (tvec bytes, full "
            f"launches): {inits}")
        if n_full <= 0 or not inits or inits[0][2] != 1 or any(
                c[1] or c[2] for c in inits[1:]):
            fail(f"18b: {label}: the first real-err init compare must take "
                 f"the full mode and every later one the host tvec cache")
    # the PacBio full-length 16S path: samPB (259 uniques, W 1,511) through
    # selfConsist at BAND_SIZE=32 on the card (B1's route, so B5 at W
    # ~1,500; its init compare takes the full mode over 384 rows). No CPU
    # reference: B1's plain version at this width is slow
    drp_pb = dt.derep_fastq(SAMPB)
    l0 = dict(ss.launches)
    t0 = time.time()
    res_pb = dt.dada(drp_pb, err=None, selfConsist=True, BAND_SIZE=32,
                     device="cuda", verbose=False)
    torch.cuda.synchronize()
    wall_pb = time.time() - t0
    n_pb = {k: ss.launches[k] - l0[k] for k in ss.launches}
    eo = np.asarray(res_pb.err_out)
    if (eo.shape[0] != 16 or not np.isfinite(eo).all() or (eo < 0).any()
            or (eo > 1).any() or len(res_pb.denoised) == 0
            or res_pb.map.shape != (len(drp_pb.sequences),)):
        fail("18b: samPB's selfConsist outputs are malformed")
    full_by_path["samPB"] = n_pb["full"]
    log(f"[full] 18b samPB (PacBio, {len(drp_pb.sequences)} uniques, W "
        f"{max(len(x) for x in drp_pb.sequences)}) selfConsist at "
        f"BAND_SIZE=32 on the card: {len(res_pb.err_in)} rounds, "
        f"{len(res_pb.denoised)} ASVs, {wall_pb:.2f}s wall, B5 launches "
        f"{n_pb}")
    if n_pb["full"] <= 0:
        fail("18b: samPB's selfConsist never launched B5's full mode")

    # 18c. phase 5's transport (17b's instrumented run) against the parent,
    # and the construction upload
    ph = st17["phases"]
    got = {k: ph.get(k, [0, 0])[1] for k in (
        "be.tvec", "be.full_fetch", "be.small_fetch", "be.bud_fetch")}
    log(f"[full] 18c phase 5's sample (17b, budded route): bytes {got} "
        f"against the parent's be.tvec {PARENT_PHASE5_BYTES['be.tvec']} and "
        f"be.small_fetch {PARENT_PHASE5_BYTES['be.small_fetch']} (PERF.md "
        f"§5); dense re-fetches {st17['dense_refetches']}, follow-ups "
        f"{st17['followup_fetches']}, fetches {st17['device_fetches']}, "
        f"puts {st17['device_puts']} ({st17['put_bytes']} bytes); B5 "
        f"launches {st17['b5_launches']}; card {card}")
    if st17["b5_launches"]["gather"] <= 0:
        fail("18c: phase 5's path never launched B5's gather mode")
    rs5 = bes["phase 5"].rs
    blob, q6 = bc._pack_construction(np.asarray(rs5.seqs), rs5.quals)
    log(f"[full] 18c construction upload of phase 5's sample (n="
        f"{rs5.n}, W={rs5.seqs.shape[1]}): one blob of {blob.nbytes} bytes "
        f"(quals {'6-bit' if q6 else 'uint8'}) against the parent's "
        f"{rs5.seqs.size + rs5.quals.size} (int8 sequences and uint8 "
        f"quals, two puts)")

    # 18d. compare_many against k compare() calls, both halves
    be1 = bes["sam1F"]
    opts = DEFAULT_OPTIONS.normalized()
    err = dt.data.tperr1()
    skip = np.zeros(be1.rs.n, bool)
    e_minmax = np.full(be1.rs.n, -999.0)
    for c in range(4):
        lam_c, _ = be1.compare(c, skip, opts, err, True, 1.0)
        e_minmax = np.maximum(e_minmax, lam_c * int(be1.rs.reads[c]))
    eth = e_minmax / int(be1.rs.reads.sum())
    centers = [0, 3, 7, 11, 19]
    for label, e_t, kd in (("unscreened", None, 1.0),
                           ("screened", eth, 1.0),
                           ("budded", eth, opts.KDIST_CUTOFF)):
        rs1 = be1.rs
        a = CudaBackend(rs1, device=dev)
        b = CudaBackend(rs1, device=dev)
        many = a.compare_many(centers, skip, opts, err, True, kd, e_t)
        for c, (lam_m, ham_m) in zip(centers, many):
            lam_s, ham_s = b.compare(c, skip, opts, err, True, kd, e_t)
            if not (np.array_equal(lam_s, lam_m)
                    and np.array_equal(ham_s, ham_m)):
                fail(f"18d: compare_many ({label}) differs from compare() "
                     f"at center {c}")
        log(f"[full] 18d compare_many of {len(centers)} sam1F centers "
            f"({label}) == compare() bit for bit")

    # 18e. device time (torch.profiler, fresh process) and call time (CUDA
    # events) of the full mode at both sizes and of the
    # gather mode at phase 5's init compare's shape, and of all three at
    # samPB's (BAND_SIZE 32, W ~1,500, the follow-up in bits at K 128),
    # against the plain versions, the bound and one launch's floor
    timed = {}
    be5 = bes["phase 5"]
    be_pb = CudaBackend(make_rawset(drp_pb.sequences, drp_pb.abundances,
                                    None, drp_pb.quals), device=dev)
    inps["samPB"] = full_inputs(be_pb, dt.data.tperr1(),
                                opts=DEFAULT_OPTIONS.replace(BAND_SIZE=32))
    for label, inp, screened, M0, K in (
            ("sam1F init", inps["sam1F"], False,
             full_adaptive_m0(bes["sam1F"], False), 64),
            ("phase 5 screened", inps["phase 5"], True,
             full_adaptive_m0(be5, True), be5.FULL_SCREENED_K),
            ("samPB init", inps["samPB"], False,
             full_adaptive_m0(be_pb, False), 64)):
        timed[label] = ("full_pack",) + full_args(inp, screened, M0, K)
    a, kw = gather_args(ss, inps["phase 5"], 32, hmax=32)
    timed["phase 5 gather"] = ("gather_subs", a, kw)
    pb = inps["samPB"]
    a, kw = full_args(pb, True, 16, 128)
    targs = (pb["small13"],) + pb["base"] + (ss.full_pack_ref(*a, **kw)[1],)
    timed["samPB take"] = ("take_subs", targs, dict(
        M0=0, M=min(256, pb["nd"]), K=128, kind="bits"))
    timed["samPB gather"] = ("gather_subs",) + gather_args(ss, pb, 32)
    dev_t = b5_call_device_times(timed)
    tiny = torch.zeros(1, device=dev)
    floor_ms = cuda_ms(lambda: tiny.add_(1), 200)
    out = []
    for label, (fn, a, kw) in timed.items():
        d_ms, per_call, names = dev_t[label]
        if per_call != 1:
            fail(f"18e: {label} ran {per_call} kernels per call ({names})")
        call = getattr(ss, fn)
        ref = {"full_pack": ss.full_pack_ref,
               "take_subs": ss.take_subs_ref,
               "gather_subs": lambda *x, **k: ss.gather_subs_ref(
                   *x[:4], x[4][:, -1], x[5], **k)}[fn]
        ms = cuda_ms(lambda: call(*a, **kw), 50)
        plain = cuda_ms(lambda: ref(*a, **kw), 5)
        # every timed shape (the main path's: sam1F's init K 64, phase 5's
        # screened K 48 and its init tiles at K 32 over the rows with ham
        # <= 32, which 18a does not run; samPB's) bitwise against the plain
        # version
        r, want = call(*a, **kw), ref(*a, **kw)
        e = (max_abs_diff(r, want) if fn == "full_pack"
             else max_abs_diff([r], [want]))
        if e != 0:
            fail(f"18e: {fn} at {label} disagrees with its plain version "
                 f"(max |kernel - plain| = {e})")
        err18 = max(err18, e)
        inp = inps[next(k for k in inps if label.startswith(k))]
        if fn == "full_pack":
            b_ms, det = full_bound(inp, a, kw, len(r[0]))
        else:
            b_ms, det = (take_bound if fn == "take_subs"
                         else gather_bound)(a, kw)
        shape = {k: v for k, v in kw.items() if not torch.is_tensor(v)}
        out.append(dict(shape=label, mode=fn, ms=ms,
                        device_ms=d_ms, plain_ms=plain, bound_ms=b_ms,
                        bound_by="bytes", launch_floor_ms=floor_ms,
                        rows=int(a[1].shape[0]), W=int(a[1].shape[1]),
                        **{k: v for k, v in shape.items() if k != "nd"}))
        log(f"[full] 18e {fn} at {label} "
            f"(n={a[1].shape[0]}, W={a[1].shape[1]}, {json.dumps(shape)}"
            f"): kernel == plain bitwise; device {d_ms} ms per call (one "
            f"kernel: {list(names)}), call {ms:.4f} ms (CUDA events over 50 "
            f"calls), plain version {plain:.4f} ms, bound {b_ms:.6f} ms by "
            f"bytes ({det}), one launch's floor {floor_ms:.4f} ms; card "
            f"{card}")
    stages = torch_stages(ss, bc, bes["phase 5"], inps["phase 5"], card,
                          st17["dense_refetches"])
    log(f"[full] phase 18 took {time.time() - t_phase:.1f}s")
    return dict(timed=out, max_abs_err=err18, stages=stages, spec18=spec18,
                full_by_path=full_by_path)


# ---- phase 19: speculation, the multi-bud prefetch ---------------------------

SPEC_COUNTERS = ("spec_hits", "spec_misses", "spec_wasted")


def proj_cases(call, ss, rng):
    """The configurations phase 19 holds B5's projection to its plain
    versions in, from one budded_pack call of the main path that computed
    its small pack: the fold alone (no proj), an all -inf proj, a mixed
    proj (each row's own loglam plus noise on half the rows, -inf on the
    rest, finite on the center's row, which the screen exempts) with the
    fold, greedy flipped and cache mode (M0U 16) with it, and the mixed
    proj without the fold. small13 None: computed in the launch. Yields
    (label, args, kwargs without proj_out)."""
    import numpy as np
    import torch

    a, kw = call
    nd, center = kw["nd"], a[5]
    dev = a[2].device
    small13 = ss.budded_pack(*a, **{k: v for k, v in kw.items()
                                     if k != "proj"})[3]
    loglam = small13[:, 4:8].contiguous().view(torch.float32)[:, 0].cpu()
    src = np.minimum(np.arange(nd), small13.shape[0] - 1)
    src[small13.shape[0]:] = 0
    mixed = np.where(rng.random(nd) < 0.5, -np.inf,
                     loglam.numpy()[src] + rng.normal(0.0, 0.5, nd))
    mixed[center] = 0.0
    mixed = torch.from_numpy(mixed.astype(np.float32)).to(dev)
    neginf = torch.full((nd,), float("-inf"), device=dev)
    cb = torch.from_numpy(rng.integers(0, 256, nd // 8).astype("uint8")).to(
        dev)
    args = [None] + list(a[1:7]) + [None]
    base = {k: v for k, v in kw.items() if k != "proj"}
    base.update(cache_on=False, M0U=None)
    lt = math.log(max(int(a[4].sum()), 1))
    yield "fold, no proj", args, dict(base, logtotal=lt)
    yield "proj -inf, fold", args, dict(base, proj=neginf, logtotal=lt)
    yield "proj mixed, fold", args, dict(base, proj=mixed, logtotal=lt)
    yield "proj mixed, fold, greedy flipped", args, dict(
        base, proj=mixed, logtotal=lt, greedy=not kw["greedy"])
    yield "proj mixed, fold, cache M0U=16", args[:7] + [cb], dict(
        base, proj=mixed, logtotal=lt, cache_on=True, M0U=16)
    yield "proj mixed, no fold", args, dict(base, proj=mixed)


def proj_vs_plain(ss, args, kw):
    """B5 with the projection against its plain version on the same card
    tensors, small13 computed in the launch and then given, the buffer
    written into a slice of a larger one (the dispatch's one buffer) whose
    other bytes must stay untouched: the largest |difference| over buf,
    order, order_u, small13 and proj_out. Returns (err, m, buflen)."""
    import torch

    nd = kw["nd"]
    fold = "logtotal" in kw
    err, m, blen = 0, 0, 0
    for given in (False, True):
        a = list(args)
        if given:
            a[0] = small13
        outs = []
        for fn in (ss.budded_pack, ss.budded_pack_ref):
            po = torch.empty(nd, device=a[2].device) if fold else None
            res = fn(*a, **kw, proj_out=po)
            outs.append(list(res) + ([po] if fold else []))
            if fn is ss.budded_pack:
                blen = len(res[0])
                big = torch.full((blen + 64,), 0xA5, dtype=torch.uint8,
                                 device=a[2].device)
                res2 = fn(*a, **kw, proj_out=(torch.empty_like(po) if fold
                                               else None),
                          out=big[32: 32 + blen])
                err = max(err, max_abs_diff([res2[0]], [res[0]]))
                if bool((big[:32] != 0xA5).any()) or bool(
                        (big[32 + blen:] != 0xA5).any()):
                    err = max(err, 1)
        small13 = outs[0][3]
        err = max(err, max_abs_diff(outs[0], outs[1]))
        m = int(outs[0][0][:16].view(torch.int32)[0])
    return err, m, blen


def spec_phase(dt, dev, card, p5, p17, spec18):
    """Phase 19: speculation. (a) B5's projection operand and fold against
    the plain versions, bitwise, at three buds of 17b's run; (b) phase 5's
    sample at SPEC_K 8, 0, 0, 8, each equal to phase 5's result, with the
    spec counters, fetches, bytes per fetch (segments included), B5 and
    B1 launches, be.* phases and walls, and no host sync between a
    dispatch's first B5 launch and its fetch (torch's sync debug mode
    raises on one); (c) 18b's sam1F and sam2F runs, card == CPU at the
    default SPEC_K 8: spec hits; (d) B5's device time with and without
    the projection (17c's fresh-process child). Fails on any difference;
    returns B5's projection entry for the kernels line."""
    import numpy as np
    import torch

    from dada2_tpu_torch.core import backend_cuda as bc
    from dada2_tpu_torch.core.backend_cuda import CudaBackend
    from dada2_tpu_torch.ops import store_screen as ss

    t_phase = time.time()
    sim, res5 = p5["sim"], p5["res5"]
    if CudaBackend.SPEC_K != 8:
        fail(f"19: the default SPEC_K is {CudaBackend.SPEC_K}, not 8")

    # 19a. the projection operand and the fold, bitwise
    calls = p17["calls"]
    computed = [k for k, (a, _) in enumerate(calls) if a[0] is None]
    picks = sorted({computed[0], computed[len(computed) // 2],
                    computed[-1]})
    rng = np.random.default_rng(19)
    err19 = 0
    for k in picks:
        for label, args, kw in proj_cases(calls[k], ss, rng):
            err, m, blen = proj_vs_plain(ss, args, kw)
            err19 = max(err19, err)
            log(f"[spec] 19a bud {k} {label}: M0={kw['M0']} "
                f"M0U={kw['M0U']} {kw['kind']} K={kw['K']} "
                f"greedy={kw['greedy']}: m={m}, {blen} bytes; max |kernel - "
                f"plain| = {err} (buffer, orders, small13, proj_out; small13 "
                f"computed and given; written into a shared buffer)")
            if err != 0:
                fail(f"kernel B5's projection disagrees with its plain "
                     f"version (bud {k}, {label})")
    torch.cuda.synchronize()

    # 19b. phase 5's sample at SPEC_K 8, 0, 0, 8; the first run with the
    # sync debug mode raising between a dispatch's first B5 launch and its
    # fetch
    window = {"armed": False, "n": 0}
    pack, fetch = ss.budded_pack, bc._fetch

    def armed_pack(*a, **kw):
        out = pack(*a, **kw)
        if not window["armed"]:
            torch.cuda.set_sync_debug_mode("error")
            window["armed"] = True
        return out

    def disarming_fetch(x):
        if window["armed"]:
            torch.cuda.set_sync_debug_mode("default")
            window["armed"] = False
            window["n"] += 1
        return fetch(x)

    def selfconsist():
        return dt.dada(sim, err=None, selfConsist=True, device=dev,
                       verbose=False)

    runs = []
    for i, k in enumerate((8, 0, 0, 8)):
        CudaBackend.SPEC_K = k
        if i == 0:
            ss.budded_pack, bc._fetch = armed_pack, disarming_fetch
        try:
            res, st, _ = transport_run(selfconsist)
        except RuntimeError as e:
            fail(f"19b: a host sync between a dispatch's B5 launches and "
                 f"its fetch, or a failed run: {e}")
        finally:
            CudaBackend.SPEC_K = 8
            torch.cuda.set_sync_debug_mode("default")
            ss.budded_pack, bc._fetch = pack, fetch
        try:
            same_sample(res5, res, f"19b SPEC_K={k} vs phase 5")
        except AssertionError as e:
            fail(f"19b: phase 5's sample at SPEC_K={k} differs: {e}")
        st["SPEC_K"] = k
        runs.append(st)
        log(f"[spec] 19b phase 5's sample, SPEC_K={k} (run {i + 1}): wall "
            f"{st['wall_s']:.4f} s; spec {st['spec']}; budded compares "
            f"{st['budded_compares']}, of them fetching "
            f"{st['budded_fetches']}; bytes per budded fetch (min, median, "
            f"max; segments included) {st['bytes_per_budded_fetch']}; "
            f"fetches {st['device_fetches']} ({st['fetch_bytes']} bytes), "
            f"follow-ups {st['followup_fetches']}; B5 launches "
            f"{st['b5_launches']} ({st['b5_pack_with']} with a projection); "
            f"B1 launches {st['b1_launches']}; be.* (s, bytes) "
            f"{json.dumps(st['phases'], sort_keys=True)}; == phase 5; card "
            f"{card}")
    on = [r for r in runs if r["SPEC_K"] == 8]
    if not all(r["spec"]["spec_hits"] > 0 for r in on):
        fail("19b: speculation never hit on phase 5's sample")
    if window["n"] <= 0:
        fail("19b: the sync window was never armed")
    log(f"[spec] 19b: {window['n']} dispatches ran from their first B5 "
        f"launch to their fetch under torch.cuda.set_sync_debug_mode("
        f"'error'): no host sync in between")

    # 19c. 18b's sam1F and sam2F runs (card == CPU there) at SPEC_K 8
    for label, sc in spec18.items():
        log(f"[spec] 19c {label} dada(selfConsist=True) at SPEC_K 8 (18b, "
            f"card == CPU): {sc}")
        if sc["spec_hits"] <= 0:
            fail(f"19c: speculation never hit in {label}'s selfConsist")

    # 19d. B5's device time with and without the projection (17c's child)
    dev_t = p17["dev_t"]
    proj_t = {}
    for label, d in dev_t.items():
        a, kw = p17["picked"][label]
        proj_t[label] = dict(M0=kw["M0"], nd=kw["nd"],
                             no_proj_device_ms=d["no_proj"][0],
                             proj_fold_device_ms=d["proj_fold"][0])
        log(f"[spec] 19d B5 at 17c's {label} (nd={kw['nd']}, M0={kw['M0']}"
            f", {kw['kind']} K={kw['K']}): device {d['no_proj'][0]} ms per "
            f"call without the projection operand, {d['proj_fold'][0]} ms "
            f"with it and the fold (fresh process, torch.profiler); card "
            f"{card}")
    log(f"[spec] phase 19 took {time.time() - t_phase:.1f}s")
    return dict(max_abs_err=err19, runs=runs, device=proj_t, sam=spec18)


def host_ms(fn, reps):
    """fn's mean wall ms over reps calls on the host (CPU tensors)."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def torch_stages(ss, bc, be, inp, card, nrows):
    """18e's device stages in torch ops: the 4-bit tvec row gather
    (gather_tvec_packed, the dense re-fetch) over nrows rows bucketed as
    the backend sends them, and the construction unpack (_construct_dev)
    of phase 5's sample: call time on the card (CUDA events), the same
    ops on the CPU, the bound by bytes; card == CPU. Returns their
    device_stages entries."""
    import numpy as np
    import torch

    rs = be.rs
    rows = np.arange(max(nrows, 1), dtype=np.int64)
    idx = be._bucketed(rows)
    tvec = inp["ent"][1]
    got = ss.gather_tvec_packed(tvec, idx)
    want = ss.gather_tvec_packed(tvec.cpu(), idx.cpu())
    if not torch.equal(got.cpu(), want):
        fail("18e: gather_tvec_packed differs card vs CPU")
    M, W = idx.shape[0], tvec.shape[1]
    g_ms = cuda_ms(lambda: ss.gather_tvec_packed(tvec, idx), 50)
    g_cpu = host_ms(lambda: ss.gather_tvec_packed(tvec.cpu(), idx.cpu()), 5)
    g_bytes = M * (W + 4 + (W + 1) // 2)
    g_bound = g_bytes / HBM_BYTES_PER_S * 1e3
    blob, q6 = bc._pack_construction(np.asarray(rs.seqs), rs.quals)
    n, W = rs.seqs.shape
    kw = dict(n=n, W=W, q6=q6, with_quals=True)
    d_blob = torch.from_numpy(blob).to(be.device)
    got = bc._construct_dev(d_blob, be.d_lens, **kw)
    want = bc._construct_dev(torch.from_numpy(blob), be.d_lens.cpu(), **kw)
    if not all(torch.equal(g.cpu(), w) for g, w in zip(got, want)) or not (
            torch.equal(got[0], be.d_seqs)):
        fail("18e: the construction unpack differs card vs CPU")
    c_ms = cuda_ms(lambda: bc._construct_dev(d_blob, be.d_lens, **kw), 20)
    c_cpu = host_ms(lambda: bc._construct_dev(
        torch.from_numpy(blob), be.d_lens.cpu(), **kw), 3)
    c_bytes = blob.nbytes + 8 * n + 2 * n * W
    c_bound = c_bytes / HBM_BYTES_PER_S * 1e3
    log(f"[full] 18e gather_tvec_packed over {M} rows (phase 5's "
        f"{nrows} dense re-fetches, bucketed) x W {W}: call {g_ms:.4f} ms "
        f"(CUDA events), CPU {g_cpu:.4f} ms, bound {g_bound:.6f} ms by "
        f"bytes ({g_bytes}); construction unpack of phase 5's sample (blob "
        f"{blob.nbytes} bytes, quals {'6-bit' if q6 else 'uint8'}): call "
        f"{c_ms:.4f} ms, CPU {c_cpu:.4f} ms, bound {c_bound:.6f} ms by bytes "
        f"({c_bytes}); card == CPU; card {card}")
    return [dict(name="4-bit tvec row gather (gather_tvec_packed)",
                 route="torch ops", source="dada2_tpu_torch/ops/"
                 "store_screen.py", replaces="dada2_tpu/core/backend_tpu.py"
                 ":886", rows=M, ms=g_ms, plain_ms=g_cpu, plain_device="cpu",
                 bound_ms=g_bound, bound_by="bytes", library_ms=None),
            dict(name="construction unpack (_construct_dev)",
                 route="torch ops", source="dada2_tpu_torch/core/"
                 "backend_cuda.py", replaces="dada2_tpu/core/backend_tpu.py"
                 ":682", blob_bytes=int(blob.nbytes),
                 parent_bytes=int(rs.seqs.size + rs.quals.size), ms=c_ms,
                 plain_ms=c_cpu, plain_device="cpu", bound_ms=c_bound,
                 bound_by="bytes", library_ms=None)]


def wide_phase(dt, nwb, dev, card, reset_launches, counts):
    """20. Kernel B4's wide body (windows of 257 to 2,048 rows) at the three
    shapes it serves for users, each held bitwise against the plain
    version on the card: merge_whole (merge_pairs' alignments of 4,096
    whole 2 x 300 V3-V4 read pairs, W 301), shift_v34 (is_shift_denovo on
    500 V3-V4 ASVs: 124,750 pairs, W 461; the whole call's wall and
    launches, its first 4,096-pair chunk and a 64-pair subset held, and 40
    of the ASVs card == CPU) and shift_pb (is_shift_denovo on samPB's 64
    most abundant uniques: 2,016 pairs, W ~1,500, pointers in device
    memory; all pairs and a 64-pair subset held). At each: the kernel's ms
    (CUDA events around its launches alone, and device time from
    torch.profiler), the call's ms, launches by body, the bound, the plain
    version's ms and the one-block-per-pair body's kernel ms on the same
    batch (forced). Returns the kernels line's row and the largest
    difference from the plain version."""
    import numpy as np
    import torch
    from dada2_tpu_torch.encode import pack_sequences

    merge_kw = dict(match=1, mismatch=-64, gap_p=-64, band=-1, mode="scalar")
    shift_kw = dict(match=5, mismatch=-4, gap_p=-8, band=-1, mode="scalar")
    err = 0
    by_path = {}

    def on_card(codes1, lens1, codes2, lens2):
        return [torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in
                (codes1, np.asarray(lens1, np.int64), codes2,
                 np.asarray(lens2, np.int64))]

    def held(label, args, kw):
        """The kernel == the plain version on args, bitwise, through the
        wide body alone; returns the plain outputs and the plain ms."""
        nonlocal err
        budget = nwb.MAX_BYTES
        nwb.MAX_BYTES = 16 << 30  # the plain version's tensors in one chunk
        try:
            t0 = time.time()
            want = nwb.nw_batch_ref(*args, **kw)
            torch.cuda.synchronize()
            plain = (time.time() - t0) * 1e3
        finally:
            nwb.MAX_BYTES = budget
        reset_launches()
        got = nwb.nw_batch(*args, **kw)
        torch.cuda.synchronize()
        n = counts()
        e = max_abs_diff(got, want)
        err = max(err, e)
        if e != 0 or not bool(got[5].all()):
            fail(f"kernel B4's wide body disagrees with its plain version "
                 f"({label})")
        if n["B4"] <= 0 or n["B4 wide"] != n["B4"]:
            fail(f"{label}: B4's launches {n} did not all take the wide body")
        log(f"[wide] {label}: {args[0].shape[0]} pairs held, {n['B4']} wide "
            f"launch(es), max |kernel - plain| = {e} (kinds, p0, p1, ham, "
            f"tvec, ok); plain {plain:.1f} ms")
        return want, plain

    def timed(label, args, kw, reps, outs, plain):
        fit = b4_fit(nwb, args, kw)
        call = cuda_ms(lambda: nwb.nw_batch(*args, **kw), reps)
        kern = b4_launch_ms(nwb, args, kw, reps)
        n0 = nwb.nw_batch.launches
        by_name = profile_device(f"wide body, {label}, {reps} calls",
                                 lambda: [nwb.nw_batch(*args, **kw)
                                          for _ in range(reps)])
        per_call = (nwb.nw_batch.launches - n0) // reps
        b4 = [v for n_, v in by_name.items() if is_b4_kernel(n_)]
        # this process's profiler may record fewer kernels than were
        # launched (6 of 10 at merge_whole); the device time a call is
        # taken over the whole calls it recorded
        rec = sum(v[1] for v in b4)
        dms = (sum(v[0] for v in b4) / 1e3 / (rec // per_call)
               if rec and per_call and rec % per_call == 0 else None)
        nwb.BODY = "block"
        try:
            block = b4_launch_ms(nwb, args, kw, max(1, reps // 3))
        finally:
            nwb.BODY = None
        l1, l2 = args[1].cpu().numpy(), args[3].cpu().numpy()
        bms, by, det = b4_bound(nbytes_of(args) + nbytes_of(outs),
                                pair_cells(l1, l2, -1), False)
        row = dict(shape=label, pairs=int(args[0].shape[0]), nd=fit["nd"],
                   W=fit["W"], body=fit["body"], warps=fit["warps"],
                   route=fit["route"], ms=kern, call_ms=call, device_ms=dms,
                   device_kernels_recorded=rec,
                   launches_per_call=per_call, plain_ms=plain, bound_ms=bms,
                   bound_by=by, block_body_ms=block)
        log(f"[time] kernel B4 wide body, {label} ({row['pairs']} pairs, "
            f"nd {fit['nd']}, W {fit['W']}, {fit['warps']} warps a pair, "
            f"route {fit['route']}): kernel {kern:.4f} ms (CUDA events), "
            f"device {'not measured' if dms is None else f'{dms:.4f}'} ms "
            f"(torch.profiler, {rec} of {per_call * reps} launches recorded, "
            f"{per_call} a call), call "
            f"{call:.4f} ms, plain {plain:.1f} ms, bound {bms:.4f} ms by {by}"
            f" ({det}); the one-block-per-pair body on the same batch "
            f"{block:.4f} ms; card {card}")
        return row

    timed_rows = []
    # merge_whole: one nw_batch call, as merge_pairs makes it
    fwd, rrc = merge_whole_reads()
    m1, ml1 = pack_sequences(fwd)
    m2, ml2 = pack_sequences(rrc)
    margs = on_card(m1, ml1, m2, ml2)
    reset_launches()
    nwb.nw_batch(*margs, **merge_kw)
    torch.cuda.synchronize()
    by_path["merge_whole"] = counts()["B4 wide"]
    outs, plain = held("merge_whole", margs, merge_kw)
    timed_rows.append(timed("merge_whole", margs, merge_kw, 10, outs, plain))

    # shift_v34: is_shift_denovo on 500 V3-V4 ASVs, the whole call
    unqs = shift_v34_uniques()
    reset_launches()
    t0 = time.time()
    flags = dt.is_shift_denovo(unqs, device="cuda")
    wall_v34 = time.time() - t0
    n_v34 = counts()
    by_path["shift_v34 is_shift_denovo"] = n_v34["B4 wide"]
    if n_v34["B4"] <= 0 or n_v34["B4 wide"] != n_v34["B4"]:
        fail(f"is_shift_denovo on V3-V4 ASVs launched {n_v34}, not the wide "
             "body alone")
    sub = dict(list(unqs.items())[:40])
    if not dt.is_shift_denovo(sub, device="cuda").equals(
            dt.is_shift_denovo(sub, device="cpu")):
        fail("is_shift_denovo on 40 V3-V4 ASVs: card differs from the CPU")
    codes, lens = pack_sequences(list(unqs))
    qi, pi = shift_pairs(unqs)
    chunk = on_card(codes[qi[:4096]], lens[qi[:4096]], codes[pi[:4096]],
                    lens[pi[:4096]])
    held("shift_v34 64 pairs", [x[:64] for x in chunk], shift_kw)
    outs, plain = held("shift_v34 first chunk", chunk, shift_kw)
    row = timed("shift_v34 first chunk", chunk, shift_kw, 10, outs, plain)
    row.update(call_wall_s=wall_v34, call_pairs=len(qi),
               call_launches=n_v34["B4"], flagged=int(flags.sum()))
    timed_rows.append(row)
    log(f"[wide] is_shift_denovo on {len(unqs)} V3-V4 ASVs: {len(qi)} "
        f"pairs, {wall_v34:.3f} s wall, launches {n_v34}, "
        f"{int(flags.sum())} flagged; 40 of them card == CPU")

    # shift_pb: is_shift_denovo on samPB's 64 most abundant uniques
    pb = shift_pb_uniques(dt)
    reset_launches()
    t0 = time.time()
    flags = dt.is_shift_denovo(pb, device="cuda")
    wall_pb = time.time() - t0
    n_pb = counts()
    by_path["shift_pb is_shift_denovo"] = n_pb["B4 wide"]
    if n_pb["B4"] <= 0 or n_pb["B4 wide"] != n_pb["B4"]:
        fail(f"is_shift_denovo on samPB launched {n_pb}, not the wide body "
             "alone")
    codes, lens = pack_sequences(list(pb))
    qi, pi = shift_pairs(pb)
    pargs = on_card(codes[qi], lens[qi], codes[pi], lens[pi])
    held("shift_pb 64 pairs", [x[:64] for x in pargs], shift_kw)
    outs, plain = held("shift_pb all pairs", pargs, shift_kw)
    geo = (pargs[0].shape[1], pargs[2].shape[1],
           *nwb.batch_geometry(lens[qi], lens[pi], -1), False)
    if nwb.route(*geo) != 4:
        fail("samPB's shift pairs did not take the wide body")
    row = timed("shift_pb", pargs, shift_kw, 5, outs, plain)
    row.update(call_wall_s=wall_pb, call_pairs=len(qi),
               call_launches=n_pb["B4"], flagged=int(flags.sum()))
    timed_rows.append(row)
    log(f"[wide] is_shift_denovo on samPB's {len(pb)} most abundant "
        f"uniques: {len(qi)} pairs, {wall_pb:.3f} s wall, launches {n_pb}, "
        f"{int(flags.sum())} flagged")
    top = timed_rows[0]
    return dict(launches=sum(by_path.values()), launches_by_path=by_path,
                **{k: top[k] for k in ("ms", "call_ms", "device_ms",
                                       "plain_ms", "bound_ms", "bound_by",
                                       "block_body_ms")},
                timed=timed_rows), err


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
        from dada2_tpu_torch.ops import store_screen as ss
        from dada2_tpu_torch.options import DEFAULT_OPTIONS
    except ImportError as e:
        fail(f"dada2_tpu_torch is not importable next to this script: {e}")
    # the [phases] lines and the per-phase fetch bytes are views over
    # the recorded spans
    dt.trace.enable()
    if "jax" in sys.modules or "dada2_tpu" in sys.modules:
        fail("the port imported jax or dada2_tpu")
    launches = nww.nw_wavefront.launches

    by_body = nwb.nw_batch.launches_by_body

    def reset_launches():
        for k in launches:
            launches[k] = 0
        for k in by_body:
            by_body[k] = 0
        for k in ss.launches:
            ss.launches[k] = 0
        for k in ss.launches_with:
            ss.launches_with[k] = 0
        nwb.nw_batch.launches = 0

    def counts():
        return dict(launches, B4=nwb.nw_batch.launches,
                    B5=sum(ss.launches.values()),
                    **{f"B4 {k}": v for k, v in by_body.items()},
                    **{f"B5 {k}": v for k, v in ss.launches.items()})

    # The CPU references run without speculation: it changes no result
    # (tests/test_torch_speculation.py; phase 19b on the card), and on the
    # CPU each prefetched segment costs a sweep of B1's plain version for
    # a fetch that costs nothing there. Card runs keep the default.
    backend_init = CudaBackend.__init__

    def cpu_reference_init(self, *a, **kw):
        backend_init(self, *a, **kw)
        if self.device.type == "cpu":
            self.SPEC_K = 0
    CudaBackend.__init__ = cpu_reference_init

    # seconds of each phase, printed on the [phases] line
    marks = []

    def mark(name):
        marks.append((name, time.time()))

    mark("1 device")
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

    mark("2 build")
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
        ("nw_batch.cu", nwb.build_kernel),
        ("store_screen.cu", ss.build_kernel))]
    for th in builders:
        th.start()
    for th in builders:
        th.join()
    if build_errors:
        fail(f"kernel build: {build_errors}")
    log(f"[build] nw_wavefront.cu, nw_batch.cu and store_screen.cu built "
        f"in {time.time() - t0:.1f}s; ptxas reports:")
    for name, rep in reports.items():
        for line in rep.strip().splitlines():
            log(f"[build]   {name}: {line.strip()}")
    ptxas = reports["nw_wavefront.cu"]
    entries = ptxas.count("Compiling entry function")
    if entries != 16:
        fail(f"expected 16 kernel instantiations (4 windows x B1's, B2's "
             f"class rows' and B3's kernel and B2 stats' body), ptxas "
             f"compiled {entries}")
    entries = reports["nw_batch.cu"].count("Compiling entry function")
    if entries != 21:
        fail(f"expected 21 instantiations of kernel B4 (the register body: "
             f"4 row tiers x vec, scalar and homopolymer; the wide body: the "
             f"three aligners; the one-block-per-pair body: the three "
             f"aligners x two slab routes), ptxas compiled {entries}")
    entries = reports["store_screen.cu"].count("Compiling entry function")
    if entries != 8:
        fail(f"expected 8 kernels of B5 (the cooperative budded kernel, "
             f"tiles and bits; the slot packer's follow-up, tiles and bits, "
             f"and gather mode; the small pack alone; the full mode, "
             f"screened and not), ptxas compiled {entries}")
    regs_by_mode = {m: ptxas_registers(ptxas, "nw_compare_kernel",
                                       f"Li{m}E") for m in (1, 2, 3)}
    if any(sorted(r) != [1, 2, 3, 4] for r in regs_by_mode.values()):
        fail(f"the four instantiations of B1, B2's class rows and B3 not "
             f"found in the ptxas report: {regs_by_mode}")
    log(f"[build] registers by rows per thread: B1 {regs_by_mode[1]}, B2 "
        f"class rows {regs_by_mode[2]}, B3 {regs_by_mode[3]}")

    def b1_fit(geom, nb, mode=1):
        """B1's (mode 2: B2's class rows', 3: B3's) pairs per block for a
        launch, its blocks per SM and the instantiation's registers, as
        printed on the [kernel]/[modes]/[time] lines."""
        P = nww.pairs_per_block(geom["L1R"], geom["L2R"], geom["NDP"],
                                geom["WP"], mode, nb)
        bps = nww.compare_blocks_per_sm(geom["L1R"], geom["L2R"],
                                        geom["NDP"], geom["WP"], P, mode)
        regs = regs_by_mode[mode][geom["WP"] // 32]
        return f"P={P} pairs/block, {bps} blocks/SM, {regs} registers", P

    mark("3 B1")
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

    mark("3b B2 B3")
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
    b2_ps = set()
    for blocks, wp in pair_cases:
        arrays, geom = pairs_case(rng, nww, blocks, 16, wp)
        ppb_s = nww.pairs_per_block(geom["L1R"], geom["L2R"], geom["NDP"],
                                    wp, nww.STATS_MODE)
        err, ok_tb, t, want = kernel_vs_plain(nww, dev, arrays, geom, "cls",
                                              True)
        every = every_p(nww, t, want, geom, 2)
        b2_ps.update(every)
        err = max([err] + [e for e, _ in every.values()])
        err_b["B2cls"] = max(err_b["B2cls"], err)
        err_s = stats_vs_plain(nww, t, want, geom)
        err_b["B2"] = max(err_b["B2"], err_s)
        log(f"[modes] B2 len1={[b[0] for b in blocks]} WP={wp} "
            f"NDP={geom['NDP']} L1R={geom['L1R']}, class rows "
            f"{b1_fit(geom, arrays[0].shape[0], 2)[0]}, also P="
            f"{sorted(every)} (stats {ppb_s} pairs/block): class rows max "
            f"|kernel - plain| = {err}, tracebacks complete: {ok_tb}; stats "
            f"over {len(STATS_SETTINGS)} (allow_one_off, max_shift) settings "
            f"max |kernel - plain| = {err_s}")
        if err != 0 or not ok_tb or err_s != 0:
            fail(f"kernel B2 disagrees with its plain version (WP={wp})")
    kinds_cases = cases + [(1450, 200, 30, 16, 64, False)]
    b3_ps = set()
    for len1, ncand, nops, band, wp, uniform in kinds_cases:
        arrays, geom = fuzz_case(rng, nww, len1, ncand, nops, band, wp,
                                 uniform)
        err, ok_tb, t, want = kernel_vs_plain(nww, dev, arrays, geom, True,
                                              False)
        every = every_p(nww, t, want, geom, 3)
        b3_ps.update(every)
        err = max([err] + [e for e, _ in every.values()])
        err_b["B3"] = max(err_b["B3"], err)
        log(f"[modes] B3 len1={len1} blocks={arrays[0].shape[0]} WP={wp} "
            f"NDP={geom['NDP']} {b1_fit(geom, arrays[0].shape[0], 3)[0]}, "
            f"also P={sorted(every)}: max |kernel - plain| = {err}, "
            f"tracebacks complete: {ok_tb}")
        if err != 0 or not ok_tb:
            fail(f"kernel B3 disagrees with its plain version (WP={wp})")
    # B2's class rows and B3 where tracebacks do not complete or lengths
    # are 0 and 1: a lane with len2 > len2max, 40-nt queries against
    # parents (B2) or a 40-nt center against candidates (B3) of length 0,
    # 1 and 2, and parents or candidates cut short by up to 294 nt under a
    # window of WP rows (the band needs about 170: tracebacks get stuck)
    s_cut = rng.integers(0, 4, 400).astype(np.uint8)
    cut = [s_cut[: 400 - k] for k in range(0, 300, 6)]
    q_cut = [rng.integers(0, 4, 400).astype(np.uint8) for _ in cut]
    for wp in (32, 64, 96, 128):
        fam, fgeom = pairs_case(rng, nww, [(250, 128, 8, False),
                                           (247, 100, 8, False)], 16, wp)
        fam[1][0, 0, 5] = fam[0][0, 1] + 1
        q40 = [rng.integers(0, 4, 40).astype(np.uint8) for _ in range(24)]
        short = pairs_arrays(nww, [(40, [
            (q40[0], q40[0][:0]), (q40[1], q40[1][:1]),
            (q40[2], q40[2][3:5]), (q40[3], q40[3][7:8])] + [
            (q, mutate(rng, q, 6, False)) for q in q40[4:]])], 16, wp,
            qrng=rng)
        stuck = pairs_arrays(nww, [(400, [
            (q, q[: 400 - 6 * k]) for k, q in enumerate(q_cut)])], 16, wp,
            cut=True, qrng=rng)
        for label, (arrays, geom), n_bad in (
                ("failed-geometry lane", (fam, fgeom), 1),
                ("parents of length 0, 1, 2", short, 0),
                ("window cut", stuck, -1)):
            err, _, t, want = kernel_vs_plain(nww, dev, arrays, geom, "cls",
                                              True)
            every = every_p(nww, t, want, geom, 2)
            b2_ps.update(every)
            err = max([err] + [e for e, _ in every.values()])
            err_b["B2cls"] = max(err_b["B2cls"], err)
            end = want[3][:, :2]
            bad = int(((end[:, 0] != 0) | (end[:, 1] != 0)).sum())
            log(f"[modes] B2 class rows, {label} WP={wp} blocks="
                f"{arrays[0].shape[0]} NDP={geom['NDP']}, "
                f"{b1_fit(geom, arrays[0].shape[0], 2)[0]}, also P="
                f"{sorted(every)}: max |kernel - plain| = {err}, {bad} lanes "
                f"end != (0, 0)")
            if err != 0 or (bad != n_bad if n_bad >= 0 else bad == 0):
                fail(f"kernel B2's class rows disagree with their plain "
                     f"version or the case is not what it says ({label}, "
                     f"WP={wp})")
        fam, fgeom = fuzz_case(rng, nww, 250, 300, 8, 16, wp, False)
        fam[1][0, 0, 5] = fam[0][0, 1] + 1
        s1 = rng.integers(0, 4, 40).astype(np.uint8)
        short = b3_inputs(nww, s1, [s1[:0], s1[:1], s1[3:5]] + [
            mutate(rng, s1, 6, False) for _ in range(20)], 4, wp)
        stuck = b3_inputs(nww, s_cut, cut, 16, wp)
        for label, (arrays, geom), n_bad in (
                ("failed-geometry lane", (fam, fgeom), 1),
                ("lengths 0, 1, 2", short, 0),
                ("window cut", stuck, -1)):
            err, _, t, want = kernel_vs_plain(nww, dev, arrays, geom, True,
                                              False)
            every = every_p(nww, t, want, geom, 3)
            b3_ps.update(every)
            err = max([err] + [e for e, _ in every.values()])
            err_b["B3"] = max(err_b["B3"], err)
            end = want[3][:, :2]
            bad = int(((end[:, 0] != 0) | (end[:, 1] != 0)).sum())
            log(f"[modes] B3 {label} WP={wp} blocks={arrays[0].shape[0]} "
                f"NDP={geom['NDP']}, P={sorted(every)}: max |kernel - "
                f"plain| = {err}, {bad} lanes end != (0, 0)")
            if err != 0 or (bad != n_bad if n_bad >= 0 else bad == 0):
                fail(f"kernel B3 disagrees with its plain version or the "
                     f"case is not what it says ({label}, WP={wp})")
    log(f"[modes] pairs per block covered: B2 class rows {sorted(b2_ps)}, "
        f"B3 {sorted(b3_ps)}")
    if b2_ps != {1, 2, 4, 8, 16, 32} or b3_ps != {1, 2, 4, 8, 16, 32}:
        fail("phase 3b did not run B2's class rows and B3 at every pairs "
             "per block from 1 to 32")

    mark("4 main small")
    # 4. main path, small: card against CPU, identical
    err41 = dt.data.tperr1()
    drp = dt.derep_fastq(SAM1F)
    reset_launches()
    t0 = time.time()
    res_gpu = dt.dada(drp, err=err41, device="cuda", verbose=False)
    t_gpu = time.time() - t0
    n4 = counts()
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
        f"{t_cpu:.2f}s; clustering/map/pval/birth_subs/trans identical; "
        f"kernel launches {n4}")
    if n4["B5 full"] <= 0:
        fail("sam1F dada(err=tperr1()) did not take B5's full mode")
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

    mark("5 main")
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
    n_b5 = dict(ss.launches)
    n_b5_with = dict(ss.launches_with)
    peak = torch.cuda.max_memory_allocated()
    rounds = len(res.err_in)
    log(f"[main] dada(selfConsist=True): {len(sim.uniques)} uniques, "
        f"{rounds} rounds, {len(res.denoised)} ASVs, {wall:.2f}s wall")
    log(f"[main] phases: {dt.PHASES.summary()}")
    log(f"[main] counters: {dt.COUNTERS.summary()}")
    log(f"[main] kernel launches: {dict(launches)}, B5 {n_b5} (of the "
        f"pack launches {n_b5_with['proj']} screened with a projection, "
        f"{n_b5_with['fold']} folded one); "
        f"max_memory_allocated: {peak} bytes")
    if n_b1 <= 0:
        fail("the main path never launched kernel B1")
    if n_b5["pack"] <= 0:
        fail("the main path never launched kernel B5 (no budded compare)")
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
    # what phase 16 runs again: the sample, its result and launches, the
    # timed bucket, and the ASVs it was simulated from
    p5 = dict(sim=sim, res5=res, n_b1_5=n_b1, b1_args=args, b1_geom=geom,
              err=err, asvs=(res_gpu.sequence, res_gpu.quality, np.array(
                  [res_gpu.denoised[s] for s in res_gpu.sequence], float)))
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

    mark("6 profile")
    # 6. where the main path's device time goes (fresh backend, so the
    # kernel runs again); B5 shows one kernel per counted launch
    b5_before = dict(ss.launches)
    by_name = profile_device("selfConsist run", lambda: dt.dada(
        sim, err=None, selfConsist=True, device="cuda", verbose=False))
    b5_calls = {k: ss.launches[k] - b5_before[k] for k in ss.launches}
    b5_kernels = {k: sum(c for name, (_, c) in by_name.items()
                         if f"{k}_kernel" in name)
                  for k in ("budded", "take", "small", "full")}
    # the gather mode is take_kernel<false, false> (demangled or not)
    gather = sum(c for name, (_, c) in by_name.items()
                 if re.search(r"take_kernel(<\s*(false|\(bool\)0)\s*,\s*"
                              r"(false|\(bool\)0)\s*>|ILb0ELb0E)", name))
    b5_kernels.update(take=b5_kernels["take"] - gather, gather=gather)
    log(f"[profile] B5 in that run: wrapper calls {b5_calls}, kernels "
        f"{b5_kernels} (budded = pack, take = take, small = small, full = "
        f"full, gather = take_kernel<false, false>)")
    if by_name and any(b5_kernels[k] != b5_calls[w] for k, w in (
            ("budded", "pack"), ("take", "take"), ("small", "small"),
            ("full", "full"), ("gather", "gather"))):
        fail("B5's kernels in the profile do not match its counted calls "
             "one for one")

    mark("7 chimera small")
    # 7. the chimera slice, small: card against CPU, identical
    def small_table(device):
        dereps = {"sam1": dt.derep_fastq(SAM1F),
                  "sam2": dt.derep_fastq(SAM2F)}
        dadas = dt.dada(dereps, err=err41, device=device, verbose=False)
        st = dt.make_sequence_table(dadas)
        return st, {m: dt.remove_bimera_denovo(st, method=m, device=device)
                    for m in ("consensus", "pooled", "per-sample")}, dadas

    reset_launches()
    t0 = time.time()
    st_gpu, nochim_gpu, dadas_f_gpu = small_table("cuda")
    t_gpu = time.time() - t0
    n7 = counts()
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
        + f"; card {t_gpu:.2f}s, CPU {t_cpu:.2f}s; identical; kernel "
        f"launches {n7}")

    mark("8 B3 path")
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
    g8 = dict(match=5, mismatch=-4, gap_p=-8, **ggeom)
    # B3 at three shapes: phase 8's own (its every P timed too), phase 5's
    # B1 bucket and samPB's at BAND_SIZE 32, each with kinds emitted
    b3_timed = []
    for label, a3, g3, sp in (
            ("phase 8", gargs, g8, arrays[:2]),
            ("phase 5's B1 shape", p5["b1_args"], p5["b1_geom"],
             (p5["b1_args"][0].cpu().numpy(), p5["b1_args"][1].cpu().numpy())),
            ("samPB", pb_args, pb_geom, (pb_scal, pb_params))):
        kw3 = dict(g3, emit_kinds=True)
        got = nww.nw_wavefront(*a3, **kw3)
        want = nww.nw_wavefront_ref(*a3, **kw3)
        e3 = max_abs_diff(got, want)
        nb3 = a3[0].shape[0]
        fit, P = b1_fit(g3, nb3, 3)
        ms = cuda_ms(lambda: nww.nw_wavefront(*a3, **kw3), 20)
        b3_ms, b3_by, detail = bound(a3, got, *sp)
        every = every_p(nww, a3, want, g3, 3, 20) if label == "phase 8" \
            else {}
        e3 = max([e3] + [e for e, _ in every.values()])
        err_b["B3"] = max(err_b["B3"], e3)
        row = dict(shape=label, blocks=nb3, WP=g3["WP"], NDP=g3["NDP"],
                   pairs_per_block=P, ms=ms, bound_ms=b3_ms, bound_by=b3_by,
                   ms_by_p={p: m for p, (_, m) in every.items()})
        if label == "phase 8":
            row["plain_ms"] = cuda_ms(
                lambda: nww.nw_wavefront_ref(*a3, **kw3), 2)
        b3_timed.append(row)
        log(f"[time] kernel B3 at {label} ({nb3} blocks, WP={g3['WP']}, "
            f"NDP={g3['NDP']}, L1R={g3['L1R']}, {fit}): {ms:.4f} ms"
            + (f", plain {row['plain_ms']:.2f} ms; by P " + ", ".join(
                f"{p}: {m:.4f}" for p, m in row["ms_by_p"].items())
               if every else "")
            + f"; bound {b3_ms:.4f} ms by {b3_by} ({detail}); max |kernel "
            f"- plain| = {e3}; card {card}")
        if e3 != 0:
            fail(f"kernel B3 disagrees with its plain version at {label}")
    top = b3_timed[0]
    rows["B3"] = dict(launches=n_b3, timed=b3_timed, **{k: top[k] for k in (
        "ms", "plain_ms", "bound_ms", "bound_by", "pairs_per_block")})

    mark("9 chimera table")
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
    d_pairs = chim._table_pairs(torch.from_numpy(mat).to(dev), 1.5, 2)
    pairs = d_pairs.cpu().numpy()
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
    d_b2 = chim._pairs_lr_stats(be, bopts, qi, pi, 16, False)
    t_b2 = time.time() - t0
    nflag, nsam = chim._table_votes(mat, be.lens, d_pairs, d_b2, 1.5, 2,
                                    False, 4)
    b2 = tuple(d_b2.cpu().numpy().T)
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
    nflag_c, nsam_c = chim._table_votes(mat, be.lens, pairs[sub],
                                        np.stack(stats_cpu, 1), 1.5, 2,
                                        False, 4)
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

    mark("10 B2 timing")
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
    cls_fit, cls_P = b1_fit(g2, CH, 2)
    # the class-row kernel's own bound: its outputs' bytes, the same cells
    cls_bound = bound(args, nww.nw_wavefront(*args, **ckw),
                      args[0].cpu().numpy(), args[1].cpu().numpy())
    log(f"[time] kernel B2 at one launch ({CH} blocks x 128 pairs, "
        f"WP={plan.WP}, L1R={plan.L1R} L2R={plan.L2R} NDP={plan.NDP}), in "
        f"turns: class rows + torch scans {t_route[0]:.4f} ms, stats kernel "
        f"{t_stats[0]:.4f} ms, {t_stats[1]:.4f} ms, class rows + torch "
        f"scans {t_route[1]:.4f} ms; the class-row kernel alone "
        f"{t_cls[0]:.4f} / {t_cls[1]:.4f} ms ({cls_fit}; bound "
        f"{cls_bound[0]:.4f} ms by {cls_bound[1]}: {cls_bound[2]}); stats "
        f"plain {plain_ms:.2f} ms; bound {bound_ms:.4f} ms by {bound_by} "
        f"({detail}); max |kernel - plain| = {err_b['B2']} (stats), "
        f"{err_b['B2cls']} (class rows); card {card}")
    if err_b["B2"] != 0 or err_b["B2cls"] != 0:
        fail("kernel B2 disagrees with its plain version on the table's "
             "inputs")
    rows["B2"].update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                      bound_by=bound_by)
    # the class-row mode: no route launches it (launches 0), timed here
    rows["B2cls"] = dict(launches=0, ms=t_cls[0], plain_ms=cls_plain_ms,
                         bound_ms=cls_bound[0], bound_by=cls_bound[1],
                         pairs_per_block=cls_P,
                         with_torch_scans_ms=t_route[0])
    del args, be

    mark("11 table profile")
    # 11. where the table run's device time goes; the route must launch
    # the stats kernel only: no class rows, no torch scans over them
    by_name = profile_device("is_bimera_denovo_table run", lambda:
                             dt.is_bimera_denovo_table(st, device="cuda"))
    if by_name:
        names = list(by_name)
        scans = [n for n in names
                 if "tensor_kernel_scan_innermost_dim" in n]
        cls_k = [n for n in names
                 if re.search(r"nw_compare_kernel<\d+, 2>", n)]
        stats_k = [n for n in names
                   if re.search(r"nw_wavefront_kernel<\d+>", n)]
        log(f"[profile] table run: stats kernel {stats_k}, class-row "
            f"kernel {cls_k}, scan kernels {scans}")
        if scans or cls_k or not stats_k:
            fail("the table run launched a class-row or scan kernel, or "
                 "not the stats kernel")

    mark("12 B4")
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
    # windows on both sides of each register tier and of the register
    # body's 256-row limit, pairs of length 0 and 1, and launches of 1,
    # P - 1, P and P + 1 pairs at a set pairs per block, and one large
    # launch whose last block is partial at the fit's own P
    for W in (32, 33, 64, 65, 128, 129, 256, 257, 288, 512, 513):
        b4_cases.append((f"window {W}, merge scoring",
                         b4_window_pairs(rng, W, 60), merge64))
    for W in (33, 129, 257):
        b4_cases.append((f"window {W}, vec, end gaps -8",
                         b4_window_pairs(rng, W, 40),
                         dict(sc5, band=-1, end_gap_p=-8)))
    for W in (65, 256, 301):
        b4_cases.append((f"window {W}, homopolymer -1",
                         b4_window_pairs(rng, W, 40),
                         dict(sc5, band=-1, mode="scalar", homo_gap_p=-1)))
    # the wide body at band 140 (windows over 256 rows where the lengths
    # differ by 300), and a batch of mixed windows, wide and narrow
    far = [(a, b[: len(b) // 2]) for a, b in b4_pairs(rng, 30, 600, 10)]
    b4_cases += [
        ("band 140 over 256 rows, vec", far, dict(sc5, band=140)),
        ("band 140 over 256 rows, scalar homopolymer -1", far,
         dict(sc5, band=140, mode="scalar", homo_gap_p=-1)),
        ("mixed windows, wide and narrow",
         b4_pairs(rng, 20, 460, 12, lo=20) + b4_short_pairs(), merge64)]
    short = b4_short_pairs() + b4_pairs(rng, 6, 40, 4, lo=2)
    b4_cases += [
        ("short pairs, vec band 4", short, dict(sc5, band=4)),
        ("short pairs, vec unbanded, end gaps -8", short,
         dict(sc5, band=-1, end_gap_p=-8)),
        ("short pairs, scalar band 4, homopolymer -1", short,
         dict(sc5, band=4, mode="scalar", homo_gap_p=-1)),
        ("short pairs, scalar unbanded", short, merge64)]
    homo_pairs = b4_pairs(rng, 5, 250, 12, homo=True)
    for n in (1, 3, 4, 5):
        b4_cases.append((f"{n} pair(s) at 4 pairs per block, homopolymer "
                         f"band 32", homo_pairs[:n],
                         dict(sc5, band=32, mode="scalar", homo_gap_p=-1,
                              pairs_per_block=4)))
        b4_cases.append((f"{n} pair(s) at 4 pairs per block, merge "
                         f"scoring", merge_like[:n],
                         dict(merge64, pairs_per_block=4)))
    b4_cases.append(("4,097 pairs, scalar band 16 (the fit's P)",
                     b4_pairs(rng, 4097, 250, 8), dict(sc5, band=16,
                                                       mode="scalar")))
    err_b["B4"] = 0
    for label, pairs, kw in b4_cases:
        kw = dict(kw)
        one_per_launch = kw.pop("one_pair_per_launch", False)
        ppb = kw.pop("pairs_per_block", None)
        args = b4_tensors(pairs, dev)
        want = nwb.nw_batch_ref(*args, **kw)
        budget = nwb.MAX_BYTES
        said = []
        for body in (None, "block"):
            reset_launches()
            nwb.MAX_BYTES = 1 if one_per_launch else budget
            nwb.BODY, nwb.PAIRS_PER_BLOCK = body, ppb
            try:
                fit = b4_fit(nwb, args, kw)
                got = nwb.nw_batch(*args, **kw)
                torch.cuda.synchronize()
            finally:
                nwb.MAX_BYTES = budget
                nwb.BODY = nwb.PAIRS_PER_BLOCK = None
            nl = counts()
            err = max_abs_diff(got, want)
            err_b["B4"] = max(err_b["B4"], err)
            said.append(f"{fit['body']} body (RPT {fit['rpt']}, P "
                        f"{fit['P']}, warps {fit['warps']}): {nl['B4']} "
                        f"launch(es), register {nl['B4 register']}, wide "
                        f"{nl['B4 wide']}, block {nl['B4 block']}, "
                        f"max |kernel - plain| = {err}")
            if err != 0 or not bool(got[5].all()):
                fail(f"kernel B4's {fit['body']} body disagrees with its "
                     f"plain version ({label})")
            if nl["B4 " + fit["body"]] != nl["B4"]:
                fail(f"{label}: the launches went to another body than "
                     f"{fit['body']}")
            want_body = ("register" if fit["W"] <= 256 else
                         "wide" if fit["W"] <= 2048 else "block")
            if body is None and fit["body"] != want_body:
                fail(f"{label}: a window of {fit['W']} rows took the "
                     f"{fit['body']} body")
            if one_per_launch and nl["B4"] != len(pairs):
                fail(f"the chunked B4 call made {nl['B4']} launches for "
                     f"{len(pairs)} pairs")
        geo = (args[0].shape[1], args[2].shape[1], fit["nd"], fit["W"],
               kw.get("homo_gap_p") is not None)
        if "slab" in label and (nwb.route(*geo) != 4
                                or nwb.block_route(*geo) != 2):
            fail("the unbanded samPB pairs did not take the wide and the "
                 "one-block-per-pair bodies' device-memory slabs")
        log(f"[batch] {label}: {len(pairs)} pairs, L1={args[0].shape[1]} "
            f"L2={args[2].shape[1]} nd={fit['nd']} W={fit['W']}; "
            + "; ".join(said) + " (over kinds, p0, p1, ham, tvec, ok)")

    mark("13 paired")
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
    if n_paired["B4"] <= 0 or n_paired["B4 register"] != n_paired["B4"]:
        fail("the paired slice never launched kernel B4, or launched "
             "another body than its register body")

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
    if (n_h["B4"] <= 0 or n_h["B1"] != 0
            or n_h["B4 register"] != n_h["B4"]):
        fail("the homopolymer configuration must launch B4's register "
             "body and not B1")
    # unbanded on sam1F's 250 most abundant uniques, as
    # tests/test_torch_backend.py::test_unserved_configs_raise runs it:
    # the CPU's unbanded plain B4 took 36-70 s on all 896
    def top250():
        d = dt.derep_fastq(SAM1F)
        return type(d)(uniques=dict(list(d.uniques.items())[:250]),
                       quals=d.quals[:250], map=np.arange(250), name="top")

    reset_launches()
    drp_u = top250()
    t0 = time.time()
    res_u = dt.dada(drp_u, err=err41, device="cuda", verbose=False,
                    BAND_SIZE=-1)
    t_gpu = time.time() - t0
    n_u = counts()
    t0 = time.time()
    res_uc = dt.dada(top250(), err=err41, device="cpu", verbose=False,
                     BAND_SIZE=-1)
    t_cpu = time.time() - t0
    try:
        same_result(res_u, res_uc, "sam1F BAND_SIZE=-1")
    except AssertionError as e:
        fail(f"dada(BAND_SIZE=-1) on the card differs from the CPU: {e}")
    log(f"[misfit] sam1F BAND_SIZE=-1: {len(res_u.denoised)} ASVs from "
        f"{len(drp_u.uniques)} uniques; card {t_gpu:.2f}s, CPU "
        f"{t_cpu:.2f}s; identical; card launches {n_u}")
    if (n_u["B4"] <= 0 or n_u["B1"] != 0
            or n_u["B4 register"] != n_u["B4"]):
        fail("dada(BAND_SIZE=-1) must launch B4's register body and not "
             "B1")

    mark("14 B4 size")
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
    if n14["B4"] <= 0 or n14["B4 register"] != n14["B4"]:
        fail("the homopolymer selfConsist run never launched kernel B4's "
             "register body, or launched another body")
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
    b4_dev = [v for n_, v in by_name.items() if is_b4_kernel(n_)]
    b4_dev_ms = sum(v[0] for v in b4_dev) / 1e3 if b4_dev else None
    b4_dev_n = sum(v[1] for v in b4_dev)
    log(f"[B4 size] dada(selfConsist=True, HOMOPOLYMER_GAP_PENALTY=-1, "
        f"BAND_SIZE=32) on phase 5's sample: {len(sim.uniques)} uniques, "
        f"{len(res14.err_in)} rounds, {len(res14.denoised)} ASVs, "
        f"{wall14:.2f}s wall; launches {n14}; B4 device time "
        f"{'not measured' if b4_dev_ms is None else round(b4_dev_ms, 4)} ms "
        f"over the {b4_dev_n} B4 kernels the profiled rerun recorded; B4 "
        f"bound over the run's {len(b4_calls)} calls "
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

    def both_bodies(args, kw, reps):
        """Both bodies of kernel B4 on one call, each held bitwise against
        the plain version: the route's body and the one-block-per-pair
        body in turns (route, block, route, block), each with its fit, the
        call's time (CUDA events around nw_batch) and its kernel's time
        (CUDA events around its launches alone)."""
        want = nwb.nw_batch_ref(*args, **kw)
        res = {}
        for body in (None, "block", None, "block"):
            nwb.BODY = body
            try:
                fit = b4_fit(nwb, args, kw)
                got = nwb.nw_batch(*args, **kw)
                err = max_abs_diff(got, want)
                ms = cuda_ms(lambda: nwb.nw_batch(*args, **kw), reps)
                kms = b4_launch_ms(nwb, args, kw, reps)
            finally:
                nwb.BODY = None
            err_b["B4"] = max(err_b["B4"], err)
            if err != 0 or not bool(got[5].all()):
                fail(f"kernel B4's {fit['body']} body disagrees with its "
                     f"plain version at a timed shape")
            r = res.setdefault(fit["body"], dict(fit, ms=[], kernel_ms=[]))
            r["ms"].append(ms)
            r["kernel_ms"].append(kms)
        return want, res

    def said(res):
        return "; ".join(
            f"{b} body (RPT {r['rpt']}, P {r['P']}): call "
            f"{' / '.join(f'{x:.4f}' for x in r['ms'])} ms, kernel "
            f"{' / '.join(f'{x:.4f}' for x in r['kernel_ms'])} ms"
            for b, r in res.items())

    outs, res_m = both_bodies(margs, merge64, 10)
    call_m = res_m["register"]["ms"][0]
    kernel_m = res_m["register"]["kernel_ms"][0]
    plain_m = cuda_ms(lambda: nwb.nw_batch_ref(*margs, **merge64), 1)
    bound_m, by_m, det_m = b4_bound(nbytes_of(margs) + nbytes_of(outs),
                                    pair_cells(l1, l2, -1), False)
    nd, W = nwb.batch_geometry(l1, l2, -1)
    log(f"[time] kernel B4 at merge shapes (4096 pairs, 240 x 200 nt, "
        f"unbanded, scoring (1, -64, -64), nd={nd} W={W}): {said(res_m)}; "
        f"plain {plain_m:.2f} ms; bound {bound_m:.4f} ms by {by_m} "
        f"({det_m}); both bodies equal to the plain version; card {card}")
    if res_m["register"]["W"] > 256:
        fail("the merge shapes did not take the register body")

    # (c) is_shift_denovo on the table's first 500 ASVs (124,750 pairs)
    unqs = {s: 1000 - k for k, s in enumerate(seqs[:500])}
    reset_launches()
    t0 = time.time()
    shifts = dt.is_shift_denovo(unqs, device="cuda")
    wall_s = time.time() - t0
    n_s = counts()
    by_name = profile_device("is_shift_denovo", lambda: dt.is_shift_denovo(
        unqs, device="cuda"))
    b4_dev = [v for n_, v in by_name.items() if is_b4_kernel(n_)]
    shift_dev_ms = sum(v[0] for v in b4_dev) / 1e3 if b4_dev else None
    shift_dev_n = sum(v[1] for v in b4_dev)
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
    _, res_s = both_bodies(chunk, skw, 5)
    plain_chunk = cuda_ms(lambda: nwb.nw_batch_ref(*chunk, **skw), 1)
    log(f"[B4 size] is_shift_denovo on {len(unqs)} ASVs ({npairs} unbanded "
        f"pairs): {wall_s:.2f}s wall, launches {n_s}, "
        f"{int(shifts.sum())} flagged; B4 device time "
        f"{'not measured' if shift_dev_ms is None else round(shift_dev_ms, 4)}"
        f" ms over the {shift_dev_n} B4 kernels the profiled rerun recorded; "
        f"bound {bound_s:.4f} ms by {by_s} ({det_s}); "
        f"one 4096-pair chunk: {said(res_s)}; plain {plain_chunk:.2f} ms; "
        f"both bodies equal to the plain version; card {card}")
    if n_s["B4"] <= 0 or n_s["B4 register"] != n_s["B4"]:
        fail("is_shift_denovo did not run through kernel B4's register "
             "body")
    timed = [dict(shape=shape, **{k: r[k] for k in ("body", "rpt", "P",
                                                    "ms", "kernel_ms")})
             for shape, res in (("merge shapes", res_m),
                                ("is_shift_denovo chunk", res_s))
             for r in res.values()]
    rows["B4"] = dict(launches=n14["B4"],
                      launches_by_body={k[3:]: v for k, v in n14.items()
                                        if k.startswith("B4 ")},
                      ms=kernel_m, call_ms=call_m, plain_ms=plain_m,
                      bound_ms=bound_m, bound_by=by_m, timed=timed,
                      dada_run_b4_device_ms=b4_dev_ms,
                      dada_run_b4_kernels_recorded=b4_dev_n,
                      dada_run_bound_ms=bound14,
                      shift_b4_device_ms=shift_dev_ms,
                      shift_b4_kernels_recorded=shift_dev_n,
                      shift_bound_ms=bound_s)

    mark("15 workflow")
    stages = workflow_ends(dt, dev, card, reset_launches, counts)
    mark("16 dist")
    launches16 = distributed_phase(dt, dev, card, reset_launches, counts,
                                   **p5)
    for k in ("B1", "B4"):
        rows[k]["launches_phase16"] = launches16[k]
    mark("17 shortlist")
    rows["B5"], p17 = shortlist_phase(dt, dev, card, p5["sim"], p5["res5"],
                                      n_b5)
    err_b["B5"] = rows["B5"].pop("max_abs_err")
    mark("18 full")
    full = full_phase(dt, dev, card, p5, p17["stats"])
    err_full = full.pop("max_abs_err")
    stages += full["stages"]
    mark("19 spec")
    spec = spec_phase(dt, dev, card, p5, p17, full["spec18"])
    err_b["B5"] = max(err_b["B5"], spec.pop("max_abs_err"))
    rows["B5"]["projection"] = dict(
        launches_with_proj=n_b5_with["proj"],
        launches_with_fold=n_b5_with["fold"], **spec)
    mark("20 wide")
    rows["B4wide"], err_b["B4wide"] = wide_phase(dt, nwb, dev, card,
                                                 reset_launches, counts)
    mark("end")

    # the slot packer (the follow-up and the gather mode): phase 5's
    # launches, 17c's follow-ups (the largest M the headline) and 18e's
    # gathers and samPB's follow-up
    packer = p17["packer"]
    ptimed = packer["timed"] + [t for t in full["timed"]
                                if t["mode"] != "full_pack"]
    top = packer["timed"][-1]
    rows["B5take"] = dict(packer, **{k: top[k] for k in (
        "ms", "device_ms", "plain_ms", "bound_ms", "bound_by")},
        launch_floor_ms=top["launch_floor_ms"], timed=ptimed)
    err_b["B5take"] = max(err_b["B5"], err_full)
    if packer["launches_by_wrapper"]["take"] <= 0:
        fail("the main path never launched the slot packer's follow-up")
    # the full mode: launches in 18b's selfConsist runs, each counted from
    # zero around its own run, timed at sam1F's init, phase 5's screened
    # shape (the headline) and samPB's
    ft = [t for t in full["timed"] if t["mode"] == "full_pack"]
    top = next(t for t in ft if t["shape"] == "phase 5 screened")
    rows["B5full"] = dict(
        launches=sum(full["full_by_path"].values()),
        launches_by_path=full["full_by_path"],
        **{k: top[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                               "bound_by", "launch_floor_ms")}, timed=ft)
    err_b["B5full"] = err_full

    wave = ("dada2_tpu_torch/csrc/nw_wavefront.cu",
            "dada2_tpu/ops/nw_pallas.py:452")
    b5src = "dada2_tpu_torch/csrc/store_screen.cu"
    kernels = {
        "B1": ("nw_wavefront compare (B1)",) + wave,
        "B2": ("nw_wavefront pairs stats (B2)",) + wave,
        "B2cls": ("nw_wavefront pairs class rows (B2)",) + wave,
        "B3": ("nw_wavefront kinds (B3)",) + wave,
        "B4": ("nw_batch (B4)", "dada2_tpu_torch/csrc/nw_batch.cu",
               "dada2_tpu/ops/nw_batch.py:63"),
        "B4wide": ("nw_batch wide body (B4, windows of 257 to 2,048 rows)",
                   "dada2_tpu_torch/csrc/nw_batch.cu",
                   "dada2_tpu/ops/nw_batch.py:63"),
        "B5": ("store_screen budded pack and small pack (B5)", b5src,
               "dada2_tpu/core/backend_tpu.py:520"),
        "B5take": ("store_screen slot packer: take and gather (B5)", b5src,
                   "dada2_tpu/core/backend_tpu.py:640"),
        "B5full": ("store_screen full mode (B5)", b5src,
                   "dada2_tpu/core/backend_tpu.py:578")}
    log(json.dumps({"device_stages": stages}))
    log(json.dumps({"kernels": [dict(
        name=name, route="cuda", source=src, replaces=rep,
        max_abs_err=err_b[k], match=err_b[k] == 0, library_ms=None,
        **rows[k]) for k, (name, src, rep) in kernels.items()]}))
    log("[phases] " + json.dumps(
        {a: round(t1 - t0, 1) for (a, t0), (_, t1) in zip(marks, marks[1:])}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dist-child"]:
        dist_child(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    elif sys.argv[1:2] == ["--b5-device-time"]:
        b5_device_child(sys.argv[2])
    elif sys.argv[1:2] == ["--b5-call-device-time"]:
        b5_call_device_child(sys.argv[2])
    else:
        main()
