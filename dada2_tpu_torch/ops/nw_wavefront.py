"""Wavefront banded ends-free Needleman-Wunsch (kernels B1, B2, B3).

`nw_wavefront` keeps the interface of the TPU kernel it replaces
(dada2_tpu/ops/nw_pallas.py::_pallas_call with end_gap_p=0): the same
scal/params/s1/s2q in and the same list of arrays out, so the two compare
array for array. It serves the TPU kernel's three modes:

  B1 compare  emit_kinds=False, s1_per_block=False  (the dada() sweep)
  B2 pairs    emit_kinds="cls", s1_per_block=True   (its class rows)
  B3 kinds    emit_kinds=True,  s1_per_block=False  (nw_wavefront_grouped)

`nw_pairs_stats` is the chimera route's B2: the same alignments as B2
pairs, with the lr/ham statistics that `_lr_accum_pairs` derives from the
class rows computed inside the kernel (one row of six int32 per pair).

On CUDA tensors they launch the hand-written Hopper kernels in
csrc/nw_wavefront.cu (one source: B1, B2 and B3 are the three variants of
nw_compare_kernel, which holds up to 32 pairs per block and traces them
back one lane per pair; B2 stats is nw_wavefront_kernel; built with nvcc
at first use, loaded through ctypes); on CPU tensors they run
`nw_wavefront_ref` / `nw_pairs_stats_ref`, the plain PyTorch versions of
the same recurrences. There is no fallback between the two. `nw_compare`
is the B1 call.

Semantics are those of ops/nw_ref.py mode="vec" (reference:
src/nwalign_vectorized.cpp:71-318): tie precedence up >= left > diag, band
widened on the long side, ends-free last-row/last-column recalculation
activating one diagonal late. The window origin
o(d) = max(0, d - len2max, ceil((d - rbmax) / 2)) and the window width WP
are the TPU kernel's, so both see exactly the same cells.

The host helpers block_window / assemble_blocks / pack_s2_blocks are
copies of the TPU package's (they fix the block layout both kernels read).
"""
from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import threading
from typing import Optional

import numpy as np
import torch

from .. import trace

NEG = -(2**29)
LANES = 128
WP_MAX = 128    # widest window (rows) the kernel serves, in steps of 32

# (emit_kinds, s1_per_block) -> (name, the C entry's mode number)
MODES = {(False, False): ("B1", 1), ("cls", True): ("B2", 2),
         (True, False): ("B3", 3)}
STATS_MODE = 4  # B2 stats (nw_pairs_stats); its launches count as "B2"
# Checks' override, None in use: the pairs per block of every B1, B2 and
# B3 launch (a power of two up to 32 that fits one block; the launch raises
# otherwise) instead of pairs_per_block's choice.
PAIRS_PER_BLOCK: Optional[int] = None

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "nw_wavefront.cu")
_BUILD_DIR = os.path.join(_PKG, "build")
_SO = os.path.join(_BUILD_DIR, "libnw_wavefront.so")
_PTXAS_LOG = os.path.join(_BUILD_DIR, "nw_wavefront.ptxas.txt")
_lock = threading.Lock()
_build_locks = {_SO: threading.Lock()}
_lib: Optional[ctypes.CDLL] = None


# ---- build and load ------------------------------------------------------

def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def build_library(src: str, so: str, log: str) -> str:
    """Compile one CUDA source for sm_90a into a shared library under
    build/ (if the library is missing or older than its source) and return
    the compiler's `-Xptxas -v` report (registers, shared memory, spills
    of every instantiation). Each library has its own lock, so two
    libraries build in parallel from two threads."""
    with _lock:
        lock = _build_locks.setdefault(so, threading.Lock())
    name = os.path.splitext(os.path.basename(src))[0]
    with lock, trace.PHASES(f"build.{name}"):
        fresh = (os.path.exists(so) and os.path.exists(log)
                 and os.path.getmtime(so) >= os.path.getmtime(src))
        trace.attrs(built=not fresh)
        if not fresh:
            os.makedirs(os.path.dirname(so), exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                   "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                   "-Xptxas", "-v", "-o", tmp, src]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
            with open(log, "w") as fh:
                fh.write(proc.stdout + proc.stderr)
            os.replace(tmp, so)
        with open(log) as fh:
            return fh.read()


def build_kernel() -> str:
    """Build csrc/nw_wavefront.cu (window widths 32..128 x B1, B2, B3 and
    B2 stats) and return its `-Xptxas -v` report."""
    return build_library(_SRC, _SO, _PTXAS_LOG)


def _load():
    global _lib
    if _lib is not None:
        return _lib
    build_kernel()
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(_SO)
            V, I = ctypes.c_void_p, ctypes.c_int
            lib.nw_wavefront_run.restype = I
            lib.nw_wavefront_run.argtypes = [V] * 8 + [I] * 10 + [V]
            lib.nw_pairs_stats_run.restype = I
            lib.nw_pairs_stats_run.argtypes = [V] * 5 + [I] * 10 + [V]
            lib.nw_wavefront_pairs_per_block.restype = I
            lib.nw_wavefront_pairs_per_block.argtypes = [I] * 6
            lib.nw_compare_blocks_per_sm.restype = I
            lib.nw_compare_blocks_per_sm.argtypes = [I] * 6
            _lib = lib
    return _lib


def pairs_per_block(L1R: int, L2R: int, NDP: int, WP: int,
                    mode: int = 1, nb: int = 1) -> int:
    """Pairs (warps) one block of the kernel holds at this geometry in a
    mode (1 B1, 2 B2, 3 B3, STATS_MODE) for a launch of nb blocks of 128
    lanes, 0 if the window does not fit one block's shared memory. B1's,
    B2's and B3's choices depend on nb and on the card (a launch too small
    to give every SM two blocks gets fewer pairs per block). The
    shared-memory layout and the fit live in csrc/nw_wavefront.cu; this
    asks the built library (so it needs nvcc, and for B1, B2 and B3 the
    current CUDA device), once per geometry, launch size and device: their
    answer takes a few dozen CUDA runtime calls, as long as a small launch
    itself."""
    return _pairs_per_block(torch.cuda.current_device(), L1R, L2R, NDP, WP,
                            mode, nb)


@functools.lru_cache(maxsize=1024)
def _pairs_per_block(device: int, L1R: int, L2R: int, NDP: int, WP: int,
                     mode: int, nb: int) -> int:
    return int(_load().nw_wavefront_pairs_per_block(L1R, L2R, NDP, WP,
                                                    mode, nb))


def compare_blocks_per_sm(L1R: int, L2R: int, NDP: int, WP: int,
                          P: int, mode: int = 1) -> int:
    """Blocks of kernel B1 (mode 1), B2's class rows (mode 2) or B3 (mode
    3) holding P pairs each that one SM of the current CUDA device keeps
    resident at this geometry (the CUDA occupancy calculator, for that
    mode's instantiation and layout), 0 if such a block cannot run. For
    reports; the choice of P is pairs_per_block's."""
    return int(_load().nw_compare_blocks_per_sm(L1R, L2R, NDP, WP, P,
                                                mode))


# ---- the wrapper ---------------------------------------------------------

def _check(scal, params, s1, s2q, L1R, L2R, WP, s1_per_block):
    nb = s2q.shape[0] if s2q.dim() == 3 else -1
    s1_shape = (nb, L1R, LANES) if s1_per_block else (L1R, LANES)
    want = {"scal": (scal, (nb, 4)), "params": (params, (nb, 8, LANES)),
            "s1": (s1, s1_shape), "s2q": (s2q, (nb, L2R, LANES))}
    for name, (x, shape) in want.items():
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                             f"expected {shape}")
        if x.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.device != s2q.device:
            raise ValueError(f"{name} is on {x.device}, s2q on {s2q.device}")
    if WP < 32 or WP > WP_MAX or WP % 32:
        raise ValueError(f"WP={WP}: the kernel serves multiples of 32 "
                         f"up to {WP_MAX}")


def nw_wavefront(scal, params, s1, s2q, *, L1R: int, L2R: int, NDP: int,
                 WP: int, match: int, mismatch: int, gap_p: int,
                 emit_kinds=False, s1_per_block: bool = False):
    """The wavefront kernel in one of its three modes (see the module
    docstring): align nb blocks of 128 pairs, s1 against s2q (B1 reads
    one column of s1 per block: its caller gives one center in every
    lane, as the TPU kernel's B1 caller does). Returns
    [kinds [nb, NDP, 128] unless B1,] sub [nb, L2R, 128], mapq
    [nb, L1R, 128], end [nb, 8, 128], all int32, in the TPU kernel's
    layouts (see csrc/nw_wavefront.cu). Ends-free (end_gap_p = 0)
    requires gap_p < 0.

    CUDA tensors launch the kernel on the current stream and count one
    launch in nw_wavefront.launches[mode]; CPU tensors run
    nw_wavefront_ref."""
    mode = MODES.get((emit_kinds, bool(s1_per_block)))
    if mode is None:
        raise ValueError(f"emit_kinds={emit_kinds!r}, s1_per_block="
                         f"{s1_per_block} is none of the kernel's modes "
                         f"{sorted(MODES, key=str)}")
    _check(scal, params, s1, s2q, L1R, L2R, WP, s1_per_block)
    if gap_p >= 0:
        raise ValueError("the kernel is ends-free: gap_p must be < 0")
    geom = dict(L1R=L1R, L2R=L2R, NDP=NDP, WP=WP, match=match,
                mismatch=mismatch, gap_p=gap_p, emit_kinds=emit_kinds,
                s1_per_block=s1_per_block)
    dev = s2q.device
    if dev.type == "cpu":
        return nw_wavefront_ref(scal, params, s1, s2q, **geom)
    if dev.type != "cuda":
        raise ValueError(f"nw_wavefront runs on cuda or cpu, not {dev}")
    # the fit query, its cache key and the launch follow the runtime's
    # current device: make it the tensors' own
    with torch.cuda.device(dev):
        nb = s2q.shape[0]
        ppb = pairs_per_block(L1R, L2R, NDP, WP, mode[1], nb)
        if ppb and PAIRS_PER_BLOCK is not None:
            ppb = PAIRS_PER_BLOCK
        if ppb == 0:
            raise NotImplementedError(
                f"window WP={WP}, NDP={NDP} exceeds one block's shared memory "
                "(such windows take the batch aligner, ops/nw_batch.py)")
        outs = [torch.empty((nb, rows, LANES), dtype=torch.int32, device=dev)
                for rows in (L2R, L1R, 8)]
        if emit_kinds:
            outs.insert(0, torch.empty((nb, NDP, LANES), dtype=torch.int32,
                                       device=dev))
        if nb == 0:
            return outs
        kinds_ptr = outs[0].data_ptr() if emit_kinds else None
        sub, mapq, end = outs[-3:]
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _load().nw_wavefront_run(
            scal.data_ptr(), params.data_ptr(), s1.data_ptr(), s2q.data_ptr(),
            kinds_ptr, sub.data_ptr(), mapq.data_ptr(), end.data_ptr(), nb,
            L1R, L2R, NDP, WP, mode[1], int(match), int(mismatch), int(gap_p),
            ppb, stream)
        if rc != 0:
            raise RuntimeError(f"nw_wavefront kernel {mode[0]} launch failed: "
                               f"CUDA error {rc}")
        with _count_lock:   # multi-sample dada() launches from worker threads
            nw_wavefront.launches[mode[0]] += 1
        return outs


nw_wavefront.launches = {name: 0 for name, _ in MODES.values()}
_count_lock = threading.Lock()


def nw_pairs_stats(scal, params, s1, s2q, *, L1R: int, L2R: int, NDP: int,
                   WP: int, match: int, mismatch: int, gap_p: int,
                   allow_one_off: bool, max_shift: int):
    """Kernel B2 for the chimera route: align nb blocks of 128 pairs (s1
    per block and lane, [nb, L1R, 128], as B2 pairs takes it) and return
    their lr/ham statistics, stats [nb * 128, 6] int32 in row order
    block * 128 + lane: left, right, left_oo, right_oo, ham (the five of
    `_lr_accum_pairs`) and end0 | end1 (0 iff the traceback completed).

    CUDA tensors launch the kernel's B2 stats mode on the current stream
    and count one launch in nw_wavefront.launches["B2"]; CPU tensors run
    nw_pairs_stats_ref."""
    _check(scal, params, s1, s2q, L1R, L2R, WP, True)
    if gap_p >= 0:
        raise ValueError("the kernel is ends-free: gap_p must be < 0")
    if not isinstance(allow_one_off, (bool, np.bool_)):
        raise ValueError(f"allow_one_off must be a bool, got "
                         f"{allow_one_off!r}")
    geom = dict(L1R=L1R, L2R=L2R, NDP=NDP, WP=WP, match=match,
                mismatch=mismatch, gap_p=gap_p)
    dev = s2q.device
    if dev.type == "cpu":
        return nw_pairs_stats_ref(scal, params, s1, s2q, **geom,
                                  allow_one_off=allow_one_off,
                                  max_shift=max_shift)
    if dev.type != "cuda":
        raise ValueError(f"nw_pairs_stats runs on cuda or cpu, not {dev}")
    with torch.cuda.device(dev):
        if pairs_per_block(L1R, L2R, NDP, WP, STATS_MODE) == 0:
            raise NotImplementedError(
                f"window WP={WP}, NDP={NDP} exceeds one block's shared memory "
                "(such windows take the batch aligner, ops/nw_batch.py)")
        nb = s2q.shape[0]
        stats = torch.empty((nb * LANES, 6), dtype=torch.int32, device=dev)
        if nb == 0:
            return stats
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _load().nw_pairs_stats_run(
            scal.data_ptr(), params.data_ptr(), s1.data_ptr(), s2q.data_ptr(),
            stats.data_ptr(), nb, L1R, L2R, NDP, WP, int(match), int(mismatch),
            int(gap_p), int(bool(allow_one_off)), int(max_shift), stream)
        if rc != 0:
            raise RuntimeError(f"nw_pairs_stats kernel B2 launch failed: CUDA "
                               f"error {rc}")
        with _count_lock:
            nw_wavefront.launches["B2"] += 1
        return stats


def nw_compare(scal, params, s1t, s2q, *, L1R: int, L2R: int, NDP: int,
               WP: int, match: int, mismatch: int, gap_p: int):
    """Kernel B1: align one center (s1t [L1R, 128], the same column in
    every lane, as the compare sweep builds it: the kernel stages one
    column per block) against nb blocks of 128 candidates (s2q). Returns
    (sub, mapq, end)."""
    return tuple(nw_wavefront(scal, params, s1t, s2q, L1R=L1R, L2R=L2R,
                              NDP=NDP, WP=WP, match=match,
                              mismatch=mismatch, gap_p=gap_p))


# ---- the plain PyTorch version -------------------------------------------

def nw_wavefront_ref(scal, params, s1, s2q, *, L1R: int, L2R: int, NDP: int,
                     WP: int, match: int, mismatch: int, gap_p: int,
                     emit_kinds=False, s1_per_block: bool = False):
    """Plain PyTorch version of the kernel in all three modes, batched over
    every pair (lane) and window row: one vectorized step per
    anti-diagonal for the fill, one per diagonal for the traceback. Same
    inputs, outputs and semantics as the kernel (including its geometry
    guard)."""
    dev = s2q.device
    nb = s2q.shape[0]
    P = nb * LANES
    i64 = torch.int64
    pid = torch.arange(P, device=dev)
    blk = pid // LANES
    lane = pid % LANES
    scal = scal.to(i64)
    params = params.to(i64)
    len1 = scal[blk, 0]
    C = scal[blk, 1]
    rbmax = scal[blk, 2]
    l2 = params[blk, 0, lane]
    lb = params[blk, 1, lane]
    rb = params[blk, 2, lane]
    if s1_per_block:
        s1c = s1.to(i64).permute(0, 2, 1).reshape(P, L1R)     # [P, L1R]
    else:
        s1c = s1.to(i64).t()[lane]
    s2c = s2q.to(i64).permute(0, 2, 1).reshape(P, L2R)        # [P, L2R]
    fail = ((len1 < 0) | (l2 < 0) | (l2 > C) | (C > L2R) | (len1 >= L1R)
            | (len1 + C >= NDP))
    nd = torch.where(fail, torch.zeros_like(len1), len1 + l2)
    ndmax = int(nd.max()) if P else 0

    def origin(d):
        return torch.clamp_min(torch.maximum(d - C, (d - rbmax + 1) >> 1),
                               0)

    r = torch.arange(WP, device=dev)[None, :]
    negcol = torch.full((P, 1), NEG, dtype=i64, device=dev)
    P1 = torch.full((P, WP), NEG, dtype=i64, device=dev)
    P1[:, 0] = 0
    P2 = torch.full((P, WP), NEG, dtype=i64, device=dev)
    slab = torch.zeros((ndmax + 1, P, WP), dtype=torch.int8, device=dev)
    om1 = torch.zeros(P, dtype=i64, device=dev)
    om2 = torch.zeros(P, dtype=i64, device=dev)
    j_first = torch.where(lb < len1, len1 - lb, 0)[:, None]
    i_first = torch.where(rb < l2, l2 - rb, 0)[:, None]
    len1c, l2c, lbc, rbc, Cc = (x[:, None] for x in (len1, l2, lb, rb, C))
    for d in range(1, ndmax + 1):
        od = origin(torch.full_like(len1, d))
        s1w = (od - om1)[:, None]
        s2w = (od - om2 - 1)[:, None]
        P1p = torch.cat([negcol, P1, negcol], 1)   # column k+1 = row k
        P2p = torch.cat([negcol, P2, negcol], 1)
        rl = r + s1w                                # (i, j-1), in [0, WP]
        Lraw = torch.gather(P1p, 1, rl + 1)
        Uraw = torch.gather(P1p, 1, rl)             # (i-1, j)
        Dp = torch.gather(P2p, 1, r + s2w + 1)      # (i-1, j-1)
        Lv = Lraw + gap_p
        U = Uraw + gap_p
        i = od[:, None] + r
        j = d - i
        c1 = torch.gather(s1c, 1, i.clamp(max=L1R - 1))
        srow = Cc - j
        c2 = torch.where((srow >= 0) & (srow < L2R),
                         torch.gather(s2c, 1, srow.clamp(0, L2R - 1)) & 3, 0)
        D = Dp + torch.where(c1 == c2, match, mismatch)
        ge = U >= Lv
        entry = torch.where(ge, U, Lv)
        ptr = torch.where(ge, 3, 2)
        dw = D > entry
        entry = torch.where(dw, D, entry)
        ptr = torch.where(dw, 1, ptr)
        entry = torch.where(j == 0, 0, entry)
        ptr = torch.where(j == 0, 3, ptr)
        entry = torch.where(i == 0, 0, entry)
        ptr = torch.where(i == 0, 2, ptr)
        rrow = len1 - om1
        candr = torch.where(
            (rrow >= 0) & (rrow < WP),
            torch.gather(P1, 1, rrow.clamp(0, WP - 1)[:, None])[:, 0],
            0)[:, None]
        lastrow = (i == len1c) & (j > j_first) & (i > 0) & (j > 0)
        rgt = lastrow & (candr > entry)
        rtie = lastrow & (candr == entry) & (ptr == 1)
        entry = torch.where(rgt, candr, entry)
        ptr = torch.where(rgt | rtie, 2, ptr)
        lastcol = (j == l2c) & (i > i_first) & (i > 0) & (j > 0)
        cgt = lastcol & (Uraw > entry)
        ctie = lastcol & (Uraw == entry) & (ptr != 3)
        entry = torch.where(cgt, Uraw, entry)
        ptr = torch.where(cgt | ctie, 3, ptr)
        valid = ((i - j <= lbc) & (j - i <= rbc) & (i <= len1c) & (j >= 0)
                 & (j <= l2c))
        P2 = P1
        P1 = torch.where(valid, entry, NEG)
        slab[d] = torch.where(valid, ptr, 0).to(torch.int8)
        om2, om1 = om1, od

    # traceback: every lane walks back from (len1, len2); a lane is active
    # on diagonal d while i + j == d
    sub = torch.zeros((P, L2R), dtype=i64, device=dev)
    mapq = torch.zeros((P, L1R), dtype=i64, device=dev)
    kinds = (torch.zeros((P, NDP), dtype=i64, device=dev) if emit_kinds
             else None)
    i = torch.where(fail, torch.clamp_min(len1, 1), len1)
    j = l2.clone()
    alive = ~fail
    for d in range(ndmax, 0, -1):
        act = alive & (i + j == d)
        rr = i - origin(torch.full_like(len1, d))
        inw = (rr >= 0) & (rr < WP)
        ptr = slab[d, pid, rr.clamp(0, WP - 1)].to(i64)
        kind = torch.where(act & inw, ptr, 0)
        diag = kind == 1
        up = kind == 3
        ic = i.clamp(0, L1R - 1)
        jrow = (C - j).clamp(0, L2R - 1)
        c1 = s1c[pid, ic]
        sq = s2c[pid, jrow]
        c2 = sq & 3
        issub = diag & (c1 != c2)
        if emit_kinds == "cls":
            # column class: kind 2 (left) -> 1, kind 3 (up) -> 2, a
            # diagonal -> 3 (substitution) or 4 (match); an active step
            # with no pointer (stuck traceback) also reads 4
            cls = torch.where(kind == 2, 1, torch.where(
                up, 2, torch.where(issub, 3, 4)))
            kinds[:, d] = torch.where(act, cls, 0)
        elif emit_kinds:
            kinds[:, d] = kind
        sub[pid[issub], jrow[issub]] = c1[issub] + 1
        rec = torch.where(diag, ((sq >> 2) << 17) | (j << 3) | (c2 + 2), 1)
        take1 = diag | up
        mapq[pid[take1], ic[take1]] = rec[take1]
        i = i - take1.to(i64)
        j = j - (diag | (kind == 2)).to(i64)
    end = torch.zeros((P, 8), dtype=i64, device=dev)
    end[:, 0] = i
    end[:, 1] = j

    def blocks(x):
        return x.reshape(nb, LANES, -1).permute(0, 2, 1).contiguous().to(
            torch.int32)

    outs = [blocks(sub), blocks(mapq), blocks(end)]
    if emit_kinds:
        outs.insert(0, blocks(kinds))
    return outs


def nw_pairs_stats_ref(scal, params, s1, s2q, *, L1R: int, L2R: int,
                       NDP: int, WP: int, match: int, mismatch: int,
                       gap_p: int, allow_one_off: bool, max_shift: int):
    """Plain PyTorch version of nw_pairs_stats: B2 pairs' class rows and
    ends from nw_wavefront_ref, then stats_from_cls."""
    cls_b, _sub, _mapq, end_b = nw_wavefront_ref(
        scal, params, s1, s2q, L1R=L1R, L2R=L2R, NDP=NDP, WP=WP,
        match=match, mismatch=mismatch, gap_p=gap_p, emit_kinds="cls",
        s1_per_block=True)
    return stats_from_cls(cls_b, end_b, allow_one_off=allow_one_off,
                          max_shift=max_shift)


def stats_from_cls(cls_b, end_b, *, allow_one_off: bool, max_shift: int):
    """nw_pairs_stats' rows from B2 pairs' outputs (class rows
    [nb, NDP, 128], end [nb, 8, 128]): _lr_accum_pairs' five statistics
    and end0 | end1, [nb * 128, 6] int32."""
    NDP = cls_b.shape[1]
    cls_rows = cls_b.permute(0, 2, 1).reshape(-1, NDP)
    end_rows = end_b.permute(0, 2, 1).reshape(-1, 8)
    stats = _lr_accum_pairs(cls_rows, allow_one_off=allow_one_off,
                            max_shift=max_shift)
    ok = (end_rows[:, 0] | end_rows[:, 1]).to(stats.dtype)
    return torch.cat([stats, ok[:, None]], 1).to(torch.int32)


def _first_false_t(mask, start, L: int):
    """Per row: smallest index >= start[p] with mask False, else L. An
    integer min over the hit indices (no argmax over bools, whose tie
    order is not a contract)."""
    idx = torch.arange(L, dtype=torch.int32, device=mask.device)[None, :]
    hit = ~mask & (idx >= start[:, None])
    return torch.where(hit, idx, L).amin(1)


def _take(x, col):
    """x[p, col[p]] for a per-row column index."""
    return torch.gather(x, 1, col.long()[:, None])[:, 0]


def _lr_accum_pairs(cls_rows, *, allow_one_off: bool, max_shift: int):
    """lr/ham stats for arbitrary pairs straight from kernel B2's
    per-diagonal alignment-column classes (0 = inactive diagonal,
    1 = s2-insertion/A-gap, 2 = A-char-vs-B-gap, 3 = substitution,
    4 = match, in forward diagonal order); the counterpart of
    dada2_tpu/chimeras.py::_lr_accum_pairs_trace.

    The column-space scans (chimeras._lr_one_side/_lr_ham_batch) run in
    DIAGONAL space with inactive steps transparent: a step's column index
    is the running count of active steps before it, so every column-bound
    predicate maps to a masked cumsum, with no column scatter. Returns
    stats [CNT, 5] int64 (left, right, left_oo, right_oo, ham)."""
    CNT, D = cls_rows.shape
    cls_f = cls_rows.to(torch.int32)
    a_f = cls_f != 0
    m = a_f.sum(1)
    zero = torch.zeros_like(m)

    def colof(cv, d_idx):
        # column index of the active step at diagonal d_idx; d_idx == D
        # (not found) maps to column m
        got = _take(cv, d_idx.clamp(0, D - 1))
        return torch.where(d_idx >= D, m, got)

    def one_side(cls_, shift_bound):
        act = cls_ != 0
        cv = torch.cumsum(act, 1, dtype=torch.int32) - 1
        # leading A-gap (class 1) run, inactive steps transparent
        q0_d = _first_false_t(~act | (cls_ == 1), zero, D)
        q0 = colof(cv, q0_d)
        # B-gap (class 2) overhang while column < shift_bound
        s_d = _first_false_t(~act | ((cls_ == 2) & (cv < shift_bound)),
                             q0_d, D)
        # match run
        eqmask = ~act | (cls_ == 4)
        e_d = _first_false_t(eqmask, s_d, D)
        e = colof(cv, e_d)
        credit = e - q0
        if not allow_one_off:
            return credit, credit
        # one-off: the single column after the run must exist and not be
        # an A-gap, then the match run continues
        n_d = _first_false_t(~act, e_d + 1, D)
        ncls = _take(cls_, n_d.clamp(0, D - 1))
        bonus = (n_d < D) & (ncls != 1)
        f_d = _first_false_t(eqmask, n_d, D)
        f = torch.where(n_d >= D, e + 1, colof(cv, f_d))
        return credit, credit + bonus + (f - (e + 1)).clamp_min(0)

    cls_r = cls_f.flip(1)
    left, left_oo = one_side(cls_f, max_shift)
    right, right_oo = one_side(cls_r, max_shift - 1)

    # ends-free hamming: trim the max of the two leading gap runs on each
    # side, count non-match columns in between
    cv_f = torch.cumsum(a_f, 1, dtype=torch.int32) - 1
    a_r = cls_r != 0
    cv_r = torch.cumsum(a_r, 1, dtype=torch.int32) - 1
    startc = torch.maximum(
        colof(cv_f, _first_false_t(~a_f | (cls_f == 1), zero, D)),
        colof(cv_f, _first_false_t(~a_f | (cls_f == 2), zero, D)))
    rtrim = torch.maximum(
        colof(cv_r, _first_false_t(~a_r | (cls_r == 1), zero, D)),
        colof(cv_r, _first_false_t(~a_r | (cls_r == 2), zero, D)))
    end = m - rtrim
    ham = (a_f & (cls_f != 4) & (cv_f >= startc[:, None])
           & (cv_f < end[:, None])).sum(1)
    return torch.stack([left, right, left_oo, right_oo, ham],
                       1).to(torch.int64)


# ---- B3's host side: one center against candidates of any lengths --------

def derive_from_kinds(kinds, s1pad, len1b, s2pad, len2b, *, nd):
    """Positions, hamming and transition vectors from diagonal-indexed step
    kinds (counterpart of nw_pallas.derive_from_kinds).

    At diagonal d the pair is at (i, j) with i + j = d; after the step its
    position is len - (suffix count of consumed steps), so one reversed
    cumsum per axis reconstructs p0/p1 without a sequential walk.
    Returns (p0, p1, ham, tvec int8, ok), one row per pair."""
    i64 = torch.int64
    kinds = kinds[:, :nd].to(i64)
    n, W2 = s2pad.shape
    W1 = s1pad.shape[1]
    l1 = len1b.to(i64)[:, None]
    l2 = len2b.to(i64)[:, None]
    takes1 = ((kinds == 1) | (kinds == 3)).to(i64)
    takes2 = ((kinds == 1) | (kinds == 2)).to(i64)
    cum1 = takes1.flip(1).cumsum(1).flip(1)
    cum2 = takes2.flip(1).cumsum(1).flip(1)
    p0 = l1 - cum1
    p1 = l2 - cum2
    diag = kinds == 1
    s1 = s1pad.to(i64)
    s2 = s2pad.to(i64)
    nt0 = torch.gather(s1, 1, p0.clamp(0, W1 - 1))
    nt1 = torch.gather(s2, 1, p1.clamp(0, W2 - 1))
    ham = (diag & (nt0 != nt1)).sum(1)
    pos = torch.arange(W2, device=s2.device)[None, :]
    tvec = torch.where(pos < l2, 5 * s2, 16)
    # non-diagonal steps land in a spare column W2, which is cut off (the
    # TPU post-pass drops them with an out-of-range scatter)
    tvec = torch.cat([tvec, torch.zeros_like(tvec[:, :1])], 1)
    tvec.scatter_(1, torch.where(diag, p1, W2),
                  torch.where(diag, 4 * nt0 + nt1, 0))
    tvec = tvec[:, :W2]
    if nd > 0:
        ok = (cum1[:, 0] == l1[:, 0]) & (cum2[:, 0] == l2[:, 0])
    else:
        ok = (l1[:, 0] + l2[:, 0]) == 0
    return p0, p1, ham, tvec.to(torch.int8), ok


def grouped_inputs(s1: np.ndarray, len1: int, s2b, len2b, band: int):
    """Kernel B3's inputs for one center against candidates: length-sorted
    128-lane blocks (as nw_pallas.nw_pallas_grouped lays them out).
    Returns (block_idx, (scal, params, s1t, s2q) as numpy, geometry)."""
    s2b = np.asarray(s2b)
    len2b = np.asarray(len2b, np.int64)
    block_idx = assemble_blocks(s2b, len2b)
    nblocks = block_idx.shape[0]
    W = max(block_window(len1, len2b[block_idx[bi]], band)
            for bi in range(nblocks))
    WP = _round_up(max(W, 8), 32)
    NDP = _round_up(len1 + int(len2b.max()) + 1, 8)
    L1R = _round_up(len1 + 1 + WP, 8)
    L2R = _round_up(int(len2b.max()) + WP, 8)
    s2r = pack_s2_blocks(s2b, len2b, block_idx, L2R)
    scal = np.zeros((nblocks, 4), np.int32)
    params = np.zeros((nblocks, 8, LANES), np.int32)
    for bi in range(nblocks):
        l2 = len2b[block_idx[bi]]
        if band < 0:
            lb = np.full(LANES, len1)
            rb = l2
        else:
            lb = band + np.maximum(0, len1 - l2)
            rb = band + np.maximum(0, l2 - len1)
        scal[bi] = (len1, int(l2.max()), int(rb.max()), int(l2.min()))
        params[bi, 0] = l2
        params[bi, 1] = lb
        params[bi, 2] = rb
    s1t = np.zeros((L1R, LANES), np.int32)
    s1t[1: 1 + len1, :] = np.asarray(s1[:len1], np.int32)[:, None]
    geom = dict(L1R=L1R, L2R=L2R, NDP=NDP, WP=WP)
    return block_idx, (scal, params, s1t, s2r), geom


def nw_wavefront_grouped(s1: np.ndarray, len1: int, s2b, len2b, *, match,
                         mismatch, gap_p, band=16, device=None):
    """Align one center against candidates (any length mix) with kernel B3
    (counterpart of nw_pallas.nw_pallas_grouped, ends-free). Results are
    returned in the ORIGINAL row order: (kinds [n, nd], p0, p1, ham [n],
    tvec [n, L2], ok [n]) as numpy, in the traceback-order convention
    shared with dada2_tpu's ops/nw_batch.nw_batch. device: "cuda" by
    default (raises without a card) or "cpu" for the plain version."""
    from ..core.backend_cuda import resolve_device

    dev = resolve_device(device)
    s2b = np.asarray(s2b)
    len2b = np.asarray(len2b, np.int64)
    n = s2b.shape[0]
    block_idx, arrays, geom = grouped_inputs(s1, len1, s2b, len2b, band)

    def put(x):
        return trace.put(x, dev)

    kinds_blocks = nw_wavefront(
        *(put(a) for a in arrays), match=int(match), mismatch=int(mismatch),
        gap_p=int(gap_p), emit_kinds=True, **geom)[0]

    # un-block: rows for the first occurrence of each original index
    flat_idx = block_idx.reshape(-1)
    inv = np.full(n, -1, np.int64)
    inv[flat_idx[::-1]] = np.arange(len(flat_idx))[::-1]
    kb = kinds_blocks.permute(0, 2, 1).reshape(flat_idx.shape[0], -1)
    kinds = kb[put(inv)]

    s1row = put(np.asarray(s1[:len1]).astype(np.int8))
    p0, p1, ham, tvec, ok = derive_from_kinds(
        kinds, s1row[None, :].expand(n, len1),
        torch.full((n,), len1, dtype=torch.int64, device=dev),
        put(s2b.astype(np.int8)), put(len2b), nd=geom["NDP"])
    # kinds rows are diagonal-ascending = forward alignment order; flip to
    # the traceback-reverse convention shared with nw_batch
    return tuple(trace.fetch(x) for x in (kinds.flip(1), p0.flip(1),
                                          p1.flip(1), ham, tvec, ok))


# ---- host helpers (copies of dada2_tpu/ops/nw_pallas.py) -------------------

def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def block_window(len1: int, len2: np.ndarray, band: int) -> int:
    """Exact max window width (rows) needed for a block of candidate
    lengths vs one center, under the uniform origin o(d)."""
    len2 = np.asarray(len2, np.int64)
    if band < 0:
        lb = np.full(len2.shape, len1)
        rb = len2.copy()
    else:
        lb = band + np.maximum(0, len1 - len2)
        rb = band + np.maximum(0, len2 - len1)
    l2m, rbm = int(len2.max()), int(rb.max())
    d = np.arange(len1 + l2m + 1)
    o = np.maximum(0, np.maximum(d - l2m, -(-(d - rbm) // 2)))
    hi = np.minimum(np.minimum(len1, d[:, None]),
                    (d[:, None] + lb[None, :]) // 2)
    return int((hi.max(axis=1) - o + 1).max())


def assemble_blocks(s2b: np.ndarray, len2b: np.ndarray, order=None,
                    lanes=LANES):
    """Sort candidates by length and chunk into 128-lane blocks.

    Returns (block_index_lists [nblocks, lanes], per-lane original row ->
    (block, lane) inverse map)."""
    len2b = np.asarray(len2b, np.int64)
    n = len(len2b)
    if order is None:
        order = np.argsort(len2b, kind="stable")
    blocks = []
    for k in range(0, n, lanes):
        chunk = order[k: k + lanes]
        pad = np.full(lanes - len(chunk), chunk[0], np.int64)
        blocks.append(np.concatenate([chunk, pad]))
    return np.stack(blocks) if blocks else np.zeros((0, lanes), np.int64)


def pack_s2_blocks(s2b: np.ndarray, len2b: np.ndarray,
                   block_idx: np.ndarray, L2R: int):
    """Reversed right-aligned candidate char blocks [nblocks, L2R, LANES]
    plus the per-lane parameter rows (len2 only; bands are center-
    dependent and belong to the per-call scalar/params assembly)."""
    nblocks, lanes = block_idx.shape
    if nblocks == 0:
        return np.zeros((0, L2R, lanes), np.int32)
    lens_all = np.asarray(len2b, np.int64)
    out = np.zeros((nblocks, L2R, lanes), np.int32)
    t_idx = np.arange(L2R, dtype=np.int64)[:, None]
    # storage row C - jj holds s2[jj-1], C = len2max(block): within one
    # block that is a plain reversal of the first l2max chars (contiguous
    # strided copy — an element scatter here costs ~10x more on slow-
    # page-fault hosts), masked where the reversal reaches past a lane's
    # own length
    for bi in range(nblocks):
        rows = block_idx[bi]
        lb = lens_all[rows]
        l2m = int(lb.max())
        seg = s2b[rows][:, l2m - 1::-1].T.astype(np.int32)  # [l2m, LANES]
        out[bi, :l2m] = np.where(t_idx[:l2m] >= (l2m - lb)[None, :],
                                 seg, 0)
    return out
