"""Wavefront banded ends-free Needleman-Wunsch, compare mode (kernel B1).

`nw_compare` keeps the interface of the TPU kernel it replaces
(dada2_tpu/ops/nw_pallas.py::_pallas_call in compare mode: emit_kinds=False,
s1_per_block=False, end_gap_p=0): the same scal/params/s1t/s2q in and the
same sub/mapq/end out, so the two compare array for array. On a CUDA
tensor it launches the hand-written Hopper kernel in
csrc/nw_wavefront.cu (built with nvcc at first use, loaded through
ctypes); on a CPU tensor it runs `nw_compare_ref`, the plain PyTorch
version of the same recurrences. There is no fallback between the two.

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
import os
import shutil
import subprocess
import threading
from typing import Optional

import numpy as np
import torch

NEG = -(2**29)
LANES = 128
WP_MAX = 128    # widest window (rows) the kernel serves, in steps of 32

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "nw_wavefront.cu")
_BUILD_DIR = os.path.join(_PKG, "build")
_SO = os.path.join(_BUILD_DIR, "libnw_wavefront.so")
_PTXAS_LOG = os.path.join(_BUILD_DIR, "nw_wavefront.ptxas.txt")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


# ---- build and load ------------------------------------------------------

def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def build_kernel() -> str:
    """Compile csrc/nw_wavefront.cu for sm_90a into build/ (if the library
    is missing or older than its source) and return the compiler's
    `-Xptxas -v` report (registers, shared memory, spills)."""
    with _lock:
        fresh = (os.path.exists(_SO) and os.path.exists(_PTXAS_LOG)
                 and os.path.getmtime(_SO) >= os.path.getmtime(_SRC))
        if not fresh:
            os.makedirs(_BUILD_DIR, exist_ok=True)
            tmp = f"{_SO}.{os.getpid()}.tmp"
            cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                   "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                   "-Xptxas", "-v", "-o", tmp, _SRC]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
            with open(_PTXAS_LOG, "w") as fh:
                fh.write(proc.stdout + proc.stderr)
            os.replace(tmp, _SO)
        with open(_PTXAS_LOG) as fh:
            return fh.read()


def _load():
    global _lib
    if _lib is not None:
        return _lib
    build_kernel()
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(_SO)
            V, I = ctypes.c_void_p, ctypes.c_int
            lib.nw_wavefront_compare.restype = I
            lib.nw_wavefront_compare.argtypes = [V] * 7 + [I] * 8 + [V]
            lib.nw_wavefront_pairs_per_block.restype = I
            lib.nw_wavefront_pairs_per_block.argtypes = [I] * 4
            _lib = lib
    return _lib


def pairs_per_block(L1R: int, L2R: int, NDP: int, WP: int) -> int:
    """Pairs (warps) one block of the kernel holds at this geometry, 0 if
    the window does not fit one block's shared memory. The shared-memory
    layout and the fit live in csrc/nw_wavefront.cu; this asks the built
    library (so it needs nvcc)."""
    return int(_load().nw_wavefront_pairs_per_block(L1R, L2R, NDP, WP))


# ---- the wrapper ---------------------------------------------------------

def _check(scal, params, s1t, s2q, L1R, L2R, WP):
    nb = s2q.shape[0] if s2q.dim() == 3 else -1
    want = {"scal": (scal, (nb, 4)), "params": (params, (nb, 8, LANES)),
            "s1t": (s1t, (L1R, LANES)), "s2q": (s2q, (nb, L2R, LANES))}
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


def nw_compare(scal, params, s1t, s2q, *, L1R: int, L2R: int, NDP: int,
               WP: int, match: int, mismatch: int, gap_p: int):
    """Kernel B1: align one center (s1t) against nb blocks of 128
    candidates (s2q). Returns (sub [nb, L2R, 128], mapq [nb, L1R, 128],
    end [nb, 8, 128]), all int32, in the TPU kernel's layouts (see
    csrc/nw_wavefront.cu). Ends-free (end_gap_p = 0) requires gap_p < 0.

    CUDA tensors launch the kernel on the current stream (and count one
    launch in nw_compare.launches); CPU tensors run nw_compare_ref."""
    _check(scal, params, s1t, s2q, L1R, L2R, WP)
    if gap_p >= 0:
        raise ValueError("compare mode is ends-free: gap_p must be < 0")
    dev = s2q.device
    if dev.type == "cpu":
        return nw_compare_ref(scal, params, s1t, s2q, L1R=L1R, L2R=L2R,
                              NDP=NDP, WP=WP, match=match,
                              mismatch=mismatch, gap_p=gap_p)
    if dev.type != "cuda":
        raise ValueError(f"nw_compare runs on cuda or cpu, not {dev}")
    if pairs_per_block(L1R, L2R, NDP, WP) == 0:
        raise NotImplementedError(
            f"window WP={WP}, NDP={NDP} exceeds one block's shared memory "
            "(ROADMAP A5: the scalar/wide-window aligner)")
    nb = s2q.shape[0]
    sub = torch.empty((nb, L2R, LANES), dtype=torch.int32, device=dev)
    mapq = torch.empty((nb, L1R, LANES), dtype=torch.int32, device=dev)
    end = torch.empty((nb, 8, LANES), dtype=torch.int32, device=dev)
    if nb == 0:
        return sub, mapq, end
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _load().nw_wavefront_compare(
        scal.data_ptr(), params.data_ptr(), s1t.data_ptr(), s2q.data_ptr(),
        sub.data_ptr(), mapq.data_ptr(), end.data_ptr(), nb, L1R, L2R, NDP,
        WP, int(match), int(mismatch), int(gap_p), stream)
    if rc != 0:
        raise RuntimeError(f"nw_wavefront kernel launch failed: CUDA error "
                           f"{rc}")
    with _count_lock:   # multi-sample dada() launches from worker threads
        nw_compare.launches += 1
    return sub, mapq, end


nw_compare.launches = 0
_count_lock = threading.Lock()


# ---- the plain PyTorch version -------------------------------------------

def nw_compare_ref(scal, params, s1t, s2q, *, L1R: int, L2R: int, NDP: int,
                   WP: int, match: int, mismatch: int, gap_p: int):
    """Plain PyTorch version of kernel B1, batched over every pair (lane)
    and window row: one vectorized step per anti-diagonal for the fill,
    one per diagonal for the traceback. Same inputs, outputs and
    semantics as the kernel (including its geometry guard)."""
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
    s1c = s1t.to(i64).t()[lane]                               # [P, L1R]
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

    return blocks(sub), blocks(mapq), blocks(end)


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
