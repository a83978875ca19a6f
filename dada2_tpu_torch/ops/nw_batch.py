"""Batched Needleman-Wunsch over per-pair windows (kernel B4).

The counterpart of dada2_tpu/ops/nw_batch.py: the same arrays in and the
same arrays out, bit for bit. Every pair (s1b[k], s2b[k]) is aligned on its
own band window: anti-diagonal d = i + j holds the in-band rows
lo(d) = max(0, d - len2, ceil((d - rband) / 2)) .. hi(d) = min(len1, d,
floor((d + lband) / 2)), stored from lo(d) on, with
lband = band + max(0, len1 - len2), rband = band + max(0, len2 - len1)
(band < 0: lband = len1, rband = len2, no band). Two aligners:

  mode="vec"     the vectorized aligner (reference:
                 src/nwalign_vectorized.cpp:71-318): tie precedence
                 up >= left > diag, the ends-free last-row/last-column
                 recalculation one diagonal late;
  mode="scalar"  the classic aligner of nwalign/mergePairs and the
                 non-vectorized engine configurations (reference:
                 src/nwalign_endsfree.cpp:76-396): free end gaps on the
                 last row and column, tie precedence up >= diag and
                 up >= left, then left >= diag; banded, the out-of-band
                 neighbours read the reference's -9999; with homo_gap_p,
                 gaps inside homopolymer runs (>= 3) cost homo_gap_p.

`nw_batch` takes numpy arrays or tensors. On CUDA tensors it launches the
hand-written Hopper kernel in csrc/nw_batch.cu (built with nvcc at first
use, loaded through ctypes) and counts each launch in nw_batch.launches
and, by the body that served it, in nw_batch.launches_by_body: "register"
(one warp per pair, the window in registers; windows of up to 256 rows),
"wide" (the register body's cells on ceil(W / 256) warps per pair;
windows of 257 to 2,048 rows) or "block" (one block per pair; wider
windows). The body is chosen from the batch's geometry before the launch
(`route`). On CPU tensors it runs the plain PyTorch version,
`nw_batch_ref` (which also runs on the card, as the kernel's yardstick for
every body). There is no fallback between the two. Batches are cut into
chunks so that the scratch one launch needs (the wide or one-block-per-pair
body's pointer slab in device memory, or the plain version's pointer and
score tensors) stays under a byte budget.

batch_geometry, homo_mask_batch and steps_to_alignment are copies of the
JAX package's host helpers.
"""
from __future__ import annotations

import ctypes
import functools
import os
import threading
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import trace
from . import nw_wavefront as nww

NEG = -(2**29)
PTR_NONE, PTR_DIAG, PTR_LEFT, PTR_UP = 0, 1, 2, 3
OOB_BANDED_SCALAR = -9999   # the reference's band-boundary fill value
MAX_BYTES = 1 << 30         # scratch budget of one launch (see nw_batch)
# Checks' overrides, None in use: BODY "block" sends every launch to the
# one-block-per-pair body wherever it fits (to hold it against the plain
# version on the batches the other bodies serve); PAIRS_PER_BLOCK sets the
# register body's pairs per block (1..16; to run partial and full last
# blocks)
BODY: Optional[str] = None
PAIRS_PER_BLOCK: Optional[int] = None

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "nw_batch.cu")
_SO = os.path.join(_PKG, "build", "libnw_batch.so")
_PTXAS_LOG = os.path.join(_PKG, "build", "nw_batch.ptxas.txt")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


# ---- host helpers (copies of dada2_tpu/ops/nw_batch.py) --------------------

def batch_geometry(len1: np.ndarray, len2: np.ndarray, band: int):
    """Static (max_diags, W) for a batch of pairs; host-side, exact."""
    len1 = np.asarray(len1, dtype=np.int64)
    len2 = np.asarray(len2, dtype=np.int64)
    if band < 0:
        lband, rband = len1, len2
    else:
        lband = band + np.maximum(0, len1 - len2)
        rband = band + np.maximum(0, len2 - len1)
    # max window width: floor((d+lband)/2) - ceil((d-rband)/2) + 1 maximized
    # over d, also bounded by the rectangle
    w = (lband + rband) // 2 + 2
    w = np.minimum(w, np.minimum(len1, len2) + 1)
    nd = int((len1 + len2).max()) + 1
    return nd, int(w.max())


def homo_mask_batch(codes: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """[n, L] bool: positions inside a homopolymer run of length >= 3,
    batched (reference: src/nwalign_endsfree.cpp:227-255)."""
    codes = np.asarray(codes)
    n, L = codes.shape
    if L < 3:
        return np.zeros((n, L), bool)
    pos = np.arange(L)[None, :]
    real = pos < np.asarray(lens)[:, None]
    eq = np.zeros((n, L), bool)
    eq[:, 1:] = (codes[:, 1:] == codes[:, :-1]) & real[:, 1:]
    # position is in a run >= 3 iff some window of 2 consecutive eq-links
    # covers it: eq[i] & eq[i+1] marks i-1..i+1
    tri = np.zeros((n, L), bool)
    tri[:, 1:] = eq[:, 1:] & np.roll(eq, -1, axis=1)[:, 1:]
    out = tri | np.roll(tri, 1, axis=1) | np.roll(tri, -1, axis=1)
    out[:, 0] = tri[:, 0] | (tri[:, 1] if L > 1 else False)
    return out & real


def steps_to_alignment(kinds: np.ndarray, p0: np.ndarray, p1: np.ndarray,
                       s1: np.ndarray, s2: np.ndarray):
    """Reconstruct the gapped alignment (host-side) from traceback steps.

    Returns (al0, al1) uint8 arrays with 254 = gap, matching ops/nw_ref.
    """
    from .nw_ref import GAP

    live = kinds != PTR_NONE
    kinds, p0, p1 = kinds[live][::-1], p0[live][::-1], p1[live][::-1]
    al0 = np.where(kinds != PTR_LEFT, s1[np.clip(p0, 0, len(s1) - 1)], GAP)
    al1 = np.where(kinds != PTR_UP, s2[np.clip(p1, 0, len(s2) - 1)], GAP)
    return al0.astype(np.uint8), al1.astype(np.uint8)


# ---- build and load --------------------------------------------------------

def build_kernel() -> str:
    """Build csrc/nw_batch.cu (the register body: rows per thread 1, 2, 4,
    8 x vec, scalar and homopolymer aligners; the wide body: the three
    aligners; the one-block-per-pair body: the three aligners x pointer
    slab in shared or device memory) and return its `-Xptxas -v`
    report."""
    return nww.build_library(_SRC, _SO, _PTXAS_LOG)


def _load():
    global _lib
    if _lib is not None:
        return _lib
    build_kernel()
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(_SO)
            V, I = ctypes.c_void_p, ctypes.c_int
            for name, nargs in (("nw_batch_route", 5),
                                ("nw_batch_block_route", 5),
                                ("nw_batch_wide_slab_words", 2),
                                ("nw_batch_warps", 1),
                                ("nw_batch_reg_rpt", 1),
                                ("nw_batch_pairs_per_block", 7)):
                getattr(lib, name).restype = I
                getattr(lib, name).argtypes = [I] * nargs
            lib.nw_batch_run.restype = I
            lib.nw_batch_run.argtypes = [V] * 13 + [I] * 16 + [V]
            _lib = lib
    return _lib


def route(L1: int, L2: int, nd: int, W: int, homo: bool) -> int:
    """Which body of kernel B4 serves this geometry: 3 the register body
    (windows of up to 256 rows); 4 the wide body (windows of up to 2,048
    rows; a pair's pointers in a device-memory slab); else the
    one-block-per-pair body with them in shared memory (1) or in a
    device-memory slab (2); 0 if nothing fits one block. The fit lives in
    csrc/nw_batch.cu (nw_batch_route); this asks the built library."""
    return int(_load().nw_batch_route(L1, L2, nd, W, int(bool(homo))))


def block_route(L1: int, L2: int, nd: int, W: int, homo: bool) -> int:
    """The one-block-per-pair body's route at this geometry (1, 2 or 0, as
    in `route`), whatever body `route` chooses."""
    return int(_load().nw_batch_block_route(L1, L2, nd, W, int(bool(homo))))


def body(r: int) -> str:
    """The name of the body that serves route r."""
    return {3: "register", 4: "wide"}.get(r, "block")


def warps_per_pair(W: int) -> int:
    """Warps a pair takes at windows of up to W rows: 1 in the register
    body, ceil(W / 256) in the wide body (csrc/nw_batch.cu,
    nw_batch_warps)."""
    return int(_load().nw_batch_warps(W))


def register_fit(L1: int, L2: int, nd: int, W: int, scalar: bool,
                 homo: bool, n: int):
    """(rows per thread, pairs per block) of the register body for a
    launch of n pairs at this geometry on the current CUDA device, (8, 1)
    where the wide body serves it (a block is one pair); pairs per block 0
    if neither does. The choice lives in csrc/nw_batch.cu
    (nw_batch_pairs_per_block, from the CUDA occupancy calculator)."""
    return _register_fit(torch.cuda.current_device(), L1, L2, nd, W,
                         int(bool(scalar)), int(bool(homo)), n)


@functools.lru_cache(maxsize=1024)
def _register_fit(device: int, L1: int, L2: int, nd: int, W: int,
                  scalar: int, homo: int, n: int):
    lib = _load()
    return (int(lib.nw_batch_reg_rpt(W)),
            int(lib.nw_batch_pairs_per_block(L1, L2, nd, W, scalar, homo,
                                             n)))


def slab_words(nd: int, W: int, r: int = 2) -> int:
    """32-bit words of one pair's device-memory pointer slab on route r:
    the one-block-per-pair body's (2: two bit planes per group of 32 window
    rows, per diagonal) or the wide body's (4: a word per row a group of
    sixteen diagonals can hold, nw_batch_wide_slab_words)."""
    if r == 4:
        return int(_load().nw_batch_wide_slab_words(nd, W))
    return nd * ((W + 31) // 32) * 2


# ---- the wrapper -----------------------------------------------------------

def _host(x) -> np.ndarray:
    return trace.fetch(x) if isinstance(x, torch.Tensor) else np.asarray(x)


def _on(x, dtype, dev) -> torch.Tensor:
    """x (numpy or tensor) as a contiguous tensor of dtype on dev; codes
    (uint8, pad 255) wrap to int8 as the JAX package's int8 cast does."""
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
        if dtype == torch.int8 and x.dtype != np.int8:
            x = x.astype(np.int64).astype(np.int8)
        x = trace.put(x, dev)
    return x.to(device=dev, dtype=dtype).contiguous()


def _device(device, arrays) -> torch.device:
    if device is None:
        for x in arrays:
            if isinstance(x, torch.Tensor):
                return x.device
    from ..core.backend_cuda import resolve_device

    return resolve_device(device)


class _Batch(NamedTuple):
    """One call's inputs on its device, its outputs and its geometry."""
    dev: torch.device
    ins: tuple       # s1, len1, s2, len2, h1, h2 (h1/h2 None without homo)
    outs: tuple      # kinds, p0, p1, ham, tvec, ok
    nd: int
    W: int
    scal: dict       # the aligner's integer parameters
    mode: str


def _prepare(s1b, len1b, s2b, len2b, match, mismatch, gap_p, end_gap_p,
             band, mode, homo_gap_p, homo1b, homo2b, device,
             geometry=None) -> _Batch:
    if mode not in ("vec", "scalar"):
        raise ValueError(f"mode must be 'vec' or 'scalar', not {mode!r}")
    dev = _device(device, (s1b, s2b, len1b, len2b))
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"nw_batch runs on cuda or cpu, not {dev}")
    l1h = _host(len1b).astype(np.int64)
    l2h = _host(len2b).astype(np.int64)
    use_homo = (mode == "scalar" and homo_gap_p is not None
                and homo_gap_p != gap_p and end_gap_p != gap_p)
    if use_homo:
        if homo1b is None:
            homo1b = homo_mask_batch(_host(s1b), l1h)
        if homo2b is None:
            homo2b = homo_mask_batch(_host(s2b), l2h)
    s1 = _on(s1b, torch.int8, dev)
    s2 = _on(s2b, torch.int8, dev)
    ins = (s1, _on(l1h, torch.int32, dev), s2, _on(l2h, torch.int32, dev),
           _on(homo1b, torch.bool, dev) if use_homo else None,
           _on(homo2b, torch.bool, dev) if use_homo else None)
    n, L1 = s1.shape
    L2 = s2.shape[1]
    if len(l1h) != n or len(l2h) != n or s2.shape[0] != n:
        raise ValueError("s1b, len1b, s2b and len2b must have one row per "
                         "pair")
    if n and ((l1h < 0).any() or (l2h < 0).any() or (l1h > L1).any()
              or (l2h > L2).any()):
        raise ValueError("lengths must lie in 0..L1 and 0..L2")
    nsteps = L1 + L2
    outs = (torch.empty((n, nsteps), dtype=torch.int8, device=dev),
            torch.empty((n, nsteps), dtype=torch.int32, device=dev),
            torch.empty((n, nsteps), dtype=torch.int32, device=dev),
            torch.empty(n, dtype=torch.int32, device=dev),
            torch.empty((n, L2), dtype=torch.int8, device=dev),
            torch.empty(n, dtype=torch.bool, device=dev))
    if geometry is not None:
        nd, W = (int(g) for g in geometry)
    else:
        nd, W = batch_geometry(l1h, l2h, band) if n else (0, 0)
    scal = dict(match=int(match), mismatch=int(mismatch), gap_p=int(gap_p),
                end_gap_p=int(end_gap_p), band=int(band),
                homo_gap_p=int(homo_gap_p) if use_homo else 0)
    return _Batch(dev, ins, outs, nd, W, scal, mode)


def nw_batch(s1b, len1b, s2b, len2b, *, match, mismatch, gap_p,
             end_gap_p=0, band=-1, mode="vec", homo_gap_p=None,
             homo1b=None, homo2b=None, device=None, geometry=None):
    """Align pairs (s1b[k], s2b[k]) (counterpart of
    dada2_tpu.ops.nw_batch.nw_batch).

    s1b: [n, L1] codes; len1b: [n]; likewise s2b/len2b (numpy or tensors).
    Returns tensors (kinds, p0, p1, ham, tvec, ok) on the device:
      kinds [n, L1+L2] int8 — traceback step types, reverse alignment order
        (1=diag, 2=gap in s1, 3=gap in s2, 0=finished);
      p0/p1 [n, L1+L2] int32 — 0-based positions after each step;
      ham [n] int32 — substitution counts;
      tvec [n, L2] int8 — 16-way transition index per s2 position (self
        transitions except at substitutions; 16 = padding);
      ok [n] bool — traceback reached the origin.

    mode="scalar" uses the classic aligner's recurrences (banded or not);
    homo_gap_p (with mode="scalar", ends-free) enables the homopolymer
    gap variant — homo1b/homo2b masks are computed here if not given.
    device: None takes the device of the tensors given, else CUDA (raising
    without a card); "cpu" runs the plain version. geometry: the static
    (nd, W) to align under, as dada2_tpu's _nw_batch_jit takes them
    (parallel/dist.py's compare step); by default batch_geometry's. On
    CUDA the call launches kernel B4: the register body in one launch, or
    the wide or the one-block-per-pair body in one launch per chunk
    (MAX_BYTES bounds their device-memory pointer slab of one launch)."""
    b = _prepare(s1b, len1b, s2b, len2b, match, mismatch, gap_p, end_gap_p,
                 band, mode, homo_gap_p, homo1b, homo2b, device, geometry)
    if b.dev.type == "cpu":
        return _plain(b)
    return _launch(b)


def _launch(b: _Batch):
    """Kernel B4 on a batch prepared on the card: the body its geometry's
    route chooses (or BODY's), one launch per chunk, counted. Returns the
    batch's output tensors. Runs with the batch's device current (the fit
    asks cudaGetDevice)."""
    with torch.cuda.device(b.dev):
        s1, len1, s2, len2, h1, h2 = b.ins
        kinds, p0, p1, ham, tvec, ok = b.outs
        n, L1 = s1.shape
        L2 = s2.shape[1]
        if n == 0:
            return b.outs
        use_homo = h1 is not None
        scalar = b.mode == "scalar"
        r = route(L1, L2, b.nd, b.W, use_homo)
        if BODY == "block" and r in (3, 4):
            r = block_route(L1, L2, b.nd, b.W, use_homo)
        if r == 0:
            raise ValueError(f"window of {b.W} rows (sequences of {L1} and "
                             f"{L2}) exceeds one block's shared memory in "
                             "kernel B4")
        ppb = 0
        if r == 3:
            ppb = PAIRS_PER_BLOCK or register_fit(L1, L2, b.nd, b.W, scalar,
                                                  use_homo, n)[1]
        gslab = r in (2, 4)   # the pointer slab in device memory
        words = slab_words(b.nd, b.W, r) if gslab else 0
        chunk = max(1, MAX_BYTES // (4 * words)) if gslab else n
        slab = (torch.empty(min(chunk, n) * words, dtype=torch.int32,
                            device=b.dev) if gslab else None)
        stream = torch.cuda.current_stream(b.dev).cuda_stream
        lib = _load()
        sc = b.scal
        for c0 in range(0, n, chunk):
            c1 = min(c0 + chunk, n)
            rc = lib.nw_batch_run(
                s1[c0].data_ptr(), len1[c0:].data_ptr(), s2[c0].data_ptr(),
                len2[c0:].data_ptr(), h1[c0].data_ptr() if use_homo else None,
                h2[c0].data_ptr() if use_homo else None, kinds[c0].data_ptr(),
                p0[c0].data_ptr(), p1[c0].data_ptr(), ham[c0:].data_ptr(),
                tvec[c0].data_ptr(), ok[c0:].data_ptr(),
                slab.data_ptr() if slab is not None else None, c1 - c0, L1, L2,
                b.nd, b.W, words, int(scalar), int(use_homo), sc["band"],
                sc["match"], sc["mismatch"], sc["gap_p"], sc["end_gap_p"],
                sc["homo_gap_p"], r, ppb, stream)
            if rc != 0:
                raise RuntimeError(f"nw_batch kernel B4 launch failed: CUDA "
                                   f"error {rc}")
            with _count_lock:
                nw_batch.launches += 1
                nw_batch.launches_by_body[body(r)] += 1
        return b.outs


nw_batch.launches = 0
nw_batch.launches_by_body = {"register": 0, "wide": 0, "block": 0}
_count_lock = threading.Lock()


# ---- the plain PyTorch version ---------------------------------------------

def _lo(d, len2, rband):
    return torch.clamp_min(torch.maximum(d - len2, (d - rband + 1) // 2), 0)


def nw_batch_ref(s1b, len1b, s2b, len2b, *, match, mismatch, gap_p,
                 end_gap_p=0, band=-1, mode="vec", homo_gap_p=None,
                 homo1b=None, homo2b=None, device=None, geometry=None):
    """The plain PyTorch version of kernel B4, on the inputs' device (the
    tensors', else `device`): nw_batch's arguments and outputs. What
    nw_batch runs on CPU tensors; on the card it is the kernel's yardstick.
    Chunks keep its [chunk, nd, W] pointers and per-diagonal [chunk, W]
    tensors under MAX_BYTES."""
    return _plain(_prepare(s1b, len1b, s2b, len2b, match, mismatch, gap_p,
                           end_gap_p, band, mode, homo_gap_p, homo1b, homo2b,
                           device, geometry))


def _plain(b: _Batch):
    n = b.ins[0].shape[0]
    chunk = max(1, MAX_BYTES // max(1, b.nd * b.W + 32 * 8 * b.W))
    for c0 in range(0, n, chunk):
        sl = slice(c0, min(c0 + chunk, n))
        got = _plain_chunk(*(x[sl] if x is not None else None
                             for x in b.ins), nd=b.nd, W=b.W, mode=b.mode,
                           **b.scal)
        for o, g in zip(b.outs, got):
            o[sl] = g
    return b.outs


def _plain_chunk(s1, len1, s2, len2, h1, h2, *, nd: int, W: int,
                 match: int, mismatch: int, gap_p: int, end_gap_p: int,
                 band: int, mode: str, homo_gap_p: int):
    """dada2_tpu's `_fill_kernel` scan and `vmap` written out as a loop
    over anti-diagonals with the batch as a tensor dimension ([n, W]
    windows), then the traceback as a loop over steps and the derived
    ham/tvec. s1 [n, L1] / s2 [n, L2] int8 codes, len1/len2 [n], h1/h2
    [n, L] bool homopolymer masks or None. A traceback that reaches a cell
    outside the window stops there (ok false), as the kernel's does."""
    dev = s1.device
    i64, i32 = torch.int64, torch.int32
    n, L1 = s1.shape
    L2 = s2.shape[1]
    # scores in int32, as the JAX scan carries them; indices in int64
    l1 = len1.to(i64)[:, None]
    l2 = len2.to(i64)[:, None]
    if band < 0:
        lband, rband = l1, l2
    else:
        lband = band + (l1 - l2).clamp_min(0)
        rband = band + (l2 - l1).clamp_min(0)
    scalar = mode == "scalar"
    OOB = OOB_BANDED_SCALAR if (scalar and band >= 0) else NEG
    endsfree = end_gap_p > gap_p
    scalar_endsfree = end_gap_p != gap_p
    j_first = torch.where(lband < l1, l1 - lband, 0)
    i_first = torch.where(rband < l2, l2 - rband, 0)
    r = torch.arange(W, device=dev)[None, :]
    c1all = s1.to(i32)
    c2all = s2.to(i32)
    match_t, mismatch_t, gap_t, homo_t = (
        torch.tensor(v, dtype=i32, device=dev)
        for v in (match, mismatch, gap_p, homo_gap_p))
    prev1 = torch.full((n, W), OOB, dtype=i32, device=dev)
    prev1[:, 0] = 0                      # diagonal 0: cell (0, 0)
    prev2 = torch.full((n, W), OOB, dtype=i32, device=dev)
    pad = torch.full((n, 2), OOB, dtype=i32, device=dev)
    lo1 = torch.zeros((n, 1), dtype=i64, device=dev)
    lo2 = torch.zeros((n, 1), dtype=i64, device=dev)
    ptrs = torch.zeros((nd, n, W), dtype=torch.int8, device=dev)
    for d in range(1, nd):
        lod = _lo(d, l2, rband)
        hid = torch.minimum(torch.clamp_max(l1, d), (d + lband) // 2)
        i = lod + r
        j = d - i
        i_i32, j_i32 = i.to(i32), j.to(i32)
        valid = r <= hid - lod
        p1pad = torch.cat([pad, prev1, pad], 1)
        p2pad = torch.cat([pad, prev2, pad], 1)
        # the windows' origin moves by 0 or 1 per diagonal, so these
        # slices never leave the padded rows (dynamic_slice needs no clamp)
        Uraw = torch.gather(p1pad, 1, lod - lo1 + 1 + r)
        Lraw = torch.gather(p1pad, 1, lod - lo1 + 2 + r)
        Dp = torch.gather(p2pad, 1, lod - lo2 + 1 + r)
        c1 = torch.gather(c1all, 1, (i - 1).clamp(0, L1 - 1))
        c2 = torch.gather(c2all, 1, (j - 1).clamp(0, L2 - 1))
        D = Dp + torch.where(c1 == c2, match_t, mismatch_t)
        if scalar:
            if h1 is not None:
                hh1 = torch.gather(h1, 1, (i - 1).clamp(0, L1 - 1))
                hh2 = torch.gather(h2, 1, (j - 1).clamp(0, L2 - 1))
                ugap_in = torch.where(hh1, homo_t, gap_t)
                lgap_in = torch.where(hh2, homo_t, gap_t)
            else:
                ugap_in = lgap_in = gap_t
            Ugap = torch.where(scalar_endsfree & (j == l2), 0, ugap_in)
            Lgap = torch.where(scalar_endsfree & (i == l1), 0, lgap_in)
            U = Uraw + Ugap
            Lv = Lraw + Lgap
            upw = (U >= D) & (U >= Lv)
            leftw = ~upw & (Lv >= D)
            entry = torch.where(upw, U, torch.where(leftw, Lv, D))
            ptr = torch.where(upw, PTR_UP,
                              torch.where(leftw, PTR_LEFT, PTR_DIAG))
            bval = 0 if scalar_endsfree else gap_p
            entry = torch.where(j == 0, i_i32 * bval, entry)
            ptr = torch.where(j == 0, PTR_UP, ptr)
            entry = torch.where(i == 0, j_i32 * bval, entry)
            ptr = torch.where(i == 0, PTR_LEFT, ptr)
        else:
            U = Uraw + gap_p
            Lv = Lraw + gap_p
            ge = U >= Lv
            entry = torch.where(ge, U, Lv)
            ptr = torch.where(ge, PTR_UP, PTR_LEFT)
            dwin = D > entry
            entry = torch.where(dwin, D, entry)
            ptr = torch.where(dwin, PTR_DIAG, ptr)
            entry = torch.where(j == 0, i_i32 * end_gap_p, entry)
            ptr = torch.where(j == 0, PTR_UP, ptr)
            entry = torch.where(i == 0, j_i32 * end_gap_p, entry)
            ptr = torch.where(i == 0, PTR_LEFT, ptr)
            if endsfree:
                # last-row free left gap (one diagonal late): the cell's
                # own left neighbour plus end_gap_p
                lastrow = (i == l1) & (j > j_first) & (j > 0) & (i > 0)
                candr = Lraw + end_gap_p
                rgt = lastrow & (candr > entry)
                rtie = lastrow & (candr == entry) & (ptr == PTR_DIAG)
                entry = torch.where(rgt, candr, entry)
                ptr = torch.where(rgt | rtie, PTR_LEFT, ptr)
                # last-column free up gap, after the row rule
                lastcol = (j == l2) & (i > i_first) & (i > 0) & (j > 0)
                candc = Uraw + end_gap_p
                cgt = lastcol & (candc > entry)
                ctie = lastcol & (candc == entry) & (ptr != PTR_UP)
                entry = torch.where(cgt, candc, entry)
                ptr = torch.where(cgt | ctie, PTR_UP, ptr)
        prev2 = prev1
        prev1 = torch.where(valid, entry, OOB).to(i32)
        ptrs[d] = torch.where(valid, ptr, PTR_NONE).to(torch.int8)
        lo2, lo1 = lo1, lod

    # traceback from (len1, len2): one step per loop for every pair; a
    # pair that is done (or stuck) repeats its position with kind 0
    nsteps = L1 + L2
    pid = torch.arange(n, device=dev)
    i = l1[:, 0].clone()
    j = l2[:, 0].clone()
    rb = rband[:, 0]
    l2v = l2[:, 0]
    kinds = torch.zeros((n, nsteps), dtype=torch.int8, device=dev)
    p0 = torch.zeros((n, nsteps), dtype=torch.int32, device=dev)
    p1 = torch.zeros((n, nsteps), dtype=torch.int32, device=dev)
    t = 0
    while t < nsteps:
        d = i + j
        rr = i - _lo(d, l2v, rb)
        inw = (rr >= 0) & (rr < W)
        ptr = ptrs[d.clamp(0, nd - 1), pid, rr.clamp(0, W - 1)].to(i64)
        ptr = torch.where(inw & (d > 0), ptr, PTR_NONE)
        if not bool((ptr != PTR_NONE).any()):
            break
        i = i - ((ptr == PTR_DIAG) | (ptr == PTR_UP)).to(i64)
        j = j - ((ptr == PTR_DIAG) | (ptr == PTR_LEFT)).to(i64)
        kinds[:, t] = ptr.to(torch.int8)
        p0[:, t] = i.to(torch.int32)
        p1[:, t] = j.to(torch.int32)
        t += 1
    # every pair has stopped: the remaining steps repeat its position
    p0[:, t:] = i.to(torch.int32)[:, None]
    p1[:, t:] = j.to(torch.int32)[:, None]

    # derived per-pair outputs: hamming count and the transition vector
    diag = kinds == PTR_DIAG
    nt0 = torch.gather(c1all, 1, p0.to(i64).clamp(0, L1 - 1))
    nt1 = torch.gather(c2all, 1, p1.to(i64).clamp(0, L2 - 1))
    ham = (diag & (nt0 != nt1)).sum(1).to(i32)
    pos = torch.arange(L2, device=dev)[None, :]
    tv = torch.where(pos < l2, 5 * c2all, 16)
    # non-diagonal steps land in a spare column L2, which is cut off (the
    # JAX scatter drops them with mode="drop")
    tv = torch.cat([tv, torch.zeros_like(tv[:, :1])], 1)
    tv.scatter_(1, torch.where(diag, p1.to(i64), L2),
                torch.where(diag, 4 * nt0 + nt1, 0))
    tvec = tv[:, :L2].to(torch.int8)
    ok = (i == 0) & (j == 0)
    return kinds, p0, p1, ham, tvec, ok
