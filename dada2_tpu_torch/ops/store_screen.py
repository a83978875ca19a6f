"""Kernel B5: the budded compare, small pack to shortlist buffer, in one
launch.

The counterpart of dada2_tpu/core/backend_tpu.py's `_budded_fused`
(:520), the device half of a budded compare: the small pack
`_small_trace` (:341), `_shortlist_screen` (:779), the ascending
compactions and the substitution transport `_subs_tile_trace` (:410) /
`_subs_bits_trace` (:426) over `_sel_tv` (:386), plus the overflow
follow-up `_take_subs` (:640). In the JAX package these are XLA
programs; here they are one hand-written CUDA source,
csrc/store_screen.cu, built with nvcc at first use and loaded through
ctypes like kernel B1.

`budded_pack` sums each row's f32 log-lambda screen (the small pack,
unless the caller passes small13), screens every row of a compare sweep
against the engine's store threshold, compacts the survivors in
ascending row order and writes, for the first M0 (cache mode: M0U
uncached) of them, their 5-byte small rows and substitution records
into ONE buffer that the host fetches once. Its layout is the JAX
package's, byte for byte (`budbuf_layout`):

    [16 B header: m, naligned, nshroud, m_u | nd/8 need bitmap |
     MU x 5 B rows | MU x subw B substitutions | nd/8 shroud bitmap]

Rows are the backend's nd = pad_rows(n): rows n..nd-1 repeat row 0 and
travel locked, as the JAX package's padded device arrays do, so the
bitmaps' offsets and every byte match. Bitmaps are little-endian.

The small pack's f32 sums are taken in the kernel's order, defined by
`small_pack_ref` (lane-strided sums over 32 lanes, then an xor
butterfly), not XLA's: they are a screen, and its margin covers any
order. Every byte after them is the JAX package's.

A speculative segment's launch takes the projected E_minmax (`proj`, f32
[nd]; `_shortlist_screen`'s proj branch, :829), and a launch whose
compare the chain assumes folds itself into it (`proj_out`, `logtotal`:
`_proj_update`, :465, as an epilogue of the same launch,
`proj_update_ref`); `out` lets the segments of one dispatch write into
one buffer. The screen's and the projection's f32 logs are `log_f32`,
XLA's CPU log, so that their bits are the JAX package's.

`full_pack` is the full compare's one-fetch transport (the JAX
package's `_full_fused`, :578): every row's 5-byte small row, the need
bitmap of its optional store screen, and the substitution tiles of the
first M0 rows that need an exact lambda and are not gapless, compacted in
ascending row order (`fullbuf_layout`):

    [16 B header: m, 0, 0, 0 | nd x 5 B rows | nd/8 need bitmap |
     M0 x i32 row indices | M0 x 2K B substitution tiles]

`gather_subs` is the tile pack over an explicit row list (`_gather_subs`,
:659), and `gather_tvec_packed` the 4-bit dense row fetch
(`_gather_tvec_packed`, :886; torch ops, no kernel of its own).

On CUDA tensors the wrappers launch the kernels (one cooperative launch
for `budded_pack` and one for `full_pack`, one for `take_subs`, one for
`gather_subs`, one for the full route's `small_pack`) and count one
launch per call in `launches`; on CPU tensors they run the plain versions
below (`small_pack_ref`, `budded_pack_ref`, `take_subs_ref`,
`full_pack_ref`, `gather_subs_ref`), the JAX functions written in torch
ops. There is no fallback between the two. The small rows the follow-up,
the full mode and the gather mode read are small13 or small5 (an
unscreened full compare never sums a small pack): 5 bytes a row are its
ham, ham_gapless and, last, its flags.
"""
from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

import numpy as np
import torch

from . import nw_wavefront as nww

EPS = 2.0 ** -23
FLT_MIN = float(np.finfo(np.float32).tiny)
_LN2 = 0.6931471805599453
KINDS = ("tiles", "bits")
# the bits transport's widest K (the budded kernel's phase 3 keeps a warp's
# nt0 stream in 64 words of shared memory)
BITS_K_MAX = 1024

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "store_screen.cu")
_SO = os.path.join(_PKG, "build", "libstore_screen.so")
_PTXAS_LOG = os.path.join(_PKG, "build", "store_screen.ptxas.txt")
_lock = threading.Lock()
_count_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


# ---- geometry (copies of the JAX package's) --------------------------------

def bucket(n: int, lo: int = 16) -> int:
    return max(lo, 1 << (max(n, 1) - 1).bit_length())


def bucket15(n: int, lo: int = 16) -> int:
    """Fetch-size bucket with 1.5x steps (16, 24, 32, 48, 64, ...)."""
    b = bucket(n, lo)
    b34 = (3 * b) // 4
    return b34 if b34 >= n else b


def pad_rows(n: int) -> int:
    """The JAX backend's row-count bucket (backend_tpu._pad_rows): n
    rounded up in ~1/8 steps, always a multiple of 8. The port keeps its
    tensors at n rows; B5 treats rows n..nd-1 as the JAX package's pad
    rows (copies of row 0, locked), so its buffer is the JAX package's."""
    if n <= 128:
        return bucket(n, 16)
    q = 1 << max(7, n.bit_length() - 4)
    return ((n + q - 1) // q) * q


def subw(W: int, K: int, kind: str) -> int:
    """Bytes of one row's substitution records: K 2-byte tile entries, or
    the ceil(W/8)-byte position bitmap plus the K/4-byte nt0 stream."""
    return (W + 7) // 8 + K // 4 if kind == "bits" else 2 * K


def budbuf_layout(nd: int, W: int, M0: int, K: int, kind: str,
                  M0U: Optional[int] = None):
    """Offsets inside one budded_pack buffer: (end of the need bitmap, end
    of the 5 B rows, end of the substitution records, total length incl.
    the shroud bitmap); the per-row blocks cover MU = M0U rows in cache
    mode, else M0 (backend_tpu.TpuBackend._budbuf_layout)."""
    nb = nd // 8
    mu = M0U if M0U is not None else M0
    o1 = 16 + nb
    o2 = o1 + 5 * mu
    o3 = o2 + subw(W, K, kind) * mu
    return o1, o2, o3, o3 + nb


# ---- the plain versions -----------------------------------------------------

def _src(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Row n.. (a pad row) reads row 0, as the JAX package's padding."""
    return torch.where(idx < n, idx, torch.zeros_like(idx))


def _unpack(pk: torch.Tensor, count: int) -> torch.Tensor:
    """Little-endian bitmap bytes -> bool [count]."""
    sh = torch.arange(8, device=pk.device, dtype=torch.int32)
    bits = (pk.to(torch.int32)[:, None] >> sh[None, :]) & 1
    return bits.reshape(-1)[:count] != 0


def _pack(b: torch.Tensor) -> torch.Tensor:
    """bool [8k] -> little-endian bitmap bytes uint8 [k]."""
    w = 1 << torch.arange(8, device=b.device, dtype=torch.int32)
    return (b.to(torch.int32).reshape(-1, 8) * w).sum(dim=1).to(torch.uint8)


def _f32(x, dev) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=dev)


def _flush(x: torch.Tensor) -> torch.Tensor:
    """Subnormal float32 values as zero, as XLA computes (its CPU and the
    TPU flush them): the JAX package's screen reads a subnormal e_thresh
    as 0, the underflow branch."""
    return torch.where(x.abs() < FLT_MIN, torch.zeros_like(x), x)


def _fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 a * b + c with one rounding (the card's __fmaf_rn): the product
    is exact in float64, the sum is rounded to odd there (TwoSum gives
    its error; an inexact even result steps one ulp toward it), and
    53 >= 24 + 2 bits make the final rounding to f32 correct."""
    p = a.to(torch.float64) * b.to(torch.float64)
    c64 = c.to(torch.float64)
    s = p + c64
    bb = s - p
    e = (p - (s - bb)) + (c64 - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(e > 0, torch.full_like(s, np.inf),
                         torch.full_like(s, -np.inf))
    s = torch.where((e != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


# the Cephes coefficients of log(1 + x) on [sqrt(1/2) - 1, sqrt(2) - 1]
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)


def log_f32(x: torch.Tensor) -> torch.Tensor:
    """The f32 natural log that the JAX package's projection takes on XLA's
    CPU backend: Cephes' polynomial with its multiply-adds fused, the
    exponent split at sqrt(1/2), subnormal inputs read as zero; 0 gives
    -inf, +inf gives +inf, negatives and NaN give NaN. It is not
    correctly rounded (about 1% of integers come out one ulp off), so
    this copy keeps the projection's bits the JAX package's; the
    projection's margin covers either. The kernel's log_f32 evaluates the
    same operations (store_screen.cu)."""
    x = _flush(x.to(torch.float32))
    dev = x.device

    def c(v):
        return _f32(v, dev)

    one, half = c(1.0), c(0.5)
    bits = torch.maximum(x, c(FLT_MIN)).view(torch.int32)
    e = one + ((bits >> 23) - 0x7F).to(torch.float32)
    m = ((bits & -0x7F800001) | 0x3F000000).view(torch.float32)
    low = m < c(0.707106781186547524)
    xm = (m - one) + torch.where(low, m, c(0.0))
    e = e - torch.where(low, one, c(0.0))
    x2 = xm * xm
    x3 = x2 * xm
    p = [c(v) for v in _LOG_P]
    y = _fma32(_fma32(xm, p[0], p[1]), xm, p[2])
    y1 = _fma32(_fma32(xm, p[3], p[4]), xm, p[5])
    y2 = _fma32(_fma32(xm, p[6], p[7]), xm, p[8])
    y = _fma32(_fma32(y, x3, y1), x3, y2)
    y = _fma32(y, x3, c(-2.12194440e-4) * e)
    r = (xm - half * x2) + y
    r = r + c(0.693359375) * e
    r = torch.where(x == 0, c(-np.inf), r)
    r = torch.where(x == np.inf, c(np.inf), r)
    return torch.where((x < 0) | torch.isnan(x), c(np.nan), r)


def _lane_sum(x: torch.Tensor) -> torch.Tensor:
    """Row sums of x [n, W] f32 in the kernel's order: lane l (of 32)
    adds positions l, l + 32, ... left to right from 0.0, then five xor
    steps v = v + v[lane ^ off] (off 16, 8, 4, 2, 1) combine the lanes.
    Bitwise reproducible: every add is one f32 rounding."""
    n, W = x.shape
    Wp = -(-W // 32) * 32
    x3 = torch.nn.functional.pad(x, (0, Wp - W)).reshape(n, Wp // 32, 32)
    acc = torch.zeros((n, 32), dtype=torch.float32, device=x.device)
    for j in range(Wp // 32):
        acc = acc + x3[:, j]
    lane = torch.arange(32, device=x.device)
    for off in (16, 8, 4, 2, 1):
        acc = acc + acc[:, lane ^ off]
    return acc[:, 0]


def small_pack_ref(tvec, seqs, lens, quals, center: int, lerr, small5):
    """Plain version of B5's small pack (backend_tpu._small_trace): each
    row's f32 log-lambda and |log-factor| sums, the screen of the exact
    host float64 product (reference: src/pval.cpp:144-197), over the
    transitions its gapless flag (small5[:, 4] & 2) picks: the
    pad-to-length construction against the center, else kernel B1's
    tvec. lerr [17, Q] f32 holds log(err) with row 16 = 0 (the pad
    transition); each factor is lerr[t, q], 0 where q >= Q or past the
    row's length (quals None: q = 0). The sums run in the kernel's order
    (_lane_sum), not XLA's; the screen's margin
    (TpuBackend._screen_need) covers any order, and exact lambdas always
    come from the host.

    Returns small13 [n, 13] int8: ham i16, ham_gapless i16, loglam f32,
    abssum f32, flags u8."""
    n, W = seqs.shape
    dev = seqs.device
    pos = torch.arange(W, device=dev)[None, :]
    valid = pos < lens[:, None]
    s2 = seqs.to(torch.int64)
    s0 = s2[center][None, :]
    subg = valid & (pos < lens[center]) & (s0 != s2)
    t_gl = torch.where(subg, 4 * s0 + s2, 5 * s2)
    glr = (small5[:, 4] & 2) != 0
    t = torch.where(glr[:, None], t_gl, tvec.to(torch.int64))
    t = torch.where(valid, t, 16)
    Q = lerr.shape[1]
    q = (quals.to(torch.int64) if quals is not None
         else torch.zeros_like(s2))
    lf = torch.where((q < Q) & valid, lerr[t, q.clamp(max=Q - 1)],
                     _f32(0.0, dev))

    def f32col(x):
        return x[:, None].view(torch.int8)

    return torch.cat([small5[:, :4], f32col(_lane_sum(lf)),
                      f32col(_lane_sum(lf.abs())), small5[:, 4:5]], dim=1)


def sel_tv(tvec, seqs, lens, center: int, flags, idx):
    """Final transition vector and substitution mask of rows idx (int64
    [M] into the n-row tensors): the gapless flag bit picks the
    pad-to-length construction over kernel B1's tvec
    (backend_tpu._sel_tv; reference: src/pval.cpp:104-130)."""
    W = seqs.shape[1]
    dev = seqs.device
    s0 = seqs[center].to(torch.int32)
    s1 = seqs[idx].to(torch.int32)
    l2 = lens[idx]
    l1 = lens[center]
    pos = torch.arange(W, device=dev)[None, :]
    validp = pos < l2[:, None]
    gtv = torch.where(validp, 5 * s1, 16)
    gtv = torch.where((pos < torch.minimum(l2, l1)[:, None])
                      & (s0[None, :] != s1), 4 * s0[None, :] + s1, gtv)
    gl = (flags[idx] & 2) != 0
    tv = torch.where(gl[:, None], gtv, tvec[idx].to(torch.int32))
    is_sub = validp & (tv != 5 * s1)
    return tv, is_sub


def _first_subs(tv, is_sub, K: int):
    """Positions, codes and validity of each row's first K entries of the
    stable order (substitutions first, ascending position)."""
    order2 = torch.argsort((~is_sub).to(torch.uint8), dim=1, stable=True)
    posK = order2[:, :K]
    return (posK.to(torch.int32), torch.gather(tv, 1, posK),
            torch.gather(is_sub, 1, posK))


def subs_tiles(tvec, seqs, lens, center: int, flags, idx, K: int):
    """[M, K] int32 substitution tile entries pos | nt0 << 14 in
    ascending position order, 0xFFFF past a row's count
    (backend_tpu._subs_tile_trace; its uint16 values)."""
    tv, is_sub = sel_tv(tvec, seqs, lens, center, flags, idx)
    posK, codeK, subK = _first_subs(tv, is_sub, K)
    return torch.where(subK, posK | ((codeK >> 2) << 14), 0xFFFF)


def subs_bits(tvec, seqs, lens, center: int, flags, idx, K: int):
    """[M, ceil(W/8) + K/4] uint8: each row's little-endian substitution
    position bitmap, then the 2-bit nt0 stream of its first K
    substitutions (backend_tpu._subs_bits_trace)."""
    W = seqs.shape[1]
    tv, is_sub = sel_tv(tvec, seqs, lens, center, flags, idx)
    M = is_sub.shape[0]
    W8 = ((W + 7) // 8) * 8
    bm = torch.zeros((M, W8), dtype=torch.bool, device=seqs.device)
    bm[:, :W] = is_sub
    bitmap = _pack(bm).reshape(M, W8 // 8)
    Ke = min(K, W)
    _, codeK, subK = _first_subs(tv, is_sub, Ke)
    nt0 = torch.where(subK, (codeK >> 2) & 3, 0)
    if Ke < K:
        nt0 = torch.nn.functional.pad(nt0, (0, K - Ke))
    w = 1 << (2 * torch.arange(4, device=seqs.device, dtype=torch.int32))
    stream = (nt0.reshape(M, K // 4, 4) * w).sum(dim=2).to(torch.uint8)
    return torch.cat([bitmap, stream], dim=1)


def _subs_bytes(tvec, seqs, lens, center, flags, idx, K, kind):
    """A row's substitution records as the buffer's bytes [M, subw]."""
    if kind == "bits":
        return subs_bits(tvec, seqs, lens, center, flags, idx, K)
    v = subs_tiles(tvec, seqs, lens, center, flags, idx, K)
    return torch.stack([v & 0xFF, v >> 8], dim=2).to(torch.uint8).reshape(
        v.shape[0], 2 * K)


def _nskip(eth2, reads, center: int, *, nd: int, n: int, greedy: bool):
    """Each of the nd rows' skip: its lock bit (eth2's bitmap after the 2
    nd threshold bytes) and, under greedy, the abundance skip reads >
    reads[center], never the center itself."""
    r = torch.arange(nd, device=eth2.device)
    nskip = _unpack(eth2[2 * nd:], nd)
    if greedy:
        nskip = nskip | (reads[_src(r, n)] > reads[center])
        nskip = nskip & (r != center)
    return nskip


def _small_f32(small13, nd: int):
    """(loglam, abssum, flags) of each of the nd rows' small13 row (rows n..
    read row 0), the f32 sums read with subnormals as zero."""
    sm = small13[_src(torch.arange(nd, device=small13.device),
                      small13.shape[0])]
    f32 = sm[:, 4:12].contiguous().view(torch.float32)
    return _flush(f32[:, 0]), _flush(f32[:, 1]), sm[:, 12]


def _margin(abssum, L: int):
    """The f32 error bound of a row's loglam: 1e-3 + eps (5 L + (L + 5)
    abssum), in the JAX package's order."""
    dev = abssum.device
    return _f32(1e-3, dev) + _f32(EPS, dev) * (
        _f32(5.0 * L, dev) + _f32(L + 5.0, dev) * abssum)


def proj_update_ref(proj, small13, reads, center: int, logtotal: float,
                    eth2, *, nd: int, L: int, greedy: bool):
    """Plain version of B5's projection fold (backend_tpu._proj_update):
    after the compare of `center`, each row's E_minmax is at least lambda
    * reads[center] if the compare processes the row (reference:
    src/cluster.cpp:179-201), so max(proj, log(lambda reads[center] /
    total)) per row stays a lower bound of log(E_minmax / total), the
    store threshold a later segment screens with. A row's term is its
    f32 loglam lowered by its margin plus lr = log(reads[center]) -
    logtotal lowered by 2 eps (|lr| + |logtotal|) + eps; rows the compare
    skips (lock bit, under greedy the abundance skip, the center never
    skipped) or shrouds, and non-finite ones, contribute -inf. Pad rows
    travel locked, so their term is -inf. The f32 arithmetic is the JAX
    package's, in its order, with its log (log_f32); subnormal sums read
    as zero. proj: f32 [nd] or None (-inf); logtotal: the f32 log of the
    sample's total reads. Returns f32 [nd]."""
    n = small13.shape[0]
    dev = small13.device
    loglam, abssum, flags = _small_f32(small13, nd)
    nskip = _nskip(eth2, reads, center, nd=nd, n=n, greedy=greedy)
    shroud = (flags & 4) != 0
    lower = loglam - _margin(abssum, L)
    lt = _f32(logtotal, dev)
    eps = _f32(EPS, dev)
    lr = log_f32(reads[center].to(torch.float32)) - lt
    lr = lr - (_f32(2.0 * EPS, dev) * (lr.abs() + lt.abs()) + eps)
    term = torch.where(torch.isfinite(lower) & ~nskip & ~shroud, lower + lr,
                       _f32(-np.inf, dev))
    return term if proj is None else torch.maximum(proj, term)


def shortlist_screen(small13, eth2, reads, center: int, *, nd: int, L: int,
                     greedy: bool, proj=None):
    """The store screen over all nd rows (backend_tpu._shortlist_screen).
    small13 [n, 13] int8 (ham i16, ham_gapless i16, loglam f32, abssum
    f32, flags); eth2 uint8
    [2 nd + nd/8]: e_thresh as bf16 (the f32 bits shifted right by 16, a
    lower bound of the threshold) and the skip's lock component,
    bit-packed (pad rows locked); reads int32 [n].

    A row is needed iff not skipped, not shrouded and loglam + margin >=
    log(e_thresh), the margin bounding the f32 error of loglam and of the
    f32 log (1e-3 + eps (5 L + (L + 5) abssum) + 4 eps |logthr|); at
    e_thresh == 0 the threshold is the underflow bound
    -(1074 + L) ln 2 - 1, below which the host's f64 product is exactly
    0; e_thresh < 0 keeps every candidate; a non-finite loglam is kept
    unless e_thresh == 0. Under greedy the abundance skip (reads >
    reads[center]) is rebuilt here, the center itself never skipped. The
    f32 arithmetic is the JAX package's on XLA, in its order, subnormal
    inputs and sums read as zero (a subnormal e_thresh takes the
    underflow branch). proj (f32 [nd], optional) is the projected
    log-threshold of a speculative segment (proj_update_ref): every row's
    logthr is raised to it, except the segment's own center, the one row
    whose lock can clear before the segment is consumed.

    Returns (header int32 [4]: m, naligned, nshroud, 0; order int32 [nd],
    the stable compaction needed rows first; shroud bitmap uint8 [nd/8];
    need bool [nd])."""
    n = small13.shape[0]
    dev = small13.device
    r = torch.arange(nd, device=dev)
    e_thresh = _flush(eth2[: 2 * nd].view(torch.bfloat16).to(torch.float32))
    nskip = _nskip(eth2, reads, center, nd=nd, n=n, greedy=greedy)
    loglam, abssum, flags = _small_f32(small13, nd)
    shroud = (flags & 4) != 0
    cand = ~nskip & ~shroud
    pos = e_thresh > 0
    logthr = torch.where(
        pos, log_f32(torch.where(pos, e_thresh, _f32(1.0, dev))),
        _f32(-np.inf, dev))
    if proj is not None:
        logthr = torch.maximum(logthr, torch.where(
            r == center, _f32(-np.inf, dev), proj))
    finthr = torch.isfinite(logthr)
    margin = (_margin(abssum, L)
              + _f32(4.0 * EPS, dev) * torch.where(finthr, logthr.abs(),
                                                   _f32(0.0, dev)))
    und = _f32(-(1074.0 + L) * _LN2 - 1.0, dev)
    logthr2 = torch.where(pos, logthr,
                          torch.where(e_thresh == 0, und, _f32(-np.inf, dev)))
    need = cand & ((_flush(loglam + margin) >= logthr2)
                   | (~torch.isfinite(loglam) & (e_thresh != 0)))
    header = torch.stack([need.sum(), cand.sum(), (shroud & ~nskip).sum(),
                          torch.zeros((), dtype=torch.int64, device=dev)]
                         ).to(torch.int32)
    order = torch.argsort((~need).to(torch.uint8), stable=True).to(
        torch.int32)
    return header, order, _pack(shroud), need


def _rows5(small, src):
    """The 5-byte small rows (ham, ham_gapless, flags) of rows src, from
    small13 or small5 rows."""
    sm = small[src].view(torch.uint8)
    if small.shape[1] == 5:
        return sm
    return torch.cat([sm[:, :4], sm[:, 12:13]], dim=1)


def budded_pack_ref(small13, tvec, seqs, lens, reads, center: int, eth2,
                    cbits=None, *, nd: int, L: int, M0: int, K: int,
                    greedy: bool, kind: str = "tiles",
                    M0U: Optional[int] = None, cache_on: bool = False,
                    small5=None, quals=None, lerr=None, proj=None,
                    proj_out=None, logtotal: Optional[float] = None,
                    out=None):
    """Plain version of kernel B5 (backend_tpu._budded_fused): with
    small13 None the small pack (small_pack_ref of small5, quals, lerr),
    else the given small13; then the screen (raised to the projection
    proj, f32 [nd], where given), the need bitmap, in cache mode (cbits:
    the host's cached-row bitmap, uint8 [nd/8]) the compaction of the
    needed uncached rows with m_u in header[3], and the 5 B rows and
    substitution records of the first MU compacted rows. With proj_out
    (f32 [nd]) and logtotal, this compare is folded into the projection
    too: proj_out = proj_update_ref(proj, ...). out (uint8, the buffer's
    length) receives the buffer, so that segments can share one fetch.
    Returns (buf uint8, order int32 [nd], order_u int32 [nd], small13;
    order_u is order outside cache mode; buf is out where given)."""
    n = seqs.shape[0]
    if small13 is None:
        small13 = small_pack_ref(tvec, seqs, lens, quals, center, lerr,
                                 small5)
    header, order, shroud_pk, need = shortlist_screen(
        small13, eth2, reads, center, nd=nd, L=L, greedy=greedy, proj=proj)
    need_pk = _pack(need)
    if cache_on:
        need_u = need & ~_unpack(cbits, nd)
        order_u = torch.argsort((~need_u).to(torch.uint8), stable=True).to(
            torch.int32)
        header[3] = need_u.sum().to(torch.int32)
    else:
        order_u = order
    src = _src(order_u[: M0U if cache_on else M0].to(torch.int64), n)
    subs = _subs_bytes(tvec, seqs, lens, center, small13[:, 12], src, K,
                       kind)
    buf = torch.cat([header.view(torch.uint8), need_pk,
                     _rows5(small13, src).reshape(-1), subs.reshape(-1),
                     shroud_pk])
    if proj_out is not None:
        proj_out.copy_(proj_update_ref(proj, small13, reads, center,
                                       logtotal, eth2, nd=nd, L=L,
                                       greedy=greedy))
    if out is not None:
        out.copy_(buf)
        buf = out
    return buf, order, order_u, small13


def take_subs_ref(small, tvec, seqs, lens, center: int, order, *,
                  M0: int, M: int, K: int, kind: str = "tiles"):
    """Plain version of the follow-up (backend_tpu._take_subs): the 5 B
    rows, then the substitution records, of compacted rows
    [M0, M0 + M). small is small13 or small5."""
    n = small.shape[0]
    src = _src(order[M0: M0 + M].to(torch.int64), n)
    subs = _subs_bytes(tvec, seqs, lens, center, small[:, -1], src, K,
                       kind)
    return torch.cat([_rows5(small, src).reshape(-1), subs.reshape(-1)])


def fullbuf_layout(nd: int, M0: int, K: int):
    """Offsets inside one full_pack buffer: (end of the 5 B rows, end of
    the need bitmap, end of the row indices, total length)
    (backend_tpu._full_finish's o1..o4)."""
    o1 = 16 + 5 * nd
    o2 = o1 + nd // 8
    o3 = o2 + 4 * M0
    return o1, o2, o3, o3 + 2 * K * M0


def full_screen(small13, eth2, *, nd: int, L: int):
    """The full compare's store screen over all nd rows (the screen of
    backend_tpu._full_fused): a row is needed iff loglam + margin >=
    log(e_thresh) or its loglam is not finite, the margin 1e-3 + eps (5 L
    + (L + 5) abssum) + 4 eps |logthr|; e_thresh <= 0 keeps the row. No
    skip, shroud or underflow rule: the host applies the caller's. eth2
    is uint8 [2 nd + nd/8]: e_thresh as bf16, then the pad bitmap. The
    f32 arithmetic is the JAX package's, subnormals read as zero.
    Returns need bool [nd]."""
    dev = small13.device
    e_thresh = _flush(eth2[: 2 * nd].view(torch.bfloat16).to(torch.float32))
    loglam, abssum, _ = _small_f32(small13, nd)
    pos = e_thresh > 0
    logthr = torch.where(
        pos, log_f32(torch.where(pos, e_thresh, _f32(1.0, dev))),
        _f32(-np.inf, dev))
    margin = (_margin(abssum, L)
              + _f32(4.0 * EPS, dev) * torch.where(pos, logthr.abs(),
                                                   _f32(0.0, dev)))
    return ((_flush(loglam + margin) >= logthr)
            | ~torch.isfinite(loglam))


def full_pack_ref(small, tvec, seqs, lens, center: int, eth2, *, nd: int,
                  L: int, M0: int, K: int, screened: bool):
    """Plain version of B5's full mode (backend_tpu._full_fused): over nd
    rows (rows n.. read row 0), need = the store screen (screened: small
    is small13 and eth2 uint8 [2 nd + nd/8], e_thresh as bf16 then the
    pad bitmap) or every row (eth2 the pad bitmap, uint8 [nd/8]; small is
    small5 or small13); sel = need & ~gapless & ~pad; the stable
    ascending compaction order (selected rows first, then the others,
    both ascending) and the buffer of fullbuf_layout: header [m = |sel|,
    0, 0, 0], every row's 5 B row, the need bitmap, order[:M0] as int32
    and the substitution tiles (K entries) of those rows, unselected ones
    included where m < M0. Returns (buf uint8, order int32 [nd])."""
    n = seqs.shape[0]
    dev = seqs.device
    src = _src(torch.arange(nd, device=dev), n)
    gl = (small[src, -1] & 2) != 0
    pad = _unpack(eth2[2 * nd:] if screened else eth2, nd)
    need = (full_screen(small, eth2, nd=nd, L=L) if screened
            else torch.ones(nd, dtype=torch.bool, device=dev))
    sel = need & ~gl & ~pad
    order = torch.argsort((~sel).to(torch.uint8), stable=True).to(
        torch.int32)
    idx = order[:M0]
    subs = _subs_bytes(tvec, seqs, lens, center, small[:, -1],
                       _src(idx.to(torch.int64), n), K, "tiles")
    header = torch.zeros(4, dtype=torch.int32, device=dev)
    header[0] = sel.sum().to(torch.int32)
    buf = torch.cat([header.view(torch.uint8),
                     _rows5(small, src).reshape(-1), _pack(need),
                     idx.contiguous().view(torch.uint8), subs.reshape(-1)])
    return buf, order


def gather_subs_ref(tvec, seqs, lens, center: int, flags, idx, *, K: int):
    """Plain version of B5's gather mode (backend_tpu._gather_subs): the
    substitution tiles of rows idx (int [M] into the n rows) as bytes
    uint8 [M, 2K], K uint16 entries a row (pos | nt0 << 14 ascending,
    0xFFFF after the row's substitutions)."""
    return _subs_bytes(tvec, seqs, lens, center, flags,
                       _src(idx.to(torch.int64), seqs.shape[0]), K, "tiles")


def gather_tvec_packed(tvec, idx):
    """Rows idx of tvec, 4-bit packed: two transition codes a byte, the
    even position in the low nibble (backend_tpu._gather_tvec_packed);
    the pad code 16 becomes 0, so the host masks by length. Torch ops on
    either device. Returns uint8 [M, ceil(W/2)]."""
    rows = tvec[idx.to(torch.int64)].to(torch.uint8) & 15
    if rows.shape[1] % 2:
        rows = torch.nn.functional.pad(rows, (0, 1))
    return rows[:, 0::2] | (rows[:, 1::2] << 4)


# ---- build, load and launch --------------------------------------------------

def build_kernel() -> str:
    """Build csrc/store_screen.cu and return its `-Xptxas -v` report."""
    return nww.build_library(_SRC, _SO, _PTXAS_LOG)


def _load():
    global _lib
    if _lib is not None:
        return _lib
    build_kernel()
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(_SO)
            V, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.store_screen_run.restype = I
            lib.store_screen_run.argtypes = (
                [V] * 15 + [I] * 14 + [F] * 4 + [V, I, V])
            lib.store_screen_small.restype = I
            lib.store_screen_small.argtypes = [V] * 7 + [I] * 4 + [V]
            lib.store_screen_take.restype = I
            lib.store_screen_take.argtypes = [V] * 5 + [I] * 8 + [V] * 2 + [V]
            lib.store_screen_full.restype = I
            lib.store_screen_full.argtypes = (
                [V] * 7 + [I] * 11 + [F] * 2 + [V, I, V])
            _lib = lib
    return _lib


# the largest Q whose [17, Q] f32 table fits the kernels' shared memory
Q_MAX = 512
# a block count's ceiling for the per-block counts workspace: 32 resident
# blocks per SM is the card's limit, so a cooperative grid never exceeds it
_BLOCKS_PER_SM_MAX = 32
_ws: dict = {}


def _workspace(dev, stream) -> torch.Tensor:
    """B5's per-block counts (int4 a block), one per device and stream:
    launches on one stream are ordered, so they can share it."""
    key = (dev.index, stream)
    ws = _ws.get(key)
    if ws is None:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        ws = torch.empty(4 * _BLOCKS_PER_SM_MAX * sms, dtype=torch.int32,
                         device=dev)
        _ws[key] = ws
    return ws


def _want(**named):
    """Raise unless each name's (tensor, shape, dtype) matches and the
    tensor is contiguous on the first one's device."""
    dev = None
    for name, (x, shape, dtype) in named.items():
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(f"{name} is {x.dtype} {tuple(x.shape)}, "
                             f"expected {dtype} {shape}")
        dev = x.device if dev is None else dev
        if not x.is_contiguous() or x.device != dev:
            raise ValueError(f"{name} must be contiguous on {dev}")


def _check(small13, tvec, seqs, lens, center, K, kind, widths=(13,)):
    """The inputs every mode reads; small13's row width one of widths
    (13, or 5 where small5 rows are taken)."""
    n, W = seqs.shape
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    if small13 is not None and (small13.dim() != 2
                                or small13.shape[1] not in widths):
        raise ValueError(f"small rows of width {tuple(small13.shape)[1:]}, "
                         f"expected one of {widths}")
    _want(seqs=(seqs, (n, W), torch.int8), tvec=(tvec, (n, W), torch.int8),
          lens=(lens, (n,), torch.int64),
          **({} if small13 is None else
             {"small13": (small13, (n, small13.shape[1]), torch.int8)}))
    if not 0 <= center < n:
        raise ValueError(f"center {center} outside [0, {n})")
    if kind == "tiles" and not 0 < K <= W:
        raise ValueError(f"a tile holds 1..W={W} entries, not K={K}")
    if kind == "bits" and (K <= 0 or K % 4 or K > BITS_K_MAX):
        raise ValueError(f"the bits stream needs 0 < K <= {BITS_K_MAX}, "
                         f"K % 4 == 0, not K={K}")


def _check_small_in(seqs, quals, lerr, small5):
    """The small pack's inputs (on the card): small5 int8 [n, 5], quals
    uint8 [n, W] or None, lerr f32 [17, Q] with 1 <= Q <= Q_MAX."""
    n, W = seqs.shape
    if lerr is None or small5 is None:
        raise ValueError("the small pack needs small5 and lerr")
    Q = lerr.shape[-1]
    if not 1 <= Q <= Q_MAX:
        raise ValueError(f"lerr has Q={Q} columns, outside [1, {Q_MAX}]")
    _want(seqs=(seqs, (n, W), torch.int8),
          small5=(small5, (n, 5), torch.int8),
          lerr=(lerr, (17, Q), torch.float32),
          **({} if quals is None else
             {"quals": (quals, (n, W), torch.uint8)}))
    return Q


def _launch(dev, fn, *args, workspace=False):
    """fn(*args[, counts workspace, its int4 entries], stream) on dev's
    current stream; raises on a CUDA error code."""
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if workspace:
            ws = _workspace(dev, stream)
            args += (ws.data_ptr(), ws.shape[0] // 4)
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"store_screen kernel B5 launch failed: CUDA "
                           f"error {rc}")


def _count(name: str) -> None:
    with _count_lock:   # multi-sample dada() launches from worker threads
        launches[name] += 1


def _ptr(x) -> Optional[int]:
    return None if x is None else x.data_ptr()


def small_pack(tvec, seqs, lens, quals, center: int, lerr, small5):
    """B5's small pack alone (the full route's small13; see
    small_pack_ref): one launch on CUDA tensors (one count in
    launches["small"]); CPU tensors run small_pack_ref."""
    dev = seqs.device
    if dev.type == "cpu":
        return small_pack_ref(tvec, seqs, lens, quals, center, lerr, small5)
    if dev.type != "cuda":
        raise ValueError(f"small_pack runs on cuda or cpu, not {dev}")
    n, W = seqs.shape
    _check(None, tvec, seqs, lens, center, 1, "tiles")
    Q = _check_small_in(seqs, quals, lerr, small5)
    small13 = torch.empty((n, 13), dtype=torch.int8, device=dev)
    _launch(dev, _load().store_screen_small,
            small5.data_ptr(), tvec.data_ptr(), seqs.data_ptr(),
            lens.data_ptr(), _ptr(quals), lerr.data_ptr(),
            small13.data_ptr(), n, W, Q, int(center))
    _count("small")
    return small13


def budded_pack(small13, tvec, seqs, lens, reads, center: int, eth2,
                cbits=None, *, nd: int, L: int, M0: int, K: int,
                greedy: bool, kind: str = "tiles",
                M0U: Optional[int] = None, cache_on: bool = False,
                small5=None, quals=None, lerr=None, proj=None,
                proj_out=None, logtotal: Optional[float] = None, out=None):
    """Kernel B5: see budded_pack_ref for what it computes (small13 None:
    the small pack from small5, quals and lerr too; given small13, those
    are not read; proj raises the screen's threshold; proj_out, with
    logtotal, receives this compare's projection fold; out receives the
    buffer). CUDA tensors launch the one cooperative kernel on the
    current stream (one count in launches["pack"]); CPU tensors run
    budded_pack_ref. Returns (buf, order, order_u, small13)."""
    _check(small13, tvec, seqs, lens, center, K, kind)
    n, W = seqs.shape
    MU = M0U if cache_on else M0
    if nd % 8 or nd < n or not 0 <= MU <= nd or (cache_on and cbits is None):
        raise ValueError(f"nd={nd}, n={n}, MU={MU}, cache_on={cache_on}")
    if (proj_out is None) != (logtotal is None):
        raise ValueError("the projection fold needs proj_out and logtotal")
    o1, o2, o3, total = budbuf_layout(nd, W, M0, K, kind,
                                      M0U if cache_on else None)
    for name, x, dtype, size in (("proj", proj, torch.float32, nd),
                                 ("proj_out", proj_out, torch.float32, nd),
                                 ("out", out, torch.uint8, total)):
        if x is not None and (x.dtype != dtype or tuple(x.shape) != (size,)
                              or not x.is_contiguous()
                              or x.device != seqs.device):
            raise ValueError(f"{name} must be contiguous {dtype} [{size}] "
                             f"on {seqs.device}")
    dev = seqs.device
    if dev.type == "cpu":
        return budded_pack_ref(
            small13, tvec, seqs, lens, reads, center, eth2, cbits, nd=nd,
            L=L, M0=M0, K=K, greedy=greedy, kind=kind, M0U=M0U,
            cache_on=cache_on, small5=small5, quals=quals, lerr=lerr,
            proj=proj, proj_out=proj_out, logtotal=logtotal, out=out)
    if dev.type != "cuda":
        raise ValueError(f"budded_pack runs on cuda or cpu, not {dev}")
    nb = nd // 8
    if (eth2.dtype != torch.uint8 or tuple(eth2.shape) != (2 * nd + nb,)
            or reads.dtype != torch.int32 or tuple(reads.shape) != (n,)
            or (cache_on and (cbits.dtype != torch.uint8
                              or tuple(cbits.shape) != (nb,)))):
        raise ValueError("eth2 must be uint8 [2 nd + nd/8], reads int32 "
                         "[n], cbits uint8 [nd/8]")
    compute = small13 is None
    if compute:
        Q = _check_small_in(seqs, quals, lerr, small5)
        small13 = torch.empty((n, 13), dtype=torch.int8, device=dev)
    else:
        Q, small5, quals, lerr = 0, None, None, None
    buf = (torch.empty(total, dtype=torch.uint8, device=dev) if out is None
           else out)
    order = torch.empty(nd, dtype=torch.int32, device=dev)
    order_u = (torch.empty(nd, dtype=torch.int32, device=dev) if cache_on
               else order)
    _launch(dev, _load().store_screen_run,
            small13.data_ptr(), _ptr(small5), tvec.data_ptr(),
            seqs.data_ptr(), lens.data_ptr(), _ptr(quals), _ptr(lerr),
            eth2.data_ptr(), reads.data_ptr(),
            cbits.data_ptr() if cache_on else None, _ptr(proj),
            order.data_ptr(), order_u.data_ptr(), buf.data_ptr(),
            _ptr(proj_out), n, nd, W, Q, int(center), int(bool(greedy)),
            int(bool(cache_on)), int(compute), MU, K, int(kind == "bits"),
            o1, o2, o3, float(np.float32(5.0 * L)),
            float(np.float32(L + 5.0)),
            float(np.float32(-(1074.0 + L) * _LN2 - 1.0)),
            float(np.float32(0.0 if logtotal is None else logtotal)),
            workspace=True)
    _count("pack")
    with _count_lock:
        launches_with["proj"] += proj is not None
        launches_with["fold"] += proj_out is not None
    return buf, order, order_u, small13


def take_subs(small13, tvec, seqs, lens, center: int, order, *, M0: int,
              M: int, K: int, kind: str = "tiles"):
    """Kernel B5's follow-up (see take_subs_ref; small13 may be small5):
    one launch of its pack over compacted rows [M0, M0 + M) on CUDA
    tensors (one count in launches["take"]); CPU tensors run
    take_subs_ref."""
    _check(small13, tvec, seqs, lens, center, K, kind, (13, 5))
    n, W = seqs.shape
    if M0 < 0 or M <= 0 or M0 + M > order.shape[0]:
        raise ValueError(f"rows [{M0}, {M0 + M}) outside the order's "
                         f"{order.shape[0]}")
    dev = seqs.device
    if dev.type == "cpu":
        return take_subs_ref(small13, tvec, seqs, lens, center, order, M0=M0,
                             M=M, K=K, kind=kind)
    if dev.type != "cuda":
        raise ValueError(f"take_subs runs on cuda or cpu, not {dev}")
    if order.dtype != torch.int32 or not order.is_contiguous():
        raise ValueError("order must be contiguous int32")
    out = torch.empty(M * (5 + subw(W, K, kind)), dtype=torch.uint8,
                      device=dev)
    _launch(dev, _load().store_screen_take,
            order.data_ptr(), small13.data_ptr(), tvec.data_ptr(),
            seqs.data_ptr(), lens.data_ptr(),
            M0, M, n, W, small13.shape[1], int(center), K,
            int(kind == "bits"), out.data_ptr(), out.data_ptr() + 5 * M)
    _count("take")
    return out


def full_pack(small, tvec, seqs, lens, center: int, eth2, *, nd: int,
              L: int, M0: int, K: int, screened: bool):
    """Kernel B5's full mode: see full_pack_ref for what it computes (small
    is small13 when screened, else small5 or small13). CUDA tensors
    launch one cooperative kernel on the current stream (one count in
    launches["full"]); CPU tensors run full_pack_ref. Returns (buf,
    order)."""
    _check(small, tvec, seqs, lens, center, K, "tiles",
           (13,) if screened else (13, 5))
    n, W = seqs.shape
    if nd % 8 or nd < n or not 0 <= M0 <= nd:
        raise ValueError(f"nd={nd}, n={n}, M0={M0}")
    ne = (2 * nd if screened else 0) + nd // 8
    if eth2.dtype != torch.uint8 or tuple(eth2.shape) != (ne,):
        raise ValueError(f"eth2 must be uint8 [{ne}] (bf16 thresholds when "
                         f"screened, then the pad bitmap)")
    dev = seqs.device
    if dev.type == "cpu":
        return full_pack_ref(small, tvec, seqs, lens, center, eth2, nd=nd,
                             L=L, M0=M0, K=K, screened=screened)
    if dev.type != "cuda":
        raise ValueError(f"full_pack runs on cuda or cpu, not {dev}")
    if eth2.device != dev or not eth2.is_contiguous():
        raise ValueError(f"eth2 must be contiguous on {dev}")
    o1, o2, o3, total = fullbuf_layout(nd, M0, K)
    buf = torch.empty(total, dtype=torch.uint8, device=dev)
    order = torch.empty(nd, dtype=torch.int32, device=dev)
    _launch(dev, _load().store_screen_full,
            small.data_ptr(), tvec.data_ptr(), seqs.data_ptr(),
            lens.data_ptr(), eth2.data_ptr(), order.data_ptr(),
            buf.data_ptr(), n, nd, W, small.shape[1], int(center),
            int(bool(screened)), M0, K, o1, o2, o3,
            float(np.float32(5.0 * L)), float(np.float32(L + 5.0)),
            workspace=True)
    _count("full")
    return buf, order


def gather_subs(tvec, seqs, lens, center: int, small, idx, *, K: int):
    """Kernel B5's gather mode (the follow-up's tile pack over an explicit
    row list, tiles only): substitution tiles uint8 [M, 2K] of rows idx
    (int32 [M]); small is small13 or small5 (its flags column). One
    launch on CUDA tensors (one count in launches["gather"]); CPU tensors
    run gather_subs_ref."""
    _check(small, tvec, seqs, lens, center, K, "tiles", (13, 5))
    n, W = seqs.shape
    M = idx.shape[0]
    dev = seqs.device
    if dev.type == "cpu":
        return gather_subs_ref(tvec, seqs, lens, center, small[:, -1], idx,
                               K=K)
    if dev.type != "cuda":
        raise ValueError(f"gather_subs runs on cuda or cpu, not {dev}")
    if (idx.dtype != torch.int32 or idx.dim() != 1 or M <= 0
            or idx.device != dev or not idx.is_contiguous()):
        raise ValueError("idx must be a non-empty contiguous int32 vector "
                         "on the card")
    out = torch.empty((M, 2 * K), dtype=torch.uint8, device=dev)
    _launch(dev, _load().store_screen_take,
            idx.data_ptr(), small.data_ptr(), tvec.data_ptr(),
            seqs.data_ptr(), lens.data_ptr(), 0, M, n, W, small.shape[1],
            int(center), K, 0, None, out.data_ptr())
    _count("gather")
    return out


launches = {"pack": 0, "take": 0, "small": 0, "full": 0, "gather": 0}
# of the "pack" launches, those that screened with a projection and those
# that folded their compare into one
launches_with = {"proj": 0, "fold": 0}
