// Kernel B5: the compare transport's device half for Hopper (sm_90a): the
// whole budded compare in one launch, its follow-up, the full compare's
// one-fetch buffer and the classic path's tile gather.
//
// Replaces the XLA programs dada2_tpu/core/backend_tpu.py::_budded_fused
// (:520), _full_fused (:578) and _gather_subs (:659): the small pack
// _small_trace (:341), the store screen
// _shortlist_screen (:779), the stable ascending compactions
// (argsort(~need, stable=True)) and the substitution transport
// _subs_tile_trace (:410) / _subs_bits_trace (:426) over _sel_tv (:386);
// and the follow-up _take_subs (:640). Plain versions and layouts:
// ops/store_screen.py (small_pack_ref, budded_pack_ref, take_subs_ref,
// full_pack_ref, gather_subs_ref, budbuf_layout, fullbuf_layout); every
// output byte is the plain version's.
//
// budded_kernel<BITS> is one persistent cooperative kernel (launched with
// cudaLaunchCooperativeKernel, grid = blocks the occupancy calculator
// fits on every SM x the SM count, capped by the work). Each block owns a
// contiguous range of rows (a multiple of 32), so the compaction stays
// local to it:
//   1. small pack and screen, fused, THREADS rows at a time: the small
//      pack a warp per row, then the screen a thread per row, so that
//      the screen's loads and logf stay off the warps' path. Lane l sums
//      the f32 log factors lerr[t, q] (lerr [17, Q] in shared memory) of
//      positions l, l + 32, ... in ascending order, loglam and
//      |factor| in two accumulators, then an xor butterfly over offsets
//      16, 8, 4, 2, 1 combines the lanes (small_pack_ref defines this
//      order; it is the kernel's, not XLA's: the sums are a screen and
//      the screen's margin covers any order). The row's gapless flag
//      picks the transitions before the sum (gapless: the
//      pad-to-length construction from the row and the center; else
//      kernel B1's tvec): the same bits as summing both and selecting,
//      with half the reads. The row's 13 bytes go to small13, its sums
//      to shared memory; then a thread per row screens the rows (a
//      status byte in shared memory), from the small pack's sums or,
//      given small13 (a cache hit), from the given row; a speculative
//      segment's screen is raised to its projected threshold (proj), and
//      with a fold the same thread writes its row's projection
//      (proj_out: _proj_update :465 as an epilogue, every term per-row,
//      so no extra grid sync; a fresh [nd] f32 output per chain step).
//      Then ballots
//      over 32 consecutive rows write the need and shroud
//      bitmaps, and each block's four counts (need, need_u, cand,
//      nshroud) go to a global array.
//   2. grid sync. Each block sums the counts of the blocks before it and
//      writes its rows' stable ascending compactions (needed rows at
//      pn++, the others at m + r - pn; the same over need_u in cache
//      mode); block 0 writes the header. No atomics on positions: the
//      host rebuilds the shortlist's rows from the need bitmap, so the
//      order must be ascending.
//   3. grid sync. One warp per shortlist slot (grid-stride): the slot's
//      5-byte small row and its substitution records (tiles: the first
//      K pos | nt0 << 14 entries in ascending position, 0xFFFF after;
//      bits: the position bitmap and the 2-bit nt0 stream), positions
//      compacted with ballots and popc.
// take_kernel<BITS, true> runs phase 3's device function alone over
// compacted rows [M0, M0 + M) (the follow-up; its small rows small13 or
// small5); take_kernel<false, false> is the gather mode, the tiles alone
// over an explicit row list (_gather_subs :659, the classic full
// compare's tile fetch); small_kernel runs phase 1's small pack alone (the
// full route's small13), so the card has one definition of small13's bits.
//
// full_kernel<SCREENED> is the full mode, the one-fetch transport of a
// full compare (_full_fused :578), one cooperative launch with the same
// grid rule: a thread per row writes its 5-byte row into the slab and,
// screened, runs the full screen (the budded screen's margin without its
// skip, shroud and underflow rules); ballots write the need bitmap and
// count sel = need & ~gapless & ~pad; after a grid sync the ascending
// compaction of sel; after another, a warp per slot of the first M0
// writes the slot's row index and its substitution tile. An unscreened
// compare hands it small5, so no small pack is summed for it. Bound by
// bytes as the budded kernel: the slab is 5 bytes a row, the tiles read
// two W-byte rows a slot.
//
// Grid sync needs no -rdc=true: since CUDA 11 cooperative_groups'
// grid.sync() compiles in whole-program mode, and build_library's
// command is unchanged.
//
// Data written in one phase and read by other blocks in a later one
// (small13, order, the block counts) is read with ld.global.cg (__ldcg,
// L2), and its pointers are not const __restrict__ (no ld.global.nc).
//
// What bounds it: bytes. Phase 1 reads each row's quals and its tvec (or
// its sequence, gapless rows) up to its length, about 11 MB at phase 5
// (n 21,630, W 250), and 5 + 8 bytes of small5 and lens, then 19 bytes a
// row for the screen and writes 13; phase 3 reads two W-byte rows per
// slot. At those sizes the launch, the per-row latency of a warp walking
// its rows and the two grid syncs, not the memory rate, set its time;
// one launch instead of three (and no torch-ops small pack before it) is
// what this design buys. Vector loads or TMA for phase 1 are later work.
//
// Numerics: the screen's and the projection's f32 arithmetic is the JAX
// package's, in its order, with no contraction into FMAs (__fmul_rn /
// __fadd_rn), the log XLA's CPU backend evaluates (log_f32, the Cephes
// polynomial with its fused multiply-adds, not logf), and subnormals read
// as zero, as XLA reads them (flush), so `need` and the projection are
// bitwise the plain version's.
// e_thresh arrives as bf16 bits, the f32's upper half (a truncation, so
// a lower bound of the threshold); the kernel rebuilds the f32 as
// bits << 16. The small pack's adds are __fadd_rn, subnormals kept (as
// torch's CPU adds keep them).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 16;                 // budded and take kernels
constexpr int THREADS = WARPS * 32;
constexpr int SMALL_WARPS = 8;            // small_kernel: a warp per row
constexpr int STREAM_WORDS = 64;          // a warp's nt0 stream: K <= 1024
constexpr int SUM_UNROLL = 8;             // small pack: positions in flight
constexpr int MAX_DYN_SMEM = 36 * 1024;   // + static, under 48 KB: no opt-in
constexpr uint8_t ST_NEED = 1, ST_NEED_U = 2, ST_CAND = 4, ST_NSHROUD = 8,
                  ST_SHROUD = 16, ST_SEL = 32;

// what the small pack reads and writes
struct SmallIn {
  const int8_t* small5;     // [n, 5]: ham i16, ham_gapless i16, flags
  const int8_t* tvec;       // [n, W] kernel B1's transitions
  const int8_t* seqs;       // [n, W]
  const long long* lens;    // [n]
  const uint8_t* quals;     // [n, W] or null (every q = 0)
  const float* lerr;        // [17, Q] log error factors, row 16 = 0
  uint8_t* small13;         // [n, 13] out (or in, given)
  int n, W, Q, center;
};

struct BudArgs {
  SmallIn sm;
  const uint8_t* eth2;      // [2 nd + nd/8]: bf16 e_thresh, lock bits
  const int* reads;         // [n]
  const uint8_t* cbits;     // [nd/8] cached rows (cache mode)
  const float* proj;        // [nd] projected log-threshold, or null
  int* order;               // [nd]
  int* order_u;             // [nd] (cache mode)
  uint8_t* buf;             // budbuf_layout
  float* proj_out;          // [nd] the fold's output, or null (no fold)
  int4* counts;             // [gridDim.x] per-block counts
  int nd, greedy, cache_on, compute, MU, K, o1, o2, o3, chunk;
  float c5L, cL5, und, logtotal;
};

__device__ __forceinline__ float load_f32(const uint8_t* p) {
  uint32_t b = (uint32_t)p[0] | ((uint32_t)p[1] << 8) |
               ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24);
  return __uint_as_float(b);
}

// subnormal values read and written as zero, as XLA computes (its CPU and
// the TPU flush them); explicit, so that no compiler flag changes it
__device__ __forceinline__ float flush(float x) {
  return fabsf(x) < 1.17549435e-38f ? 0.f : x;
}

// The f32 log of the JAX package on XLA's CPU backend, operation for
// operation (ops/store_screen.py::log_f32, bitwise): Cephes' polynomial of
// log(1 + x) on [sqrt(1/2) - 1, sqrt(2) - 1] with its multiply-adds fused,
// subnormal inputs read as zero. The accurate logf rounds about 1% of
// integers to the other neighbour, and the projection's bits are the JAX
// package's only with this one.
__device__ float log_f32(float x) {
  x = flush(x);
  if (x == 0.f) return -INFINITY;
  if (!(x >= 0.f)) return NAN;   // negative or NaN
  if (isinf(x)) return INFINITY;
  const uint32_t bits = __float_as_uint(x);
  float e = __fadd_rn(1.f, (float)((int)(bits >> 23) - 0x7f));
  const float m = __uint_as_float((bits & 0x807fffffu) | 0x3f000000u);
  const bool low = m < 0.707106781186547524f;
  const float xm = __fadd_rn(__fsub_rn(m, 1.f), low ? m : 0.f);
  e = __fsub_rn(e, low ? 1.f : 0.f);
  const float x2 = __fmul_rn(xm, xm), x3 = __fmul_rn(x2, xm);
  float y = __fmaf_rn(__fmaf_rn(xm, 7.0376836292e-2f, -1.1514610310e-1f), xm,
                      1.1676998740e-1f);
  const float y1 = __fmaf_rn(
      __fmaf_rn(xm, -1.2420140846e-1f, 1.4249322787e-1f), xm,
      -1.6668057665e-1f);
  const float y2 = __fmaf_rn(
      __fmaf_rn(xm, 2.0000714765e-1f, -2.4999993993e-1f), xm,
      3.3333331174e-1f);
  y = __fmaf_rn(__fmaf_rn(y, x3, y1), x3, y2);
  y = __fmaf_rn(y, x3, __fmul_rn(-2.12194440e-4f, e));
  const float r = __fadd_rn(__fsub_rn(xm, __fmul_rn(0.5f, x2)), y);
  return __fadd_rn(r, __fmul_rn(0.693359375f, e));
}

// rows n..nd-1 are the JAX package's pad rows: copies of row 0
__device__ __forceinline__ int src_row(int r, int n) { return r < n ? r : 0; }

__host__ __device__ __forceinline__ int lerr_bytes(int Q) {
  return ((17 * Q * 4) + 15) & ~15;
}

__device__ __forceinline__ void load_lerr(const SmallIn& sm, float* lerr_s) {
  for (int i = threadIdx.x; i < 17 * sm.Q; i += blockDim.x)
    lerr_s[i] = sm.lerr[i];
}

// Row s's f32 loglam and abssum over its gapless-selected transitions, in
// the defined order (lane-strided ascending adds, then the butterfly);
// every lane returns the same bits. Positions past the row's length add
// nothing (their factor is 0), so the walk stops there. The loads of
// SUM_UNROLL positions a lane are issued before their adds, so a row
// costs one memory latency per 32 * SUM_UNROLL positions; the adds keep
// the ascending order.
__device__ void small_sums(const SmallIn& sm, int s, bool gl,
                           const float* lerr_s, int lane, float& loglam,
                           float& abssum) {
  const int W = sm.W, Q = sm.Q;
  const int lim = min(W, (int)sm.lens[s]);
  const int8_t* s1 = sm.seqs + (size_t)s * W;
  const int8_t* s0 = sm.seqs + (size_t)sm.center * W;
  const int8_t* tv = sm.tvec + (size_t)s * W;
  const uint8_t* qrow = sm.quals ? sm.quals + (size_t)s * W : nullptr;
  const int l1 = (int)sm.lens[sm.center];
  float al = 0.f, aa = 0.f;
  // loads run to W (in bounds), so they need not wait for the length
  for (int base = lane; base < W; base += 32 * SUM_UNROLL) {
    int tq[SUM_UNROLL];   // transition | quality << 8
#pragma unroll
    for (int j = 0; j < SUM_UNROLL; ++j) {
      const int p = base + 32 * j;
      int t = 0, q = 0;
      if (p < W) {
        if (gl) {
          const int a = s1[p], b = s0[p];
          t = (p < l1 && b != a) ? 4 * b + a : 5 * a;
        } else {
          t = tv[p];
        }
        q = qrow ? qrow[p] : 0;
      }
      tq[j] = t | (q << 8);
    }
#pragma unroll
    for (int j = 0; j < SUM_UNROLL; ++j) {
      if (base + 32 * j < lim) {
        const int t = tq[j] & 0xff, q = tq[j] >> 8;
        const float f = q < Q ? lerr_s[t * Q + q] : 0.f;
        al = __fadd_rn(al, f);
        aa = __fadd_rn(aa, fabsf(f));
      }
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    al = __fadd_rn(al, __shfl_xor_sync(FULL, al, off));
    aa = __fadd_rn(aa, __shfl_xor_sync(FULL, aa, off));
  }
  loglam = al;
  abssum = aa;
}

// small13 row r: small5's ham, ham_gapless, then loglam, abssum, flags
__device__ __forceinline__ void write_small13(uint8_t* out,
                                              const int8_t* s5, float ll,
                                              float as, int lane) {
  if (lane < 13) {
    uint32_t v;
    if (lane < 4) v = (uint8_t)s5[lane];
    else if (lane < 8) v = __float_as_uint(ll) >> (8 * (lane - 4));
    else if (lane < 12) v = __float_as_uint(as) >> (8 * (lane - 8));
    else v = (uint8_t)s5[4];
    out[lane] = (uint8_t)v;
  }
}

// Whether row r (source row s) is skipped: its lock bit and, under greedy,
// the abundance skip, never the center itself.
__device__ __forceinline__ bool row_nskip(const BudArgs& a, int r, int s) {
  bool nskip = (a.eth2[2 * a.nd + (r >> 3)] >> (r & 7)) & 1;
  if (a.greedy) {
    nskip = nskip || a.reads[s] > a.reads[a.sm.center];
    nskip = nskip && r != a.sm.center;
  }
  return nskip;
}

// The projection's lr: log(reads[center] / total) lowered by its margin
// 2 eps (|lr| + |logtotal|) + eps (backend_tpu._proj_update's order).
__device__ __forceinline__ float proj_lr(const BudArgs& a) {
  const float eps = 1.1920928955078125e-7f;   // 2^-23
  float lr = __fsub_rn(log_f32((float)a.reads[a.sm.center]), a.logtotal);
  const float m = __fadd_rn(
      __fmul_rn(2.f * eps, __fadd_rn(fabsf(lr), fabsf(a.logtotal))), eps);
  return __fsub_rn(lr, m);
}

// Row r's f32 store screen from its small pack: its status byte. With a
// projection, logthr is raised to proj[r] (never for the center, whose
// lock can clear before a segment is consumed); with a fold, the row's
// term (its loglam lowered by its margin, plus lr; -inf where the compare
// skips or shrouds the row, or the sum is not finite) maxed into
// proj_out[r] (backend_tpu._proj_update).
__device__ uint8_t screen_row(const BudArgs& a, int r, bool nskip,
                              float loglam, float abssum, uint8_t flags,
                              float lr) {
  const uint32_t eb =
      (uint32_t)a.eth2[2 * r] | ((uint32_t)a.eth2[2 * r + 1] << 8);
  const float e = flush(__uint_as_float(eb << 16));
  loglam = flush(loglam);
  abssum = flush(abssum);
  const bool shroud = (flags & 4) != 0;
  const bool cand = !nskip && !shroud;
  const bool pos = e > 0.f;
  float logthr = pos ? log_f32(e) : -INFINITY;
  if (a.proj && r != a.sm.center) logthr = fmaxf(logthr, a.proj[r]);
  const float eps = 1.1920928955078125e-7f;   // 2^-23
  const float m1 = __fadd_rn(
      1e-3f, __fmul_rn(eps, __fadd_rn(a.c5L, __fmul_rn(a.cL5, abssum))));
  if (a.proj_out) {
    const float lower = __fsub_rn(loglam, m1);
    const float term = isfinite(lower) && cand ? __fadd_rn(lower, lr)
                                               : -INFINITY;
    a.proj_out[r] = fmaxf(a.proj ? a.proj[r] : -INFINITY, term);
  }
  const float margin = __fadd_rn(
      m1, __fmul_rn(4.f * eps, isfinite(logthr) ? fabsf(logthr) : 0.f));
  const float logthr2 = pos ? logthr : (e == 0.f ? a.und : -INFINITY);
  const bool need = cand && ((flush(__fadd_rn(loglam, margin)) >= logthr2) ||
                             (!isfinite(loglam) && e != 0.f));
  const bool need_u =
      need && !(a.cache_on && ((a.cbits[r >> 3] >> (r & 7)) & 1));
  return (need ? ST_NEED : 0) | (need_u ? ST_NEED_U : 0) |
         (cand ? ST_CAND : 0) | (shroud && !nskip ? ST_NSHROUD : 0) |
         (shroud ? ST_SHROUD : 0);
}

// One shortlist slot (source row s): its 5-byte small row (ROWS) and its
// substitution records. Small rows are small13 or small5 (rstride 13 or
// 5): bytes 0..3 ham and ham_gapless, the last byte the flags. The warp's
// nt0 stream sits in `stream` (BITS only).
template <bool BITS, bool ROWS>
__device__ void pack_slot(int s, int slot, const uint8_t* small, int rstride,
                          const int8_t* __restrict__ tvec,
                          const int8_t* __restrict__ seqs,
                          const long long* __restrict__ lens, int W,
                          int center, int K, uint8_t* rows_out,
                          uint8_t* subs_out, uint32_t* stream, int lane) {
  const uint8_t* sm = small + (size_t)s * rstride;
  if (ROWS && lane < 5)
    rows_out[(size_t)slot * 5 + lane] =
        __ldcg(sm + (lane < 4 ? lane : rstride - 1));
  const int l2 = (int)lens[s], mn = min(l2, (int)lens[center]);
  const bool gl = (__ldcg(sm + rstride - 1) & 2) != 0;
  const int8_t* s1 = seqs + (size_t)s * W;
  const int8_t* s0 = seqs + (size_t)center * W;
  const int8_t* tv_row = tvec + (size_t)s * W;
  const int bmb = (W + 7) >> 3;
  const int subw = BITS ? bmb + K / 4 : 2 * K;
  uint8_t* out = subs_out + (size_t)slot * subw;
  if (BITS) {
    for (int w = lane; w < STREAM_WORDS; w += 32) stream[w] = 0;
    __syncwarp();
  }
  int count = 0;
  for (int p0 = 0; p0 < W; p0 += 32) {
    const int p = p0 + lane;
    bool sub = false;
    int tv = 0;
    if (p < W) {
      const int a = s1[p];
      const bool valid = p < l2;
      if (gl) {
        const int b = s0[p];
        tv = valid ? 5 * a : 16;
        if (p < mn && b != a) tv = 4 * b + a;
      } else {
        tv = tv_row[p];
      }
      sub = valid && tv != 5 * a;
    }
    const unsigned bal = __ballot_sync(FULL, sub);
    const int k = count + __popc(bal & ((1u << lane) - 1));
    if (BITS) {
      if ((lane & 7) == 0 && (p >> 3) < bmb) out[p >> 3] = (bal >> lane) & 0xff;
      if (sub && k < K)
        atomicOr(&stream[k >> 4], (uint32_t)((tv >> 2) & 3) << (2 * (k & 15)));
    } else if (sub && k < K) {
      const uint32_t v = (uint32_t)p | ((uint32_t)(tv >> 2) << 14);
      out[2 * k] = v & 0xff;
      out[2 * k + 1] = (v >> 8) & 0xff;
    }
    count += __popc(bal);
  }
  if (BITS) {
    __syncwarp();
    for (int j = lane; j < K / 4; j += 32)
      out[bmb + j] = (stream[j >> 2] >> (8 * (j & 3))) & 0xff;
    __syncwarp();   // the stream is reused by the warp's next slot
  } else {
    for (int k = count + lane; k < K; k += 32) {
      out[2 * k] = 0xff;
      out[2 * k + 1] = 0xff;
    }
  }
}

// sum of x over the block (THREADS threads); every thread gets it
__device__ __forceinline__ int block_sum(int x, int* red) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
  __syncthreads();
  if (lane == 0) red[w] = x;
  __syncthreads();
  int t = 0;
  for (int i = 0; i < WARPS; ++i) t += red[i];
  return t;
}

// two blocks an SM: at most 64 registers a thread
template <bool BITS>
__global__ void __launch_bounds__(THREADS, 2) budded_kernel(BudArgs a) {
  extern __shared__ __align__(16) uint8_t dyn[];
  __shared__ uint32_t stream[WARPS][STREAM_WORDS];
  __shared__ float2 sums[THREADS];   // a sub-chunk's loglam, abssum
  __shared__ int4 red4[WARPS];
  __shared__ int red[WARPS];
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nb = a.nd >> 3;
  const int lo = blockIdx.x * a.chunk, hi = min(lo + a.chunk, a.nd);
  float* lerr_s = (float*)dyn;
  uint8_t* status = dyn + (a.compute ? lerr_bytes(a.sm.Q) : 0);

  // 1. small pack and screen, THREADS rows at a time: the small pack a
  // warp per row, then the screen (and the fold) a thread per row
  const SmallIn& sm = a.sm;
  const float lr = a.proj_out ? proj_lr(a) : 0.f;
  if (a.compute) load_lerr(sm, lerr_s);
  __syncthreads();
  for (int r0 = lo; r0 < hi; r0 += THREADS) {
    const int r1 = min(r0 + THREADS, hi);
    if (a.compute) {
      for (int r = r0 + warp; r < r1; r += WARPS) {
        const int s = src_row(r, sm.n);
        const int8_t* s5 = sm.small5 + (size_t)s * 5;
        const uint8_t flags = (uint8_t)s5[4];
        float ll = 0.f, as = 0.f;
        // a pad row's sums matter only if it is a candidate (never, when
        // its lock bit is set, as the backend sets it)
        if (r < sm.n || (!(flags & 4) && !row_nskip(a, r, s))) {
          small_sums(sm, s, (flags & 2) != 0, lerr_s, lane, ll, as);
          if (r < sm.n)
            write_small13(sm.small13 + (size_t)r * 13, s5, ll, as, lane);
        }
        if (lane == 0) sums[r - r0] = make_float2(ll, as);
      }
      __syncthreads();
    }
    const int r = r0 + threadIdx.x;
    if (r < r1) {
      const int s = src_row(r, sm.n);
      float ll, as;
      uint8_t flags;
      if (a.compute) {
        ll = sums[threadIdx.x].x;
        as = sums[threadIdx.x].y;
        flags = (uint8_t)sm.small5[(size_t)s * 5 + 4];
      } else {
        const uint8_t* row = sm.small13 + (size_t)s * 13;
        flags = row[12];
        ll = load_f32(row + 4);
        as = load_f32(row + 8);
      }
      status[r - lo] =
          screen_row(a, r, row_nskip(a, r, s), ll, as, flags, lr);
    }
    __syncthreads();   // sums are the next sub-chunk's
  }
  int cn = 0, cu = 0, cc = 0, cs = 0;
  for (int g0 = lo + 32 * warp; g0 < hi; g0 += 32 * WARPS) {
    const int r = g0 + lane;
    const uint8_t st = r < hi ? status[r - lo] : 0;
    const unsigned bn = __ballot_sync(FULL, st & ST_NEED);
    const unsigned bs = __ballot_sync(FULL, st & ST_SHROUD);
    const int byte = (g0 >> 3) + lane;
    if (lane < 4 && byte < nb) {   // a warp's 32 rows: 4 bytes, little-endian
      a.buf[16 + byte] = (bn >> (8 * lane)) & 0xff;
      a.buf[a.o3 + byte] = (bs >> (8 * lane)) & 0xff;
    }
    cn += __popc(bn);
    cu += __popc(__ballot_sync(FULL, st & ST_NEED_U));
    cc += __popc(__ballot_sync(FULL, st & ST_CAND));
    cs += __popc(__ballot_sync(FULL, st & ST_NSHROUD));
  }
  if (lane == 0) red4[warp] = make_int4(cn, cu, cc, cs);
  __syncthreads();
  if (threadIdx.x == 0) {
    int4 t = make_int4(0, 0, 0, 0);
    for (int i = 0; i < WARPS; ++i) {
      t.x += red4[i].x; t.y += red4[i].y; t.z += red4[i].z; t.w += red4[i].w;
    }
    a.counts[blockIdx.x] = t;
  }
  grid.sync();

  // 2. the blocks before this one, the totals, the compactions
  int pn = 0, pu = 0, tn = 0, tu = 0, tc = 0, ts = 0;
  for (int j = threadIdx.x; j < (int)gridDim.x; j += THREADS) {
    const int4 c = __ldcg(a.counts + j);
    tn += c.x; tu += c.y; tc += c.z; ts += c.w;
    if (j < (int)blockIdx.x) { pn += c.x; pu += c.y; }
  }
  pn = block_sum(pn, red);
  pu = block_sum(pu, red);
  const int m = block_sum(tn, red), mu = block_sum(tu, red);
  const int naligned = block_sum(tc, red), nshroud = block_sum(ts, red);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    int* header = (int*)a.buf;
    header[0] = m;
    header[1] = naligned;
    header[2] = nshroud;
    header[3] = a.cache_on ? mu : 0;
  }
  if (warp == 0) {
    const unsigned lt = (1u << lane) - 1;
    for (int g0 = lo; g0 < hi; g0 += 32) {
      const int r = g0 + lane;
      const bool in = r < hi;
      const uint8_t st = in ? status[r - lo] : 0;
      // rows not needed follow the needed ones, also ascending: r - k of
      // them come before r
      const unsigned bn = __ballot_sync(FULL, st & ST_NEED);
      const int k = pn + __popc(bn & lt);
      if (in) {
        if (st & ST_NEED) a.order[k] = r; else a.order[m + r - k] = r;
      }
      pn += __popc(bn);
      if (a.cache_on) {
        const unsigned bu = __ballot_sync(FULL, st & ST_NEED_U);
        const int ku = pu + __popc(bu & lt);
        if (in) {
          if (st & ST_NEED_U) a.order_u[ku] = r;
          else a.order_u[mu + r - ku] = r;
        }
        pu += __popc(bu);
      }
    }
  }
  grid.sync();

  // 3. the shortlist's first MU slots, a warp per slot
  const int* ord = a.cache_on ? a.order_u : a.order;
  for (int slot = blockIdx.x * WARPS + warp; slot < a.MU;
       slot += gridDim.x * WARPS)
    pack_slot<BITS, true>(src_row(__ldcg(ord + slot), a.sm.n), slot,
                          a.sm.small13, 13, a.sm.tvec, a.sm.seqs, a.sm.lens,
                          a.sm.W, a.sm.center, a.K, a.buf + a.o1,
                          a.buf + a.o2, stream[warp], lane);
}

// The follow-up (ROWS: 5-byte rows, then records) over compacted rows
// [slot0, slot0 + nslots) of order; the gather mode (ROWS false, tiles
// only) over an explicit row list, order = idx and slot0 = 0.
template <bool BITS, bool ROWS>
__global__ void __launch_bounds__(THREADS)
take_kernel(const int* order, int slot0, int nslots, int n,
            const uint8_t* small, int rstride,
            const int8_t* __restrict__ tvec, const int8_t* __restrict__ seqs,
            const long long* __restrict__ lens, int W, int center, int K,
            uint8_t* __restrict__ rows_out, uint8_t* __restrict__ subs_out) {
  __shared__ uint32_t stream[BITS ? WARPS : 1][STREAM_WORDS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slot = blockIdx.x * WARPS + warp;
  if (slot >= nslots) return;   // warp-uniform
  pack_slot<BITS, ROWS>(src_row(order[slot0 + slot], n), slot, small,
                        rstride, tvec, seqs, lens, W, center, K, rows_out,
                        subs_out, stream[BITS ? warp : 0], lane);
}

struct FullArgs {
  const uint8_t* small;     // [n, rstride]: small13 (screened) or small5
  const int8_t* tvec;       // [n, W]
  const int8_t* seqs;       // [n, W]
  const long long* lens;    // [n]
  const uint8_t* eth2;      // [2 nd] bf16 e_thresh (screened), [nd/8] pad
  int* order;               // [nd]
  uint8_t* buf;             // fullbuf_layout
  int4* counts;             // [gridDim.x] per-block counts (.x: |sel|)
  int n, nd, W, rstride, center, M0, K, o1, o2, o3, chunk;
  float c5L, cL5;
};

// The full compare's f32 store screen of row r (backend_tpu._full_fused):
// the budded screen's margin without its skip, shroud and underflow
// rules; non-finite loglam is kept.
__device__ bool full_need(const FullArgs& a, int r, float loglam,
                          float abssum) {
  const uint32_t eb =
      (uint32_t)a.eth2[2 * r] | ((uint32_t)a.eth2[2 * r + 1] << 8);
  const float e = flush(__uint_as_float(eb << 16));
  loglam = flush(loglam);
  abssum = flush(abssum);
  const bool pos = e > 0.f;
  const float logthr = pos ? log_f32(e) : -INFINITY;
  const float eps = 1.1920928955078125e-7f;   // 2^-23
  const float m1 = __fadd_rn(
      1e-3f, __fmul_rn(eps, __fadd_rn(a.c5L, __fmul_rn(a.cL5, abssum))));
  const float margin =
      __fadd_rn(m1, __fmul_rn(4.f * eps, pos ? fabsf(logthr) : 0.f));
  return flush(__fadd_rn(loglam, margin)) >= logthr || !isfinite(loglam);
}

// B5's full mode, one cooperative launch (the grid and the row ranges as
// budded_kernel's): 1. a thread per row writes its 5-byte row into the
// slab, screens it (SCREENED) and marks sel = need & ~gapless & ~pad; a
// warp's ballots write 4 bytes of the need bitmap and count sel;
// 2. grid sync, the ascending compaction of sel into order (unselected
// rows after, also ascending) and the header; 3. grid sync, a warp per
// slot of the first M0: its row index and its substitution tile.
template <bool SCREENED>
__global__ void __launch_bounds__(THREADS, 2) full_kernel(FullArgs a) {
  extern __shared__ __align__(16) uint8_t status[];
  __shared__ int red[WARPS];
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nb = a.nd >> 3;
  const int lo = blockIdx.x * a.chunk, hi = min(lo + a.chunk, a.nd);
  const uint8_t* padb = a.eth2 + (SCREENED ? 2 * a.nd : 0);

  // 1. slab rows, the screen, sel
  for (int r = lo + threadIdx.x; r < hi; r += THREADS) {
    const uint8_t* row = a.small + (size_t)src_row(r, a.n) * a.rstride;
    const uint8_t flags = row[a.rstride - 1];
    uint8_t* out = a.buf + 16 + (size_t)r * 5;
    for (int j = 0; j < 4; ++j) out[j] = row[j];
    out[4] = flags;
    const bool need =
        SCREENED ? full_need(a, r, load_f32(row + 4), load_f32(row + 8))
                 : true;
    const bool pad = (padb[r >> 3] >> (r & 7)) & 1;
    const bool sel = need && !(flags & 2) && !pad;
    status[r - lo] = (need ? ST_NEED : 0) | (sel ? ST_SEL : 0);
  }
  __syncthreads();
  int cs = 0;
  for (int g0 = lo + 32 * warp; g0 < hi; g0 += 32 * WARPS) {
    const int r = g0 + lane;
    const uint8_t st = r < hi ? status[r - lo] : 0;
    const unsigned bn = __ballot_sync(FULL, st & ST_NEED);
    const int byte = (g0 >> 3) + lane;
    if (lane < 4 && byte < nb) a.buf[a.o1 + byte] = (bn >> (8 * lane)) & 0xff;
    cs += __popc(__ballot_sync(FULL, st & ST_SEL));
  }
  cs = block_sum(lane == 0 ? cs : 0, red);   // a warp's lanes hold one count
  if (threadIdx.x == 0) a.counts[blockIdx.x] = make_int4(cs, 0, 0, 0);
  grid.sync();

  // 2. the compaction and the header
  int pn = 0, tn = 0;
  for (int j = threadIdx.x; j < (int)gridDim.x; j += THREADS) {
    const int c = __ldcg(&a.counts[j].x);
    tn += c;
    if (j < (int)blockIdx.x) pn += c;
  }
  pn = block_sum(pn, red);
  const int m = block_sum(tn, red);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    int* header = (int*)a.buf;
    header[0] = m;
    header[1] = header[2] = header[3] = 0;
  }
  if (warp == 0) {
    const unsigned lt = (1u << lane) - 1;
    for (int g0 = lo; g0 < hi; g0 += 32) {
      const int r = g0 + lane;
      const bool in = r < hi;
      const uint8_t st = in ? status[r - lo] : 0;
      const unsigned bs = __ballot_sync(FULL, st & ST_SEL);
      const int k = pn + __popc(bs & lt);
      if (in) {
        if (st & ST_SEL) a.order[k] = r; else a.order[m + r - k] = r;
      }
      pn += __popc(bs);
    }
  }
  grid.sync();

  // 3. the first M0 slots: row index (unaligned int32, byte by byte) and
  // substitution tile, a warp per slot
  for (int slot = blockIdx.x * WARPS + warp; slot < a.M0;
       slot += gridDim.x * WARPS) {
    const int r = __ldcg(a.order + slot);
    if (lane < 4) a.buf[a.o2 + 4 * slot + lane] = (r >> (8 * lane)) & 0xff;
    pack_slot<false, false>(src_row(r, a.n), slot, a.small, a.rstride,
                            a.tvec, a.seqs, a.lens, a.W, a.center, a.K,
                            nullptr, a.buf + a.o3, nullptr, lane);
  }
}

__global__ void __launch_bounds__(SMALL_WARPS * 32) small_kernel(SmallIn sm) {
  extern __shared__ __align__(16) uint8_t dyn[];
  float* lerr_s = (float*)dyn;
  load_lerr(sm, lerr_s);
  __syncthreads();
  const int r = blockIdx.x * SMALL_WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= sm.n) return;   // warp-uniform
  const int8_t* s5 = sm.small5 + (size_t)r * 5;
  float ll, as;
  small_sums(sm, r, (s5[4] & 2) != 0, lerr_s, lane, ll, as);
  write_small13(sm.small13 + (size_t)r * 13, s5, ll, as, lane);
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

SmallIn small_in(const void* small5, const void* tvec, const void* seqs,
                 const void* lens, const void* quals, const void* lerr,
                 void* small13, int n, int W, int Q, int center) {
  return SmallIn{(const int8_t*)small5, (const int8_t*)tvec,
                 (const int8_t*)seqs,   (const long long*)lens,
                 (const uint8_t*)quals, (const float*)lerr,
                 (uint8_t*)small13,     n, W, Q, center};
}

// B5's grid rule for a cooperative launch of fn over nd rows: as many
// blocks as fit on the card at once (occupancy x SMs), at most one per 32
// rows and one per workspace entry; rows per block (chunk) a multiple of
// 32, so a warp's ballot covers 4 whole bitmap bytes of one block; lb
// bytes of dynamic shared memory before the chunk's status bytes.
int coop_grid(const void* fn, int nd, int counts_cap, int lb, int* G_out,
              int* chunk_out, int* smem_out) {
  int dev = 0, sms = 0;
  int rc = (int)cudaGetDevice(&dev);
  if (!rc) rc = (int)cudaDeviceGetAttribute(
      &sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc) return rc;
  int G = ceil_div(nd, 32) < counts_cap ? ceil_div(nd, 32) : counts_cap;
  int chunk = 0, smem = 0, fits = 0;
  for (int it = 0; it < 16 && !fits; ++it) {
    chunk = ceil_div(ceil_div(nd, G), 32) * 32;
    G = ceil_div(nd, chunk);
    smem = lb + chunk;
    if (smem > MAX_DYN_SMEM) return (int)cudaErrorInvalidValue;
    int occ = 0;
    rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fn, THREADS,
                                                           smem);
    if (rc) return rc;
    if (occ * sms <= 0) return (int)cudaErrorCooperativeLaunchTooLarge;
    fits = G <= occ * sms;
    if (!fits) G = occ * sms;
  }
  if (!fits) return (int)cudaErrorCooperativeLaunchTooLarge;
  *G_out = G;
  *chunk_out = chunk;
  *smem_out = smem;
  return 0;
}

}  // namespace

// One budded compare: the small pack (compute != 0; else small13 is
// given), the screen, the compactions and the pack into buf (layout
// ops/store_screen.py::budbuf_layout; o1..o3 are its offsets), in one
// cooperative launch. counts is a workspace of counts_cap int4.
extern "C" int store_screen_run(
    void* small13, const void* small5, const void* tvec, const void* seqs,
    const void* lens, const void* quals, const void* lerr, const void* eth2,
    const void* reads, const void* cbits, const void* proj, void* order,
    void* order_u, void* buf, void* proj_out, int n, int nd, int W, int Q,
    int center, int greedy, int cache_on, int compute, int MU, int K,
    int bits, int o1, int o2, int o3, float c5L, float cL5, float und,
    float logtotal, void* counts, int counts_cap, void* stream) {
  const void* fn = bits ? (const void*)budded_kernel<true>
                        : (const void*)budded_kernel<false>;
  int G = 0, chunk = 0, smem = 0;
  int rc = coop_grid(fn, nd, counts_cap, compute ? lerr_bytes(Q) : 0, &G,
                     &chunk, &smem);
  if (rc) return rc;
  BudArgs a{small_in(small5, tvec, seqs, lens, quals, lerr, small13, n, W, Q,
                     center),
            (const uint8_t*)eth2, (const int*)reads, (const uint8_t*)cbits,
            (const float*)proj, (int*)order, (int*)order_u, (uint8_t*)buf,
            (float*)proj_out, (int4*)counts,
            nd, greedy, cache_on, compute, MU, K, o1, o2, o3, chunk,
            c5L, cL5, und, logtotal};
  void* params[] = {&a};
  rc = (int)cudaLaunchCooperativeKernel(fn, dim3(G), dim3(THREADS), params,
                                        (size_t)smem, (cudaStream_t)stream);
  if (rc) return rc;
  return (int)cudaGetLastError();
}

// The full route's small pack alone: small13 [n, 13] from small5, tvec,
// seqs, lens, quals and lerr, a warp per row.
extern "C" int store_screen_small(const void* small5, const void* tvec,
                                  const void* seqs, const void* lens,
                                  const void* quals, const void* lerr,
                                  void* small13, int n, int W, int Q,
                                  int center, void* stream) {
  const int smem = lerr_bytes(Q);
  if (smem > MAX_DYN_SMEM) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  small_kernel<<<ceil_div(n, SMALL_WARPS), SMALL_WARPS * 32, smem,
                 (cudaStream_t)stream>>>(
      small_in(small5, tvec, seqs, lens, quals, lerr, small13, n, W, Q,
               center));
  return (int)cudaGetLastError();
}

// The follow-up: rows and substitution records of compacted rows
// [slot0, slot0 + nslots) of order. With rows_out null, the gather mode:
// the tiles alone (bits refused) of rows order[slot0 ..]. Small rows of
// rstride bytes (13 or 5).
extern "C" int store_screen_take(const void* order, const void* small,
                                 const void* tvec, const void* seqs,
                                 const void* lens, int slot0, int nslots,
                                 int n, int W, int rstride, int center,
                                 int K, int bits, void* rows_out,
                                 void* subs_out, void* stream) {
  if (nslots <= 0) return 0;
  if (!rows_out && bits) return (int)cudaErrorInvalidValue;
  const int blocks = ceil_div(nslots, WARPS);
  cudaStream_t st = (cudaStream_t)stream;
  const int* o = (const int*)order;
  const uint8_t* sm = (const uint8_t*)small;
  const int8_t *tv = (const int8_t*)tvec, *sq = (const int8_t*)seqs;
  const long long* ln = (const long long*)lens;
  uint8_t *ro = (uint8_t*)rows_out, *so = (uint8_t*)subs_out;
  if (!rows_out)
    take_kernel<false, false><<<blocks, THREADS, 0, st>>>(
        o, slot0, nslots, n, sm, rstride, tv, sq, ln, W, center, K, ro, so);
  else if (bits)
    take_kernel<true, true><<<blocks, THREADS, 0, st>>>(
        o, slot0, nslots, n, sm, rstride, tv, sq, ln, W, center, K, ro, so);
  else
    take_kernel<false, true><<<blocks, THREADS, 0, st>>>(
        o, slot0, nslots, n, sm, rstride, tv, sq, ln, W, center, K, ro, so);
  return (int)cudaGetLastError();
}

// B5's full mode: the full compare's buffer (layout
// ops/store_screen.py::fullbuf_layout; o1..o3 are its offsets) and the
// compaction order, in one cooperative launch. counts is a workspace of
// counts_cap int4.
extern "C" int store_screen_full(const void* small, const void* tvec,
                                 const void* seqs, const void* lens,
                                 const void* eth2, void* order, void* buf,
                                 int n, int nd, int W, int rstride,
                                 int center, int screened, int M0, int K,
                                 int o1, int o2, int o3, float c5L,
                                 float cL5, void* counts, int counts_cap,
                                 void* stream) {
  const void* fn = screened ? (const void*)full_kernel<true>
                            : (const void*)full_kernel<false>;
  int G = 0, chunk = 0, smem = 0;
  int rc = coop_grid(fn, nd, counts_cap, 0, &G, &chunk, &smem);
  if (rc) return rc;
  FullArgs a{(const uint8_t*)small, (const int8_t*)tvec,
             (const int8_t*)seqs,   (const long long*)lens,
             (const uint8_t*)eth2,  (int*)order,
             (uint8_t*)buf,         (int4*)counts,
             n, nd, W, rstride, center, M0, K, o1, o2, o3, chunk, c5L, cL5};
  void* params[] = {&a};
  rc = (int)cudaLaunchCooperativeKernel(fn, dim3(G), dim3(THREADS), params,
                                        (size_t)smem, (cudaStream_t)stream);
  if (rc) return rc;
  return (int)cudaGetLastError();
}
