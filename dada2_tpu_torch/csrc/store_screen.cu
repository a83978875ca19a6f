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
// take_kernel<BITS, true> is the follow-up over compacted rows [M0, M0 + M)
// (its small rows small13 or small5); take_kernel<false, false> is the
// gather mode, the tiles alone over an explicit row list (_gather_subs
// :659, the classic full compare's tile fetch); small_kernel runs phase
// 1's small pack alone (the full route's small13), so the card has one
// definition of small13's bits. The follow-up, the gather mode and the
// full mode pack their slots with the slot packer
// (pack_records, below): a group of 16 or 32 lanes a slot, the slot's two
// rows in registers from 16-byte loads all issued before their first use,
// its substitutions marked four bytes at a time, ranked by a prefix over
// the group's lanes and staged in shared memory, then stored 16 bytes at a
// time; the take kernel's grid holds every slot at once (4 to 8 slots a
// block of 128 threads). The budded kernel's phase 3 keeps its warp walk
// (pack_slot): under its 64-register cap (two blocks an SM) the slot packer
// there ran 2% slower, 0.0326-0.0328 against 0.0320-0.0321 ms at
// chip_smoke.py 17c's shapes on an H100 in four alternating runs (PERF.md).
//
// full_kernel<SCREENED> is the full mode, the one-fetch transport of a
// full compare (_full_fused :578), in one cooperative launch of at most a
// block an SM (two grid.sync()s). A thread per row writes its 5-byte row
// into the slab and, screened, runs the full screen (the budded screen's
// margin without its skip, shroud and underflow rules); ballots write the
// need bitmap and count sel = need & ~gapless & ~pad; after the counts'
// exchange each block's warps write its rows' places in the ascending
// compaction, and after a second sync the grid's groups of lanes pack the
// first M0 slots (row index and substitution tile), grid-stride. An
// unscreened compare hands it small5, so no small pack is summed for it.
// Bound by bytes: the slab is 5 bytes a row, the tiles read two W-byte rows
// a slot.
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

#include <mutex>
#include <vector>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 16;                 // budded and full kernels
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

// One shortlist slot of the budded kernel's phase 3 (source row s): its
// 5-byte small row (ROWS) and its substitution records, a warp walking the
// row 32 positions at a time. Small rows are small13 or small5 (rstride 13 or
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

// ---- the slot packer: the follow-up, the gather mode and the full mode ----
//
// A slot's records come from two W-byte rows: the row's sequence s1 and,
// by its gapless flag, its tvec row (kernel B1's) or the center's
// sequence. A group of G lanes packs one slot: G = 16 where a row is at
// most 16 chunks of 16 bytes (W <= 256; two slots a warp), else 32. Lane g
// holds chunks g, g + G, ... of both rows, PACK_ROUNDS chunks a row a
// pass, loaded as aligned 16-byte words (the word holding the chunk's
// first byte and, for a row not 16-byte aligned, the next) and realigned
// in registers (load_chunk); every load of a pass is issued before the
// first is used, so a row up to 16 G PACK_ROUNDS bytes costs one memory
// latency (W 250: one chunk a lane; samPB's ~1,450: three, two passes);
// the tvec row is loaded before the row's gapless flag is known, and a
// gapless row loads the center's instead. Each lane marks its chunk's
// substitutions in a 16-bit mask, four bytes at a time (chunk_subs), the
// group's exclusive prefix of their counts (shuffles) ranks them, and the
// lane writes its records at their ranks into the group's staging buffer
// in shared memory, which the group then copies to the output with 16-byte
// stores (copy_out: the staging copy sits at the output's alignment, so
// every interior word is one aligned store). Tiles are prefilled with
// 0xFF (the 0xFFFF past the count); the bits stream's 2-bit codes are
// or-ed into an aligned scratch of K/4 bytes, then copied behind the
// bitmap.
constexpr int PACK_ROUNDS = 2;
constexpr int TAKE_THREADS = 128;          // take_kernel: 4 to 8 slots a block
constexpr int STAGE_BUDGET = 16 * 1024;    // a block's staging buffers

__host__ __device__ __forceinline__ int pack_group(int W) {
  return W <= 256 ? 16 : 32;
}

// bytes of a group's staging: the records at the output's alignment (+15),
// room for a 4-byte word around their ends, then the bits stream
__host__ __device__ __forceinline__ int stage_rec(int subw) {
  return (subw + 35) & ~15;
}
__host__ __device__ __forceinline__ int stage_bytes(int subw, int K,
                                                    bool bits) {
  return stage_rec(subw) + (bits ? ((K / 4 + 15) & ~15) : 0);
}

// bytes [16 c, 16 c + 16) of a row (zero where ok is false; bytes past W
// are the next row's or padding, masked by the caller)
__device__ __forceinline__ uint4 load_chunk(const int8_t* row, int c, int W,
                                            bool ok) {
  uint4 r = make_uint4(0, 0, 0, 0);
  if (!ok || 16 * c >= W) return r;
  const uintptr_t p = (uintptr_t)row + 16 * (uintptr_t)c;
  const uintptr_t al = p & ~(uintptr_t)15;
  const int off = (int)(p & 15);
  const uint4 lo = __ldg((const uint4*)al);
  uint4 hi = make_uint4(0, 0, 0, 0);
  // the next word only where it holds bytes of this row (never past the
  // row's allocation)
  if (off && al + 16 < (uintptr_t)row + W)
    hi = __ldg((const uint4*)(al + 16));
  uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  const int q = off >> 2;
  const unsigned sh = 8u * (off & 3);
#pragma unroll
  for (int k = 0; k < 7; ++k) w[k] = (q & 1) ? w[k + 1] : w[k];
#pragma unroll
  for (int k = 0; k < 5; ++k) w[k] = (q & 2) ? w[k + 2] : w[k];
  return make_uint4(__funnelshift_r(w[0], w[1], sh),
                    __funnelshift_r(w[1], w[2], sh),
                    __funnelshift_r(w[2], w[3], sh),
                    __funnelshift_r(w[3], w[4], sh));
}

// 0xff in each of the low n bytes of a word (n clamped to 0..4)
__device__ __forceinline__ uint32_t low_bytes(int n) {
  return n >= 4 ? 0xffffffffu : n <= 0 ? 0u : (1u << (8 * n)) - 1u;
}

// the high bits of a word's 4 bytes (0x80 or 0) as 4 bits, byte j at bit j
__device__ __forceinline__ uint32_t byte_bits(uint32_t x) {
  return ((((x >> 7) & 0x01010101u) * 0x01020408u) >> 24) & 0xfu;
}

// a word's 4 bytes' low 2 bits as 8 bits, byte j at bits 2j, 2j + 1
__device__ __forceinline__ uint32_t byte_codes(uint32_t x) {
  return (x & 3u) | ((x >> 6) & 0xcu) | ((x >> 12) & 0x30u) |
         ((x >> 18) & 0xc0u);
}

// Chunk c's substitutions (bit i: position 16 c + i) and their nt0 codes
// (2 bits each), four bytes at a time. a: the row's sequence bytes; b: its
// tvec bytes or, gapless, the center's sequence bytes. The plain version's
// rule (sub = p < W && p < l2 && tv != 5 a, tv = b, or gapless the
// pad-to-length construction: sub = p < min(l2, l1) && b != a, code bits 2-3
// of 4 b + a) is taken per byte with __vcmpne4; a tvec compare holds
// bitwise only while 5 a fits a byte, so a chunk with a valid sequence byte
// outside 0..3 (none in real data) takes the rule byte by byte.
__device__ __forceinline__ void chunk_subs(const uint4& A, const uint4& B,
                                           bool gl, int c, int W, int l2,
                                           int mn, uint32_t& m16,
                                           uint32_t& codes) {
  const uint32_t av[4] = {A.x, A.y, A.z, A.w}, bv[4] = {B.x, B.y, B.z, B.w};
  const int base = 16 * c;
  const int nv = min(l2, W) - base, nm = min(mn, W) - base;
  bool odd = false;
  m16 = 0;
  codes = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t a = av[k], b = bv[k];
    uint32_t ne, cw;
    if (gl) {
      ne = __vcmpne4(a, b) & low_bytes(nm - 4 * k);
      cw = ((b & 0x03030303u) + ((a >> 2) & 0x03030303u)) & 0x03030303u;
    } else {
      const uint32_t vm = low_bytes(nv - 4 * k);
      odd = odd || (a & vm & 0xfcfcfcfcu) != 0;
      ne = __vcmpne4(b, a + (a << 2)) & vm;
      cw = (b >> 2) & 0x03030303u;
    }
    m16 |= byte_bits(ne) << (4 * k);
    codes |= byte_codes(cw) << (8 * k);
  }
  if (odd) {
    m16 = 0;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int a = (int)(int8_t)(av[i >> 2] >> (8 * (i & 3)));
      const int tv = (int)(int8_t)(bv[i >> 2] >> (8 * (i & 3)));
      m16 |= (uint32_t)(i < nv && tv != 5 * a) << i;
    }
  }
}

// n bytes from the staging copy src (src = dst mod 16) to dst, by a group
__device__ __forceinline__ void copy_out(uint8_t* dst, const uint8_t* src,
                                         int n, int soff, int glane, int G) {
  const int head = min(n, (16 - soff) & 15);
  for (int j = glane; j < head; j += G) dst[j] = src[j];
  const int body = (n - head) >> 4;
  const uint4* s4 = (const uint4*)(src + head);
  uint4* d4 = (uint4*)(dst + head);
  for (int j = glane; j < body; j += G) d4[j] = s4[j];
  for (int j = head + 16 * body + glane; j < n; j += G) dst[j] = src[j];
}

// One slot's substitution records (tiles: K entries pos | nt0 << 14 in
// ascending position, 0xFFFF after; bits: the position bitmap, then the
// 2-bit nt0 stream of the first K) into dst, by a group of G lanes (glane
// its lane) through its staging buffer `stage`. s1 is the row's sequence,
// tv_row its tvec row, s0 the center's sequence (a gapless row's, gl, is
// built from s1 and s0); l2, l1 the row's and the center's lengths.
// Every lane of the warp calls it together (the shuffles span the warp);
// a group that is not `active` loads and writes nothing.
template <bool BITS>
__device__ void pack_records(bool active, bool gl, int l2, int l1,
                             const int8_t* s1, const int8_t* tv_row,
                             const int8_t* s0, int W, int K, int G,
                             int glane, uint8_t* stage, uint8_t* dst) {
  const int bmb = (W + 7) >> 3;
  const int subw = BITS ? bmb + K / 4 : 2 * K;
  const int soff = (int)((uintptr_t)dst & 15);
  uint8_t* rec = stage + soff;
  uint32_t* stream = (uint32_t*)(stage + stage_rec(subw));
  if (active) {
    uint32_t* w = BITS ? stream : (uint32_t*)stage;
    const int nw = BITS ? (K + 15) / 16 : stage_rec(subw) / 4;
    for (int j = glane; j < nw; j += G) w[j] = BITS ? 0u : 0xffffffffu;
  }
  __syncwarp();
  const int mn = min(l2, l1);
  const int nch = (W + 15) >> 4;
  int count = 0;
  for (int c0 = 0; c0 < nch; c0 += G * PACK_ROUNDS) {
    // the tvec row is loaded with the sequence, before the gapless flag
    // is known; a gapless row then loads the center's instead
    uint4 A[PACK_ROUNDS], B[PACK_ROUNDS];
#pragma unroll
    for (int j = 0; j < PACK_ROUNDS; ++j) {
      const int c = c0 + j * G + glane;
      A[j] = load_chunk(s1, c, W, active);
      B[j] = load_chunk(tv_row, c, W, active);
    }
    if (gl) {
#pragma unroll
      for (int j = 0; j < PACK_ROUNDS; ++j)
        B[j] = load_chunk(s0, c0 + j * G + glane, W, active);
    }
#pragma unroll
    for (int j = 0; j < PACK_ROUNDS; ++j) {
      if (c0 + j * G >= nch) break;   // warp-uniform
      const int c = c0 + j * G + glane;
      uint32_t m16 = 0, codes = 0;
      if (active) chunk_subs(A[j], B[j], gl, c, W, l2, mn, m16, codes);
      const int cnt = __popc(m16);
      int incl = cnt;
      for (int d = 1; d < G; d <<= 1) {
        const int v = __shfl_up_sync(FULL, incl, d, G);
        if (glane >= d) incl += v;
      }
      int k = count + incl - cnt;
      count += __shfl_sync(FULL, incl, G - 1, G);
      if (BITS && active && 2 * c < bmb) {
        rec[2 * c] = m16 & 0xff;
        if (2 * c + 1 < bmb) rec[2 * c + 1] = m16 >> 8;
      }
      for (uint32_t m = m16; m && k < K; m &= m - 1, ++k) {
        const int i = __ffs(m) - 1;
        const uint32_t code = (codes >> (2 * i)) & 3;
        if (BITS) {
          atomicOr(&stream[k >> 4], code << (2 * (k & 15)));
        } else {
          const uint32_t v = (uint32_t)(16 * c + i) | (code << 14);
          rec[2 * k] = v & 0xff;
          rec[2 * k + 1] = (v >> 8) & 0xff;
        }
      }
    }
  }
  __syncwarp();
  if (BITS && active)
    for (int j = glane; j < K / 4; j += G)
      rec[bmb + j] = (stream[j >> 2] >> (8 * (j & 3))) & 0xff;
  __syncwarp();
  if (active) copy_out(dst, rec, subw, soff, glane, G);
  __syncwarp();   // the staging is the group's next slot's
}

struct TakeArgs {
  const int* order;         // [slot0 + nslots] rows (the gather mode: idx)
  const uint8_t* small;     // [n, rstride]: small13 or small5
  const int8_t* tvec;       // [n, W]
  const int8_t* seqs;       // [n, W]
  const long long* lens;    // [n]
  uint8_t* rows_out;        // [nslots, 5] (ROWS)
  uint8_t* subs_out;        // [nslots, subw]
  int slot0, nslots, n, W, rstride, center, K, G, gpb, sbytes;
};

// The follow-up (ROWS: 5-byte rows, then records) over compacted rows
// [slot0, slot0 + nslots) of order; the gather mode (ROWS false, tiles
// only) over an explicit row list, order = idx and slot0 = 0. A group of
// G lanes a slot, gpb slots a block, one slot a group: the grid covers
// every slot at once.
template <bool BITS, bool ROWS>
__global__ void __launch_bounds__(TAKE_THREADS) take_kernel(TakeArgs a) {
  extern __shared__ __align__(16) uint8_t dyn[];
  const int G = a.G;
  const int gid = threadIdx.x / G, glane = threadIdx.x % G;
  const int slot = blockIdx.x * a.gpb + gid;
  const bool active = gid < a.gpb && slot < a.nslots;
  int s = 0;
  if (active) s = src_row(a.order[a.slot0 + slot], a.n);
  const uint8_t* sm = a.small + (size_t)s * a.rstride;
  const uint8_t flags = active ? sm[a.rstride - 1] : 0;
  if (ROWS && active && glane < 5)
    a.rows_out[(size_t)slot * 5 + glane] =
        glane < 4 ? sm[glane] : flags;
  const bool gl = (flags & 2) != 0;
  const int W = a.W;
  const int subw = BITS ? ((W + 7) >> 3) + a.K / 4 : 2 * a.K;
  pack_records<BITS>(
      active, gl, active ? (int)a.lens[s] : 0, (int)a.lens[a.center],
      a.seqs + (size_t)s * W, a.tvec + (size_t)s * W,
      a.seqs + (size_t)a.center * W, W, a.K, G, glane,
      dyn + (size_t)min(gid, a.gpb - 1) * a.sbytes,
      a.subs_out + (size_t)(active ? slot : 0) * subw);
}

struct FullArgs {
  const uint8_t* small;     // [n, rstride]: small13 (screened) or small5
  const int8_t* tvec;       // [n, W]
  const int8_t* seqs;       // [n, W]
  const long long* lens;    // [n]
  const uint8_t* eth2;      // [2 nd] bf16 e_thresh (screened), [nd/8] pad
  int* order;               // [nd]
  uint8_t* buf;             // fullbuf_layout
  int4* counts;             // [gridDim.x] per-block counts
  int n, nd, W, rstride, center, M0, K, o1, o2, o3, chunk;
  int G, pack_groups, sbytes;
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

// B5's full mode, one launch; each block owns `chunk` consecutive rows.
// 1. a thread per row writes its 5-byte row into the slab, screens it
// (SCREENED) and marks sel = need & ~gapless & ~pad; a warp per 32 rows
// writes 4 bytes of the need bitmap and the group's sel count, and warp 0
// scans the groups' counts. 2. the blocks' counts, in a global workspace
// after grid.sync. Each block's warps write its rows' places in the stable
// ascending compaction (selected rows at pn.., the others at m + r - k).
// 3. after a second grid sync, the grid's groups of lanes pack the slots
// below M0,
// grid-stride (the slots' rows lie in the first blocks, so the block that
// compacted them cannot pack them alone): each slot's row index and
// substitution tile.
template <bool SCREENED>
__global__ void __launch_bounds__(THREADS) full_kernel(FullArgs a) {
  extern __shared__ __align__(16) uint8_t dyn[];
  __shared__ int red[WARPS];
  __shared__ int blk_sel;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nb = a.nd >> 3, chunk = a.chunk;
  const int lo = min((int)blockIdx.x * chunk, a.nd);
  const int hi = min(lo + chunk, a.nd);
  const int ngr = (hi - lo + 31) >> 5;
  uint8_t* stage = dyn;
  uint8_t* status = dyn + a.pack_groups * a.sbytes;
  int* gpre = (int*)(status + chunk);
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
  for (int g = warp; g < ngr; g += WARPS) {
    const int r = lo + 32 * g + lane;
    const uint8_t st = r < hi ? status[r - lo] : 0;
    const unsigned bn = __ballot_sync(FULL, st & ST_NEED);
    const int byte = (r - lane) / 8 + lane;
    if (lane < 4 && byte < nb) a.buf[a.o1 + byte] = (bn >> (8 * lane)) & 0xff;
    const int cs = __popc(__ballot_sync(FULL, st & ST_SEL));
    if (lane == 0) gpre[g] = cs;
  }
  __syncthreads();
  if (warp == 0) {   // exclusive prefix of the groups' counts
    int carry = 0;
    for (int g0 = 0; g0 < ngr; g0 += 32) {
      const int v = g0 + lane < ngr ? gpre[g0 + lane] : 0;
      int incl = v;
      for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_up_sync(FULL, incl, d);
        if (lane >= d) incl += u;
      }
      if (g0 + lane < ngr) gpre[g0 + lane] = carry + incl - v;
      carry += __shfl_sync(FULL, incl, 31);
    }
    if (lane == 0) blk_sel = carry;
  }
  __syncthreads();

  // 2. the blocks before this one and the total, then the compaction
  if (threadIdx.x == 0) a.counts[blockIdx.x] = make_int4(blk_sel, 0, 0, 0);
  cg::this_grid().sync();
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
  const unsigned lt = (1u << lane) - 1;
  for (int g = warp; g < ngr; g += WARPS) {
    const int r = lo + 32 * g + lane;
    const uint8_t st = r < hi ? status[r - lo] : 0;
    const unsigned bs = __ballot_sync(FULL, st & ST_SEL);
    const int k = pn + gpre[g] + __popc(bs & lt);   // selected rows before r
    if (r < hi) {
      if (st & ST_SEL) a.order[k] = r; else a.order[m + r - k] = r;
    }
  }
  cg::this_grid().sync();   // the order is whole past this sync

  // 3. the first M0 slots, a group of lanes a slot, grid-stride
  const int G = a.G, gpw = 32 / G;
  const int sub = lane / G, glane = lane % G;
  const int pwarps = a.pack_groups / gpw;
  if (warp >= pwarps) return;   // warp-uniform
  const int l1 = (int)a.lens[a.center];
  uint8_t* st_g = stage + (size_t)(warp * gpw + sub) * a.sbytes;
  const int stride = (int)gridDim.x * pwarps * gpw;
  for (int s0 = ((int)blockIdx.x * pwarps + warp) * gpw; s0 < a.M0;
       s0 += stride) {
    const int slot = s0 + sub;
    const bool active = slot < a.M0;
    const int r = active ? __ldcg(a.order + slot) : 0;
    const int s = src_row(r, a.n);
    const bool gl = active && (a.small[(size_t)s * a.rstride + a.rstride - 1]
                               & 2);
    if (active && glane < 4)
      a.buf[a.o2 + 4 * (size_t)slot + glane] = (r >> (8 * glane)) & 0xff;
    pack_records<false>(
        active, gl, active ? (int)a.lens[s] : 0, l1,
        a.seqs + (size_t)s * a.W, a.tvec + (size_t)s * a.W,
        a.seqs + (size_t)a.center * a.W, a.W, a.K, G, glane, st_g,
        a.buf + a.o3 + 2 * (size_t)a.K * (active ? slot : 0));
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

// The runtime's answers that depend only on the device, the kernel and its
// dynamic shared memory (the SM count, a kernel's blocks per SM), asked
// once and kept: a launch of a shape seen before makes no query.
enum Query { Q_SMS, Q_OCC };

int cached_query(Query kind, const void* fn, int smem, int* value) {
  struct Entry { Query kind; const void* fn; int dev, smem, value; };
  static std::mutex mu;
  static std::vector<Entry> seen;
  int dev = 0;
  int rc = (int)cudaGetDevice(&dev);
  if (rc) return rc;
  std::lock_guard<std::mutex> guard(mu);
  for (const Entry& e : seen)
    if (e.kind == kind && e.fn == fn && e.dev == dev && e.smem == smem) {
      *value = e.value;
      return 0;
    }
  int v = 0;
  if (kind == Q_SMS)
    rc = (int)cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
  else
    rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&v, fn, THREADS,
                                                           smem);
  if (rc) return rc;
  seen.push_back(Entry{kind, fn, dev, smem, v});
  *value = v;
  return 0;
}

// B5's grid rule for a cooperative launch of fn over nd rows: as many
// blocks as fit on the card at once (occupancy x SMs), at most one per 32
// rows and one per workspace entry; rows per block (chunk) a multiple of
// 32, so a warp's ballot covers 4 whole bitmap bytes of one block; lb
// bytes of dynamic shared memory before the rows', per8 eighths of a byte
// a row.
int coop_grid(const void* fn, int nd, int counts_cap, int lb, int per8,
              int* G_out, int* chunk_out, int* smem_out) {
  int sms = 0;
  int rc = cached_query(Q_SMS, nullptr, 0, &sms);
  if (rc) return rc;
  int G = ceil_div(nd, 32) < counts_cap ? ceil_div(nd, 32) : counts_cap;
  int chunk = 0, smem = 0, fits = 0;
  for (int it = 0; it < 16 && !fits; ++it) {
    chunk = ceil_div(ceil_div(nd, G), 32) * 32;
    G = ceil_div(nd, chunk);
    smem = lb + (chunk * per8) / 8;
    if (smem > MAX_DYN_SMEM) return (int)cudaErrorInvalidValue;
    int occ = 0;
    rc = cached_query(Q_OCC, fn, smem, &occ);
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

// groups of a block that can stage their records within STAGE_BUDGET, a
// multiple of the groups a warp holds, at least one warp's
int staged_groups(int groups, int gpw, int sbytes) {
  while (groups > gpw && groups * sbytes > STAGE_BUDGET) groups -= gpw;
  return groups;
}

// past 48 KB a kernel's dynamic shared memory needs the opt-in
int allow_smem(const void* fn, int smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
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
  int rc = coop_grid(fn, nd, counts_cap, compute ? lerr_bytes(Q) : 0, 8, &G,
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
  const int G = pack_group(W), gpw = 32 / G;
  const int subw = bits ? (W + 7) / 8 + K / 4 : 2 * K;
  const int sbytes = stage_bytes(subw, K, bits != 0);
  const int gpb = staged_groups(TAKE_THREADS / G, gpw, sbytes);
  const int smem = gpb * sbytes;
  TakeArgs a{(const int*)order,  (const uint8_t*)small, (const int8_t*)tvec,
             (const int8_t*)seqs, (const long long*)lens, (uint8_t*)rows_out,
             (uint8_t*)subs_out, slot0, nslots, n, W, rstride, center, K, G,
             gpb, sbytes};
  const void* fn = !rows_out ? (const void*)take_kernel<false, false>
                   : bits    ? (const void*)take_kernel<true, true>
                             : (const void*)take_kernel<false, true>;
  int rc = allow_smem(fn, smem);
  if (rc) return rc;
  void* params[] = {&a};
  rc = (int)cudaLaunchKernel(fn, dim3(ceil_div(nslots, gpb)), dim3(gpb * G),
                             params, (size_t)smem, (cudaStream_t)stream);
  if (rc) return rc;
  return (int)cudaGetLastError();
}

// B5's full mode: the full compare's buffer (layout
// ops/store_screen.py::fullbuf_layout; o1..o3 are its offsets) and the
// compaction order, in one cooperative launch of at most a block an SM
// (fewer, fuller blocks sync faster, and a block's rows are a few a
// thread). counts is a workspace of counts_cap int4.
extern "C" int store_screen_full(const void* small, const void* tvec,
                                 const void* seqs, const void* lens,
                                 const void* eth2, void* order, void* buf,
                                 int n, int nd, int W, int rstride,
                                 int center, int screened,
                                 int M0, int K, int o1, int o2, int o3,
                                 float c5L, float cL5, void* counts,
                                 int counts_cap, void* stream) {
  const void* fn = screened ? (const void*)full_kernel<true>
                            : (const void*)full_kernel<false>;
  const int G = pack_group(W), gpw = 32 / G;
  const int sbytes = stage_bytes(2 * K, K, false);
  const int pg = staged_groups(THREADS / G, gpw, sbytes);
  const int lb = pg * sbytes;
  int G_blocks = 0, chunk = 0, smem = 0, sms = 0;
  int rc = cached_query(Q_SMS, nullptr, 0, &sms);
  if (rc) return rc;
  // a row's shared memory: its status byte and an eighth of its 32-row
  // group's int prefix count
  rc = coop_grid(fn, nd, min(counts_cap, sms), lb, 9, &G_blocks, &chunk,
                 &smem);
  if (rc) return rc;
  FullArgs a{(const uint8_t*)small, (const int8_t*)tvec,
             (const int8_t*)seqs,   (const long long*)lens,
             (const uint8_t*)eth2,  (int*)order,
             (uint8_t*)buf,         (int4*)counts,
             n, nd, W, rstride, center, M0, K, o1, o2, o3, chunk,
             G, pg, sbytes, c5L, cL5};
  void* params[] = {&a};
  rc = (int)cudaLaunchCooperativeKernel(fn, dim3(G_blocks), dim3(THREADS),
                                        params, (size_t)smem,
                                        (cudaStream_t)stream);
  if (rc) return rc;
  return (int)cudaGetLastError();
}
