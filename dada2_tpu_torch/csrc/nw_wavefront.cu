// Banded ends-free Needleman-Wunsch on the wavefront, for Hopper: one
// fill (fill_pair) under two kernels: nw_compare_kernel<RPT, MODE>
// serves B1 compare (MODE_B1), B2 pairs' class rows (MODE_CLS) and B3
// kinds (MODE_KINDS), chosen at compile time; nw_wavefront_kernel<RPT>
// serves B2 stats.
//
// Replaces the TPU kernel dada2_tpu/ops/nw_pallas.py::_make_kernel as
// launched by _pallas_call (end_gap_p = 0) in its three modes:
//   B1 compare (emit_kinds=False, s1_per_block=False; caller
//      dada2_tpu/core/backend_tpu.py _fused_align_base): one center s1
//      shared by every lane;
//   B2 pairs (emit_kinds="cls", s1_per_block=True; caller
//      dada2_tpu/chimeras.py _pairs_lr_stats): every lane carries its own
//      query, len1 is block-uniform; adds the per-diagonal alignment-column
//      class;
//   B3 kinds (emit_kinds=True; caller nw_pallas.py nw_pallas_grouped):
//      as B1, adds the raw per-diagonal traceback kind.
// and a fourth mode for the chimera route, B2 stats (nw_wavefront_kernel,
// entry nw_pairs_stats_run): B2's alignments, with the lr/ham statistics that
// dada2_tpu/chimeras.py::_lr_accum_pairs_trace derives from the class rows
// computed inside the kernel, so that only one row of six int32 per pair
// reaches device memory.
// Same arrays in and out as the TPU kernel, bit for bit:
//   scal   [nb, 4]          int32  len1, len2max (C), rbmax, len2min per block
//   params [nb, 8, 128]     int32  rows 0..2: len2, lband, rband per lane
//   s1     [L1R, 128]       int32  row m = center char s1[m-1] (B1, B3), or
//          [nb, L1R, 128]          per block and lane (B2, B2 stats)
//   s2q    [nb, L2R, 128]   int32  row C-j = (qual << 2) | nt of s2[j-1]
//   kinds  [nb, NDP, 128]   int32  B3: row d = traceback kind of the step
//                                  taken on diagonal d (1 diag, 2 left,
//                                  3 up), 0 where no step was taken;
//                                  B2: row d = column class (1 s2-insertion
//                                  = left, 2 s1-char vs gap = up,
//                                  3 substitution, 4 match), 0 where no
//                                  step was taken (not written in B1)
//   sub    [nb, L2R, 128]   int32  row C-j = 1 + nt0 where the aligned
//                                  column (i, j) is a substitution, else 0
//   mapq   [nb, L1R, 128]   int32  row i: (q << 17) | (j << 3) | (nt1 + 2)
//                                  for a diagonal step, 1 for an up step,
//                                  0 where center position i is unconsumed
//   end    [nb, 8, 128]     int32  rows 0, 1: final (i, j); ok iff both 0
//   stats  [nb * 128, 6]    int32  B2 stats only (no kinds, sub, mapq or
//                                  end): row block * 128 + lane = left,
//                                  right, left_oo, right_oo, ham, end0|end1
// Semantics are the vectorized aligner's (reference:
// src/nwalign_vectorized.cpp:71-318): tie precedence up >= left > diag,
// band widened on the long side, the ends-free last-row/last-column
// recalculation activating one diagonal late. The window origin
// o(d) = max(0, d - C, ceil((d - rbmax) / 2)) and window width WP are the
// TPU kernel's, so cells it leaves outside the window stay outside here.
// The statistics are the reference's get_lr / get_ham_endsfree
// (src/chimera.cpp:196-269) in the column-space form of
// dada2_tpu_torch/chimeras.py::_lr_ham_batch.
//
// What bounds it on the card: the bytes are small (the arrays above, read
// or written once), so the roofline bound is the fill's integer work: 13
// int32 operations per in-band cell that the recurrence needs (itemised
// in chip_smoke.py; the borders, band tests and ends-free recalculations
// are needed only at the band's edges and on the last row and column, so
// the bound leaves them out). In practice each pair is a chain of
// len1 + len2 dependent anti-diagonal steps followed by a serial traceback
// of the same length, so the instructions issued per diagonal step and
// the chain's latency limit it.
//
// Design: one warp per pair (a pair = one lane of a 128-lane block), the
// window rows on the warp's threads (WP / 32 rows per thread, WP <= 128).
// Each thread keeps its rows' scores of diagonals d-1 and d-2 in
// registers, and the three neighbours of a cell (left and up on d-1,
// diagonal on d-2) follow from the warp-uniform origin shifts
// s1w = o(d) - o(d-1) in {0, 1} and s2w = o(d) - o(d-2) - 1 in {-1, 0, 1}:
// left is row r + s1w of d-1 and up row r + s1w - 1, so one __shfl_sync
// (rows r + 1 or r - 1) gives the one of them that is not the thread's
// own row; diagonal is row r + s2w of d-2, which is the thread's own row
// when s2w = 0 and otherwise exactly the previous step's shuffle. So one
// shuffle per row and diagonal, no shared-memory ring and no barrier per
// step. The band is a warp-uniform row range per diagonal; the borders
// and the ends-free recalculations touch at most one cell of a diagonal,
// so the fill runs in three phases: the first max(lb, rb) diagonals with
// every check, the middle without the border and recalculation checks
// and unrolled sixteen diagonals (one slab word) per pass, and the last
// diagonals with the recalculations. The max-with-pointer of the
// recurrence is Hopper's DPX: __vibmax_s32 for up against left (its
// predicate is the pointer), __viaddmax_s32 for that against diagonal +
// substitution score. Thousands of pairs are in flight at once, which
// hides the per-step latency. The 2-bit pointers are packed sixteen
// diagonals to a 32-bit word in shared memory (4 * ceil(NDP / 16) * WP
// bytes per pair, one funnel shift per cell) and never touch device
// memory; the center and candidate columns are staged into shared memory
// once, and the traceback runs from shared memory on one lane per pair.
// B1, B2 and B3 (nw_compare_kernel) hold up to 32 pairs per block; B1
// and B3 stage their center once per block, B2 each pair's own query
// beside its candidate. After a block barrier lane p of warp 0 traces
// pair p back, so one warp's instructions serve P tracebacks, and
// compare_pairs picks P from the geometry, the launch's size and the
// card's occupancy of the instantiation at hand. B3 adds the kinds rows
// and B2 the class rows: the prologue zeroes them (P consecutive lanes a
// row, beside sub and mapq), and each traceback step stores its kind or
// class with one predicated store at a pointer that follows d = i + j.
// B2 stats (nw_wavefront_kernel) holds up to 4 pairs per block, and lane
// 0 of each pair's warp traces it back. In
// B2 stats the traceback writes each alignment column's class as one byte
// into a per-pair column buffer in shared memory (from the end, so the m
// columns lie in forward order at buf[NDP-m..NDP-1]) and the warp then
// scans that buffer 32 columns at a time (__ballot_sync + __ffs / __popc)
// for the first-index searches and masked counts of the statistics. The
// uniform-origin storage tricks, `halves` and the four-diagonal chunking
// of the TPU kernel were workarounds for its layout and loop overhead and
// are not reproduced.
#include <cuda_runtime.h>

#define LANES 128
#define NEG (-(1 << 29))
#define SMEM_MAX 232448  // 227 KB: the most one block may use on sm_90
#define FULL 0xffffffffu

// nw_compare_kernel's modes, numbered as the C entry's
enum Mode { MODE_B1 = 1, MODE_CLS = 2, MODE_KINDS = 3 };

struct Args {
  const int* scal;
  const int* params;
  const int* s1;
  const int* s2q;
  int* kinds;
  int* sub;
  int* mapq;
  int* endo;
  int* stats;
  int L1R, L2R, NDP, ppb, match, mismatch, gap_p, allow_one_off, max_shift;
};

// One pair's shared memory in B2 stats: the s2 and s1 columns (one byte
// per char: the stats read no qualities), the column buffer (NDP bytes)
// and the pointer slab (one word per row and 16 diagonals).
struct Layout {
  int s1, buf, slab, bytes;
};

__host__ __device__ static inline Layout pair_layout(int L1R, int L2R,
                                                     int NDP, int WP) {
  Layout o;
  o.s1 = L2R;
  o.buf = o.s1 + L1R;
  o.slab = (o.buf + NDP + 15) & ~15;
  o.bytes = o.slab + 4 * ((NDP + 15) / 16) * WP;
  return o;
}

__device__ __forceinline__ int origin(int d, int C, int rbmax) {
  int a = d - C;
  int b = (d - rbmax + 1) >> 1;  // arithmetic shift: floor, as in the TPU
  int m = a > b ? a : b;
  return m > 0 ? m : 0;
}

// ---- fill: the per-diagonal step ----
// One pair's fill on one thread of its warp: the thread's rows r = t + 32k
// of the window, their scores on diagonals d-1 (P1) and d-2 (P2), rows
// r +- 1 of d-2 (X, the previous step's shuffle) and the 2-bit pointers
// of the current slab word (acc, the newest diagonal in the top bits).
// step<EDGE, LATE>(d) computes diagonal d; EDGE adds the border cells
// (i == 0, j == 0), LATE the ends-free recalculations, so the diagonals
// that can hold neither run without their checks.
template <int RPT, bool STATS, typename CT>
struct Fill {
  static constexpr int WP = RPT * 32;
  const CT* s1c;
  const CT* s2c;
  unsigned* slab;
  int t, L1R, L2R, C, rbmax, len1, l2, lb, rb, dr0, dc0;
  int match, mismatch, gap_p;
  int srcm, srcp;    // lanes t - 1 and t + 1, mod 32
  bool wrapm, wrapp; // t == 0, t == 31
  int P1[RPT], P2[RPT], X[RPT];
  unsigned acc[RPT];
  int om1, s1p;      // o(d-1), o(d-1) - o(d-2)

  template <bool EDGE, bool LATE>
  __device__ __forceinline__ void step(const int d) {
    const int od = origin(d, C, rbmax);
    const int s1w = od - om1;  // 0 or 1; s2w = s1w + s1p - 1
    // rows r + 1 (s1w = 1) or r - 1 (s1w = 0) of diagonal d-1: one shuffle
    // per register; the lane that wraps takes the neighbouring register,
    // and a row outside [0, WP) reads NEG, as outside the window
    const int src = s1w ? srcp : srcm;
    const bool wrap = s1w ? wrapp : wrapm;
    int y[RPT], Y[RPT];
#pragma unroll
    for (int k = 0; k < RPT; ++k) y[k] = __shfl_sync(FULL, P1[k], src);
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      const int above = k + 1 < RPT ? y[k + 1 < RPT ? k + 1 : k] : NEG;
      const int below = k > 0 ? y[k > 0 ? k - 1 : 0] : NEG;
      Y[k] = wrap ? (s1w ? above : below) : y[k];
    }
    // the band as a row range: i - j <= lb, j - i <= rb, i <= len1,
    // 0 <= j <= l2, with i = od + r and j = d - i
    const int ilo = max((d - rb + 1) >> 1, d - l2);
    const int ihi = min(min((d + lb) >> 1, len1), d);
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      const int r = t + 32 * k;
      const int i = od + r;
      // left (i, j-1) is row r + s1w of d-1, up (i-1, j) row r + s1w - 1;
      // diagonal (i-1, j-1) is row r + s2w of d-2: the previous step's
      // shuffle when s2w != 0 (then s1w == s1p), else the row itself
      const int Lr = s1w ? Y[k] : P1[k];
      const int Ur = s1w ? P1[k] : Y[k];
      const int Dr = s1w == s1p ? X[k] : P2[k];
      const bool inb = i >= ilo && i <= ihi;
      // out of band the clamped reads stay inside this pair's columns
      // (C - d + i >= 0 because o(d) >= d - C) and the cell becomes NEG
      const int c1 = s1c[min(i, L1R - 1)];
      const int sq = s2c[min(C - d + i, L2R - 1)];
      const int sc = c1 == (STATS ? sq : sq & 3) ? match : mismatch;
      // up >= left > diag: left wins only if strictly greater than up,
      // the diagonal only if strictly greater than both
      bool up;
      const int h = __vibmax_s32(Ur, Lr, &up) + gap_p;
      int entry = __viaddmax_s32(Dr, sc, h);
      int ptr = entry != h ? 1 : up ? 3 : 2;
      entry = inb ? entry : NEG;
      ptr = inb ? ptr : 0;
      if (EDGE) {
        if (inb && i == d) {  // j == 0: i * end_gap_p
          entry = 0;
          ptr = 3;
        }
        if (inb && i == 0) {  // j * end_gap_p
          entry = 0;
          ptr = 2;
        }
      }
      if (LATE) {
        if (inb && d >= dr0 && i == len1) {
          // score(len1, j-1) on diagonal d-1, 0 outside the window (the
          // TPU kernel's masked row sum), plus end_gap_p = 0
          const int candr = r + s1w < WP ? Lr : 0;
          if (candr > entry) {
            entry = candr;
            ptr = 2;
          } else if (candr == entry && ptr == 1) {
            ptr = 2;
          }
        }
        if (inb && d >= dc0 && i == d - l2) {
          const int candc = Ur;  // U - gap_p + end_gap_p
          if (candc > entry) {
            entry = candc;
            ptr = 3;
          } else if (candc == entry && ptr != 3) {
            ptr = 3;
          }
        }
      }
      acc[k] = __funnelshift_r(acc[k], (unsigned)ptr, 2);
      P2[k] = P1[k];
      P1[k] = entry;
      X[k] = Y[k];
    }
    s1p = s1w;
    om1 = od;
  }

  // the slab word of diagonals 16q .. 16q + 15 (d = 16q + 15): diagonal
  // 16q + m sits in bits 2m
  __device__ __forceinline__ void store(const int d) {
#pragma unroll
    for (int k = 0; k < RPT; ++k) slab[(d >> 4) * WP + t + 32 * k] = acc[k];
  }
};
// ---- end of fill: the per-diagonal step ----

// ---- fill: one pair's diagonals 1 .. len1 + l2, in three phases ----
// Run by the pair's warp (thread t of 32); the pointers are 2-bit
// pointers into `slab`, one word per window row and sixteen diagonals.
template <int RPT, bool STATS, typename CT>
__device__ __forceinline__ void fill_pair(const CT* s1c, const CT* s2c,
                                          unsigned* slab, const int t,
                                          const Args& a, const int C,
                                          const int rbmax, const int len1,
                                          const int l2, const int lb,
                                          const int rb) {
  constexpr int WP = RPT * 32;
  const int nd = len1 + l2;  // later diagonals never reach the traceback
  Fill<RPT, STATS, CT> f;
  f.s1c = s1c;
  f.s2c = s2c;
  f.slab = slab;
  f.t = t;
  f.L1R = a.L1R;
  f.L2R = a.L2R;
  f.C = C;
  f.rbmax = rbmax;
  f.len1 = len1;
  f.l2 = l2;
  f.lb = lb;
  f.rb = rb;
  // the ends-free recalculations' cells, one diagonal late, only where
  // the band clips that side (reference: src/nwalign_vectorized.cpp:
  // 186-215): row len1 from diagonal dr0 on (j > j_first), column l2
  // from diagonal dc0 on (i > i_first)
  const int j_first = lb < len1 ? len1 - lb : 0;
  const int i_first = rb < l2 ? l2 - rb : 0;
  f.dr0 = len1 > 0 ? len1 + j_first + 1 : nd + 1;
  f.dc0 = l2 > 0 ? l2 + i_first + 1 : nd + 1;
  f.match = a.match;
  f.mismatch = a.mismatch;
  f.gap_p = a.gap_p;
  f.srcm = (t + 31) & 31;
  f.srcp = (t + 1) & 31;
  f.wrapm = t == 0;
  f.wrapp = t == 31;
  // diagonal 0 holds only cell (0, 0) = 0, diagonal -1 nothing
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    f.P1[k] = t + 32 * k == 0 ? 0 : NEG;
    f.P2[k] = NEG;
    f.X[k] = NEG;
    f.acc[k] = 0u;
  }
  f.om1 = 0;
  f.s1p = 0;
  int d = 1;
  // diagonals that may hold a border cell (d <= lb or d <= rb): all checks
  for (const int e = min(lb > rb ? lb : rb, nd); d <= e; ++d) {
    f.template step<true, true>(d);
    if ((d & 15) == 15) f.store(d);
  }
  // the middle, before the first recalculation: neither check, one slab
  // word (16 diagonals) per pass
  const int m_end = min(min(f.dr0, f.dc0) - 1, nd);
  for (; d <= m_end && (d & 15) != 0; ++d) {
    f.template step<false, false>(d);
    if ((d & 15) == 15) f.store(d);
  }
  for (; d + 15 <= m_end; d += 16) {
#pragma unroll
    for (int q = 0; q < 16; ++q) f.template step<false, false>(d + q);
    f.store(d + 15);
  }
  for (; d <= m_end; ++d) f.template step<false, false>(d);
  // the last diagonals, where the recalculations apply
  for (; d <= nd; ++d) {
    f.template step<false, true>(d);
    if ((d & 15) == 15) f.store(d);
  }
  if ((nd & 15) != 15) {  // flush the trailing partial word
#pragma unroll
    for (int k = 0; k < RPT; ++k)
      slab[(nd >> 4) * WP + t + 32 * k] =
          f.acc[k] >> (2 * (15 - (nd & 15)));
  }
  __syncwarp();
}
// ---- end of fill: one pair's diagonals ----

// ---- B2 stats: warp scans over one pair's column buffer ----
// Column k of the alignment (0 <= k < m) sits at buf[NDP - m + k]; REV
// reads the columns from the end (column k of the reversed alignment).
template <bool REV>
__device__ __forceinline__ int col_at(const unsigned char* buf, int NDP,
                                      int m, int k) {
  return REV ? buf[NDP - 1 - k] : buf[NDP - m + k];
}

// The first column k >= start (k < m) whose class c satisfies
// pred(c, k), else m: 32 columns per ballot.
template <bool REV, class Pred>
__device__ __forceinline__ int warp_first(const unsigned char* buf, int NDP,
                                          int m, int start, int t,
                                          Pred pred) {
  for (int k0 = start; k0 < m; k0 += 32) {
    const int k = k0 + t;
    const bool hit = k < m && pred(col_at<REV>(buf, NDP, m, k), k);
    const unsigned bal = __ballot_sync(FULL, hit);
    if (bal) return k0 + __ffs(bal) - 1;
  }
  return m;
}

// One directional credit scan (reference: get_lr, src/chimera.cpp:228-269;
// column form chimeras.py::_lr_one_side): skip the leading s2-insertion
// run (class 1), credit the s1-vs-gap overhang (class 2) while the column
// is below shift_bound, then the match run (class 4); with one-off, the
// column after the run counts unless it is an s2-insertion, and the match
// run after it is credited too. Returns q0, the end of the class-1 run.
template <bool REV>
__device__ __forceinline__ int one_side(const unsigned char* buf, int NDP,
                                        int m, int t, int shift_bound,
                                        bool allow_one_off, int& credit,
                                        int& credit_oo) {
  const int q0 = warp_first<REV>(buf, NDP, m, 0, t,
                                 [](int c, int) { return c != 1; });
  const int s = warp_first<REV>(
      buf, NDP, m, q0, t,
      [shift_bound](int c, int k) { return !(c == 2 && k < shift_bound); });
  const int e = warp_first<REV>(buf, NDP, m, s, t,
                                [](int c, int) { return c != 4; });
  credit = e - q0;
  credit_oo = credit;
  if (allow_one_off && e + 1 < m) {
    const int n = e + 1;
    const int bonus = col_at<REV>(buf, NDP, m, n) != 1;
    const int f = warp_first<REV>(buf, NDP, m, n, t,
                                  [](int c, int) { return c != 4; });
    credit_oo = credit + bonus + (f - n);
  }
  return q0;
}

template <int RPT>
__global__ void nw_wavefront_kernel(const Args a) {
  constexpr int WP = RPT * 32;
  extern __shared__ __align__(16) unsigned char smem[];
  const int L1R = a.L1R, L2R = a.L2R, NDP = a.NDP, ppb = a.ppb;
  const Layout lay = pair_layout(L1R, L2R, NDP, WP);
  const int warp = threadIdx.x >> 5;
  const int t = threadIdx.x & 31;
  const int pair0 = blockIdx.x * ppb;  // ppb divides LANES
  const int b = pair0 / LANES;
  const int lane0 = pair0 % LANES;

  // ---- stage the char columns, one byte per char ----
  for (int k = threadIdx.x; k < L2R * ppb; k += blockDim.x) {
    int row = k / ppb, l = k % ppb;
    size_t g = ((size_t)b * L2R + row) * LANES + lane0 + l;
    (smem + (size_t)l * lay.bytes)[row] = (unsigned char)(a.s2q[g] & 3);
  }
  for (int k = threadIdx.x; k < L1R * ppb; k += blockDim.x) {
    int row = k / ppb, l = k % ppb;
    size_t g = ((size_t)b * L1R + row) * LANES + lane0 + l;
    const int v = a.s1[g];
    // only equality with an nt code (0..3) matters here: any other code
    // becomes 4, which matches none
    (smem + (size_t)l * lay.bytes + lay.s1)[row] =
        (unsigned char)((unsigned)v < 4u ? v : 4);
  }
  __syncthreads();

  const int lane = lane0 + warp;
  unsigned char* mine = smem + (size_t)warp * lay.bytes;
  const unsigned char* s2c = mine;
  const unsigned char* s1c = mine + lay.s1;
  unsigned char* buf = mine + lay.buf;
  unsigned* slab = (unsigned*)(mine + lay.slab);

  const int len1 = a.scal[b * 4 + 0];
  const int C = a.scal[b * 4 + 1];
  const int rbmax = a.scal[b * 4 + 2];
  const int l2 = a.params[((size_t)b * 8 + 0) * LANES + lane];
  const int lb = a.params[((size_t)b * 8 + 1) * LANES + lane];
  const int rb = a.params[((size_t)b * 8 + 2) * LANES + lane];
  int* srow_out = a.stats + ((size_t)b * LANES + lane) * 6;

  // geometry the buffers cannot hold: report a failed traceback
  if (len1 < 0 || l2 < 0 || l2 > C || C > L2R || len1 >= L1R ||
      len1 + C >= NDP) {
    if (t == 0) {
      for (int q = 0; q < 5; ++q) srow_out[q] = 0;
      srow_out[5] = (len1 > 0 ? len1 : 1) | l2;
    }
    return;
  }

  // ---- fill ----
  fill_pair<RPT, true, unsigned char>(s1c, s2c, slab, t, a, C, rbmax, len1,
                                      l2, lb, rb);
  // ---- end of fill ----

  // ---- traceback from (len1, len2) ----
  // The cell in hand always lies on diagonal d = i + j; each step writes
  // its column's class into buf, from the end.
  int i = len1, j = l2, m = 0;
  if (t == 0) {
    while (i + j >= 1) {
      const int d = i + j;
      const int r = i - origin(d, C, rbmax);
      const int kind =
          (r >= 0 && r < WP) ? (slab[(d >> 4) * WP + r] >> (2 * (d & 15))) & 3
                             : 0;
      if (kind == 1) {
        buf[NDP - 1 - m++] = s1c[i] != s2c[C - j] ? 3 : 4;
        --i;
        --j;
      } else if (kind == 3) {
        buf[NDP - 1 - m++] = 2;
        --i;
      } else if (kind == 2) {
        buf[NDP - 1 - m++] = 1;
        --j;
      } else {
        // no pointer here: the traceback is stuck, end != (0, 0). The TPU
        // kernel still classes this active step (as 4, "not an insertion,
        // gap or substitution"), so the column buffer does too.
        buf[NDP - 1 - m++] = 4;
        break;
      }
    }
  }
  // ---- end of traceback ----

  // ---- B2 stats: the warp scans the m columns ----
  __syncwarp();
  m = __shfl_sync(FULL, m, 0);
  const bool aoo = a.allow_one_off != 0;
  int left, left_oo, right, right_oo;
  const int q0f =
      one_side<false>(buf, NDP, m, t, a.max_shift, aoo, left, left_oo);
  const int q0r =
      one_side<true>(buf, NDP, m, t, a.max_shift - 1, aoo, right, right_oo);
  // ends-free hamming: trim the longer leading gap run on each side,
  // count the non-match columns in between (get_ham_endsfree)
  const int g2f = warp_first<false>(buf, NDP, m, 0, t,
                                    [](int c, int) { return c != 2; });
  const int g2r = warp_first<true>(buf, NDP, m, 0, t,
                                   [](int c, int) { return c != 2; });
  const int startc = q0f > g2f ? q0f : g2f;
  const int end = m - (q0r > g2r ? q0r : g2r);
  int ham = 0;
  for (int k0 = startc; k0 < end; k0 += 32) {
    const int k = k0 + t;
    ham += __popc(__ballot_sync(
        FULL, k < end && col_at<false>(buf, NDP, m, k) != 4));
  }
  if (t == 0) {
    srow_out[0] = left;
    srow_out[1] = right;
    srow_out[2] = left_oo;
    srow_out[3] = right_oo;
    srow_out[4] = ham;
    srow_out[5] = i | j;
  }
}

// ---- B1 compare, B2 class rows and B3 kinds: P pairs per block, the
// tracebacks one lane per pair ----
// The block's P warps each fill one pair with fill_pair, as B2 stats
// does; then, after one block barrier, lane p of warp 0 traces pair p
// back while the other warps have finished. In B1 and B3 every lane
// aligns the same center, so the s1 column is staged once per block (the
// kernel reads the column of the block's first lane; the caller gives
// 128 equal columns); in B2 (MODE_CLS) every lane carries its own query,
// staged in its pair's slot. The columns stay int32: the walk writes the
// raw s1 code into sub and s2q's quality into mapq. Layout: the center
// column (not in B2), then per pair its s2 column, its s1 column (B2
// only) and its slab; the pair stride is an odd number of words, so the
// P traceback lanes reading one offset of their own pairs fall in P
// different banks. B2 and B3 write the same sub, mapq and end as B1, and
// the class or kinds rows besides.
struct CmpLayout {
  int center, s1, slab, stride;
};

__host__ __device__ static inline CmpLayout compare_layout(int L1R, int L2R,
                                                          int NDP, int WP,
                                                          int mode) {
  const bool lane_s1 = mode == MODE_CLS;
  CmpLayout o;
  o.center = lane_s1 ? 0 : (4 * L1R + 15) & ~15;
  o.s1 = 4 * L2R;
  o.slab = 4 * (L2R + (lane_s1 ? L1R : 0));
  o.stride = 4 * ((o.slab / 4 + (NDP + 15) / 16 * WP) | 1);
  return o;
}

static inline int compare_bytes(int L1R, int L2R, int NDP, int WP, int P,
                                int mode) {
  const CmpLayout o = compare_layout(L1R, L2R, NDP, WP, mode);
  return o.center + P * o.stride;
}

// geometry the buffers cannot hold: the pair reports a failed traceback
__device__ __forceinline__ bool bad_geometry(int len1, int l2, int C,
                                             int L1R, int L2R, int NDP) {
  return len1 < 0 || l2 < 0 || l2 > C || C > L2R || len1 >= L1R ||
         len1 + C >= NDP;
}

// *p = v on the lanes where `on` holds, as one predicated store (no branch)
__device__ __forceinline__ void store_if(int* p, int v, bool on) {
#ifdef __CUDA_ARCH__
  asm volatile(
      "{\n\t.reg .pred q;\n\tsetp.ne.u32 q, %2, 0;\n\t"
      "@q st.global.u32 [%0], %1;\n\t}" ::"l"(p),
      "r"(v), "r"((unsigned)on)
      : "memory");
#else
  if (on) *p = v;
#endif
}

template <int RPT, int MODE>
__global__ void nw_compare_kernel(const Args a) {
  constexpr int WP = RPT * 32;
  constexpr bool LANE_S1 = MODE == MODE_CLS;  // a query per lane
  constexpr bool ROWS = MODE != MODE_B1;      // class or kinds rows
  extern __shared__ __align__(16) unsigned char smem[];
  const int L1R = a.L1R, L2R = a.L2R, NDP = a.NDP, P = a.ppb;
  const int lgP = __ffs(P) - 1;  // P is a power of two dividing LANES
  const CmpLayout lay = compare_layout(L1R, L2R, NDP, WP, MODE);
  const int warp = threadIdx.x >> 5;
  const int t = threadIdx.x & 31;
  const int pair0 = blockIdx.x * P;
  const int b = pair0 / LANES;
  const int lane0 = pair0 % LANES;
  int* center = (int*)smem;  // B1, B3
  unsigned char* pairs = smem + lay.center;

  // ---- zero the block's output rows (P consecutive lanes each), stage
  // the center once (B1, B3) or every pair's query (B2), and every pair's
  // s2 column ----
  if (!LANE_S1)
    for (int k = threadIdx.x; k < L1R; k += blockDim.x)
      center[k] = a.s1[(size_t)k * LANES + lane0];
  for (int k = threadIdx.x; k < L2R * P; k += blockDim.x) {
    const int row = k >> lgP, l = k & (P - 1);
    const size_t g = ((size_t)b * L2R + row) * LANES + lane0 + l;
    a.sub[g] = 0;
    ((int*)(pairs + (size_t)l * lay.stride))[row] = a.s2q[g];
  }
  for (int k = threadIdx.x; k < L1R * P; k += blockDim.x) {
    const int row = k >> lgP, l = k & (P - 1);
    const size_t g = ((size_t)b * L1R + row) * LANES + lane0 + l;
    a.mapq[g] = 0;
    if (LANE_S1)
      ((int*)(pairs + (size_t)l * lay.stride + lay.s1))[row] = a.s1[g];
  }
  // B2, B3: every class or kinds row starts at 0, the value of a diagonal
  // without a step
  if (ROWS)
    for (int k = threadIdx.x; k < NDP * P; k += blockDim.x)
      a.kinds[((size_t)b * NDP + (k >> lgP)) * LANES + lane0 +
              (k & (P - 1))] = 0;
  for (int k = threadIdx.x; k < 6 * P; k += blockDim.x)
    a.endo[((size_t)b * 8 + 2 + (k >> lgP)) * LANES + lane0 + (k & (P - 1))] =
        0;
  __syncthreads();

  const int len1 = a.scal[b * 4 + 0];
  const int C = a.scal[b * 4 + 1];
  const int rbmax = a.scal[b * 4 + 2];
  {  // warp w fills pair w; a pair whose geometry fails skips its fill
    const int lane = lane0 + warp;
    unsigned char* mine = pairs + (size_t)warp * lay.stride;
    const int l2 = a.params[((size_t)b * 8 + 0) * LANES + lane];
    // ---- fill ----
    if (!bad_geometry(len1, l2, C, L1R, L2R, NDP))
      fill_pair<RPT, false, int>(
          LANE_S1 ? (const int*)(mine + lay.s1) : center, (const int*)mine,
          (unsigned*)(mine + lay.slab), t, a, C, rbmax, len1, l2,
          a.params[((size_t)b * 8 + 1) * LANES + lane],
          a.params[((size_t)b * 8 + 2) * LANES + lane]);
    // ---- end of fill ----
  }
  __syncthreads();
  if (warp != 0 || t >= P) return;

  // ---- traceback, one lane per pair: lane t of warp 0 walks pair t ----
  // The cell in hand lies on diagonal d = i + j. Each step is branch-free:
  // the kind selects the moves, the stores are predicated and the lanes
  // that are done step with kind 0, so the P lanes stay converged; the
  // output addresses follow (i, j) incrementally. Lanes of one block share
  // len1, so while their paths agree their mapq (and the kinds or class)
  // stores land in P consecutive words.
  const int lane = lane0 + t;
  const int l2 = a.params[((size_t)b * 8 + 0) * LANES + lane];
  const bool bad = bad_geometry(len1, l2, C, L1R, L2R, NDP);
  const unsigned char* slot = pairs + (size_t)t * lay.stride;
  const int* s1c = LANE_S1 ? (const int*)(slot + lay.s1) : center;
  const int* s2c = (const int*)slot;
  const unsigned* slab = (const unsigned*)(slot + lay.slab);
  // a pair whose geometry fails stays at (0, 0), where every read is in
  // its buffers, and reports (max(len1, 1), len2)
  int i = bad ? 0 : len1;
  int j = bad ? 0 : l2;
  int* mq = a.mapq + ((size_t)b * L1R + i) * LANES + lane;     // row i
  int* sb = a.sub + ((size_t)b * L2R + C - j) * LANES + lane;  // row C - j
  // B2, B3: row d = i + j; a diagonal step leaves the skipped row at 0
  int* kd = ROWS ? a.kinds + ((size_t)b * NDP + i + j) * LANES + lane
                 : nullptr;
  const int h0 = 1 - rbmax;  // o(d) = max(0, d - C, (d + h0) >> 1)
  bool live = !bad && i + j >= 1;
  const unsigned lanes = P == 32 ? FULL : (1u << P) - 1u;
  while (__any_sync(lanes, live)) {
    const int d = i + j;
    const int r = i - __vimax_s32_relu(d - C, (d + h0) >> 1);
    const unsigned w =
        live && (unsigned)r < (unsigned)WP ? slab[(d >> 4) * WP + r] : 0u;
    const int kind = (w >> (2 * (d & 15))) & 3;  // 0: stuck, end != 0
    const int c1 = s1c[i];
    const int sq = s2c[C - j];
    const int c2 = sq & 3;
    const bool diag = kind == 1;
    const bool take1 = diag || kind == 3;  // consumes s1 position i
    const bool take2 = diag || kind == 2;  // consumes s2 position j
    store_if(sb, c1 + 1, diag && c1 != c2);
    store_if(mq, diag ? ((sq >> 2) << 17) | (j << 3) | (c2 + 2) : 1, take1);
    if (MODE == MODE_KINDS) store_if(kd, kind, kind != 0);
    if (MODE == MODE_CLS) {
      // the column's class: 1 left, 2 up, 3 substitution, 4 match; a live
      // lane that finds no pointer classes its last step as 4 too, as the
      // TPU kernel does (nw_pallas.py's clsv), and then stops
      const int cls = kind == 2 ? 1 : kind == 3 ? 2 : diag && c1 != c2 ? 3 : 4;
      store_if(kd, cls, live);
    }
    if (ROWS) kd -= (take1 + take2) * LANES;
    i -= take1;
    j -= take2;
    mq -= take1 ? LANES : 0;
    sb += take2 ? LANES : 0;
    live = kind != 0 && i + j >= 1;
  }
  a.endo[((size_t)b * 8 + 0) * LANES + lane] = bad ? max(len1, 1) : i;
  a.endo[((size_t)b * 8 + 1) * LANES + lane] = bad ? l2 : j;
  // ---- end of traceback, one lane per pair ----
}

template <int RPT, int MODE>
static int launch_compare(const Args& a, int nb, cudaStream_t stream) {
  const int bytes =
      compare_bytes(a.L1R, a.L2R, a.NDP, RPT * 32, a.ppb, MODE);
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        nw_compare_kernel<RPT, MODE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(nb * (LANES / a.ppb)), block(32 * a.ppb);
  nw_compare_kernel<RPT, MODE><<<grid, block, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int MODE>
static const void* compare_fn_wp(int WP) {
  switch (WP / 32) {
    case 1:
      return (const void*)nw_compare_kernel<1, MODE>;
    case 2:
      return (const void*)nw_compare_kernel<2, MODE>;
    case 3:
      return (const void*)nw_compare_kernel<3, MODE>;
    default:
      return (const void*)nw_compare_kernel<4, MODE>;
  }
}

static const void* compare_fn(int WP, int mode) {
  switch (mode) {
    case MODE_B1:
      return compare_fn_wp<MODE_B1>(WP);
    case MODE_CLS:
      return compare_fn_wp<MODE_CLS>(WP);
    default:
      return compare_fn_wp<MODE_KINDS>(WP);
  }
}

// Blocks of nw_compare_kernel with P pairs resident on one SM (the CUDA
// occupancy calculator, from the instantiation's registers and the block's
// shared memory: B1's for mode 1, B2's class rows for mode 2, B3's for
// mode 3), 0 if such a block cannot run or the mode is none of these.
extern "C" int nw_compare_blocks_per_sm(int L1R, int L2R, int NDP, int WP,
                                        int P, int mode) {
  if (WP < 32 || WP > 128 || WP % 32 || P < 1 || P > 32 || (P & (P - 1)) ||
      mode < MODE_B1 || mode > MODE_KINDS)
    return 0;
  const void* fn = compare_fn(WP, mode);
  const int bytes = compare_bytes(L1R, L2R, NDP, WP, P, mode);
  cudaFuncAttributes fa;
  int bps = 0;
  if (bytes > SMEM_MAX || cudaFuncGetAttributes(&fa, fn) != cudaSuccess ||
      32 * P > fa.maxThreadsPerBlock ||
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           SMEM_MAX) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&bps, fn, 32 * P,
                                                    bytes) != cudaSuccess)
    return 0;
  return bps;
}

// Pairs per block of nw_compare_kernel (mode 1 B1, 2 B2, 3 B3) for a
// launch of nb blocks of 128 lanes. A block that is tracing back keeps its
// P warps' slots while one warp works, so the fit takes the largest P (a
// power of two up to 32) that still keeps four blocks resident per SM (a
// traceback then idles at most a quarter of the SM's warps, and a larger
// P shares the traceback's instructions among more pairs; PERF.md has the
// sweep of P behind this); where no P keeps four, the P that keeps the
// most pairs resident (on a tie the larger). A P is considered only if
// the grid still gives every SM two blocks (P = 1 always is), so a small
// launch gets fewer pairs per block.
static int compare_pairs(int L1R, int L2R, int NDP, int WP, int nb,
                         int mode) {
  int dev = 0, nsm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  int best = 0, best_res = 0, four = 0;
  for (int P = 1; P <= 32; P *= 2) {
    if (P > 1 && (long long)nb * LANES / P < 2LL * nsm) break;
    const int bps = nw_compare_blocks_per_sm(L1R, L2R, NDP, WP, P, mode);
    if (bps == 0) break;
    if (bps >= 4) four = P;
    if (P * bps >= best_res) {
      best = P;
      best_res = P * bps;
    }
  }
  return four ? four : best;
}

// Pairs (warps) per block for a mode (1 B1, 2 B2, 3 B3, 4 B2 stats) and a
// launch of nb blocks of 128 lanes; 0 if even one pair does not fit, WP is
// not a multiple of 32 up to 128, or the mode is unknown. This is the one
// place that decides the fit (the TPU kernel's VMEM_SLAB_CAP check does
// not carry over). B1, B2 and B3: compare_pairs, each asking its own
// instantiation and its own layout. B2 stats: the largest of 4, 2, 1
// whose shared memory (byte columns and the column buffer) fits one
// block's 227 KB.
extern "C" int nw_wavefront_pairs_per_block(int L1R, int L2R, int NDP,
                                            int WP, int mode, int nb) {
  if (WP < 32 || WP > 128 || WP % 32 || mode < 1 || mode > 4) return 0;
  if (mode != 4) return compare_pairs(L1R, L2R, NDP, WP, nb, mode);
  const int per = pair_layout(L1R, L2R, NDP, WP).bytes;
  for (int ppb = 4; ppb >= 1; ppb /= 2)
    if (ppb * per <= SMEM_MAX) return ppb;
  return 0;
}

template <int RPT>
static int launch_stats(const Args& a, int nb, cudaStream_t stream) {
  const int bytes = a.ppb * pair_layout(a.L1R, a.L2R, a.NDP, RPT * 32).bytes;
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        nw_wavefront_kernel<RPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(nb * (LANES / a.ppb)), block(32 * a.ppb);
  nw_wavefront_kernel<RPT><<<grid, block, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int MODE>
static int launch_compare_wp(const Args& a, int nb, int WP,
                             cudaStream_t stream) {
  switch (WP / 32) {
    case 1:
      return launch_compare<1, MODE>(a, nb, stream);
    case 2:
      return launch_compare<2, MODE>(a, nb, stream);
    case 3:
      return launch_compare<3, MODE>(a, nb, stream);
    default:
      return launch_compare<4, MODE>(a, nb, stream);
  }
}

// Launches one mode of nw_compare_kernel on `stream`: mode 1 = B1
// compare (shared s1), 2 = B2 pairs (s1 per block and lane, class rows
// into `kinds`), 3 = B3 kinds (shared s1, kind rows into `kinds`); `kinds`
// is unused in mode 1. `ppb` is the pairs per block (0 =
// nw_wavefront_pairs_per_block's choice). Returns cudaGetLastError() after
// the launch (0 = launched), or cudaErrorInvalidValue for an unknown mode,
// a window that does not fit one block (nw_wavefront_pairs_per_block ==
// 0) or a given `ppb` that is not a power of two up to 32 whose block fits
// the mode's layout.
extern "C" int nw_wavefront_run(const int* scal, const int* params,
                                const int* s1, const int* s2q, int* kinds,
                                int* sub, int* mapq, int* endo, int nb,
                                int L1R, int L2R, int NDP, int WP, int mode,
                                int match, int mismatch, int gap_p, int ppb,
                                void* stream) {
  if (nb <= 0) return 0;
  if (mode < MODE_B1 || mode > MODE_KINDS) return (int)cudaErrorInvalidValue;
  if (ppb == 0)
    ppb = nw_wavefront_pairs_per_block(L1R, L2R, NDP, WP, mode, nb);
  else if (ppb > 32 || (ppb & (ppb - 1)) ||
           compare_bytes(L1R, L2R, NDP, WP, ppb, mode) > SMEM_MAX)
    ppb = 0;
  if (ppb <= 0) return (int)cudaErrorInvalidValue;
  const Args a = {scal,  params, s1,  s2q, kinds, sub,   mapq,     endo,
                  nullptr, L1R,  L2R, NDP, ppb,   match, mismatch, gap_p,
                  0,     0};
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case MODE_B1:
      return launch_compare_wp<MODE_B1>(a, nb, WP, s);
    case MODE_CLS:
      return launch_compare_wp<MODE_CLS>(a, nb, WP, s);
    default:
      return launch_compare_wp<MODE_KINDS>(a, nb, WP, s);
  }
}

// Launches B2 stats (mode 4, nw_wavefront_kernel) on `stream`: B2's inputs
// (s1 per block and lane), one row of six int32 per pair into `stats`
// [nb * 128, 6]. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a window that does not fit one block.
extern "C" int nw_pairs_stats_run(const int* scal, const int* params,
                                  const int* s1, const int* s2q, int* stats,
                                  int nb, int L1R, int L2R, int NDP, int WP,
                                  int match, int mismatch, int gap_p,
                                  int allow_one_off, int max_shift,
                                  void* stream) {
  if (nb <= 0) return 0;
  const int ppb = nw_wavefront_pairs_per_block(L1R, L2R, NDP, WP, 4, nb);
  if (ppb == 0) return (int)cudaErrorInvalidValue;
  const Args a = {scal,    params,  s1,  s2q, nullptr, nullptr,
                  nullptr, nullptr, stats, L1R, L2R,   NDP,
                  ppb,     match,   mismatch, gap_p, allow_one_off,
                  max_shift};
  cudaStream_t s = (cudaStream_t)stream;
  switch (WP / 32) {
    case 1:
      return launch_stats<1>(a, nb, s);
    case 2:
      return launch_stats<2>(a, nb, s);
    case 3:
      return launch_stats<3>(a, nb, s);
    default:
      return launch_stats<4>(a, nb, s);
  }
}
