// Batched Needleman-Wunsch over per-pair windows for Hopper (kernel B4):
// a register body (one warp per pair, the window in registers) for windows
// of up to 256 rows, a wide body (several warps per pair, the same cell code)
// for windows of up to 2,048 rows, and a one-block-per-pair body for wider
// ones.
//
// Replaces the JAX package's XLA aligner dada2_tpu/ops/nw_batch.py:
// _fill_kernel (the lax.scan over anti-diagonals, vmapped over pairs) and
// _traceback_kernel, as jitted by _nw_batch_jit (and, one center against a
// batch, by core/backend_tpu.py::_align_center_jit), with the derived ham
// and tvec of _nw_batch_jit's `derive`. Same arrays in and out, bit for
// bit (row k of each is pair k):
//   s1 [n, L1], s2 [n, L2]  int8   codes (pad -1 past each length)
//   len1, len2 [n]          int32
//   h1 [n, L1], h2 [n, L2]  uint8  homopolymer masks (homopolymer mode)
//   kinds [n, L1+L2]        int8   traceback step kinds in reverse
//                                  alignment order (1 diag, 2 left = gap in
//                                  s1, 3 up = gap in s2; 0 once stopped)
//   p0, p1 [n, L1+L2]       int32  (i, j) after each step
//   ham [n]                 int32  substitutions on diagonal steps
//   tvec [n, L2]            int8   5 * s2 (self transitions), 4 * nt0 + nt1
//                                  at diagonal steps, 16 past len2
//   ok [n]                  uint8  the traceback reached (0, 0)
// Semantics (see ops/nw_batch.py): diagonal d holds the window rows
// r = 0.. with i = lo(d) + r, lo(d) = max(0, d - len2, ceil((d-rband)/2)),
// valid while i <= hi(d) = min(len1, d, floor((d + lband) / 2)); the three
// neighbours of (i, j) are rows r + lo(d) - lo(d-1) - 1 (up) and
// r + lo(d) - lo(d-1) (left) of diagonal d-1 and r + lo(d) - lo(d-2) - 1
// (diag) of d-2; a row outside the window and an invalid row read NEG
// (-9999 in the banded scalar aligner). Vec mode: tie precedence
// up >= left > diag, borders i*end_gap_p / j*end_gap_p, and, ends-free,
// the last-row rule (left neighbour + end_gap_p, after cell j_first) and
// then the last-column rule (up neighbour + end_gap_p, after i_first).
// Scalar mode: free end gaps on the last row and column (when
// end_gap_p != gap_p), up >= diag and up >= left wins, then left >= diag,
// borders i*bval / j*bval, homopolymer masks read at i-1 / j-1.
//
// What bounds it on the card: the bytes are small (the arrays above, read
// or written once; kinds/p0/p1 are 9 bytes per traceback step), so the
// roofline bound is the fill's integer work, 13 int32 operations per
// in-band cell as chip_smoke.py counts them for B1 (gap adds, match score,
// the two max-with-pointer selects, the pointer packing), plus 2 selects of
// the gap penalty per cell in the homopolymer aligner. In practice each
// pair is a chain of len1 + len2 dependent diagonal steps followed by a
// serial traceback of as many steps, and the instructions issued per cell
// set the time.
//
// Which body serves a launch is decided from the batch's geometry before
// it (nw_batch_route, the one place that decides the fit).
//
// The register body (nw_batch_reg_kernel; windows of up to 256 rows, the
// merge, shift-detection, collapse, chimera-fallback and dada shapes): B1's
// design for the batch aligner's rules. One warp per pair; thread t holds
// the RPT consecutive window rows r = t * RPT + k (RPT = 1, 2, 4 or 8, a
// template parameter chosen from the batch's window) of diagonals d-1 and
// d-2 in registers. The pair's origin lo(d) is warp-uniform, so left and up
// are rows r + s1w and r + s1w - 1 of d-1 with s1w = lo(d) - lo(d-1) in
// {0, 1}: the thread's own registers except at its first or last row,
// whose neighbour one __shfl_sync per diagonal brings from the next lane;
// diagonal is row r + s1w + s1p - 1 of d-2, the previous step's shuffle at
// the lane boundary. No barrier per diagonal. The max-with-pointer is DPX
// (__vibmax_s32 for up against left, its predicate the pointer,
// __viaddmax_s32 for that against the diagonal): up >= left > diagonal in
// both aligners, which differ only in their gaps. The borders and the last
// row's and column's rules touch row 0 or the last valid row only, so the
// fill runs in phases by which of them a diagonal can hold (three
// diagonals per pass, the middle sixteen, so that the three register sets
// rotate without moves); the border cell j == 0 is set by a warp-uniform
// switch on its register. The 2-bit pointers are packed sixteen diagonals
// to a word in shared memory, per group of sixteen diagonals only as many
// rows as its diagonals can hold (an unbanded window's two triangles then
// take half of nd x W). The sequences are staged once per pair as bytes
// (homopolymer aligner: one int32 word per position, the gap beside the
// code). Pairs per block from the CUDA occupancy calculator; the warps of
// a block are independent (no block barrier): lane 0 of the pair's warp
// walks the pointers, writing one byte per step into shared memory, while
// the other warps of the SM keep filling, and then the warp writes the
// step rows (positions from ballot prefix counts), ham and tvec with
// coalesced stores.
//
// The wide body (nw_batch_wide_kernel; windows of 257 to 2,048 rows: whole
// 2 x 300 merges, shift detection on V3-V4 or PacBio ASVs): the register
// body's fill on G = ceil(W / 256) warps per pair, one pair per block.
// Thread t of the pair (t = 32 * warp + lane) holds the window rows
// t * 8 + k, so a warp holds 256 consecutive rows and the cell code is the
// register body's, RPT = 8. Across a warp boundary the one neighbour row
// the shuffle cannot bring (lane 31's next row when lo(d) advances, lane
// 0's previous row when it does not) comes from an exchange buffer in
// shared memory: after each diagonal a warp's lane 0 and lane 31 write
// their first and last rows there (two buffers by the diagonal's parity,
// one slot per warp with an out-of-band slot on each side) and the pair's
// warps meet at a named barrier (bar.sync 1, 32 * G: the block is the
// pair); the double buffer makes one barrier per diagonal enough. A warp
// whose 256 rows are all past the diagonal's last valid row (the window's
// triangles, or a pair narrower than the batch's window) skips its cells:
// they would all read the out-of-band value, so it only shifts its pointer
// words and exchanges its edges. The pointers are packed as in the register
// body (sixteen diagonals to a word, per group only the rows its diagonals
// can hold) in a device-memory slab that the wrapper allocates (about 23 KB
// a pair at a 301-row window, 53 KB at 461, 0.55 MB for an unbanded PacBio
// pair): in shared memory they capped the SM at four pairs at W 461, where
// registers (80 a thread) allow twelve; the slab in device memory measured
// 38% faster there and no slower at W 301.
// After a last barrier the other warps leave and warp 0 walks the pointers
// as one warp: on entering a group of sixteen diagonals it takes the 64
// words around the walk's row from a window loaded when it entered the
// previous group (the walk moves at most 31 rows in two groups), and loads
// the next group's window at once, so each step costs a shuffle and a
// device-memory slab's latency is hidden behind a group's steps; then the
// warp writes the step rows with the register body's coalesced stores. No
// block-wide barrier follows the fill, so the SM's other pairs keep
// filling while a pair walks.
//
// The one-block-per-pair body (nw_batch_kernel; windows over 2,048 rows,
// e.g. unbanded full-length rRNA operons): 32..256 threads striding over the
// pair's window rows on each diagonal. The scores of diagonals d-1 and d-2
// and the one being written live in three int32 buffers in shared memory
// (one barrier per diagonal; the buffer written at d+1 is the one read at
// d-1, so one barrier suffices), with one guard row on each side that stays
// at the out-of-band value. The sequences (and masks) are staged into
// shared memory once. Pointers are 2 bits per cell, as two bit planes per
// warp and diagonal (__ballot_sync), in shared memory when nd x W fits one
// block, else in a device-memory slab that the wrapper allocates. After the
// last barrier thread 0 walks the traceback and writes kinds/p0/p1, ham and
// the tvec entries of diagonal steps; the other threads initialise tvec
// before the fill and write the tail of the step rows after the walk.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#define NEG (-(1 << 29))
#define OOB_SCALAR (-9999)
#define SMEM_MAX 232448  // 227 KB: the most one block may use on sm_90
#define FULL 0xffffffffu
#define THREADS_MAX 256

struct BatchArgs {
  const int8_t* s1;
  const int* len1;
  const int8_t* s2;
  const int* len2;
  const uint8_t* h1;
  const uint8_t* h2;
  int8_t* kinds;
  int* p0;
  int* p1;
  int* ham;
  int8_t* tvec;
  uint8_t* ok;
  uint32_t* slab;  // device-memory pointer slab, slab_words per pair
  int slab_words;
  int L1, L2, W, band, match, mismatch, gap_p, end_gap_p, homo_gap_p;
};

// One block's shared memory: the traceback's end (t, i, j), three score
// buffers of W + 2 int32, the staged s1 and s2 (and masks), then the
// pointer slab when it lives here.
struct BatchLayout {
  int sc, s1, s2, h1, h2, slab, bytes;
};

__host__ __device__ static inline BatchLayout batch_layout(int L1, int L2,
                                                           int nd, int W,
                                                           bool homo,
                                                           bool shared_slab) {
  BatchLayout o;
  o.sc = 16;
  o.s1 = o.sc + 12 * (W + 2);
  o.s2 = o.s1 + ((L1 + 3) & ~3);
  o.h1 = o.s2 + ((L2 + 3) & ~3);
  o.h2 = o.h1 + (homo ? ((L1 + 3) & ~3) : 0);
  o.slab = o.h2 + (homo ? ((L2 + 3) & ~3) : 0);
  const long long slab = shared_slab ? 8LL * nd * ((W + 31) / 32) : 0;
  const long long bytes = o.slab + slab;
  o.bytes = bytes > SMEM_MAX ? SMEM_MAX + 1 : (int)bytes;
  return o;
}

// floor(x / 2) for any sign (arithmetic shift)
__device__ __forceinline__ int floor2(int x) { return x >> 1; }

template <bool SCALAR, bool HOMO, bool GSLAB>
__global__ void __launch_bounds__(THREADS_MAX)
    nw_batch_kernel(const BatchArgs a, const BatchLayout lay) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* tb_end = (int*)smem;
  const int p = blockIdx.x;
  const int tid = threadIdx.x, T = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int len1 = a.len1[p], len2 = a.len2[p];
  int lband, rband;
  if (a.band < 0) {
    lband = len1;
    rband = len2;
  } else {
    lband = a.band + max(0, len1 - len2);
    rband = a.band + max(0, len2 - len1);
  }
  // this pair's window: an upper bound of hi(d) - lo(d) + 1 over d
  const int Wp = min((lband + rband) / 2 + 2, min(len1, len2) + 1);
  const int WW = (Wp + 31) >> 5;
  const int nd = len1 + len2 + 1;
  const int stride = a.W + 2;
  const int OOB = (SCALAR && a.band >= 0) ? OOB_SCALAR : NEG;
  int* sc = (int*)(smem + lay.sc);
  int8_t* c1s = (int8_t*)(smem + lay.s1);
  int8_t* c2s = (int8_t*)(smem + lay.s2);
  uint8_t* h1s = smem + lay.h1;
  uint8_t* h2s = smem + lay.h2;
  uint32_t* slab = GSLAB ? a.slab + (size_t)p * a.slab_words
                         : (uint32_t*)(smem + lay.slab);
  const int8_t* g1 = a.s1 + (size_t)p * a.L1;
  const int8_t* g2 = a.s2 + (size_t)p * a.L2;
  int8_t* tv = a.tvec + (size_t)p * a.L2;

  // ---- staging, score buffers at the out-of-band value, tvec ----
  for (int k = tid; k < a.L1; k += T) {
    c1s[k] = g1[k];
    if (HOMO) h1s[k] = a.h1[(size_t)p * a.L1 + k];
  }
  for (int k = tid; k < a.L2; k += T) {
    const int8_t c = g2[k];
    c2s[k] = c;
    if (HOMO) h2s[k] = a.h2[(size_t)p * a.L2 + k];
    tv[k] = k < len2 ? (int8_t)(5 * (int)c) : (int8_t)16;
  }
  for (int k = tid; k < 3 * stride; k += T) sc[k] = OOB;
  __syncthreads();
  if (tid == 0) sc[1] = 0;  // diagonal 0 (buffer 0, row 0): cell (0, 0)
  __syncthreads();

  // ---- fill: one diagonal per pass, one barrier per diagonal ----
  const bool endsfree = a.end_gap_p > a.gap_p;       // vec
  const bool scalar_free = a.end_gap_p != a.gap_p;   // scalar
  const int j_first = lband < len1 ? len1 - lband : 0;
  const int i_first = rband < len2 ? len2 - rband : 0;
  const int bval = scalar_free ? 0 : a.gap_p;
  int lo1 = 0, lo2 = 0;
  for (int d = 1; d < nd; ++d) {
    const int* P1 = sc + ((d - 1) % 3) * stride;
    const int* P2 = sc + ((d + 1) % 3) * stride;  // diagonal d - 2
    int* C = sc + (d % 3) * stride;
    const int lod = max(0, max(d - len2, floor2(d - rband + 1)));
    const int nvalid = min(min(len1, d), floor2(d + lband)) - lod + 1;
    const int su = lod - lo1, sd = lod - lo2;
    for (int rb = warp * 32; rb < Wp; rb += T) {
      const int r = rb + lane;
      int ptr = 0;
      if (r < Wp) {
        const int i = lod + r, j = d - i;
        const int Uraw = P1[su + r];      // (i-1, j): row r + su - 1 of d-1
        const int Lraw = P1[su + r + 1];  // (i, j-1): row r + su of d-1
        const int Dp = P2[sd + r];        // (i-1, j-1): row r + sd - 1 of d-2
        const int ci = min(max(i - 1, 0), a.L1 - 1);
        const int cj = min(max(j - 1, 0), a.L2 - 1);
        const int D = Dp + (c1s[ci] == c2s[cj] ? a.match : a.mismatch);
        int entry;
        if (SCALAR) {
          int ug = a.gap_p, lg = a.gap_p;
          if (HOMO) {
            ug = h1s[ci] ? a.homo_gap_p : a.gap_p;
            lg = h2s[cj] ? a.homo_gap_p : a.gap_p;
          }
          if (scalar_free && j == len2) ug = 0;
          if (scalar_free && i == len1) lg = 0;
          const int U = Uraw + ug, L = Lraw + lg;
          const bool upw = U >= D && U >= L;
          const bool leftw = !upw && L >= D;
          entry = upw ? U : (leftw ? L : D);
          ptr = upw ? 3 : (leftw ? 2 : 1);
          if (j == 0) {
            entry = i * bval;
            ptr = 3;
          }
          if (i == 0) {
            entry = j * bval;
            ptr = 2;
          }
        } else {
          const int U = Uraw + a.gap_p, L = Lraw + a.gap_p;
          entry = U >= L ? U : L;
          ptr = U >= L ? 3 : 2;
          if (D > entry) {
            entry = D;
            ptr = 1;
          }
          if (j == 0) {
            entry = i * a.end_gap_p;
            ptr = 3;
          }
          if (i == 0) {
            entry = j * a.end_gap_p;
            ptr = 2;
          }
          if (endsfree) {
            if (i == len1 && j > j_first && j > 0 && i > 0) {
              const int candr = Lraw + a.end_gap_p;
              if (candr > entry) {
                entry = candr;
                ptr = 2;
              } else if (candr == entry && ptr == 1) {
                ptr = 2;
              }
            }
            if (j == len2 && i > i_first && i > 0 && j > 0) {
              const int candc = Uraw + a.end_gap_p;
              if (candc > entry) {
                entry = candc;
                ptr = 3;
              } else if (candc == entry && ptr != 3) {
                ptr = 3;
              }
            }
          }
        }
        const bool valid = r < nvalid;
        C[1 + r] = valid ? entry : OOB;
        if (!valid) ptr = 0;
      }
      const uint32_t b0 = __ballot_sync(FULL, ptr & 1);
      const uint32_t b1 = __ballot_sync(FULL, ptr >> 1);
      if (lane == 0) {
        uint32_t* w = slab + ((size_t)d * WW + (rb >> 5)) * 2;
        w[0] = b0;
        w[1] = b1;
      }
    }
    lo2 = lo1;
    lo1 = lod;
    __syncthreads();
  }
  // ---- end of fill ----

  // ---- traceback on thread 0, then the tail of the step rows ----
  int8_t* kr = a.kinds + (size_t)p * (a.L1 + a.L2);
  int* q0 = a.p0 + (size_t)p * (a.L1 + a.L2);
  int* q1 = a.p1 + (size_t)p * (a.L1 + a.L2);
  const int nsteps = a.L1 + a.L2;
  if (tid == 0) {
    int i = len1, j = len2, t = 0, h = 0;
    while (t < nsteps && (i | j)) {
      const int d = i + j;
      const int rr = i - max(0, max(d - len2, floor2(d - rband + 1)));
      int ptr = 0;
      if (rr >= 0 && rr < Wp) {
        const uint32_t* w = slab + ((size_t)d * WW + (rr >> 5)) * 2;
        ptr = ((w[0] >> (rr & 31)) & 1) | (((w[1] >> (rr & 31)) & 1) << 1);
      }
      if (ptr == 0) break;
      if (ptr == 1) {
        const int nt0 = c1s[i - 1], nt1 = c2s[j - 1];
        h += nt0 != nt1;
        tv[j - 1] = (int8_t)(4 * nt0 + nt1);
      }
      i -= (ptr == 1 || ptr == 3);
      j -= (ptr == 1 || ptr == 2);
      kr[t] = (int8_t)ptr;
      q0[t] = i;
      q1[t] = j;
      ++t;
    }
    tb_end[0] = t;
    tb_end[1] = i;
    tb_end[2] = j;
    a.ham[p] = h;
    a.ok[p] = (i == 0 && j == 0);
  }
  __syncthreads();
  const int t0 = tb_end[0], fi = tb_end[1], fj = tb_end[2];
  for (int k = t0 + tid; k < nsteps; k += T) {
    kr[k] = 0;
    q0[k] = fi;
    q1[k] = fj;
  }
  // ---- end of traceback ----
}

// ---- the register body: one warp per pair, the window in registers ----
// Thread t of a pair's warp holds the window rows r = t * RPT + k (k < RPT)
// of diagonals d-1 and d-2 in registers (P1, P2). A row outside the
// registers or outside the pair's valid rows reads the out-of-band value,
// as the scan's padding does.
#define REG_W_MAX 256  // the widest window of the register body (RPT = 8)
#define REG_P_MAX 16   // pairs (warps) per block of the register body
// The register body's threads per block at most: 128 at RPT = 8 (the fill
// then keeps its 8 x 4 score and pointer registers without spilling; one
// block of 512 threads would cap a thread at 128 registers), else 512
#define REG_THREADS(RPT) ((RPT) >= 8 ? 128 : 32 * REG_P_MAX)

// One warp's shared memory in the register body: s1 staged at s1s[i] =
// s1[i - 1], s2 at s2s[j - 1 + WR] = s2[j - 1] (guard elements where the
// window's rows run past the sequences; in the homopolymer aligner each
// element is the int32 word gap * 256 + code, the gap a step next to that
// position costs, else an int8 code), the walk's step kinds (one byte per
// step), the slab's offsets (nq + 1 int32, see group_rows), in the wide
// body the exchange buffer (two buffers of G + 2 slots of two int32), and
// the pointer slab: per group of sixteen diagonals q, one word per window
// row below group_rows(q), diagonal 16q + m in bits 2m (`words` in all; not
// in shared memory where the wide body keeps it in device memory). `wr` is
// the rows a pair's threads hold, 32 * RPT * warps, the guard of the staged
// sequences. The wide body's pair has the same layout, one pair a block,
// its slab in device memory.
struct RegLayout {
  int s2, kb, off, ex, slab, stride, nd, nq, wr, words;
};

__host__ __device__ static inline int reg_rpt(int W) {
  return W <= 32 ? 1 : W <= 64 ? 2 : W <= 128 ? 4 : 8;
}

#define WIDE_RPT 8       // rows per thread of the wide body
#define WIDE_W_MAX 2048  // the widest window of the wide body (8 warps)
#define WIDE_THREADS (WIDE_W_MAX / WIDE_RPT)

// Warps per pair of the wide body at windows of up to W rows.
__host__ __device__ static inline int wide_warps(int W) {
  return (W + 32 * WIDE_RPT - 1) / (32 * WIDE_RPT);
}

// The rows of the slab kept for diagonals 16q .. 16q + 15 of a batch of nd
// diagonals and windows of up to W rows: on diagonal d a pair's valid rows
// number at most d + 1, len1 + len2 - d + 1 <= nd - d and W, so these rows
// hold every valid row of the group (an unbanded window's triangles then
// take about half the words of nd x W).
__host__ __device__ static inline int group_rows(int q, int nd, int W) {
  return max(0, min(W, min(16 * q + 16, nd - 16 * q)));
}

// One pair's layout: the register body's (wide false), or the wide body's,
// whose slab is in device memory.
__host__ __device__ static inline RegLayout reg_layout(int L1, int L2, int nd,
                                                       int W, bool homo,
                                                       bool wide = false) {
  RegLayout o;
  const int cs = homo ? 4 : 1;
  const int WR = wide ? 32 * WIDE_RPT * wide_warps(W) : 32 * reg_rpt(W);
  o.wr = WR;
  o.nd = nd;
  o.nq = (nd + 15) / 16;
  o.s2 = (cs * (L1 + WR) + 15) & ~15;
  o.kb = o.s2 + ((cs * (L2 + WR) + 15) & ~15);
  o.off = o.kb + ((L1 + L2 + 15) & ~15);
  o.ex = o.off + ((4 * (o.nq + 1) + 15) & ~15);
  o.slab = o.ex + (wide ? 16 * (wide_warps(W) + 2) : 0);
  long long words = 0;
  for (int q = 0; q < o.nq; ++q) words += group_rows(q, nd, W);
  o.words = words > (1LL << 30) ? (1 << 30) : (int)words;
  const long long bytes = o.slab + (wide ? 0 : 4 * words);
  o.stride = bytes > SMEM_MAX ? SMEM_MAX + 1 : (int)bytes;
  return o;
}

// A named barrier among the pair's threads (the wide body's block is one
// pair; id 0 is left to __syncthreads)
__device__ __forceinline__ void pair_sync(const int nthreads) {
  asm volatile("bar.sync 1, %0;" ::"r"(nthreads) : "memory");
}

__device__ __forceinline__ int code_of(int8_t c) { return c; }
__device__ __forceinline__ int code_of(int w) { return (int8_t)(w & 0xff); }

// ---- fill: the per-diagonal step of the register body ----
// step<EDGE, LATE>(d) computes diagonal d on the pair's warp (WIDE: on
// this warp of the pair's warps); EDGE adds the border cells (i == 0,
// j == 0), LATE the rules of the last row and column (vec: the ends-free
// recalculations; scalar: the free end gaps), so that the diagonals that
// hold neither run without their checks.
template <int RPT_, bool SCALAR, bool HOMO, bool WIDE = false>
struct RegFill {
  using CT = typename std::conditional<HOMO, int, int8_t>::type;
  static constexpr int RPT = RPT_;
  static constexpr bool IS_SCALAR = SCALAR;
  static constexpr int WR = RPT * 32;
  const CT* s1s;
  const CT* s2s;
  unsigned* slab;
  const int* off;      // slab offsets of the groups of sixteen diagonals
  int t, len1, len2, lband, rband, OOB;  // t: the thread's rows are t*RPT+k
  int match, mismatch, gap_p, bval, egp, dr0, dc0;
  int srcm, srcp;      // lanes - 1 and + 1, mod 32
  bool wrapm, wrapp;   // lane 0, lane 31
  // WIDE: the rows the pair's threads hold (the staged s2's guard), this
  // warp's first row, its exchange slot (two int32: its first and last
  // rows; the next buffer `exs` int32 on), the pair's threads
  int wr, row0, exs, nthreads;
  int* exw;
  bool sfree;          // scalar: free end gaps
  int P1[RPT], P2[RPT];
  int xs;              // the previous step's shuffle: row tR - 1 or tR + R
  unsigned acc[RPT];
  int om1, s1p;        // lo(d-1), lo(d-1) - lo(d-2)

  __device__ __forceinline__ int lo(const int d) const {
    return max(0, max(d - len2, (d - rband + 1) >> 1));
  }

  template <bool EDGE, bool LATE>
  __device__ __forceinline__ void step(const int d) {
    const int od = lo(d);
    const int s1w = od - om1;
    // the one row of d-1 next to this thread's rows that another lane
    // holds: row tR + R (lane t + 1's first) when s1w = 1, row tR - 1 (lane
    // t - 1's last) when s1w = 0; outside the registers it reads OOB
    int sh = __shfl_sync(FULL, s1w ? P1[0] : P1[RPT - 1], s1w ? srcp : srcm);
    // at the warp's edge: OOB, or in the wide body the neighbouring warp's
    // first or last row of d-1 from the exchange buffer (the slots past
    // the first and the last warp hold OOB)
    if (s1w ? wrapp : wrapm)
      sh = WIDE ? exw[((d - 1) & 1) * exs + (s1w ? 2 : -1)] : OOB;
    // diagonal is row r + e of d-2, e = s1w + s1p - 1: the row itself, or
    // when e != 0 (then s1w == s1p) the next or previous row, whose value
    // across the lane boundary the previous step's shuffle brought (xs)
    const bool dsh = s1w == s1p;
    // row r = tR + k is valid iff k < v; it holds i == len1 iff k == ri;
    // row 0 holds i == 0 iff lo(d) == 0 and j == len2 iff lo(d) == d - len2
    const int hid = min(min(len1, d), (d + lband) >> 1);
    const int v = hid - od + 1 - t * RPT;
    const int ri = len1 - od - t * RPT;
    const bool i0 = t == 0 && od == 0;
    const bool jl = t == 0 && od == d - len2;
    const CT* c1p = s1s + od + t * RPT;                 // s1[i - 1] at c1p[k]
    const CT* c2p =
        s2s + (d - od - t * RPT + (WIDE ? wr : WR) - 1);  // s2[j-1] at c2p[-k]
    int E[RPT];
    if (WIDE && row0 > hid - od) {
      // no valid row in this warp: every row reads OOB, no pointer is read
#pragma unroll
      for (int k = 0; k < RPT; ++k) {
        acc[k] >>= 2;
        E[k] = OOB;
      }
    } else {
      cells<EDGE, LATE>(d, od, s1w, sh, dsh, hid, v, ri, i0, jl, c1p, c2p, E);
    }
    if (WIDE) {  // this warp's first and last rows of d for its neighbours
      if (wrapm) exw[(d & 1) * exs] = E[0];
      if (wrapp) exw[(d & 1) * exs + 1] = E[RPT - 1];
    }
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      P2[k] = P1[k];
      P1[k] = E[k];
    }
    xs = sh;
    s1p = s1w;
    om1 = od;
    if (WIDE) pair_sync(nthreads);
  }

  // the cells of diagonal d on this thread's rows
  template <bool EDGE, bool LATE>
  __device__ __forceinline__ void cells(const int d, const int od,
                                        const int s1w, const int sh,
                                        const bool dsh, const int hid,
                                        const int v, const int ri,
                                        const bool i0, const bool jl,
                                        const CT* c1p, const CT* c2p,
                                        int* E) {
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      // left (i, j-1) is row r + s1w of d-1, up (i-1, j) row r + s1w - 1
      const int nxt = k + 1 < RPT ? P1[k + 1 < RPT ? k + 1 : k] : sh;
      const int prv = k > 0 ? P1[k > 0 ? k - 1 : 0] : sh;
      const int Lr = s1w ? nxt : P1[k];
      const int Ur = s1w ? P1[k] : prv;
      const int dn = k + 1 < RPT ? P2[k + 1 < RPT ? k + 1 : k] : xs;
      const int dp = k > 0 ? P2[k > 0 ? k - 1 : 0] : xs;
      const int Dr = dsh ? (s1w ? dn : dp) : P2[k];
      const int c1 = c1p[k];
      const int c2 = c2p[-k];
      const bool eq = HOMO ? ((c1 ^ c2) & 0xff) == 0 : c1 == c2;
      // both aligners: the larger of up and left (up on a tie), then the
      // diagonal only if strictly larger; they differ in the gaps
      bool up;
      int m;
      if (SCALAR) {
        int ug = HOMO ? c1 >> 8 : gap_p;
        int lg = HOMO ? c2 >> 8 : gap_p;
        if (LATE && sfree) {
          if (k == 0 && jl) ug = 0;
          if (k == ri) lg = 0;
        }
        m = __vibmax_s32(Ur + ug, Lr + lg, &up);
      } else {
        m = __vibmax_s32(Ur, Lr, &up) + gap_p;
      }
      int entry = __viaddmax_s32(Dr, eq ? match : mismatch, m);
      int ptr = entry != m ? 1 : up ? 3 : 2;
      if (EDGE && k == 0 && i0) {  // i == 0, j == d
        entry = d * bval;
        ptr = 2;
      }
      if (!SCALAR && LATE) {
        if (d >= dr0 && k == ri) {
          const int candr = Lr + egp;
          if (candr > entry) {
            entry = candr;
            ptr = 2;
          } else if (candr == entry && ptr == 1) {
            ptr = 2;
          }
        }
        if (d >= dc0 && k == 0 && jl) {
          const int candc = Ur + egp;
          if (candc > entry) {
            entry = candc;
            ptr = 3;
          } else if (candc == entry && ptr != 3) {
            ptr = 3;
          }
        }
      }
      // an invalid row's pointer is never read (the walk checks the band)
      acc[k] = __funnelshift_r(acc[k], (unsigned)ptr, 2);
      E[k] = k < v ? entry : OOB;
    }
    // the border cell j == 0 (i == d) is row d - lo(d) if that row is
    // valid: one register of one lane, found by a warp-uniform switch
    const int r0 = d - od;
    if (EDGE && r0 <= hid - od && t == r0 / RPT) {
      switch (r0 % RPT) {
        case 0:
          border<0>(E, d);
          break;
        case 1:
          border<1>(E, d);
          break;
        case 2:
          border<2>(E, d);
          break;
        case 3:
          border<3>(E, d);
          break;
        case 4:
          border<4>(E, d);
          break;
        case 5:
          border<5>(E, d);
          break;
        case 6:
          border<6>(E, d);
          break;
        default:
          border<7>(E, d);
          break;
      }
    }
  }

  // register K of this thread holds the border cell (i, 0) = (d, 0):
  // score d * bval, pointer up (the top bits of its slab word)
  template <int K>
  __device__ __forceinline__ void border(int* E, const int d) {
    if (K < RPT) {
      E[K < RPT ? K : 0] = d * bval;
      acc[K < RPT ? K : 0] |= 3u << 30;
    }
  }

  // diagonals d .. e, three per pass (the scores of d-2, d-1 and d rotate
  // through three sets of registers, so the unrolled pass needs no moves)
  template <bool EDGE, bool LATE>
  __device__ __forceinline__ void run(int& d, const int e) {
    for (; d + 2 <= e; d += 3) {
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        step<EDGE, LATE>(d + q);
        if (((d + q) & 15) == 15) store(d + q, 0);
      }
    }
    for (; d <= e; ++d) {
      step<EDGE, LATE>(d);
      if ((d & 15) == 15) store(d, 0);
    }
  }

  __device__ __forceinline__ void store(const int d, const int shift) {
    const int base = off[d >> 4], rows = off[(d >> 4) + 1] - base;
#pragma unroll
    for (int k = 0; k < RPT; ++k)
      if (t * RPT + k < rows) slab[base + t * RPT + k] = acc[k] >> shift;
  }
};
// ---- end of fill: the per-diagonal step ----

// The pair's band: lband = band + max(0, len1 - len2), rband likewise (no
// band: len1 and len2)
__device__ __forceinline__ void pair_band(const BatchArgs& a, const int len1,
                                          const int len2, int& lband,
                                          int& rband) {
  if (a.band < 0) {
    lband = len1;
    rband = len2;
  } else {
    lband = a.band + max(0, len1 - len2);
    rband = a.band + max(0, len2 - len1);
  }
}

// Stages pair p's s1 and s2 with their guard elements (WR of them, the rows
// the pair's threads hold) and writes its tvec row tv's self transitions;
// thread x0 of nx threads.
template <class CT, bool HOMO>
__device__ __forceinline__ void stage_pair(const BatchArgs& a, const int p,
                                           const int len1, const int len2,
                                           const int WR, CT* s1s, CT* s2s,
                                           int8_t* tv, const int x0,
                                           const int nx) {
  const int8_t* g1 = a.s1 + (size_t)p * a.L1;
  const int8_t* g2 = a.s2 + (size_t)p * a.L2;
  for (int x = x0; x < a.L1 + WR; x += nx) {
    const int q = x - 1;
    const bool in = q >= 0 && q < len1;
    int c = in ? g1[q] : -1;
    if (HOMO)
      c = (c & 0xff) +
          256 * (in && a.h1[(size_t)p * a.L1 + q] ? a.homo_gap_p : a.gap_p);
    s1s[x] = (CT)c;
  }
  for (int x = x0; x < a.L2 + WR; x += nx) {
    const int q = x - WR;
    const bool in = q >= 0 && q < len2;
    int c = in ? g2[q] : -1;
    if (HOMO)
      c = (c & 0xff) +
          256 * (in && a.h2[(size_t)p * a.L2 + q] ? a.homo_gap_p : a.gap_p);
    s2s[x] = (CT)c;
  }
  for (int x = x0; x < a.L2; x += nx)
    tv[x] = x < len2 ? (int8_t)(5 * (int)g2[x]) : (int8_t)16;
}

// The slab's offsets of the groups of sixteen diagonals (one thread)
__device__ __forceinline__ void slab_offsets(const RegLayout& lay, const int W,
                                             int* off) {
  int o = 0;
  for (int q = 0; q < lay.nq; ++q) {
    off[q] = o;
    o += group_rows(q, lay.nd, W);
  }
  off[lay.nq] = o;
}

// The fill of one pair on f's warp(s), t the thread's index among the
// pair's threads: diagonals 1 .. len1 + len2, in phases by which border
// and last-row checks a diagonal can need. Every thread of the pair runs
// the same diagonals (the wide body's barriers count on it).
template <class F>
__device__ __forceinline__ void fill_pair(F& f, const BatchArgs& a,
                                          const int len1, const int len2,
                                          const int lband, const int rband,
                                          const int t, const int lane) {
  constexpr bool SCALAR = F::IS_SCALAR;
  constexpr int RPT = F::RPT;
  f.t = t;
  f.len1 = len1;
  f.len2 = len2;
  f.lband = lband;
  f.rband = rband;
  f.OOB = (SCALAR && a.band >= 0) ? OOB_SCALAR : NEG;
  f.match = a.match;
  f.mismatch = a.mismatch;
  f.gap_p = a.gap_p;
  f.egp = a.end_gap_p;
  f.sfree = a.end_gap_p != a.gap_p;
  f.bval = SCALAR ? (f.sfree ? 0 : a.gap_p) : a.end_gap_p;
  const int ndl = len1 + len2;
  const int NEVER = 1 << 30;
  // vec, ends-free: the last row's rule from diagonal dr0 on (j > j_first),
  // the last column's from dc0 on (i > i_first)
  const bool endsfree = !SCALAR && a.end_gap_p > a.gap_p;
  const int j_first = lband < len1 ? len1 - lband : 0;
  const int i_first = rband < len2 ? len2 - rband : 0;
  f.dr0 = endsfree && len1 > 0 ? len1 + j_first + 1 : NEVER;
  f.dc0 = endsfree && len2 > 0 ? len2 + i_first + 1 : NEVER;
  // the first diagonal with a cell of the last row or column that LATE's
  // rules change
  const int dl = SCALAR ? (f.sfree ? min(len1, len2) + 1 : NEVER)
                        : min(f.dr0, f.dc0);
  f.srcm = (lane + 31) & 31;
  f.srcp = (lane + 1) & 31;
  f.wrapm = lane == 0;
  f.wrapp = lane == 31;
#pragma unroll
  for (int k = 0; k < RPT; ++k) {  // diagonal 0: cell (0, 0) = 0
    f.P1[k] = t * RPT + k == 0 ? 0 : f.OOB;
    f.P2[k] = f.OOB;
    f.acc[k] = 0u;
  }
  f.xs = f.OOB;
  f.om1 = 0;
  f.s1p = 0;
  int d = 1;
  // the diagonals that may hold a border cell (d <= lband or d <= rband),
  // without and then with the last row's and column's rules
  const int e = min(max(lband, rband), ndl);
  f.template run<true, false>(d, min(e, dl - 1));
  f.template run<true, true>(d, e);
  // the middle: neither check, one slab word (16 diagonals) per pass
  const int m_end = min(dl - 1, ndl);
  for (; d <= m_end && (d & 15) != 0; ++d) {
    f.template step<false, false>(d);
    if ((d & 15) == 15) f.store(d, 0);
  }
  for (; d + 15 <= m_end; d += 16) {
#pragma unroll
    for (int q = 0; q < 16; ++q) f.template step<false, false>(d + q);
    f.store(d + 15, 0);
  }
  for (; d <= m_end; ++d) f.template step<false, false>(d);
  // the last diagonals, where the last row's and column's rules apply
  f.template run<false, true>(d, ndl);
  if ((ndl & 15) != 15) f.store(ndl, 2 * (15 - (ndl & 15)));
}

// The step rows of pair p from the walk's `steps` kinds in kb, 32 steps per
// pass on one warp (lane t): (i, j) after step k is (len1, len2) less the
// steps <= k that consume s1 (kinds 1, 3) and s2 (kinds 1, 2), positions
// from ballot prefix counts; then ham, the tvec entries of the diagonal
// steps (row tv) and ok. s1 and s2 are staged with a guard of WR elements.
template <class CT>
__device__ __forceinline__ void write_steps(const BatchArgs& a, const int p,
                                            int8_t* tv,
                                            const unsigned char* kb,
                                            const int steps, const int len1,
                                            const int len2, const CT* s1s,
                                            const CT* s2s, const int WR,
                                            const int t) {
  const int nsteps = a.L1 + a.L2;
  int8_t* kr = a.kinds + (size_t)p * nsteps;
  int* q0 = a.p0 + (size_t)p * nsteps;
  int* q1 = a.p1 + (size_t)p * nsteps;
  const unsigned le = FULL >> (31 - t);  // lanes 0 .. t
  int ci = 0, cj = 0, h = 0;
  for (int k0 = 0; k0 < nsteps; k0 += 32) {
    const int k = k0 + t;
    const int kind = k < steps ? kb[k] : 0;
    const unsigned bi = __ballot_sync(FULL, kind == 1 || kind == 3);
    const unsigned bj = __ballot_sync(FULL, kind == 1 || kind == 2);
    const int i = len1 - ci - __popc(bi & le);
    const int j = len2 - cj - __popc(bj & le);
    if (k < nsteps) {
      kr[k] = (int8_t)kind;
      q0[k] = i;
      q1[k] = j;
    }
    if (kind == 1) {  // a diagonal step: (i, j) is the aligned column
      const int nt0 = code_of(s1s[i + 1]), nt1 = code_of(s2s[j + WR]);
      h += nt0 != nt1;
      tv[j] = (int8_t)(4 * nt0 + nt1);
    }
    ci += __popc(bi);
    cj += __popc(bj);
  }
  h = __reduce_add_sync(FULL, h);
  if (t == 0) {
    a.ham[p] = h;
    a.ok[p] = len1 == ci && len2 == cj;
  }
}

template <int RPT, bool SCALAR, bool HOMO>
__global__ void __launch_bounds__(REG_THREADS(RPT))
    nw_batch_reg_kernel(const BatchArgs a, const RegLayout lay, const int n) {
  using F = RegFill<RPT, SCALAR, HOMO>;
  using CT = typename F::CT;
  constexpr int WR = F::WR;
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int p = blockIdx.x * (blockDim.x >> 5) + w;
  if (p >= n) return;  // the whole warp: the block has no barrier
  unsigned char* mine = smem + (size_t)w * lay.stride;
  CT* s1s = (CT*)mine;
  CT* s2s = (CT*)(mine + lay.s2);
  unsigned char* kb = mine + lay.kb;
  int* off = (int*)(mine + lay.off);
  unsigned* slab = (unsigned*)(mine + lay.slab);
  const int len1 = a.len1[p], len2 = a.len2[p];
  int lband, rband;
  pair_band(a, len1, len2, lband, rband);
  // the tvec row, taken once for the staging and the step rows: with it
  // live across the fill the scalar RPT 8 instantiation keeps 80 registers
  // (25 warps an SM); taken again after the fill it had 72 (28 warps) and
  // ran 4-5% slower at 4,096-pair launches, whose last partial wave then
  // holds the same latency-bound tail
  int8_t* tv = a.tvec + (size_t)p * a.L2;

  // ---- staging: s1 and s2 with their guard elements, tvec ----
  stage_pair<CT, HOMO>(a, p, len1, len2, WR, s1s, s2s, tv, t, 32);
  if (t == 0) slab_offsets(lay, a.W, off);
  __syncwarp();

  // ---- fill: diagonals 1 .. len1 + len2, in three phases ----
  F f;
  f.s1s = s1s;
  f.s2s = s2s;
  f.slab = slab;
  f.off = off;
  fill_pair(f, a, len1, len2, lband, rband, t, t);
  __syncwarp();
  // ---- end of fill ----

  // ---- traceback: lane 0 walks the pointers, the warp writes the rows ----
  const int nsteps = a.L1 + a.L2;
  int steps = 0;
  if (t == 0) {
    int i = len1, j = len2, cq = -1, base = 0, rows = 0;
    while (steps < nsteps && (i | j)) {
      const int dd = i + j;
      if ((dd >> 4) != cq) {  // a new group of sixteen diagonals
        cq = dd >> 4;
        base = off[cq];
        rows = off[cq + 1] - base;
      }
      const int rr = i - f.lo(dd);
      // a cell outside the band (i > hi(d); the other limits hold on the
      // path) or outside the slab has no pointer
      const unsigned wd = (unsigned)rr < (unsigned)rows &&
                                  i <= ((dd + lband) >> 1)
                              ? slab[base + rr]
                              : 0u;
      const int kind = (wd >> (2 * (dd & 15))) & 3;
      if (kind == 0) break;  // no pointer here: stuck outside the window
      kb[steps++] = (unsigned char)kind;
      i -= kind != 2;
      j -= kind != 3;
    }
  }
  __syncwarp();
  steps = __shfl_sync(FULL, steps, 0);
  write_steps(a, p, tv, kb, steps, len1, len2, s1s, s2s, WR, t);
  // ---- end of traceback ----
}

// ---- the wide body: G warps per pair, one pair per block ----
template <bool SCALAR, bool HOMO>
__global__ void __launch_bounds__(WIDE_THREADS)
    nw_batch_wide_kernel(const BatchArgs a, const RegLayout lay) {
  using F = RegFill<WIDE_RPT, SCALAR, HOMO, true>;
  using CT = typename F::CT;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, T = blockDim.x;
  const int lane = tid & 31, g = tid >> 5, G = T >> 5;
  const int p = blockIdx.x;
  CT* s1s = (CT*)smem;
  CT* s2s = (CT*)(smem + lay.s2);
  unsigned char* kb = smem + lay.kb;
  int* off = (int*)(smem + lay.off);
  int* ex = (int*)(smem + lay.ex);
  unsigned* slab = a.slab + (size_t)p * a.slab_words;
  const int len1 = a.len1[p], len2 = a.len2[p];
  int lband, rband;
  pair_band(a, len1, len2, lband, rband);
  const int OOB = (SCALAR && a.band >= 0) ? OOB_SCALAR : NEG;

  // ---- staging: s1 and s2 with their guard elements, tvec, the exchange
  // buffer at the out-of-band value ----
  int8_t* tv = a.tvec + (size_t)p * a.L2;
  stage_pair<CT, HOMO>(a, p, len1, len2, lay.wr, s1s, s2s, tv, tid, T);
  for (int x = tid; x < 4 * (G + 2); x += T) ex[x] = OOB;
  if (tid == 0) slab_offsets(lay, a.W, off);
  pair_sync(T);

  // ---- fill: diagonals 1 .. len1 + len2, one barrier each ----
  F f;
  f.s1s = s1s;
  f.s2s = s2s;
  f.slab = slab;
  f.off = off;
  f.wr = lay.wr;
  f.row0 = g * 32 * WIDE_RPT;
  f.exw = ex + 2 * (g + 1);
  f.exs = 2 * (G + 2);
  f.nthreads = T;
  fill_pair(f, a, len1, len2, lband, rband, tid, lane);
  pair_sync(T);  // every warp's slab words are written
  // ---- end of fill ----
  if (g != 0) return;

  // ---- traceback: warp 0 walks the pointers as one warp, then writes the
  // rows ----
  // The window of a group of sixteen diagonals: lane l holds its words at
  // rows c - 31 + l and c + 1 + l (0 outside the group's rows). Entered at
  // row rr0, a group's cells lie within rr0 +- 15 (at most 16 steps, each
  // moving the row by at most one), and the next group's within rr0 +- 31,
  // so the window centred at the entry row of group q serves group q - 1.
  const int nsteps = a.L1 + a.L2;
  int i = len1, j = len2, steps = 0, cq = -1, c = 0, nc = 0;
  unsigned wa = 0u, wb = 0u, na = 0u, nb = 0u;
  auto window = [&](const int q, const int cen, unsigned& x, unsigned& y) {
    x = y = 0u;
    if (q < 0) return;
    const int base = off[q], rows = off[q + 1] - base;
    const int r0 = cen - 31 + lane, r1 = cen + 1 + lane;
    if ((unsigned)r0 < (unsigned)rows) x = slab[base + r0];
    if ((unsigned)r1 < (unsigned)rows) y = slab[base + r1];
  };
  while (steps < nsteps && (i | j)) {
    const int dd = i + j;
    const int rr = i - f.lo(dd);
    if ((dd >> 4) != cq) {  // a new group: its window, and the next one's
      if (cq < 0) {
        window(dd >> 4, rr, wa, wb);
        c = rr;
      } else {
        wa = na;
        wb = nb;
        c = nc;
      }
      cq = dd >> 4;
      window(cq - 1, rr, na, nb);
      nc = rr;
    }
    const int k = rr - c + 31;
    unsigned wd = __shfl_sync(FULL, k < 32 ? wa : wb, k & 31);
    // a cell outside the band (i > hi(d); the other limits hold on the
    // path) or outside the window has no pointer
    if ((unsigned)k >= 64u || i > ((dd + lband) >> 1)) wd = 0u;
    const int kind = (wd >> (2 * (dd & 15))) & 3;
    if (kind == 0) break;  // no pointer here: stuck outside the window
    if (lane == 0) kb[steps] = (unsigned char)kind;
    ++steps;
    i -= kind != 2;
    j -= kind != 3;
  }
  __syncwarp();
  write_steps(a, p, tv, kb, steps, len1, len2, s1s, s2s, lay.wr, lane);
  // ---- end of traceback ----
}

// Where kernel B4 keeps one pair's pointers in the one-block-per-pair body
// at this batch geometry (nd diagonals, windows of up to W rows, sequences
// padded to L1 and L2): 1 in shared memory, 2 in a device-memory slab (the
// wrapper allocates 4 * nd * ceil(W / 32) * 2 bytes per pair), 0 if even
// the score buffers and the staged sequences exceed one block's 227 KB.
extern "C" int nw_batch_block_route(int L1, int L2, int nd, int W, int homo) {
  if (L1 < 1 || L2 < 1 || nd < 1 || W < 1) return 0;
  if (batch_layout(L1, L2, nd, W, homo, true).bytes <= SMEM_MAX) return 1;
  if (batch_layout(L1, L2, nd, W, homo, false).bytes <= SMEM_MAX) return 2;
  return 0;
}

// Which body of kernel B4 serves a batch geometry: 3 the register body
// (windows of up to REG_W_MAX rows whose warp's shared memory fits one
// block); else, for windows of up to WIDE_W_MAX rows, 4 the wide body (its
// pointers in a device-memory slab of nw_batch_wide_slab_words words a
// pair); else the one-block-per-pair body's route (nw_batch_block_route:
// 1, 2, or 0 where nothing fits). This is the one place that decides the
// fit.
extern "C" int nw_batch_route(int L1, int L2, int nd, int W, int homo) {
  if (L1 < 1 || L2 < 1 || nd < 1 || W < 1) return 0;
  if (W <= REG_W_MAX && reg_layout(L1, L2, nd, W, homo).stride <= SMEM_MAX)
    return 3;
  if (W <= WIDE_W_MAX &&
      reg_layout(L1, L2, nd, W, homo, true).stride <= SMEM_MAX)
    return 4;
  return nw_batch_block_route(L1, L2, nd, W, homo);
}

// 32-bit words of one pair's pointer slab in the register and wide bodies
// (the groups of sixteen diagonals' rows, see group_rows): what the wrapper
// allocates a pair for route 4.
extern "C" int nw_batch_wide_slab_words(int nd, int W) {
  if (nd < 1 || W < 1) return 0;
  return reg_layout(1, 1, nd, W, false, true).words;
}

// Warps per pair at windows of up to W rows: 1 in the register body, G in
// the wide body.
extern "C" int nw_batch_warps(int W) {
  return W <= REG_W_MAX ? 1 : wide_warps(W);
}

// Rows per thread of the register and wide bodies at windows of up to W rows.
extern "C" int nw_batch_reg_rpt(int W) { return reg_rpt(W); }

template <int RPT>
static const void* reg_fn_rpt(int scalar, int homo) {
  if (!scalar) return (const void*)nw_batch_reg_kernel<RPT, false, false>;
  if (homo) return (const void*)nw_batch_reg_kernel<RPT, true, true>;
  return (const void*)nw_batch_reg_kernel<RPT, true, false>;
}

static const void* reg_fn(int W, int scalar, int homo) {
  switch (reg_rpt(W)) {
    case 1:
      return reg_fn_rpt<1>(scalar, homo);
    case 2:
      return reg_fn_rpt<2>(scalar, homo);
    case 4:
      return reg_fn_rpt<4>(scalar, homo);
    default:
      return reg_fn_rpt<8>(scalar, homo);
  }
}

// Blocks of the register body with P pairs resident on one SM (the CUDA
// occupancy calculator, from the instantiation's registers and the
// block's shared memory), 0 if such a block cannot run.
static int reg_blocks_per_sm(int L1, int L2, int nd, int W, int scalar,
                             int homo, int P) {
  if (W < 1 || W > REG_W_MAX || P < 1 || P > REG_P_MAX || (homo && !scalar))
    return 0;
  const long long bytes =
      (long long)P * reg_layout(L1, L2, nd, W, homo).stride;
  const void* fn = reg_fn(W, scalar, homo);
  cudaFuncAttributes fa;
  int bps = 0;
  if (bytes > SMEM_MAX || cudaFuncGetAttributes(&fa, fn) != cudaSuccess ||
      32 * P > fa.maxThreadsPerBlock ||
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           SMEM_MAX) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&bps, fn, 32 * P,
                                                    (int)bytes) != cudaSuccess)
    return 0;
  return bps;
}

// The register body's pairs per block for a launch of n pairs: the P (a
// power of two up to REG_P_MAX) that keeps the most pairs resident per SM,
// on a tie the smaller (the warps of a block are independent, but a block
// holds its resources until its last pair is done); a P is considered
// only if the grid still gives every SM two blocks (P = 1 always is). 0 if
// not even one pair fits. The wide body's is 1.
extern "C" int nw_batch_pairs_per_block(int L1, int L2, int nd, int W,
                                        int scalar, int homo, int n) {
  int dev = 0, nsm = 0;
  const int r = nw_batch_route(L1, L2, nd, W, homo);
  if (r == 4) return 1;  // the wide body: a block is one pair
  if (r != 3 ||
      cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  int best = 0, best_res = 0;
  for (int P = 1; P <= REG_P_MAX; P *= 2) {
    if (P > 1 && ((long long)n + P - 1) / P < 2LL * nsm) break;
    const int bps = reg_blocks_per_sm(L1, L2, nd, W, scalar, homo, P);
    if (bps == 0) break;
    if (P * bps > best_res) {
      best = P;
      best_res = P * bps;
    }
  }
  return best;
}

template <int RPT, bool SCALAR, bool HOMO>
static int launch_reg(const BatchArgs& a, int n, int nd, int P,
                      cudaStream_t stream) {
  const RegLayout lay = reg_layout(a.L1, a.L2, nd, a.W, HOMO);
  const long long bytes = (long long)P * lay.stride;
  if (P < 1 || 32 * P > REG_THREADS(RPT) || bytes > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        nw_batch_reg_kernel<RPT, SCALAR, HOMO>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  nw_batch_reg_kernel<RPT, SCALAR, HOMO>
      <<<(n + P - 1) / P, 32 * P, (int)bytes, stream>>>(a, lay, n);
  return (int)cudaGetLastError();
}

template <int RPT>
static int launch_reg_mode(const BatchArgs& a, int n, int nd, int P,
                           int scalar, int homo, cudaStream_t s) {
  if (!scalar) return launch_reg<RPT, false, false>(a, n, nd, P, s);
  if (homo) return launch_reg<RPT, true, true>(a, n, nd, P, s);
  return launch_reg<RPT, true, false>(a, n, nd, P, s);
}

template <bool SCALAR, bool HOMO>
static int launch_wide(const BatchArgs& a, int n, int nd,
                       cudaStream_t stream) {
  const RegLayout lay = reg_layout(a.L1, a.L2, nd, a.W, HOMO, true);
  const int G = wide_warps(a.W);
  if (lay.stride > SMEM_MAX || a.W > WIDE_W_MAX || !a.slab ||
      a.slab_words < lay.words)
    return (int)cudaErrorInvalidValue;
  if (lay.stride > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        nw_batch_wide_kernel<SCALAR, HOMO>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, lay.stride);
    if (e != cudaSuccess) return (int)e;
  }
  nw_batch_wide_kernel<SCALAR, HOMO>
      <<<n, 32 * G, lay.stride, stream>>>(a, lay);
  return (int)cudaGetLastError();
}

static int launch_wide_mode(const BatchArgs& a, int n, int nd, int scalar,
                            int homo, cudaStream_t s) {
  if (!scalar) return launch_wide<false, false>(a, n, nd, s);
  if (homo) return launch_wide<true, true>(a, n, nd, s);
  return launch_wide<true, false>(a, n, nd, s);
}

template <bool SCALAR, bool HOMO, bool GSLAB>
static int launch(const BatchArgs& a, int n, int nd, cudaStream_t stream) {
  const BatchLayout lay = batch_layout(a.L1, a.L2, nd, a.W, HOMO, !GSLAB);
  if (lay.bytes > SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (lay.bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        nw_batch_kernel<SCALAR, HOMO, GSLAB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, lay.bytes);
    if (e != cudaSuccess) return (int)e;
  }
  // 32..THREADS_MAX threads, a multiple of 32 covering the window's rows
  int threads = (a.W + 31) / 32 * 32;
  if (threads < 32) threads = 32;
  if (threads > THREADS_MAX) threads = THREADS_MAX;
  nw_batch_kernel<SCALAR, HOMO, GSLAB>
      <<<n, threads, lay.bytes, stream>>>(a, lay);
  return (int)cudaGetLastError();
}

template <bool GSLAB>
static int launch_mode(const BatchArgs& a, int n, int nd, int scalar,
                       int homo, cudaStream_t s) {
  if (!scalar) return launch<false, false, GSLAB>(a, n, nd, s);
  if (homo) return launch<true, true, GSLAB>(a, n, nd, s);
  return launch<true, false, GSLAB>(a, n, nd, s);
}

// Launches kernel B4 on `stream` for n pairs: route 3 the register body
// (`ppb` pairs per block, see nw_batch_pairs_per_block; `slab` unused), 4
// the wide body with the pointer slab in `slab` (slab_words words per
// pair, at least nw_batch_wide_slab_words), 1 and 2 the one-block-per-pair
// body with the pointer slab in shared memory (route 1; `slab` unused) or
// in `slab` (route 2, slab_words words per pair). Routes 3 and 4 are taken
// where nw_batch_route says so, routes 1 and 2 where nw_batch_block_route
// fits them. Returns cudaGetLastError() after
// the launch (0 = launched), or cudaErrorInvalidValue for a route that
// does not fit, a missing slab, a `ppb` that does not fit one block or
// homopolymer masks outside the scalar aligner.
extern "C" int nw_batch_run(const int8_t* s1, const int* len1,
                            const int8_t* s2, const int* len2,
                            const uint8_t* h1, const uint8_t* h2,
                            int8_t* kinds, int* p0, int* p1, int* ham,
                            int8_t* tvec, uint8_t* ok, uint32_t* slab, int n,
                            int L1, int L2, int nd, int W, int slab_words,
                            int scalar, int homo, int band, int match,
                            int mismatch, int gap_p, int end_gap_p,
                            int homo_gap_p, int route, int ppb,
                            void* stream) {
  if (n <= 0) return 0;
  if (homo && (!scalar || !h1 || !h2)) return (int)cudaErrorInvalidValue;
  const BatchArgs a = {s1,   len1, s2,    len2, h1,  h2,       kinds,
                       p0,   p1,   ham,   tvec, ok,  slab,     slab_words,
                       L1,   L2,   W,     band, match, mismatch, gap_p,
                       end_gap_p, homo_gap_p};
  cudaStream_t s = (cudaStream_t)stream;
  if (route == 3) {
    if (nw_batch_route(L1, L2, nd, W, homo) != 3)
      return (int)cudaErrorInvalidValue;
    switch (reg_rpt(W)) {
      case 1:
        return launch_reg_mode<1>(a, n, nd, ppb, scalar, homo, s);
      case 2:
        return launch_reg_mode<2>(a, n, nd, ppb, scalar, homo, s);
      case 4:
        return launch_reg_mode<4>(a, n, nd, ppb, scalar, homo, s);
      default:
        return launch_reg_mode<8>(a, n, nd, ppb, scalar, homo, s);
    }
  }
  if (route == 4) {
    if (nw_batch_route(L1, L2, nd, W, homo) != 4)
      return (int)cudaErrorInvalidValue;
    return launch_wide_mode(a, n, nd, scalar, homo, s);
  }
  const int fit = nw_batch_block_route(L1, L2, nd, W, homo);
  if (route < 1 || route > 2 || fit == 0 || (route == 2 && !slab) ||
      (route == 1 && fit != 1))
    return (int)cudaErrorInvalidValue;
  return route == 2 ? launch_mode<true>(a, n, nd, scalar, homo, s)
                    : launch_mode<false>(a, n, nd, scalar, homo, s);
}
