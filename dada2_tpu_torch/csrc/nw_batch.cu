// Batched Needleman-Wunsch over per-pair windows for Hopper (kernel B4):
// one block per pair.
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
// pair is a chain of len1 + len2 dependent diagonal steps, each ending in a
// block barrier, followed by a serial traceback of as many steps.
//
// Design (simple first; ROADMAP's redesign would move the fill into
// registers as B1's): one block per pair, 32..256 threads striding over the
// pair's window rows on each diagonal. The scores of diagonals d-1 and d-2
// and the one being written live in three int32 buffers in shared memory
// (one barrier per diagonal; the buffer written at d+1 is the one read at
// d-1, so one barrier suffices), with one guard row on each side that stays
// at the out-of-band value. The sequences (and masks) are staged into
// shared memory once. Pointers are 2 bits per cell, as two bit planes per
// warp and diagonal (__ballot_sync), in shared memory when nd x W fits one
// block, else in a device-memory slab that the wrapper allocates (a PacBio
// read of ~1450 bp without a band needs ~1 MB per pair); the choice is made
// before the launch (nw_batch_route). After the last barrier thread 0 walks
// the traceback and writes kinds/p0/p1, ham and the tvec entries of
// diagonal steps; the other threads initialise tvec before the fill and
// write the tail of the step rows after the walk.
#include <cuda_runtime.h>
#include <stdint.h>

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
}

// Where kernel B4 keeps one pair's pointers at this batch geometry (nd
// diagonals, windows of up to W rows, sequences padded to L1 and L2): 1 in
// shared memory, 2 in a device-memory slab (the wrapper allocates
// 4 * nd * ceil(W / 32) * 2 bytes per pair), 0 if even the score buffers
// and the staged sequences exceed one block's 227 KB. This is the one place
// that decides the fit.
extern "C" int nw_batch_route(int L1, int L2, int nd, int W, int homo) {
  if (L1 < 1 || L2 < 1 || nd < 1 || W < 1) return 0;
  if (batch_layout(L1, L2, nd, W, homo, true).bytes <= SMEM_MAX) return 1;
  if (batch_layout(L1, L2, nd, W, homo, false).bytes <= SMEM_MAX) return 2;
  return 0;
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

// Launches kernel B4 on `stream` for n pairs (one block each) with the
// pointer slab in shared memory (route 1; `slab` unused) or in `slab`
// (route 2, slab_words words per pair). Returns cudaGetLastError() after
// the launch (0 = launched), or cudaErrorInvalidValue for a route that does
// not fit (see nw_batch_route), a missing slab or homopolymer masks outside
// the scalar aligner.
extern "C" int nw_batch_run(const int8_t* s1, const int* len1,
                            const int8_t* s2, const int* len2,
                            const uint8_t* h1, const uint8_t* h2,
                            int8_t* kinds, int* p0, int* p1, int* ham,
                            int8_t* tvec, uint8_t* ok, uint32_t* slab, int n,
                            int L1, int L2, int nd, int W, int slab_words,
                            int scalar, int homo, int band, int match,
                            int mismatch, int gap_p, int end_gap_p,
                            int homo_gap_p, int route, void* stream) {
  if (n <= 0) return 0;
  if (route < 1 || route > 2 || (route == 2 && !slab) ||
      (homo && (!scalar || !h1 || !h2)) ||
      nw_batch_route(L1, L2, nd, W, homo) == 0 ||
      (route == 1 && nw_batch_route(L1, L2, nd, W, homo) != 1))
    return (int)cudaErrorInvalidValue;
  const BatchArgs a = {s1,   len1, s2,    len2, h1,  h2,       kinds,
                       p0,   p1,   ham,   tvec, ok,  slab,     slab_words,
                       L1,   L2,   W,     band, match, mismatch, gap_p,
                       end_gap_p, homo_gap_p};
  cudaStream_t s = (cudaStream_t)stream;
  return route == 2 ? launch_mode<true>(a, n, nd, scalar, homo, s)
                    : launch_mode<false>(a, n, nd, scalar, homo, s);
}
