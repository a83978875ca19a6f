// Banded ends-free Needleman-Wunsch on the wavefront, for Hopper: one
// kernel body in three modes, chosen at compile time.
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
// Same arrays in and out, bit for bit:
//   scal   [nb, 4]          int32  len1, len2max (C), rbmax, len2min per block
//   params [nb, 8, 128]     int32  rows 0..2: len2, lband, rband per lane
//   s1     [L1R, 128]       int32  row m = center char s1[m-1] (B1, B3), or
//          [nb, L1R, 128]          per block and lane (B2)
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
// Semantics are the vectorized aligner's (reference:
// src/nwalign_vectorized.cpp:71-318): tie precedence up >= left > diag,
// band widened on the long side, the ends-free last-row/last-column
// recalculation activating one diagonal late. The window origin
// o(d) = max(0, d - C, ceil((d - rbmax) / 2)) and window width WP are the
// TPU kernel's, so cells it leaves outside the window stay outside here.
//
// What bounds it on the card: the bytes are small (the arrays above, read
// or written once), so the roofline bound is the fill's integer work: 13
// int32 operations per in-band cell that the recurrence needs (itemised
// in chip_smoke.py; the borders, band tests and ends-free recalculations
// this body runs on every cell are needed only at the band's edges and on
// the last row and column, so the bound leaves them out). In practice each
// pair is a chain of len1 + len2 dependent anti-diagonal steps followed by
// a serial traceback of the same length, so the chain's latency limits it:
// one step has to wait for the previous diagonal.
//
// Design: one warp per pair (a pair = one lane of a 128-lane block), the
// window rows on the warp's threads (WP / 32 rows per thread, WP <= 128),
// so the neighbours on diagonals d-1 and d-2 are reads from a three-deep
// ring of windows in shared memory, and one step costs one __syncwarp.
// Thousands of pairs are in flight at once, which hides the per-step
// latency. The 2-bit pointers are packed four diagonals to a byte in
// shared memory (ceil(NDP / 4) * WP bytes per pair) and never touch device
// memory; the center and candidate columns are staged into shared memory
// once, and lane 0 of the warp runs the traceback from shared memory.
// The modes differ only in where the s1 column is staged from and in the
// traceback's extra per-diagonal write, so they are template parameters of
// one body. The uniform-origin storage tricks, `halves` and the
// four-diagonal chunking of the TPU kernel were workarounds for its layout
// and loop overhead and are not reproduced.
#include <cuda_runtime.h>

#define LANES 128
#define NEG (-(1 << 29))
#define SMEM_MAX 232448  // 227 KB: the most one block may use on sm_90

enum Emit { EMIT_NONE = 0, EMIT_KINDS = 1, EMIT_CLS = 2 };

struct Args {
  const int* scal;
  const int* params;
  const int* s1;
  const int* s2q;
  int* kinds;
  int* sub;
  int* mapq;
  int* endo;
  int L1R, L2R, NDP, ppb, match, mismatch, gap_p;
};

__host__ __device__ static inline int pair_smem_bytes(int L1R, int L2R,
                                                      int NDP, int WP) {
  int bytes = 4 * (L2R + L1R + 3 * WP) + ((NDP + 3) / 4) * WP;
  return (bytes + 15) & ~15;
}

__device__ __forceinline__ int origin(int d, int C, int rbmax) {
  int a = d - C;
  int b = (d - rbmax + 1) >> 1;  // arithmetic shift: floor, as in the TPU
  int m = a > b ? a : b;
  return m > 0 ? m : 0;
}

template <int RPT, bool S1LANE, int EMIT>
__global__ void nw_wavefront_kernel(const Args a) {
  constexpr int WP = RPT * 32;
  extern __shared__ __align__(16) unsigned char smem[];
  const int L1R = a.L1R, L2R = a.L2R, NDP = a.NDP, ppb = a.ppb;
  const int per_pair = pair_smem_bytes(L1R, L2R, NDP, WP);
  const int warp = threadIdx.x >> 5;
  const int t = threadIdx.x & 31;
  const int pair0 = blockIdx.x * ppb;  // ppb divides LANES
  const int b = pair0 / LANES;
  const int lane0 = pair0 % LANES;

  // ---- zero this block's output columns and stage the char columns ----
  for (int k = threadIdx.x; k < L2R * ppb; k += blockDim.x) {
    int row = k / ppb, l = k % ppb;
    size_t g = ((size_t)b * L2R + row) * LANES + lane0 + l;
    a.sub[g] = 0;
    int* s2c = (int*)(smem + (size_t)l * per_pair);
    s2c[row] = a.s2q[g];
  }
  for (int k = threadIdx.x; k < L1R * ppb; k += blockDim.x) {
    int row = k / ppb, l = k % ppb;
    size_t g = ((size_t)b * L1R + row) * LANES + lane0 + l;
    a.mapq[g] = 0;
    int* s1c = (int*)(smem + (size_t)l * per_pair) + L2R;
    s1c[row] = S1LANE ? a.s1[g] : a.s1[(size_t)row * LANES + lane0 + l];
  }
  if (EMIT != EMIT_NONE) {
    for (int k = threadIdx.x; k < NDP * ppb; k += blockDim.x) {
      int row = k / ppb, l = k % ppb;
      a.kinds[((size_t)b * NDP + row) * LANES + lane0 + l] = 0;
    }
  }
  for (int k = threadIdx.x; k < 6 * ppb; k += blockDim.x) {
    int row = 2 + k / ppb, l = k % ppb;
    a.endo[((size_t)b * 8 + row) * LANES + lane0 + l] = 0;
  }
  __syncthreads();

  const int lane = lane0 + warp;
  const int* s2c = (const int*)(smem + (size_t)warp * per_pair);
  const int* s1c = s2c + L2R;
  int* ring = (int*)(smem + (size_t)warp * per_pair) + L2R + L1R;
  unsigned char* slab =
      smem + (size_t)warp * per_pair + 4 * (L2R + L1R + 3 * WP);

  const int len1 = a.scal[b * 4 + 0];
  const int C = a.scal[b * 4 + 1];
  const int rbmax = a.scal[b * 4 + 2];
  const int l2 = a.params[((size_t)b * 8 + 0) * LANES + lane];
  const int lb = a.params[((size_t)b * 8 + 1) * LANES + lane];
  const int rb = a.params[((size_t)b * 8 + 2) * LANES + lane];
  const int nd = len1 + l2;  // later diagonals never reach the traceback
  const size_t e0 = ((size_t)b * 8 + 0) * LANES + lane;
  const size_t e1 = ((size_t)b * 8 + 1) * LANES + lane;

  // geometry the buffers cannot hold: report a failed traceback
  if (len1 < 0 || l2 < 0 || l2 > C || C > L2R || len1 >= L1R ||
      len1 + C >= NDP) {
    if (t == 0) {
      a.endo[e0] = len1 > 0 ? len1 : 1;
      a.endo[e1] = l2;
    }
    return;
  }

  // diagonal 0 lives in ring slot 0 (only cell (0, 0) = 0 is in band),
  // diagonal -1 in slot 2
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    int r = t + 32 * k;
    ring[r] = r == 0 ? 0 : NEG;
    ring[2 * WP + r] = NEG;
  }
  __syncwarp();

  const int match = a.match, mismatch = a.mismatch, gap_p = a.gap_p;
  const int j_first = lb < len1 ? len1 - lb : 0;
  const int i_first = rb < l2 ? l2 - rb : 0;
  unsigned acc[RPT];
#pragma unroll
  for (int k = 0; k < RPT; ++k) acc[k] = 0u;

  int om1 = 0, om2 = 0;  // o(d-1), o(d-2)
  for (int d = 1; d <= nd; ++d) {
    const int od = origin(d, C, rbmax);
    const int* P1 = ring + ((d + 2) % 3) * WP;  // diagonal d-1
    const int* P2 = ring + ((d + 1) % 3) * WP;  // diagonal d-2
    int* PC = ring + (d % 3) * WP;
    const int s1w = od - om1;      // 0 or 1
    const int s2w = od - om2 - 1;  // -1, 0 or 1
    // score(len1, j-1) on diagonal d-1 (0 when outside the window, as in
    // the TPU kernel's masked row sum), plus end_gap_p = 0
    const int rrow = len1 - om1;
    const int candr = (rrow >= 0 && rrow < WP) ? P1[rrow] : 0;
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      const int r = t + 32 * k;
      const int i = od + r;
      const int j = d - i;
      const int rl = r + s1w;  // (i, j-1)
      const int ru = rl - 1;   // (i-1, j)
      const int rd = r + s2w;  // (i-1, j-1)
      const int Lraw = rl < WP ? P1[rl] : NEG;
      const int Uraw = (ru >= 0 && ru < WP) ? P1[ru] : NEG;
      const int Dp = (rd >= 0 && rd < WP) ? P2[rd] : NEG;
      const int Lv = Lraw + gap_p;
      const int U = Uraw + gap_p;
      const int c1 = i < L1R ? s1c[i] : 0;
      const int srow = C - j;
      const int c2 = (srow >= 0 && srow < L2R) ? (s2c[srow] & 3) : 0;
      const int D = Dp + (c1 == c2 ? match : mismatch);
      int entry, ptr;
      if (U >= Lv) {
        entry = U;
        ptr = 3;
      } else {
        entry = Lv;
        ptr = 2;
      }
      if (D > entry) {
        entry = D;
        ptr = 1;
      }
      if (j == 0) {  // i * end_gap_p
        entry = 0;
        ptr = 3;
      }
      if (i == 0) {  // j * end_gap_p
        entry = 0;
        ptr = 2;
      }
      // ends-free recalculation, one diagonal late, only where the band
      // clips that side (reference: src/nwalign_vectorized.cpp:186-215)
      if (i == len1 && j > j_first && i > 0 && j > 0) {
        if (candr > entry) {
          entry = candr;
          ptr = 2;
        } else if (candr == entry && ptr == 1) {
          ptr = 2;
        }
      }
      if (j == l2 && i > i_first && i > 0 && j > 0) {
        const int candc = Uraw;  // U - gap_p + end_gap_p
        if (candc > entry) {
          entry = candc;
          ptr = 3;
        } else if (candc == entry && ptr != 3) {
          ptr = 3;
        }
      }
      const bool valid = (i - j <= lb) && (j - i <= rb) && (i <= len1) &&
                         (j >= 0) && (j <= l2);
      if (!valid) {
        entry = NEG;
        ptr = 0;
      }
      PC[r] = entry;
      acc[k] |= (unsigned)ptr << (2 * (d & 3));
      if ((d & 3) == 3) {
        slab[(d >> 2) * WP + r] = (unsigned char)acc[k];
        acc[k] = 0u;
      }
    }
    __syncwarp();
    om2 = om1;
    om1 = od;
  }
  if ((nd & 3) != 3) {  // flush the trailing partial byte
#pragma unroll
    for (int k = 0; k < RPT; ++k)
      slab[(nd >> 2) * WP + t + 32 * k] = (unsigned char)acc[k];
  }
  __syncwarp();

  // ---- traceback from (len1, len2) ----
  // The cell in hand always lies on diagonal d = i + j (a diagonal step
  // skips one diagonal, on which the TPU kernel's loop idles and writes
  // kind / class 0).
  if (t != 0) return;
  // row d of this lane's kinds / class column sits at emit[d * LANES]
  int* emit =
      EMIT == EMIT_NONE ? nullptr : a.kinds + (size_t)b * NDP * LANES + lane;
  int i = len1, j = l2;
  while (i + j >= 1) {
    const int d = i + j;
    const int r = i - origin(d, C, rbmax);
    const int kind =
        (r >= 0 && r < WP) ? (slab[(d >> 2) * WP + r] >> (2 * (d & 3))) & 3
                           : 0;
    if (EMIT == EMIT_KINDS) emit[(size_t)d * LANES] = kind;
    if (kind == 1) {
      const int c1 = s1c[i];
      const int sq = s2c[C - j];
      const int c2 = sq & 3;
      if (c1 != c2) a.sub[((size_t)b * L2R + C - j) * LANES + lane] = c1 + 1;
      if (EMIT == EMIT_CLS) emit[(size_t)d * LANES] = c1 != c2 ? 3 : 4;
      a.mapq[((size_t)b * L1R + i) * LANES + lane] =
          ((sq >> 2) << 17) | (j << 3) | (c2 + 2);
      --i;
      --j;
    } else if (kind == 3) {
      if (EMIT == EMIT_CLS) emit[(size_t)d * LANES] = 2;
      a.mapq[((size_t)b * L1R + i) * LANES + lane] = 1;
      --i;
    } else if (kind == 2) {
      if (EMIT == EMIT_CLS) emit[(size_t)d * LANES] = 1;
      --j;
    } else {
      // no pointer here: the traceback is stuck, end != (0, 0). The TPU
      // kernel still classes this active step (as 4, "not an insertion,
      // gap or substitution"), so the class row does too.
      if (EMIT == EMIT_CLS) emit[(size_t)d * LANES] = 4;
      break;
    }
  }
  a.endo[e0] = i;
  a.endo[e1] = j;
}

// Pairs (warps) per block: the largest of 4, 2, 1 whose shared memory fits
// one block's 227 KB; 0 if even one pair does not fit or WP is not a
// multiple of 32 up to 128. This is the one place that decides the fit
// (the TPU kernel's VMEM_SLAB_CAP check does not carry over). The modes
// share the layout: the kinds / class rows go straight to device memory.
extern "C" int nw_wavefront_pairs_per_block(int L1R, int L2R, int NDP,
                                            int WP) {
  if (WP < 32 || WP > 128 || WP % 32) return 0;
  const int per = pair_smem_bytes(L1R, L2R, NDP, WP);
  for (int ppb = 4; ppb >= 1; ppb /= 2)
    if (ppb * per <= SMEM_MAX) return ppb;
  return 0;
}

template <int RPT, bool S1LANE, int EMIT>
static int launch(const Args& a, int nb, cudaStream_t stream) {
  const int bytes = a.ppb * pair_smem_bytes(a.L1R, a.L2R, a.NDP, RPT * 32);
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        nw_wavefront_kernel<RPT, S1LANE, EMIT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(nb * (LANES / a.ppb)), block(32 * a.ppb);
  nw_wavefront_kernel<RPT, S1LANE, EMIT><<<grid, block, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool S1LANE, int EMIT>
static int launch_wp(const Args& a, int nb, int WP, cudaStream_t stream) {
  switch (WP / 32) {
    case 1:
      return launch<1, S1LANE, EMIT>(a, nb, stream);
    case 2:
      return launch<2, S1LANE, EMIT>(a, nb, stream);
    case 3:
      return launch<3, S1LANE, EMIT>(a, nb, stream);
    default:
      return launch<4, S1LANE, EMIT>(a, nb, stream);
  }
}

// Launches one mode on `stream`: mode 1 = B1 compare, 2 = B2 pairs (s1 per
// block and lane, class rows into `kinds`), 3 = B3 kinds (shared s1, kind
// rows into `kinds`); `kinds` is unused in mode 1. Returns
// cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for an unknown mode or a window that does not fit
// one block (nw_wavefront_pairs_per_block == 0).
extern "C" int nw_wavefront_run(const int* scal, const int* params,
                                const int* s1, const int* s2q, int* kinds,
                                int* sub, int* mapq, int* endo, int nb,
                                int L1R, int L2R, int NDP, int WP, int mode,
                                int match, int mismatch, int gap_p,
                                void* stream) {
  if (nb <= 0) return 0;
  const int ppb = nw_wavefront_pairs_per_block(L1R, L2R, NDP, WP);
  if (ppb == 0) return (int)cudaErrorInvalidValue;
  const Args a = {scal, params, s1,  s2q, kinds, sub,      mapq,
                  endo, L1R,    L2R, NDP, ppb,   match, mismatch,
                  gap_p};
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case 1:
      return launch_wp<false, EMIT_NONE>(a, nb, WP, s);
    case 2:
      return launch_wp<true, EMIT_CLS>(a, nb, WP, s);
    case 3:
      return launch_wp<false, EMIT_KINDS>(a, nb, WP, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
