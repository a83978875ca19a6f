// Kernel B5: the budded compare's store screen and shortlist pack, for
// Hopper (sm_90a).
//
// Replaces the XLA programs of dada2_tpu/core/backend_tpu.py's budded
// compare: _budded_fused (:520) after its small pack, i.e.
// _shortlist_screen (:779), the stable ascending compactions
// (argsort(~need, stable=True)), _subs_tile_trace (:410) and
// _subs_bits_trace (:426) over _sel_tv (:386), and the follow-up
// _take_subs (:640). Plain version and layout: ops/store_screen.py
// (budded_pack_ref, take_subs_ref, budbuf_layout); every output byte is
// the plain version's.
//
// Three kernels per budded compare (one launch each):
//   screen_kernel   one thread per row: the f32 store screen, a status
//                   byte per row, and the need and shroud bitmaps from
//                   warp ballots;
//   compact_kernel  one block: a chunked block scan of the status bytes
//                   gives the stable compactions (needed rows ascending,
//                   then the others ascending; in cache mode the same
//                   for needed uncached rows) and the header. A scan,
//                   never an atomic counter: the host rebuilds the
//                   shortlist's row indices from the need bitmap, so the
//                   order must be ascending;
//   pack_kernel     one warp per shortlist slot: the slot's 5-byte small
//                   row and its substitution records (tiles: the first K
//                   pos | nt0 << 14 entries in ascending position, 0xFFFF
//                   after; bits: the position bitmap and the 2-bit nt0
//                   stream), positions compacted with ballots and popc.
// The follow-up runs pack_kernel alone over compacted rows [M0, M0 + M).
//
// What bounds it: bytes. The screen reads 13 + 2 + 4 bytes a row and
// writes one status byte; the pack reads two W-byte rows (tvec, seqs) per
// slot. The work is a few hundred KB per compare, so at phase 5's sizes
// the launches' latency, not the card's memory rate, sets its time.
//
// Numerics: the screen's f32 arithmetic is the JAX package's, in its
// order, with no contraction into FMAs (__fmul_rn / __fadd_rn) and the
// accurate logf (no fast math), and subnormals read as zero, as XLA
// reads them (flush), so `need` is bitwise the plain version's.
// e_thresh arrives as bf16 bits, the f32's upper half (a
// truncation, so a lower bound of the threshold); the kernel rebuilds the
// f32 as bits << 16.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int SCREEN_THREADS = 256;
constexpr int COMPACT_THREADS = 1024;
constexpr int PACK_WARPS = 8;
constexpr int STREAM_WORDS = 64;   // a warp's nt0 stream: K <= 1024
constexpr uint8_t ST_NEED = 1, ST_NEED_U = 2, ST_CAND = 4, ST_NSHROUD = 8;

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

// rows n..nd-1 are the JAX package's pad rows: copies of row 0
__device__ __forceinline__ int src_row(int r, int n) { return r < n ? r : 0; }

__global__ void __launch_bounds__(SCREEN_THREADS)
screen_kernel(const uint8_t* __restrict__ small13,
              const uint8_t* __restrict__ eth2, const int* __restrict__ reads,
              const uint8_t* __restrict__ cbits, int n, int nd, int center,
              int greedy, int cache_on, float c5L, float cL5, float und,
              uint8_t* __restrict__ status, uint8_t* __restrict__ need_pk,
              uint8_t* __restrict__ shroud_pk) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  bool need = false, shroud = false;
  if (r < nd) {
    const int s = src_row(r, n);
    const uint8_t* row = small13 + (size_t)s * 13;
    const uint32_t eb = (uint32_t)eth2[2 * r] | ((uint32_t)eth2[2 * r + 1] << 8);
    const float e = flush(__uint_as_float(eb << 16));
    bool nskip = (eth2[2 * nd + (r >> 3)] >> (r & 7)) & 1;
    if (greedy) {
      nskip = nskip || reads[s] > reads[center];
      nskip = nskip && r != center;
    }
    const float loglam = flush(load_f32(row + 4));
    const float abssum = flush(load_f32(row + 8));
    shroud = (row[12] & 4) != 0;
    const bool cand = !nskip && !shroud;
    const bool pos = e > 0.f;
    const float logthr = pos ? logf(e) : -INFINITY;
    const float eps = 1.1920928955078125e-7f;   // 2^-23
    const float m1 = __fadd_rn(
        1e-3f, __fmul_rn(eps, __fadd_rn(c5L, __fmul_rn(cL5, abssum))));
    const float margin = __fadd_rn(
        m1, __fmul_rn(4.f * eps, isfinite(logthr) ? fabsf(logthr) : 0.f));
    const float logthr2 = pos ? logthr : (e == 0.f ? und : -INFINITY);
    need = cand && ((flush(__fadd_rn(loglam, margin)) >= logthr2) ||
                    (!isfinite(loglam) && e != 0.f));
    const bool need_u =
        need && !(cache_on && ((cbits[r >> 3] >> (r & 7)) & 1));
    status[r] = (need ? ST_NEED : 0) | (need_u ? ST_NEED_U : 0) |
                (cand ? ST_CAND : 0) | (shroud && !nskip ? ST_NSHROUD : 0);
  }
  // bitmaps: a warp's 32 rows are 4 bytes, little-endian
  const unsigned nbal = __ballot_sync(FULL, need);
  const unsigned sbal = __ballot_sync(FULL, shroud);
  const int lane = threadIdx.x & 31;
  const int byte = ((r - lane) >> 3) + lane;
  if (lane < 4 && byte < (nd >> 3)) {
    need_pk[byte] = (nbal >> (8 * lane)) & 0xff;
    shroud_pk[byte] = (sbal >> (8 * lane)) & 0xff;
  }
}

// inclusive block scan of two counters (blockDim.x == COMPACT_THREADS)
__device__ void block_scan2(int& a, int& b, int& tot_a, int& tot_b) {
  __shared__ int wa[32], wb[32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    const int xa = __shfl_up_sync(FULL, a, o), xb = __shfl_up_sync(FULL, b, o);
    if (lane >= o) { a += xa; b += xb; }
  }
  if (lane == 31) { wa[w] = a; wb[w] = b; }
  __syncthreads();
  if (w == 0) {
    int va = wa[lane], vb = wb[lane];
    for (int o = 1; o < 32; o <<= 1) {
      const int xa = __shfl_up_sync(FULL, va, o), xb = __shfl_up_sync(FULL, vb, o);
      if (lane >= o) { va += xa; vb += xb; }
    }
    wa[lane] = va;
    wb[lane] = vb;
  }
  __syncthreads();
  if (w > 0) { a += wa[w - 1]; b += wb[w - 1]; }
  tot_a = wa[31];
  tot_b = wb[31];
  __syncthreads();
}

__global__ void __launch_bounds__(COMPACT_THREADS)
compact_kernel(const uint8_t* __restrict__ status, int nd, int cache_on,
               int* __restrict__ order, int* __restrict__ order_u,
               int* __restrict__ header) {
  const int t = threadIdx.x;
  const int chunk = (nd + COMPACT_THREADS - 1) / COMPACT_THREADS;
  const int lo = min(t * chunk, nd), hi = min(lo + chunk, nd);
  int cn = 0, cu = 0, cc = 0, cs = 0;
  for (int r = lo; r < hi; ++r) {
    const uint8_t s = status[r];
    cn += s & ST_NEED;
    cu += (s & ST_NEED_U) != 0;
    cc += (s & ST_CAND) != 0;
    cs += (s & ST_NSHROUD) != 0;
  }
  int pn = cn, pu = cu, m, mu, naligned, nshroud;
  block_scan2(pn, pu, m, mu);
  block_scan2(cc, cs, naligned, nshroud);
  pn -= cn;   // exclusive: needed rows before lo
  pu -= cu;
  if (t == 0) {
    header[0] = m;
    header[1] = naligned;
    header[2] = nshroud;
    header[3] = cache_on ? mu : 0;
  }
  for (int r = lo; r < hi; ++r) {
    const uint8_t s = status[r];
    // rows not needed follow the needed ones, also ascending: r - pn of
    // them come before r
    if (s & ST_NEED) order[pn++] = r; else order[m + r - pn] = r;
    if (cache_on) {
      if (s & ST_NEED_U) order_u[pu++] = r; else order_u[mu + r - pu] = r;
    }
  }
}

template <bool BITS>
__global__ void __launch_bounds__(PACK_WARPS * 32)
pack_kernel(const int* __restrict__ order, int slot0, int nslots, int n,
            const uint8_t* __restrict__ small13,
            const int8_t* __restrict__ tvec, const int8_t* __restrict__ seqs,
            const long long* __restrict__ lens, int W, int center, int K,
            uint8_t* __restrict__ rows_out, uint8_t* __restrict__ subs_out) {
  __shared__ uint32_t stream[PACK_WARPS][STREAM_WORDS];
  const int wib = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slot = blockIdx.x * PACK_WARPS + wib;
  if (slot >= nslots) return;   // warp-uniform
  const int s = src_row(order[slot0 + slot], n);
  const uint8_t* sm = small13 + (size_t)s * 13;
  if (lane < 5) rows_out[(size_t)slot * 5 + lane] = sm[lane < 4 ? lane : 12];
  const int l2 = (int)lens[s], mn = min(l2, (int)lens[center]);
  const bool gl = (sm[12] & 2) != 0;
  const int8_t* s1 = seqs + (size_t)s * W;
  const int8_t* s0 = seqs + (size_t)center * W;
  const int8_t* tv_row = tvec + (size_t)s * W;
  const int bmb = (W + 7) >> 3;
  const int subw = BITS ? bmb + K / 4 : 2 * K;
  uint8_t* out = subs_out + (size_t)slot * subw;
  if (BITS) {
    for (int w = lane; w < STREAM_WORDS; w += 32) stream[wib][w] = 0;
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
        atomicOr(&stream[wib][k >> 4], (uint32_t)((tv >> 2) & 3) << (2 * (k & 15)));
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
      out[bmb + j] = (stream[wib][j >> 2] >> (8 * (j & 3))) & 0xff;
  } else {
    for (int k = count + lane; k < K; k += 32) {
      out[2 * k] = 0xff;
      out[2 * k + 1] = 0xff;
    }
  }
}

int launch_pack(const int* order, int slot0, int nslots, int n,
                const uint8_t* small13, const int8_t* tvec,
                const int8_t* seqs, const long long* lens, int W, int center,
                int K, int bits, uint8_t* rows_out, uint8_t* subs_out,
                cudaStream_t stream) {
  if (nslots <= 0) return 0;
  const int blocks = (nslots + PACK_WARPS - 1) / PACK_WARPS;
  if (bits)
    pack_kernel<true><<<blocks, PACK_WARPS * 32, 0, stream>>>(
        order, slot0, nslots, n, small13, tvec, seqs, lens, W, center, K,
        rows_out, subs_out);
  else
    pack_kernel<false><<<blocks, PACK_WARPS * 32, 0, stream>>>(
        order, slot0, nslots, n, small13, tvec, seqs, lens, W, center, K,
        rows_out, subs_out);
  return (int)cudaGetLastError();
}

}  // namespace

// One budded compare: screen, compaction, pack into buf (layout
// ops/store_screen.py::budbuf_layout; o1..o3 are its offsets).
extern "C" int store_screen_run(
    const void* small13, const void* eth2, const void* reads,
    const void* cbits, const void* tvec, const void* seqs, const void* lens,
    int n, int nd, int W, int center, int greedy, int cache_on, float c5L,
    float cL5, float und, void* status, void* order, void* order_u,
    void* buf, int MU, int K, int bits, int o1, int o2, int o3,
    void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  uint8_t* b = (uint8_t*)buf;
  const int blocks = (nd + SCREEN_THREADS - 1) / SCREEN_THREADS;
  screen_kernel<<<blocks, SCREEN_THREADS, 0, stream>>>(
      (const uint8_t*)small13, (const uint8_t*)eth2, (const int*)reads,
      (const uint8_t*)cbits, n, nd, center, greedy, cache_on, c5L, cL5, und,
      (uint8_t*)status, b + 16, b + o3);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  compact_kernel<<<1, COMPACT_THREADS, 0, stream>>>(
      (const uint8_t*)status, nd, cache_on, (int*)order, (int*)order_u,
      (int*)b);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  return launch_pack((const int*)(cache_on ? order_u : order), 0, MU, n,
                     (const uint8_t*)small13, (const int8_t*)tvec,
                     (const int8_t*)seqs, (const long long*)lens, W, center,
                     K, bits, b + o1, b + o2, stream);
}

// The follow-up: rows and substitution records of compacted rows
// [slot0, slot0 + nslots).
extern "C" int store_screen_take(const void* order, const void* small13,
                                 const void* tvec, const void* seqs,
                                 const void* lens, int slot0, int nslots,
                                 int n, int W, int center, int K, int bits,
                                 void* rows_out, void* subs_out,
                                 void* stream) {
  return launch_pack((const int*)order, slot0, nslots, n,
                     (const uint8_t*)small13, (const int8_t*)tvec,
                     (const int8_t*)seqs, (const long long*)lens, W, center,
                     K, bits, (uint8_t*)rows_out, (uint8_t*)subs_out,
                     (cudaStream_t)stream);
}
