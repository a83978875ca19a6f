// Exact-lambda batch kernels: the sequential float64 product of error
// factors per candidate row (reference: src/pval.cpp:144-197
// compute_lambda_ts), computed with ZERO heap temporaries and the GIL
// released (ctypes drops it for the duration of the call).
//
// Semantics contract (bit-identical to backend_tpu.TpuBackend._lambdas):
//   lam = f(0) * f(1) * ... * f(len-1), strictly left-to-right IEEE f64,
//   f(j) = err[t_j * Q + q_j], q_j = quals[row, j] (or 0 without quals).
// The multiply order matters: the engine's bud decisions hinge on the
// last ulp, and np.multiply.reduce is strictly sequential — so is this
// loop (no -ffast-math anywhere in the build; GCC does not reassociate
// FP reductions without it).
//
// Three tvec sources, mirroring the Python call sites:
//   dense  — a fetched [m, L] transition matrix (int8 or int64)
//   subs   — substitution tiles: t = 5*s1 except tile entries
//            ((nt0 << 14) | pos, reference: src/pval.cpp:104-130)
//   gapless— pad-to-length pairs: t from the center/member sequences
//            (reference: src/nwalign_endsfree.cpp:539-555)
// The subs/gapless forms never materialize the [m, L] tvec at all —
// on lazily-backed VM memory those temporaries cost more than the
// arithmetic (see utils/hostmem.py).

#include <cstdint>
#include <algorithm>
#include <thread>
#include <vector>

namespace {

inline int nthreads_for(int64_t m) {
    if (m < 512) return 1;
    unsigned hw = std::thread::hardware_concurrency();
    if (hw == 0) hw = 1;
    return (int)std::min<int64_t>(std::min<unsigned>(hw, 8), (m + 511) / 512);
}

template <class F>
void parallel_rows(int64_t m, F&& body) {
    int nt = nthreads_for(m);
    if (nt <= 1) {
        body(0, m);
        return;
    }
    std::vector<std::thread> th;
    th.reserve(nt);
    int64_t chunk = (m + nt - 1) / nt;
    for (int t = 0; t < nt; ++t) {
        int64_t lo = t * chunk, hi = std::min<int64_t>(m, lo + chunk);
        if (lo >= hi) break;
        th.emplace_back([&body, lo, hi] { body(lo, hi); });
    }
    for (auto& t : th) t.join();
}

template <class T>
void lam_dense(int64_t m, int64_t L, const T* tvec, const int64_t* idx,
               const uint8_t* quals, int64_t W, const int32_t* lens,
               const double* err, int64_t Q, double* out) {
    parallel_rows(m, [&](int64_t lo, int64_t hi) {
        for (int64_t r = lo; r < hi; ++r) {
            int64_t row = idx[r];
            int64_t len = std::min<int64_t>(lens[row], L);
            const T* tv = tvec + r * L;
            const uint8_t* q = quals ? quals + row * W : nullptr;
            double lam = 1.0;
            for (int64_t j = 0; j < len; ++j) {
                int64_t qj = q ? q[j] : 0;
                lam = lam * err[(int64_t)tv[j] * Q + qj];
            }
            out[r] = lam;
        }
    });
}

}  // namespace

extern "C" {

void lam_dense_i8(int64_t m, int64_t L, const int8_t* tvec,
                  const int64_t* idx, const uint8_t* quals, int64_t W,
                  const int32_t* lens, const double* err, int64_t Q,
                  double* out) {
    lam_dense(m, L, tvec, idx, quals, W, lens, err, Q, out);
}

void lam_dense_i64(int64_t m, int64_t L, const int64_t* tvec,
                   const int64_t* idx, const uint8_t* quals, int64_t W,
                   const int32_t* lens, const double* err, int64_t Q,
                   double* out) {
    lam_dense(m, L, tvec, idx, quals, W, lens, err, Q, out);
}

// Substitution-tile form. subs[r*K..r*K+counts[r]) hold
// (nt0 << 14) | pos entries; all other query positions are the self
// transition 5*s1. seqs holds 2-bit codes 0..3 in uint8 (PAD=255 past
// len, never read here).
void lam_subs(int64_t m, const int64_t* idx, const uint8_t* seqs,
              const uint8_t* quals, int64_t W, const int32_t* lens,
              const uint16_t* subs, int64_t K, const int64_t* counts,
              const double* err, int64_t Q, double* out) {
    parallel_rows(m, [&](int64_t lo, int64_t hi) {
        // per-thread overlay of substitution transitions by position;
        // entries are (pos, t) pairs applied sparsely, so the reset
        // cost is O(counts), not O(L)
        std::vector<int16_t> over((size_t)W, -1);
        for (int64_t r = lo; r < hi; ++r) {
            int64_t row = idx[r];
            int64_t len = std::min<int64_t>(lens[row], W);
            const uint8_t* s1 = seqs + row * W;
            const uint8_t* q = quals ? quals + row * W : nullptr;
            int64_t cnt = std::min<int64_t>(counts[r], K);
            const uint16_t* sb = subs + r * K;
            for (int64_t k = 0; k < cnt; ++k) {
                int64_t pos = sb[k] & 0x3FFF;
                if (pos < W)
                    over[pos] = (int16_t)(4 * (sb[k] >> 14) + s1[pos]);
            }
            double lam = 1.0;
            for (int64_t j = 0; j < len; ++j) {
                int64_t t = over[j] >= 0 ? over[j] : 5 * (int64_t)s1[j];
                int64_t qj = q ? q[j] : 0;
                lam = lam * err[t * Q + qj];
            }
            for (int64_t k = 0; k < cnt; ++k) {
                int64_t pos = sb[k] & 0x3FFF;
                if (pos < W) over[pos] = -1;
            }
            out[r] = lam;
        }
    });
}

// Gapless (pad-to-length) form: t = 5*s1 where the pair agrees or the
// member runs past the center, 4*s0+s1 at mismatches within the
// overlap.
void lam_gapless(int64_t m, int64_t center, const int64_t* idx,
                 const uint8_t* seqs, const uint8_t* quals, int64_t W,
                 const int32_t* lens, const double* err, int64_t Q,
                 double* out) {
    const uint8_t* s0 = seqs + center * W;
    int64_t l1 = lens[center];
    parallel_rows(m, [&](int64_t lo, int64_t hi) {
        for (int64_t r = lo; r < hi; ++r) {
            int64_t row = idx[r];
            int64_t len = std::min<int64_t>(lens[row], W);
            int64_t both = std::min<int64_t>(len, l1);
            const uint8_t* s1 = seqs + row * W;
            const uint8_t* q = quals ? quals + row * W : nullptr;
            double lam = 1.0;
            int64_t j = 0;
            for (; j < both; ++j) {
                int64_t t = (s0[j] == s1[j]) ? 5 * (int64_t)s1[j]
                                             : 4 * (int64_t)s0[j] + s1[j];
                int64_t qj = q ? q[j] : 0;
                lam = lam * err[t * Q + qj];
            }
            for (; j < len; ++j) {
                int64_t qj = q ? q[j] : 0;
                lam = lam * err[5 * (int64_t)s1[j] * Q + qj];
            }
            out[r] = lam;
        }
    });
}

}  // extern "C"
