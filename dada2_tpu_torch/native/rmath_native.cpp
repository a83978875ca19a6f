// Batch entry points for the R-exact Poisson tail (rmath_ppois.h):
// ctypes releases the GIL around the call, so per-sample engine threads
// compute p-values concurrently (the pure-Python rmath loop would
// serialize on the GIL). Bit-identity with utils/rmath.py is fuzzed in
// tests/test_rmath.py.
#include "rmath_ppois.h"

extern "C" double dada2_ppois_upper(double x, double lam) {
  return dada2_rmath::ppois_upper(x, lam);
}

extern "C" void dada2_ppois_upper_batch(const double *xs, const double *lams,
                                        double *out, long long n) {
  for (long long i = 0; i < n; i++)
    out[i] = dada2_rmath::ppois_upper(xs[i], lams[i]);
}

// libm exp(-x) batch: the reference's calc_pA norm term calls C exp()
// (reference: src/pval.cpp:55); numpy's SIMD exp can differ in the last
// ulp, so the Python fallback loops math.exp — this is that loop,
// GIL-free (math.exp and libm exp are the same function).
#include <cmath>
extern "C" void dada2_exp_neg_batch(const double *xs, double *out,
                                    long long n) {
  for (long long i = 0; i < n; i++)
    out[i] = exp(-xs[i]);
}
