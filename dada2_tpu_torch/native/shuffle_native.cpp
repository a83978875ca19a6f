// Native best-E scan for the engine's shuffle (reference:
// src/cluster.cpp:210-266 b_shuffle2's E-maximization): for every raw,
// the cluster maximizing E = lambda * bi_reads, visited in ascending
// cluster order with a STRICT > (ties keep the earlier cluster) —
// bit-identical to the numpy per-cluster loop it replaces
// (core/engine.py Engine.shuffle), but one fused GIL-free pass.
extern "C" void dada2_shuffle_best(
    long long n, const double *c0lam, const long long *c0ham,
    double c0reads,
    long long nclust,            // clusters 1..nclust (cluster 0 above)
    const long long *offs,       // [nclust+1] comp offsets
    const long long *idx, const double *lam, const long long *ham,
    const double *bireads,       // [nclust] reads of cluster 1+k
    long long *best_i, double *best_lam, long long *best_ham,
    double *emax) {
  for (long long r = 0; r < n; r++) {
    emax[r] = c0lam[r] * c0reads;
    best_i[r] = 0;
    best_lam[r] = c0lam[r];
    best_ham[r] = c0ham[r];
  }
  for (long long k = 0; k < nclust; k++) {
    const double br = bireads[k];
    for (long long t = offs[k]; t < offs[k + 1]; t++) {
      const double e = lam[t] * br;
      const long long r = idx[t];
      if (e > emax[r]) {
        emax[r] = e;
        best_i[r] = k + 1;
        best_lam[r] = lam[t];
        best_ham[r] = ham[t];
      }
    }
  }
}
