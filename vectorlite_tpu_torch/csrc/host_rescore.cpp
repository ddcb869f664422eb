// Exact float64 re-score of a device candidate pool, on the host.
//
// Port of flat_rescore_f64 (vectorlite_tpu/native/hnsw_builder.cpp:1248),
// alone: FlatIndex._exact_rescore re-scores the pool that a
// reduced-precision rung (int8, bf16, PQ) selected on the card, in exact
// float64 from the host truth matrix, so returned scores match the scalar
// reference formulas (reference: src/lib.rs:425-572). numpy's
// vals64[slots] gather materializes a [B, K, D] f64 temp before its
// batched product; this loop reads each candidate row once, accumulates in
// registers and writes only the [B, K] scores. It is bound by random reads
// of D * 8-byte rows from host memory. Single-threaded: it runs under
// concurrent serving streams and shares no mutable state.
//
// metric: 0 = cosine, 1 = euclidean, 2 = dot product, 3 = manhattan.
// norms (row L2 norms) is read for cosine only and may be null otherwise.
// Semantics match the numpy version: cosine guards denom > 0, divides by
// max(denom, 1e-300) and clamps at 1.0.

#include <cmath>
#include <cstdint>

extern "C" {

void flat_rescore_f64(const double* vals, const double* norms,
                      const double* q, const int64_t* slots, double* out,
                      int64_t dim, int64_t b_rows, int64_t k_cols,
                      int32_t metric) {
  for (int64_t b = 0; b < b_rows; ++b) {
    const double* qb = q + b * dim;
    double qn = 0.0;
    if (metric == 0) {
      double acc = 0.0;
#pragma omp simd reduction(+ : acc)
      for (int64_t d = 0; d < dim; ++d) acc += qb[d] * qb[d];
      qn = std::sqrt(acc);
    }
    const int64_t* srow = slots + b * k_cols;
    double* orow = out + b * k_cols;
    for (int64_t j = 0; j < k_cols; ++j) {
      const double* r = vals + srow[j] * dim;
      double sc;
      if (metric == 0 || metric == 2) {
        double dot = 0.0;
#pragma omp simd reduction(+ : dot)
        for (int64_t d = 0; d < dim; ++d) dot += r[d] * qb[d];
        if (metric == 2) {
          sc = dot;
        } else {
          const double denom = norms[srow[j]] * qn;
          sc = denom > 0.0 ? dot / (denom < 1e-300 ? 1e-300 : denom) : 0.0;
          if (sc > 1.0) sc = 1.0;
        }
      } else if (metric == 1) {
        double acc = 0.0;
#pragma omp simd reduction(+ : acc)
        for (int64_t d = 0; d < dim; ++d) {
          const double t = r[d] - qb[d];
          acc += t * t;
        }
        sc = 1.0 / (1.0 + std::sqrt(acc));
      } else {
        double acc = 0.0;
#pragma omp simd reduction(+ : acc)
        for (int64_t d = 0; d < dim; ++d) acc += std::fabs(r[d] - qb[d]);
        sc = 1.0 / (1.0 + acc);
      }
      orow[j] = sc;
    }
  }
}

}  // extern "C"
