// Exact per-tile top-k for Hopper (sm_90a) on the tensor-core body
// (scan_mma.cuh, its TOPK mode), for k <= 32:
//
//   scan_topk_exact_tf32  (K1) replace vectorlite_tpu/kernels/pallas_scan.py:46
//   scan_topk_exact_bf16  _tile_kernel over f32 rows (3xTF32: the queries'
//                         two tf32 terms against the rows split into two
//                         as they load into registers) and over bf16 rows
//                         (three bf16 query terms, exact products).
//   scan_topk_exact_s8    (K2) replaces pallas_scan.py:471 _tile_kernel_int8:
//                         three int8 query terms, exact s32 sums, the row
//                         scale in the epilogue.
//
// Each writes tile_topk_plain's [B, n / tile_n, k]: each tile's top k by
// (score descending, row ascending), invalid rows at -inf. 32 < k <= 256
// runs on the body's wide mode (csrc/wide.cu), beyond on its scores into a
// radix select (csrc/select.cu), chosen before any launch (kernels/scan.py
// exact_route).
//
// Bounds at the main-path shapes (2^20 x 384 rows, B = 256): f32 rows,
// three tf32 passes of 2 B N D = 206 GFLOP at 494.7 TFLOP/s, 1.25 ms
// (the rows' 1.61 GB take 0.48 ms at 3.35 TB/s); bf16 rows, three bf16
// passes 0.63 ms (0.24 ms of rows); int8 rows, three int8 passes 0.31 ms,
// one 0.10 ms, the rows' 403 MB 0.12 ms. The design's costs beside the
// tensor work: over f32 rows the L2 reads of the rows (once a query block)
// and the query terms (once a chunk of a block: 12.9 GB in all at B 256);
// everywhere each chunk's score tile (32 KB of shared traffic a
// warpgroup) and its merge into the lists, which holds most of the time
// at k 32 (scripts/probe_exact_topk.py takes the two apart).
//
// Each C entry launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include "scan_mma.cuh"

extern "C" {

// K1 over f32 rows [n, d]: q_img the two tf32 query terms
// (kernels/scan_mma.py query_operand_tf32), into out_s/out_i [B, n /
// tile_n, k], 1 <= k <= 32.
int scan_topk_exact_tf32(const void* q_img, const void* qsq, const void* values,
                         const void* sqnorms, const void* valid, void* out_s, void* out_i,
                         int n, int d, int b, int k, int tile_n, int metric, void* stream) {
  return scan_mma::launch<float, scan_mma::TOPK, 1>(
      values, q_img, nullptr, static_cast<const float*>(qsq), nullptr,
      static_cast<const float*>(sqnorms), static_cast<const uint8_t*>(valid),
      static_cast<float*>(out_s), static_cast<int*>(out_i), n, d, b, tile_n, metric,
      scan_mma::F_WALK, static_cast<cudaStream_t>(stream), k);
}

// K1 over bf16 rows, with the three bf16 query terms q_img
// (kernels/scan_mma.py query_operand); the layout of scan_topk_exact_tf32.
int scan_topk_exact_bf16(const void* q_img, const void* qsq, const void* values,
                         const void* sqnorms, const void* valid, void* out_s, void* out_i,
                         int n, int d, int b, int k, int tile_n, int metric, void* stream) {
  return scan_mma::launch<uint16_t, scan_mma::TOPK, 1>(
      values, q_img, nullptr, static_cast<const float*>(qsq), nullptr,
      static_cast<const float*>(sqnorms), static_cast<const uint8_t*>(valid),
      static_cast<float*>(out_s), static_cast<int*>(out_i), n, d, b, tile_n, metric,
      scan_mma::F_WALK, static_cast<cudaStream_t>(stream), k);
}

// K2: int8 rows with their scales, the three int8 query terms q_img and
// their scales q_scale (kernels/scan_mma.py query_operand_int8); the
// layout of scan_topk_exact_tf32.
int scan_topk_exact_s8(const void* q_img, const void* q_scale, const void* qsq,
                       const void* values, const void* scales, const void* sqnorms,
                       const void* valid, void* out_s, void* out_i, int n, int d, int b,
                       int k, int tile_n, int metric, void* stream) {
  return scan_mma::launch<int8_t, scan_mma::TOPK, 1>(
      values, q_img, static_cast<const float*>(q_scale), static_cast<const float*>(qsq),
      static_cast<const float*>(scales), static_cast<const float*>(sqnorms),
      static_cast<const uint8_t*>(valid), static_cast<float*>(out_s), static_cast<int*>(out_i),
      n, d, b, tile_n, metric, scan_mma::F_WALK, static_cast<cudaStream_t>(stream), k);
}

// The ring's stages a TOPK launch over rows of width d takes (dtype 0 f32,
// 1 bf16, 2 int8), negative when the query terms stream with the rows
// instead of staying resident, 0 when not even two stages fit. No launch.
int scan_topk_exact_stages(int dtype, int d) {
  bool resident = false;
  const int stages =
      dtype == 2   ? scan_mma::plan_stages<int8_t, scan_mma::TOPK, 1>(d, &resident)
      : dtype == 1 ? scan_mma::plan_stages<uint16_t, scan_mma::TOPK, 1>(d, &resident)
                   : scan_mma::plan_stages<float, scan_mma::TOPK, 1>(d, &resident);
  return resident ? stages : -stages;
}

}  // extern "C"
