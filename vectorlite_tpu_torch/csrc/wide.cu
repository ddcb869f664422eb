// Exact per-tile top-k for Hopper (sm_90a) past k = 32, on the tensor-core
// body's wide per-query mode (scan_mma.cuh, WIDE), for 32 < k <= 256:
//
//   scan_topk_wide_tf32  (K1) replace vectorlite_tpu/kernels/pallas_scan.py:46
//   scan_topk_wide_bf16  _tile_kernel over f32 rows (3xTF32) and over bf16
//                        rows (three bf16 query terms), the contraction of
//                        exact.cu's entries.
//   scan_topk_wide_s8    (K2) replaces pallas_scan.py:471 _tile_kernel_int8:
//                        three int8 query terms, exact s32 sums, the row
//                        scale in the epilogue.
//
// Each writes tile_topk_plain's [B, n / tile_n, k]: each tile's top k by
// (score descending, row ascending), invalid rows at -inf. k <= 32 keeps
// exact.cu's entries, k > 256 (and tiles past 32,768 rows) select.cu's,
// chosen before any launch (kernels/scan.py exact_route); tiles hold at
// most 32,768 rows (a list names its rows by 16-bit offsets in the tile).
//
// Bounds at the main-path shapes (2^20 x 384 rows, B = 256, tile 2,048):
// K1 over f32 rows at k_pad 128, three tf32 passes of 2 B N D = 206 GFLOP
// at 494.7 TFLOP/s, 1.25 ms; K2 at the pool of 256, the bytes (rows 403
// MB, lists out 268 MB) 0.20 ms, one int8 pass 0.10 ms.
//
// What the design does about the selection, which held the CUDA-core
// entries' 77-93 ms at these k (one insertion a row that beats the k-th
// entry, ~480-790 a query a tile): every chunk's 128 rows reach the lists
// as one batch, by a fixed network of compare-exchange steps whatever
// number of them enter. One list a query for the block, in shared memory
// (32 W scores and 16-bit rows: 48 KB at W 4, 96 KB at W 8); each of the
// eight warps merges 8 queries' rows from both warpgroups' score tiles
// after a block barrier: a ballot against the k-th entry picks the batch
// (none, the up to 32 or 64 rows that beat it, packed, or all 128), a
// bitonic sort of the batch, a bitonic merge into the list. The lists and
// score tiles leave no room for resident query terms: one ring serves both
// warpgroups, a stage holding the slice's terms once and each
// warpgroup's rows (scan_mma.cuh SHARED), so the terms are read from L2
// once a chunk of a query block.
//
// Each C entry launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include "scan_mma.cuh"

namespace {

template <typename T>
int launch_wide(const void* values, const void* q_img, const float* q_scale, const float* qsq,
                const float* scales, const float* sqnorms, const uint8_t* valid, float* out_s,
                int* out_i, int n, int d, int b, int k, int tile_n, int metric,
                cudaStream_t stream) {
  if (k <= 4 * 32)
    return scan_mma::launch<T, scan_mma::WIDE, 4>(values, q_img, q_scale, qsq, scales, sqnorms,
                                                 valid, out_s, out_i, n, d, b, tile_n, metric,
                                                 scan_mma::F_WALK, stream, k);
  return scan_mma::launch<T, scan_mma::WIDE, 8>(values, q_img, q_scale, qsq, scales, sqnorms,
                                               valid, out_s, out_i, n, d, b, tile_n, metric,
                                               scan_mma::F_WALK, stream, k);
}

// The plan of a launch of list length k over rows of width d (W 4 up to k
// 128, else 8): plan[0] the ring's stages (0 when not even two fit),
// plan[1] the bytes of the ring, plan[2] of the score tiles, plan[3] of the
// lists, plan[4] the dynamic shared memory in all.
template <typename T, int W>
void plan_of(int d, int* plan) {
  bool resident = false;
  const int stages = scan_mma::plan_stages<T, scan_mma::WIDE, W>(d, &resident);
  const int slices = (d * scan_mma::Rows<T>::BYTES + scan_mma::SLICE_BYTES - 1) /
                     scan_mma::SLICE_BYTES;
  const scan_mma::Layout l =
      scan_mma::layout_for<T, scan_mma::WIDE, W>(slices, resident, stages > 0 ? stages : 2);
  plan[0] = stages;
  plan[1] = static_cast<int>(l.scores - l.ring);
  plan[2] = static_cast<int>(l.lists - l.scores);
  plan[3] = static_cast<int>(l.qnorm - l.lists);
  plan[4] = static_cast<int>(l.bytes);
}

template <typename T>
void plan_k(int d, int k, int* plan) {
  if (k <= 4 * 32)
    plan_of<T, 4>(d, plan);
  else
    plan_of<T, 8>(d, plan);
}

}  // namespace

extern "C" {

// K1 over f32 rows [n, d]: q_img the two tf32 query terms
// (kernels/scan_mma.py query_operand_tf32), into out_s/out_i [B, n /
// tile_n, k], 1 <= k <= 256, k <= tile_n <= 32,768.
int scan_topk_wide_tf32(const void* q_img, const void* qsq, const void* values,
                        const void* sqnorms, const void* valid, void* out_s, void* out_i, int n,
                        int d, int b, int k, int tile_n, int metric, void* stream) {
  return launch_wide<float>(values, q_img, nullptr, static_cast<const float*>(qsq), nullptr,
                            static_cast<const float*>(sqnorms),
                            static_cast<const uint8_t*>(valid), static_cast<float*>(out_s),
                            static_cast<int*>(out_i), n, d, b, k, tile_n, metric,
                            static_cast<cudaStream_t>(stream));
}

// K1 over bf16 rows, with the three bf16 query terms q_img
// (kernels/scan_mma.py query_operand); the layout of scan_topk_wide_tf32.
int scan_topk_wide_bf16(const void* q_img, const void* qsq, const void* values,
                        const void* sqnorms, const void* valid, void* out_s, void* out_i, int n,
                        int d, int b, int k, int tile_n, int metric, void* stream) {
  return launch_wide<uint16_t>(values, q_img, nullptr, static_cast<const float*>(qsq), nullptr,
                               static_cast<const float*>(sqnorms),
                               static_cast<const uint8_t*>(valid), static_cast<float*>(out_s),
                               static_cast<int*>(out_i), n, d, b, k, tile_n, metric,
                               static_cast<cudaStream_t>(stream));
}

// K2: int8 rows with their scales, the three int8 query terms q_img and
// their scales q_scale (kernels/scan_mma.py query_operand_int8); the
// layout of scan_topk_wide_tf32.
int scan_topk_wide_s8(const void* q_img, const void* q_scale, const void* qsq,
                      const void* values, const void* scales, const void* sqnorms,
                      const void* valid, void* out_s, void* out_i, int n, int d, int b, int k,
                      int tile_n, int metric, void* stream) {
  return launch_wide<int8_t>(values, q_img, static_cast<const float*>(q_scale),
                             static_cast<const float*>(qsq), static_cast<const float*>(scales),
                             static_cast<const float*>(sqnorms),
                             static_cast<const uint8_t*>(valid), static_cast<float*>(out_s),
                             static_cast<int*>(out_i), n, d, b, k, tile_n, metric,
                             static_cast<cudaStream_t>(stream));
}

// The shared-memory plan of a launch over rows of width d (dtype 0 f32, 1
// bf16, 2 int8) at list length k into plan[0..4] (plan_of above). No
// launch.
void scan_topk_wide_plan(int dtype, int d, int k, int* plan) {
  if (dtype == 2)
    plan_k<int8_t>(d, k, plan);
  else if (dtype == 1)
    plan_k<uint16_t>(d, k, plan);
  else
    plan_k<float>(d, k, plan);
}

}  // extern "C"
