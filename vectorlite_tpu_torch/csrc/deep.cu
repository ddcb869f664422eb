// Exact per-tile top-k for Hopper (sm_90a) past k = 256, on the tensor-core
// body's deep per-query mode (scan_mma.cuh, DEEP), for 256 < k <= 2,048:
//
//   scan_topk_deep_tf32  (K1) replace vectorlite_tpu/kernels/pallas_scan.py:46
//   scan_topk_deep_bf16  _tile_kernel over f32 rows (3xTF32) and over bf16
//                        rows (three bf16 query terms), the contraction of
//                        exact.cu's and wide.cu's entries.
//   scan_topk_deep_s8    (K2) replaces pallas_scan.py:471 _tile_kernel_int8:
//                        three int8 query terms, exact s32 sums, the row
//                        scale in the epilogue.
//
// Each writes tile_topk_plain's [B, n / tile_n, k]: each tile's top k by
// (score descending, row ascending), invalid rows at -inf. k <= 256 keeps
// exact.cu's and wide.cu's entries, k > 2,048 and tiles past 32,768 rows
// the CUDA-core body (csrc/scan.cu), chosen before any launch
// (kernels/scan.py exact_route). The wrapper grows the tile with k
// (kernels/scan.py exact_tile: to 32 k rows, at most 32,768, where the
// rows allow).
//
// Bounds at the main-path shapes (2^20 x 384 rows, B = 256): K1 over f32
// rows, three tf32 passes of 2 B N D = 206 GFLOP at 494.7 TFLOP/s, 1.25 ms
// (the rows' 1.61 GB 0.48 ms, the output at k 1,024 and 32,768-row tiles
// 67 MB); over bf16 rows one bf16 pass 0.21 ms against the rows' 805 MB,
// 0.24 ms; K2 one int8 pass 0.10 ms against the rows' 403 MB, 0.12 ms.
//
// What the design does about the selection, which held the CUDA-core
// entries' ~235 ms at k 300 (lists in the output, one serial insertion a
// row that beats the k-th entry, on 2,048-row tiles): the contraction runs
// on the tensor cores as in the wide mode, and a query's list stays in its
// row of the output, but rows reach it in batches. Each chunk's rows that
// beat the k-th entry (a ballot) are staged in shared memory, 256 a query
// (the wide mode's W 8 lists), and a full buffer merges at once: a bitonic
// sort of the batch, then one pass over the list in runs of 32 from its
// end, each entry moving up by the batch entries that precede it (binary
// searches of the batch, eight runs' together) and writing the batch
// entries that land just above it, which stops where nothing moves. A
// chunk's merges go to the block's eight warps in turn, whichever warp
// stages the query, since the block waits for its slowest warp before the
// next chunk's scores. Tiles grow to 32 k rows, so after the first k rows
// of a tile few rows enter (about k ln(T / k) of T) and few chunks reach
// a merge. The merges hold most of the time (scripts/probe_exact_topk.py,
// PERF.md): each is a latency-bound chain of a sort, L2 reads of the list
// and shared-memory searches, tens of thousands of cycles at k >= 1,024.
//
// Precision: these lists reach scores near 0 (k = tile_n lists every
// row), where an f32 dot's error is a fraction of sum |q_i x_i|, not of
// the score. Over f32 and bf16 rows the body sums the large term's passes
// a slice at a time in registers (scan_mma.cuh Dots), since the tensor
// cores' accumulation truncates at each k-step: the f32 entry's dots lie
// nearer to float64 than the plain f32 product's (PERF.md).
//
// Each C entry launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include "scan_mma.cuh"

namespace {

template <typename T>
int launch_deep(const void* values, const void* q_img, const float* q_scale, const float* qsq,
                const float* scales, const float* sqnorms, const uint8_t* valid, float* out_s,
                int* out_i, int n, int d, int b, int k, int tile_n, int metric,
                cudaStream_t stream) {
  return scan_mma::launch<T, scan_mma::DEEP, 8>(values, q_img, q_scale, qsq, scales, sqnorms,
                                               valid, out_s, out_i, n, d, b, tile_n, metric,
                                               scan_mma::F_WALK, stream, k);
}

// The plan of a launch over rows of width d: plan[0] the ring's stages (0
// when not even two fit), plan[1] the bytes of the ring, plan[2] of the
// score tiles, plan[3] of the staging buffers and the queries' state,
// plan[4] the dynamic shared memory in all.
template <typename T>
void plan_of(int d, int* plan) {
  bool resident = false;
  const int stages = scan_mma::plan_stages<T, scan_mma::DEEP, 8>(d, &resident);
  const int slices = (d * scan_mma::Rows<T>::BYTES + scan_mma::SLICE_BYTES - 1) /
                     scan_mma::SLICE_BYTES;
  const scan_mma::Layout l =
      scan_mma::layout_for<T, scan_mma::DEEP, 8>(slices, resident, stages > 0 ? stages : 2);
  plan[0] = stages;
  plan[1] = static_cast<int>(l.scores - l.ring);
  plan[2] = static_cast<int>(l.lists - l.scores);
  plan[3] = static_cast<int>(l.qnorm - l.lists);
  plan[4] = static_cast<int>(l.bytes);
}

}  // namespace

extern "C" {

// K1 over f32 rows [n, d]: q_img the two tf32 query terms
// (kernels/scan_mma.py query_operand_tf32), into out_s/out_i [B, n /
// tile_n, k], 1 <= k <= 2,048, k <= tile_n <= 32,768.
int scan_topk_deep_tf32(const void* q_img, const void* qsq, const void* values,
                        const void* sqnorms, const void* valid, void* out_s, void* out_i, int n,
                        int d, int b, int k, int tile_n, int metric, void* stream) {
  return launch_deep<float>(values, q_img, nullptr, static_cast<const float*>(qsq), nullptr,
                            static_cast<const float*>(sqnorms),
                            static_cast<const uint8_t*>(valid), static_cast<float*>(out_s),
                            static_cast<int*>(out_i), n, d, b, k, tile_n, metric,
                            static_cast<cudaStream_t>(stream));
}

// K1 over bf16 rows, with the three bf16 query terms q_img
// (kernels/scan_mma.py query_operand); the layout of scan_topk_deep_tf32.
int scan_topk_deep_bf16(const void* q_img, const void* qsq, const void* values,
                        const void* sqnorms, const void* valid, void* out_s, void* out_i, int n,
                        int d, int b, int k, int tile_n, int metric, void* stream) {
  return launch_deep<uint16_t>(values, q_img, nullptr, static_cast<const float*>(qsq), nullptr,
                               static_cast<const float*>(sqnorms),
                               static_cast<const uint8_t*>(valid), static_cast<float*>(out_s),
                               static_cast<int*>(out_i), n, d, b, k, tile_n, metric,
                               static_cast<cudaStream_t>(stream));
}

// K2: int8 rows with their scales, the three int8 query terms q_img and
// their scales q_scale (kernels/scan_mma.py query_operand_int8); the
// layout of scan_topk_deep_tf32.
int scan_topk_deep_s8(const void* q_img, const void* q_scale, const void* qsq,
                      const void* values, const void* scales, const void* sqnorms,
                      const void* valid, void* out_s, void* out_i, int n, int d, int b, int k,
                      int tile_n, int metric, void* stream) {
  return launch_deep<int8_t>(values, q_img, static_cast<const float*>(q_scale),
                             static_cast<const float*>(qsq), static_cast<const float*>(scales),
                             static_cast<const float*>(sqnorms),
                             static_cast<const uint8_t*>(valid), static_cast<float*>(out_s),
                             static_cast<int*>(out_i), n, d, b, k, tile_n, metric,
                             static_cast<cudaStream_t>(stream));
}

// The shared-memory plan of a launch over rows of width d (dtype 0 f32, 1
// bf16, 2 int8) into plan[0..4] (plan_of above). No launch.
void scan_topk_deep_plan(int dtype, int d, int* plan) {
  if (dtype == 2)
    plan_of<int8_t>(d, plan);
  else if (dtype == 1)
    plan_of<uint16_t>(d, plan);
  else
    plan_of<float>(d, plan);
}

}  // extern "C"
