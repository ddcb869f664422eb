// Lane-group list kernels for Hopper (sm_90a):
//
//   scan_block_topw_s8,   (K3) replace vectorlite_tpu/kernels/pallas_scan.py:159
//   scan_block_topw_bf16, _block_topw_kernel over int8 rows (with their
//   scan_block_topw_tf32  scales), bf16 rows and f32 rows (3xTF32): each lane
//                         group's (row mod 128) top W of every tile, on the
//                         tensor-core body. W above 3 stays on the CUDA-core
//                         body (scan.cu scan_block_topw).
//   scan_merge_topw       (K7) replaces vectorlite_tpu/kernels/pallas_merge.py:66
//                         _merge_kernel: each lane group's top W over the
//                         whole corpus, over bf16 rows and over f32 rows.
//   scan_fold_probe       (K8) replaces bench/decompose.py:68 (mk_kernel's
//                         kern): the contraction alone, or with a lane-group
//                         fold.
//
// Bounds at their shape (2^20 x 384 rows, B = 256): one bf16 pass is 0.21
// ms of tensor work, the bf16 rows' 805 MB 0.24 ms at 3.35 TB/s; f32
// queries against bf16 rows take three bf16 passes, 0.63 ms; against int8
// rows three int8 passes, 0.31 ms, and the rows are 403 MB (0.12 ms); K3
// and K7 over f32 rows, the exact f32 dot the reference takes, three tf32
// passes (3xTF32), 1.25 ms, their rows' 1.61 GB 0.48 ms.
//
// The tensor-core body (scan_mma.cuh): the f32 queries split into three
// bf16 or int8 terms (two tf32 terms against f32 rows, whose words split
// into hi and lo in registers), wgmma over TMA-staged row tiles, and each
// thread's (query, lane group) lists in registers, updated on the
// accumulators chunk after chunk. K3 blocks walk runs of consecutive tiles
// and write each tile's lists in K3's own [B, T, W*128] layout. K3 and K7
// over f32 rows are held to the 1e-5 rule (scores within rtol/atol 1e-5,
// ids equal beyond 1e-5 near-ties), as K1 over f32 rows is on the same
// 3xTF32 contraction; their dot lists, which reach dots near 0 in lane
// groups with few live rows, to float64 (the rule plus the plain f32
// product's own distance from it). The TPU kernel of K7 carries
// its per-lane-group state across a sequential grid; here a block owns (64
// queries, one tile), writes its lists as a partial, and a second pass
// (merge_partials) merges the partials in tile order. K8 is the same block
// with the lists reset per tile (`full`), distinct values kept (`maxonly`)
// or no selection at all (`none`, the contraction of every chunk, its
// first chunk written).
//
// Each C entry launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include "scan_kernel.cuh"  // merge_partials: LANE_GROUPS, MAX_WINNERS, lane_insert
#include "scan_mma.cuh"

namespace {

// K7's second pass: thread (query, lane group) merges the tiles' lists
// [n_tiles, B, W*128] into [W, B, 128] in tile order (ascending rows) with
// the first pass's strict-> insertion, so the result is the lane group's
// top W by (score descending, row ascending) whatever the tile size.
__global__ void __launch_bounds__(THREADS)
    merge_partials(const float* __restrict__ part_s,
                   const int* __restrict__ part_i, float* __restrict__ out_s,
                   int* __restrict__ out_i, int n_tiles, int b, int winners) {
  const int t = blockIdx.x * THREADS + threadIdx.x;
  if (t >= b * LANE_GROUPS) return;
  const int bq = t / LANE_GROUPS;
  const int lg = t % LANE_GROUPS;
  float ms[MAX_WINNERS];
  int mr[MAX_WINNERS];
  for (int w = 0; w < MAX_WINNERS; ++w) {
    ms[w] = -CUDART_INF_F;
    mr[w] = 0;
  }
  const int n_out = winners * LANE_GROUPS;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const size_t base = (static_cast<size_t>(tile) * b + bq) * n_out + lg;
    for (int w = 0; w < winners; ++w) {
      const float s = part_s[base + w * LANE_GROUPS];
      if (!(s > ms[winners - 1])) break;  // the list is sorted: no later entry enters
      lane_insert(ms, mr, 1, winners, s, part_i[base + w * LANE_GROUPS]);
    }
  }
  for (int w = 0; w < winners; ++w) {
    const size_t o = (static_cast<size_t>(w) * b + bq) * LANE_GROUPS + lg;
    out_s[o] = ms[w];
    out_i[o] = mr[w];
  }
}

}  // namespace

extern "C" {

// K3 over int8 rows [n, d] with their scales, on the tensor-core body: the
// queries split into three int8 terms q_img with their scales q_scale
// (kernels/scan_mma.py query_operand_int8), each tile's lane-group lists
// into out_s/out_i [B, n / tile_n, W*128]. winners 1-3.
int scan_block_topw_s8(const void* q_img, const void* q_scale, const void* qsq,
                       const void* values, const void* scales, const void* sqnorms,
                       const void* valid, void* out_s, void* out_i, int n, int d,
                       int b, int tile_n, int winners, int metric, void* stream) {
  return scan_mma::launch_w<int8_t, scan_mma::TOPW>(
      winners, values, q_img, static_cast<const float*>(q_scale),
      static_cast<const float*>(qsq), static_cast<const float*>(scales),
      static_cast<const float*>(sqnorms), static_cast<const uint8_t*>(valid),
      static_cast<float*>(out_s), static_cast<int*>(out_i), n, d, b, tile_n, metric,
      scan_mma::F_LOW_ROWS | scan_mma::F_QUERY_MAJOR | scan_mma::F_WALK,
      static_cast<cudaStream_t>(stream));
}

// K3 over bf16 rows on the tensor-core body, with the three bf16 terms
// q_img (kernels/scan_mma.py query_operand); the layout of
// scan_block_topw_s8.
int scan_block_topw_bf16(const void* q_img, const void* qsq, const void* values,
                         const void* sqnorms, const void* valid, void* out_s,
                         void* out_i, int n, int d, int b, int tile_n, int winners,
                         int metric, void* stream) {
  return scan_mma::launch_w<uint16_t, scan_mma::TOPW>(
      winners, values, q_img, nullptr, static_cast<const float*>(qsq), nullptr,
      static_cast<const float*>(sqnorms), static_cast<const uint8_t*>(valid),
      static_cast<float*>(out_s), static_cast<int*>(out_i), n, d, b, tile_n, metric,
      scan_mma::F_LOW_ROWS | scan_mma::F_QUERY_MAJOR | scan_mma::F_WALK,
      static_cast<cudaStream_t>(stream));
}

// K3 over f32 rows on the tensor-core body's 3xTF32 form, with the two
// tf32 terms q_img (kernels/scan_mma.py query_operand_tf32); the layout of
// scan_block_topw_s8.
int scan_block_topw_tf32(const void* q_img, const void* qsq, const void* values,
                         const void* sqnorms, const void* valid, void* out_s,
                         void* out_i, int n, int d, int b, int tile_n, int winners,
                         int metric, void* stream) {
  return scan_mma::launch_w<float, scan_mma::TOPW>(
      winners, values, q_img, nullptr, static_cast<const float*>(qsq), nullptr,
      static_cast<const float*>(sqnorms), static_cast<const uint8_t*>(valid),
      static_cast<float*>(out_s), static_cast<int*>(out_i), n, d, b, tile_n, metric,
      scan_mma::F_LOW_ROWS | scan_mma::F_QUERY_MAJOR | scan_mma::F_WALK,
      static_cast<cudaStream_t>(stream));
}

// K7: the tiles' lists into part_s/part_i [n / tile_n, B, W*128], then
// their merge into out_s/out_i [W, B, 128], on the tensor-core body.
// dtype 1 (bfloat16 rows): the three bf16 query terms q_img
// (kernels/scan_mma.py query_operand); dtype 0 (float32 rows): the two
// tf32 query terms (query_operand_tf32), 3xTF32.
int scan_merge_topw(const void* q_img, const void* qsq, const void* values, int dtype,
                    const void* sqnorms, const void* valid, void* part_s, void* part_i,
                    void* out_s, void* out_i, int n, int d, int b, int tile_n, int winners,
                    int metric, void* stream) {
  if (winners < 1 || winners > MAX_WINNERS || dtype < 0 || dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  auto f = dtype == 1 ? scan_mma::launch_w<uint16_t, scan_mma::TOPW>
                      : scan_mma::launch_w<float, scan_mma::TOPW>;
  const int err = f(winners, values, q_img, nullptr, static_cast<const float*>(qsq), nullptr,
                    static_cast<const float*>(sqnorms), static_cast<const uint8_t*>(valid),
                    static_cast<float*>(part_s), static_cast<int*>(part_i), n, d, b, tile_n,
                    metric, 0, st);
  if (err != 0) return err;
  const int threads = b * LANE_GROUPS;
  merge_partials<<<(threads + THREADS - 1) / THREADS, THREADS, 0, st>>>(
      static_cast<const float*>(part_s), static_cast<const int*>(part_i),
      static_cast<float*>(out_s), static_cast<int*>(out_i), n / tile_n, b,
      winners);
  return static_cast<int>(cudaGetLastError());
}

// K8 over bfloat16 rows into [n / tile_n, B, n_out] on the tensor-core body,
// with the split queries q_img. mode: 0 = none (n_out 128), 1 = maxonly,
// 2 = full (n_out W*128).
int scan_fold_probe(const void* q_img, const void* values, void* out_s,
                    void* out_i, int n, int d, int b, int tile_n, int winners,
                    int mode, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  auto* os = static_cast<float*>(out_s);
  auto* oi = static_cast<int*>(out_i);
  switch (mode) {
    case 0:
      return scan_mma::launch_w<uint16_t, scan_mma::FIRST>(
          1, values, q_img, nullptr, nullptr, nullptr, nullptr, nullptr, os, oi, n, d, b, tile_n,
          scan_mma::DOT, 0, st);
    case 1:
      return scan_mma::launch_w<uint16_t, scan_mma::DISTINCT>(
          winners, values, q_img, nullptr, nullptr, nullptr, nullptr, nullptr, os, oi, n, d, b,
          tile_n, scan_mma::DOT, 0, st);
    case 2:
      return scan_mma::launch_w<uint16_t, scan_mma::TOPW>(
          winners, values, q_img, nullptr, nullptr, nullptr, nullptr, nullptr, os, oi, n, d, b,
          tile_n, scan_mma::DOT, scan_mma::F_GROUP_ROW, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
