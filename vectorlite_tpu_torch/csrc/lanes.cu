// Lane-group list kernels for Hopper (sm_90a) on the body in
// scan_kernel.cuh:
//
//   scan_merge_topw  (K7) replaces vectorlite_tpu/kernels/pallas_merge.py
//                    _merge_kernel: each lane group's (row mod 128) top W
//                    over the whole corpus.
//   scan_fold_probe  (K8) replaces bench/decompose.py mk_kernel's kern: the
//                    contraction alone, or with a lane-group fold.
//
// Both are bound by bytes at their shape (2^20 x 384 bf16 rows, B = 256):
// 805 MB of rows at 3.35 TB/s is 0.24 ms, against 0.21 ms of one bf16
// pass. The TPU kernel of K7 carries its per-lane-group state across a
// sequential grid; here a block owns (64 queries, one tile) and walks it
// in K1's consecutive 128-row chunks, so thread `lane` always holds lane
// groups lane + 32 jj and owns fixed (query, lane group) pairs: their top-W
// lists live in shared memory ([W][64][128], 64 KB a rung) and update with
// no synchronisation. Each tile writes its lists as a partial; a second
// pass (merge_partials) merges the partials in tile order. K8 is the same
// block with the state reset per tile (`full`), a distinct-value list
// (`maxonly`) or no selection at all (`none`). The lists cost occupancy:
// at W >= 2 one block fits an SM, where K3 has two.
//
// Each C entry launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include "scan_kernel.cuh"

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

// K7: the tiles' lists into part_s/part_i [n / tile_n, B, W*128], then
// their merge into out_s/out_i [W, B, 128]. dtype: 0 = float32 rows,
// 1 = bfloat16 rows.
int scan_merge_topw(const void* q_t, const void* qsq, const void* values,
                    int dtype, const void* sqnorms, const void* valid,
                    void* part_s, void* part_i, void* out_s, void* out_i,
                    int n, int d, int b, int tile_n, int winners, int metric,
                    void* stream) {
  if (winners < 1 || winners > MAX_WINNERS)
    return static_cast<int>(cudaErrorInvalidValue);
  auto f = dtype == 1 ? launch_sel<__nv_bfloat16, false, LANE_TOPW, false>
                      : launch_sel<float, false, LANE_TOPW, false>;
  int err = f(static_cast<const float*>(q_t), static_cast<const float*>(qsq),
              values, nullptr, static_cast<const float*>(sqnorms),
              static_cast<const uint8_t*>(valid), static_cast<float*>(part_s),
              static_cast<int*>(part_i), n, d, b, 0, tile_n, winners, metric,
              static_cast<cudaStream_t>(stream));
  if (err != 0) return err;
  const int threads = b * LANE_GROUPS;
  merge_partials<<<(threads + THREADS - 1) / THREADS, THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part_s), static_cast<const int*>(part_i),
      static_cast<float*>(out_s), static_cast<int*>(out_i), n / tile_n, b,
      winners);
  return static_cast<int>(cudaGetLastError());
}

// K8 over bfloat16 rows into [n / tile_n, B, n_out]. mode: 0 = none
// (n_out 128), 1 = maxonly, 2 = full (n_out W*128).
int scan_fold_probe(const void* q_t, const void* qsq, const void* values,
                    void* out_s, void* out_i, int n, int d, int b, int tile_n,
                    int winners, int mode, void* stream) {
  if (mode != 0 && (winners < 1 || winners > MAX_WINNERS))
    return static_cast<int>(cudaErrorInvalidValue);
  auto f = mode == 0   ? launch_sel<__nv_bfloat16, false, FIRST_COLS, false>
           : mode == 1 ? launch_sel<__nv_bfloat16, false, LANE_DISTINCT, false>
                       : launch_sel<__nv_bfloat16, false, LANE_TOPW, false>;
  return f(static_cast<const float*>(q_t), static_cast<const float*>(qsq),
           values, nullptr, nullptr, nullptr, static_cast<float*>(out_s),
           static_cast<int*>(out_i), n, d, b, mode == 2 ? 1 : 0, tile_n,
           mode == 0 ? 1 : winners, METRIC_DOT, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
