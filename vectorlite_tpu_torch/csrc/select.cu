// Exact per-tile top-k for Hopper (sm_90a) past k = 256, and at any k past
// 32 over tiles of more than 32,768 rows: a tensor-core scan into a radix
// select.
//
//   scan_topk_select_tf32  (K1) replace vectorlite_tpu/kernels/pallas_scan.py:46
//   scan_topk_select_bf16  _tile_kernel over f32 rows (3xTF32) and over bf16
//                          rows (three bf16 query terms).
//   scan_topk_select_s8    (K2) replaces pallas_scan.py:471 _tile_kernel_int8:
//                          three int8 query terms, exact s32 sums, the row
//                          scale in the epilogue.
//
// Each writes tile_topk_plain's [B, n / tile_n, k]: each tile's top k by
// (score descending, row ascending), invalid rows at -inf. k <= 256 over
// tiles up to 32,768 rows keeps exact.cu's and wide.cu's entries, chosen
// before any launch (kernels/scan.py exact_route).
//
// Why not sorted lists past k 256: a list that takes rows by insertion or
// by merges costs more the longer it is (the deep mode this file replaced,
// lists in the output merged 256 candidates at a time, spent 28-78K
// cycles a merge at k 300-1,024), and once a list is an eighth of its tile
// or more most rows reach one. A radix select costs time linear in the
// tile's rows, whatever k is.
//
// Design: two launches a group of tiles, both on the caller's stream, over
// a scratch buffer the wrapper allocates (kernels/scan.py select_group_rows
// bounds it to 256 MiB: 8 tiles of 32,768 rows at B 256; groups of 1 or 2
// such tiles, which L2 could hold between the launches, ran slower: more
// launches, each with a partly empty last wave).
//
// 1. Scores: scan_mma.cuh's SCORES mode writes the group's [B, rows] f32
//    scores, metric and validity applied: 3xTF32 over f32 rows and three
//    bf16 query terms over bf16 rows, each with the large term summed a
//    slice at a time in registers (lists of any length reach dots near 0,
//    where the tensor cores' truncating accumulation would leave the f32
//    error above the plain product's), and three int8 terms with exact s32
//    sums over int8 rows.
// 2. Select (select.cuh select_kernel, which csrc/l1.cu runs too, over the
//    FADD stream's Manhattan scores: K4 past k 32): one block of 1,024
//    threads a (query, tile).
//    Each score maps to an order-preserving 32-bit key (key_of); tiles up
//    to 32,768 rows keep the keys in shared memory (128 KB), larger ones
//    read them again from the scratch each pass. Warp w owns rows [w S,
//    (w + 1) S) of the tile, S = 32 ceil(T / 1,024), lane l rows w S + l +
//    32 j: the (warp, j, lane) order is row order. The k-th key is found by
//    radix select, 8 bits a pass from the top: a histogram in shared memory
//    of the keys that match the digits found so far (one copy of the 256
//    bins a lane, so a warp's atomic adds never collide: cosine scores
//    share their top bits), then one warp finds the bin that holds the
//    remaining rank. The passes stop as soon as a whole bin is taken (3.03
//    passes a block at the main path's k 4,096). Every key above the final
//    prefix survives; of the keys equal to it, the lowest rows. Each warp
//    counts both kinds, so every warp knows where its survivors start and
//    ballots place the rest in row order: no atomic add on a shared count.
//    The k survivors are sorted by a bitonic network over the 64-bit value
//    key << 32 | ~offset, unique a row, so the order is (key descending,
//    row ascending) with no need for a stable sort: up to 8,192 entries in
//    registers (E = 2-8 a thread; strides under E in the thread, up to 32 E
//    by shuffles, larger through shared memory with a barrier a step),
//    longer lists as (key, 16-bit offset) pairs in shared memory, or past
//    32,768 entries or 65,536-row tiles in their slice of the output.
//
// Where the time goes (scripts/probe_exact_topk.py --select-only, PERF.md):
// at k 4,096 over 32,768-row tiles the select's block spends ~31K cycles
// in the passes (the keys' loads included), ~17K placing the survivors and
// ~44K sorting them; 8,192 blocks at one block an SM.
//
// Bounds at the main-path shapes (2^20 x 384 rows, B = 256): K1 over f32
// rows three tf32 passes of 2 B N D = 206 GFLOP at 494.7 TFLOP/s, 1.25 ms;
// over bf16 rows the rows' 805 MB and the [B, T, k] lists, 0.32 ms at
// k 4,096; K2 the rows' 403 MB and the lists, 0.20 ms. The scratch is this
// design's, not the function's: its 1 GiB of f32 scores written and read
// once adds 0.64 ms of device memory where a group outgrows L2, as the
// main path's do (chip_smoke.py prints both bounds).
//
// Each C entry launches on the caller's stream, allocates nothing and
// returns the first CUDA error of its launches.

#include "scan_mma.cuh"
#include "select.cuh"

namespace {
namespace sel {

// Scores then select, group by group: group_rows (a multiple of tile_n) a
// group, scratch [B, group_rows] f32.
template <typename T>
int launch_topk(const void* values, const void* q_img, const float* q_scale, const float* qsq,
                const float* scales, const float* sqnorms, const uint8_t* valid, float* scratch,
                int group_rows, float* out_s, int* out_i, int n, int d, int b, int k, int tile_n,
                int metric, cudaStream_t stream) {
  if (n <= 0 || d <= 0 || b <= 0 || tile_n <= 0 || tile_n % scan_mma::CHUNK || n % tile_n ||
      k < 1 || k > tile_n || group_rows < tile_n || group_rows % tile_n)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = n / tile_n;
  const size_t row_bytes = static_cast<size_t>(d) * scan_mma::Rows<T>::BYTES;
  for (int g0 = 0; g0 < n; g0 += group_rows) {
    const int m = n - g0 < group_rows ? n - g0 : group_rows;
    int e = scan_mma::launch<T, scan_mma::SCORES, 1>(
        static_cast<const uint8_t*>(values) + g0 * row_bytes, q_img, q_scale, qsq,
        scales != nullptr ? scales + g0 : nullptr, sqnorms + g0, valid + g0, scratch, nullptr, m,
        d, b, scan_mma::CHUNK, metric, scan_mma::F_WALK, stream);
    if (e == 0)
      e = launch_select(scratch, m, out_s, out_i, b, k, tile_n, n_tiles, g0 / tile_n,
                        m / tile_n, stream);
    if (e != 0) return e;
  }
  return 0;
}

}  // namespace sel
}  // namespace

extern "C" {

// K1 over f32 rows [n, d]: q_img the two tf32 query terms
// (kernels/scan_mma.py query_operand_tf32), scratch [B, group_rows] f32
// (group_rows a multiple of tile_n), into out_s/out_i [B, n / tile_n, k],
// 1 <= k <= tile_n.
int scan_topk_select_tf32(const void* q_img, const void* qsq, const void* values,
                          const void* sqnorms, const void* valid, void* scratch, int group_rows,
                          void* out_s, void* out_i, int n, int d, int b, int k, int tile_n,
                          int metric, void* stream) {
  return sel::launch_topk<float>(
      values, q_img, nullptr, static_cast<const float*>(qsq), nullptr,
      static_cast<const float*>(sqnorms), static_cast<const uint8_t*>(valid),
      static_cast<float*>(scratch), group_rows, static_cast<float*>(out_s),
      static_cast<int*>(out_i), n, d, b, k, tile_n, metric, static_cast<cudaStream_t>(stream));
}

// K1 over bf16 rows, with the three bf16 query terms q_img
// (kernels/scan_mma.py query_operand); the layout of scan_topk_select_tf32.
int scan_topk_select_bf16(const void* q_img, const void* qsq, const void* values,
                          const void* sqnorms, const void* valid, void* scratch, int group_rows,
                          void* out_s, void* out_i, int n, int d, int b, int k, int tile_n,
                          int metric, void* stream) {
  return sel::launch_topk<uint16_t>(
      values, q_img, nullptr, static_cast<const float*>(qsq), nullptr,
      static_cast<const float*>(sqnorms), static_cast<const uint8_t*>(valid),
      static_cast<float*>(scratch), group_rows, static_cast<float*>(out_s),
      static_cast<int*>(out_i), n, d, b, k, tile_n, metric, static_cast<cudaStream_t>(stream));
}

// K2: int8 rows with their scales, the three int8 query terms q_img and
// their scales q_scale (kernels/scan_mma.py query_operand_int8); the
// layout of scan_topk_select_tf32.
int scan_topk_select_s8(const void* q_img, const void* q_scale, const void* qsq,
                        const void* values, const void* scales, const void* sqnorms,
                        const void* valid, void* scratch, int group_rows, void* out_s,
                        void* out_i, int n, int d, int b, int k, int tile_n, int metric,
                        void* stream) {
  return sel::launch_topk<int8_t>(
      values, q_img, static_cast<const float*>(q_scale), static_cast<const float*>(qsq),
      static_cast<const float*>(scales), static_cast<const float*>(sqnorms),
      static_cast<const uint8_t*>(valid), static_cast<float*>(scratch), group_rows,
      static_cast<float*>(out_s), static_cast<int*>(out_i), n, d, b, k, tile_n, metric,
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
