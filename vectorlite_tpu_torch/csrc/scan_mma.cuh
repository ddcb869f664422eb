// The tensor-core scan body for Hopper (sm_90a): f32 queries against bf16
// or int8 rows on wgmma, with a per-(query, lane group) selection that
// lives on the accumulators. csrc/lanes.cu runs on it K3 over bf16 and
// int8 rows (scan_block_topw_bf16, scan_block_topw_s8), K7 over bf16 rows
// (scan_merge_topw) and K8 (scan_fold_probe); the CUDA-core body of
// scan_kernel.cuh keeps K1, K2, K4, and K3 and K7 over f32 rows.
//
// Bounds at the headline shape (2^20 x 384 rows, B = 256). bf16 rows: one
// bf16 pass is 2 B N D = 206 GFLOP, 0.21 ms at 989 TFLOP/s, and the rows'
// 805 MB take 0.24 ms at 3.35 TB/s; the f32 queries need three passes
// (below), 0.63 ms of tensor work. int8 rows: three int8 passes of 206 G
// operations at 1,979 TOP/s are 0.31 ms, the rows' 403 MB 0.12 ms. Both
// forms are bound by operations.
//
// Precision, bf16 rows. The rows are exact bf16 operands. The wrapper
// splits each f32 query into three bf16 terms, q = h + m + l exactly
// (kernels/scan_mma.py split_query_terms), and each term x row product is
// exact in f32, so the three passes give the f32 dot of the plain version
// up to the f32 additions. Those lose more on the tensor cores than in the
// plain version's order: summed into one accumulator (72 wgmmas at D =
// 384), the dots at D = 768 came out about twice as far from float64 as
// the plain f32 product's on an H100. So the h term's passes sum into one
// accumulator and the m and l terms' (smallest first) into a second, added
// once a chunk.
//
// Precision, int8 rows. The wrapper splits each f32 query into three int8
// terms (kernels/scan_mma.py split_query_int8): s1 = max|q| / 127 (an f32
// value), s2 = s1 / 254, s3 = s2 / 254, each term rounded to nearest in
// [-127, 127], so each term's full range covers the rounding error of the
// one before; q - s1 (t1 + t2 / 254 + t3 / 254^2) is at most s1 / (2 x
// 254^2) = s1 / 129,032 (about max|q| 2^-24) an element. Each term's dot
// with the int8 row accumulates exactly in s32 (wgmma m64n64k32.s32.s8.s8),
// and |acc| <= 127 x 127 x D < 2^24 for D <= 1,040, so its f32 conversion
// is exact too. The epilogue forms (acc3 / 254^2 + acc2 / 254 + acc1) s1,
// smallest first, then multiplies by the row's scale: four f32 roundings
// beside the split's residual, whose dot is at most D s1 / 129,032 x 127 x
// scale and ~3e-6 (rms) for N(0, 1) queries and rows at D = 384, below the
// plain version's own f32 error there (~9e-6 on the CPU). So the 1e-5
// rule (scores within rtol/atol 1e-5, ids equal beyond 1e-5 near-ties;
// chip_smoke.py, tests/test_torch_scan.py) holds K3 over int8 rows as it
// holds the other routes. Scales stepping by 128 (powers of two, the later
// terms within +-64) leave s1 2^-15, ~1.4e-5 (rms): above that rule for
// scores near 0.
//
// Design. The rows are the wgmma's M operand and the queries its N: a
// block owns 64 queries and a run of rows, and walks it in 128-row chunks,
// one chunk a step of its two consumer warpgroups (rows 0-63 and 64-127 of
// the chunk). So the accumulator's row r is lane group r of every chunk
// (chunks start at multiples of 128), and each thread holds the same two
// lane groups x 16 queries chunk after chunk: it owns those 32 (query, lane
// group) lists and updates them in ascending row order, with no
// synchronisation, under the strict-> insertion that keeps the lowest row
// among equal scores. A block's run is one tile (K7, K8) or, for K3, a run
// of consecutive tiles: the lists are written and reset at each tile's end,
// so the query terms load once a block and the ring never drains between
// tiles (K3's 4,096-row tiles would otherwise give 1,024 short blocks at
// 2^20 rows, B 256). A warpgroup stages its 64 rows of each 128-byte-wide
// slice (8 KB, 128-byte swizzle; 64 bf16 or 128 int8 columns) by TMA
// tensor copies into its own ring of stages on mbarriers; its first thread
// issues them (no producer warp), and refills a stage as soon as the wgmma
// group that read it has completed. Per slice a warpgroup issues 4 k-steps
// (32 bytes of each row a step: wgmma m64n64k16 over bf16, m64n64k32 over
// int8) x 3 terms with both operands from shared memory. After a chunk's
// last slice the epilogue applies the row scale (int8), the metric and the
// validity and updates the lists, branch-free: about 3 W instructions a
// score, which the other warpgroup's wgmmas overlap.
//
// The shared-memory budget is the crux: at 64 queries and D = 384 the three
// bf16 query terms take 144 KB (the int8 terms 72 KB), one rung of lists
// would take 64 KB and a ring of 128-row tiles 16 KB a stage. The choice:
// the lists live in registers (W scores and one word of W chunk indices a
// list, 32 lists a thread, beside the accumulators: two f32 sets of 32
// registers over bf16 rows, three s32 sets over int8 rows; ptxas reports
// 159-241 registers a thread over bf16 rows and 223-254 over int8 rows,
// where W = 3 spills 8 bytes), the query
// terms stay resident in shared memory for the whole run (loaded once by a
// TMA bulk copy, laid out by the wrapper in the swizzled order the wgmma
// reads), and the ring takes what is left (at most 8 stages; one block an
// SM, 256 threads). Where the terms do not fit beside two stages (bf16
// rows at D > 384), each stage carries its slice's three query terms too
// (32 KB a warpgroup), read again per chunk from L2. A list names its rows
// by chunk indices of 32 / W bits, so a tile holds at most 2^10 chunks at
// W = 3 (131,072 rows) and 2^16 at W = 2.
//
// Empty slots (a list short of W rows above -inf) name row 0 (K7), their
// lane group's first row of the tile (K8 `full`), or (K3) the lowest rows
// of the lane group not already listed, in row order: what the plain
// version's stable sort of the tile's -inf entries gives.
//
// Rows whose stride is not a multiple of 16 bytes (D = 100: 200 bytes of
// bf16, 100 of int8) are refused by TMA: for them each warpgroup copies its
// 64-row slice with plain loads into the same swizzled layout (bytes past
// the row zero), fences it to the async proxy and syncs its four warps
// before the wgmma. Columns past D of the last slice are zero either way
// (TMA fills them), as are the queries past B.
//
// Numbers: f32 only in the epilogue, IEEE division and sqrt, no fast math;
// cosine multiplies by the norms' reciprocals (score_of).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"

namespace {
namespace scan_mma {

constexpr int THREADS = 256;             // two consumer warpgroups
constexpr int WG_ROWS = 64;              // a warpgroup's rows of a chunk: the wgmma's M
constexpr int CHUNK = 128;               // rows a chunk: lane groups 0-127
constexpr int QN = 64;                   // queries a block: the wgmma's N
constexpr int SLICE_BYTES = 128;         // bytes of a row a slice: one swizzled row
constexpr int TERMS = 3;                 // terms a query
constexpr int BOX = WG_ROWS * SLICE_BYTES;   // bytes of a warpgroup's rows of a slice
constexpr int QSLICE = QN * SLICE_BYTES;     // bytes of one term's queries of a slice
constexpr int LISTS = QN / 2;            // (query, lane group) lists a thread owns
constexpr int MAX_STAGES = 8;
constexpr int SMEM_MAX = 232448;         // Hopper's per-block shared-memory limit

// What a block keeps of each (query, lane group): its top W by (score
// descending, row ascending) (K3, K7, K8 full), its W largest distinct
// scores (K8 maxonly), or nothing: the tile's first chunk is written as it
// is (K8 none; the wgmmas are volatile asm, so every chunk is contracted
// all the same).
enum Mode { TOPW = 0, DISTINCT = 1, FIRST = 2 };
// TMA: rows staged by tensor copies (else by plain loads); RESIDENT: the
// query terms stay in shared memory (else each stage carries its slice's);
// GROUP_ROW: an empty TOPW slot names its lane group's first row of the
// tile (K8 full), LOW_ROWS: the lowest rows of its lane group not listed
// (K3), neither: row 0 (K7); QUERY_MAJOR: lists go out as [B, T, W*128]
// (K3), else [T, B, W*128]; WALK: a block walks a run of consecutive tiles
// (K3), else one.
enum Flags {
  F_TMA = 1, F_RESIDENT = 2, F_GROUP_ROW = 4, F_LOW_ROWS = 8, F_QUERY_MAJOR = 16, F_WALK = 32
};
enum Metric { COSINE = 0, EUCLIDEAN = 1, DOT = 2 };

// The row element types: bf16 (as its bits) and int8.
template <typename T>
struct Rows;
template <>
struct Rows<uint16_t> {
  static constexpr int BYTES = 2;
  static constexpr CUtensorMapDataType TMA_TYPE = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
template <>
struct Rows<int8_t> {
  static constexpr int BYTES = 1;
  static constexpr CUtensorMapDataType TMA_TYPE = CU_TENSOR_MAP_DATA_TYPE_UINT8;  // TMA copies the bytes
};

// A chunk's three passes and their sums, by row type. bf16: the h term's
// passes into hi, the m and l terms' into lo (the large sum takes a third
// of the additions: the tensor cores' f32 accumulation loses up to an ulp
// of the sum an addition, the small one's losses are 2^-8 as large). int8:
// term t's passes into its own exact s32 sum.
template <typename T>
struct Dots;
template <>
struct Dots<uint16_t> {
  Acc<QN> hi, lo;
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < QN / 2; ++i) hi.v[i] = lo.v[i] = 0.0f;
  }
  __device__ __forceinline__ void hold_all() {
#pragma unroll
    for (int i = 0; i < QN / 2; ++i) {
      hold(hi.v[i]);
      hold(lo.v[i]);
    }
  }
  // k-step kk of a slice: terms l, m, then h
  __device__ __forceinline__ void mma(uint64_t da, uint64_t db, int kk) {
    wgmma_ss(lo, da + 2 * kk, db + 2 * (QSLICE >> 4) + 2 * kk);
    wgmma_ss(lo, da + 2 * kk, db + (QSLICE >> 4) + 2 * kk);
    wgmma_ss(hi, da + 2 * kk, db + 2 * kk);
  }
  __device__ __forceinline__ float dot(int i, float, float) const { return hi.v[i] + lo.v[i]; }
};
template <>
struct Dots<int8_t> {
  AccS<QN> a1, a2, a3;
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < QN / 2; ++i) a1.v[i] = a2.v[i] = a3.v[i] = 0;
  }
  __device__ __forceinline__ void hold_all() {
#pragma unroll
    for (int i = 0; i < QN / 2; ++i) {
      hold(a1.v[i]);
      hold(a2.v[i]);
      hold(a3.v[i]);
    }
  }
  __device__ __forceinline__ void mma(uint64_t da, uint64_t db, int kk) {
    wgmma_s8(a3, da + 2 * kk, db + 2 * (QSLICE >> 4) + 2 * kk);
    wgmma_s8(a2, da + 2 * kk, db + (QSLICE >> 4) + 2 * kk);
    wgmma_s8(a1, da + 2 * kk, db + 2 * kk);
  }
  // (acc3 / 254^2 + acc2 / 254 + acc1) s1, then the row's scale (each
  // conversion exact)
  __device__ __forceinline__ float dot(int i, float qscale, float rscale) const {
    const float t = (static_cast<float>(a3.v[i]) * (1.0f / 64516.0f) +
                     static_cast<float>(a2.v[i]) * (1.0f / 254.0f)) +
                    static_cast<float>(a1.v[i]);
    return (t * qscale) * rscale;
  }
};

struct Layout {
  size_t ring;   // offset of warpgroup 0's ring (the resident query terms come first)
  size_t stage;  // bytes of a stage
  size_t qnorm;  // [3][QN] f32: the block's query squared norms, 1 / the norms, term scales
  size_t bars;   // 2 x stages full barriers, then the query terms' barrier
  size_t bytes;  // dynamic shared memory, with the slack to align the base to 1 KB
};

__host__ __device__ inline Layout layout_for(int slices, bool resident, int stages) {
  Layout l;
  l.ring = resident ? static_cast<size_t>(slices) * TERMS * QSLICE : 0;
  l.stage = BOX + (resident ? 0 : TERMS * QSLICE);
  l.qnorm = l.ring + 2 * stages * l.stage;
  l.bars = l.qnorm + 3 * QN * sizeof(float);
  l.bytes = l.bars + (2 * stages + 1) * 8 + 1024;
  return l;
}

// Shared-memory matrix descriptor of a K-major operand in the 128-byte
// swizzle (TMA's SWIZZLE_128B): rows of 128 bytes, groups of 8 rows 1024
// bytes apart (stride byte offset), the base 1 KB aligned. The k-step kk
// of a slice starts 32 kk bytes in: descriptor + 2 kk.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
       | (static_cast<uint64_t>(1) << 16)
       | (static_cast<uint64_t>(1024 >> 4) << 32)
       | (static_cast<uint64_t>(1) << 62);
}

// pallas_scan.py:74-89 with the norms' work taken once a query and once a
// row: cosine is dot x (1 / |q|) x (1 / |v|), 0 where either norm is 0 (the
// plain version divides by max(|q||v|, 1e-30); the two differ by rounding,
// and for 0 < |q||v| < 1e-30); euclidean clamps the expanded squared
// distance at 0.
__device__ __forceinline__ float score_of(float dot, float qsq, float q_inv, float sq,
                                          float v_inv, int metric) {
  if (metric == COSINE) return dot * q_inv * v_inv;
  if (metric == EUCLIDEAN) {
    const float d_sq = fmaxf(qsq + sq - 2.0f * dot, 0.0f);
    return 1.0f / (1.0f + sqrtf(d_sq));
  }
  return dot;
}

// 1 / sqrt(sq), 0 where sq is 0.
__device__ __forceinline__ float inv_norm(float sq) {
  return sq > 0.0f ? 1.0f / sqrtf(sq) : 0.0f;
}

// A list names its entries' rows by their chunk indices in the tile,
// packed in one word: W fields of 32 / W bits (W 3: 10 bits, so a tile
// holds at most 2^10 chunks; W 2: 2^16; W 1: any).
template <int W>
struct Ids {
  static constexpr int BITS = 32 / W;
  static constexpr uint32_t MASK = W == 1 ? ~0u : (1u << BITS) - 1;
  uint32_t v[LISTS];
};

template <int W>
__device__ __forceinline__ uint32_t id_of(const Ids<W>& ids, int w, int L) {
  return (ids.v[L] >> (Ids<W>::BITS * w)) & Ids<W>::MASK;
}

// List L's update by score s of chunk c, branch-free (a warp's lanes
// disagree on most chunks whether their list takes the score, so a branch
// would run the insertion for the whole warp anyway): s enters only when it
// beats the last entry strictly (rows arrive in ascending order, so the
// lower row stays first among equal scores); DISTINCT also drops a score
// already listed. above[w]: s goes above entry w; the lists are sorted, so
// the entries it goes above are a suffix and s lands at the first of them.
template <int MODE, int W>
__device__ __forceinline__ void list_update(float (&ls)[W][LISTS], Ids<W>& ids, int L,
                                            float s, uint32_t c) {
  bool enter = s > ls[W - 1][L];
  if (MODE == DISTINCT) {
#pragma unroll
    for (int w = 0; w + 1 < W; ++w) enter = enter && ls[w][L] != s;
  }
  bool above[W];
#pragma unroll
  for (int w = 0; w < W; ++w) above[w] = enter && s > ls[w][L];
#pragma unroll
  for (int w = W - 1; w > 0; --w)
    ls[w][L] = above[w - 1] ? ls[w - 1][L] : (above[w] ? s : ls[w][L]);
  ls[0][L] = above[0] ? s : ls[0][L];
  if constexpr (MODE == TOPW) {
    uint32_t e[W];
#pragma unroll
    for (int w = 0; w < W; ++w) e[w] = id_of<W>(ids, w, L);
#pragma unroll
    for (int w = W - 1; w > 0; --w) e[w] = above[w - 1] ? e[w - 1] : (above[w] ? c : e[w]);
    e[0] = above[0] ? c : e[0];
    uint32_t v = 0;
#pragma unroll
    for (int w = 0; w < W; ++w) v |= e[w] << (Ids<W>::BITS * w);
    ids.v[L] = v;
  }
}

// A block: 64 queries (blockIdx.x) x a run of tiles (blockIdx.y: tiles
// blockIdx.y * tiles_per_block on, one without F_WALK), into out_s/out_i
// [n_tiles, B, n_out] or, with F_QUERY_MAJOR, [B, n_tiles, n_out] (n_out =
// 128 for FIRST, W * 128 otherwise, position w * 128 + lane group). K8
// passes no qsq, sqnorms or validity (dot, every row valid); only int8 rows
// have scales and query term scales.
template <typename T, int MODE, int W>
__global__ void __launch_bounds__(THREADS, 1)
lanes_kernel(const __grid_constant__ CUtensorMap rows_map,   // [N, D] (F_TMA)
             const T* __restrict__ values,                   // [N, D] (plain loads)
             const uint8_t* __restrict__ q_img,   // [B/64, S, 3, 64, 128 bytes], swizzled
             const float* __restrict__ q_scale,   // [B] (int8) or null
             const float* __restrict__ qsq,       // [B] or null
             const float* __restrict__ scales,    // [N] (int8) or null
             const float* __restrict__ sqnorms,   // [N] or null
             const uint8_t* __restrict__ valid,   // [N] or null
             float* __restrict__ out_s, int* __restrict__ out_i,
             int d, int b, int tile_n, int n_tiles, int tiles_per_block, int metric,
             int slices, int stages, int flags) {
  extern __shared__ __align__(16) uint8_t body_smem[];
  uint8_t* smem = body_smem + ((1024 - (smem_addr(body_smem) & 1023)) & 1023);
  const bool tma = flags & F_TMA;
  const bool resident = flags & F_RESIDENT;
  const Layout lay = layout_for(slices, resident, stages);

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int wtid = tid & 127;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = blockIdx.x * QN;
  const int first_tile = blockIdx.y * tiles_per_block;
  const int my_tiles = min(tiles_per_block, n_tiles - first_tile);
  const long long run_base = static_cast<long long>(first_tile) * tile_n;
  const int tile_chunks = tile_n / CHUNK;
  const int steps = my_tiles * tile_chunks * slices;

  uint8_t* ring = smem + lay.ring + static_cast<size_t>(wg) * stages * lay.stage;
  float* qn = reinterpret_cast<float*>(smem + lay.qnorm);  // qsq, 1 / |q|, term scale
  const uint32_t bars = smem_addr(smem + lay.bars);
  const uint32_t full0 = bars + 8 * wg * stages;
  const uint32_t img_bar = bars + 8 * 2 * stages;
  const uint32_t stage_tx = (tma ? BOX : 0) + (resident ? 0 : TERMS * QSLICE);
  const size_t img_bytes = static_cast<size_t>(slices) * TERMS * QSLICE;
  const uint8_t* img = q_img + blockIdx.x * img_bytes;

  if (tid == 0) {
    for (int i = 0; i < 2 * stages + 1; ++i) mbar_init(bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid < QN) {
    const bool live = q0 + tid < b;
    const float v = (qsq != nullptr && live) ? qsq[q0 + tid] : 0.0f;
    qn[tid] = v;
    qn[QN + tid] = inv_norm(v);
    qn[2 * QN + tid] = (q_scale != nullptr && live) ? q_scale[q0 + tid] : 1.0f;
  }
  __syncthreads();

  // step j = chunk j / slices of the run, slice j % slices, into stage j % stages
  auto issue = [&](int j) {
    if (stage_tx == 0) return;
    const int st = j % stages;
    const int s = j % slices;
    const uint32_t bar = full0 + 8 * st;
    const uint32_t dst = smem_addr(ring + st * lay.stage);
    mbar_expect_tx(bar, stage_tx);
    if (tma)
      tma_load_2d(dst, &rows_map, s * (SLICE_BYTES / Rows<T>::BYTES),
                  static_cast<int>(run_base + static_cast<long long>(j / slices) * CHUNK +
                                   wg * WG_ROWS),
                  bar);
    if (!resident)
      bulk_load(dst + BOX, img + static_cast<size_t>(s) * TERMS * QSLICE, TERMS * QSLICE, bar);
  };
  // the staging path for rows TMA refuses: this warpgroup's 64 rows of the
  // slice by plain loads, swizzled as TMA would, then fenced to the async
  // proxy
  auto copy_rows = [&](int j) {
    const int c = j / slices;
    const int s = j % slices;
    uint8_t* dst = ring + (j % stages) * lay.stage;
    const long long row0 = run_base + static_cast<long long>(c) * CHUNK + wg * WG_ROWS;
    const size_t row_bytes = static_cast<size_t>(d) * Rows<T>::BYTES;
    const uint8_t* vb = reinterpret_cast<const uint8_t*>(values);
    for (int x = wtid; x < WG_ROWS * 8; x += 128) {
      const int r = x >> 3;
      const int ch = x & 7;
      const size_t col = static_cast<size_t>(s) * SLICE_BYTES + ch * 16;
      const uint8_t* src = vb + static_cast<size_t>(row0 + r) * row_bytes + col;
      uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int e = 0; e < 16; ++e)
        if (col + e < row_bytes) w[e >> 2] |= static_cast<uint32_t>(src[e]) << (8 * (e & 3));
      *reinterpret_cast<uint4*>(dst + r * 128 + ((ch ^ (r & 7)) << 4)) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
  };

  if (tid == 0 && resident) {
    mbar_expect_tx(img_bar, static_cast<uint32_t>(img_bytes));
    bulk_load(smem_addr(smem), img, static_cast<uint32_t>(img_bytes), img_bar);
  }
  if (wtid == 0)
    for (int j = 0; j < stages && j < steps; ++j) issue(j);
  __syncwarp();
  if (resident) mbar_wait(img_bar, 0);

  // the thread's accumulator rows: lane groups lg and lg + 8; its queries
  // q0 + 8 i + 2 t + e (accumulator entry 4 i + 2 h + e, h = 1 for lg + 8)
  const int lg = wg * WG_ROWS + warp * 16 + g;
  float ls[W][LISTS];
  Ids<W> ids;
  auto reset = [&]() {
#pragma unroll
    for (int L = 0; L < LISTS; ++L) {
#pragma unroll
      for (int w = 0; w < W; ++w) ls[w][L] = -CUDART_INF_F;
      ids.v[L] = 0;
    }
  };
  auto out_at = [&](int tile, int q, int n_out) {
    return flags & F_QUERY_MAJOR
               ? (static_cast<size_t>(q) * n_tiles + tile) * n_out
               : (static_cast<size_t>(tile) * b + q) * n_out;
  };
  // the tile's lists to the output
  auto flush = [&](int tile) {
    const long long tile_base = static_cast<long long>(tile) * tile_n;
#pragma unroll
    for (int L = 0; L < LISTS; ++L) {
      const int q = q0 + 8 * (L >> 2) + 2 * t + (L & 1);
      if (q >= b) continue;
      const int lgl = lg + 8 * ((L >> 1) & 1);
      const size_t o = out_at(tile, q, W * CHUNK) + lgl;
      uint32_t next = 0;  // F_LOW_ROWS: the next chunk an empty slot may name
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const float s = ls[w][L];
        long long r = 0;
        if (MODE == TOPW) {
          if (s != -CUDART_INF_F) {
            r = tile_base + static_cast<long long>(id_of<W>(ids, w, L)) * CHUNK + lgl;
          } else if (flags & F_LOW_ROWS) {
            // the lowest chunk no finite entry names (those come first)
            for (bool taken = true; taken;) {
              taken = false;
#pragma unroll
              for (int v = 0; v < W; ++v)
                taken = taken || (ls[v][L] != -CUDART_INF_F && id_of<W>(ids, v, L) == next);
              next += taken;
            }
            r = tile_base + static_cast<long long>(next++) * CHUNK + lgl;
          } else if (flags & F_GROUP_ROW) {
            r = tile_base + lgl;
          }
        }
        out_s[o + w * CHUNK] = s;
        out_i[o + w * CHUNK] = static_cast<int>(r);
      }
    }
  };

  const uint32_t img_s = smem_addr(smem);
  Dots<T> acc;
  for (int tt = 0; tt < my_tiles; ++tt) {
    const int tile = first_tile + tt;
    reset();
    for (int cl = 0; cl < tile_chunks; ++cl) {  // the chunk's index in its tile
      const int c = tt * tile_chunks + cl;  // ... and in the block's run
      acc.zero();
      for (int s = 0; s < slices; ++s) {
        const int j = c * slices + s;
        const int st = j % stages;
        if (!tma) copy_rows(j);
        if (stage_tx != 0) mbar_wait(full0 + 8 * st, (j / stages) & 1);
        const uint32_t a = smem_addr(ring + st * lay.stage);
        uint64_t da = sw128_desc(a);
        uint64_t db = sw128_desc(resident ? img_s + s * TERMS * QSLICE : a + BOX);
        hold(da);
        hold(db);
        acc.hold_all();
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) acc.mma(da, db, kk);
        wgmma_commit();
        // the previous step's group has completed: refill its stage
        wgmma_wait<1>();
        if (wtid == 0 && j >= 1 && j - 1 + stages < steps) issue(j - 1 + stages);
        __syncwarp();
      }
      wgmma_wait<0>();
      acc.hold_all();

      const long long row = run_base + static_cast<long long>(c) * CHUNK + lg;
      float rscale[2] = {1.0f, 1.0f};
      if (scales != nullptr) {
        rscale[0] = scales[row];
        rscale[1] = scales[row + 8];
      }
      float dot[LISTS];
#pragma unroll
      for (int L = 0; L < LISTS; ++L) {
        const int ql = 8 * (L >> 2) + 2 * t + (L & 1);
        dot[L] = acc.dot(L, sizeof(T) == 1 ? qn[2 * QN + ql] : 1.0f, rscale[(L >> 1) & 1]);
      }

      if (MODE == FIRST) {
#pragma unroll
        for (int L = 0; L < LISTS; ++L) {
          const int q = q0 + 8 * (L >> 2) + 2 * t + (L & 1);
          if (cl == 0 && q < b) {
            const size_t o = out_at(tile, q, CHUNK) + lg + 8 * ((L >> 1) & 1);
            out_s[o] = dot[L];
            out_i[o] = 0;
          }
        }
        continue;
      }
      // metric and validity, then the lists
      float sq[2] = {0.0f, 0.0f};
      bool ok[2] = {true, true};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (sqnorms != nullptr) sq[h] = sqnorms[row + 8 * h];
        if (valid != nullptr) ok[h] = valid[row + 8 * h] != 0;
      }
      const float inv[2] = {inv_norm(sq[0]), inv_norm(sq[1])};
#pragma unroll
      for (int L = 0; L < LISTS; ++L) {
        const int h = (L >> 1) & 1;
        const int ql = 8 * (L >> 2) + 2 * t + (L & 1);
        float s = dot[L];
        if (metric != DOT) s = score_of(s, qn[ql], qn[QN + ql], sq[h], inv[h], metric);
        if (!ok[h]) s = -CUDART_INF_F;
        list_update<MODE, W>(ls, ids, L, s, static_cast<uint32_t>(cl));
      }
    }
    if (MODE != FIRST) flush(tile);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no -lcuda).
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                            &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Tiles a block walks with F_WALK: the fewest that keep every block's run
// within one wave of the card's SMs (at one block an SM).
inline int walk_tiles(int n_tiles, int q_blocks) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      sms <= 0)
    return 1;
  const long long units = static_cast<long long>(n_tiles) * q_blocks;
  return static_cast<int>((units + sms - 1) / sms);
}

// One launch over bf16 (T = uint16_t) or int8 rows [n, d]: mode and W
// choose the instantiation; metric is applied with qsq/sqnorms (null for a
// dot). Returns the CUDA error of the launch.
template <typename T, int MODE, int W>
int launch(const void* values, const void* q_img, const float* q_scale, const float* qsq,
           const float* scales, const float* sqnorms, const uint8_t* valid, float* out_s,
           int* out_i, int n, int d, int b, int tile_n, int metric, int flags,
           cudaStream_t stream) {
  if (n <= 0 || d <= 0 || b <= 0 || tile_n <= 0 || tile_n % CHUNK || n % tile_n)
    return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (MODE != FIRST && W > 1) {
    if (tile_n / CHUNK > (1 << Ids<W>::BITS)) return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int BYTES = Rows<T>::BYTES;
  const int slices = (d * BYTES + SLICE_BYTES - 1) / SLICE_BYTES;
  bool resident = true;
  int stages = MAX_STAGES;
  while (stages >= 2 && layout_for(slices, true, stages).bytes > SMEM_MAX) --stages;
  if (stages < 2) {
    resident = false;
    stages = MAX_STAGES;
    while (stages >= 2 && layout_for(slices, false, stages).bytes > SMEM_MAX) --stages;
  }
  if (stages < 2) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map;
  memset(&map, 0, sizeof(map));
  const bool tma = (static_cast<size_t>(d) * BYTES) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(values) % 16 == 0;
  if (tma) {
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(n)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(d) * BYTES};
    const cuuint32_t box[2] = {SLICE_BYTES / BYTES, WG_ROWS};
    const cuuint32_t unit[2] = {1, 1};
    if (encode(&map, Rows<T>::TMA_TYPE, 2, const_cast<void*>(values), dims, strides, box, unit,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  flags |= (tma ? F_TMA : 0) | (resident ? F_RESIDENT : 0);
  const int n_tiles = n / tile_n;
  const int q_blocks = (b + QN - 1) / QN;
  const int per_block = (flags & F_WALK) ? walk_tiles(n_tiles, q_blocks) : 1;
  const size_t smem = layout_for(slices, resident, stages).bytes;
  auto kernel = lanes_kernel<T, MODE, W>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(q_blocks, (n_tiles + per_block - 1) / per_block);
  kernel<<<grid, THREADS, smem, stream>>>(
      map, static_cast<const T*>(values), static_cast<const uint8_t*>(q_img), q_scale, qsq,
      scales, sqnorms, valid, out_s, out_i, d, b, tile_n, n_tiles, per_block, metric, slices,
      stages, flags);
  return static_cast<int>(cudaGetLastError());
}

// launch<T, MODE, W> for a runtime W in 1-3 (FIRST keeps no lists: W 1).
template <typename T, int MODE>
int launch_w(int winners, const void* values, const void* q_img, const float* q_scale,
             const float* qsq, const float* scales, const float* sqnorms,
             const uint8_t* valid, float* out_s, int* out_i, int n, int d, int b, int tile_n,
             int metric, int flags, cudaStream_t stream) {
  if constexpr (MODE == FIRST) {
    return launch<T, MODE, 1>(values, q_img, q_scale, qsq, scales, sqnorms, valid, out_s,
                              out_i, n, d, b, tile_n, metric, flags, stream);
  } else {
    switch (winners) {
      case 1: return launch<T, MODE, 1>(values, q_img, q_scale, qsq, scales, sqnorms, valid,
                                        out_s, out_i, n, d, b, tile_n, metric, flags, stream);
      case 2: return launch<T, MODE, 2>(values, q_img, q_scale, qsq, scales, sqnorms, valid,
                                        out_s, out_i, n, d, b, tile_n, metric, flags, stream);
      case 3: return launch<T, MODE, 3>(values, q_img, q_scale, qsq, scales, sqnorms, valid,
                                        out_s, out_i, n, d, b, tile_n, metric, flags, stream);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
}

}  // namespace scan_mma
}  // namespace
