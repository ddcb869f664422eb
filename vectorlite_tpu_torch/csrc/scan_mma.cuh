// The tensor-core scan body for Hopper (sm_90a): f32 queries against bf16
// rows on wgmma, with a per-(query, lane group) selection that lives on the
// accumulators. csrc/lanes.cu runs K7 over bf16 rows (scan_merge_topw) and
// K8 (scan_fold_probe) on it; the CUDA-core body of scan_kernel.cuh keeps
// K1-K4 and K7 over f32 rows.
//
// Bound at the headline shape (2^20 x 384 bf16 rows, B = 256): one bf16
// pass is 2 B N D = 206 GFLOP, 0.21 ms at 989 TFLOP/s, and the rows' 805 MB
// take 0.24 ms at 3.35 TB/s. The f32 queries need three passes (below):
// 0.63 ms of tensor work, so the design is bound by operations.
//
// Precision. The rows are exact bf16 operands. The wrapper splits each f32
// query into three bf16 terms, q = h + m + l exactly (kernels/scan_mma.py
// split_query_terms), and each term x row product is exact in f32, so the
// three passes give the f32 dot of the plain version up to the f32
// additions. Those lose more on the tensor cores than in the plain
// version's order: summed into one accumulator (72 wgmmas at D = 384), the
// dots at D = 768 came out about twice as far from float64 as the plain
// f32 product's on an H100. So the h term's passes sum into one
// accumulator and the m and l terms' (smallest first) into a second, added
// once a chunk.
//
// Design. The rows are the wgmma's M operand and the queries its N: a
// block owns 64 queries and one tile and walks the tile in 128-row chunks,
// one chunk a step of its two consumer warpgroups (rows 0-63 and 64-127 of
// the chunk). So the accumulator's row r is lane group r of every chunk
// (chunks start at multiples of 128), and each thread holds the same two
// lane groups x 16 queries chunk after chunk: it owns those 32 (query, lane
// group) lists and updates them in ascending row order, with no
// synchronisation, under the strict-> insertion that keeps the lowest row
// among equal scores. A warpgroup stages its 64 rows of each 64-column
// slice (8 KB, 128-byte swizzle) by TMA tensor copies into its own ring of
// stages on mbarriers; its first thread issues them (no producer warp), and
// refills a stage as soon as the wgmma group that read it has completed.
// Per slice a warpgroup issues 4 k-steps x 3 terms of wgmma m64n64k16 with
// both operands from shared memory. After a chunk's last slice the
// epilogue applies the metric and the validity (K7) and updates the lists,
// branch-free: about 3 W instructions a score, which the other warpgroup's
// wgmmas overlap.
//
// The shared-memory budget is the crux: at 64 queries and D = 384 the three
// query terms take 144 KB, one rung of lists would take 64 KB and a ring
// of 128 x 64 bf16 row tiles 16 KB a stage. The choice: the lists live in
// registers (W scores and one word of W chunk indices a list, 32 lists a
// thread, beside the two accumulators' 64: up to 253 registers a thread at
// W = 3 in ptxas's report, no spills), the
// query terms stay resident in shared memory for the whole tile (loaded
// once by a TMA bulk copy, laid out by the wrapper in the swizzled order the
// wgmma reads), and the ring takes what is left: 4 stages of 2 x 8 KB at D
// = 384 (214.6 KB in all, one block an SM, 256 threads). Where the terms
// do not fit beside two stages (D > 384), each stage carries its slice's
// three query terms too (32 KB a warpgroup), read again per chunk from L2.
// A list names its rows by chunk indices of 32 / W bits, so a tile holds
// at most 2^10 chunks at W = 3 (131,072 rows) and 2^16 at W = 2.
//
// Rows whose stride is not a multiple of 16 bytes (D = 100: 200 bytes)
// are refused by TMA: for them each warpgroup copies its 64 x 64 slice with
// plain loads into the same swizzled layout (columns past D zero), fences
// it to the async proxy and syncs its four warps before the wgmma. Columns
// past D of the last slice are zero either way (TMA fills them), as are the
// queries past B.
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
constexpr int KS = 64;                   // columns a slice: one 128-byte swizzled row
constexpr int TERMS = 3;                 // bf16 terms a query
constexpr int BOX = WG_ROWS * KS * 2;    // bytes of a warpgroup's rows of a slice
constexpr int QSLICE = QN * KS * 2;      // bytes of one term's queries of a slice
constexpr int LISTS = QN / 2;            // (query, lane group) lists a thread owns
constexpr int MAX_STAGES = 8;
constexpr int SMEM_MAX = 232448;         // Hopper's per-block shared-memory limit

// What a block keeps of each (query, lane group): its top W by (score
// descending, row ascending) (K7, K8 full), its W largest distinct scores
// (K8 maxonly), or nothing: the tile's first chunk is written as it is
// (K8 none; the wgmmas are volatile asm, so every chunk is contracted all
// the same).
enum Mode { TOPW = 0, DISTINCT = 1, FIRST = 2 };
// TMA: rows staged by tensor copies (else by plain loads); RESIDENT: the
// query terms stay in shared memory (else each stage carries its slice's);
// GROUP_ROW: an empty TOPW slot names its lane group's first row of the
// tile (K8 full), else row 0 (K7).
enum Flags { F_TMA = 1, F_RESIDENT = 2, F_GROUP_ROW = 4 };
enum Metric { COSINE = 0, EUCLIDEAN = 1, DOT = 2 };

struct Layout {
  size_t ring;   // offset of warpgroup 0's ring (the resident query terms come first)
  size_t stage;  // bytes of a stage
  size_t qnorm;  // [2][QN] f32: the block's query squared norms, 1 / the norms
  size_t bars;   // 2 x stages full barriers, then the query terms' barrier
  size_t bytes;  // dynamic shared memory, with the slack to align the base to 1 KB
};

__host__ __device__ inline Layout layout_for(int slices, bool resident, int stages) {
  Layout l;
  l.ring = resident ? static_cast<size_t>(slices) * TERMS * QSLICE : 0;
  l.stage = BOX + (resident ? 0 : TERMS * QSLICE);
  l.qnorm = l.ring + 2 * stages * l.stage;
  l.bars = l.qnorm + 2 * QN * sizeof(float);
  l.bytes = l.bars + (2 * stages + 1) * 8 + 1024;
  return l;
}

// Shared-memory matrix descriptor of a K-major operand in the 128-byte
// swizzle (TMA's SWIZZLE_128B): rows of 64 bf16 (128 bytes), groups of 8
// rows 1024 bytes apart (stride byte offset), the base 1 KB aligned. The
// k-step kk of a slice starts 32 kk bytes in: descriptor + 2 kk.
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

// A list names its entries' rows by their chunk indices, packed in one
// word: W fields of 32 / W bits (W 3: 10 bits, so a tile holds at most 2^10
// chunks; W 2: 2^16; W 1: any).
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

// A block: 64 queries (blockIdx.x) x one tile (blockIdx.y), into
// out_s/out_i [n_tiles, B, n_out] (n_out = 128 for FIRST, W * 128
// otherwise, position w * 128 + lane group). K8 passes no qsq, sqnorms or
// validity (dot, every row valid).
template <int MODE, int W>
__global__ void __launch_bounds__(THREADS, 1)
lanes_kernel(const __grid_constant__ CUtensorMap rows_map,   // [N, D] bf16 (F_TMA)
             const uint16_t* __restrict__ values,            // [N, D] bf16 (plain loads)
             const uint8_t* __restrict__ q_img,   // [B/64, S, 3, 64, 64] bf16, swizzled
             const float* __restrict__ qsq,       // [B] or null
             const float* __restrict__ sqnorms,   // [N] or null
             const uint8_t* __restrict__ valid,   // [N] or null
             float* __restrict__ out_s, int* __restrict__ out_i,
             int d, int b, int tile_n, int metric, int slices, int stages, int flags) {
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
  const int tile = blockIdx.y;
  const long long tile_base = static_cast<long long>(tile) * tile_n;
  const int n_chunks = tile_n / CHUNK;
  const int steps = n_chunks * slices;

  uint8_t* ring = smem + lay.ring + static_cast<size_t>(wg) * stages * lay.stage;
  float* qn = reinterpret_cast<float*>(smem + lay.qnorm);  // qsq, then 1 / |q|
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
    const float v = (qsq != nullptr && q0 + tid < b) ? qsq[q0 + tid] : 0.0f;
    qn[tid] = v;
    qn[QN + tid] = inv_norm(v);
  }
  __syncthreads();

  // step j = chunk j / slices, slice j % slices, into stage j % stages
  auto issue = [&](int j) {
    if (stage_tx == 0) return;
    const int st = j % stages;
    const int s = j % slices;
    const uint32_t bar = full0 + 8 * st;
    const uint32_t dst = smem_addr(ring + st * lay.stage);
    mbar_expect_tx(bar, stage_tx);
    if (tma)
      tma_load_2d(dst, &rows_map, s * KS,
                  static_cast<int>(tile_base + static_cast<long long>(j / slices) * CHUNK +
                                   wg * WG_ROWS),
                  bar);
    if (!resident)
      bulk_load(dst + BOX, img + static_cast<size_t>(s) * TERMS * QSLICE, TERMS * QSLICE, bar);
  };
  // the staging path for rows TMA refuses: this warpgroup's 64 x 64 slice by
  // plain loads, swizzled as TMA would, then fenced to the async proxy
  auto copy_rows = [&](int j) {
    const int c = j / slices;
    const int s = j % slices;
    uint8_t* dst = ring + (j % stages) * lay.stage;
    const long long row0 = tile_base + static_cast<long long>(c) * CHUNK + wg * WG_ROWS;
    for (int x = wtid; x < WG_ROWS * 8; x += 128) {
      const int r = x >> 3;
      const int ch = x & 7;
      const int col = s * KS + ch * 8;
      const uint16_t* src = values + static_cast<size_t>(row0 + r) * d + col;
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t lo = col + 2 * e < d ? src[2 * e] : 0u;
        const uint32_t hi = col + 2 * e + 1 < d ? src[2 * e + 1] : 0u;
        w[e] = lo | (hi << 16);
      }
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
#pragma unroll
  for (int L = 0; L < LISTS; ++L) {
#pragma unroll
    for (int w = 0; w < W; ++w) ls[w][L] = -CUDART_INF_F;
    ids.v[L] = 0;
  }

  // the h term's passes sum into hi, the m and l terms' into lo: the large
  // sum takes a third of the additions (the tensor cores' f32 accumulation
  // loses up to an ulp of the sum an addition), the small one's losses are
  // 2^-8 as large
  const uint32_t img_s = smem_addr(smem);
  Acc<QN> hi, lo;
  for (int c = 0; c < n_chunks; ++c) {
#pragma unroll
    for (int i = 0; i < QN / 2; ++i) hi.v[i] = lo.v[i] = 0.0f;
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
#pragma unroll
      for (int i = 0; i < QN / 2; ++i) {
        hold(hi.v[i]);
        hold(lo.v[i]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KS / 16; ++kk) {  // terms l, m, then h
        wgmma_ss(lo, da + 2 * kk, db + 2 * (QSLICE >> 4) + 2 * kk);
        wgmma_ss(lo, da + 2 * kk, db + (QSLICE >> 4) + 2 * kk);
        wgmma_ss(hi, da + 2 * kk, db + 2 * kk);
      }
      wgmma_commit();
      // the previous step's group has completed: refill its stage
      wgmma_wait<1>();
      if (wtid == 0 && j >= 1 && j - 1 + stages < steps) issue(j - 1 + stages);
      __syncwarp();
    }
    wgmma_wait<0>();
    float dot[LISTS];
#pragma unroll
    for (int i = 0; i < QN / 2; ++i) {
      hold(hi.v[i]);
      hold(lo.v[i]);
      dot[i] = hi.v[i] + lo.v[i];
    }

    if (MODE == FIRST) {
#pragma unroll
      for (int L = 0; L < LISTS; ++L) {
        const int q = q0 + 8 * (L >> 2) + 2 * t + (L & 1);
        if (c == 0 && q < b) {
          const size_t o = (static_cast<size_t>(tile) * b + q) * CHUNK + lg + 8 * ((L >> 1) & 1);
          out_s[o] = dot[L];
          out_i[o] = 0;
        }
      }
      continue;
    }
    // metric and validity, then the lists
    const long long row = tile_base + static_cast<long long>(c) * CHUNK + lg;
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
      list_update<MODE, W>(ls, ids, L, s, static_cast<uint32_t>(c));
    }
  }

  if (MODE == FIRST) return;
#pragma unroll
  for (int L = 0; L < LISTS; ++L) {
    const int q = q0 + 8 * (L >> 2) + 2 * t + (L & 1);
    if (q >= b) continue;
    const int lgl = lg + 8 * ((L >> 1) & 1);
    const size_t o = (static_cast<size_t>(tile) * b + q) * (W * CHUNK) + lgl;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const float s = ls[w][L];
      long long r = 0;
      if (MODE == TOPW) {
        if (s != -CUDART_INF_F)
          r = tile_base + static_cast<long long>(id_of<W>(ids, w, L)) * CHUNK + lgl;
        else if (flags & F_GROUP_ROW)
          r = tile_base + lgl;
      }
      out_s[o + w * CHUNK] = s;
      out_i[o + w * CHUNK] = static_cast<int>(r);
    }
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

// One launch over bf16 rows [n, d]: mode and W choose the instantiation;
// metric is applied with qsq/sqnorms (null for a dot). Returns the CUDA
// error of the launch.
template <int MODE, int W>
int launch(const void* values, const void* q_img, const float* qsq, const float* sqnorms,
           const uint8_t* valid, float* out_s, int* out_i, int n, int d, int b, int tile_n,
           int metric, int flags, cudaStream_t stream) {
  if (n <= 0 || d <= 0 || b <= 0 || tile_n % CHUNK || n % tile_n)
    return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (MODE != FIRST && W > 1) {
    if (tile_n / CHUNK > (1 << Ids<W>::BITS)) return static_cast<int>(cudaErrorInvalidValue);
  }
  const int slices = (d + KS - 1) / KS;
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
  const bool tma = (static_cast<size_t>(d) * 2) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(values) % 16 == 0;
  if (tma) {
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(n)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(d) * 2};
    const cuuint32_t box[2] = {KS, WG_ROWS};
    const cuuint32_t unit[2] = {1, 1};
    if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(values), dims,
               strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  flags |= (tma ? F_TMA : 0) | (resident ? F_RESIDENT : 0);
  const size_t smem = layout_for(slices, resident, stages).bytes;
  auto kernel = lanes_kernel<MODE, W>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((b + QN - 1) / QN, n / tile_n);
  kernel<<<grid, THREADS, smem, stream>>>(
      map, static_cast<const uint16_t*>(values), static_cast<const uint8_t*>(q_img), qsq,
      sqnorms, valid, out_s, out_i, d, b, tile_n, metric, slices, stages, flags);
  return static_cast<int>(cudaGetLastError());
}

// launch<MODE, W> for a runtime W in 1-3 (FIRST keeps no lists: W 1).
template <int MODE>
int launch_w(int winners, const void* values, const void* q_img, const float* qsq,
             const float* sqnorms, const uint8_t* valid, float* out_s, int* out_i, int n,
             int d, int b, int tile_n, int metric, int flags, cudaStream_t stream) {
  if constexpr (MODE == FIRST) {
    return launch<MODE, 1>(values, q_img, qsq, sqnorms, valid, out_s, out_i, n, d, b, tile_n,
                           metric, flags, stream);
  } else {
    switch (winners) {
      case 1: return launch<MODE, 1>(values, q_img, qsq, sqnorms, valid, out_s, out_i, n, d,
                                     b, tile_n, metric, flags, stream);
      case 2: return launch<MODE, 2>(values, q_img, qsq, sqnorms, valid, out_s, out_i, n, d,
                                     b, tile_n, metric, flags, stream);
      case 3: return launch<MODE, 3>(values, q_img, qsq, sqnorms, valid, out_s, out_i, n, d,
                                     b, tile_n, metric, flags, stream);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
}

}  // namespace scan_mma
}  // namespace
