// The CUDA-core body of the scan kernels for Hopper (sm_90a), shared by
// csrc/scan.cu and csrc/lanes.cu. What it still serves: K3 at W above 3
// over any rows (scan.cu scan_block_topw; the index's W is 2), and K7's merge
// pass (lanes.cu merge_partials, which takes lane_insert and the constants
// below). The rest runs elsewhere: K1 and K2 on the tensor-core body
// (scan_mma.cuh; past k 256 its scores into the radix select of
// csrc/select.cu), K3 at W 1-3 (bf16, int8 and f32 rows), K7 (bf16 and f32
// rows) and K8 on the tensor-core body too, K4 on the FADD stream of csrc/l1.cu
// (past k 32 its scores into the same radix select). A tiled f32
// contraction of a query block against a corpus tile (FMA dots), the
// similarity metric, the validity mask, and a per-lane-group top W that
// never leaves the block. Two translation units include it;
// kernels/_build.py hashes this header into each one's library key.
//
// What the design does about the scan's bound: every corpus element
// staged in shared memory feeds 64 queries and each thread keeps an 8x4
// register tile (32 FMAs for 6 shared-memory loads). Rows are loaded 16
// bytes at a time whatever their type and widened to f32 once, in shared
// memory, by the threads themselves (two block barriers a 32-wide step of
// D). Rows are read from device memory about once: the B/64 query blocks
// of one tile are adjacent in the grid and find the tile in L2. K3 gives
// each lane group's 32 rows to the 32 lanes of one warp, so its top-W is a
// butterfly of shuffles with no shared state. All of it runs on CUDA cores
// in f32.
//
// Ties: the order is (score descending, row ascending) everywhere, which
// is what the reference's k rounds of max + lowest-column argmax give for
// finite scores. Numbers: f32 only, IEEE division and sqrt (no fast
// math), never TF32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;       // 8 warps
constexpr int QB = 64;             // queries per block: 8 per warp
constexpr int RC = 128;            // corpus rows per chunk: 4 per lane
constexpr int DK = 32;             // contraction depth per staging step
constexpr int VS_STRIDE = RC + 1;  // odd stride: conflict-free transposed stores
constexpr int LANE_GROUPS = 128;   // K3: lane groups per tile
constexpr int MAX_GROUP_ROWS = 32; // K3: rows per lane group (tile <= 4096)
constexpr int MAX_WINNERS = 3;     // K7: the rungs of a list (its merge pass)

enum Metric { METRIC_COSINE = 0, METRIC_EUCLIDEAN = 1, METRIC_DOT = 2 };

// 16-byte loads of row elements, unpacked to f32 (exact for every type).
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void unpack(uint4 w, float* o) {
    o[0] = __uint_as_float(w.x);
    o[1] = __uint_as_float(w.y);
    o[2] = __uint_as_float(w.z);
    o[3] = __uint_as_float(w.w);
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack(uint4 w, float* o) {
    const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // a bf16 is the high half of its f32
      o[2 * e] = __uint_as_float(u[e] << 16);
      o[2 * e + 1] = __uint_as_float(u[e] & 0xffff0000u);
    }
  }
};
template <>
struct Vec<int8_t> {
  static constexpr int N = 16;
  __device__ static void unpack(uint4 w, float* o) {
    const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int j = 0; j < 4; ++j)  // sign-extend byte j
        o[4 * e + j] = static_cast<float>(static_cast<int>(u[e] << (24 - 8 * j)) >> 24);
  }
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(int8_t v) {
  return static_cast<float>(v);
}

// pallas_scan.py:74-89: cosine is 0 when |q||v| <= 0; euclidean clamps the
// expanded squared distance at 0.
__device__ __forceinline__ float apply_metric(float dot, float qsq, float sq,
                                              int metric) {
  if (metric == METRIC_COSINE) {
    float denom = sqrtf(qsq) * sqrtf(sq);
    return denom > 0.0f ? dot / fmaxf(denom, 1e-30f) : 0.0f;
  }
  if (metric == METRIC_EUCLIDEAN) {
    float d_sq = fmaxf(qsq + sq - 2.0f * dot, 0.0f);
    return 1.0f / (1.0f + sqrtf(d_sq));
  }
  return dot;
}

// (s1, r1) precedes (s2, r2): higher score first, lower row on ties.
__device__ __forceinline__ bool precedes(float s1, int r1, float s2, int r2) {
  return s1 > s2 || (s1 == s2 && r1 < r2);
}

// Insert (s, r) into the sorted list l_s/l_r (entry w at w * stride) of
// length `winners`, whose last entry s beats strictly. Entries that s does
// not beat strictly stay above it: rows arrive in ascending order, so the
// lower row stays first among equal scores.
__device__ __forceinline__ void lane_insert(float* l_s, int* l_r, int stride,
                                            int winners, float s, int r) {
  int p = winners - 1;
  while (p > 0 && s > l_s[(p - 1) * stride]) {
    l_s[p * stride] = l_s[(p - 1) * stride];
    l_r[p * stride] = l_r[(p - 1) * stride];
    --p;
  }
  l_s[p * stride] = s;
  l_r[p * stride] = r;
}

// K3's global row of chunk-local row r, or -1 past a short lane group:
// chunk c is lane groups 4c..4c+3, all rows of each; local row r = 32*g
// + j is row j of lane group 4c+g, i.e. tile row 4c+g+128j.
__device__ __forceinline__ long long chunk_row(long long tile_base, int c, int r,
                                               int group_rows) {
  const int j = r & 31;
  if (j >= group_rows) return -1;
  return tile_base + 4 * c + (r >> 5) + static_cast<long long>(LANE_GROUPS) * j;
}

// K3: each lane group's top W of every tile into [B, n_tiles, W*128],
// position w*128 + lane group.
template <typename T, bool SCALED>
__global__ void __launch_bounds__(THREADS, 2)
    scan_kernel(const float* __restrict__ q_t,      // [D, B] queries, transposed
                const float* __restrict__ qsq,      // [B]
                const T* __restrict__ values,       // [N, D]
                const float* __restrict__ scales,   // [N] (SCALED only)
                const float* __restrict__ sqnorms,  // [N]
                const uint8_t* __restrict__ valid,  // [N]
                float* __restrict__ out_s,          // [B, n_tiles, W*128]
                int* __restrict__ out_i,            // [B, n_tiles, W*128]
                int d, int b, int tile_n, int winners, int metric, bool vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);  // [DK][QB]
  float* vs = qs + DK * QB;                        // [DK][VS_STRIDE]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * QB;
  const int tile = blockIdx.y;
  const int n_tiles = gridDim.y;
  const long long tile_base = static_cast<long long>(tile) * tile_n;
  const int group_rows = tile_n / LANE_GROUPS;
  const int n_chunks = LANE_GROUPS / 4;
  const int n_out = winners * LANE_GROUPS;

  float my_qsq[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    int bq = q0 + warp * 8 + i;
    my_qsq[i] = bq < b ? qsq[bq] : 0.0f;
  }

  for (int c = 0; c < n_chunks; ++c) {
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) acc[i][jj] = 0.0f;

    for (int d0 = 0; d0 < d; d0 += DK) {
      // queries: [DK x QB] slab, coalesced along the (transposed) batch
#pragma unroll
      for (int t = 0; t < (DK * QB) / THREADS; ++t) {
        int idx = tid + THREADS * t;
        int dk = idx / QB;
        int qq = idx % QB;
        int dd = d0 + dk;
        int bq = q0 + qq;
        qs[dk * QB + qq] =
            (dd < d && bq < b) ? q_t[static_cast<size_t>(dd) * b + bq] : 0.0f;
      }
      // rows: [RC x DK] slab, coalesced along D, stored transposed
      if (vec) {  // 16-byte loads: D * sizeof(T) is a multiple of 16
        constexpr int EPV = Vec<T>::N;
        constexpr int WPR = DK / EPV;  // 16-byte words per slab row
#pragma unroll
        for (int t = 0; t < (RC * WPR) / THREADS; ++t) {
          int idx = tid + THREADS * t;
          int r = idx / WPR;
          int w = idx % WPR;
          int dd = d0 + w * EPV;
          long long row = chunk_row(tile_base, c, r, group_rows);
          float f[EPV];
          if (dd < d && row >= 0) {
            Vec<T>::unpack(*reinterpret_cast<const uint4*>(
                               values + static_cast<size_t>(row) * d + dd),
                           f);
          } else {
#pragma unroll
            for (int e = 0; e < EPV; ++e) f[e] = 0.0f;
          }
#pragma unroll
          for (int e = 0; e < EPV; ++e) vs[(w * EPV + e) * VS_STRIDE + r] = f[e];
        }
      } else {
#pragma unroll
        for (int t = 0; t < (DK * RC) / THREADS; ++t) {
          int idx = tid + THREADS * t;
          int r = idx / DK;
          int dk = idx % DK;
          int dd = d0 + dk;
          long long row = chunk_row(tile_base, c, r, group_rows);
          vs[dk * VS_STRIDE + r] =
              (dd < d && row >= 0)
                  ? to_f32(values[static_cast<size_t>(row) * d + dd])
                  : 0.0f;
        }
      }
      __syncthreads();
#pragma unroll 8
      for (int dk = 0; dk < DK; ++dk) {
        const float4 qa = *reinterpret_cast<const float4*>(&qs[dk * QB + warp * 8]);
        const float4 qb = *reinterpret_cast<const float4*>(&qs[dk * QB + warp * 8 + 4]);
        const float qv[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
        float vv[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) vv[jj] = vs[dk * VS_STRIDE + lane + 32 * jj];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) acc[i][jj] = fmaf(qv[i], vv[jj], acc[i][jj]);
      }
      __syncthreads();
    }

    // epilogue: metric + validity, in place
    long long rows[4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      long long row = chunk_row(tile_base, c, lane + 32 * jj, group_rows);
      rows[jj] = row;
      float sq = 0.0f, scl = 1.0f;
      bool ok = false;
      if (row >= 0) {
        sq = sqnorms[row];
        ok = valid[row] != 0;
        if (SCALED) scl = scales[row];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float dot = SCALED ? acc[i][jj] * scl : acc[i][jj];
        // every row scored, then the valid ones kept: no branch around the
        // metric's divisions
        const float score = apply_metric(dot, my_qsq[i], sq, metric);
        acc[i][jj] = ok ? score : -CUDART_INF_F;
      }
    }

    // lane j holds row j of lane groups 4c..4c+3: a butterfly over the
    // warp gives each group's best (score desc, lane asc); W rounds
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int lg = 4 * c + jj;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int bq = q0 + warp * 8 + i;
        float s = acc[i][jj];
        int key = rows[jj] >= 0 ? lane : MAX_GROUP_ROWS + lane;
        for (int w = 0; w < winners; ++w) {
          float bs = s;
          int bk = key;
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            float os = __shfl_xor_sync(0xffffffffu, bs, off);
            int ok2 = __shfl_xor_sync(0xffffffffu, bk, off);
            if (precedes(os, ok2, bs, bk)) {
              bs = os;
              bk = ok2;
            }
          }
          if (lane == 0 && bq < b) {
            size_t o = (static_cast<size_t>(bq) * n_tiles + tile) * n_out +
                       w * LANE_GROUPS + lg;
            out_s[o] = bs;
            out_i[o] = static_cast<int>(tile_base + lg +
                                        static_cast<long long>(LANE_GROUPS) *
                                            (bk & (MAX_GROUP_ROWS - 1)));
          }
          if (key == bk) {  // taken: rank below every remaining row
            s = -CUDART_INF_F;
            key = 2 * MAX_GROUP_ROWS + lane;
          }
        }
      }
    }
  }
}

template <typename T, bool SCALED>
int launch_topw(const float* q_t, const float* qsq, const void* values, const float* scales,
                const float* sqnorms, const uint8_t* valid, float* out_s, int* out_i, int n,
                int d, int b, int tile_n, int winners, int metric, cudaStream_t stream) {
  auto kernel = scan_kernel<T, SCALED>;
  const size_t smem = sizeof(float) * (DK * QB + DK * VS_STRIDE);
  const bool vec = (static_cast<size_t>(d) * sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(values) % 16 == 0;
  dim3 grid((b + QB - 1) / QB, n / tile_n);
  kernel<<<grid, THREADS, smem, stream>>>(q_t, qsq, static_cast<const T*>(values), scales,
                                          sqnorms, valid, out_s, out_i, d, b, tile_n, winners,
                                          metric, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
