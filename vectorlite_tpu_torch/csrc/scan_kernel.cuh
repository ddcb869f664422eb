// The CUDA-core body of the scan kernels for Hopper (sm_90a), shared by
// csrc/scan.cu and csrc/lanes.cu. What it still serves: K3 over f32 rows
// or W above 3 (scan_block_topw), K4 past k = 32 (scan_topk_l1, lists in
// shared memory or, past k 256, in the output) and K7 over f32 rows
// (lanes.cu scan_merge_topw). The rest runs elsewhere: K1 and K2 on the
// tensor-core body (scan_mma.cuh; past k 256 its scores into the radix
// select of csrc/select.cu), K3 over bf16 and int8 rows, K7 over bf16 rows
// and K8 on the tensor-core body too, K4 up to k = 32 on the FADD stream
// of csrc/l1.cu. A tiled f32 contraction of a query
// block against a corpus tile (FMA dots, or |q - v| sums for Manhattan),
// the similarity metric, the validity mask, and a selection that never
// leaves the block, chosen at compile time (`Select`). Two translation
// units build in parallel; kernels/_build.py hashes this header into each
// one's library key.
//
// What the design does about the scans' bounds: every corpus element
// staged in shared memory feeds 64 queries and each thread keeps an 8x4
// register tile (32 FMAs for 6 shared-memory loads). Rows are loaded 16
// bytes at a time whatever their type and widened to f32 once, in shared
// memory, by the threads themselves (two block barriers a 32-wide step of
// D). Rows are read from device memory about once: the B/64 query blocks
// of one tile are adjacent in the grid and find the tile in L2. Selection
// stays out of the row stream: K4 merges each 128-row chunk into a
// per-query sorted list (in shared memory up to SHARED_LIST_MAX, beyond
// that in the block's own slice of the output), inserting
// only rows that beat its k-th entry; K3 gives each lane group's 32 rows
// to the 32 lanes of one warp, so its top-W is a butterfly of shuffles with
// no shared state; K7 keeps each (query, lane group) list in shared
// memory, owned by one thread. All of it runs on CUDA cores in f32.
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
constexpr int SHARED_LIST_MAX = 256;  // K4: 64 lists of k <= 256 in 128 KB
constexpr int MAX_WINNERS = 3;     // K7: [3][64][128] (score, row) in 192 KB
constexpr int GSTRIDE = QB * LANE_GROUPS;  // K7: one rung of the lists

enum Metric { METRIC_COSINE = 0, METRIC_EUCLIDEAN = 1, METRIC_DOT = 2 };

// Selection of a block: K4 keeps each query's running top-k in
// shared memory (k <= SHARED_LIST_MAX) or in the block's rows of the
// output (any k); K3 keeps the top-W of each lane group. K7 keeps each
// (query, lane group)'s top W in shared memory (LANE_TOPW).
enum Select { LIST_SHARED = 1, LIST_GLOBAL = 2, LANE_GROUP_TOPW = 3, LANE_TOPW = 4 };

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

// Insert (cs, cr) into the sorted list ls/lr of length k, dropping the
// last entry. Every lane of the warp calls it with the same candidate.
__device__ void warp_insert(float* ls, int* lr, int k, float cs, int cr,
                            int lane) {
  int p = 0;
  for (int base = 0; base < k; base += 32) {
    int j = base + lane;
    bool before = j < k && precedes(ls[j], lr[j], cs, cr);
    p += __popc(__ballot_sync(0xffffffffu, before));
  }
  if (p >= k) return;
  // shift [p, k-1) up by one, highest group first
  for (int base = ((k - 1) / 32) * 32; base >= 0; base -= 32) {
    int j = base + lane;
    bool move = j > p && j < k;
    float s = 0.0f;
    int r = 0;
    if (move) {
      s = ls[j - 1];
      r = lr[j - 1];
    }
    __syncwarp();
    if (move) {
      ls[j] = s;
      lr[j] = r;
    }
    __syncwarp();
  }
  if (lane == 0) {
    ls[p] = cs;
    lr[p] = cr;
  }
  __syncwarp();
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

// K7's update of one (query, lane group) list in shared memory by a score
// that beats its last entry: out of line, since it is rare (about W ln(rows
// per lane group) times a list) and 32 inlined copies of it would swell the
// kernel.
__device__ __noinline__ void lane_update(float* l_s, int* l_r, int winners,
                                         float s, int r) {
  lane_insert(l_s, l_r, GSTRIDE, winners, s, r);
}

// Global row of chunk-local row r, or -1 past a short lane group.
// Exact scan: chunk c is rows [c*128, c*128+128) of the tile.
// Block scan: chunk c is lane groups 4c..4c+3, all rows of each; local
// row r = 32*g + j is row j of lane group 4c+g, i.e. tile row 4c+g+128j.
template <bool BLOCK>
__device__ __forceinline__ long long chunk_row(long long tile_base, int c,
                                               int r, int group_rows) {
  if (BLOCK) {
    int j = r & 31;
    if (j >= group_rows) return -1;
    return tile_base + 4 * c + (r >> 5) + static_cast<long long>(LANE_GROUPS) * j;
  }
  return tile_base + static_cast<long long>(c) * RC + r;
}

// L1: the contraction sums |q - v| (K4) and the score is 1 / (1 + sum);
// otherwise it is a dot product and `metric` applies. K7 writes [n_tiles,
// B, W*128] (tile-major) and names an empty slot by row 0.
template <typename T, bool SCALED, int SEL, bool L1>
__global__ void __launch_bounds__(THREADS, 2)
    scan_kernel(const float* __restrict__ q_t,      // [D, B] queries, transposed
                const float* __restrict__ qsq,      // [B]
                const T* __restrict__ values,       // [N, D]
                const float* __restrict__ scales,   // [N] (SCALED only)
                const float* __restrict__ sqnorms,  // [N] (not L1)
                const uint8_t* __restrict__ valid,  // [N]
                float* __restrict__ out_s,          // [B, n_tiles, n_out]
                int* __restrict__ out_i,            // [B, n_tiles, n_out]
                int d, int b, int k, int tile_n, int winners, int metric,
                bool vec) {
  constexpr bool BLOCK = SEL == LANE_GROUP_TOPW;
  constexpr bool LANE = SEL == LANE_TOPW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);  // [DK][QB]
  float* vs = qs + DK * QB;                        // [DK][VS_STRIDE]
  float* ls = vs + DK * VS_STRIDE;                 // [QB][k]   LIST_SHARED
  int* lr = reinterpret_cast<int*>(ls + QB * k);   // [QB][k]   LIST_SHARED
  // LANE: [W][QB][128] scores at ls, rows at gr
  int* gr = reinterpret_cast<int*>(ls + winners * GSTRIDE);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * QB;
  const int tile = blockIdx.y;
  const int n_tiles = gridDim.y;
  const long long tile_base = static_cast<long long>(tile) * tile_n;
  const int group_rows = tile_n / LANE_GROUPS;
  const int n_chunks = BLOCK ? LANE_GROUPS / 4 : tile_n / RC;
  const int n_out = BLOCK || LANE ? winners * LANE_GROUPS : k;

  float my_qsq[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    int bq = q0 + warp * 8 + i;
    my_qsq[i] = (!L1 && bq < b) ? qsq[bq] : 0.0f;
  }

  // LIST_SHARED / LIST_GLOBAL: query ql's list, in shared memory or in
  // its own row of the output
  auto list_s = [&](int ql) {
    return SEL == LIST_GLOBAL
               ? out_s + (static_cast<size_t>(q0 + ql) * n_tiles + tile) * k
               : ls + ql * k;
  };
  auto list_r = [&](int ql) {
    return SEL == LIST_GLOBAL
               ? out_i + (static_cast<size_t>(q0 + ql) * n_tiles + tile) * k
               : lr + ql * k;
  };
  if (SEL == LIST_SHARED || SEL == LIST_GLOBAL) {
    for (int i = 0; i < 8; ++i) {
      if (q0 + warp * 8 + i >= b) break;  // warp-uniform
      float* l_s = list_s(warp * 8 + i);
      int* l_r = list_r(warp * 8 + i);
      for (int j = lane; j < k; j += 32) {
        l_s[j] = -CUDART_INF_F;
        l_r[j] = 0x7fffffff;
      }
    }
    __syncwarp();
  }
  if (LANE) {  // each thread initialises the entries it owns
    for (int i = 0; i < 8; ++i)
      for (int jj = 0; jj < 4; ++jj)
        for (int w = 0; w < winners; ++w) {
          int o = w * GSTRIDE + (warp * 8 + i) * LANE_GROUPS + lane + 32 * jj;
          ls[o] = -CUDART_INF_F;
          gr[o] = 0;
        }
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
          long long row = chunk_row<BLOCK>(tile_base, c, r, group_rows);
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
          long long row = chunk_row<BLOCK>(tile_base, c, r, group_rows);
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
          for (int jj = 0; jj < 4; ++jj) {
            if (L1)
              acc[i][jj] += fabsf(qv[i] - vv[jj]);
            else
              acc[i][jj] = fmaf(qv[i], vv[jj], acc[i][jj]);
          }
      }
      __syncthreads();
    }

    // epilogue: metric + validity, in place
    long long rows[4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      long long row = chunk_row<BLOCK>(tile_base, c, lane + 32 * jj, group_rows);
      rows[jj] = row;
      float sq = 0.0f, scl = 1.0f;
      bool ok = false;
      if (row >= 0) {
        if (!L1) sq = sqnorms[row];
        ok = valid[row] != 0;
        if (SCALED) scl = scales[row];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float dot = SCALED ? acc[i][jj] * scl : acc[i][jj];
        float score = L1 ? 1.0f / (1.0f + dot) : apply_metric(dot, my_qsq[i], sq, metric);
        acc[i][jj] = ok ? score : -CUDART_INF_F;
      }
    }

    if (BLOCK) {
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
    } else if (LANE) {
      // lane j holds rows j + 32 jj of the chunk, i.e. of lane groups
      // j + 32 jj: each (query, lane group) list is this thread's alone
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float s = acc[i][jj];
          const int o = (warp * 8 + i) * LANE_GROUPS + lane + 32 * jj;
          if (s > ls[(winners - 1) * GSTRIDE + o])
            lane_update(ls + o, gr + o, winners, s, static_cast<int>(rows[jj]));
        }
      }
    } else {
      // merge the chunk into each query's running top-k; only rows that
      // beat the current k-th entry are inserted (chunk rows all exceed
      // the listed rows, so a tie with the k-th never enters)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int ql = warp * 8 + i;
        if (q0 + ql >= b) continue;  // warp-uniform
        float* l_s = list_s(ql);
        int* l_r = list_r(ql);
        float kth_s = l_s[k - 1];
        int kth_r = l_r[k - 1];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float s = acc[i][jj];
          const int row = static_cast<int>(rows[jj]);
          unsigned mask =
              __ballot_sync(0xffffffffu, precedes(s, row, kth_s, kth_r));
          while (mask) {
            int src = __ffs(mask) - 1;
            mask &= mask - 1;
            float cs = __shfl_sync(0xffffffffu, s, src);
            int cr = __shfl_sync(0xffffffffu, row, src);
            warp_insert(l_s, l_r, k, cs, cr, lane);
          }
          kth_s = l_s[k - 1];
          kth_r = l_r[k - 1];
        }
      }
    }
  }

  if (SEL == LIST_SHARED) {
    for (int i = 0; i < 8; ++i) {
      const int ql = warp * 8 + i;
      const int bq = q0 + ql;
      if (bq >= b) break;
      size_t o = (static_cast<size_t>(bq) * n_tiles + tile) * k;
      for (int j = lane; j < k; j += 32) {
        out_s[o + j] = ls[ql * k + j];
        out_i[o + j] = lr[ql * k + j];
      }
    }
  }
  if (LANE) {
    for (int i = 0; i < 8; ++i) {
      const int bq = q0 + warp * 8 + i;
      if (bq >= b) break;  // warp-uniform
      for (int jj = 0; jj < 4; ++jj) {
        const int lg = lane + 32 * jj;
        for (int w = 0; w < winners; ++w) {
          const int g = w * GSTRIDE + (warp * 8 + i) * LANE_GROUPS + lg;
          size_t o = (static_cast<size_t>(tile) * b + bq) * n_out + w * LANE_GROUPS + lg;
          out_s[o] = ls[g];
          out_i[o] = gr[g];
        }
      }
    }
  }
}

template <typename T, bool SCALED, int SEL, bool L1>
int launch_sel(const float* q_t, const float* qsq, const void* values,
               const float* scales, const float* sqnorms, const uint8_t* valid,
               float* out_s, int* out_i, int n, int d, int b, int k,
               int tile_n, int winners, int metric, cudaStream_t stream) {
  auto kernel = scan_kernel<T, SCALED, SEL, L1>;
  size_t smem = sizeof(float) * (DK * QB + DK * VS_STRIDE);
  if (SEL == LIST_SHARED)
    smem += static_cast<size_t>(QB) * k * (sizeof(float) + sizeof(int));
  if (SEL == LANE_TOPW)
    smem += static_cast<size_t>(winners) * QB * LANE_GROUPS * (sizeof(float) + sizeof(int));
  const bool vec = (static_cast<size_t>(d) * sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(values) % 16 == 0;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid((b + QB - 1) / QB, n / tile_n);
  kernel<<<grid, THREADS, smem, stream>>>(
      q_t, qsq, static_cast<const T*>(values), scales, sqnorms, valid, out_s,
      out_i, d, b, k, tile_n, winners, metric, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
