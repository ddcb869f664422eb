// PQ asymmetric-distance (ADC) selection rank for Hopper (sm_90a).
//
//   pq_rank  (K5) replaces vectorlite_tpu/kernels/pq.py:291 _pq_rank_kernel:
//            rank[b, n] = surrogate(sum_m LUT[b, m, code[n, m]], sq[n]),
//            -inf where valid[n] is 0.
//
// The LUT is the per-query [B, M, kc] lookup table rounded to bf16 (what the
// reference's selection contracts); the sum is taken in f32. Codes are
// uint8, either one code a byte ([N, M]) or, for 4-bit codes (kc = 16),
// two a byte ([N, M/2]: code 2j in the high nibble, 2j+1 in the low one).
// The surrogate is the reference's _rank_surrogate: adc * rsqrt(max(sq,
// 1e-30)) for cosine, adc - 0.5 * sq for euclidean, adc itself for dot and
// for manhattan (whose LUT the caller negated before the bf16 cast).
//
// Bound at the main-path shape (one 2^18-row chunk of a 2^20 x 384 corpus,
// M = 192 packed 4-bit codes, B = 256), H100 SXM data-sheet rates at 700 W:
// the reference contracts the rank as a one-hot bf16 product, 2*B*N*M*kc =
// 412 GFLOP at 989 TFLOP/s = 0.42 ms, against 0.09 ms for its bytes (25 MB
// of codes, the LUT, and a 268 MB f32 rank written once). chip_smoke.py
// prints the bound from its run's shapes.
//
// What the design does about it: it does not expand the one-hot at all.
// Each of the B*N*M look-ups is one shared-memory load and one f32 add, so
// the kernel is bound by shared-memory load throughput (one warp-wide load
// per SM clock): B*N*M / (32 * 132 SMs * 1.755 GHz) = 1.7 ms a chunk,
// some 4x the one-hot bound. A block stages the LUT of a group of QG
// queries in shared memory as f32 (12 KB a query at M = 192, kc = 16; the
// group shrinks as kc grows so the kc = 256 opt-in fits) and walks 1024
// rows, one row per thread: it reads the row's codes with 16-byte loads,
// decodes each byte once in registers and feeds QG running sums from it.
// For kc = 16 the 16 entries of one subspace lie in 16 distinct banks, so
// the lanes of a warp never conflict. The epilogue writes each query's
// rank row coalesced. The one-hot bf16 mma / wgmma form that reaches the
// bound is later work.
//
// Each C entry launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;             // rows per pass, one per thread
constexpr int PASSES = 4;                // rows per block = 1024 (the reference's tile)
constexpr int ROWS_PER_BLOCK = THREADS * PASSES;
constexpr int MAX_QG = 8;                // queries per block
constexpr int LUT_BUDGET = 96 * 1024;    // f32 LUT bytes a block aims to stage
constexpr int SMEM_MAX = 232448;         // Hopper's per-block shared-memory limit

enum Metric { METRIC_COSINE = 0, METRIC_EUCLIDEAN = 1, METRIC_DOT = 2, METRIC_MANHATTAN = 3 };

__device__ __forceinline__ float bf16_bits_to_float(uint16_t h) {
  return __uint_as_float(static_cast<uint32_t>(h) << 16);
}

// One stored byte of column j: two 4-bit codes (subspaces 2j, 2j+1) or one
// code (subspace j). lut_s is [QG][m][kc] f32; table = m * kc.
template <int QG, bool PACKED>
__device__ __forceinline__ void add_byte(float (&acc)[QG], const float* lut_s,
                                         uint32_t byte, int j, int kc, int table) {
  if (PACKED) {
    const float* hi = lut_s + (2 * j) * 16 + (byte >> 4);
    const float* lo = lut_s + (2 * j + 1) * 16 + (byte & 0xFu);
#pragma unroll
    for (int q = 0; q < QG; ++q) {
      acc[q] += hi[q * table];
      acc[q] += lo[q * table];
    }
  } else {
    if (byte >= static_cast<uint32_t>(kc)) return;  // no centroid: adds 0
    const float* t = lut_s + j * kc + byte;
#pragma unroll
    for (int q = 0; q < QG; ++q) acc[q] += t[q * table];
  }
}

template <int QG, bool PACKED>
__global__ void __launch_bounds__(THREADS)
pq_rank_kernel(const uint16_t* __restrict__ lut,   // [B, M, kc] bf16 bits
               const uint8_t* __restrict__ codes,  // [N, ms]
               const float* __restrict__ sq,       // [N]
               const uint8_t* __restrict__ valid,  // [N]
               float* __restrict__ out,            // [B, N]
               int n, int b, int m, int kc, int ms, int metric, int vec16) {
  extern __shared__ float lut_s[];  // [QG][m][kc]
  const int table = m * kc;
  const int q0 = blockIdx.y * QG;
  const int nq = min(QG, b - q0);
  for (int i = threadIdx.x; i < QG * table; i += THREADS) {
    const int q = i / table;
    lut_s[i] = q < nq
        ? bf16_bits_to_float(lut[static_cast<size_t>(q0 + q) * table + (i - q * table)])
        : 0.0f;
  }
  __syncthreads();

  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * ROWS_PER_BLOCK;
  for (int p = 0; p < PASSES; ++p) {
    const int64_t r = row0 + p * THREADS + threadIdx.x;
    if (r >= n) break;
    float acc[QG];
#pragma unroll
    for (int q = 0; q < QG; ++q) acc[q] = 0.0f;
    const uint8_t* row = codes + r * ms;
    if (vec16) {
      const uint4* rv = reinterpret_cast<const uint4*>(row);
      for (int w = 0; w < ms / 16; ++w) {
        const uint4 v = __ldg(rv + w);
        const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int t = 0; t < 4; ++t) {
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            add_byte<QG, PACKED>(acc, lut_s, (words[t] >> (8 * s)) & 0xFFu,
                                 w * 16 + t * 4 + s, kc, table);
          }
        }
      }
    } else {
      for (int j = 0; j < ms; ++j) {
        add_byte<QG, PACKED>(acc, lut_s, __ldg(row + j), j, kc, table);
      }
    }
    const float s = sq[r];
    const bool ok = valid[r] != 0;
    const float inv = rsqrtf(fmaxf(s, 1e-30f));
#pragma unroll
    for (int q = 0; q < QG; ++q) {
      if (q >= nq) break;
      float v = acc[q];
      if (metric == METRIC_COSINE) {
        v = v * inv;
      } else if (metric == METRIC_EUCLIDEAN) {
        v = v - 0.5f * s;
      }
      out[static_cast<size_t>(q0 + q) * n + r] = ok ? v : -CUDART_INF_F;
    }
  }
}

template <int QG, bool PACKED>
int launch(const void* lut, const void* codes, const void* sq, const void* valid,
           void* out, int n, int b, int m, int kc, int ms, int metric,
           cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(QG) * m * kc * sizeof(float);
  auto kernel = pq_rank_kernel<QG, PACKED>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int vec16 = (ms % 16 == 0) && (reinterpret_cast<uintptr_t>(codes) % 16 == 0);
  const dim3 grid((n + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK, (b + QG - 1) / QG);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const uint16_t*>(lut), static_cast<const uint8_t*>(codes),
      static_cast<const float*>(sq), static_cast<const uint8_t*>(valid),
      static_cast<float*>(out), n, b, m, kc, ms, metric, vec16);
  return static_cast<int>(cudaGetLastError());
}

template <bool PACKED>
int launch_group(int qg, const void* lut, const void* codes, const void* sq,
                 const void* valid, void* out, int n, int b, int m, int kc, int ms,
                 int metric, cudaStream_t stream) {
  switch (qg) {
    case 8: return launch<8, PACKED>(lut, codes, sq, valid, out, n, b, m, kc, ms, metric, stream);
    case 4: return launch<4, PACKED>(lut, codes, sq, valid, out, n, b, m, kc, ms, metric, stream);
    case 2: return launch<2, PACKED>(lut, codes, sq, valid, out, n, b, m, kc, ms, metric, stream);
    default: return launch<1, PACKED>(lut, codes, sq, valid, out, n, b, m, kc, ms, metric, stream);
  }
}

// Queries a block stages: the most (up to 8, a power of two) whose f32
// LUTs fit LUT_BUDGET, at least one; 0 when one query's LUT exceeds the
// shared memory of a block.
int query_group(int m, int kc) {
  const long long table = static_cast<long long>(m) * kc * sizeof(float);
  if (table > SMEM_MAX) return 0;
  int qg = MAX_QG;
  while (qg > 1 && qg * table > LUT_BUDGET) qg /= 2;
  return qg;
}

}  // namespace

extern "C" {

// lut: [b, m, kc] bf16; codes: [n, ms] uint8 with ms = m / 2 when packed
// (kc = 16), else ms = m; sq: [n] f32; valid: [n] uint8 (bool);
// out: [b, n] f32. metric: 0 cosine, 1 euclidean, 2 dot, 3 manhattan.
int pq_rank(const void* lut, const void* codes, const void* sq, const void* valid,
            void* out, int n, int b, int m, int kc, int ms, int packed, int metric,
            cudaStream_t stream) {
  const int qg = query_group(m, kc);
  if (qg == 0 || n <= 0 || b <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (packed) {
    if (kc != 16 || 2 * ms != m) return static_cast<int>(cudaErrorInvalidValue);
    return launch_group<true>(qg, lut, codes, sq, valid, out, n, b, m, kc, ms, metric, stream);
  }
  if (ms != m || kc > 256) return static_cast<int>(cudaErrorInvalidValue);
  return launch_group<false>(qg, lut, codes, sq, valid, out, n, b, m, kc, ms, metric, stream);
}

}  // extern "C"
