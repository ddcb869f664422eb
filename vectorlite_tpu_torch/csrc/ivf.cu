// IVF partition-probe scores for Hopper (sm_90a).
//
//   gather_score (K6) replaces vectorlite_tpu/kernels/ivf.py:290
//                _gather_score_kernel:
//                out[b, l, p] = sum_d q[b, d] * rows[ids[b, l] * P + p, d],
//                accumulated in f32.
//
// rows is the partition-contiguous [C * P, D] layout, bf16 or int8; ids
// [B, L] int32 names the partition each query probes; q [B, D] is f32 and
// already holds what the reference contracts: for bf16 rows the query
// rounded to bf16 (so every product is exact in f32), for int8 rows the f32
// query itself, each int8 element cast to f32. The per-row int8 scales, the
// metric's surrogate and the validity mask stay outside, as in the
// reference.
//
// Bound at the smoke's IVF shape (C = 4096, P = 640, D = 384, B = 64,
// L = 16), H100 SXM data-sheet rate at 700 W: the kernel must read every
// probed [P, D] block, 0.49 MB of bf16 each; if each (query, probe) block is
// read once, as the TPU kernel DMAs it, that is B*L*P*D*2 = 503 MB, 0.150 ms
// at 3.35 TB/s (int8: 252 MB, 0.075 ms), against 0.5 GFLOP of f32 FMAs
// (negligible). chip_smoke.py computes the bound from its run's own ids
// (distinct probed blocks, each read once).
//
// What the design does about it: one block per (query, probe) pair holds
// the query in shared memory as f32; each of its eight warps walks rows of
// the partition, four rows at a time, each lane reading 16 bytes of a row
// per load (8 bf16 or 16 int8 values), so a warp streams whole rows
// coalesced and keeps four independent loads in flight per lane. The f32
// sums are reduced with shuffles and lane 0 writes the row's score. Rows
// whose byte width is not a multiple of 16 (or an unaligned base) load one
// element a lane. The grid is B * L blocks: 1,024 at the smoke's shape,
// about one wave of eight blocks on each of the 132 SMs. Queries that probe
// the same cell read its block again (from L2 when it is still there); a
// wgmma over the queries that share a cell is later work.
//
// The C entry launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // eight warps
constexpr int ROWS = 4;       // rows a warp scores at once

__device__ __forceinline__ float bf16_bits_to_float(uint32_t h) {
  return __uint_as_float(h << 16);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The dot of one 16-byte word of a row with the matching query values.
template <bool INT8>
__device__ __forceinline__ float dot16(const uint4 w, const float* q) {
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
  float acc = 0.0f;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (INT8) {
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const float v = static_cast<float>(static_cast<int8_t>((words[t] >> (8 * s)) & 0xFFu));
        acc = fmaf(v, q[4 * t + s], acc);
      }
    } else {
      acc = fmaf(bf16_bits_to_float(words[t] & 0xFFFFu), q[2 * t], acc);
      acc = fmaf(bf16_bits_to_float(words[t] >> 16), q[2 * t + 1], acc);
    }
  }
  return acc;
}

template <bool INT8>
__device__ __forceinline__ float element(const void* rows, size_t i) {
  if (INT8) return static_cast<float>(static_cast<const int8_t*>(rows)[i]);
  return bf16_bits_to_float(static_cast<const uint16_t*>(rows)[i]);
}

template <bool INT8>
__global__ void __launch_bounds__(THREADS)
gather_score_kernel(const void* __restrict__ rows,   // [C * P, D] bf16 bits or int8
                    const int* __restrict__ ids,     // [B, L]
                    const float* __restrict__ q,     // [B, D]
                    float* __restrict__ out,         // [B, L, P]
                    int l_probe, int p_width, int d, int vec16) {
  extern __shared__ float q_s[];  // [d]
  const int l = blockIdx.x;
  const int b = blockIdx.y;
  for (int i = threadIdx.x; i < d; i += THREADS) q_s[i] = q[static_cast<size_t>(b) * d + i];
  __syncthreads();

  constexpr int ELEM = INT8 ? 1 : 2;       // bytes an element
  constexpr int PER_WORD = 16 / ELEM;      // elements a 16-byte load
  const size_t block0 =
      static_cast<size_t>(ids[static_cast<size_t>(b) * l_probe + l]) * p_width;
  float* o = out + (static_cast<size_t>(b) * l_probe + l) * p_width;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const char* base = static_cast<const char*>(rows);

  for (int p0 = warp * ROWS; p0 < p_width; p0 += (THREADS / 32) * ROWS) {
    float acc[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r] = 0.0f;
    if (vec16) {
      const int words = d / PER_WORD;
      for (int w = lane; w < words; w += 32) {
        uint4 v[ROWS];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          v[r] = make_uint4(0u, 0u, 0u, 0u);
          if (p0 + r < p_width) {
            const uint4* row = reinterpret_cast<const uint4*>(
                base + (block0 + p0 + r) * static_cast<size_t>(d) * ELEM);
            v[r] = __ldg(row + w);
          }
        }
        const float* qw = q_s + w * PER_WORD;
#pragma unroll
        for (int r = 0; r < ROWS; ++r) acc[r] += dot16<INT8>(v[r], qw);
      }
    } else {
      for (int i = lane; i < d; i += 32) {
        const float qi = q_s[i];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          if (p0 + r < p_width) {
            acc[r] = fmaf(element<INT8>(rows, (block0 + p0 + r) * static_cast<size_t>(d) + i),
                          qi, acc[r]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float s = warp_sum(acc[r]);
      if (lane == 0 && p0 + r < p_width) o[p0 + r] = s;
    }
  }
}

}  // namespace

extern "C" {

// rows: [c * p_width, d] bf16 (int8 = 0) or int8 (int8 = 1); ids: [b, l]
// int32 in [0, c); q: [b, d] f32; out: [b, l, p_width] f32.
int gather_score(const void* rows, const void* ids, const void* q, void* out,
                 int int8, int b, int l_probe, int p_width, int d,
                 cudaStream_t stream) {
  if (b <= 0 || l_probe <= 0 || p_width <= 0 || d <= 0 || b > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(d) * sizeof(float);
  const size_t row_bytes = static_cast<size_t>(d) * (int8 ? 1 : 2);
  const int vec16 = (row_bytes % 16 == 0) && (reinterpret_cast<uintptr_t>(rows) % 16 == 0);
  const dim3 grid(l_probe, b);
  if (int8) {
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(gather_score_kernel<true>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    gather_score_kernel<true><<<grid, THREADS, smem, stream>>>(
        rows, static_cast<const int*>(ids), static_cast<const float*>(q),
        static_cast<float*>(out), l_probe, p_width, d, vec16);
  } else {
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(gather_score_kernel<false>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    gather_score_kernel<false><<<grid, THREADS, smem, stream>>>(
        rows, static_cast<const int*>(ids), static_cast<const float*>(q),
        static_cast<float*>(out), l_probe, p_width, d, vec16);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
