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
// L = 16), H100 SXM data-sheet rate at 700 W: every distinct probed cell
// read once, ~906 of the 1,024 (query, probe) pairs with random ids, 0.49
// MB of bf16 each: 446 MB, 0.133 ms at 3.35 TB/s (int8: half), against 0.5
// GFLOP of f32 FMAs (negligible). chip_smoke.py computes the bound from its
// run's own ids.
//
// Design. One block per (query, probe) pair, one launch a batch: the
// query in shared memory as f32, the probed cell streamed from global
// memory straight into registers. A row is read by LR lanes, LR the
// largest power of two up to 32 that divides its 16-byte words (16 for a
// bf16 row of D = 384: 48 words, 3 a lane; 8 for int8), so every lane
// loads in every round; a warp scores 32 / LR rows a round, loads two
// rounds at once (6 loads of 16 bytes a lane in flight at D = 384) and
// reduces each row with log2(LR) shuffles, not five. int8 elements become
// f32 by a byte permute and an add (full rate), not the quarter-rate
// integer conversion. Rows whose byte width is not a multiple of 16 (or an
// unaligned base) take a plain path: a warp a row, one element a lane.
//
// Cells probed by several pairs of the batch are read by each of them:
// most of the B * L blocks run at once, so a cell's later readers mostly
// find it in L2. Reading each probed cell once per batch (every block finds
// its cell's probers in the batch's ids, and the probers split the cell's
// rows and queries between them) is in scripts/k6_read_once.cu, and
// scripts/probe_k6_read_once.py times it beside this kernel. On an H100 it
// was no faster with shared or single-cell ids and slower on int8 rows:
// with DRAM and L2 traffic cut, every (row, query) pair still reads its
// query from shared memory, so a shared cell is bound there, as here. What
// would pay from about 20 queries a cell is a bf16 mma over the shared
// queries: at D = 384 a bf16 row is 768 bytes, and past ~20 queries its
// f32 FMAs on the CUDA cores (67 TFLOP/s) outlast its bytes from DRAM
// (3.35 TB/s). The batches IVF serves have ~1.1 probers a cell.
//
// No TMA ring: cells stream by direct 16-byte loads into registers.
// Staging row slabs through shared memory with cp.async.bulk on an mbarrier
// ring adds a shared-memory round trip and a block barrier a slab to a
// kernel that uses each row once; it has not been measured here.
//
// The C entry launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // eight warps
constexpr int WARPS = THREADS / 32;
constexpr int ROUNDS = 2;     // row rounds a warp loads at once
constexpr int WORDS = 4;      // 16-byte words a lane loads a row at once

__device__ __forceinline__ float bf16_bits_to_float(uint32_t h) {
  return __uint_as_float(h << 16);
}

// Byte s of an int8 word as f32, exactly, without the quarter-rate
// integer conversion: the byte flipped to x + 128 in the low mantissa of
// 2^23 is the float 2^23 + x + 128; subtracting 2^23 + 128 leaves x.
// `flipped` is the word XOR 0x80808080.
__device__ __forceinline__ float int8_to_float(uint32_t flipped, int s) {
  return __uint_as_float(__byte_perm(flipped, 0x4B000000u, 0x7540 + s)) - 8388736.0f;
}

// The dot of one 16-byte word of a row with the matching query values
// (16-byte aligned in shared memory).
template <bool INT8>
__device__ __forceinline__ float dot16(const uint4 w, const float* q) {
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
  const float4* q4 = reinterpret_cast<const float4*>(q);
  float acc = 0.0f;
  if (INT8) {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float4 qq = q4[t];
      const float qv[4] = {qq.x, qq.y, qq.z, qq.w};
      const uint32_t flipped = words[t] ^ 0x80808080u;
#pragma unroll
      for (int s = 0; s < 4; ++s) acc = fmaf(int8_to_float(flipped, s), qv[s], acc);
    }
  } else {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 qq = q4[h];
      acc = fmaf(bf16_bits_to_float(words[2 * h] & 0xFFFFu), qq.x, acc);
      acc = fmaf(bf16_bits_to_float(words[2 * h] >> 16), qq.y, acc);
      acc = fmaf(bf16_bits_to_float(words[2 * h + 1] & 0xFFFFu), qq.z, acc);
      acc = fmaf(bf16_bits_to_float(words[2 * h + 1] >> 16), qq.w, acc);
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
                    int l_probe, int p_width, int d, int lr) {
  extern __shared__ __align__(16) float q_s[];  // [d]
  const int pair = blockIdx.y * l_probe + blockIdx.x;
  for (int i = threadIdx.x; i < d; i += THREADS) q_s[i] = q[static_cast<size_t>(blockIdx.y) * d + i];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t row_bytes = static_cast<size_t>(d) * (INT8 ? 1 : 2);
  const size_t cell_row0 = static_cast<size_t>(ids[pair]) * p_width;
  float* o = out + static_cast<size_t>(pair) * p_width;

  if (lr == 0) {
    // plain path: a warp a row, one element a lane
    for (int p = warp; p < p_width; p += WARPS) {
      float acc = 0.0f;
      for (int e = lane; e < d; e += 32) {
        acc = fmaf(element<INT8>(rows, (cell_row0 + p) * d + e), q_s[e], acc);
      }
      for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) o[p] = acc;
    }
    return;
  }

  constexpr int PER_WORD = INT8 ? 16 : 8;  // elements a 16-byte word
  const unsigned char* cell = static_cast<const unsigned char*>(rows) + cell_row0 * row_bytes;
  const int wpl = static_cast<int>(row_bytes / 16) / lr;  // words a lane a row
  const int rpw = 32 / lr;                                // rows a warp round
  const int sub = lane / lr, col = lane % lr;
  for (int rw0 = warp * rpw * ROUNDS; rw0 < p_width; rw0 += WARPS * rpw * ROUNDS) {
    float acc[ROUNDS];
#pragma unroll
    for (int rr = 0; rr < ROUNDS; ++rr) acc[rr] = 0.0f;
    for (int c0 = 0; c0 < wpl; c0 += WORDS) {
      uint4 v[ROUNDS][WORDS];
#pragma unroll
      for (int rr = 0; rr < ROUNDS; ++rr) {
        const int r = rw0 + rr * rpw + sub;
        const uint4* row = reinterpret_cast<const uint4*>(cell + r * row_bytes);
#pragma unroll
        for (int u = 0; u < WORDS; ++u) {
          v[rr][u] = make_uint4(0u, 0u, 0u, 0u);
          if (r < p_width && c0 + u < wpl) v[rr][u] = __ldg(row + col + lr * (c0 + u));
        }
      }
#pragma unroll
      for (int u = 0; u < WORDS; ++u) {
        if (c0 + u < wpl) {
          const float* qc = q_s + (col + lr * (c0 + u)) * PER_WORD;
#pragma unroll
          for (int rr = 0; rr < ROUNDS; ++rr) acc[rr] += dot16<INT8>(v[rr][u], qc);
        }
      }
    }
#pragma unroll
    for (int rr = 0; rr < ROUNDS; ++rr) {
      for (int off = lr >> 1; off > 0; off >>= 1) {
        acc[rr] += __shfl_xor_sync(0xffffffffu, acc[rr], off);
      }
      const int r = rw0 + rr * rpw + sub;
      if (r < p_width && col == 0) o[r] = acc[rr];
    }
  }
}

// Lanes a row for the 16-byte path: the largest power of two up to 32 that
// divides the row's 16-byte words; 0 (the plain path) when rows are not
// whole words on a 16-byte aligned base.
int lanes_for(const void* rows, int d, int elem) {
  const size_t row_bytes = static_cast<size_t>(d) * elem;
  if (row_bytes % 16 != 0 || reinterpret_cast<uintptr_t>(rows) % 16 != 0) return 0;
  const int words = static_cast<int>(row_bytes / 16);
  int lr = 32;
  while (words % lr) lr >>= 1;
  return lr;
}

template <bool INT8>
int launch(const void* rows, const void* ids, const void* q, void* out, int b, int l_probe,
           int p_width, int d, cudaStream_t stream) {
  const int lr = lanes_for(rows, d, INT8 ? 1 : 2);
  const size_t smem = static_cast<size_t>(d) * sizeof(float);
  auto kernel = gather_score_kernel<INT8>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<dim3(l_probe, b), THREADS, smem, stream>>>(
      rows, static_cast<const int*>(ids), static_cast<const float*>(q),
      static_cast<float*>(out), l_probe, p_width, d, lr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// rows: [c * p_width, d] bf16 (int8 = 0) or int8 (int8 = 1); ids: [b, l]
// int32 in [0, c); q: [b, d] f32; out: [b, l, p_width] f32.
int gather_score(const void* rows, const void* ids, const void* q, void* out,
                 int int8, int b, int l_probe, int p_width, int d,
                 cudaStream_t stream) {
  if (b <= 0 || l_probe <= 0 || p_width <= 0 || d <= 0 || b > 65535 ||
      static_cast<long long>(b) * l_probe >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (int8) return launch<true>(rows, ids, q, out, b, l_probe, p_width, d, stream);
  return launch<false>(rows, ids, q, out, b, l_probe, p_width, d, stream);
}

}  // extern "C"
