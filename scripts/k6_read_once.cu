// A probe, not part of the package: K6 (vectorlite_tpu_torch/csrc/ivf.cu
// gather_score) in the form that streams each probed cell once per batch.
// scripts/probe_k6_read_once.py builds it and times it beside K6.
//
//   out[b, l, p] = sum_d q[b, d] * rows[ids[b, l] * P + p, d], in f32,
//
// with the operands of gather_score (bf16 or int8 cell-contiguous rows,
// [B, L] int32 cell ids, the [B, D] f32 query operand).
//
// One block per (query, probe) pair, one launch a batch. Every block reads
// the batch's ids (4 KB at B 64 x L 16; one load of up to 16 ids a thread,
// a bit each) and finds the k pairs that probe its cell and its own rank j
// among them; the k blocks of a cell split its work as G query groups x S
// row slabs (G = ceil(k / QG), S = floor(k / G), QG the queries a block
// stages: 8 at D = 384): block j scores its slab of rows for its group's
// queries, each row word loaded and converted to f32 once and dotted with
// every staged query, each result written to its own out[b', l', :]; the
// k - G * S blocks left over exit. A block so does the work of about one
// pair whatever the sharing, a cell's rows are read from DRAM once, and L2
// serves each row G times instead of k. A cell with one prober is the
// pair's own block streaming its whole cell as K6 does. Batches of more
// than 4,096 pairs, or rows of more than 4 words a lane, score their own
// pair.
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
constexpr int MAX_QG = 8;     // queries a block stages for a shared cell
constexpr int MAX_SHARING_PAIRS = 4096;  // pairs up to which blocks find their cell's probers
constexpr int PER_THREAD = MAX_SHARING_PAIRS / THREADS;  // ids a thread scans, a bit each
constexpr int Q_BUDGET = MAX_QG * 384 * 4;  // bytes of staged queries

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

// One 16-byte word of a row as f32 values (8 bf16 or 16 int8).
template <bool INT8>
__device__ __forceinline__ void unpack16(const uint4 w, float (&x)[INT8 ? 16 : 8]) {
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (INT8) {
#pragma unroll
      for (int s = 0; s < 4; ++s) x[4 * t + s] = int8_to_float(words[t] ^ 0x80808080u, s);
    } else {
      x[2 * t] = bf16_bits_to_float(words[t] & 0xFFFFu);
      x[2 * t + 1] = bf16_bits_to_float(words[t] >> 16);
    }
  }
}

template <bool INT8>
__device__ __forceinline__ float element(const void* rows, size_t i) {
  if (INT8) return static_cast<float>(static_cast<const int8_t*>(rows)[i]);
  return bf16_bits_to_float(static_cast<const uint16_t*>(rows)[i]);
}

// Block-wide exclusive prefix sum of one int a thread; *total gets the sum.
// scratch: WARPS + 1 ints of shared memory.
__device__ __forceinline__ int block_exclusive_sum(int v, int* scratch, int* total) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < WARPS ? scratch[lane] : 0;
#pragma unroll
    for (int off = 1; off < WARPS; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += y;
    }
    if (lane < WARPS) scratch[lane] = w;  // inclusive warp totals
  }
  __syncthreads();
  const int before = (warp > 0 ? scratch[warp - 1] : 0) + x - v;
  *total = scratch[WARPS - 1];
  __syncthreads();  // scratch is free again
  return before;
}

template <bool INT8>
__global__ void __launch_bounds__(THREADS)
gather_score_kernel(const void* __restrict__ rows,   // [C * P, D] bf16 bits or int8
                    const int* __restrict__ ids,     // [B, L]
                    const float* __restrict__ q,     // [B, D]
                    float* __restrict__ out,         // [B, L, P]
                    int n_pairs, int l_probe, int p_width, int d, int lr, int qg_max,
                    int share) {
  extern __shared__ __align__(16) float q_s[];  // [qg_max][d], then the group's pairs
  int* group = reinterpret_cast<int*>(q_s + static_cast<size_t>(qg_max) * d);  // [qg_max]
  int* scratch = group + qg_max;                                               // [WARPS + 1]
  const int pair = blockIdx.y * l_probe + blockIdx.x;
  const int tid = threadIdx.x;

  // This block's share of its cell: the pairs of its query group and its
  // slab [r0, r1) of the cell's rows.
  int nq = 1, r0 = 0, r1 = p_width;
  if (share) {
    // one pass over the ids: bit t of `match` says whether pair lo + t
    // probes this block's cell
    const int mine = ids[pair];
    const int per = (n_pairs + THREADS - 1) / THREADS;  // <= PER_THREAD
    const int lo = min(n_pairs, tid * per), hi = min(n_pairs, lo + per);
    uint32_t match = 0;
#pragma unroll
    for (int t = 0; t < PER_THREAD; ++t) {
      if (lo + t < hi && ids[lo + t] == mine) match |= 1u << t;
    }
    int k;
    const int first = block_exclusive_sum(__popc(match), scratch, &k);  // list position of lo's match
    if (pair >= lo && pair < hi) scratch[WARPS] = first + __popc(match & ((1u << (pair - lo)) - 1));
    __syncthreads();
    const int j = scratch[WARPS];
    const int g_count = (k + qg_max - 1) / qg_max;
    const int s_count = k / g_count;
    if (j >= g_count * s_count) return;  // block-uniform: a leftover prober
    const int g = j / s_count, s = j % s_count;
    const int qlo = static_cast<int>(static_cast<long long>(g) * k / g_count);
    const int qhi = static_cast<int>(static_cast<long long>(g + 1) * k / g_count);
    nq = qhi - qlo;
    r0 = s * p_width / s_count;
    r1 = (s + 1) * p_width / s_count;
    int pos = first;
    for (uint32_t m = match; m != 0; m &= m - 1, ++pos) {
      if (pos >= qlo && pos < qhi) group[pos - qlo] = lo + __ffs(m) - 1;
    }
  } else if (tid == 0) {
    group[0] = pair;
  }
  __syncthreads();
  for (int i = tid; i < nq * d; i += THREADS) {
    const int e = i / d;
    q_s[i] = q[static_cast<size_t>(group[e] / l_probe) * d + (i - e * d)];
  }
  __syncthreads();

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const size_t row_bytes = static_cast<size_t>(d) * (INT8 ? 1 : 2);
  const size_t cell_row0 = static_cast<size_t>(ids[pair]) * p_width;

  if (lr == 0) {
    // plain path: a warp a row, one element a lane, the block's own pair
    float* o = out + static_cast<size_t>(pair) * p_width;
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

  if (nq > 1) {
    // a shared cell: each word of a slab row loaded and converted to f32
    // once, then dotted with every staged query (wpl <= WORDS, the host's
    // condition for sharing)
    for (int rw0 = r0 + warp * rpw; rw0 < r1; rw0 += WARPS * rpw) {
      const int r = rw0 + sub;
      const uint4* row = reinterpret_cast<const uint4*>(cell + r * row_bytes);
      uint4 v[WORDS];
#pragma unroll
      for (int u = 0; u < WORDS; ++u) {
        v[u] = make_uint4(0u, 0u, 0u, 0u);
        if (r < r1 && u < wpl) v[u] = __ldg(row + col + lr * u);
      }
      float acc[MAX_QG];
#pragma unroll
      for (int e = 0; e < MAX_QG; ++e) acc[e] = 0.0f;
#pragma unroll
      for (int u = 0; u < WORDS; ++u) {
        if (u < wpl) {
          float x[PER_WORD];
          unpack16<INT8>(v[u], x);
          const float4* qw = reinterpret_cast<const float4*>(q_s + (col + lr * u) * PER_WORD);
#pragma unroll
          for (int e = 0; e < MAX_QG; ++e) {
            if (e < nq) {
              const float4* qe = qw + e * (d / 4);
#pragma unroll
              for (int t = 0; t < PER_WORD / 4; ++t) {
                const float4 qq = qe[t];
                acc[e] = fmaf(x[4 * t], qq.x, acc[e]);
                acc[e] = fmaf(x[4 * t + 1], qq.y, acc[e]);
                acc[e] = fmaf(x[4 * t + 2], qq.z, acc[e]);
                acc[e] = fmaf(x[4 * t + 3], qq.w, acc[e]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int e = 0; e < MAX_QG; ++e) {
        if (e < nq) {
          for (int off = lr >> 1; off > 0; off >>= 1) {
            acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], off);
          }
          if (r < r1 && col == 0) out[static_cast<size_t>(group[e]) * p_width + r] = acc[e];
        }
      }
    }
    return;
  }

  // one query: the slab streamed with two row rounds of loads in flight
  float* o = out + static_cast<size_t>(group[0]) * p_width;
  for (int rw0 = r0 + warp * rpw * ROUNDS; rw0 < r1; rw0 += WARPS * rpw * ROUNDS) {
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
          if (r < r1 && c0 + u < wpl) v[rr][u] = __ldg(row + col + lr * (c0 + u));
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
      if (r < r1 && col == 0) o[r] = acc[rr];
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
  const int elem = INT8 ? 1 : 2;
  const int lr = lanes_for(rows, d, elem);
  const int n_pairs = b * l_probe;
  // blocks look for their cell's other probers when the batch's ids are few
  // enough to scan and a lane's part of a row fits its registers
  const int share = lr > 0 && n_pairs <= MAX_SHARING_PAIRS &&
                    static_cast<size_t>(d) * elem / 16 / lr <= WORDS;
  const int qg_max = share ? max(1, min(MAX_QG, Q_BUDGET / (d * 4))) : 1;
  const size_t smem = static_cast<size_t>(qg_max) * d * sizeof(float) +
                      static_cast<size_t>(qg_max + WARPS + 1) * sizeof(int);
  auto kernel = gather_score_kernel<INT8>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<dim3(l_probe, b), THREADS, smem, stream>>>(
      rows, static_cast<const int*>(ids), static_cast<const float*>(q),
      static_cast<float*>(out), n_pairs, l_probe, p_width, d, lr, qg_max, share);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// rows: [c * p_width, d] bf16 (int8 = 0) or int8 (int8 = 1); ids: [b, l]
// int32 in [0, c); q: [b, d] f32; out: [b, l, p_width] f32.
int gather_score_read_once(const void* rows, const void* ids, const void* q, void* out,
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
