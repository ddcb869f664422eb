// PQ asymmetric-distance (ADC) selection rank for Hopper (sm_90a).
//
// Both entries replace vectorlite_tpu/kernels/pq.py:291 _pq_rank_kernel:
//
//   rank[b, n] = surrogate(sum_m LUT[b, m, code[n, m]], sq[n]),
//   -inf where valid[n] is 0.
//
// The LUT is the per-query [B, M, kc] lookup table rounded to bf16 (what the
// reference's selection contracts); the sum is taken in f32. Codes are
// uint8, either one code a byte ([N, M]) or, for 4-bit codes (kc = 16),
// two a byte ([N, M/2]: code 2j in the high nibble, 2j+1 in the low one).
// The surrogate is the reference's _rank_surrogate: adc * rsqrt(max(sq,
// 1e-30)) for cosine, adc - 0.5 * sq for euclidean, adc itself for dot and
// for manhattan (whose LUT the caller negated before the bf16 cast).
//
// pq_rank_mma (kc = 16, packed or unpacked): the reference's own form, the
// rank as a bf16 product of the LUT with a one-hot of the codes, on the
// tensor cores, with the one-hot never in memory.
//
//   Bound at the main-path shape (one 2^18-row chunk of a 2^20 x 384
//   corpus, M = 192 packed 4-bit codes, B = 256), H100 SXM data-sheet rates
//   at 700 W: 2*B*N*M*kc = 412 GFLOP at 989 TFLOP/s = 0.42 ms, against
//   0.09 ms for its bytes (25 MB of codes, the 1.57 MB LUT, the 268 MB f32
//   rank written once). chip_smoke.py prints the bound from its run's shapes.
//
//   Design. kc = 16 is the bf16 MMA depth, so one subspace is one k-step of
//   wgmma.m64nNk16: A is rows x 16 codes (the one-hot), B is 16 codes x N
//   queries (the subspace's LUT slice). Each thread builds the A fragment
//   of its two rows in registers from their codes: an entry is 1.0 (bf16
//   0x3F80) where the column equals the code, a handful of integer ops a
//   k-step against 128 tensor-core clocks of work at N = 256. Products are
//   exact (bf16 x 1.0) and each k-step has one nonzero product per (row,
//   query), so only the f32 accumulation order differs from the plain
//   version. A block is two consumer warpgroups (64 rows each, the whole
//   query tile of N <= 256 in one instruction: a 64 x 256 f32 accumulator
//   is 128 registers a thread) and one producer warp. The consumers first
//   copy the tile's codes (128 rows, 12 KB at M = 192 packed) into shared
//   memory; the producer streams the LUT with TMA bulk copies, G = 4
//   subspaces (32 KB at N = 256) a stage, into a ring of up to 6 stages on
//   mbarriers. The wrapper lays the LUT out as [query tile, M, N/8, 2, 8, 8]
//   so that a subspace's slice is one contiguous run in the core-matrix
//   order wgmma reads without swizzle. For each group of G subspaces a
//   warpgroup writes its fragments to its own A tiles in shared memory (2
//   KB a subspace, two sets alternating by group), fences them to the
//   async proxy, syncs its four warps and issues the G wgmmas with both
//   operands from shared memory; it waits for the previous group only, then
//   releases that group's stage. The one-hot never reaches device memory.
//   The form with A straight from registers (wgmma's register-A variant)
//   was built first and measured slower on an H100: the compiler fences
//   before each wgmma that reads fragments rebuilt in the loop. The
//   epilogue applies the surrogate and the mask and stages the tile through
//   shared memory as [query][row], so each query's 128 rows go out as 512
//   contiguous bytes.
//
//   L2 traffic. The LUT cannot stay resident (1.57 MB), so every 128-row
//   tile streams all of it: 2^18 / 128 x 1.57 MB = 3.2 GB from L2 a chunk,
//   58 GB/s into each SM at the tensor-core rate. Thread-block clusters of
//   two with each stage multicast to both blocks would halve that to 1.6 GB,
//   but a stage is then refilled only when both blocks' consumers have
//   released it. That form measured 1.48 ms a chunk against this one's 0.82
//   on an H100 80GB HBM3 at 700 W: L2 keeps up with the 3.2 GB, and the
//   shared release couples the two blocks' stalls, so blocks stream alone.
//
//   What holds it above the bound: each group of k-steps waits for its A
//   tiles to be built, written and fenced, and one block an SM leaves the
//   epilogue's stores unoverlapped with the tensor cores.
//
//   A tile's codes must fit beside two stages and the A tiles: at N = 256,
//   rows of more than ~1,040 code bytes (M > 2,080 packed) go to the
//   look-up entry instead; the wrapper decides (kernels/pq.py mma_fits).

// pq_rank (any kc <= 256; the 8-bit profile's kc = 256, and 4-bit rows too
// wide for pq_rank_mma): look-ups. The one-hot form would do 16x the
// needed tensor work at kc = 256 (3.3 TFLOP a chunk, 3.3 ms); the
// reference splits by kc the same way (pq.py:494-500).
//
//   Bound at the 8-bit path's shape (one 2^16-row chunk, M = 96, kc = 256,
//   B = 256): its bytes (6.3 MB of codes, the 12.6 MB LUT, the 67 MB rank)
//   take 0.026 ms at 3.35 TB/s, but each of its 1.61 G look-ups is a
//   shared-memory read of a bf16 entry: 3.2 GB at the SMs' ~29.6 TB/s (128
//   bytes a clock an SM x 132 SMs at 1.755 GHz) is ~0.11 ms, the bound the
//   design works against.
//
//   Design. The LUT stays bf16 in shared memory (its values are bf16; f32
//   would double its bytes), laid out by the wrapper per query tile of Q =
//   8 LPR queries as [m][table row][Q] (kernels/pq.py lookup_lut_operand):
//   one (subspace, code) entry of the tile's Q queries is 16 LPR contiguous
//   bytes, and LPR lanes share a row, each loading the 16 bytes of its 8
//   queries. A thread keeps RT rows x 8 queries of independent f32 sums (no
//   dependent chain through the M subspaces). A block is ROWS = 256 RT / LPR
//   rows of one query tile (LPR 4, RT 16: 1,024 rows of 32 queries, 128
//   sums a thread; 512 blocks at the 8-bit chunk, B 256): the producer
//   thread streams G subspaces of the tile's LUT a stage (4 unpacked, one
//   code word; 8 packed) by TMA bulk copies through a ring of mbarrier
//   stages, so each staged slice serves ROWS rows; the block's codes go to
//   shared memory a window of 12 code words (48 bytes) a row at a time,
//   4-byte loads, padded to an odd number of words a row so that the rows'
//   reads hit distinct banks.
//
//   Bank conflicts. The lanes of a row read one contiguous run, but the
//   rows of a quarter-warp (8 / LPR of them) read entries at random codes:
//   two collide when their codes agree mod 8 / LPR. LPR 1 (Q 8) has 8 rows
//   a quarter-warp and the most collisions; LPR 4 (Q 32) none beyond code
//   parity, but its 64 KB stages leave room for the codes of half the rows
//   (1,024 a block against 2,048 at LPR 1 and 2), so it streams the LUT
//   from L2 twice as often. LPR 4 measured fastest of 1, 2 and 4 on an H100
//   at the 8-bit path's chunk (scripts/probe_pq_lookup.py builds the
//   others by editing LPR and RT).
//
//   Codes at or above kc add 0: the wrapper zero-fills the table to 256
//   rows (16 for packed 4-bit codes), and subspaces past M to a whole stage.

// Each C entry launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int SMEM_MAX = 232448;         // Hopper's per-block shared-memory limit

enum Metric { METRIC_COSINE = 0, METRIC_EUCLIDEAN = 1, METRIC_DOT = 2, METRIC_MANHATTAN = 3 };

// ---------------------------------------------------------------- pq_rank

namespace lookup {

constexpr int THREADS = 256;
constexpr int CW = 12;            // code words of a row a window holds
constexpr int CSTRIDE = CW + 1;   // words a row in shared memory: odd
constexpr int MAX_STAGES = 4;
constexpr int LPR = 4;            // lanes a row (the wrapper reads Q: pq_rank_queries)
constexpr int RT = 16;            // rows a thread: 8 RT f32 sums

// Table rows and subspaces a stage (one code word): unpacked codes index
// 256 rows, 4 a word; packed 4-bit codes 16 rows, 8 a word.
template <bool PACKED>
struct Codes {
  static constexpr int T = PACKED ? 16 : 256;
  static constexpr int G = PACKED ? 8 : 4;
};

template <bool PACKED>
struct Cfg {
  static constexpr int Q = 8 * LPR;               // queries a tile
  static constexpr int SLOTS = THREADS / LPR;     // rows in flight
  static constexpr int ROWS = SLOTS * RT;         // rows a block
  static constexpr int STAGE = Codes<PACKED>::G * Codes<PACKED>::T * Q * 2;  // bytes
};

// Shared memory: the ring, the codes window, the barriers.
template <bool PACKED>
__host__ __device__ inline size_t smem_bytes(int stages) {
  using C = Cfg<PACKED>;
  return static_cast<size_t>(stages) * C::STAGE + static_cast<size_t>(C::ROWS) * CSTRIDE * 4 +
         8 * stages;
}

__device__ __forceinline__ void add8(float (&acc)[8], uint4 e) {
  const uint32_t u[4] = {e.x, e.y, e.z, e.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // a bf16 is the high half of its f32
    acc[2 * i] += __uint_as_float(u[i] << 16);
    acc[2 * i + 1] += __uint_as_float(u[i] & 0xFFFF0000u);
  }
}

template <bool PACKED>
__global__ void __launch_bounds__(THREADS, 1)
pq_lookup_kernel(const uint8_t* __restrict__ lut_t,   // [QT, m_pad, T, Q] bf16
                 const uint8_t* __restrict__ codes,   // [n, ms]
                 const float* __restrict__ sq,        // [n]
                 const uint8_t* __restrict__ valid,   // [n]
                 float* __restrict__ out,             // [b, n]
                 int n, int b, int m_pad, int ms, int metric, int stages, int words) {
  using C = Cfg<PACKED>;
  constexpr int T = Codes<PACKED>::T;
  constexpr int G = Codes<PACKED>::G;
  extern __shared__ __align__(128) uint8_t smem[];
  uint32_t* codes_s = reinterpret_cast<uint32_t*>(smem + static_cast<size_t>(stages) * C::STAGE);
  const uint32_t ring = smem_addr(smem);
  const uint32_t full0 = smem_addr(codes_s + C::ROWS * CSTRIDE);

  const int tid = threadIdx.x;
  const int slot = tid / LPR;
  const int part = tid % LPR;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * C::ROWS;
  const int qt = blockIdx.y;
  const int steps = m_pad / G;  // one code word each
  const uint8_t* src0 = lut_t + static_cast<size_t>(qt) * m_pad * T * C::Q * 2;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(full0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto issue = [&](int j) {
    const uint32_t bar = full0 + 8 * (j % stages);
    mbar_expect_tx(bar, C::STAGE);
    bulk_load(ring + (j % stages) * C::STAGE, src0 + static_cast<size_t>(j) * C::STAGE,
              C::STAGE, bar);
  };
  if (tid == 0)
    for (int j = 0; j < stages && j < steps; ++j) issue(j);

  float acc[RT][8];
#pragma unroll
  for (int k = 0; k < RT; ++k)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[k][e] = 0.0f;

  for (int j = 0; j < steps; ++j) {
    if (j % CW == 0) {
      // the next window of code words: words j .. j + CW - 1 of each row,
      // zero past the row and past n
      __syncthreads();
      for (int x = tid; x < C::ROWS * CW; x += THREADS) {
        const int r = x / CW;
        const int w = j + x % CW;
        const int64_t row = row0 + r;
        uint32_t v = 0;
        if (row < n) {
          const uint8_t* p = codes + row * ms + 4 * w;
          if (words) {
            if (4 * w < ms) v = __ldg(reinterpret_cast<const uint32_t*>(p));
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (4 * w + e < ms) v |= static_cast<uint32_t>(__ldg(p + e)) << (8 * e);
          }
        }
        codes_s[r * CSTRIDE + x % CW] = v;
      }
      __syncthreads();
    }
    mbar_wait(full0 + 8 * (j % stages), (j / stages) & 1);
    uint32_t cw[RT];
#pragma unroll
    for (int k = 0; k < RT; ++k) cw[k] = codes_s[(slot + C::SLOTS * k) * CSTRIDE + j % CW];
    const uint8_t* stage = smem + (j % stages) * C::STAGE + part * 16;
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const uint8_t* tab = stage + i * T * C::Q * 2;
#pragma unroll
      for (int k = 0; k < RT; ++k) {
        // packed: byte p holds subspace 2p in its high nibble, 2p + 1 in its low one
        const uint32_t code = PACKED ? (cw[k] >> (8 * (i >> 1) + ((i & 1) ? 0 : 4))) & 0xFu
                                     : (cw[k] >> (8 * i)) & 0xFFu;
        add8(acc[k], *reinterpret_cast<const uint4*>(tab + code * (C::Q * 2)));
      }
    }
    __syncthreads();  // every thread is done with stage j: refill it
    if (tid == 0 && j + stages < steps) issue(j + stages);
  }

#pragma unroll
  for (int k = 0; k < RT; ++k) {
    const int64_t r = row0 + slot + C::SLOTS * k;
    if (r >= n) continue;
    const float s = sq[r];
    const bool ok = valid[r] != 0;
    const float inv = rsqrtf(fmaxf(s, 1e-30f));
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int q = qt * C::Q + part * 8 + e;
      if (q >= b) break;
      float v = acc[k][e];
      if (metric == METRIC_COSINE) {
        v = v * inv;
      } else if (metric == METRIC_EUCLIDEAN) {
        v = v - 0.5f * s;
      }
      out[static_cast<size_t>(q) * n + r] = ok ? v : -CUDART_INF_F;
    }
  }
}

template <bool PACKED>
int launch(const void* lut_t, const void* codes, const void* sq, const void* valid, void* out,
           int n, int b, int m_pad, int ms, int metric, cudaStream_t stream) {
  using C = Cfg<PACKED>;
  if (m_pad % Codes<PACKED>::G) return static_cast<int>(cudaErrorInvalidValue);
  int stages = MAX_STAGES;
  while (stages >= 2 && smem_bytes<PACKED>(stages) > SMEM_MAX) --stages;
  if (stages < 2) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes<PACKED>(stages);
  auto kernel = pq_lookup_kernel<PACKED>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int words = (ms % 4 == 0) && (reinterpret_cast<uintptr_t>(codes) % 4 == 0);
  const dim3 grid((n + C::ROWS - 1) / C::ROWS, (b + C::Q - 1) / C::Q);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const uint8_t*>(lut_t), static_cast<const uint8_t*>(codes),
      static_cast<const float*>(sq), static_cast<const uint8_t*>(valid),
      static_cast<float*>(out), n, b, m_pad, ms, metric, stages, words);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace lookup

// ------------------------------------------------------------ pq_rank_mma

namespace mma {

constexpr int CONSUMERS = 256;            // two warpgroups: 128 rows
constexpr int THREADS = CONSUMERS + 32;   // and one producer warp
constexpr int ROWS = 128;
constexpr int G = 4;                      // subspaces a stage (k-steps)
constexpr int STAGES = 6;                 // ring stages at most
constexpr int OUT_STRIDE = ROWS + 4;      // floats a staged query row
constexpr int A_TILE = 64 * 16 * 2;       // bytes of a warpgroup's A tile, one subspace
constexpr int ABUF = 2 * 2 * G * A_TILE;  // two warpgroups, two sets each

// Shared-memory matrix descriptor of a K-major operand without swizzle, A
// (64 rows x 16 codes) or B (16 codes x N queries): core matrices of 8 rows
// (or queries) x 8 codes, 128 bytes each; the two 8-code halves 128 bytes
// apart (leading byte offset), groups of 8 rows 256 bytes apart (stride
// byte offset).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
       | (static_cast<uint64_t>(128 >> 4) << 16)
       | (static_cast<uint64_t>(256 >> 4) << 32);
}

// Byte offset of element (row r, code k) in an A tile, smem_desc's order.
__device__ __forceinline__ int a_offset(int r, int k) {
  return (r >> 3) * 256 + (k >> 3) * 128 + (r & 7) * 16 + (k & 7) * 2;
}

// bf16 bits of the one-hot pair (col, col + 1) of a row whose code is c:
// 1.0 in the half whose column equals the code (low half = lower column).
__device__ __forceinline__ uint32_t onehot2(uint32_t c, uint32_t col) {
  const uint32_t d = c - col;
  return d < 2u ? 0x3F80u << (d << 4) : 0u;
}

// The codes of one tile row for subspaces m0 .. m0 + 3 from the tile's
// codes in shared memory: packed, the two bytes m0/2, m0/2 + 1; unpacked,
// the four bytes m0 .. m0 + 3. `words`: the row is whole 16-bit (packed) or
// 32-bit (unpacked) words, so one load does; else byte by byte up to the
// row's end (the k-steps past M are never issued, so those codes are moot).
__device__ __forceinline__ uint32_t row_codes(const uint8_t* row, int m0, int ms, int packed,
                                              bool words) {
  const int b0 = packed ? m0 >> 1 : m0;
  if (words) {
    if (packed) return *reinterpret_cast<const uint16_t*>(row + b0);
    return *reinterpret_cast<const uint32_t*>(row + b0);
  }
  uint32_t x = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if ((!packed || k < 2) && b0 + k < ms) x |= static_cast<uint32_t>(row[b0 + k]) << (8 * k);
  }
  return x;
}

// Code i (0..3) of row_codes' word: packed, code 2k in the high nibble of
// byte k and 2k + 1 in the low one.
__device__ __forceinline__ uint32_t code_of(uint32_t w, int i, int packed) {
  if (packed) return (w >> (8 * (i >> 1) + ((i & 1) ? 0 : 4))) & 0xFu;
  return (w >> (8 * i)) & 0xFFu;
}

__device__ __forceinline__ void build_a(uint32_t (&a)[G][4], uint32_t lo, uint32_t hi,
                                        int packed, int t) {
#pragma unroll
  for (int i = 0; i < G; ++i) {
    const uint32_t cl = code_of(lo, i, packed);
    const uint32_t ch = code_of(hi, i, packed);
    a[i][0] = onehot2(cl, 2 * t);
    a[i][1] = onehot2(ch, 2 * t);
    a[i][2] = onehot2(cl, 2 * t + 8);
    a[i][3] = onehot2(ch, 2 * t + 8);
  }
}

// The consumers' own barrier (the producer warp keeps streaming).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(CONSUMERS) : "memory");
}

// Shared memory of a launch: the LUT ring, the tile's codes, the
// warpgroups' A tiles and the ring's barriers; the epilogue's [query][row]
// staging reuses the ring, the codes and the A tiles.
struct Layout {
  size_t abuf;    // offset of the warpgroups' one-hot A tiles
  size_t codes;   // offset of the codes tile
  size_t bars;    // offset of the 2 * stages barriers
  size_t bytes;   // dynamic shared memory
};

__host__ __device__ inline Layout layout_for(int n_tile, int ms, int stages) {
  Layout l;
  const size_t ring = static_cast<size_t>(stages) * G * n_tile * 32;
  l.codes = ring;
  const size_t staging = static_cast<size_t>(n_tile) * OUT_STRIDE * 4;
  l.abuf = (ring + static_cast<size_t>(ROWS) * ms + 127) / 128 * 128;
  const size_t end = l.abuf + ABUF;
  l.bars = ((end > staging ? end : staging) + 15) / 16 * 16;
  l.bytes = l.bars + 2 * stages * 8;
  return l;
}

template <int N>
__global__ void __launch_bounds__(THREADS, 1)
pq_rank_mma_kernel(const uint8_t* __restrict__ lut_t,   // [QT, M, N/8, 2, 8, 8] bf16
                   const uint8_t* __restrict__ codes,   // [n, ms]
                   const float* __restrict__ sq,        // [n]
                   const uint8_t* __restrict__ valid,   // [n]
                   float* __restrict__ out,             // [b, n]
                   int n, int b, int m, int ms, int packed, int metric, int stages) {
  constexpr int SLICE = N * 32;  // bytes of one subspace's B operand
  constexpr int STAGE = G * SLICE;
  extern __shared__ __align__(128) uint8_t smem[];
  const Layout lay = layout_for(N, ms, stages);
  const uint32_t ring = smem_addr(smem);
  const uint32_t full0 = smem_addr(smem + lay.bars);
  const uint32_t empty0 = full0 + stages * 8;
  uint8_t* codes_s = smem + lay.codes;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * ROWS;
  const int q0 = blockIdx.y * N;
  const int ngroups = (m + G - 1) / G;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMERS / 32) {
    // ---- producer: one thread streams the LUT slices through the ring
    if (lane == 0) {
      const uint8_t* src0 = lut_t + static_cast<size_t>(blockIdx.y) * m * SLICE;
      int s = 0;
      uint32_t phase = 0;
      for (int j = 0; j < ngroups; ++j) {
        if (j >= stages) mbar_wait(empty0 + 8 * s, phase ^ 1);
        const uint32_t bytes = static_cast<uint32_t>(min(G, m - j * G) * SLICE);
        mbar_expect_tx(full0 + 8 * s, bytes);
        bulk_load(ring + s * STAGE, src0 + static_cast<size_t>(j) * STAGE, bytes,
                  full0 + 8 * s);
        if (++s == stages) {
          s = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- consumers. The tile's codes first, rows past n as zeros.
    {
      const int live = static_cast<int>(max(int64_t{0}, min(static_cast<int64_t>(ROWS), n - row0)));
      const size_t bytes = static_cast<size_t>(live) * ms;
      const uint8_t* src = codes + row0 * ms;
      size_t i = 0;
      if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
        for (i = static_cast<size_t>(tid) * 16; i + 16 <= bytes; i += CONSUMERS * 16) {
          *reinterpret_cast<uint4*>(codes_s + i) = __ldg(reinterpret_cast<const uint4*>(src + i));
        }
        i = bytes / 16 * 16;
      }
      for (size_t k = i + tid; k < static_cast<size_t>(ROWS) * ms; k += CONSUMERS) {
        codes_s[k] = k < bytes ? __ldg(src + k) : 0;
      }
      consumers_sync();
    }
    // warpgroup wg owns rows 64 wg .. +63, its warp w rows 16 w .. +15, the
    // thread rows g and g + 8 of those
    const int g = lane >> 2;
    const int t = lane & 3;
    const int r_lo = (warp >> 2) * 64 + (warp & 3) * 16 + g;  // tile-local
    const int r_hi = r_lo + 8;

    Acc<N> acc;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc.v[i] = 0.0f;

    const bool words = (ms & (packed ? 1 : 3)) == 0;
    const uint8_t* row_lo = codes_s + r_lo * ms;
    const uint8_t* row_hi = codes_s + r_hi * ms;
    const int wg = warp >> 2;
    const int rl = (warp & 3) * 16 + g, rh = rl + 8;  // the thread's rows in its A tile
    const uint32_t abuf = smem_addr(smem + lay.abuf) + wg * 2 * G * A_TILE;
    int s = 0;
    uint32_t phase = 0;
    for (int j = 0; j < ngroups; ++j) {
      // The one-hot fragments, built in registers, to this warpgroup's A
      // tiles (64 rows x 16 codes a subspace, core-matrix order; two sets,
      // alternating by group: group j - 2, the last reader of this set, has
      // finished, as group j - 1's wait showed).
      uint32_t a[G][4];
      build_a(a, row_codes(row_lo, j * G, ms, packed, words),
              row_codes(row_hi, j * G, ms, packed, words), packed, t);
      uint8_t* at = smem + lay.abuf + (wg * 2 + (j & 1)) * G * A_TILE;
#pragma unroll
      for (int i = 0; i < G; ++i) {
        uint8_t* ti = at + i * A_TILE;
        *reinterpret_cast<uint32_t*>(ti + a_offset(rl, 2 * t)) = a[i][0];
        *reinterpret_cast<uint32_t*>(ti + a_offset(rh, 2 * t)) = a[i][1];
        *reinterpret_cast<uint32_t*>(ti + a_offset(rl, 2 * t + 8)) = a[i][2];
        *reinterpret_cast<uint32_t*>(ti + a_offset(rh, 2 * t + 8)) = a[i][3];
      }
      // visible to the tensor cores (the async proxy), and every warp's part
      // written, before the warpgroup's wgmmas read the tiles
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" :: "r"(2 + wg) : "memory");
      mbar_wait(full0 + 8 * s, phase);
      // descriptors and accumulator final before the fence: a register
      // written between the fence and a wgmma makes the compiler fence again
      uint64_t da[G], db[G];
#pragma unroll
      for (int i = 0; i < G; ++i) {
        da[i] = smem_desc(abuf + ((j & 1) * G + i) * A_TILE);
        db[i] = smem_desc(ring + s * STAGE + i * SLICE);
        hold(da[i]);
        hold(db[i]);
      }
#pragma unroll
      for (int i = 0; i < N / 2; ++i) hold(acc.v[i]);
      wgmma_fence();
#pragma unroll
      for (int i = 0; i < G; ++i) {
        if (j * G + i < m) wgmma_ss(acc, da[i], db[i]);
      }
      wgmma_commit();
      // group j - 1 has finished reading its stage: release it
      wgmma_wait<1>();
      if (j > 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty0 + 8 * (s == 0 ? stages - 1 : s - 1));
      }
      if (++s == stages) {
        s = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < N / 2; ++i) hold(acc.v[i]);

    // ---- epilogue: every stage has landed and been read, so the ring
    // holds the tile as [query][row] for coalesced stores along the rows
    consumers_sync();
    float* st = reinterpret_cast<float*>(smem);
    const int64_t gl = row0 + r_lo, gh = row0 + r_hi;
    const float sl = gl < n ? sq[gl] : 0.0f, sh = gh < n ? sq[gh] : 0.0f;
    const bool ok_l = gl < n && valid[gl] != 0, ok_h = gh < n && valid[gh] != 0;
    const float il = rsqrtf(fmaxf(sl, 1e-30f)), ih = rsqrtf(fmaxf(sh, 1e-30f));
    auto rank_of = [&](float v, float sqn, float inv, bool ok) {
      if (metric == METRIC_COSINE) {
        v = v * inv;
      } else if (metric == METRIC_EUCLIDEAN) {
        v = v - 0.5f * sqn;
      }
      return ok ? v : -CUDART_INF_F;
    };
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
      const int q = 8 * i + 2 * t;
      st[q * OUT_STRIDE + r_lo] = rank_of(acc.v[4 * i + 0], sl, il, ok_l);
      st[(q + 1) * OUT_STRIDE + r_lo] = rank_of(acc.v[4 * i + 1], sl, il, ok_l);
      st[q * OUT_STRIDE + r_hi] = rank_of(acc.v[4 * i + 2], sh, ih, ok_h);
      st[(q + 1) * OUT_STRIDE + r_hi] = rank_of(acc.v[4 * i + 3], sh, ih, ok_h);
    }
    consumers_sync();
    const int nq = min(N, b - q0);
    const bool vec = (n % 4) == 0;
    for (int idx = tid; idx < nq * (ROWS / 4); idx += CONSUMERS) {
      const int q = idx / (ROWS / 4);
      const int c = 4 * (idx % (ROWS / 4));
      const int64_t r = row0 + c;
      const float* src = st + q * OUT_STRIDE + c;
      float* dst = out + static_cast<size_t>(q0 + q) * n + r;
      if (vec) {
        if (r < n) *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
      } else {
        for (int e = 0; e < 4; ++e) {
          if (r + e < n) dst[e] = src[e];
        }
      }
    }
  }
}

// The most ring stages (at most STAGES, at least 2) that fit a block's
// shared memory beside the codes tile; 0 when two do not.
inline int stages_for(int n_tile, int ms) {
  for (int stages = STAGES; stages >= 2; --stages) {
    if (layout_for(n_tile, ms, stages).bytes <= SMEM_MAX) return stages;
  }
  return 0;
}

template <int N>
int launch(const void* lut_t, const void* codes, const void* sq, const void* valid, void* out,
           int n, int b, int m, int ms, int packed, int metric, cudaStream_t stream) {
  const int stages = stages_for(N, ms);
  if (stages == 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = layout_for(N, ms, stages).bytes;
  auto kernel = pq_rank_mma_kernel<N>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((n + ROWS - 1) / ROWS, (b + N - 1) / N);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const uint8_t*>(lut_t), static_cast<const uint8_t*>(codes),
      static_cast<const float*>(sq), static_cast<const uint8_t*>(valid), static_cast<float*>(out),
      n, b, m, ms, packed, metric, stages);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mma

}  // namespace

extern "C" {

// Queries a tile of pq_rank (8 LPR): the width the wrapper lays the LUT out
// at (kernels/pq.py lookup_query_tile), read from the library as built.
int pq_rank_queries() { return lookup::Cfg<false>::Q; }

// lut_t: the [b, m, kc] bf16 LUT laid out by the wrapper as [ceil(b / Q),
// m_pad, T, Q] (query tile of Q = 8 LPR = 32, subspace, table row, query),
// zero past b, kc and m (kernels/pq.py lookup_lut_operand); T = 16 for
// packed codes, else 256; m_pad a multiple of 8 (packed) or 4. codes: [n,
// ms] uint8, ms = m / 2 when packed (kc = 16), else m; sq: [n] f32; valid:
// [n] uint8 (bool); out: [b, n] f32. metric: 0 cosine, 1 euclidean, 2 dot,
// 3 manhattan.
int pq_rank(const void* lut_t, const void* codes, const void* sq, const void* valid,
            void* out, int n, int b, int m_pad, int ms, int packed, int metric,
            cudaStream_t stream) {
  if (n <= 0 || b <= 0 || m_pad <= 0 || ms <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (packed)
    return lookup::launch<true>(lut_t, codes, sq, valid, out, n, b, m_pad, ms, metric, stream);
  return lookup::launch<false>(lut_t, codes, sq, valid, out, n, b, m_pad, ms, metric, stream);
}

// lut_t: the [b, m, 16] bf16 LUT laid out by the wrapper as [ceil(b / nt),
// m, nt / 8, 2, 8, 8] (query tile, subspace, query group, code half, query,
// code), zero past b; codes: [n, ms] uint8, ms = m / 2 when packed, else m;
// sq: [n] f32; valid: [n] uint8 (bool); out: [b, n] f32. nt: queries a
// tile, 8, 16, 32, 64, 128 or 256.
int pq_rank_mma(const void* lut_t, const void* codes, const void* sq, const void* valid,
                void* out, int n, int b, int m, int ms, int packed, int metric, int nt,
                cudaStream_t stream) {
  if (n <= 0 || b <= 0 || m <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (packed ? 2 * ms != m : ms != m) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (nt) {
    case 256: return mma::launch<256>(lut_t, codes, sq, valid, out, n, b, m, ms, packed, metric, stream);
    case 128: return mma::launch<128>(lut_t, codes, sq, valid, out, n, b, m, ms, packed, metric, stream);
    case 64: return mma::launch<64>(lut_t, codes, sq, valid, out, n, b, m, ms, packed, metric, stream);
    case 32: return mma::launch<32>(lut_t, codes, sq, valid, out, n, b, m, ms, packed, metric, stream);
    case 16: return mma::launch<16>(lut_t, codes, sq, valid, out, n, b, m, ms, packed, metric, stream);
    case 8: return mma::launch<8>(lut_t, codes, sq, valid, out, n, b, m, ms, packed, metric, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
