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

// pq_rank (any kc <= 256; the 8-bit profile's kc = 256): look-ups. The
// one-hot form would do 16x the needed tensor work at kc = 256 (3.3 TFLOP a
// chunk, 3.3 ms), against ~0.9 ms of look-ups; the reference splits by kc
// the same way (pq.py:494-500). Each of the B*N*M look-ups is one
// shared-memory load and one f32 add, so the kernel is bound by
// shared-memory load throughput (one warp-wide load per SM clock). A block
// stages the LUT of a group of QG queries in shared memory as f32 (the group
// shrinks as kc grows) and walks 1024 rows, one row per thread: it reads
// the row's codes with 16-byte loads, decodes each byte once in registers
// and feeds QG running sums from it. The epilogue writes each query's rank
// row coalesced.
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

template <int N>
struct Acc {
  float v[N / 2];
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.b32 %0, 1, 0, P1;\n"
      "}\n" : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// A phase that has not completed after ~2^35 clocks (~20 s) never will:
// trap, so the launch fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - start > (1LL << 35)) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(PENDING) : "memory");
}

// Keeps a register's value in place up to this point: what a wgmma reads
// (its descriptors, its accumulator) is final before wgmma.fence.
__device__ __forceinline__ void hold(float& r) { asm volatile("" : "+f"(r) :: "memory"); }
__device__ __forceinline__ void hold(uint64_t& r) { asm volatile("" : "+l"(r) :: "memory"); }

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

__device__ __forceinline__ void wgmma_ss(Acc<8>& d, uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3"
      "}, %4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d.v[0]), "+f"(d.v[1]), "+f"(d.v[2]), "+f"(d.v[3])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_ss(Acc<16>& d, uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d.v[0]), "+f"(d.v[1]), "+f"(d.v[2]), "+f"(d.v[3]), "+f"(d.v[4]), "+f"(d.v[5]), "+f"(d.v[6]), "+f"(d.v[7])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_ss(Acc<32>& d, uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d.v[0]), "+f"(d.v[1]), "+f"(d.v[2]), "+f"(d.v[3]), "+f"(d.v[4]), "+f"(d.v[5]), "+f"(d.v[6]), "+f"(d.v[7]),
        "+f"(d.v[8]), "+f"(d.v[9]), "+f"(d.v[10]), "+f"(d.v[11]), "+f"(d.v[12]), "+f"(d.v[13]), "+f"(d.v[14]), "+f"(d.v[15])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_ss(Acc<64>& d, uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d.v[0]), "+f"(d.v[1]), "+f"(d.v[2]), "+f"(d.v[3]), "+f"(d.v[4]), "+f"(d.v[5]), "+f"(d.v[6]), "+f"(d.v[7]),
        "+f"(d.v[8]), "+f"(d.v[9]), "+f"(d.v[10]), "+f"(d.v[11]), "+f"(d.v[12]), "+f"(d.v[13]), "+f"(d.v[14]), "+f"(d.v[15]),
        "+f"(d.v[16]), "+f"(d.v[17]), "+f"(d.v[18]), "+f"(d.v[19]), "+f"(d.v[20]), "+f"(d.v[21]), "+f"(d.v[22]), "+f"(d.v[23]),
        "+f"(d.v[24]), "+f"(d.v[25]), "+f"(d.v[26]), "+f"(d.v[27]), "+f"(d.v[28]), "+f"(d.v[29]), "+f"(d.v[30]), "+f"(d.v[31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_ss(Acc<128>& d, uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d.v[0]), "+f"(d.v[1]), "+f"(d.v[2]), "+f"(d.v[3]), "+f"(d.v[4]), "+f"(d.v[5]), "+f"(d.v[6]), "+f"(d.v[7]),
        "+f"(d.v[8]), "+f"(d.v[9]), "+f"(d.v[10]), "+f"(d.v[11]), "+f"(d.v[12]), "+f"(d.v[13]), "+f"(d.v[14]), "+f"(d.v[15]),
        "+f"(d.v[16]), "+f"(d.v[17]), "+f"(d.v[18]), "+f"(d.v[19]), "+f"(d.v[20]), "+f"(d.v[21]), "+f"(d.v[22]), "+f"(d.v[23]),
        "+f"(d.v[24]), "+f"(d.v[25]), "+f"(d.v[26]), "+f"(d.v[27]), "+f"(d.v[28]), "+f"(d.v[29]), "+f"(d.v[30]), "+f"(d.v[31]),
        "+f"(d.v[32]), "+f"(d.v[33]), "+f"(d.v[34]), "+f"(d.v[35]), "+f"(d.v[36]), "+f"(d.v[37]), "+f"(d.v[38]), "+f"(d.v[39]),
        "+f"(d.v[40]), "+f"(d.v[41]), "+f"(d.v[42]), "+f"(d.v[43]), "+f"(d.v[44]), "+f"(d.v[45]), "+f"(d.v[46]), "+f"(d.v[47]),
        "+f"(d.v[48]), "+f"(d.v[49]), "+f"(d.v[50]), "+f"(d.v[51]), "+f"(d.v[52]), "+f"(d.v[53]), "+f"(d.v[54]), "+f"(d.v[55]),
        "+f"(d.v[56]), "+f"(d.v[57]), "+f"(d.v[58]), "+f"(d.v[59]), "+f"(d.v[60]), "+f"(d.v[61]), "+f"(d.v[62]), "+f"(d.v[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_ss(Acc<256>& d, uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d.v[0]), "+f"(d.v[1]), "+f"(d.v[2]), "+f"(d.v[3]), "+f"(d.v[4]), "+f"(d.v[5]), "+f"(d.v[6]), "+f"(d.v[7]),
        "+f"(d.v[8]), "+f"(d.v[9]), "+f"(d.v[10]), "+f"(d.v[11]), "+f"(d.v[12]), "+f"(d.v[13]), "+f"(d.v[14]), "+f"(d.v[15]),
        "+f"(d.v[16]), "+f"(d.v[17]), "+f"(d.v[18]), "+f"(d.v[19]), "+f"(d.v[20]), "+f"(d.v[21]), "+f"(d.v[22]), "+f"(d.v[23]),
        "+f"(d.v[24]), "+f"(d.v[25]), "+f"(d.v[26]), "+f"(d.v[27]), "+f"(d.v[28]), "+f"(d.v[29]), "+f"(d.v[30]), "+f"(d.v[31]),
        "+f"(d.v[32]), "+f"(d.v[33]), "+f"(d.v[34]), "+f"(d.v[35]), "+f"(d.v[36]), "+f"(d.v[37]), "+f"(d.v[38]), "+f"(d.v[39]),
        "+f"(d.v[40]), "+f"(d.v[41]), "+f"(d.v[42]), "+f"(d.v[43]), "+f"(d.v[44]), "+f"(d.v[45]), "+f"(d.v[46]), "+f"(d.v[47]),
        "+f"(d.v[48]), "+f"(d.v[49]), "+f"(d.v[50]), "+f"(d.v[51]), "+f"(d.v[52]), "+f"(d.v[53]), "+f"(d.v[54]), "+f"(d.v[55]),
        "+f"(d.v[56]), "+f"(d.v[57]), "+f"(d.v[58]), "+f"(d.v[59]), "+f"(d.v[60]), "+f"(d.v[61]), "+f"(d.v[62]), "+f"(d.v[63]),
        "+f"(d.v[64]), "+f"(d.v[65]), "+f"(d.v[66]), "+f"(d.v[67]), "+f"(d.v[68]), "+f"(d.v[69]), "+f"(d.v[70]), "+f"(d.v[71]),
        "+f"(d.v[72]), "+f"(d.v[73]), "+f"(d.v[74]), "+f"(d.v[75]), "+f"(d.v[76]), "+f"(d.v[77]), "+f"(d.v[78]), "+f"(d.v[79]),
        "+f"(d.v[80]), "+f"(d.v[81]), "+f"(d.v[82]), "+f"(d.v[83]), "+f"(d.v[84]), "+f"(d.v[85]), "+f"(d.v[86]), "+f"(d.v[87]),
        "+f"(d.v[88]), "+f"(d.v[89]), "+f"(d.v[90]), "+f"(d.v[91]), "+f"(d.v[92]), "+f"(d.v[93]), "+f"(d.v[94]), "+f"(d.v[95]),
        "+f"(d.v[96]), "+f"(d.v[97]), "+f"(d.v[98]), "+f"(d.v[99]), "+f"(d.v[100]), "+f"(d.v[101]), "+f"(d.v[102]), "+f"(d.v[103]),
        "+f"(d.v[104]), "+f"(d.v[105]), "+f"(d.v[106]), "+f"(d.v[107]), "+f"(d.v[108]), "+f"(d.v[109]), "+f"(d.v[110]), "+f"(d.v[111]),
        "+f"(d.v[112]), "+f"(d.v[113]), "+f"(d.v[114]), "+f"(d.v[115]), "+f"(d.v[116]), "+f"(d.v[117]), "+f"(d.v[118]), "+f"(d.v[119]),
        "+f"(d.v[120]), "+f"(d.v[121]), "+f"(d.v[122]), "+f"(d.v[123]), "+f"(d.v[124]), "+f"(d.v[125]), "+f"(d.v[126]), "+f"(d.v[127])
      : "l"(desc_a), "l"(desc_b), "r"(1));
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
