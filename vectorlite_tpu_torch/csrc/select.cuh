// The radix select of a per-tile top-k for Hopper (sm_90a), over a group
// of tiles' [B, rows] f32 scores in a scratch buffer: one block of 1,024
// threads a (query, tile) writes tile_topk_plain's [B, n_tiles, k] slice
// of its tile, by (score descending, row ascending). Included by
// csrc/select.cu (K1 and K2 past k 256, on the tensor-core body's scores)
// and csrc/l1.cu (K4 past k 32, on the FADD stream's scores); its design
// and where its time goes are in select.cu's header.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {
namespace sel {

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int KEY_TILE = 32768;                // the largest tile whose keys stay in shared memory
constexpr int SMEM_MAX = 232448 - 1024;        // dynamic shared memory a block may take
constexpr int BINS = 256;                      // an 8-bit digit a pass
constexpr int SORT_REG_MAX = 8192;             // lists sorted in registers (8 entries a thread)
constexpr int SORT_MIN = 64;                   // the shortest network: one warp of pairs
constexpr int SORT_MAX = 32768;                // lists sorted in shared memory
constexpr int OFFSET_TILE = 1 << 16;           // 16-bit offsets in the tile
// where a block sorts its survivors: as 64-bit values in registers, by
// shuffles and (strides past a warp's) in shared memory; as (key, 16-bit
// offset) pairs in shared memory; in its slice of the output
enum Sort { SORT_REGS = 0, SORT_SHARED = 1, SORT_OUTPUT = 2 };
constexpr int HIST_BYTES = BINS * 32 * 4 + BINS * 4;  // a copy a lane, then the totals

// An order-preserving key: a larger score gives a larger key. -0 reads as
// +0 and every NaN as one NaN above +inf, as torch's descending sort
// orders them.
__device__ __forceinline__ uint32_t key_of(float x) {
  uint32_t u = __float_as_uint(x == 0.0f ? 0.0f : x);
  if (x != x) u = 0x7fc00000u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float score_of_key(uint32_t key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// The 64-bit sort value of (key, offset): unique a row, larger first.
__device__ __forceinline__ uint64_t sort_value(uint32_t key, uint32_t offset) {
  return (static_cast<uint64_t>(key) << 32) | static_cast<uint32_t>(~offset);
}

__device__ __forceinline__ uint64_t shfl_xor64(uint64_t x, int m) {
  const uint32_t lo = __shfl_xor_sync(FULL, static_cast<uint32_t>(x), m);
  const uint32_t hi = __shfl_xor_sync(FULL, static_cast<uint32_t>(x >> 32), m);
  return (static_cast<uint64_t>(hi) << 32) | lo;
}

// Pair p of a step of the bitonic network (size, stride = 2^ls): the
// flip (stride = size / 2) compares i with its mirror in its block of
// size, the half-cleaners i with i + stride; larger values go to i.
__device__ __forceinline__ void network_pair(int p, int size, int ls, int& i, int& l) {
  const int stride = 1 << ls;
  if (stride == size >> 1) {
    const int base = (p >> ls) * size;
    i = base + (p & (stride - 1));
    l = base + size - 1 - (p & (stride - 1));
  } else {
    i = ((p >> ls) << (ls + 1)) + (p & (stride - 1));
    l = i + stride;
  }
}

// Bitonic sort of n entries, larger values first, over a power-of-two
// network with the missing entries past n taken as smaller than any: a
// comparison that reaches past n leaves the entry below it where it is.
// Each size starts with the flip, then the half-cleaners; one barrier a
// step. For lists past SORT_REG_MAX.
template <typename Get, typename Put>
__device__ __forceinline__ void bitonic(int n, Get get, Put put) {
  int full = 1;
  while (full < n) full <<= 1;
  for (int size = 2; size <= full; size <<= 1) {
    for (int ls = __ffs(size) - 2; ls >= 0; --ls) {
      for (int p = threadIdx.x; p < full / 2; p += THREADS) {
        int i, l;
        network_pair(p, size, ls, i, l);
        if (l < n) {
          const uint64_t a = get(i), c = get(l);
          if (a < c) {
            put(i, c);
            put(l, a);
          }
        }
      }
      __syncthreads();
    }
  }
}

// A step of the network inside a thread's E entries (STRIDE < E <= 8):
// entry e against e ^ (2 STRIDE - 1) (the flip) or e ^ STRIDE, indices
// known at compile time so that the entries stay in registers.
template <int E, int STRIDE, bool FLIP>
__device__ __forceinline__ void thread_step(uint64_t (&v)[E]) {
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int pe = FLIP ? (e ^ (2 * STRIDE - 1)) : (e ^ STRIDE);
    if (e < pe && pe < E) {
      const uint64_t a = v[e], c = v[pe];
      v[e] = a > c ? a : c;
      v[pe] = a > c ? c : a;
    }
  }
}

// The same network over n_pow2 = E x (threads holding entries) 64-bit
// values in buf (zero past the list: smaller than any entry), thread t
// holding entries t E .. t E + E - 1 in registers. Strides under E run in
// the thread, up to 32 E by shuffles between the lanes of a warp (no
// barrier), past it in shared memory (store, a barrier a step, load).
// Leaves the sorted values in buf.
template <int E>
__device__ __forceinline__ void bitonic_regs(uint64_t* buf, int n_pow2) {
  const int tid = threadIdx.x;
  const int holders = n_pow2 / E;
  const bool live = (tid & ~31) < holders;  // warp-uniform: the warps that hold entries
  uint64_t v[E];
  if (live) {
#pragma unroll
    for (int e = 0; e < E; ++e) v[e] = tid < holders ? buf[tid * E + e] : 0ull;
  }
  for (int size = 2; size <= n_pow2; size <<= 1) {
    int ls = __ffs(size) - 2;
    if ((size >> 1) >= 32 * E) {
      // the strides past a warp's entries: in shared memory
      if (live && tid < holders) {
#pragma unroll
        for (int e = 0; e < E; ++e) buf[tid * E + e] = v[e];
      }
      __syncthreads();
      for (; (1 << ls) >= 32 * E; --ls) {
        for (int p = tid; p < n_pow2 / 2; p += THREADS) {
          int i, l;
          network_pair(p, size, ls, i, l);
          const uint64_t a = buf[i], c = buf[l];
          if (a < c) {
            buf[i] = c;
            buf[l] = a;
          }
        }
        __syncthreads();
      }
      if (live && tid < holders) {
#pragma unroll
        for (int e = 0; e < E; ++e) v[e] = buf[tid * E + e];
      }
    }
    if (!live) continue;
    for (; ls >= 0; --ls) {
      const int stride = 1 << ls;
      const bool flip = stride == size >> 1;
      if (stride >= E) {
        // partner lane t ^ m; the flip pairs entry e with the partner's
        // E - 1 - e; the lower thread keeps the larger value
        const int m = flip ? size / E - 1 : stride / E;
        const bool lower = (tid & (flip ? size / E / 2 : m)) == 0;
        auto keep = [&](uint64_t mine, uint64_t other) {
          return lower == (mine > other) ? mine : other;
        };
        if (flip) {
#pragma unroll
          for (int e = 0; e < E / 2; ++e) {
            const uint64_t a = v[e], c = v[E - 1 - e];
            const uint64_t pa = shfl_xor64(c, m), pc = shfl_xor64(a, m);
            v[e] = keep(a, pa);
            v[E - 1 - e] = keep(c, pc);
          }
        } else {
#pragma unroll
          for (int e = 0; e < E; ++e) v[e] = keep(v[e], shfl_xor64(v[e], m));
        }
      } else if (stride == 4) {
        flip ? thread_step<E, 4, true>(v) : thread_step<E, 4, false>(v);
      } else if (stride == 2) {
        flip ? thread_step<E, 2, true>(v) : thread_step<E, 2, false>(v);
      } else {
        flip ? thread_step<E, 1, true>(v) : thread_step<E, 1, false>(v);
      }
    }
  }
  if (live && tid < holders) {
#pragma unroll
    for (int e = 0; e < E; ++e) buf[tid * E + e] = v[e];
  }
  __syncthreads();
}

// A block: query q and tile tl of the group (blockIdx.x = q * tiles_g +
// tl), its T = tile_n scores at scores + q * ld + tl * T, into out_s/out_i
// [B, n_tiles, k] at tile first_tile + tl. SMEM_KEYS: the keys fit shared
// memory beside the work area (T <= KEY_TILE). sort: where the survivors
// are sorted (Sort).
template <bool SMEM_KEYS>
__global__ void __launch_bounds__(THREADS, 1)
select_kernel(const float* __restrict__ scores, long long ld, float* __restrict__ out_s,
              int* __restrict__ out_i, int tile_n, int k, int n_tiles, int first_tile,
              int tiles_g, int sort) {
  extern __shared__ __align__(16) uint8_t sel_smem[];
  __shared__ uint32_t st_prefix, st_mask, st_need, st_done;
  __shared__ uint32_t st_above[WARPS], st_equal[WARPS];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const uint32_t lower = (1u << lane) - 1u;
  const int q = blockIdx.x / tiles_g;
  const int tl = blockIdx.x - q * tiles_g;
  const int tile = first_tile + tl;
  const float* src = scores + q * ld + static_cast<long long>(tl) * tile_n;
  const size_t o = (static_cast<size_t>(q) * n_tiles + tile) * k;
  const int tile_base = tile * tile_n;  // the wrapper keeps rows below 2^31
  const int kpt = (tile_n + THREADS - 1) / THREADS;  // keys a thread
  const int seg = kpt * 32;                          // rows a warp

  // SMEM_KEYS: the tile's keys in shared memory, then the work area (the
  // histograms, later the survivors); else the work area alone, and the
  // keys read again from the scratch on every pass
  uint32_t* skeys = reinterpret_cast<uint32_t*>(sel_smem);
  uint8_t* work = sel_smem + (SMEM_KEYS ? (static_cast<size_t>(tile_n) * 4 + 15) / 16 * 16 : 0);
  if constexpr (SMEM_KEYS) {
#pragma unroll 8
    for (int i = tid; i < tile_n; i += THREADS) skeys[i] = key_of(src[i]);
  }
  // f(key, row, in) for each of the thread's keys in row order (in: the row
  // is in the tile); j < kpt is uniform over the block, so f may ballot
  auto for_keys = [&](auto&& f) {
#pragma unroll 4
    for (int j = 0; j < kpt; ++j) {
      const int r = warp * seg + j * 32 + lane;
      const bool in = r < tile_n;
      f(in ? (SMEM_KEYS ? skeys[r] : key_of(src[r])) : 0u, r, in);
    }
  };

  // the radix select: after each pass the digits found (prefix under mask)
  // and the rank still to take among the keys that carry them (the first
  // pass's barrier publishes the keys)
  uint32_t* hist = reinterpret_cast<uint32_t*>(work);  // [BINS][32]
  uint32_t* tot = hist + BINS * 32;                          // [BINS]
  if (tid == 0) {
    st_prefix = 0;
    st_mask = 0;
    st_need = static_cast<uint32_t>(k);
    st_done = 0;
  }
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = tid; i < BINS * 32; i += THREADS) hist[i] = 0;
    __syncthreads();
    const uint32_t prefix = st_prefix, mask = st_mask;
    for_keys([&](uint32_t key, int, bool in) {
      if (in && (key & mask) == prefix) atomicAdd(&hist[((key >> shift) & 0xFFu) * 32 + lane], 1u);
    });
    __syncthreads();
    if (tid < BINS) {
      uint32_t s = 0;
      for (int c = 0; c < 32; ++c) s += hist[tid * 32 + ((c + tid) & 31)];  // no bank conflict
      tot[tid] = s;
    }
    __syncthreads();
    if (warp == 0) {
      // lane l holds bins 255 - 8 l down to 248 - 8 l; above: the keys in
      // the bins over them
      const uint32_t need = st_need;
      uint32_t c[8];
      uint32_t sum = 0;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        c[e] = tot[255 - 8 * lane - e];
        sum += c[e];
      }
      uint32_t incl = sum;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const uint32_t v = __shfl_up_sync(FULL, incl, off);
        if (lane >= off) incl += v;
      }
      uint32_t above = incl - sum;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (above < need && above + c[e] >= need) {  // one bin of the block
          st_prefix = prefix | (static_cast<uint32_t>(255 - 8 * lane - e) << shift);
          st_mask = mask | (0xFFu << shift);
          st_need = need - above;
          st_done = above + c[e] == need;  // the whole bin is taken
        }
        above += c[e];
      }
    }
    __syncthreads();
    if (st_done) break;
  }

  // the survivors: every key over the prefix, and of those equal to it the
  // first `need` in row order. Each warp counts both kinds; a warp's first
  // survivor goes after those of the warps before it, the rest in row
  // order by ballots (no atomics: the survivors land in row order)
  const uint32_t prefix = st_prefix, mask = st_mask, need = st_need;
  uint32_t above_here = 0, equal_here = 0;
  for_keys([&](uint32_t key, int, bool in) {
    const uint32_t mk = key & mask;
    above_here += __popc(__ballot_sync(FULL, in && mk > prefix));
    equal_here += __popc(__ballot_sync(FULL, in && mk == prefix));
  });
  if (lane == 0) {
    st_above[warp] = above_here;
    st_equal[warp] = equal_here;
  }
  __syncthreads();  // the histograms are free: the sort buffer may be written
  uint32_t rank0 = 0, pos0 = 0;  // equal keys and survivors before this warp's
  for (int w = 0; w < warp; ++w) {
    const uint32_t left = need > rank0 ? need - rank0 : 0u;
    pos0 += st_above[w] + (st_equal[w] < left ? st_equal[w] : left);
    rank0 += st_equal[w];
  }
  // SORT_REGS: the survivors' 64-bit values in a power-of-two buffer,
  // zero past k; SORT_SHARED: (key, 16-bit offset) arrays
  uint64_t* buf = reinterpret_cast<uint64_t*>(work);
  uint32_t* skey = reinterpret_cast<uint32_t*>(work);
  uint16_t* soff = reinterpret_cast<uint16_t*>(work + static_cast<size_t>(k) * 4);
  int n_pow2 = SORT_MIN;
  while (n_pow2 < k) n_pow2 <<= 1;
  if (sort == SORT_REGS)
    for (int e = k + tid; e < n_pow2; e += THREADS) buf[e] = 0ull;
  for_keys([&](uint32_t key, int r, bool in) {
    const uint32_t mk = key & mask;
    const bool eq = in && mk == prefix;
    const unsigned em = __ballot_sync(FULL, eq);
    const bool take = (in && mk > prefix) || (eq && rank0 + __popc(em & lower) < need);
    rank0 += __popc(em);
    const unsigned tm = __ballot_sync(FULL, take);
    const int pos = static_cast<int>(pos0) + __popc(tm & lower);
    pos0 += __popc(tm);
    if (take) {
      if (sort == SORT_REGS) {
        buf[pos] = sort_value(key, static_cast<uint32_t>(r));
      } else if (sort == SORT_SHARED) {
        skey[pos] = key;
        soff[pos] = static_cast<uint16_t>(r);
      } else {
        out_s[o + pos] = score_of_key(key);
        out_i[o + pos] = tile_base + r;
      }
    }
  });
  __syncthreads();

  // the k survivors by (key descending, row ascending)
  if (sort == SORT_REGS) {
    if (n_pow2 <= 2048)
      bitonic_regs<2>(buf, n_pow2);
    else if (n_pow2 == 4096)
      bitonic_regs<4>(buf, n_pow2);
    else
      bitonic_regs<8>(buf, n_pow2);
    for (int e = tid; e < k; e += THREADS) {
      const uint64_t v = buf[e];
      out_s[o + e] = score_of_key(static_cast<uint32_t>(v >> 32));
      out_i[o + e] = tile_base + static_cast<int>(~static_cast<uint32_t>(v));
    }
  } else if (sort == SORT_SHARED) {
    bitonic(
        k, [&](int i) { return sort_value(skey[i], soff[i]); },
        [&](int i, uint64_t v) {
          skey[i] = static_cast<uint32_t>(v >> 32);
          soff[i] = static_cast<uint16_t>(~static_cast<uint32_t>(v));
        });
    for (int e = tid; e < k; e += THREADS) {
      out_s[o + e] = score_of_key(skey[e]);
      out_i[o + e] = tile_base + soff[e];
    }
  } else {
    bitonic(
        k,
        [&](int i) {
          return sort_value(key_of(out_s[o + i]), static_cast<uint32_t>(out_i[o + i] - tile_base));
        },
        [&](int i, uint64_t v) {
          out_s[o + i] = score_of_key(static_cast<uint32_t>(v >> 32));
          out_i[o + i] = tile_base + static_cast<int>(~static_cast<uint32_t>(v));
        });
  }
}

// The select over one group: tiles_g tiles of tile_n rows, their scores at
// scratch [B, ld].
int launch_select(const float* scratch, long long ld, float* out_s, int* out_i, int b, int k,
                  int tile_n, int n_tiles, int first_tile, int tiles_g, cudaStream_t stream) {
  const int sort = k <= SORT_REG_MAX                       ? SORT_REGS
                   : k <= SORT_MAX && tile_n <= OFFSET_TILE ? SORT_SHARED
                                                            : SORT_OUTPUT;
  int n_pow2 = SORT_MIN;
  while (n_pow2 < k) n_pow2 <<= 1;
  const size_t sort_bytes = sort == SORT_REGS     ? static_cast<size_t>(n_pow2) * 8
                            : sort == SORT_SHARED ? static_cast<size_t>(k) * 6
                                                  : 0;
  const size_t work = sort_bytes > HIST_BYTES ? sort_bytes : HIST_BYTES;
  const size_t keys = (static_cast<size_t>(tile_n) * 4 + 15) / 16 * 16;
  const bool smem_keys = tile_n <= KEY_TILE && keys + work <= SMEM_MAX;
  const size_t smem = work + (smem_keys ? keys : 0);
  auto kernel = smem_keys ? select_kernel<true> : select_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<static_cast<unsigned>(b) * tiles_g, THREADS, smem, stream>>>(
      scratch, ld, out_s, out_i, tile_n, k, n_tiles, first_tile, tiles_g, sort);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sel
}  // namespace
