// The tensor-core scan body for Hopper (sm_90a): f32 queries against bf16,
// int8 or f32 rows on wgmma, with a per-(query, lane group) selection that
// lives on the accumulators, or a per-query top-k (TOPK and WIDE, below).
// csrc/lanes.cu runs on it K3 over bf16, int8 and f32 rows
// (scan_block_topw_bf16, scan_block_topw_s8, scan_block_topw_tf32), K7
// over bf16 and f32 rows (scan_merge_topw; f32 rows on 3xTF32, below) and
// K8 (scan_fold_probe);
// csrc/exact.cu K1 over f32 and bf16 rows (scan_topk_exact_tf32,
// scan_topk_exact_bf16) and K2 (scan_topk_exact_s8) at k <= 32;
// csrc/wide.cu the same three at 32 < k <= 256 (scan_topk_wide_tf32,
// _bf16, _s8); csrc/select.cu the scores of the same three past k 256 or
// tiles of 32,768 rows (SCORES, below; scan_topk_select_tf32, _bf16, _s8,
// whose radix select lives in select.cuh). The CUDA-core body of
// scan_kernel.cuh keeps K3 at W above 3 alone; K4 runs on csrc/l1.cu's
// FADD stream (Manhattan has no matrix-product form).
//
// Bounds at the headline shape (2^20 x 384 rows, B = 256). bf16 rows: one
// bf16 pass is 2 B N D = 206 GFLOP, 0.21 ms at 989 TFLOP/s, and the rows'
// 805 MB take 0.24 ms at 3.35 TB/s; the f32 queries need three passes
// (below), 0.63 ms of tensor work. int8 rows: three int8 passes of 206 G
// operations at 1,979 TOP/s are 0.31 ms, the rows' 403 MB 0.12 ms. f32
// rows: three tf32 passes at 494.7 TFLOP/s are 1.25 ms, the rows' 1.61 GB
// 0.48 ms. All three forms are bound by operations.
//
// Precision, bf16 rows. The rows are exact bf16 operands. The wrapper
// splits each f32 query into three bf16 terms, q = h + m + l exactly
// (kernels/scan_mma.py split_query_terms), and each term x row product is
// exact in f32, so the three passes give the f32 dot of the plain version
// up to the f32 additions. Those lose more on the tensor cores than in the
// plain version's order: summed into one accumulator (72 wgmmas at D =
// 384), the dots at D = 768 came out about twice as far from float64 as
// the plain f32 product's on an H100. So the h term's passes sum into one
// accumulator and the m and l terms' (smallest first) into a second, added
// once a chunk.
//
// Precision, int8 rows. The wrapper splits each f32 query into three int8
// terms (kernels/scan_mma.py split_query_int8): s1 = max|q| / 127 (an f32
// value), s2 = s1 / 254, s3 = s2 / 254, each term rounded to nearest in
// [-127, 127], so each term's full range covers the rounding error of the
// one before; q - s1 (t1 + t2 / 254 + t3 / 254^2) is at most s1 / (2 x
// 254^2) = s1 / 129,032 (about max|q| 2^-24) an element. Each term's dot
// with the int8 row accumulates exactly in s32 (wgmma m64n64k32.s32.s8.s8),
// and |acc| <= 127 x 127 x D < 2^24 for D <= 1,040, so its f32 conversion
// is exact too. The epilogue forms (acc3 / 254^2 + acc2 / 254 + acc1) s1,
// smallest first, then multiplies by the row's scale: four f32 roundings
// beside the split's residual, whose dot is at most D s1 / 129,032 x 127 x
// scale and ~3e-6 (rms) for N(0, 1) queries and rows at D = 384, below the
// plain version's own f32 error there (~9e-6 on the CPU). So the 1e-5
// rule (scores within rtol/atol 1e-5, ids equal beyond 1e-5 near-ties;
// chip_smoke.py, tests/test_torch_scan.py) holds K3 over int8 rows as it
// holds the other routes. Scales stepping by 128 (powers of two, the later
// terms within +-64) leave s1 2^-15, ~1.4e-5 (rms): above that rule for
// scores near 0.
//
// Precision, f32 rows (3xTF32: K1, K3, K7). The wrapper splits each f32 query into
// two tf32 terms, hi = rna(q) and lo = rna(q - hi) (kernels/scan_mma.py
// split_query_tf32; rna: round to nearest, ties away, to 10 mantissa bits,
// the low 13 bits zeroed: what cvt.rna.tf32.f32 gives), and the kernel
// splits each row word the same way as it loads it from the staged tile
// into registers (the wgmma's A), so nothing depends on what the tensor
// cores do with the low 13 bits. With u = 2^-11, |q - hi| <= u |q| and |q - hi - lo| <= u^2
// |q|; the three passes hi.hi + hi.lo + lo.hi drop lo.lo and the split's
// residuals: at most 3.01 u^2 |q| |x| = 7.2e-7 |q| |x| a product, and each
// product of two tf32 values is exact in f32. The hi.hi passes sum into one
// accumulator and the two cross passes (smallest first) into a second,
// added once a chunk, as over bf16 rows; the f32 accumulations bound the
// rest, as they bound the plain f32 product (D additions of up to an ulp
// each). The dots are held to the 1e-5 rule (scores within rtol/atol 1e-5,
// ids equal beyond 1e-5 near-ties; chip_smoke.py, tests/test_torch_scan.py),
// as the CUDA-core K1's plain f32 FMAs are; an emulation summed in float64
// (tests/test_torch_scan.py) gives 1.47e-6 (rms) at D 384 and 2.10e-6 at
// D 768 against float64, where the plain f32 product gives 4.9e-6 and
// 8.2e-6 (N(0, 1) queries and rows), and stays within 3.01 u^2 sum |q||x|.
// Truncating hi instead (the hardware's reading of a raw f32 word) gives
// 6.8e-6 at D 384, above the plain product: the rows are rounded here.
//
// Design. The rows are the wgmma's M operand and the queries its N: a
// block owns 64 queries and a run of rows, and walks it in 128-row chunks,
// one chunk a step of its two consumer warpgroups (rows 0-63 and 64-127 of
// the chunk). So the accumulator's row r is lane group r of every chunk
// (chunks start at multiples of 128), and each thread holds the same two
// lane groups x 16 queries chunk after chunk: it owns those 32 (query, lane
// group) lists and updates them in ascending row order, with no
// synchronisation, under the strict-> insertion that keeps the lowest row
// among equal scores. A block's run is one tile (K7, K8) or, for K3, a run
// of consecutive tiles: the lists are written and reset at each tile's end,
// so the query terms load once a block and the ring never drains between
// tiles (K3's 4,096-row tiles would otherwise give 1,024 short blocks at
// 2^20 rows, B 256). A warpgroup stages its 64 rows of each 128-byte-wide
// slice (8 KB, 128-byte swizzle; 64 bf16 or 128 int8 columns) by TMA
// tensor copies into its own ring of stages on mbarriers; its first thread
// issues them (no producer warp), and refills a stage as soon as the wgmma
// group that read it has completed. Per slice a warpgroup issues 4 k-steps
// (32 bytes of each row a step: wgmma m64n64k16 over bf16, m64n64k32 over
// int8) x 3 terms with both operands from shared memory. After a chunk's
// last slice the epilogue applies the row scale (int8), the metric and the
// validity and updates the lists, branch-free: about 3 W instructions a
// score, which the other warpgroup's wgmmas overlap.
//
// The shared-memory budget is the crux: at 64 queries and D = 384 the three
// bf16 query terms take 144 KB (the int8 terms 72 KB), one rung of lists
// would take 64 KB and a ring of 128-row tiles 16 KB a stage. The choice:
// the lists live in registers (W scores and one word of W chunk indices a
// list, 32 lists a thread, beside the accumulators: two f32 sets of 32
// registers over bf16 rows, three s32 sets over int8 rows; ptxas reports
// 159-241 registers a thread over bf16 rows and 223-254 over int8 rows,
// where W = 3 spills 8 bytes), the query
// terms stay resident in shared memory for the whole run (loaded once by a
// TMA bulk copy, laid out by the wrapper in the swizzled order the wgmma
// reads), and the ring takes what is left (at most 8 stages; one block an
// SM, 256 threads). Where the terms do not fit beside two stages (bf16
// rows at D > 384), each stage carries its slice's three query terms too
// (32 KB a warpgroup), read again per chunk from L2. A list names its rows
// by chunk indices of 32 / W bits, so a tile holds at most 2^10 chunks at
// W = 3 (131,072 rows) and 2^16 at W = 2.
//
// Empty slots (a list short of W rows above -inf) name row 0 (K7), their
// lane group's first row of the tile (K8 `full`), or (K3) the lowest rows
// of the lane group not already listed, in row order: what the plain
// version's stable sort of the tile's -inf entries gives.
//
// Rows whose stride is not a multiple of 16 bytes (D = 100: 200 bytes of
// bf16, 100 of int8) are refused by TMA: for them each warpgroup copies its
// 64-row slice with plain loads into the same swizzled layout (bytes past
// the row zero), fences it to the async proxy and syncs its four warps
// before the wgmma. Columns past D of the last slice are zero either way
// (TMA fills them), as are the queries past B.
//
// TOPK (K1, K2: tile_topk_plain's [B, T, k], k <= 32). A lane-group list
// cannot hold a query's top k, so after a chunk's last slice each
// warpgroup writes its 64 rows x 64 queries of scores (metric and validity
// applied) to its own 16 KB score tile in shared memory (row index XOR 8
// ((query / 2) mod 4): the accumulator layout's writes and the per-query
// reads both free of bank conflicts) and syncs its 128 threads; each warp
// then merges its 16 queries' 2 scores a lane into each query's running
// top k in registers (lane j holds entry j), by (score descending, row
// ascending): a tile's first chunk by a bitonic sort of its 64 rows, later
// chunks half by half, the rows that beat the k-th entry (a ballot) packed
// in shared memory and inserted in turn by a shuffle of the list, four
// queries interleaved. A query has two lists, one a warpgroup (rows 0-63
// and 64-127 of each chunk); at the tile's end both go to shared memory
// and each entry's place in the merged list is its index plus its rank in
// the other list (a binary search: the lists hold distinct rows). Every
// row of the tile enters (invalid ones at -inf, ordered by row), so a list
// of k <= 64 rows a warpgroup is full and empty slots come out as the
// plain version's stable sort gives them. The merge, not the contraction,
// holds most of the time at k 32 (csrc/exact.cu, PERF.md): ~105 of a
// list's 1,024 rows a tile enter it, and each insertion is a chain of
// shuffles.
//
// WIDE (K1, K2: [B, T, k], 32 < k <= 32 W; W 4 or 8). Lists of 128 or
// 256 entries a query fit neither a warp's registers (16 queries a warp)
// nor two a query in shared memory, and at these k most of a tile's rows
// enter a list, so one insertion a row (the CUDA-core body's lists, 77-93
// ms at the main path's k) is the wrong design. A block keeps one list a
// query in shared memory, 32 W scores and 32 W rows as 16-bit offsets in
// the tile (tiles up to WIDE_MAX_TILE rows; 48 KB at W 4, 96 KB at W 8),
// fed by both warpgroups' score tiles: after each chunk's scores are
// written, a block barrier, then each of the 8 warps merges the chunk's
// 128 rows into its 8 queries' lists, one query at a time
// (wide_merge_query): a ballot against the k-th entry decides whether the
// query merges and which batch (up to 32 or 64 rows packed, else all 128),
// a bitonic sort of the batch, and a bitonic merge of the batch into the
// list (merge_batch), a fixed network whatever the number of rows that
// enter. Every row passes through a batch or is beaten by the k-th entry,
// and placeholders (-inf, WIDE_PLACE) sort after every row, so a list's
// first k are the tile's top k once its k <= tile_n rows are seen. A
// block barrier before the next chunk's scores keeps the tiles intact for
// the merges. The lists and score tiles leave no room for resident query
// terms, and terms streamed a warpgroup would take 32 KB a stage each: so
// one ring serves both warpgroups (Ring::SHARED, as over f32 rows, below),
// a stage holding the slice's terms once and each warpgroup's rows (40 KB
// over bf16 and int8 rows: 2-3 stages), released once both have read it.
// The merges hold most of the time (scripts/probe_exact_topk.py, PERF.md):
// each step is a handful of integer and predicate instructions a pair,
// the SMs' issue of them bounds it, not the shuffles' latency.
//
// SCORES (K1, K2 past k 256 or tiles of 32,768 rows: csrc/select.cu).
// No list: the epilogue writes each (query, row) score, metric and
// validity applied, to [B, n] f32 (the caller's scratch, n the launch's
// rows), straight from the accumulators (for one accumulator entry a
// warp's stores are four runs of eight consecutive rows, 32 bytes each:
// whole sectors). The contraction sums the large term a slice at a time
// (HiLo, below: these scores feed lists of any length, which reach dots
// near 0), on the shared ring; a block walks runs of 128-row chunks
// (F_WALK with tile_n = CHUNK) so that a launch over one group of select
// tiles still fills the card.
//
// f32 rows (TOPK, WIDE, SCORES and TOPW). A stage cannot carry the query terms a warpgroup
// as over bf16 rows: two tf32 terms of 64 queries are 192 KB at D 384, and
// streamed per warpgroup they would double the L2 reads of the terms. So
// one ring serves both warpgroups: a stage holds the slice's two query
// terms (16 KB) once and each warpgroup's 64 raw f32 rows (8 KB each), 32
// KB in all: six stages beside the score tiles. The block's first thread
// issues every copy of a stage, refilling a stage once both warpgroups
// have arrived on its empty barrier (without waiting while the step it
// needs next is issued). Each thread loads its A words of a k-step (rows g
// and g + 8 of its warp's 16, columns t and t + 4) from the swizzled tile,
// splits them into hi and lo in registers and issues wgmma m64n64k8 with
// A from registers: the rows' split costs no shared-memory traffic, and
// the tensor cores read only the query terms from shared memory. Over
// rows TMA refuses (D not a multiple of 4) the words come from device
// memory instead. TOPW over f32 rows (K3 and K7: one instantiation, the
// flags at run time) keeps its lists in registers as over bf16 rows,
// beside the two accumulator sets, the large term's slice sums (HiLo,
// below: a lane group with few live rows lists dots near 0, where the
// tensor cores' truncating accumulation over a chunk's 48-96 k-steps would
// leave them farther from float64 than the plain f32 product's) and the A
// words of a k-step (the registers ptxas reports for W 1-3 stand in
// PERF.md). K3 walks runs of tiles (F_WALK) with those A words loaded from
// device memory where TMA refuses the rows, and names the lowest unlisted
// rows in its empty slots (F_LOW_ROWS), as over bf16 and int8 rows.
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
constexpr int SLICE_BYTES = 128;         // bytes of a row a slice: one swizzled row
constexpr int BOX = WG_ROWS * SLICE_BYTES;   // bytes of a warpgroup's rows of a slice
constexpr int QSLICE = QN * SLICE_BYTES;     // bytes of one term's queries of a slice
constexpr int LISTS = QN / 2;            // (query, lane group) lists a thread owns
constexpr int MAX_STAGES = 8;
constexpr int SMEM_MAX = 232448;         // Hopper's per-block shared-memory limit
constexpr int TOPK_MAX = 32;             // TOPK: a list's entries, one a lane
constexpr int WARP_QUERIES = QN / 4;     // TOPK: queries a warp merges
constexpr int SCORE_BYTES = WG_ROWS * QN * 4;  // TOPK, WIDE: a warpgroup's score tile
constexpr int WIDE_QUERIES = QN / 8;     // WIDE: queries a warp merges (of the block's 8)
constexpr int WIDE_MAX_TILE = 1 << 15;   // WIDE: a list names rows by 16-bit offsets in the tile
constexpr int WIDE_PLACE = 0xFFFF;       // WIDE: an empty slot's row (-inf, after every row)

// What a block keeps of each (query, lane group): its top W by (score
// descending, row ascending) (K3, K7, K8 full), its W largest distinct
// scores (K8 maxonly), or nothing: the tile's first chunk is written as it
// is (K8 none; the wgmmas are volatile asm, so every chunk is contracted
// all the same); or each query's top k of the tile (TOPK: K1, K2, k <= 32;
// WIDE: k <= 32 W, W 4 or 8); or every score (SCORES, W 1).
enum Mode { TOPW = 0, DISTINCT = 1, FIRST = 2, TOPK = 3, WIDE = 4, SCORES = 6 };
// TMA: rows staged by tensor copies (else by plain loads); RESIDENT: the
// query terms stay in shared memory (else each stage carries its slice's);
// GROUP_ROW: an empty TOPW slot names its lane group's first row of the
// tile (K8 full), LOW_ROWS: the lowest rows of its lane group not listed
// (K3), neither: row 0 (K7); QUERY_MAJOR: lists go out as [B, T, W*128]
// (K3), else [T, B, W*128]; WALK: a block walks a run of consecutive tiles
// (K3), else one.
enum Flags {
  F_TMA = 1, F_RESIDENT = 2, F_GROUP_ROW = 4, F_LOW_ROWS = 8, F_QUERY_MAJOR = 16, F_WALK = 32
};
enum Metric { COSINE = 0, EUCLIDEAN = 1, DOT = 2 };

// The row element types: bf16 (as its bits), int8 and f32. QTERMS: terms
// a query is split into; SPLIT: the staged rows are split into hi and lo
// tf32 words as they load into registers (the wgmma's A), and one ring
// serves both warpgroups.
template <typename T>
struct Rows;
template <>
struct Rows<uint16_t> {
  static constexpr int BYTES = 2;
  static constexpr int QTERMS = 3;
  static constexpr bool SPLIT = false;
  static constexpr CUtensorMapDataType TMA_TYPE = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
template <>
struct Rows<int8_t> {
  static constexpr int BYTES = 1;
  static constexpr int QTERMS = 3;
  static constexpr bool SPLIT = false;
  static constexpr CUtensorMapDataType TMA_TYPE = CU_TENSOR_MAP_DATA_TYPE_UINT8;  // TMA copies the bytes
};
template <>
struct Rows<float> {
  static constexpr int BYTES = 4;
  static constexpr int QTERMS = 2;
  static constexpr bool SPLIT = true;
  static constexpr CUtensorMapDataType TMA_TYPE = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};

// SHARED: one ring serves both warpgroups, a stage holding the slice's
// query terms once and each warpgroup's 64 rows (f32 rows in every mode, and every row
// type in the WIDE mode, whose lists leave no room for resident terms, and
// in SCORES, which sums a slice at a time); else each warpgroup has a ring
// of its own. SUMS: the large term is summed a slice at a time (HiLo,
// below): SCORES, and TOPW over f32 rows.
template <typename T, int MODE>
struct Ring {
  static constexpr bool SHARED = Rows<T>::SPLIT || MODE == WIDE || MODE == SCORES;
  static constexpr bool SUMS = MODE == SCORES || (Rows<T>::SPLIT && MODE == TOPW);
};

// A chunk's three passes and their sums, by row type. bf16: the h term's
// passes into hi, the m and l terms' into lo (the large sum takes a third
// of the additions: the tensor cores' f32 accumulation loses up to an ulp
// of the sum an addition, the small one's losses are 2^-8 as large). int8:
// term t's passes into its own exact s32 sum.
template <typename T>
struct Dots;
// The bf16 and f32 forms' sums: the large term's passes into hi, the
// others into lo, both f32 on the tensor cores. SCORES (and TOPW over f32
// rows) also sums hi a slice at a time (slice_start, slice_end, then
// take_sums at the chunk's end): the tensor cores' f32 accumulation
// truncates to the running sum's ulp at each k-step, which over a chunk's
// k-steps (48 at D 384 over f32 rows) left a long list's dots near 0
// further from float64 than the plain f32 product's; summed in registers
// (round to nearest) a slice's 4 k-steps at a time they lie nearer
// (scripts/probe_exact_topk.py --precision, PERF.md). The TOPK and WIDE
// modes' lists keep scores far from 0.
struct HiLo {
  Acc<QN> hi, lo;
  float sums[QN / 2];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < QN / 2; ++i) hi.v[i] = lo.v[i] = sums[i] = 0.0f;
  }
  __device__ __forceinline__ void slice_start() {
#pragma unroll
    for (int i = 0; i < QN / 2; ++i) hi.v[i] = 0.0f;
  }
  __device__ __forceinline__ void slice_end() {
#pragma unroll
    for (int i = 0; i < QN / 2; ++i) sums[i] += hi.v[i];
  }
  __device__ __forceinline__ void take_sums() {
#pragma unroll
    for (int i = 0; i < QN / 2; ++i) hi.v[i] = sums[i];
  }
  __device__ __forceinline__ void hold_all() {
#pragma unroll
    for (int i = 0; i < QN / 2; ++i) {
      hold(hi.v[i]);
      hold(lo.v[i]);
    }
  }
  __device__ __forceinline__ float dot(int i, float, float) const { return hi.v[i] + lo.v[i]; }
};
template <>
struct Dots<uint16_t> : HiLo {
  // k-step kk of a slice: terms l, m, then h
  __device__ __forceinline__ void mma(uint64_t da, uint64_t db, int kk) {
    wgmma_ss(lo, da + 2 * kk, db + 2 * (QSLICE >> 4) + 2 * kk);
    wgmma_ss(lo, da + 2 * kk, db + (QSLICE >> 4) + 2 * kk);
    wgmma_ss(hi, da + 2 * kk, db + 2 * kk);
  }
};
template <>
struct Dots<int8_t> {
  AccS<QN> a1, a2, a3;
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < QN / 2; ++i) a1.v[i] = a2.v[i] = a3.v[i] = 0;
  }
  __device__ __forceinline__ void hold_all() {
#pragma unroll
    for (int i = 0; i < QN / 2; ++i) {
      hold(a1.v[i]);
      hold(a2.v[i]);
      hold(a3.v[i]);
    }
  }
  __device__ __forceinline__ void mma(uint64_t da, uint64_t db, int kk) {
    wgmma_s8(a3, da + 2 * kk, db + 2 * (QSLICE >> 4) + 2 * kk);
    wgmma_s8(a2, da + 2 * kk, db + (QSLICE >> 4) + 2 * kk);
    wgmma_s8(a1, da + 2 * kk, db + 2 * kk);
  }
  // (acc3 / 254^2 + acc2 / 254 + acc1) s1, then the row's scale (each
  // conversion exact)
  __device__ __forceinline__ float dot(int i, float qscale, float rscale) const {
    const float t = (static_cast<float>(a3.v[i]) * (1.0f / 64516.0f) +
                     static_cast<float>(a2.v[i]) * (1.0f / 254.0f)) +
                    static_cast<float>(a1.v[i]);
    return (t * qscale) * rscale;
  }
};
// f32 rows: the rows' hi and lo words of a k-step in registers (ah, al),
// the queries' hi term at db, their lo term QSLICE bytes on. hi.hi into
// hi, the cross products into lo.
template <>
struct Dots<float> : HiLo {
  __device__ __forceinline__ void mma(const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                      uint64_t db, int kk) {
    wgmma_tf32_rs(lo, al, db + 2 * kk);
    wgmma_tf32_rs(lo, ah, db + (QSLICE >> 4) + 2 * kk);
    wgmma_tf32_rs(hi, ah, db + 2 * kk);
  }
};

// rna(x) to tf32 (round to nearest, ties away from zero, the low 13 bits
// zero), as an f32 word: cvt.rna.tf32.f32's rounding, written in integer
// arithmetic so that kernels/scan_mma.py round_tf32 gives the same bits.
__device__ __forceinline__ uint32_t round_tf32(uint32_t x) {
  return (x + 0x1000u) & 0xffffe000u;
}

// A staged f32 word split into its hi and lo tf32 words: x - hi is exact.
__device__ __forceinline__ void split_tf32(uint32_t x, uint32_t& hi, uint32_t& lo) {
  hi = round_tf32(x);
  lo = round_tf32(__float_as_uint(__uint_as_float(x) - __uint_as_float(hi)));
}

struct Layout {
  size_t ring;    // offset of warpgroup 0's ring (the resident query terms come first)
  size_t stage;   // bytes of a stage
  size_t scores;  // TOPK, WIDE: [2][QN][WG_ROWS] f32, each warpgroup's score tile
  size_t lists;   // WIDE: [QN][32 W] f32 scores, then [QN][32 W] u16 rows, a list a query
  size_t qnorm;   // [3][QN] f32: the block's query squared norms, 1 / the norms, term scales
  size_t bars;    // 2 x stages full barriers (SHARED: stages full, stages empty), then the
                  // query terms' barrier
  size_t bytes;   // dynamic shared memory, with the slack to align the base to 1 KB
};

// A warpgroup's ring (bf16, int8 rows): a stage is its 64 rows of a slice,
// then (unless resident) the slice's query terms. The shared ring (SHARED):
// a stage is the slice's query terms, then each warpgroup's 64 rows.
template <typename T, int MODE, int W>
__host__ __device__ inline Layout layout_for(int slices, bool resident, int stages) {
  constexpr size_t QBYTES = static_cast<size_t>(Rows<T>::QTERMS) * QSLICE;
  Layout l;
  l.ring = resident ? static_cast<size_t>(slices) * QBYTES : 0;
  if (Ring<T, MODE>::SHARED) {
    l.stage = QBYTES + 2 * BOX;
    l.scores = l.ring + stages * l.stage;
  } else {
    l.stage = BOX + (resident ? 0 : QBYTES);
    l.scores = l.ring + 2 * stages * l.stage;
  }
  l.lists = l.scores + (MODE == TOPK || MODE == WIDE ? 2 * SCORE_BYTES : 0);
  l.qnorm = l.lists + (MODE == WIDE ? static_cast<size_t>(QN) * 32 * W * 6 : 0);
  l.bars = l.qnorm + 3 * QN * sizeof(float);
  l.bytes = l.bars + (2 * stages + 1) * 8 + 1024;
  return l;
}

// TOPK: the score tile's word of query ql, row r of the warpgroup's 64.
__device__ __forceinline__ int score_at(int ql, int r) {
  return ql * WG_ROWS + (r ^ (((ql >> 1) & 3) << 3));
}

// (s1, r1) precedes (s2, r2): higher score first, lower row on ties.
__device__ __forceinline__ bool precedes(float s1, int r1, float s2, int r2) {
  return s1 > s2 || (s1 == s2 && r1 < r2);
}

// TOPK: (s, r) into a sorted list of a warp, lane j holding entry j (lanes
// past the list's length hold what they will): entries that precede it
// stay, the entry it displaces and those after move one lane up. A pair
// that precedes no entry leaves the list as it is.
__device__ __forceinline__ void insert_entry(float& ls, int& lr, float s, int r, int lane) {
  const float up_s = __shfl_up_sync(0xffffffffu, ls, 1);
  const int up_r = __shfl_up_sync(0xffffffffu, lr, 1);
  const bool stay = precedes(ls, lr, s, r);
  const bool here = lane == 0 || precedes(up_s, up_r, s, r);
  ls = stay ? ls : (here ? s : up_s);
  lr = stay ? lr : (here ? r : up_r);
}

// TOPK: one compare-exchange step (run `size`, distance d) of a bitonic
// sort of a warp's 64 (score, row) pairs by (score descending, row
// ascending), element e in lane e % 32 (e < 32: s0/r0, else s1/r1):
// partners in one lane at distance 32, across lanes by shuffles below it.
// The lower element of a pair takes the better one in a descending run (e
// & size == 0), the worse one in an ascending run. The 21 steps of size 2,
// 4, ..., 64 and d size / 2, ..., 1 sort the 64.
__device__ __forceinline__ void sort_step(float& s0, int& r0, float& s1, int& r1, int size,
                                          int d, int lane) {
  if (d == 32) {  // size 64: element e before element e + 32
    const bool swap = !precedes(s0, r0, s1, r1);
    const float ts = s0;
    const int tr = r0;
    s0 = swap ? s1 : s0;
    r0 = swap ? r1 : r0;
    s1 = swap ? ts : s1;
    r1 = swap ? tr : r1;
    return;
  }
#pragma unroll
  for (int jj = 0; jj < 2; ++jj) {
    float& s = jj ? s1 : s0;
    int& r = jj ? r1 : r0;
    const int e = jj * 32 + lane;
    const float os = __shfl_xor_sync(0xffffffffu, s, d);
    const int orow = __shfl_xor_sync(0xffffffffu, r, d);
    const bool better = ((e & d) == 0) == ((e & size) == 0);
    if (precedes(os, orow, s, r) == better) {
      s = os;
      r = orow;
    }
  }
}

// WIDE: a warp's 32 S (score, row) pairs, element e = 32 a + lane in slot a
// of lane e % 32. One compare-exchange step of a bitonic network: partners
// at distance D, from 32 on in one lane across slots, below it across lanes
// by shuffles; the lower element of a pair takes the better one in a run
// sorted descending ((e & SIZE) == 0), the worse one in an ascending run.
template <int S, int SIZE, int D>
__device__ __forceinline__ void cx_step(float (&s)[S], int (&r)[S], int lane) {
  if constexpr (D >= 32) {
    constexpr int DS = D / 32;
#pragma unroll
    for (int a = 0; a < S; ++a) {
      if ((a & DS) == 0) {
        const bool desc = ((a * 32) & SIZE) == 0;
        const bool swap = precedes(s[a + DS], r[a + DS], s[a], r[a]) == desc;
        const float ts = s[a];
        const int tr = r[a];
        s[a] = swap ? s[a + DS] : s[a];
        r[a] = swap ? r[a + DS] : r[a];
        s[a + DS] = swap ? ts : s[a + DS];
        r[a + DS] = swap ? tr : r[a + DS];
      }
    }
  } else {
#pragma unroll
    for (int a = 0; a < S; ++a) {
      const int e = a * 32 + lane;
      const float os = __shfl_xor_sync(0xffffffffu, s[a], D);
      const int orow = __shfl_xor_sync(0xffffffffu, r[a], D);
      const bool better = ((e & D) == 0) == ((e & SIZE) == 0);
      if (precedes(os, orow, s[a], r[a]) == better) {
        s[a] = os;
        r[a] = orow;
      }
    }
  }
}

// The steps D, D / 2, ..., 1 of runs of SIZE.
template <int S, int SIZE, int D>
__device__ __forceinline__ void cx_steps(float (&s)[S], int (&r)[S], int lane) {
  cx_step<S, SIZE, D>(s, r, lane);
  if constexpr (D > 1) cx_steps<S, SIZE, D / 2>(s, r, lane);
}

// A bitonic sort of the warp's 32 S pairs, descending: runs of SIZE, 2
// SIZE, ..., 32 S.
template <int S, int SIZE = 2>
__device__ __forceinline__ void bitonic_sort(float (&s)[S], int (&r)[S], int lane) {
  cx_steps<S, SIZE, SIZE / 2>(s, r, lane);
  if constexpr (SIZE < 32 * S) bitonic_sort<S, SIZE * 2>(s, r, lane);
}

// WIDE: a batch of 32 SB (score, row) pairs (SB <= KS; any order, (-inf,
// WIDE_PLACE) where a lane has none) into a query's list of 32 KS in shared
// memory (sorted), which keeps the top 32 KS of both. The batch is sorted;
// list entry i takes the better of itself and batch entry 32 KS - 1 - i,
// which leaves the top 32 KS of both in a bitonic order (the list
// descending against the batch ascending; entries below 32 (KS - SB)
// face the batch's empty slots and stay), and a bitonic merge sorts them.
// A fixed network: log^2 steps of the batch and log2(32 KS) of the merge,
// however many of the batch enter.
template <int KS, int SB>
__device__ __forceinline__ void merge_batch(float* lst_s, uint16_t* lst_r, float (&bs)[SB],
                                            int (&br)[SB], int lane) {
  bitonic_sort<SB>(bs, br, lane);
  float s[KS];
  int r[KS];
#pragma unroll
  for (int a = 0; a < KS; ++a) {
    s[a] = lst_s[a * 32 + lane];
    r[a] = lst_r[a * 32 + lane];
  }
#pragma unroll
  for (int a = KS - SB; a < KS; ++a) {
    const float os = __shfl_xor_sync(0xffffffffu, bs[KS - 1 - a], 31);
    const int orow = __shfl_xor_sync(0xffffffffu, br[KS - 1 - a], 31);
    if (precedes(os, orow, s[a], r[a])) {
      s[a] = os;
      r[a] = orow;
    }
  }
  cx_steps<KS, 32 * KS, 16 * KS>(s, r, lane);
#pragma unroll
  for (int a = 0; a < KS; ++a) {
    lst_s[a * 32 + lane] = s[a];
    lst_r[a * 32 + lane] = static_cast<uint16_t>(r[a]);
  }
}

// WIDE: a chunk's 128 rows (both warpgroups' score tiles; base: the
// chunk's first row in the tile) into query ql's list. The rows that
// precede the k-th entry (a ballot) decide whether the query merges at all
// and which batch it merges: up to 32 or 64 of them packed into the
// query's rows of the score tiles (read already), else all 128 rows as
// they are (a row that does not beat the k-th entry only moves entries
// past k).
template <int W>
__device__ __forceinline__ void wide_merge_query(float* score_tile, float* ls_, uint16_t* lr_,
                                                 int ql, int base, int k, int lane) {
  float cs[4];
  int cr[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    cs[u] = score_tile[(u >> 1) * (QN * WG_ROWS) + score_at(ql, (u & 1) * 32 + lane)];
    cr[u] = base + u * 32 + lane;
  }
  const float kth_s = ls_[k - 1];
  const int kth_r = lr_[k - 1];
  unsigned in[4];
  int m = 0;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    in[u] = __ballot_sync(0xffffffffu, precedes(cs[u], cr[u], kth_s, kth_r));
    m += __popc(in[u]);
  }
  if (m == 0) return;
  if (m > 64) {
    merge_batch<W, 4>(ls_, lr_, cs, cr, lane);
    return;
  }
  float* const pack_s = score_tile + ql * WG_ROWS;  // the query's row of tile 0 ...
  int* const pack_r = reinterpret_cast<int*>(score_tile + (QN + ql) * WG_ROWS);  // ... of 1
  __syncwarp();
  int at = 0;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    if ((in[u] >> lane) & 1) {
      const int p = at + __popc(in[u] & ((1u << lane) - 1));
      pack_s[p] = cs[u];
      pack_r[p] = cr[u];
    }
    at += __popc(in[u]);
  }
  __syncwarp();
  if (m <= 32) {
    float bs[1] = {lane < m ? pack_s[lane] : -CUDART_INF_F};
    int br[1] = {lane < m ? pack_r[lane] : WIDE_PLACE};
    merge_batch<W, 1>(ls_, lr_, bs, br, lane);
  } else {
    float bs[2] = {pack_s[lane], lane + 32 < m ? pack_s[lane + 32] : -CUDART_INF_F};
    int br[2] = {pack_r[lane], lane + 32 < m ? pack_r[lane + 32] : WIDE_PLACE};
    merge_batch<W, 2>(ls_, lr_, bs, br, lane);
  }
}

// Shared-memory matrix descriptor of a K-major operand in the 128-byte
// swizzle (TMA's SWIZZLE_128B): rows of 128 bytes, groups of 8 rows 1024
// bytes apart (stride byte offset), the base 1 KB aligned. The k-step kk
// of a slice starts 32 kk bytes in: descriptor + 2 kk.
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

// A list names its entries' rows by their chunk indices in the tile,
// packed in one word: W fields of 32 / W bits (W 3: 10 bits, so a tile
// holds at most 2^10 chunks; W 2: 2^16; W 1: any).
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

// A block: 64 queries (blockIdx.x) x a run of tiles (blockIdx.y: tiles
// blockIdx.y * tiles_per_block on, one without F_WALK), into out_s/out_i
// [n_tiles, B, n_out] or, with F_QUERY_MAJOR, [B, n_tiles, n_out] (n_out =
// 128 for FIRST, W * 128 otherwise, position w * 128 + lane group; TOPK
// and WIDE write [B, n_tiles, k]). K8 passes no qsq, sqnorms or validity (dot,
// every row valid); only int8 rows have scales and query term scales.
template <typename T, int MODE, int W>
__global__ void __launch_bounds__(THREADS, 1)
lanes_kernel(const __grid_constant__ CUtensorMap rows_map,   // [N, D] (F_TMA)
             const T* __restrict__ values,                   // [N, D] (plain loads)
             const uint8_t* __restrict__ q_img,   // [B/64, S, terms, 64, 128 bytes], swizzled
             const float* __restrict__ q_scale,   // [B] (int8) or null
             const float* __restrict__ qsq,       // [B] or null
             const float* __restrict__ scales,    // [N] (int8) or null
             const float* __restrict__ sqnorms,   // [N] or null
             const uint8_t* __restrict__ valid,   // [N] or null
             float* __restrict__ out_s, int* __restrict__ out_i,
             int d, int b, int tile_n, int n_tiles, int tiles_per_block, int metric,
             int slices, int stages, int flags, int k) {
  constexpr bool SPLIT = Rows<T>::SPLIT;
  constexpr bool SHARED = Ring<T, MODE>::SHARED;
  constexpr int QBYTES = Rows<T>::QTERMS * QSLICE;
  extern __shared__ __align__(16) uint8_t body_smem[];
  uint8_t* smem = body_smem + ((1024 - (smem_addr(body_smem) & 1023)) & 1023);
  const bool tma = flags & F_TMA;
  const bool resident = flags & F_RESIDENT;
  const Layout lay = layout_for<T, MODE, W>(slices, resident, stages);

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int wtid = tid & 127;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = blockIdx.x * QN;
  const int first_tile = blockIdx.y * tiles_per_block;
  const int my_tiles = min(tiles_per_block, n_tiles - first_tile);
  const long long run_base = static_cast<long long>(first_tile) * tile_n;
  const int tile_chunks = tile_n / CHUNK;
  const int steps = my_tiles * tile_chunks * slices;

  // SHARED: one ring for both warpgroups, full barriers then empty ones
  uint8_t* ring = smem + lay.ring + (SHARED ? 0 : static_cast<size_t>(wg) * stages * lay.stage);
  float* qn = reinterpret_cast<float*>(smem + lay.qnorm);  // qsq, 1 / |q|, term scale
  const uint32_t bars = smem_addr(smem + lay.bars);
  const uint32_t full0 = bars + (SHARED ? 0 : 8 * wg * stages);
  const uint32_t empty0 = bars + 8 * stages;  // SHARED
  const uint32_t img_bar = bars + 8 * 2 * stages;
  const uint32_t stage_tx = SHARED ? QBYTES + (tma ? 2 * BOX : 0)
                                  : (tma ? BOX : 0) + (resident ? 0 : QBYTES);
  const size_t img_bytes = static_cast<size_t>(slices) * QBYTES;
  const uint8_t* img = q_img + blockIdx.x * img_bytes;
  // this warpgroup's rows in stage st
  auto rows_at = [&](int st) {
    return ring + static_cast<size_t>(st) * lay.stage + (SHARED ? QBYTES + wg * BOX : 0);
  };

  if (tid == 0) {
    for (int i = 0; i < 2 * stages + 1; ++i)
      mbar_init(bars + 8 * i, SHARED && i >= stages && i < 2 * stages ? 2 : 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid < QN) {
    const bool live = q0 + tid < b;
    const float v = (qsq != nullptr && live) ? qsq[q0 + tid] : 0.0f;
    qn[tid] = v;
    qn[QN + tid] = inv_norm(v);
    qn[2 * QN + tid] = (q_scale != nullptr && live) ? q_scale[q0 + tid] : 1.0f;
  }
  __syncthreads();

  // step j = chunk j / slices of the run, slice j % slices, into stage j %
  // stages (SHARED: the block's first thread, for both warpgroups)
  auto issue = [&](int j) {
    if (stage_tx == 0) return;
    const int st = j % stages;
    const int s = j % slices;
    const uint32_t bar = full0 + 8 * st;
    const uint32_t dst = smem_addr(ring + st * lay.stage);
    if constexpr (SHARED) {
      const long long row0 = run_base + static_cast<long long>(j / slices) * CHUNK;
      mbar_expect_tx(bar, stage_tx);
      bulk_load(dst, img + static_cast<size_t>(s) * QBYTES, QBYTES, bar);
      for (int w = 0; tma && w < 2; ++w)
        tma_load_2d(dst + QBYTES + w * BOX, &rows_map, s * (SLICE_BYTES / Rows<T>::BYTES),
                    static_cast<int>(row0 + w * WG_ROWS), bar);
      return;
    }
    mbar_expect_tx(bar, stage_tx);
    if (tma)
      tma_load_2d(dst, &rows_map, s * (SLICE_BYTES / Rows<T>::BYTES),
                  static_cast<int>(run_base + static_cast<long long>(j / slices) * CHUNK +
                                   wg * WG_ROWS),
                  bar);
    if (!resident)
      bulk_load(dst + BOX, img + static_cast<size_t>(s) * QBYTES, QBYTES, bar);
  };
  // the staging path for rows TMA refuses: this warpgroup's 64 rows of the
  // slice by plain loads, swizzled as TMA would, then fenced to the async
  // proxy
  auto copy_rows = [&](int j) {
    const int c = j / slices;
    const int s = j % slices;
    uint8_t* dst = rows_at(j % stages);
    const long long row0 = run_base + static_cast<long long>(c) * CHUNK + wg * WG_ROWS;
    const size_t row_bytes = static_cast<size_t>(d) * Rows<T>::BYTES;
    const uint8_t* vb = reinterpret_cast<const uint8_t*>(values);
    for (int x = wtid; x < WG_ROWS * 8; x += 128) {
      const int r = x >> 3;
      const int ch = x & 7;
      const size_t col = static_cast<size_t>(s) * SLICE_BYTES + ch * 16;
      const uint8_t* src = vb + static_cast<size_t>(row0 + r) * row_bytes + col;
      uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int e = 0; e < 16; ++e)
        if (col + e < row_bytes) w[e >> 2] |= static_cast<uint32_t>(src[e]) << (8 * (e & 3));
      *reinterpret_cast<uint4*>(dst + r * 128 + ((ch ^ (r & 7)) << 4)) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
  };
  // SHARED (the block's first thread): issue the steps whose stage both
  // warpgroups have released, up to step j + stages - 1, waiting only when
  // step j itself is not issued yet
  int issued = min(stages, steps);
  auto refill = [&](int j) {
    while (issued < steps && issued < j + stages) {
      const int prev = issued - stages;  // the step that held the stage
      const uint32_t e = empty0 + 8 * (prev % stages);
      const uint32_t parity = (prev / stages) & 1;
      if (issued > j) {
        if (!mbar_test_wait(e, parity)) break;
      } else {
        mbar_wait(e, parity);
      }
      issue(issued++);
    }
  };
  // SPLIT: this thread's A words of step j (rows ra and ra + 8 of the
  // warpgroup's 64, columns 8 kk + t and + 4: wgmma_tf32_rs's fragment)
  // from the staged tile (swizzled as TMA left it) or, where TMA refuses
  // the rows, from device memory; each split into its hi and lo tf32 words
  auto load_a = [&](int j, uint32_t (&ah)[4][4], uint32_t (&al)[4][4]) {
    const int ra = warp * 16 + g;
    const uint8_t* tile = rows_at(j % stages);
    const long long row0 = run_base + static_cast<long long>(j / slices) * CHUNK + wg * WG_ROWS;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // a0..a3: row ra + 8 (e & 1), column + 4 (e >> 1)
        const int r = ra + 8 * (e & 1);
        uint32_t x;
        if (tma) {
          const int chunk = 2 * kk + (e >> 1);
          x = *reinterpret_cast<const uint32_t*>(tile + r * SLICE_BYTES +
                                                  ((chunk ^ (r & 7)) << 4) + 4 * t);
        } else {
          const int col = (j % slices) * (SLICE_BYTES / 4) + 8 * kk + 4 * (e >> 1) + t;
          x = col < d ? __float_as_uint(
                            reinterpret_cast<const float*>(values)[(row0 + r) * d + col])
                      : 0u;
        }
        split_tf32(x, ah[kk][e], al[kk][e]);
      }
    }
  };

  if (tid == 0 && resident) {
    mbar_expect_tx(img_bar, static_cast<uint32_t>(img_bytes));
    bulk_load(smem_addr(smem), img, static_cast<uint32_t>(img_bytes), img_bar);
  }
  if (SHARED ? tid == 0 : wtid == 0)
    for (int j = 0; j < stages && j < steps; ++j) issue(j);
  __syncwarp();
  if (resident) mbar_wait(img_bar, 0);

  // the thread's accumulator rows: lane groups lg and lg + 8; its queries
  // q0 + 8 i + 2 t + e (accumulator entry 4 i + 2 h + e, h = 1 for lg + 8)
  const int lg = wg * WG_ROWS + warp * 16 + g;
  float ls[W][LISTS];
  Ids<W> ids;
  // TOPK: entry `lane` of the top k of queries q0 + 16 warp + i (i < 16)
  // over this warpgroup's rows of the tile
  float ks[WARP_QUERIES];
  int kr[WARP_QUERIES];
  float* const score_tile = reinterpret_cast<float*>(smem + lay.scores);
  // WIDE: the list of query ql at list_s / list_r + 32 W ql, which warp
  // ql / WIDE_QUERIES (of the block's 8) alone reads and writes
  constexpr int KP = 32 * W;
  float* const list_s = reinterpret_cast<float*>(smem + lay.lists);
  uint16_t* const list_r = reinterpret_cast<uint16_t*>(smem + lay.lists + QN * KP * 4);
  auto reset = [&]() {
    if constexpr (MODE == TOPK) {
#pragma unroll
      for (int i = 0; i < WARP_QUERIES; ++i) {
        ks[i] = -CUDART_INF_F;
        kr[i] = 0x7fffffff;
      }
    } else if constexpr (MODE == WIDE) {
      const int first = (tid >> 5) * WIDE_QUERIES * KP;
      for (int e = lane; e < WIDE_QUERIES * KP; e += 32) {
        list_s[first + e] = -CUDART_INF_F;
        list_r[first + e] = WIDE_PLACE;
      }
    } else if constexpr (MODE != SCORES) {
#pragma unroll
      for (int L = 0; L < LISTS; ++L) {
#pragma unroll
        for (int w = 0; w < W; ++w) ls[w][L] = -CUDART_INF_F;
        ids.v[L] = 0;
      }
    }
  };
  auto out_at = [&](int tile, int q, int n_out) {
    return flags & F_QUERY_MAJOR
               ? (static_cast<size_t>(q) * n_tiles + tile) * n_out
               : (static_cast<size_t>(tile) * b + q) * n_out;
  };
  // the tile's lists to the output
  auto flush = [&](int tile) {
    const long long tile_base = static_cast<long long>(tile) * tile_n;
#pragma unroll
    for (int L = 0; L < LISTS; ++L) {
      const int q = q0 + 8 * (L >> 2) + 2 * t + (L & 1);
      if (q >= b) continue;
      const int lgl = lg + 8 * ((L >> 1) & 1);
      const size_t o = out_at(tile, q, W * CHUNK) + lgl;
      uint32_t next = 0;  // F_LOW_ROWS: the next chunk an empty slot may name
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const float s = ls[w][L];
        long long r = 0;
        if (MODE == TOPW) {
          if (s != -CUDART_INF_F) {
            r = tile_base + static_cast<long long>(id_of<W>(ids, w, L)) * CHUNK + lgl;
          } else if (flags & F_LOW_ROWS) {
            // the lowest chunk no finite entry names (those come first)
            for (bool taken = true; taken;) {
              taken = false;
#pragma unroll
              for (int v = 0; v < W; ++v)
                taken = taken || (ls[v][L] != -CUDART_INF_F && id_of<W>(ids, v, L) == next);
              next += taken;
            }
            r = tile_base + static_cast<long long>(next++) * CHUNK + lgl;
          } else if (flags & F_GROUP_ROW) {
            r = tile_base + lgl;
          }
        }
        out_s[o + w * CHUNK] = s;
        out_i[o + w * CHUNK] = static_cast<int>(r);
      }
    }
  };
  // TOPK: the chunk's 64 rows (from row0) of this warpgroup's score tile
  // into the warp's 16 queries' lists, four queries at a time so that
  // their steps overlap (each query's are a chain of shuffles). A tile's
  // first chunk: a bitonic sort of each query's 64 (score, row) pairs, two
  // a lane, whose first k are the list. Later chunks, a half (32 rows) at a
  // time: the rows that beat the k-th entry (a ballot) are packed into the
  // query's row of the score tile (read already) and inserted in turn
  // (insert_entry). The per-candidate work is the cost here (~105
  // candidates a list a tile at k 32 and 2,048 rows, ~53 at k 16), so it
  // is kept to two shared-memory reads and one insertion. The loop over
  // the groups is not unrolled (one copy of its body: the sort alone is
  // ~600 instructions); the lists rotate through ks[0..3] / kr[0..3].
  auto topk_merge = [&](int row0, bool first) {
    float* sc = score_tile + wg * (QN * WG_ROWS);
    constexpr int G = 4;
#pragma unroll 1
    for (int i = 0; i < WARP_QUERIES; i += G) {
      float s0[G], s1[G];
      int r0[G], r1[G];
      bool live[G];
#pragma unroll
      for (int u = 0; u < G; ++u) {
        const int ql = warp * WARP_QUERIES + i + u;
        live[u] = q0 + ql < b;
        s0[u] = sc[score_at(ql, lane)];
        s1[u] = sc[score_at(ql, lane + 32)];
        r0[u] = row0 + lane;
        r1[u] = row0 + lane + 32;
      }
      if (first) {
#pragma unroll 1
        for (int size = 2; size <= 64; size <<= 1) {
#pragma unroll 1
          for (int d = size >> 1; d > 0; d >>= 1) {
#pragma unroll
            for (int u = 0; u < G; ++u) sort_step(s0[u], r0[u], s1[u], r1[u], size, d, lane);
          }
        }
#pragma unroll
        for (int u = 0; u < G; ++u) {
          ks[u] = s0[u];
          kr[u] = r0[u];
        }
      } else {
        // each half of the chunk in turn (the second against the k-th
        // entries the first left): its candidates packed into the query's
        // row of the score tile (read already), then inserted in order
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          int n[G];
#pragma unroll
          for (int u = 0; u < G; ++u) {
            const float kth_s = __shfl_sync(0xffffffffu, ks[u], k - 1);
            const int kth_r = __shfl_sync(0xffffffffu, kr[u], k - 1);
            const float x = half ? s1[u] : s0[u];
            const int xr = half ? r1[u] : r0[u];
            const bool in = live[u] && precedes(x, xr, kth_s, kth_r);
            const unsigned m = __ballot_sync(0xffffffffu, in);
            n[u] = __popc(m);
            float* ts = sc + (warp * WARP_QUERIES + i + u) * WG_ROWS;
            const int at = __popc(m & ((1u << lane) - 1));
            if (in) {
              ts[at] = x;
              reinterpret_cast<int*>(ts)[TOPK_MAX + at] = xr;
            }
          }
          __syncwarp();
          int most = 0;
#pragma unroll
          for (int u = 0; u < G; ++u) most = max(most, n[u]);
          for (int j = 0; j < most; ++j) {
            // a query without a j-th candidate inserts (-inf, INT_MAX),
            // which precedes no entry
#pragma unroll
            for (int u = 0; u < G; ++u) {
              const float* ts = sc + (warp * WARP_QUERIES + i + u) * WG_ROWS;
              const bool have = j < n[u];
              const float x = ts[have ? j : 0];
              const int xr = reinterpret_cast<const int*>(ts)[TOPK_MAX + (have ? j : 0)];
              insert_entry(ks[u], kr[u], have ? x : -CUDART_INF_F, have ? xr : 0x7fffffff,
                           lane);
            }
          }
          __syncwarp();
        }
      }
      // the next group's lists into ks[0..3] / kr[0..3]
#pragma unroll
      for (int u = 0; u < G; ++u) {
        const float s_ = ks[u];
        const int r_ = kr[u];
#pragma unroll
        for (int v = u; v + G < WARP_QUERIES; v += G) {
          ks[v] = ks[v + G];
          kr[v] = kr[v + G];
        }
        ks[WARP_QUERIES - G + u] = s_;
        kr[WARP_QUERIES - G + u] = r_;
      }
    }
  };
  // TOPK: the two warpgroups' lists of the tile merged into [B, T, k]: each
  // entry goes to its index plus the number of the other list's entries
  // that precede it (the lists hold distinct rows, each sorted)
  auto topk_flush = [&](int tile) {
    float* mine_s = score_tile + wg * (QN * WG_ROWS);  // [QN][32] scores, then rows
    int* mine_r = reinterpret_cast<int*>(mine_s + QN * TOPK_MAX);
#pragma unroll
    for (int i = 0; i < WARP_QUERIES; ++i) {
      const int ql = warp * WARP_QUERIES + i;
      mine_s[ql * TOPK_MAX + lane] = ks[i];
      mine_r[ql * TOPK_MAX + lane] = kr[i];
    }
    __syncthreads();
    const float* other_s = score_tile + (1 - wg) * (QN * WG_ROWS);
    const int* other_r = reinterpret_cast<const int*>(other_s + QN * TOPK_MAX);
#pragma unroll
    for (int i = 0; i < WARP_QUERIES; ++i) {
      const int ql = warp * WARP_QUERIES + i;
      const int q = q0 + ql;
      if (q >= b) break;  // warp-uniform
      if (lane < k) {
        const float s = ks[i];
        const int r = kr[i];
        int lo = 0, hi = k;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (precedes(other_s[ql * TOPK_MAX + mid], other_r[ql * TOPK_MAX + mid], s, r))
            lo = mid + 1;
          else
            hi = mid;
        }
        const int pos = lane + lo;
        if (pos < k) {
          const size_t o = (static_cast<size_t>(q) * n_tiles + tile) * k + pos;
          out_s[o] = s;
          out_i[o] = r;
        }
      }
    }
    __syncthreads();  // the score tiles are free again
  };
  // WIDE: the chunk's rows into the lists of the warp's 8 queries
  // (wide_merge_query), one query at a time (two at a time, their steps
  // interleaved, ran no faster: the merge is bound by the instructions
  // it issues, not by the shuffles' latency)
  auto wide_merge = [&](int base) {
    if constexpr (MODE == WIDE) {
#pragma unroll 1
      for (int i = 0; i < WIDE_QUERIES; ++i) {
        const int ql = (tid >> 5) * WIDE_QUERIES + i;
        if (q0 + ql >= b) break;  // warp-uniform
        wide_merge_query<W>(score_tile, list_s + ql * KP, list_r + ql * KP, ql, base, k, lane);
      }
    }
  };
  // WIDE: the first k entries of the warp's queries' lists to [B, T, k]
  auto wide_flush = [&](int tile) {
    if constexpr (MODE == WIDE) {
      const long long tile_base = static_cast<long long>(tile) * tile_n;
      for (int i = 0; i < WIDE_QUERIES; ++i) {
        const int ql = (tid >> 5) * WIDE_QUERIES + i;
        const int q = q0 + ql;
        if (q >= b) break;  // warp-uniform
        const size_t o = (static_cast<size_t>(q) * n_tiles + tile) * k;
        for (int e = lane; e < k; e += 32) {
          out_s[o + e] = list_s[ql * KP + e];
          out_i[o + e] = static_cast<int>(tile_base + list_r[ql * KP + e]);
        }
      }
    }
  };

  const uint32_t img_s = smem_addr(smem);
  Dots<T> acc;
  for (int tt = 0; tt < my_tiles; ++tt) {
    const int tile = first_tile + tt;
    reset();
    for (int cl = 0; cl < tile_chunks; ++cl) {  // the chunk's index in its tile
      const int c = tt * tile_chunks + cl;  // ... and in the block's run
      acc.zero();
      for (int s = 0; s < slices; ++s) {
        const int j = c * slices + s;
        const int st = j % stages;
        if constexpr (SHARED) {
          // the shared ring: the stage released as soon as this
          // warpgroup's wgmmas have read it
          if (tid == 0) refill(j);
          __syncwarp();
          mbar_wait(full0 + 8 * st, (j / stages) & 1);
          uint64_t db = sw128_desc(smem_addr(ring + st * lay.stage));
          hold(db);
          if constexpr (SPLIT) {
            // the A words to registers (a second set of A words, to load
            // the next step's during this step's wgmmas, took ~90 more
            // registers and ran slower)
            uint32_t ah[4][4], al[4][4];
            if constexpr (Ring<T, MODE>::SUMS) acc.slice_start();
            load_a(j, ah, al);
            acc.hold_all();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                hold(ah[kk][e]);
                hold(al[kk][e]);
              }
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) acc.mma(ah[kk], al[kk], db, kk);
            wgmma_commit();
            wgmma_wait<0>();  // the A words are live until the group completes
            if constexpr (Ring<T, MODE>::SUMS) {
              acc.hold_all();
              acc.slice_end();
            }
          } else {
            // this warpgroup's rows of the stage (the terms come first)
            if (!tma) copy_rows(j);
            if constexpr (Ring<T, MODE>::SUMS && sizeof(T) == 2) acc.slice_start();
            uint64_t da = sw128_desc(smem_addr(rows_at(st)));
            hold(da);
            acc.hold_all();
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) acc.mma(da, db, kk);
            wgmma_commit();
            wgmma_wait<0>();
            if constexpr (Ring<T, MODE>::SUMS && sizeof(T) == 2) {
              acc.hold_all();
              acc.slice_end();
            }
          }
          if (wtid == 0) mbar_arrive(empty0 + 8 * st);
          __syncwarp();
          continue;
        }
        if (!tma) copy_rows(j);
        if (stage_tx != 0) mbar_wait(full0 + 8 * st, (j / stages) & 1);
        const uint32_t a = smem_addr(rows_at(st));
        uint64_t da = sw128_desc(a);
        uint64_t db = sw128_desc(resident ? img_s + s * QBYTES : a + BOX);
        hold(da);
        hold(db);
        acc.hold_all();
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if constexpr (!SPLIT) acc.mma(da, db, kk);
        }
        wgmma_commit();
        // the previous step's group has completed: refill its stage
        wgmma_wait<1>();
        if (wtid == 0 && j >= 1 && j - 1 + stages < steps) issue(j - 1 + stages);
        __syncwarp();
      }
      wgmma_wait<0>();
      acc.hold_all();
      if constexpr (Ring<T, MODE>::SUMS && sizeof(T) != 1) acc.take_sums();

      const long long row = run_base + static_cast<long long>(c) * CHUNK + lg;
      float rscale[2] = {1.0f, 1.0f};
      if (scales != nullptr) {
        rscale[0] = scales[row];
        rscale[1] = scales[row + 8];
      }
      float dot[LISTS];
#pragma unroll
      for (int L = 0; L < LISTS; ++L) {
        const int ql = 8 * (L >> 2) + 2 * t + (L & 1);
        dot[L] = acc.dot(L, sizeof(T) == 1 ? qn[2 * QN + ql] : 1.0f, rscale[(L >> 1) & 1]);
      }

      if (MODE == FIRST) {
#pragma unroll
        for (int L = 0; L < LISTS; ++L) {
          const int q = q0 + 8 * (L >> 2) + 2 * t + (L & 1);
          if (cl == 0 && q < b) {
            const size_t o = out_at(tile, q, CHUNK) + lg + 8 * ((L >> 1) & 1);
            out_s[o] = dot[L];
            out_i[o] = 0;
          }
        }
        continue;
      }
      // metric and validity, then the lists
      float sq[2] = {0.0f, 0.0f};
      bool ok[2] = {true, true};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (sqnorms != nullptr) sq[h] = sqnorms[row + 8 * h];
        if (valid != nullptr) ok[h] = valid[row + 8 * h] != 0;
      }
      const float inv[2] = {inv_norm(sq[0]), inv_norm(sq[1])};
      float* sc = score_tile + wg * (QN * WG_ROWS);
      // the last chunk's merges are done
      if constexpr (MODE == WIDE) __syncthreads();
#pragma unroll
      for (int L = 0; L < LISTS; ++L) {
        const int h = (L >> 1) & 1;
        const int ql = 8 * (L >> 2) + 2 * t + (L & 1);
        float s = dot[L];
        if (metric != DOT) s = score_of(s, qn[ql], qn[QN + ql], sq[h], inv[h], metric);
        if (!ok[h]) s = -CUDART_INF_F;
        if constexpr (MODE == TOPK || MODE == WIDE) {
          sc[score_at(ql, warp * 16 + g + 8 * h)] = s;
        } else if constexpr (MODE == SCORES) {
          if (q0 + ql < b)
            out_s[static_cast<size_t>(q0 + ql) * n_tiles * tile_n + row + 8 * h] = s;
        } else {
          list_update<MODE, W>(ls, ids, L, s, static_cast<uint32_t>(cl));
        }
      }
      if constexpr (MODE == WIDE) {
        __syncthreads();  // both score tiles are written
        wide_merge(cl * CHUNK);
      }
      if constexpr (MODE == TOPK) {
        asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
        topk_merge(static_cast<int>(run_base + static_cast<long long>(c) * CHUNK) + wg * WG_ROWS,
                   cl == 0);
        asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
      }
    }
    if constexpr (MODE == TOPK)
      topk_flush(tile);
    else if constexpr (MODE == WIDE)
      wide_flush(tile);
    else if constexpr (MODE != FIRST && MODE != SCORES)
      flush(tile);
  }
}

// The shared-memory plan of a launch over rows of width d: whether the
// query terms stay resident (never with the shared ring) and the ring's
// stages, the most that fit (0 if not even 2 do).
template <typename T, int MODE, int W>
int plan_stages(int d, bool* resident) {
  const int slices = (d * Rows<T>::BYTES + SLICE_BYTES - 1) / SLICE_BYTES;
  int stages = MAX_STAGES;
  *resident = !Ring<T, MODE>::SHARED;
  if (*resident) {
    while (stages >= 2 && layout_for<T, MODE, W>(slices, true, stages).bytes > SMEM_MAX)
      --stages;
    if (stages < 2) *resident = false;
  }
  if (!*resident) {
    stages = MAX_STAGES;
    while (stages >= 2 && layout_for<T, MODE, W>(slices, false, stages).bytes > SMEM_MAX)
      --stages;
  }
  return stages < 2 ? 0 : stages;
}

// One launch over bf16 (T = uint16_t), int8 or (TOPK, WIDE, SCORES, TOPW) f32 rows
// [n, d]: mode and W choose the instantiation; metric is applied with
// qsq/sqnorms (null for a dot); k is TOPK's and WIDE's list length. Returns
// the CUDA error of the launch.
template <typename T, int MODE, int W>
int launch(const void* values, const void* q_img, const float* q_scale, const float* qsq,
           const float* scales, const float* sqnorms, const uint8_t* valid, float* out_s,
           int* out_i, int n, int d, int b, int tile_n, int metric, int flags,
           cudaStream_t stream, int k = 0) {
  static_assert(!Rows<T>::SPLIT || MODE == TOPK || MODE == WIDE || MODE == SCORES ||
                    MODE == TOPW,
                "f32 rows have the per-query modes and TOPW only");
  if (n <= 0 || d <= 0 || b <= 0 || tile_n <= 0 || tile_n % CHUNK || n % tile_n)
    return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (MODE != FIRST && MODE != TOPK && MODE != WIDE && MODE != SCORES && W > 1) {
    if (tile_n / CHUNK > (1 << Ids<W>::BITS)) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (MODE == TOPK && (k < 1 || k > TOPK_MAX)) return static_cast<int>(cudaErrorInvalidValue);
  if (MODE == WIDE && (k < 1 || k > 32 * W || k > tile_n || tile_n > WIDE_MAX_TILE))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int BYTES = Rows<T>::BYTES;
  const int slices = (d * BYTES + SLICE_BYTES - 1) / SLICE_BYTES;
  bool resident = true;
  const int stages = plan_stages<T, MODE, W>(d, &resident);
  if (stages < 2) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map;
  memset(&map, 0, sizeof(map));
  const bool tma = (static_cast<size_t>(d) * BYTES) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(values) % 16 == 0;
  if (tma) {
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(n)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(d) * BYTES};
    const cuuint32_t box[2] = {SLICE_BYTES / BYTES, WG_ROWS};
    const cuuint32_t unit[2] = {1, 1};
    if (encode(&map, Rows<T>::TMA_TYPE, 2, const_cast<void*>(values), dims, strides, box, unit,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  flags |= (tma ? F_TMA : 0) | (resident ? F_RESIDENT : 0);
  const int n_tiles = n / tile_n;
  const int q_blocks = (b + QN - 1) / QN;
  // F_WALK: the tiles a block walks (hopper.cuh one_wave_run)
  const int per_block =
      (flags & F_WALK) ? one_wave_run(static_cast<long long>(n_tiles) * q_blocks) : 1;
  const size_t smem = layout_for<T, MODE, W>(slices, resident, stages).bytes;
  auto kernel = lanes_kernel<T, MODE, W>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(q_blocks, (n_tiles + per_block - 1) / per_block);
  kernel<<<grid, THREADS, smem, stream>>>(
      map, static_cast<const T*>(values), static_cast<const uint8_t*>(q_img), q_scale, qsq,
      scales, sqnorms, valid, out_s, out_i, d, b, tile_n, n_tiles, per_block, metric, slices,
      stages, flags, k);
  return static_cast<int>(cudaGetLastError());
}

// launch<T, MODE, W> for a runtime W in 1-3 (FIRST keeps no lists: W 1).
template <typename T, int MODE>
int launch_w(int winners, const void* values, const void* q_img, const float* q_scale,
             const float* qsq, const float* scales, const float* sqnorms,
             const uint8_t* valid, float* out_s, int* out_i, int n, int d, int b, int tile_n,
             int metric, int flags, cudaStream_t stream) {
  if constexpr (MODE == FIRST) {
    return launch<T, MODE, 1>(values, q_img, q_scale, qsq, scales, sqnorms, valid, out_s,
                              out_i, n, d, b, tile_n, metric, flags, stream);
  } else {
    switch (winners) {
      case 1: return launch<T, MODE, 1>(values, q_img, q_scale, qsq, scales, sqnorms, valid,
                                        out_s, out_i, n, d, b, tile_n, metric, flags, stream);
      case 2: return launch<T, MODE, 2>(values, q_img, q_scale, qsq, scales, sqnorms, valid,
                                        out_s, out_i, n, d, b, tile_n, metric, flags, stream);
      case 3: return launch<T, MODE, 3>(values, q_img, q_scale, qsq, scales, sqnorms, valid,
                                        out_s, out_i, n, d, b, tile_n, metric, flags, stream);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
}

}  // namespace scan_mma
}  // namespace
