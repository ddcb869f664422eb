// Inline PTX for Hopper (sm_90a) shared by csrc/pq.cu (K5), csrc/l1.cu
// (K4) and csrc/scan_mma.cuh (the tensor-core scan body of K1-K3, K7 and
// K8): shared-memory addresses, mbarriers, TMA bulk and tensor copies, and
// the asynchronous warpgroup matrix multiply (wgmma m64nNk16 over bf16
// operands and m64n64k8 over tf32 ones into f32 accumulators, and
// m64n64k32 over int8 operands into s32 ones; B from shared memory, A too
// but for tf32, whose A comes from registers; the sums in registers); on
// the host, cuTensorMapEncodeTiled, looked up at run time. No CUTLASS:
// what the kernels use of it is these few instructions. kernels/_build.py
// hashes this header into every CUDA library's key.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The f32 accumulator of one warpgroup's m64nNk16 tile: N / 2 registers a
// thread.
template <int N>
struct Acc {
  float v[N / 2];
};

// The s32 accumulator of one warpgroup's m64nNk32 int8 tile: N / 2
// registers a thread, in the f32 accumulator's layout.
template <int N>
struct AccS {
  int32_t v[N / 2];
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

// Whether the phase of the given parity has completed, without waiting.
__device__ __forceinline__ bool mbar_test_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.b32 %0, 1, 0, P1;\n"
      "}\n" : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
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

// TMA tensor copy of one box of a 2-D tensor map (inner coordinate x,
// outer y) into shared memory, completing on the mbarrier; the map is a
// __grid_constant__ kernel parameter.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* map, int x, int y,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
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
__device__ __forceinline__ void hold(int32_t& r) { asm volatile("" : "+r"(r) :: "memory"); }
__device__ __forceinline__ void hold(uint32_t& r) { asm volatile("" : "+r"(r) :: "memory"); }

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

// int8 x int8 -> s32, exact: D += A B with A (64 rows x 32 int8) and B (32
// x 64 int8) both K-major in shared memory (the only major order 8-bit
// wgmma takes); integer wgmma has no operand scale or transpose arguments.
__device__ __forceinline__ void wgmma_s8(AccS<64>& d, uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d.v[0]), "+r"(d.v[1]), "+r"(d.v[2]), "+r"(d.v[3]), "+r"(d.v[4]), "+r"(d.v[5]), "+r"(d.v[6]), "+r"(d.v[7]),
        "+r"(d.v[8]), "+r"(d.v[9]), "+r"(d.v[10]), "+r"(d.v[11]), "+r"(d.v[12]), "+r"(d.v[13]), "+r"(d.v[14]), "+r"(d.v[15]),
        "+r"(d.v[16]), "+r"(d.v[17]), "+r"(d.v[18]), "+r"(d.v[19]), "+r"(d.v[20]), "+r"(d.v[21]), "+r"(d.v[22]), "+r"(d.v[23]),
        "+r"(d.v[24]), "+r"(d.v[25]), "+r"(d.v[26]), "+r"(d.v[27]), "+r"(d.v[28]), "+r"(d.v[29]), "+r"(d.v[30]), "+r"(d.v[31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// tf32 x tf32 -> f32: D += A B with A (64 rows x 8 tf32) in registers, a
// warp's 16 rows four words a thread (a0 row g col t, a1 row g + 8 col t,
// a2 row g col t + 4, a3 row g + 8 col t + 4; g = lane / 4, t = lane % 4:
// mma.m16n8k8's tf32 A fragment), and B (8 x 64 tf32) K-major in shared
// memory (tf32 wgmma takes no other major order, and no transpose
// arguments). The operands are f32 words whose low 13 bits the tensor
// cores ignore; csrc/scan_mma.cuh rounds them to tf32 itself, so those
// bits are zero.
__device__ __forceinline__ void wgmma_tf32_rs(Acc<64>& d, const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d.v[0]), "+f"(d.v[1]), "+f"(d.v[2]), "+f"(d.v[3]), "+f"(d.v[4]), "+f"(d.v[5]), "+f"(d.v[6]), "+f"(d.v[7]),
        "+f"(d.v[8]), "+f"(d.v[9]), "+f"(d.v[10]), "+f"(d.v[11]), "+f"(d.v[12]), "+f"(d.v[13]), "+f"(d.v[14]), "+f"(d.v[15]),
        "+f"(d.v[16]), "+f"(d.v[17]), "+f"(d.v[18]), "+f"(d.v[19]), "+f"(d.v[20]), "+f"(d.v[21]), "+f"(d.v[22]), "+f"(d.v[23]),
        "+f"(d.v[24]), "+f"(d.v[25]), "+f"(d.v[26]), "+f"(d.v[27]), "+f"(d.v[28]), "+f"(d.v[29]), "+f"(d.v[30]), "+f"(d.v[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// The units (a tile or a chunk of rows, times the query blocks) a block
// of a walking launch takes: the fewest that keep every block's run
// within one wave of the card's SMs at one block an SM (1 where the count
// of SMs cannot be read).
inline int one_wave_run(long long units) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      sms <= 0)
    return 1;
  return static_cast<int>((units + sms - 1) / sms);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no -lcuda).
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                            &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

}  // namespace
