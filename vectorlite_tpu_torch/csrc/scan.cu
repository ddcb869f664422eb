// Lane-group top-W on the CUDA-core body of scan_kernel.cuh for Hopper
// (sm_90a):
//
//   scan_block_topw       (K3) replaces vectorlite_tpu/kernels/pallas_scan.py
//                         _block_topw_kernel: top-W of every lane group
//                         (tile rows = l mod 128), over f32, bf16 or int8
//                         rows at W > 3, past the lists the tensor-core
//                         body keeps in registers (csrc/lanes.cu serves W
//                         1-3 over every row type; the index's W is 2).
//
// The rest left this body: K1 and K2 (pallas_scan.py _tile_kernel,
// _tile_kernel_int8) run on the tensor-core body (csrc/exact.cu, wide.cu,
// select.cu), K4 (pallas_l1.py _l1_tile_kernel) on csrc/l1.cu's FADD
// stream (past k 32 its scores into select.cuh's radix select), K3 and K7
// over f32 rows on the tensor-core body's 3xTF32 TOPW form (csrc/lanes.cu).
//
// Bound at the main-path shape (B = 256 queries, N = 2^20 rows, D = 384),
// from H100 SXM data-sheet rates at 700 W, priced at the precision the
// function needs: K3 over f32 rows takes the exact f32 dot the reference
// takes, whose least time on this card is three tf32 passes (3xTF32, as K1
// over f32 rows is priced): 3 x 2*B*N*D = 618 G operations at 494.7
// TFLOP/s, 1.25 ms, against 0.48 ms to read 1.61 GB of rows at 3.35 TB/s.
// This body contracts in full f32 FMAs instead, 2*B*N*D = 206 GFLOP at 67
// TFLOP/s of f32 outside the tensor cores, 3.1 ms at best (9.6 ms at W 2,
// PERF.md). chip_smoke.py prints the bound from its run's shapes.
//
// The C entry launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include "scan_kernel.cuh"

extern "C" {

// dtype: 0 = float32 rows, 1 = bfloat16 rows, 2 = int8 rows with scales.
int scan_block_topw(const void* q_t, const void* qsq, const void* values,
                    int dtype, const void* scales, const void* sqnorms,
                    const void* valid, void* out_s, void* out_i, int n, int d,
                    int b, int tile_n, int winners, int metric, void* stream) {
  auto f = dtype == 2   ? launch_topw<int8_t, true>
           : dtype == 1 ? launch_topw<__nv_bfloat16, false>
                        : launch_topw<float, false>;
  return f(static_cast<const float*>(q_t), static_cast<const float*>(qsq),
           values, static_cast<const float*>(scales),
           static_cast<const float*>(sqnorms),
           static_cast<const uint8_t*>(valid), static_cast<float*>(out_s),
           static_cast<int*>(out_i), n, d, b, tile_n, winners, metric,
           static_cast<cudaStream_t>(stream));
}

}  // extern "C"
