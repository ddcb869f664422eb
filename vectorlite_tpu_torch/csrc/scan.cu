// Fused corpus scan + per-tile selection for Hopper (sm_90a): two kernels
// on the body in scan_kernel.cuh.
//
//   scan_block_topw       (K3) replaces vectorlite_tpu/kernels/pallas_scan.py
//                         _block_topw_kernel: top-W of every lane group
//                         (tile rows = l mod 128), over f32 rows or W > 3
//                         (csrc/lanes.cu serves int8 and bf16 rows).
//   scan_topk_l1          (K4) replaces vectorlite_tpu/kernels/pallas_l1.py
//                         _l1_tile_kernel: exact top-k of 1 / (1 + sum |q -
//                         v|), for k > 32 (csrc/l1.cu serves k <= 32 on an
//                         FADD stream fed by TMA; kernels/scan.py exact_route).
//
// K1 and K2 (pallas_scan.py _tile_kernel, _tile_kernel_int8) left this body
// entirely: the tensor-core body serves them up to k = 256 (csrc/exact.cu,
// wide.cu) and csrc/select.cu beyond it and over tiles past 32,768 rows.
//
// Bounds at the main-path shape (B = 256 queries, N = 2^20 rows, D = 384),
// from H100 SXM data-sheet rates at 700 W, priced at the precision each
// function needs. K3 over f32 rows contracts in full f32 FMAs: 2*B*N*D =
// 206 GFLOP at 67 TFLOP/s of f32 outside the tensor cores is 3.1 ms,
// against 0.48 ms to read 1.61 GB of rows at 3.35 TB/s. K4 has no matmul
// form: |q - v| + acc is two FADD instructions (a subtract, then an add
// with |.| as a free source modifier; sm_90 has no packed f32 add), and an
// FADD issues at the FMA rate, 132 SMs x 128 lanes x 1.98 GHz = 33.5e12 a
// second: 2*B*N*D = 206 G instructions take 6.155 ms. (The 67 TFLOP/s above
// counts an FMA as two operations; pricing K4's 3*B*N*D "operations" at it
// gave 4.6 ms, a time no FADD stream can reach.) chip_smoke.py prints each
// bound from its run's shapes.
//
// Each C entry launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include "scan_kernel.cuh"

namespace {

// K4: lists in shared memory up to SHARED_LIST_MAX, in the output beyond.
template <typename T>
int launch_l1(const float* q_t, const void* values, const uint8_t* valid, float* out_s,
              int* out_i, int n, int d, int b, int k, int tile_n, cudaStream_t stream) {
  auto f = k <= SHARED_LIST_MAX ? launch_sel<T, false, LIST_SHARED, true>
                                : launch_sel<T, false, LIST_GLOBAL, true>;
  return f(q_t, nullptr, values, nullptr, nullptr, valid, out_s, out_i, n, d, b, k, tile_n, 0,
           0, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32 rows, 1 = bfloat16 rows, 2 = int8 rows with scales.
int scan_block_topw(const void* q_t, const void* qsq, const void* values,
                    int dtype, const void* scales, const void* sqnorms,
                    const void* valid, void* out_s, void* out_i, int n, int d,
                    int b, int tile_n, int winners, int metric, void* stream) {
  auto f = dtype == 2   ? launch_sel<int8_t, true, LANE_GROUP_TOPW, false>
           : dtype == 1 ? launch_sel<__nv_bfloat16, false, LANE_GROUP_TOPW, false>
                        : launch_sel<float, false, LANE_GROUP_TOPW, false>;
  return f(static_cast<const float*>(q_t), static_cast<const float*>(qsq),
           values, static_cast<const float*>(scales),
           static_cast<const float*>(sqnorms),
           static_cast<const uint8_t*>(valid), static_cast<float*>(out_s),
           static_cast<int*>(out_i), n, d, b, 0, tile_n, winners, metric,
           static_cast<cudaStream_t>(stream));
}

// Manhattan (K4). dtype: 0 = float32 rows, 1 = bfloat16 rows.
int scan_topk_l1(const void* q_t, const void* values, int dtype,
                 const void* valid, void* out_s, void* out_i, int n, int d,
                 int b, int k, int tile_n, void* stream) {
  auto f = dtype == 1 ? launch_l1<__nv_bfloat16> : launch_l1<float>;
  return f(static_cast<const float*>(q_t), values, static_cast<const uint8_t*>(valid),
           static_cast<float*>(out_s), static_cast<int*>(out_i), n, d, b, k, tile_n,
           static_cast<cudaStream_t>(stream));
}

}  // extern "C"
