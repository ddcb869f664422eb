// Fused corpus scan + per-tile selection for Hopper (sm_90a): four
// kernels on the body in scan_kernel.cuh.
//
//   scan_topk_exact       (K1) replaces vectorlite_tpu/kernels/pallas_scan.py
//                         _tile_kernel: exact top-k of each corpus tile,
//                         for k > 32 (csrc/exact.cu serves k <= 32 on the
//                         tensor-core body; kernels/scan.py exact_route).
//   scan_topk_exact_int8  (K2) replaces pallas_scan.py _tile_kernel_int8:
//                         K1 over int8 rows, dot scaled by the row's scale
//                         (k > 32, as K1).
//   scan_block_topw       (K3) replaces pallas_scan.py _block_topw_kernel:
//                         top-W of every lane group (tile rows = l mod 128).
//   scan_topk_l1          (K4) replaces vectorlite_tpu/kernels/pallas_l1.py
//                         _l1_tile_kernel: K1 with 1 / (1 + sum |q - v|),
//                         for k > 32 (csrc/l1.cu serves k <= 32 on an FADD
//                         stream fed by TMA; kernels/scan.py exact_route).
//
// Bounds at the main-path shape (B = 256 queries, N = 2^20 rows, D = 384),
// from H100 SXM data-sheet rates at 700 W, priced at the precision each
// function needs. K1 over f32 rows contracts in full f32 (the reference's
// Precision.HIGHEST): 2*B*N*D = 206 GFLOP at 67 TFLOP/s of f32 outside the
// tensor cores is 3.1 ms, against 0.48 ms to read 1.61 GB of rows at
// 3.35 TB/s. K2 and K3 over int8 rows need one bf16 pass (the reference
// contracts them at DEFAULT precision): 206 GFLOP at 989 TFLOP/s is
// 0.21 ms, against 0.12 ms of row bytes. K4 has no matmul form: |q - v| +
// acc is two FADD instructions (a subtract, then an add with |.| as a free
// source modifier; sm_90 has no packed f32 add), and an FADD issues at the
// FMA rate, 132 SMs x 128 lanes x 1.98 GHz = 33.5e12 a second: 2*B*N*D =
// 206 G instructions take 6.155 ms. (The 67 TFLOP/s above counts an FMA as
// two operations; pricing K4's 3*B*N*D "operations" at it gave 4.6 ms, a
// time no FADD stream can reach.) chip_smoke.py prints each bound from its
// run's shapes.
//
// Each C entry launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include "scan_kernel.cuh"

namespace {

// K1/K2/K4: lists in shared memory up to SHARED_LIST_MAX, in the output
// beyond.
template <typename T, bool SCALED, bool L1>
int launch_exact(const float* q_t, const float* qsq, const void* values,
                 const float* scales, const float* sqnorms,
                 const uint8_t* valid, float* out_s, int* out_i, int n, int d,
                 int b, int k, int tile_n, int metric, cudaStream_t stream) {
  auto f = k <= SHARED_LIST_MAX ? launch_sel<T, SCALED, LIST_SHARED, L1>
                                : launch_sel<T, SCALED, LIST_GLOBAL, L1>;
  return f(q_t, qsq, values, scales, sqnorms, valid, out_s, out_i, n, d, b, k,
           tile_n, 0, metric, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32 rows, 1 = bfloat16 rows.
int scan_topk_exact(const void* q_t, const void* qsq, const void* values,
                    int dtype, const void* sqnorms, const void* valid,
                    void* out_s, void* out_i, int n, int d, int b, int k,
                    int tile_n, int metric, void* stream) {
  auto f = dtype == 1 ? launch_exact<__nv_bfloat16, false, false>
                      : launch_exact<float, false, false>;
  return f(static_cast<const float*>(q_t), static_cast<const float*>(qsq),
           values, nullptr, static_cast<const float*>(sqnorms),
           static_cast<const uint8_t*>(valid), static_cast<float*>(out_s),
           static_cast<int*>(out_i), n, d, b, k, tile_n, metric,
           static_cast<cudaStream_t>(stream));
}

int scan_topk_exact_int8(const void* q_t, const void* qsq, const void* values,
                         const void* scales, const void* sqnorms,
                         const void* valid, void* out_s, void* out_i, int n,
                         int d, int b, int k, int tile_n, int metric,
                         void* stream) {
  return launch_exact<int8_t, true, false>(
      static_cast<const float*>(q_t), static_cast<const float*>(qsq), values,
      static_cast<const float*>(scales), static_cast<const float*>(sqnorms),
      static_cast<const uint8_t*>(valid), static_cast<float*>(out_s),
      static_cast<int*>(out_i), n, d, b, k, tile_n, metric,
      static_cast<cudaStream_t>(stream));
}

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
  auto f = dtype == 1 ? launch_exact<__nv_bfloat16, false, true>
                      : launch_exact<float, false, true>;
  return f(static_cast<const float*>(q_t), nullptr, values, nullptr, nullptr,
           static_cast<const uint8_t*>(valid), static_cast<float*>(out_s),
           static_cast<int*>(out_i), n, d, b, k, tile_n, 0,
           static_cast<cudaStream_t>(stream));
}

}  // extern "C"
