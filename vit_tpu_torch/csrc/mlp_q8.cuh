// The W8A8 MLP shared by K16 (out_ln_mlp_residual_q8, after its out_proj
// stage, on fp32 x1) and K17 (ln_mlp_residual_q8, on the dtype's x):
// quant_kernels.py:_out_ln_mlp_q8_kernel's tail and _ln_mlp_q8_kernel.
//   1. LN2 of x1 in fp32, per-row int8 codes hq and scales hs
//   2. mid = GELU((hq @ W1q) hs w1s + b1), int8 GEMM with exact int32 sums;
//      mid stays fp32 in a (rows, F) device scratch, because the next
//      quantizer needs each row's largest |mid| over all F columns, which
//      span many column tiles
//   3. per-row int8 codes mq and scales ms of mid
//   4. out = (mq @ W2q) ms w2s + b2 + x1, rounded to the dtype
#pragma once

#include "common.cuh"
#include "gemm_q8.cuh"
#include "quant_rows.cuh"

namespace vt {

template <typename T, typename TRes>
cudaError_t mlp_q8(const TRes* x1, const T* ln_scale, const T* ln_bias, const int8_t* w1q,
                   const float* w1s, const T* b1, const int8_t* w2q, const float* w2s,
                   const T* b2, int8_t* hq, float* hs, float* mid, int8_t* mq, float* ms, T* out,
                   int rows, int d, int f, float eps, int variant, cudaStream_t stream) {
  VT_TRY(launch_ln_quant_rows(x1, ln_scale, ln_bias, hq, hs, rows, d, eps, stream));
  VT_TRY(launch_gemm_q8(hq, w1q, rows, f, d, DequantBiasGeluEpi<T>{hs, w1s, b1, mid, f, variant},
                        stream));
  VT_TRY(launch_quant_rows(mid, mq, ms, rows, f, stream));
  return launch_gemm_q8(mq, w2q, rows, d, f,
                        DequantBiasResidualEpi<T, TRes>{ms, w2s, b2, x1, out, d}, stream);
}

}  // namespace vt
