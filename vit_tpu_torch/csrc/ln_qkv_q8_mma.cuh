// Stages 1-2 of the bf16 W8A8 attention block, one host function shared by
// K15 (ln_qkv_attn_q8.cu: its QKV stage and the whole kernel) and K19
// (ln_qkv_attn_q8a.cu), so that both write the same packed QKV bit for bit:
// Wq's K-major copy into wqt (d3, d), LN1's row codes hq and scales hs
// (quant_rows.cuh), and the int8 QKV GEMM on gemm_mma_q8.cuh's TMA +
// wgmma core with (acc hs) ws + b rounded once to bf16 (DequantBiasEpi).
#pragma once

#include "common.cuh"
#include "gemm_mma_q8.cuh"
#include "quant_rows.cuh"

namespace vt {

inline cudaError_t ln_qkv_q8_mma(const bf16* x, const bf16* ln_scale, const bf16* ln_bias,
                                 const int8_t* wq, const float* ws, const bf16* bqkv,
                                 int8_t* wqt, int8_t* hq, float* hs, bf16* qkv, int rows, int d,
                                 int d3, float eps, cudaStream_t stream) {
  if (rows <= 0) return cudaSuccess;
  VT_TRY(launch_transpose_q8(wq, wqt, d, d3, stream));
  VT_TRY(launch_ln_quant_rows(x, ln_scale, ln_bias, hq, hs, rows, d, eps, stream));
  return launch_gemm_mma_q8(hq, wqt, rows, d3, d, DequantBiasEpi<bf16>{hs, ws, bqkv, qkv, d3},
                            stream);
}

}  // namespace vt
