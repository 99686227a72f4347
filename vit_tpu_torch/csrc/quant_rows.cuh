// Dynamic symmetric per-row int8 quantization of the W8A8 kernels' GEMM
// inputs (quant_kernels.py:_quant_rows): for a row v in fp32,
//   scale = max(max|v| / 127, 1e-12),  q = clip(round(v / scale), -127, 127)
// with a true fp32 divide and round-half-to-even (rintf), as jnp.round and
// torch.round do — a reciprocal multiply or roundf would flip codes at
// ties.  One warp per row; the row is read once per pass from device
// memory (later passes hit L1/L2).  An all-zero row gives scale 1e-12 and
// codes 0.
#pragma once

#include "common.cuh"

namespace vt {

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float quant_scale(float absmax) {
  return fmaxf(absmax / 127.0f, 1e-12f);
}

__device__ __forceinline__ int8_t quant_code(float v, float scale) {
  return (int8_t)(int)fminf(fmaxf(rintf(v / scale), -127.0f), 127.0f);
}

// q, qs = quantize rows of LayerNorm(x): h = (x - mean) rstd gamma + beta in
// fp32 from fp32 statistics, never rounded to the working dtype (stage 1 of
// K15 on the dtype's x, and of the int8 MLP on fp32 x1 or the dtype's x).
template <typename TIn, typename TP>
__global__ void __launch_bounds__(kRowThreads)
ln_quant_rows_kernel(const TIn* __restrict__ x, const TP* __restrict__ gamma,
                     const TP* __restrict__ beta, int8_t* __restrict__ q,
                     float* __restrict__ qs, int rows, int d, float eps) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // whole warps exit together
  const TIn* xr = x + (size_t)row * d;
  float mean, rstd;
  warp_row_stats(xr, d, eps, lane, mean, rstd);
  float amax = 0.f;
  for (int j = lane; j < d; j += 32) {
    const float h = (to_f(xr[j]) - mean) * rstd * to_f(gamma[j]) + to_f(beta[j]);
    amax = fmaxf(amax, fabsf(h));
  }
  const float scale = quant_scale(warp_max(amax));
  int8_t* qr = q + (size_t)row * d;
  for (int j = lane; j < d; j += 32) {
    const float h = (to_f(xr[j]) - mean) * rstd * to_f(gamma[j]) + to_f(beta[j]);
    qr[j] = quant_code(h, scale);
  }
  if (lane == 0) qs[row] = scale;
}

template <typename TIn, typename TP>
inline cudaError_t launch_ln_quant_rows(const TIn* x, const TP* gamma, const TP* beta, int8_t* q,
                                        float* qs, int rows, int d, float eps,
                                        cudaStream_t stream) {
  ln_quant_rows_kernel<<<cdiv(rows, kRowThreads / 32), kRowThreads, 0, stream>>>(
      x, gamma, beta, q, qs, rows, d, eps);
  return cudaGetLastError();
}

// q, qs = quantize rows of an fp32 matrix (the GELU output `mid`)
static __global__ void __launch_bounds__(kRowThreads)
quant_rows_kernel(const float* __restrict__ v, int8_t* __restrict__ q, float* __restrict__ qs,
                  int rows, int n) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // whole warps exit together
  const float* vr = v + (size_t)row * n;
  float amax = 0.f;
  for (int j = lane; j < n; j += 32) amax = fmaxf(amax, fabsf(vr[j]));
  const float scale = quant_scale(warp_max(amax));
  int8_t* qr = q + (size_t)row * n;
  for (int j = lane; j < n; j += 32) qr[j] = quant_code(vr[j], scale);
  if (lane == 0) qs[row] = scale;
}

inline cudaError_t launch_quant_rows(const float* v, int8_t* q, float* qs, int rows, int n,
                                     cudaStream_t stream) {
  quant_rows_kernel<<<cdiv(rows, kRowThreads / 32), kRowThreads, 0, stream>>>(v, q, qs, rows, n);
  return cudaGetLastError();
}

}  // namespace vt
