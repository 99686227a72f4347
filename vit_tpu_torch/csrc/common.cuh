// Shared device helpers for the vit_tpu_torch kernels: dtype conversion,
// warp reductions, per-row LayerNorm statistics and input gradient, and the
// GELU forms with their derivatives.
//
// The numerics follow the JAX package's Pallas kernels
// (vit_tpu/ops/pallas/fused_block.py:_ln, _gelu, _erf_tanh_inner and
// mlp_kernel.py:_erf): fp32 statistics with the centred variance and eps
// inside the rsqrt; exact GELU via the Abramowitz-Stegun erf in fp32 and
// the tanh-form erf in bf16.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace vt {

// dtype codes passed from Python (vit_tpu_torch/ops/kernels/_build.py)
enum DType { kFloat32 = 0, kBFloat16 = 1 };

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
// round to nearest even, as torch's and XLA's casts do
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

// value after rounding to T, back in fp32
template <typename T> __device__ __forceinline__ float round_to(float v) { return to_f(from_f<T>(v)); }

// return a failed launch's status from the enclosing host function
#define VT_TRY(expr)                      \
  do {                                    \
    const cudaError_t err_ = (expr);      \
    if (err_ != cudaSuccess) return err_; \
  } while (0)

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One warp computes one row's fp32 mean and rstd = rsqrt(var + eps), two
// passes (mean, then the centred variance) over the row in device memory
// (the second pass hits L1).
template <typename TIn>
__device__ __forceinline__ void warp_row_stats(const TIn* __restrict__ x, int d, float eps,
                                               int lane, float& mean, float& rstd) {
  float s = 0.f;
  for (int j = lane; j < d; j += 32) s += to_f(x[j]);
  mean = warp_sum(s) / (float)d;
  float v = 0.f;
  for (int j = lane; j < d; j += 32) {
    float c = to_f(x[j]) - mean;
    v += c * c;
  }
  rstd = rsqrtf(warp_sum(v) / (float)d + eps);
}

constexpr int kRowThreads = 256;  // 8 rows (warps) per block

template <typename TIn>
__global__ void __launch_bounds__(kRowThreads)
row_stats_kernel(const TIn* __restrict__ x, float* __restrict__ mean, float* __restrict__ rstd,
                 int rows, int d, float eps) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // whole warps exit together
  float m, r;
  warp_row_stats(x + (size_t)row * d, d, eps, lane, m, r);
  if (lane == 0) {
    mean[row] = m;
    rstd[row] = r;
  }
}

template <typename TIn>
inline cudaError_t launch_row_stats(const TIn* x, float* mean, float* rstd, int rows, int d,
                                    float eps, cudaStream_t stream) {
  row_stats_kernel<TIn><<<cdiv(rows, kRowThreads / 32), kRowThreads, 0, stream>>>(
      x, mean, rstd, rows, d, eps);
  return cudaGetLastError();
}

// erf via Abramowitz-Stegun 7.1.26, |err| <= 1.5e-7 (mlp_kernel.py:_erf)
__device__ __forceinline__ float erf_as(float x) {
  const float a = fabsf(x);
  const float t = 1.0f / (1.0f + 0.3275911f * a);
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f + t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  const float y = 1.0f - poly * expf(-a * a);
  return x > 0.f ? y : (x < 0.f ? -y : 0.f);  // sign(x) * y
}

// erf(x) ~= tanh(x * q(x^2)), x clamped to [-3.2, 3.2], |err| <= 3.1e-5
// (fused_block.py:_erf_tanh_inner); also hands back the clamped x and q
__device__ __forceinline__ float erf_tanh_inner(float x, float& xc, float& q) {
  xc = fminf(fmaxf(x, -3.2f), 3.2f);
  const float t = xc * xc;
  q = 1.4501721850515667e-05f;
  q = q * t + -0.00022230843767343287f;
  q = q * t + -0.0011219408928909798f;
  q = q * t + 0.10359029852786425f;
  q = q * t + 1.1281997085186337f;
  return tanhf(xc * q);
}

__device__ __forceinline__ float erf_tanh(float x) {
  float xc, q;
  return erf_tanh_inner(x, xc, q);
}

// variant 0 = exact (erf form), 1 = tanh approximation (fused_block.py:_gelu)
__device__ __forceinline__ float gelu(float h, int variant, bool fast_erf) {
  if (variant == 0) {
    const float z = h * 0.7071067811865476f;
    const float e = fast_erf ? erf_tanh(z) : erf_as(z);
    return 0.5f * h * (1.0f + e);
  }
  return 0.5f * h * (1.0f + tanhf(0.7978845608028654f * (h + 0.044715f * h * h * h)));
}

// d gelu(u) / du in fp32 (backward.py:_gelu_grad): exact = Phi(u) + u phi(u)
// with the A-S erf, or the derivative of the tanh-form erf when fast_erf;
// tanh variant = 0.5(1+t) + 0.5 u (1-t^2) c (1 + 3*0.044715 u^2).
__device__ __forceinline__ float gelu_grad(float u, int variant, bool fast_erf) {
  if (variant == 0) {
    const float inv_sqrt2 = 0.7071067811865476f;
    if (fast_erf) {
      float sc, q;
      const float t = erf_tanh_inner(u * inv_sqrt2, sc, q);
      const float tsq = sc * sc;
      float qp = (float)(4 * 1.4501721850515667e-05);  // sum of i * Q[i] * s^(2(i-1))
      qp = qp * tsq + (float)(3 * -0.00022230843767343287);
      qp = qp * tsq + (float)(2 * -0.0011219408928909798);
      qp = qp * tsq + (float)(1 * 0.10359029852786425);
      const float vp = q + 2.0f * tsq * qp;  // d(s q(s^2)) / ds
      return 0.5f * (1.0f + t) + 0.5f * u * (1.0f - t * t) * vp * inv_sqrt2;
    }
    const float cdf = 0.5f * (1.0f + erf_as(u * inv_sqrt2));
    const float pdf = 0.3989422804014327f * expf(-0.5f * u * u);
    return cdf + u * pdf;
  }
  const float c = 0.7978845608028654f;
  const float t = tanhf(c * (u + 0.044715f * u * u * u));
  return 0.5f * (1.0f + t) + 0.5f * u * (1.0f - t * t) * c * (1.0f + (float)(3 * 0.044715) * u * u);
}

// ---- training-mode regularizer masks (fused_block.py:104-137).  The
// regularized kernels regenerate every dropout mask from a hash of
// (per-layer seed, site, absolute row, column of the site's width) —
// bit-identical to vit_tpu_torch/ops/fused_block.py:mask_hash_u32 and to
// the JAX package's — so nothing mask-shaped is stored between forward and
// backward.

// DROP_SITE_* of ops/fused_block.py
enum DropSite { kSiteAttnOut = 1, kSiteMlpInner = 2, kSiteMlpOut = 3 };

// murmur3-finalizer mix, native uint32 arithmetic (wraps mod 2^32)
__device__ __forceinline__ uint32_t mask_hash(uint32_t seed, uint32_t site, uint32_t r,
                                              uint32_t c) {
  uint32_t x = r * 0x9E3779B9u + c * 0x85EBCA6Bu + seed + site * 0x27D4EB2Fu;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// Inverted dropout of rate p: keep = fp32(1/(1-p)) where the hash is at
// least thresh = uint32(p * 2^32), else 0.  Both come from the host.
struct Dropout {
  uint32_t seed;
  uint32_t thresh;
  float keep;
  __device__ __forceinline__ float operator()(int site, int r, int c) const {
    return mask_hash(seed, (uint32_t)site, (uint32_t)r, (uint32_t)c) >= thresh ? keep : 0.f;
  }
};

// LayerNorm input gradient, one warp per row (backward.py:_ln_bwd_dx, plus
// the residual join): with xhat = (x - mean) rstd and g = dh * gamma,
//   dx = dres + rstd * (g - mean(g) - xhat * mean(g * xhat))
// in fp32; written in T, and in fp32 too when dx_f32 is given.  kRes false
// leaves the join out (dx = LN-bwd alone): a kernel of its own, so the
// joining kernel keeps its machine code.
template <typename T, bool kRes>
__device__ __forceinline__ void ln_bwd_row(const float* __restrict__ dh, const T* __restrict__ x,
                                           const float* __restrict__ mean,
                                           const float* __restrict__ rstd,
                                           const T* __restrict__ gamma,
                                           const T* __restrict__ dres, T* __restrict__ dx,
                                           float* __restrict__ dx_f32, int rows, int d) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // whole warps exit together
  const size_t base = (size_t)row * d;
  const float m = mean[row], r = rstd[row];
  float s1 = 0.f, s2 = 0.f;
  for (int j = lane; j < d; j += 32) {
    const float g = dh[base + j] * to_f(gamma[j]);
    s1 += g;
    s2 += g * ((to_f(x[base + j]) - m) * r);
  }
  const float m1 = warp_sum(s1) / (float)d, m2 = warp_sum(s2) / (float)d;
  for (int j = lane; j < d; j += 32) {
    const float g = dh[base + j] * to_f(gamma[j]);
    const float xhat = (to_f(x[base + j]) - m) * r;
    const float v = kRes ? to_f(dres[base + j]) + r * (g - m1 - xhat * m2)
                         : r * (g - m1 - xhat * m2);
    dx[base + j] = from_f<T>(v);
    if (dx_f32) dx_f32[base + j] = v;
  }
}

template <typename T>
__global__ void __launch_bounds__(kRowThreads)
ln_bwd_rows_kernel(const float* __restrict__ dh, const T* __restrict__ x,
                   const float* __restrict__ mean, const float* __restrict__ rstd,
                   const T* __restrict__ gamma, const T* __restrict__ dres, T* __restrict__ dx,
                   float* __restrict__ dx_f32, int rows, int d) {
  ln_bwd_row<T, true>(dh, x, mean, rstd, gamma, dres, dx, dx_f32, rows, d);
}

template <typename T>
__global__ void __launch_bounds__(kRowThreads)
ln_bwd_rows_nores_kernel(const float* __restrict__ dh, const T* __restrict__ x,
                         const float* __restrict__ mean, const float* __restrict__ rstd,
                         const T* __restrict__ gamma, T* __restrict__ dx,
                         float* __restrict__ dx_f32, int rows, int d) {
  ln_bwd_row<T, false>(dh, x, mean, rstd, gamma, nullptr, dx, dx_f32, rows, d);
}

// dres null: no residual join (the nores kernel)
template <typename T>
inline cudaError_t launch_ln_bwd_rows(const float* dh, const T* x, const float* mean,
                                      const float* rstd, const T* gamma, const T* dres, T* dx,
                                      float* dx_f32, int rows, int d, cudaStream_t stream) {
  if (dres)
    ln_bwd_rows_kernel<T><<<cdiv(rows, kRowThreads / 32), kRowThreads, 0, stream>>>(
        dh, x, mean, rstd, gamma, dres, dx, dx_f32, rows, d);
  else
    ln_bwd_rows_nores_kernel<T><<<cdiv(rows, kRowThreads / 32), kRowThreads, 0, stream>>>(
        dh, x, mean, rstd, gamma, dx, dx_f32, rows, d);
  return cudaGetLastError();
}

}  // namespace vt
