// K3: row LayerNorm — replaces vit_tpu/ops/pallas/ln_kernel.py:layer_norm.
//
// Memory-bound on the H100 (one read, one write of the activation).  One
// warp per row: fp32 two-pass statistics (mean, then centred variance; the
// second and third reads of the row hit L1), eps inside the rsqrt, fp32
// affine, one rounding to the output dtype.
#include "common.cuh"

namespace vt {

template <typename T>
__global__ void __launch_bounds__(kRowThreads)
layer_norm_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                  const T* __restrict__ bias, T* __restrict__ out, int rows, int d, float eps) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // whole warps exit together
  const T* xr = x + (size_t)row * d;
  float mean, rstd;
  warp_row_stats(xr, d, eps, lane, mean, rstd);
  T* o = out + (size_t)row * d;
  for (int j = lane; j < d; j += 32)
    o[j] = from_f<T>((to_f(xr[j]) - mean) * rstd * to_f(scale[j]) + to_f(bias[j]));
}

template <typename T>
cudaError_t layer_norm(const void* x, const void* scale, const void* bias, void* out, int rows,
                       int d, float eps, cudaStream_t stream) {
  layer_norm_kernel<T><<<cdiv(rows, kRowThreads / 32), kRowThreads, 0, stream>>>(
      (const T*)x, (const T*)scale, (const T*)bias, (T*)out, rows, d, eps);
  return cudaGetLastError();
}

}  // namespace vt

extern "C" {

int vt_layer_norm(const void* x, const void* scale, const void* bias, void* out, int rows, int d,
                  float eps, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == vt::kFloat32) return (int)vt::layer_norm<float>(x, scale, bias, out, rows, d, eps, s);
  if (dtype == vt::kBFloat16) return (int)vt::layer_norm<vt::bf16>(x, scale, bias, out, rows, d, eps, s);
  return (int)cudaErrorInvalidValue;
}

// Message for a status returned by any vt_* entry point.
const char* vt_error_string(int status) { return cudaGetErrorString((cudaError_t)status); }

}  // extern "C"
