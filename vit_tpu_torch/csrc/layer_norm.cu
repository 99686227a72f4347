// K3: row LayerNorm — replaces vit_tpu/ops/pallas/ln_kernel.py:layer_norm.
//
// Memory-bound on the H100 (one read, one write of the activation: B/16
// batch 100, 19,700 x 768 bf16, 60.5 MB, 0.0181 ms at 3.35 TB/s).  One warp
// per row, fp32 statistics (mean, then the centred variance, eps inside the
// rsqrt), fp32 affine, one rounding to the output dtype.  Two kernels,
// chosen by shape up front (the wrapper's `vecs`, layer_norm.py's
// register_vecs; the launcher refuses a choice the operands do not allow):
//  - bf16 rows of d <= 256 kVecs, d a multiple of 8, every operand on the
//    16-byte grid: the register row pass, each lane holding kVecs 16-byte
//    vectors of its row (768 bf16 = 3 per lane), so the row is read from
//    device memory once with 16-byte loads and written with 16-byte stores;
//    warp_row_stats' formulas summed in another order;
//  - everything else (fp32, wider rows, other widths, a view off the
//    16-byte grid): the two-read row kernel, which reads the row through
//    warp_row_stats with element loads (the second and third reads hit L1).
#include "common.cuh"
#include "mma_bf16.cuh"

#include <type_traits>

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

// one warp per bf16 row held in registers: lane l holds 16-byte vectors l,
// l + 32, ... (8 values each) of the row's d / 8
template <int kVecs>
__global__ void __launch_bounds__(kRowThreads)
layer_norm_reg_kernel(const bf16* __restrict__ x, const bf16* __restrict__ scale,
                      const bf16* __restrict__ bias, bf16* __restrict__ out, int rows, int d,
                      float eps) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // whole warps exit together
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * d);
  const int nv = d / 8;
  uint4 v[kVecs];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int j = lane + 32 * i;
    v[i] = j < nv ? __ldcs(xr + j) : make_uint4(0u, 0u, 0u, 0u);
    const uint32_t* w = reinterpret_cast<const uint32_t*>(&v[i]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = unpack_bf16(w[e]);
      sum += f.x + f.y;
    }
  }
  const float mean = warp_sum(sum) / (float)d;
  float var = 0.f;
#pragma unroll
  for (int i = 0; i < kVecs; ++i)
    if (lane + 32 * i < nv) {
      const uint32_t* w = reinterpret_cast<const uint32_t*>(&v[i]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = unpack_bf16(w[e]);
        const float c0 = f.x - mean, c1 = f.y - mean;
        var += c0 * c0 + c1 * c1;
      }
    }
  const float rstd = rsqrtf(warp_sum(var) / (float)d + eps);
  uint4* o = reinterpret_cast<uint4*>(out + (size_t)row * d);
  const uint4* g4 = reinterpret_cast<const uint4*>(scale);
  const uint4* b4 = reinterpret_cast<const uint4*>(bias);
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int j = lane + 32 * i;
    if (j < nv) {
      const uint4 gv = g4[j], bv = b4[j];
      const uint32_t* w = reinterpret_cast<const uint32_t*>(&v[i]);
      const uint32_t* gw = reinterpret_cast<const uint32_t*>(&gv);
      const uint32_t* bw = reinterpret_cast<const uint32_t*>(&bv);
      uint4 r;
      uint32_t* rw = reinterpret_cast<uint32_t*>(&r);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = unpack_bf16(w[e]), gf = unpack_bf16(gw[e]), bf = unpack_bf16(bw[e]);
        rw[e] = pack_bf16((f.x - mean) * rstd * gf.x + bf.x, (f.y - mean) * rstd * gf.y + bf.y);
      }
      o[j] = r;
    }
  }
}

inline bool on_grid(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
cudaError_t layer_norm(const void* x, const void* scale, const void* bias, void* out, int rows,
                       int d, float eps, int vecs, cudaStream_t stream) {
  if (rows <= 0) return cudaSuccess;
  const int blocks = cdiv(rows, kRowThreads / 32);
  if (!vecs) {
    layer_norm_kernel<T><<<blocks, kRowThreads, 0, stream>>>(
        (const T*)x, (const T*)scale, (const T*)bias, (T*)out, rows, d, eps);
    return cudaGetLastError();
  }
  if constexpr (std::is_same<T, bf16>::value) {
    if (d % 8 || d > 256 * vecs || !on_grid(x) || !on_grid(scale) || !on_grid(bias) ||
        !on_grid(out))
      return cudaErrorInvalidValue;
    const bf16 *xb = (const bf16*)x, *sb = (const bf16*)scale, *bb = (const bf16*)bias;
    switch (vecs) {
      case 2:
        layer_norm_reg_kernel<2><<<blocks, kRowThreads, 0, stream>>>(xb, sb, bb, (bf16*)out, rows,
                                                                     d, eps);
        break;
      case 4:
        layer_norm_reg_kernel<4><<<blocks, kRowThreads, 0, stream>>>(xb, sb, bb, (bf16*)out, rows,
                                                                     d, eps);
        break;
      case 8:
        layer_norm_reg_kernel<8><<<blocks, kRowThreads, 0, stream>>>(xb, sb, bb, (bf16*)out, rows,
                                                                     d, eps);
        break;
      default:
        return cudaErrorInvalidValue;
    }
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;  // the register pass is bf16's
}

}  // namespace vt

extern "C" {

// vecs: 0 for the two-read row kernel, else the bf16 register pass's
// 16-byte vectors per lane (2, 4 or 8)
int vt_layer_norm(const void* x, const void* scale, const void* bias, void* out, int rows, int d,
                  float eps, int vecs, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == vt::kFloat32)
    return (int)vt::layer_norm<float>(x, scale, bias, out, rows, d, eps, vecs, s);
  if (dtype == vt::kBFloat16)
    return (int)vt::layer_norm<vt::bf16>(x, scale, bias, out, rows, d, eps, vecs, s);
  return (int)cudaErrorInvalidValue;
}

// Message for a status returned by any vt_* entry point.
const char* vt_error_string(int status) { return cudaGetErrorString((cudaError_t)status); }

}  // extern "C"
