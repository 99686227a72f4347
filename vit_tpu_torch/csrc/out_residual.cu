// K4: out_proj + residual, rounded to the working dtype.
// Replaces vit_tpu/ops/pallas/fused_block.py:out_residual (_out_res_kernel).
//
// One tiled GEMM (gemm.cuh) over all B*T rows, with the bias and residual
// added in fp32 in its epilogue and one rounding: x1 = round(ctx @ W_o +
// b_o + res).  Unlike K2, which keeps x1 in fp32, the training forward
// rounds x1 here, and K5 and the backward read that rounded x1.
#include "common.cuh"
#include "epilogue.cuh"
#include "gemm.cuh"

namespace vt {

template <typename T>
cudaError_t out_residual(const T* ctx, const T* res, const T* wo, const T* bo, T* out, int rows,
                         int d_ctx, int d, cudaStream_t stream) {
  return launch_gemm<T>(Load<T>{ctx, d_ctx}, Load<T>{wo, d}, rows, d, d_ctx,
                        BiasResidualEpi<T, T, T>{bo, res, out, d}, stream);
}

}  // namespace vt

extern "C" int vt_out_residual(const void* ctx, const void* res, const void* wo, const void* bo,
                               void* out, int rows, int d_ctx, int d, int dtype, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == vt::kFloat32) {
    typedef float T;
    return (int)vt::out_residual<T>((const T*)ctx, (const T*)res, (const T*)wo, (const T*)bo,
                                    (T*)out, rows, d_ctx, d, s);
  }
  if (dtype == vt::kBFloat16) {
    typedef vt::bf16 T;
    return (int)vt::out_residual<T>((const T*)ctx, (const T*)res, (const T*)wo, (const T*)bo,
                                    (T*)out, rows, d_ctx, d, s);
  }
  return (int)cudaErrorInvalidValue;
}
