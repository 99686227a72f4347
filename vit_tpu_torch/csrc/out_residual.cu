// K4: out_proj + residual, rounded to the working dtype.
// Replaces vit_tpu/ops/pallas/fused_block.py:out_residual (_out_res_kernel).
//
// One GEMM over all B*T rows, with the bias and residual added in fp32 in
// its epilogue and one rounding: x1 = round(ctx @ W_o + b_o + res).
// Unlike K2, which keeps x1 in fp32, the training forward rounds x1 here,
// and K5 and the backward read that rounded x1.
//
// What bounds it on the H100: operations (B/16 batch 64: 12,608 x 768 x
// 768, 14.9 GFLOP) near the bytes (ctx and the residual read, x1 written,
// 58 MB at bf16).  The TPU kernel keeps W_o resident in VMEM and streams
// 512-row blocks; here bf16 (the path's dtype) runs K2's out_proj on
// gemm_mma.cuh's TMA + wgmma core: W_o (1.2 MB) stays in L2, consecutive
// blocks share one ctx row block, and the residual rows of a tile are
// prefetched into L2 during its last k-steps, so the epilogue
// (BiasResidualEpi) reads them from there.  fp32 keeps gemm.cuh's FMA core
// (never TF32).
#include "common.cuh"
#include "epilogue.cuh"
#include "gemm.cuh"
#include "gemm_mma.cuh"

#include <type_traits>

namespace vt {

template <typename T>
cudaError_t out_residual(const T* ctx, const T* res, const T* wo, const T* bo, T* out, int rows,
                         int d_ctx, int d, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value)
    return launch_gemm_mma(ctx, d_ctx, wo, d, rows, d, d_ctx,
                           BiasResidualEpi<bf16, bf16, bf16>{bo, res, out, d}, stream);
  else
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
