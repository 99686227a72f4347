// K16: out_proj + residual -> LN2 -> int8 FC1 -> GELU -> int8 FC2 ->
// residual.  Replaces vit_tpu/ops/pallas/quant_kernels.py:
// out_ln_mlp_residual_q8 (_out_ln_mlp_q8_kernel).
//
// W_o stays in the working dtype; W1 and W2 are int8 [in, out] with fp32
// per-column scales.  The TPU kernel keeps every weight and intermediate in
// VMEM; here, over device scratches:
//   1. x1 = ctx @ W_o + b_o + res     -> fp32, never rounded (K2's stage 1)
//   2-5. the W8A8 MLP of mlp_q8.cuh on x1
#include "common.cuh"
#include "epilogue.cuh"
#include "gemm.cuh"
#include "mlp_q8.cuh"

namespace vt {

template <typename T>
cudaError_t out_ln_mlp_residual_q8(const T* ctx, const T* res, const T* wo, const T* bo,
                                   const T* ln_scale, const T* ln_bias, const int8_t* w1q,
                                   const float* w1s, const T* b1, const int8_t* w2q,
                                   const float* w2s, const T* b2, float* x1, int8_t* hq,
                                   float* hs, float* mid, int8_t* mq, float* ms, T* out, int rows,
                                   int d_ctx, int d, int f, float eps, int variant,
                                   cudaStream_t stream) {
  VT_TRY(launch_gemm<T>(Load<T>{ctx, d_ctx}, Load<T>{wo, d}, rows, d, d_ctx,
                        BiasResidualEpi<T, T, float>{bo, res, x1, d}, stream));
  return mlp_q8<T, float>(x1, ln_scale, ln_bias, w1q, w1s, b1, w2q, w2s, b2, hq, hs, mid, mq, ms,
                          out, rows, d, f, eps, variant, stream);
}

}  // namespace vt

extern "C" int vt_out_ln_mlp_residual_q8(const void* ctx, const void* res, const void* wo,
                                         const void* bo, const void* ln_scale,
                                         const void* ln_bias, const void* w1q, const void* w1s,
                                         const void* b1, const void* w2q, const void* w2s,
                                         const void* b2, void* x1, void* hq, void* hs, void* mid,
                                         void* mq, void* ms, void* out, int rows, int d_ctx, int d,
                                         int f, float eps, int gelu_variant, int dtype, int device,
                                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == vt::kFloat32) {
    typedef float T;
    return (int)vt::out_ln_mlp_residual_q8<T>(
        (const T*)ctx, (const T*)res, (const T*)wo, (const T*)bo, (const T*)ln_scale,
        (const T*)ln_bias, (const int8_t*)w1q, (const float*)w1s, (const T*)b1,
        (const int8_t*)w2q, (const float*)w2s, (const T*)b2, (float*)x1, (int8_t*)hq, (float*)hs,
        (float*)mid, (int8_t*)mq, (float*)ms, (T*)out, rows, d_ctx, d, f, eps, gelu_variant, s);
  }
  if (dtype == vt::kBFloat16) {
    typedef vt::bf16 T;
    return (int)vt::out_ln_mlp_residual_q8<T>(
        (const T*)ctx, (const T*)res, (const T*)wo, (const T*)bo, (const T*)ln_scale,
        (const T*)ln_bias, (const int8_t*)w1q, (const float*)w1s, (const T*)b1,
        (const int8_t*)w2q, (const float*)w2s, (const T*)b2, (float*)x1, (int8_t*)hq, (float*)hs,
        (float*)mid, (int8_t*)mq, (float*)ms, (T*)out, rows, d_ctx, d, f, eps, gelu_variant, s);
  }
  return (int)cudaErrorInvalidValue;
}
