// K16: out_proj + residual -> LN2 -> int8 FC1 -> GELU -> int8 FC2 ->
// residual.  Replaces vit_tpu/ops/pallas/quant_kernels.py:
// out_ln_mlp_residual_q8 (_out_ln_mlp_q8_kernel).
//
// W_o stays in the working dtype; W1 and W2 are int8 [in, out] with fp32
// per-column scales.  The TPU kernel keeps every weight and intermediate in
// VMEM; here, over device scratches:
//   1. x1 = ctx @ W_o + b_o + res     -> fp32, never rounded (K2's stage 1)
//   2-5. the W8A8 MLP on x1: LN2 and per-row codes hq, hs; mid =
//      GELU((hq @ W1q) hs w1s + b1) in fp32; per-row codes mq, ms of mid;
//      out = (mq @ W2q) ms w2s + b2 + x1, rounded to the dtype
// What bounds it on the H100: operations (B/16 batch 100: 23 GFLOP of
// out_proj, 2 x 93 G int8 operations).  bf16 (the main path) runs stage 1
// on gemm_mma.cuh's TMA + wgmma core (K2's bf16 stage 1), and the int8
// GEMMs on gemm_mma_q8.cuh's, which reads both operands K-major: the
// sequence first copies W1q and W2q transposed into the w1t and w2t
// scratches (2.4 MB each at B/16).  The two row quantizers are K16's own
// passes, which hold each row in registers and so read the fp32 x1 and mid
// once each; stages 2-5 are gemm_mma_q8.cuh's mlp_q8_mma, which the bf16
// K17 runs on its own x.  fp32 keeps the first design: gemm.cuh's FMA
// out_proj (never TF32), then mlp_q8.cuh's WMMA int8 MLP, the one the fp32
// K17 runs.
//
// vt_gemm_q8_mma_dequant is the int8 core alone, (A @ B) sa sb in fp32 with
// B given K-major, and vt_transpose_q8 the weight copy alone, for their
// exactness tests and timings; no model path calls them.
#include "common.cuh"
#include "epilogue.cuh"
#include "gemm.cuh"
#include "gemm_mma.cuh"
#include "gemm_mma_q8.cuh"
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

// bf16 on the tensor-core cores: w1t (f, d) and w2t (d, f) hold W1q and
// W2q K-major
cudaError_t out_ln_mlp_residual_q8_mma(const bf16* ctx, const bf16* res, const bf16* wo,
                                       const bf16* bo, const bf16* ln_scale, const bf16* ln_bias,
                                       const int8_t* w1q, const float* w1s, const bf16* b1,
                                       const int8_t* w2q, const float* w2s, const bf16* b2,
                                       int8_t* w1t, int8_t* w2t, float* x1, int8_t* hq,
                                       float* hs, float* mid, int8_t* mq, float* ms, bf16* out,
                                       int rows, int d_ctx, int d, int f, float eps, int variant,
                                       cudaStream_t stream) {
  if (rows <= 0) return cudaSuccess;
  VT_TRY(launch_gemm_mma(ctx, d_ctx, wo, d, rows, d, d_ctx,
                         BiasResidualEpi<bf16, bf16, float>{bo, res, x1, d}, stream));
  return mlp_q8_mma<float>(x1, ln_scale, ln_bias, w1q, w1s, b1, w2q, w2s, b2, w1t, w2t, hq, hs,
                           mid, mq, ms, out, rows, d, f, eps, variant, stream);
}

}  // namespace vt

// `w1t` and `w2t` (f x d int8 each) are bf16's scratches; fp32 takes null
extern "C" int vt_out_ln_mlp_residual_q8(const void* ctx, const void* res, const void* wo,
                                         const void* bo, const void* ln_scale,
                                         const void* ln_bias, const void* w1q, const void* w1s,
                                         const void* b1, const void* w2q, const void* w2s,
                                         const void* b2, void* w1t, void* w2t, void* x1, void* hq,
                                         void* hs, void* mid, void* mq, void* ms, void* out,
                                         int rows, int d_ctx, int d, int f, float eps,
                                         int gelu_variant, int dtype, int device, void* stream) {
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
    return (int)vt::out_ln_mlp_residual_q8_mma(
        (const T*)ctx, (const T*)res, (const T*)wo, (const T*)bo, (const T*)ln_scale,
        (const T*)ln_bias, (const int8_t*)w1q, (const float*)w1s, (const T*)b1,
        (const int8_t*)w2q, (const float*)w2s, (const T*)b2, (int8_t*)w1t, (int8_t*)w2t,
        (float*)x1, (int8_t*)hq, (float*)hs, (float*)mid, (int8_t*)mq, (float*)ms, (T*)out, rows,
        d_ctx, d, f, eps, gelu_variant, s);
  }
  return (int)cudaErrorInvalidValue;
}

// out (m, n) fp32 = (a @ bt^T) sa sb: a (m, k) and bt (n, k) int8 (B given
// K-major), through the int8 TMA + wgmma core
extern "C" int vt_gemm_q8_mma_dequant(const void* a, const void* sa, const void* bt,
                                      const void* sb, void* out, int m, int n, int k, int device,
                                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)vt::launch_gemm_mma_q8((const int8_t*)a, (const int8_t*)bt, m, n, k,
                                     vt::DequantEpi{(const float*)sa, (const float*)sb,
                                                    (float*)out, n},
                                     (cudaStream_t)stream);
}

// dst (cols, rows) = src (rows, cols)^T, int8
extern "C" int vt_transpose_q8(const void* src, void* dst, int rows, int cols, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)vt::launch_transpose_q8((const int8_t*)src, (int8_t*)dst, rows, cols,
                                      (cudaStream_t)stream);
}
