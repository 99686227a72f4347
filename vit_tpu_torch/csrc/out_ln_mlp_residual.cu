// K2: out_proj + residual -> LN2 -> FC1 -> GELU -> FC2 -> residual.
// Replaces vit_tpu/ops/pallas/fused_block.py:out_ln_mlp_residual
// (_out_ln_mlp_kernel).
//
// The TPU kernel keeps W_o, W1, W2 and every intermediate in VMEM.  Here
// three tiled GEMMs (gemm.cuh) stream weight tiles, with the elementwise
// steps in their loads and epilogues and two device scratches:
//   1. x1 = ctx @ W_o + b_o + res         -> fp32 scratch, never rounded
//   2. LN2 row statistics of x1 (fp32)
//   3. g = GELU(LN2(x1) @ W1 + b1)        -> LN2 applied and rounded to the
//      dtype in the A-tile load; bias + GELU in fp32; g rounded to the dtype
//   4. out = g @ W2 + b2 + x1             -> rounded to the dtype
// GELU's erf is the A-S form in fp32 and the tanh form in bf16.
#include "common.cuh"
#include "epilogue.cuh"
#include "gemm.cuh"

namespace vt {

template <typename T>
cudaError_t out_ln_mlp_residual(const T* ctx, const T* res, const T* wo, const T* bo,
                                const T* ln_scale, const T* ln_bias, const T* w1, const T* b1,
                                const T* w2, const T* b2, float* x1, float* stats, T* g, T* out,
                                int rows, int d_ctx, int d, int f, float eps, int variant,
                                cudaStream_t stream) {
  float* mean = stats;
  float* rstd = stats + rows;
  cudaError_t err = launch_gemm<T>(Load<T>{ctx, d_ctx}, Load<T>{wo, d}, rows, d, d_ctx,
                                   BiasResidualEpi<T, T, float>{bo, res, x1, d}, stream);
  if (err != cudaSuccess) return err;
  err = launch_row_stats(x1, mean, rstd, rows, d, eps, stream);
  if (err != cudaSuccess) return err;
  err = launch_gemm<T>(LoadLn<float, T>{x1, d, mean, rstd, ln_scale, ln_bias}, Load<T>{w1, f},
                       rows, f, d, BiasGeluEpi<T>{b1, g, f, variant}, stream);
  if (err != cudaSuccess) return err;
  return launch_gemm<T>(Load<T>{g, f}, Load<T>{w2, d}, rows, d, f,
                        BiasResidualEpi<T, float, T>{b2, x1, out, d}, stream);
}

}  // namespace vt

extern "C" int vt_out_ln_mlp_residual(const void* ctx, const void* res, const void* wo,
                                      const void* bo, const void* ln_scale, const void* ln_bias,
                                      const void* w1, const void* b1, const void* w2,
                                      const void* b2, void* x1, void* stats, void* g, void* out,
                                      int rows, int d_ctx, int d, int f, float eps,
                                      int gelu_variant, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == vt::kFloat32) {
    typedef float T;
    return (int)vt::out_ln_mlp_residual<T>(
        (const T*)ctx, (const T*)res, (const T*)wo, (const T*)bo, (const T*)ln_scale,
        (const T*)ln_bias, (const T*)w1, (const T*)b1, (const T*)w2, (const T*)b2, (float*)x1,
        (float*)stats, (T*)g, (T*)out, rows, d_ctx, d, f, eps, gelu_variant, s);
  }
  if (dtype == vt::kBFloat16) {
    typedef vt::bf16 T;
    return (int)vt::out_ln_mlp_residual<T>(
        (const T*)ctx, (const T*)res, (const T*)wo, (const T*)bo, (const T*)ln_scale,
        (const T*)ln_bias, (const T*)w1, (const T*)b1, (const T*)w2, (const T*)b2, (float*)x1,
        (float*)stats, (T*)g, (T*)out, rows, d_ctx, d, f, eps, gelu_variant, s);
  }
  return (int)cudaErrorInvalidValue;
}
