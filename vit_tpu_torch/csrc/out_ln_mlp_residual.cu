// K2: out_proj + residual -> LN2 -> FC1 -> GELU -> FC2 -> residual.
// Replaces vit_tpu/ops/pallas/fused_block.py:out_ln_mlp_residual
// (_out_ln_mlp_kernel).
//
// The TPU kernel keeps W_o, W1, W2 and every intermediate in VMEM.  Here
// three tiled GEMMs stream weight tiles, with the elementwise steps in
// their epilogues and device scratches between them:
//   1. x1 = ctx @ W_o + b_o + res         -> fp32 scratch, never rounded
//   2. LN2 of x1 (fp32 statistics and affine), rounded to the dtype
//   3. g = GELU(LN2(x1) @ W1 + b1)        -> bias + GELU in fp32; g rounded
//      to the dtype
//   4. out = g @ W2 + b2 + x1             -> rounded to the dtype
// GELU's erf is the A-S form in fp32 and the tanh form in bf16.
//
// What bounds it on the H100: operations (B/16 batch 100: 23 + 93 + 93
// GFLOP).  bf16 (the main path) runs the three GEMMs on gemm_mma.cuh's
// pipelined cp.async + wgmma core, with step 2 a row pass that writes
// LN2(x1) once into a bf16 scratch h2 (rows, d) the FC1 GEMM copies as is.
// fp32 keeps the parent's stages: row statistics of x1, then gemm.cuh's
// FMA core (never TF32) with LN2 applied in FC1's A-tile load.
#include "common.cuh"
#include "epilogue.cuh"
#include "gemm.cuh"
#include "gemm_mma.cuh"

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

// bf16 on the tensor-core core: h2 (rows, d) holds LN2(x1)
cudaError_t out_ln_mlp_residual_mma(const bf16* ctx, const bf16* res, const bf16* wo,
                                    const bf16* bo, const bf16* ln_scale, const bf16* ln_bias,
                                    const bf16* w1, const bf16* b1, const bf16* w2,
                                    const bf16* b2, float* x1, bf16* h2, bf16* g, bf16* out,
                                    int rows, int d_ctx, int d, int f, float eps, int variant,
                                    cudaStream_t stream) {
  if (rows <= 0) return cudaSuccess;
  VT_TRY(launch_gemm_mma(ctx, d_ctx, wo, d, rows, d, d_ctx,
                         BiasResidualEpi<bf16, bf16, float>{bo, res, x1, d}, stream));
  VT_TRY(launch_ln_rows(x1, ln_scale, ln_bias, h2, rows, d, eps, stream));
  VT_TRY(launch_gemm_mma(h2, d, w1, f, rows, f, d, BiasGeluEpi<bf16>{b1, g, f, variant}, stream));
  return launch_gemm_mma(g, f, w2, d, rows, d, f,
                         BiasResidualEpi<bf16, float, bf16>{b2, x1, out, d}, stream);
}

}  // namespace vt

// `stats` (2 * rows fp32) is fp32's scratch, `h` (rows, d) bf16's; the
// other may be null
extern "C" int vt_out_ln_mlp_residual(const void* ctx, const void* res, const void* wo,
                                      const void* bo, const void* ln_scale, const void* ln_bias,
                                      const void* w1, const void* b1, const void* w2,
                                      const void* b2, void* x1, void* stats, void* h, void* g,
                                      void* out, int rows, int d_ctx, int d, int f, float eps,
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
    return (int)vt::out_ln_mlp_residual_mma(
        (const T*)ctx, (const T*)res, (const T*)wo, (const T*)bo, (const T*)ln_scale,
        (const T*)ln_bias, (const T*)w1, (const T*)b1, (const T*)w2, (const T*)b2, (float*)x1,
        (T*)h, (T*)g, (T*)out, rows, d_ctx, d, f, eps, gelu_variant, s);
  }
  return (int)cudaErrorInvalidValue;
}
