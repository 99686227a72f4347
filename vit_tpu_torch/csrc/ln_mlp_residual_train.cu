// K11: LN2 -> FC1 -> GELU -> dropout -> FC2 -> dropout -> stochastic depth
// -> residual.  Replaces vit_tpu/ops/pallas/fused_block.py:
// ln_mlp_residual_train (_ln_mlp_train_kernel).
//
// K5's two GEMMs (gemm.cuh) with gated epilogues (epilogue.cuh):
//   1. LN2 row statistics of x (fp32)
//   2. g = round(gelu(LN2(x) @ W1 + b1) * m_inner): the inner mask
//      multiplies in fp32 before g rounds (BiasGeluDropEpi)
//   3. out = round(((g @ W2 + b2) * m_out) * dp_mlp[r] + x)
//      (BiasDropResidualEpi at the MLP-out site)
// Masks are regenerated from the hash of (seed, site, row, col), never
// stored; the dropout gate is a template flag (none compiled in at p = 0).
// GELU: A-S erf in fp32, tanh-form erf in bf16, as in K5.
#include "common.cuh"
#include "epilogue.cuh"
#include "gemm.cuh"

namespace vt {

template <typename T, bool kDrop>
cudaError_t ln_mlp_residual_train(const T* x, const T* ln_scale, const T* ln_bias, const T* w1,
                                  const T* b1, const T* w2, const T* b2, const float* dp,
                                  Dropout drop, float* stats, T* g, T* out, int rows, int d,
                                  int f, float eps, int variant, cudaStream_t stream) {
  float* mean = stats;
  float* rstd = stats + rows;
  VT_TRY(launch_row_stats(x, mean, rstd, rows, d, eps, stream));
  VT_TRY(launch_gemm<T>(LoadLn<T, T>{x, d, mean, rstd, ln_scale, ln_bias}, Load<T>{w1, f}, rows,
                        f, d, BiasGeluDropEpi<T, kDrop>{b1, g, f, variant, drop}, stream));
  return launch_gemm<T>(Load<T>{g, f}, Load<T>{w2, d}, rows, d, f,
                        BiasDropResidualEpi<T, kDrop>{b2, x, dp, drop, kSiteMlpOut, out, d},
                        stream);
}

}  // namespace vt

extern "C" int vt_ln_mlp_residual_train(const void* x, const void* ln_scale,
                                        const void* ln_bias, const void* w1, const void* b1,
                                        const void* w2, const void* b2, const void* dp,
                                        void* stats, void* g, void* out, int rows, int d, int f,
                                        float eps, int gelu_variant, uint32_t seed,
                                        uint32_t thresh, float keep, int dropout, int dtype,
                                        int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const vt::Dropout drop{seed, thresh, keep};
#define VT_K11(T, D)                                                                          \
  vt::ln_mlp_residual_train<T, D>((const T*)x, (const T*)ln_scale, (const T*)ln_bias,        \
                                  (const T*)w1, (const T*)b1, (const T*)w2, (const T*)b2,    \
                                  (const float*)dp, drop, (float*)stats, (T*)g, (T*)out, rows, \
                                  d, f, eps, gelu_variant, s)
  if (dtype == vt::kFloat32) return (int)(dropout ? VT_K11(float, true) : VT_K11(float, false));
  if (dtype == vt::kBFloat16)
    return (int)(dropout ? VT_K11(vt::bf16, true) : VT_K11(vt::bf16, false));
#undef VT_K11
  return (int)cudaErrorInvalidValue;
}
