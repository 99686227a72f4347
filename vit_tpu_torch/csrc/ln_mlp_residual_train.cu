// K11: LN2 -> FC1 -> GELU -> dropout -> FC2 -> dropout -> stochastic depth
// -> residual.  Replaces vit_tpu/ops/pallas/fused_block.py:
// ln_mlp_residual_train (_ln_mlp_train_kernel).
//
// K5's chain (ln_mlp_residual.cu) with gated epilogues (epilogue.cuh):
//   1. h = round(LN2(x))
//   2. g = round(gelu(h @ W1 + b1) * m_inner): the inner mask multiplies
//      in fp32 before g rounds (BiasGeluDropEpi)
//   3. out = round(((g @ W2 + b2) * m_out) * dp_mlp[r] + x)
//      (BiasDropResidualEpi at the MLP-out site)
// bf16 (the main path) writes h once into a bf16 (rows, d) scratch and runs
// both GEMMs on gemm_mma.cuh's TMA + wgmma core, which prefetches FC2's
// residual rows and drop-path scales into L2 before its epilogue; fp32
// keeps row statistics and gemm.cuh's FMA core with LN2 in FC1's A-tile
// load.  The epilogues see the global row, so the masks are K12a's and
// K12b's.  Masks are regenerated from the hash of (seed, site, row, col),
// never stored; the dropout gate is a template flag (none compiled in at
// p = 0), and then both chains are K5's bit for bit at dp = 1 (v * 1.0f is
// exact).  GELU: A-S erf in fp32, tanh-form erf in bf16, as in K5.
#include "common.cuh"
#include "epilogue.cuh"
#include "gemm.cuh"
#include "gemm_mma.cuh"

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

// bf16 on the tensor-core core: h (rows, d) holds round(LN2(x))
template <bool kDrop>
cudaError_t ln_mlp_residual_train_mma(const bf16* x, const bf16* ln_scale, const bf16* ln_bias,
                                      const bf16* w1, const bf16* b1, const bf16* w2,
                                      const bf16* b2, const float* dp, Dropout drop, bf16* h,
                                      bf16* g, bf16* out, int rows, int d, int f, float eps,
                                      int variant, cudaStream_t stream) {
  if (rows <= 0) return cudaSuccess;
  VT_TRY(launch_ln_rows(x, ln_scale, ln_bias, h, rows, d, eps, stream));
  VT_TRY(launch_gemm_mma(h, d, w1, f, rows, f, d,
                         BiasGeluDropEpi<bf16, kDrop>{b1, g, f, variant, drop}, stream));
  return launch_gemm_mma(g, f, w2, d, rows, d, f,
                         BiasDropResidualEpi<bf16, kDrop>{b2, x, dp, drop, kSiteMlpOut, out, d},
                         stream);
}

}  // namespace vt

// `stats` (2 * rows fp32) is fp32's scratch, `h` (rows, d) bf16's; the
// other may be null
extern "C" int vt_ln_mlp_residual_train(const void* x, const void* ln_scale,
                                        const void* ln_bias, const void* w1, const void* b1,
                                        const void* w2, const void* b2, const void* dp,
                                        void* stats, void* h, void* g, void* out, int rows,
                                        int d, int f, float eps, int gelu_variant,
                                        uint32_t seed, uint32_t thresh, float keep, int dropout,
                                        int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const vt::Dropout drop{seed, thresh, keep};
#define VT_K11(D)                                                                             \
  vt::ln_mlp_residual_train<float, D>((const float*)x, (const float*)ln_scale,               \
                                      (const float*)ln_bias, (const float*)w1,               \
                                      (const float*)b1, (const float*)w2, (const float*)b2,  \
                                      (const float*)dp, drop, (float*)stats, (float*)g,      \
                                      (float*)out, rows, d, f, eps, gelu_variant, s)
#define VT_K11_MMA(D)                                                                         \
  vt::ln_mlp_residual_train_mma<D>((const vt::bf16*)x, (const vt::bf16*)ln_scale,            \
                                   (const vt::bf16*)ln_bias, (const vt::bf16*)w1,            \
                                   (const vt::bf16*)b1, (const vt::bf16*)w2,                 \
                                   (const vt::bf16*)b2, (const float*)dp, drop, (vt::bf16*)h, \
                                   (vt::bf16*)g, (vt::bf16*)out, rows, d, f, eps,            \
                                   gelu_variant, s)
  if (dtype == vt::kFloat32) return (int)(dropout ? VT_K11(true) : VT_K11(false));
  if (dtype == vt::kBFloat16) return (int)(dropout ? VT_K11_MMA(true) : VT_K11_MMA(false));
#undef VT_K11
#undef VT_K11_MMA
  return (int)cudaErrorInvalidValue;
}
