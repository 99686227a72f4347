// K5: LN2 -> FC1 -> GELU -> FC2 -> residual over a rounded x.
// Replaces vit_tpu/ops/pallas/fused_block.py:ln_mlp_residual
// (_ln_mlp_kernel, without the u stash), in both its forms: the block's
// (+ b2 + residual, rounded) and the tensor-parallel partial (vt_ln_mlp_partial:
// this shard's hidden columns, fp32 g @ W2 with no bias and no residual,
// summed across shards by the caller).
//
// The TPU kernel keeps W1 and W2 resident in VMEM and never writes the
// (rows, F) hidden activation; here two tiled GEMMs stream weight tiles
// through shared memory, with a (rows, F) scratch between them:
//   1. LN2 row statistics of x (fp32)
//   2. g = GELU(LN2(x) @ W1 + b1): LN2 applied and rounded to the dtype in
//      the A-tile load; bias + GELU in fp32; g rounded to the dtype
//   3. out = g @ W2 + b2 + x, rounded to the dtype; in the partial form
//      out = g @ W2 in fp32 (StoreEpi<float>), the TPU kernel's
//      `partial=True` epilogue
// The same epilogues as K2 (epilogue.cuh); the residual is the rounded x.
// The FC2 epilogue is a template argument, so the block's form compiles to
// the kernels it had before the partial form existed.
#include "common.cuh"
#include "epilogue.cuh"
#include "gemm.cuh"

namespace vt {

template <typename T, class Fc2Epi>
cudaError_t ln_mlp(const T* x, const T* ln_scale, const T* ln_bias, const T* w1, const T* b1,
                   const T* w2, float* stats, T* g, int rows, int d, int f, float eps,
                   int variant, Fc2Epi fc2_epi, cudaStream_t stream) {
  float* mean = stats;
  float* rstd = stats + rows;
  cudaError_t err = launch_row_stats(x, mean, rstd, rows, d, eps, stream);
  if (err != cudaSuccess) return err;
  err = launch_gemm<T>(LoadLn<T, T>{x, d, mean, rstd, ln_scale, ln_bias}, Load<T>{w1, f}, rows,
                       f, d, BiasGeluEpi<T>{b1, g, f, variant}, stream);
  if (err != cudaSuccess) return err;
  return launch_gemm<T>(Load<T>{g, f}, Load<T>{w2, d}, rows, d, f, fc2_epi, stream);
}

template <typename T>
cudaError_t ln_mlp_residual(const T* x, const T* ln_scale, const T* ln_bias, const T* w1,
                            const T* b1, const T* w2, const T* b2, float* stats, T* g, T* out,
                            int rows, int d, int f, float eps, int variant,
                            cudaStream_t stream) {
  return ln_mlp<T>(x, ln_scale, ln_bias, w1, b1, w2, stats, g, rows, d, f, eps, variant,
                   BiasResidualEpi<T, T, T>{b2, x, out, d}, stream);
}

template <typename T>
cudaError_t ln_mlp_partial(const T* x, const T* ln_scale, const T* ln_bias, const T* w1,
                           const T* b1, const T* w2, float* stats, T* g, float* out, int rows,
                           int d, int f, float eps, int variant, cudaStream_t stream) {
  return ln_mlp<T>(x, ln_scale, ln_bias, w1, b1, w2, stats, g, rows, d, f, eps, variant,
                   StoreEpi<float>{out, d}, stream);
}

}  // namespace vt

extern "C" int vt_ln_mlp_residual(const void* x, const void* ln_scale, const void* ln_bias,
                                  const void* w1, const void* b1, const void* w2, const void* b2,
                                  void* stats, void* g, void* out, int rows, int d, int f,
                                  float eps, int gelu_variant, int dtype, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == vt::kFloat32) {
    typedef float T;
    return (int)vt::ln_mlp_residual<T>((const T*)x, (const T*)ln_scale, (const T*)ln_bias,
                                       (const T*)w1, (const T*)b1, (const T*)w2, (const T*)b2,
                                       (float*)stats, (T*)g, (T*)out, rows, d, f, eps,
                                       gelu_variant, s);
  }
  if (dtype == vt::kBFloat16) {
    typedef vt::bf16 T;
    return (int)vt::ln_mlp_residual<T>((const T*)x, (const T*)ln_scale, (const T*)ln_bias,
                                       (const T*)w1, (const T*)b1, (const T*)w2, (const T*)b2,
                                       (float*)stats, (T*)g, (T*)out, rows, d, f, eps,
                                       gelu_variant, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int vt_ln_mlp_partial(const void* x, const void* ln_scale, const void* ln_bias,
                                 const void* w1, const void* b1, const void* w2, void* stats,
                                 void* g, void* out, int rows, int d, int f, float eps,
                                 int gelu_variant, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == vt::kFloat32) {
    typedef float T;
    return (int)vt::ln_mlp_partial<T>((const T*)x, (const T*)ln_scale, (const T*)ln_bias,
                                      (const T*)w1, (const T*)b1, (const T*)w2, (float*)stats,
                                      (T*)g, (float*)out, rows, d, f, eps, gelu_variant, s);
  }
  if (dtype == vt::kBFloat16) {
    typedef vt::bf16 T;
    return (int)vt::ln_mlp_partial<T>((const T*)x, (const T*)ln_scale, (const T*)ln_bias,
                                      (const T*)w1, (const T*)b1, (const T*)w2, (float*)stats,
                                      (T*)g, (float*)out, rows, d, f, eps, gelu_variant, s);
  }
  return (int)cudaErrorInvalidValue;
}
