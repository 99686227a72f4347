// K5: LN2 -> FC1 -> GELU -> FC2 -> residual over a rounded x.
// Replaces vit_tpu/ops/pallas/fused_block.py:ln_mlp_residual
// (_ln_mlp_kernel), in both its forms: the block's (+ b2 + residual,
// rounded) and the tensor-parallel partial (vt_ln_mlp_partial: this shard's
// hidden columns, fp32 g @ W2 with no bias and no residual, summed across
// shards by the caller); each with the pre-GELU stash u = round(h W1 + b1)
// when `u` is given (the TPU kernel's `return_u`).
//
// The TPU kernel keeps W1 and W2 resident in VMEM and never writes the
// (rows, F) hidden activation; here two tiled GEMMs stream weight tiles
// through shared memory, with a (rows, F) scratch g between them:
//   1. h = round(LN2(x)), fp32 statistics and affine
//   2. g = round(GELU(h @ W1 + b1)): bias + GELU in fp32 (BiasGeluEpi; with
//      the stash, BiasGeluStashEpi also writes round(u))
//   3. out = round(g @ W2 + b2 + x) (BiasResidualEpi); in the partial form
//      out = g @ W2 in fp32 (StoreEpi<float>), the TPU kernel's
//      `partial=True` epilogue
// What bounds it on the H100: operations (B/16 batch 64: 12,608 rows, 2 x
// 60 GFLOP).  bf16 (the main path) runs step 1 as a row pass that writes h
// once into a bf16 (rows, d) scratch (launch_ln_rows, the bits gemm.cuh's
// LoadLn computes), then both GEMMs on gemm_mma.cuh's TMA + wgmma core;
// K2's MLP half (out_ln_mlp_residual.cu) without its out_proj.  fp32 keeps
// the first design: row statistics, then gemm.cuh's FMA core (never TF32)
// with LN2 applied in FC1's A-tile load.  The epilogues are template
// arguments, so each form compiles to kernels of its own.
#include "common.cuh"
#include "epilogue.cuh"
#include "gemm.cuh"
#include "gemm_mma.cuh"

namespace vt {

template <typename T, class Fc1Epi, class Fc2Epi>
cudaError_t ln_mlp(const T* x, const T* ln_scale, const T* ln_bias, const T* w1, const T* w2,
                   float* stats, T* g, int rows, int d, int f, float eps, Fc1Epi fc1_epi,
                   Fc2Epi fc2_epi, cudaStream_t stream) {
  float* mean = stats;
  float* rstd = stats + rows;
  cudaError_t err = launch_row_stats(x, mean, rstd, rows, d, eps, stream);
  if (err != cudaSuccess) return err;
  err = launch_gemm<T>(LoadLn<T, T>{x, d, mean, rstd, ln_scale, ln_bias}, Load<T>{w1, f}, rows,
                       f, d, fc1_epi, stream);
  if (err != cudaSuccess) return err;
  return launch_gemm<T>(Load<T>{g, f}, Load<T>{w2, d}, rows, d, f, fc2_epi, stream);
}

// bf16 on the tensor-core core: h (rows, d) holds round(LN2(x))
template <class Fc1Epi, class Fc2Epi>
cudaError_t ln_mlp_mma(const bf16* x, const bf16* ln_scale, const bf16* ln_bias, const bf16* w1,
                       const bf16* w2, bf16* h, const bf16* g, int rows, int d, int f, float eps,
                       Fc1Epi fc1_epi, Fc2Epi fc2_epi, cudaStream_t stream) {
  if (rows <= 0) return cudaSuccess;
  VT_TRY(launch_ln_rows(x, ln_scale, ln_bias, h, rows, d, eps, stream));
  VT_TRY(launch_gemm_mma(h, d, w1, f, rows, f, d, fc1_epi, stream));
  return launch_gemm_mma(g, f, w2, d, rows, d, f, fc2_epi, stream);
}

// the FC1 epilogue with or without the stash, then the chain of the dtype
template <typename T, class Fc2Epi>
cudaError_t ln_mlp_any(const T* x, const T* ln_scale, const T* ln_bias, const T* w1, const T* b1,
                       const T* w2, float* stats, T* h, T* g, T* u, int rows, int d, int f,
                       float eps, int variant, Fc2Epi fc2_epi, cudaStream_t stream) {
  auto run = [&](auto fc1_epi) {
    if constexpr (std::is_same<T, bf16>::value)
      return ln_mlp_mma(x, ln_scale, ln_bias, w1, w2, h, g, rows, d, f, eps, fc1_epi, fc2_epi,
                        stream);
    else
      return ln_mlp<T>(x, ln_scale, ln_bias, w1, w2, stats, g, rows, d, f, eps, fc1_epi,
                       fc2_epi, stream);
  };
  if (u) return run(BiasGeluStashEpi<T>{b1, g, u, f, variant});
  return run(BiasGeluEpi<T>{b1, g, f, variant});
}

template <typename T>
cudaError_t ln_mlp_residual(const T* x, const T* ln_scale, const T* ln_bias, const T* w1,
                            const T* b1, const T* w2, const T* b2, float* stats, T* h, T* g,
                            T* u, T* out, int rows, int d, int f, float eps, int variant,
                            cudaStream_t stream) {
  return ln_mlp_any<T>(x, ln_scale, ln_bias, w1, b1, w2, stats, h, g, u, rows, d, f, eps,
                       variant, BiasResidualEpi<T, T, T>{b2, x, out, d}, stream);
}

template <typename T>
cudaError_t ln_mlp_partial(const T* x, const T* ln_scale, const T* ln_bias, const T* w1,
                           const T* b1, const T* w2, float* stats, T* h, T* g, T* u, float* out,
                           int rows, int d, int f, float eps, int variant, cudaStream_t stream) {
  return ln_mlp_any<T>(x, ln_scale, ln_bias, w1, b1, w2, stats, h, g, u, rows, d, f, eps,
                       variant, StoreEpi<float>{out, d}, stream);
}

}  // namespace vt

// `stats` (2 * rows fp32) is fp32's scratch, `h` (rows, d) bf16's; the
// other may be null.  `u` (rows, f), the pre-GELU stash, may be null.
extern "C" int vt_ln_mlp_residual(const void* x, const void* ln_scale, const void* ln_bias,
                                  const void* w1, const void* b1, const void* w2, const void* b2,
                                  void* stats, void* h, void* g, void* u, void* out, int rows,
                                  int d, int f, float eps, int gelu_variant, int dtype,
                                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
#define VT_K5(T)                                                                              \
  vt::ln_mlp_residual<T>((const T*)x, (const T*)ln_scale, (const T*)ln_bias, (const T*)w1,   \
                         (const T*)b1, (const T*)w2, (const T*)b2, (float*)stats, (T*)h,     \
                         (T*)g, (T*)u, (T*)out, rows, d, f, eps, gelu_variant, s)
  if (dtype == vt::kFloat32) return (int)VT_K5(float);
  if (dtype == vt::kBFloat16) return (int)VT_K5(vt::bf16);
#undef VT_K5
  return (int)cudaErrorInvalidValue;
}

extern "C" int vt_ln_mlp_partial(const void* x, const void* ln_scale, const void* ln_bias,
                                 const void* w1, const void* b1, const void* w2, void* stats,
                                 void* h, void* g, void* u, void* out, int rows, int d, int f,
                                 float eps, int gelu_variant, int dtype, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
#define VT_K5P(T)                                                                             \
  vt::ln_mlp_partial<T>((const T*)x, (const T*)ln_scale, (const T*)ln_bias, (const T*)w1,    \
                        (const T*)b1, (const T*)w2, (float*)stats, (T*)h, (T*)g, (T*)u,      \
                        (float*)out, rows, d, f, eps, gelu_variant, s)
  if (dtype == vt::kFloat32) return (int)VT_K5P(float);
  if (dtype == vt::kBFloat16) return (int)VT_K5P(vt::bf16);
#undef VT_K5P
  return (int)cudaErrorInvalidValue;
}
