// K22: FC1 + b1 -> GELU -> FC2 + b2 over (rows, D) rows; no LayerNorm, no
// residual.  Replaces vit_tpu/ops/pallas/mlp_kernel.py:mlp (_mlp_kernel),
// the per-op tier's MLP.
//
// The TPU kernel keeps W1 and W2 resident in VMEM across the row stream and
// never writes the (rows, F) hidden activation.  Bound on the H100 by
// tensor-core work (B/16 @224 batch 100: 19,700 x 768 x 3,072 twice, 186
// GFLOP); a Hopper block has 227 KB of shared memory, so this is K5's MLP
// without its LayerNorm and residual: two tiled GEMMs over a (rows, F)
// scratch `g` in device memory (121 MB at batch 100 bf16), which the TPU
// kept in VMEM:
//   1. g = round(GELU(x @ W1 + b1)): bias and GELU in fp32 in the epilogue
//      (A-S erf in fp32, tanh-form erf in bf16; or the tanh variant)
//   2. out = round(g @ W2 + b2)
// bf16 (the per-op tier's dtype on the card) runs both GEMMs on
// gemm_mma.cuh's TMA + wgmma core, K5's bf16 chain without its LN2 row pass
// and its residual; fp32 keeps gemm.cuh's FMA core, never TF32.
#include "common.cuh"
#include "epilogue.cuh"
#include "gemm.cuh"
#include "gemm_mma.cuh"

namespace vt {

template <typename T>
cudaError_t mlp(const T* x, const T* w1, const T* b1, const T* w2, const T* b2, T* g, T* out,
                int rows, int d, int f, int variant, cudaStream_t stream) {
  VT_TRY(launch_gemm<T>(Load<T>{x, d}, Load<T>{w1, f}, rows, f, d,
                        BiasGeluEpi<T>{b1, g, f, variant}, stream));
  return launch_gemm<T>(Load<T>{g, f}, Load<T>{w2, d}, rows, d, f, BiasEpi<T, T>{b2, out, d},
                        stream);
}

// bf16 on the tensor-core core
cudaError_t mlp_mma(const bf16* x, const bf16* w1, const bf16* b1, const bf16* w2, const bf16* b2,
                    bf16* g, bf16* out, int rows, int d, int f, int variant, cudaStream_t stream) {
  if (rows <= 0) return cudaSuccess;
  VT_TRY(launch_gemm_mma(x, d, w1, f, rows, f, d, BiasGeluEpi<bf16>{b1, g, f, variant}, stream));
  return launch_gemm_mma(g, f, w2, d, rows, d, f, BiasEpi<bf16, bf16>{b2, out, d}, stream);
}

}  // namespace vt

extern "C" int vt_mlp(const void* x, const void* w1, const void* b1, const void* w2,
                      const void* b2, void* g, void* out, int rows, int d, int f,
                      int gelu_variant, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == vt::kFloat32) {
    typedef float T;
    return (int)vt::mlp<T>((const T*)x, (const T*)w1, (const T*)b1, (const T*)w2, (const T*)b2,
                           (T*)g, (T*)out, rows, d, f, gelu_variant, s);
  }
  if (dtype == vt::kBFloat16) {
    typedef vt::bf16 T;
    return (int)vt::mlp_mma((const T*)x, (const T*)w1, (const T*)b1, (const T*)w2, (const T*)b2,
                            (T*)g, (T*)out, rows, d, f, gelu_variant, s);
  }
  return (int)cudaErrorInvalidValue;
}
