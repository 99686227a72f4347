// K17: LN2 -> int8 FC1 -> GELU -> int8 FC2 -> residual over the dtype's x.
// Replaces vit_tpu/ops/pallas/quant_kernels.py:ln_mlp_residual_q8
// (_ln_mlp_q8_kernel): K16 without the out_proj head, for token merging,
// whose merge sits between the out_proj and the MLP.  What bounds it on the
// H100: operations (B/16 batch 100: 2 x 93 G int8 operations).
//
// bf16 (the main path) is the bf16 K16's chain from LN2 on with x itself
// as x1 (gemm_mma_q8.cuh's mlp_q8_mma): W1q and W2q copied K-major into
// the w1t and w2t scratches, LN2's codes by ln_quant_rows_kernel (K18a's
// stage 1, bit for bit), FC1 and FC2 on the TMA + wgmma int8 core, mid's
// codes by the register row pass.  fp32 keeps the first design: the WMMA
// int8 MLP of mlp_q8.cuh with x widened to fp32 on load.
#include "common.cuh"
#include "gemm_mma_q8.cuh"
#include "mlp_q8.cuh"

// `w1t` and `w2t` (f x d int8 each) are bf16's scratches; fp32 takes null
extern "C" int vt_ln_mlp_residual_q8(const void* x, const void* ln_scale, const void* ln_bias,
                                     const void* w1q, const void* w1s, const void* b1,
                                     const void* w2q, const void* w2s, const void* b2, void* w1t,
                                     void* w2t, void* hq, void* hs, void* mid, void* mq, void* ms,
                                     void* out, int rows, int d, int f, float eps,
                                     int gelu_variant, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == vt::kFloat32) {
    typedef float T;
    return (int)vt::mlp_q8<T, T>(
        (const T*)x, (const T*)ln_scale, (const T*)ln_bias, (const int8_t*)w1q, (const float*)w1s,
        (const T*)b1, (const int8_t*)w2q, (const float*)w2s, (const T*)b2, (int8_t*)hq,
        (float*)hs, (float*)mid, (int8_t*)mq, (float*)ms, (T*)out, rows, d, f, eps, gelu_variant,
        s);
  }
  if (dtype == vt::kBFloat16) {
    typedef vt::bf16 T;
    return (int)vt::mlp_q8_mma<T>(
        (const T*)x, (const T*)ln_scale, (const T*)ln_bias, (const int8_t*)w1q, (const float*)w1s,
        (const T*)b1, (const int8_t*)w2q, (const float*)w2s, (const T*)b2, (int8_t*)w1t,
        (int8_t*)w2t, (int8_t*)hq, (float*)hs, (float*)mid, (int8_t*)mq, (float*)ms, (T*)out, rows,
        d, f, eps, gelu_variant, s);
  }
  return (int)cudaErrorInvalidValue;
}
