// K10: out_proj + dropout + stochastic depth + residual, rounded to the
// working dtype.  Replaces vit_tpu/ops/pallas/fused_block.py:
// out_residual_train (_out_res_train_kernel).
//
// K4's GEMM (gemm.cuh) with one new epilogue (epilogue.cuh
// BiasDropResidualEpi):
//   x1 = round(((ctx @ W_o + b_o) * m_attn) * dp_attn[r] + res)
// m_attn is the attention-out site's dropout multiplier, regenerated in the
// epilogue from the hash of (seed, site, row, col) and never stored;
// dp_attn is the (rows,) fp32 stochastic-depth scale.  The dropout gate is
// a template flag: at p = 0 no hash is compiled in.
#include "common.cuh"
#include "epilogue.cuh"
#include "gemm.cuh"

namespace vt {

template <typename T, bool kDrop>
cudaError_t out_residual_train(const T* ctx, const T* res, const T* wo, const T* bo,
                               const float* dp, Dropout drop, T* out, int rows, int d_ctx, int d,
                               cudaStream_t stream) {
  return launch_gemm<T>(Load<T>{ctx, d_ctx}, Load<T>{wo, d}, rows, d, d_ctx,
                        BiasDropResidualEpi<T, kDrop>{bo, res, dp, drop, kSiteAttnOut, out, d},
                        stream);
}

}  // namespace vt

extern "C" int vt_out_residual_train(const void* ctx, const void* res, const void* wo,
                                     const void* bo, const void* dp, void* out, int rows,
                                     int d_ctx, int d, uint32_t seed, uint32_t thresh, float keep,
                                     int dropout, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const vt::Dropout drop{seed, thresh, keep};
#define VT_K10(T, D)                                                                      \
  vt::out_residual_train<T, D>((const T*)ctx, (const T*)res, (const T*)wo, (const T*)bo, \
                               (const float*)dp, drop, (T*)out, rows, d_ctx, d, s)
  if (dtype == vt::kFloat32) return (int)(dropout ? VT_K10(float, true) : VT_K10(float, false));
  if (dtype == vt::kBFloat16)
    return (int)(dropout ? VT_K10(vt::bf16, true) : VT_K10(vt::bf16, false));
#undef VT_K10
  return (int)cudaErrorInvalidValue;
}
