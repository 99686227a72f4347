// K12a: merged backward of the regularized [LN2 + MLP + residual] and
// [out_proj + residual].  Replaces vit_tpu/ops/pallas/backward.py:
// ln_mlp_out_residual_bwd_train (_ln_mlp_out_bwd_train_kernel with
// _mlp_bwd_core's inner_mask and _mlp_grad_accum).
//
// K7's chain (ln_mlp_out_residual_bwd.cu), with the regularizer gates
// regenerated from the forward's seed, never stored:
//   dy_m = (dy * dp_mlp[r]) * m_out            (fp32; GEMMs read round(dy_m))
//   g    = round(gelu(u) * m_inner)            (dW2's operand)
//   du   = ((round(dy_m) @ W2^T) * m_inner) * gelu'(u),  du_c = round(du)
//   dx1  = dy + LN-bwd(du_c @ W1^T)            (the residual path ungated)
//   dz   = (dx1_f32 * dp_attn[r]) * m_attn     (fp32; GEMMs read round(dz))
//   dctx = round(round(dz) @ W_o^T)
//   dW1 = h2^T du_c, db1 = sum du, dW2 = round(g)^T round(dy_m),
//   db2 = sum dy_m, dgamma/dbeta as in K7, dW_o = ctx^T round(dz),
//   db_o = sum dz
// dy_m and dz are hashed once per element where they are summed in fp32
// by the column sums (Gate) and once where they are written rounded into
// K7's fp32 (rows, D) scratches while those are free, so every GEMM reads
// plain tiles: no new scratch.  bf16, the path's dtype, runs K7's chain
// with the gates compiled in (mlp_bwd_mma.cuh: the TMA + wgmma core;
// round(dy_m) into dh2's scratch before the dh2 GEMM and again after dh2's
// column sums, round(dz) into its second half).  fp32 runs the chain below
// on gemm.cuh's FMA core (never TF32): round(dy_m) into dh2's scratch before
// the dh2 GEMM, then round(dz) into dh2's and round(dy_m) again into dx1's
// once their readers are done.  The gates are a template flag (none
// compiled in at p = 0); the scratch and the reductions are K7's, so zero
// rates reproduce K7 bit for bit.
#include "common.cuh"
#include "epilogue.cuh"
#include "gemm.cuh"
#include "ln_mlp_out_residual_bwd.cuh"
#include "mlp_bwd_mma.cuh"

namespace vt {

template <typename T, bool kDrop>
cudaError_t ln_mlp_out_residual_bwd_train(
    const T* dy, const T* x1, const T* ctx, const T* ln_scale, const T* ln_bias, const T* w1,
    const T* b1, const T* w2, const T* wo, const float* dp_mlp, const float* dp_attn,
    Dropout drop, T* dx1, T* dctx, float* dgamma, float* dbeta, float* dw1, float* db1,
    float* dw2, float* db2, float* dwo, float* dbo, void* workspace, int rows, int d, int f,
    int d_ctx, float eps, int variant, cudaStream_t stream) {
  Arena arena{(char*)workspace};
  const K7Scratch<T> s = k7_scratch<T>(arena, rows, d, f, d_ctx);
  const LoadLn<T, T> h2{x1, d, s.mean, s.rstd, ln_scale, ln_bias};
  const LoadLn<T, T, true> h2_t{x1, d, s.mean, s.rstd, ln_scale, ln_bias};
  const Gate<T, kDrop> dy_m{dy, d, dp_mlp, drop, kSiteMlpOut};
  const Gate<float, kDrop> dz{s.dx1f, d, dp_attn, drop, kSiteAttnOut};
  T* const dym_early = (T*)s.dh2;  // until the dh2 GEMM
  T* const dz_c = (T*)s.dh2;       // after dh2's column sums
  T* const dym_c = (T*)s.dx1f;     // after dz_c and db_o are made from dx1

  VT_TRY(launch_row_stats(x1, s.mean, s.rstd, rows, d, eps, stream));
  VT_TRY(launch_gemm<T>(h2, Load<T>{w1, f}, rows, f, d, BiasEpi<T, float>{b1, s.u, f}, stream));
  VT_TRY(launch_gate_rows(dy_m, dym_early, rows, d, stream));
  VT_TRY(launch_gemm<T>(Load<T>{dym_early, d}, Load<T, T, true>{w2, d}, rows, f, d,
                        GeluGradDropEpi<T, kDrop>{s.u, s.g, s.du_c, f, variant, drop}, stream));
  VT_TRY(launch_gemm<T>(Load<T>{s.du_c, f}, Load<T, T, true>{w1, f}, rows, d, f,
                        StoreEpi<float>{s.dh2, d}, stream));
  VT_TRY(launch_ln_bwd_rows<T>(s.dh2, x1, s.mean, s.rstd, ln_scale, dy, dx1, s.dx1f, rows, d,
                               stream));

  VT_TRY(launch_colsum(ColOf<float>{s.u, f}, rows, f, s.cpart, db1, stream));  // u holds du
  VT_TRY(launch_colsum(dy_m, rows, d, s.cpart, db2, stream));
  VT_TRY(launch_colsum(ColLnScaleGrad<T>{s.dh2, x1, s.mean, s.rstd, d}, rows, d, s.cpart, dgamma,
                       stream));
  VT_TRY(launch_colsum(ColOf<float>{s.dh2, d}, rows, d, s.cpart, dbeta, stream));
  VT_TRY(launch_colsum(dz, rows, d, s.cpart, dbo, stream));
  VT_TRY(launch_gate_rows(dz, dz_c, rows, d, stream));
  VT_TRY(launch_gate_rows(dy_m, dym_c, rows, d, stream));

  VT_TRY(launch_gemm<T>(Load<T>{dz_c, d}, Load<T, T, true>{wo, d}, rows, d_ctx, d,
                        StoreEpi<T>{dctx, d_ctx}, stream));
  VT_TRY(launch_wgrad<T>(h2_t, Load<T>{s.du_c, f}, d, f, rows, dw1, s.wpart, stream));
  VT_TRY(launch_wgrad<T>(Load<T, T, true>{s.g, f}, Load<T>{dym_c, d}, f, d, rows, dw2, s.wpart,
                         stream));
  VT_TRY(launch_wgrad<T>(Load<T, T, true>{ctx, d_ctx}, Load<T>{dz_c, d}, d_ctx, d, rows, dwo,
                         s.wpart, stream));
  return cudaSuccess;
}

}  // namespace vt

extern "C" {

size_t vt_ln_mlp_out_residual_bwd_train_workspace(int rows, int d, int f, int d_ctx, int dtype) {
  vt::Arena a{nullptr};
  if (dtype == vt::kBFloat16)
    vt::mlp_bwd_mma_scratch(a, rows, d, f, d_ctx);
  else
    vt::k7_scratch<float>(a, rows, d, f, d_ctx);
  return a.off;
}

int vt_ln_mlp_out_residual_bwd_train(
    const void* dy, const void* x1, const void* ctx, const void* ln_scale, const void* ln_bias,
    const void* w1, const void* b1, const void* w2, const void* wo, const void* dp_mlp,
    const void* dp_attn, void* dx1, void* dctx, void* dgamma, void* dbeta, void* dw1, void* db1,
    void* dw2, void* db2, void* dwo, void* dbo, void* workspace, int rows, int d, int f,
    int d_ctx, float eps, int gelu_variant, uint32_t seed, uint32_t thresh, float keep,
    int dropout, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const vt::Dropout drop{seed, thresh, keep};
#define VT_K12A(T, D)                                                                          \
  vt::ln_mlp_out_residual_bwd_train<T, D>(                                                     \
      (const T*)dy, (const T*)x1, (const T*)ctx, (const T*)ln_scale, (const T*)ln_bias,        \
      (const T*)w1, (const T*)b1, (const T*)w2, (const T*)wo, (const float*)dp_mlp,            \
      (const float*)dp_attn, drop, (T*)dx1, (T*)dctx, (float*)dgamma, (float*)dbeta,           \
      (float*)dw1, (float*)db1, (float*)dw2, (float*)db2, (float*)dwo, (float*)dbo, workspace, \
      rows, d, f, d_ctx, eps, gelu_variant, s)
  if (dtype == vt::kFloat32)
    return (int)(dropout ? VT_K12A(float, true) : VT_K12A(float, false));
#undef VT_K12A
  if (dtype == vt::kBFloat16) {
    typedef vt::bf16 T;
    vt::Arena arena{(char*)workspace};
    const vt::OutProjBwd out{(const T*)ctx, (const T*)wo, (const float*)dp_attn, (T*)dctx,
                             (float*)dwo, (float*)dbo, d_ctx};
#define VT_K12A(D)                                                                             \
  vt::mlp_residual_bwd_mma<true, D, true>(                                                     \
      vt::mlp_bwd_mma_scratch(arena, rows, d, f, d_ctx), (const T*)dy, (const T*)x1,           \
      (const T*)ln_scale, (const T*)ln_bias, (const T*)w1, (const T*)b1, (const T*)w2,         \
      (const float*)dp_mlp, drop, (T*)dx1, (float*)dgamma, (float*)dbeta, (float*)dw1,         \
      (float*)db1, (float*)dw2, (float*)db2, rows, d, f, eps, gelu_variant, s, out)
    return (int)(dropout ? VT_K12A(true) : VT_K12A(false));
#undef VT_K12A
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
