// K12b: split backward of the regularized [LN2 + MLP + residual].
// Replaces vit_tpu/ops/pallas/backward.py:ln_mlp_residual_bwd_train
// (_ln_mlp_bwd_train_kernel with _mlp_bwd_core's inner_mask and
// _mlp_grad_accum).  Token merging's training path runs the block's halves
// apart (the merge sits between out_proj and the MLP), so this is the MLP
// half of K12a (ln_mlp_out_residual_bwd_train.cu), cut from it as K8 is cut
// from K7:
//   dy_m = (dy * dp_mlp[r]) * m_out            (fp32; GEMMs read round(dy_m))
//   g    = round(gelu(u) * m_inner)            (dW2's operand)
//   du   = ((round(dy_m) @ W2^T) * m_inner) * gelu'(u),  du_c = round(du)
//   dx1  = dy + LN-bwd(du_c @ W1^T)            (the residual path ungated)
//   dW1 = h2^T du_c, db1 = sum du, dW2 = round(g)^T round(dy_m),
//   db2 = sum dy_m, dgamma/dbeta as in K8
// The masks are regenerated from (seed, site, row, column) — the row is the
// absolute row of this call's (rows, D) operand, so a merged layer's rows
// B * t_l hash as its forward (K11) hashed them.  dy_m is hashed once per
// element where it is summed (db2) and once more where it is written
// rounded: into K8's fp32 dh2 scratch, first before the dh2 GEMM overwrites
// it, then again after dh2's column sums are done with it.  No scratch
// beyond K8's; the gates are a template flag (none compiled in at p = 0).
// bf16, the path's dtype, runs K8's chain with the gates compiled in
// (mlp_bwd_mma.cuh: the TMA + wgmma core); fp32 runs the chain below on
// gemm.cuh's FMA core (never TF32).
#include "common.cuh"
#include "epilogue.cuh"
#include "gemm.cuh"
#include "ln_mlp_out_residual_bwd.cuh"
#include "mlp_bwd_mma.cuh"

namespace vt {

template <typename T, bool kDrop>
cudaError_t ln_mlp_residual_bwd_train(const T* dy, const T* x1, const T* ln_scale,
                                      const T* ln_bias, const T* w1, const T* b1, const T* w2,
                                      const float* dp_mlp, Dropout drop, T* dx1, float* dgamma,
                                      float* dbeta, float* dw1, float* db1, float* dw2,
                                      float* db2, void* workspace, int rows, int d, int f,
                                      float eps, int variant, cudaStream_t stream) {
  Arena arena{(char*)workspace};
  const K7Scratch<T> s = k8_scratch<T>(arena, rows, d, f);
  const LoadLn<T, T> h2{x1, d, s.mean, s.rstd, ln_scale, ln_bias};
  const LoadLn<T, T, true> h2_t{x1, d, s.mean, s.rstd, ln_scale, ln_bias};
  const Gate<T, kDrop> dy_m{dy, d, dp_mlp, drop, kSiteMlpOut};
  T* const dym_c = (T*)s.dh2;  // until the dh2 GEMM, and after dh2's column sums

  VT_TRY(launch_row_stats(x1, s.mean, s.rstd, rows, d, eps, stream));
  VT_TRY(launch_gemm<T>(h2, Load<T>{w1, f}, rows, f, d, BiasEpi<T, float>{b1, s.u, f}, stream));
  VT_TRY(launch_gate_rows(dy_m, dym_c, rows, d, stream));
  VT_TRY(launch_gemm<T>(Load<T>{dym_c, d}, Load<T, T, true>{w2, d}, rows, f, d,
                        GeluGradDropEpi<T, kDrop>{s.u, s.g, s.du_c, f, variant, drop}, stream));
  VT_TRY(launch_gemm<T>(Load<T>{s.du_c, f}, Load<T, T, true>{w1, f}, rows, d, f,
                        StoreEpi<float>{s.dh2, d}, stream));
  VT_TRY(launch_ln_bwd_rows<T>(s.dh2, x1, s.mean, s.rstd, ln_scale, dy, dx1, nullptr, rows, d,
                               stream));

  VT_TRY(launch_colsum(ColOf<float>{s.u, f}, rows, f, s.cpart, db1, stream));  // u holds du
  VT_TRY(launch_colsum(dy_m, rows, d, s.cpart, db2, stream));
  VT_TRY(launch_colsum(ColLnScaleGrad<T>{s.dh2, x1, s.mean, s.rstd, d}, rows, d, s.cpart, dgamma,
                       stream));
  VT_TRY(launch_colsum(ColOf<float>{s.dh2, d}, rows, d, s.cpart, dbeta, stream));
  VT_TRY(launch_gate_rows(dy_m, dym_c, rows, d, stream));

  VT_TRY(launch_wgrad<T>(h2_t, Load<T>{s.du_c, f}, d, f, rows, dw1, s.wpart, stream));
  VT_TRY(launch_wgrad<T>(Load<T, T, true>{s.g, f}, Load<T>{dym_c, d}, f, d, rows, dw2, s.wpart,
                         stream));
  return cudaSuccess;
}

}  // namespace vt

extern "C" {

size_t vt_ln_mlp_residual_bwd_train_workspace(int rows, int d, int f, int dtype) {
  vt::Arena a{nullptr};
  if (dtype == vt::kBFloat16)
    vt::mlp_bwd_mma_scratch(a, rows, d, f);
  else
    vt::k8_scratch<float>(a, rows, d, f);
  return a.off;
}

int vt_ln_mlp_residual_bwd_train(const void* dy, const void* x1, const void* ln_scale,
                                 const void* ln_bias, const void* w1, const void* b1,
                                 const void* w2, const void* dp_mlp, void* dx1, void* dgamma,
                                 void* dbeta, void* dw1, void* db1, void* dw2, void* db2,
                                 void* workspace, int rows, int d, int f, float eps,
                                 int gelu_variant, uint32_t seed, uint32_t thresh, float keep,
                                 int dropout, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const vt::Dropout drop{seed, thresh, keep};
#define VT_K12B(T, D)                                                                          \
  vt::ln_mlp_residual_bwd_train<T, D>(                                                         \
      (const T*)dy, (const T*)x1, (const T*)ln_scale, (const T*)ln_bias, (const T*)w1,         \
      (const T*)b1, (const T*)w2, (const float*)dp_mlp, drop, (T*)dx1, (float*)dgamma,         \
      (float*)dbeta, (float*)dw1, (float*)db1, (float*)dw2, (float*)db2, workspace, rows, d, f, \
      eps, gelu_variant, s)
  if (dtype == vt::kFloat32)
    return (int)(dropout ? VT_K12B(float, true) : VT_K12B(float, false));
#undef VT_K12B
  if (dtype == vt::kBFloat16) {
    typedef vt::bf16 T;
    vt::Arena arena{(char*)workspace};
#define VT_K12B(D)                                                                             \
  vt::mlp_residual_bwd_mma<true, D>(                                                           \
      vt::mlp_bwd_mma_scratch(arena, rows, d, f), (const T*)dy, (const T*)x1,                  \
      (const T*)ln_scale, (const T*)ln_bias, (const T*)w1, (const T*)b1, (const T*)w2,         \
      (const float*)dp_mlp, drop, (T*)dx1, (float*)dgamma, (float*)dbeta, (float*)dw1,         \
      (float*)db1, (float*)dw2, (float*)db2, rows, d, f, eps, gelu_variant, s)
    return (int)(dropout ? VT_K12B(true) : VT_K12B(false));
#undef VT_K12B
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
