// K7: merged backward of [LN2 + MLP + residual] o [out_proj + residual].
// Replaces vit_tpu/ops/pallas/backward.py:ln_mlp_out_residual_bwd
// (_ln_mlp_out_bwd_kernel with _mlp_bwd_core and _mlp_grad_accum).
//
// The TPU kernel walks row blocks in order, keeps W1, W2, W_o and the fp32
// weight-gradient accumulators resident in VMEM, and carries the sums from
// one grid step to the next.  Hopper blocks run in no order and hold 227 KB
// each, so this is a chain of tiled GEMMs (gemm.cuh) over all B*T rows with
// device scratch between them, and every reduction over rows (the weight
// gradients' depth, the bias/LN column sums) is its own deterministic pass:
//   1. LN2 row statistics of the rounded x1 (fp32)
//   2. u = LN2(x1) @ W1 + b1 -> fp32 (rows, F) scratch, never rounded
//   3. dg = dy @ W2^T; epilogue: g = round(gelu(u)), du = dg * gelu'(u)
//      (fp32, written over u), du_c = round(du)
//   4. dh2 = du_c @ W1^T -> fp32 (rows, D)
//   5. dx1 = dy + LN-bwd(dh2) in fp32, written in the dtype (output) and
//      in fp32 (for db_o)
//   6. dctx = round(dx1) @ W_o^T, rounded
//   7. column sums db1 = sum du, db2 = sum dy, dgamma = sum dh2 * xhat,
//      dbeta = sum dh2, db_o = sum dx1
//   8. weight gradients dW1 = h2^T du_c (h2 = LN2(x1) rounded, recomputed
//      in the tile load), dW2 = round(g)^T dy, dW_o = ctx^T round(dx1)
// The rounding points are the TPU kernel's; the erf is the A-S form in fp32
// and the tanh form (and its derivative) in bf16.
#include "common.cuh"
#include "epilogue.cuh"
#include "gemm.cuh"
#include "ln_mlp_out_residual_bwd.cuh"

namespace vt {

// u[r, c] holds u on entry and du on exit; g = round(gelu(u)),
// du = acc * gelu'(u) with acc = (dy @ W2^T)[r, c], du_c = round(du)
template <typename T>
struct GeluGradEpi {
  float* u;
  T* g;
  T* du_c;
  int ld;
  int variant;
  __device__ __forceinline__ void operator()(int r, int c, float acc) const {
    constexpr bool fast_erf = std::is_same<T, bf16>::value;
    const size_t i = (size_t)r * ld + c;
    const float uu = u[i];
    g[i] = from_f<T>(gelu(uu, variant, fast_erf));
    const float du = acc * gelu_grad(uu, variant, fast_erf);
    u[i] = du;
    du_c[i] = from_f<T>(du);
  }
};

template <typename T>
cudaError_t ln_mlp_out_residual_bwd(const T* dy, const T* x1, const T* ctx, const T* ln_scale,
                                    const T* ln_bias, const T* w1, const T* b1, const T* w2,
                                    const T* wo, T* dx1, T* dctx, float* dgamma, float* dbeta,
                                    float* dw1, float* db1, float* dw2, float* db2, float* dwo,
                                    float* dbo, void* workspace, int rows, int d, int f,
                                    int d_ctx, float eps, int variant, cudaStream_t stream) {
  Arena arena{(char*)workspace};
  const K7Scratch<T> s = k7_scratch<T>(arena, rows, d, f, d_ctx);
  const LoadLn<T, T> h2{x1, d, s.mean, s.rstd, ln_scale, ln_bias};
  const LoadLn<T, T, true> h2_t{x1, d, s.mean, s.rstd, ln_scale, ln_bias};

  VT_TRY(launch_row_stats(x1, s.mean, s.rstd, rows, d, eps, stream));
  VT_TRY(launch_gemm<T>(h2, Load<T>{w1, f}, rows, f, d, BiasEpi<T, float>{b1, s.u, f}, stream));
  VT_TRY(launch_gemm<T>(Load<T>{dy, d}, Load<T, T, true>{w2, d}, rows, f, d,
                        GeluGradEpi<T>{s.u, s.g, s.du_c, f, variant}, stream));
  VT_TRY(launch_gemm<T>(Load<T>{s.du_c, f}, Load<T, T, true>{w1, f}, rows, d, f,
                        StoreEpi<float>{s.dh2, d}, stream));
  VT_TRY(launch_ln_bwd_rows<T>(s.dh2, x1, s.mean, s.rstd, ln_scale, dy, dx1, s.dx1f, rows, d,
                               stream));
  VT_TRY(launch_gemm<T>(Load<T>{dx1, d}, Load<T, T, true>{wo, d}, rows, d_ctx, d,
                        StoreEpi<T>{dctx, d_ctx}, stream));

  VT_TRY(launch_colsum(ColOf<float>{s.u, f}, rows, f, s.cpart, db1, stream));  // u holds du
  VT_TRY(launch_colsum(ColOf<T>{dy, d}, rows, d, s.cpart, db2, stream));
  VT_TRY(launch_colsum(ColLnScaleGrad<T>{s.dh2, x1, s.mean, s.rstd, d}, rows, d, s.cpart, dgamma,
                       stream));
  VT_TRY(launch_colsum(ColOf<float>{s.dh2, d}, rows, d, s.cpart, dbeta, stream));
  VT_TRY(launch_colsum(ColOf<float>{s.dx1f, d}, rows, d, s.cpart, dbo, stream));

  VT_TRY(launch_wgrad<T>(h2_t, Load<T>{s.du_c, f}, d, f, rows, dw1, s.wpart, stream));
  VT_TRY(launch_wgrad<T>(Load<T, T, true>{s.g, f}, Load<T>{dy, d}, f, d, rows, dw2, s.wpart,
                         stream));
  VT_TRY(launch_wgrad<T>(Load<T, T, true>{ctx, d_ctx}, Load<T>{dx1, d}, d_ctx, d, rows, dwo,
                         s.wpart, stream));
  return cudaSuccess;
}

}  // namespace vt

extern "C" {

size_t vt_ln_mlp_out_residual_bwd_workspace(int rows, int d, int f, int d_ctx, int dtype) {
  vt::Arena a{nullptr};
  if (dtype == vt::kBFloat16)
    vt::k7_scratch<vt::bf16>(a, rows, d, f, d_ctx);
  else
    vt::k7_scratch<float>(a, rows, d, f, d_ctx);
  return a.off;
}

int vt_ln_mlp_out_residual_bwd(const void* dy, const void* x1, const void* ctx,
                               const void* ln_scale, const void* ln_bias, const void* w1,
                               const void* b1, const void* w2, const void* wo, void* dx1,
                               void* dctx, void* dgamma, void* dbeta, void* dw1, void* db1,
                               void* dw2, void* db2, void* dwo, void* dbo, void* workspace,
                               int rows, int d, int f, int d_ctx, float eps, int gelu_variant,
                               int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
#define VT_K7(T)                                                                              \
  vt::ln_mlp_out_residual_bwd<T>(                                                             \
      (const T*)dy, (const T*)x1, (const T*)ctx, (const T*)ln_scale, (const T*)ln_bias,       \
      (const T*)w1, (const T*)b1, (const T*)w2, (const T*)wo, (T*)dx1, (T*)dctx,              \
      (float*)dgamma, (float*)dbeta, (float*)dw1, (float*)db1, (float*)dw2, (float*)db2,      \
      (float*)dwo, (float*)dbo, workspace, rows, d, f, d_ctx, eps, gelu_variant, s)
  if (dtype == vt::kFloat32) return (int)VT_K7(float);
  if (dtype == vt::kBFloat16) return (int)VT_K7(vt::bf16);
#undef VT_K7
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
