// The backward pieces of the fp32 K7 (ln_mlp_out_residual_bwd.cu), its
// regularized form K12a (ln_mlp_out_residual_bwd_train.cu), the split forms
// K8 (ln_mlp_residual_bwd.cu) and K12b, and K9 (out_residual_bwd.cu) and
// K12c, on gemm.cuh's FMA core; every bf16 instance of these kernels runs
// mlp_bwd_mma.cuh's chain on the TMA + wgmma core instead:
//  - the device scratch: LN2 row statistics, the fp32 (rows, F) u/du
//    buffer, g and du_c in the dtype, fp32 dh2 and dx1, and the partials of
//    the column sums and the split-K weight gradients — carved from one
//    workspace (Arena) the wrapper allocates;
//  - the MLP half, d[LN2 + MLP + residual] (K7's steps 1-5 and their
//    reductions; all of the fp32 K8);
//  - the out_proj half, d[out_proj + residual] (the fp32 K7's tail; all of
//    the fp32 K9 and K12c);
//  - the GELU backward epilogue, which the bf16 chain shares.
// What bounds them on the H100: the FMA core, never TF32 (fp32 keeps the
// TPU kernels' arithmetic; 67 TFLOP/s at best outside the tensor cores).
#pragma once

#include "epilogue.cuh"
#include "gemm.cuh"

namespace vt {

template <typename T>
struct K7Scratch {
  float *mean, *rstd, *u, *dh2, *dx1f, *cpart, *wpart;
  T *g, *du_c;
};

template <typename T>
K7Scratch<T> k7_scratch(Arena& a, int rows, int d, int f, int d_ctx) {
  K7Scratch<T> s;
  s.mean = a.take<float>(rows);
  s.rstd = a.take<float>(rows);
  s.u = a.take<float>((size_t)rows * f);
  s.g = a.take<T>((size_t)rows * f);
  s.du_c = a.take<T>((size_t)rows * f);
  s.dh2 = a.take<float>((size_t)rows * d);
  s.dx1f = a.take<float>((size_t)rows * d);
  s.cpart = a.take<float>(colsum_partial_floats(rows, std::max(f, d)));
  s.wpart = a.take<float>(std::max({wgrad_partial_floats<T>(d, f, rows),
                                    wgrad_partial_floats<T>(f, d, rows),
                                    wgrad_partial_floats<T>(d_ctx, d, rows)}));
  return s;
}

// K8's: K7's without what its out_proj tail needs (the fp32 dx1, W_o's
// partials)
template <typename T>
K7Scratch<T> k8_scratch(Arena& a, int rows, int d, int f) {
  K7Scratch<T> s;
  s.mean = a.take<float>(rows);
  s.rstd = a.take<float>(rows);
  s.u = a.take<float>((size_t)rows * f);
  s.g = a.take<T>((size_t)rows * f);
  s.du_c = a.take<T>((size_t)rows * f);
  s.dh2 = a.take<float>((size_t)rows * d);
  s.dx1f = nullptr;
  s.cpart = a.take<float>(colsum_partial_floats(rows, std::max(f, d)));
  s.wpart = a.take<float>(std::max(wgrad_partial_floats<T>(d, f, rows),
                                   wgrad_partial_floats<T>(f, d, rows)));
  return s;
}

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

// The MLP half:
//   1. LN2 row statistics of the rounded x1 (fp32)
//   2. u = LN2(x1) @ W1 + b1 -> fp32 (rows, F) scratch, never rounded
//   3. dg = dy @ W2^T; epilogue: g = round(gelu(u)), du = dg * gelu'(u)
//      (fp32, written over u), du_c = round(du)
//   4. dh2 = du_c @ W1^T -> fp32 (rows, D)
//   5. dx1 = dy + LN-bwd(dh2) in fp32 (LN-bwd alone without the residual),
//      written in the dtype (and in fp32 into s.dx1f when it is not null)
//   6. column sums db1 = sum du, db2 = sum dy, dgamma = sum dh2 * xhat,
//      dbeta = sum dh2
//   7. weight gradients dW1 = h2^T du_c (h2 = LN2(x1) rounded, recomputed
//      in the tile load), dW2 = round(g)^T dy
template <typename T>
cudaError_t mlp_residual_bwd(const K7Scratch<T>& s, const T* dy, const T* x1, const T* ln_scale,
                             const T* ln_bias, const T* w1, const T* b1, const T* w2, T* dx1,
                             float* dgamma, float* dbeta, float* dw1, float* db1, float* dw2,
                             float* db2, int rows, int d, int f, float eps, int variant,
                             cudaStream_t stream, bool residual = true) {
  const LoadLn<T, T> h2{x1, d, s.mean, s.rstd, ln_scale, ln_bias};
  const LoadLn<T, T, true> h2_t{x1, d, s.mean, s.rstd, ln_scale, ln_bias};

  VT_TRY(launch_row_stats(x1, s.mean, s.rstd, rows, d, eps, stream));
  VT_TRY(launch_gemm<T>(h2, Load<T>{w1, f}, rows, f, d, BiasEpi<T, float>{b1, s.u, f}, stream));
  VT_TRY(launch_gemm<T>(Load<T>{dy, d}, Load<T, T, true>{w2, d}, rows, f, d,
                        GeluGradEpi<T>{s.u, s.g, s.du_c, f, variant}, stream));
  VT_TRY(launch_gemm<T>(Load<T>{s.du_c, f}, Load<T, T, true>{w1, f}, rows, d, f,
                        StoreEpi<float>{s.dh2, d}, stream));
  VT_TRY(launch_ln_bwd_rows<T>(s.dh2, x1, s.mean, s.rstd, ln_scale, residual ? dy : nullptr, dx1,
                               s.dx1f, rows, d, stream));

  VT_TRY(launch_colsum(ColOf<float>{s.u, f}, rows, f, s.cpart, db1, stream));  // u holds du
  VT_TRY(launch_colsum(ColOf<T>{dy, d}, rows, d, s.cpart, db2, stream));
  VT_TRY(launch_colsum(ColLnScaleGrad<T>{s.dh2, x1, s.mean, s.rstd, d}, rows, d, s.cpart, dgamma,
                       stream));
  VT_TRY(launch_colsum(ColOf<float>{s.dh2, d}, rows, d, s.cpart, dbeta, stream));

  VT_TRY(launch_wgrad<T>(h2_t, Load<T>{s.du_c, f}, d, f, rows, dw1, s.wpart, stream));
  VT_TRY(launch_wgrad<T>(Load<T, T, true>{s.g, f}, Load<T>{dy, d}, f, d, rows, dw2, s.wpart,
                         stream));
  return cudaSuccess;
}

// The fp32 out_proj half: dctx = round(dx1) @ W_o^T, rounded; db_o =
// column sums of `dx1_col` (K7: its fp32 dx1; K9: its dx1 operand; K12c:
// its gate); dW_o = ctx^T round(dx1).  cpart and wpart as sized by colsum_partial_floats(rows, d)
// and wgrad_partial_floats<T>(d_ctx, d, rows).
template <typename T, class Col>
cudaError_t out_residual_bwd(const T* dx1, Col dx1_col, const T* ctx, const T* wo, T* dctx,
                             float* dwo, float* dbo, float* cpart, float* wpart, int rows,
                             int d_ctx, int d, cudaStream_t stream) {
  VT_TRY(launch_gemm<T>(Load<T>{dx1, d}, Load<T, T, true>{wo, d}, rows, d_ctx, d,
                        StoreEpi<T>{dctx, d_ctx}, stream));
  VT_TRY(launch_colsum(dx1_col, rows, d, cpart, dbo, stream));
  VT_TRY(launch_wgrad<T>(Load<T, T, true>{ctx, d_ctx}, Load<T>{dx1, d}, d_ctx, d, rows, dwo,
                         wpart, stream));
  return cudaSuccess;
}

}  // namespace vt
