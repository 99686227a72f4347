// The bf16 chain of K7 (ln_mlp_out_residual_bwd.cu), K8
// (ln_mlp_residual_bwd.cu), K12a (ln_mlp_out_residual_bwd_train.cu) and K12b
// (ln_mlp_residual_bwd_train.cu): the backward of [LN2 + MLP + residual],
// and with kOut of [out_proj + residual] after it, on gemm_mma.cuh's TMA +
// wgmma core.  That out_proj tail is one host function, out_proj_bwd_mma,
// which is also all of the bf16 K9 (out_residual_bwd.cu) and K12c
// (out_residual_bwd_train.cu).  The fp32 instances keep
// ln_mlp_out_residual_bwd.cuh's mlp_residual_bwd and out_residual_bwd (and
// K12a's and K12b's own chains) on gemm.cuh's FMA core.
//
// What bounds it on the H100: operations, 10 rows D F in the MLP half's five
// GEMMs and 4 rows D d_ctx in the tail's two (B/16 @224 batch 64: 12,608
// rows, 327 GFLOP), then ~1.3 GB of fp32 and bf16 scratch traffic (u/du, g,
// du_c, dh2, h2, dx1) that the TPU kept in VMEM.  The design moves every
// GEMM to the tensor-core core in the operand form it needs, with LayerNorm
// applied once per row instead of in every tile load:
//   1. LN2 row statistics of x1 (fp32; LN-bwd and dgamma read them);
//   2. h2 = round(LN2(x1)) once into a bf16 (rows, D) scratch (launch_ln_rows:
//      the value gemm.cuh's LoadLn computes on every load);
//   3. u = h2 W1 + b1, fp32, never rounded (K2's FC1 form);
//   4. round(dy_m) W2^T, B K-major; the GELU backward in the epilogue:
//      g = round(gelu(u) [m_in]), du = (acc [m_in]) gelu'(u) over u, du_c =
//      round(du);
//   5. dh2 = du_c W1^T, B K-major, fp32;
//   6. dx1 = dy + LN-bwd(dh2) rounded (LN-bwd alone with residual false,
//      K8's tensor-parallel form; and, with kOut, in fp32 too); the
//      column sums db1 = sum du, db2 = sum dy_m, dgamma = sum dh2 xhat, dbeta
//      = sum dh2 (fixed-order passes);
//   7. dW1 = h2^T du_c and dW2 = round(g)^T round(dy_m): A MN-major, the depth
//      (rows) split over gridDim.z into fp32 partials summed in split order;
//   8. kOut, the out_proj tail: db_o = sum dz over the fp32 dx1, dctx =
//      round(round(dz) W_o^T) with W_o (d_ctx, D) read K-major, and dW_o =
//      ctx^T round(dz), ctx read MN-major, split as in 7; dz = dx1 (K7).
//      On its own (K9, K12c) the tail is bound by its 4 rows D d_ctx
//      operations too (@512 batch 16: 16,400 rows, 38.7 GFLOP, 0.039 ms);
//      dW_o has only 36 output tiles at 768 x 768, so the depth split is
//      what fills the card (7 splits at 16,400 and at 10,944 rows).
// The rounding points are the TPU kernel's (backward.py:111 _mlp_bwd_core,
// :159 _mlp_grad_accum, :323-345 the out_proj tail).  No atomics: two runs
// give the same bits.
//
// kReg compiles in K12a's and K12b's gates (epilogue.cuh): dy_m = (dy
// dp_mlp[r]) [m_out], written rounded into the fp32 dh2 scratch while that
// is free (before the dh2 GEMM, and again once dh2's column sums are done),
// summed as is for db2; with kOut, dz = (dx1_f32 dp_attn[r]) [m_attn],
// summed as is for db_o and written rounded into the second half of dh2's
// scratch (an fp32 (rows, D) holds two bf16 ones), so round(dy_m) and
// round(dz) are both alive for their GEMMs and no scratch is added; kDrop
// the dropout masks within them.  K7 and K8 (kReg false) read dy and the
// bf16 dx1 themselves, so K12a and K12b at zero rates (dp = 1) run their
// arithmetic on the same bits.  kOut leaves K8's and K12b's instances as
// they were: no fp32 dx1, and K8's workspace.
#pragma once

#include "epilogue.cuh"
#include "gemm.cuh"
#include "gemm_mma.cuh"
#include "ln_mlp_out_residual_bwd.cuh"

#include <algorithm>

namespace vt {

struct MlpBwdMmaScratch {
  float *mean, *rstd, *u, *dh2, *dx1f, *cpart, *wpart;
  bf16 *h2, *g, *du_c;
};

// d_ctx > 0 (K7, K12a) adds the out_proj tail's fp32 dx1 and sizes the
// weight-gradient partials for dW_o as well
inline MlpBwdMmaScratch mlp_bwd_mma_scratch(Arena& a, int rows, int d, int f, int d_ctx = 0) {
  MlpBwdMmaScratch s;
  s.mean = a.take<float>(rows);
  s.rstd = a.take<float>(rows);
  s.u = a.take<float>((size_t)rows * f);
  s.g = a.take<bf16>((size_t)rows * f);
  s.du_c = a.take<bf16>((size_t)rows * f);
  s.dh2 = a.take<float>((size_t)rows * d);
  s.dx1f = d_ctx > 0 ? a.take<float>((size_t)rows * d) : nullptr;
  s.h2 = a.take<bf16>((size_t)rows * d);
  s.cpart = a.take<float>(colsum_partial_floats(rows, std::max(f, d)));
  s.wpart = a.take<float>(std::max({mma_partial_floats(d, f, rows),
                                    mma_partial_floats(f, d, rows),
                                    d_ctx > 0 ? mma_partial_floats(d_ctx, d, rows) : 0}));
  return s;
}

// the out_proj tail's operands and outputs (kOut): ctx (rows, d_ctx) and
// W_o (d_ctx, D) in; dctx (rows, d_ctx), dW_o (d_ctx, D) and db_o (D) out;
// K12a's drop-path scale of the attention branch
struct OutProjBwd {
  const bf16* ctx;
  const bf16* wo;
  const float* dp_attn;
  bf16* dctx;
  float* dwo;
  float* dbo;
  int d_ctx;
};

// The out_proj tail, d[out_proj + residual] (kOut's step 8; all of the
// bf16 K9 and K12c): db_o = the column sums of `dz_col` (fixed order),
// dctx = round(dzg W_o^T) with W_o (d_ctx, D) read K-major, dW_o = ctx^T
// dzg with ctx (rows, d_ctx) read MN-major and the rows split as
// mma_wgrad_split picks from the shape.  cpart and wpart as
// colsum_partial_floats(rows, d) and mma_partial_floats(d_ctx, d, rows)
// size them.
template <class Col>
inline cudaError_t out_proj_bwd_mma(const bf16* dzg, Col dz_col, const bf16* ctx, const bf16* wo,
                                    bf16* dctx, float* dwo, float* dbo, float* cpart,
                                    float* wpart, int rows, int d_ctx, int d,
                                    cudaStream_t stream) {
  VT_TRY(launch_colsum(dz_col, rows, d, cpart, dbo, stream));
  VT_TRY((launch_gemm_mma<false, true>(dzg, d, wo, d, rows, d_ctx, d,
                                       StoreEpi<bf16>{dctx, d_ctx}, stream)));
  return launch_wgrad_mma<true>(ctx, d_ctx, dzg, d, d_ctx, d, rows, dwo, wpart, stream);
}

// the GELU backward reads u one element at a time behind its own stores:
// its rows of the tile into L2 during the main loop's last k-steps (found
// by the core's prefetch_epilogue call through argument-dependent lookup)
template <typename T>
__device__ __forceinline__ void prefetch_epilogue(const GeluGradEpi<T>& e, int row0, int col0,
                                                  int M, int N) {
  prefetch_tile_rows(e.u, e.ld, row0, col0, M, N);
}

template <typename T, bool kDrop>
__device__ __forceinline__ void prefetch_epilogue(const GeluGradDropEpi<T, kDrop>& e, int row0,
                                                  int col0, int M, int N) {
  prefetch_tile_rows(e.u, e.ld, row0, col0, M, N);
}

template <bool kReg, bool kDrop, bool kOut = false>
cudaError_t mlp_residual_bwd_mma(const MlpBwdMmaScratch& s, const bf16* dy, const bf16* x1,
                                 const bf16* ln_scale, const bf16* ln_bias, const bf16* w1,
                                 const bf16* b1, const bf16* w2, const float* dp_mlp,
                                 Dropout drop, bf16* dx1, float* dgamma, float* dbeta, float* dw1,
                                 float* db1, float* dw2, float* db2, int rows, int d, int f,
                                 float eps, int variant, cudaStream_t stream,
                                 const OutProjBwd& out = {}, bool residual = true) {
  const Gate<bf16, kDrop> dy_m{dy, d, dp_mlp, drop, kSiteMlpOut};
  // the GEMMs' dY operand: dy, or round(dy_m) in the dh2 scratch
  const bf16* const dyg = kReg ? (const bf16*)s.dh2 : dy;

  VT_TRY(launch_row_stats(x1, s.mean, s.rstd, rows, d, eps, stream));
  VT_TRY(launch_ln_rows(x1, ln_scale, ln_bias, s.h2, rows, d, eps, stream));
  VT_TRY(launch_gemm_mma(s.h2, d, w1, f, rows, f, d, BiasEpi<bf16, float>{b1, s.u, f}, stream));
  if constexpr (kReg) {
    VT_TRY(launch_gate_rows(dy_m, (bf16*)s.dh2, rows, d, stream));
    VT_TRY((launch_gemm_mma<false, true>(
        dyg, d, w2, d, rows, f, d,
        GeluGradDropEpi<bf16, kDrop>{s.u, s.g, s.du_c, f, variant, drop}, stream)));
  } else {
    VT_TRY((launch_gemm_mma<false, true>(dyg, d, w2, d, rows, f, d,
                                         GeluGradEpi<bf16>{s.u, s.g, s.du_c, f, variant},
                                         stream)));
  }
  VT_TRY((launch_gemm_mma<false, true>(s.du_c, f, w1, f, rows, d, f, StoreEpi<float>{s.dh2, d},
                                       stream)));
  VT_TRY(launch_ln_bwd_rows<bf16>(s.dh2, x1, s.mean, s.rstd, ln_scale, residual ? dy : nullptr,
                                  dx1, kOut ? s.dx1f : nullptr, rows, d, stream));

  VT_TRY(launch_colsum(ColOf<float>{s.u, f}, rows, f, s.cpart, db1, stream));  // u holds du
  if constexpr (kReg) {
    VT_TRY(launch_colsum(dy_m, rows, d, s.cpart, db2, stream));
  } else {
    VT_TRY(launch_colsum(ColOf<bf16>{dy, d}, rows, d, s.cpart, db2, stream));
  }
  VT_TRY(launch_colsum(ColLnScaleGrad<bf16>{s.dh2, x1, s.mean, s.rstd, d}, rows, d, s.cpart,
                       dgamma, stream));
  VT_TRY(launch_colsum(ColOf<float>{s.dh2, d}, rows, d, s.cpart, dbeta, stream));
  if constexpr (kReg) VT_TRY(launch_gate_rows(dy_m, (bf16*)s.dh2, rows, d, stream));

  VT_TRY(launch_wgrad_mma<true>(s.h2, d, s.du_c, f, d, f, rows, dw1, s.wpart, stream));
  VT_TRY(launch_wgrad_mma<true>(s.g, f, dyg, d, f, d, rows, dw2, s.wpart, stream));
  if constexpr (kOut) {
    // the GEMMs' dZ operand: round(dz) in dh2's second half, or the bf16
    // dx1; db_o sums dz, or the fp32 dx1
    if constexpr (kReg) {
      bf16* const dz_c = (bf16*)s.dh2 + (size_t)rows * d;
      const Gate<float, kDrop> dz{s.dx1f, d, out.dp_attn, drop, kSiteAttnOut};
      VT_TRY(launch_gate_rows(dz, dz_c, rows, d, stream));
      return out_proj_bwd_mma(dz_c, dz, out.ctx, out.wo, out.dctx, out.dwo, out.dbo, s.cpart,
                              s.wpart, rows, out.d_ctx, d, stream);
    } else {
      return out_proj_bwd_mma(dx1, ColOf<float>{s.dx1f, d}, out.ctx, out.wo, out.dctx, out.dwo,
                              out.dbo, s.cpart, s.wpart, rows, out.d_ctx, d, stream);
    }
  }
  return cudaSuccess;
}

}  // namespace vt
