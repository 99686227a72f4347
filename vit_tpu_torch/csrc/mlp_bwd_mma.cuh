// The bf16 chain of K8 (ln_mlp_residual_bwd.cu) and K12b
// (ln_mlp_residual_bwd_train.cu): the backward of [LN2 + MLP + residual] on
// gemm_mma.cuh's TMA + wgmma core.  The fp32 instances keep
// ln_mlp_out_residual_bwd.cuh's mlp_residual_bwd (and K12b's own chain) on
// gemm.cuh's FMA core; K7 and K12a keep theirs.
//
// What bounds it on the H100: operations, 10 rows D F in five GEMMs (B/16
// @512 batch 16: 16,400 rows, 387 GFLOP), then ~1.5 GB of fp32 and bf16
// scratch traffic (u/du, g, du_c, dh2, h2) that the TPU kept in VMEM.  The
// design moves every GEMM to the tensor-core core in the operand form it
// needs, with LayerNorm applied once per row instead of in every tile load:
//   1. LN2 row statistics of x1 (fp32; LN-bwd and dgamma read them);
//   2. h2 = round(LN2(x1)) once into a bf16 (rows, D) scratch (launch_ln_rows:
//      the value gemm.cuh's LoadLn computes on every load);
//   3. u = h2 W1 + b1, fp32, never rounded (K2's FC1 form);
//   4. round(dy_m) W2^T, B K-major; the GELU backward in the epilogue:
//      g = round(gelu(u) [m_in]), du = (acc [m_in]) gelu'(u) over u, du_c =
//      round(du);
//   5. dh2 = du_c W1^T, B K-major, fp32;
//   6. dx1 = dy + LN-bwd(dh2) rounded; the column sums db1 = sum du, db2 =
//      sum dy_m, dgamma = sum dh2 xhat, dbeta = sum dh2 (fixed-order passes);
//   7. dW1 = h2^T du_c and dW2 = round(g)^T round(dy_m): A MN-major, the depth
//      (rows) split over gridDim.z into fp32 partials summed in split order.
// The rounding points are the TPU kernel's (backward.py:111 _mlp_bwd_core,
// :159 _mlp_grad_accum).  No atomics: two runs give the same bits.
//
// kReg compiles in K12b's gates (epilogue.cuh): dy_m = (dy dp_mlp[r])
// [m_out], written rounded into the fp32 dh2 scratch while that is free
// (before the dh2 GEMM, and again once dh2's column sums are done), summed
// as is for db2; kDrop the dropout masks within them.  K8 (kReg false) reads
// dy itself, so K12b at zero rates (dp_mlp = 1) runs K8's arithmetic on the
// same bits.
#pragma once

#include "epilogue.cuh"
#include "gemm.cuh"
#include "gemm_mma.cuh"
#include "ln_mlp_out_residual_bwd.cuh"

#include <algorithm>

namespace vt {

struct MlpBwdMmaScratch {
  float *mean, *rstd, *u, *dh2, *cpart, *wpart;
  bf16 *h2, *g, *du_c;
};

inline MlpBwdMmaScratch mlp_bwd_mma_scratch(Arena& a, int rows, int d, int f) {
  MlpBwdMmaScratch s;
  s.mean = a.take<float>(rows);
  s.rstd = a.take<float>(rows);
  s.u = a.take<float>((size_t)rows * f);
  s.g = a.take<bf16>((size_t)rows * f);
  s.du_c = a.take<bf16>((size_t)rows * f);
  s.dh2 = a.take<float>((size_t)rows * d);
  s.h2 = a.take<bf16>((size_t)rows * d);
  s.cpart = a.take<float>(colsum_partial_floats(rows, std::max(f, d)));
  s.wpart =
      a.take<float>(std::max(mma_partial_floats(d, f, rows), mma_partial_floats(f, d, rows)));
  return s;
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

template <bool kReg, bool kDrop>
cudaError_t mlp_residual_bwd_mma(const MlpBwdMmaScratch& s, const bf16* dy, const bf16* x1,
                                 const bf16* ln_scale, const bf16* ln_bias, const bf16* w1,
                                 const bf16* b1, const bf16* w2, const float* dp_mlp,
                                 Dropout drop, bf16* dx1, float* dgamma, float* dbeta, float* dw1,
                                 float* db1, float* dw2, float* db2, int rows, int d, int f,
                                 float eps, int variant, cudaStream_t stream) {
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
  VT_TRY(launch_ln_bwd_rows<bf16>(s.dh2, x1, s.mean, s.rstd, ln_scale, dy, dx1, nullptr, rows, d,
                                  stream));

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
  return launch_wgrad_mma<true>(s.g, f, dyg, d, f, d, rows, dw2, s.wpart, stream);
}

}  // namespace vt
