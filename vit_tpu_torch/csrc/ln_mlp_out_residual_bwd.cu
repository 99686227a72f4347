// K7: merged backward of [LN2 + MLP + residual] o [out_proj + residual].
// Replaces vit_tpu/ops/pallas/backward.py:ln_mlp_out_residual_bwd
// (_ln_mlp_out_bwd_kernel with _mlp_bwd_core and _mlp_grad_accum), with
// or without the pre-GELU stash u (non-null `u`, of dtype `u_dtype`:
// widened into the fp32 u scratch in place of the FC1 GEMM, UStash).
//
// The TPU kernel walks row blocks in order, keeps W1, W2, W_o and the fp32
// weight-gradient accumulators resident in VMEM, and carries the sums from
// one grid step to the next.  Hopper blocks run in no order and hold 227 KB
// each, so this is a chain of tiled GEMMs over all B*T rows with device
// scratch between them, and every reduction over rows (the weight
// gradients' depth, the bias/LN column sums) is its own deterministic pass:
// the MLP half (LN2 statistics, u, the GELU backward, dh2, dx1 = dy +
// LN-bwd(dh2) also kept in fp32, db1, db2, dgamma, dbeta, dW1, dW2 — all of
// K8), then the out_proj half on that dx1 (dctx = round(dx1) W_o^T, db_o =
// sum of the fp32 dx1, dW_o = ctx^T round(dx1) — K9 with the fp32 column
// sum).  bf16, the path's dtype, runs K8's chain with the out_proj tail
// compiled in (mlp_bwd_mma.cuh: the TMA + wgmma core, LayerNorm once per
// row, W2^T/W1^T/W_o^T read K-major, h2^T/g^T/ctx^T read MN-major, the
// weight gradients split over rows and summed in split order); fp32 runs
// ln_mlp_out_residual_bwd.cuh's halves on gemm.cuh's FMA core (never TF32).
// The rounding points are the TPU kernel's; the erf is the A-S form in fp32
// and the tanh form (and its derivative) in bf16.
#include "common.cuh"
#include "epilogue.cuh"
#include "gemm.cuh"
#include "ln_mlp_out_residual_bwd.cuh"
#include "mlp_bwd_mma.cuh"

namespace vt {

template <typename T>
cudaError_t ln_mlp_out_residual_bwd(const T* dy, const T* x1, const T* ctx, const T* ln_scale,
                                    const T* ln_bias, const T* w1, const T* b1, const T* w2,
                                    const T* wo, const UStash& stash, T* dx1, T* dctx, float* dgamma, float* dbeta,
                                    float* dw1, float* db1, float* dw2, float* db2, float* dwo,
                                    float* dbo, void* workspace, int rows, int d, int f,
                                    int d_ctx, float eps, int variant, cudaStream_t stream) {
  Arena arena{(char*)workspace};
  const K7Scratch<T> s = k7_scratch<T>(arena, rows, d, f, d_ctx);
  VT_TRY(mlp_residual_bwd<T>(s, dy, x1, ln_scale, ln_bias, w1, b1, w2, dx1, dgamma, dbeta, dw1,
                             db1, dw2, db2, rows, d, f, eps, variant, stream, true, stash));
  return out_residual_bwd<T>(dx1, ColOf<float>{s.dx1f, d}, ctx, wo, dctx, dwo, dbo, s.cpart,
                             s.wpart, rows, d_ctx, d, stream);
}

}  // namespace vt

extern "C" {

size_t vt_ln_mlp_out_residual_bwd_workspace(int rows, int d, int f, int d_ctx, int dtype) {
  vt::Arena a{nullptr};
  if (dtype == vt::kBFloat16)
    vt::mlp_bwd_mma_scratch(a, rows, d, f, d_ctx);
  else
    vt::k7_scratch<float>(a, rows, d, f, d_ctx);
  return a.off;
}

int vt_ln_mlp_out_residual_bwd(const void* dy, const void* x1, const void* ctx,
                               const void* ln_scale, const void* ln_bias, const void* w1,
                               const void* b1, const void* w2, const void* wo, const void* u,
                               void* dx1,
                               void* dctx, void* dgamma, void* dbeta, void* dw1, void* db1,
                               void* dw2, void* db2, void* dwo, void* dbo, void* workspace,
                               int rows, int d, int f, int d_ctx, float eps, int gelu_variant,
                               int u_dtype, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == vt::kFloat32) {
    typedef float T;
    return (int)vt::ln_mlp_out_residual_bwd<T>(
        (const T*)dy, (const T*)x1, (const T*)ctx, (const T*)ln_scale, (const T*)ln_bias,
        (const T*)w1, (const T*)b1, (const T*)w2, (const T*)wo, vt::UStash{u, u_dtype},
        (T*)dx1, (T*)dctx,
        (float*)dgamma, (float*)dbeta, (float*)dw1, (float*)db1, (float*)dw2, (float*)db2,
        (float*)dwo, (float*)dbo, workspace, rows, d, f, d_ctx, eps, gelu_variant, s);
  }
  if (dtype == vt::kBFloat16) {
    typedef vt::bf16 T;
    vt::Arena arena{(char*)workspace};
    return (int)vt::mlp_residual_bwd_mma<false, false, true>(
        vt::mlp_bwd_mma_scratch(arena, rows, d, f, d_ctx), (const T*)dy, (const T*)x1,
        (const T*)ln_scale, (const T*)ln_bias, (const T*)w1, (const T*)b1, (const T*)w2, nullptr,
        vt::Dropout{}, (T*)dx1, (float*)dgamma, (float*)dbeta, (float*)dw1, (float*)db1,
        (float*)dw2, (float*)db2, rows, d, f, eps, gelu_variant, s,
        vt::OutProjBwd{(const T*)ctx, (const T*)wo, nullptr, (T*)dctx, (float*)dwo, (float*)dbo,
                       d_ctx},
        true, vt::UStash{u, u_dtype});
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
