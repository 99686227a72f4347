// K8: split backward of [LN2 + MLP + residual] (the split C').  Replaces
// vit_tpu/ops/pallas/backward.py:ln_mlp_residual_bwd (_ln_mlp_bwd_kernel
// with _mlp_bwd_core and _mlp_grad_accum), in its residual form without
// the pre-GELU stash; residual 0 is the tensor-parallel form (_lmp_bwd's
// residual=False): dx1 = LN-bwd(dh2) alone, the six weight gradients and
// db2 as before.
//
// The MLP half of K7's backward (LN2 statistics, u = LN2(x1) W1 + b1 in
// fp32, the GELU backward, dh2, dx1 = dy + LN-bwd(dh2) rounded, the column
// sums db1, db2, dgamma, dbeta and the split-K weight gradients dW1, dW2).
// bf16, the path's dtype, runs mlp_bwd_mma.cuh's chain on the TMA + wgmma
// core (LayerNorm once per row into a bf16 h2 scratch, the transposed
// operands in the core's K-major-B and MN-major-A forms); fp32 runs
// ln_mlp_out_residual_bwd.cuh's mlp_residual_bwd on gemm.cuh's FMA core
// (never TF32), over a scratch without K7's fp32 dx1.  Every reduction
// over rows is a fixed-order pass: no atomics.
#include "common.cuh"
#include "epilogue.cuh"
#include "gemm.cuh"
#include "ln_mlp_out_residual_bwd.cuh"
#include "mlp_bwd_mma.cuh"

extern "C" {

size_t vt_ln_mlp_residual_bwd_workspace(int rows, int d, int f, int dtype) {
  vt::Arena a{nullptr};
  if (dtype == vt::kBFloat16)
    vt::mlp_bwd_mma_scratch(a, rows, d, f);
  else
    vt::k8_scratch<float>(a, rows, d, f);
  return a.off;
}

int vt_ln_mlp_residual_bwd(const void* dy, const void* x1, const void* ln_scale,
                           const void* ln_bias, const void* w1, const void* b1, const void* w2,
                           void* dx1, void* dgamma, void* dbeta, void* dw1, void* db1, void* dw2,
                           void* db2, void* workspace, int rows, int d, int f, float eps,
                           int gelu_variant, int residual, int dtype, int device,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  vt::Arena arena{(char*)workspace};
  if (dtype == vt::kFloat32) {
    typedef float T;
    return (int)vt::mlp_residual_bwd<T>(
        vt::k8_scratch<T>(arena, rows, d, f), (const T*)dy, (const T*)x1, (const T*)ln_scale,
        (const T*)ln_bias, (const T*)w1, (const T*)b1, (const T*)w2, (T*)dx1, (float*)dgamma,
        (float*)dbeta, (float*)dw1, (float*)db1, (float*)dw2, (float*)db2, rows, d, f, eps,
        gelu_variant, s, residual != 0);
  }
  if (dtype == vt::kBFloat16) {
    typedef vt::bf16 T;
    return (int)vt::mlp_residual_bwd_mma<false, false>(
        vt::mlp_bwd_mma_scratch(arena, rows, d, f), (const T*)dy, (const T*)x1,
        (const T*)ln_scale, (const T*)ln_bias, (const T*)w1, (const T*)b1, (const T*)w2, nullptr,
        vt::Dropout{}, (T*)dx1, (float*)dgamma, (float*)dbeta, (float*)dw1, (float*)db1,
        (float*)dw2, (float*)db2, rows, d, f, eps, gelu_variant, s, vt::OutProjBwd{},
        residual != 0);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
