// K8: split backward of [LN2 + MLP + residual] (the split C').  Replaces
// vit_tpu/ops/pallas/backward.py:ln_mlp_residual_bwd (_ln_mlp_bwd_kernel
// with _mlp_bwd_core and _mlp_grad_accum), in its residual form without
// the pre-GELU stash.
//
// It is K7 without the out_proj tail: the MLP half of
// ln_mlp_out_residual_bwd.cuh (LN2 statistics, u = LN2(x1) W1 + b1 in
// fp32, the GELU backward, dh2, dx1 = dy + LN-bwd(dh2) rounded, the column
// sums db1, db2, dgamma, dbeta and the split-K weight gradients dW1, dW2),
// over a scratch without K7's fp32 dx1.  Every reduction over rows is a
// fixed-order pass: no atomics.
#include "common.cuh"
#include "epilogue.cuh"
#include "gemm.cuh"
#include "ln_mlp_out_residual_bwd.cuh"

extern "C" {

size_t vt_ln_mlp_residual_bwd_workspace(int rows, int d, int f, int dtype) {
  vt::Arena a{nullptr};
  if (dtype == vt::kBFloat16)
    vt::k8_scratch<vt::bf16>(a, rows, d, f);
  else
    vt::k8_scratch<float>(a, rows, d, f);
  return a.off;
}

int vt_ln_mlp_residual_bwd(const void* dy, const void* x1, const void* ln_scale,
                           const void* ln_bias, const void* w1, const void* b1, const void* w2,
                           void* dx1, void* dgamma, void* dbeta, void* dw1, void* db1, void* dw2,
                           void* db2, void* workspace, int rows, int d, int f, float eps,
                           int gelu_variant, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  vt::Arena arena{(char*)workspace};
#define VT_K8(T)                                                                             \
  vt::mlp_residual_bwd<T>(vt::k8_scratch<T>(arena, rows, d, f), (const T*)dy, (const T*)x1,  \
                          (const T*)ln_scale, (const T*)ln_bias, (const T*)w1, (const T*)b1, \
                          (const T*)w2, (T*)dx1, (float*)dgamma, (float*)dbeta, (float*)dw1, \
                          (float*)db1, (float*)dw2, (float*)db2, rows, d, f, eps,            \
                          gelu_variant, s)
  if (dtype == vt::kFloat32) return (int)VT_K8(float);
  if (dtype == vt::kBFloat16) return (int)VT_K8(vt::bf16);
#undef VT_K8
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
