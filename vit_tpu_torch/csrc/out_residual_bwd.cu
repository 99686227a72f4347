// K9: split backward of [out_proj + residual] (the split B').  Replaces
// vit_tpu/ops/pallas/backward.py:out_residual_bwd (_out_res_bwd_kernel).
//
// K7's out_proj tail on its own dx1: dctx = round(dx1 W_o^T), db_o = sum
// of dx1 in fp32 (128-row partials summed in order; the bf16 values of
// dx1, where K7 sums its fp32 dx1), dW_o = ctx^T dx1 in fp32 (a split-K
// weight gradient summed in split order).  The residual's gradient is dx1
// itself, which the caller passes on.  bf16, the path's dtype, runs
// mlp_bwd_mma.cuh's out_proj_bwd_mma, the tail of the bf16 K7: both GEMMs
// on gemm_mma.cuh's TMA + wgmma core, W_o read K-major for dctx, ctx read
// MN-major for dW_o with the rows split as the shape alone decides.  fp32
// runs ln_mlp_out_residual_bwd.cuh's out_residual_bwd on gemm.cuh's FMA
// core (W_o transposed in its tile load, never TF32).  No atomics: two runs
// give the same bits.
#include "common.cuh"
#include "epilogue.cuh"
#include "gemm.cuh"
#include "ln_mlp_out_residual_bwd.cuh"
#include "mlp_bwd_mma.cuh"

#include <type_traits>

namespace vt {

struct K9Scratch {
  float *cpart, *wpart;
};

template <typename T>
K9Scratch k9_scratch(Arena& a, int rows, int d_ctx, int d) {
  K9Scratch s;
  s.cpart = a.take<float>(colsum_partial_floats(rows, d));
  if constexpr (std::is_same<T, bf16>::value)
    s.wpart = a.take<float>(mma_partial_floats(d_ctx, d, rows));
  else
    s.wpart = a.take<float>(wgrad_partial_floats<T>(d_ctx, d, rows));
  return s;
}

template <typename T>
cudaError_t out_residual_bwd_k9(const T* dx1, const T* ctx, const T* wo, T* dctx, float* dwo,
                                float* dbo, void* workspace, int rows, int d_ctx, int d,
                                cudaStream_t stream) {
  Arena arena{(char*)workspace};
  const K9Scratch s = k9_scratch<T>(arena, rows, d_ctx, d);
  if constexpr (std::is_same<T, bf16>::value)
    return out_proj_bwd_mma(dx1, ColOf<T>{dx1, d}, ctx, wo, dctx, dwo, dbo, s.cpart, s.wpart,
                            rows, d_ctx, d, stream);
  else
    return out_residual_bwd<T>(dx1, ColOf<T>{dx1, d}, ctx, wo, dctx, dwo, dbo, s.cpart, s.wpart,
                               rows, d_ctx, d, stream);
}

}  // namespace vt

extern "C" {

size_t vt_out_residual_bwd_workspace(int rows, int d_ctx, int d, int dtype) {
  vt::Arena a{nullptr};
  if (dtype == vt::kBFloat16)
    vt::k9_scratch<vt::bf16>(a, rows, d_ctx, d);
  else
    vt::k9_scratch<float>(a, rows, d_ctx, d);
  return a.off;
}

int vt_out_residual_bwd(const void* dx1, const void* ctx, const void* wo, void* dctx, void* dwo,
                        void* dbo, void* workspace, int rows, int d_ctx, int d, int dtype,
                        int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
#define VT_K9(T)                                                                              \
  vt::out_residual_bwd_k9<T>((const T*)dx1, (const T*)ctx, (const T*)wo, (T*)dctx, (float*)dwo, \
                             (float*)dbo, workspace, rows, d_ctx, d, s)
  if (dtype == vt::kFloat32) return (int)VT_K9(float);
  if (dtype == vt::kBFloat16) return (int)VT_K9(vt::bf16);
#undef VT_K9
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
