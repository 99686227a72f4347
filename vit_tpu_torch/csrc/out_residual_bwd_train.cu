// K12c: split backward of the regularized [out_proj + residual].  Replaces
// vit_tpu/ops/pallas/backward.py:out_residual_bwd_train
// (_out_res_bwd_train_kernel).  Token merging's training path runs the
// block's halves apart, so this is K9 (out_residual_bwd.cu) with the
// forward's gates on its input, K12a's out_proj tail on its own:
//   dz   = (dx1 * dp_attn[r]) * m_attn    (fp32, the mask regenerated from
//                                          (seed, site, absolute row, column))
//   dctx = round(round(dz) @ W_o^T), dW_o = ctx^T round(dz), db_o = sum dz
// dz is hashed once per element where it is written rounded (a (rows, D)
// dtype scratch the GEMMs read as plain tiles) and once where db_o sums it
// in fp32.  The residual's gradient is dx1 itself, ungated; the caller
// passes it on.  The gate is a template flag (no hash compiled in at p = 0).
#include "common.cuh"
#include "epilogue.cuh"
#include "gemm.cuh"
#include "ln_mlp_out_residual_bwd.cuh"

namespace vt {

template <typename T>
struct K12cScratch {
  T* dz_c;
  float *cpart, *wpart;
};

template <typename T>
K12cScratch<T> k12c_scratch(Arena& a, int rows, int d_ctx, int d) {
  K12cScratch<T> s;
  s.dz_c = a.take<T>((size_t)rows * d);
  s.cpart = a.take<float>(colsum_partial_floats(rows, d));
  s.wpart = a.take<float>(wgrad_partial_floats<T>(d_ctx, d, rows));
  return s;
}

template <typename T, bool kDrop>
cudaError_t out_residual_bwd_train(const T* dx1, const T* ctx, const T* wo, const float* dp_attn,
                                   Dropout drop, T* dctx, float* dwo, float* dbo,
                                   void* workspace, int rows, int d_ctx, int d,
                                   cudaStream_t stream) {
  Arena arena{(char*)workspace};
  const K12cScratch<T> s = k12c_scratch<T>(arena, rows, d_ctx, d);
  const Gate<T, kDrop> dz{dx1, d, dp_attn, drop, kSiteAttnOut};
  VT_TRY(launch_gate_rows(dz, s.dz_c, rows, d, stream));
  return out_residual_bwd<T>(s.dz_c, dz, ctx, wo, dctx, dwo, dbo, s.cpart, s.wpart, rows, d_ctx,
                             d, stream);
}

}  // namespace vt

extern "C" {

size_t vt_out_residual_bwd_train_workspace(int rows, int d_ctx, int d, int dtype) {
  vt::Arena a{nullptr};
  if (dtype == vt::kBFloat16)
    vt::k12c_scratch<vt::bf16>(a, rows, d_ctx, d);
  else
    vt::k12c_scratch<float>(a, rows, d_ctx, d);
  return a.off;
}

int vt_out_residual_bwd_train(const void* dx1, const void* ctx, const void* wo,
                              const void* dp_attn, void* dctx, void* dwo, void* dbo,
                              void* workspace, int rows, int d_ctx, int d, uint32_t seed,
                              uint32_t thresh, float keep, int dropout, int dtype, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const vt::Dropout drop{seed, thresh, keep};
#define VT_K12C(T, D)                                                                          \
  vt::out_residual_bwd_train<T, D>((const T*)dx1, (const T*)ctx, (const T*)wo,                 \
                                   (const float*)dp_attn, drop, (T*)dctx, (float*)dwo,         \
                                   (float*)dbo, workspace, rows, d_ctx, d, s)
  if (dtype == vt::kFloat32)
    return (int)(dropout ? VT_K12C(float, true) : VT_K12C(float, false));
  if (dtype == vt::kBFloat16)
    return (int)(dropout ? VT_K12C(vt::bf16, true) : VT_K12C(vt::bf16, false));
#undef VT_K12C
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
