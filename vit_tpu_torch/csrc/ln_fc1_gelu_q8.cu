// K18a: LN2 -> per-row int8 -> int8 FC1 over this shard's hidden columns ->
// dequant + b1 -> GELU, into an fp32 `mid` (rows, F/tp).  Replaces
// vit_tpu/ops/pallas/quant_kernels.py:ln_fc1_gelu_q8 (_ln_fc1_gelu_q8_kernel).
//
// The first half of the tensor-parallel W8A8 MLP: stages 1-2 of the MLP K16
// and K17 share, cut at the `mid` scratch, because the next quantizer's row
// scale is an absmax over the FULL hidden row, which spans every shard: the
// caller takes it across shards (all-reduce MAX) and hands it to K18b
// (fc2_q8_partial.cu).
//   1. LN2 of x in fp32 from fp32 statistics, per-row int8 codes hq and
//      scales hs (quant_rows.cuh's ln_quant_rows_kernel, K17's own pass, so
//      the codes are K17's bit for bit; LN2's input is replicated over the
//      shards, so every shard quantizes it alike)
//   2. hq @ W1q with exact int32 sums; epilogue GELU((acc hs) w1s + b1) in
//      fp32 into mid.  The erf form is the caller's (`fast_erf`: the tanh
//      form where the working dtype is bf16, as in K16/K17); a different
//      erf would move values right before the next round().
// bf16 (the main path) runs stage 2 on gemm_mma_q8.cuh's TMA + wgmma int8
// core, which reads both operands K-major: the sequence first copies this
// shard's W1q (d, F/tp) into the w1t scratch (F/tp, d).  The TPU kernel
// keeps the shard weight resident in VMEM; here its K-major copy (1.2 MB at
// B/16 tp 2) stays in L2 while the codes stream through TMA.  fp32 keeps the
// first design, gemm_q8.cuh's WMMA core.
// What bounds it on the H100: at B/16 batch 100 and tp = 2 the fp32 mid
// (121 MB) is most of its ~152 MB; the GEMM is 46.5 G integer operations.
#include "common.cuh"
#include "gemm_mma_q8.cuh"
#include "quant_rows.cuh"

#include <type_traits>

namespace vt {

// mid[r, c] = gelu((acc hs[r]) ws[c] + b1[c]) in fp32, with the erf form
// given by kFastErf (DequantBiasGeluEpi ties it to the dtype instead)
template <typename T, bool kFastErf>
struct DequantBiasGeluErfEpi {
  const float* hs;
  const float* ws;
  const T* b1;
  float* mid;
  int ld;
  int variant;
  __device__ __forceinline__ void operator()(int r, int c, int acc) const {
    mid[(size_t)r * ld + c] =
        gelu(__fadd_rn(dequant(acc, hs[r], ws[c]), to_f(b1[c])), variant, kFastErf);
  }
};

// w1t: bf16's K-major copy of w1q; each instance compiles only its own core
template <typename T, bool kFastErf>
cudaError_t ln_fc1_gelu_q8(const T* x, const T* ln_scale, const T* ln_bias, const int8_t* w1q,
                           const float* w1s, const T* b1, int8_t* w1t, int8_t* hq, float* hs,
                           float* mid, int rows, int d, int f, float eps, int variant,
                           cudaStream_t stream) {
  const DequantBiasGeluErfEpi<T, kFastErf> epi{hs, w1s, b1, mid, f, variant};
  if constexpr (std::is_same<T, bf16>::value) {
    if (rows <= 0) return cudaSuccess;
    VT_TRY(launch_transpose_q8(w1q, w1t, d, f, stream));
    VT_TRY(launch_ln_quant_rows(x, ln_scale, ln_bias, hq, hs, rows, d, eps, stream));
    return launch_gemm_mma_q8(hq, w1t, rows, f, d, epi, stream);
  } else {
    VT_TRY(launch_ln_quant_rows(x, ln_scale, ln_bias, hq, hs, rows, d, eps, stream));
    return launch_gemm_q8(hq, w1q, rows, f, d, epi, stream);
  }
}

template <typename T>
cudaError_t ln_fc1_gelu_q8_any(const T* x, const T* ln_scale, const T* ln_bias,
                               const int8_t* w1q, const float* w1s, const T* b1, int8_t* w1t,
                               int8_t* hq, float* hs, float* mid, int rows, int d, int f,
                               float eps, int variant, int fast_erf, cudaStream_t stream) {
  if (fast_erf)
    return ln_fc1_gelu_q8<T, true>(x, ln_scale, ln_bias, w1q, w1s, b1, w1t, hq, hs, mid, rows, d,
                                   f, eps, variant, stream);
  return ln_fc1_gelu_q8<T, false>(x, ln_scale, ln_bias, w1q, w1s, b1, w1t, hq, hs, mid, rows, d,
                                  f, eps, variant, stream);
}

}  // namespace vt

// `w1t` (f x d int8) is bf16's scratch; fp32 takes null
extern "C" int vt_ln_fc1_gelu_q8(const void* x, const void* ln_scale, const void* ln_bias,
                                 const void* w1q, const void* w1s, const void* b1, void* w1t,
                                 void* hq, void* hs, void* mid, int rows, int d, int f, float eps,
                                 int gelu_variant, int fast_erf, int dtype, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == vt::kFloat32) {
    typedef float T;
    return (int)vt::ln_fc1_gelu_q8_any<T>(
        (const T*)x, (const T*)ln_scale, (const T*)ln_bias, (const int8_t*)w1q,
        (const float*)w1s, (const T*)b1, nullptr, (int8_t*)hq, (float*)hs, (float*)mid, rows, d,
        f, eps, gelu_variant, fast_erf, s);
  }
  if (dtype == vt::kBFloat16) {
    typedef vt::bf16 T;
    return (int)vt::ln_fc1_gelu_q8_any<T>(
        (const T*)x, (const T*)ln_scale, (const T*)ln_bias, (const int8_t*)w1q,
        (const float*)w1s, (const T*)b1, (int8_t*)w1t, (int8_t*)hq, (float*)hs, (float*)mid,
        rows, d, f, eps, gelu_variant, fast_erf, s);
  }
  return (int)cudaErrorInvalidValue;
}
