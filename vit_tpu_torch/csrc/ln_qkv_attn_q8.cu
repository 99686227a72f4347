// K15: LN1 -> per-row int8 -> int8 QKV GEMM -> dequant + bias -> per-head
// softmax attention in the working dtype.  Replaces
// vit_tpu/ops/pallas/quant_kernels.py:ln_qkv_attn_q8
// (_ln_qkv_attn_q8_kernel, _qkv_q8).
//
// W_qkv is int8 [in, out] with fp32 per-column scales.  The TPU kernel holds
// it and one image's packed QKV in VMEM; here, three stages over device
// scratches:
//   1. per row: LN1 in fp32 from fp32 statistics (h is not rounded to the
//      dtype), the row's int8 codes hq and its scale hs (quant_rows.cuh)
//   2. the int8 GEMM hq @ Wq with exact int32 sums (gemm_q8.cuh); epilogue
//      (acc hs) ws + b in fp32, rounded once to the dtype into the packed QKV
//   3. K1's attention stage, unchanged (attention.cuh), with its token-merging
//      hooks: the log-size bias on the key logits and the mean key over
//      heads, read from the dequantized packed QKV
// Stages 1-2 are an entry point of their own (vt_ln_qkv_q8): the
// long-sequence W8A8 block runs them before the flash-attention kernel, so
// both blocks share one definition of the QKV grouping.
//
// vt_gemm_q8_dequant is the GEMM core alone, (A @ B) sa sb in fp32, for its
// exactness test and its timing; no model path calls it.
#include "attention.cuh"
#include "common.cuh"
#include "gemm_q8.cuh"
#include "quant_rows.cuh"

namespace vt {

template <typename T>
cudaError_t ln_qkv_q8(const T* x, const T* ln_scale, const T* ln_bias, const int8_t* wq,
                      const float* ws, const T* bqkv, int8_t* hq, float* hs, T* qkv, int rows,
                      int d, int d3, float eps, cudaStream_t stream) {
  VT_TRY(launch_ln_quant_rows(x, ln_scale, ln_bias, hq, hs, rows, d, eps, stream));
  return launch_gemm_q8(hq, wq, rows, d3, d, DequantBiasEpi<T>{hs, ws, bqkv, qkv, d3}, stream);
}

template <typename T>
cudaError_t ln_qkv_attn_q8(const T* x, const T* ln_scale, const T* ln_bias, const int8_t* wq,
                           const float* ws, const T* bqkv, int8_t* hq, float* hs, T* qkv, T* ctx,
                           const float* log_size, T* kmean, int batch, int seq, int d, int heads,
                           int head_dim, float eps, cudaStream_t stream) {
  VT_TRY(ln_qkv_q8<T>(x, ln_scale, ln_bias, wq, ws, bqkv, hq, hs, qkv, batch * seq, d,
                      3 * heads * head_dim, eps, stream));
  return launch_attention_any<T>(qkv, ctx, batch, seq, heads, head_dim, stream, log_size, kmean);
}

}  // namespace vt

extern "C" int vt_ln_qkv_q8(const void* x, const void* ln_scale, const void* ln_bias,
                            const void* wq, const void* ws, const void* bqkv, void* hq, void* hs,
                            void* qkv, int rows, int d, int d3, float eps, int dtype, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == vt::kFloat32) {
    typedef float T;
    return (int)vt::ln_qkv_q8<T>((const T*)x, (const T*)ln_scale, (const T*)ln_bias,
                                 (const int8_t*)wq, (const float*)ws, (const T*)bqkv, (int8_t*)hq,
                                 (float*)hs, (T*)qkv, rows, d, d3, eps, s);
  }
  if (dtype == vt::kBFloat16) {
    typedef vt::bf16 T;
    return (int)vt::ln_qkv_q8<T>((const T*)x, (const T*)ln_scale, (const T*)ln_bias,
                                 (const int8_t*)wq, (const float*)ws, (const T*)bqkv, (int8_t*)hq,
                                 (float*)hs, (T*)qkv, rows, d, d3, eps, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int vt_ln_qkv_attn_q8(const void* x, const void* ln_scale, const void* ln_bias,
                                 const void* wq, const void* ws, const void* bqkv, void* hq,
                                 void* hs, void* qkv, void* ctx, const void* log_size,
                                 void* kmean, int batch, int seq, int d, int heads, int head_dim,
                                 float eps, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == vt::kFloat32) {
    typedef float T;
    return (int)vt::ln_qkv_attn_q8<T>((const T*)x, (const T*)ln_scale, (const T*)ln_bias,
                                      (const int8_t*)wq, (const float*)ws, (const T*)bqkv,
                                      (int8_t*)hq, (float*)hs, (T*)qkv, (T*)ctx,
                                      (const float*)log_size, (T*)kmean, batch, seq, d, heads,
                                      head_dim, eps, s);
  }
  if (dtype == vt::kBFloat16) {
    typedef vt::bf16 T;
    return (int)vt::ln_qkv_attn_q8<T>((const T*)x, (const T*)ln_scale, (const T*)ln_bias,
                                      (const int8_t*)wq, (const float*)ws, (const T*)bqkv,
                                      (int8_t*)hq, (float*)hs, (T*)qkv, (T*)ctx,
                                      (const float*)log_size, (T*)kmean, batch, seq, d, heads,
                                      head_dim, eps, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int vt_gemm_q8_dequant(const void* a, const void* sa, const void* b, const void* sb,
                                  void* out, int m, int n, int k, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)vt::launch_gemm_q8((const int8_t*)a, (const int8_t*)b, m, n, k,
                                 vt::DequantEpi{(const float*)sa, (const float*)sb, (float*)out, n},
                                 (cudaStream_t)stream);
}
