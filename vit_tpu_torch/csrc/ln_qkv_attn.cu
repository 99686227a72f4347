// K1: LN1 -> packed QKV projection -> per-head softmax attention.
// Replaces vit_tpu/ops/pallas/fused_block.py:ln_qkv_attn
// (_ln_qkv_attn_kernel, _head_context).
//
// The TPU kernel holds W_qkv and one image's packed QKV in VMEM.  A Hopper
// block has 227 KB of shared memory, so this is two stages over a packed
// QKV scratch in device memory:
//   1. LN1 row statistics, then the tiled GEMM (gemm.cuh) with LN1 applied
//      in the A-tile load; epilogue adds the bias and rounds to the dtype.
//   2. attention: one block per (image, head, 64-query tile), q/k/v read
//      with strides from the packed (head, {q,k,v}, dh) columns, 64-key
//      tiles streamed through shared memory twice (pass 1: row max and sum
//      of exp with online rescaling; pass 2: p = exp(s - m) * (1/sum)
//      rounded to the dtype, then p @ v), so every T fits and the rounding
//      points are the TPU kernel's.  Ragged query and key edges are masked;
//      keys past T load zeros and get p = 0.
// Token merging's hooks (attention.cuh): with `log_size` (B, T) fp32 the
// attention blocks add it to the key logits before the row max; with
// `kmean` a third stage writes the mean key over heads (B*T, dh) from the
// packed-QKV scratch.  Both null: stages 1-2 as without the hooks.
#include "attention.cuh"
#include "common.cuh"
#include "epilogue.cuh"
#include "gemm.cuh"

namespace vt {

template <typename T>
cudaError_t ln_qkv_attn(const T* x, const T* ln_scale, const T* ln_bias, const T* wqkv,
                        const T* bqkv, float* stats, T* qkv, T* ctx, const float* log_size,
                        T* kmean, int batch, int seq, int d, int heads, int head_dim, float eps,
                        cudaStream_t stream) {
  const int rows = batch * seq, d3 = 3 * heads * head_dim;
  float* mean = stats;
  float* rstd = stats + rows;
  cudaError_t err = launch_row_stats(x, mean, rstd, rows, d, eps, stream);
  if (err != cudaSuccess) return err;
  err = launch_gemm<T>(LoadLn<T, T>{x, d, mean, rstd, ln_scale, ln_bias}, Load<T>{wqkv, d3},
                       rows, d3, d, BiasEpi<T, T>{bqkv, qkv, d3}, stream);
  if (err != cudaSuccess) return err;
  return launch_attention_any<T>(qkv, ctx, batch, seq, heads, head_dim, stream, log_size, kmean);
}

}  // namespace vt

extern "C" int vt_ln_qkv_attn(const void* x, const void* ln_scale, const void* ln_bias,
                              const void* wqkv, const void* bqkv, void* stats, void* qkv,
                              void* ctx, const void* log_size, void* kmean, int batch,
                              int seq, int d, int heads, int head_dim, float eps, int dtype,
                              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  float* st = (float*)stats;
  if (dtype == vt::kFloat32) {
    typedef float T;
    return (int)vt::ln_qkv_attn<T>((const T*)x, (const T*)ln_scale, (const T*)ln_bias,
                                   (const T*)wqkv, (const T*)bqkv, st, (T*)qkv, (T*)ctx,
                                   (const float*)log_size, (T*)kmean, batch, seq, d, heads,
                                   head_dim, eps, s);
  }
  if (dtype == vt::kBFloat16) {
    typedef vt::bf16 T;
    return (int)vt::ln_qkv_attn<T>((const T*)x, (const T*)ln_scale, (const T*)ln_bias,
                                   (const T*)wqkv, (const T*)bqkv, st, (T*)qkv, (T*)ctx,
                                   (const float*)log_size, (T*)kmean, batch, seq, d, heads,
                                   head_dim, eps, s);
  }
  return (int)cudaErrorInvalidValue;
}
