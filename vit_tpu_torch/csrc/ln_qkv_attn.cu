// K1: LN1 -> packed QKV projection -> per-head softmax attention.
// Replaces vit_tpu/ops/pallas/fused_block.py:ln_qkv_attn
// (_ln_qkv_attn_kernel, _head_context).
//
// The TPU kernel holds W_qkv and one image's packed QKV in VMEM.  A Hopper
// block has 227 KB of shared memory, so this is stages over a packed QKV
// scratch in device memory.  What bounds it on the H100: operations (B/16
// batch 100: the QKV GEMM's 70 GFLOP and attention's 12).
//
// bf16 (the main path), on the tensor cores:
//   1. LN1 once per row into a bf16 scratch h (gemm_mma.cuh's
//      launch_ln_rows: fp32 statistics and affine, one rounding);
//   2. the packed QKV GEMM on gemm_mma.cuh's pipelined cp.async + wgmma
//      core, h @ W_qkv + b_qkv rounded to bf16 (BiasEpi);
//   3. attention on sdpa_mma.cuh's register tiles, K21's body
//      (qkv_attention_mma.cuh, shared with the bf16 K15): one block
//      per (image, head, 64-query tile) reading q/k/v in place from the
//      packed (head, {q,k,v}, dh) columns as strided views, two passes
//      over 64-key tiles (exact row max and sum, then p rounded before
//      p @ v), the context in 16-byte stores.
// fp32 keeps the parent's stages: LN1 row statistics, gemm.cuh's FMA core
// with LN1 applied in the A-tile load (never TF32), and attention.cuh's
// SIMT attention (attention_tile), which rounds at the same points.
//
// Token merging's hooks: with `log_size` (B, T) fp32 the attention adds it
// to the key logits before the row max (the bf16 body's kBias flag, the
// fp32 attention_bias_kernel); with `kmean` one more kernel writes the
// mean key over heads (B*T, dh) from the packed-QKV scratch (kmean_kernel).
// Both null: the stages as without the hooks.
#include "attention.cuh"
#include "common.cuh"
#include "epilogue.cuh"
#include "gemm.cuh"
#include "gemm_mma.cuh"
#include "qkv_attention_mma.cuh"

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

// bf16: h = LN1(x) (rows, d), the packed QKV on the tensor-core core, then
// attention on the register tiles
cudaError_t ln_qkv_attn_mma(const bf16* x, const bf16* ln_scale, const bf16* ln_bias,
                            const bf16* wqkv, const bf16* bqkv, bf16* h, bf16* qkv, bf16* ctx,
                            const float* log_size, bf16* kmean, int batch, int seq, int d,
                            int heads, int head_dim, float eps, cudaStream_t stream) {
  const int rows = batch * seq, d3 = 3 * heads * head_dim;
  if (rows <= 0) return cudaSuccess;
  VT_TRY(launch_ln_rows(x, ln_scale, ln_bias, h, rows, d, eps, stream));
  VT_TRY(launch_gemm_mma(h, d, wqkv, d3, rows, d3, d, BiasEpi<bf16, bf16>{bqkv, qkv, d3},
                         stream));
  return qkv_attention_mma_any(qkv, ctx, log_size, kmean, batch, seq, heads, head_dim, stream);
}

}  // namespace vt

// `stats` (2 * rows fp32) is fp32's scratch, `h` (rows, d) bf16's; the
// other may be null
extern "C" int vt_ln_qkv_attn(const void* x, const void* ln_scale, const void* ln_bias,
                              const void* wqkv, const void* bqkv, void* stats, void* h,
                              void* qkv, void* ctx, const void* log_size, void* kmean,
                              int batch, int seq, int d, int heads, int head_dim, float eps,
                              int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == vt::kFloat32) {
    typedef float T;
    return (int)vt::ln_qkv_attn<T>((const T*)x, (const T*)ln_scale, (const T*)ln_bias,
                                   (const T*)wqkv, (const T*)bqkv, (float*)stats, (T*)qkv,
                                   (T*)ctx, (const float*)log_size, (T*)kmean, batch, seq, d,
                                   heads, head_dim, eps, s);
  }
  if (dtype == vt::kBFloat16) {
    typedef vt::bf16 T;
    return (int)vt::ln_qkv_attn_mma((const T*)x, (const T*)ln_scale, (const T*)ln_bias,
                                    (const T*)wqkv, (const T*)bqkv, (T*)h, (T*)qkv, (T*)ctx,
                                    (const float*)log_size, (T*)kmean, batch, seq, d, heads,
                                    head_dim, eps, s);
  }
  return (int)cudaErrorInvalidValue;
}
