// The bf16 attention stage over a packed QKV, shared by K1
// (ln_qkv_attn.cu, after its bf16 QKV GEMM) and the bf16 K15
// (ln_qkv_attn_q8.cu, after its int8 one): sdpa_mma.cuh's register tiles,
// K21's body, one block per (image, head, 64-query tile) reading q/k/v in
// place from the packed (head, {q,k,v}, dh) columns as strided views and
// writing the context into the (B*T, H*dh) rows.  Token merging's hooks:
// `log_size` (B, T) fp32 selects the kBias instance, which adds it to the
// key logits before the row max; `kmean` (B*T, dh) is written after the
// attention by attention.cuh's kmean_kernel from the same packed QKV.
#pragma once

#include "attention.cuh"
#include "common.cuh"
#include "sdpa_mma.cuh"

#include <algorithm>

namespace vt {

// one block's attention in bf16: query tile blockIdx.x of (image, head) =
// (blockIdx.z, blockIdx.y), q/k/v read from the packed QKV's columns and
// the context written into the (B*T, H*dh) rows, both in place
template <int DH, bool kBias>
__global__ void __launch_bounds__(kMmaThreads)
qkv_attention_mma_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ ctx,
                         const float* __restrict__ log_size, int seq, int heads,
                         float inv_sqrt_dh) {
  const long long ld = 3LL * heads * DH, dctx = (long long)heads * DH;
  const View4 sqkv{seq * ld, 3 * DH, ld}, so{seq * dctx, DH, dctx};
  sdpa_mma_tile<DH, kBias>(qkv, sqkv, qkv + DH, sqkv, qkv + 2 * DH, sqkv, ctx, so, log_size, seq,
                           inv_sqrt_dh);
}

template <int DH, bool kBias>
cudaError_t launch_qkv_attention_mma(const bf16* qkv, bf16* ctx, const float* log_size,
                                     int batch, int seq, int heads, cudaStream_t stream) {
  constexpr size_t smem = mma_tiles_bytes<DH>(5);
  const float inv_sqrt_dh = (float)(1.0 / sqrt((double)DH));  // as the host computes it
  VT_TRY(cudaFuncSetAttribute(qkv_attention_mma_kernel<DH, kBias>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  qkv_attention_mma_kernel<DH, kBias><<<dim3(cdiv(seq, kMmaRows), heads, batch), kMmaThreads,
                                        smem, stream>>>(qkv, ctx, log_size, seq, heads,
                                                        inv_sqrt_dh);
  return cudaGetLastError();
}

template <int DH>
cudaError_t qkv_attention_mma(const bf16* qkv, bf16* ctx, const float* log_size, int batch,
                              int seq, int heads, cudaStream_t stream) {
  return log_size ? launch_qkv_attention_mma<DH, true>(qkv, ctx, log_size, batch, seq, heads,
                                                       stream)
                  : launch_qkv_attention_mma<DH, false>(qkv, ctx, nullptr, batch, seq, heads,
                                                        stream);
}

// the stage at the head widths it is instantiated for (16, 32, 64, 80,
// 128), then the k-mean when `kmean` is given; batch * seq > 0
inline cudaError_t qkv_attention_mma_any(const bf16* qkv, bf16* ctx, const float* log_size,
                                         bf16* kmean, int batch, int seq, int heads,
                                         int head_dim, cudaStream_t stream) {
  switch (head_dim) {
    case 16: VT_TRY(qkv_attention_mma<16>(qkv, ctx, log_size, batch, seq, heads, stream)); break;
    case 32: VT_TRY(qkv_attention_mma<32>(qkv, ctx, log_size, batch, seq, heads, stream)); break;
    case 64: VT_TRY(qkv_attention_mma<64>(qkv, ctx, log_size, batch, seq, heads, stream)); break;
    case 80: VT_TRY(qkv_attention_mma<80>(qkv, ctx, log_size, batch, seq, heads, stream)); break;
    case 128: VT_TRY(qkv_attention_mma<128>(qkv, ctx, log_size, batch, seq, heads, stream)); break;
    default: return cudaErrorInvalidValue;
  }
  if (!kmean) return cudaSuccess;
  const int rows = batch * seq;
  const size_t n = (size_t)rows * head_dim;
  const int blocks = (int)std::min<size_t>((n + 255) / 256, 4096);
  kmean_kernel<bf16><<<blocks, 256, 0, stream>>>(qkv, kmean, rows, heads, head_dim,
                                                 (float)(1.0 / heads));
  return cudaGetLastError();
}

}  // namespace vt
