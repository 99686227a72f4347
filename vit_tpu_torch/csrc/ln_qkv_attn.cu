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
#include "attention.cuh"
#include "common.cuh"
#include "epilogue.cuh"
#include "gemm.cuh"

namespace vt {

template <int DH>
constexpr size_t attention_smem_bytes() {
  // Qs [Q][DH+1], Ks [K][DH+1], Vs [K][DH], Ps [Q][K+1], all fp32
  return sizeof(float) *
         (kAtQ * (DH + 1) + kAtK * (DH + 1) + kAtK * DH + kAtQ * (kAtK + 1));
}

template <typename T, int DH>
__global__ void __launch_bounds__(kAtThreads)
attention_kernel(const T* __restrict__ qkv, T* __restrict__ ctx, int seq, int heads,
                 float inv_sqrt_dh) {
  extern __shared__ float smem[];
  float* Qs = smem;                       // [kAtQ][DH + 1]
  float* Ks = Qs + kAtQ * (DH + 1);       // [kAtK][DH + 1]
  float* Vs = Ks + kAtK * (DH + 1);       // [kAtK][DH]
  float* Ps = Vs + kAtK * DH;             // [kAtQ][kAtK + 1]

  const int q0 = blockIdx.x * kAtQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int ld = 3 * heads * DH;  // packed row pitch (3D)
  const T* base = qkv + (size_t)b * seq * ld + (size_t)h * 3 * DH;

  // q * (1/sqrt(dh)) with the scale and the product rounded to the dtype,
  // as the TPU kernel scales q in its working dtype
  const float scale = round_to<T>(inv_sqrt_dh);
  for (int i = tid; i < kAtQ * DH; i += kAtThreads) {
    const int r = i / DH, c = i % DH, t = q0 + r;
    Qs[r * (DH + 1) + c] = t < seq ? round_to<T>(to_f(base[(size_t)t * ld + c]) * scale) : 0.f;
  }

  // pass 1: running row max m and sum of exp(s - m) over all keys
  float m[4], l[4];
  softmax_stats<T, DH>(base, ld, seq, Qs, Ks, tid, tx, ty, m, l);
  float s[4][4];
  float inv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) inv[i] = 1.0f / l[i];

  // pass 2: p = round(exp(s - m) * inv), o += p @ v in fp32
  constexpr int kDj = DH / 16;  // output columns per thread: tx + 16j
  float o[4][kDj];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kDj; ++j) o[i][j] = 0.f;
  for (int k0 = 0; k0 < seq; k0 += kAtK) {
    __syncthreads();  // previous tile's Ks/Vs/Ps consumed
    for (int i = tid; i < kAtK * DH; i += kAtThreads) {
      const int r = i / DH, c = i % DH, t = k0 + r;
      const bool ok = t < seq;
      Ks[r * (DH + 1) + c] = ok ? to_f(base[(size_t)t * ld + DH + c]) : 0.f;
      Vs[r * DH + c] = ok ? to_f(base[(size_t)t * ld + 2 * DH + c]) : 0.f;
    }
    __syncthreads();
    score_tile<DH>(Qs, Ks, tx, ty, s);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = k0 + tx + 16 * j < seq;
        Ps[(ty + 16 * i) * (kAtK + 1) + tx + 16 * j] =
            ok ? round_to<T>(expf(s[i][j] - m[i]) * inv[i]) : 0.f;
      }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kAtK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * (kAtK + 1) + kk];
#pragma unroll
      for (int j = 0; j < kDj; ++j) {
        const float vv = Vs[kk * DH + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) o[i][j] = fmaf(pv[i], vv, o[i][j]);
      }
    }
  }

  const int dctx = heads * DH;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= seq) continue;
    T* out = ctx + ((size_t)b * seq + t) * dctx + (size_t)h * DH;
#pragma unroll
    for (int j = 0; j < kDj; ++j) out[tx + 16 * j] = from_f<T>(o[i][j]);
  }
}

template <typename T, int DH>
cudaError_t launch_attention(const T* qkv, T* ctx, int batch, int seq, int heads,
                             cudaStream_t stream) {
  constexpr size_t smem = attention_smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(attention_kernel<T, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const float inv_sqrt_dh = (float)(1.0 / sqrt((double)DH));  // as the host computes it
  dim3 grid(cdiv(seq, kAtQ), heads, batch);
  attention_kernel<T, DH><<<grid, kAtThreads, smem, stream>>>(qkv, ctx, seq, heads, inv_sqrt_dh);
  return cudaGetLastError();
}

template <typename T>
cudaError_t ln_qkv_attn(const T* x, const T* ln_scale, const T* ln_bias, const T* wqkv,
                        const T* bqkv, float* stats, T* qkv, T* ctx, int batch, int seq, int d,
                        int heads, int head_dim, float eps, cudaStream_t stream) {
  const int rows = batch * seq, d3 = 3 * heads * head_dim;
  float* mean = stats;
  float* rstd = stats + rows;
  cudaError_t err = launch_row_stats(x, mean, rstd, rows, d, eps, stream);
  if (err != cudaSuccess) return err;
  err = launch_gemm<T>(LoadLn<T, T>{x, d, mean, rstd, ln_scale, ln_bias}, Load<T>{wqkv, d3},
                       rows, d3, d, BiasEpi<T, T>{bqkv, qkv, d3}, stream);
  if (err != cudaSuccess) return err;
  switch (head_dim) {
    case 16: return launch_attention<T, 16>(qkv, ctx, batch, seq, heads, stream);
    case 32: return launch_attention<T, 32>(qkv, ctx, batch, seq, heads, stream);
    case 64: return launch_attention<T, 64>(qkv, ctx, batch, seq, heads, stream);
    case 128: return launch_attention<T, 128>(qkv, ctx, batch, seq, heads, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace vt

extern "C" int vt_ln_qkv_attn(const void* x, const void* ln_scale, const void* ln_bias,
                              const void* wqkv, const void* bqkv, void* stats, void* qkv,
                              void* ctx, int batch, int seq, int d, int heads, int head_dim,
                              float eps, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  float* st = (float*)stats;
  if (dtype == vt::kFloat32) {
    typedef float T;
    return (int)vt::ln_qkv_attn<T>((const T*)x, (const T*)ln_scale, (const T*)ln_bias,
                                   (const T*)wqkv, (const T*)bqkv, st, (T*)qkv, (T*)ctx, batch,
                                   seq, d, heads, head_dim, eps, s);
  }
  if (dtype == vt::kBFloat16) {
    typedef vt::bf16 T;
    return (int)vt::ln_qkv_attn<T>((const T*)x, (const T*)ln_scale, (const T*)ln_bias,
                                   (const T*)wqkv, (const T*)bqkv, st, (T*)qkv, (T*)ctx, batch,
                                   seq, d, heads, head_dim, eps, s);
  }
  return (int)cudaErrorInvalidValue;
}
