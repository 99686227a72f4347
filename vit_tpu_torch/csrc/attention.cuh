// Tile helpers shared by the attention forward (K1, K15, K21) and backward
// (K6): 64 x 64 score tiles from two fp32 shared-memory row tiles, and
// half-warp reductions over a query row; and the forward body itself
// (attention_tile), which reads q, k and v and writes the context through
// an io functor: PackedIo over the packed (B*T, 3D) QKV, which K1 and its
// int8 twin K15 both instantiate (attention_kernel, launch_attention_any)
// with token merging's two hooks — the per-key log-size bias
// (attention_bias_kernel; fused_block.py:183-184) and the mean key over
// heads (kmean_kernel; fused_block.py:219-226) — and StridedIo over three
// (batch, head, token, dh) views and an output view, which K21
// (scaled_dot_product_attention.cu) instantiates.
//
// The head width DH is a template argument, 16 x kDj: 16, 32, 64, 80 (ViT-H,
// vit_h_14) and 128.  The tiles' loops run over DH columns with odd fp32
// pitches (DH + 1), so 80 needs no padding.
#pragma once

#include "common.cuh"

#include <algorithm>

namespace vt {

constexpr int kAtQ = 64, kAtK = 64, kAtThreads = 256;

// element strides of a (batch, head, token, head_dim) view whose last axis
// is contiguous: the packed (B*T, 3D) QKV, the (B*T, D) context, or a
// contiguous (B, H, T, dh) tensor
struct View4 {
  long long b, h, t;
  __device__ __forceinline__ long long at(int bi, int hi) const {
    return (long long)bi * b + (long long)hi * h;
  }
};

// Where one (image, head)'s attention reads element c of token t's q, k
// and v rows, and where it writes token t's context row.

// the packed (B*T, 3D) QKV in (head, {q,k,v}, dh) column order and the
// (B*T, D) context (K1, K15)
template <typename T, int DH>
struct PackedIo {
  const T* base;  // token 0's q of this (image, head)
  int ld;         // packed row pitch (3D)
  T* ctx;
  int b, h, seq, dctx;
  __device__ __forceinline__ T q(int t, int c) const { return base[(size_t)t * ld + c]; }
  __device__ __forceinline__ T k(int t, int c) const { return base[(size_t)t * ld + DH + c]; }
  __device__ __forceinline__ T v(int t, int c) const { return base[(size_t)t * ld + 2 * DH + c]; }
  __device__ __forceinline__ T* out(int t) const {
    return ctx + ((size_t)b * seq + t) * dctx + (size_t)h * DH;
  }
};

// q, k, v and the output as four strided (batch, head, token, dh) views,
// each at this (image, head) with its own token stride (K21)
template <typename T>
struct StridedIo {
  const T *qb, *kb, *vb;
  T* ob;
  long long qt, kt, vt, ot;
  __device__ __forceinline__ T q(int t, int c) const { return qb[t * qt + c]; }
  __device__ __forceinline__ T k(int t, int c) const { return kb[t * kt + c]; }
  __device__ __forceinline__ T v(int t, int c) const { return vb[t * vt + c]; }
  __device__ __forceinline__ T* out(int t) const { return ob + t * ot; }
};

// the key rows alone, for the backward's recompute of the softmax (K6)
template <typename T, int DH>
struct PackedKeys {
  const T* base;
  int ld;
  __device__ __forceinline__ T k(int t, int c) const { return base[(size_t)t * ld + DH + c]; }
};

// s[i][j] = sum_d A[ty + 16i][d] * B[tx + 16j][d] over rows of pitch DH + 1.
// Thread (ty, tx) = (tid / 16, tid % 16) owns rows ty + 16i of A and
// tx + 16j of B (i, j < 4); the 16 threads sharing an A row are one
// half-warp, reduced with xor-shuffles of width 16.
template <int DH>
__device__ __forceinline__ void score_tile(const float* A, const float* B, int tx, int ty,
                                           float s[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < DH; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = A[(ty + 16 * i) * (DH + 1) + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = B[(tx + 16 * j) * (DH + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o, 16));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o, 16);
  return v;
}

// s[i][j] += bias[k0 + tx + 16j]: the log-size bias of the key tile at k0
// (keys past seq are masked by the caller)
__device__ __forceinline__ void add_key_bias(const float* __restrict__ bias, int k0, int seq,
                                             int tx, float s[4][4]) {
  float bv[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int t = k0 + tx + 16 * j;
    bv[j] = t < seq ? bias[t] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] += bv[j];
}

// Running row max m and sum of exp(s - m) over all `seq` keys for the
// query rows held in Qs (pass 1 of the forward, and K6's recompute): key
// tiles read through io.k stream through Ks; keys past seq are excluded.
// kBias adds the image's fp32 log-size row `bias` (seq,) to the scores
// before the row max.
template <typename T, int DH, bool kBias, class Io>
__device__ __forceinline__ void softmax_stats_io(const Io& io, int seq, const float* Qs,
                                                 float* Ks, int tid, int tx, int ty, float m[4],
                                                 float l[4], const float* __restrict__ bias) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  float s[4][4];
  for (int k0 = 0; k0 < seq; k0 += kAtK) {
    __syncthreads();  // Qs written / previous tile consumed
    for (int i = tid; i < kAtK * DH; i += kAtThreads) {
      const int r = i / DH, c = i % DH, t = k0 + r;
      Ks[r * (DH + 1) + c] = t < seq ? to_f(io.k(t, c)) : 0.f;
    }
    __syncthreads();
    score_tile<DH>(Qs, Ks, tx, ty, s);
    if constexpr (kBias) add_key_bias(bias, k0, seq, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (k0 + tx + 16 * j < seq) tmax = fmaxf(tmax, s[i][j]);
      const float mn = fmaxf(m[i], half_warp_max(tmax));  // finite: every tile has a key
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (k0 + tx + 16 * j < seq) ps += expf(s[i][j] - mn);
      l[i] = l[i] * expf(m[i] - mn) + half_warp_sum(ps);
      m[i] = mn;
    }
  }
}

// the same over the key columns of the packed (head, {q,k,v}, dh) QKV at
// `base` (pitch ld)
template <typename T, int DH, bool kBias = false>
__device__ __forceinline__ void softmax_stats(const T* __restrict__ base, int ld, int seq,
                                              const float* Qs, float* Ks, int tid, int tx,
                                              int ty, float m[4], float l[4],
                                              const float* __restrict__ bias = nullptr) {
  softmax_stats_io<T, DH, kBias>(PackedKeys<T, DH>{base, ld}, seq, Qs, Ks, tid, tx, ty, m, l,
                                 bias);
}

// ---- the attention forward: q, k, v -> context (K1, K15, K21).

template <int DH>
constexpr size_t attention_smem_bytes() {
  // Qs [Q][DH+1], Ks [K][DH+1], Vs [K][DH], Ps [Q][K+1], all fp32
  return sizeof(float) *
         (kAtQ * (DH + 1) + kAtK * (DH + 1) + kAtK * DH + kAtQ * (kAtK + 1));
}

// one block's work: the 64 query rows of tile blockIdx.x of one (image,
// head), read and written through `io`; kBias adds the image's log-size row
// `bias` (seq,) to the scores
template <typename T, int DH, bool kBias, class Io>
__device__ __forceinline__ void attention_tile(const Io& io, const float* __restrict__ bias,
                                               int seq, float inv_sqrt_dh) {
  extern __shared__ float smem[];
  float* Qs = smem;                       // [kAtQ][DH + 1]
  float* Ks = Qs + kAtQ * (DH + 1);       // [kAtK][DH + 1]
  float* Vs = Ks + kAtK * (DH + 1);       // [kAtK][DH]
  float* Ps = Vs + kAtK * DH;             // [kAtQ][kAtK + 1]

  const int q0 = blockIdx.x * kAtQ;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  // q * (1/sqrt(dh)) with the scale and the product rounded to the dtype,
  // as the TPU kernel scales q in its working dtype
  const float scale = round_to<T>(inv_sqrt_dh);
  for (int i = tid; i < kAtQ * DH; i += kAtThreads) {
    const int r = i / DH, c = i % DH, t = q0 + r;
    Qs[r * (DH + 1) + c] = t < seq ? round_to<T>(to_f(io.q(t, c)) * scale) : 0.f;
  }

  // pass 1: running row max m and sum of exp(s - m) over all keys
  float m[4], l[4];
  softmax_stats_io<T, DH, kBias>(io, seq, Qs, Ks, tid, tx, ty, m, l, bias);
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
      Ks[r * (DH + 1) + c] = ok ? to_f(io.k(t, c)) : 0.f;
      Vs[r * DH + c] = ok ? to_f(io.v(t, c)) : 0.f;
    }
    __syncthreads();
    score_tile<DH>(Qs, Ks, tx, ty, s);
    if constexpr (kBias) add_key_bias(bias, k0, seq, tx, s);
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

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= seq) continue;
    T* out = io.out(t);
#pragma unroll
    for (int j = 0; j < kDj; ++j) out[tx + 16 * j] = from_f<T>(o[i][j]);
  }
}

// K1/K15's block: (image, head) = (blockIdx.z, blockIdx.y) of the packed
// QKV; kBias adds log_size[b, key] to the scores
template <typename T, int DH, bool kBias>
__device__ __forceinline__ void attention_block(const T* __restrict__ qkv, T* __restrict__ ctx,
                                                const float* __restrict__ log_size, int seq,
                                                int heads, float inv_sqrt_dh) {
  const int h = blockIdx.y, b = blockIdx.z;
  const int ld = 3 * heads * DH;  // packed row pitch (3D)
  const PackedIo<T, DH> io{qkv + (size_t)b * seq * ld + (size_t)h * 3 * DH, ld, ctx, b, h, seq,
                           heads * DH};
  attention_tile<T, DH, kBias>(io, kBias ? log_size + (size_t)b * seq : nullptr, seq,
                               inv_sqrt_dh);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kAtThreads)
attention_kernel(const T* __restrict__ qkv, T* __restrict__ ctx, int seq, int heads,
                 float inv_sqrt_dh) {
  attention_block<T, DH, false>(qkv, ctx, nullptr, seq, heads, inv_sqrt_dh);
}

// token merging's proportional attention: softmax(q k^T / sqrt(dh) + log s)
template <typename T, int DH>
__global__ void __launch_bounds__(kAtThreads)
attention_bias_kernel(const T* __restrict__ qkv, T* __restrict__ ctx,
                      const float* __restrict__ log_size, int seq, int heads,
                      float inv_sqrt_dh) {
  attention_block<T, DH, true>(qkv, ctx, log_size, seq, heads, inv_sqrt_dh);
}

// kmean[r, c] = round((sum over heads, in head order, of k[r, h, c]) * inv_heads)
// in fp32 from the packed (head, {q,k,v}, dh) QKV: token merging's
// similarity metric, the mean attention key over heads
template <typename T>
__global__ void __launch_bounds__(256)
kmean_kernel(const T* __restrict__ qkv, T* __restrict__ kmean, int rows, int heads, int dh,
             float inv_heads) {
  const size_t n = (size_t)rows * dh;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t r = i / dh, c = i % dh;
    const T* k = qkv + r * 3 * heads * dh + dh + c;
    float acc = to_f(k[0]);
    for (int h = 1; h < heads; ++h) acc += to_f(k[(size_t)h * 3 * dh]);
    kmean[i] = from_f<T>(acc * inv_heads);
  }
}

template <typename T, int DH>
cudaError_t launch_attention(const T* qkv, T* ctx, const float* log_size, int batch, int seq,
                             int heads, cudaStream_t stream) {
  constexpr size_t smem = attention_smem_bytes<DH>();
  const float inv_sqrt_dh = (float)(1.0 / sqrt((double)DH));  // as the host computes it
  dim3 grid(cdiv(seq, kAtQ), heads, batch);
  if (log_size) {
    VT_TRY(cudaFuncSetAttribute(attention_bias_kernel<T, DH>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
    attention_bias_kernel<T, DH><<<grid, kAtThreads, smem, stream>>>(qkv, ctx, log_size, seq,
                                                                     heads, inv_sqrt_dh);
    return cudaGetLastError();
  }
  VT_TRY(cudaFuncSetAttribute(attention_kernel<T, DH>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  attention_kernel<T, DH><<<grid, kAtThreads, smem, stream>>>(qkv, ctx, seq, heads, inv_sqrt_dh);
  return cudaGetLastError();
}

// the attention stage at the head dims it is instantiated for; `log_size`
// (batch, seq) fp32 or null, and `kmean` (batch * seq, head_dim) or null
// (token merging's hooks)
template <typename T>
cudaError_t launch_attention_any(const T* qkv, T* ctx, int batch, int seq, int heads, int head_dim,
                                 cudaStream_t stream, const float* log_size = nullptr,
                                 T* kmean = nullptr) {
  switch (head_dim) {
    case 16: VT_TRY((launch_attention<T, 16>(qkv, ctx, log_size, batch, seq, heads, stream))); break;
    case 32: VT_TRY((launch_attention<T, 32>(qkv, ctx, log_size, batch, seq, heads, stream))); break;
    case 64: VT_TRY((launch_attention<T, 64>(qkv, ctx, log_size, batch, seq, heads, stream))); break;
    case 80: VT_TRY((launch_attention<T, 80>(qkv, ctx, log_size, batch, seq, heads, stream))); break;
    case 128: VT_TRY((launch_attention<T, 128>(qkv, ctx, log_size, batch, seq, heads, stream))); break;
    default: return cudaErrorInvalidValue;
  }
  if (!kmean) return cudaSuccess;
  const int rows = batch * seq;
  const size_t n = (size_t)rows * head_dim;
  const int blocks = (int)std::min<size_t>((n + 255) / 256, 4096);
  kmean_kernel<T><<<blocks, 256, 0, stream>>>(qkv, kmean, rows, heads, head_dim,
                                              (float)(1.0 / heads));
  return cudaGetLastError();
}

}  // namespace vt
