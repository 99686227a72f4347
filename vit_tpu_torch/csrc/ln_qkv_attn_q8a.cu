// K19: K15 with int8 attention dots — LN1 -> per-row int8 -> int8 QKV GEMM ->
// dequant + bias -> per-head softmax attention whose q·kᵀ (and, with
// quant_pv, p·v) are exact int32 dots of int8 codes.  Replaces
// vit_tpu/ops/pallas/quant_kernels.py:ln_qkv_attn_q8a (the pallas_call of
// K15 with attn_q8=True; per-head math _head_context_q8).
//
// The kernel study's record kernel (the JAX package's scripts/bench_kernels.py
// and vit_tpu_torch/cli/bench_kernels.py call it; no model path does).
// Stages over device scratches:
//   1-2. K15's: LN1 in fp32, row codes hq and scales hs (quant_rows.cuh);
//        hq @ Wq with exact int32 sums, (acc hs) ws + b rounded to the dtype
//        into the packed (head, {q,k,v}, dh) QKV (gemm_q8.cuh)
//   3a. codes of the attention operands, from the packed QKV in fp32: q per
//       (row, head) and k per (key, head) over dh — the TPU kernel transposes
//       k before it quantizes, so each KEY gets its own scale — and, with
//       quant_pv, v per (image, head, column) over all T keys; each
//       scale = max(absmax / 127, 1e-12), code = clip(rint(v / scale)) with a
//       true divide (quant_rows.cuh)
//   3b. one block per (image, head, 64-query tile), 64-key tiles streamed
//       through shared memory twice:
//         pass 1: s = (float(q8·k8) (qs·(1/sqrt(dh)))) ks with the int32
//         dot by __dp4a over codes packed four to a word; running row max m
//         and sum l of exp(s - m);
//         pass 2: e = exp(s - m); with quant_pv p8 = rint(127 e) at the fixed
//         scale (e <= 1), o += p8·v8 as an exact int32 __dp4a dot over keys
//         packed four to a word, ctx = (float(o) ((1/l) (1/127))) vs; without
//         it p = round_to_dtype(e (1/l)) and o += p v in fp32, as K1.
//       Keys past T load zero codes and take p = 0.  The context is rounded
//       once to the dtype.  With a non-null `p8_out` (the card checks only)
//       the block also writes its p codes to a (B, H, T, T) int8 array.
// No token-merging hooks: the TPU kernel refuses them for this variant.
//
// What bounds it on the H100: the QKV GEMM (B/16 batch 100: 70 G integer
// operations) and the attention dots (12 G integer operations); right
// first — the dots run on the CUDA cores (__dp4a), not on the tensor cores.
#include "attention.cuh"
#include "common.cuh"
#include "gemm_q8.cuh"
#include "quant_rows.cuh"

namespace vt {

// codes and scale of q and of k of one (row, head) over dh, one warp each
template <typename T>
__global__ void __launch_bounds__(256)
quant_qk_kernel(const T* __restrict__ qkv, int8_t* __restrict__ q8, float* __restrict__ qs,
                int8_t* __restrict__ k8, float* __restrict__ ks, int rows, int heads, int dh) {
  const int w = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= rows * heads) return;  // whole warps exit together
  const int r = w / heads, h = w % heads, d = heads * dh;
  const T* base = qkv + (size_t)r * 3 * d + (size_t)h * 3 * dh;
#pragma unroll
  for (int part = 0; part < 2; ++part) {  // q, then k
    const T* src = base + part * dh;
    float amax = 0.f;
    for (int c = lane; c < dh; c += 32) amax = fmaxf(amax, fabsf(to_f(src[c])));
    const float scale = quant_scale(warp_max(amax));
    int8_t* dst = (part ? k8 : q8) + (size_t)r * d + (size_t)h * dh;
    for (int c = lane; c < dh; c += 32) dst[c] = quant_code(to_f(src[c]), scale);
    if (lane == 0) (part ? ks : qs)[(size_t)r * heads + h] = scale;
  }
}

// codes and scale of v of one (image, head, column) over the image's keys,
// one thread each: vs[(b * heads + h) * dh + c]
template <typename T>
__global__ void __launch_bounds__(256)
quant_v_kernel(const T* __restrict__ qkv, int8_t* __restrict__ v8, float* __restrict__ vs,
               int batch, int seq, int heads, int dh) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= batch * heads * dh) return;
  const int c = i % dh, h = (i / dh) % heads, b = i / (dh * heads), d = heads * dh;
  const T* src = qkv + (size_t)b * seq * 3 * d + (size_t)h * 3 * dh + 2 * dh + c;
  float amax = 0.f;
  for (int t = 0; t < seq; ++t) amax = fmaxf(amax, fabsf(to_f(src[(size_t)t * 3 * d])));
  const float scale = quant_scale(amax);
  int8_t* dst = v8 + (size_t)b * seq * d + (size_t)h * dh + c;
  for (int t = 0; t < seq; ++t) dst[(size_t)t * d] = quant_code(to_f(src[(size_t)t * 3 * d]), scale);
  vs[i] = scale;
}

// ---- the int8 attention tile.  Thread (ty, tx) = (tid / 16, tid % 16) owns
// query rows ty + 16i and keys tx + 16j (i, j < 4) of a 64 x 64 score tile,
// and context columns tx + 16j (j < DH / 16).

constexpr int kQaPb = kAtK + 4;  // bytes per row of the p and v^T code tiles (17 words)

template <int DH>
__host__ __device__ constexpr int qa_words() { return DH / 4 + 1; }  // per packed q/k row (odd)

template <int DH, bool kQuantPv>
constexpr size_t attention_q8_smem_bytes() {
  // Qw [Q][DH/4+1], Kw [K][DH/4+1] int; qsc [Q], ksc [K] fp32; then
  // quant_pv: Pb [Q][K+4], Vb [DH][K+4] int8; else Ps [Q][K+1], Vs [K][DH] fp32
  return sizeof(int) * (kAtQ + kAtK) * qa_words<DH>() + sizeof(float) * (kAtQ + kAtK) +
         (kQuantPv ? (size_t)(kAtQ + DH) * kQaPb
                   : sizeof(float) * ((size_t)kAtQ * (kAtK + 1) + (size_t)kAtK * DH));
}

// the 64 packed key rows from key k0 and their scales; zeros past seq
template <int DH>
__device__ __forceinline__ void load_key_codes(const int8_t* __restrict__ k8,
                                               const float* __restrict__ ks, size_t row0,
                                               int k0, int seq, int h, int heads, int* Kw,
                                               float* ksc, int tid) {
  constexpr int W = qa_words<DH>(), kWords = DH / 4;
  const int d = heads * DH;
  for (int i = tid; i < kAtK * kWords; i += kAtThreads) {
    const int r = i / kWords, w = i % kWords, t = k0 + r;
    Kw[r * W + w] =
        t < seq ? *reinterpret_cast<const int*>(k8 + (row0 + t) * d + (size_t)h * DH + 4 * w) : 0;
  }
  for (int r = tid; r < kAtK; r += kAtThreads) {
    const int t = k0 + r;
    ksc[r] = t < seq ? ks[(row0 + t) * heads + h] : 0.f;
  }
}

// s[i][j] = (float(q8 · k8) qsc[row]) ksc[key], the int32 dot by __dp4a
template <int DH>
__device__ __forceinline__ void score_tile_q8(const int* Qw, const int* Kw, const float* qsc,
                                              const float* ksc, int tx, int ty, float s[4][4]) {
  constexpr int W = qa_words<DH>();
  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;
#pragma unroll 4
  for (int w = 0; w < DH / 4; ++w) {
    int av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = Qw[(ty + 16 * i) * W + w];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = Kw[(tx + 16 * j) * W + w];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      s[i][j] = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j]), qsc[ty + 16 * i]), ksc[tx + 16 * j]);
}

template <typename T, int DH, bool kQuantPv>
__global__ void __launch_bounds__(kAtThreads)
attention_q8_kernel(const T* __restrict__ qkv, const int8_t* __restrict__ q8,
                    const float* __restrict__ qs, const int8_t* __restrict__ k8,
                    const float* __restrict__ ks, const int8_t* __restrict__ v8,
                    const float* __restrict__ vs, T* __restrict__ ctx,
                    int8_t* __restrict__ p8_out, int seq, int heads, float inv_sqrt_dh) {
  constexpr int W = qa_words<DH>(), kWords = DH / 4, kDj = DH / 16;
  extern __shared__ float smem[];
  int* Qw = reinterpret_cast<int*>(smem);
  int* Kw = Qw + kAtQ * W;
  float* qsc = reinterpret_cast<float*>(Kw + kAtK * W);
  float* ksc = qsc + kAtQ;
  float* rest = ksc + kAtK;

  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * kAtQ;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int d = heads * DH;
  const size_t row0 = (size_t)b * seq;

  for (int i = tid; i < kAtQ * kWords; i += kAtThreads) {
    const int r = i / kWords, w = i % kWords, t = q0 + r;
    Qw[r * W + w] =
        t < seq ? *reinterpret_cast<const int*>(q8 + (row0 + t) * d + (size_t)h * DH + 4 * w) : 0;
  }
  for (int r = tid; r < kAtQ; r += kAtThreads) {  // qs * (1/sqrt(dh)), as the TPU kernel
    const int t = q0 + r;
    qsc[r] = t < seq ? __fmul_rn(qs[(row0 + t) * heads + h], inv_sqrt_dh) : 0.f;
  }

  // pass 1: running row max m and sum l of exp(s - m) over all keys
  float m[4], l[4], s[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  for (int k0 = 0; k0 < seq; k0 += kAtK) {
    __syncthreads();  // Qw written / previous tile consumed
    load_key_codes<DH>(k8, ks, row0, k0, seq, h, heads, Kw, ksc, tid);
    __syncthreads();
    score_tile_q8<DH>(Qw, Kw, qsc, ksc, tx, ty, s);
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

  if constexpr (kQuantPv) {
    // pass 2: p8 = rint(127 exp(s - m)), o += p8 · v8 in int32
    signed char* Pb = reinterpret_cast<signed char*>(rest);  // [kAtQ][kQaPb]
    signed char* Vb = Pb + kAtQ * kQaPb;                       // [DH][kQaPb]: v codes, keys along
    int o[4][kDj];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kDj; ++j) o[i][j] = 0;
    for (int k0 = 0; k0 < seq; k0 += kAtK) {
      __syncthreads();  // previous tile's Kw/Pb/Vb consumed
      load_key_codes<DH>(k8, ks, row0, k0, seq, h, heads, Kw, ksc, tid);
      for (int i = tid; i < kAtK * DH; i += kAtThreads) {
        const int r = i / DH, c = i % DH, t = k0 + r;
        Vb[c * kQaPb + r] = t < seq ? v8[(row0 + t) * d + (size_t)h * DH + c] : 0;
      }
      __syncthreads();
      score_tile_q8<DH>(Qw, Kw, qsc, ksc, tx, ty, s);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int tq = q0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int tk = k0 + tx + 16 * j;
          const signed char p =
              tk < seq ? (signed char)(int)rintf(__fmul_rn(expf(s[i][j] - m[i]), 127.f)) : 0;
          Pb[(ty + 16 * i) * kQaPb + tx + 16 * j] = p;
          if (p8_out && tq < seq && tk < seq)
            p8_out[(((size_t)b * heads + h) * seq + tq) * seq + tk] = p;
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int w = 0; w < kAtK / 4; ++w) {
        int pw[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          pw[i] = *reinterpret_cast<const int*>(Pb + (ty + 16 * i) * kQaPb + 4 * w);
#pragma unroll
        for (int j = 0; j < kDj; ++j) {
          const int vw = *reinterpret_cast<const int*>(Vb + (tx + 16 * j) * kQaPb + 4 * w);
#pragma unroll
          for (int i = 0; i < 4; ++i) o[i][j] = __dp4a(pw[i], vw, o[i][j]);
        }
      }
    }
    const float* vsh = vs + ((size_t)b * heads + h) * DH;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = q0 + ty + 16 * i;
      if (t >= seq) continue;
      const float f = __fmul_rn(1.0f / l[i], 1.0f / 127.0f);  // (1/l) (1/127)
      T* out = ctx + (row0 + t) * d + (size_t)h * DH;
#pragma unroll
      for (int j = 0; j < kDj; ++j) {
        const int c = tx + 16 * j;
        out[c] = from_f<T>(__fmul_rn(__fmul_rn(__int2float_rn(o[i][j]), f), vsh[c]));
      }
    }
  } else {
    // pass 2: p = round_to_dtype(exp(s - m) (1/l)), o += p v in fp32 (K1's)
    float* Ps = rest;                  // [kAtQ][kAtK + 1]
    float* Vs = Ps + kAtQ * (kAtK + 1);  // [kAtK][DH]
    const T* vbase = qkv + row0 * 3 * d + (size_t)h * 3 * DH + 2 * DH;
    float inv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) inv[i] = 1.0f / l[i];
    float o[4][kDj];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kDj; ++j) o[i][j] = 0.f;
    for (int k0 = 0; k0 < seq; k0 += kAtK) {
      __syncthreads();  // previous tile's Kw/Ps/Vs consumed
      load_key_codes<DH>(k8, ks, row0, k0, seq, h, heads, Kw, ksc, tid);
      for (int i = tid; i < kAtK * DH; i += kAtThreads) {
        const int r = i / DH, c = i % DH, t = k0 + r;
        Vs[r * DH + c] = t < seq ? to_f(vbase[(size_t)t * 3 * d + c]) : 0.f;
      }
      __syncthreads();
      score_tile_q8<DH>(Qw, Kw, qsc, ksc, tx, ty, s);
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
      T* out = ctx + (row0 + t) * d + (size_t)h * DH;
#pragma unroll
      for (int j = 0; j < kDj; ++j) out[tx + 16 * j] = from_f<T>(o[i][j]);
    }
  }
}

template <typename T, int DH, bool kQuantPv>
cudaError_t launch_attention_q8(const T* qkv, const int8_t* q8, const float* qs, const int8_t* k8,
                                const float* ks, const int8_t* v8, const float* vs, T* ctx,
                                int8_t* p8_out, int batch, int seq, int heads,
                                cudaStream_t stream) {
  constexpr size_t smem = attention_q8_smem_bytes<DH, kQuantPv>();
  const float inv_sqrt_dh = (float)(1.0 / sqrt((double)DH));  // as the host computes it
  VT_TRY(cudaFuncSetAttribute(attention_q8_kernel<T, DH, kQuantPv>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  attention_q8_kernel<T, DH, kQuantPv><<<dim3(cdiv(seq, kAtQ), heads, batch), kAtThreads, smem,
                                         stream>>>(qkv, q8, qs, k8, ks, v8, vs, ctx, p8_out, seq,
                                                   heads, inv_sqrt_dh);
  return cudaGetLastError();
}

template <typename T, bool kQuantPv>
cudaError_t launch_attention_q8_any(const T* qkv, const int8_t* q8, const float* qs,
                                    const int8_t* k8, const float* ks, const int8_t* v8,
                                    const float* vs, T* ctx, int8_t* p8_out, int batch, int seq,
                                    int heads, int head_dim, cudaStream_t stream) {
  switch (head_dim) {
#define VT_QA_CASE(DH)                                                                      \
  case DH:                                                                                  \
    return launch_attention_q8<T, DH, kQuantPv>(qkv, q8, qs, k8, ks, v8, vs, ctx, p8_out,   \
                                                batch, seq, heads, stream);
    VT_QA_CASE(16)
    VT_QA_CASE(32)
    VT_QA_CASE(64)
    VT_QA_CASE(80)
    VT_QA_CASE(128)
#undef VT_QA_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t ln_qkv_attn_q8a(const T* x, const T* ln_scale, const T* ln_bias, const int8_t* wq,
                            const float* ws, const T* bqkv, int8_t* hq, float* hs, T* qkv,
                            int8_t* q8, float* qs, int8_t* k8, float* ks, int8_t* v8, float* vs,
                            int8_t* p8_out, T* ctx, int batch, int seq, int d, int heads,
                            int head_dim, int quant_pv, float eps, cudaStream_t stream) {
  const int rows = batch * seq, d3 = 3 * heads * head_dim;
  VT_TRY(launch_ln_quant_rows(x, ln_scale, ln_bias, hq, hs, rows, d, eps, stream));
  VT_TRY(launch_gemm_q8(hq, wq, rows, d3, d, DequantBiasEpi<T>{hs, ws, bqkv, qkv, d3}, stream));
  if (rows <= 0) return cudaSuccess;
  quant_qk_kernel<T><<<cdiv(rows * heads, 8), 256, 0, stream>>>(qkv, q8, qs, k8, ks, rows, heads,
                                                                head_dim);
  VT_TRY(cudaGetLastError());
  if (!quant_pv)
    return launch_attention_q8_any<T, false>(qkv, q8, qs, k8, ks, nullptr, nullptr, ctx, nullptr,
                                             batch, seq, heads, head_dim, stream);
  quant_v_kernel<T><<<cdiv(batch * heads * head_dim, 256), 256, 0, stream>>>(
      qkv, v8, vs, batch, seq, heads, head_dim);
  VT_TRY(cudaGetLastError());
  return launch_attention_q8_any<T, true>(qkv, q8, qs, k8, ks, v8, vs, ctx, p8_out, batch, seq,
                                          heads, head_dim, stream);
}

}  // namespace vt

extern "C" int vt_ln_qkv_attn_q8a(const void* x, const void* ln_scale, const void* ln_bias,
                                  const void* wq, const void* ws, const void* bqkv, void* hq,
                                  void* hs, void* qkv, void* q8, void* qs, void* k8, void* ks,
                                  void* v8, void* vs, void* p8, void* ctx, int batch, int seq,
                                  int d, int heads, int head_dim, int quant_pv, float eps,
                                  int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
#define VT_QA_ARGS(T)                                                                         \
  (const T*)x, (const T*)ln_scale, (const T*)ln_bias, (const int8_t*)wq, (const float*)ws,   \
      (const T*)bqkv, (int8_t*)hq, (float*)hs, (T*)qkv, (int8_t*)q8, (float*)qs,              \
      (int8_t*)k8, (float*)ks, (int8_t*)v8, (float*)vs, (int8_t*)p8, (T*)ctx, batch, seq, d,  \
      heads, head_dim, quant_pv, eps, s
  if (dtype == vt::kFloat32) return (int)vt::ln_qkv_attn_q8a<float>(VT_QA_ARGS(float));
  if (dtype == vt::kBFloat16) return (int)vt::ln_qkv_attn_q8a<vt::bf16>(VT_QA_ARGS(vt::bf16));
#undef VT_QA_ARGS
  return (int)cudaErrorInvalidValue;
}
