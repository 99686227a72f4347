// K19: K15 with int8 attention dots — LN1 -> per-row int8 -> int8 QKV GEMM ->
// dequant + bias -> per-head softmax attention whose q·kᵀ (and, with
// quant_pv, p·v) are exact int32 dots of int8 codes.  Replaces
// vit_tpu/ops/pallas/quant_kernels.py:ln_qkv_attn_q8a (the pallas_call of
// K15 with attn_q8=True; per-head math _head_context_q8).
//
// The kernel study's record kernel (the JAX package's scripts/bench_kernels.py
// and vit_tpu_torch/cli/bench_kernels.py call it; no model path does): it
// asks whether int8 attention dots pay for themselves against K15's
// attention in the working dtype, so its bf16 form runs on the cores K15
// runs on.  No token-merging hooks: the TPU kernel refuses them for this
// variant.  The quantization grouping and rounding points are the TPU
// kernel's, in both dtypes:
//   - q codes per (row, head) and k codes per (key, head) over dh — the TPU
//     kernel transposes k before it quantizes, so each KEY gets its own
//     scale — and, with quant_pv, v codes per (image, head, column) over all
//     T keys; each scale = max(absmax / 127, 1e-12), code = clip(rint(v /
//     scale)) with a true divide (quant_rows.cuh);
//   - s = (float(q8·k8) (qs·(1/sqrt(dh)))) ks, each product rounded
//     (__fmul_rn); the exact row max m over all keys and the sum l of
//     expf(s - m) (pass 1; expf, not __expf: the p codes depend on it);
//   - pass 2: e = expf(s - m) with the final m; with quant_pv p8 = rint(127
//     e) at the fixed scale (e <= 1), o = p8·v8 in int32, ctx = (float(o)
//     ((1/l) (1/127))) vs; without it p = round_to_dtype(e (1/l)) and o = p v
//     in fp32, as K1.  An int32 sum cannot be rescaled exactly and the
//     fixed scale needs e <= 1 of the true row max, so the two passes stay
//     (K13's online softmax does not apply).  Keys past T take p = 0; the
//     context is rounded once to the dtype.  With a non-null `p8_out` (the
//     card checks only) the kernel also writes its p codes to a (B, H, T, T)
//     int8 array.
//
// bf16 (the study's dtype), on the cores the bf16 K15 runs on:
//   1-2. K15's stages through its own host function (ln_qkv_q8_mma.cuh): Wq
//        copied K-major into wqt, LN1's row codes, the int8 QKV GEMM on
//        gemm_mma_q8.cuh's TMA + wgmma core — the packed QKV is K15's bit
//        for bit;
//   3a. the attention operands' codes in two vectorized passes over the
//       packed bf16 QKV, 16-byte loads: q and k a group of lanes per (row,
//       head, q|k), one 16-byte chunk each, the maximum by shuffles, 8-byte
//       code stores into (B*T, D) rows; v one block per (image, head), the
//       column maxima over T keys,
//       then the codes through a shared-memory transpose into a
//       keys-contiguous (B, H, dh, T padded to 16) array, 16-byte stores:
//       p·v's B operand must lie K-major (ldmatrix moves 16-bit elements;
//       .trans would swap byte pairs);
//   3b. attention on mma.sync m16n8k32 s8 register tiles (mma_s8.cuh),
//       organised as sdpa_mma.cuh: one block of 4 warps x 16 query rows per
//       (image, head, 64-query tile), q codes loaded once by cp.async and
//       held as A fragments, k codes (and in pass 2 v codes) in 64-key tiles
//       through a 2-stage cp.async ring, the row max and sum in registers
//       (quad shuffles).  The K tile's rows hold keys in the order tile_key
//       gives, so that the score columns a thread holds are the keys its A
//       fragment of p needs: p8 is packed four codes to a register with no
//       shuffle or shared-memory trip (mma_s8.cuh).  Head widths 16 and 80
//       are padded with zero code columns to the k32 step.  Without quant_pv
//       the score dot stays int8 and p·v runs on mma_bf16.cuh's m16n8k16
//       tiles, v read from the packed QKV in the same key order.  The context
//       leaves in 16-byte stores (store_rows16).
// fp32 keeps the first design: gemm_q8.cuh's WMMA QKV GEMM, one-warp and
// one-thread code passes, and 64 x 64 score tiles with __dp4a dots on the
// CUDA cores.
//
// What bounds it on the H100: operations — the QKV GEMM (B/16 batch 100:
// 70 G integer operations) and the attention dots (12 G), at the int8
// tensor-core rate.
#include "attention.cuh"
#include "common.cuh"
#include "gemm_q8.cuh"
#include "ln_qkv_q8_mma.cuh"
#include "mma_s8.cuh"
#include "quant_rows.cuh"

#include <type_traits>

namespace vt {

// ---- fp32 (the first design): stage 3a and 3b on the CUDA cores

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

// ---- bf16: stage 3a, the attention operands' codes

constexpr int kCodeThreads = 256;
constexpr int kV8KeyPad = 16;  // v codes: each (image, head, column) row of keys padded to 16

__host__ __device__ constexpr int v8_pitch(int seq) {
  return (seq + kV8KeyPad - 1) / kV8KeyPad * kV8KeyPad;
}

// lanes per (row, head, q|k) segment in quant_qk_vec_kernel: one per
// 16-byte chunk of its dh values, rounded up to a power of two
__host__ __device__ constexpr int qk_group(int dh) {
  return dh <= 16 ? 2 : dh <= 32 ? 4 : dh <= 64 ? 8 : 16;
}

// codes and scale of q or k of one (row, head) over dh: a group of
// qk_group(DH) lanes per segment 2 (row heads + head) + part (part 0 = q,
// 1 = k), lane j holding 16-byte chunk j (8 values), so a warp reads whole
// neighbouring segments; the group's max by xor shuffles, 8-byte code
// stores
template <int DH>
__global__ void __launch_bounds__(kCodeThreads)
quant_qk_vec_kernel(const bf16* __restrict__ qkv, int8_t* __restrict__ q8,
                    float* __restrict__ qs, int8_t* __restrict__ k8, float* __restrict__ ks,
                    int rows, int heads) {
  constexpr int kC = DH / 8, kG = qk_group(DH);  // chunks, lanes per segment
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) / kG, j = threadIdx.x % kG;
  const bool ok = i < 2 * rows * heads && j < kC;  // every lane stays for the shuffles
  const int part = i & 1, rh = i >> 1, r = rh / heads, h = rh - r * heads, d = heads * DH;
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (ok)
    v = reinterpret_cast<const uint4*>(qkv + (size_t)r * 3 * d + (size_t)h * 3 * DH +
                                       part * DH)[j];
  const uint32_t* w = reinterpret_cast<const uint32_t*>(&v);
  float amax = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = unpack_bf16(w[e]);
    amax = fmaxf(amax, fmaxf(fabsf(f.x), fabsf(f.y)));
  }
#pragma unroll
  for (int o = kG / 2; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if (!ok) return;
  const float scale = quant_scale(amax);
  uint2 out;
  const float2 f0 = unpack_bf16(w[0]), f1 = unpack_bf16(w[1]), f2 = unpack_bf16(w[2]),
               f3 = unpack_bf16(w[3]);
  out.x = pack_s8(quant_code(f0.x, scale), quant_code(f0.y, scale), quant_code(f1.x, scale),
                  quant_code(f1.y, scale));
  out.y = pack_s8(quant_code(f2.x, scale), quant_code(f2.y, scale), quant_code(f3.x, scale),
                  quant_code(f3.y, scale));
  reinterpret_cast<uint2*>((part ? k8 : q8) + (size_t)r * d + (size_t)h * DH)[j] = out;
  if (j == 0) (part ? ks : qs)[rh] = scale;
}

constexpr int kVtLd = kMmaRows + 16;  // a v code tile's row: 64 keys + 16 bytes

// codes and scales of v of one (image, head) = (blockIdx.y, blockIdx.x) per
// column over its T keys: vs[(b heads + h) dh + c], and the codes keys-
// contiguous, v8[((b heads + h) dh + c) v8_pitch(T) + key], zero past T.
// Thread (r, c) = (tid / kC, tid % kC) reads 16-byte chunk c of tokens r, r
// + kR, ...: the column maxima join through shared memory; then 64-key
// tiles of codes are transposed through shared memory into 16-byte stores.
template <int DH>
__global__ void __launch_bounds__(kCodeThreads)
quant_v_vec_kernel(const bf16* __restrict__ qkv, int8_t* __restrict__ v8, float* __restrict__ vs,
                   int seq, int heads) {
  constexpr int kC = DH / 8, kR = kCodeThreads / kC, kThreads = kC * kR;
  __shared__ float part[kR][DH];
  __shared__ float scale[DH];
  __shared__ __align__(16) int8_t tile[DH][kVtLd];
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x, c = tid % kC, r = tid / kC;
  const int d = heads * DH, tp = v8_pitch(seq);
  const bf16* src = qkv + (size_t)b * seq * 3 * d + (size_t)h * 3 * DH + 2 * DH + 8 * c;
  float amax[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) amax[e] = 0.f;
  for (int t = r; t < seq; t += kR) {
    const uint4 v = *reinterpret_cast<const uint4*>(src + (size_t)t * 3 * d);
    const uint32_t* w = reinterpret_cast<const uint32_t*>(&v);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = unpack_bf16(w[e]);
      amax[2 * e] = fmaxf(amax[2 * e], fabsf(f.x));
      amax[2 * e + 1] = fmaxf(amax[2 * e + 1], fabsf(f.y));
    }
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) part[r][8 * c + e] = amax[e];
  __syncthreads();
  if (tid < DH) {
    float a = 0.f;
    for (int i = 0; i < kR; ++i) a = fmaxf(a, part[i][tid]);
    scale[tid] = quant_scale(a);
    vs[((size_t)b * heads + h) * DH + tid] = scale[tid];
  }
  __syncthreads();
  float sc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) sc[e] = scale[8 * c + e];
  int8_t* dst = v8 + ((size_t)b * heads + h) * DH * tp;
  for (int k0 = 0; k0 < tp; k0 += kMmaRows) {
    for (int t = r; t < kMmaRows; t += kR) {
      const int key = k0 + t;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (key < seq) v = *reinterpret_cast<const uint4*>(src + (size_t)key * 3 * d);
      const uint32_t* w = reinterpret_cast<const uint32_t*>(&v);
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // quant_code(0) = 0: zero codes past T
        const float2 f = unpack_bf16(w[e]);
        tile[8 * c + 2 * e][t] = quant_code(f.x, sc[2 * e]);
        tile[8 * c + 2 * e + 1][t] = quant_code(f.y, sc[2 * e + 1]);
      }
    }
    __syncthreads();
    for (int i = tid; i < DH * 4; i += kThreads) {
      const int n = i >> 2, j = (i & 3) * 16;
      if (k0 + j < tp)
        *reinterpret_cast<uint4*>(dst + (size_t)n * tp + k0 + j) =
            *reinterpret_cast<const uint4*>(&tile[n][j]);
    }
    __syncthreads();
  }
}

// ---- bf16: stage 3b, attention on int8 register tiles
//
// Tiles: q codes [64][s8_ld(DH)] (rows = queries), two stages of k codes
// [64][s8_ld(DH)] (rows = keys in tile_key order) with their 64 key scales,
// and two stages of v: with quant_pv codes [DH][kVtLd] (rows = dh columns,
// keys along), else bf16 rows [64][mma_ld(DH)] in tile_key order.  A code
// row is dh padded with zeros to the k32 step (s8_cols), then 16 bytes more,
// so that the 8 rows of one ldmatrix phase fall in disjoint bank groups.

__host__ __device__ constexpr int s8_cols(int dh) { return (dh + 31) / 32 * 32; }
__host__ __device__ constexpr int s8_ld(int dh) { return s8_cols(dh) + 16; }

// the key (0..63) that row r of a K or V tile holds.  A thread (g, c) holds
// score columns 8j + 2c, 8j + 2c + 1 of n8 tiles j; with this order those of
// tiles 4kk .. 4kk + 3 are keys 32kk + 4c .. 4c + 3 and 32kk + 16 + 4c ..
// 16 + 4c + 3, the columns of its m16n8k32 A fragment of step kk
__device__ __forceinline__ int tile_key(int r) {
  const int m = (r >> 3) & 3, c = (r >> 1) & 3;
  return (r & 32) + 16 * (m >> 1) + 4 * c + 2 * (m & 1) + (r & 1);
}

template <int DH, bool kQuantPv>
__host__ __device__ constexpr size_t attention_s8_smem_bytes() {
  return (size_t)3 * kMmaRows * s8_ld(DH) + 2 * kMmaRows * sizeof(float) +
         (kQuantPv ? (size_t)2 * DH * kVtLd : mma_tiles_bytes<DH>(2));
}

// tile row r (row pitch `ld` elements) from row t0 + tile_key(r) (kKeys) or
// t0 + r of a slab with row pitch `st` elements, kBytes bytes each, by
// 16-byte cp.async; zeros past seq
template <bool kKeys, int kBytes, typename E>
__device__ __forceinline__ void cp_tile_rows(E* tile, int ld, const E* __restrict__ x,
                                             long long st, int t0, int seq) {
  constexpr int kC = kBytes / 16, kE = 16 / (int)sizeof(E);
  for (int i = threadIdx.x; i < kMmaRows * kC; i += kMmaThreads) {
    const int r = i / kC, cc = (i % kC) * kE, t = t0 + (kKeys ? tile_key(r) : r);
    const bool ok = t < seq;
    cp_async16(tile + r * ld + cc, ok ? x + t * st + cc : x, ok);
  }
}

// one warp's 16 x 64 scores of a K tile: s = (float(q8 · k8) qsc) ksc, -inf
// past seq; sc[j] holds columns 8j + 2c, + 1 of rows g, g + 8
template <int DH>
__device__ __forceinline__ void score_tile_s8(float (&sc)[8][4],
                                              const uint32_t (&qf)[s8_cols(DH) / 32][4],
                                              const int8_t* Kt, const float* ksc,
                                              const float (&qsc)[2], int k0, int seq) {
  const int c = threadIdx.x & 3;
  int acc[8][4];
  zero(acc);
#pragma unroll
  for (int kk = 0; kk < s8_cols(DH) / 32; ++kk)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      uint32_t bk[4];
      ldsm_b_s8(bk, Kt, s8_ld(DH), 16 * jj, 32 * kk);
      mma16832_s8(acc[2 * jj], qf[kk], bk[0], bk[1]);
      mma16832_s8(acc[2 * jj + 1], qf[kk], bk[2], bk[3]);
    }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int r = 8 * j + 2 * c, key = k0 + tile_key(r);  // key + 1 is row r + 1's
    const float2 kv = *reinterpret_cast<const float2*>(ksc + r);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float s = __fmul_rn(__fmul_rn(__int2float_rn(acc[j][e]), qsc[e >> 1]),
                                e & 1 ? kv.y : kv.x);
      sc[j][e] = key + (e & 1) < seq ? s : -INFINITY;
    }
  }
}

template <int DH, bool kQuantPv>
__global__ void __launch_bounds__(kMmaThreads)
attention_s8_kernel(const bf16* __restrict__ qkv, const int8_t* __restrict__ q8,
                    const float* __restrict__ qs, const int8_t* __restrict__ k8,
                    const float* __restrict__ ks, const int8_t* __restrict__ v8,
                    const float* __restrict__ vs, bf16* __restrict__ ctx,
                    int8_t* __restrict__ p8_out, int seq, int heads, float inv_sqrt_dh) {
  constexpr int LD = s8_ld(DH), kK = s8_cols(DH) / 32, kTile = kMmaRows * LD;
  static_assert(DH % 16 == 0, "16-byte code chunks");
  static_assert(attention_s8_smem_bytes<DH, kQuantPv>() >= mma_tiles_bytes<DH>(1),
                "the output stage reuses the tiles");
  extern __shared__ __align__(128) unsigned char s8_smem[];
  int8_t* Qs = reinterpret_cast<int8_t*>(s8_smem);
  int8_t* Ks = Qs + kTile;                                  // 2 stages
  float* ksc = reinterpret_cast<float*>(Ks + 2 * kTile);    // 2 stages of 64
  unsigned char* Vs = reinterpret_cast<unsigned char*>(ksc + 2 * kMmaRows);  // 2 stages

  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * kMmaRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const int d = heads * DH, tp = v8_pitch(seq);
  const long long row0 = (long long)b * seq;
  const int8_t* kb = k8 + row0 * d + h * DH;
  const float* ksb = ks + row0 * heads + h;
  const int8_t* v8b = v8 + ((long long)b * heads + h) * DH * tp;
  const bf16* vb = qkv + row0 * 3 * d + (long long)h * 3 * DH + 2 * DH;
  const int nk = cdiv(seq, kMmaRows), steps = 2 * nk;
  const bool live = q0 + 16 * warp < seq;  // warp-uniform

  if constexpr (s8_cols(DH) > DH) {  // the zero code columns of the Q and K tiles
    for (int r = threadIdx.x; r < 3 * kMmaRows; r += kMmaThreads)
#pragma unroll
      for (int j = DH; j < s8_cols(DH); j += 16)
        *reinterpret_cast<uint4*>(Qs + r * LD + j) = make_uint4(0u, 0u, 0u, 0u);
  }

  // step i < nk (pass 1) reads key tile i; step nk + i (pass 2) key and value
  // tile i, into ring stage i & 1
  auto load = [&](int i) {
    const int s = i & 1, k0 = (i < nk ? i : i - nk) * kMmaRows;
    cp_tile_rows<true, DH>(Ks + s * kTile, LD, kb, d, k0, seq);
    if (threadIdx.x < kMmaRows) {
      const int t = k0 + tile_key(threadIdx.x);
      const bool ok = t < seq;
      cp_async4(ksc + s * kMmaRows + threadIdx.x, ok ? ksb + (long long)t * heads : ksb, ok);
    }
    if (i >= nk) {
      if constexpr (kQuantPv) {
        int8_t* Vt = reinterpret_cast<int8_t*>(Vs) + s * DH * kVtLd;
        for (int j = threadIdx.x; j < DH * 4; j += kMmaThreads) {
          const int n = j >> 2, kc = (j & 3) * 16;
          const bool ok = k0 + kc < tp;
          cp_async16(Vt + n * kVtLd + kc, ok ? v8b + (long long)n * tp + k0 + kc : v8b, ok);
        }
      } else {
        cp_tile_rows<true, 2 * DH>(reinterpret_cast<bf16*>(Vs) + s * kMmaRows * mma_ld(DH),
                                   mma_ld(DH), vb, 3LL * d, k0, seq);
      }
    }
  };
  cp_tile_rows<false, DH>(Qs, LD, q8 + row0 * d + h * DH, d, q0, seq);
  load(0);
  cp_async_commit();

  float qsc[2];  // qs (1/sqrt(dh)) of rows g, g + 8, as the TPU kernel folds it
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = q0 + 16 * warp + g + 8 * r;
    qsc[r] = t < seq ? __fmul_rn(qs[(row0 + t) * heads + h], inv_sqrt_dh) : 0.f;
  }
  uint32_t qf[kK][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, f[2] = {0.f, 0.f};
  typename std::conditional<kQuantPv, int, float>::type o[DH / 8][4];
  zero(o);
  for (int i = 0; i < steps; ++i) {
    if (i + 1 < steps) load(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (i == 0) {
#pragma unroll
      for (int kk = 0; kk < kK; ++kk) ldsm_a_s8(qf[kk], Qs, LD, 16 * warp, 32 * kk);
    }
    if (live) {
      const int s = i & 1, k0 = (i < nk ? i : i - nk) * kMmaRows;
      float sc[8][4];  // rows g, g + 8; the keys of columns 8j + 2c, + 1 (tile_key)
      score_tile_s8<DH>(sc, qf, Ks + s * kTile, ksc + s * kMmaRows, qsc, k0, seq);
      if (i < nk) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float tmax = -INFINITY;
#pragma unroll
          for (int j = 0; j < 8; ++j) tmax = fmaxf(tmax, fmaxf(sc[j][2 * r], sc[j][2 * r + 1]));
          const float mn = fmaxf(m[r], quad_max(tmax));  // finite: every tile has a key
          float ps = 0.f;
#pragma unroll
          for (int j = 0; j < 8; ++j) ps += expf(sc[j][2 * r] - mn) + expf(sc[j][2 * r + 1] - mn);
          l[r] = l[r] * expf(m[r] - mn) + quad_sum(ps);
          m[r] = mn;
        }
        if (i == nk - 1) {
#pragma unroll
          for (int r = 0; r < 2; ++r)
            f[r] = kQuantPv ? __fmul_rn(1.0f / l[r], 1.0f / 127.0f) : 1.0f / l[r];
        }
      } else if constexpr (kQuantPv) {
        const int8_t* Vt = reinterpret_cast<const int8_t*>(Vs) + s * DH * kVtLd;
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {  // keys 32kk .. 32kk + 31 of the tile
          int p[4][4];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              p[jj][e] = (int)rintf(__fmul_rn(expf(sc[4 * kk + jj][e] - m[e >> 1]), 127.f));
          if (p8_out) {
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int tq = q0 + 16 * warp + g + 8 * (e >> 1);
                const int tk = k0 + tile_key(8 * (4 * kk + jj) + 2 * c + (e & 1));
                if (tq < seq && tk < seq)
                  p8_out[(((long long)b * heads + h) * seq + tq) * seq + tk] = (int8_t)p[jj][e];
              }
          }
          const uint32_t pa[4] = {pack_s8(p[0][0], p[0][1], p[1][0], p[1][1]),
                                  pack_s8(p[0][2], p[0][3], p[1][2], p[1][3]),
                                  pack_s8(p[2][0], p[2][1], p[3][0], p[3][1]),
                                  pack_s8(p[2][2], p[2][3], p[3][2], p[3][3])};
#pragma unroll
          for (int jj = 0; jj < DH / 16; ++jj) {
            uint32_t bv[4];
            ldsm_b_s8(bv, Vt, kVtLd, 16 * jj, 32 * kk);
            mma16832_s8(o[2 * jj], pa, bv[0], bv[1]);
            mma16832_s8(o[2 * jj + 1], pa, bv[2], bv[3]);
          }
        }
      } else {
        const bf16* Vt = reinterpret_cast<const bf16*>(Vs) + s * kMmaRows * mma_ld(DH);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {  // p of tile rows 16kk .. 16kk + 15 as an A fragment
#pragma unroll
          for (int jj = 2 * kk; jj < 2 * kk + 2; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[jj][e] = expf(sc[jj][e] - m[e >> 1]) * f[e >> 1];
          uint32_t pa[4];
          acc_to_a(pa, sc[2 * kk], sc[2 * kk + 1]);
          mma_cols<DH>(o, pa, Vt, 16 * kk);
        }
      }
    }
    __syncthreads();  // stage i & 1 consumed before step i + 2 refills it
  }
  if (!live) return;
  bf16* stage = reinterpret_cast<bf16*>(s8_smem) + 16 * warp * mma_ld(DH);
  bf16* out = ctx + row0 * d + h * DH;
  if constexpr (kQuantPv) {
    const float* vsh = vs + ((long long)b * heads + h) * DH;
    float of[DH / 8][4];
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      const float2 v = *reinterpret_cast<const float2*>(vsh + 8 * j + 2 * c);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        of[j][e] = __fmul_rn(__fmul_rn(__int2float_rn(o[j][e]), f[e >> 1]), e & 1 ? v.y : v.x);
    }
    store_rows16<DH>(of, 1.f, stage, out, d, q0 + 16 * warp, seq);
  } else {
    store_rows16<DH>(o, 1.f, stage, out, d, q0 + 16 * warp, seq);
  }
}

template <int DH, bool kQuantPv>
cudaError_t launch_attention_s8(const bf16* qkv, const int8_t* q8, const float* qs,
                                const int8_t* k8, const float* ks, const int8_t* v8,
                                const float* vs, bf16* ctx, int8_t* p8_out, int batch, int seq,
                                int heads, cudaStream_t stream) {
  constexpr size_t smem = attention_s8_smem_bytes<DH, kQuantPv>();
  const float inv_sqrt_dh = (float)(1.0 / sqrt((double)DH));  // as the host computes it
  VT_TRY(cudaFuncSetAttribute(attention_s8_kernel<DH, kQuantPv>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  attention_s8_kernel<DH, kQuantPv><<<dim3(cdiv(seq, kMmaRows), heads, batch), kMmaThreads, smem,
                                      stream>>>(qkv, q8, qs, k8, ks, v8, vs, ctx, p8_out, seq,
                                                heads, inv_sqrt_dh);
  return cudaGetLastError();
}

// stage 3 at one head width: the codes, then the attention
template <int DH>
cudaError_t attention_s8_stage(const bf16* qkv, int8_t* q8, float* qs, int8_t* k8, float* ks,
                               int8_t* v8, float* vs, int8_t* p8_out, bf16* ctx, int batch,
                               int seq, int heads, int quant_pv, cudaStream_t stream) {
  const int rows = batch * seq;
  quant_qk_vec_kernel<DH><<<cdiv(2 * rows * heads, kCodeThreads / qk_group(DH)), kCodeThreads, 0,
                            stream>>>(qkv, q8, qs, k8, ks, rows, heads);
  VT_TRY(cudaGetLastError());
  if (!quant_pv)
    return launch_attention_s8<DH, false>(qkv, q8, qs, k8, ks, nullptr, nullptr, ctx, nullptr,
                                          batch, seq, heads, stream);
  constexpr int kC = DH / 8;
  quant_v_vec_kernel<DH><<<dim3(heads, batch), kC * (kCodeThreads / kC), 0, stream>>>(
      qkv, v8, vs, seq, heads);
  VT_TRY(cudaGetLastError());
  return launch_attention_s8<DH, true>(qkv, q8, qs, k8, ks, v8, vs, ctx, p8_out, batch, seq,
                                       heads, stream);
}

cudaError_t ln_qkv_attn_q8a_mma(const bf16* x, const bf16* ln_scale, const bf16* ln_bias,
                                const int8_t* wq, const float* ws, const bf16* bqkv,
                                int8_t* wqt, int8_t* hq, float* hs, bf16* qkv, int8_t* q8,
                                float* qs, int8_t* k8, float* ks, int8_t* v8, float* vs,
                                int8_t* p8_out, bf16* ctx, int batch, int seq, int d, int heads,
                                int head_dim, int quant_pv, float eps, cudaStream_t stream) {
  if (batch * seq <= 0) return cudaSuccess;
  VT_TRY(ln_qkv_q8_mma(x, ln_scale, ln_bias, wq, ws, bqkv, wqt, hq, hs, qkv, batch * seq, d,
                       3 * heads * head_dim, eps, stream));
  switch (head_dim) {
#define VT_S8_CASE(DH)                                                                      \
  case DH:                                                                                  \
    return attention_s8_stage<DH>(qkv, q8, qs, k8, ks, v8, vs, p8_out, ctx, batch, seq,     \
                                  heads, quant_pv, stream);
    VT_S8_CASE(16)
    VT_S8_CASE(32)
    VT_S8_CASE(64)
    VT_S8_CASE(80)
    VT_S8_CASE(128)
#undef VT_S8_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

// ---- fp32: the first design

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

// `wqt` (d3 x d int8) is bf16's scratch for Wq's K-major copy, and bf16's v8
// is keys-contiguous (B, H, dh, v8_pitch(T)); fp32 takes a null wqt and a
// (B*T, D) v8
extern "C" int vt_ln_qkv_attn_q8a(const void* x, const void* ln_scale, const void* ln_bias,
                                  const void* wq, const void* ws, const void* bqkv, void* wqt,
                                  void* hq, void* hs, void* qkv, void* q8, void* qs, void* k8,
                                  void* ks, void* v8, void* vs, void* p8, void* ctx, int batch,
                                  int seq, int d, int heads, int head_dim, int quant_pv,
                                  float eps, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == vt::kFloat32) {
    typedef float T;
    return (int)vt::ln_qkv_attn_q8a<T>(
        (const T*)x, (const T*)ln_scale, (const T*)ln_bias, (const int8_t*)wq, (const float*)ws,
        (const T*)bqkv, (int8_t*)hq, (float*)hs, (T*)qkv, (int8_t*)q8, (float*)qs, (int8_t*)k8,
        (float*)ks, (int8_t*)v8, (float*)vs, (int8_t*)p8, (T*)ctx, batch, seq, d, heads,
        head_dim, quant_pv, eps, s);
  }
  if (dtype == vt::kBFloat16) {
    typedef vt::bf16 T;
    return (int)vt::ln_qkv_attn_q8a_mma(
        (const T*)x, (const T*)ln_scale, (const T*)ln_bias, (const int8_t*)wq, (const float*)ws,
        (const T*)bqkv, (int8_t*)wqt, (int8_t*)hq, (float*)hs, (T*)qkv, (int8_t*)q8, (float*)qs,
        (int8_t*)k8, (float*)ks, (int8_t*)v8, (float*)vs, (int8_t*)p8, (T*)ctx, batch, seq, d,
        heads, head_dim, quant_pv, eps, s);
  }
  return (int)cudaErrorInvalidValue;
}
