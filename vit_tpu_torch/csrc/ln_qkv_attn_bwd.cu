// K6: backward of LN1 -> packed QKV -> attention, joined with the first
// residual's gradient: dx = dres + d(LN1 + QKV + attention)/dx.
// Replaces vit_tpu/ops/pallas/backward.py:ln_qkv_attn_bwd
// (_ln_qkv_attn_bwd_kernel, with dres and without the qkv stash or the
// ToMe log-size bias).
//
// The TPU kernel recomputes one image's LN1, packed QKV and per-head probs
// in VMEM, holds the (T, 3D) dQKV in a VMEM scratch, and accumulates dW_qkv
// and the bias/LN sums across sequential grid steps.  Here:
//   1. LN1 row statistics; qkv = round(LN1(x) @ W_qkv + b) -> dtype scratch
//   2. attention backward, one block per (head, image), looping over
//      64-query tiles.  Per tile it recomputes the softmax statistics (as
//      K1), then Dq = sum_k p dp, then per 64-key tile: s, dp = dctx_h v^T,
//      p = exp(s - m) / l (fp32), ds = p (dp - Dq); p and ds rounded to the
//      dtype into shared memory; dq += round(ds) k in registers; dk =
//      round(ds)^T q_s and dv = round(p)^T dctx_h added into the fp32 dQKV
//      rows of that key tile, which only this block touches — race-free and
//      in a fixed order, whatever T (dK/dV of one head at T = 1024 fp32 is
//      512 KB and would not fit in shared memory).  dq * (1/sqrt(dh)) is
//      written at the end of the query tile.  q_s = round(q round(scale)).
//   3. db_qkv = sum dqkv (deterministic column sum)
//   4. dh1 = round(dqkv) @ W_qkv^T -> fp32
//   5. dx = dres + LN-bwd(dh1), rounded
//   6. dgamma = sum dh1 * xhat, dbeta = sum dh1
//   7. dW_qkv = h1^T round(dqkv), h1 = LN1(x) rounded, recomputed on load
#include "attention.cuh"
#include "common.cuh"
#include "epilogue.cuh"
#include "gemm.cuh"

namespace vt {

template <int DH>
constexpr size_t attention_bwd_smem_bytes() {
  // Qs, Gs, Ks, Vs [64][DH+1]; Ps, Ss [64][65]; all fp32
  return sizeof(float) * (4 * kAtQ * (DH + 1) + 2 * kAtQ * (kAtK + 1));
}

template <typename T, int DH>
__global__ void __launch_bounds__(kAtThreads)
attention_bwd_kernel(const T* __restrict__ qkv, const T* __restrict__ dctx,
                     float* __restrict__ dqkv, int seq, int heads, float inv_sqrt_dh) {
  extern __shared__ float smem[];
  constexpr int P = DH + 1, PS = kAtK + 1;
  float* Qs = smem;           // q_s of the query tile
  float* Gs = Qs + kAtQ * P;  // dctx_h of the query tile
  float* Ks = Gs + kAtQ * P;
  float* Vs = Ks + kAtK * P;
  float* Ps = Vs + kAtK * P;  // round(p)  [query][key]
  float* Ss = Ps + kAtQ * PS; // round(ds) [query][key]

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int ld = 3 * heads * DH, gld = heads * DH;
  const T* base = qkv + (size_t)b * seq * ld + (size_t)h * 3 * DH;
  const T* gbase = dctx + (size_t)b * seq * gld + (size_t)h * DH;
  float* dbase = dqkv + (size_t)b * seq * ld + (size_t)h * 3 * DH;
  const float scale = round_to<T>(inv_sqrt_dh);
  constexpr int kDj = DH / 16;  // columns per thread: tx + 16j

  auto load_kv = [&](int k0) {
    for (int i = tid; i < kAtK * DH; i += kAtThreads) {
      const int r = i / DH, c = i % DH, t = k0 + r;
      const bool ok = t < seq;
      Ks[r * P + c] = ok ? to_f(base[(size_t)t * ld + DH + c]) : 0.f;
      Vs[r * P + c] = ok ? to_f(base[(size_t)t * ld + 2 * DH + c]) : 0.f;
    }
  };

  for (int q0 = 0; q0 < seq; q0 += kAtQ) {
    __syncthreads();  // the previous query tile's Qs/Gs consumed
    for (int i = tid; i < kAtQ * DH; i += kAtThreads) {
      const int r = i / DH, c = i % DH, t = q0 + r;
      const bool ok = t < seq;
      Qs[r * P + c] = ok ? round_to<T>(to_f(base[(size_t)t * ld + c]) * scale) : 0.f;
      Gs[r * P + c] = ok ? to_f(gbase[(size_t)t * gld + c]) : 0.f;
    }
    float m[4], l[4], inv[4];
    softmax_stats<T, DH>(base, ld, seq, Qs, Ks, tid, tx, ty, m, l);
#pragma unroll
    for (int i = 0; i < 4; ++i) inv[i] = 1.0f / l[i];

    // Dq = sum_k p dp over all keys (fp32 p, as the TPU kernel's rowsum)
    float s[4][4], dp[4][4], dsum[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < seq; k0 += kAtK) {
      __syncthreads();
      load_kv(k0);
      __syncthreads();
      score_tile<DH>(Qs, Ks, tx, ty, s);
      score_tile<DH>(Gs, Vs, tx, ty, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (k0 + tx + 16 * j < seq) dsum[i] += expf(s[i][j] - m[i]) * inv[i] * dp[i][j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) dsum[i] = half_warp_sum(dsum[i]);

    float dq[4][kDj];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kDj; ++j) dq[i][j] = 0.f;
    for (int k0 = 0; k0 < seq; k0 += kAtK) {
      __syncthreads();
      load_kv(k0);
      __syncthreads();
      score_tile<DH>(Qs, Ks, tx, ty, s);
      score_tile<DH>(Gs, Vs, tx, ty, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool ok = q0 + ty + 16 * i < seq && k0 + tx + 16 * j < seq;
          const float p = expf(s[i][j] - m[i]) * inv[i];
          const int e = (ty + 16 * i) * PS + tx + 16 * j;
          Ps[e] = ok ? round_to<T>(p) : 0.f;
          Ss[e] = ok ? round_to<T>(p * (dp[i][j] - dsum[i])) : 0.f;
        }
      __syncthreads();
      // dq[query][c] += sum_key round(ds) k
#pragma unroll 4
      for (int kk = 0; kk < kAtK; ++kk) {
        float sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) sv[i] = Ss[(ty + 16 * i) * PS + kk];
#pragma unroll
        for (int j = 0; j < kDj; ++j) {
          const float kv = Ks[kk * P + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) dq[i][j] = fmaf(sv[i], kv, dq[i][j]);
        }
      }
      // keys ty + 16i: dk = sum_query round(ds) q_s, dv = sum_query round(p) dctx_h
      float dk[4][kDj], dv[4][kDj];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kDj; ++j) dk[i][j] = dv[i][j] = 0.f;
#pragma unroll 4
      for (int qq = 0; qq < kAtQ; ++qq) {
        float sv[4], pv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          sv[i] = Ss[qq * PS + ty + 16 * i];
          pv[i] = Ps[qq * PS + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < kDj; ++j) {
          const float qv = Qs[qq * P + tx + 16 * j], gv = Gs[qq * P + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dk[i][j] = fmaf(sv[i], qv, dk[i][j]);
            dv[i][j] = fmaf(pv[i], gv, dv[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = k0 + ty + 16 * i;
        if (t >= seq) continue;
        float* row = dbase + (size_t)t * ld;
#pragma unroll
        for (int j = 0; j < kDj; ++j) {
          row[DH + tx + 16 * j] += dk[i][j];
          row[2 * DH + tx + 16 * j] += dv[i][j];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = q0 + ty + 16 * i;
      if (t >= seq) continue;
#pragma unroll
      for (int j = 0; j < kDj; ++j) dbase[(size_t)t * ld + tx + 16 * j] = dq[i][j] * inv_sqrt_dh;
    }
  }
}

template <typename T, int DH>
cudaError_t launch_attention_bwd(const T* qkv, const T* dctx, float* dqkv, int batch, int seq,
                                 int heads, cudaStream_t stream) {
  constexpr size_t smem = attention_bwd_smem_bytes<DH>();
  VT_TRY(cudaFuncSetAttribute(attention_bwd_kernel<T, DH>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  const float inv_sqrt_dh = (float)(1.0 / sqrt((double)DH));  // as the host computes it
  attention_bwd_kernel<T, DH><<<dim3(heads, batch), kAtThreads, smem, stream>>>(
      qkv, dctx, dqkv, seq, heads, inv_sqrt_dh);
  return cudaGetLastError();
}

template <typename T>
struct K6Scratch {
  float *mean, *rstd, *dqkv, *dh1, *cpart, *wpart;
  T* qkv;
};

template <typename T>
K6Scratch<T> k6_scratch(Arena& a, int rows, int d, int d3) {
  K6Scratch<T> s;
  s.mean = a.take<float>(rows);
  s.rstd = a.take<float>(rows);
  s.qkv = a.take<T>((size_t)rows * d3);
  s.dqkv = a.take<float>((size_t)rows * d3);
  s.dh1 = a.take<float>((size_t)rows * d);
  s.cpart = a.take<float>(colsum_partial_floats(rows, std::max(d3, d)));
  s.wpart = a.take<float>(wgrad_partial_floats<T>(d, d3, rows));
  return s;
}

template <typename T>
cudaError_t ln_qkv_attn_bwd(const T* dctx, const T* dres, const T* x, const T* ln_scale,
                            const T* ln_bias, const T* wqkv, const T* bqkv, T* dx, float* dgamma,
                            float* dbeta, float* dwqkv, float* dbqkv, void* workspace, int batch,
                            int seq, int d, int heads, int head_dim, float eps,
                            cudaStream_t stream) {
  const int rows = batch * seq, d3 = 3 * heads * head_dim;
  Arena arena{(char*)workspace};
  const K6Scratch<T> s = k6_scratch<T>(arena, rows, d, d3);

  VT_TRY(launch_row_stats(x, s.mean, s.rstd, rows, d, eps, stream));
  VT_TRY(launch_gemm<T>(LoadLn<T, T>{x, d, s.mean, s.rstd, ln_scale, ln_bias},
                        Load<T>{wqkv, d3}, rows, d3, d, BiasEpi<T, T>{bqkv, s.qkv, d3}, stream));
  VT_TRY(cudaMemsetAsync(s.dqkv, 0, sizeof(float) * (size_t)rows * d3, stream));
  switch (head_dim) {
    case 16: VT_TRY((launch_attention_bwd<T, 16>(s.qkv, dctx, s.dqkv, batch, seq, heads, stream))); break;
    case 32: VT_TRY((launch_attention_bwd<T, 32>(s.qkv, dctx, s.dqkv, batch, seq, heads, stream))); break;
    case 64: VT_TRY((launch_attention_bwd<T, 64>(s.qkv, dctx, s.dqkv, batch, seq, heads, stream))); break;
    case 128: VT_TRY((launch_attention_bwd<T, 128>(s.qkv, dctx, s.dqkv, batch, seq, heads, stream))); break;
    default: return cudaErrorInvalidValue;
  }
  VT_TRY(launch_colsum(ColOf<float>{s.dqkv, d3}, rows, d3, s.cpart, dbqkv, stream));
  VT_TRY(launch_gemm<T>(Load<T, float>{s.dqkv, d3}, Load<T, T, true>{wqkv, d3}, rows, d, d3,
                        StoreEpi<float>{s.dh1, d}, stream));
  VT_TRY(launch_ln_bwd_rows<T>(s.dh1, x, s.mean, s.rstd, ln_scale, dres, dx, nullptr, rows, d,
                               stream));
  VT_TRY(launch_colsum(ColLnScaleGrad<T>{s.dh1, x, s.mean, s.rstd, d}, rows, d, s.cpart, dgamma,
                       stream));
  VT_TRY(launch_colsum(ColOf<float>{s.dh1, d}, rows, d, s.cpart, dbeta, stream));
  VT_TRY(launch_wgrad<T>(LoadLn<T, T, true>{x, d, s.mean, s.rstd, ln_scale, ln_bias},
                         Load<T, float>{s.dqkv, d3}, d, d3, rows, dwqkv, s.wpart, stream));
  return cudaSuccess;
}

}  // namespace vt

extern "C" {

size_t vt_ln_qkv_attn_bwd_workspace(int batch, int seq, int d, int heads, int head_dim,
                                    int dtype) {
  vt::Arena a{nullptr};
  const int rows = batch * seq, d3 = 3 * heads * head_dim;
  if (dtype == vt::kBFloat16)
    vt::k6_scratch<vt::bf16>(a, rows, d, d3);
  else
    vt::k6_scratch<float>(a, rows, d, d3);
  return a.off;
}

int vt_ln_qkv_attn_bwd(const void* dctx, const void* dres, const void* x, const void* ln_scale,
                       const void* ln_bias, const void* wqkv, const void* bqkv, void* dx,
                       void* dgamma, void* dbeta, void* dwqkv, void* dbqkv, void* workspace,
                       int batch, int seq, int d, int heads, int head_dim, float eps, int dtype,
                       int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
#define VT_K6(T)                                                                              \
  vt::ln_qkv_attn_bwd<T>((const T*)dctx, (const T*)dres, (const T*)x, (const T*)ln_scale,     \
                         (const T*)ln_bias, (const T*)wqkv, (const T*)bqkv, (T*)dx,           \
                         (float*)dgamma, (float*)dbeta, (float*)dwqkv, (float*)dbqkv,         \
                         workspace, batch, seq, d, heads, head_dim, eps, s)
  if (dtype == vt::kFloat32) return (int)VT_K6(float);
  if (dtype == vt::kBFloat16) return (int)VT_K6(vt::bf16);
#undef VT_K6
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
