// K6: backward of LN1 -> packed QKV -> attention, joined with the first
// residual's gradient: dx = dres + d(LN1 + QKV + attention)/dx.
// Replaces vit_tpu/ops/pallas/backward.py:ln_qkv_attn_bwd
// (_ln_qkv_attn_bwd_kernel), with or without the packed-QKV stash `qkv`
// (K1's return_qkv: round(LN1(x) W_qkv + b_qkv), read in place of the
// recompute of steps 1-2 below, whose LN1 statistics and h1 dW_qkv and dx
// still need; a host-side branch).  With token merging's
// `log_size` (B, T) fp32 the recomputed scores add it before the row max,
// as the forward did; without the residual join (dres=None) the wrapper
// passes zeros for dres, which adds exactly nothing.
//
// The TPU kernel recomputes one image's LN1, packed QKV and per-head probs
// in VMEM, holds the (T, 3D) dQKV in a VMEM scratch, and accumulates dW_qkv
// and the bias/LN sums across sequential grid steps.  Hopper blocks run in
// no order, so this is a chain of launches over all B*T rows with device
// scratch between them, every reduction over rows its own fixed-order pass
// (no float atomics: two runs give the same bits).
//
// What bounds it on the H100: operations.  B/16 @224 batch 64 (12,608
// rows): three GEMMs of 2 rows D 3D each (the QKV recompute, dh1 = dQKV
// W^T, dW_qkv; 134 GFLOP) and five T^2 dh products per image and head in
// the attention backward (19.1 GFLOP), then ~0.3 GB of row traffic.
//
// bf16 (the main path), on the tensor cores:
//   1. LN1 row statistics; h1 = round(LN1(x)) once into a bf16 (rows, D)
//      scratch (gemm_mma.cuh's launch_ln_rows);
//   2. qkv = round(h1 W_qkv + b_qkv) on gemm_mma.cuh's TMA + wgmma core in
//      the default form (K1's QKV GEMM);
//   3. the attention backward on mma.sync register tiles, reading q, k, v
//      and dctx in place as strided views of the packed (head, {q,k,v},
//      dh) columns, in three launches of one block per (image, head,
//      64-row tile), none writing a (T, T) tile to device memory:
//      - statistics (k6_stats_mma_kernel), queries outer: two passes over
//        the key tiles, the exact row max and sum of s = q_s k^T (+
//        log_size[key]) first (as sdpa_mma.cuh does for K1), written as
//        lse = m + log(l); then delta = sum_k p dp with dp = dctx_h v^T and
//        p = exp(s - lse), the TPU kernel's fp32 jnp.sum(dp * p);
//      - dK/dV, keys outer, and dQ, queries outer: flash_bwd_mma.cuh's
//        bodies (K14's) with the key-bias hook (with log_size) and the fp32
//        flush, which writes each block's own rows of the fp32 dQKV (for
//        db_qkv) and of round(dQKV) (for the GEMMs) beside it.
//      p is exp(s - lse) (__expf), not the TPU's e (1/sum e): lse carries
//      one more fp32 rounding, of log(l), which moves p by at most |lse|
//      2^-24 relative, far below the 2^-8 at which p rounds before dV;
//   4. db_qkv = sum dQKV (fp32, fixed order);
//   5. dh1 = round(dQKV) W_qkv^T in fp32, W_qkv read K-major;
//   6. dx = dres + LN-bwd(dh1), rounded; dgamma = sum dh1 xhat, dbeta =
//      sum dh1;
//   7. dW_qkv = h1^T round(dQKV), h1 read MN-major, the rows split over
//      gridDim.z into fp32 partials summed in split order (launch_wgrad_mma).
//
// fp32 keeps its own chain on gemm.cuh's FMA core (never TF32) and a SIMT
// attention backward (ln_qkv_attn_bwd<float> below):
//   1. LN1 row statistics; qkv = round(LN1(x) @ W_qkv + b) -> scratch
//   2. attention backward, one block per (head, image), looping over
//      64-query tiles.  Per tile it recomputes the softmax statistics (as
//      K1), then Dq = sum_k p dp, then per 64-key tile: s, dp = dctx_h v^T,
//      p = exp(s - m) / l (fp32), ds = p (dp - Dq); dq += ds k in registers;
//      dk = ds^T q_s and dv = p^T dctx_h added into the fp32 dQKV rows of
//      that key tile, which only this block touches — race-free and in a
//      fixed order, whatever T (dK/dV of one head at T = 1024 fp32 is
//      512 KB and would not fit in shared memory).  dq * (1/sqrt(dh)) is
//      written at the end of the query tile.
//   3. db_qkv = sum dqkv (deterministic column sum)
//   4. dh1 = dqkv @ W_qkv^T -> fp32
//   5. dx = dres + LN-bwd(dh1)
//   6. dgamma = sum dh1 * xhat, dbeta = sum dh1
//   7. dW_qkv = h1^T dqkv, h1 = LN1(x), recomputed on load
#include "attention.cuh"
#include "common.cuh"
#include "epilogue.cuh"
#include "flash_bwd_mma.cuh"
#include "gemm.cuh"
#include "gemm_mma.cuh"

namespace vt {

template <int DH>
constexpr size_t attention_bwd_smem_bytes() {
  // Qs, Gs, Ks, Vs [64][DH+1]; Ps, Ss [64][65]; all fp32
  return sizeof(float) * (4 * kAtQ * (DH + 1) + 2 * kAtQ * (kAtK + 1));
}

// one block's work; kBias adds log_size[b, key] to the recomputed scores
template <typename T, int DH, bool kBias>
__device__ __forceinline__ void attention_bwd_block(const T* __restrict__ qkv,
                                                    const T* __restrict__ dctx,
                                                    const float* __restrict__ log_size,
                                                    float* __restrict__ dqkv, int seq, int heads,
                                                    float inv_sqrt_dh) {
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
  const float* bias = kBias ? log_size + (size_t)b * seq : nullptr;
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
    softmax_stats<T, DH, kBias>(base, ld, seq, Qs, Ks, tid, tx, ty, m, l, bias);
#pragma unroll
    for (int i = 0; i < 4; ++i) inv[i] = 1.0f / l[i];

    // Dq = sum_k p dp over all keys (fp32 p, as the TPU kernel's rowsum)
    float s[4][4], dp[4][4], dsum[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < seq; k0 += kAtK) {
      __syncthreads();
      load_kv(k0);
      __syncthreads();
      score_tile<DH>(Qs, Ks, tx, ty, s);
      if constexpr (kBias) add_key_bias(bias, k0, seq, tx, s);
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
      if constexpr (kBias) add_key_bias(bias, k0, seq, tx, s);
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
__global__ void __launch_bounds__(kAtThreads)
attention_bwd_kernel(const T* __restrict__ qkv, const T* __restrict__ dctx,
                     float* __restrict__ dqkv, int seq, int heads, float inv_sqrt_dh) {
  attention_bwd_block<T, DH, false>(qkv, dctx, nullptr, dqkv, seq, heads, inv_sqrt_dh);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kAtThreads)
attention_bwd_bias_kernel(const T* __restrict__ qkv, const T* __restrict__ dctx,
                          const float* __restrict__ log_size, float* __restrict__ dqkv, int seq,
                          int heads, float inv_sqrt_dh) {
  attention_bwd_block<T, DH, true>(qkv, dctx, log_size, dqkv, seq, heads, inv_sqrt_dh);
}

template <typename T, int DH>
cudaError_t launch_attention_bwd(const T* qkv, const T* dctx, const float* log_size, float* dqkv,
                                 int batch, int seq, int heads, cudaStream_t stream) {
  constexpr size_t smem = attention_bwd_smem_bytes<DH>();
  const float inv_sqrt_dh = (float)(1.0 / sqrt((double)DH));  // as the host computes it
  const dim3 grid(heads, batch);
  if (log_size) {
    VT_TRY(cudaFuncSetAttribute(attention_bwd_bias_kernel<T, DH>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
    attention_bwd_bias_kernel<T, DH><<<grid, kAtThreads, smem, stream>>>(
        qkv, dctx, log_size, dqkv, seq, heads, inv_sqrt_dh);
    return cudaGetLastError();
  }
  VT_TRY(cudaFuncSetAttribute(attention_bwd_kernel<T, DH>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  attention_bwd_kernel<T, DH><<<grid, kAtThreads, smem, stream>>>(qkv, dctx, dqkv, seq, heads,
                                                                  inv_sqrt_dh);
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
                            const T* ln_bias, const T* wqkv, const T* bqkv,
                            const float* log_size, const T* qkv_stash, T* dx, float* dgamma,
                            float* dbeta, float* dwqkv, float* dbqkv, void* workspace, int batch,
                            int seq, int d, int heads, int head_dim, float eps,
                            cudaStream_t stream) {
  const int rows = batch * seq, d3 = 3 * heads * head_dim;
  Arena arena{(char*)workspace};
  const K6Scratch<T> s = k6_scratch<T>(arena, rows, d, d3);
  const T* const qkv = qkv_stash ? qkv_stash : s.qkv;

  VT_TRY(launch_row_stats(x, s.mean, s.rstd, rows, d, eps, stream));
  if (!qkv_stash)
    VT_TRY(launch_gemm<T>(LoadLn<T, T>{x, d, s.mean, s.rstd, ln_scale, ln_bias},
                          Load<T>{wqkv, d3}, rows, d3, d, BiasEpi<T, T>{bqkv, s.qkv, d3},
                          stream));
  VT_TRY(cudaMemsetAsync(s.dqkv, 0, sizeof(float) * (size_t)rows * d3, stream));
#define VT_K6_ATTN(DH) \
  VT_TRY((launch_attention_bwd<T, DH>(qkv, dctx, log_size, s.dqkv, batch, seq, heads, stream)))
  switch (head_dim) {
    case 16: VT_K6_ATTN(16); break;
    case 32: VT_K6_ATTN(32); break;
    case 64: VT_K6_ATTN(64); break;
    case 80: VT_K6_ATTN(80); break;
    case 128: VT_K6_ATTN(128); break;
    default: return cudaErrorInvalidValue;
  }
#undef VT_K6_ATTN
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

// ---- bf16: the chain on the TMA + wgmma core, the attention backward on
// mma.sync register tiles

// lse and delta of query tile blockIdx.x of (image, head) = (blockIdx.z,
// blockIdx.y), rows (b H + h) T + t, those below T only.  4 warps of 16
// query rows hold q_s and dO as A fragments; K (pass 1) and K and V (pass
// 2) stream through a 2-stage cp.async ring.  Keys past T score -inf, so
// they add nothing to l or delta; key 0 is in the first chunk, so the
// running max is finite from then on.  Chunks wholly past T are skipped.
template <int DH, bool kBias>
__global__ void __launch_bounds__(kMmaThreads)
k6_stats_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ bias, float* __restrict__ lse,
                    float* __restrict__ delta, BwdArgs a) {
  constexpr int LD = mma_ld(DH), kTile = kMmaRows * LD, kD = DH / 16, kCh = bwd_chunk<DH>();
  extern __shared__ __align__(128) unsigned char mma_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(mma_smem);  // [64][LD] q_s
  bf16* Ds = Qs + kTile;                          // [64][LD] dO
  bf16* Ks = Ds + kTile;                          // 2 stages
  bf16* Vs = Ks + 2 * kTile;                      // 2 stages

  const int q0 = blockIdx.x * kMmaRows, h = blockIdx.y, b = blockIdx.z, seq = a.seq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const long long base = a.sin.at(b, h), row_base = ((long long)b * a.heads + h) * seq;
  const bf16 *kb = k + base, *vb = v + base;
  const float* bb = kBias ? bias + (long long)b * seq : nullptr;
  const int nk = cdiv(seq, kMmaRows), steps = 2 * nk, row0 = q0 + 16 * warp;
  const bool live = row0 < seq;  // warp-uniform

  // step i < nk (pass 1) reads key tile i; step nk + i (pass 2) key and
  // value tile i, into ring stage i & 1
  auto load = [&](int i) {
    const int k0 = (i < nk ? i : i - nk) * kMmaRows;
    cp_rows<DH>(Ks + (i & 1) * kTile, kb, a.sin.t, k0, seq);
    if (i >= nk) cp_rows<DH>(Vs + (i & 1) * kTile, vb, a.sin.t, k0, seq);
  };
  cp_rows<DH>(Qs, q + base, a.sin.t, q0, seq);
  cp_rows<DH>(Ds, dout + a.sdo.at(b, h), a.sdo.t, q0, seq);
  load(0);
  cp_async_commit();

  uint32_t qf[kD][4], df[kD][4];
  // rows g and g + 8: running max and sum, then lse, and delta's partial
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, ls[2] = {0.f, 0.f};
  float dsum[2] = {0.f, 0.f};
  for (int i = 0; i < steps; ++i) {
    if (i + 1 < steps) load(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    if (i == 0) scale_own_rows<DH>(Qs, round_to<bf16>(a.inv_sqrt_dh));
    __syncthreads();
    if (i == 0) {
#pragma unroll
      for (int kk = 0; kk < kD; ++kk) {
        ldsm_a(qf[kk], Qs, LD, 16 * warp, 16 * kk);
        ldsm_a(df[kk], Ds, LD, 16 * warp, 16 * kk);
      }
    }
    if (live) {
      const bool pass1 = i < nk;
      const int k0 = (pass1 ? i : i - nk) * kMmaRows;
      const bf16 *Kt = Ks + (i & 1) * kTile, *Vt = Vs + (i & 1) * kTile;
#pragma unroll 1
      for (int n0 = 0; n0 < kMmaRows && k0 + n0 < seq; n0 += kCh) {
        // rows: the warp's queries g, g + 8; columns: keys n0 + 8j + 2c, + 1
        float s[kCh / 8][4];
        zero(s);
        mma_rows<DH, kCh / 8>(s, qf, Kt, n0);  // S = q_s K^T
#pragma unroll
        for (int j = 0; j < kCh / 8; ++j) {
          const int key = k0 + n0 + 8 * j + 2 * c;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kx = key + (e & 1);
            float sc = s[j][e];
            if constexpr (kBias) sc += kx < seq ? bb[kx] : 0.f;
            s[j][e] = kx < seq ? sc : -INFINITY;
          }
        }
        if (pass1) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float tmax = -INFINITY;
#pragma unroll
            for (int j = 0; j < kCh / 8; ++j)
              tmax = fmaxf(tmax, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
            const float mn = fmaxf(m[r], quad_max(tmax));
            float ps = 0.f;
#pragma unroll
            for (int j = 0; j < kCh / 8; ++j)
              ps += __expf(s[j][2 * r] - mn) + __expf(s[j][2 * r + 1] - mn);
            l[r] = l[r] * __expf(m[r] - mn) + quad_sum(ps);
            m[r] = mn;
          }
        } else {
          float dp[kCh / 8][4];
          zero(dp);
          mma_rows<DH, kCh / 8>(dp, df, Vt, n0);  // dP = dO V^T
#pragma unroll
          for (int j = 0; j < kCh / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) dsum[e >> 1] += __expf(s[j][e] - ls[e >> 1]) * dp[j][e];
        }
      }
      if (i == nk - 1) {
        ls[0] = m[0] + logf(l[0]);
        ls[1] = m[1] + logf(l[1]);
      }
    }
    __syncthreads();  // stage i & 1 consumed before step i + 2 refills it
  }
  if (live) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float de = quad_sum(dsum[r]);
      const int t = row0 + g + 8 * r;
      if (c == 0 && t < seq) {
        lse[row_base + t] = ls[r];
        delta[row_base + t] = de;
      }
    }
  }
}

// q, k, v, dctx and the two dQKV scratches as flash_bwd_mma.cuh's bodies
// take them: the packed columns of head h start at 3 h dh, and each block
// flushes the rows of its own tile into both dQKV copies
template <int DH, bool kBias>
__global__ void __launch_bounds__(kMmaThreads, dkv_min_blocks<DH>())
k6_dkv_mma_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dctx,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  const float* __restrict__ bias, float* __restrict__ dqkv,
                  bf16* __restrict__ dqkv_c, BwdArgs a) {
  flash_bwd_dkv_mma_body<DH, kBias, true>(qkv, qkv + DH, qkv + 2 * DH, dctx, lse, delta,
                                          dqkv_c + DH, dqkv_c + 2 * DH, a, bias, dqkv + DH,
                                          dqkv + 2 * DH);
}

template <int DH, bool kBias>
__global__ void __launch_bounds__(kMmaThreads)
k6_dq_mma_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dctx,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 const float* __restrict__ bias, float* __restrict__ dqkv,
                 bf16* __restrict__ dqkv_c, BwdArgs a) {
  flash_bwd_dq_mma_body<DH, kBias, true>(qkv, qkv + DH, qkv + 2 * DH, dctx, lse, delta, dqkv_c,
                                         a, bias, dqkv);
}

template <int DH, bool kBias>
cudaError_t k6_attention_bwd_mma(const bf16* qkv, const bf16* dctx, const float* log_size,
                                 float* lse, float* delta, float* dqkv, bf16* dqkv_c, int batch,
                                 int seq, int heads, cudaStream_t stream) {
  const long long ld = 3LL * heads * DH, gld = (long long)heads * DH;
  const BwdArgs a{{seq * ld, 3 * DH, ld}, {seq * gld, DH, gld}, {seq * ld, 3 * DH, ld}, seq,
                  heads, (float)(1.0 / sqrt((double)DH))};  // as the host computes it
  constexpr size_t smem_stats = mma_tiles_bytes<DH>(6), smem_dkv = dkv_mma_smem_bytes<DH>(),
                   smem_dq = dq_mma_smem_bytes<DH>();
  VT_TRY(cudaFuncSetAttribute(k6_stats_mma_kernel<DH, kBias>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_stats));
  VT_TRY(cudaFuncSetAttribute(k6_dkv_mma_kernel<DH, kBias>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dkv));
  VT_TRY(cudaFuncSetAttribute(k6_dq_mma_kernel<DH, kBias>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dq));
  const dim3 grid(cdiv(seq, kMmaRows), heads, batch);
  k6_stats_mma_kernel<DH, kBias><<<grid, kMmaThreads, smem_stats, stream>>>(
      qkv, qkv + DH, qkv + 2 * DH, dctx, log_size, lse, delta, a);
  VT_TRY(cudaGetLastError());
  k6_dkv_mma_kernel<DH, kBias><<<grid, kMmaThreads, smem_dkv, stream>>>(qkv, dctx, lse, delta,
                                                                       log_size, dqkv, dqkv_c, a);
  VT_TRY(cudaGetLastError());
  k6_dq_mma_kernel<DH, kBias><<<grid, kMmaThreads, smem_dq, stream>>>(qkv, dctx, lse, delta,
                                                                     log_size, dqkv, dqkv_c, a);
  return cudaGetLastError();
}

template <int DH>
cudaError_t k6_attention_bwd_mma_any(const bf16* qkv, const bf16* dctx, const float* log_size,
                                     float* lse, float* delta, float* dqkv, bf16* dqkv_c,
                                     int batch, int seq, int heads, cudaStream_t stream) {
  return log_size ? k6_attention_bwd_mma<DH, true>(qkv, dctx, log_size, lse, delta, dqkv, dqkv_c,
                                                   batch, seq, heads, stream)
                  : k6_attention_bwd_mma<DH, false>(qkv, dctx, nullptr, lse, delta, dqkv,
                                                    dqkv_c, batch, seq, heads, stream);
}

struct K6MmaScratch {
  float *mean, *rstd, *lse, *delta, *dqkv, *dh1, *cpart, *wpart;
  bf16 *h1, *qkv, *dqkv_c;
};

// every piece on a 256-byte boundary (Arena), the bf16 rows D and 3D wide
inline K6MmaScratch k6_mma_scratch(Arena& a, int batch, int seq, int d, int heads, int d3) {
  const int rows = batch * seq;
  K6MmaScratch s;
  s.mean = a.take<float>(rows);
  s.rstd = a.take<float>(rows);
  s.lse = a.take<float>((size_t)rows * heads);
  s.delta = a.take<float>((size_t)rows * heads);
  s.h1 = a.take<bf16>((size_t)rows * d);
  s.qkv = a.take<bf16>((size_t)rows * d3);
  s.dqkv = a.take<float>((size_t)rows * d3);
  s.dqkv_c = a.take<bf16>((size_t)rows * d3);
  s.dh1 = a.take<float>((size_t)rows * d);
  s.cpart = a.take<float>(colsum_partial_floats(rows, std::max(d3, d)));
  s.wpart = a.take<float>(mma_partial_floats(d, d3, rows));
  return s;
}

cudaError_t ln_qkv_attn_bwd_mma(const bf16* dctx, const bf16* dres, const bf16* x,
                                const bf16* ln_scale, const bf16* ln_bias, const bf16* wqkv,
                                const bf16* bqkv, const float* log_size, const bf16* qkv_stash,
                                bf16* dx, float* dgamma, float* dbeta, float* dwqkv,
                                float* dbqkv, void* workspace, int batch, int seq, int d,
                                int heads, int head_dim, float eps, cudaStream_t stream) {
  const int rows = batch * seq, d3 = 3 * heads * head_dim;
  Arena arena{(char*)workspace};
  const K6MmaScratch s = k6_mma_scratch(arena, batch, seq, d, heads, d3);
  const bf16* const qkv = qkv_stash ? qkv_stash : s.qkv;

  VT_TRY(launch_row_stats(x, s.mean, s.rstd, rows, d, eps, stream));
  VT_TRY(launch_ln_rows(x, ln_scale, ln_bias, s.h1, rows, d, eps, stream));
  if (!qkv_stash)
    VT_TRY(launch_gemm_mma(s.h1, d, wqkv, d3, rows, d3, d, BiasEpi<bf16, bf16>{bqkv, s.qkv, d3},
                           stream));
#define VT_K6_ATTN(DH)                                                                       \
  VT_TRY(k6_attention_bwd_mma_any<DH>(qkv, dctx, log_size, s.lse, s.delta, s.dqkv, s.dqkv_c, \
                                      batch, seq, heads, stream))
  switch (head_dim) {
    case 16: VT_K6_ATTN(16); break;
    case 32: VT_K6_ATTN(32); break;
    case 64: VT_K6_ATTN(64); break;
    case 80: VT_K6_ATTN(80); break;
    case 128: VT_K6_ATTN(128); break;
    default: return cudaErrorInvalidValue;
  }
#undef VT_K6_ATTN
  VT_TRY(launch_colsum(ColOf<float>{s.dqkv, d3}, rows, d3, s.cpart, dbqkv, stream));
  VT_TRY((launch_gemm_mma<false, true>(s.dqkv_c, d3, wqkv, d3, rows, d, d3,
                                       StoreEpi<float>{s.dh1, d}, stream)));
  VT_TRY(launch_ln_bwd_rows<bf16>(s.dh1, x, s.mean, s.rstd, ln_scale, dres, dx, nullptr, rows, d,
                                  stream));
  VT_TRY(launch_colsum(ColLnScaleGrad<bf16>{s.dh1, x, s.mean, s.rstd, d}, rows, d, s.cpart,
                       dgamma, stream));
  VT_TRY(launch_colsum(ColOf<float>{s.dh1, d}, rows, d, s.cpart, dbeta, stream));
  return launch_wgrad_mma<true>(s.h1, d, s.dqkv_c, d3, d, d3, rows, dwqkv, s.wpart, stream);
}

}  // namespace vt

extern "C" {

size_t vt_ln_qkv_attn_bwd_workspace(int batch, int seq, int d, int heads, int head_dim,
                                    int dtype) {
  vt::Arena a{nullptr};
  const int rows = batch * seq, d3 = 3 * heads * head_dim;
  if (dtype == vt::kBFloat16)
    vt::k6_mma_scratch(a, batch, seq, d, heads, d3);
  else
    vt::k6_scratch<float>(a, rows, d, d3);
  return a.off;
}

int vt_ln_qkv_attn_bwd(const void* dctx, const void* dres, const void* x, const void* ln_scale,
                       const void* ln_bias, const void* wqkv, const void* bqkv,
                       const void* log_size, const void* qkv, void* dx,
                       void* dgamma, void* dbeta, void* dwqkv, void* dbqkv, void* workspace,
                       int batch, int seq, int d, int heads, int head_dim, float eps, int dtype,
                       int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == vt::kFloat32) {
    typedef float T;
    return (int)vt::ln_qkv_attn_bwd<T>(
        (const T*)dctx, (const T*)dres, (const T*)x, (const T*)ln_scale, (const T*)ln_bias,
        (const T*)wqkv, (const T*)bqkv, (const float*)log_size, (const T*)qkv, (T*)dx, (float*)dgamma,
        (float*)dbeta, (float*)dwqkv, (float*)dbqkv, workspace, batch, seq, d, heads, head_dim,
        eps, s);
  }
  if (dtype == vt::kBFloat16) {
    typedef vt::bf16 T;
    return (int)vt::ln_qkv_attn_bwd_mma(
        (const T*)dctx, (const T*)dres, (const T*)x, (const T*)ln_scale, (const T*)ln_bias,
        (const T*)wqkv, (const T*)bqkv, (const float*)log_size, (const T*)qkv, (T*)dx, (float*)dgamma,
        (float*)dbeta, (float*)dwqkv, (float*)dbqkv, workspace, batch, seq, d, heads, head_dim,
        eps, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
