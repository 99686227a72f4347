// The bf16 attention body on mma.sync register tiles (mma_bf16.cuh),
// shared by K21's sdpa_mma_kernel (scaled_dot_product_attention.cu) and
// qkv_attention_mma_kernel (qkv_attention_mma.cuh, the attention stage of
// K1 and the bf16 K15): softmax(q kᵀ / sqrt(dh) [+ log s]) v over four
// strided (batch, head, token, dh) views, with the
// TPU kernels' rounding points -- q * round(1/sqrt(dh)) rounded to bf16,
// fp32 scores and the exact row max over all T keys (pass 1), p = exp(s -
// m) * (1/sum) rounded to bf16 before p @ v (pass 2), fp32 accumulation,
// output rounded once.
//
// 4 warps, 16 query rows each; q_s is loaded once by cp.async and held as
// A fragments; K (and in pass 2 V) tiles stream through a 2-stage cp.async
// ring; the row max and sum stay in registers (quad shuffles); p is formed
// in registers and repacked straight into the A fragments of p @ v, with V
// read by ldmatrix.trans; the context leaves in 16-byte stores.  Keys past
// T score -inf; every 64-key tile holds a key, so the running max is
// finite after the first tile, with the log-size bias (finite) too.
//
// kBias is a template flag: token merging's proportional attention (K1's
// hook, fused_block.py:183-184) adds the image's log-size row to the fp32
// scores before the row max; K21's instance has it off and compiles no
// bias code.
#pragma once

#include "attention.cuh"
#include "common.cuh"
#include "mma_bf16.cuh"

namespace vt {

// one block's work: the 64 query rows of tile blockIdx.x of (image, head)
// = (blockIdx.z, blockIdx.y); kBias adds the image's fp32 log-size row
// bias[b * seq ..] to the key logits before the row max
template <int DH, bool kBias>
__device__ __forceinline__ void sdpa_mma_tile(const bf16* __restrict__ q, View4 sq,
                                              const bf16* __restrict__ k, View4 sk,
                                              const bf16* __restrict__ v, View4 sv,
                                              bf16* __restrict__ out, View4 so,
                                              const float* __restrict__ bias, int seq,
                                              float inv_sqrt_dh) {
  constexpr int LD = mma_ld(DH), kTile = kMmaRows * LD, kD = DH / 16;
  extern __shared__ __align__(128) unsigned char mma_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(mma_smem);  // [64][LD], then the output stage
  bf16* Ks = Qs + kTile;                          // 2 stages
  bf16* Vs = Ks + 2 * kTile;                      // 2 stages

  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * kMmaRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, c = lane & 3;
  const bf16 *kb = k + sk.at(b, h), *vb = v + sv.at(b, h);
  const int nk = cdiv(seq, kMmaRows), steps = 2 * nk;
  const bool live = q0 + 16 * warp < seq;  // warp-uniform

  // step i < nk (pass 1) reads key tile i; step nk + i (pass 2) key and
  // value tile i, into ring stage i & 1
  auto load = [&](int i) {
    const int k0 = (i < nk ? i : i - nk) * kMmaRows;
    cp_rows<DH>(Ks + (i & 1) * kTile, kb, sk.t, k0, seq);
    if (i >= nk) cp_rows<DH>(Vs + (i & 1) * kTile, vb, sv.t, k0, seq);
  };
  cp_rows<DH>(Qs, q + sq.at(b, h), sq.t, q0, seq);
  load(0);
  cp_async_commit();

  uint32_t qf[kD][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, inv[2] = {0.f, 0.f};
  float o[DH / 8][4];
  zero(o);
  for (int i = 0; i < steps; ++i) {
    if (i + 1 < steps) load(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    if (i == 0) scale_own_rows<DH>(Qs, round_to<bf16>(inv_sqrt_dh));
    __syncthreads();
    if (i == 0) {
#pragma unroll
      for (int kk = 0; kk < kD; ++kk) ldsm_a(qf[kk], Qs, LD, 16 * warp, 16 * kk);
    }
    if (live) {
      const int k0 = (i < nk ? i : i - nk) * kMmaRows;
      float s[8][4];  // 16 rows x 64 keys: rows g, g + 8; keys 8j + 2c, + 1
      zero(s);
      mma_rows<DH, 8>(s, qf, Ks + (i & 1) * kTile, 0);
      if constexpr (kBias) {
        const float* bb = bias + (long long)b * seq;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int key = k0 + 8 * j + 2 * c;
          const float b0 = key < seq ? bb[key] : 0.f, b1 = key + 1 < seq ? bb[key + 1] : 0.f;
          s[j][0] += b0;
          s[j][2] += b0;
          s[j][1] += b1;
          s[j][3] += b1;
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int key = k0 + 8 * j + 2 * c;
        if (key >= seq) s[j][0] = s[j][2] = -INFINITY;
        if (key + 1 >= seq) s[j][1] = s[j][3] = -INFINITY;
      }
      if (i < nk) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {  // rows g and g + 8
          float tmax = -INFINITY;
#pragma unroll
          for (int j = 0; j < 8; ++j) tmax = fmaxf(tmax, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
          const float mn = fmaxf(m[r], quad_max(tmax));  // finite: every tile has a key
          float ps = 0.f;
#pragma unroll
          for (int j = 0; j < 8; ++j)
            ps += __expf(s[j][2 * r] - mn) + __expf(s[j][2 * r + 1] - mn);
          l[r] = l[r] * __expf(m[r] - mn) + quad_sum(ps);
          m[r] = mn;
        }
        if (i == nk - 1) {
          inv[0] = 1.0f / l[0];
          inv[1] = 1.0f / l[1];
        }
      } else {
        const bf16* Vt = Vs + (i & 1) * kTile;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {  // p of keys 16kk .. 16kk + 15 as an A fragment
#pragma unroll
          for (int jj = 2 * kk; jj < 2 * kk + 2; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[jj][e] = __expf(s[jj][e] - m[e >> 1]) * inv[e >> 1];
          uint32_t pa[4];
          acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
          mma_cols<DH>(o, pa, Vt, 16 * kk);
        }
      }
    }
    __syncthreads();  // stage i & 1 consumed before step i + 2 refills it
  }
  if (live) store_rows16<DH>(o, 1.f, Qs + 16 * warp * LD, out + so.at(b, h), so.t, q0 + 16 * warp,
                             seq);
}

}  // namespace vt
