// The bf16 bodies of the blockwise attention backward on mma.sync register
// tiles (mma_bf16.cuh), shared by K14's kernels (flash_attention_bwd.cu)
// and K6's attention backward (ln_qkv_attn_bwd.cu):
//   dK/dV: one block per (image, head, 64-key tile), streaming 64-query
//          tiles: dV += round(p)^T dO, dK += round(dS)^T q_s;
//   dQ:    one block per (image, head, 64-query tile), streaming 64-key
//          tiles: dQ += round(dS) K, times 1/sqrt(dh) once at the flush.
// Both recompute per tile S = q_s K^T and dP = dO V^T, then p = exp(S -
// lse) and dS = p (dP - delta) in fp32 from the unrounded p, with lse and
// delta per query row made before them (K14: by K13 and the caller; K6: by
// its statistics kernel).  Every block owns its accumulators and sums them
// in a fixed order: no atomics, two runs give the same bits.  Query rows
// past T load zeros and take lse = delta = 0, keys past T load zeros, and p
// is 0 wherever the row or the key is past T, so a padded row's value
// never reaches an accumulator.  The rounding points are the TPU kernels':
// q_s = round(q round(1/sqrt(dh))), round(p) and round(dS) before their
// products.
//
// The dK/dV warp holds its 16 keys' K and V as A fragments and computes the
// transposed tiles S^T = K q_s^T and dP^T = V dO^T, so p^T and dS^T come
// out of the accumulators in the A-fragment layout of dV += round(p^T) dO
// and dK += round(dS^T) q_s (dO and q_s read by ldmatrix.trans); the
// tile's lse and delta are read per column from shared memory.  The dQ warp
// holds its 16 queries' q_s and dO as A fragments; S and dP stay in
// registers, and dS is repacked as the A operand of dQ += round(dS) K.
// Neither p nor dS passes through shared memory.  exp is the MUFU's (__expf,
// 2 ulp near 0; p rounds to bf16 at 2^-8 before dV).
//
// Two template hooks, both off in K14's instances (which then compile to
// the machine code they had as kernels of their own):
//  - kBias: token merging's per-key bias (K6's `log_size`, fp32 (B, T)) is
//    added to the fp32 scores before p, as the forward added it before the
//    row max;
//  - kF32: the flush writes the fp32 gradient rows too (K6: the fp32 dQKV
//    that db_qkv sums) beside the rounded bf16 ones (round(dQKV), which K6's
//    next two GEMMs read).
#pragma once

#include "attention.cuh"
#include "common.cuh"
#include "mma_bf16.cuh"

namespace vt {

// q, k, v share one view (`sin`), dO has `sdo`, the gradients `sgrad`
struct BwdArgs {
  View4 sin, sdo, sgrad;
  int seq, heads;
  float inv_sqrt_dh;
};

// score-shaped columns per inner step: 32 (16 at dh 128, to stay in registers)
template <int DH>
__host__ __device__ constexpr int bwd_chunk() { return DH >= 128 ? 16 : 32; }

// blocks per SM the dK/dV kernel is compiled for: 3 at dh <= 64 (168
// registers, no spills; 2 blocks with the compiler's own 201 measured 5%
// slower), else the compiler's choice
template <int DH>
__host__ __device__ constexpr int dkv_min_blocks() { return DH <= 64 ? 3 : 1; }

// dynamic shared memory of the two bodies
template <int DH>
constexpr size_t dkv_mma_smem_bytes() {
  return mma_tiles_bytes<DH>(6) + 4 * kMmaRows * sizeof(float);
}
template <int DH>
constexpr size_t dq_mma_smem_bytes() { return mma_tiles_bytes<DH>(6); }

// A warp's 16 x DH fp32 accumulator times `scale`, in fp32, to rows row0 ..
// row0+15 (those below `seq`) of a (token, dh) slab with pitch `st`: each
// quad writes 32 contiguous bytes of a row per n8 tile
template <int DH>
__device__ __forceinline__ void store_rows16_f32(const float (&acc)[DH / 8][4], float scale,
                                                 float* __restrict__ out, long long st, int row0,
                                                 int seq) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const bool ok0 = row0 + g < seq, ok1 = row0 + g + 8 < seq;
  float* r0 = out + (long long)(row0 + g) * st + 2 * c;
  float* r1 = r0 + 8 * st;
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    if (ok0)
      *reinterpret_cast<float2*>(r0 + 8 * j) = make_float2(acc[j][0] * scale, acc[j][1] * scale);
    if (ok1)
      *reinterpret_cast<float2*>(r1 + 8 * j) = make_float2(acc[j][2] * scale, acc[j][3] * scale);
  }
}

// dK/dV of key tile blockIdx.x of (image, head) = (blockIdx.z, blockIdx.y);
// with kBias `bias` is the (B, T) key bias, with kF32 dk32/dv32 take the
// fp32 rows at the bf16 outputs' offsets (view sgrad)
template <int DH, bool kBias, bool kF32>
__device__ __forceinline__ void flash_bwd_dkv_mma_body(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, BwdArgs a, const float* __restrict__ bias,
    float* __restrict__ dk32, float* __restrict__ dv32) {
  constexpr int LD = mma_ld(DH), kTile = kMmaRows * LD, kD = DH / 16, kCh = bwd_chunk<DH>();
  extern __shared__ __align__(128) unsigned char mma_smem[];
  bf16* Ks = reinterpret_cast<bf16*>(mma_smem);  // [64][LD]
  bf16* Vs = Ks + kTile;                          // [64][LD]
  bf16* Qs = Vs + kTile;                          // 2 stages of q_s
  bf16* Ds = Qs + 2 * kTile;                      // 2 stages of dO
  float* Ls = reinterpret_cast<float*>(Ds + 2 * kTile);  // 2 stages of lse
  float* Es = Ls + 2 * kMmaRows;                         // 2 stages of delta

  const int k0 = blockIdx.x * kMmaRows, h = blockIdx.y, b = blockIdx.z, seq = a.seq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const long long base = a.sin.at(b, h), row_base = ((long long)b * a.heads + h) * seq;
  const bf16 *qb = q + base, *dob = dout + a.sdo.at(b, h);
  const int nq = cdiv(seq, kMmaRows), key0 = k0 + 16 * warp;
  const bool live = key0 < seq;  // warp-uniform
  const bool key_ok[2] = {key0 + g < seq, key0 + g + 8 < seq};
  float kbias[2] = {0.f, 0.f};  // rows g, g + 8: the warp's keys
  if constexpr (kBias) {
    const float* bb = bias + (long long)b * seq;
    kbias[0] = key_ok[0] ? bb[key0 + g] : 0.f;
    kbias[1] = key_ok[1] ? bb[key0 + g + 8] : 0.f;
  }

  auto load = [&](int i) {  // query tile i into ring stage i & 1
    const int q0 = i * kMmaRows, st = i & 1;
    cp_rows<DH>(Qs + st * kTile, qb, a.sin.t, q0, seq);
    cp_rows<DH>(Ds + st * kTile, dob, a.sdo.t, q0, seq);
    if (threadIdx.x < kMmaRows) {
      const int r = threadIdx.x;
      const bool ok = q0 + r < seq;
      const long long at = row_base + (ok ? q0 + r : 0);
      cp_async4(Ls + st * kMmaRows + r, lse + at, ok);
      cp_async4(Es + st * kMmaRows + r, delta + at, ok);
    }
  };
  cp_rows<DH>(Ks, k + base, a.sin.t, k0, seq);
  cp_rows<DH>(Vs, v + base, a.sin.t, k0, seq);
  load(0);
  cp_async_commit();

  uint32_t kf[kD][4], vf[kD][4];
  float dka[DH / 8][4], dva[DH / 8][4];
  zero(dka);
  zero(dva);
  const float scale = round_to<bf16>(a.inv_sqrt_dh);
  for (int i = 0; i < nq; ++i) {
    if (i + 1 < nq) load(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    scale_own_rows<DH>(Qs + (i & 1) * kTile, scale);
    __syncthreads();
    if (i == 0) {
#pragma unroll
      for (int kk = 0; kk < kD; ++kk) {
        ldsm_a(kf[kk], Ks, LD, 16 * warp, 16 * kk);
        ldsm_a(vf[kk], Vs, LD, 16 * warp, 16 * kk);
      }
    }
    if (live) {
      const bf16 *Qt = Qs + (i & 1) * kTile, *Dt = Ds + (i & 1) * kTile;
      const float *lt = Ls + (i & 1) * kMmaRows, *et = Es + (i & 1) * kMmaRows;
      const int q0 = i * kMmaRows;
#pragma unroll 1  // rolled: fewer live registers, and measured faster
      for (int n0 = 0; n0 < kMmaRows; n0 += kCh) {
        // rows: the warp's keys g, g + 8; columns: queries n0 + 8j + 2c, + 1
        float s[kCh / 8][4], dp[kCh / 8][4];
        zero(s);
        zero(dp);
        mma_rows<DH, kCh / 8>(s, kf, Qt, n0);   // S^T = K q_s^T
        mma_rows<DH, kCh / 8>(dp, vf, Dt, n0);  // dP^T = V dO^T
#pragma unroll
        for (int j = 0; j < kCh / 8; ++j) {
          const int col = n0 + 8 * j + 2 * c;
          const float2 ls = *reinterpret_cast<const float2*>(lt + col);
          const float2 de = *reinterpret_cast<const float2*>(et + col);
          const bool q_ok[2] = {q0 + col < seq, q0 + col + 1 < seq};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool ok = key_ok[e >> 1] && q_ok[e & 1];
            float p;  // each form as written: K14's compiles to its own machine code
            if constexpr (kBias)
              p = ok ? __expf(s[j][e] + kbias[e >> 1] - ((e & 1) ? ls.y : ls.x)) : 0.f;
            else
              p = ok ? __expf(s[j][e] - ((e & 1) ? ls.y : ls.x)) : 0.f;
            dp[j][e] = p * (dp[j][e] - ((e & 1) ? de.y : de.x));  // dS^T from the unrounded p
            s[j][e] = p;
          }
        }
#pragma unroll
        for (int kk = 0; kk < kCh / 16; ++kk) {
          uint32_t pa[4], da[4];
          acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
          acc_to_a(da, dp[2 * kk], dp[2 * kk + 1]);
          mma_cols<DH>(dva, pa, Dt, n0 + 16 * kk);  // dV += round(p^T) dO
          mma_cols<DH>(dka, da, Qt, n0 + 16 * kk);  // dK += round(dS^T) q_s
        }
      }
    }
    __syncthreads();  // stage i & 1 consumed before query tile i + 2 refills it
  }
  if (live) {
    const long long gbase = a.sgrad.at(b, h);
    store_rows16<DH>(dka, 1.f, Qs + 16 * warp * LD, dk + gbase, a.sgrad.t, key0, seq);
    store_rows16<DH>(dva, 1.f, Ds + 16 * warp * LD, dv + gbase, a.sgrad.t, key0, seq);
    if constexpr (kF32) {
      store_rows16_f32<DH>(dka, 1.f, dk32 + gbase, a.sgrad.t, key0, seq);
      store_rows16_f32<DH>(dva, 1.f, dv32 + gbase, a.sgrad.t, key0, seq);
    }
  }
}

// dQ of query tile blockIdx.x of (image, head) = (blockIdx.z, blockIdx.y);
// the hooks as in flash_bwd_dkv_mma_body
template <int DH, bool kBias, bool kF32>
__device__ __forceinline__ void flash_bwd_dq_mma_body(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, BwdArgs a, const float* __restrict__ bias, float* __restrict__ dq32) {
  constexpr int LD = mma_ld(DH), kTile = kMmaRows * LD, kD = DH / 16, kCh = bwd_chunk<DH>();
  extern __shared__ __align__(128) unsigned char mma_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(mma_smem);  // [64][LD] q_s, then the output stage
  bf16* Ds = Qs + kTile;                          // [64][LD] dO
  bf16* Ks = Ds + kTile;                          // 2 stages
  bf16* Vs = Ks + 2 * kTile;                      // 2 stages

  const int q0 = blockIdx.x * kMmaRows, h = blockIdx.y, b = blockIdx.z, seq = a.seq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const long long base = a.sin.at(b, h), row_base = ((long long)b * a.heads + h) * seq;
  const bf16 *kb = k + base, *vb = v + base;
  const int nk = cdiv(seq, kMmaRows), row0 = q0 + 16 * warp;
  const bool live = row0 < seq;  // warp-uniform
  const float* bb = kBias ? bias + (long long)b * seq : nullptr;

  auto load = [&](int i) {  // key tile i into ring stage i & 1
    cp_rows<DH>(Ks + (i & 1) * kTile, kb, a.sin.t, i * kMmaRows, seq);
    cp_rows<DH>(Vs + (i & 1) * kTile, vb, a.sin.t, i * kMmaRows, seq);
  };
  cp_rows<DH>(Qs, q + base, a.sin.t, q0, seq);
  cp_rows<DH>(Ds, dout + a.sdo.at(b, h), a.sdo.t, q0, seq);
  load(0);
  cp_async_commit();

  // rows g and g + 8 of the warp: lse = delta = 0 past T
  bool row_ok[2];
  float lr[2], er[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = row0 + g + 8 * r;
    row_ok[r] = t < seq;
    lr[r] = row_ok[r] ? lse[row_base + t] : 0.f;
    er[r] = row_ok[r] ? delta[row_base + t] : 0.f;
  }
  uint32_t qf[kD][4], df[kD][4];
  float dqa[DH / 8][4];
  zero(dqa);
  for (int i = 0; i < nk; ++i) {
    if (i + 1 < nk) load(i + 1);
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
      const bf16 *Kt = Ks + (i & 1) * kTile, *Vt = Vs + (i & 1) * kTile;
      const int k0 = i * kMmaRows;
#pragma unroll 1  // rolled: fewer live registers, and measured faster
      for (int n0 = 0; n0 < kMmaRows; n0 += kCh) {
        // rows: the warp's queries g, g + 8; columns: keys n0 + 8j + 2c, + 1
        float s[kCh / 8][4], dp[kCh / 8][4];
        zero(s);
        zero(dp);
        mma_rows<DH, kCh / 8>(s, qf, Kt, n0);   // S = q_s K^T
        mma_rows<DH, kCh / 8>(dp, df, Vt, n0);  // dP = dO V^T
#pragma unroll
        for (int j = 0; j < kCh / 8; ++j) {
          const int key = k0 + n0 + 8 * j + 2 * c;
          const bool k_ok[2] = {key < seq, key + 1 < seq};
          float kbias[2] = {0.f, 0.f};
          if constexpr (kBias) {
            kbias[0] = k_ok[0] ? bb[key] : 0.f;
            kbias[1] = k_ok[1] ? bb[key + 1] : 0.f;
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool ok = row_ok[e >> 1] && k_ok[e & 1];
            float p;
            if constexpr (kBias)
              p = ok ? __expf(s[j][e] + kbias[e & 1] - lr[e >> 1]) : 0.f;
            else
              p = ok ? __expf(s[j][e] - lr[e >> 1]) : 0.f;
            dp[j][e] = p * (dp[j][e] - er[e >> 1]);
          }
        }
#pragma unroll
        for (int kk = 0; kk < kCh / 16; ++kk) {
          uint32_t da[4];
          acc_to_a(da, dp[2 * kk], dp[2 * kk + 1]);
          mma_cols<DH>(dqa, da, Kt, n0 + 16 * kk);  // dQ += round(dS) K
        }
      }
    }
    __syncthreads();  // stage i & 1 consumed before key tile i + 2 refills it
  }
  if (live) {
    store_rows16<DH>(dqa, a.inv_sqrt_dh, Qs + 16 * warp * LD, dq + a.sgrad.at(b, h), a.sgrad.t,
                     row0, seq);
    if constexpr (kF32)
      store_rows16_f32<DH>(dqa, a.inv_sqrt_dh, dq32 + a.sgrad.at(b, h), a.sgrad.t, row0, seq);
  }
}

}  // namespace vt
