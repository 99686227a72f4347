// Tile helpers shared by the attention forward (K1) and backward (K6):
// 64 x 64 score tiles from two fp32 shared-memory row tiles, and
// half-warp reductions over a query row.
#pragma once

#include "common.cuh"

namespace vt {

constexpr int kAtQ = 64, kAtK = 64, kAtThreads = 256;

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

// Running row max m and sum of exp(s - m) over all `seq` keys for the
// query rows held in Qs (pass 1 of K1, and K6's recompute): key tiles of
// the packed (head, {q,k,v}, dh) columns at `base` (pitch ld) stream
// through Ks; keys past seq are excluded.
template <typename T, int DH>
__device__ __forceinline__ void softmax_stats(const T* __restrict__ base, int ld, int seq,
                                              const float* Qs, float* Ks, int tid, int tx,
                                              int ty, float m[4], float l[4]) {
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
      Ks[r * (DH + 1) + c] = t < seq ? to_f(base[(size_t)t * ld + DH + c]) : 0.f;
    }
    __syncthreads();
    score_tile<DH>(Qs, Ks, tx, ty, s);
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

}  // namespace vt
