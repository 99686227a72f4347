// Tile machinery of the fp32 blockwise flash-attention forward (K13,
// flash_attention.cu) and backward (K14, flash_attention_bwd.cu).  bf16
// runs on mma_bf16.cuh's register tiles instead.
//
// Every block works on 64-row tiles held in shared memory: operands (q
// scaled, k, v, dO, probabilities) and fp32 scratch for the score-shaped
// products.  A TileAcc is one block's fp32 accumulator of a 64 x N product,
// fed from shared-memory tiles by CUDA-core FMA (never TF32, as the TPU
// kernel pins HIGHEST): thread (ty, tx) = (tid / 16, tid % 16) owns rows
// ty + 16 i (i < 4) and columns tx + 16 j (j < N / 16).  Elementwise work
// reads the accumulators through for_each, which hands each element to a
// functor with its (row, col).
#pragma once

#include "attention.cuh"
#include "common.cuh"

namespace vt {

constexpr int kFl = 64;          // query and key rows per tile
constexpr int kFlThreads = 256;  // 8 warps

// pitch of a tile with c columns: one pad column, so the SIMT reads of a
// transposed tile hit 32 banks
__host__ __device__ constexpr int fl_ld(int c) { return c + 1; }

// Shared memory carved in 128-byte aligned pieces; the same code sizes it
// on the host (base == nullptr).
struct SmemCarve {
  unsigned char* base;
  size_t off = 0;
  template <typename X>
  __host__ __device__ X* take(size_t n) {
    off = (off + 127) & ~(size_t)127;
    X* p = base ? (X*)(base + off) : nullptr;
    off += n * sizeof(X);
    return p;
  }
};

template <typename T, int N>
struct TileAcc {
  static constexpr int kJ = N / 16;
  float v[4][kJ];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kJ; ++j) v[i][j] = 0.f;
  }

  // acc += A (64 x K) B (K x N) from shared memory: A(i, k) is A[i * lda +
  // k], or A[k * lda + i] with kTA; B(k, n) is B[k * ldb + n], or B[n * ldb
  // + k] with kTB
  template <int K, bool kTA, bool kTB>
  __device__ __forceinline__ void mma(const T* A, int lda, const T* B, int ldb) {
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      float av[4], bv[kJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        av[i] = to_f(kTA ? A[k * lda + r] : A[r * lda + k]);
      }
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const int c = tx + 16 * j;
        bv[j] = to_f(kTB ? B[c * ldb + k] : B[k * ldb + c]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kJ; ++j) v[i][j] = fmaf(av[i], bv[j], v[i][j]);
    }
  }

  // f(row, col, value) for every element this thread owns
  template <class F>
  __device__ __forceinline__ void for_each(F f) const {
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kJ; ++j) f(ty + 16 * i, tx + 16 * j, v[i][j]);
  }

  // row r times s[r]
  __device__ __forceinline__ void scale_rows(const float* s) {
    const int ty = threadIdx.x >> 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float f = s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kJ; ++j) v[i][j] *= f;
    }
  }
};

// out[r][c] = acc(r, c) into a [64][ld] fp32 shared tile (caller syncs)
template <class Acc>
__device__ __forceinline__ void store_tile(const Acc& acc, float* out, int ld) {
  acc.for_each([&](int r, int c, float v) { out[r * ld + c] = v; });
}

// tile[r][c] = x(row0 + r, c) of a (token, dh) slab with row pitch `st`,
// times `scale` and rounded to T when kScale; rows at or past `seq` load 0
template <typename T, int DH, bool kScale = false>
__device__ __forceinline__ void load_rows(const T* __restrict__ x, long long st, int row0,
                                          int seq, T* tile, int ld, float scale = 1.f) {
  for (int i = threadIdx.x; i < kFl * DH; i += kFlThreads) {
    const int r = i / DH, c = i % DH, t = row0 + r;
    T v = from_f<T>(0.f);
    if (t < seq) {
      v = x[(long long)t * st + c];
      if constexpr (kScale) v = from_f<T>(to_f(v) * scale);
    }
    tile[r * ld + c] = v;
  }
}

template <typename Kernel>
inline cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace vt
