// Tile machinery shared by the blockwise flash-attention forward (K13,
// flash_attention.cu) and backward (K14, flash_attention_bwd.cu).
//
// Every block works on 64-row tiles held in shared memory: operands in the
// working dtype T (q scaled, k, v, dO, rounded probabilities), and fp32
// scratch for the score-shaped products.  A TileAcc is one block's fp32
// accumulator of a 64 x N product, fed from shared-memory tiles:
//  - bf16: tensor cores through WMMA (16x16x16, fp32 accumulators); warp w
//    owns the 16 x 16 tiles w, w + 8, ... of the output;
//  - fp32: CUDA-core FMA (never TF32, as the TPU kernel pins HIGHEST);
//    thread (ty, tx) = (tid / 16, tid % 16) owns rows ty + 16 i (i < 4)
//    and columns tx + 16 j (j < N / 16).
// Elementwise work reads the accumulators through for_each, which hands
// each element to a functor with its (row, col) — through a per-warp
// 16 x 16 fp32 scratch for the WMMA fragments, whose register layout the
// API leaves unspecified.
#pragma once

#include "attention.cuh"
#include "common.cuh"

#include <mma.h>

#include <type_traits>

namespace vt {

constexpr int kFl = 64;          // query and key rows per tile
constexpr int kFlThreads = 256;  // 8 warps
constexpr int kFlWarps = kFlThreads / 32;

// element strides of a (batch, head, token, head_dim) view whose last axis
// is contiguous: the packed (B*T, 3D) QKV, the (B*T, D) context, or a
// contiguous (B, H, T, dh) tensor
struct View4 {
  long long b, h, t;
  __device__ __forceinline__ long long at(int bi, int hi) const {
    return (long long)bi * b + (long long)hi * h;
  }
};

template <typename T>
struct FlTile {
  static constexpr bool kBf16 = std::is_same<T, bf16>::value;
  // pitch of a T tile with C columns: bf16 pads 8 (16 B: WMMA needs
  // multiples of 8 and 32-byte aligned fragments, and rows shift banks),
  // fp32 pads 1 (the SIMT reads of a transposed tile hit 32 banks)
  __host__ __device__ static constexpr int ld(int c) { return kBf16 ? c + 8 : c + 1; }
  // pitch of an fp32 scratch tile: WMMA stores need multiples of 4
  __host__ __device__ static constexpr int ldf(int c) { return kBf16 ? c + 4 : c + 1; }
};

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

template <typename T, int N, bool kWmma = FlTile<T>::kBf16>
struct TileAcc;

// fp32: CUDA-core FMA, the SIMT layout above
template <typename T, int N>
struct TileAcc<T, N, false> {
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
  __device__ __forceinline__ void for_each(float* /*warp scratch*/, F f) const {
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kJ; ++j) f(ty + 16 * i, tx + 16 * j, v[i][j]);
  }

  // row r times s[r]
  __device__ __forceinline__ void scale_rows(const float* s, float* /*warp scratch*/) {
    const int ty = threadIdx.x >> 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float f = s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kJ; ++j) v[i][j] *= f;
    }
  }
};

// bf16: WMMA fragments; warp w owns output tiles w + 8 f
template <typename T, int N>
struct TileAcc<T, N, true> {
  static constexpr int kCols = N / 16;
  static constexpr int kTiles = 4 * kCols;
  static constexpr int kF = (kTiles + kFlWarps - 1) / kFlWarps;
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> f[kF];

  __device__ __forceinline__ static int tile(int i) { return (threadIdx.x >> 5) + kFlWarps * i; }

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < kF; ++i) nvcuda::wmma::fill_fragment(f[i], 0.f);
  }

  template <int K, bool kTA, bool kTB>
  __device__ __forceinline__ void mma(const T* A, int lda, const T* B, int ldb) {
    using namespace nvcuda;
    using LA = typename std::conditional<kTA, wmma::col_major, wmma::row_major>::type;
    using LB = typename std::conditional<kTB, wmma::col_major, wmma::row_major>::type;
#pragma unroll
    for (int i = 0; i < kF; ++i) {
      const int t = tile(i);
      if (t >= kTiles) break;  // head_dim 16: half the warps own no tile
      const int r0 = (t / kCols) * 16, c0 = (t % kCols) * 16;
#pragma unroll
      for (int k0 = 0; k0 < K; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LA> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> b;
        wmma::load_matrix_sync(a, kTA ? A + k0 * lda + r0 : A + r0 * lda + k0, lda);
        wmma::load_matrix_sync(b, kTB ? B + c0 * ldb + k0 : B + k0 * ldb + c0, ldb);
        wmma::mma_sync(f[i], a, b, f[i]);
      }
    }
  }

  // each fragment through the warp's 16 x 16 scratch, element by element
  template <class F>
  __device__ __forceinline__ void for_each(float* scratch, F fn) const {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int i = 0; i < kF; ++i) {
      const int t = tile(i);
      if (t >= kTiles) break;
      const int r0 = (t / kCols) * 16, c0 = (t % kCols) * 16;
      nvcuda::wmma::store_matrix_sync(scratch, f[i], 16, nvcuda::wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) fn(r0 + e / 16, c0 + e % 16, scratch[e]);
      __syncwarp();
    }
  }

  __device__ __forceinline__ void scale_rows(const float* s, float* scratch) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int i = 0; i < kF; ++i) {
      const int t = tile(i);
      if (t >= kTiles) break;
      const int r0 = (t / kCols) * 16;
      nvcuda::wmma::store_matrix_sync(scratch, f[i], 16, nvcuda::wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) scratch[e] *= s[r0 + e / 16];
      __syncwarp();
      nvcuda::wmma::load_matrix_sync(f[i], scratch, 16, nvcuda::wmma::mem_row_major);
      __syncwarp();
    }
  }
};

// out[r][c] = acc(r, c) into a [64][ld] fp32 shared tile (caller syncs)
template <class Acc>
__device__ __forceinline__ void store_tile(const Acc& acc, float* out, int ld, float* scratch) {
  acc.for_each(scratch, [&](int r, int c, float v) { out[r * ld + c] = v; });
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
