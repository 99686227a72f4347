// Tiled GEMM core shared by K1 and K2: C = A @ W with A (M, K) produced
// element by element by an A-loader (plain, or with LayerNorm applied on
// the fly), W (K, N) row-major [in, out], fp32 accumulation, and an
// epilogue functor that receives each fp32 accumulator with its (row, col).
//
//  - bf16: tensor cores through WMMA (16x16x16, fp32 accumulators); block
//    tile 128 x 128 x 32, 8 warps each owning a 64 x 32 slab.
//  - fp32: CUDA-core fp32 FMA (never TF32); block tile 64 x 64 x 16,
//    256 threads each owning 4 x 4 outputs.
//
// Tiles are single-buffered and loaded through registers, where the
// A-loader applies its transform; rows, columns and depth past the matrix
// load zeros, and the epilogue is skipped there.  cp.async/TMA pipelining
// and wgmma are later work.
#pragma once

#include "common.cuh"

#include <mma.h>

#include <type_traits>

namespace vt {

// ---- A-operand loaders: element (r, k) of A, already in the GEMM's dtype T.

template <typename T>
struct LoadA {
  const T* x;
  int ld;
  __device__ __forceinline__ T operator()(int r, int k) const { return x[(size_t)r * ld + k]; }
};

// LayerNorm applied on load: ((x - mean) * rstd * scale + bias) in fp32,
// rounded to T — the TPU kernels' `_ln(...).astype(dtype)`.
template <typename TIn, typename T>
struct LoadLnA {
  const TIn* x;
  int ld;
  const float* mean;
  const float* rstd;
  const T* scale;
  const T* bias;
  __device__ __forceinline__ T operator()(int r, int k) const {
    const float c = to_f(x[(size_t)r * ld + k]) - mean[r];
    return from_f<T>(c * rstd[r] * to_f(scale[k]) + to_f(bias[k]));
  }
};

// ---- bf16 tensor-core GEMM.

constexpr int kTcBM = 128, kTcBN = 128, kTcBK = 32, kTcThreads = 256;
// Row pitches padded by 8 elements (16 B): every 16-row fragment offset
// stays 32-byte aligned as WMMA requires, and rows shift across banks.
constexpr int kTcLdA = kTcBK + 8;  // 40 bf16 = 80 B
constexpr int kTcLdB = kTcBN + 8;  // 136 bf16 = 272 B

template <class ALoad, class Epi>
__global__ void __launch_bounds__(kTcThreads)
gemm_bf16_kernel(ALoad a, const bf16* __restrict__ w, int M, int N, int K, Epi epi) {
  using namespace nvcuda;
  __shared__ __align__(128) bf16 As[kTcBM * kTcLdA];
  __shared__ __align__(128) bf16 Bs[kTcBK * kTcLdB];
  __shared__ __align__(128) float Cs[kTcThreads / 32][16 * 16];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2;  // 0..1: 64-row slab
  const int wn = warp & 3;   // 0..3: 32-column slab
  const int row0 = blockIdx.y * kTcBM, col0 = blockIdx.x * kTcBN;
  const bf16 zero = __float2bfloat16(0.f);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += kTcBK) {
    for (int i = tid; i < kTcBM * kTcBK; i += kTcThreads) {
      const int r = i / kTcBK, c = i % kTcBK;
      const int gr = row0 + r, gk = k0 + c;
      As[r * kTcLdA + c] = (gr < M && gk < K) ? a(gr, gk) : zero;
    }
    for (int i = tid; i < kTcBK * kTcBN; i += kTcThreads) {
      const int r = i / kTcBN, c = i % kTcBN;
      const int gk = k0 + r, gc = col0 + c;
      Bs[r * kTcLdB + c] = (gk < K && gc < N) ? w[(size_t)gk * N + gc] : zero;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTcBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm * 64 + i * 16) * kTcLdA + kk, kTcLdA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Bs + kk * kTcLdB + wn * 32 + j * 16, kTcLdB);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: each warp spills one 16x16 accumulator at a time to its own
  // shared scratch, then applies the functor element by element
  float* cs = Cs[warp];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = row0 + wm * 64 + i * 16 + e / 16;
        const int c = col0 + wn * 32 + j * 16 + e % 16;
        if (r < M && c < N) epi(r, c, cs[e]);
      }
      __syncwarp();
    }
  }
}

// ---- fp32 CUDA-core GEMM.

constexpr int kFpBM = 64, kFpBN = 64, kFpBK = 16, kFpThreads = 256;

template <class ALoad, class Epi>
__global__ void __launch_bounds__(kFpThreads)
gemm_f32_kernel(ALoad a, const float* __restrict__ w, int M, int N, int K, Epi epi) {
  __shared__ float As[kFpBK][kFpBM + 4];  // k-major: a thread's 4 rows per k
  __shared__ float Bs[kFpBK][kFpBN];

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * kFpBM, col0 = blockIdx.x * kFpBN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kFpBK) {
    for (int i = tid; i < kFpBM * kFpBK; i += kFpThreads) {
      const int r = i / kFpBK, c = i % kFpBK;
      const int gr = row0 + r, gk = k0 + c;
      As[c][r] = (gr < M && gk < K) ? a(gr, gk) : 0.f;
    }
    for (int i = tid; i < kFpBK * kFpBN; i += kFpThreads) {
      const int r = i / kFpBN, c = i % kFpBN;
      const int gk = k0 + r, gc = col0 + c;
      Bs[r][c] = (gk < K && gc < N) ? w[(size_t)gk * N + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFpBK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = row0 + ty + 16 * i, c = col0 + tx + 16 * j;
      if (r < M && c < N) epi(r, c, acc[i][j]);
    }
}

// C = A @ W over (M, K) x (K, N) on `stream`, for T = float or bf16.
template <typename T, class ALoad, class Epi>
inline cudaError_t launch_gemm(ALoad a, const T* w, int M, int N, int K, Epi epi,
                               cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value) {
    dim3 grid(cdiv(N, kFpBN), cdiv(M, kFpBM));
    gemm_f32_kernel<<<grid, kFpThreads, 0, stream>>>(a, w, M, N, K, epi);
  } else {
    static_assert(std::is_same<T, bf16>::value, "GEMM dtype must be float or bf16");
    dim3 grid(cdiv(N, kTcBN), cdiv(M, kTcBM));
    gemm_bf16_kernel<<<grid, kTcThreads, 0, stream>>>(a, w, M, N, K, epi);
  }
  return cudaGetLastError();
}

}  // namespace vt
