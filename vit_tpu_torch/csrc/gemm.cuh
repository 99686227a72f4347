// Tiled fp32 GEMM core: C = A @ B with A (M, K) and B (K, N) each produced
// element by element by a loader functor (plain, transposed, rounded from
// another type, or with LayerNorm applied on the fly), fp32 accumulation,
// and an epilogue functor that receives each fp32 accumulator with its
// (row, col).  Every kernel's fp32 form runs its GEMMs here (K1, K2, K4-K12c,
// K16, K22); bf16 runs on gemm_mma.cuh's TMA + wgmma core, and the int8
// GEMMs on gemm_q8.cuh and gemm_mma_q8.cuh.
//
// CUDA-core fp32 FMA (never TF32): block tile 64 x 64 x 16, 256 threads
// each owning 4 x 4 outputs.  Tiles are single-buffered and loaded through
// registers, where the loaders apply their transform; each loader says
// which of its two indices runs along contiguous memory, and the tile fill
// walks that one across neighbouring threads.  Rows, columns and depth
// past the matrix load zeros (the depth tail matters where K is the ragged
// row axis of a weight gradient), and the epilogue is skipped there.
//
// Weight gradients (launch_wgrad) split the depth K over gridDim.z when
// the output has few tiles; each split writes its own fp32 partial and a
// second pass sums the partials in split order — deterministic, no atomics.
// The column sums and sum_partials_kernel here serve gemm_mma.cuh too.
#pragma once

#include "common.cuh"

#include <algorithm>
#include <type_traits>

namespace vt {

// ---- Operand loaders: element (i, j) of the operand in the GEMM's dtype T.
// kContiguousJ: true when j runs along contiguous memory.

// x row-major (pitch ld), read as is (kTrans false: element x[i][j]) or
// transposed (element x[j][i]); a TSrc other than T is rounded on load.
template <typename T, typename TSrc = T, bool kTrans = false>
struct Load {
  static constexpr bool kContiguousJ = !kTrans;
  const TSrc* x;
  int ld;
  __device__ __forceinline__ T operator()(int i, int j) const {
    const TSrc v = kTrans ? x[(size_t)j * ld + i] : x[(size_t)i * ld + j];
    if constexpr (std::is_same<T, TSrc>::value) {
      return v;
    } else {
      return from_f<T>(to_f(v));
    }
  }
};

// LayerNorm of x (rows r, features k) applied on load: ((x - mean) * rstd *
// scale + bias) in fp32, rounded to T — the TPU kernels'
// `_ln(...).astype(dtype)`.  kTrans reads LN(x) transposed (element
// (k, r)), the A operand of a weight gradient h^T @ dY.
template <typename TIn, typename T, bool kTrans = false>
struct LoadLn {
  static constexpr bool kContiguousJ = !kTrans;
  const TIn* x;
  int ld;
  const float* mean;
  const float* rstd;
  const T* scale;
  const T* bias;
  __device__ __forceinline__ T operator()(int i, int j) const {
    const int r = kTrans ? j : i, k = kTrans ? i : j;
    const float c = to_f(x[(size_t)r * ld + k]) - mean[r];
    return from_f<T>(c * rstd[r] * to_f(scale[k]) + to_f(bias[k]));
  }
};

// tile[r][c] (or tile[c][r] when kStoreT) = ld(r0 + r, c0 + c) for an R x C
// tile, zero outside [0, rows) x [0, cols); neighbouring threads take
// neighbouring elements along the operand's contiguous axis.
template <int R, int C, int kThreads, bool kStoreT, class Ld, typename T>
__device__ __forceinline__ void fill_tile(const Ld& ld, T* tile, int pitch, int r0, int c0,
                                          int rows, int cols, int tid) {
  for (int idx = tid; idx < R * C; idx += kThreads) {
    int r, c;
    if constexpr (Ld::kContiguousJ) {
      r = idx / C;
      c = idx % C;
    } else {
      c = idx / R;
      r = idx % R;
    }
    const int gr = r0 + r, gc = c0 + c;
    const T v = (gr < rows && gc < cols) ? ld(gr, gc) : from_f<T>(0.f);
    tile[kStoreT ? c * pitch + r : r * pitch + c] = v;
  }
}

// ---- fp32 CUDA-core GEMM.

constexpr int kFpBM = 64, kFpBN = 64, kFpBK = 16, kFpThreads = 256;

template <bool kSplitK, class ALoad, class BLoad, class Epi>
__global__ void __launch_bounds__(kFpThreads)
gemm_f32_kernel(ALoad a, BLoad b, int M, int N, int K, int k_chunk, Epi epi) {
  __shared__ float As[kFpBK][kFpBM + 4];  // k-major: a thread's 4 rows per k
  __shared__ float Bs[kFpBK][kFpBN];

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * kFpBM, col0 = blockIdx.x * kFpBN;
  const int kb = kSplitK ? blockIdx.z * k_chunk : 0;
  const int ke = kSplitK ? min(K, kb + k_chunk) : K;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = kb; k0 < ke; k0 += kFpBK) {
    fill_tile<kFpBM, kFpBK, kFpThreads, true>(a, &As[0][0], kFpBM + 4, row0, k0, M, ke, tid);
    fill_tile<kFpBK, kFpBN, kFpThreads, false>(b, &Bs[0][0], kFpBN, k0, col0, ke, N, tid);
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

template <typename T, bool kSplitK, class ALoad, class BLoad, class Epi>
inline cudaError_t launch_gemm_chunked(ALoad a, BLoad b, int M, int N, int K, int k_chunk,
                                       int splits, Epi epi, cudaStream_t stream) {
  static_assert(std::is_same<T, float>::value,
                "gemm.cuh is the fp32 core: bf16 GEMMs run on gemm_mma.cuh");
  if (M <= 0 || N <= 0) return cudaSuccess;
  dim3 grid(cdiv(N, kFpBN), cdiv(M, kFpBM), splits);
  gemm_f32_kernel<kSplitK><<<grid, kFpThreads, 0, stream>>>(a, b, M, N, K, k_chunk, epi);
  return cudaGetLastError();
}

// C = A @ B over (M, K) x (K, N) on `stream`, T = float.
template <typename T, class ALoad, class BLoad, class Epi>
inline cudaError_t launch_gemm(ALoad a, BLoad b, int M, int N, int K, Epi epi,
                               cudaStream_t stream) {
  return launch_gemm_chunked<T, false>(a, b, M, N, K, K, 1, epi, stream);
}

// ---- weight gradients: fp32 (M, N) = A @ B with the depth K = B*T rows.

struct WgradSplit {
  int splits;   // gridDim.z
  int k_chunk;  // depth per split, a multiple of the tile depth
};

// Enough splits to give ~2 blocks per SM (132 on the H100), each split at
// least 8 tile depths deep.  A function of the shape only, so a run's
// partition (and its summation order) never changes.
template <typename T>
inline WgradSplit wgrad_split(int M, int N, int K) {
  static_assert(std::is_same<T, float>::value, "the fp32 core's split; bf16: mma_wgrad_split");
  const int tiles = cdiv(M, kFpBM) * cdiv(N, kFpBN);
  const int splits = std::max(1, std::min(cdiv(264, tiles), cdiv(K, 8 * kFpBK)));
  const int k_chunk = std::max(kFpBK, cdiv(cdiv(K, splits), kFpBK) * kFpBK);
  return {std::max(1, cdiv(K, k_chunk)), k_chunk};
}

// fp32 floats of partials launch_wgrad needs (0 when it does not split)
template <typename T>
inline size_t wgrad_partial_floats(int M, int N, int K) {
  const WgradSplit s = wgrad_split<T>(M, N, K);
  return s.splits > 1 ? (size_t)s.splits * M * N : 0;
}

// out[r, c] = acc, or this split's partial
struct StorePartialEpi {
  float* out;
  int M, N;
  __device__ __forceinline__ void operator()(int r, int c, float acc) const {
    out[(size_t)blockIdx.z * M * N + (size_t)r * N + c] = acc;
  }
};

static __global__ void sum_partials_kernel(const float* __restrict__ part, int splits, size_t n,
                                    float* __restrict__ out) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += part[(size_t)z * n + i];  // split order
    out[i] = s;
  }
}

template <typename T, class ALoad, class BLoad>
inline cudaError_t launch_wgrad(ALoad a, BLoad b, int M, int N, int K, float* out,
                                float* partials, cudaStream_t stream) {
  const WgradSplit s = wgrad_split<T>(M, N, K);
  if (s.splits == 1)
    return launch_gemm_chunked<T, false>(a, b, M, N, K, K, 1, StorePartialEpi{out, M, N},
                                         stream);
  cudaError_t err = launch_gemm_chunked<T, true>(a, b, M, N, K, s.k_chunk, s.splits,
                                           StorePartialEpi{partials, M, N}, stream);
  if (err != cudaSuccess) return err;
  const size_t n = (size_t)M * N;
  const int blocks = (int)std::min<size_t>((n + 255) / 256, 4096);
  sum_partials_kernel<<<blocks, 256, 0, stream>>>(partials, s.splits, n, out);
  return cudaGetLastError();
}

// ---- deterministic column sums: out[c] = sum over rows r of f(r, c).
// Pass 1: one partial per (chunk of kColChunk rows, column), each thread
// summing its column down the chunk in row order (neighbouring threads read
// neighbouring columns); pass 2: the partials in chunk order.

constexpr int kColThreads = 128, kColChunk = 128;

inline size_t colsum_partial_floats(int rows, int cols) {
  return (size_t)cdiv(rows, kColChunk) * cols;
}

template <class F>
__global__ void __launch_bounds__(kColThreads)
colsum_partial_kernel(F f, int rows, int cols, float* __restrict__ part) {
  const int c = blockIdx.x * kColThreads + threadIdx.x;
  if (c >= cols) return;
  const int r0 = blockIdx.y * kColChunk, r1 = min(rows, r0 + kColChunk);
  float s = 0.f;
  for (int r = r0; r < r1; ++r) s += f(r, c);
  part[(size_t)blockIdx.y * cols + c] = s;
}

static __global__ void colsum_finish_kernel(const float* __restrict__ part, int chunks, int cols,
                                     float* __restrict__ out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cols) return;
  float s = 0.f;
  for (int z = 0; z < chunks; ++z) s += part[(size_t)z * cols + c];
  out[c] = s;
}

template <class F>
inline cudaError_t launch_colsum(F f, int rows, int cols, float* partials, float* out,
                                 cudaStream_t stream) {
  const int chunks = cdiv(rows, kColChunk);
  colsum_partial_kernel<<<dim3(cdiv(cols, kColThreads), chunks), kColThreads, 0, stream>>>(
      f, rows, cols, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  colsum_finish_kernel<<<cdiv(cols, kColThreads), kColThreads, 0, stream>>>(partials, chunks,
                                                                         cols, out);
  return cudaGetLastError();
}

// column-sum operands: an fp32 or dtype matrix, and dh * xhat (the
// LayerNorm scale gradient) with xhat = (x - mean) * rstd
template <typename TSrc>
struct ColOf {
  const TSrc* x;
  int ld;
  __device__ __forceinline__ float operator()(int r, int c) const {
    return to_f(x[(size_t)r * ld + c]);
  }
};

template <typename TIn>
struct ColLnScaleGrad {
  const float* dh;
  const TIn* x;
  const float* mean;
  const float* rstd;
  int ld;
  __device__ __forceinline__ float operator()(int r, int c) const {
    const size_t i = (size_t)r * ld + c;
    return dh[i] * ((to_f(x[i]) - mean[r]) * rstd[r]);
  }
};

// ---- scratch carved from one workspace the wrapper allocates: the same
// layout code runs once with base == nullptr to size it.

struct Arena {
  char* base;
  size_t off = 0;
  template <typename X>
  X* take(size_t n) {
    off = (off + 255) & ~(size_t)255;
    X* p = base ? (X*)(base + off) : nullptr;
    off += n * sizeof(X);
    return p;
  }
};

}  // namespace vt
