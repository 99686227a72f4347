// int8 GEMM core of the fp32 W8A8 kernels (K15-K17, K18a) and of K19: C =
// A @ B with A (M, K) and B (K, N) int8 row-major in device memory, exact
// int32 accumulation on the tensor cores (WMMA 16x16x16, signed char
// operands, int accumulators), and an epilogue functor that receives each
// int32 accumulator with its (row, col) — where the dequantization by the
// row and column scales runs.
//
// Block tile 128 x 128 x 64, 8 warps each owning a 64 x 32 slab, as the bf16
// core of gemm.cuh (which stays as it is: this is a header of its own so
// that no existing kernel recompiles differently).  Operands are plain
// int8 matrices, so the tiles fill with 16-byte loads: K and N must be
// multiples of 16 and both base pointers 16-byte aligned (the wrappers
// check).  Rows past M and depth past K load zeros, which add nothing to
// the sums; the epilogue is skipped past M and N.  Tiles are
// single-buffered; the bf16 W8A8 kernels (K15-K17, K18a) and K18b run
// gemm_mma_q8.cuh's TMA + wgmma core instead, with this header's functors.
#pragma once

#include "common.cuh"

#include <mma.h>

#include <type_traits>

namespace vt {

constexpr int kQ8BM = 128, kQ8BN = 128, kQ8BK = 64, kQ8Threads = 256;
constexpr int kQ8Vec = 16;  // int8 values per load
// Row pitches padded by 16 bytes: a multiple of 16 as WMMA's int8 loads
// require, and rows shift across banks.
constexpr int kQ8LdA = kQ8BK + 16;  // 80 B
constexpr int kQ8LdB = kQ8BN + 16;  // 144 B

// 16 consecutive values of row r from column c (c % 16 == 0) of a
// row-major (rows, cols) int8 matrix of pitch cols; zeros outside
__device__ __forceinline__ int4 load_q8x16(const int8_t* __restrict__ p, int r, int c, int rows,
                                           int cols) {
  if (r < rows && c < cols) return *reinterpret_cast<const int4*>(p + (size_t)r * cols + c);
  return make_int4(0, 0, 0, 0);
}

template <class Epi>
__global__ void __launch_bounds__(kQ8Threads)
gemm_q8_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b, int M, int N, int K,
               Epi epi) {
  using namespace nvcuda;
  __shared__ __align__(128) signed char As[kQ8BM * kQ8LdA];
  __shared__ __align__(128) signed char Bs[kQ8BK * kQ8LdB];
  __shared__ __align__(128) int Cs[kQ8Threads / 32][16 * 16];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2;  // 0..1: 64-row slab
  const int wn = warp & 3;   // 0..3: 32-column slab
  const int row0 = blockIdx.y * kQ8BM, col0 = blockIdx.x * kQ8BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0);

  constexpr int kAVecs = kQ8BK / kQ8Vec, kBVecs = kQ8BN / kQ8Vec;  // per tile row
  for (int k0 = 0; k0 < K; k0 += kQ8BK) {
    for (int idx = tid; idx < kQ8BM * kAVecs; idx += kQ8Threads) {
      const int r = idx / kAVecs, c = (idx % kAVecs) * kQ8Vec;
      *reinterpret_cast<int4*>(As + r * kQ8LdA + c) = load_q8x16(a, row0 + r, k0 + c, M, K);
    }
    for (int idx = tid; idx < kQ8BK * kBVecs; idx += kQ8Threads) {
      const int r = idx / kBVecs, c = (idx % kBVecs) * kQ8Vec;
      *reinterpret_cast<int4*>(Bs + r * kQ8LdB + c) = load_q8x16(b, k0 + r, col0 + c, K, N);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kQ8BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm * 64 + i * 16) * kQ8LdA + kk, kQ8LdA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Bs + kk * kQ8LdB + wn * 32 + j * 16, kQ8LdB);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: each warp spills one 16x16 accumulator at a time to its own
  // shared scratch, then applies the functor element by element
  int* cs = Cs[warp];
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

// C = A @ B over int8 (M, K) x (K, N) on `stream`; K and N multiples of 16.
template <class Epi>
inline cudaError_t launch_gemm_q8(const int8_t* a, const int8_t* b, int M, int N, int K, Epi epi,
                                  cudaStream_t stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  if (K % kQ8Vec || N % kQ8Vec) return cudaErrorInvalidValue;
  dim3 grid(cdiv(N, kQ8BN), cdiv(M, kQ8BM));
  gemm_q8_kernel<<<grid, kQ8Threads, 0, stream>>>(a, b, M, N, K, epi);
  return cudaGetLastError();
}

// ---- epilogues.  The dequantization is (float(acc) * hs[row]) * ws[col],
// then + bias, each a separate fp32 rounding in that order, as the TPU
// kernels' `acc.astype(f32) * hs * ws` and `+ bias` (quant_kernels.py:48).
// The intrinsics keep the compiler from contracting a product into the add
// that follows, so the result is the plain twin's bit for bit.

__device__ __forceinline__ float dequant(int acc, float hs, float ws) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), hs), ws);
}

// out[r, c] = (acc hs[r]) ws[c]  (fp32; the core alone)
struct DequantEpi {
  const float* hs;
  const float* ws;
  float* out;
  int ld;
  __device__ __forceinline__ void operator()(int r, int c, int acc) const {
    out[(size_t)r * ld + c] = dequant(acc, hs[r], ws[c]);
  }
};

// out[r, c] = round((acc hs[r]) ws[c] + b[c])  (the packed QKV)
template <typename T>
struct DequantBiasEpi {
  const float* hs;
  const float* ws;
  const T* b;
  T* out;
  int ld;
  __device__ __forceinline__ void operator()(int r, int c, int acc) const {
    out[(size_t)r * ld + c] = from_f<T>(__fadd_rn(dequant(acc, hs[r], ws[c]), to_f(b[c])));
  }
};

// mid[r, c] = gelu((acc hs[r]) ws[c] + b1[c]), kept in fp32: the second row
// quantizer reads it unrounded.  The erf is the A-S form in fp32 and the
// tanh form in bf16 (fused_block.use_fast_erf of the working dtype T).
template <typename T>
struct DequantBiasGeluEpi {
  const float* hs;
  const float* ws;
  const T* b1;
  float* mid;
  int ld;
  int variant;
  __device__ __forceinline__ void operator()(int r, int c, int acc) const {
    constexpr bool fast_erf = std::is_same<T, bf16>::value;
    mid[(size_t)r * ld + c] =
        gelu(__fadd_rn(dequant(acc, hs[r], ws[c]), to_f(b1[c])), variant, fast_erf);
  }
};

// out[r, c] = round(((acc ms[r]) ws[c] + b2[c]) + x1[r, c])  (FC2 with its
// residual: fp32 x1 in K16, the dtype's x in K17)
template <typename T, typename TRes>
struct DequantBiasResidualEpi {
  const float* ms;
  const float* ws;
  const T* b2;
  const TRes* x1;
  T* out;
  int ld;
  __device__ __forceinline__ void operator()(int r, int c, int acc) const {
    const size_t i = (size_t)r * ld + c;
    const float v = __fadd_rn(dequant(acc, ms[r], ws[c]), to_f(b2[c]));
    out[i] = from_f<T>(__fadd_rn(v, to_f(x1[i])));
  }
};

}  // namespace vt
