// GEMM epilogue functors shared by the kernels (gemm.cuh calls each with
// an fp32 accumulator and its (row, col)).  Additions run in fp32 in the
// TPU kernels' order; each output rounds once, to its own type.
#pragma once

#include "common.cuh"

#include <type_traits>

namespace vt {

// out[r, c] = acc
template <typename TOut>
struct StoreEpi {
  TOut* out;
  int ld;
  __device__ __forceinline__ void operator()(int r, int c, float acc) const {
    out[(size_t)r * ld + c] = from_f<TOut>(acc);
  }
};

// out[r, c] = acc + b[c]  (the packed QKV, rounded; or fp32 u)
template <typename TB, typename TOut>
struct BiasEpi {
  const TB* b;
  TOut* out;
  int ld;
  __device__ __forceinline__ void operator()(int r, int c, float acc) const {
    out[(size_t)r * ld + c] = from_f<TOut>(acc + to_f(b[c]));
  }
};

// out[r, c] = acc + b[c] + res[r, c]  (out_proj and FC2 with their residual)
template <typename TB, typename TRes, typename TOut>
struct BiasResidualEpi {
  const TB* b;
  const TRes* res;
  TOut* out;
  int ld;
  __device__ __forceinline__ void operator()(int r, int c, float acc) const {
    const size_t i = (size_t)r * ld + c;
    out[i] = from_f<TOut>(acc + to_f(b[c]) + to_f(res[i]));
  }
};

// g[r, c] = round(gelu(acc + b1[c])); the erf is the A-S form in fp32 and
// the tanh form in bf16 (fused_block.use_fast_erf)
template <typename T>
struct BiasGeluEpi {
  const T* b1;
  T* g;
  int ld;
  int variant;
  __device__ __forceinline__ void operator()(int r, int c, float acc) const {
    constexpr bool fast_erf = std::is_same<T, bf16>::value;
    g[(size_t)r * ld + c] = from_f<T>(gelu(acc + to_f(b1[c]), variant, fast_erf));
  }
};

}  // namespace vt
