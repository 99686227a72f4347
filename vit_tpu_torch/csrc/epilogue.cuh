// GEMM epilogue functors shared by the kernels (gemm.cuh and gemm_mma.cuh
// call each with an fp32 accumulator and its (row, col)).  Additions run
// in fp32 in the TPU kernels' order; each output rounds once, to its own
// type.
#pragma once

#include "common.cuh"

#include <algorithm>
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

// BiasGeluEpi that also stashes the pre-GELU activation: u[r, c] =
// round(acc + b1[c]) beside g (K5's return_u; the TPU kernel's
// `u.astype(x.dtype)`)
template <typename T>
struct BiasGeluStashEpi {
  const T* b1;
  T* g;
  T* u;
  int ld;
  int variant;
  __device__ __forceinline__ void operator()(int r, int c, float acc) const {
    constexpr bool fast_erf = std::is_same<T, bf16>::value;
    const size_t i = (size_t)r * ld + c;
    const float v = acc + to_f(b1[c]);
    u[i] = from_f<T>(v);
    g[i] = from_f<T>(gelu(v, variant, fast_erf));
  }
};

// ---- the regularized kernels' gates (K10, K11, K12a).  kDrop is a
// template flag: with p = 0 the hash is never compiled in, and dp (the
// (rows,) fp32 stochastic-depth scale) multiplies by 1 where a row is kept.
// Products run in the TPU kernels' order.

// out[r, c] = round(((acc + b[c]) * m_site) * dp[r] + res[r, c])
// (K10 at the attention-out site, K11's FC2 at the MLP-out site)
template <typename T, bool kDrop>
struct BiasDropResidualEpi {
  const T* b;
  const T* res;
  const float* dp;
  Dropout drop;
  int site;
  T* out;
  int ld;
  __device__ __forceinline__ void operator()(int r, int c, float acc) const {
    const size_t i = (size_t)r * ld + c;
    float v = acc + to_f(b[c]);
    if constexpr (kDrop) v = v * drop(site, r, c);
    out[i] = from_f<T>(v * dp[r] + to_f(res[i]));
  }
};

// g[r, c] = round(gelu(acc + b1[c]) * m_inner): the inner mask multiplies
// in fp32 before g rounds (K11's FC1)
template <typename T, bool kDrop>
struct BiasGeluDropEpi {
  const T* b1;
  T* g;
  int ld;
  int variant;
  Dropout drop;
  __device__ __forceinline__ void operator()(int r, int c, float acc) const {
    constexpr bool fast_erf = std::is_same<T, bf16>::value;
    float v = gelu(acc + to_f(b1[c]), variant, fast_erf);
    if constexpr (kDrop) v = v * drop(kSiteMlpInner, r, c);
    g[(size_t)r * ld + c] = from_f<T>(v);
  }
};

// K12a's GELU backward: u[r, c] holds u on entry and du on exit;
// g = round(gelu(u) * m_inner), du = (acc * m_inner) * gelu'(u) with
// acc = (round(dy_m) @ W2^T)[r, c], du_c = round(du)
template <typename T, bool kDrop>
struct GeluGradDropEpi {
  float* u;
  T* g;
  T* du_c;
  int ld;
  int variant;
  Dropout drop;
  __device__ __forceinline__ void operator()(int r, int c, float acc) const {
    constexpr bool fast_erf = std::is_same<T, bf16>::value;
    const size_t i = (size_t)r * ld + c;
    const float uu = u[i];
    float gv = gelu(uu, variant, fast_erf);
    if constexpr (kDrop) {
      const float m = drop(kSiteMlpInner, r, c);
      gv = gv * m;
      acc = acc * m;
    }
    g[i] = from_f<T>(gv);
    const float du = acc * gelu_grad(uu, variant, fast_erf);
    u[i] = du;
    du_c[i] = from_f<T>(du);
  }
};

// Gated gradient operand, element (i, j) of a row-major (rows, cols)
// matrix x: (x * dp[i]) * m_site, in fp32 — K12a's (and K12b's) dy_m =
// (dy dp_mlp) m_out and K12a's (and K12c's) dz = (dx1 dp_attn) m_attn,
// summed as is (db2, db_o) and written rounded once for the GEMMs
// (launch_gate_rows).
template <typename TSrc, bool kDrop>
struct Gate {
  const TSrc* x;
  int ld;
  const float* dp;
  Dropout drop;
  int site;
  __device__ __forceinline__ float operator()(int i, int j) const {
    float v = to_f(x[(size_t)i * ld + j]) * dp[i];
    if constexpr (kDrop) v = v * drop(site, i, j);
    return v;
  }
};

// out[r, c] = round(gate(r, c)) over a row-major (rows, cols) matrix
template <typename T, typename TSrc, bool kDrop>
__global__ void __launch_bounds__(256)
gate_rows_kernel(Gate<TSrc, kDrop> gate, T* __restrict__ out, int rows, int cols) {
  const size_t n = (size_t)rows * cols;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    out[i] = from_f<T>(gate((int)(i / cols), (int)(i % cols)));
}

template <typename T, typename TSrc, bool kDrop>
cudaError_t launch_gate_rows(Gate<TSrc, kDrop> gate, T* out, int rows, int cols,
                             cudaStream_t stream) {
  const size_t n = (size_t)rows * cols;
  const int blocks = (int)std::min<size_t>((n + 255) / 256, 4096);
  gate_rows_kernel<<<blocks, 256, 0, stream>>>(gate, out, rows, cols);
  return cudaGetLastError();
}

}  // namespace vt
