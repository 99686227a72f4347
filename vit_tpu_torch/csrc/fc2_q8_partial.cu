// K18b: requantize the fp32 `mid` with a GIVEN per-row scale -> int8 FC2
// over this shard's hidden rows -> the raw int32 sums.  Replaces
// vit_tpu/ops/pallas/quant_kernels.py:fc2_q8_partial (_fc2_q8_partial_kernel).
//
// The second half of the tensor-parallel W8A8 MLP.  The row scale ms is the
// caller's: max(max over every shard of the row's largest |mid|, all-reduced
// MAX) / 127, floored at 1e-12 — the scale the unsharded quantizer takes
// over the whole hidden row, so no absmax here.  The int32 sums go out
// undequantized: the shards' partial sums add exactly (all-reduce SUM in
// int32) before the caller dequantizes, which keeps the arithmetic the
// unsharded kernel's.
//   1. mq = clip(rint(mid / ms[r]), -127, 127): a true fp32 divide and
//      round-half-to-even (quant_rows.cuh quant_code), element-wise
//   2. mq @ W2q with exact int32 sums (gemm_q8.cuh) stored as they are
// What bounds it on the H100: at B/16 batch 100 and tp = 2, reading mid
// (121 MB) and writing the int32 sums (60.5 MB): ~183 MB.
#include "common.cuh"
#include "gemm_q8.cuh"
#include "quant_rows.cuh"

#include <algorithm>

namespace vt {

static __global__ void __launch_bounds__(256)
requant_rows_kernel(const float* __restrict__ mid, const float* __restrict__ ms,
                    int8_t* __restrict__ mq, int rows, int n) {
  const size_t total = (size_t)rows * n;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x)
    mq[i] = quant_code(mid[i], ms[i / n]);
}

// out[r, c] = acc, the raw int32 sum
struct StoreInt32Epi {
  int* out;
  int ld;
  __device__ __forceinline__ void operator()(int r, int c, int acc) const {
    out[(size_t)r * ld + c] = acc;
  }
};

cudaError_t fc2_q8_partial(const float* mid, const float* ms, const int8_t* w2q, int8_t* mq,
                           int* out, int rows, int f, int d, cudaStream_t stream) {
  const size_t n = (size_t)rows * f;
  const int blocks = (int)std::min<size_t>((n + 255) / 256, 8192);
  if (n) {
    requant_rows_kernel<<<blocks, 256, 0, stream>>>(mid, ms, mq, rows, f);
    VT_TRY(cudaGetLastError());
  }
  return launch_gemm_q8(mq, w2q, rows, d, f, StoreInt32Epi{out, d}, stream);
}

}  // namespace vt

extern "C" int vt_fc2_q8_partial(const void* mid, const void* ms, const void* w2q, void* mq,
                                 void* out, int rows, int f, int d, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)vt::fc2_q8_partial((const float*)mid, (const float*)ms, (const int8_t*)w2q,
                                 (int8_t*)mq, (int*)out, rows, f, d, (cudaStream_t)stream);
}
