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
//      round-half-to-even (quant_rows.cuh quant_code), a warp per row with
//      16-byte loads and 4-byte code stores
//   2. mq @ W2q with exact int32 sums on gemm_mma_q8.cuh's TMA + wgmma int8
//      core, stored as they are (a warp on 32 neighbouring columns).  The
//      core reads both operands K-major, so the sequence first copies this
//      shard's W2q (F/tp, d) into the w2t scratch (d, F/tp); the TPU kernel
//      keeps the shard weight resident in VMEM, here its copy stays in L2.
// What bounds it on the H100: at B/16 batch 100 and tp = 2, reading mid
// (121 MB) and writing the int32 sums (60.5 MB): ~183 MB.
#include "common.cuh"
#include "gemm_mma_q8.cuh"
#include "quant_rows.cuh"

namespace vt {

constexpr int kRequantVecs = 4;  // float4 loads per lane in flight

// mq[r, :] = quant_code(mid[r, :], ms[r]); n a multiple of 4, rows of mid
// and mq on 16- and 4-byte boundaries
static __global__ void __launch_bounds__(kRowThreads)
requant_rows_vec_kernel(const float* __restrict__ mid, const float* __restrict__ ms,
                        int8_t* __restrict__ mq, int rows, int n) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // whole warps exit together
  const float scale = ms[row];
  const float4* vr = reinterpret_cast<const float4*>(mid + (size_t)row * n);
  char4* qr = reinterpret_cast<char4*>(mq + (size_t)row * n);
  const int nv = n / 4;
  for (int j0 = lane; j0 < nv; j0 += 32 * kRequantVecs) {
    float4 v[kRequantVecs];
#pragma unroll
    for (int i = 0; i < kRequantVecs; ++i) {
      const int j = j0 + 32 * i;
      v[i] = j < nv ? __ldcs(vr + j) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int i = 0; i < kRequantVecs; ++i) {
      const int j = j0 + 32 * i;
      if (j < nv)
        qr[j] = make_char4(quant_code(v[i].x, scale), quant_code(v[i].y, scale),
                           quant_code(v[i].z, scale), quant_code(v[i].w, scale));
    }
  }
}

// out[r, c] = acc, the raw int32 sum
struct StoreInt32Epi {
  int* out;
  int ld;
  __device__ __forceinline__ void operator()(int r, int c, int acc) const {
    out[(size_t)r * ld + c] = acc;
  }
};

cudaError_t fc2_q8_partial(const float* mid, const float* ms, const int8_t* w2q, int8_t* w2t,
                           int8_t* mq, int* out, int rows, int f, int d, cudaStream_t stream) {
  if (rows <= 0) return cudaSuccess;
  if (f % 4) return cudaErrorInvalidValue;
  VT_TRY(launch_transpose_q8(w2q, w2t, f, d, stream));
  requant_rows_vec_kernel<<<cdiv(rows, kRowThreads / 32), kRowThreads, 0, stream>>>(mid, ms, mq,
                                                                                    rows, f);
  VT_TRY(cudaGetLastError());
  return launch_gemm_mma_q8(mq, w2t, rows, d, f, StoreInt32Epi{out, d}, stream);
}

}  // namespace vt

// `w2t` (d x f int8) is the K-major copy's scratch
extern "C" int vt_fc2_q8_partial(const void* mid, const void* ms, const void* w2q, void* w2t,
                                 void* mq, void* out, int rows, int f, int d, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)vt::fc2_q8_partial((const float*)mid, (const float*)ms, (const int8_t*)w2q,
                                 (int8_t*)w2t, (int8_t*)mq, (int*)out, rows, f, d,
                                 (cudaStream_t)stream);
}
