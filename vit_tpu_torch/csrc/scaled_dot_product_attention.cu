// K21: softmax(q k^T / sqrt(dh)) v over (batch, head, token, dh) views.
// Replaces vit_tpu/ops/pallas/attention_kernel.py:scaled_dot_product_attention
// (_attn_kernel), the per-op tier's attention core.
//
// The TPU kernel holds one (batch, head)'s whole (T, T) score tile in VMEM.
// A Hopper block has 227 KB of shared memory, so this is K1's attention
// stage (attention.cuh, attention_tile) on strided views: one block per
// (image, head, 64-query tile), grid (ceil(T / 64), H, B); 64-key tiles
// stream through shared memory twice (pass 1: row max and sum of exp;
// pass 2: p = exp(s - m) * (1/sum) rounded to the dtype, then p @ v), so any
// T fits and the rounding points are the TPU kernel's: q * (1/sqrt(dh)) in
// the dtype, fp32 scores, reciprocal-multiply normalisation, p rounded to
// v's dtype, fp32 accumulation, output rounded once.
//
// Bound on the H100 by device memory at ViT shapes (B/16 @224 batch 100:
// 121 MB of q, k, v and output against 11.9 GFLOP), so the views are read
// in place — the packed (B*T, 3D) QKV columns, say — and the context is
// written through its own strides, with no head transposes.  The scores
// and p @ v run in fp32 FMA (SIMT); tensor-core tiles are later work.
#include "attention.cuh"
#include "common.cuh"

namespace vt {

template <typename T, int DH>
__global__ void __launch_bounds__(kAtThreads)
sdpa_kernel(const T* __restrict__ q, View4 sq, const T* __restrict__ k, View4 sk,
            const T* __restrict__ v, View4 sv, T* __restrict__ out, View4 so, int seq,
            float inv_sqrt_dh) {
  const int h = blockIdx.y, b = blockIdx.z;
  const StridedIo<T> io{q + sq.at(b, h), k + sk.at(b, h), v + sv.at(b, h), out + so.at(b, h),
                        sq.t, sk.t, sv.t, so.t};
  attention_tile<T, DH, false>(io, nullptr, seq, inv_sqrt_dh);
}

template <typename T, int DH>
cudaError_t launch_sdpa(const T* q, View4 sq, const T* k, View4 sk, const T* v, View4 sv, T* out,
                        View4 so, int batch, int heads, int seq, cudaStream_t stream) {
  constexpr size_t smem = attention_smem_bytes<DH>();
  VT_TRY(cudaFuncSetAttribute(sdpa_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem));
  const float inv_sqrt_dh = (float)(1.0 / sqrt((double)DH));  // as the host computes it
  sdpa_kernel<T, DH><<<dim3(cdiv(seq, kAtQ), heads, batch), kAtThreads, smem, stream>>>(
      q, sq, k, sk, v, sv, out, so, seq, inv_sqrt_dh);
  return cudaGetLastError();
}

template <typename T>
cudaError_t sdpa(const T* q, View4 sq, const T* k, View4 sk, const T* v, View4 sv, T* out,
                 View4 so, int batch, int heads, int seq, int head_dim, cudaStream_t stream) {
  if (seq <= 0 || batch <= 0 || heads <= 0) return cudaSuccess;
  switch (head_dim) {
    case 16: return launch_sdpa<T, 16>(q, sq, k, sk, v, sv, out, so, batch, heads, seq, stream);
    case 32: return launch_sdpa<T, 32>(q, sq, k, sk, v, sv, out, so, batch, heads, seq, stream);
    case 64: return launch_sdpa<T, 64>(q, sq, k, sk, v, sv, out, so, batch, heads, seq, stream);
    case 80: return launch_sdpa<T, 80>(q, sq, k, sk, v, sv, out, so, batch, heads, seq, stream);
    case 128: return launch_sdpa<T, 128>(q, sq, k, sk, v, sv, out, so, batch, heads, seq, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace vt

extern "C" int vt_scaled_dot_product_attention(
    const void* q, long long qb, long long qh, long long qt, const void* k, long long kb,
    long long kh, long long kt, const void* v, long long vb, long long vh, long long vt_,
    void* out, long long ob, long long oh, long long ot, int batch, int heads, int seq,
    int head_dim, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const vt::View4 sq{qb, qh, qt}, sk{kb, kh, kt}, sv{vb, vh, vt_}, so{ob, oh, ot};
  cudaStream_t s = (cudaStream_t)stream;
#define VT_K21(T)                                                                         \
  vt::sdpa<T>((const T*)q, sq, (const T*)k, sk, (const T*)v, sv, (T*)out, so, batch, heads, \
              seq, head_dim, s)
  if (dtype == vt::kFloat32) return (int)VT_K21(float);
  if (dtype == vt::kBFloat16) return (int)VT_K21(vt::bf16);
#undef VT_K21
  return (int)cudaErrorInvalidValue;
}
