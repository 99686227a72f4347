// K21: softmax(q k^T / sqrt(dh)) v over (batch, head, token, dh) views.
// Replaces vit_tpu/ops/pallas/attention_kernel.py:scaled_dot_product_attention
// (_attn_kernel), the per-op tier's attention core.
//
// The TPU kernel holds one (batch, head)'s whole (T, T) score tile in VMEM.
// Here one block owns 64 query rows of one (image, head), grid (ceil(T /
// 64), H, B), and 64-key tiles stream past it twice (pass 1: row max and
// sum of exp; pass 2: p = exp(s - m) * (1/sum) rounded to the dtype, then
// p @ v), so any T fits and the rounding points are the TPU kernel's:
// q * round(1/sqrt(dh)) rounded to the dtype, fp32 scores and the exact row
// max over all T keys, reciprocal-multiply normalisation, p rounded to v's
// dtype before p @ v, fp32 accumulation, output rounded once.  (Normalising
// at the end, as single-pass flash does, would move p's rounding point.)
//
// What bounds it on the H100: device memory at ViT shapes (B/16 @224 batch
// 100: 121 MB of q, k, v and output against 11.9 GFLOP, 17.8 with the two
// passes), so the views are read in place -- the packed (B*T, 3D) QKV
// columns, say -- and the context is written through its own strides, with
// no head transposes.
//
// bf16 (the main path) runs on the tensor cores (mma_bf16.cuh; the body,
// sdpa_mma.cuh's sdpa_mma_tile, is shared with K1's attention stage): 4 warps,
// 16 query rows each; q_s is loaded once by cp.async and held as mma.sync
// A fragments; K (and in pass 2 V) tiles stream through a 2-stage cp.async
// ring; the row max and sum stay in registers (quad shuffles); in pass 2 p
// is formed in registers and repacked straight into the A fragments of
// p @ v, with V read by ldmatrix.trans; the context leaves in 16-byte
// stores.  exp is the MUFU's (__expf: 2 ulp near 0, where p is large; p
// rounds to bf16 at 2^-8).  A warp whose 16 rows all lie past T does no MMA
// work (at T = 197 the last tile's 5 live rows keep one warp of four busy).
// fp32 keeps K1's attention stage (attention.cuh, attention_tile) on
// strided views: CUDA-core FMA, never TF32, as the TPU kernel pins HIGHEST.
#include "attention.cuh"
#include "common.cuh"
#include "mma_bf16.cuh"
#include "sdpa_mma.cuh"

#include <type_traits>

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

// one block's work in bf16: the 64 query rows of tile blockIdx.x
template <int DH>
__global__ void __launch_bounds__(kMmaThreads)
sdpa_mma_kernel(const bf16* __restrict__ q, View4 sq, const bf16* __restrict__ k, View4 sk,
                const bf16* __restrict__ v, View4 sv, bf16* __restrict__ out, View4 so, int seq,
                float inv_sqrt_dh) {
  sdpa_mma_tile<DH, false>(q, sq, k, sk, v, sv, out, so, nullptr, seq, inv_sqrt_dh);
}

template <typename T, int DH>
cudaError_t launch_sdpa(const T* q, View4 sq, const T* k, View4 sk, const T* v, View4 sv, T* out,
                        View4 so, int batch, int heads, int seq, cudaStream_t stream) {
  const float inv_sqrt_dh = (float)(1.0 / sqrt((double)DH));  // as the host computes it
  const dim3 grid(cdiv(seq, kAtQ), heads, batch);
  if constexpr (std::is_same<T, bf16>::value) {
    constexpr size_t smem = mma_tiles_bytes<DH>(5);
    VT_TRY(cudaFuncSetAttribute(sdpa_mma_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem));
    sdpa_mma_kernel<DH><<<grid, kMmaThreads, smem, stream>>>(q, sq, k, sk, v, sv, out, so, seq,
                                                             inv_sqrt_dh);
  } else {
    constexpr size_t smem = attention_smem_bytes<DH>();
    VT_TRY(cudaFuncSetAttribute(sdpa_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem));
    sdpa_kernel<T, DH><<<grid, kAtThreads, smem, stream>>>(q, sq, k, sk, v, sv, out, so, seq,
                                                          inv_sqrt_dh);
  }
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
