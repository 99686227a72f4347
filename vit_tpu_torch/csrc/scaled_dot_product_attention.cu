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
// bf16 (the main path) runs on the tensor cores (mma_bf16.cuh): 4 warps,
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
  constexpr int LD = mma_ld(DH), kTile = kMmaRows * LD, kD = DH / 16;
  extern __shared__ __align__(128) unsigned char mma_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(mma_smem);  // [64][LD], then the output stage
  bf16* Ks = Qs + kTile;                          // 2 stages
  bf16* Vs = Ks + 2 * kTile;                      // 2 stages

  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * kMmaRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, c = lane & 3;
  const bf16 *kb = k + sk.at(b, h), *vb = v + sv.at(b, h);
  const int nk = cdiv(seq, kMmaRows), steps = 2 * nk;
  const bool live = q0 + 16 * warp < seq;  // warp-uniform

  // step i < nk (pass 1) reads key tile i; step nk + i (pass 2) key and
  // value tile i, into ring stage i & 1
  auto load = [&](int i) {
    const int k0 = (i < nk ? i : i - nk) * kMmaRows;
    cp_rows<DH>(Ks + (i & 1) * kTile, kb, sk.t, k0, seq);
    if (i >= nk) cp_rows<DH>(Vs + (i & 1) * kTile, vb, sv.t, k0, seq);
  };
  cp_rows<DH>(Qs, q + sq.at(b, h), sq.t, q0, seq);
  load(0);
  cp_async_commit();

  uint32_t qf[kD][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, inv[2] = {0.f, 0.f};
  float o[DH / 8][4];
  zero(o);
  for (int i = 0; i < steps; ++i) {
    if (i + 1 < steps) load(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    if (i == 0) scale_own_rows<DH>(Qs, round_to<bf16>(inv_sqrt_dh));
    __syncthreads();
    if (i == 0) {
#pragma unroll
      for (int kk = 0; kk < kD; ++kk) ldsm_a(qf[kk], Qs, LD, 16 * warp, 16 * kk);
    }
    if (live) {
      const int k0 = (i < nk ? i : i - nk) * kMmaRows;
      float s[8][4];  // 16 rows x 64 keys: rows g, g + 8; keys 8j + 2c, + 1
      zero(s);
      mma_rows<DH, 8>(s, qf, Ks + (i & 1) * kTile, 0);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int key = k0 + 8 * j + 2 * c;
        if (key >= seq) s[j][0] = s[j][2] = -INFINITY;
        if (key + 1 >= seq) s[j][1] = s[j][3] = -INFINITY;
      }
      if (i < nk) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {  // rows g and g + 8
          float tmax = -INFINITY;
#pragma unroll
          for (int j = 0; j < 8; ++j) tmax = fmaxf(tmax, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
          const float mn = fmaxf(m[r], quad_max(tmax));  // finite: every tile has a key
          float ps = 0.f;
#pragma unroll
          for (int j = 0; j < 8; ++j)
            ps += __expf(s[j][2 * r] - mn) + __expf(s[j][2 * r + 1] - mn);
          l[r] = l[r] * __expf(m[r] - mn) + quad_sum(ps);
          m[r] = mn;
        }
        if (i == nk - 1) {
          inv[0] = 1.0f / l[0];
          inv[1] = 1.0f / l[1];
        }
      } else {
        const bf16* Vt = Vs + (i & 1) * kTile;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {  // p of keys 16kk .. 16kk + 15 as an A fragment
#pragma unroll
          for (int jj = 2 * kk; jj < 2 * kk + 2; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[jj][e] = __expf(s[jj][e] - m[e >> 1]) * inv[e >> 1];
          uint32_t pa[4];
          acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
          mma_cols<DH>(o, pa, Vt, 16 * kk);
        }
      }
    }
    __syncthreads();  // stage i & 1 consumed before step i + 2 refills it
  }
  if (live) store_rows16<DH>(o, 1.f, Qs + 16 * warp * LD, out + so.at(b, h), so.t, q0 + 16 * warp,
                             seq);
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
