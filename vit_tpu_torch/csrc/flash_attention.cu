// K13: blockwise flash-attention forward (online softmax), with the fp32
// per-row logsumexp for the backward.  Replaces
// vit_tpu/ops/pallas/flash_attention.py:_flash_forward (_flash_kernel).
//
// The TPU kernel walks (bh, q block, k block) in order, carrying the
// running max, sum and output accumulator in VMEM scratch across the k
// steps.  Here one block owns (image, head, 64-query tile), grid (ceil(T /
// 64), H, B), and loops over 64-key tiles itself: S = q_s K^T; per query
// row the running max m, p = exp(s - m) (fp32), the correction exp(m_old -
// m) and the running sum l from the unrounded p; the accumulator rescaled
// by the correction, then += round(p) V.  At the end out = acc * (1/l),
// rounded once, and lse = m + log(l) from the same l.  q_s = round(q
// round(1/sqrt(dh))), as the TPU kernel scales q in its working dtype.
//
// q, k and v are (batch, head, token, dh) views with their own base and
// shared strides, so the packed (B*T, 3D) QKV is read in place, and the
// output view writes the context straight into (B*T, D).  Keys past T load
// zeros and score -inf; query rows past T are never written.  Every key
// tile holds a valid key, so the row max is finite before any exp.
//
// What bounds it on the H100: the tensor cores (ViT-B/16 @512 batch 16:
// 4 B H T^2 dh = 51.6 GFLOP, 0.052 ms at 989 TFLOP/s, against 50 MB of q,
// k, v and output, 0.015 ms).
//
// bf16 (the main path) runs on mma_bf16.cuh's register tiles: 4 warps of
// 16 query rows each; q_s is loaded once by cp.async, scaled by each
// thread in its own chunks and held as mma.sync A fragments; K and V tiles
// stream through a 2-stage cp.async ring, two barriers per key tile; S, the
// row max and sum, the correction and the fp32 output accumulator stay in
// registers (quad shuffles); p is repacked from the score accumulators into
// the A fragments of p V, with V read by ldmatrix.trans; the output leaves
// in 16-byte stores.  exp is the MUFU's (__expf: 2 ulp near 0, where p is
// large; p rounds to bf16 at 2^-8; __expf(-inf) = 0 gives the first tile's
// correction and the masked keys' p).  A warp whose 16 rows all lie past T
// does no MMA work but still copies and meets the barriers.  fp32 keeps
// flash.cuh's SIMT TileAcc path (FMA, never TF32).
#include "flash.cuh"
#include "mma_bf16.cuh"

#include <type_traits>

namespace vt {

// ---- fp32 on flash.cuh's SIMT tiles, instantiated for T = float only

template <typename T, int DH>
struct FwdSmem {
  T *q, *k, *v, *p;
  float *s, *corr, *inv_l;

  __host__ __device__ static FwdSmem carve(SmemCarve& c) {
    static_assert(std::is_same<T, float>::value, "bf16 runs the mma.sync kernel");
    constexpr int LD = fl_ld(DH), LP = fl_ld(kFl), LS = fl_ld(kFl);
    FwdSmem m;
    m.q = c.take<T>(kFl * LD);
    m.k = c.take<T>(kFl * LD);
    m.v = c.take<T>(kFl * LD);
    m.p = c.take<T>(kFl * LP);
    m.s = c.take<float>(kFl * LS);
    m.corr = c.take<float>(kFl);
    m.inv_l = c.take<float>(kFl);
    return m;
  }

  static size_t bytes() {
    SmemCarve c{nullptr};
    carve(c);
    return c.off;
  }
};

template <typename T, int DH>
__global__ void __launch_bounds__(kFlThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 View4 sin, T* __restrict__ out, View4 sout, float* __restrict__ lse, int seq,
                 int heads, float inv_sqrt_dh) {
  extern __shared__ __align__(128) unsigned char fl_smem[];
  SmemCarve carver{fl_smem};
  const FwdSmem<T, DH> sm = FwdSmem<T, DH>::carve(carver);
  constexpr int LD = fl_ld(DH), LP = fl_ld(kFl), LS = fl_ld(kFl);

  const int q0 = blockIdx.x * kFl, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long base = sin.at(b, h);
  const T *qb = q + base, *kb = k + base, *vb = v + base;

  load_rows<T, DH, true>(qb, sin.t, q0, seq, sm.q, LD, round_to<T>(inv_sqrt_dh));

  float m[4], l[4];  // rows ty + 16 i
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  TileAcc<T, DH> acc;
  acc.zero();
  for (int k0 = 0; k0 < seq; k0 += kFl) {
    __syncthreads();  // the previous tile's K, V and P consumed
    load_rows<T, DH>(kb, sin.t, k0, seq, sm.k, LD);
    load_rows<T, DH>(vb, sin.t, k0, seq, sm.v, LD);
    __syncthreads();
    TileAcc<T, kFl> s;
    s.zero();
    s.template mma<DH, false, true>(sm.q, LD, sm.k, LD);
    store_tile(s, sm.s, LS);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      float sv[4], tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        sv[j] = k0 + c < seq ? sm.s[r * LS + c] : -INFINITY;
        tmax = fmaxf(tmax, sv[j]);
      }
      const float mn = fmaxf(m[i], half_warp_max(tmax));  // finite: the tile has a key
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sv[j] - mn);  // 0 for a masked key
        ps += p;
        sm.p[r * LP + tx + 16 * j] = from_f<T>(p);
      }
      const float corr = expf(m[i] - mn);  // 0 on the first tile
      l[i] = l[i] * corr + half_warp_sum(ps);
      m[i] = mn;
      if (tx == 0) sm.corr[r] = corr;
    }
    __syncthreads();
    acc.scale_rows(sm.corr);
    acc.template mma<kFl, false, false>(sm.p, LP, sm.v, LD);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, t = q0 + r;
    if (tx == 0) {
      sm.inv_l[r] = 1.0f / l[i];
      if (lse && t < seq) lse[((long long)b * heads + h) * seq + t] = m[i] + logf(l[i]);
    }
  }
  __syncthreads();
  T* ob = out + sout.at(b, h);
  acc.for_each([&](int r, int c, float val) {
    const int t = q0 + r;
    if (t < seq) ob[(long long)t * sout.t + c] = from_f<T>(val * sm.inv_l[r]);
  });
}

// ---- bf16 on register-resident mma.sync tiles

// one block's work: the 64 query rows of tile blockIdx.x
template <int DH>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, View4 sin, bf16* __restrict__ out, View4 sout,
                     float* __restrict__ lse, int seq, int heads, float inv_sqrt_dh) {
  constexpr int LD = mma_ld(DH), kTile = kMmaRows * LD, kD = DH / 16;
  extern __shared__ __align__(128) unsigned char mma_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(mma_smem);  // [64][LD], then the output stage
  bf16* Ks = Qs + kTile;                          // 2 stages
  bf16* Vs = Ks + 2 * kTile;                      // 2 stages

  const int q0 = blockIdx.x * kMmaRows, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const long long base = sin.at(b, h);
  const bf16 *kb = k + base, *vb = v + base;
  const int nk = cdiv(seq, kMmaRows), row0 = q0 + 16 * warp;
  const bool live = row0 < seq;  // warp-uniform

  auto load = [&](int i) {  // key and value tile i into ring stage i & 1
    cp_rows<DH>(Ks + (i & 1) * kTile, kb, sin.t, i * kMmaRows, seq);
    cp_rows<DH>(Vs + (i & 1) * kTile, vb, sin.t, i * kMmaRows, seq);
  };
  cp_rows<DH>(Qs, q + base, sin.t, q0, seq);
  load(0);
  cp_async_commit();

  uint32_t qf[kD][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows g, g + 8
  float o[DH / 8][4];
  zero(o);
  for (int i = 0; i < nk; ++i) {
    if (i + 1 < nk) load(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    if (i == 0) scale_own_rows<DH>(Qs, round_to<bf16>(inv_sqrt_dh));
    __syncthreads();
    if (i == 0) {
#pragma unroll
      for (int kk = 0; kk < kD; ++kk) ldsm_a(qf[kk], Qs, LD, 16 * warp, 16 * kk);
    }
    if (live) {
      const int k0 = i * kMmaRows;
      float s[8][4];  // 16 rows x 64 keys: rows g, g + 8; keys 8j + 2c, + 1
      zero(s);
      mma_rows<DH, 8>(s, qf, Ks + (i & 1) * kTile, 0);
      if (k0 + kMmaRows > seq) {  // the last tile: keys past T score -inf
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int key = k0 + 8 * j + 2 * c;
          if (key >= seq) s[j][0] = s[j][2] = -INFINITY;
          if (key + 1 >= seq) s[j][1] = s[j][3] = -INFINITY;
        }
      }
      float corr[2], ps[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float tmax = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j) tmax = fmaxf(tmax, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
        const float mn = fmaxf(m[r], quad_max(tmax));  // finite: every tile has a key
        corr[r] = __expf(m[r] - mn);                   // 0 on the first tile
        m[r] = mn;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = __expf(s[j][e] - m[e >> 1]);  // 0 for a masked key
          ps[e >> 1] += s[j][e];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + quad_sum(ps[r]);
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        o[j][0] *= corr[0];
        o[j][1] *= corr[0];
        o[j][2] *= corr[1];
        o[j][3] *= corr[1];
      }
      const bf16* Vt = Vs + (i & 1) * kTile;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {  // round(p) of keys 16kk .. 16kk + 15 as an A fragment
        uint32_t pa[4];
        acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
        mma_cols<DH>(o, pa, Vt, 16 * kk);
      }
    }
    __syncthreads();  // stage i & 1 consumed before tile i + 2 refills it
  }
  if (live) {
    const float inv[2] = {1.0f / l[0], 1.0f / l[1]};
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      o[j][0] *= inv[0];
      o[j][1] *= inv[0];
      o[j][2] *= inv[1];
      o[j][3] *= inv[1];
    }
    store_rows16<DH>(o, 1.f, Qs + 16 * warp * LD, out + sout.at(b, h), sout.t, row0, seq);
    if (lse && c == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int t = row0 + g + 8 * r;
        if (t < seq) lse[((long long)b * heads + h) * seq + t] = m[r] + logf(l[r]);
      }
    }
  }
}

template <typename T, int DH>
cudaError_t launch_flash_fwd(const T* q, const T* k, const T* v, View4 sin, T* out, View4 sout,
                             float* lse, int batch, int heads, int seq, cudaStream_t stream) {
  const float inv_sqrt_dh = (float)(1.0 / sqrt((double)DH));  // as the host computes it
  if constexpr (std::is_same<T, bf16>::value) {
    constexpr size_t smem = mma_tiles_bytes<DH>(5);
    VT_TRY(set_smem(flash_fwd_mma_kernel<DH>, smem));
    flash_fwd_mma_kernel<DH><<<dim3(cdiv(seq, kMmaRows), heads, batch), kMmaThreads, smem,
                               stream>>>(q, k, v, sin, out, sout, lse, seq, heads, inv_sqrt_dh);
  } else {
    const size_t smem = FwdSmem<T, DH>::bytes();
    VT_TRY(set_smem(flash_fwd_kernel<T, DH>, smem));
    flash_fwd_kernel<T, DH><<<dim3(cdiv(seq, kFl), heads, batch), kFlThreads, smem, stream>>>(
        q, k, v, sin, out, sout, lse, seq, heads, inv_sqrt_dh);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t flash_fwd(const T* q, const T* k, const T* v, View4 sin, T* out, View4 sout,
                      float* lse, int batch, int heads, int seq, int head_dim,
                      cudaStream_t stream) {
  if (seq <= 0 || batch <= 0 || heads <= 0) return cudaSuccess;
  switch (head_dim) {
    case 16: return launch_flash_fwd<T, 16>(q, k, v, sin, out, sout, lse, batch, heads, seq, stream);
    case 32: return launch_flash_fwd<T, 32>(q, k, v, sin, out, sout, lse, batch, heads, seq, stream);
    case 64: return launch_flash_fwd<T, 64>(q, k, v, sin, out, sout, lse, batch, heads, seq, stream);
    case 80: return launch_flash_fwd<T, 80>(q, k, v, sin, out, sout, lse, batch, heads, seq, stream);
    case 128: return launch_flash_fwd<T, 128>(q, k, v, sin, out, sout, lse, batch, heads, seq, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace vt

extern "C" int vt_flash_fwd(const void* q, const void* k, const void* v, long long sb,
                            long long sh, long long st, void* out, long long ob, long long oh,
                            long long ot, void* lse, int batch, int heads, int seq,
                            int head_dim, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const vt::View4 sin{sb, sh, st}, sout{ob, oh, ot};
  cudaStream_t s = (cudaStream_t)stream;
#define VT_K13(T)                                                                          \
  vt::flash_fwd<T>((const T*)q, (const T*)k, (const T*)v, sin, (T*)out, sout, (float*)lse, \
                   batch, heads, seq, head_dim, s)
  if (dtype == vt::kFloat32) return (int)VT_K13(float);
  if (dtype == vt::kBFloat16) return (int)VT_K13(vt::bf16);
#undef VT_K13
  return (int)cudaErrorInvalidValue;
}
