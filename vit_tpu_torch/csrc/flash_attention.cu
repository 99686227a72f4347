// K13: blockwise flash-attention forward (online softmax), with the fp32
// per-row logsumexp for the backward.  Replaces
// vit_tpu/ops/pallas/flash_attention.py:_flash_forward (_flash_kernel).
//
// The TPU kernel walks (bh, q block, k block) in order, carrying the
// running max, sum and output accumulator in VMEM scratch across the k
// steps.  Here one block owns (image, head, 64-query tile) and loops over
// 64-key tiles itself (flash.cuh): S = q_s K^T into fp32 shared memory; per
// query row the running max m, p = exp(s - m) (fp32), the correction
// exp(m_old - m) and the running sum l; p rounded to the dtype into shared
// memory; the accumulator rescaled by the correction, then += round(p) V.
// At the end out = acc * (1/l), rounded, and lse = m + log(l).  q_s = round(q
// round(1/sqrt(dh))), as the TPU kernel scales q in its working dtype.
//
// q, k and v are (batch, head, token, dh) views with their own base and
// shared strides, so the packed (B*T, 3D) QKV is read in place, and the
// output view writes the context straight into (B*T, D).  Keys past T load
// zeros and score -inf; query rows past T are never written.  Every key
// tile holds a valid key, so the row max is finite before any exp.
#include "flash.cuh"

namespace vt {

template <typename T, int DH>
struct FwdSmem {
  T *q, *k, *v, *p;
  float *s, *corr, *inv_l, *scratch;

  __host__ __device__ static FwdSmem carve(SmemCarve& c) {
    constexpr int LD = FlTile<T>::ld(DH), LP = FlTile<T>::ld(kFl), LS = FlTile<T>::ldf(kFl);
    FwdSmem m;
    m.q = c.take<T>(kFl * LD);
    m.k = c.take<T>(kFl * LD);
    m.v = c.take<T>(kFl * LD);
    m.p = c.take<T>(kFl * LP);
    m.s = c.take<float>(kFl * LS);
    m.corr = c.take<float>(kFl);
    m.inv_l = c.take<float>(kFl);
    m.scratch = c.take<float>(kFlWarps * 256);
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
  constexpr int LD = FlTile<T>::ld(DH), LP = FlTile<T>::ld(kFl), LS = FlTile<T>::ldf(kFl);

  const int q0 = blockIdx.x * kFl, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  float* scratch = sm.scratch + (tid >> 5) * 256;
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
    store_tile(s, sm.s, LS, scratch);
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
    acc.scale_rows(sm.corr, scratch);
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
  acc.for_each(scratch, [&](int r, int c, float val) {
    const int t = q0 + r;
    if (t < seq) ob[(long long)t * sout.t + c] = from_f<T>(val * sm.inv_l[r]);
  });
}

template <typename T, int DH>
cudaError_t launch_flash_fwd(const T* q, const T* k, const T* v, View4 sin, T* out, View4 sout,
                             float* lse, int batch, int heads, int seq, cudaStream_t stream) {
  const size_t smem = FwdSmem<T, DH>::bytes();
  VT_TRY(set_smem(flash_fwd_kernel<T, DH>, smem));
  const float inv_sqrt_dh = (float)(1.0 / sqrt((double)DH));  // as the host computes it
  flash_fwd_kernel<T, DH><<<dim3(cdiv(seq, kFl), heads, batch), kFlThreads, smem, stream>>>(
      q, k, v, sin, out, sout, lse, seq, heads, inv_sqrt_dh);
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
