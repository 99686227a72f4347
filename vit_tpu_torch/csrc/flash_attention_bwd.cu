// K14: blockwise flash-attention backward.  Replaces
// vit_tpu/ops/pallas/flash_attention.py:flash_attention_bwd
// (_flash_bwd_dkv_kernel, _flash_bwd_dq_kernel, _recompute_probs).
//
// Two kernels, as on the TPU, each owning its accumulators in one block and
// summing them in a fixed order (no atomics; two runs give the same bits):
//   dK/dV: one block per (image, head, 64-key tile), streaming 64-query
//          tiles: dV += round(p)^T dO, dK += round(dS)^T q_s;
//   dQ:    one block per (image, head, 64-query tile), streaming 64-key
//          tiles: dQ += round(dS) K, times 1/sqrt(dh) once at the flush.
// Both recompute per tile S = q_s K^T and dP = dO V^T, then p = exp(S -
// lse) and dS = p (dP - delta) in fp32 from the unrounded p (delta =
// rowsum(dO O), made by the caller); nothing of size (T, T) reaches device
// memory.  Query rows past T load zeros and take lse = delta = 0, keys past
// T load zeros, and p is 0 wherever the row or the key is past T, so a
// padded row's value never reaches an accumulator.  The rounding points are
// the TPU kernel's: q_s = round(q round(1/sqrt(dh))), round(p) and round(dS)
// before their products, gradients rounded once to the dtype.
//
// What bounds it on the H100: the tensor cores (ViT-B/16 @512 batch 16:
// five products, 129 GFLOP; the two-kernel form runs seven, 181).
//
// bf16 (the main path) keeps the score-shaped tiles and the accumulators
// in registers: its two kernels instantiate flash_bwd_mma.cuh's bodies
// (shared with K6) with both hooks off.  fp32 keeps the SIMT TileAcc path
// of flash.cuh (FMA, never TF32).
#include "flash.cuh"
#include "flash_bwd_mma.cuh"
#include "mma_bf16.cuh"

#include <type_traits>

namespace vt {

// ---- fp32 on flash.cuh's SIMT tiles (TileAcc), the two kernels below
// instantiated for T = float only

template <typename T, int DH>
struct BwdSmem {
  T *q, *dout, *k, *v, *p, *ds;
  float *s, *dp, *lse, *delta;

  // fp32 tiles are SIMT: p and ds overwrite s and dp in place (each
  // element read, then written, by the same thread)
  __host__ __device__ static BwdSmem carve(SmemCarve& c) {
    static_assert(std::is_same<T, float>::value, "bf16 runs the mma.sync kernels");
    constexpr int LD = fl_ld(DH), LS = fl_ld(kFl);
    BwdSmem m;
    m.q = c.take<T>(kFl * LD);
    m.dout = c.take<T>(kFl * LD);
    m.k = c.take<T>(kFl * LD);
    m.v = c.take<T>(kFl * LD);
    m.s = c.take<float>(kFl * LS);
    m.dp = c.take<float>(kFl * LS);
    m.p = (T*)m.s;
    m.ds = (T*)m.dp;
    m.lse = c.take<float>(kFl);
    m.delta = c.take<float>(kFl);
    return m;
  }

  static size_t bytes() {
    SmemCarve c{nullptr};
    carve(c);
    return c.off;
  }
};

// the query tile: q_s, dO, and its rows' lse and delta (0 past T)
template <typename T, int DH>
__device__ __forceinline__ void load_query_tile(const BwdSmem<T, DH>& sm, const T* qb,
                                                const T* dob, const float* lse,
                                                const float* delta, long long row_base,
                                                int q0, const BwdArgs& a) {
  constexpr int LD = fl_ld(DH);
  load_rows<T, DH, true>(qb, a.sin.t, q0, a.seq, sm.q, LD, round_to<T>(a.inv_sqrt_dh));
  load_rows<T, DH>(dob, a.sdo.t, q0, a.seq, sm.dout, LD);
  for (int r = threadIdx.x; r < kFl; r += kFlThreads) {
    const bool ok = q0 + r < a.seq;
    sm.lse[r] = ok ? lse[row_base + q0 + r] : 0.f;
    sm.delta[r] = ok ? delta[row_base + q0 + r] : 0.f;
  }
}

// S = q_s K^T and dP = dO V^T into shared memory, then round(p) (when kP)
// and round(dS) in place of them; the tiles must be loaded and synced
template <typename T, int DH, bool kP>
__device__ __forceinline__ void probs_and_dscores(const BwdSmem<T, DH>& sm, int q0, int k0,
                                                  int seq) {
  constexpr int LD = fl_ld(DH), LP = fl_ld(kFl), LS = fl_ld(kFl);
  {
    TileAcc<T, kFl> s;
    s.zero();
    s.template mma<DH, false, true>(sm.q, LD, sm.k, LD);
    store_tile(s, sm.s, LS);
    TileAcc<T, kFl> dp;
    dp.zero();
    dp.template mma<DH, false, true>(sm.dout, LD, sm.v, LD);
    store_tile(dp, sm.dp, LS);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kFl * kFl; i += kFlThreads) {
    const int r = i / kFl, c = i % kFl;
    const bool ok = q0 + r < seq && k0 + c < seq;
    const float p = ok ? expf(sm.s[r * LS + c] - sm.lse[r]) : 0.f;
    const float ds = p * (sm.dp[r * LS + c] - sm.delta[r]);
    if constexpr (kP) sm.p[r * LP + c] = from_f<T>(p);
    sm.ds[r * LP + c] = from_f<T>(ds);
  }
  __syncthreads();
}

template <typename T, int DH>
__global__ void __launch_bounds__(kFlThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     BwdArgs a) {
  extern __shared__ __align__(128) unsigned char fl_smem[];
  SmemCarve carver{fl_smem};
  const BwdSmem<T, DH> sm = BwdSmem<T, DH>::carve(carver);
  constexpr int LD = fl_ld(DH), LP = fl_ld(kFl);

  const int k0 = blockIdx.x * kFl, h = blockIdx.y, b = blockIdx.z;
  const long long base = a.sin.at(b, h), row_base = ((long long)b * a.heads + h) * a.seq;
  load_rows<T, DH>(k + base, a.sin.t, k0, a.seq, sm.k, LD);
  load_rows<T, DH>(v + base, a.sin.t, k0, a.seq, sm.v, LD);

  TileAcc<T, DH> dka, dva;
  dka.zero();
  dva.zero();
  for (int q0 = 0; q0 < a.seq; q0 += kFl) {
    __syncthreads();  // the previous query tile's operands consumed
    load_query_tile(sm, q + base, dout + a.sdo.at(b, h), lse, delta, row_base, q0, a);
    __syncthreads();
    probs_and_dscores<T, DH, true>(sm, q0, k0, a.seq);
    dva.template mma<kFl, true, false>(sm.p, LP, sm.dout, LD);  // round(p)^T dO
    dka.template mma<kFl, true, false>(sm.ds, LP, sm.q, LD);    // round(dS)^T q_s
  }

  const long long gbase = a.sgrad.at(b, h);
  T *dkb = dk + gbase, *dvb = dv + gbase;
  const long long st = a.sgrad.t;
  const int seq = a.seq;
  dka.for_each([&](int r, int c, float val) {
    if (k0 + r < seq) dkb[(long long)(k0 + r) * st + c] = from_f<T>(val);
  });
  dva.for_each([&](int r, int c, float val) {
    if (k0 + r < seq) dvb[(long long)(k0 + r) * st + c] = from_f<T>(val);
  });
}

template <typename T, int DH>
__global__ void __launch_bounds__(kFlThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, BwdArgs a) {
  extern __shared__ __align__(128) unsigned char fl_smem[];
  SmemCarve carver{fl_smem};
  const BwdSmem<T, DH> sm = BwdSmem<T, DH>::carve(carver);
  constexpr int LD = fl_ld(DH), LP = fl_ld(kFl);

  const int q0 = blockIdx.x * kFl, h = blockIdx.y, b = blockIdx.z;
  const long long base = a.sin.at(b, h), row_base = ((long long)b * a.heads + h) * a.seq;
  load_query_tile(sm, q + base, dout + a.sdo.at(b, h), lse, delta, row_base, q0, a);

  TileAcc<T, DH> dqa;
  dqa.zero();
  for (int k0 = 0; k0 < a.seq; k0 += kFl) {
    __syncthreads();  // the previous key tile consumed
    load_rows<T, DH>(k + base, a.sin.t, k0, a.seq, sm.k, LD);
    load_rows<T, DH>(v + base, a.sin.t, k0, a.seq, sm.v, LD);
    __syncthreads();
    probs_and_dscores<T, DH, false>(sm, q0, k0, a.seq);
    dqa.template mma<kFl, false, false>(sm.ds, LP, sm.k, LD);  // round(dS) K
  }

  T* dqb = dq + a.sgrad.at(b, h);
  const long long st = a.sgrad.t;
  const int seq = a.seq;
  const float scale = a.inv_sqrt_dh;
  dqa.for_each([&](int r, int c, float val) {
    if (q0 + r < seq) dqb[(long long)(q0 + r) * st + c] = from_f<T>(val * scale);
  });
}

// ---- bf16 on register-resident mma.sync tiles (flash_bwd_mma.cuh's bodies)

template <int DH>
__global__ void __launch_bounds__(kMmaThreads, dkv_min_blocks<DH>())
flash_bwd_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, BwdArgs a) {
  flash_bwd_dkv_mma_body<DH, false, false>(q, k, v, dout, lse, delta, dk, dv, a, nullptr, nullptr,
                                           nullptr);
}

template <int DH>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        bf16* __restrict__ dq, BwdArgs a) {
  flash_bwd_dq_mma_body<DH, false, false>(q, k, v, dout, lse, delta, dq, a, nullptr, nullptr);
}

template <int DH>
cudaError_t launch_flash_bwd_mma(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                                 const float* lse, const float* delta, bf16* dq, bf16* dk,
                                 bf16* dv, BwdArgs a, int batch, cudaStream_t stream) {
  constexpr size_t smem_dkv = dkv_mma_smem_bytes<DH>(), smem_dq = dq_mma_smem_bytes<DH>();
  VT_TRY(set_smem(flash_bwd_dkv_mma_kernel<DH>, smem_dkv));
  VT_TRY(set_smem(flash_bwd_dq_mma_kernel<DH>, smem_dq));
  const dim3 grid(cdiv(a.seq, kMmaRows), a.heads, batch);
  flash_bwd_dkv_mma_kernel<DH><<<grid, kMmaThreads, smem_dkv, stream>>>(q, k, v, dout, lse, delta,
                                                                       dk, dv, a);
  VT_TRY(cudaGetLastError());
  flash_bwd_dq_mma_kernel<DH><<<grid, kMmaThreads, smem_dq, stream>>>(q, k, v, dout, lse, delta,
                                                                     dq, a);
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t launch_flash_bwd(const T* q, const T* k, const T* v, const T* dout,
                             const float* lse, const float* delta, T* dq, T* dk, T* dv,
                             BwdArgs a, int batch, cudaStream_t stream) {
  const size_t smem = BwdSmem<T, DH>::bytes();
  VT_TRY(set_smem(flash_bwd_dkv_kernel<T, DH>, smem));
  VT_TRY(set_smem(flash_bwd_dq_kernel<T, DH>, smem));
  const dim3 grid(cdiv(a.seq, kFl), a.heads, batch);
  flash_bwd_dkv_kernel<T, DH><<<grid, kFlThreads, smem, stream>>>(q, k, v, dout, lse, delta, dk,
                                                                   dv, a);
  VT_TRY(cudaGetLastError());
  flash_bwd_dq_kernel<T, DH><<<grid, kFlThreads, smem, stream>>>(q, k, v, dout, lse, delta, dq, a);
  return cudaGetLastError();
}

// bf16 on the mma.sync tiles, fp32 on TileAcc's SIMT path
template <typename T, int DH>
cudaError_t launch_flash_bwd_dtype(const T* q, const T* k, const T* v, const T* dout,
                                   const float* lse, const float* delta, T* dq, T* dk, T* dv,
                                   BwdArgs a, int batch, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value)
    return launch_flash_bwd_mma<DH>(q, k, v, dout, lse, delta, dq, dk, dv, a, batch, stream);
  else
    return launch_flash_bwd<T, DH>(q, k, v, dout, lse, delta, dq, dk, dv, a, batch, stream);
}

template <typename T>
cudaError_t flash_bwd(const T* q, const T* k, const T* v, const T* dout, const float* lse,
                      const float* delta, T* dq, T* dk, T* dv, BwdArgs a, int batch,
                      int head_dim, cudaStream_t stream) {
  if (a.seq <= 0 || batch <= 0 || a.heads <= 0) return cudaSuccess;
  a.inv_sqrt_dh = (float)(1.0 / sqrt((double)head_dim));  // as the host computes it
#define VT_K14(DH) launch_flash_bwd_dtype<T, DH>(q, k, v, dout, lse, delta, dq, dk, dv, a, batch, \
                                                stream)
  switch (head_dim) {
    case 16: return VT_K14(16);
    case 32: return VT_K14(32);
    case 64: return VT_K14(64);
    case 80: return VT_K14(80);
    case 128: return VT_K14(128);
    default: return cudaErrorInvalidValue;
  }
#undef VT_K14
}

}  // namespace vt

extern "C" int vt_flash_bwd(const void* q, const void* k, const void* v, long long sb,
                            long long sh, long long st, const void* dout, long long db,
                            long long dh, long long dt, const void* lse, const void* delta,
                            void* dq, void* dk, void* dv, long long gb, long long gh,
                            long long gt, int batch, int heads, int seq, int head_dim, int dtype,
                            int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const vt::BwdArgs a{{sb, sh, st}, {db, dh, dt}, {gb, gh, gt}, seq, heads, 0.f};
  cudaStream_t s = (cudaStream_t)stream;
#define VT_K14(T)                                                                          \
  vt::flash_bwd<T>((const T*)q, (const T*)k, (const T*)v, (const T*)dout, (const float*)lse, \
                   (const float*)delta, (T*)dq, (T*)dk, (T*)dv, a, batch, head_dim, s)
  if (dtype == vt::kFloat32) return (int)VT_K14(float);
  if (dtype == vt::kBFloat16) return (int)VT_K14(vt::bf16);
#undef VT_K14
  return (int)cudaErrorInvalidValue;
}
