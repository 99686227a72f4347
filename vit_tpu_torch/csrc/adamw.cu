// K20: the in-place AdamW update of many parameter leaves in one launch.
// Replaces vit_tpu/ops/pallas/adamw_kernel.py:_leaf_update (_adamw_kernel),
// optax.adamw's math (scale_by_adam with eps_root = 0, decoupled weight
// decay, scale by -lr):
//   m = b1 m + (1 - b1) g            v = b2 v + (1 - b2) g^2
//   p = p - lr ((m bc1) / (sqrt(v bc2) + eps) + wd p)
// with bc = 1 / (1 - b^t) at the 1-based step t, computed on the host in
// fp32 like lr.  g and p are fp32 or bf16 and computed in fp32; m and v are
// fp32; p is written back in its own dtype.
//
// Bound on the H100 by device memory: each element reads g, p, m, v and
// writes p, m, v once (28 bytes per fp32 element; ViT-B/16's 86.6 M
// parameters move 2.42 GB a step, 0.724 ms at 3.35 TB/s), which is the
// floor the TPU kernel's input_output_aliases reach too.  The TPU kernel
// runs one pallas_call per leaf, and sends leaves under 2^15 elements or
// not divisible by its 128 lanes to jnp.  Here one launch takes a table of
// up to kAdamWLeaves leaves of one (p, g) dtype pair, passed by value in
// the kernel's parameters: ViT-B/16's 20 leaves are one launch, with one
// host call and one tail wave for the step.  Each block owns kAdamWChunk
// elements of one leaf, found from the table's per-leaf prefix sums of
// blocks; a leaf whose four pointers are 16-byte aligned moves 4 elements
// per load (its n % 4 tail element by element), any other leaf one element
// per load.
#include "common.cuh"

#include <limits.h>
#include <string.h>

namespace vt {

constexpr int kAdamWLeaves = 48;  // leaves per launch: ~2.2 KB of the 4 KB of parameters
constexpr int kAdamWThreads = 256;
constexpr int kAdamWVecs = 4;  // 4-element vectors per thread, all loaded before any update
constexpr int kAdamWChunk = kAdamWThreads * 4 * kAdamWVecs;  // elements per block

struct AdamWArgs {
  float lr, b1, omb1, b2, omb2, eps, wd, bc1, bc2;  // omb = 1 - b, rounded from double
};

struct AdamWTable {
  const void* g[kAdamWLeaves];
  void* p[kAdamWLeaves];
  float* m[kAdamWLeaves];
  float* v[kAdamWLeaves];
  long long n[kAdamWLeaves];
  int block0[kAdamWLeaves + 1];  // leaf i owns blocks block0[i] .. block0[i + 1] - 1
  unsigned long long aligned;    // bit i: leaf i's g, p, m, v start on 16 bytes
  int leaves;
};

__device__ __forceinline__ void adamw_elem(float g, float& p, float& m, float& v,
                                           const AdamWArgs& a) {
  m = a.b1 * m + a.omb1 * g;
  v = a.b2 * v + a.omb2 * (g * g);
  const float upd = (m * a.bc1) / (sqrtf(v * a.bc2) + a.eps) + a.wd * p;
  p = p - a.lr * upd;
}

template <typename TP, typename TG>
__device__ __forceinline__ void adamw_at(const TG* __restrict__ g, TP* __restrict__ p,
                                         float* __restrict__ m, float* __restrict__ v,
                                         long long i, const AdamWArgs& a) {
  float pi = to_f(p[i]), mi = m[i], vi = v[i];
  adamw_elem(to_f(g[i]), pi, mi, vi, a);
  p[i] = from_f<TP>(pi);
  m[i] = mi;
  v[i] = vi;
}

// 4 consecutive elements, 16 (fp32) or 8 (bf16) bytes
__device__ __forceinline__ void ld4(const float* x, float (&f)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(x);
  f[0] = u.x;
  f[1] = u.y;
  f[2] = u.z;
  f[3] = u.w;
}

__device__ __forceinline__ void ld4(const bf16* x, float (&f)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(x);
  __nv_bfloat162 h[2];
  memcpy(h, &u, sizeof(u));
  const float2 lo = __bfloat1622float2(h[0]), hi = __bfloat1622float2(h[1]);
  f[0] = lo.x;
  f[1] = lo.y;
  f[2] = hi.x;
  f[3] = hi.y;
}

__device__ __forceinline__ void st4(float* x, const float (&f)[4]) {
  *reinterpret_cast<float4*>(x) = make_float4(f[0], f[1], f[2], f[3]);
}

// rounded to nearest even, as from_f<bf16>
__device__ __forceinline__ void st4(bf16* x, const float (&f)[4]) {
  const __nv_bfloat162 h[2] = {__floats2bfloat162_rn(f[0], f[1]),
                               __floats2bfloat162_rn(f[2], f[3])};
  uint2 u;
  memcpy(&u, h, sizeof(u));
  *reinterpret_cast<uint2*>(x) = u;
}

template <typename TP, typename TG>
__global__ void __launch_bounds__(kAdamWThreads)
adamw_table_kernel(const AdamWTable t, const AdamWArgs a) {
  const int blk = blockIdx.x;
  int leaf = 0, hi = t.leaves - 1;  // the last leaf whose first block is at or before blk
  while (leaf < hi) {
    const int mid = (leaf + hi + 1) >> 1;
    if (t.block0[mid] <= blk) leaf = mid;
    else hi = mid - 1;
  }
  const TG* __restrict__ g = (const TG*)t.g[leaf];
  TP* __restrict__ p = (TP*)t.p[leaf];
  float* __restrict__ m = t.m[leaf];
  float* __restrict__ v = t.v[leaf];
  const long long start = (long long)(blk - t.block0[leaf]) * kAdamWChunk;
  const long long end = min(start + kAdamWChunk, t.n[leaf]);
  if (!((t.aligned >> leaf) & 1)) {
    for (long long i = start + threadIdx.x; i < end; i += kAdamWThreads) adamw_at(g, p, m, v, i, a);
    return;
  }
  float gv[kAdamWVecs][4], pv[kAdamWVecs][4], mv[kAdamWVecs][4], vv[kAdamWVecs][4];
#pragma unroll
  for (int it = 0; it < kAdamWVecs; ++it) {
    const long long i = start + 4 * (it * kAdamWThreads + threadIdx.x);
    if (i + 4 <= end) {
      ld4(g + i, gv[it]);
      ld4(p + i, pv[it]);
      ld4(m + i, mv[it]);
      ld4(v + i, vv[it]);
    }
  }
#pragma unroll
  for (int it = 0; it < kAdamWVecs; ++it) {
    const long long i = start + 4 * (it * kAdamWThreads + threadIdx.x);
    if (i + 4 <= end) {
#pragma unroll
      for (int e = 0; e < 4; ++e) adamw_elem(gv[it][e], pv[it][e], mv[it][e], vv[it][e], a);
      st4(p + i, pv[it]);
      st4(m + i, mv[it]);
      st4(v + i, vv[it]);
    } else {
      for (long long j = i; j < end; ++j) adamw_at(g, p, m, v, j, a);  // the n % 4 tail
    }
  }
}

template <typename TP, typename TG>
cudaError_t adamw(const AdamWTable& t, AdamWArgs a, cudaStream_t stream) {
  const int blocks = t.block0[t.leaves];
  if (blocks == 0) return cudaSuccess;
  adamw_table_kernel<TP, TG><<<blocks, kAdamWThreads, 0, stream>>>(t, a);
  return cudaGetLastError();
}

}  // namespace vt

// One launch over `leaves` leaves (at most vt::kAdamWLeaves) of one (p, g)
// dtype pair: g[i], p[i], m[i], v[i] hold n[i] elements; aligned[i] != 0
// says the four start on 16 bytes.
extern "C" int vt_adamw(const void* const* g, void* const* p, void* const* m, void* const* v,
                        const long long* n, const int* aligned, int leaves, float lr, float b1,
                        float omb1, float b2, float omb2, float eps, float wd, float bc1,
                        float bc2, int p_dtype, int g_dtype, int device, void* stream) {
  if (leaves < 0 || leaves > vt::kAdamWLeaves) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  vt::AdamWTable t;
  memset(&t, 0, sizeof(t));
  long long blocks = 0;
  for (int i = 0; i < leaves; ++i) {
    t.g[i] = g[i];
    t.p[i] = p[i];
    t.m[i] = (float*)m[i];
    t.v[i] = (float*)v[i];
    t.n[i] = n[i];
    t.block0[i] = (int)blocks;
    blocks += (n[i] + vt::kAdamWChunk - 1) / vt::kAdamWChunk;
    if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
    if (aligned[i]) t.aligned |= 1ull << i;
  }
  t.block0[leaves] = (int)blocks;
  t.leaves = leaves;
  const vt::AdamWArgs a{lr, b1, omb1, b2, omb2, eps, wd, bc1, bc2};
  cudaStream_t s = (cudaStream_t)stream;
  using vt::bf16;
  if (p_dtype == vt::kFloat32 && g_dtype == vt::kFloat32) return (int)vt::adamw<float, float>(t, a, s);
  if (p_dtype == vt::kFloat32 && g_dtype == vt::kBFloat16) return (int)vt::adamw<float, bf16>(t, a, s);
  if (p_dtype == vt::kBFloat16 && g_dtype == vt::kFloat32) return (int)vt::adamw<bf16, float>(t, a, s);
  if (p_dtype == vt::kBFloat16 && g_dtype == vt::kBFloat16) return (int)vt::adamw<bf16, bf16>(t, a, s);
  return (int)cudaErrorInvalidValue;
}
