// Warp-level bf16 tensor-core tiles for Hopper (sm_90a) in inline PTX,
// shared by K21 (scaled_dot_product_attention.cu), K13
// (flash_attention.cu), K14 and K6's attention backward
// (flash_bwd_mma.cuh): mma.sync
// m16n8k16 with fp32 accumulators, ldmatrix (plain and .trans) from padded
// shared-memory tiles, 16-byte cp.async copies in commit/wait groups, the
// accumulator-to-A-fragment repack, quad reductions, and 16-byte stores of
// a warp's 16 output rows.
//
// Fragment layouts of m16n8k16 (PTX ISA, "Matrix Fragments for
// mma.m16n8k16"), lane = 4 g + c:
//   A (16 x 16, row-major): a[0] = (g, 2c..2c+1), a[1] = (g + 8, 2c..2c+1),
//                           a[2] = (g, 2c+8..2c+9), a[3] = (g + 8, 2c+8..2c+9);
//   B (16 x 8, k x n):      b[0] = (2c..2c+1, g), b[1] = (2c+8..2c+9, g);
//   C (16 x 8, fp32):       c[0..1] = (g, 2c..2c+1), c[2..3] = (g + 8, 2c..2c+1),
// two bf16 to a register, the lower column in the low half.  So the C
// fragments of two adjacent n8 tiles, each rounded to bf16 and paired, are
// the A fragment of one k16 step of the next product (acc_to_a): p and dS
// go from a score product into the next product without shared memory.
// The four lanes of a quad (lane xor 1, 2) hold one row between them.
//
// Tiles are 64 rows (4 warps x 16) of C bf16 columns at a pitch of C + 8
// elements: every row starts 16-byte aligned (cp.async, 16-byte loads), and
// the 8 rows one ldmatrix phase reads fall in disjoint bank groups for
// C = 16, 32, 64, 80 and 128.
#pragma once

#include "common.cuh"

#include <string.h>

namespace vt {

constexpr int kMmaRows = 64, kMmaWarps = 4, kMmaThreads = 32 * kMmaWarps;

__host__ __device__ constexpr int mma_ld(int cols) { return cols + 8; }

// bytes of `n` [64][mma_ld(DH)] bf16 tiles
template <int DH>
__host__ __device__ constexpr size_t mma_tiles_bytes(int n) {
  return (size_t)n * kMmaRows * mma_ld(DH) * sizeof(bf16);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from device memory into shared memory; 16 zero bytes when !ok
// (src-size 0 reads nothing; the caller still passes a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// 4 bytes, zero when !ok
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight; the
// finished copies are then visible to this thread (to the block after a
// __syncthreads)
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// c += a b, one m16n8k16 step
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two fp32 rounded to bf16 (nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  uint32_t u;
  memcpy(&u, &v, 4);
  return u;
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  __nv_bfloat162 v;
  memcpy(&v, &u, 4);
  return __bfloat1622float2(v);
}

// the A fragment of one k16 step from the C fragments of n8 tiles 2kk and
// 2kk + 1, each value rounded to bf16
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// A fragment of rows r0..r0+15, columns k0..k0+15 of a row-major tile
__device__ __forceinline__ void ldsm_a(uint32_t (&a)[4], const bf16* tile, int ld, int r0,
                                      int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(a, tile + (r0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
}

// B fragments (b[0..1] of n8 tile n0, b[2..3] of n0 + 8) at k0..k0+15 of
// B = tileᵀ: the tile's rows are n, its columns k (K rows for q Kᵀ)
__device__ __forceinline__ void ldsm_b_rows(uint32_t (&b)[4], const bf16* tile, int ld, int n0,
                                           int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(b, tile + (n0 + (lane & 7) + (lane >> 4) * 8) * ld + k0 + ((lane >> 3) & 1) * 8);
}

// the same for B = tile: its rows are k, its columns n (V rows for p V),
// read transposed
__device__ __forceinline__ void ldsm_b_cols(uint32_t (&b)[4], const bf16* tile, int ld, int k0,
                                           int n0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_trans(b, tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 + (lane >> 4) * 8);
}

// c[j] (+)= a · tileᵀ for the NT n8 tiles of rows n0.. of `tile` (the
// rows' DH columns are the k axis); a holds DH / 16 A fragments
template <int DH, int NT>
__device__ __forceinline__ void mma_rows(float (&c)[NT][4], const uint32_t (&a)[DH / 16][4],
                                         const bf16* tile, int n0) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
    for (int jj = 0; jj < NT / 2; ++jj) {
      uint32_t b[4];
      ldsm_b_rows(b, tile, mma_ld(DH), n0 + 16 * jj, 16 * kk);
      mma16816(c[2 * jj], a[kk], b[0], b[1]);
      mma16816(c[2 * jj + 1], a[kk], b[2], b[3]);
    }
}

// c (+)= a · tile[k0 .. k0+15][0 .. DH): one k16 step into DH / 8 n8 tiles
template <int DH>
__device__ __forceinline__ void mma_cols(float (&c)[DH / 8][4], const uint32_t (&a)[4],
                                         const bf16* tile, int k0) {
#pragma unroll
  for (int jj = 0; jj < DH / 16; ++jj) {
    uint32_t b[4];
    ldsm_b_cols(b, tile, mma_ld(DH), k0, 16 * jj);
    mma16816(c[2 * jj], a, b[0], b[1]);
    mma16816(c[2 * jj + 1], a, b[2], b[3]);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&c)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
}

// rows row0 .. row0+63 of a (token, dh) slab with row pitch `st` elements
// into a [64][mma_ld(DH)] tile by 16-byte cp.async; rows at or past `seq`
// are zero-filled.  Thread tid copies chunks tid, tid + 128, ...
template <int DH>
__device__ __forceinline__ void cp_rows(bf16* tile, const bf16* __restrict__ x, long long st,
                                        int row0, int seq) {
  constexpr int kC = DH / 8;  // 16-byte chunks per row
#pragma unroll
  for (int i = threadIdx.x; i < kMmaRows * kC; i += kMmaThreads) {
    const int r = i / kC, c = (i % kC) * 8, t = row0 + r;
    const bool ok = t < seq;
    cp_async16(tile + r * mma_ld(DH) + c, ok ? x + (long long)t * st + c : x, ok);
  }
}

// this thread's chunks of cp_rows (after its wait) times `scale`, rounded
// to bf16 in place: q_s = round(q · round(1/sqrt(dh)))
template <int DH>
__device__ __forceinline__ void scale_own_rows(bf16* tile, float scale) {
  constexpr int kC = DH / 8;
#pragma unroll
  for (int i = threadIdx.x; i < kMmaRows * kC; i += kMmaThreads) {
    uint4* p = reinterpret_cast<uint4*>(tile + (i / kC) * mma_ld(DH) + (i % kC) * 8);
    uint4 v = *p;
    uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = unpack_bf16(w[e]);
      w[e] = pack_bf16(f.x * scale, f.y * scale);
    }
    *p = v;
  }
}

// A warp's 16 x DH fp32 accumulator times `scale`, rounded to bf16 once,
// written to rows row0 .. row0+15 (those below `seq`) of a (token, dh)
// slab with pitch `st`, in 16-byte stores: staged through the warp's own
// 16 x mma_ld(DH) shared-memory rows `stage`
template <int DH>
__device__ __forceinline__ void store_rows16(const float (&acc)[DH / 8][4], float scale,
                                             bf16* stage, bf16* __restrict__ out, long long st,
                                             int row0, int seq) {
  constexpr int LD = mma_ld(DH), kC = DH / 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    *reinterpret_cast<uint32_t*>(stage + g * LD + 8 * j + 2 * c) =
        pack_bf16(acc[j][0] * scale, acc[j][1] * scale);
    *reinterpret_cast<uint32_t*>(stage + (g + 8) * LD + 8 * j + 2 * c) =
        pack_bf16(acc[j][2] * scale, acc[j][3] * scale);
  }
  __syncwarp();
#pragma unroll
  for (int i = lane; i < 16 * kC; i += 32) {
    const int r = i / kC, cc = (i % kC) * 8;
    if (row0 + r < seq)
      *reinterpret_cast<uint4*>(out + (long long)(row0 + r) * st + cc) =
          *reinterpret_cast<const uint4*>(stage + r * LD + cc);
  }
}

}  // namespace vt
