// Warp-level int8 tensor-core tiles for Hopper (sm_90a) in inline PTX, for
// K19's attention (ln_qkv_attn_q8a.cu): mma.sync m16n8k32 with s8 operands
// and exact s32 accumulators, and ldmatrix fragments of int8 tiles
// addressed in bytes.  Beside mma_bf16.cuh (whose cp.async and ldmatrix
// wrappers it reuses) rather than inside it, so that the kernels including
// that header compile exactly as before.
//
// Fragment layouts of m16n8k32 .s8 (PTX ISA, "Matrix Fragments for
// mma.m16n8k32"), lane = 4 g + c, four int8 values to a register, the lowest
// column (or k) in the low byte:
//   A (16 x 32, row-major): a[0] = (g, 4c..4c+3), a[1] = (g + 8, 4c..4c+3),
//                           a[2] = (g, 16+4c..16+4c+3), a[3] = (g + 8, 16+4c..);
//   B (32 x 8, k x n):      b[0] = (4c..4c+3, g), b[1] = (16+4c..16+4c+3, g);
//   C (16 x 8, s32):        c[0..1] = (g, 2c..2c+1), c[2..3] = (g + 8, 2c..2c+1).
// In bytes, A and B are m16n8k16's bf16 fragments: ldmatrix (16-bit
// elements, not transposed) loads them from tiles whose rows hold the k axis
// contiguously — q codes (rows = queries), k codes (rows = keys) and v codes
// stored keys-contiguous (rows = dh columns).  ldmatrix.trans would swap byte
// pairs, so no int8 operand is read transposed.
//
// Unlike bf16, the C fragment of a score product is NOT the A fragment of
// the next product: a thread holds keys 2c, 2c+1 of each n8 tile, while A
// wants 4c..4c+3.  K19 reorders the key rows of its K tiles instead (the
// row permutation tile_key in ln_qkv_attn_q8a.cu), so that a thread's score
// columns already are the keys its A fragment of p needs.
#pragma once

#include "common.cuh"
#include "mma_bf16.cuh"

namespace vt {

// c += a b, one m16n8k32 step over int8 codes with exact int32 sums
__device__ __forceinline__ void mma16832_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                            uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 x 16-byte matrices of an int8 tile, lane l giving row l % 8's
// address of matrix l / 8
__device__ __forceinline__ void ldsm_x4_s8(uint32_t (&r)[4], const int8_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// A fragment of rows r0..r0+15, bytes k0..k0+31 of a row-major int8 tile
// with a pitch of `ld` bytes
__device__ __forceinline__ void ldsm_a_s8(uint32_t (&a)[4], const int8_t* tile, int ld, int r0,
                                         int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_s8(a, tile + (r0 + (lane & 15)) * ld + k0 + (lane >> 4) * 16);
}

// B fragments (b[0..1] of n8 tile n0, b[2..3] of n0 + 8) at bytes k0..k0+31
// of B = tileᵀ: the tile's rows are n, its bytes k
__device__ __forceinline__ void ldsm_b_s8(uint32_t (&b)[4], const int8_t* tile, int ld, int n0,
                                         int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_s8(b, tile + (n0 + (lane & 7) + (lane >> 4) * 8) * ld + k0 + ((lane >> 3) & 1) * 16);
}

// four codes in [-127, 127] as one register, the first in the low byte
__device__ __forceinline__ uint32_t pack_s8(int a, int b, int c, int d) {
  return (uint32_t)(a & 0xff) | (uint32_t)(b & 0xff) << 8 | (uint32_t)(c & 0xff) << 16 |
         (uint32_t)(d & 0xff) << 24;
}

template <int N>
__device__ __forceinline__ void zero(int (&c)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0;
}

}  // namespace vt
