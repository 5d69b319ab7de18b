// The tensor-core product of the bf16 fGN-input forms (K1/K2 in
// csrc/fgn_tile.cuh; K6/K7 and the P1 matmul probe in
// csrc/slab_tile.cuh; K8/K9's stage 1 in csrc/pathgen_factored.cu):
// mma.sync.aligned.m16n8k16 with bf16 inputs and float32 sums
// (counterpart: jnp.dot(x.astype(bf16), m_bf16,
// preferred_element_type=float32) of pathgen_pallas.py:_fgn_x:142).
//
// Fragments are read from shared memory with 32-bit loads, two bf16 of one
// row (A) or one column (B) along k at a time, so A is stored row-major
// ([row][k], k contiguous) and B column by column ([col][k]).  With a row
// stride of 4 (mod 8) words the eight rows (columns) of a fragment fall on
// distinct 4-bank groups, and the four k pairs of each fill the group, so a
// warp's fragment read touches 32 distinct banks.
//
// Lane l of a warp, g = l / 4 and t = l % 4 (PTX ISA, "Matrix Fragments for
// mma.m16n8k16"):
//   A (16 x 16): a0 (row g, k 2t..2t+1), a1 (row g+8, same k),
//                a2 (row g, k 2t+8..2t+9), a3 (row g+8, k 2t+8..2t+9);
//   B (16 x 8):  b0 (k 2t..2t+1, column g), b1 (k 2t+8..2t+9, column g);
//   C (16 x 8):  c0, c1 (row g, columns 2t, 2t+1), c2, c3 (row g+8, same).
// The lower k (or column) of each pair sits in the low 16 bits.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mcop {

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t bf16_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment of the 16 x 16 tile at (r0, k0) of a row-major bf16 matrix of
// row stride ld (ld and k0 even).
__device__ __forceinline__ void load_a_frag(const __nv_bfloat16* a, int ld,
                                            int r0, int k0,
                                            uint32_t (&f)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* p = a + (r0 + g) * ld + k0 + 2 * t;
  f[0] = bf16_pair(p);
  f[1] = bf16_pair(p + 8 * ld);
  f[2] = bf16_pair(p + 8);
  f[3] = bf16_pair(p + 8 * ld + 8);
}

// B fragment of the 16 x 8 tile at (k0, c0) of a bf16 matrix stored column
// by column: bt[c * ld + k] (ld and k0 even).
__device__ __forceinline__ void load_b_frag(const __nv_bfloat16* bt, int ld,
                                            int c0, int k0,
                                            uint32_t (&f)[2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* p = bt + (c0 + g) * ld + k0 + 2 * t;
  f[0] = bf16_pair(p);
  f[1] = bf16_pair(p + 8);
}

// Negate a fragment (A or B) in place: flip the sign bit of each bf16
// (exact, so a product by -A is the negated product to the bit).
template <int N>
__device__ __forceinline__ void negate_bf16_frag(uint32_t (&f)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) f[i] ^= 0x80008000u;
}

// Write a 16 x 8 float32 accumulator to out[(r0 + row) * ld + c0 + col].
__device__ __forceinline__ void store_c_frag(float* out, int ld, int r0,
                                             int c0, const float (&d)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float* p = out + (r0 + g) * ld + c0 + 2 * t;
  p[0] = d[0];
  p[1] = d[1];
  p[8 * ld] = d[2];
  p[8 * ld + 1] = d[3];
}

}  // namespace mcop
