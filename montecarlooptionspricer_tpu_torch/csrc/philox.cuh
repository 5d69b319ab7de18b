// The seeded streams shared by every path kernel of the port: Philox4x32-10
// (Random123) and the Box-Muller pair it feeds.  Layout (models/
// pathgen_cuda.py docstring; philox_normals_ref is its PyTorch version):
// counter (global row, step pair, 0, 0), key (folded seed word, 0); step 2j
// takes the pair of (x0, x1), step 2j+1 that of (x2, x3); N = radius cos,
// W = radius sin.  The spectral fGN form's three planes (Zr, Zi, W) keep
// that N as Zr and that W, and draw Zi from counter (row, step quad, 3, 0)
// (spectral_zi_quad; philox_spectral_normals_ref), a word no other stream
// uses, so one key gives the chol and spectral bodies the same W.
#pragma once

#include <stdint.h>

namespace mcop {

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c;
}

__device__ __forceinline__ float uniform_open(uint32_t bits) {
  return __fadd_rn(__fmul_rn(static_cast<float>(static_cast<int>(bits >> 8)),
                             1.0f / 16777216.0f),
                   0.5f / 16777216.0f);
}

__device__ __forceinline__ void box_muller(uint32_t ba, uint32_t bb,
                                           float* n, float* w) {
  const float rad = sqrtf(-2.0f * logf(uniform_open(ba)));
  const float ang = __fmul_rn(6.2831855f, uniform_open(bb));
  *n = rad * cosf(ang);
  *w = rad * sinf(ang);
}

// The four normals of (row, step pair j): N and W of steps 2j and 2j+1.
__device__ __forceinline__ void step_pair_normals(uint32_t key, int row,
                                                  int j, float* n0, float* w0,
                                                  float* n1, float* w1) {
  const uint4 b = philox4x32_10(
      make_uint4(static_cast<uint32_t>(row), static_cast<uint32_t>(j), 0u,
                 0u),
      key, 0u);
  box_muller(b.x, b.y, n0, w0);
  box_muller(b.z, b.w, n1, w1);
}

// The factored-DFT kernels' stream (models/pathgen_factored_cuda.py
// docstring; philox_factored_normals_ref is its PyTorch version).  The third
// counter word (1, 2) keeps it apart from the stream above (0).
//
// fGN noise of storage columns 2*pair and 2*pair+1: counter
// (row, pair, 1, 0), each column's (Zr, Zi) one Box-Muller pair.
__device__ __forceinline__ void factored_z_pair(uint32_t key, int row,
                                                int pair, float* zr0,
                                                float* zi0, float* zr1,
                                                float* zi1) {
  const uint4 b = philox4x32_10(
      make_uint4(static_cast<uint32_t>(row), static_cast<uint32_t>(pair), 1u,
                 0u),
      key, 0u);
  box_muller(b.x, b.y, zr0, zi0);
  box_muller(b.z, b.w, zr1, zi1);
}

// Four normals of steps 4*quad .. 4*quad+3 from counter (row, quad, word,
// 0): the Box-Muller pairs of (x0, x1) and (x2, x3), cos then sin.
__device__ __forceinline__ float4 normal_quad(uint32_t key, int row, int quad,
                                              uint32_t word) {
  const uint4 b = philox4x32_10(
      make_uint4(static_cast<uint32_t>(row), static_cast<uint32_t>(quad),
                 word, 0u),
      key, 0u);
  float4 v;
  box_muller(b.x, b.y, &v.x, &v.y);
  box_muller(b.z, b.w, &v.z, &v.w);
  return v;
}

// Price Brownian of steps 4*quad .. 4*quad+3: counter (row, quad, 2, 0).
__device__ __forceinline__ float4 factored_w_quad(uint32_t key, int row,
                                                  int quad) {
  return normal_quad(key, row, quad, 2u);
}

// The spectral form's Zi of steps 4*quad .. 4*quad+3: counter
// (row, quad, 3, 0).
__device__ __forceinline__ float4 spectral_zi_quad(uint32_t key, int row,
                                                   int quad) {
  return normal_quad(key, row, quad, 3u);
}

}  // namespace mcop
