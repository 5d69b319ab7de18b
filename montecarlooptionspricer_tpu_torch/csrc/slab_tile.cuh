// The slab's staged tile product: one output tile of 128 columns of
// X = N @ Lt' for a block's D = 16 * PM rows, N and the factor streamed from
// device memory (L2) through shared memory in k-tiles of 16.  K6/K7
// (csrc/pathgen_tiled.cu) run it on every column tile of a path block; the
// P1 matmul probe (csrc/roofline.cu) runs it on every column tile of each
// dependent step a = a @ B, so the probe times the kernels' own product.
//
// * tile_product: float32 on the CUDA cores.  Each of the 256 threads keeps
//   a PM x 8 micro-tile (rows ty*PM.., columns tx*4..+3 and 64+tx*4..+3,
//   read as float4 so a quarter-warp reads 128 contiguous bytes of the
//   factor's k-tile); N^T is staged [kTileK][D+4].  SPEC adds the spectral
//   form's second product, X -= Zi @ Ci'.
// * tile_product_bf16: bf16 inputs on the tensor cores, float32 sums
//   (csrc/mma_bf16.cuh).  The N k-tile is rounded to bf16 (nearest even)
//   into [D][kNB], the bf16 factor's k-tile stored column by column
//   [kTileCols][kNB]; warp w runs the m16n8k16 products of the 8-column
//   groups w and w + 8 for every m16 row group.  TRI skips a group's
//   product on the k-tiles past its last column (an upper-triangular
//   factor).  SPEC stages the Zi k-tile and the bf16 Ci' k-tile beside
//   them and adds (-Zi) @ Ci' into the same float32 accumulators (the
//   negation is exact in bf16), over every k < n.
//
// Both take the factor and the width from `a` (a.lt: the factor [n][n],
// float32 or bf16; a.ci: Ci' under SPEC; a.n), read rows of N with row
// stride n and columns c < n of the factor, and pad the k-tiles past n
// with zeros in shared memory.  TRI (an upper-triangular factor, Lt') ends
// k at the tile's last column; a dense factor (SPEC, or !TRI) runs every
// k < n.  Both start and end synchronised on the block's barrier, so the
// caller may reuse xs after the call and the buffers across calls.
#pragma once

#include <cuda_bf16.h>

#include "mma_bf16.cuh"

namespace mcop {
namespace slab {

constexpr int kThreads = 256;
constexpr int kTileCols = 128;                 // columns per output tile
constexpr int kHalfCols = kTileCols / 2;
constexpr int kTileK = 16;                     // rows of the factor a k-tile
constexpr int kColGroups = 16;                 // threads across a tile row
constexpr int kXStride = kTileCols + 1;
constexpr int kNB = kTileK + 8;  // bf16 row stride of a staged k-tile: 4
                                 // (mod 8) words, conflict-free fragments

// Floats of the staged k-tiles of a block of d rows: float32 N^T and
// factor tiles, or the bf16 N and factor tiles (spec: two of each).
__host__ __device__ constexpr int tile_floats_of(int d, bool spec,
                                                 bool bf16) {
  return (spec ? 2 : 1) * (bf16 ? (d + kTileCols) * kNB / 2
                                : kTileK * (d + 4) + kTileK * kTileCols);
}

template <int PM, bool SPEC, bool BF16>
__host__ __device__ constexpr int tile_floats() {
  return tile_floats_of(16 * PM, SPEC, BF16);
}

template <int PM>
__device__ __forceinline__ void load_paths(const float* src, float (&v)[PM]) {
  if constexpr (PM % 4 == 0) {
#pragma unroll
    for (int i = 0; i < PM; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(src + i);
      v[i] = q.x;
      v[i + 1] = q.y;
      v[i + 2] = q.z;
      v[i + 3] = q.w;
    }
  } else if constexpr (PM == 2) {
    const float2 q = *reinterpret_cast<const float2*>(src);
    v[0] = q.x;
    v[1] = q.y;
  } else {
    v[0] = src[0];
  }
}

// Columns c0 .. c0 + kTileCols - 1 of X = N @ Lt' (SPEC: Zr @ Cr' - Zi @
// Ci', nrows Zr and zrows Zi, a.lt Cr') into xs [D][kXStride]; ns, lts
// (SPEC also zs, cts) are the staged k-tiles.
template <int PM, bool SPEC, bool TRI = true, class Src>
__device__ void tile_product(const Src& a, const float* nrows,
                             const float* zrows, int c0, float* ns,
                             float* lts, float* zs, float* cts, float* xs) {
  constexpr int D = 16 * PM;
  constexpr int NS = D + 4;
  const int n = a.n;
  const float* lt = static_cast<const float*>(a.lt);
  const int tid = threadIdx.x;
  const int tx = tid % kColGroups;              // columns tx*4.., 64+tx*4..
  const int ty = tid / kColGroups;              // rows ty*PM + i
  const int kmax = min(c0 + kTileCols, n);
  float acc[PM][8];
#pragma unroll
  for (int i = 0; i < PM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  const int kend = SPEC || !TRI ? n : kmax;
  for (int k0 = 0; k0 < kend; k0 += kTileK) {
    const int kn = min(kTileK, kend - k0);
    __syncthreads();  // previous readers of ns/lts (zs/cts) are done
    for (int idx = tid; idx < D * kTileK; idx += kThreads) {
      const int p = idx / kTileK, kk = idx - p * kTileK;
      const size_t g = static_cast<size_t>(p) * n + k0 + kk;
      ns[kk * NS + p] = kk < kn ? nrows[g] : 0.0f;
      if (SPEC) zs[kk * NS + p] = kk < kn ? zrows[g] : 0.0f;
    }
    for (int idx = tid; idx < kTileK * kTileCols; idx += kThreads) {
      const int kk = idx / kTileCols, cc = idx - kk * kTileCols;
      const int c = c0 + cc;
      const bool in = kk < kn && c < n;
      const size_t g = static_cast<size_t>(k0 + kk) * n + c;
      lts[idx] = in ? lt[g] : 0.0f;
      if (SPEC) cts[idx] = in ? a.ci[g] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTileK; ++kk) {
      float av[PM];
      load_paths<PM>(ns + kk * NS + ty * PM, av);
      const float4 b0 =
          *reinterpret_cast<const float4*>(lts + kk * kTileCols + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(
          lts + kk * kTileCols + kHalfCols + tx * 4);
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < PM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], b[j], acc[i][j]);
      if constexpr (SPEC) {
        float zv[PM];
        load_paths<PM>(zs + kk * NS + ty * PM, zv);
        const float4 d0 = *reinterpret_cast<const float4*>(
            cts + kk * kTileCols + tx * 4);
        const float4 d1 = *reinterpret_cast<const float4*>(
            cts + kk * kTileCols + kHalfCols + tx * 4);
        const float d[8] = {d0.x, d0.y, d0.z, d0.w,
                            d1.x, d1.y, d1.z, d1.w};
#pragma unroll
        for (int i = 0; i < PM; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j] = fmaf(-zv[i], d[j], acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < PM; ++i) {
    float* xrow = xs + (ty * PM + i) * kXStride;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      xrow[tx * 4 + j] = acc[i][j];
      xrow[kHalfCols + tx * 4 + j] = acc[i][4 + j];
    }
  }
  __syncthreads();
}

// The same columns with N rounded to bf16 and a bf16 factor a.lt, on the
// tensor cores; nsb [D][kNB] and ltb [kTileCols][kNB] are the staged
// k-tiles.  SPEC: X = Zr @ Cr' - Zi @ Ci' (nrows Zr, zrows Zi, a.lt Cr',
// a.ci Ci', all k < n), the Zi and Ci' k-tiles staged in zsb [D][kNB] and
// ctb [kTileCols][kNB]; each row group's two A fragments are loaded once a
// k-tile (the Zi one negated) and each column group's B fragments once a
// row group, so the fragments held stay within the two-blocks-an-SM
// register budget at PM 8.
template <int PM, bool TRI = true, bool SPEC = false, class Src>
__device__ void tile_product_bf16(const Src& a, const float* nrows, int c0,
                                  __nv_bfloat16* nsb, __nv_bfloat16* ltb,
                                  float* xs, const float* zrows = nullptr,
                                  __nv_bfloat16* zsb = nullptr,
                                  __nv_bfloat16* ctb = nullptr) {
  constexpr int D = 16 * PM;
  const int n = a.n;
  const __nv_bfloat16* lt = static_cast<const __nv_bfloat16*>(a.lt);
  const __nv_bfloat16* ci =   // Ci' (SPEC), whatever pointer type a holds
      static_cast<const __nv_bfloat16*>(static_cast<const void*>(a.ci));
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int kend = TRI && !SPEC ? min(c0 + kTileCols, n) : n;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
  float acc[PM][2][4];
#pragma unroll
  for (int i = 0; i < PM; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  for (int k0 = 0; k0 < kend; k0 += kTileK) {
    const int kn = min(kTileK, kend - k0);
    __syncthreads();  // previous readers of nsb/ltb (zsb/ctb) are done
    for (int idx = tid; idx < D * kTileK; idx += kThreads) {
      const int p = idx / kTileK, kk = idx - p * kTileK;
      const size_t g = static_cast<size_t>(p) * n + k0 + kk;
      nsb[p * kNB + kk] = kk < kn ? __float2bfloat16_rn(nrows[g]) : zero;
      if (SPEC)
        zsb[p * kNB + kk] = kk < kn ? __float2bfloat16_rn(zrows[g]) : zero;
    }
    for (int idx = tid; idx < kTileK * kTileCols; idx += kThreads) {
      const int kk = idx / kTileCols, cc = idx - kk * kTileCols;
      const int c = c0 + cc;
      const bool in = kk < kn && c < n;
      const size_t g = static_cast<size_t>(k0 + kk) * n + c;
      ltb[cc * kNB + kk] = in ? lt[g] : zero;
      if (SPEC) ctb[cc * kNB + kk] = in ? ci[g] : zero;
    }
    __syncthreads();
    if constexpr (SPEC) {
#pragma unroll
      for (int i = 0; i < PM; ++i) {
        uint32_t af[4], zf[4];
        load_a_frag(nsb, kNB, 16 * i, 0, af);
        load_a_frag(zsb, kNB, 16 * i, 0, zf);
        negate_bf16_frag(zf);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = 8 * (warp + 8 * j);
          uint32_t b[2], bi[2];
          load_b_frag(ltb, kNB, col, 0, b);
          load_b_frag(ctb, kNB, col, 0, bi);
          mma_bf16_16816(acc[i][j], af, b);
          mma_bf16_16816(acc[i][j], zf, bi);
        }
      }
    } else {
      uint32_t af[PM][4];
#pragma unroll
      for (int i = 0; i < PM; ++i) load_a_frag(nsb, kNB, 16 * i, 0, af[i]);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = 8 * (warp + 8 * j);
        if (!TRI || k0 <= c0 + col + 7) {   // the triangle: zeros past it
          uint32_t b[2];
          load_b_frag(ltb, kNB, col, 0, b);
#pragma unroll
          for (int i = 0; i < PM; ++i) mma_bf16_16816(acc[i][j], af[i], b);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < PM; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      store_c_frag(xs, kXStride, 16 * i, 8 * (warp + 8 * j), acc[i][j]);
  __syncthreads();
}

}  // namespace slab
}  // namespace mcop
