// The single-tile path block shared by K1, K2 (csrc/pathgen.cu), K5
// (csrc/chain.cu), K3 and K4 (csrc/greeks.cu): a block of BP = 16 * PM
// paths keeps its N noise plane (and Zi under the spectral form) in
// dynamic shared memory for the whole horizon, with its W plane (K1) or
// without it (K2, K5, K3/K4 draw W per tile), and the step axis runs in
// tiles of kTileCols columns.
//
// load_noise fills the planes from the seeded stream (csrc/philox.cuh) or
// from an injected [2, rows, n] plane ([3, rows, n] = Zr, Zi, W under the
// spectral form); fgn_tile computes one step tile of X = N @ M for one or
// two upper-triangular [n, n] factors M (K3 and K4 need Lt' and dLt' from
// the same N reads), or of the spectral X = Zr @ Cr' - Zi @ Ci' for the
// dense [n, n] Cr' and Ci' (pathgen_pallas.py:_fgn_x:142).  Every kernel
// that includes this header therefore draws the same paths from a seed,
// and sums the fGN product in the same order (k ascending, 32-row stages),
// so X is bitwise the same in all five kernels.
//
// The bf16 fGN-input form (BF16; StreamConfig.fgn_matmul_dtype="bfloat16",
// counterpart _fgn_x with bf16 matrices, and _tangent_planes:845 for K3/K4)
// keeps the N plane (and under SPEC the Zi plane) in bf16, each normal
// rounded to nearest even as it is drawn or read, reads the factors (Lt',
// and dLt' for K3/K4, or Cr' and Ci') as bf16 and runs the products on the
// tensor cores (csrc/mma_bf16.cuh), float32 sums; W stays float32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_bf16.cuh"
#include "philox.cuh"

namespace mcop {

constexpr int kThreads = 256;
constexpr int kTileCols = 64;
constexpr int kTileK = 32;
constexpr int kColGroups = 16;                 // threads across a tile row
constexpr int kColsPerThread = kTileCols / kColGroups;
constexpr int kXStride = kTileCols + 1;
constexpr int kSmemLimit = 232448;

// Row stride of the noise planes: n rounded up to odd, so the rows of a
// warp fall on distinct banks.
__host__ __device__ inline int plane_ld(int n) { return n | 1; }

// The BF16 form: the N plane's row stride in bf16, n rounded up to whole
// k16 steps plus 8 (4 mod 8 words: conflict-free fragment reads), zero
// past n; and the stride of the staged factor tile [kTileCols][kTileKB]
// (column by column, k contiguous, the B fragments' layout).
__host__ __device__ inline int plane_ld_bf16(int n) {
  return (n + 15) / 16 * 16 + 8;
}
constexpr int kTileKB = kTileK + 8;

// The element type of the N plane and of the factors: float, or bf16 under
// the BF16 form.
template <bool BF16>
using fgn_elem = std::conditional_t<BF16, __nv_bfloat16, float>;

template <bool BF16>
__device__ __forceinline__ fgn_elem<BF16> to_fgn_elem(float v) {
  if constexpr (BF16) {
    return __float2bfloat16_rn(v);
  } else {
    return v;
  }
}

// Floats of shared memory `tiles` staged factor tiles take (one per
// product; two under SPEC: Cr' and Ci'), of tk rows each in float32.
__host__ __device__ constexpr int staged_floats(int tiles, bool bf16,
                                                int tk = kTileK) {
  return tiles * (bf16 ? kTileCols * kTileKB / 2 : tk * kTileCols);
}

// Floats of shared memory the N plane of bp rows takes.
__host__ __device__ inline int n_plane_floats(int n, int bp, bool bf16) {
  return bf16 ? bp * plane_ld_bf16(n) / 2 : bp * plane_ld(n);
}

// Fill the block's N and W planes [BP][ld] (and Zi into zs under SPEC)
// from the stream of `key` (noise null) or from the injected plane noise
// [2, rows, n] (N, W), or [3, rows, n] (Zr, Zi, W) under SPEC.  The
// spectral form's Zr and W are the chol stream's N and W; its Zi comes
// from the stream's own counter word (spectral_zi_quad).  Under BF16 the
// N plane (and Zi under SPEC) is bf16 [BP][plane_ld_bf16(n)], each normal
// rounded to nearest even, and its columns past n are zero (the
// tensor-core product reads whole k16 steps).  Without WITH_W (K2, K5,
// K3/K4: csrc/strip_sweep.cuh:tile_w_pair draws W per tile) no W plane is
// written and ws may be null.
template <int BP, bool SEEDED, bool SPEC = false, bool BF16 = false,
          bool WITH_W = true>
__device__ void load_noise(const float* noise, int rows, int n, uint32_t key,
                           int row0, fgn_elem<BF16>* ns, float* ws,
                           fgn_elem<BF16>* zs = nullptr) {
  const int ld = plane_ld(n);
  const int ldn = BF16 ? plane_ld_bf16(n) : ld;
  if (SEEDED) {
    const int pairs = (n + 1) / 2;
    for (int idx = threadIdx.x; idx < BP * pairs; idx += kThreads) {
      const int p = idx / pairs, j = idx - p * pairs;
      float n0, w0, n1, w1;
      step_pair_normals(key, row0 + p, j, &n0, &w0, &n1, &w1);
      ns[p * ldn + 2 * j] = to_fgn_elem<BF16>(n0);
      if (WITH_W) ws[p * ld + 2 * j] = w0;
      if (2 * j + 1 < n) {
        ns[p * ldn + 2 * j + 1] = to_fgn_elem<BF16>(n1);
        if (WITH_W) ws[p * ld + 2 * j + 1] = w1;
      }
    }
    if (SPEC) {
      const int quads = (n + 3) / 4;
      for (int idx = threadIdx.x; idx < BP * quads; idx += kThreads) {
        const int p = idx / quads, q = idx - p * quads;
        const float4 z = spectral_zi_quad(key, row0 + p, q);
        const float zv[4] = {z.x, z.y, z.z, z.w};
#pragma unroll
        for (int t = 0; t < 4; ++t)
          if (4 * q + t < n)
            zs[p * ldn + 4 * q + t] = to_fgn_elem<BF16>(zv[t]);
      }
    }
  } else {
    const size_t plane = static_cast<size_t>(rows) * n;
    for (int idx = threadIdx.x; idx < BP * n; idx += kThreads) {
      const int p = idx / n, c = idx - p * n;
      const size_t g = static_cast<size_t>(row0 + p) * n + c;
      ns[p * ldn + c] = to_fgn_elem<BF16>(noise[g]);
      if (SPEC) zs[p * ldn + c] = to_fgn_elem<BF16>(noise[plane + g]);
      if (WITH_W) ws[p * ld + c] = noise[(SPEC ? 2 : 1) * plane + g];
    }
  }
  if (BF16) {
    const int pad = ldn - n;
    for (int idx = threadIdx.x; idx < BP * pad; idx += kThreads) {
      const int p = idx / pad;
      ns[p * ldn + n + idx - p * pad] = to_fgn_elem<BF16>(0.0f);
      if (SPEC) zs[p * ldn + n + idx - p * pad] = to_fgn_elem<BF16>(0.0f);
    }
  }
}

// One step tile of X = N @ Lt' on the tensor cores (the BF16 form of
// fgn_tile): N in ns [D][plane_ld_bf16(n)] bf16, Lt' [n, n] bf16 in device
// memory, staged kTileK rows at a time into lts [kTileCols][kTileKB]
// column by column; out0 [D][kXStride] float32 sums.  Warp w owns columns
// c0 + 8w .. c0 + 8w + 7 of the tile and all PM m16 row groups of the
// block's D = 16 PM rows; it skips the k16 steps past its last column (Lt'
// is upper triangular, so they add zeros).
// NMAT 2 (K3/K4): the second upper-triangular product N @ m1 (dLt') into
// out1 from the same N reads: the m1 k-tile is staged beside m0's, each A
// fragment of N is loaded once and issued into both float32 accumulators,
// and the triangle skip is the same.
// SPEC: the dense X = Zr @ Cr' - Zi @ Ci' (m0 = Cr', m1 = Ci', Zr in ns and
// Zi in zs, both bf16 planes): Cr' and Ci' k-tiles staged side by side in
// lts, every k < n for every column (no triangle skip), and the Zi
// fragment negated (exact in bf16) so both products add into one float32
// accumulator.  The planes are zero past n, so the last k16 step adds
// zeros there.
template <int PM, bool SPEC = false, int NMAT = 1>
__device__ void fgn_tile_mma(const __nv_bfloat16* m0, const __nv_bfloat16* m1,
                             int n, int c0, const __nv_bfloat16* ns,
                             const __nv_bfloat16* zs, __nv_bfloat16* lts,
                             float* out0, float* out1 = nullptr) {
  static_assert(!SPEC || NMAT == 1, "the spectral product has one output");
  constexpr bool kTwoTiles = SPEC || NMAT == 2;   // m1 staged too
  const int ldn = plane_ld_bf16(n);
  const int warp = threadIdx.x / 32;
  const int kmax = SPEC ? n : min(c0 + kTileCols, n);
  const int kwarp = SPEC ? kmax : min(c0 + 8 * warp + 8, kmax);
  __nv_bfloat16* cts = lts + kTileCols * kTileKB;   // Ci' or dLt' k-tile
  float acc[NMAT][PM][4];
#pragma unroll
  for (int m = 0; m < NMAT; ++m)
#pragma unroll
    for (int i = 0; i < PM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[m][i][j] = 0.0f;

  for (int k0 = 0; k0 < kmax; k0 += kTileK) {
    const int kn = min(kTileK, kmax - k0);
    __syncthreads();  // previous users of lts (and of the out tiles) are done
    for (int idx = threadIdx.x; idx < kTileK * kTileCols; idx += kThreads) {
      const int kk = idx / kTileCols, cc = idx - kk * kTileCols;
      const int c = c0 + cc;
      const bool in = kk < kn && c < n;
      const size_t g = static_cast<size_t>(k0 + kk) * n + c;
      const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
      lts[cc * kTileKB + kk] = in ? m0[g] : zero;
      if (kTwoTiles) cts[cc * kTileKB + kk] = in ? m1[g] : zero;
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kTileK; ks += 16) {
      if (k0 + ks < kwarp) {
        uint32_t b[2], bi[2];
        load_b_frag(lts, kTileKB, 8 * warp, ks, b);
        if (kTwoTiles) load_b_frag(cts, kTileKB, 8 * warp, ks, bi);
#pragma unroll
        for (int i = 0; i < PM; ++i) {
          uint32_t a[4];
          load_a_frag(ns, ldn, 16 * i, k0 + ks, a);
          mma_bf16_16816(acc[0][i], a, b);
          if constexpr (NMAT == 2) {
            mma_bf16_16816(acc[NMAT - 1][i], a, bi);
          } else if constexpr (SPEC) {
            load_a_frag(zs, ldn, 16 * i, k0 + ks, a);
            negate_bf16_frag(a);
            mma_bf16_16816(acc[0][i], a, bi);
          }
        }
      }
    }
  }
  float* out[2] = {out0, out1};
#pragma unroll
  for (int m = 0; m < NMAT; ++m)
#pragma unroll
    for (int i = 0; i < PM; ++i)
      store_c_frag(out[m], kXStride, 16 * i, 8 * warp, acc[m][i]);
  __syncthreads();
}

// One step tile of the fGN products, for m0 (and m1 when NMAT is 2):
// out_m[p * kXStride + cc] = sum_{k <= c} N[p, k] * m_m[k, c] for
// c = c0 + cc < min(c0 + kTileCols, n), zero past n.  Each thread holds a
// PM x kColsPerThread micro-tile per factor; the factors are staged through
// shared memory (lts, NMAT * TK * kTileCols floats) TK rows at a time
// (kTileK, or fewer where a block needs the room; the sums run k ascending
// whatever TK, so X is the same bits), and rows past the tile's last
// column are skipped (the factors are upper triangular).
// SPEC (NMAT 1): the spectral product out0 = sum_{k < n} Zr[p, k] m0[k, c]
// - Zi[p, k] m1[k, c], Zr in ns and Zi in zs, m0 = Cr' and m1 = Ci' both
// staged (2 * kTileK * kTileCols floats).  Cr' and Ci' are dense, so every
// column tile runs over all n rows: no triangle skip.
// BF16: the tensor-core products of fgn_tile_mma (m0 = Lt' and, NMAT 2,
// m1 = dLt'; or Cr' and m1 = Ci' under SPEC; ns, zs and lts bf16).
// Ends with the tile written and the block synchronised.
template <int PM, int NMAT, bool SPEC = false, bool BF16 = false,
          int TK = kTileK>
__device__ void fgn_tile(const fgn_elem<BF16>* m0, const fgn_elem<BF16>* m1,
                         int n, int c0, const fgn_elem<BF16>* ns,
                         fgn_elem<BF16>* lts, float* out0, float* out1,
                         const fgn_elem<BF16>* zs = nullptr) {
  static_assert(!SPEC || NMAT == 1, "the spectral product has one output");
  static_assert(!BF16 || TK == kTileK, "the bf16 product stages kTileK");
  if constexpr (BF16) {
    fgn_tile_mma<PM, SPEC, NMAT>(m0, m1, n, c0, ns, zs, lts, out0, out1);
  } else {
    constexpr int kStaged = SPEC ? 2 : NMAT;   // factor tiles staged
    const float* mats[2] = {m0, m1};
    float* out[2] = {out0, out1};
    const int ld = plane_ld(n);
    const int tid = threadIdx.x;
    const int tx = tid % kColGroups;        // columns tx + 16 j
    const int ty = tid / kColGroups;        // paths ty * PM + i
    const int kmax = SPEC ? n : min(c0 + kTileCols, n);
    float acc[NMAT][PM][kColsPerThread];
#pragma unroll
    for (int m = 0; m < NMAT; ++m)
#pragma unroll
      for (int i = 0; i < PM; ++i)
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) acc[m][i][j] = 0.0f;

    for (int k0 = 0; k0 < kmax; k0 += TK) {
      const int kn = min(TK, kmax - k0);
      __syncthreads();  // previous users of lts (and the out tiles) are done
      for (int idx = tid; idx < TK * kTileCols; idx += kThreads) {
        const int kk = idx / kTileCols, cc = idx - kk * kTileCols;
        const int c = c0 + cc;
        const bool in = kk < kn && c < n;
        const size_t g = static_cast<size_t>(k0 + kk) * n + c;
#pragma unroll
        for (int m = 0; m < kStaged; ++m)
          lts[m * TK * kTileCols + idx] = in ? mats[m][g] : 0.0f;
      }
      __syncthreads();
      for (int kk = 0; kk < kn; ++kk) {
        float b[kStaged][kColsPerThread];
#pragma unroll
        for (int m = 0; m < kStaged; ++m)
#pragma unroll
          for (int j = 0; j < kColsPerThread; ++j)
            b[m][j] = lts[m * TK * kTileCols + kk * kTileCols + tx +
                          kColGroups * j];
#pragma unroll
        for (int i = 0; i < PM; ++i) {
          const int cell = (ty * PM + i) * ld + k0 + kk;
          const float nv = ns[cell];
          if constexpr (SPEC) {
            const float zv = zs[cell];
#pragma unroll
            for (int j = 0; j < kColsPerThread; ++j)
              acc[0][i][j] = fmaf(-zv, b[kStaged - 1][j],
                                  fmaf(nv, b[0][j], acc[0][i][j]));
          } else {
#pragma unroll
            for (int m = 0; m < NMAT; ++m)
#pragma unroll
              for (int j = 0; j < kColsPerThread; ++j)
                acc[m][i][j] = fmaf(nv, b[m][j], acc[m][i][j]);
          }
        }
      }
    }
#pragma unroll
    for (int m = 0; m < NMAT; ++m)
#pragma unroll
      for (int i = 0; i < PM; ++i)
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j)
          out[m][(ty * PM + i) * kXStride + tx + kColGroups * j] =
              acc[m][i][j];
    __syncthreads();
  }
}

// Shared memory of the planes (three under the spectral form; N, and Zi
// under the spectral form, in bf16 under the bf16 form; no W plane without
// w_plane), NMAT product tiles, the staged factors (one a product, two
// under the spectral form, in bf16 under the bf16 form) and `extra` floats
// more, for a block of bp paths at horizon n.
__host__ __device__ inline int block_smem_bytes(int n, int bp, int nmat,
                                                int extra,
                                                bool spec = false,
                                                bool bf16 = false,
                                                bool w_plane = true) {
  return 4 * ((spec ? 2 : 1) * n_plane_floats(n, bp, bf16) +
              (w_plane ? bp * plane_ld(n) : 0) + nmat * bp * kXStride +
              staged_floats(spec ? 2 : nmat, bf16) + extra);
}

}  // namespace mcop
