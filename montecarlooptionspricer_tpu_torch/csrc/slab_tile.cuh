// The slab's staged tile product: one output tile of 128 columns of
// X = N @ Lt' for a block's D = 16 * PM rows, N and the factor streamed from
// device memory (L2) through a ring of k-tile stages in shared memory.
// K6/K7 (csrc/pathgen_tiled.cu) run it on every column tile of a path block;
// the P1 matmul probe (csrc/roofline.cu) runs it on every column tile of
// each dependent step a = a @ B, so the probe times the kernels' own product.
//
// * The ring.  stages() k-tiles of tile_k() steps are in flight: the copies
//   of k-tile t + stages - 1 are issued (cp.async) before the products of
//   k-tile t run, into the stage k-tile t - 1 has just left, so a k-tile
//   costs one barrier and no thread waits on a load it issued this k-tile.
//   The factor's k-tile is copied 16 bytes at a time from a factor whose
//   rows are padded to whole 16-byte copies (slab_ld, zero past n); copies
//   past the tile's last row or past n are zero-filled (src-size 0).
// * tile_product, float32 on the CUDA cores: each of the 256 threads keeps
//   a PM x 8 micro-tile (rows ty*PM.., columns tx*4..+3 and 64+tx*4..+3,
//   read as float4 so a quarter-warp reads 128 contiguous bytes of the
//   factor's k-tile); N^T is staged [tile_k][D+4] so a thread reads its PM
//   rows of one step as float4.  N's rows have an odd stride in the
//   noise-in layout (n steps), so N is copied 4 bytes a cell, transposed by
//   the copy itself.  SPEC adds the spectral form's second product,
//   X -= Zi @ Ci', and stages 16 steps a k-tile, so a stage of its four
//   tiles takes the room of a chol stage of 32.  Each accumulator sums k
//   ascending with fmaf, so X is the same bits whatever the k-tile depth
//   and the ring.
// * tile_product, BF16: bf16 inputs on the tensor cores, float32 sums
//   (csrc/mma_bf16.cuh).  N's k-tile is stored row-major [D][kNB] and read
//   with ldmatrix; the factor's k-tile row-major [tile_k][kFacB] and read
//   with ldmatrix.trans.  Bank arithmetic: kNB = 24 bf16 = 12 words, so the
//   eight 16-byte rows of an ldmatrix phase start at words 12 r mod 32 =
//   0, 12, 24, 4, 16, 28, 8, 20, four banks each, all distinct; kFacB =
//   136 bf16 = 68 words = 4 mod 32, so eight factor rows start at words
//   0, 4, ..., 28, distinct.  The 8 warps tile the 16 x 16 .. 128 x 128
//   output as WM x WN warps (2 x 4 from 32 rows up): each warp runs the
//   m16n8k16 products of its PM / WM row groups and 16 / WN column groups,
//   so a warp loads PM / WM A and 16 / WN / 2 B ldmatrix.x4 a k-tile for
//   (PM / WM) (16 / WN) products.  TRI skips a group's product on the
//   k-tiles past its last column (an upper-triangular factor).  SPEC stages
//   the Zi and Ci' k-tiles beside them and adds (-Zi) @ Ci' into the same
//   float32 accumulators (the negation is exact in bf16) over every k < n.
//   Every accumulator takes the same bf16 inputs in the same k16 order
//   whatever the k-tile depth and the ring, so X is the same bits.
// * Where the rows of N come from (Rows): float32 rows of any stride,
//   copied 4 bytes a cell (kF32, the float32 product); bf16 rows padded to
//   whole 16-byte copies, written so by the seeded entry's draw (or P1's
//   chain), each value rounded once (kBf16); or float32 rows of any stride
//   read into registers a k-tile ahead, rounded to bf16 (nearest even, the
//   bits of kBf16) and stored after the k-tile's products (kF32Round, the
//   noise-in entries).
//
// The product starts with a barrier (so the caller may reuse the ring and
// xs from the previous call), waits for every k-tile's products before it
// writes xs (so xs may share the ring's room) and ends with a barrier.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace mcop {
namespace slab {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileCols = 128;                 // columns per output tile
constexpr int kHalfCols = kTileCols / 2;
constexpr int kColGroups = 16;                 // threads across a tile row
constexpr int kXStride = kTileCols + 1;
constexpr int kNB = 16 + 8;        // bf16 row stride of N's k-tile
constexpr int kFacB = kTileCols + 8;  // bf16 row stride of the factor's

// Steps a k-tile of the form stages: 32 for the float32 chol form, 16 for
// the others (the float32 spectral form's four tiles a stage, and one k16
// step of the tensor cores).
__host__ __device__ constexpr int tile_k(bool spec, bool bf16) {
  return !bf16 && !spec ? 32 : 16;
}

// Stages of the ring: three in float32 (97.5 KB at 128 rows: two blocks an
// SM), six for the bf16 chol form and three for the bf16 spectral form
// (61.5 KB, within the X tile's room it shares).
__host__ __device__ constexpr int stages(bool spec, bool bf16) {
  return !bf16 || spec ? 3 : 6;
}

// Row stride, in elements, of a factor the product copies 16 bytes at a
// time: n rounded up to 8 (zero past n).
__host__ __device__ constexpr int slab_ld(int n) { return (n + 7) / 8 * 8; }

// Floats of one stage for a block of d rows: N^T and the factor's k-tile
// in float32, or N's and the factor's bf16 k-tiles (spec: two of each).
__host__ __device__ constexpr int stage_floats(int d, bool spec, bool bf16) {
  return (spec ? 2 : 1) *
         (bf16 ? (d * kNB + tile_k(spec, bf16) * kFacB) / 2
               : tile_k(spec, bf16) * (d + 4 + kTileCols));
}

// Floats of the ring of a block of d rows.
__host__ __device__ constexpr int ring_floats(int d, bool spec, bool bf16) {
  return stages(spec, bf16) * stage_floats(d, spec, bf16);
}

enum class Rows { kF32, kBf16, kF32Round };

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&f)[4],
                                            const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(f[0]), "=r"(f[1]), "=r"(f[2]), "=r"(f[3])
      : "r"(a)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&f)[4],
                                                  const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(f[0]), "=r"(f[1]), "=r"(f[2]), "=r"(f[3])
      : "r"(a)
      : "memory");
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

// What the product reads: the rows of N (and Zi under SPEC), row stride
// nld elements (float32, or bf16 under Rows::kBf16), and the factor (and
// Ci' under SPEC), [n][fld] row-major, fld a multiple of 8, zero past n
// (float32, or bf16 under BF16).
struct Operands {
  const void* nrows;
  const void* zrows;
  long long nld;
  const void* fac;
  const void* fci;
  int fld;
  int n;
};

// Columns c0 .. c0 + kTileCols - 1 of X = N @ F (SPEC: Zr @ Cr' - Zi @ Ci')
// into xs [D][kXStride]; ring holds ring_floats(D, SPEC, BF16) floats.
// TRI ends k at the tile's last column (F upper triangular); a dense
// factor (SPEC, or !TRI) runs every k < n.
template <int PM, bool SPEC, bool TRI, bool BF16, Rows R>
__device__ void tile_product(const Operands& o, int c0, float* ring,
                             float* xs) {
  static_assert(BF16 == (R != Rows::kF32), "bf16 rows for a bf16 product");
  constexpr int D = 16 * PM;
  constexpr int TK = tile_k(SPEC, BF16);
  constexpr int S = stages(SPEC, BF16);
  constexpr int SF = stage_floats(D, SPEC, BF16);
  constexpr int NS = D + 4;                        // float32 N^T row stride
  constexpr bool kReg = R == Rows::kF32Round;
  constexpr int kPlanes = SPEC ? 2 : 1;
  const int n = o.n, tid = threadIdx.x;
  const int kend = TRI && !SPEC ? min(c0 + kTileCols, n) : n;
  const int nk = (kend + TK - 1) / TK;

  // Issue the copies of k-tile t into stage s.
  auto issue = [&](int s, int t) {
    float* st = ring + s * SF;
    const int k0 = t * TK;
    if constexpr (BF16) {
      auto* nb = reinterpret_cast<__nv_bfloat16*>(st);
      __nv_bfloat16* fb = nb + kPlanes * D * kNB;
      for (int idx = tid; idx < TK * (kTileCols / 8); idx += kThreads) {
        const int kk = idx / (kTileCols / 8), q = idx % (kTileCols / 8);
        const int k = k0 + kk, c = c0 + 8 * q;
        const bool ok = k < kend && c < n;
        const size_t g = ok ? static_cast<size_t>(k) * o.fld + c : 0;
#pragma unroll
        for (int m = 0; m < kPlanes; ++m)
          cp_async16(fb + m * TK * kFacB + kk * kFacB + 8 * q,
                     static_cast<const __nv_bfloat16*>(m ? o.fci : o.fac) + g,
                     ok);
      }
      if constexpr (R == Rows::kBf16) {
        for (int idx = tid; idx < 2 * D; idx += kThreads) {
          const int p = idx / 2, h = idx % 2;
          const int k = k0 + 8 * h;
          const bool ok = k < kend;
          const size_t g = static_cast<size_t>(p) * o.nld + (ok ? k : 0);
#pragma unroll
          for (int m = 0; m < kPlanes; ++m)
            cp_async16(nb + m * D * kNB + p * kNB + 8 * h,
                       static_cast<const __nv_bfloat16*>(m ? o.zrows
                                                           : o.nrows) + g,
                       ok);
        }
      }
    } else {
      float* fs = st + kPlanes * TK * NS;
      for (int idx = tid; idx < TK * (kTileCols / 4); idx += kThreads) {
        const int kk = idx / (kTileCols / 4), q = idx % (kTileCols / 4);
        const int k = k0 + kk, c = c0 + 4 * q;
        const bool ok = k < kend && c < n;
        const size_t g = ok ? static_cast<size_t>(k) * o.fld + c : 0;
#pragma unroll
        for (int m = 0; m < kPlanes; ++m)
          cp_async16(fs + m * TK * kTileCols + kk * kTileCols + 4 * q,
                     static_cast<const float*>(m ? o.fci : o.fac) + g, ok);
      }
      for (int idx = tid; idx < D * TK; idx += kThreads) {
        const int p = idx / TK, kk = idx % TK;
        const bool ok = k0 + kk < kend;
        const size_t g = static_cast<size_t>(p) * o.nld + (ok ? k0 + kk : 0);
#pragma unroll
        for (int m = 0; m < kPlanes; ++m)
          cp_async4(st + m * TK * NS + kk * NS + p,
                    static_cast<const float*>(m ? o.zrows : o.nrows) + g, ok);
      }
    }
  };

  // kReg: the thread's 8 steps of one row (and of Zi), a k-tile ahead.
  constexpr int kRegRows = kReg ? 1 : 0;
  float vreg[kPlanes][8 * kRegRows + 1 - kRegRows];
  const int rp = tid / 2, rh = tid % 2;            // row, half of the k-tile
  auto load_regs = [&](int t) {
    if constexpr (kReg) {
      if (rp >= D) return;
      const int k = t * TK + 8 * rh;
#pragma unroll
      for (int m = 0; m < kPlanes; ++m) {
        const float* src = static_cast<const float*>(m ? o.zrows : o.nrows) +
                           static_cast<size_t>(rp) * o.nld + k;
#pragma unroll
        for (int e = 0; e < 8; ++e) vreg[m][e] = k + e < kend ? src[e] : 0.0f;
      }
    }
  };
  auto store_regs = [&](int s) {
    if constexpr (kReg) {
      if (rp >= D) return;
      auto* nb = reinterpret_cast<__nv_bfloat16*>(ring + s * SF);
#pragma unroll
      for (int m = 0; m < kPlanes; ++m) {
        uint32_t w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const __nv_bfloat162 pr =
              __floats2bfloat162_rn(vreg[m][2 * e], vreg[m][2 * e + 1]);
          w[e] = *reinterpret_cast<const uint32_t*>(&pr);
        }
        *reinterpret_cast<uint4*>(nb + m * D * kNB + rp * kNB + 8 * rh) =
            make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  };

  // The accumulators and the k-tile's products.
  constexpr int WM = PM >= 2 ? 2 : 1;              // bf16 warps along rows
  constexpr int WN = kWarps / WM;                  // and along columns
  constexpr int MI = PM / WM, NJ = 16 / WN;        // m16, n8 groups a warp
  // acc[i][j][e]: bf16, element e of the warp's row group i and column
  // group j (store_c_frag's order); float32, column 4 j + e of the
  // micro-tile's row i.
  constexpr int kAccRows = BF16 ? MI : PM;
  constexpr int kAccGroups = BF16 ? NJ : 2;
  float acc[kAccRows][kAccGroups][4];
#pragma unroll
  for (int i = 0; i < kAccRows; ++i)
#pragma unroll
    for (int j = 0; j < kAccGroups; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / WN, wn = warp % WN;
  const int tx = tid % kColGroups;              // float32: columns tx*4..
  const int ty = tid / kColGroups;              // rows ty*PM + i

  auto compute = [&](int s, int t) {
    const float* st = ring + s * SF;
    if constexpr (BF16) {
      const auto* nb = reinterpret_cast<const __nv_bfloat16*>(st);
      const __nv_bfloat16* fb = nb + kPlanes * D * kNB;
      const int k0 = t * TK;
      uint32_t b[kPlanes][NJ][2];
#pragma unroll
      for (int m = 0; m < kPlanes; ++m)
#pragma unroll
        for (int jj = 0; jj < NJ; jj += 2) {
          const int col = 8 * (wn * NJ + jj) + 8 * (lane / 16);
          uint32_t f[4];
          ldmatrix_x4_trans(
              f, fb + m * TK * kFacB + (lane % 16) * kFacB + col);
          b[m][jj][0] = f[0];
          b[m][jj][1] = f[1];
          b[m][jj + 1][0] = f[2];
          b[m][jj + 1][1] = f[3];
        }
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const int row = 16 * (wm * MI + i) + lane % 16;
        uint32_t af[kPlanes][4];
#pragma unroll
        for (int m = 0; m < kPlanes; ++m)
          ldmatrix_x4(af[m], nb + m * D * kNB + row * kNB + 8 * (lane / 16));
        if constexpr (SPEC) negate_bf16_frag(af[1]);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int col = 8 * (wn * NJ + j);
          if (!TRI || SPEC || k0 <= c0 + col + 7) {  // the triangle: zeros
#pragma unroll
            for (int m = 0; m < kPlanes; ++m)
              mma_bf16_16816(acc[i][j], af[m], b[m][j]);
          }
        }
      }
    } else {
      const float* ns = st;
      const float* fs = st + kPlanes * TK * NS;
#pragma unroll
      for (int kk = 0; kk < TK; ++kk) {
        float av[PM];
        load_paths<PM>(ns + kk * NS + ty * PM, av);
        const float4 b0 =
            *reinterpret_cast<const float4*>(fs + kk * kTileCols + tx * 4);
        const float4 b1 = *reinterpret_cast<const float4*>(
            fs + kk * kTileCols + kHalfCols + tx * 4);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < PM; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j / 4][j % 4] = fmaf(av[i], bv[j], acc[i][j / 4][j % 4]);
        if constexpr (SPEC) {
          float zv[PM];
          load_paths<PM>(ns + TK * NS + kk * NS + ty * PM, zv);
          const float* cs = fs + TK * kTileCols;
          const float4 d0 =
              *reinterpret_cast<const float4*>(cs + kk * kTileCols + tx * 4);
          const float4 d1 = *reinterpret_cast<const float4*>(
              cs + kk * kTileCols + kHalfCols + tx * 4);
          const float dv[8] = {d0.x, d0.y, d0.z, d0.w,
                               d1.x, d1.y, d1.z, d1.w};
#pragma unroll
          for (int i = 0; i < PM; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j)
              acc[i][j / 4][j % 4] =
                  fmaf(-zv[i], dv[j], acc[i][j / 4][j % 4]);
        }
      }
    }
  };

  __syncthreads();  // the ring's and xs's previous users are done
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nk) {
      issue(s, s);
      load_regs(s);
      store_regs(s);
    }
    cp_async_commit();
  }
  for (int t = 0; t < nk; ++t) {
    cp_async_wait<S - 2>();
    __syncthreads();   // k-tile t has landed; stage (t - 1) % S is free
    const int next = t + S - 1;
    if (next < nk) {
      issue(next % S, next);
      load_regs(next);
    }
    cp_async_commit();
    compute(t % S, t);
    if (next < nk) store_regs(next % S);
  }
  cp_async_wait<0>();
  __syncthreads();   // every k-tile's products are done: xs may be the ring

  if constexpr (BF16) {
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        store_c_frag(xs, kXStride, 16 * (wm * MI + i), 8 * (wn * NJ + j),
                     acc[i][j]);
  } else {
#pragma unroll
    for (int i = 0; i < PM; ++i) {
      float* xrow = xs + (ty * PM + i) * kXStride;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        xrow[tx * 4 + j] = acc[i][0][j];
        xrow[kHalfCols + tx * 4 + j] = acc[i][1][j];
      }
    }
  }
  __syncthreads();
}

}  // namespace slab
}  // namespace mcop
