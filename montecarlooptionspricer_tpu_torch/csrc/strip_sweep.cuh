// The strike sweep shared by K5 (csrc/chain.cu) and K3/K4 (csrc/greeks.cu),
// and K2's decision (csrc/pathgen.cu, one strike): what a block needs to
// find, for each (path, strike), the first column of a 64-column step tile
// inside the strike's exercise interval, with the lanes of a warp on the
// tile's columns instead of one thread walking them.
//
// * tile_w_pair: the price Brownian W of two columns, redrawn per tile
//   from the seeded stream or read from the injected plane, so none of
//   these kernels keeps a W plane resident (load_noise<..., WITH_W =
//   false>).
// * stage_strike_rows: rows 0 and 1 of each strike's table (lo and hi, or
//   log lo and log hi) for the tile's columns, copied into shared memory
//   with cp.async; the copy is issued before the tile's fGN product and
//   waited for after it.
// * first_hit: lane l tests columns l and l + 32 of the tile; two ballots
//   (columns 0-31, then 32-63) put bit order in column order, so the first
//   set bit is the first hit.  Warp-uniform.  The kernels take every
//   path's ballots for a strike before any branch, then branch once per
//   strike, so the common case (no new hit in the tile) runs straight.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "fgn_tile.cuh"
#include "philox.cuh"

namespace mcop {

constexpr int kWarps = kThreads / 32;
constexpr unsigned kFullMask = 0xffffffffu;
// Floats one strike's staged rows take: lo and hi of one tile.
constexpr int kStagedStrikeFloats = 2 * kTileCols;

// The W of columns c and c + 1 (c even) of drawn row `row`: from the
// stream of `key` at counter (row, c / 2), the call load_noise makes for
// the same cells, or from the injected plane noise[wplane] [rows, n]
// (plane 1, or 2 under SPEC).  w[1] is meaningless past n.
template <bool SEEDED, bool SPEC = false>
__device__ __forceinline__ void tile_w_pair(const float* noise, int rows,
                                            int n, uint32_t key, int row,
                                            int c, float w[2]) {
  if (SEEDED) {
    float n0, n1;
    step_pair_normals(key, row, c / 2, &n0, &w[0], &n1, &w[1]);
  } else {
    const float* wp =
        noise + ((SPEC ? 2 : 1) * static_cast<size_t>(rows) + row) * n + c;
    w[0] = __ldg(wp);
    w[1] = c + 1 < n ? __ldg(wp + 1) : 0.0f;
  }
}

// Copy rows 0 and 1 of each of the n_strikes tables (strike_stride floats
// apart, rows row_stride apart) for columns c0 .. c0 + cn - 1 into
// tab [n_strikes][2][kTileCols], asynchronously; cp_async_wait_all and a
// barrier make them visible.  Columns past cn are left as they were.
__device__ __forceinline__ void stage_strike_rows(const float* tables,
                                                  long long strike_stride,
                                                  long long row_stride,
                                                  int n_strikes, int c0,
                                                  int cn, float* tab) {
  for (int idx = threadIdx.x; idx < n_strikes * kStagedStrikeFloats;
       idx += kThreads) {
    const int kr = idx / kTileCols, cc = idx - kr * kTileCols;
    if (cc >= cn) continue;
    const float* src = tables + (kr >> 1) * strike_stride +
                       (kr & 1) * row_stride + c0 + cc;
    const unsigned dst =
        static_cast<unsigned>(__cvta_generic_to_shared(tab + idx));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
                 "l"(src)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The first column of the tile whose test holds, from the ballots of the
// lanes' tests of columns l (b0) and l + 32 (b1), where one does.
__device__ __forceinline__ int first_hit(unsigned b0, unsigned b1) {
  return b0 ? __ffs(b0) - 1 : 31 + __ffs(b1);
}

}  // namespace mcop
