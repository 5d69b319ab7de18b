// K5, the strike-chain kernel for Hopper (sm_90a), bound through a plain C
// interface and loaded with ctypes (models/chain_cuda.py).
//
// mcop_priced_chain replaces montecarlooptionspricer_tpu/models/
//    pathgen_pallas.py:_chain_kernel, _chain_kernel_noise_in and
//    _chain_kernel_grid (with _sweep_values and _policy_value_boundary),
//    chol and spectral fGN forms (the spectral one, SPEC, reads Zr, Zi, W
//    and the dense Cr', Ci' as K2's does).  Boundary policy in two forms:
//    plain and antithetic (the pair branch of _chain_paths:432); the
//    quadratic policy (QUAD, chain_policy_form="quadratic":
//    _sweep_values:408 with _policy_value_minreduce:302) plain.
//    Every form also runs on bf16 fGN inputs (BF16, from the bf16 flag;
//    StreamConfig.fgn_matmul_dtype="bfloat16": make_pallas_priced_chain
//    takes its bf16 factor from _fgn_consts at pathgen_pallas.py:1943, and
//    _chain_paths forms X with _fgn_x:142 on the bf16 matrices).
//
// Build units (csrc/build_unit.cuh): this source is built twice, the
// float32 and the bf16 bodies apart; an entry given the other dtype's
// flag returns cudaErrorInvalidValue.
//
// What it computes: the paths of K2 (csrc/pathgen.cu) from the same noise,
// S_c = exp(logS_c) on every cell, and for each strike k of the strip the
// first column c with lo_k[c] <= S_c <= hi_k[c] of its S-space
// boundary_rows table; the path is then worth dk_k[c] - disc[c] * S_c for a
// put and disc[c] * S_c - dk_k[c] for a call (dk = disc * strike, no clamp,
// as on the TPU), else 0.  Under QUAD the strike's table is its
// policy_rows table instead, and the path stops at the first c where the
// quadratic says exercise (csrc/quad_policy.cuh, z = (s - mu) * (1 / sd) as
// _policy_value_minreduce takes it; strike from row 7), worth
// disc[c] * max(+-(S_c - strike), 0).  Each block writes one partial sum
// per strike (no atomics: a seed gives the same [K] on every run).  The
// antithetic form
// draws (or reads) N and W for half the paths: drawn row q prices (N, W)
// and its partner (-N, -W), and the fGN map is linear, so the partner's
// plane is -x and the product runs once per pair; each member then takes
// its own exp, Euler recursion and S-space strike sweep.
//
// Bound on the H100: operations.  Per path the fGN product is ~n^2/2
// multiply-adds (67k at n = 365) and the strike sweep ~4 operations per
// cell and strike up to its first hit (two compares, the value, the stop
// flag): at 131,072 paths, 365 steps and 21 strikes that is 8.8e9 FMA
// plus at most 4.0e9 sweep operations, at most 0.33 ms at 67 TFLOP/s
// float32, against ~0.6 MB of bytes that must move (Lt', the tables, the
// sums), 0.2 us at 3.35 TB/s.  Paired, the product is half of that and
// the sweep is not: every member sweeps.  The spectral product is 2 n^2
// multiply-adds per path (dense Cr', Ci'), four times the triangle: at
// 365 steps and 21 strikes at most 1.1 ms.  The QUAD sweep is ~12
// operations a strike-cell up to its first hit (the quadratic, the payoff,
// two compares), three times the boundary sweep's.
//
// Design:
// * The path block, its N plane (and Zi), the fGN tile product and the
//   Euler increments are K2's (csrc/fgn_tile.cuh), bit for bit.  The log
//   price is log s0 + (the running sum of the increments), JAX's
//   association (log_s0 + the cumsum matmul) and the plain version's, not
//   K2's running sum from log s0: a float32 sum carried at log s0 ~ 4.6
//   rounds each step at 4.8e-7, which flipped root-band decisions against
//   the plain version.  Each path block is generated once and every
//   strike of the launch is swept against it, tile by tile.
// * No W plane stays resident: the Euler pass takes each tile's W per
//   step pair, redrawn from the seeded stream at the counter load_noise
//   uses (csrc/strip_sweep.cuh:tile_w_pair) or read from the injected
//   plane.  That frees D ld floats, the room the staged tables take, and
//   lets the bf16 chol blocks run two to an SM (__launch_bounds__(256, 2):
//   at most 128 registers a thread).
// * The strike sweep, JAX's min-index reduction over columns
//   (_sweep_values, _policy_value_boundary) written for a warp: the lanes
//   sit on the tile's columns (lane l on columns l and l + 32) and warp w
//   owns paths w, w + 8, ... (BP / 8 of them).  Each lane takes exp of its
//   columns' log prices once per tile.  For each strike k of the launch
//   the warp reads k's lo and hi at its two columns from shared memory
//   (conflict-free), then for each of its paths tests both columns and
//   takes two ballots (columns 0-31, 32-63: bit order is column order),
//   all with no branch, and branches once per strike, where a path that
//   had not stopped hits in the tile; __ffs then gives that path's first
//   hit.  Lane k keeps strike k's stop state for the warp's paths (a
//   stopped bit and the value per path); the warp broadcasts lane k's
//   bits, so a (path, strike) that stopped in an earlier tile is masked
//   warp-uniformly and a strike every path of the warp has left is
//   skipped whole.  On a first hit the S of that column comes from its
//   lane by shuffle and lane k reads dk and disc at that column (once per
//   path and strike) for the value.  No thread walks columns one by one
//   and nothing exits early: a (path, strike, tile) costs four compares,
//   two ballots and a mask update, however far the first hit lies.
// * The tables: rows lo and hi of the launch's strikes for the tile's 64
//   columns are copied into shared memory with cp.async, issued before
//   the tile's product and waited for after its Euler pass and running
//   sum, so the copy overlaps the product (n_strikes * 512 bytes a block;
//   the reserve is sized by the launch's strikes, the block by kGroup).
//   The QUAD sweep reads its seven policy_rows rows at its two columns
//   per strike straight from global memory, coalesced (a warp reads a
//   row's 64 columns as two 128-byte lines), with sd's reciprocal taken
//   once per column and strike (csrc/quad_policy.cuh:QuadCell); staging
//   seven rows of 32 strikes (57 KB) would cost the block its size.
// * The running log price along a tile stays one thread per path (64
//   dependent adds); its association is the plain version's.
// * One launch sweeps up to kGroup = 32 strikes (one per lane).  A wider
//   strip takes one launch per 32 strikes on the same seed, which
//   regenerates bitwise-identical paths: the Philox counter is (global
//   drawn row, step pair), so a member and its partner are the same two
//   paths for every strike of the strip.
// * The block's partial sums are reduced in a fixed order through the
//   shared-memory tile, one thread per strike: no atomics.
// * Shared memory (models/chain_cuda.py smem_bytes): the N plane (Zr and
//   Zi under SPEC) of the D = 16 * PM drawn rows, one 64-column X tile of
//   every member (BP = D plain, 2D paired), the staged factor rows and
//   the staged strike rows: 4 (P D ld + 65 BP + F + 128 K) bytes, P
//   planes, ld = n rounded up to odd, F = 2048 floats a staged float32
//   factor tile, K strikes (0 under QUAD).  The bf16 form (BF16) keeps
//   its planes in bf16 (2 D (ceil16(n) + 8) bytes each) and stages
//   [64][40] bf16 factor tiles.  The block is the largest the model fits
//   at kGroup strikes (models/chain_cuda.py block_paths_for): at 365
//   steps 64 paths (128 members paired) in every chol form, spectral 32
//   (64) in float32 and 64 (128) in bf16; at 512 steps 64 (128) chol,
//   spectral 32 (64) float32, 64 (128) bf16.  A bf16 chol block at 365
//   steps takes 86,272 bytes plain and 102,912 paired at 32 strikes, so
//   two share an SM; the float32 and spectral blocks run one to an SM.
//   The reduction's [32][BP] floats fit the X tile.
// * The decision is taken in S space for both members, as on the TPU.
// * The bf16 form (BF16) rounds each normal of N (and Zi) to nearest even
//   as it is drawn or read, pads the rows with zeros to whole k16 steps
//   and runs the product on the tensor cores (csrc/fgn_tile.cuh:
//   fgn_tile_mma, m16n8k16, float32 sums); W, the X tile, the Euler
//   recursion and the sweep are the float32 form's.

#include <cuda_runtime.h>
#include <stdint.h>

#include "build_unit.cuh"
#include "fgn_tile.cuh"
#include "quad_policy.cuh"
#include "strip_sweep.cuh"

namespace {

using namespace mcop;

constexpr int kGroup = 32;   // strikes one launch sweeps

struct ChainArgs {
  const float* noise;   // [2 or 3, drawn, n] or nullptr (seeded entry)
  const void* lt;       // [n, n] half-scaled factor: Lt' (upper), or Cr';
                        // bf16 under the bf16 form, else float32
  const void* ci;       // [n, n] Ci' (spectral, the dtype of lt), or
                        // nullptr (chol)
  const float* vd;      // [n] half variance drift
  const float* tables;  // [n_strikes] boundary_rows tables: rows lo, hi,
                        // disc * strike, disc (QUAD: policy_rows tables)
  long long strike_stride, row_stride;   // floats
  int n_strikes;        // <= kGroup
  float* out;           // [rows / BP, n_strikes] partial sums
  int drawn, n;         // rows of the noise planes, steps
  uint32_t key;
  float r, dt, sqrt_dt, log_s0;
  int is_call;
};

// The Euler log increment of one cell.  Every rounding is explicit (no
// multiply-add contraction), so a pair's partner (-x, -w) rounds exactly as
// the unpaired kernel on the negated noise does, in the plain versions'
// order.
__device__ __forceinline__ float euler_inc(const ChainArgs& a, float x,
                                           float w, int c) {
  const float sv = expf(x + a.vd[c]);
  const float v = __fmul_rn(sv, sv);
  return __fadd_rn(__fmul_rn(__fsub_rn(a.r, __fmul_rn(0.5f, v)), a.dt),
                   __fmul_rn(sv, __fmul_rn(w, a.sqrt_dt)));
}

// The value of a path stopped at column c at price s for strike k: the
// boundary form's dk - disc * s (put; disc * s - dk call), or under QUAD
// disc * payoff, as quad_exercise takes it.
template <bool QUAD>
__device__ __forceinline__ float stop_value(const ChainArgs& a, int k, int c,
                                            float s) {
  const float* row = a.tables + k * a.strike_stride + c;
  if (QUAD) {
    return __fmul_rn(quad_payoff(s, __ldg(row + 7 * a.row_stride), a.is_call),
                     __ldg(row + 6 * a.row_stride));
  }
  const float ds = __fmul_rn(s, __ldg(row + 3 * a.row_stride));
  const float dk = __ldg(row + 2 * a.row_stride);
  return a.is_call ? __fsub_rn(ds, dk) : __fsub_rn(dk, ds);
}

// Block of D = 16 * PM drawn rows; BP = D paths, or 2D pair members (ANTI:
// member p < D is drawn row p, member D + p its partner).  SPEC: the
// spectral fGN form; QUAD: the quadratic policy; BF16: the bf16 fGN-input
// form.
template <int PM, bool SEEDED, bool ANTI, bool SPEC, bool QUAD, bool BF16>
__global__ void __launch_bounds__(kThreads, 2) chain_kernel(ChainArgs a) {
  constexpr int D = 16 * PM;
  constexpr int BP = ANTI ? 2 * D : D;
  constexpr int kPaths = BP / kWarps;     // paths each warp sweeps
  constexpr unsigned kAllPaths = (1u << kPaths) - 1u;
  constexpr int kHalf = kTileCols / 2;
  using E = fgn_elem<BF16>;
  extern __shared__ float smem[];
  const int n = a.n;
  const int npf = n_plane_floats(n, D, BF16);
  E* ns = reinterpret_cast<E*>(smem);     // [D][ld] N (Zr); bf16: [D][ldn]
  E* zs = reinterpret_cast<E*>(smem + npf);   // the same, Zi under SPEC
  float* xs = smem + (SPEC ? 2 : 1) * npf;    // [BP][kXStride]
  E* lts = reinterpret_cast<E*>(xs + BP * kXStride);
                                          // [1 or 2][kTileK][kTileCols];
                                          // bf16: [kTileCols][kTileKB]
  float* tab = xs + BP * kXStride + staged_floats(SPEC ? 2 : 1, BF16);
                                          // [n_strikes][2][kTileCols]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int row0 = blockIdx.x * D;        // first drawn row
  load_noise<D, SEEDED, SPEC, BF16, false>(a.noise, a.drawn, n, a.key, row0,
                                           ns, nullptr, zs);

  float cum = 0.0f;    // running sum of the log increments, thread tid < BP
  // Lane k keeps strike k's stop state for paths warp + kWarps * j: bit j
  // of `stopped` and val[j].
  unsigned stopped = 0u;
  float val[kPaths];
#pragma unroll
  for (int j = 0; j < kPaths; ++j) val[j] = 0.0f;

  for (int c0 = 0; c0 < n; c0 += kTileCols) {
    const int cn = min(c0 + kTileCols, n) - c0;
    __syncthreads();   // the last tile's sweep is done with tab
    if (!QUAD)
      stage_strike_rows(a.tables, a.strike_stride, a.row_stride,
                        a.n_strikes, c0, cn, tab);
    fgn_tile<PM, 1, SPEC, BF16>(static_cast<const E*>(a.lt),
                                static_cast<const E*>(a.ci), n, c0, ns, lts,
                                xs, nullptr, zs);

    // Variance exp and Euler increment of each step pair (K2's cells;
    // both members of a pair from one x and one w), W drawn or read here.
    for (int idx = tid; idx < D * kHalf; idx += kThreads) {
      const int q = idx / kHalf, cc = 2 * (idx - q * kHalf);
      if (cc >= cn) continue;
      float w[2];
      tile_w_pair<SEEDED, SPEC>(a.noise, a.drawn, n, a.key, row0 + q, c0 + cc,
                                w);
      float* xp = &xs[q * kXStride + cc];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        if (cc + t < cn) {
          const float x = xp[t];
          xp[t] = euler_inc(a, x, w[t], c0 + cc + t);
          if (ANTI) xp[D * kXStride + t] = euler_inc(a, -x, -w[t], c0 + cc + t);
        }
      }
    }
    __syncthreads();

    // Running log price along the tile, one thread per path: log s0 plus
    // the running sum of the increments.
    if (tid < BP) {
      float* xp = &xs[tid * kXStride];
      for (int cc = 0; cc < cn; ++cc) {
        cum += xp[cc];
        xp[cc] = a.log_s0 + cum;
      }
    }
    cp_async_wait_all();
    __syncthreads();

    // The strike sweep: lanes on columns, the warp over its (path,
    // strike) items.
    const bool v0 = lane < cn, v1 = lane + 32 < cn;
    float s0[kPaths], s1[kPaths];
#pragma unroll
    for (int j = 0; j < kPaths; ++j) {
      const float* xp = &xs[(warp + kWarps * j) * kXStride];
      s0[j] = expf(xp[lane]);
      s1[j] = expf(xp[lane + 32]);
    }
    // One strike's items: `test(s, h)` is the strike's test of the lane's
    // column l (h 0) or l + 32 (h 1) at price s.  Every path's ballots
    // first, with no branch; then one warp-uniform branch for the strike,
    // taken where a path that had not stopped hits in this tile.
    auto sweep_strike = [&](int k, unsigned done, auto test) {
      unsigned b0[kPaths], b1[kPaths], hits = 0u;
#pragma unroll
      for (int j = 0; j < kPaths; ++j) {
        b0[j] = __ballot_sync(kFullMask, v0 & test(s0[j], 0));
        b1[j] = __ballot_sync(kFullMask, v1 & test(s1[j], 1));
        hits |= (b0[j] | b1[j]) != 0u ? 1u << j : 0u;
      }
      hits &= ~done;
      if (hits == 0u) return;
#pragma unroll
      for (int j = 0; j < kPaths; ++j) {
        if (!((hits >> j) & 1u)) continue;
        const int c = first_hit(b0[j], b1[j]);
        const float s =
            __shfl_sync(kFullMask, c < 32 ? s0[j] : s1[j], c & 31);
        if (lane == k) {
          val[j] = stop_value<QUAD>(a, k, c0 + c, s);
          stopped |= 1u << j;
        }
      }
    };
    for (int k = 0; k < a.n_strikes; ++k) {
      const unsigned done = __shfl_sync(kFullMask, stopped, k);
      if (done == kAllPaths) continue;
      if constexpr (QUAD) {
        const float* tk = a.tables + k * a.strike_stride;
        const QuadCell q0 = quad_cell(tk, a.row_stride, v0 ? c0 + lane : 0);
        const QuadCell q1 =
            quad_cell(tk, a.row_stride, v1 ? c0 + lane + 32 : 0);
        sweep_strike(k, done, [&](float s, int h) {
          return quad_cell_exercises(h ? q1 : q0, s, a.is_call);
        });
      } else {
        const float* tk = tab + k * kStagedStrikeFloats;
        const float lo[2] = {tk[lane], tk[lane + 32]};
        const float hi[2] = {tk[kTileCols + lane], tk[kTileCols + lane + 32]};
        sweep_strike(k, done, [&](float s, int h) {
          return (s >= lo[h]) & (s <= hi[h]);
        });
      }
    }
    // The next tile synchronises before it overwrites tab and xs.
  }

  __syncthreads();
  float* red = xs;                        // [n_strikes][BP]
  if (lane < a.n_strikes) {
#pragma unroll
    for (int j = 0; j < kPaths; ++j)
      red[lane * BP + warp + kWarps * j] = val[j];
  }
  __syncthreads();
  if (tid < a.n_strikes) {
    float sum = 0.0f;
    for (int q = 0; q < BP; ++q) sum += red[tid * BP + q];
    a.out[static_cast<size_t>(blockIdx.x) * a.n_strikes + tid] = sum;
  }
}

// Shared memory of a block of bp paths (pair members when antithetic), in
// the bf16 form's layout when bf16, for a launch of n_strikes strikes
// (whose lo and hi rows it stages, none under quad).
int smem_bytes(int n, int bp, bool anti, bool spec, bool bf16, bool quad,
               int n_strikes) {
  const int d = anti ? bp / 2 : bp;
  return block_smem_bytes(
      n, d, 1,
      (bp - d) * kXStride + (quad ? 0 : n_strikes * kStagedStrikeFloats),
      spec, bf16, false);
}

using Kernel = void (*)(ChainArgs);

template <int PM, bool ANTI, bool QUAD>
Kernel body_of(bool seeded, bool spec) {
  if (spec)
    return seeded ? chain_kernel<PM, true, ANTI, true, QUAD, kUnitBf16>
                  : chain_kernel<PM, false, ANTI, true, QUAD, kUnitBf16>;
  return seeded ? chain_kernel<PM, true, ANTI, false, QUAD, kUnitBf16>
                : chain_kernel<PM, false, ANTI, false, QUAD, kUnitBf16>;
}

template <int PM>
Kernel body_of(bool seeded, bool anti, bool spec, bool quad) {
  if (quad) return body_of<PM, false, true>(seeded, spec);
  return anti ? body_of<PM, true, false>(seeded, spec)
              : body_of<PM, false, false>(seeded, spec);
}

// This unit's body of the form (block_paths counts members when anti), or
// null where the arguments name none.
Kernel kernel_for(int n, int block_paths, bool seeded, bool anti, bool spec,
                  bool quad, int n_strikes) {
  const int unit = anti ? 32 : 16;
  if (n < 1 || block_paths < unit || block_paths % unit ||
      block_paths > 4 * unit || n_strikes < 1 || n_strikes > kGroup ||
      (quad && anti) ||
      smem_bytes(n, block_paths, anti, spec, kUnitBf16, quad, n_strikes) >
          kSmemLimit)
    return nullptr;
  switch (block_paths / unit) {
    case 4:
      return body_of<4>(seeded, anti, spec, quad);
    case 2:
      return body_of<2>(seeded, anti, spec, quad);
    case 1:
      return body_of<1>(seeded, anti, spec, quad);
    default:
      return nullptr;
  }
}

}  // namespace

extern "C" {

// block_paths counts paths (pair members when antithetic != 0); the
// spectral form when spectral != 0, the quadratic policy when quadratic
// != 0, a launch of n_strikes strikes; in this unit's fGN input dtype.
int MCOP_ENTRY(mcop_chain_smem_bytes)(int n_steps, int block_paths,
                                      int antithetic, int spectral,
                                      int quadratic, int n_strikes) {
  return smem_bytes(n_steps, block_paths, antithetic != 0, spectral != 0,
                    kUnitBf16, quadratic != 0, n_strikes);
}

int MCOP_ENTRY(mcop_chain_group)() { return kGroup; }

// Blocks of the form's seeded body one SM runs at once at this launch's
// shared memory, by cudaOccupancyMaxActiveBlocksPerMultiprocessor; minus
// a cudaError_t where the arguments name no body or the query fails.
int MCOP_ENTRY(mcop_chain_blocks_per_sm)(int n_steps, int block_paths,
                                         int antithetic, int spectral,
                                         int quadratic, int n_strikes) {
  const Kernel k = kernel_for(n_steps, block_paths, true,
                              antithetic != 0, spectral != 0,
                              quadratic != 0, n_strikes);
  if (k == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  const int smem = smem_bytes(n_steps, block_paths, antithetic != 0,
                              spectral != 0, kUnitBf16, quadratic != 0,
                              n_strikes);
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, kThreads,
                                                        smem);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// K5.  noise may be null (seeded entry, stream of `key`).  lt is Lt'
// (chol, ci null) or Cr' (spectral, ci = Ci'); noise is then [2, rows,
// n_steps] (N, W) or [3, rows, n_steps] (Zr, Zi, W).  bf16 != 0 (the _bf16
// unit only): the bf16 form, lt and ci bf16, noise float32 (N, and Zi,
// rounded as they are read).  rows counts paths; antithetic != 0 reads
// (or draws) rows / 2 rows of noise, and block_paths (32, 64 or 128)
// counts pair members.
// tables: the launch's n_strikes boundary_rows tables (quadratic != 0:
// policy_rows tables, not with antithetic), strike_stride floats apart,
// rows row_stride floats apart.  out: [rows / block_paths, n_strikes].
int MCOP_ENTRY(mcop_priced_chain)(
    const float* noise, const void* lt, const void* ci, const float* vd,
    int rows, int n_steps, int block_paths, unsigned int key, float r,
    float dt, float sqrt_dt, float log_s0, const float* tables,
    long long strike_stride, long long row_stride, int n_strikes,
    int is_call, int antithetic, int quadratic, int bf16, float* out,
    void* stream) {
  const bool anti = antithetic != 0, quad = quadratic != 0;
  const bool spec = ci != nullptr;
  const Kernel k = kernel_for(n_steps, block_paths, noise == nullptr, anti,
                              spec, quad, n_strikes);
  if (k == nullptr || (bf16 != 0) != kUnitBf16 || rows < 1 ||
      rows % block_paths)
    return static_cast<int>(cudaErrorInvalidValue);
  ChainArgs a{};
  a.noise = noise;
  a.lt = lt;
  a.ci = ci;
  a.vd = vd;
  a.tables = tables;
  a.strike_stride = strike_stride;
  a.row_stride = row_stride;
  a.n_strikes = n_strikes;
  a.out = out;
  a.drawn = anti ? rows / 2 : rows;
  a.n = n_steps;
  a.key = key;
  a.r = r;
  a.dt = dt;
  a.sqrt_dt = sqrt_dt;
  a.log_s0 = log_s0;
  a.is_call = is_call;
  const int smem =
      smem_bytes(n_steps, block_paths, anti, spec, kUnitBf16, quad, n_strikes);
  const cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int d = anti ? block_paths / 2 : block_paths;
  k<<<a.drawn / d, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
