// Step-tiled rough-Bergomi path kernels for Hopper (sm_90a), for horizons
// past the single-tile kernels of csrc/pathgen.cu.  Bound through a plain C
// interface and loaded with ctypes (models/pathgen_tiled_cuda.py).
//
// K6 mcop_tiled_pathgen replaces montecarlooptionspricer_tpu/models/
//    pathgen_pallas_tiled.py:_tiled_pathgen_kernel (and
//    _tiled_pathgen_kernel_noise_in), chol and spectral fGN forms, plain
//    and paired (the whole-path pair body, _pair_tiles:382).
// K7 mcop_tiled_priced_chunk replaces pathgen_pallas_tiled.py:
//    _tiled_priced_kernel (and _tiled_priced_kernel_noise_in), chol and
//    spectral forms.  Log-boundary policy in four forms: plain, antithetic
//    (_pair_tiles:382), control variate (_finalize_priced_log:207) and
//    both; the quadratic policy (QUAD: _priced_tile_body:336's else branch,
//    _policy_tile:161 and _accumulate_priced:320) plain and with the
//    control variate.  The spectral form (SPEC, from the ci pointer) is the
//    slab's _fgn_tile:125, Zr @ Cr' - Zi @ Ci' on three noise planes.
// Both also run the bf16 fGN-input form of every body (BF16, from the
//    bf16 flag; StreamConfig.fgn_matmul_dtype="bfloat16", the slab's
//    _consts:88 in bf16 and its bf16 noise tiles, pathgen_pallas_tiled.py
//    :249, :308, :435), chol and spectral: K6 plain and paired, K7 in its
//    four boundary forms and its two quadratic ones.
//
// Build units (csrc/build_unit.cuh): this source is built four times, the
// float32 and the bf16 bodies, each seeded and noise-in, apart; an entry
// given a body its unit does not hold (the other dtype's flag, or the
// other seeded flag) returns cudaErrorInvalidValue.
//
// They compute what K1 and K2 compute, on the same seeded stream
// (csrc/philox.cuh), re-blocked over the step axis.  Per path p and step
// column c < n (column c = step c+1):
//   x_c    = sum_{k <= c} N[p,k] * Lt'[k,c]        (Lt' = 0.5 Lt, upper)
//            or, spectral: sum_{k < n} Zr[p,k] Cr'[k,c] - Zi[p,k] Ci'[k,c]
//   sv     = exp(x_c + vd[c])
//   inc    = (r - sv^2/2) dt + sv * W[p,c] * sqrt(dt)
//   logS_c = log s0 + sum_{k <= c} inc_k
// K6 writes out[p, 0] = s0 and out[p, c+1] = exp(logS_c); its pair form
// writes the drawn rows' paths to rows [0, rows/2) and their partners' to
// [rows/2, rows), the [X; -X] of the unpaired kernel.  K7 stops each
// path at the first c with llo[c] <= logS_c <= lhi[c] (QUAD: where the
// policy table's quadratic says exercise, csrc/quad_policy.cuh), adds
// disc[c] * max(+-(exp(logS_c) - strike), 0), and writes one partial sum
// per block (no atomics, so a seed gives the same sum on every run).  The
// forms are K2's: the control lane adds cv_disc * sum_p exp(logS_{p,n-1})
// per block, and an antithetic block prices drawn row q as (N, W) and
// (-N, -W), the partner's fGN tile being -x.
//
// Bound on the H100: operations.  At n = 1825 and 131072 rows the
// triangular fGN product is 2.2e11 multiply-adds; with ~8 operations per
// cell besides that is 4.4e11 operations, 6.55 ms at the card's 67 TFLOP/s
// float32 (full float32 is kept: no tensor cores), while the bytes that
// must move (Lt', and K6's 957 MB of prices) take 0.29 ms.  The
// antithetic forms run the product once per pair, 1.1e11 multiply-adds.
// The spectral product is two dense [n, n] products, 2 n^2 multiply-adds
// per path (8.7e11 at 1825 steps and 131072 rows, ~26 ms), four times
// the triangle.  The bf16 form runs the triangle on the tensor cores:
// 0.44 ms at the 989 TFLOP/s dense bf16 peak (the spectral form's dense
// products 1.8 ms), so its ~8 operations a cell besides the product (and
// the draws of the seeded entry) bound it.
//
// Design:
// * Shared memory.  At 1825 steps one path's N row is 7.3 KB, so the N
//   plane of a block wide enough for a register-tiled product (128 paths,
//   934 KB) is four times the 227 KB a block may use.  The noise therefore
//   stays in device memory (the noise-in layout, or the seeded entry's
//   workspace, draw_rows) and the product streams N and the factor
//   through a ring of k-tile stages, 16-byte cp.async copies issued stages
//   - 1 k-tiles ahead with one barrier a k-tile (csrc/slab_tile.cuh).  The
//   ring shares its room with the X tile of the block's BP paths (stride
//   kTileCols+1) and, ahead of it, the decision's staged rows: the product
//   writes X only once its last k-tile is done.  At 128 paths and every
//   horizon 99,840 bytes a block in float32 (three stages of 32 steps) and
//   70,144 in bf16: two blocks an SM, by the 128 registers of
//   __launch_bounds__(256, 2).
// * The factor.  The kernels read Lt' (or Cr' and Ci') with rows padded to
//   slab_ld(n) elements, zero past n (models/pathgen_tiled_cuda.py keeps
//   the padded copy beside the constants), so every copy of its k-tiles
//   is 16 bytes.
// * The seeded workspace.  The seeded entry first draws its block's rows
//   into the workspace: in float32 the noise-in layout [2 or 3, drawn, n];
//   under BF16 the N plane (and Zi) as bf16 rows of slab_ld(n), each normal
//   rounded to nearest even once at the draw (the bits the product would
//   round to) and zero past n, so the product copies them 16 bytes at a
//   time and each column tile re-reads half the bytes, then W in float32
//   [drawn, n].  The noise-in entry reads its float32 input (4-byte copies
//   in float32; under BF16 read a k-tile ahead into registers and rounded
//   there).
// * One block of 256 threads owns BP = 16*PM paths (128, 64, 32 or 16, the
//   largest that divides the rows).  Output tiles are 128 step columns;
//   output tile c reads k-tiles that end at its last column only: Lt' is
//   upper triangular.  The product of a column tile, float32 and bf16, is
//   csrc/slab_tile.cuh's, which the P1 matmul probe (csrc/roofline.cu)
//   also runs.
// * The TPU grid carried per-path state across step tiles in scratch.
//   Here thread p < BP carries path p's running sum across tiles in a
//   register, one step after another along each tile (K6: the running log
//   price from log s0; K7: the running sum of the increments, to which log
//   s0 is added, JAX's association, ls = log_s0 + carry + local,
//   _euler_tile:156, and the plain version's).  Padded columns past n are
//   never computed.  W is read once, at its own tile, each thread's next
//   eight cells' loads in flight together.
// * K7's decision, _policy_tile_log's first hit, runs as a parallel pass
//   once the tile's log prices stand: warp w owns paths w, w + 8, ...
//   (BP / 8 of them) and lane l tests columns l, l + 32, l + 64 and l + 96:
//   four ballots a path (bit order is column order), no branch; then, for
//   each path that had not stopped and hits in this tile (one warp-uniform
//   branch), the first set bit gives the column, that column's lane
//   supplies the log price by shuffle and lane j keeps path j's value.  A
//   path stopped in an earlier tile is masked; nothing exits early.  The
//   boundary forms test llo <= logS <= lhi in log space and take the exp
//   only at the hit; the QUAD forms take exp of each lane's columns of a
//   path that has not stopped and test quad_exercise's arithmetic (IEEE
//   division, as _policy_tile:161 divides), z and the polynomial only for
//   a path some lane's column pays on.  The rows the decision reads for the
//   tile (llo, lhi and disc, or the eight policy_rows rows) are copied with
//   cp.async into the room ahead of the X tile once the product is done
//   with it, and waited for after the running sum.  The stopped paths'
//   values (and under CV each path's terminal price) are reduced in path
//   order through the X tile: no atomics.
// * Antithetic blocks stream D = 16*PM drawn rows (64, 32 or 16) through
//   the same product and keep 2D members: the X tile holds both halves,
//   and thread p < 2D carries member p (p >= D the partner of row p - D).
//   Paired K6 writes member p >= D to the partner row `drawn` rows below
//   drawn row p - D (member_row).
// * The spectral form keeps its noise as [3, rows, n] (Zr, Zi, W) and
//   streams the Zr and Zi k-tiles beside the Cr' and Ci' k-tiles.  Every
//   output tile reads every k-tile: the matrices are dense.  Both matrices
//   stay in L2 up to isqrt(L2 / 8) = 2,560 steps (max_tiled_steps), the
//   chol factor to 3,620.  The seeded entry draws Zr and W as the chol
//   stream's N and W and Zi from its own counter word, as K1/K2 do.
// * The bf16 form (BF16) runs the tile as m16n8k16 tensor-core products
//   with float32 sums (csrc/mma_bf16.cuh) on ldmatrix fragments, skipping a
//   column group's product on the k-tiles past its last column (the
//   triangle); under SPEC the Zi and Ci' k-tiles are staged beside them
//   and every column tile sums over every k-tile, the Zi fragments negated
//   into the same accumulators.  The rest of the body (the QUAD policy
//   included) is the float32 form's; a pair's partner is -x to the bit.
// * No --use_fast_math: logf/expf/sinf/cosf stay precise so the plain
//   PyTorch versions agree to a few ulp per cell.

#include <cuda_runtime.h>
#include <stdint.h>

#include "build_unit.cuh"
#include "mma_bf16.cuh"
#include "philox.cuh"
#include "quad_policy.cuh"
#include "slab_tile.cuh"

namespace {

using namespace mcop::slab;
using mcop::kPhaseDraw;
using mcop::kPhaseEuler;
using mcop::kPhaseOut;
using mcop::kPhases;
using mcop::kPhaseScan;
using mcop::kUnitBf16;
using mcop::kUnitNoiseIn;
using mcop::kUnitSeeded;

constexpr int kSmemLimit = 232448;
constexpr unsigned kFullMask = 0xffffffffu;
// The decision's staged rows: llo, lhi and disc, or the eight policy_rows
// rows, of one column tile.
constexpr int kTabFloats = 8 * kTileCols;

struct Args {
  float* noise;         // [2 or 3, drawn, n]: the input, or the seeded
                        // workspace (draw_rows)
  const void* lt;       // [n, slab_ld(n)] half-scaled factor, zero past n:
                        // Lt' (upper), or Cr'; bf16 under the bf16 form,
                        // else float32
  const void* ci;       // the same of Ci' (spectral), or nullptr (chol)
  const float* vd;      // [n] half variance drift
  const float* llo;     // [n] log lower bounds (K7)
  const float* lhi;     // [n] log upper bounds (K7)
  const float* disc;    // [n] discounts (K7)
  const float* tab;     // the policy_rows table (K7's QUAD forms)
  long long tstride;    // its row stride, floats
  float* out;           // K6: [rows, n+1]; K7: [1 or 2][blocks] partial sums
  int rows, drawn, n;   // paths, rows of the noise plane (rows / 2 paired)
  uint32_t key;
  float r, dt, sqrt_dt, log_s0, s0, strike, cv_disc;
  int is_call;
  bool bf16;            // the bf16 fGN-input form
};

__host__ __device__ constexpr int smem_floats(int d, int bp, bool spec,
                                              bool bf16) {
  return ring_floats(d, spec, bf16) > kTabFloats + bp * kXStride
             ? ring_floats(d, spec, bf16)
             : kTabFloats + bp * kXStride;
}

template <int PM, bool ANTI = false, bool SPEC = false, bool BF16 = false>
struct Layout {
  static constexpr int kD = 16 * PM;
  static constexpr int kBP = ANTI ? 2 * kD : kD;
  static constexpr int kBytes = 4 * smem_floats(kD, kBP, SPEC, BF16);
};

// Seeded entry: draw the block's D rows of N and W into the workspace
// (SPEC: Zr = N, then Zi, then W): in float32 the noise-in layout; under
// BF16 the N (and Zi) planes as bf16 rows [drawn][slab_ld(n)], each normal
// rounded to nearest even, zero past n, then W [drawn][n] in float32
// (models/pathgen_tiled_cuda.py:workspace_floats).
template <int D, bool SPEC, bool BF16>
__device__ void draw_rows(const Args& a, int row0) {
  const int n = a.n, pairs = (n + 1) / 2;
  const size_t drawn = a.drawn;
  const int ld = BF16 ? slab_ld(n) : n;
  auto* nb = reinterpret_cast<__nv_bfloat16*>(a.noise);
  float* zplane = a.noise + drawn * n;                   // float32 Zi
  __nv_bfloat16* zb = nb + drawn * ld;                   // bf16 Zi
  float* wplane =
      a.noise + (SPEC ? 2 : 1) * drawn * (BF16 ? ld / 2 : n);
  auto put = [&](size_t row, int c, float v, bool zi) {
    if constexpr (BF16)
      (zi ? zb : nb)[row * ld + c] = __float2bfloat16_rn(v);
    else
      (zi ? zplane : a.noise)[row * n + c] = v;
  };
  for (int idx = threadIdx.x; idx < D * pairs; idx += kThreads) {
    const int p = idx / pairs, j = idx - p * pairs;
    float n0, w0, n1, w1;
    mcop::step_pair_normals(a.key, row0 + p, j, &n0, &w0, &n1, &w1);
    const size_t row = static_cast<size_t>(row0 + p);
    put(row, 2 * j, n0, false);
    wplane[row * n + 2 * j] = w0;
    if (2 * j + 1 < n) {
      put(row, 2 * j + 1, n1, false);
      wplane[row * n + 2 * j + 1] = w1;
    }
  }
  if (SPEC) {
    const int quads = (n + 3) / 4;
    for (int idx = threadIdx.x; idx < D * quads; idx += kThreads) {
      const int p = idx / quads, q = idx - p * quads;
      const float4 z = mcop::spectral_zi_quad(a.key, row0 + p, q);
      const float zv[4] = {z.x, z.y, z.z, z.w};
#pragma unroll
      for (int t = 0; t < 4; ++t)
        if (4 * q + t < n) put(row0 + p, 4 * q + t, zv[t], true);
    }
  }
  if (BF16) {
    const int pad = ld - n;
    for (int idx = threadIdx.x; idx < D * pad; idx += kThreads) {
      const int p = idx / pad, c = n + idx - p * pad;
      const size_t row = static_cast<size_t>(row0 + p);
      put(row, c, 0.0f, false);
      if (SPEC) put(row, c, 0.0f, true);
    }
  }
}

// The Euler log increment of one cell.  Every rounding is explicit (no
// multiply-add contraction), so a pair's partner (-x, -w) rounds exactly as
// the unpaired kernel on the negated noise does, in the plain versions'
// order.
__device__ __forceinline__ float euler_inc(const Args& a, float x, float w,
                                           int c) {
  const float sv = expf(x + a.vd[c]);
  const float v = __fmul_rn(sv, sv);
  return __fadd_rn(__fmul_rn(__fsub_rn(a.r, __fmul_rn(0.5f, v)), a.dt),
                   __fmul_rn(sv, __fmul_rn(w, a.sqrt_dt)));
}

// K6's output row of block member p (block rows start at drawn row row0):
// the drawn row, or under ANTI for p >= D the partner of drawn row p - D,
// `drawn` rows further down.
template <int D, bool ANTI>
__device__ __forceinline__ size_t member_row(int drawn, int row0, int p) {
  return static_cast<size_t>(ANTI && p >= D ? drawn + row0 + p - D
                                            : row0 + p);
}

// Copy rows 0 .. rows - 1 of a table (row r at row(r)) for the tile's
// columns c0 .. c0 + cn - 1 into tab [rows][kTileCols] and commit them;
// cp_async_wait<0> and a barrier make them visible.
template <class Row>
__device__ __forceinline__ void stage_rows(int rows, Row row, int c0, int cn,
                                           float* tab) {
  for (int idx = threadIdx.x; idx < rows * kTileCols; idx += kThreads) {
    const int r = idx / kTileCols, cc = idx - r * kTileCols;
    if (cc < cn) cp_async4(tab + idx, row(r) + c0 + cc, true);
  }
  cp_async_commit();
}

// The first column of the tile whose test holds, from the ballots of the
// lanes' tests of columns l + 32 h (b[h]), where one does.
__device__ __forceinline__ int first_hit4(const unsigned (&b)[4]) {
  return b[0]   ? __ffs(b[0]) - 1
         : b[1] ? 31 + __ffs(b[1])
         : b[2] ? 63 + __ffs(b[2])
                : 95 + __ffs(b[3]);
}

// Block of D = 16*PM drawn rows; BP = D paths, or 2D pair members (ANTI:
// member p < D is drawn row p, member D + p its partner).  CV adds the
// control lane, SPEC the spectral fGN form, QUAD the quadratic policy,
// BF16 the bf16 fGN-input form.
template <int PM, bool SEEDED, bool PRICED, bool ANTI, bool CV, bool SPEC,
          bool QUAD, bool BF16>
__global__ void __launch_bounds__(kThreads, 2) tiled_kernel(Args a) {
  using L = Layout<PM, ANTI, SPEC, BF16>;
  constexpr int D = L::kD;
  constexpr int BP = L::kBP;
  constexpr int kPaths = BP / kWarps;           // paths each warp decides
  constexpr bool kDecide = PRICED && (kPhases & kPhaseOut);
  constexpr Rows R = !BF16   ? Rows::kF32
                     : SEEDED ? Rows::kBf16
                              : Rows::kF32Round;
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);  // the product's k-tiles
  float* tab = ring;                            // [8][kTileCols] K7's rows
  float* xs = ring + kTabFloats;                // [BP][kXStride]

  const int n = a.n;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int row0 = blockIdx.x * D;              // first drawn row
  const size_t drawn = a.drawn;
  Operands o;
  const float* wrows;                           // W of the block's rows
  if (SEEDED && BF16) {
    const int ld = slab_ld(n);
    const auto* nb = reinterpret_cast<const __nv_bfloat16*>(a.noise);
    o.nrows = nb + static_cast<size_t>(row0) * ld;
    o.zrows = nb + (drawn + row0) * ld;
    o.nld = ld;
    wrows = a.noise + (SPEC ? 2 : 1) * drawn * ld / 2 +
            static_cast<size_t>(row0) * n;
  } else {
    const float* nrows = a.noise + static_cast<size_t>(row0) * n;
    o.nrows = nrows;
    o.zrows = nrows + drawn * n;
    o.nld = n;
    wrows = nrows + (SPEC ? 2 : 1) * drawn * n;
  }
  o.fac = a.lt;
  o.fci = a.ci;
  o.fld = slab_ld(n);
  o.n = n;

  if (SEEDED && (kPhases & kPhaseDraw)) {
    draw_rows<D, SPEC, BF16>(a, row0);
    __syncthreads();  // the block's workspace writes are visible to it
  }
  if (!PRICED) {
    for (int p = tid; p < BP; p += kThreads)
      a.out[member_row<D, ANTI>(a.drawn, row0, p) * (n + 1)] = a.s0;
  }

  // K6: the running log price of thread p < BP.  K7: its running sum of
  // the increments; bit j of `stopped` says path warp + kWarps j has
  // stopped (warp-uniform), and lane j keeps that path's value.
  float ls = a.log_s0, cum = 0.0f, val = 0.0f;
  unsigned stopped = 0u;

  for (int c0 = 0; c0 < n; c0 += kTileCols) {
    const int cn = min(c0 + kTileCols, n) - c0;
    tile_product<PM, SPEC, true, BF16, R>(o, c0, ring, xs);
    if constexpr (kDecide && QUAD)
      stage_rows(8, [&](int r) { return a.tab + r * a.tstride; }, c0, cn,
                 tab);
    else if constexpr (kDecide)
      stage_rows(3, [&](int r) {
        return r == 0 ? a.llo : r == 1 ? a.lhi : a.disc;
      }, c0, cn, tab);

    // Variance exp and Euler increment, elementwise over the tile (both
    // members of a pair from one x and one w).  Each thread reads the W of
    // its next kBatch cells before it computes them: the loads come from
    // L2 or device memory, and one at a time they left the pass waiting.
    constexpr int kBatch = 8;
    for (int base = tid; (kPhases & kPhaseEuler) && base < D * kTileCols;
         base += kThreads * kBatch) {
      float w[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int idx = base + u * kThreads;
        const int p = idx / kTileCols, cc = idx - p * kTileCols;
        w[u] = idx < D * kTileCols && cc < cn
                   ? wrows[static_cast<size_t>(p) * n + c0 + cc]
                   : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int idx = base + u * kThreads;
        const int p = idx / kTileCols, cc = idx - p * kTileCols;
        if (idx < D * kTileCols && cc < cn) {
          const int c = c0 + cc;
          float* xp = &xs[p * kXStride + cc];
          const float x = *xp;
          *xp = euler_inc(a, x, w[u], c);
          if (ANTI) xp[D * kXStride] = euler_inc(a, -x, -w[u], c);
        }
      }
    }
    __syncthreads();

    // The running sum along the tile, one thread per path; the carry
    // crosses tiles in registers.
    if ((kPhases & kPhaseScan) && tid < BP) {
      float* xp = &xs[tid * kXStride];
      for (int cc = 0; cc < cn; ++cc) {
        if (PRICED) {
          cum += xp[cc];
          xp[cc] = a.log_s0 + cum;
        } else {
          ls += xp[cc];
          xp[cc] = ls;
        }
      }
    }

    if constexpr (!PRICED && (kPhases & kPhaseOut)) {
      __syncthreads();
      for (int idx = tid; idx < BP * kTileCols; idx += kThreads) {
        const int p = idx / kTileCols, cc = idx - p * kTileCols;
        if (cc < cn)
          a.out[member_row<D, ANTI>(a.drawn, row0, p) * (n + 1) + c0 + cc +
                1] = expf(xs[p * kXStride + cc]);
      }
    } else if constexpr (kDecide) {
      cp_async_wait<0>();
      __syncthreads();

      // The decision: lanes on columns, the warp over its paths.  The
      // lane's rows at its four columns are read once per tile.
      bool valid[4];
      float lo[4], hi[4];
      mcop::QuadRows q[4];
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int cc = lane + 32 * h;
        valid[h] = cc < cn;
        if constexpr (QUAD) {
          q[h] = mcop::quad_rows(tab, kTileCols, cc);
        } else {
          lo[h] = tab[cc];
          hi[h] = tab[kTileCols + cc];
        }
      }
      // Path p's ballots b over the tile (bit l of b[h]: column l + 32 h
      // exercises) and the lane's values x at its columns: the log price,
      // or under QUAD the price.
      auto ballots = [&](int p, unsigned (&b)[4], float (&x)[4]) {
        const float* xp = &xs[p * kXStride + lane];
        if constexpr (QUAD) {
          // quad_exercise's test, p > eps and p >= cont; z and the
          // polynomial only where a lane's column pays over eps.
          float pay[4];
          bool over[4], any = false;
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            x[h] = expf(xp[32 * h]);
            pay[h] = mcop::quad_payoff(x[h], q[h].strike, a.is_call);
            over[h] = valid[h] & (pay[h] > q[h].eps);
            any |= over[h];
          }
          if (__any_sync(kFullMask, any)) {
#pragma unroll
            for (int h = 0; h < 4; ++h)
              b[h] = __ballot_sync(
                  kFullMask,
                  over[h] & (pay[h] >= mcop::quad_rows_cont(q[h], x[h])));
          } else {
#pragma unroll
            for (int h = 0; h < 4; ++h) b[h] = 0u;
          }
        } else {
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            x[h] = xp[32 * h];
            b[h] = __ballot_sync(
                kFullMask, valid[h] & (x[h] >= lo[h]) & (x[h] <= hi[h]));
          }
        }
      };
      unsigned hits = 0u;
#pragma unroll
      for (int j = 0; j < kPaths; ++j) {
        // A stopped path's exps and quadratics are skipped (warp-uniform);
        // the boundary test costs less than the branch.
        if (QUAD && ((stopped >> j) & 1u)) continue;
        unsigned b[4];
        float x[4];
        ballots(warp + kWarps * j, b, x);
        hits |= (b[0] | b[1] | b[2] | b[3]) != 0u ? 1u << j : 0u;
      }
      hits &= ~stopped;
      stopped |= hits;
      while (hits != 0u) {   // the paths whose first hit is in this tile
        const int j = __ffs(hits) - 1;
        hits &= hits - 1u;
        unsigned b[4];
        float x[4];
        ballots(warp + kWarps * j, b, x);
        const int c = first_hit4(b);
        const float mine = c < 32 ? x[0] : c < 64 ? x[1] : c < 96 ? x[2]
                                                                : x[3];
        const float xc = __shfl_sync(kFullMask, mine, c & 31);
        if (lane == j) {
          if constexpr (QUAD) {
            val = __fmul_rn(
                mcop::quad_payoff(xc, tab[7 * kTileCols + c], a.is_call),
                tab[6 * kTileCols + c]);
          } else {
            const float s = expf(xc);
            const float pay = a.is_call ? s - a.strike : a.strike - s;
            val = tab[2 * kTileCols + c] * fmaxf(pay, 0.0f);
          }
        }
      }
      // The next tile's product synchronises before it overwrites tab
      // and xs.
    }
  }

  if (PRICED) {
    __syncthreads();
    float* red = xs;                            // [BP], and [BP] more (CV)
    if (lane < kPaths) red[warp + kWarps * lane] = val;
    if (CV && tid < BP) red[BP + tid] = expf(a.log_s0 + cum);  // terminal
    __syncthreads();
    if (tid == 0) {
      float sum = 0.0f;
      for (int p = 0; p < BP; ++p) sum += red[p];
      a.out[blockIdx.x] = sum;
      if (CV) {
        float cv = 0.0f;
        for (int p = 0; p < BP; ++p) cv += red[BP + p];
        a.out[gridDim.x + blockIdx.x] = a.cv_disc * cv;
      }
    }
  }
}

using Kernel = void (*)(Args);

// A body of this unit and its shared memory.
struct Body {
  Kernel kernel;
  int smem;
};

template <int PM, bool SEEDED, bool PRICED, bool ANTI, bool CV, bool SPEC,
          bool QUAD>
Body body_pm() {
  constexpr int smem = Layout<PM, ANTI, SPEC, kUnitBf16>::kBytes;
  static_assert(smem <= kSmemLimit, "tile shapes exceed shared memory");
  return {tiled_kernel<PM, SEEDED, PRICED, ANTI, CV, SPEC, QUAD, kUnitBf16>,
          smem};
}

// The plain forms take 128, 64, 32 or 16 paths a block; the paired forms
// 128, 64 or 32 members (64, 32 or 16 drawn rows); chol or spectral.
template <bool SEEDED, bool PRICED, bool ANTI, bool CV, bool QUAD, bool SPEC>
Body body_of(int block_paths) {
  switch (ANTI ? block_paths / 2 : block_paths) {
    case 128:
      if constexpr (ANTI) return {nullptr, 0};
      else
        return body_pm<8, SEEDED, PRICED, ANTI, CV, SPEC, QUAD>();
    case 64:
      return body_pm<4, SEEDED, PRICED, ANTI, CV, SPEC, QUAD>();
    case 32:
      return body_pm<2, SEEDED, PRICED, ANTI, CV, SPEC, QUAD>();
    case 16:
      return body_pm<1, SEEDED, PRICED, ANTI, CV, SPEC, QUAD>();
    default:
      return {nullptr, 0};
  }
}

// The seeded or noise-in body, where this unit holds it.
template <bool PRICED, bool ANTI, bool CV, bool QUAD = false>
Body body_for(bool seeded, bool spec, int block_paths) {
  if (seeded) {
    if constexpr (kUnitSeeded)
      return spec ? body_of<true, PRICED, ANTI, CV, QUAD, true>(block_paths)
                  : body_of<true, PRICED, ANTI, CV, QUAD, false>(block_paths);
  } else {
    if constexpr (kUnitNoiseIn)
      return spec ? body_of<false, PRICED, ANTI, CV, QUAD, true>(block_paths)
                  : body_of<false, PRICED, ANTI, CV, QUAD, false>(
                        block_paths);
  }
  return {nullptr, 0};
}

// This unit's body of the form (K6: priced false), or a null kernel where
// the arguments name none.  The quadratic policy has no pair form.
Body find_body(bool priced, bool seeded, bool anti, bool cv, bool quad,
               bool spec, int block_paths) {
  if (block_paths < 16 || (anti && block_paths % 32) ||
      (quad && (anti || !priced)))
    return {nullptr, 0};
  if (quad)
    return cv ? body_for<true, false, true, true>(seeded, spec, block_paths)
              : body_for<true, false, false, true>(seeded, spec,
                                                   block_paths);
  if (!priced)
    return anti ? body_for<false, true, false>(seeded, spec, block_paths)
                : body_for<false, false, false>(seeded, spec, block_paths);
  if (anti)
    return cv ? body_for<true, true, true>(seeded, spec, block_paths)
              : body_for<true, true, false>(seeded, spec, block_paths);
  return cv ? body_for<true, false, true>(seeded, spec, block_paths)
            : body_for<true, false, false>(seeded, spec, block_paths);
}

cudaError_t set_smem(const Body& b) {
  cudaError_t err = cudaFuncSetAttribute(
      b.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, b.smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(b.kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// Launch K6 (priced false) or K7 over a.rows paths in blocks of block_paths.
cudaError_t launch(bool priced, Args a, int seeded, int block_paths,
                   bool anti, bool cv, bool quad, cudaStream_t stream) {
  if (a.n < 1 || a.rows < 1 || a.noise == nullptr || a.bf16 != kUnitBf16 ||
      block_paths < 1 || a.rows % block_paths)
    return cudaErrorInvalidValue;
  const Body b = find_body(priced, seeded != 0, anti, cv, quad,
                           a.ci != nullptr, block_paths);
  if (b.kernel == nullptr) return cudaErrorInvalidValue;
  a.drawn = anti ? a.rows / 2 : a.rows;
  cudaError_t err = set_smem(b);
  if (err != cudaSuccess) return err;
  const int d = anti ? block_paths / 2 : block_paths;
  b.kernel<<<a.drawn / d, kThreads, b.smem, stream>>>(a);
  return cudaGetLastError();
}

Args make_args(float* noise, const void* lt, const void* ci,
               const float* vd, int rows, int n_steps, unsigned int key,
               float r, float dt, float sqrt_dt, float log_s0, int bf16) {
  Args a{};
  a.bf16 = bf16 != 0;
  a.noise = noise;
  a.lt = lt;
  a.ci = ci;
  a.vd = vd;
  a.rows = rows;
  a.n = n_steps;
  a.key = key;
  a.r = r;
  a.dt = dt;
  a.sqrt_dt = sqrt_dt;
  a.log_s0 = log_s0;
  return a;
}

}  // namespace

extern "C" {

// The per-block shared memory of the tiled kernels at this block size
// (pair members when antithetic; the spectral form when spectral != 0) in
// this unit's fGN input dtype, or -1 for a block size they do not take.
// The control variate takes none more (with_cv is not read).
int MCOP_ENTRY(mcop_tiled_smem_bytes)(int block_paths, int antithetic,
                                      int with_cv, int spectral) {
  const int d = antithetic ? block_paths / 2 : block_paths;
  if (antithetic && (block_paths % 2 || d == 128)) return -1;
  const int pm = d / 16;
  if (d % 16 || (pm != 1 && pm != 2 && pm != 4 && pm != 8)) return -1;
  return 4 * smem_floats(d, antithetic ? 2 * d : d, spectral != 0,
                         kUnitBf16);
}

// Blocks of the K6 (priced == 0) or K7 form one SM runs at once, of this
// unit's seeded body (its noise-in one in a noise-in unit), by
// cudaOccupancyMaxActiveBlocksPerMultiprocessor at the form's shared
// memory; minus a cudaError_t where the arguments name no body or the
// query fails.
int MCOP_ENTRY(mcop_tiled_blocks_per_sm)(int block_paths, int priced,
                                         int antithetic, int with_cv,
                                         int spectral, int quadratic) {
  const Body b = find_body(priced != 0, kUnitSeeded, antithetic != 0,
                           with_cv != 0, quadratic != 0, spectral != 0,
                           block_paths);
  if (b.kernel == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = set_smem(b);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, b.kernel,
                                                        kThreads, b.smem);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// K6.  noise: [2, rows, n_steps] float32 (N, W; ci null: lt is Lt') or
// [3, rows, n_steps] (Zr, Zi, W; spectral: lt is Cr', ci is Ci'), read as
// given (seeded == 0), or a workspace filled first from the stream of
// `key` (seeded != 0, the _seeded units only; draw_rows' layout).  lt and
// ci: [n_steps, slab_ld(n_steps)], zero past n_steps.  bf16 != 0 (the
// _bf16 units only): the bf16 form, lt and ci bf16, the noise float32.
// rows counts paths; antithetic != 0 reads (or draws into the workspace)
// rows / 2 rows of noise, block_paths counts pair members, and out holds
// the drawn rows' paths, then their partners'.
int MCOP_ENTRY(mcop_tiled_pathgen)(
    float* noise, int seeded, const void* lt, const void* ci,
    const float* vd, int rows, int n_steps, int block_paths,
    unsigned int key, float r, float dt, float sqrt_dt, float log_s0,
    float s0, int antithetic, int bf16, float* out, void* stream) {
  Args a = make_args(noise, lt, ci, vd, rows, n_steps, key, r, dt, sqrt_dt,
                     log_s0, bf16);
  a.s0 = s0;
  a.out = out;
  return static_cast<int>(launch(false, a, seeded, block_paths,
                                 antithetic != 0, false, false,
                                 static_cast<cudaStream_t>(stream)));
}

// K7.  table: rows 0-2 of the log_boundary_rows table, or with
// quadratic != 0 the eight rows of the policy_rows table (its strike in row
// 7; `strike` is then not read), row stride table_stride floats.  noise,
// lt, ci and bf16 as K6's.  rows counts paths; antithetic != 0 (not with
// quadratic) reads (or draws into the workspace) rows / 2 rows of noise,
// and block_paths counts pair members.
// out: [rows / block_paths] partial sums, then as many control sums when
// with_cv != 0.
int MCOP_ENTRY(mcop_tiled_priced_chunk)(
    float* noise, int seeded, const void* lt, const void* ci,
    const float* vd, int rows, int n_steps, int block_paths,
    unsigned int key, float r, float dt, float sqrt_dt, float log_s0,
    const float* table, long long table_stride, float strike, int is_call,
    int antithetic, int with_cv, int quadratic, int bf16, float cv_disc,
    float* out, void* stream) {
  Args a = make_args(noise, lt, ci, vd, rows, n_steps, key, r, dt, sqrt_dt,
                     log_s0, bf16);
  a.llo = table;
  a.lhi = table + table_stride;
  a.disc = table + 2 * table_stride;
  a.tab = table;
  a.tstride = table_stride;
  a.strike = strike;
  a.is_call = is_call;
  a.cv_disc = cv_disc;
  a.out = out;
  return static_cast<int>(launch(true, a, seeded, block_paths,
                                 antithetic != 0, with_cv != 0,
                                 quadratic != 0,
                                 static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
