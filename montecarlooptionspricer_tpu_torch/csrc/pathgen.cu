// Fused rough-Bergomi path kernels for Hopper (sm_90a), bound through a
// plain C interface and loaded with ctypes (models/pathgen_cuda.py).
//
// K1 mcop_pathgen replaces montecarlooptionspricer_tpu/models/
//    pathgen_pallas.py:_pathgen_kernel (and _pathgen_kernel_noise_in),
//    chol and spectral fGN forms, plain and paired (the whole-path pair
//    body of _euler_from_noise:261 with _logpaths_from_x_anti:161).
// K2 mcop_priced_chunk replaces pathgen_pallas.py:_priced_kernel (and
//    _priced_kernel_noise_in), chol and spectral forms, interleave 1.
//    Log-boundary policy in four forms: plain, antithetic
//    (_logpaths_from_x_anti:161), control variate (_cv_log_sum:567,
//    _store_priced_log:577) and both (_priced_body:650); the quadratic
//    policy (QUAD: _priced_body's else branch, _policy_value:277 and
//    _store_priced:549) plain and with the control variate.
// Both also run the bf16 fGN-input form of every body (BF16, from the
//    bf16 flag; StreamConfig.fgn_matmul_dtype="bfloat16", _fgn_x:142 with
//    the bf16 matrices of _fgn_consts:1359), chol and spectral: K1 plain
//    and paired, K2 in its four boundary forms and its two quadratic ones.
//
// Build units (csrc/build_unit.cuh): this source is built four times, the
// float32 and the bf16 bodies, each seeded and noise-in, apart; an entry
// given a body its unit does not hold (the other dtype's flag, or the
// other noise source) returns cudaErrorInvalidValue.
//
// What they compute, per path p and step column c < n (column c = step c+1):
//   x_c    = sum_{k <= c} N[p,k] * Lt'[k,c]        (Lt' = 0.5 Lt, upper)
//            or, spectral (SPEC, ci non-null; _fgn_x:142):
//            sum_{k < n} Zr[p,k] Cr'[k,c] - Zi[p,k] Ci'[k,c]
//                                  (Cr' = 0.5 Cr, Ci' = 0.5 Ci, dense)
//   sv     = exp(x_c + vd[c])
//   inc    = (r - sv^2/2) dt + sv * W[p,c] * sqrt(dt)
//   logS_c = log s0 + sum_{k <= c} inc_k
// K1 writes out[p, 0] = s0 and out[p, c+1] = exp(logS_c); its pair form
// writes the drawn rows' paths to rows [0, rows/2) and their partners' to
// [rows/2, rows), the [X; -X] of the unpaired kernel (JAX lays each pair
// out inside each block instead; only the tests see the order).  K2 stops each
// path at the first c with llo[c] <= logS_c <= lhi[c] and adds
// disc[c] * max(+-(exp(logS_c) - strike), 0); each block writes one
// partial sum (no atomics, so a seed gives the same sum on every run).
// The QUAD forms stop each path instead at the first c where the policy
// table's quadratic says exercise (csrc/quad_policy.cuh, on
// s = exp(logS_c), strike from the table) and add disc[c] * payoff.
// The control-variate forms write a second partial sum per block,
// cv_disc * sum_p exp(logS_{p,n-1}) with cv_disc = exp(-r n dt).  The
// antithetic forms draw (or read) N and W for half the paths only: path q
// of a drawn row and its partner price (N, W) and (-N, -W), and the fGN
// map is linear, so the partner's plane is -x and the product runs once
// per pair.
//
// Bound on the H100: operations.  The fGN product is ~n^2/2 multiply-adds
// per path (67k at n = 365) against ~n transcendentals and n*4 bytes of
// output; at 131072 paths that is 8.8e9 FMA, 0.26 ms at the card's
// 67 TFLOP/s float32 (no tensor cores: full float32 is kept), while the
// bytes that must move (Lt', the output) take at most 0.06 ms.
// The antithetic forms run the product once per pair: half of that.
// The QUAD forms add, per cell up to the path's first hit, the exp of the
// price and ~10 operations of the policy, at most 4.8e7 x 30 operations a
// chunk (0.02 ms at the peak).
// The spectral product is two dense [n, n] products, 2 n^2 multiply-adds
// per path (266k at n = 365, four times the triangle): 1.05 ms at 131072
// paths, 0.53 ms paired.
// The bf16 form runs the triangle on the tensor cores (989 TFLOP/s dense
// bf16): 0.02 ms of product at 131072 paths (the spectral form's two dense
// products 0.07 ms), so the exp, the Box-Muller draws and the running sum
// bound it; K1 also writes its [rows, n + 1] prices, 192 MB at 365 steps,
// 0.057 ms at the card's 3.35 TB/s.
//
// Design:
// * One block of 256 threads owns BP = 16*PM paths (64, 32 or 16).  Its N
//   plane (and Zi) lives in dynamic shared memory for the whole block
//   (row stride n rounded up to odd, so the rows of a warp fall on
//   distinct banks); paths never touch device memory in K2.
// * The TPU grid ran blocks in order on one core; here blocks are
//   independent.  The seeded stream depends only on the global row index
//   and the step (Philox4x32-10 counter = (row, step pair, 0, 0), key =
//   (folded seed word, 0); csrc/philox.cuh, shared with the step-tiled
//   kernels), never on the block size or schedule.
// * The step axis runs in tiles of 64 columns.  For each tile the block
//   computes the X tile as a register-tiled product (each thread a PM x 4
//   micro-tile; Lt' staged through shared memory 32 rows at a time; the
//   triangle is used: rows past the tile's last column are skipped), then
//   the variance exp and Euler increment elementwise over the tile with all
//   threads, then the running log price with one thread per path.  Padded
//   steps are never computed.
// * K1 and K2 are one body (tile_kernel; PRICED false is K1) and keep no
//   W plane: the Euler pass takes each tile's W per step pair, redrawn
//   from the seeded stream at the counter load_noise uses, or read from
//   the injected plane (csrc/strip_sweep.cuh:tile_w_pair), so W is the
//   same bits wherever it is read.  The log price is log s0 plus the
//   running sum of the increments, JAX's association (log_s0 + the cumsum
//   matmul, _logpaths_from_x_anti:161) and the plain version's, carried
//   along each tile one step after another by one thread per path: a few
//   microseconds of dependent adds a block, while another block of the SM
//   runs its product.  Without W the bf16 chol block at 365 steps takes
//   69,888 bytes, so three share an SM, and the float32 chol block,
//   staging Lt' 16 rows a pass (priced_tile_k), 114,176, so two do
//   (__launch_bounds__ per form, tile_kernel).  Each kernel has its own
//   block (models/pathgen_cuda.py pathgen_block_paths, priced_block_paths:
//   the largest that fits, below measured caps).  The single-tile
//   family's range is still set by the layout with a resident W plane
//   (models/pathgen_cuda.py range_smem_bytes, max_block_paths): K1's own
//   block does not move a horizon from one family to another.
// * K1 writes each tile's prices once its log prices stand: exp of each
//   cell, neighbouring lanes on neighbouring steps of one path's row.
// * K2's decision, JAX's min-index reduction over columns
//   (_priced_log_subvals:589, _policy_value:277), runs as a parallel pass
//   once the tile's log prices stand: warp w owns paths w, w + 8, ...
//   (BP / 8 of them), and lane l tests columns l and l + 32.  For each path
//   the warp takes two ballots (columns 0-31, then 32-63: bit order is
//   column order), all with no branch; then, for each path that had not
//   stopped and hits in this tile (one warp-uniform branch), first_hit
//   gives the column, the hit column's lane supplies its log price (or
//   price) by shuffle, and lane j keeps path j's value.  A path stopped in
//   an earlier tile is masked; no thread walks columns one by one and
//   nothing exits early.  The boundary forms test llo <= logS <= lhi in log
//   space and take the exp only for the hit; the QUAD forms take exp of
//   each lane's two columns once per tile and test quad_exercise's
//   arithmetic (IEEE division, as _policy_value divides), z and the
//   polynomial only for a path some lane's column pays on, and skip a
//   stopped path.
// * The rows the decision reads for the tile's 64 columns (llo, lhi and
//   disc, or the eight policy_rows rows under QUAD) are copied with
//   cp.async into the staged factor tiles' room once the tile's product is
//   done with it, and waited for after the running sum, so the copy
//   overlaps the Euler pass and takes no shared memory of its own.
// * K2's partial sums are reduced in a fixed order through the X tile: no
//   atomics.  Shared memory (priced_smem_bytes): the planes, one X tile of
//   every member and the staged factor tiles, in either policy.
// * Antithetic blocks hold BP/2 drawn rows of N (the product's micro-tile maps 16*PM drawn rows onto the 256 threads, so a
//   paired block of 32*PM paths reuses the unpaired block's product of
//   16*PM) and an X tile of BP paths: the elementwise pass writes both
//   members' increments from one x and one w.  A paired K1 block draws
//   the same (global drawn row, step pair) counters as a paired K2 block,
//   so one key gives both kernels the same pairs, and it writes its
//   partner rows `drawn` rows below the drawn ones (member_row).
// * The spectral form (SPEC, from the ci pointer) keeps a second plane,
//   Zi, beside Zr (in the N plane), and stages Cr' and Ci' k-tiles side by
//   side; every column tile sums over all n rows, the matrices being
//   dense.  Its seeded Zr and W are the chol stream's N and W and its Zi
//   the stream's own counter word (csrc/philox.cuh), drawn by K1 and K2
//   alike, so one key gives both the same paths and pairs.
// * The bf16 form (BF16) keeps its N plane in bf16 (each normal rounded to
//   nearest even, the stride padded to whole k16 steps with zeros), and
//   each warp runs 8 columns of the 64-column tile as m16n8k16 tensor-core
//   products with float32 sums (csrc/fgn_tile.cuh:fgn_tile_mma), skipping
//   the k16 steps past its last column.  Under SPEC both Zr and Zi are
//   bf16 planes (zero past n), Cr' and Ci' k-tiles are staged side by
//   side, and the dense product runs every k < n with the Zi fragment
//   negated into the one accumulator.  W, the variance exp, the Euler
//   increment, the running sum and the decision are the float32 form's.
//   A pair's partner is -x to the bit, as in the float32 form.
// * No --use_fast_math: logf/expf/sinf/cosf stay precise and / stays IEEE
//   division, so the plain PyTorch versions agree to a few ulp per cell.

#include <cuda_runtime.h>
#include <stdint.h>

#include "build_unit.cuh"
#include "fgn_tile.cuh"
#include "quad_policy.cuh"
#include "strip_sweep.cuh"

namespace {

using namespace mcop;

struct Args {
  const float* noise;   // [2 or 3, drawn, n] or nullptr (seeded entry)
  const void* lt;       // [n, n] half-scaled factor: Lt' (upper), or Cr';
                        // bf16 under the bf16 form, else float32
  const void* ci;       // [n, n] Ci' (spectral, the dtype of lt), or
                        // nullptr (chol)
  const float* vd;      // [n] half variance drift
  const float* llo;     // [n] log lower bounds (K2)
  const float* lhi;     // [n] log upper bounds (K2)
  const float* disc;    // [n] discounts (K2)
  const float* tab;     // the policy_rows table (K2's QUAD forms)
  long long tstride;    // its row stride, floats
  float* out;           // K1: [rows, n+1]; K2: [1 or 2][blocks] partial sums
  int rows, drawn, n, ld;  // paths, rows of the noise planes, steps, stride
  uint32_t key;
  float r, dt, sqrt_dt, log_s0, s0, strike, cv_disc;
  int is_call;
  bool bf16;            // the bf16 fGN-input form
};

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

// K1's output row of block member p (block rows start at drawn row row0):
// the drawn row, or under ANTI for p >= D the partner of drawn row p - D,
// `drawn` rows further down.
template <int D, bool ANTI>
__device__ __forceinline__ size_t member_row(int drawn, int row0, int p) {
  return static_cast<size_t>(ANTI && p >= D ? drawn + row0 + p - D
                                            : row0 + p);
}

// Rows K2's decision reads per tile: llo, lhi and disc, or the eight
// policy_rows rows under the quadratic policy.
__host__ __device__ constexpr int priced_rows(bool quad) {
  return quad ? 8 : 3;
}

// Rows of Lt' K2 (priced) or K1 stages per pass of its float32 product:
// 16 for the unpaired chol block, whose shared memory then fits two blocks
// an SM at 365 steps, 8 for K1's spectral pair (two blocks an SM where 32
// rows leave one), else kTileK.  The product's sums run k ascending
// whatever the depth, so X is the same bits.
__host__ __device__ constexpr int priced_tile_k(bool anti, bool spec,
                                                bool bf16,
                                                bool priced = true) {
  return !anti && !spec && !bf16            ? 16
         : !priced && anti && spec && !bf16 ? 8
                                            : kTileK;
}

// Copy rows 0 .. rows - 1 of a table (row r at row(r)) for the tile's
// columns c0 .. c0 + cn - 1 into tab [rows][kTileCols], asynchronously;
// cp_async_wait_all and a barrier make them visible.  Columns past cn are
// left as they were.
template <class Row>
__device__ __forceinline__ void stage_rows(int rows, Row row, int c0, int cn,
                                           float* tab) {
  for (int idx = threadIdx.x; idx < rows * kTileCols; idx += kThreads) {
    const int r = idx / kTileCols, cc = idx - r * kTileCols;
    if (cc >= cn) continue;
    const unsigned dst =
        static_cast<unsigned>(__cvta_generic_to_shared(tab + idx));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
                 "l"(row(r) + c0 + cc)
                 : "memory");
  }
}

// K1 (PRICED false) and K2.  Block of D = 16*PM drawn rows; BP = D paths,
// or 2D pair members (ANTI: member p < D is drawn row p, member D + p its
// partner).  CV adds K2's control lane, SPEC the spectral fGN form, QUAD
// K2's quadratic policy, BF16 the bf16 fGN-input form.  The launch bounds'
// minimum of blocks an SM caps the registers (128 a thread at 2, 80 at 3):
// at 365 steps three bf16 blocks fit an SM, but the paired chol one (two),
// and two float32 unpaired chol blocks or three paired ones; the float32
// spectral ones fit one.
template <int PM, bool SEEDED, bool PRICED, bool ANTI, bool CV, bool SPEC,
          bool QUAD, bool BF16>
__global__ void __launch_bounds__(kThreads,
                                  BF16 && (SPEC || !ANTI) ? 3 : 2)
    tile_kernel(Args a) {
  constexpr int D = 16 * PM;
  constexpr int BP = ANTI ? 2 * D : D;
  constexpr int kPaths = BP / kWarps;     // paths each warp decides
  constexpr bool kDecide = PRICED && (kPhases & kPhaseOut);
  constexpr int kHalf = kTileCols / 2;
  constexpr int TK = priced_tile_k(ANTI, SPEC, BF16, PRICED);
  static_assert(!PRICED || staged_floats(1, BF16, TK) >= 8 * kTileCols,
                "the staged rows live in the factor tiles' room");
  using E = fgn_elem<BF16>;
  extern __shared__ float smem[];
  const int n = a.n;
  const int npf = n_plane_floats(n, D, BF16);
  E* ns = reinterpret_cast<E*>(smem);     // [D][ld] N (Zr); bf16: [D][ldn]
  E* zs = reinterpret_cast<E*>(smem + npf);   // the same, Zi under SPEC
  float* xs = smem + (SPEC ? 2 : 1) * npf;    // [BP][kXStride]
  E* lts = reinterpret_cast<E*>(xs + BP * kXStride);
                                          // [1 or 2][TK][kTileCols];
                                          // bf16: [kTileCols][kTileKB]
  // [priced_rows][kTileCols]: the decision's rows, staged in the factor
  // tiles' room once the tile's product is done with it.
  float* tab = xs + BP * kXStride;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int row0 = blockIdx.x * D;        // first drawn row
  if (!SEEDED || (kPhases & kPhaseDraw))
    load_noise<D, SEEDED, SPEC, BF16, false>(a.noise, a.drawn, n, a.key,
                                             row0, ns, nullptr, zs);
  if (!PRICED) {
    for (int p = tid; p < BP; p += kThreads)
      a.out[member_row<D, ANTI>(a.drawn, row0, p) * (n + 1)] = a.s0;
  }

  float cum = 0.0f;   // running sum of the log increments, thread tid < BP
  // Bit j: path warp + kWarps * j has stopped (warp-uniform); lane j keeps
  // that path's value.
  unsigned stopped = 0u;
  float val = 0.0f;

  for (int c0 = 0; c0 < n; c0 += kTileCols) {
    const int cn = min(c0 + kTileCols, n) - c0;
    __syncthreads();   // the last tile's decision is done with tab and xs
    fgn_tile<PM, 1, SPEC, BF16, TK>(static_cast<const E*>(a.lt),
                                    static_cast<const E*>(a.ci), n, c0, ns,
                                    lts, xs, nullptr, zs);
    if constexpr (kDecide && QUAD)
      stage_rows(priced_rows(true),
                 [&](int r) { return a.tab + r * a.tstride; }, c0, cn, tab);
    else if constexpr (kDecide)
      stage_rows(priced_rows(false), [&](int r) {
        return r == 0 ? a.llo : r == 1 ? a.lhi : a.disc;
      }, c0, cn, tab);

    // Variance exp and Euler increment of each step pair (both members of
    // a pair from one x and one w), W drawn or read here.
    for (int idx = tid; (kPhases & kPhaseEuler) && idx < D * kHalf;
         idx += kThreads) {
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
          if (ANTI)
            xp[D * kXStride + t] = euler_inc(a, -x, -w[t], c0 + cc + t);
        }
      }
    }
    __syncthreads();

    // Running log price along the tile, one thread per path: log s0 plus
    // the running sum of the increments.
    if ((kPhases & kPhaseScan) && tid < BP) {
      float* xp = &xs[tid * kXStride];
      for (int cc = 0; cc < cn; ++cc) {
        cum += xp[cc];
        xp[cc] = a.log_s0 + cum;
      }
    }
    if constexpr (!kDecide) {
      // K1's prices, neighbouring lanes on neighbouring steps.
      __syncthreads();
      for (int idx = tid; !PRICED && (kPhases & kPhaseOut) &&
                          idx < BP * kTileCols;
           idx += kThreads) {
        const int p = idx / kTileCols, cc = idx - p * kTileCols;
        if (cc < cn)
          a.out[member_row<D, ANTI>(a.drawn, row0, p) * (n + 1) + c0 + cc +
                1] = expf(xs[p * kXStride + cc]);
      }
      continue;   // the next tile synchronises before it overwrites xs
    }
    cp_async_wait_all();
    __syncthreads();

    // The decision: lanes on columns, the warp over its paths.  The lane's
    // rows at its two columns are read once per tile.
    const bool valid[2] = {lane < cn, lane + 32 < cn};
    float lo[2], hi[2];
    QuadRows q[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if constexpr (QUAD) {
        q[h] = quad_rows(tab, kTileCols, lane + 32 * h);
      } else {
        lo[h] = tab[lane + 32 * h];
        hi[h] = tab[kTileCols + lane + 32 * h];
      }
    }
    // Path p's ballots b over the tile (bit l of b[h]: column l + 32 h
    // exercises) and the lane's values x at its columns: the log price, or
    // under QUAD the price.
    auto ballots = [&](int p, unsigned b[2], float x[2]) {
      const float* xp = &xs[p * kXStride + lane];
      if constexpr (QUAD) {
        // quad_exercise's test, p > eps and p >= cont; z and the
        // polynomial only where a lane's column pays over eps.
        float pay[2];
        bool over[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          x[h] = expf(xp[32 * h]);
          pay[h] = quad_payoff(x[h], q[h].strike, a.is_call);
          over[h] = valid[h] & (pay[h] > q[h].eps);
        }
        if (__any_sync(kFullMask, over[0] | over[1])) {
#pragma unroll
          for (int h = 0; h < 2; ++h)
            b[h] = __ballot_sync(
                kFullMask, over[h] & (pay[h] >= quad_rows_cont(q[h], x[h])));
        } else {
          b[0] = b[1] = 0u;
        }
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          x[h] = xp[32 * h];
          b[h] = __ballot_sync(kFullMask,
                               valid[h] & (x[h] >= lo[h]) & (x[h] <= hi[h]));
        }
      }
    };
    unsigned hits = 0u;
#pragma unroll
    for (int j = 0; j < kPaths; ++j) {
      // A stopped path's exps and quadratics are skipped (warp-uniform);
      // the boundary test costs less than the branch.
      if (QUAD && ((stopped >> j) & 1u)) continue;
      unsigned b[2];
      float x[2];
      ballots(warp + kWarps * j, b, x);
      hits |= (b[0] | b[1]) != 0u ? 1u << j : 0u;
    }
    hits &= ~stopped;
    stopped |= hits;
    while (hits != 0u) {   // the paths whose first hit is in this tile
      const int j = __ffs(hits) - 1;
      hits &= hits - 1u;
      unsigned b[2];
      float x[2];
      ballots(warp + kWarps * j, b, x);
      const int c = first_hit(b[0], b[1]);
      const float xc = __shfl_sync(kFullMask, c < 32 ? x[0] : x[1], c & 31);
      if (lane == j) {
        if constexpr (QUAD) {
          val = __fmul_rn(
              quad_payoff(xc, tab[7 * kTileCols + c], a.is_call),
              tab[6 * kTileCols + c]);
        } else {
          const float s = expf(xc);
          const float pay = a.is_call ? s - a.strike : a.strike - s;
          val = tab[2 * kTileCols + c] * fmaxf(pay, 0.0f);
        }
      }
    }
    // The next tile synchronises before it overwrites tab and xs.
  }

  if (!PRICED) return;
  __syncthreads();
  float* red = xs;                        // [BP], and [BP] more under CV
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

// Shared memory of a K2 (priced) or K1 block: the planes without W, one X
// tile of every member (K2's partial sums at the end) and the staged factor
// tiles of priced_tile_k rows (K2's decision rows in their room), in
// either policy.
int priced_smem_bytes(int n, int bp, bool anti, bool spec, bool bf16,
                      bool priced = true) {
  const int d = anti ? bp / 2 : bp;
  return 4 * ((spec ? 2 : 1) * n_plane_floats(n, d, bf16) + bp * kXStride +
              staged_floats(spec ? 2 : 1, bf16,
                            priced_tile_k(anti, spec, bf16, priced)));
}

using Kernel = void (*)(Args);

// This unit's K1 (PRICED false) or K2 body of the form, or null where the
// unit holds none.
template <int PM, bool PRICED, bool ANTI, bool CV, bool QUAD>
Kernel unit_body(bool seeded, bool spec) {
  if (seeded) {
    if constexpr (kUnitSeeded)
      return spec ? tile_kernel<PM, true, PRICED, ANTI, CV, true, QUAD,
                                kUnitBf16>
                  : tile_kernel<PM, true, PRICED, ANTI, CV, false, QUAD,
                                kUnitBf16>;
  } else {
    if constexpr (kUnitNoiseIn)
      return spec ? tile_kernel<PM, false, PRICED, ANTI, CV, true, QUAD,
                                kUnitBf16>
                  : tile_kernel<PM, false, PRICED, ANTI, CV, false, QUAD,
                                kUnitBf16>;
  }
  return nullptr;
}

template <int PM>
Kernel body_of(bool priced, bool seeded, bool anti, bool cv, bool spec,
               bool quad) {
  if (!priced)
    return anti ? unit_body<PM, false, true, false, false>(seeded, spec)
                : unit_body<PM, false, false, false, false>(seeded, spec);
  if (quad)
    return cv ? unit_body<PM, true, false, true, true>(seeded, spec)
              : unit_body<PM, true, false, false, true>(seeded, spec);
  if (anti)
    return cv ? unit_body<PM, true, true, true, false>(seeded, spec)
              : unit_body<PM, true, true, false, false>(seeded, spec);
  return cv ? unit_body<PM, true, false, true, false>(seeded, spec)
            : unit_body<PM, true, false, false, false>(seeded, spec);
}

// This unit's body of the form (block_paths counts paths, pair members when
// anti: 16, 32 or 64 plain, 32, 64 or 128 paired), or null where the
// arguments name none.  The quadratic policy (quad) has no pair form, and
// K1 (priced false) no policy.
Kernel kernel_for(bool priced, int n, int block_paths, bool seeded,
                  bool anti, bool cv, bool spec, bool quad) {
  const int unit = anti ? 32 : 16;
  if (n < 1 || block_paths < unit || block_paths % unit ||
      (quad && (anti || !priced)) || (!priced && cv) ||
      priced_smem_bytes(n, block_paths, anti, spec, kUnitBf16, priced) >
          kSmemLimit)
    return nullptr;
  switch (block_paths / unit) {
    case 4:
      return body_of<4>(priced, seeded, anti, cv, spec, quad);
    case 2:
      return body_of<2>(priced, seeded, anti, cv, spec, quad);
    case 1:
      return body_of<1>(priced, seeded, anti, cv, spec, quad);
    default:
      return nullptr;
  }
}

// Launch K1 (priced false) or K2 over a.rows paths in blocks of block_paths.
cudaError_t launch(bool priced, Args a, int block_paths, bool anti, bool cv,
                   bool quad, cudaStream_t stream) {
  const bool spec = a.ci != nullptr;
  const Kernel k = kernel_for(priced, a.n, block_paths, a.noise == nullptr,
                              anti, cv, spec, quad);
  if (k == nullptr || a.bf16 != kUnitBf16 || a.rows < 1 ||
      a.rows % block_paths)
    return cudaErrorInvalidValue;
  a.drawn = anti ? a.rows / 2 : a.rows;
  const int smem =
      priced_smem_bytes(a.n, block_paths, anti, spec, kUnitBf16, priced);
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int d = anti ? block_paths / 2 : block_paths;
  k<<<a.drawn / d, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// Blocks of the K1 (priced false) or K2 form one SM runs at once, of this
// unit's seeded body (its noise-in one in a noise-in unit), by
// cudaOccupancyMaxActiveBlocksPerMultiprocessor at the form's shared
// memory; minus a cudaError_t where the arguments name no body or the
// query fails.
int blocks_per_sm(bool priced, int n, int block_paths, bool anti, bool cv,
                  bool spec, bool quad) {
  const Kernel k = kernel_for(priced, n, block_paths, kUnitSeeded, anti, cv,
                              spec, quad);
  if (k == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  const int smem =
      priced_smem_bytes(n, block_paths, anti, spec, kUnitBf16, priced);
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, kThreads,
                                                        smem);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

}  // namespace

extern "C" {

// Shared memory of a K2 block of block_paths paths (pair members when
// antithetic != 0), the spectral form when spectral != 0, in this unit's
// fGN input dtype (the policy and the control variate take none more).
int MCOP_ENTRY(mcop_priced_smem_bytes)(int n_steps, int block_paths,
                                       int antithetic, int spectral) {
  return priced_smem_bytes(n_steps, block_paths, antithetic != 0,
                           spectral != 0, kUnitBf16);
}

// The same of a K1 block.
int MCOP_ENTRY(mcop_path_smem_bytes)(int n_steps, int block_paths,
                                     int antithetic, int spectral) {
  return priced_smem_bytes(n_steps, block_paths, antithetic != 0,
                           spectral != 0, kUnitBf16, false);
}

// Blocks of the K2 form one SM runs at once (blocks_per_sm).
int MCOP_ENTRY(mcop_priced_blocks_per_sm)(int n_steps, int block_paths,
                                          int antithetic, int with_cv,
                                          int spectral, int quadratic) {
  return blocks_per_sm(true, n_steps, block_paths, antithetic != 0,
                       with_cv != 0, spectral != 0, quadratic != 0);
}

// Blocks of the K1 form one SM runs at once (blocks_per_sm).
int MCOP_ENTRY(mcop_path_blocks_per_sm)(int n_steps, int block_paths,
                                        int antithetic, int spectral) {
  return blocks_per_sm(false, n_steps, block_paths, antithetic != 0, false,
                       spectral != 0, false);
}

// K1.  noise may be null (seeded entry, stream of `key`).  lt is Lt' (chol,
// ci null) or Cr' (spectral, ci = Ci'); noise is then [2, rows, n_steps]
// (N, W) or [3, rows, n_steps] (Zr, Zi, W).  bf16 != 0 (the _bf16 units
// only): the bf16 form, lt and ci bf16, noise float32 (N, and Zi, rounded
// as they are read).  rows counts paths; antithetic != 0 reads (or draws)
// rows / 2 rows of noise, block_paths counts pair members, and out holds
// the drawn rows' paths, then their partners'.
int MCOP_ENTRY(mcop_pathgen)(const float* noise, const void* lt,
                             const void* ci, const float* vd, int rows,
                             int n_steps, int block_paths, unsigned int key,
                             float r, float dt, float sqrt_dt, float log_s0,
                             float s0, int antithetic, int bf16, float* out,
                             void* stream) {
  Args a{};
  a.noise = noise;
  a.lt = lt;
  a.ci = ci;
  a.vd = vd;
  a.out = out;
  a.rows = rows;
  a.n = n_steps;
  a.ld = n_steps | 1;
  a.key = key;
  a.r = r;
  a.dt = dt;
  a.sqrt_dt = sqrt_dt;
  a.log_s0 = log_s0;
  a.s0 = s0;
  a.bf16 = bf16 != 0;
  return static_cast<int>(launch(false, a, block_paths, antithetic != 0,
                                 false, false,
                                 static_cast<cudaStream_t>(stream)));
}

// K2.  table: rows 0-2 of the log_boundary_rows table, or with
// quadratic != 0 the eight rows of the policy_rows table (its strike in row
// 7; `strike` is then not read), row stride table_stride floats.  lt, ci,
// bf16 and the noise planes as K1's.  rows counts paths; antithetic != 0
// (not with quadratic) reads (or draws) rows / 2 rows of noise.  out:
// [rows / block_paths] partial sums, then as many control sums when
// with_cv != 0.
int MCOP_ENTRY(mcop_priced_chunk)(
    const float* noise, const void* lt, const void* ci, const float* vd,
    int rows, int n_steps, int block_paths, unsigned int key, float r,
    float dt, float sqrt_dt, float log_s0, const float* table,
    long long table_stride, float strike, int is_call, int antithetic,
    int with_cv, int quadratic, int bf16, float cv_disc, float* out,
    void* stream) {
  Args a{};
  a.noise = noise;
  a.lt = lt;
  a.ci = ci;
  a.vd = vd;
  a.llo = table;
  a.lhi = table + table_stride;
  a.disc = table + 2 * table_stride;
  a.tab = table;
  a.tstride = table_stride;
  a.out = out;
  a.rows = rows;
  a.n = n_steps;
  a.ld = n_steps | 1;
  a.key = key;
  a.r = r;
  a.dt = dt;
  a.sqrt_dt = sqrt_dt;
  a.log_s0 = log_s0;
  a.strike = strike;
  a.cv_disc = cv_disc;
  a.is_call = is_call;
  a.bf16 = bf16 != 0;
  return static_cast<int>(launch(true, a, block_paths, antithetic != 0,
                                 with_cv != 0, quadratic != 0,
                                 static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
