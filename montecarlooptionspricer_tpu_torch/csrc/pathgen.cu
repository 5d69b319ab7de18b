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
// chunk (0.02 ms at the peak), on the one-thread-per-path running sum.
// The spectral product is two dense [n, n] products, 2 n^2 multiply-adds
// per path (266k at n = 365, four times the triangle): 1.05 ms at 131072
// paths, 0.53 ms paired.
// The bf16 form runs the triangle on the tensor cores (989 TFLOP/s dense
// bf16): 0.02 ms of product at 131072 paths (the spectral form's two dense
// products 0.07 ms), so the exp, the Box-Muller draws and the serial
// running sum bound it.
//
// Design:
// * One block of 256 threads owns BP = 16*PM paths (64, 32 or 16, the
//   largest whose planes fit the 227 KB of shared memory).  Its N and W
//   planes live in dynamic shared memory for the whole block (row stride
//   n rounded up to odd, so the rows of a warp fall on distinct banks);
//   paths never touch device memory in K2.
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
//   threads, then the running sum and the first-hit test with one thread
//   per path.  The TPU's triangular-matmul cumsum and min-index reduction
//   become that sequential loop; padded steps are never computed.
// * Antithetic blocks hold BP/2 drawn rows of N and W (the product's
//   micro-tile maps 16*PM drawn rows onto the 256 threads, so a paired
//   block of 32*PM paths reuses the unpaired block's product of 16*PM) and
//   an X tile of BP paths: the elementwise pass writes both members'
//   increments from one x and one w.  Halving the planes lets a 128-path
//   paired block fit at 365 steps (229,376 bytes).  A paired K1 block
//   draws the same (global drawn row, step pair) counters as a paired K2
//   block, so one key gives both kernels the same pairs, and it writes its
//   partner rows `drawn` rows below the drawn ones (member_row).
// * The spectral form (SPEC, from the ci pointer) keeps a third plane, Zi,
//   beside Zr (in the N plane) and W, and stages Cr' and Ci' k-tiles side
//   by side; every column tile sums over all n rows, the matrices being
//   dense.  Three planes at 365 steps fit 32 paths (64 members paired),
//   not 64.  Its seeded Zr and W are the chol stream's N and W and its Zi
//   the stream's own counter word (csrc/philox.cuh), drawn by K1 and K2
//   alike, so one key gives both the same paths and pairs.
// * The QUAD forms test the quadratic in the same one-thread-per-path loop
//   as the running sum: a path takes exp and the policy's seven table rows
//   (through the read-only cache, __ldg) at each step until its first hit,
//   then only the running sum (kept for the control lane).  The tables stay
//   in device memory; shared memory is the boundary forms'.
// * The bf16 form (BF16) keeps its N plane in bf16 (each normal rounded to
//   nearest even, the stride padded to whole k16 steps with zeros) beside
//   the float32 W plane, and each warp runs 8 columns of the 64-column
//   tile as m16n8k16 tensor-core products with float32 sums
//   (csrc/fgn_tile.cuh:fgn_tile_mma), skipping the k16 steps past its
//   last column.  Under SPEC both Zr and Zi are bf16 planes (zero past
//   n), Cr' and Ci' k-tiles are staged side by side, and the dense product
//   runs every k < n with the Zi fragment negated into the one
//   accumulator.  The variance exp, the Euler increment, the running sum,
//   the first-hit test and the QUAD policy are the float32 form's.  A
//   pair's partner is -x to the bit, as in the float32 form.  It keeps
//   the float32 form's path blocks (its planes take less shared memory).
// * No --use_fast_math: logf/expf/sinf/cosf stay precise and / stays IEEE
//   division, so the plain PyTorch versions agree to a few ulp per cell.

#include <cuda_runtime.h>
#include <stdint.h>

#include "build_unit.cuh"
#include "fgn_tile.cuh"
#include "quad_policy.cuh"

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

// Block of D = 16*PM drawn rows; BP = D paths, or 2D pair members (ANTI:
// member p < D is drawn row p, member D + p its partner).  CV adds the
// control lane, SPEC the spectral fGN form, QUAD the quadratic policy,
// BF16 the bf16 fGN-input form.
template <int PM, bool SEEDED, bool PRICED, bool ANTI, bool CV, bool SPEC,
          bool QUAD, bool BF16>
__global__ void __launch_bounds__(kThreads, 1) path_kernel(Args a) {
  constexpr int D = 16 * PM;
  constexpr int BP = ANTI ? 2 * D : D;
  using E = fgn_elem<BF16>;
  extern __shared__ float smem[];
  const int n = a.n, ld = a.ld;
  const int npf = n_plane_floats(n, D, BF16);
  E* ns = reinterpret_cast<E*>(smem);     // [D][ld] N (Zr); bf16: [D][ldn]
  E* zs = reinterpret_cast<E*>(smem + npf);   // the same, Zi under SPEC
  float* ws = smem + (SPEC ? 2 : 1) * npf;    // [D][ld]
  float* xs = ws + D * ld;                // [BP][kXStride]
  E* lts = reinterpret_cast<E*>(xs + BP * kXStride);
                                          // [1 or 2][kTileK][kTileCols];
                                          // bf16: [kTileCols][kTileKB]
  float* red = xs + BP * kXStride + staged_floats(SPEC ? 2 : 1, BF16);
                                          // [BP], and [BP] more under CV

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * D;        // first drawn row

  load_noise<D, SEEDED, SPEC, BF16>(a.noise, a.drawn, n, a.key, row0, ns, ws,
                                    zs);
  if (!PRICED) {
    for (int p = tid; p < BP; p += kThreads)
      a.out[member_row<D, ANTI>(a.drawn, row0, p) * (n + 1)] = a.s0;
  }

  // Per-path state, held by thread p < BP across tiles.
  float ls = a.log_s0;
  bool stopped = false;
  float val = 0.0f;

  for (int c0 = 0; c0 < n; c0 += kTileCols) {
    const int kmax = min(c0 + kTileCols, n);
    fgn_tile<PM, 1, SPEC, BF16>(static_cast<const E*>(a.lt),
                                static_cast<const E*>(a.ci), n, c0, ns,
                                lts, xs, nullptr, zs);

    // Variance exp and Euler increment, elementwise over the tile (both
    // members of a pair from one x and one w).
    const int cn = kmax - c0;
    for (int idx = tid; idx < D * kTileCols; idx += kThreads) {
      const int p = idx / kTileCols, cc = idx - p * kTileCols;
      float* xp = &xs[p * kXStride + cc];
      if (cc < cn) {
        const int c = c0 + cc;
        const float x = *xp, w = ws[p * ld + c];
        *xp = euler_inc(a, x, w, c);
        if (ANTI) xp[D * kXStride] = euler_inc(a, -x, -w, c);
      } else {
        *xp = 0.0f;
        if (ANTI) xp[D * kXStride] = 0.0f;
      }
    }
    __syncthreads();

    // Running sum (and the first-hit test) along the tile, one thread per
    // path.
    if (tid < BP) {
      float* xp = &xs[tid * kXStride];
      for (int cc = 0; cc < cn; ++cc) {
        ls += xp[cc];
        if (PRICED && QUAD) {
          if (!stopped)
            stopped = quad_exercise(a.tab, a.tstride, c0 + cc, expf(ls),
                                    a.is_call, &val);
        } else if (PRICED) {
          const int c = c0 + cc;
          if (!stopped && ls >= a.llo[c] && ls <= a.lhi[c]) {
            stopped = true;
            const float s = expf(ls);
            const float pay = a.is_call ? s - a.strike : a.strike - s;
            val = a.disc[c] * fmaxf(pay, 0.0f);
          }
        } else {
          xp[cc] = ls;
        }
      }
    }

    if (!PRICED) {
      __syncthreads();
      for (int idx = tid; idx < BP * kTileCols; idx += kThreads) {
        const int p = idx / kTileCols, cc = idx - p * kTileCols;
        if (cc < cn)
          a.out[member_row<D, ANTI>(a.drawn, row0, p) * (n + 1) + c0 + cc +
                1] = expf(xs[p * kXStride + cc]);
      }
    }
  }

  if (PRICED) {
    if (tid < BP) {
      red[tid] = val;
      if (CV) red[BP + tid] = expf(ls);  // ls is the terminal log price
    }
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

// Shared memory of a block of bp paths (pair members when antithetic).
int smem_bytes(int n, int bp, bool anti, bool cv, bool spec,
               bool bf16 = false) {
  const int d = anti ? bp / 2 : bp;
  return block_smem_bytes(n, d, 1, (bp - d) * kXStride + (cv ? 2 : 1) * bp,
                          spec, bf16);
}

template <int PM, bool SEEDED, bool PRICED, bool ANTI, bool CV, bool SPEC,
          bool QUAD, bool BF16 = false>
cudaError_t launch_one(const Args& a, cudaStream_t stream) {
  constexpr int D = 16 * PM;
  const int smem = smem_bytes(a.n, ANTI ? 2 * D : D, ANTI, CV, SPEC, BF16);
  auto kernel = path_kernel<PM, SEEDED, PRICED, ANTI, CV, SPEC, QUAD, BF16>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<a.drawn / D, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// Chol or spectral (from a.ci), in this unit's fGN input dtype.
template <int PM, bool SEEDED, bool PRICED, bool ANTI, bool CV, bool QUAD>
cudaError_t launch_form(const Args& a, cudaStream_t stream) {
  return a.ci != nullptr
             ? launch_one<PM, SEEDED, PRICED, ANTI, CV, true, QUAD,
                          kUnitBf16>(a, stream)
             : launch_one<PM, SEEDED, PRICED, ANTI, CV, false, QUAD,
                          kUnitBf16>(a, stream);
}

// The seeded (noise null) or noise-in entry, where this unit holds it and
// a.bf16 names its dtype.
template <int PM, bool PRICED, bool ANTI, bool CV, bool QUAD>
cudaError_t launch_entry(const Args& a, cudaStream_t stream) {
  if (a.bf16 != kUnitBf16) return cudaErrorInvalidValue;
  if (a.noise == nullptr) {
    if constexpr (kUnitSeeded)
      return launch_form<PM, true, PRICED, ANTI, CV, QUAD>(a, stream);
  } else {
    if constexpr (kUnitNoiseIn)
      return launch_form<PM, false, PRICED, ANTI, CV, QUAD>(a, stream);
  }
  return cudaErrorInvalidValue;
}

template <bool PRICED, bool ANTI, bool CV, bool QUAD = false>
cudaError_t launch_pm(const Args& a, int pm, cudaStream_t stream) {
  switch (pm) {
    case 4:
      return launch_entry<4, PRICED, ANTI, CV, QUAD>(a, stream);
    case 2:
      return launch_entry<2, PRICED, ANTI, CV, QUAD>(a, stream);
    case 1:
      return launch_entry<1, PRICED, ANTI, CV, QUAD>(a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// block_paths counts paths (pair members when antithetic): 16, 32 or 64
// plain, 32, 64 or 128 paired.  The quadratic policy (quad) has no pair
// form.
template <bool PRICED>
cudaError_t launch(Args a, int block_paths, bool anti, bool cv, bool quad,
                   cudaStream_t stream) {
  const int unit = anti ? 32 : 16;
  if (a.n < 1 || a.rows < 1 || block_paths < unit || block_paths % unit ||
      a.rows % block_paths || (quad && (anti || !PRICED)) ||
      smem_bytes(a.n, block_paths, anti, cv, a.ci != nullptr, a.bf16) >
          kSmemLimit)
    return cudaErrorInvalidValue;
  a.drawn = anti ? a.rows / 2 : a.rows;
  const int pm = block_paths / unit;
  if (!PRICED)
    return anti ? launch_pm<false, true, false>(a, pm, stream)
                : launch_pm<false, false, false>(a, pm, stream);
  if (quad)
    return cv ? launch_pm<true, false, true, true>(a, pm, stream)
              : launch_pm<true, false, false, true>(a, pm, stream);
  if (anti)
    return cv ? launch_pm<true, true, true>(a, pm, stream)
              : launch_pm<true, true, false>(a, pm, stream);
  return cv ? launch_pm<true, false, true>(a, pm, stream)
            : launch_pm<true, false, false>(a, pm, stream);
}

}  // namespace

extern "C" {

// Shared memory of a K1/K2 block of block_paths paths (pair members when
// antithetic != 0), the spectral form when spectral != 0, in this unit's
// fGN input dtype.
int MCOP_ENTRY(mcop_smem_bytes)(int n_steps, int block_paths, int antithetic,
                                int with_cv, int spectral) {
  return smem_bytes(n_steps, block_paths, antithetic != 0, with_cv != 0,
                    spectral != 0, kUnitBf16);
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
  return static_cast<int>(launch<false>(a, block_paths, antithetic != 0,
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
  return static_cast<int>(launch<true>(a, block_paths, antithetic != 0,
                                       with_cv != 0, quadratic != 0,
                                       static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
