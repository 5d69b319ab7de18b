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
//   stays in device memory as a [2, rows, n] plane (the noise-in layout),
//   and the product streams N through shared memory in k-tiles of 16
//   steps.  The noise-in entry reads its input; the seeded entry first
//   draws its block's rows of N and W into a workspace plane of the same
//   layout and then runs the same loop.  Shared memory per block is fixed
//   by the tile shapes (83 KB at 128 paths, two blocks per SM) at every
//   horizon.
// * One block of 256 threads owns BP = 16*PM paths (128, 64, 32 or 16, the
//   largest that divides the rows).  Output tiles are 128 step columns;
//   each thread accumulates a PM x 8 micro-tile (paths ty*PM.., columns
//   tx*4..+3 and 64+tx*4..+3, read as float4 so a quarter-warp reads 128
//   contiguous bytes of the Lt' tile).  Output tile c reads k-tiles that
//   end at its last column only: Lt' is upper triangular.  The product of
//   a column tile, float32 and bf16, is csrc/slab_tile.cuh's, which the
//   P1 matmul probe (csrc/roofline.cu) also runs.
// * The TPU grid carried per-path state across step tiles in scratch.
//   Here the state of path p (log-price carry, stopped flag, stop value)
//   lives in the registers of thread p < BP, which runs the running sum and
//   the first-hit test along each tile.  Padded columns past n are never
//   computed.  W is read once, at its own tile.  The TPU carried "already
//   exercised" across tiles in stop_ref; here it is the stopped flag.
// * The QUAD forms take exp and the policy's seven table rows (through
//   __ldg) per cell of that loop until the path's first hit, ~30
//   operations a cell beside the product's 2 n per cell.
// * Antithetic blocks stream D = 16*PM drawn rows (64, 32 or 16) through
//   the same product and keep 2D members: the X tile holds both halves,
//   and thread p < 2D carries member p (p >= D the partner of row p - D).
//   The 128-member paired block has the unpaired 128-path block's shared
//   memory within 256 bytes, so two blocks still share an SM.  Paired K6
//   writes member p >= D to the partner row `drawn` rows below drawn row
//   p - D (member_row).
// * The spectral form keeps its noise as [3, rows, n] (Zr, Zi, W) and
//   streams the Zr and Zi k-tiles beside the Cr' and Ci' k-tiles (16.6 KB
//   more a block, still two blocks an SM).  Every output tile reads every
//   k-tile: the matrices are dense.  Both matrices stay in L2 up to
//   isqrt(L2 / 8) = 2,560 steps (max_tiled_steps), the chol factor to
//   3,620.  The seeded entry draws Zr and W as the chol stream's N and W
//   and Zi from its own counter word, as K1/K2 do.
// * The bf16 form (BF16) stages each k-tile as bf16, the N^T tile as
//   [D][kNB] (k contiguous; each normal rounded to nearest even from the
//   float32 plane) and the Lt' tile column by column, [kTileCols][kNB],
//   and runs the tile as m16n8k16 tensor-core products with float32 sums
//   (csrc/mma_bf16.cuh): warp w owns the 8-column groups w and w + 8 of
//   the 128-column tile and every m16 row group, and skips a group's
//   product on the k-tiles past its last column (the triangle).  Under
//   SPEC the Zi k-tile and the Ci' k-tile are staged in bf16 beside them
//   (24.6 KB of tiles at 128 paths, 91.6 KB a block: still two an SM) and
//   every column tile sums over every k-tile, the Zi fragments negated
//   into the same accumulators.  The rest of the body (the QUAD policy
//   included) is the float32 form's; a pair's partner is -x to the bit.
//   It keeps the float32 form's path blocks.
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
using mcop::kUnitBf16;
using mcop::kUnitNoiseIn;
using mcop::kUnitSeeded;

constexpr int kSmemLimit = 232448;

struct Args {
  float* noise;         // [2 or 3, drawn, n]: the input, or the seeded
                        // workspace
  const void* lt;       // [n, n] half-scaled factor: Lt' (upper), or Cr';
                        // bf16 under the bf16 form, else float32
  const float* ci;      // [n, n] Ci' (spectral; its bf16 bits under the
                        // bf16 form), or nullptr (chol)
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

// Shared memory of one block, in floats: the N^T k-tile of its D drawn
// rows (row stride D+4, a multiple of 4 for float4 reads), the Lt' k-tile
// (under SPEC the Zr^T and Zi^T k-tiles and the Cr' and Ci' k-tiles; under
// BF16 the bf16 N tile [D][kNB] and Lt' tile [kTileCols][kNB]), the X tile
// of its BP paths (stride kTileCols+1, so the per-path loop reads distinct
// banks) and the path-sum slots (twice under CV).
template <int PM, bool ANTI = false, bool CV = false, bool SPEC = false,
          bool BF16 = false>
struct Layout {
  static constexpr int kD = 16 * PM;
  static constexpr int kBP = ANTI ? 2 * kD : kD;
  static constexpr int kNStride = kD + 4;
  static constexpr int kTileFloats = tile_floats<PM, SPEC, BF16>();
  static constexpr int kFloats =
      kTileFloats + kBP * kXStride + (CV ? 2 : 1) * kBP;
  static constexpr int kBytes = 4 * kFloats;
};

// Seeded entry: draw the block's D rows of N and W into the plane (SPEC:
// Zr = N into plane 0, Zi into plane 1, W into plane 2).
template <int D, bool SPEC>
__device__ void draw_rows(const Args& a, int row0) {
  const int n = a.n, pairs = (n + 1) / 2;
  const size_t plane = static_cast<size_t>(a.drawn) * n;
  float* wplane = a.noise + (SPEC ? 2 : 1) * plane;
  for (int idx = threadIdx.x; idx < D * pairs; idx += kThreads) {
    const int p = idx / pairs, j = idx - p * pairs;
    float n0, w0, n1, w1;
    mcop::step_pair_normals(a.key, row0 + p, j, &n0, &w0, &n1, &w1);
    const size_t g = static_cast<size_t>(row0 + p) * n + 2 * j;
    a.noise[g] = n0;
    wplane[g] = w0;
    if (2 * j + 1 < n) {
      a.noise[g + 1] = n1;
      wplane[g + 1] = w1;
    }
  }
  if (SPEC) {
    const int quads = (n + 3) / 4;
    for (int idx = threadIdx.x; idx < D * quads; idx += kThreads) {
      const int p = idx / quads, q = idx - p * quads;
      const float4 z = mcop::spectral_zi_quad(a.key, row0 + p, q);
      const float zv[4] = {z.x, z.y, z.z, z.w};
      float* zrow = a.noise + plane + static_cast<size_t>(row0 + p) * n;
#pragma unroll
      for (int t = 0; t < 4; ++t)
        if (4 * q + t < n) zrow[4 * q + t] = zv[t];
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

// Block of D = 16*PM drawn rows; BP = D paths, or 2D pair members (ANTI:
// member p < D is drawn row p, member D + p its partner).  CV adds the
// control lane, SPEC the spectral fGN form, QUAD the quadratic policy,
// BF16 the bf16 fGN-input form.
template <int PM, bool SEEDED, bool PRICED, bool ANTI, bool CV, bool SPEC,
          bool QUAD, bool BF16>
__global__ void __launch_bounds__(kThreads, 2) tiled_kernel(Args a) {
  using L = Layout<PM, ANTI, CV, SPEC, BF16>;
  constexpr int D = L::kD;
  constexpr int BP = L::kBP;
  constexpr int NS = L::kNStride;
  extern __shared__ float4 smem4[];
  float* ns = reinterpret_cast<float*>(smem4);  // [kTileK][NS]   N^T k-tile
  float* lts = ns + kTileK * NS;                // [kTileK][kTileCols]
  float* zs = lts + kTileK * kTileCols;         // SPEC: Zi^T k-tile
  float* cts = zs + kTileK * NS;                // SPEC: Ci' k-tile
  auto* nsb = reinterpret_cast<__nv_bfloat16*>(smem4);  // BF16: [D][kNB]
  __nv_bfloat16* ltb = nsb + D * kNB;           // BF16: [kTileCols][kNB]
  __nv_bfloat16* zsb = ltb + kTileCols * kNB;   // BF16 and SPEC: Zi tile
  __nv_bfloat16* ctb = zsb + D * kNB;           // BF16 and SPEC: Ci' tile
  float* xs = reinterpret_cast<float*>(smem4) + L::kTileFloats;
                                                // [BP][kXStride]
  float* red = xs + BP * kXStride;              // [BP] (twice under CV)

  const int n = a.n;
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * D;              // first drawn row
  const size_t plane = static_cast<size_t>(a.drawn) * n;
  const float* nrows = a.noise + static_cast<size_t>(row0) * n;
  const float* zrows = nrows + plane;           // SPEC: Zi
  const float* wrows = nrows + (SPEC ? 2 : 1) * plane;

  if (SEEDED) {
    draw_rows<D, SPEC>(a, row0);
    __syncthreads();  // the block's plane writes are visible to the block
  }
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
    if constexpr (BF16)
      tile_product_bf16<PM, true, SPEC>(a, nrows, c0, nsb, ltb, xs, zrows,
                                        zsb, ctb);
    else
      tile_product<PM, SPEC>(a, nrows, zrows, c0, ns, lts, zs, cts, xs);

    // Variance exp and Euler increment, elementwise over the tile (both
    // members of a pair from one x and one w).
    const int cn = kmax - c0;
    for (int idx = tid; idx < D * kTileCols; idx += kThreads) {
      const int p = idx / kTileCols, cc = idx - p * kTileCols;
      if (cc < cn) {
        const int c = c0 + cc;
        float* xp = &xs[p * kXStride + cc];
        const float x = *xp, w = wrows[static_cast<size_t>(p) * n + c];
        *xp = euler_inc(a, x, w, c);
        if (ANTI) xp[D * kXStride] = euler_inc(a, -x, -w, c);
      }
    }
    __syncthreads();

    // Running sum (and the first-hit test) along the tile, one thread per
    // path; the carry crosses tiles in registers.
    if (tid < BP) {
      float* xp = &xs[tid * kXStride];
      for (int cc = 0; cc < cn; ++cc) {
        ls += xp[cc];
        if (PRICED && QUAD) {
          if (!stopped)
            stopped = mcop::quad_exercise(a.tab, a.tstride, c0 + cc,
                                          expf(ls), a.is_call, &val);
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

template <int PM, bool SEEDED, bool PRICED, bool ANTI, bool CV, bool SPEC,
          bool QUAD, bool BF16>
cudaError_t launch_one(const Args& a, cudaStream_t stream) {
  constexpr int smem = Layout<PM, ANTI, CV, SPEC, BF16>::kBytes;
  static_assert(smem <= kSmemLimit, "tile shapes exceed shared memory");
  auto kernel = tiled_kernel<PM, SEEDED, PRICED, ANTI, CV, SPEC, QUAD, BF16>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<a.drawn / (16 * PM), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The plain forms take 128, 64, 32 or 16 paths a block; the paired forms
// 128, 64 or 32 members (64, 32 or 16 drawn rows).
template <bool SEEDED, bool PRICED, bool ANTI, bool CV, bool SPEC, bool QUAD,
          bool BF16 = false>
cudaError_t launch_pm(const Args& a, int block_paths, cudaStream_t stream) {
  switch (ANTI ? block_paths / 2 : block_paths) {
    case 128:
      if constexpr (ANTI) return cudaErrorInvalidValue;
      else
        return launch_one<8, SEEDED, PRICED, ANTI, CV, SPEC, QUAD, BF16>(
            a, stream);
    case 64:
      return launch_one<4, SEEDED, PRICED, ANTI, CV, SPEC, QUAD, BF16>(
          a, stream);
    case 32:
      return launch_one<2, SEEDED, PRICED, ANTI, CV, SPEC, QUAD, BF16>(
          a, stream);
    case 16:
      return launch_one<1, SEEDED, PRICED, ANTI, CV, SPEC, QUAD, BF16>(
          a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// Chol or spectral (from a.ci), in this unit's fGN input dtype.
template <bool SEEDED, bool PRICED, bool ANTI, bool CV, bool QUAD>
cudaError_t launch_form(const Args& a, int block_paths, cudaStream_t stream) {
  return a.ci != nullptr
             ? launch_pm<SEEDED, PRICED, ANTI, CV, true, QUAD, kUnitBf16>(
                   a, block_paths, stream)
             : launch_pm<SEEDED, PRICED, ANTI, CV, false, QUAD, kUnitBf16>(
                   a, block_paths, stream);
}

// The seeded or noise-in entry, where this unit holds it and a.bf16 names
// its dtype.
template <bool PRICED, bool ANTI, bool CV, bool QUAD = false>
cudaError_t launch_seeded(const Args& a, int seeded, int block_paths,
                          cudaStream_t stream) {
  if (a.bf16 != kUnitBf16) return cudaErrorInvalidValue;
  if (seeded) {
    if constexpr (kUnitSeeded)
      return launch_form<true, PRICED, ANTI, CV, QUAD>(a, block_paths,
                                                       stream);
  } else {
    if constexpr (kUnitNoiseIn)
      return launch_form<false, PRICED, ANTI, CV, QUAD>(a, block_paths,
                                                        stream);
  }
  return cudaErrorInvalidValue;
}

template <bool PRICED>
cudaError_t launch(Args a, int seeded, int block_paths, bool anti, bool cv,
                   bool quad, cudaStream_t stream) {
  if (a.n < 1 || a.rows < 1 || a.noise == nullptr || block_paths < 16 ||
      a.rows % block_paths || (anti && block_paths % 32) ||
      (quad && (anti || !PRICED)))
    return cudaErrorInvalidValue;
  a.drawn = anti ? a.rows / 2 : a.rows;
  if (quad)
    return cv ? launch_seeded<true, false, true, true>(a, seeded,
                                                       block_paths, stream)
              : launch_seeded<true, false, false, true>(a, seeded,
                                                        block_paths, stream);
  if (!PRICED)
    return anti ? launch_seeded<false, true, false>(a, seeded, block_paths,
                                                    stream)
                : launch_seeded<false, false, false>(a, seeded, block_paths,
                                                     stream);
  if (anti)
    return cv ? launch_seeded<true, true, true>(a, seeded, block_paths, stream)
              : launch_seeded<true, true, false>(a, seeded, block_paths,
                                                 stream);
  return cv ? launch_seeded<true, false, true>(a, seeded, block_paths, stream)
            : launch_seeded<true, false, false>(a, seeded, block_paths,
                                                stream);
}

Args make_args(float* noise, const void* lt, const void* ci,
               const float* vd, int rows, int n_steps, unsigned int key,
               float r, float dt, float sqrt_dt, float log_s0, int bf16) {
  Args a{};
  a.bf16 = bf16 != 0;
  a.noise = noise;
  a.lt = lt;
  a.ci = static_cast<const float*>(ci);
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
int MCOP_ENTRY(mcop_tiled_smem_bytes)(int block_paths, int antithetic,
                                      int with_cv, int spectral) {
  const int d = antithetic ? block_paths / 2 : block_paths;
  if (antithetic && (block_paths % 2 || d == 128)) return -1;
  const int pm = d / 16;
  if (d % 16 || (pm != 1 && pm != 2 && pm != 4 && pm != 8)) return -1;
  const int bp = antithetic ? 2 * d : d;
  return 4 * (tile_floats_of(d, spectral != 0, kUnitBf16) + bp * kXStride +
              (with_cv ? 2 : 1) * bp);
}

// K6.  noise: [2, rows, n_steps] float32 (N, W; ci null: lt is Lt') or
// [3, rows, n_steps] (Zr, Zi, W; spectral: lt is Cr', ci is Ci'), read as
// given (seeded == 0) or filled first from the stream of `key` (seeded !=
// 0, a workspace; the _seeded units only).  bf16 != 0 (the _bf16 units
// only): the bf16 form, lt and ci bf16, the noise float32.  rows counts paths; antithetic != 0
// reads (or draws into the workspace) rows / 2 rows of noise, block_paths
// counts pair members, and out holds the drawn rows' paths, then their
// partners'.
int MCOP_ENTRY(mcop_tiled_pathgen)(
    float* noise, int seeded, const void* lt, const void* ci,
    const float* vd, int rows, int n_steps, int block_paths,
    unsigned int key, float r, float dt, float sqrt_dt, float log_s0,
    float s0, int antithetic, int bf16, float* out, void* stream) {
  Args a = make_args(noise, lt, ci, vd, rows, n_steps, key, r, dt, sqrt_dt,
                     log_s0, bf16);
  a.s0 = s0;
  a.out = out;
  return static_cast<int>(launch<false>(a, seeded, block_paths,
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
  return static_cast<int>(launch<true>(a, seeded, block_paths,
                                       antithetic != 0, with_cv != 0,
                                       quadratic != 0,
                                       static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
