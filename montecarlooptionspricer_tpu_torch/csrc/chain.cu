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
// two compares; seven table reads through __ldg), three times the
// boundary sweep's.
//
// Design:
// * The path block, its noise, the fGN tile product and the Euler
//   increments are K2's (csrc/fgn_tile.cuh), bit for bit.  The log price
//   is log s0 + (the running sum of the increments), JAX's association
//   (log_s0 + the cumsum matmul) and the plain version's, not K2's running
//   sum from log s0: a float32 sum carried at log s0 ~ 4.6 rounds each
//   step at 4.8e-7, which put the kernel's log prices a few ulps from the
//   plain version's and flipped enough root-band decisions to move a deep
//   out-of-the-money strike's sum by 1e-4 of itself.  Each path block is
//   generated once and every strike of the launch is swept against it;
//   there are no per-group passes over the paths inside a launch.
// * The TPU swept at most 10 strikes per pass because Mosaic schedules a
//   longer unroll badly.  Here the strike sweep is where K2's idle threads
//   work: thread (path p, lane l) of the block's 256 keeps, in registers,
//   the stopped flag and value of strikes l, l + L, l + 2L, ... (L = 256 /
//   BP lanes per path).  One thread per path writes each tile's running
//   log price into shared memory, all threads turn it into S, then every
//   thread sweeps its strikes over the tile.
// * One launch sweeps up to kGroup = 32 strikes: 16 (flag, value) register
//   pairs per thread at BP = 128 pair members, 8 at 64, 4 at 32, 2 at 16.
//   A wider strip takes one launch per 32 strikes on the same seed, which
//   regenerates bitwise-identical paths: the Philox counter is (global
//   drawn row, step pair), so a member and its partner are the same two
//   paths for every strike of the strip.
// * The block's partial sums are reduced in a fixed order through the
//   shared-memory tile, one thread per strike.
// * Shared memory (models/chain_cuda.py smem_bytes): the N and W planes of
//   the D = 16 * PM drawn rows, one 64-column X tile of every member (BP
//   = D plain, 2D paired) and the staged Lt' rows: 4 (2 D ld + 65 BP +
//   2048) bytes, ld = n rounded up to odd.  Plain blocks of 64 paths fit
//   up to 405 steps and 32 up to 843.  A paired block keeps D drawn rows
//   and runs the product of the unpaired D-path block: at 365 steps D = 64
//   (128 members) takes 4 (2 * 64 * 365 + 65 * 128 + 2048) = 228,352 of
//   the 232,448 bytes; at 512 steps it would take 304,128, so D = 32 (64
//   members, 156,160 bytes).  The reduction's [32][BP] floats fit the X
//   tile.  The spectral form adds the Zi plane and a staged Ci' tile:
//   4 (3 D ld + 65 BP + 4096) bytes, 32 paths (64 members) at 365 and at
//   512 steps (230,016 bytes paired at 512).
// * The decision is taken in S space for both members, as on the TPU.
// * The bf16 form (BF16) keeps its N plane (and Zi) in bf16, each normal
//   rounded to nearest even as it is drawn or read, the rows padded with
//   zeros to whole k16 steps, and runs the product on the tensor cores
//   (csrc/fgn_tile.cuh:fgn_tile_mma, m16n8k16, float32 sums); W, the X
//   tile, the Euler recursion and the sweep are the float32 form's.  Its
//   planes and staged tiles are narrower: 2 D (ceil16(n) + 8) bytes a
//   bf16 plane and 2 * 64 * 40 bytes a staged tile, so its block is the
//   largest its own model fits (models/chain_cuda.py block_paths_for),
//   never smaller than the float32 form's: 64 paths at 365 and 512 steps
//   (128 and 64 members paired), spectral 64 at 365 and 32 at 512 (64
//   members paired at both).

#include <cuda_runtime.h>
#include <stdint.h>

#include "build_unit.cuh"
#include "fgn_tile.cuh"
#include "quad_policy.cuh"

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
  bool bf16;            // the bf16 fGN-input form
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

// Block of D = 16 * PM drawn rows; BP = D paths, or 2D pair members (ANTI:
// member p < D is drawn row p, member D + p its partner).  SPEC: the
// spectral fGN form; QUAD: the quadratic policy; BF16: the bf16 fGN-input
// form.
template <int PM, bool SEEDED, bool ANTI, bool SPEC, bool QUAD, bool BF16>
__global__ void __launch_bounds__(kThreads, 1) chain_kernel(ChainArgs a) {
  constexpr int D = 16 * PM;
  constexpr int BP = ANTI ? 2 * D : D;
  constexpr int kLanes = kThreads / BP;   // strike lanes per path
  constexpr int kPer = kGroup / kLanes;   // strikes per thread
  using E = fgn_elem<BF16>;
  extern __shared__ float smem[];
  const int n = a.n, ld = plane_ld(n);
  const int npf = n_plane_floats(n, D, BF16);
  E* ns = reinterpret_cast<E*>(smem);     // [D][ld] N (Zr); bf16: [D][ldn]
  E* zs = reinterpret_cast<E*>(smem + npf);   // the same, Zi under SPEC
  float* ws = smem + (SPEC ? 2 : 1) * npf;    // [D][ld]
  float* xs = ws + D * ld;                // [BP][kXStride]
  E* lts = reinterpret_cast<E*>(xs + BP * kXStride);
                                          // [1 or 2][kTileK][kTileCols];
                                          // bf16: [kTileCols][kTileKB]

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * D;        // first drawn row
  const int p = tid % BP, lane = tid / BP;
  load_noise<D, SEEDED, SPEC, BF16>(a.noise, a.drawn, n, a.key, row0, ns, ws,
                                    zs);

  float cum = 0.0f;    // running sum of the log increments, thread tid < BP
  bool stopped[kPer];
  float val[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    stopped[i] = false;
    val[i] = 0.0f;
  }

  for (int c0 = 0; c0 < n; c0 += kTileCols) {
    const int cn = min(c0 + kTileCols, n) - c0;
    fgn_tile<PM, 1, SPEC, BF16>(static_cast<const E*>(a.lt),
                                static_cast<const E*>(a.ci), n, c0, ns, lts,
                                xs, nullptr, zs);

    // Variance exp and Euler increment, elementwise over the tile (K2's;
    // both members of a pair from one x and one w).
    for (int idx = tid; idx < D * kTileCols; idx += kThreads) {
      const int q = idx / kTileCols, cc = idx - q * kTileCols;
      float* xp = &xs[q * kXStride + cc];
      if (cc < cn) {
        const int c = c0 + cc;
        const float x = *xp, w = ws[q * ld + c];
        *xp = euler_inc(a, x, w, c);
        if (ANTI) xp[D * kXStride] = euler_inc(a, -x, -w, c);
      } else {
        *xp = 0.0f;
        if (ANTI) xp[D * kXStride] = 0.0f;
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
    __syncthreads();
    for (int idx = tid; idx < BP * kTileCols; idx += kThreads) {
      const int q = idx / kTileCols, cc = idx - q * kTileCols;
      if (cc < cn) xs[q * kXStride + cc] = expf(xs[q * kXStride + cc]);
    }
    __syncthreads();

    // The strike sweep: thread (p, lane) over its strikes' first hits.
    const float* sp = &xs[p * kXStride];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int k = lane + kLanes * i;
      if (k >= a.n_strikes || stopped[i]) continue;
      if (QUAD) {
        const float* tab = a.tables + k * a.strike_stride;
        for (int cc = 0; cc < cn; ++cc) {
          float v;
          if (quad_exercise<true>(tab, a.row_stride, c0 + cc, sp[cc],
                                  a.is_call, &v)) {
            val[i] = v;
            stopped[i] = true;
            break;
          }
        }
        continue;
      }
      const float* lo = a.tables + k * a.strike_stride + c0;
      const float* hi = lo + a.row_stride;
      const float* dk = lo + 2 * a.row_stride;
      const float* disc = lo + 3 * a.row_stride;
      for (int cc = 0; cc < cn; ++cc) {
        const float s = sp[cc];
        if (s >= __ldg(lo + cc) && s <= __ldg(hi + cc)) {
          const float ds = __fmul_rn(s, __ldg(disc + cc));
          val[i] = a.is_call ? __fsub_rn(ds, __ldg(dk + cc))
                             : __fsub_rn(__ldg(dk + cc), ds);
          stopped[i] = true;
          break;
        }
      }
    }
    // The next tile's product synchronises before it overwrites xs.
  }

  __syncthreads();
  float* red = xs;                        // [n_strikes][BP]
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int k = lane + kLanes * i;
    if (k < a.n_strikes) red[k * BP + p] = val[i];
  }
  __syncthreads();
  if (tid < a.n_strikes) {
    float sum = 0.0f;
    for (int q = 0; q < BP; ++q) sum += red[tid * BP + q];
    a.out[static_cast<size_t>(blockIdx.x) * a.n_strikes + tid] = sum;
  }
}

// Shared memory of a block of bp paths (pair members when antithetic), in
// the bf16 form's layout when bf16.
int smem_bytes(int n, int bp, bool anti, bool spec, bool bf16) {
  const int d = anti ? bp / 2 : bp;
  return block_smem_bytes(n, d, 1, (bp - d) * kXStride, spec, bf16);
}

template <int PM, bool SEEDED, bool ANTI, bool SPEC, bool QUAD>
cudaError_t launch_one(const ChainArgs& a, cudaStream_t stream) {
  constexpr int D = 16 * PM;
  const int smem = smem_bytes(a.n, ANTI ? 2 * D : D, ANTI, SPEC, kUnitBf16);
  auto kernel = chain_kernel<PM, SEEDED, ANTI, SPEC, QUAD, kUnitBf16>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<a.drawn / D, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The seeded or noise-in entry, chol or spectral (from a.ci), where
// a.bf16 names this unit's fGN input dtype.
template <int PM, bool ANTI, bool QUAD>
cudaError_t launch_entry(const ChainArgs& a, cudaStream_t s) {
  if (a.bf16 != kUnitBf16) return cudaErrorInvalidValue;
  const bool seeded = a.noise == nullptr;
  if (a.ci != nullptr)
    return seeded ? launch_one<PM, true, ANTI, true, QUAD>(a, s)
                  : launch_one<PM, false, ANTI, true, QUAD>(a, s);
  return seeded ? launch_one<PM, true, ANTI, false, QUAD>(a, s)
                : launch_one<PM, false, ANTI, false, QUAD>(a, s);
}

template <bool ANTI, bool QUAD = false>
cudaError_t launch_pm(const ChainArgs& a, int pm, cudaStream_t s) {
  switch (pm) {
    case 4:
      return launch_entry<4, ANTI, QUAD>(a, s);
    case 2:
      return launch_entry<2, ANTI, QUAD>(a, s);
    case 1:
      return launch_entry<1, ANTI, QUAD>(a, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// block_paths counts paths (pair members when antithetic != 0); the
// spectral form when spectral != 0; in this unit's fGN input dtype.
int MCOP_ENTRY(mcop_chain_smem_bytes)(int n_steps, int block_paths,
                                      int antithetic, int spectral) {
  return smem_bytes(n_steps, block_paths, antithetic != 0, spectral != 0,
                    kUnitBf16);
}

int MCOP_ENTRY(mcop_chain_group)() { return kGroup; }

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
  const bool anti = antithetic != 0;
  const int unit = anti ? 32 : 16;
  if (n_steps < 1 || rows < 1 || block_paths < unit || block_paths % unit ||
      block_paths > 4 * unit || rows % block_paths || n_strikes < 1 ||
      n_strikes > kGroup || (quadratic != 0 && anti) ||
      smem_bytes(n_steps, block_paths, anti, ci != nullptr, kUnitBf16) >
          kSmemLimit)
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
  a.bf16 = bf16 != 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int pm = block_paths / unit;
  const cudaError_t err = quadratic != 0 ? launch_pm<false, true>(a, pm, s)
                          : anti         ? launch_pm<true>(a, pm, s)
                                         : launch_pm<false>(a, pm, s);
  return static_cast<int>(err);
}

}  // extern "C"
