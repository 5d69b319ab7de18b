// K5, the strike-chain kernel for Hopper (sm_90a), bound through a plain C
// interface and loaded with ctypes (models/chain_cuda.py).
//
// mcop_priced_chain replaces montecarlooptionspricer_tpu/models/
//    pathgen_pallas.py:_chain_kernel, _chain_kernel_noise_in and
//    _chain_kernel_grid (with _sweep_values and _policy_value_boundary),
//    chol fGN form, boundary policy, no antithetic.
//
// What it computes: the paths of K2 (csrc/pathgen.cu) from the same noise,
// S_c = exp(logS_c) on every cell, and for each strike k of the strip the
// first column c with lo_k[c] <= S_c <= hi_k[c] of its S-space
// boundary_rows table; the path is then worth dk_k[c] - disc[c] * S_c for a
// put and disc[c] * S_c - dk_k[c] for a call (dk = disc * strike, no clamp,
// as on the TPU), else 0.  Each block writes one partial sum per strike (no
// atomics: a seed gives the same [K] on every run).
//
// Bound on the H100: operations.  Per path the fGN product is ~n^2/2
// multiply-adds (67k at n = 365) and the strike sweep ~4 operations per
// cell and strike up to its first hit (two compares, the value, the stop
// flag): at 131,072 paths, 365 steps and 21 strikes that is 8.8e9 FMA
// plus at most 4.0e9 sweep operations, at most 0.33 ms at 67 TFLOP/s
// float32, against ~0.6 MB of bytes that must move (Lt', the tables, the
// sums), 0.2 us at 3.35 TB/s.
//
// Design:
// * The path block, its noise, the fGN tile product and the Euler
//   increments are K2's (csrc/fgn_tile.cuh), so the seeded paths are K2's
//   bit for bit.  Each path block is generated once and every strike of the
//   launch is swept against it; there are no per-group passes over the
//   paths inside a launch.
// * The TPU swept at most 10 strikes per pass because Mosaic schedules a
//   longer unroll badly.  Here the strike sweep is where K2's idle threads
//   work: thread (path p, lane l) of the block's 256 keeps, in registers,
//   the stopped flag and value of strikes l, l + L, l + 2L, ... (L = 256 /
//   BP lanes per path).  One thread per path writes each tile's running
//   log price into shared memory, all threads turn it into S, then every
//   thread sweeps its strikes over the tile.
// * One launch sweeps up to kGroup = 32 strikes: 8 (flag, value) register
//   pairs per thread at BP = 64, 4 at 32, 2 at 16.  A wider strip takes one
//   launch per 32 strikes on the same seed, which regenerates
//   bitwise-identical paths; the 21-strike strip needs one.
// * The block's partial sums are reduced in a fixed order through the
//   shared-memory tile, one thread per strike.
// * Shared memory is K2's without the path-sum slots: the N and W planes,
//   one 64-column tile and the staged Lt' rows (models/chain_cuda.py
//   smem_bytes); 64-path blocks up to 405 steps, 32 up to 843.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fgn_tile.cuh"

namespace {

using namespace mcop;

constexpr int kGroup = 32;   // strikes one launch sweeps

struct ChainArgs {
  const float* noise;   // [2, rows, n] or nullptr for the seeded entry
  const float* lt;      // [n, n] half-scaled upper-triangular factor
  const float* vd;      // [n] half variance drift
  const float* tables;  // [n_strikes] boundary_rows tables: rows lo, hi,
                        // disc * strike, disc
  long long strike_stride, row_stride;   // floats
  int n_strikes;        // <= kGroup
  float* out;           // [rows / BP, n_strikes] partial sums
  int rows, n;
  uint32_t key;
  float r, dt, sqrt_dt, log_s0;
  int is_call;
};

template <int PM, bool SEEDED>
__global__ void __launch_bounds__(kThreads, 1) chain_kernel(ChainArgs a) {
  constexpr int BP = 16 * PM;
  constexpr int kLanes = kThreads / BP;   // strike lanes per path
  constexpr int kPer = kGroup / kLanes;   // strikes per thread
  extern __shared__ float smem[];
  const int n = a.n, ld = plane_ld(n);
  float* ns = smem;                       // [BP][ld]
  float* ws = ns + BP * ld;               // [BP][ld]
  float* xs = ws + BP * ld;               // [BP][kXStride]
  float* lts = xs + BP * kXStride;        // [kTileK][kTileCols]

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * BP;
  const int p = tid % BP, lane = tid / BP;
  load_noise<BP, SEEDED>(a.noise, a.rows, n, a.key, row0, ns, ws);

  float ls = a.log_s0;                    // running log price, thread tid < BP
  bool stopped[kPer];
  float val[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    stopped[i] = false;
    val[i] = 0.0f;
  }

  for (int c0 = 0; c0 < n; c0 += kTileCols) {
    const int cn = min(c0 + kTileCols, n) - c0;
    fgn_tile<PM, 1>(a.lt, nullptr, n, c0, ns, lts, xs, nullptr);

    // Variance exp and Euler increment, elementwise over the tile (K2's).
    for (int idx = tid; idx < BP * kTileCols; idx += kThreads) {
      const int q = idx / kTileCols, cc = idx - q * kTileCols;
      float* xp = &xs[q * kXStride + cc];
      if (cc < cn) {
        const int c = c0 + cc;
        const float sv = expf(*xp + a.vd[c]);
        const float v = sv * sv;
        *xp = (a.r - 0.5f * v) * a.dt + sv * (ws[q * ld + c] * a.sqrt_dt);
      } else {
        *xp = 0.0f;
      }
    }
    __syncthreads();

    // Running log price along the tile, one thread per path.
    if (tid < BP) {
      float* xp = &xs[tid * kXStride];
      for (int cc = 0; cc < cn; ++cc) {
        ls += xp[cc];
        xp[cc] = ls;
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

int smem_bytes(int n, int bp) { return block_smem_bytes(n, bp, 1, 0); }

template <int PM, bool SEEDED>
cudaError_t launch_one(const ChainArgs& a, cudaStream_t stream) {
  const int smem = smem_bytes(a.n, 16 * PM);
  auto kernel = chain_kernel<PM, SEEDED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<a.rows / (16 * PM), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int mcop_chain_smem_bytes(int n_steps, int block_paths) {
  return smem_bytes(n_steps, block_paths);
}

int mcop_chain_group() { return kGroup; }

// K5.  noise may be null (seeded entry, stream of `key`).  tables: the
// launch's n_strikes boundary_rows tables, strike_stride floats apart, rows
// row_stride floats apart.  out: [rows / block_paths, n_strikes].
int mcop_priced_chain(const float* noise, const float* lt, const float* vd,
                      int rows, int n_steps, int block_paths,
                      unsigned int key, float r, float dt, float sqrt_dt,
                      float log_s0, const float* tables,
                      long long strike_stride, long long row_stride,
                      int n_strikes, int is_call, float* out, void* stream) {
  if (n_steps < 1 || rows < 1 || block_paths < 16 || block_paths % 16 ||
      rows % block_paths || n_strikes < 1 || n_strikes > kGroup ||
      smem_bytes(n_steps, block_paths) > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  ChainArgs a{};
  a.noise = noise;
  a.lt = lt;
  a.vd = vd;
  a.tables = tables;
  a.strike_stride = strike_stride;
  a.row_stride = row_stride;
  a.n_strikes = n_strikes;
  a.out = out;
  a.rows = rows;
  a.n = n_steps;
  a.key = key;
  a.r = r;
  a.dt = dt;
  a.sqrt_dt = sqrt_dt;
  a.log_s0 = log_s0;
  a.is_call = is_call;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool seeded = noise == nullptr;
  cudaError_t err;
  switch (block_paths) {
    case 64:
      err = seeded ? launch_one<4, true>(a, s) : launch_one<4, false>(a, s);
      break;
    case 32:
      err = seeded ? launch_one<2, true>(a, s) : launch_one<2, false>(a, s);
      break;
    case 16:
      err = seeded ? launch_one<1, true>(a, s) : launch_one<1, false>(a, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
