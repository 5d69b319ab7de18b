// Fused rough-Bergomi path kernels for Hopper (sm_90a), bound through a
// plain C interface and loaded with ctypes (models/pathgen_cuda.py).
//
// K1 mcop_pathgen replaces montecarlooptionspricer_tpu/models/
//    pathgen_pallas.py:_pathgen_kernel (and _pathgen_kernel_noise_in),
//    chol fGN form, no antithetic.
// K2 mcop_priced_chunk replaces pathgen_pallas.py:_priced_kernel (and
//    _priced_kernel_noise_in), chol form, log-boundary policy, interleave 1,
//    no control variate, no antithetic.
//
// What they compute, per path p and step column c < n (column c = step c+1):
//   x_c    = sum_{k <= c} N[p,k] * Lt'[k,c]        (Lt' = 0.5 Lt, upper)
//   sv     = exp(x_c + vd[c])
//   inc    = (r - sv^2/2) dt + sv * W[p,c] * sqrt(dt)
//   logS_c = log s0 + sum_{k <= c} inc_k
// K1 writes out[p, 0] = s0 and out[p, c+1] = exp(logS_c).  K2 stops each
// path at the first c with llo[c] <= logS_c <= lhi[c] and adds
// disc[c] * max(+-(exp(logS_c) - strike), 0); each block writes one
// partial sum (no atomics, so a seed gives the same sum on every run).
//
// Bound on the H100: operations.  The fGN product is ~n^2/2 multiply-adds
// per path (67k at n = 365) against ~n transcendentals and n*4 bytes of
// output; at 131072 paths that is 8.8e9 FMA, 0.26 ms at the card's
// 67 TFLOP/s float32 (no tensor cores: full float32 is kept), while the
// bytes that must move (Lt', the output) take at most 0.06 ms.
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
// * No --use_fast_math: logf/expf/sinf/cosf stay precise so the plain
//   PyTorch versions agree to a few ulp per cell.

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileCols = 64;
constexpr int kTileK = 32;
constexpr int kColGroups = 16;                 // threads across a tile row
constexpr int kColsPerThread = kTileCols / kColGroups;
constexpr int kXStride = kTileCols + 1;
constexpr int kSmemLimit = 232448;

struct Args {
  const float* noise;   // [2, rows, n] or nullptr for the seeded entry
  const float* lt;      // [n, n] half-scaled upper-triangular factor
  const float* vd;      // [n] half variance drift
  const float* llo;     // [n] log lower bounds (K2)
  const float* lhi;     // [n] log upper bounds (K2)
  const float* disc;    // [n] discounts (K2)
  float* out;           // K1: [rows, n+1]; K2: [rows / BP] partial sums
  int rows, n, ld;
  uint32_t key;
  float r, dt, sqrt_dt, log_s0, s0, strike;
  int is_call;
};

// Fill the block's N and W planes [BP][ld] from the stream or the input.
template <int BP, bool SEEDED>
__device__ void load_noise(const Args& a, int row0, float* ns, float* ws) {
  const int n = a.n, ld = a.ld;
  if (SEEDED) {
    const int pairs = (n + 1) / 2;
    for (int idx = threadIdx.x; idx < BP * pairs; idx += kThreads) {
      const int p = idx / pairs, j = idx - p * pairs;
      float n0, w0, n1, w1;
      mcop::step_pair_normals(a.key, row0 + p, j, &n0, &w0, &n1, &w1);
      ns[p * ld + 2 * j] = n0;
      ws[p * ld + 2 * j] = w0;
      if (2 * j + 1 < n) {
        ns[p * ld + 2 * j + 1] = n1;
        ws[p * ld + 2 * j + 1] = w1;
      }
    }
  } else {
    const size_t plane = static_cast<size_t>(a.rows) * n;
    for (int idx = threadIdx.x; idx < BP * n; idx += kThreads) {
      const int p = idx / n, c = idx - p * n;
      const size_t g = static_cast<size_t>(row0 + p) * n + c;
      ns[p * ld + c] = a.noise[g];
      ws[p * ld + c] = a.noise[plane + g];
    }
  }
}

template <int PM, bool SEEDED, bool PRICED>
__global__ void __launch_bounds__(kThreads, 1) path_kernel(Args a) {
  constexpr int BP = 16 * PM;
  extern __shared__ float smem[];
  const int n = a.n, ld = a.ld;
  float* ns = smem;                       // [BP][ld]
  float* ws = ns + BP * ld;               // [BP][ld]
  float* xs = ws + BP * ld;               // [BP][kXStride]
  float* lts = xs + BP * kXStride;        // [kTileK][kTileCols]
  float* red = lts + kTileK * kTileCols;  // [BP]

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * BP;
  const int tx = tid % kColGroups;        // columns tx + 16 j
  const int ty = tid / kColGroups;        // paths ty * PM + i

  load_noise<BP, SEEDED>(a, row0, ns, ws);
  if (!PRICED) {
    for (int p = tid; p < BP; p += kThreads)
      a.out[static_cast<size_t>(row0 + p) * (n + 1)] = a.s0;
  }

  // Per-path state, held by thread p < BP across tiles.
  float ls = a.log_s0;
  bool stopped = false;
  float val = 0.0f;

  for (int c0 = 0; c0 < n; c0 += kTileCols) {
    const int kmax = min(c0 + kTileCols, n);
    float acc[PM][kColsPerThread];
#pragma unroll
    for (int i = 0; i < PM; ++i)
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) acc[i][j] = 0.0f;

    for (int k0 = 0; k0 < kmax; k0 += kTileK) {
      const int kn = min(kTileK, kmax - k0);
      __syncthreads();  // previous users of lts (and of xs) are done
      for (int idx = tid; idx < kTileK * kTileCols; idx += kThreads) {
        const int kk = idx / kTileCols, cc = idx - kk * kTileCols;
        const int c = c0 + cc;
        lts[idx] = (kk < kn && c < n)
                       ? a.lt[static_cast<size_t>(k0 + kk) * n + c]
                       : 0.0f;
      }
      __syncthreads();
      for (int kk = 0; kk < kn; ++kk) {
        float b[kColsPerThread];
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j)
          b[j] = lts[kk * kTileCols + tx + kColGroups * j];
#pragma unroll
        for (int i = 0; i < PM; ++i) {
          const float nv = ns[(ty * PM + i) * ld + k0 + kk];
#pragma unroll
          for (int j = 0; j < kColsPerThread; ++j)
            acc[i][j] = fmaf(nv, b[j], acc[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < PM; ++i)
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j)
        xs[(ty * PM + i) * kXStride + tx + kColGroups * j] = acc[i][j];
    __syncthreads();

    // Variance exp and Euler increment, elementwise over the tile.
    const int cn = kmax - c0;
    for (int idx = tid; idx < BP * kTileCols; idx += kThreads) {
      const int p = idx / kTileCols, cc = idx - p * kTileCols;
      float* xp = &xs[p * kXStride + cc];
      if (cc < cn) {
        const int c = c0 + cc;
        const float sv = expf(*xp + a.vd[c]);
        const float v = sv * sv;
        *xp = (a.r - 0.5f * v) * a.dt + sv * (ws[p * ld + c] * a.sqrt_dt);
      } else {
        *xp = 0.0f;
      }
    }
    __syncthreads();

    // Running sum (and the first-hit test) along the tile, one thread per
    // path.
    if (tid < BP) {
      float* xp = &xs[tid * kXStride];
      for (int cc = 0; cc < cn; ++cc) {
        ls += xp[cc];
        if (PRICED) {
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
          a.out[static_cast<size_t>(row0 + p) * (n + 1) + c0 + cc + 1] =
              expf(xs[p * kXStride + cc]);
      }
    }
  }

  if (PRICED) {
    if (tid < BP) red[tid] = val;
    __syncthreads();
    if (tid == 0) {
      float sum = 0.0f;
      for (int p = 0; p < BP; ++p) sum += red[p];
      a.out[blockIdx.x] = sum;
    }
  }
}

int smem_bytes(int n, int bp) {
  const int ld = n | 1;
  return 4 * (2 * bp * ld + bp * kXStride + kTileK * kTileCols + bp);
}

template <int PM, bool SEEDED, bool PRICED>
cudaError_t launch_one(const Args& a, cudaStream_t stream) {
  const int smem = smem_bytes(a.n, 16 * PM);
  auto kernel = path_kernel<PM, SEEDED, PRICED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<a.rows / (16 * PM), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool PRICED>
cudaError_t launch(const Args& a, int block_paths, cudaStream_t stream) {
  if (a.n < 1 || a.rows < 1 || block_paths < 16 || block_paths % 16 ||
      a.rows % block_paths || smem_bytes(a.n, block_paths) > kSmemLimit)
    return cudaErrorInvalidValue;
  const bool seeded = a.noise == nullptr;
  switch (block_paths) {
    case 64:
      return seeded ? launch_one<4, true, PRICED>(a, stream)
                    : launch_one<4, false, PRICED>(a, stream);
    case 32:
      return seeded ? launch_one<2, true, PRICED>(a, stream)
                    : launch_one<2, false, PRICED>(a, stream);
    case 16:
      return seeded ? launch_one<1, true, PRICED>(a, stream)
                    : launch_one<1, false, PRICED>(a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// K1.  noise may be null (seeded entry, stream of `key`).
int mcop_pathgen(const float* noise, const float* lt, const float* vd,
                 int rows, int n_steps, int block_paths, unsigned int key,
                 float r, float dt, float sqrt_dt, float log_s0, float s0,
                 float* out, void* stream) {
  Args a{};
  a.noise = noise;
  a.lt = lt;
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
  return static_cast<int>(
      launch<false>(a, block_paths, static_cast<cudaStream_t>(stream)));
}

// K2.  table: rows 0-2 of the log_boundary_rows table, row stride
// table_stride floats.  out: [rows / block_paths] partial sums.
int mcop_priced_chunk(const float* noise, const float* lt, const float* vd,
                      int rows, int n_steps, int block_paths,
                      unsigned int key, float r, float dt, float sqrt_dt,
                      float log_s0, const float* table, long long table_stride,
                      float strike, int is_call, float* out, void* stream) {
  Args a{};
  a.noise = noise;
  a.lt = lt;
  a.vd = vd;
  a.llo = table;
  a.lhi = table + table_stride;
  a.disc = table + 2 * table_stride;
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
  a.is_call = is_call;
  return static_cast<int>(
      launch<true>(a, block_paths, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
