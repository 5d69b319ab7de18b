// Step-tiled rough-Bergomi path kernels for Hopper (sm_90a), for horizons
// past the single-tile kernels of csrc/pathgen.cu.  Bound through a plain C
// interface and loaded with ctypes (models/pathgen_tiled_cuda.py).
//
// K6 mcop_tiled_pathgen replaces montecarlooptionspricer_tpu/models/
//    pathgen_pallas_tiled.py:_tiled_pathgen_kernel (and
//    _tiled_pathgen_kernel_noise_in), chol fGN form, no antithetic.
// K7 mcop_tiled_priced_chunk replaces pathgen_pallas_tiled.py:
//    _tiled_priced_kernel (and _tiled_priced_kernel_noise_in), chol form,
//    log-boundary policy, no control variate, no antithetic.
//
// They compute what K1 and K2 compute, on the same seeded stream
// (csrc/philox.cuh), re-blocked over the step axis.  Per path p and step
// column c < n (column c = step c+1):
//   x_c    = sum_{k <= c} N[p,k] * Lt'[k,c]        (Lt' = 0.5 Lt, upper)
//   sv     = exp(x_c + vd[c])
//   inc    = (r - sv^2/2) dt + sv * W[p,c] * sqrt(dt)
//   logS_c = log s0 + sum_{k <= c} inc_k
// K6 writes out[p, 0] = s0 and out[p, c+1] = exp(logS_c).  K7 stops each
// path at the first c with llo[c] <= logS_c <= lhi[c], adds
// disc[c] * max(+-(exp(logS_c) - strike), 0), and writes one partial sum
// per block (no atomics, so a seed gives the same sum on every run).
//
// Bound on the H100: operations.  At n = 1825 and 131072 rows the
// triangular fGN product is 2.2e11 multiply-adds; with ~8 operations per
// cell besides that is 4.4e11 operations, 6.55 ms at the card's 67 TFLOP/s
// float32 (full float32 is kept: no tensor cores), while the bytes that
// must move (Lt', and K6's 957 MB of prices) take 0.29 ms.
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
//   end at its last column only: Lt' is upper triangular.
// * The TPU grid carried per-path state across step tiles in scratch.
//   Here the state of path p (log-price carry, stopped flag, stop value)
//   lives in the registers of thread p < BP, which runs the running sum and
//   the first-hit test along each tile.  Padded columns past n are never
//   computed.  W is read once, at its own tile.
// * No --use_fast_math: logf/expf/sinf/cosf stay precise so the plain
//   PyTorch versions agree to a few ulp per cell.

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileCols = 128;                 // step columns per output tile
constexpr int kHalfCols = kTileCols / 2;
constexpr int kTileK = 16;                     // steps per staged k-tile
constexpr int kColGroups = 16;                 // threads across a tile row
constexpr int kXStride = kTileCols + 1;
constexpr int kSmemLimit = 232448;

struct Args {
  float* noise;         // [2, rows, n]: the input, or the seeded workspace
  const float* lt;      // [n, n] half-scaled upper-triangular factor
  const float* vd;      // [n] half variance drift
  const float* llo;     // [n] log lower bounds (K7)
  const float* lhi;     // [n] log upper bounds (K7)
  const float* disc;    // [n] discounts (K7)
  float* out;           // K6: [rows, n+1]; K7: [rows / BP] partial sums
  int rows, n;
  uint32_t key;
  float r, dt, sqrt_dt, log_s0, s0, strike;
  int is_call;
};

// Shared memory of one block, in floats: the N^T k-tile (row stride BP+4,
// a multiple of 4 for float4 reads), the Lt' k-tile, the X tile (stride
// kTileCols+1, so the per-path loop reads distinct banks) and the
// path-sum slots.
template <int PM>
struct Layout {
  static constexpr int kBP = 16 * PM;
  static constexpr int kNStride = kBP + 4;
  static constexpr int kFloats = kTileK * kNStride + kTileK * kTileCols +
                                 kBP * kXStride + kBP;
  static constexpr int kBytes = 4 * kFloats;
};

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

// Seeded entry: draw the block's rows of N and W into the plane.
template <int BP>
__device__ void draw_rows(const Args& a, int row0) {
  const int n = a.n, pairs = (n + 1) / 2;
  const size_t plane = static_cast<size_t>(a.rows) * n;
  for (int idx = threadIdx.x; idx < BP * pairs; idx += kThreads) {
    const int p = idx / pairs, j = idx - p * pairs;
    float n0, w0, n1, w1;
    mcop::step_pair_normals(a.key, row0 + p, j, &n0, &w0, &n1, &w1);
    const size_t g = static_cast<size_t>(row0 + p) * n + 2 * j;
    a.noise[g] = n0;
    a.noise[plane + g] = w0;
    if (2 * j + 1 < n) {
      a.noise[g + 1] = n1;
      a.noise[plane + g + 1] = w1;
    }
  }
}

template <int PM, bool SEEDED, bool PRICED>
__global__ void __launch_bounds__(kThreads, 2) tiled_kernel(Args a) {
  using L = Layout<PM>;
  constexpr int BP = L::kBP;
  constexpr int NS = L::kNStride;
  extern __shared__ float4 smem4[];
  float* ns = reinterpret_cast<float*>(smem4);  // [kTileK][NS]   N^T k-tile
  float* lts = ns + kTileK * NS;                // [kTileK][kTileCols]
  float* xs = lts + kTileK * kTileCols;         // [BP][kXStride]
  float* red = xs + BP * kXStride;              // [BP]

  const int n = a.n;
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * BP;
  const int tx = tid % kColGroups;              // columns tx*4.., 64+tx*4..
  const int ty = tid / kColGroups;              // paths ty*PM + i
  const size_t plane = static_cast<size_t>(a.rows) * n;
  const float* nrows = a.noise + static_cast<size_t>(row0) * n;
  const float* wrows = nrows + plane;

  if (SEEDED) {
    draw_rows<BP>(a, row0);
    __syncthreads();  // the block's plane writes are visible to the block
  }
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
    float acc[PM][8];
#pragma unroll
    for (int i = 0; i < PM; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

    for (int k0 = 0; k0 < kmax; k0 += kTileK) {
      const int kn = min(kTileK, kmax - k0);
      __syncthreads();  // previous readers of ns/lts are done
      for (int idx = tid; idx < BP * kTileK; idx += kThreads) {
        const int p = idx / kTileK, kk = idx - p * kTileK;
        ns[kk * NS + p] =
            kk < kn ? nrows[static_cast<size_t>(p) * n + k0 + kk] : 0.0f;
      }
      for (int idx = tid; idx < kTileK * kTileCols; idx += kThreads) {
        const int kk = idx / kTileCols, cc = idx - kk * kTileCols;
        const int c = c0 + cc;
        lts[idx] = (kk < kn && c < n)
                       ? a.lt[static_cast<size_t>(k0 + kk) * n + c]
                       : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kTileK; ++kk) {
        float av[PM];
        load_paths<PM>(ns + kk * NS + ty * PM, av);
        const float4 b0 =
            *reinterpret_cast<const float4*>(lts + kk * kTileCols + tx * 4);
        const float4 b1 = *reinterpret_cast<const float4*>(
            lts + kk * kTileCols + kHalfCols + tx * 4);
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < PM; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], b[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < PM; ++i) {
      float* xrow = xs + (ty * PM + i) * kXStride;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        xrow[tx * 4 + j] = acc[i][j];
        xrow[kHalfCols + tx * 4 + j] = acc[i][4 + j];
      }
    }
    __syncthreads();

    // Variance exp and Euler increment, elementwise over the tile.
    const int cn = kmax - c0;
    for (int idx = tid; idx < BP * kTileCols; idx += kThreads) {
      const int p = idx / kTileCols, cc = idx - p * kTileCols;
      if (cc < cn) {
        const int c = c0 + cc;
        float* xp = &xs[p * kXStride + cc];
        const float sv = expf(*xp + a.vd[c]);
        const float v = sv * sv;
        *xp = (a.r - 0.5f * v) * a.dt +
              sv * (wrows[static_cast<size_t>(p) * n + c] * a.sqrt_dt);
      }
    }
    __syncthreads();

    // Running sum (and the first-hit test) along the tile, one thread per
    // path; the carry crosses tiles in registers.
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

template <int PM, bool SEEDED, bool PRICED>
cudaError_t launch_one(const Args& a, cudaStream_t stream) {
  constexpr int smem = Layout<PM>::kBytes;
  static_assert(smem <= kSmemLimit, "tile shapes exceed shared memory");
  auto kernel = tiled_kernel<PM, SEEDED, PRICED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<a.rows / (16 * PM), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool SEEDED, bool PRICED>
cudaError_t launch_pm(const Args& a, int block_paths, cudaStream_t stream) {
  switch (block_paths) {
    case 128:
      return launch_one<8, SEEDED, PRICED>(a, stream);
    case 64:
      return launch_one<4, SEEDED, PRICED>(a, stream);
    case 32:
      return launch_one<2, SEEDED, PRICED>(a, stream);
    case 16:
      return launch_one<1, SEEDED, PRICED>(a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool PRICED>
cudaError_t launch(const Args& a, int seeded, int block_paths,
                   cudaStream_t stream) {
  if (a.n < 1 || a.rows < 1 || a.noise == nullptr || block_paths < 16 ||
      a.rows % block_paths)
    return cudaErrorInvalidValue;
  return seeded ? launch_pm<true, PRICED>(a, block_paths, stream)
                : launch_pm<false, PRICED>(a, block_paths, stream);
}

Args make_args(float* noise, const float* lt, const float* vd, int rows,
               int n_steps, unsigned int key, float r, float dt,
               float sqrt_dt, float log_s0) {
  Args a{};
  a.noise = noise;
  a.lt = lt;
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

// The per-block shared memory of the tiled kernels at this block size, or
// -1 for a block size they do not take.
int mcop_tiled_smem_bytes(int block_paths) {
  switch (block_paths) {
    case 128:
      return Layout<8>::kBytes;
    case 64:
      return Layout<4>::kBytes;
    case 32:
      return Layout<2>::kBytes;
    case 16:
      return Layout<1>::kBytes;
    default:
      return -1;
  }
}

// K6.  noise: [2, rows, n_steps] float32, read as given (seeded == 0) or
// filled first from the stream of `key` (seeded != 0, a workspace).
int mcop_tiled_pathgen(float* noise, int seeded, const float* lt,
                       const float* vd, int rows, int n_steps,
                       int block_paths, unsigned int key, float r, float dt,
                       float sqrt_dt, float log_s0, float s0, float* out,
                       void* stream) {
  Args a = make_args(noise, lt, vd, rows, n_steps, key, r, dt, sqrt_dt,
                     log_s0);
  a.s0 = s0;
  a.out = out;
  return static_cast<int>(launch<false>(a, seeded, block_paths,
                                        static_cast<cudaStream_t>(stream)));
}

// K7.  table: rows 0-2 of the log_boundary_rows table, row stride
// table_stride floats.  out: [rows / block_paths] partial sums.
int mcop_tiled_priced_chunk(float* noise, int seeded, const float* lt,
                            const float* vd, int rows, int n_steps,
                            int block_paths, unsigned int key, float r,
                            float dt, float sqrt_dt, float log_s0,
                            const float* table, long long table_stride,
                            float strike, int is_call, float* out,
                            void* stream) {
  Args a = make_args(noise, lt, vd, rows, n_steps, key, r, dt, sqrt_dt,
                     log_s0);
  a.llo = table;
  a.lhi = table + table_stride;
  a.disc = table + 2 * table_stride;
  a.strike = strike;
  a.is_call = is_call;
  a.out = out;
  return static_cast<int>(launch<true>(a, seeded, block_paths,
                                       static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
