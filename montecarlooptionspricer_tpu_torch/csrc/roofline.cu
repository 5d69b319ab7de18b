// P1: the roofline probes of the path kernels on Hopper (sm_90a), bound
// through a plain C interface and loaded with ctypes
// (montecarlooptionspricer_tpu_torch/roofline.py).
//
// P1/normals mcop_roofline_normals replaces parity/vpu_roofline.py:
//    nrm_kernel (pallas_call at :110): each block draws k * unroll planes
//    of [512, 512] standard normals and accumulates them; with_exp takes
//    exp(plane * 1e-3) first, fma applies that many dependent
//    plane * 0.999999 + 1e-7.
// P1/matmul mcop_roofline_matmul replaces parity/vpu_roofline.py:mm_kernel
//    (pallas_call at :177): a0 ~ normals [512, s_pad] per block, then
//    k * unroll dependent steps a = a @ B, and the column sums of a.
//
// What they measure: the rates of the path kernels' own arithmetic on this
// card, from the two-point deltas of roofline.py (unroll 3 against 1, and
// with_exp / fma against the plain draw at the same k), which cancel the
// launch and the loop: Box-Muller normals from the Philox stream, precise
// expf, float32 multiply-adds, and the fGN product as K6/K7 run it (the
// slab's tile product, csrc/slab_tile.cuh) on the CUDA cores (float32
// B) and on the tensor cores (bf16 B: bf16 inputs, float32 sums).  The
// product's rate is that of this code, not of the card: a library's
// product at the same shape may run faster.

// Design:
// * The draws use the path kernels' device functions (csrc/philox.cuh):
//   normal (column c, plane t, row 4q + i) is the i-th of (n0, w0, n1, w1)
//   of step_pair_normals(key, c, 128 t + q), so the plain version is
//   philox_normals_ref of c, steps 256 t .. 256 t + 255, both planes.
// * The TPU kernel keeps lanes 0-127 of each column sum; its PRNG is a side
//   effect its compiler cannot drop, but Philox is pure arithmetic, so a
//   kernel that wrote a quarter of the sums would lose three quarters of
//   its draws to dead-code elimination.  Every block writes all 512 column
//   sums ([grid, 512]); roofline.stripe forms JAX's [grid * 8, 128].
// * The TPU ran its 64 grid steps in order on one core; here the caller
//   sizes the grid to fill the card, one thread per column (512 a block).
// * A [512, 384] float32 block of the matmul chain (786 KB) exceeds a
//   block's 227 KB of shared memory.  Each row's chain is independent, so
//   a JAX block's 512 rows split over 4 CUDA blocks of 128 rows, the
//   slab's 128-path blocks (two an SM).  As K6/K7 read their N plane, a
//   block reads its rows of a from device memory (two buffers, the step's
//   input and output, in the workspace the wrapper passes) k-tile by
//   k-tile, B streams from L2 as Lt' does, and each column tile's X is
//   written back to the output buffer.  Under bf16 each step also writes
//   its output rounded to bf16 (the product's rounding, so the product is
//   the same bits), and the next step's product copies those rows 16
//   bytes at a time as K6/K7 copy their seeded bf16 N.  Each CUDA block
//   writes the column sums of its 128 rows; the wrapper adds the 4 of a
//   JAX block.
// * No --use_fast_math: expf, logf, sinf and cosf are the kernels' own
//   precise ones.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "build_unit.cuh"
#include "philox.cuh"
#include "slab_tile.cuh"

namespace {

namespace slab = mcop::slab;

constexpr int kLanes = 512;           // columns of a normals plane
constexpr int kPlaneRows = 512;       // rows of a normals plane (BLOCK)
constexpr int kQuads = kPlaneRows / 4;
constexpr int kMmPM = 8;              // the slab's 128-row blocks
constexpr int kMmRows = 16 * kMmPM;   // rows of a a CUDA block runs
constexpr int kMmSplit = kPlaneRows / kMmRows;   // CUDA blocks a JAX block
constexpr int kSmemLimit = 232448;

// One thread per column: the column's sum over k * unroll planes.
template <bool WITH_EXP, int FMA>
__global__ void __launch_bounds__(kLanes) normals_kernel(uint32_t key, int k,
                                                         int unroll,
                                                         float* out) {
  const int col = blockIdx.x * kLanes + threadIdx.x;
  float acc = 0.0f;
  for (int it = 0; it < k; ++it) {
    for (int u = 0; u < unroll; ++u) {
      const int step0 = (it * unroll + u) * kQuads;
#pragma unroll 4
      for (int q = 0; q < kQuads; ++q) {
        float v[4];
        mcop::step_pair_normals(key, col, step0 + q, &v[0], &v[1], &v[2],
                                &v[3]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float x = v[i];
          if (WITH_EXP) x = expf(x * 1e-3f);
#pragma unroll
          for (int j = 0; j < FMA; ++j) x = fmaf(x, 0.999999f, 1e-7f);
          acc += x;
        }
      }
    }
  }
  out[col] = acc;
}

// Shared memory of a matmul-probe block: the slab's ring of k-tile stages
// at kMmRows rows, sharing its room with the X tile of its rows.
template <bool BF16>
constexpr int mm_smem_bytes() {
  constexpr int ring = slab::ring_floats(kMmRows, false, BF16);
  constexpr int x = kMmRows * slab::kXStride;
  return 4 * (ring > x ? ring : x);
}

// kMmRows rows of the chain in a0 / a1 ([rows][s_pad] each, the step's
// input and output in turn): a0 from the stream (the N plane of
// step_pair_normals over the row's s_pad steps), k * unroll steps
// a = a @ B, each column tile by the slab's product (B dense, rows of
// s_pad: 16-byte copies; a's float32 rows copied 4 bytes a cell), then the
// column sums of the block's rows into out[blockIdx.x][s_pad].  BF16: a
// is also kept rounded to bf16 in b0 / b1 (the rounding the product would
// make of it), from which the product copies 16 bytes at a time.
template <bool BF16>
__global__ void __launch_bounds__(slab::kThreads, 2) matmul_kernel(
    uint32_t key, const void* b, int s_pad, int k, int unroll, float* a0,
    float* a1, __nv_bfloat16* b0, __nv_bfloat16* b1, float* out) {
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);     // the k-tile stages
  float* xs = ring;                                  // [kMmRows][kXStride]
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kMmRows;
  const size_t first = static_cast<size_t>(row0) * s_pad;
  float* acur = a0 + first;
  float* anext = a1 + first;
  __nv_bfloat16* bcur = BF16 ? b0 + first : nullptr;
  __nv_bfloat16* bnext = BF16 ? b1 + first : nullptr;
  const int pairs = s_pad / 2;
  for (int idx = tid; (mcop::kPhases & mcop::kPhaseDraw) &&
                      idx < kMmRows * pairs;
       idx += slab::kThreads) {
    const int p = idx / pairs, j = idx - p * pairs;
    float n0, w0, n1, w1;
    mcop::step_pair_normals(key, row0 + p, j, &n0, &w0, &n1, &w1);
    acur[p * s_pad + 2 * j] = n0;
    acur[p * s_pad + 2 * j + 1] = n1;
    if (BF16)
      *reinterpret_cast<__nv_bfloat162*>(bcur + p * s_pad + 2 * j) =
          __floats2bfloat162_rn(n0, n1);
  }
  const int steps = k * unroll;
  for (int s = 0; s < steps; ++s) {
    const slab::Operands o{BF16 ? static_cast<const void*>(bcur) : acur,
                           nullptr, s_pad, b, nullptr, s_pad, s_pad};
    for (int c0 = 0; c0 < s_pad; c0 += slab::kTileCols) {
      // Each call starts on the block's barrier, so a's writes of the
      // previous step (and xs's readers below) are done.
      if constexpr (BF16)
        slab::tile_product<kMmPM, false, false, true, slab::Rows::kBf16>(
            o, c0, ring, xs);
      else
        slab::tile_product<kMmPM, false, false, false, slab::Rows::kF32>(
            o, c0, ring, xs);
      for (int idx = tid; (mcop::kPhases & mcop::kPhaseOut) &&
                          idx < kMmRows * slab::kTileCols;
           idx += slab::kThreads) {
        const int p = idx / slab::kTileCols, cc = idx - p * slab::kTileCols;
        const float x = xs[p * slab::kXStride + cc];
        anext[static_cast<size_t>(p) * s_pad + c0 + cc] = x;
        if (BF16)
          bnext[static_cast<size_t>(p) * s_pad + c0 + cc] =
              __float2bfloat16_rn(x);
      }
    }
    float* t = acur;
    acur = anext;
    anext = t;
    __nv_bfloat16* tb = bcur;
    bcur = bnext;
    bnext = tb;
  }
  __syncthreads();
  for (int c = tid; c < s_pad; c += slab::kThreads) {
    float sum = 0.0f;
    for (int p = 0; p < kMmRows; ++p)
      sum += acur[static_cast<size_t>(p) * s_pad + c];
    out[static_cast<size_t>(blockIdx.x) * s_pad + c] = sum;
  }
}

template <bool WITH_EXP, int FMA>
cudaError_t launch_normals(uint32_t key, int grid, int k, int unroll,
                           float* out, cudaStream_t stream) {
  normals_kernel<WITH_EXP, FMA><<<grid, kLanes, 0, stream>>>(key, k, unroll,
                                                             out);
  return cudaGetLastError();
}

template <bool BF16>
cudaError_t launch_matmul(uint32_t key, const void* b, int grid, int s_pad,
                          int k, int unroll, float* work, float* out,
                          cudaStream_t stream) {
  constexpr int smem = mm_smem_bytes<BF16>();
  static_assert(smem <= kSmemLimit, "tile shapes exceed shared memory");
  auto kernel = matmul_kernel<BF16>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const size_t plane = static_cast<size_t>(grid) * kPlaneRows * s_pad;
  auto* shadow = reinterpret_cast<__nv_bfloat16*>(work + 2 * plane);
  kernel<<<grid * kMmSplit, slab::kThreads, smem, stream>>>(
      key, b, s_pad, k, unroll, work, work + plane, BF16 ? shadow : nullptr,
      BF16 ? shadow + plane : nullptr, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// P1/normals.  out: [grid, 512] float32 column sums.  fma, the FMA chain's
// length, is 0 or 8 (the script's J), and not with with_exp.
int mcop_roofline_normals(unsigned int key, int grid, int k, int unroll,
                          int with_exp, int fma, float* out, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (grid < 1 || k < 1 || unroll < 1 || (fma != 0 && fma != 8) ||
      (with_exp && fma))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (fma)
    err = launch_normals<false, 8>(key, grid, k, unroll, out, s);
  else if (with_exp)
    err = launch_normals<true, 0>(key, grid, k, unroll, out, s);
  else
    err = launch_normals<false, 0>(key, grid, k, unroll, out, s);
  return static_cast<int>(err);
}

// P1/matmul.  b: [s_pad, s_pad] float32 (bf16 == 0: the CUDA cores) or
// bf16 (the tensor cores); s_pad a multiple of 128.  grid counts JAX
// blocks of 512 rows; work: [2, grid * 512, s_pad] float32, a's two
// buffers, and under bf16 a third plane for their bf16 shadows; out:
// [grid * 4, s_pad] float32 column sums, 4 consecutive rows of it per JAX
// block.
int mcop_roofline_matmul(unsigned int key, const void* b, int grid,
                         int s_pad, int k, int unroll, int bf16, float* work,
                         float* out, void* stream) {
  if (grid < 1 || k < 1 || unroll < 1 || s_pad < slab::kTileCols ||
      s_pad % slab::kTileCols)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      bf16 ? launch_matmul<true>(key, b, grid, s_pad, k, unroll, work, out, s)
           : launch_matmul<false>(key, b, grid, s_pad, k, unroll, work, out,
                                  s));
}

}  // extern "C"
