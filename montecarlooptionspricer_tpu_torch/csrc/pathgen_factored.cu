// Factored-DFT rough-Bergomi path kernels for Hopper (sm_90a): the spectral
// fGN law at long horizons.  Bound through a plain C interface and loaded
// with ctypes (models/pathgen_factored_cuda.py).
//
// K8 mcop_factored_pathgen replaces montecarlooptionspricer_tpu/models/
//    pathgen_pallas_factored.py:_factored_pathgen_kernel (and
//    _factored_pathgen_kernel_noise_in), plain and paired (the whole-path
//    pair body: stages 1 and 2 once per drawn path, :222 and :250).
// K9 mcop_factored_priced_chunk replaces pathgen_pallas_factored.py:
//    _factored_priced_kernel (and _factored_priced_kernel_noise_in, :330-385).
//    Log-boundary policy in four forms: plain, antithetic (_pair_tiles),
//    control variate (_finalize_priced_log) and both; the quadratic policy
//    (QUAD: _priced_step:300-327's else branch, the policy of
//    pathgen_pallas_tiled._policy_tile) plain and with the control variate.
// Both also run the bf16 fGN-input form of every body (BF16, from the
//    bf16 flag; StreamConfig.fgn_matmul_dtype="bfloat16", _stage1:158 on
//    bf16 a and F1, pathgen_pallas_factored.py:174-175 and :129-131): the
//    host rounds F1 to bf16, the kernel rounds a = Z * phi' to bf16, and
//    stage 1 sums in float32 on the tensor cores; the twiddle, stage 2 and
//    everything after stay float32.
//
// Build units (csrc/build_unit.cuh): this source is built twice, the
// float32 and the bf16 bodies apart (each with its seeded and noise-in
// entries); an entry given the other dtype's flag returns
// cudaErrorInvalidValue.
//
// Per path p, with m2 = next_pow2(n), N2 = m2 / 128 and the fGN noise
// a = Z * phi' stored transposed (column c = 128 k2 + k1 holds frequency
// k = N2 k1 + k2), the half-scaled fGN increment of step m = m1 + 128 j is
//   S [k2, m1] = sum_k1 a[128 k2 + k1] F1[k1, m1]     (stage 1, complex)
//   S'[k2, m1] = S[k2, m1] tw[k2, m1]                   (twiddle)
//   x_m = sum_k2 Re S'[k2, m1] cos2[k2, j] + Im S'[k2, m1] sin2[k2, j]
//                                                       (stage 2)
// with every angle reduced exactly on the host (no sinf/cosf of a large
// argument here).  Then, as in K6/K7, sv = exp(x_m + vd[m]),
// inc = (r - sv^2/2) dt + sv W[p,m] sqrt(dt), logS = log s0 + running sum;
// K8 writes out[p, 0] = s0 and out[p, m+1] = exp(logS_m), and its pair
// form the drawn rows' paths to rows [0, rows/2) and their partners' to
// [rows/2, rows), the [X; -X] of the unpaired kernel; K9 stops each
// path at its first m with llo[m] <= logS_m <= lhi[m] (QUAD: where the
// policy table's quadratic says exercise, csrc/quad_policy.cuh), adds
// disc[m] max(+-(exp(logS_m) - strike), 0) and writes one partial sum per
// block (no atomics, so a seed gives the same sum on every run).  The
// control-variate forms add cv_disc * sum_p exp(logS_{p,n-1}) per block;
// the antithetic forms price drawn path q as (Z, W) and (-Z, -W), and both
// DFT stages are linear, so the partner's increments come from -x.
//
// Work and bound on the H100.  This four-step split with a dense 128-point
// stage 1 and an N2-point stage 2 is the TPU's choice of algorithm (its
// MXU wants the product), kept here: per path stage 1 is 8 N2 128^2 float32
// operations (a complex multiply-add is four), stage 2 4 N2 s_pad and the
// rest ~8 per step, 2.24M at 1825 steps (N2 16, s_pad 1920) and 4.75M at
// 4000 (N2 32, s_pad 4096), i.e. 4.4 ms and 9.3 ms per 131072 rows at the
// card's 67 TFLOP/s float32 (full float32 on CUDA cores: no TF32, no
// wgmma).  The function itself needs far less: a length-m2 FFT is
// 5 m2 log2 m2 operations per path, 19 times fewer, so the least time is
// set by K8's prices (2.1 GB, 0.63 ms at 4000 steps) and, for K9, by the
// FFT's operations (0.59 ms); chip_smoke.py's factored_bound_ms counts it.
// The bf16 form moves stage 1 (the FFT's first log2(128) of log2(m2)
// stages) onto the tensor cores at 989 TFLOP/s: stage 1's 8 N2 128^2
// operations a path become 0.3 ms at 4000 steps, so stage 2, the exp and
// the scan on the CUDA cores bound it.
//
// Design:
// * Shared memory.  The TPU kept the whole block's twiddled stage-1 output
//   in VMEM ([N2, block, 128] x 2, 2 MB at block 256 and m2 2048); one
//   H100 block may use 232,448 bytes, and at m2 4096 one path's S' alone is
//   32 KB.  So a block owns the 64 stage-1 rows (path, k2) of P = 64 / N2
//   paths (4 at 1825 steps, 2 at 4000): S' is 64 KB at every horizon.  A
//   second 32 KB region holds first the staged k-tiles of the noise (row
//   stride 68, so a thread reads its four rows as one float4) and of F1
//   (16 of its 128 rows at a time), then the P paths' Euler increments
//   ([P, m2] = 32 KB).  The stage-2 cos/sin table (rows padded to four
//   columns) adds 2 N2 max(N2, 4) floats.  Total 100,352 bytes at N2 16,
//   106,496 at N2 32: two blocks per SM.  N2 may grow to 64 (m2 8192),
//   where the table brings the block to 131,072 bytes.
// * Registers: 128 a thread (the cap for two 256-thread blocks per SM),
//   no spills (-Xptxas -v).  The seeded entries' 32-byte stack frame is
//   the precise sinf/cosf large-argument reduction buffer of Box-Muller,
//   as in every seeded kernel of the port.
// * Stage 1: 256 threads, each a 4-row x 8-column complex micro-tile of
//   the [64, 128] output (rows ty*4.., columns tx*4.. and 64+tx*4..), six
//   float4 shared-memory reads per 128 multiply-adds.  The seeded entry
//   draws the noise straight into the staged k-tile (one Philox call per
//   two columns); the noise-in entry reads it from device memory.
// * Stage 2 and the increments (pass A): a thread takes one path, four
//   consecutive steps m1..m1+3 and four step tiles j0..j0+3, so each S'
//   float4 it reads serves sixteen outputs; it adds exp, W (one Philox call
//   per four steps when seeded) and the Euler increment, and stores the
//   increments in shared memory.
// * The running sum (pass B): one warp per path walks the path 128 steps
//   at a time, four steps a lane, with a warp scan and the carry in a
//   register.  K9 finds the first hit with a ballot and leaves the path
//   there.  The TPU's cross-tile scratch carries are gone: a block holds
//   its paths whole.  Under QUAD each lane tests its four steps in order,
//   exp and the policy's seven table rows (__ldg) per step, up to its
//   first hit, ahead of the same ballot.
// * The forms.  Under CV a warp that found its path's first hit keeps
//   scanning to step n-1 (the scan is cheap beside stage 1) for the
//   terminal log price.  A paired block runs stages 1 and 2 for its P
//   drawn paths only; pass A then stores x, not increments, and a pass A2
//   writes both members' increments into the S' region, free once stage 2
//   has read it (2 P m2 floats, 64 KB, at every horizon).  So shared
//   memory does not grow, 8,192 steps (one drawn path, two members) still
//   fit, and the W draw runs once per pair.  Paired K8 runs the same
//   passes and writes member q >= P to the partner row `drawn` rows below
//   drawn row q - P: it takes every horizon the plain K8 takes.
// * The bf16 form (BF16) runs stage 1 as m16n8k16 tensor-core products
//   (csrc/mma_bf16.cuh): a = Z * phi' is computed in float32 with every
//   rounding explicit (the plain version's order) and stored rounded to
//   nearest even, all 128 k at once, into bf16 rows [64][136] in the S'
//   region (free until the twiddle; k contiguous, the row stride of 68
//   words 4 mod 8, so fragment reads are conflict-free), before any sum
//   is live, so the draws and the 64 accumulators never share registers;
//   F1's bf16 k-tiles of 32 are stored column by column in region 2,
//   [128 columns][40], entry (k, m1) at m1 * 40 + k, as the B fragments
//   read it.  F1 is symmetric, so that index order is the one thing a
//   check of S cannot see; it follows load_b_frag's layout.  Warp w owns
//   row group w / 2 (16 stage-1 rows) and the eight 8-column groups of
//   half w % 2: Sr = Ar F1r + Ai (-F1i) (the negation exact in bf16, and
//   taken on the B fragment, which is loaded per column group anyway, so
//   it holds no register across the loop), Si = Ar F1i + Ai F1r, 64
//   float32 sums a thread.  The twiddle then reads
//   each sum where the accumulator fragment holds it (rows g and g + 8,
//   columns 2t and 2t + 1 of each m16n8 tile) and stores S' there, after
//   a barrier (a lived in S').  The staging (a 34 KB of S' 64 KB, F1 20 KB
//   of the 32 KB region 2) fits the float32 form's layout, so shared
//   memory, the block and every horizon to 8,192 stay as they are.
// * No --use_fast_math: logf/expf/sinf/cosf stay precise so the plain
//   PyTorch versions agree to a few ulp per cell.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "build_unit.cuh"
#include "mma_bf16.cuh"
#include "philox.cuh"
#include "quad_policy.cuh"

namespace {

using mcop::kUnitBf16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLane = 128;      // N1: stage-1 DFT length = one step tile
constexpr int kRows = 64;       // stage-1 rows (path, k2) per block
constexpr int kTileK = 16;      // k1 per staged k-tile
constexpr int kAStride = kRows + 4;
constexpr int kColGroups = 16;  // threads across the 128 output columns
constexpr int kSmemLimit = 232448;
constexpr int kStagingFloats = 2 * kTileK * kAStride + 2 * kTileK * kLane;
constexpr int kIncFloats = kRows * kLane;  // P paths x m2 steps
constexpr int kRegion2Floats =
    kStagingFloats > kIncFloats ? kStagingFloats : kIncFloats;
// The bf16 form's staging: a (real, imaginary) [kRows][kAStrideB] for
// all 128 k in the S' region (free until the twiddle), and F1's k-tiles
// (real, imaginary) [kLane][kFStrideB] in region 2.  Both strides are 4
// (mod 8) words: conflict-free fragment reads.
constexpr int kTileKB = 32;
constexpr int kAStrideB = kLane + 8;
constexpr int kFStrideB = kTileKB + 8;
static_assert(2 * kRows * kAStrideB / 2 <= 2 * kRows * kLane,
              "the bf16 a must fit the S' region");
static_assert(2 * kLane * kFStrideB / 2 <= kRegion2Floats,
              "the bf16 F1 k-tiles must fit region 2");
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const float* noise;  // [3, rows, m2], or nullptr for the seeded entry
  const void* f1r;     // [128, 128] stage-1 DFT matrix (bf16 under the
  const void* f1i;     // bf16 form, else float32)
  const float* phir;   // [N2, 128] half-scaled diagonal, storage order
  const float* phii;
  const float* twr;    // [N2, 128] twiddle
  const float* twi;
  const float* c2;     // [N2, N2] stage-2 cos and sin
  const float* s2;
  const float* vd;     // [n] half variance drift
  const float* llo;    // [n] log lower bounds (K9)
  const float* lhi;    // [n] log upper bounds (K9)
  const float* disc;   // [n] discounts (K9)
  const float* tab;    // the policy_rows table (K9's QUAD forms)
  long long tstride;   // its row stride, floats
  float* out;          // K8: [rows, n+1]; K9: [1 or 2][blocks] partial sums
  int rows, drawn, n, m2, n2, s_pad;
  int paths;           // drawn paths per block, P = 64 / N2
  uint32_t key;
  float r, dt, sqrt_dt, log_s0, s0, strike, cv_disc;
  int is_call;
  bool bf16;           // the bf16 fGN-input form
};

int next_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

__host__ __device__ constexpr int table_cols(int n2) {
  return n2 < 4 ? 4 : n2;
}

int smem_bytes(int n2) {
  return 4 * (2 * kRows * kLane + kRegion2Floats + 2 * n2 * table_cols(n2));
}

__device__ __forceinline__ void store_a(float* asr, float* asi, int kk, int r,
                                        float zr, float zi, float pr,
                                        float pi) {
  asr[kk * kAStride + r] = zr * pr - zi * pi;
  asi[kk * kAStride + r] = zr * pi + zi * pr;
}

template <bool SEEDED>
__device__ void stage_a(const Args& a, float* asr, float* asi, int k0,
                        int row0) {
  const int n2 = a.n2;
  if (SEEDED) {
    constexpr int kPairs = kTileK / 2;
    for (int idx = threadIdx.x; idx < kRows * kPairs; idx += kThreads) {
      const int r = idx / kPairs, kp = idx - r * kPairs;
      const int pl = r / n2, k2 = r - pl * n2;
      const int k1 = k0 + 2 * kp;
      const int c = k2 * kLane + k1;
      float zr0, zi0, zr1, zi1;
      mcop::factored_z_pair(a.key, row0 + pl, c >> 1, &zr0, &zi0, &zr1,
                            &zi1);
      store_a(asr, asi, 2 * kp, r, zr0, zi0, __ldg(a.phir + c),
              __ldg(a.phii + c));
      store_a(asr, asi, 2 * kp + 1, r, zr1, zi1, __ldg(a.phir + c + 1),
              __ldg(a.phii + c + 1));
    }
  } else {
    const size_t plane = static_cast<size_t>(a.drawn) * a.m2;
    for (int idx = threadIdx.x; idx < kRows * kTileK; idx += kThreads) {
      const int r = idx / kTileK, kk = idx - r * kTileK;
      const int pl = r / n2, k2 = r - pl * n2;
      const int c = k2 * kLane + k0 + kk;
      const size_t g = static_cast<size_t>(row0 + pl) * a.m2 + c;
      store_a(asr, asi, kk, r, __ldg(a.noise + g), __ldg(a.noise + plane + g),
              __ldg(a.phir + c), __ldg(a.phii + c));
    }
  }
}

// The bf16 form's a = Z * phi' of one cell: float32, every rounding
// explicit (the plain version's order), then rounded to bf16.
__device__ __forceinline__ void store_a_bf16(__nv_bfloat16* abr,
                                             __nv_bfloat16* abi, int r,
                                             int k1, float zr, float zi,
                                             float pr, float pi) {
  abr[r * kAStrideB + k1] =
      __float2bfloat16_rn(__fsub_rn(__fmul_rn(zr, pr), __fmul_rn(zi, pi)));
  abi[r * kAStrideB + k1] =
      __float2bfloat16_rn(__fadd_rn(__fmul_rn(zr, pi), __fmul_rn(zi, pr)));
}

// Stage the bf16 a of the block's 64 rows, all 128 k1 (seeded: one
// Philox call per two columns, as stage_a).
template <bool SEEDED>
__device__ void stage_a_bf16(const Args& a, __nv_bfloat16* abr,
                             __nv_bfloat16* abi, int row0) {
  const int n2 = a.n2;
  if (SEEDED) {
    constexpr int kPairs = kLane / 2;
    for (int idx = threadIdx.x; idx < kRows * kPairs; idx += kThreads) {
      const int r = idx / kPairs, kp = idx - r * kPairs;
      const int pl = r / n2, k2 = r - pl * n2;
      const int c = k2 * kLane + 2 * kp;
      float zr0, zi0, zr1, zi1;
      mcop::factored_z_pair(a.key, row0 + pl, c >> 1, &zr0, &zi0, &zr1,
                            &zi1);
      store_a_bf16(abr, abi, r, 2 * kp, zr0, zi0, __ldg(a.phir + c),
                   __ldg(a.phii + c));
      store_a_bf16(abr, abi, r, 2 * kp + 1, zr1, zi1, __ldg(a.phir + c + 1),
                   __ldg(a.phii + c + 1));
    }
  } else {
    const size_t plane = static_cast<size_t>(a.drawn) * a.m2;
    for (int idx = threadIdx.x; idx < kRows * kLane; idx += kThreads) {
      const int r = idx / kLane, k1 = idx - r * kLane;
      const int pl = r / n2, k2 = r - pl * n2;
      const int c = k2 * kLane + k1;
      const size_t g = static_cast<size_t>(row0 + pl) * a.m2 + c;
      store_a_bf16(abr, abi, r, k1, __ldg(a.noise + g),
                   __ldg(a.noise + plane + g), __ldg(a.phir + c),
                   __ldg(a.phii + c));
    }
  }
}

// The twiddle of one stage-1 sum pair (sr, si) at row r, column col, into
// S'.
__device__ __forceinline__ void twiddle_store(const Args& a, float* spr,
                                              float* spi, int r, int col,
                                              float sr, float si) {
  const int k2 = r % a.n2;
  const float tr = __ldg(a.twr + k2 * kLane + col);
  const float ti = __ldg(a.twi + k2 * kLane + col);
  spr[r * kLane + col] = sr * tr - si * ti;
  spi[r * kLane + col] = sr * ti + si * tr;
}

// Stage 1 and the twiddle in float32 on the CUDA cores: S' of the block's
// 64 rows r = pl * N2 + k2, S = (Z * phi') @ F1, each thread a 4-row x
// 8-column complex micro-tile; ends with S' written and the block
// synchronised.
template <bool SEEDED>
__device__ __forceinline__ void stage1_f32(const Args& a, float* spr,
                                           float* spi, float* region2,
                                           int row0) {
  float* asr = region2;                          // [kTileK][kAStride]
  float* asi = asr + kTileK * kAStride;
  float* fsr = asi + kTileK * kAStride;          // [kTileK][kLane]
  float* fsi = fsr + kTileK * kLane;
  const int tid = threadIdx.x;
  const int n2 = a.n2;
  const float* f1r = static_cast<const float*>(a.f1r);
  const float* f1i = static_cast<const float*>(a.f1i);
  const int tx = tid % kColGroups;  // columns tx*4.., 64+tx*4..
  const int ty = tid / kColGroups;  // rows ty*4..ty*4+3
  float accr[4][8], acci[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) accr[i][j] = acci[i][j] = 0.0f;

  for (int k0 = 0; k0 < kLane; k0 += kTileK) {
    __syncthreads();  // previous readers of the staged tiles are done
    stage_a<SEEDED>(a, asr, asi, k0, row0);
    for (int idx = tid; idx < kTileK * kLane / 4; idx += kThreads) {
      reinterpret_cast<float4*>(fsr)[idx] =
          __ldg(reinterpret_cast<const float4*>(f1r + k0 * kLane) + idx);
      reinterpret_cast<float4*>(fsi)[idx] =
          __ldg(reinterpret_cast<const float4*>(f1i + k0 * kLane) + idx);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTileK; ++kk) {
      const float4 ar4 =
          *reinterpret_cast<const float4*>(asr + kk * kAStride + ty * 4);
      const float4 ai4 =
          *reinterpret_cast<const float4*>(asi + kk * kAStride + ty * 4);
      const float4 br0 =
          *reinterpret_cast<const float4*>(fsr + kk * kLane + tx * 4);
      const float4 br1 =
          *reinterpret_cast<const float4*>(fsr + kk * kLane + 64 + tx * 4);
      const float4 bi0 =
          *reinterpret_cast<const float4*>(fsi + kk * kLane + tx * 4);
      const float4 bi1 =
          *reinterpret_cast<const float4*>(fsi + kk * kLane + 64 + tx * 4);
      const float ar[4] = {ar4.x, ar4.y, ar4.z, ar4.w};
      const float ai[4] = {ai4.x, ai4.y, ai4.z, ai4.w};
      const float br[8] = {br0.x, br0.y, br0.z, br0.w,
                           br1.x, br1.y, br1.z, br1.w};
      const float bi[8] = {bi0.x, bi0.y, bi0.z, bi0.w,
                           bi1.x, bi1.y, bi1.z, bi1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          accr[i][j] = fmaf(ar[i], br[j], accr[i][j]);
          accr[i][j] = fmaf(-ai[i], bi[j], accr[i][j]);
          acci[i][j] = fmaf(ar[i], bi[j], acci[i][j]);
          acci[i][j] = fmaf(ai[i], br[j], acci[i][j]);
        }
    }
  }

  // Twiddle, into S'.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const int k2 = r % n2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col0 = h * 64 + tx * 4;
      const float4 tr =
          __ldg(reinterpret_cast<const float4*>(a.twr + k2 * kLane + col0));
      const float4 ti =
          __ldg(reinterpret_cast<const float4*>(a.twi + k2 * kLane + col0));
      const float twr[4] = {tr.x, tr.y, tr.z, tr.w};
      const float twi[4] = {ti.x, ti.y, ti.z, ti.w};
      float outr[4], outi[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float sr = accr[i][h * 4 + e], si = acci[i][h * 4 + e];
        outr[e] = sr * twr[e] - si * twi[e];
        outi[e] = sr * twi[e] + si * twr[e];
      }
      *reinterpret_cast<float4*>(spr + r * kLane + col0) =
          make_float4(outr[0], outr[1], outr[2], outr[3]);
      *reinterpret_cast<float4*>(spi + r * kLane + col0) =
          make_float4(outi[0], outi[1], outi[2], outi[3]);
    }
  }
  __syncthreads();  // S' complete; the staging region is free
}

// Stage 1 and the twiddle on the tensor cores (the BF16 form): S' of the
// block's 64 rows from bf16 a and F1, float32 sums; ends with S' written
// and the block synchronised.  a is drawn whole before any sum is live, so
// the draws and the accumulators never hold registers together.
template <bool SEEDED>
__device__ void stage1_bf16(const Args& a, float* spr, float* spi,
                            float* region2, int row0) {
  auto* abr = reinterpret_cast<__nv_bfloat16*>(spr);  // [kRows][136], in S'
  __nv_bfloat16* abi = abr + kRows * kAStrideB;
  auto* fbr = reinterpret_cast<__nv_bfloat16*>(region2);  // [kLane][40]
  __nv_bfloat16* fbi = fbr + kLane * kFStrideB;
  const auto* f1r = static_cast<const __nv_bfloat16*>(a.f1r);
  const auto* f1i = static_cast<const __nv_bfloat16*>(a.f1i);
  const int tid = threadIdx.x, warp = tid / 32;
  const int r0 = 16 * (warp >> 1);          // this warp's row group
  const int cg0 = 8 * (warp & 1);           // its first 8-column group
  float accr[8][4], acci[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) accr[j][e] = acci[j][e] = 0.0f;

  stage_a_bf16<SEEDED>(a, abr, abi, row0);
  for (int k0 = 0; k0 < kLane; k0 += kTileKB) {
    __syncthreads();  // a is staged; previous readers of F1's tile are done
    for (int idx = tid; idx < kTileKB * kLane; idx += kThreads) {
      const int kk = idx / kLane, m1 = idx - kk * kLane;
      const int g = (k0 + kk) * kLane + m1;   // F1[k1, m1]
      fbr[m1 * kFStrideB + kk] = f1r[g];
      fbi[m1 * kFStrideB + kk] = f1i[g];
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kTileKB; ks += 16) {
      uint32_t ar[4], ai[4];
      mcop::load_a_frag(abr, kAStrideB, r0, k0 + ks, ar);
      mcop::load_a_frag(abi, kAStrideB, r0, k0 + ks, ai);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c0 = 8 * (cg0 + j);
        uint32_t br[2], bi[2];
        mcop::load_b_frag(fbr, kFStrideB, c0, ks, br);
        mcop::load_b_frag(fbi, kFStrideB, c0, ks, bi);
        mcop::mma_bf16_16816(acci[j], ar, bi);
        mcop::mma_bf16_16816(acci[j], ai, br);
        mcop::mma_bf16_16816(accr[j], ar, br);
        mcop::negate_bf16_frag(bi);            // -F1i: Sr = Ar F1r - Ai F1i
        mcop::mma_bf16_16816(accr[j], ai, bi);
      }
    }
  }

  __syncthreads();  // every warp has read a (in S') and F1
  // Twiddle, into S', where each accumulator fragment holds its sums.
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * (cg0 + j) + 2 * t;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      twiddle_store(a, spr, spi, r0 + g + (e >> 1) * 8, col + (e & 1),
                    accr[j][e], acci[j][e]);
  }
  __syncthreads();  // S' complete; the staging region is free
}

// The Euler log increment of one cell.  Every rounding is explicit (no
// multiply-add contraction), so a pair's partner (-x, -w) rounds exactly as
// the unpaired kernel on the negated noise does, in the plain versions'
// order.
__device__ __forceinline__ float euler_inc(const Args& a, float x, float w,
                                           int m) {
  const float sv = expf(x + __ldg(a.vd + m));
  const float v = __fmul_rn(sv, sv);
  return __fadd_rn(__fmul_rn(__fsub_rn(a.r, __fmul_rn(0.5f, v)), a.dt),
                   __fmul_rn(sv, __fmul_rn(w, a.sqrt_dt)));
}

// The price Brownian of steps m..m+3 of drawn row `row`.
template <bool SEEDED>
__device__ __forceinline__ float4 load_w(const Args& a, int row, int m) {
  if (SEEDED) return mcop::factored_w_quad(a.key, row, m >> 2);
  const size_t plane = static_cast<size_t>(a.drawn) * a.m2;
  return __ldg(reinterpret_cast<const float4*>(
      a.noise + 2 * plane + static_cast<size_t>(row) * a.m2 + m));
}

// A block of P drawn paths: P paths, or 2P pair members (ANTI: member
// q < P is drawn path q, member P + q its partner).  CV adds the control
// lane, QUAD the quadratic policy, BF16 the bf16 fGN-input form.
template <bool SEEDED, bool PRICED, bool ANTI, bool CV, bool QUAD, bool BF16>
__global__ void __launch_bounds__(kThreads, 2) factored_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* spr = reinterpret_cast<float*>(smem4);  // [kRows][kLane]   Re S'
  float* spi = spr + kRows * kLane;              // [kRows][kLane]   Im S'
  float* region2 = spi + kRows * kLane;          // stage 1's staging, then
  float* inc = region2;                          // [P][s_pad]
  const int n2 = a.n2, nj = table_cols(n2);
  float* cs = region2 + kRegion2Floats;          // [n2][nj]
  float* sn = cs + n2 * nj;
  __shared__ float red[kWarps];
  __shared__ float red_cv[kWarps];

  const int tid = threadIdx.x;
  const int P = a.paths;
  const int row0 = blockIdx.x * P;

  for (int idx = tid; idx < n2 * nj; idx += kThreads) {
    const int k2 = idx / nj, j = idx - k2 * nj;
    cs[idx] = j < n2 ? __ldg(a.c2 + k2 * n2 + j) : 0.0f;
    sn[idx] = j < n2 ? __ldg(a.s2 + k2 * n2 + j) : 0.0f;
  }

  if constexpr (BF16)
    stage1_bf16<SEEDED>(a, spr, spi, region2, row0);
  else
    stage1_f32<SEEDED>(a, spr, spi, region2, row0);

  // Pass A: stage 2, exp and the Euler increments, into inc (paired: x
  // itself, for pass A2).
  const int n = a.n, s_pad = a.s_pad;
  const int n_tiles = s_pad / kLane;
  const int groups = (n_tiles + 3) / 4;
  const int items = P * groups * (kLane / 4);
  for (int it = tid; it < items; it += kThreads) {
    const int q = it % (kLane / 4);
    const int rest = it / (kLane / 4);
    const int g = rest % groups, pl = rest / groups;
    const int j0 = 4 * g;
    float x[4][4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[jj][e] = 0.0f;
    const float* sr_row = spr + pl * n2 * kLane + 4 * q;
    const float* si_row = spi + pl * n2 * kLane + 4 * q;
    for (int k2 = 0; k2 < n2; ++k2) {
      const float4 sr4 = *reinterpret_cast<const float4*>(sr_row + k2 * kLane);
      const float4 si4 = *reinterpret_cast<const float4*>(si_row + k2 * kLane);
      const float4 c4 = *reinterpret_cast<const float4*>(cs + k2 * nj + j0);
      const float4 s4 = *reinterpret_cast<const float4*>(sn + k2 * nj + j0);
      const float sr[4] = {sr4.x, sr4.y, sr4.z, sr4.w};
      const float si[4] = {si4.x, si4.y, si4.z, si4.w};
      const float c[4] = {c4.x, c4.y, c4.z, c4.w};
      const float s[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          x[jj][e] = fmaf(si[e], s[jj], fmaf(sr[e], c[jj], x[jj][e]));
    }
    const int row = row0 + pl;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = j0 + jj;
      if (j >= n_tiles) continue;
      const int m = j * kLane + 4 * q;
      float4* dst = reinterpret_cast<float4*>(inc + pl * s_pad + m);
      if (ANTI) {
        *dst = make_float4(x[jj][0], x[jj][1], x[jj][2], x[jj][3]);
        continue;
      }
      const float4 w4 = load_w<SEEDED>(a, row, m);
      const float w[4] = {w4.x, w4.y, w4.z, w4.w};
      float v_inc[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v_inc[e] = m + e < n ? euler_inc(a, x[jj][e], w[e], m + e) : 0.0f;
      *dst = make_float4(v_inc[0], v_inc[1], v_inc[2], v_inc[3]);
    }
  }
  __syncthreads();

  // Pass A2 (paired): both members' increments from x and one W draw,
  // into the S' region (S' is dead): member q at spr, its partner at spi.
  if (ANTI) {
    for (int it = tid; it < P * (s_pad / 4); it += kThreads) {
      const int pl = it / (s_pad / 4), m = 4 * (it - pl * (s_pad / 4));
      const float4 x4 = *reinterpret_cast<const float4*>(inc + pl * s_pad + m);
      const float4 w4 = load_w<SEEDED>(a, row0 + pl, m);
      const float x[4] = {x4.x, x4.y, x4.z, x4.w};
      const float w[4] = {w4.x, w4.y, w4.z, w4.w};
      float vp[4], vm[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool in = m + e < n;
        vp[e] = in ? euler_inc(a, x[e], w[e], m + e) : 0.0f;
        vm[e] = in ? euler_inc(a, -x[e], -w[e], m + e) : 0.0f;
      }
      *reinterpret_cast<float4*>(spr + pl * s_pad + m) =
          make_float4(vp[0], vp[1], vp[2], vp[3]);
      *reinterpret_cast<float4*>(spi + pl * s_pad + m) =
          make_float4(vm[0], vm[1], vm[2], vm[3]);
    }
    __syncthreads();
  }

  // Pass B: one warp per path (pair member), the running sum 128 steps at
  // a time.
  const int warp = tid >> 5, lane = tid & 31;
  const int members = ANTI ? 2 * P : P;
  float wsum = 0.0f, wcv = 0.0f;
  for (int mp = warp; mp < members; mp += kWarps) {
    // K8's output row: drawn, or (paired) `drawn` rows below its partner.
    const size_t row = static_cast<size_t>(
        ANTI && mp >= P ? a.drawn + row0 + mp - P : row0 + mp);
    const float* path_inc =
        ANTI ? (mp < P ? spr : spi) + (mp % P) * s_pad : inc + mp * s_pad;
    float carry = a.log_s0;
    bool stopped = false;
    if (!PRICED && lane == 0) a.out[row * (n + 1)] = a.s0;
    for (int c0 = 0; c0 < s_pad; c0 += kLane) {
      const int m = c0 + 4 * lane;
      const float4 v = *reinterpret_cast<const float4*>(path_inc + m);
      const float p1 = v.x, p2 = p1 + v.y, p3 = p2 + v.z, p4 = p3 + v.w;
      float s = p4;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float y = __shfl_up_sync(kFull, s, off);
        if (lane >= off) s += y;
      }
      float excl = __shfl_up_sync(kFull, s, 1);
      if (lane == 0) excl = 0.0f;
      const float base = carry + excl;
      const float ls[4] = {base + p1, base + p2, base + p3, base + p4};
      carry += __shfl_sync(kFull, s, 31);
      if (!PRICED) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (m + e < n) a.out[row * (n + 1) + 1 + m + e] = expf(ls[e]);
      } else if (!stopped) {
        int first = 4;
        float qval = 0.0f;
        if (QUAD) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (first == 4 && m + e < n &&
                mcop::quad_exercise(a.tab, a.tstride, m + e, expf(ls[e]),
                                    a.is_call, &qval))
              first = e;
        } else {
#pragma unroll
          for (int e = 3; e >= 0; --e)
            if (m + e < n && ls[e] >= __ldg(a.llo + m + e) &&
                ls[e] <= __ldg(a.lhi + m + e))
              first = e;
        }
        const unsigned hits = __ballot_sync(kFull, first < 4);
        if (hits) {
          if (lane == __ffs(hits) - 1) {
            if (QUAD) {
              wsum += qval;
            } else {
              const float lsf = first == 0   ? ls[0]
                                : first == 1 ? ls[1]
                                : first == 2 ? ls[2]
                                             : ls[3];
              const float st = expf(lsf);
              const float pay = a.is_call ? st - a.strike : a.strike - st;
              wsum += __ldg(a.disc + m + first) * fmaxf(pay, 0.0f);
            }
          }
          // Warp-uniform: the path stopped at its first hit; under CV the
          // scan goes on to the terminal log price.
          stopped = true;
          if (!CV) break;
        }
      }
    }
    if (CV && lane == 0) wcv += expf(carry);  // carry = logS_{n-1}
  }

  if (PRICED) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      wsum += __shfl_down_sync(kFull, wsum, off);
    if (lane == 0) {
      red[warp] = wsum;
      red_cv[warp] = wcv;
    }
    __syncthreads();
    if (tid == 0) {
      float sum = 0.0f, cv = 0.0f;
      for (int w = 0; w < kWarps; ++w) sum += red[w];
      a.out[blockIdx.x] = sum;
      if (CV) {
        for (int w = 0; w < kWarps; ++w) cv += red_cv[w];
        a.out[gridDim.x + blockIdx.x] = a.cv_disc * cv;
      }
    }
  }
}

template <bool SEEDED, bool PRICED, bool ANTI, bool CV, bool QUAD>
cudaError_t launch_one(const Args& a, cudaStream_t stream) {
  const int smem = smem_bytes(a.n2);
  auto kernel = factored_kernel<SEEDED, PRICED, ANTI, CV, QUAD, kUnitBf16>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<a.drawn / a.paths, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool PRICED, bool ANTI, bool CV, bool QUAD = false>
cudaError_t launch_seeded(const Args& a, cudaStream_t stream) {
  return a.noise == nullptr
             ? launch_one<true, PRICED, ANTI, CV, QUAD>(a, stream)
             : launch_one<false, PRICED, ANTI, CV, QUAD>(a, stream);
}

template <bool PRICED>
cudaError_t launch(Args a, bool anti, bool cv, bool quad,
                   cudaStream_t stream) {
  a.m2 = next_pow2(a.n);
  a.n2 = a.m2 / kLane;
  a.s_pad = (a.n + kLane - 1) / kLane * kLane;
  if (a.n <= kLane || a.n2 > kRows || smem_bytes(a.n2) > kSmemLimit)
    return cudaErrorInvalidValue;
  a.paths = kRows / a.n2;
  a.drawn = anti ? a.rows / 2 : a.rows;
  if (a.rows < 1 || (anti && a.rows % 2) || a.drawn % a.paths ||
      (quad && (anti || !PRICED)) || a.bf16 != kUnitBf16)
    return cudaErrorInvalidValue;
  if (quad)
    return cv ? launch_seeded<true, false, true, true>(a, stream)
              : launch_seeded<true, false, false, true>(a, stream);
  if (!PRICED)
    return anti ? launch_seeded<false, true, false>(a, stream)
                : launch_seeded<false, false, false>(a, stream);
  if (anti)
    return cv ? launch_seeded<true, true, true>(a, stream)
              : launch_seeded<true, true, false>(a, stream);
  return cv ? launch_seeded<true, false, true>(a, stream)
            : launch_seeded<true, false, false>(a, stream);
}

Args make_args(const float* noise, const void* f1r, const void* f1i,
               const float* phir, const float* phii, const float* twr,
               const float* twi, const float* c2, const float* s2,
               const float* vd, int rows, int n_steps, unsigned int key,
               float r, float dt, float sqrt_dt, float log_s0, int bf16) {
  Args a{};
  a.bf16 = bf16 != 0;
  a.noise = noise;
  a.f1r = f1r;
  a.f1i = f1i;
  a.phir = phir;
  a.phii = phii;
  a.twr = twr;
  a.twi = twi;
  a.c2 = c2;
  a.s2 = s2;
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

// The per-block dynamic shared memory of K8/K9 at this horizon (the same in
// both fGN input dtypes), or -1 for a horizon they do not take.
int MCOP_ENTRY(mcop_factored_smem_bytes)(int n_steps) {
  if (n_steps <= kLane) return -1;
  const int n2 = next_pow2(n_steps) / kLane;
  if (n2 > kRows || smem_bytes(n2) > kSmemLimit) return -1;
  return smem_bytes(n2);
}

// K8.  noise: [3, rows, m2] float32 (the noise-in entry), or null for the
// seeded entry, which draws the stream of `key`.  f1r and f1i are float32,
// or bf16 with bf16 != 0 (the _bf16 unit only).  rows counts paths;
// antithetic != 0 reads (or draws) rows / 2 rows of noise, [3, rows / 2,
// m2], and out holds the drawn rows' paths, then their partners'.
int MCOP_ENTRY(mcop_factored_pathgen)(
    const float* noise, const void* f1r, const void* f1i, const float* phir,
    const float* phii, const float* twr, const float* twi, const float* c2,
    const float* s2, const float* vd, int rows, int n_steps,
    unsigned int key, float r, float dt, float sqrt_dt, float log_s0,
    float s0, int antithetic, int bf16, float* out, void* stream) {
  Args a = make_args(noise, f1r, f1i, phir, phii, twr, twi, c2, s2, vd, rows,
                     n_steps, key, r, dt, sqrt_dt, log_s0, bf16);
  a.s0 = s0;
  a.out = out;
  return static_cast<int>(launch<false>(a, antithetic != 0, false, false,
                                        static_cast<cudaStream_t>(stream)));
}

// K9.  table: rows 0-2 of the log_boundary_rows table, or with
// quadratic != 0 the eight rows of the policy_rows table (its strike in row
// 7; `strike` is then not read), row stride table_stride floats.  rows
// counts paths; antithetic != 0 (not with quadratic) reads (or draws)
// rows / 2 rows of noise, [3, rows / 2, m2].  f1r, f1i and bf16 as K8's.
// out: [rows / P] partial sums (rows / 2P paired), then as many control
// sums when with_cv != 0.
int MCOP_ENTRY(mcop_factored_priced_chunk)(
    const float* noise, const void* f1r, const void* f1i, const float* phir,
    const float* phii, const float* twr, const float* twi, const float* c2,
    const float* s2, const float* vd, int rows, int n_steps,
    unsigned int key, float r, float dt, float sqrt_dt, float log_s0,
    const float* table, long long table_stride, float strike, int is_call,
    int antithetic, int with_cv, int quadratic, int bf16, float cv_disc,
    float* out, void* stream) {
  Args a = make_args(noise, f1r, f1i, phir, phii, twr, twi, c2, s2, vd, rows,
                     n_steps, key, r, dt, sqrt_dt, log_s0, bf16);
  a.llo = table;
  a.lhi = table + table_stride;
  a.disc = table + 2 * table_stride;
  a.tab = table;
  a.tstride = table_stride;
  a.strike = strike;
  a.is_call = is_call;
  a.cv_disc = cv_disc;
  a.out = out;
  return static_cast<int>(launch<true>(a, antithetic != 0, with_cv != 0,
                                       quadratic != 0,
                                       static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
