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
// Work and bound on the H100.  The function is a length-m2 DFT a path, so
// the synthesis is computed as one: per path, N2 128-point FFTs (stage 1,
// 5 * 128 * 7 float32 operations each), the twiddle, and 128 N2-point FFTs
// (stage 2), 5 m2 log2 m2 operations in all (246k at 4000 steps, against
// 4.7M for the TPU's dense four-step product, whose MXU wanted the
// [*, 128] x [128, 128] shape).  The rest is ~8 per step.  So the least
// time is set by K8's prices (2.1 GB, 0.63 ms at 4000 steps) and, for K9,
// by the FFT's operations (0.59 ms; chip_smoke.py's factored_bound_ms).
// What the kernel spends beyond them goes to its normals: 2 m2 fGN normals
// and s_pad price normals a path (12,288 at 4000 steps, 1.6G a launch of
// 131,072 rows), each a Philox draw and a precise Box-Muller.  The bf16
// form keeps stage 1 as a dense product on the tensor cores (its function
// rounds a and F1 to bf16, which an FFT has no place for): 8 N2 128^2
// operations a path, 0.3 ms at 4000 steps at 989 TFLOP/s.  Measured on an
// H100 80GB HBM3 at 700 W (K9, 4000 steps, 131,072 rows; chip_smoke.py
// --k9-forms, and clock stamps per block in a scratch copy): 8.5 ms, of
// which a copy with constant normals keeps 4.8; the launch is bound by the
// issue of the precise Box-Muller draws the seeded stream fixes, so the
// draws' loops unroll by two for independent chains a thread.
//
// Design:
// * Blocks.  A block of 256 threads owns the 64 stage-1 rows (path, k2) of
//   P = 64 / N2 paths (2 at 4000 steps, 4 at 1825, 1 at 8192).
//   Shared memory holds two planes, Re and Im, of 64 rows of kRS = 144
//   floats; row r starts at row_off(r) = 144 r + 8 ((r >> 1) & 1).  A row
//   holds first a = Z * phi' (k1 in storage order, so no transpose), then
//   the twiddled stage-1 output S'[k2, m1] in place, then (Re plane) the
//   fGN increments x of steps m1 + 128 j in row j of the path, then their
//   Euler increments in place (the pair form: the partner's in the Im
//   plane), then under K8 the prices, each phase in place.  Beside the
//   planes: the root tables (W_128^e from F1's row 1, W_N2^e from the
//   stage-2 table's row 1; every angle reduced exactly on the host, no
//   sinf/cosf here) and one staging region: F1's bf16 k-tiles under the
//   bf16 form, then the decision's table rows.  95,808 bytes a block (K8),
//   99,904 (the boundary forms), 108,096 (QUAD), at every horizon: two
//   blocks an SM.  N2 may grow to 64 (m2 8192): stage 2 then holds 32 complex
//   values a thread.
// * Bank arithmetic (32 banks of 4 bytes; row_off(r) mod 32 = 16 (r & 1) +
//   8 ((r >> 1) & 1), so the four rows of a group of four sit 0, 16, 8, 24
//   banks apart):
//   - stage 1: a warp runs rows 4w'..4w'+3, eight lanes a row; lane t reads
//     k1 = t + 8u, eight consecutive banks a row, the four rows' windows
//     disjoint.  The exchange runs in two halves, v < 8 and v >= 8: it
//     writes Y_t[v] at 9 (v mod 8) + t (the same disjoint windows) and lane
//     t reads back 9 t + s, s = 0..7: {9 t mod 32} + {0, 16, 8, 24} covers
//     the 32 banks once.  The output columns t + 16 w and t + 8 + 16 w are
//     again eight consecutive banks a row.
//   - stage 2: lanes 2c + e of a warp read column c (16 consecutive) of
//     rows 2q + e; row_off(2q + 1) - row_off(2q) = 16 mod 32, so the two
//     parities fill disjoint halves of the banks: conflict-free.  The
//     stores pair row j (e = 0) with row N2/2 + j + 1 (e = 1), again 16
//     apart for N2 >= 8.
// * Stage 1 (float32): eight lanes a row, sixteen points a lane (k1 = t +
//   8u): a radix-16 DFT over u in registers (radix-2 decimation in
//   frequency, the bit-reversed output order taken in the indices), the
//   inner twiddle W_128^(t v), the exchange through the row's own shared
//   memory (two halves of v), a radix-8 DFT over t for v = t and
//   v = t + 8, and the twiddle tw[k2, m1] fused into the store of
//   S'[k2, t + 16 w] (m1 = v + 16 w).
//   The seeded entry draws a's pairs straight into the rows (one Philox
//   call per two columns, the counters of csrc/philox.cuh); the noise-in
//   entry reads them as float4.
// * Stage 1 (bf16, BF16): a = Z * phi' in float32 with every rounding
//   explicit (the plain version's order), rounded to nearest even into
//   bf16 rows [64][136] in the Re plane; F1's bf16 k-tiles of 32, staged
//   column by column ([128][40], entry (k, m1) at m1 * 40 + k) with 16-byte
//   cp.async from F1's contiguous rows (F1 is symmetric, so column m1 of a
//   k-tile is row m1's run of 32); m16n8k16 products with float32 sums,
//   warp w owning row group w / 2 and the eight 8-column groups of half
//   w % 2, k ascending in steps of 16 (each sum the same instructions on
//   the same fragments, whatever warp holds it).  Sr = Ar F1r + Ai (-F1i),
//   Si = Ar F1i + Ai F1r (the negation exact, on the B fragment).
// * Stage 2: lane pair (2c, 2c + 1) takes column m1 = c of a path; lane e
//   runs the N2/2-point FFT of rows k2 = 2q + e in registers (decimation in
//   frequency, roots W_N2^(2k)), lane 1 turns its output j into the real
//   part of W_N2^j O[j], one shuffle swaps them, and x_j = Re E[j] + T[j],
//   x_(j + N2/2) = Re E[j] - T[j] (only the real part of the last
//   butterfly is formed).  x goes to row j of the path's Re plane.
// * Pass A: four consecutive steps a thread: sv = exp(x + vd), the price
//   Brownian W (one Philox call per four steps when seeded, counter
//   (p, q, 2, 0)), the Euler increment with every rounding
//   explicit, in place; the pair form writes (-x, -W)'s into the Im plane.
// * Pass B, on every warp: each member (path, or pair member) is split into
//   kWarps / P segments of whole 128-step tiles (one where P >= 8), the
//   warps taking the (member, segment) units in turn; the segments depend
//   on P only, so a pair member is scanned exactly as the unpaired kernel
//   scans its path.  The warps first sum their segments, the block
//   exchanges the sums, and each warp scans its segment from the sum of
//   the earlier ones (in segment order): logS_m = log s0 + the
//   running sum of the increments (pathgen_cuda.log_paths_from_x's
//   association, as K2, K5 and K3/K4), four steps a lane and a warp scan a
//   tile.  K9 finds its segment's first hit with a ballot (the boundary
//   forms in log space, exp only at the hit; QUAD by quad_policy.cuh's
//   arithmetic, IEEE division), and the block takes, per member, the hit
//   of the earliest segment that has one; under CV the last segment scans
//   to the end for the terminal log price.  The rows the decision reads
//   (llo, lhi, disc, or the eight policy rows) are staged with cp.async,
//   each lane its own four steps: two tiles ahead for the boundary forms
//   (two slots), one tile ahead under QUAD (one slot, issued once the
//   lane has read the tile's rows), so the copies overlap the scan.  K8
//   turns each tile into prices in place and writes them with
//   neighbouring lanes on neighbouring steps.  One partial sum per block,
//   summed in a fixed order: no atomics.
// * Registers: __launch_bounds__(256, 2), 126-128 a thread, no spills; the
//   seeded bodies' 32-byte stack frame is Box-Muller's precise sinf/cosf
//   reduction buffer, as in every seeded kernel of the port.  Every
//   register array is indexed by template constants (dif_stages), so none
//   lives in local memory.
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
constexpr int kLane = 128;       // N1: stage-1 DFT length = one step tile
constexpr int kRows = 64;        // stage-1 rows (path, k2) per block
constexpr int kMaxN2 = kRows;    // at least one path a block
constexpr int kRS = kLane + 16;  // row stride of the planes, floats
constexpr int kPlaneFloats = kRows * kRS + 8;
constexpr int kRootFloats = 2 * kLane + 2 * kMaxN2;
constexpr int kSmemLimit = 232448;
// The bf16 form's staging: a (real, imaginary) [kRows][kAStrideB] in the
// Re plane, F1's k-tiles (real, imaginary) [kLane][kFStrideB] in the
// staging region.  Both strides are 4 (mod 8) words: conflict-free
// fragment reads.
constexpr int kTileKB = 32;
constexpr int kAStrideB = kLane + 8;
constexpr int kFStrideB = kTileKB + 8;
constexpr int kF1Floats = kLane * kFStrideB;  // two bf16 planes
static_assert(kRows * kAStrideB <= kPlaneFloats,
              "the bf16 a must fit the Re plane");
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

// Table rows the decision stages a lane: llo, lhi, disc, or QUAD's eight.
__host__ __device__ constexpr int staged_rows(bool priced, bool quad) {
  return !priced ? 0 : quad ? 8 : 3;
}

// Tiles of rows a lane has staged at once: two for the boundary forms (the
// copy runs two tiles ahead), one for QUAD, whose eight rows would
// otherwise cost the second block an SM.
__host__ __device__ constexpr int staged_tiles(bool quad) {
  return quad ? 1 : 2;
}

// The staging region: F1's bf16 k-tiles (stage 1), then the staged rows of
// four steps a thread (pass B).
constexpr int stage_floats(bool priced, bool quad) {
  return kThreads * 4 * staged_rows(priced, quad) * staged_tiles(quad) >
                 kF1Floats
             ? kThreads * 4 * staged_rows(priced, quad) * staged_tiles(quad)
             : kF1Floats;
}

int smem_bytes(bool priced, bool quad) {
  return 4 * (2 * kPlaneFloats + kRootFloats + stage_floats(priced, quad));
}

// Whether K8/K9 take this horizon: it spans two step tiles and a block
// holds one path (N2 <= 64).
int horizon_n2(int n_steps) {
  if (n_steps <= kLane) return -1;
  const int n2 = next_pow2(n_steps) / kLane;
  return n2 > kMaxN2 ? -1 : n2;
}

// First float of stage-1 row r in a plane (the bank note above).
__host__ __device__ constexpr int row_off(int r) {
  return r * kRS + ((r & 2) << 2);
}

// Where lane t writes Y_t[v] in the stage-1 exchange (each half of v in
// turn).
__host__ __device__ constexpr int xpos(int v) { return 9 * (v & 7); }

// k's bits reversed over log2(n) bits.
__host__ __device__ constexpr int brev(int k, int n) {
  int r = 0;
  for (int b = 1; b < n; b <<= 1) {
    r = (r << 1) | (k & 1);
    k >>= 1;
  }
  return r;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most one committed group is still in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// One radix-2 decimation-in-frequency stage of span H of an N-point DFT in
// registers, then the stages of span H / 2 .. 1 (the spans are template
// constants, so every loop unrolls and every index is static: no local
// memory).  W_N^e = (wr[e S], wi[e S]) from a root table of N S entries;
// the exact roots 1 (e = 0) and -i (e = N / 4) skip it.
template <int N, int H, int S>
__device__ __forceinline__ void dif_stages(float (&re)[N], float (&im)[N],
                                           const float* wr, const float* wi) {
  if constexpr (H >= 1) {
#pragma unroll
    for (int b = 0; b < N; b += 2 * H) {
#pragma unroll
      for (int j = 0; j < H; ++j) {
        const int i0 = b + j, i1 = b + j + H;
        const float dr = re[i0] - re[i1], di = im[i0] - im[i1];
        re[i0] += re[i1];
        im[i0] += im[i1];
        const int e = j * (N / (2 * H));
        if (e == 0) {
          re[i1] = dr;
          im[i1] = di;
        } else if (4 * e == N) {
          re[i1] = di;
          im[i1] = -dr;
        } else {
          const float c = wr[e * S], s = wi[e * S];
          re[i1] = dr * c - di * s;
          im[i1] = dr * s + di * c;
        }
      }
    }
    dif_stages<N, H / 2, S>(re, im, wr, wi);
  }
}

// In-place DFT of N points in registers, X[k] = sum_n x[n] W_N^(n k),
// radix-2 decimation in frequency: natural order in, X[k] in element
// brev(k, N) out.
template <int N, int S>
__device__ __forceinline__ void fft_dif(float (&re)[N], float (&im)[N],
                                        const float* wr, const float* wi) {
  dif_stages<N, N / 2, S>(re, im, wr, wi);
}

// S' = S tw[k2, m1] of row k2 at column m1, into the row (pr, pi).
__device__ __forceinline__ void store_twiddled(float* pr, float* pi,
                                               const float* twr,
                                               const float* twi, int m1,
                                               float sr, float si) {
  const float tr = __ldg(twr + m1), ti = __ldg(twi + m1);
  pr[m1] = sr * tr - si * ti;
  pi[m1] = sr * ti + si * tr;
}

// a = Z * phi' of the block's 64 rows into the planes (seeded: one Philox
// call per two columns; noise-in: float4 reads).  Each thread's cells are
// independent: the loops unroll so that several Philox and Box-Muller
// chains are in flight a thread.
template <bool SEEDED>
__device__ void stage_a(const Args& a, float* spr, float* spi, int row0) {
  const int n2 = a.n2, lg2 = __ffs(n2) - 1;   // N2 is a power of two
  if (SEEDED) {
    constexpr int kPairs = kLane / 2;
    static_assert(kRows * kPairs % kThreads == 0, "whole passes");
#pragma unroll 2
    for (int i = 0; i < kRows * kPairs / kThreads; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int r = idx / kPairs, kp = idx - r * kPairs;
      const int pl = r >> lg2, k2 = r & (n2 - 1);
      const int c = k2 * kLane + 2 * kp;
      float zr0, zi0, zr1, zi1;
      mcop::factored_z_pair(a.key, row0 + pl, c >> 1, &zr0, &zi0, &zr1,
                            &zi1);
      const float2 pr = __ldg(reinterpret_cast<const float2*>(a.phir + c));
      const float2 pi = __ldg(reinterpret_cast<const float2*>(a.phii + c));
      const int o = row_off(r) + 2 * kp;
      *reinterpret_cast<float2*>(spr + o) =
          make_float2(zr0 * pr.x - zi0 * pi.x, zr1 * pr.y - zi1 * pi.y);
      *reinterpret_cast<float2*>(spi + o) =
          make_float2(zr0 * pi.x + zi0 * pr.x, zr1 * pi.y + zi1 * pr.y);
    }
  } else {
    constexpr int kQuads = kLane / 4;
    static_assert(kRows * kQuads % kThreads == 0, "whole passes");
    const size_t plane = static_cast<size_t>(a.drawn) * a.m2;
#pragma unroll 4
    for (int i = 0; i < kRows * kQuads / kThreads; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int r = idx / kQuads, kq = idx - r * kQuads;
      const int pl = r >> lg2, k2 = r & (n2 - 1);
      const int c = k2 * kLane + 4 * kq;
      const size_t g = static_cast<size_t>(row0 + pl) * a.m2 + c;
      const float4 zr = __ldg(reinterpret_cast<const float4*>(a.noise + g));
      const float4 zi =
          __ldg(reinterpret_cast<const float4*>(a.noise + plane + g));
      const float4 pr = __ldg(reinterpret_cast<const float4*>(a.phir + c));
      const float4 pi = __ldg(reinterpret_cast<const float4*>(a.phii + c));
      const int o = row_off(r) + 4 * kq;
      *reinterpret_cast<float4*>(spr + o) = make_float4(
          zr.x * pr.x - zi.x * pi.x, zr.y * pr.y - zi.y * pi.y,
          zr.z * pr.z - zi.z * pi.z, zr.w * pr.w - zi.w * pi.w);
      *reinterpret_cast<float4*>(spi + o) = make_float4(
          zr.x * pi.x + zi.x * pr.x, zr.y * pi.y + zi.y * pr.y,
          zr.z * pi.z + zi.z * pr.z, zr.w * pi.w + zi.w * pr.w);
    }
  }
}

// The stage-1 exchange of the row at (pr, pi), half H: lane t writes
// Y_t[v] for v = 8H .. 8H + 7 at xpos(v) + t, and reads Y_s[8H + t] for
// s = 0..7 back; the barriers order it after the row's earlier reads.
template <int H>
__device__ __forceinline__ void exchange_half(float* pr, float* pi, int t,
                                              const float (&xr)[16],
                                              const float (&xi)[16],
                                              float (&yr)[8], float (&yi)[8]) {
  __syncwarp();
#pragma unroll
  for (int v = 8 * H; v < 8 * H + 8; ++v) {
    pr[xpos(v) + t] = xr[brev(v, 16)];
    pi[xpos(v) + t] = xi[brev(v, 16)];
  }
  __syncwarp();
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    yr[s] = pr[xpos(t) + s];
    yi[s] = pi[xpos(t) + s];
  }
}

// Stage 1 and the twiddle as 128-point FFTs (the float32 form), each row
// of a in place to its S'; eight lanes a row, one warp four rows.
__device__ void stage1_fft(const Args& a, float* spr, float* spi,
                           const float* rtr, const float* rti) {
  const int t = threadIdx.x & 7;
  for (int r = threadIdx.x >> 3; r < kRows; r += kThreads / 8) {
    float* pr = spr + row_off(r);
    float* pi = spi + row_off(r);
    float xr[16], xi[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      xr[u] = pr[t + 8 * u];
      xi[u] = pi[t + 8 * u];
    }
    fft_dif<16, 8>(xr, xi, rtr, rti);   // Y_t[v] = sum_u a[t + 8u] W_16^(uv)
#pragma unroll
    for (int v = 1; v < 16; ++v) {      // W_128^(t v)
      const int e = (t * v) & (kLane - 1);
      const float c = rtr[e], s = rti[e];
      const float yr = xr[brev(v, 16)], yi = xi[brev(v, 16)];
      xr[brev(v, 16)] = yr * c - yi * s;
      xi[brev(v, 16)] = yr * s + yi * c;
    }
    float ur[8], ui[8], vr[8], vi[8];    // Y_s[t] and Y_s[t + 8], s = 0..7
    exchange_half<0>(pr, pi, t, xr, xi, ur, ui);
    exchange_half<1>(pr, pi, t, xr, xi, vr, vi);
    fft_dif<8, 16>(ur, ui, rtr, rti);   // S[v + 16 w] = sum_s Y_s[v] W_8^(sw)
    fft_dif<8, 16>(vr, vi, rtr, rti);
    __syncwarp();                       // the exchange is read
    const int k2 = r & (a.n2 - 1);
    const float* twr = a.twr + k2 * kLane;
    const float* twi = a.twi + k2 * kLane;
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      store_twiddled(pr, pi, twr, twi, t + 16 * w, ur[brev(w, 8)],
                     ui[brev(w, 8)]);
      store_twiddled(pr, pi, twr, twi, t + 8 + 16 * w, vr[brev(w, 8)],
                     vi[brev(w, 8)]);
    }
  }
}

// The bf16 form's a = Z * phi' of one cell: float32, every rounding
// explicit (the plain version's order), then rounded to bf16.
__device__ __forceinline__ __nv_bfloat16 a_bf16_re(float zr, float zi,
                                                   float pr, float pi) {
  return __float2bfloat16_rn(__fsub_rn(__fmul_rn(zr, pr), __fmul_rn(zi, pi)));
}

__device__ __forceinline__ __nv_bfloat16 a_bf16_im(float zr, float zi,
                                                   float pr, float pi) {
  return __float2bfloat16_rn(__fadd_rn(__fmul_rn(zr, pi), __fmul_rn(zi, pr)));
}

// Two neighbouring cells (k1, k1 + 1) of row r, k1 even, stored as one
// word of each plane.
__device__ __forceinline__ void store_a_bf16_pair(
    __nv_bfloat16* abr, __nv_bfloat16* abi, int r, int k1, float zr0,
    float zi0, float zr1, float zi1, float2 pr, float2 pi) {
  __nv_bfloat162 re, im;
  re.x = a_bf16_re(zr0, zi0, pr.x, pi.x);
  re.y = a_bf16_re(zr1, zi1, pr.y, pi.y);
  im.x = a_bf16_im(zr0, zi0, pr.x, pi.x);
  im.y = a_bf16_im(zr1, zi1, pr.y, pi.y);
  *reinterpret_cast<__nv_bfloat162*>(abr + r * kAStrideB + k1) = re;
  *reinterpret_cast<__nv_bfloat162*>(abi + r * kAStrideB + k1) = im;
}

// Stage the bf16 a of the block's 64 rows, all 128 k1 (seeded: one
// Philox call per two columns, as stage_a; unrolled as stage_a).
template <bool SEEDED>
__device__ void stage_a_bf16(const Args& a, __nv_bfloat16* abr,
                             __nv_bfloat16* abi, int row0) {
  const int n2 = a.n2, lg2 = __ffs(n2) - 1;
  constexpr int kPairs = kLane / 2;
  static_assert(kRows * kPairs % kThreads == 0, "whole passes");
  const size_t plane = static_cast<size_t>(a.drawn) * a.m2;
#pragma unroll 2
  for (int i = 0; i < kRows * kPairs / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / kPairs, kp = idx - r * kPairs;
    const int pl = r >> lg2, k2 = r & (n2 - 1);
    const int c = k2 * kLane + 2 * kp;
    float zr0, zi0, zr1, zi1;
    if (SEEDED) {
      mcop::factored_z_pair(a.key, row0 + pl, c >> 1, &zr0, &zi0, &zr1,
                            &zi1);
    } else {
      const size_t g = static_cast<size_t>(row0 + pl) * a.m2 + c;
      const float2 zr = __ldg(reinterpret_cast<const float2*>(a.noise + g));
      const float2 zi =
          __ldg(reinterpret_cast<const float2*>(a.noise + plane + g));
      zr0 = zr.x, zr1 = zr.y, zi0 = zi.x, zi1 = zi.y;
    }
    store_a_bf16_pair(abr, abi, r, 2 * kp, zr0, zi0, zr1, zi1,
                      __ldg(reinterpret_cast<const float2*>(a.phir + c)),
                      __ldg(reinterpret_cast<const float2*>(a.phii + c)));
  }
}

// Stage 1 and the twiddle on the tensor cores (the BF16 form): S' of the
// block's 64 rows from bf16 a and F1, float32 sums, in the planes; ends
// with the block synchronised.  a is drawn whole before any sum is live,
// so the draws and the accumulators never hold registers together.
template <bool SEEDED>
__device__ void stage1_bf16(const Args& a, float* spr, float* spi,
                            float* stage, int row0) {
  auto* abr = reinterpret_cast<__nv_bfloat16*>(spr);  // [kRows][136]
  __nv_bfloat16* abi = abr + kRows * kAStrideB;
  auto* fbr = reinterpret_cast<__nv_bfloat16*>(stage);  // [kLane][40]
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
    // Column m1 of the k-tile, F1[k0 .. k0 + 31, m1], is row m1's run
    // F1[m1, k0 .. k0 + 31] (F1 is symmetric): four 16-byte copies.
    for (int idx = tid; idx < 2 * kLane * (kTileKB / 8); idx += kThreads) {
      const int q = idx & 3, m1 = (idx >> 2) & (kLane - 1), pl = idx >> 9;
      const int g = m1 * kLane + k0 + 8 * q;
      cp_async16((pl ? fbi : fbr) + m1 * kFStrideB + 8 * q,
                 (pl ? f1i : f1r) + g);
    }
    cp_async_wait();
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

  __syncthreads();  // every warp has read a (in the Re plane) and F1
  // Twiddle, into S', where each accumulator fragment holds its sums: rows
  // g and g + 8, columns 2t and 2t + 1 of each 8-column group, a float2 of
  // the twiddle and of each S' plane at a time.
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + g + 8 * h;
    const int k2 = r & (a.n2 - 1);
    float* pr = spr + row_off(r);
    float* pi = spi + row_off(r);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * (cg0 + j) + 2 * t;
      const float2 tr =
          __ldg(reinterpret_cast<const float2*>(a.twr + k2 * kLane + col));
      const float2 ti =
          __ldg(reinterpret_cast<const float2*>(a.twi + k2 * kLane + col));
      const float sr0 = accr[j][2 * h], si0 = acci[j][2 * h];
      const float sr1 = accr[j][2 * h + 1], si1 = acci[j][2 * h + 1];
      *reinterpret_cast<float2*>(pr + col) =
          make_float2(sr0 * tr.x - si0 * ti.x, sr1 * tr.y - si1 * ti.y);
      *reinterpret_cast<float2*>(pi + col) =
          make_float2(sr0 * ti.x + si0 * tr.x, sr1 * ti.y + si1 * tr.y);
    }
  }
}

// Stage 2 for N2 = 2 NH: lane pair (2c, 2c + 1) of each column c of each
// path; x of step m1 + 128 j into row j of the path's Re plane.
template <int NH>
__device__ void stage2(float* spr, const float* spi, const float* w2r,
                       const float* w2i) {
  constexpr int kN2 = 2 * NH;
  for (int it = threadIdx.x; it < kRows / kN2 * 2 * kLane; it += kThreads) {
    const int e = it & 1, c = (it >> 1) & (kLane - 1);
    const int r0 = (it >> 8) * kN2;
    float xr[NH], xi[NH];
#pragma unroll
    for (int q = 0; q < NH; ++q) {
      const int o = row_off(r0 + 2 * q + e) + c;
      xr[q] = spr[o];
      xi[q] = spi[o];
    }
    fft_dif<NH, 2>(xr, xi, w2r, w2i);   // E (e = 0) or O (e = 1), W_N2^(2k)
    __syncwarp();                       // the pair's column is read
    // x_j (lane 0) or x_(j + NH) (lane 1) of output j of the pair, j in
    // pairs so that lane 1 stores row NH + j + 1 beside lane 0's row j.
    constexpr int kStep = NH >= 2 ? 2 : 1;
#pragma unroll
    for (int j = 0; j < NH; j += kStep) {
      float o[kStep];
#pragma unroll
      for (int h = 0; h < kStep; ++h) {
        const int k = brev(j + h, NH);
        const float tj = xr[k] * w2r[j + h] - xi[k] * w2i[j + h];  // Re W^j O
        const float mine = e ? tj : xr[k];
        const float other = __shfl_xor_sync(kFull, mine, 1);
        o[h] = e ? other - mine : mine + other;
      }
      if constexpr (NH == 1) {
        spr[row_off(r0 + e) + c] = o[0];
      } else {
        const int ra = e ? r0 + NH + j + 1 : r0 + j;
        const int rb = e ? r0 + NH + j : r0 + j + 1;
        spr[row_off(ra) + c] = e ? o[1] : o[0];
        spr[row_off(rb) + c] = e ? o[0] : o[1];
      }
    }
  }
}

// The Euler log increment of one cell.  Every rounding is explicit (no
// multiply-add contraction), so a pair's partner (-x, -w) rounds exactly as
// the unpaired kernel on the negated noise does, in the plain versions'
// order.
__device__ __forceinline__ float euler_inc(const Args& a, float x, float w,
                                           float vdm) {
  const float sv = expf(x + vdm);
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

// Offset of step m of the block's path pl in a plane.
__device__ __forceinline__ int step_off(int n2, int pl, int m) {
  return row_off(pl * n2 + (m >> 7)) + (m & (kLane - 1));
}

// Copy the decision's rows at this lane's steps m..m+3 into its slot
// ([R][kLane] a warp, the lane's four floats at 4 lane) with cp.async, as
// one committed group; a wait makes them visible to the lane.  Steps past
// n are left.
template <bool QUAD>
__device__ __forceinline__ void stage_lane_rows(const Args& a, float* slot,
                                                int m) {
  constexpr int R = staged_rows(true, QUAD);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float* row = (QUAD     ? a.tab + r * a.tstride
                        : r == 0 ? a.llo
                        : r == 1 ? a.lhi
                                 : a.disc) + m;
    if (m + 4 <= a.n && (reinterpret_cast<uintptr_t>(row) & 15) == 0) {
      cp_async16(slot + r * kLane, row);   // the common case: one copy
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (m + e < a.n) cp_async4(slot + r * kLane + e, row + e);
    }
  }
  cp_async_commit();
}

// A block of P drawn paths: P paths, or 2P pair members (ANTI: member
// q < P is drawn path q, member P + q its partner).  CV adds the control
// lane, QUAD the quadratic policy, BF16 the bf16 fGN-input form.
template <bool SEEDED, bool PRICED, bool ANTI, bool CV, bool QUAD, bool BF16>
__global__ void __launch_bounds__(kThreads, 2) factored_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* spr = reinterpret_cast<float*>(smem4);  // Re plane
  float* spi = spr + kPlaneFloats;               // Im plane
  float* rtr = spi + kPlaneFloats;               // [128] W_128^e
  float* rti = rtr + kLane;
  float* w2r = rti + kLane;                      // [N2] W_N2^e
  float* w2i = w2r + kMaxN2;
  float* stage = w2i + kMaxN2;                   // F1 tiles, then the rows
  // Per (member, segment) unit: the segment's sum, whether it hit, the
  // value, the control (at most 2P members of kWarps / P segments, or 2P
  // whole members: 2 kRows units).
  __shared__ float seg_sum[2 * kRows];
  __shared__ float unit_val[2 * kRows], unit_cv[2 * kRows];
  __shared__ int unit_hit[2 * kRows];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n2 = a.n2, P = a.paths;
  const int row0 = blockIdx.x * P;

  if (!BF16) {
    const float* f1r = static_cast<const float*>(a.f1r);
    const float* f1i = static_cast<const float*>(a.f1i);
    for (int i = tid; i < kLane; i += kThreads) {
      rtr[i] = __ldg(f1r + kLane + i);   // F1[1, e] = W_128^e
      rti[i] = __ldg(f1i + kLane + i);
    }
  }
  for (int i = tid; i < n2; i += kThreads) {
    w2r[i] = __ldg(a.c2 + n2 + i);       // W_N2^e = cos2[1, e] - i sin2[1, e]
    w2i[i] = -__ldg(a.s2 + n2 + i);
  }

  if constexpr (BF16) {
    stage1_bf16<SEEDED>(a, spr, spi, stage, row0);
  } else {
    stage_a<SEEDED>(a, spr, spi, row0);
    __syncthreads();
    stage1_fft(a, spr, spi, rtr, rti);
  }
  __syncthreads();  // S' complete

  switch (n2) {
    case 2: stage2<1>(spr, spi, w2r, w2i); break;
    case 4: stage2<2>(spr, spi, w2r, w2i); break;
    case 8: stage2<4>(spr, spi, w2r, w2i); break;
    case 16: stage2<8>(spr, spi, w2r, w2i); break;
    case 32: stage2<16>(spr, spi, w2r, w2i); break;
    default: stage2<32>(spr, spi, w2r, w2i); break;
  }
  __syncthreads();  // x complete; the Im plane is free

  // Pass A: the Euler increments in place (the partner's in the Im plane).
  const int n = a.n, s_pad = a.s_pad;
  const int quads = s_pad / 4;
  for (int pl = 0; pl < P; ++pl) {
#pragma unroll 2
    for (int q = tid; q < quads; q += kThreads) {
      const int m = 4 * q;
      const int o = step_off(n2, pl, m);
      const float4 x4 = *reinterpret_cast<const float4*>(spr + o);
      const float4 w4 = load_w<SEEDED>(a, row0 + pl, m);
      const float x[4] = {x4.x, x4.y, x4.z, x4.w};
      const float w[4] = {w4.x, w4.y, w4.z, w4.w};
      float vd[4];
      if (m + 4 <= n && (reinterpret_cast<uintptr_t>(a.vd) & 15) == 0) {
        const float4 v4 = __ldg(reinterpret_cast<const float4*>(a.vd + m));
        vd[0] = v4.x, vd[1] = v4.y, vd[2] = v4.z, vd[3] = v4.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          vd[e] = m + e < n ? __ldg(a.vd + m + e) : 0.0f;
      }
      float vp[4], vm[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool in = m + e < n;
        vp[e] = in ? euler_inc(a, x[e], w[e], vd[e]) : 0.0f;
        if (ANTI) vm[e] = in ? euler_inc(a, -x[e], -w[e], vd[e]) : 0.0f;
      }
      *reinterpret_cast<float4*>(spr + o) = make_float4(vp[0], vp[1], vp[2],
                                                        vp[3]);
      if (ANTI)
        *reinterpret_cast<float4*>(spi + o) =
            make_float4(vm[0], vm[1], vm[2], vm[3]);
    }
  }
  __syncthreads();

  // Pass B: units (member, segment), warp w taking units w, w + kWarps, ...
  // A member's segments are whole tiles, kWarps / P of them (one where
  // P >= kWarps): they depend on the drawn paths only, so a pair member is
  // scanned in the unpaired kernel's association.
  const int members = ANTI ? 2 * P : P;
  const int wpm = P >= kWarps ? 1 : kWarps / P;
  const int units = members * wpm;
  const int n_tiles = s_pad / kLane;
  const int tps = (n_tiles + wpm - 1) / wpm;
  // The lane's slots: kBufs tiles of its four steps of the staged rows,
  // tile t in slot (t - t0) % kBufs.
  constexpr int kBufs = staged_tiles(QUAD);
  constexpr int kSlot = staged_rows(PRICED, QUAD) * kLane;
  float* slots = stage + warp * kBufs * kSlot + 4 * lane;
  auto unit_plane = [&](int u, int* pl) {
    const int mp = u / wpm;
    const bool partner = ANTI && mp >= P;
    *pl = partner ? mp - P : mp;
    return partner ? spi : spr;
  };
  // Unit u's first kBufs tiles of rows, into its slots.
  auto stage_first = [&](int u) {
    const int t0 = min(u % wpm * tps, n_tiles), t1 = min(t0 + tps, n_tiles);
    __syncwarp();   // the lane's reads of its slots precede the copies
    for (int t = t0; t < t0 + kBufs && t < t1; ++t)
      stage_lane_rows<QUAD>(a, slots + (t - t0) * kSlot, t * kLane + 4 * lane);
  };
  if (PRICED && warp < units) stage_first(warp);
  if (wpm > 1) {
    // Segment sums, exchanged: each segment starts from the earlier ones'.
    for (int u = warp; u < units; u += kWarps) {
      int pl;
      const float* plane = unit_plane(u, &pl);
      const int seg = u % wpm;
      const int t0 = min(seg * tps, n_tiles), t1 = min(t0 + tps, n_tiles);
      float s = 0.0f;
      for (int t = t0; t < t1; ++t) {
        const float4 v = *reinterpret_cast<const float4*>(
            plane + step_off(n2, pl, t * kLane + 4 * lane));
        s += (v.x + v.y) + (v.z + v.w);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(kFull, s, off);
      if (lane == 0) seg_sum[u] = s;
    }
    __syncthreads();
  }
  for (int u = warp; u < units; u += kWarps) {
    int pl;
    float* plane = unit_plane(u, &pl);
    const int mp = u / wpm, seg = u % wpm;
    const int t0 = min(seg * tps, n_tiles), t1 = min(t0 + tps, n_tiles);
    // K8's output row: drawn, or (paired) `drawn` rows below its partner.
    const size_t row = static_cast<size_t>(
        ANTI && mp >= P ? a.drawn + row0 + pl : row0 + pl);
    if (PRICED && u != warp) stage_first(u);   // the first was issued above
    float carry = 0.0f;  // running sum of the increments before the tile
    for (int q = u - seg; q < u; ++q) carry += seg_sum[q];
    if (!PRICED && seg == 0 && lane == 0) a.out[row * (n + 1)] = a.s0;
    bool stopped = false;
    float val = 0.0f;   // the hit's value, on lane hit_lane
    int hit_lane = 0;
    for (int t = t0; t < t1; ++t) {
      const int c0 = t * kLane, m = c0 + 4 * lane;
      float* tile = plane + step_off(n2, pl, c0);
      const float4 v = *reinterpret_cast<const float4*>(tile + 4 * lane);
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
      const float ls[4] = {a.log_s0 + (base + p1), a.log_s0 + (base + p2),
                           a.log_s0 + (base + p3), a.log_s0 + (base + p4)};
      carry += __shfl_sync(kFull, s, 31);
      if (!PRICED) {
        // Prices in place, then stored with lanes on consecutive steps.
        *reinterpret_cast<float4*>(tile + 4 * lane) = make_float4(
            expf(ls[0]), expf(ls[1]), expf(ls[2]), expf(ls[3]));
        __syncwarp();
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int cc = lane + 32 * i;
          if (c0 + cc < n) a.out[row * (n + 1) + 1 + c0 + cc] = tile[cc];
        }
        continue;
      }
      if (stopped) continue;  // CV's last segment, on to the terminal price
      // This tile's rows: wait for its group (the next tile's may still be
      // in flight), read them, and reuse the slot for the tile kBufs on.
      if (kBufs == 2 && t + 1 < t1)
        cp_async_wait_one();
      else
        cp_async_wait();
      const float* slot = slots + (t - t0) % kBufs * kSlot;
      float4 rows[staged_rows(true, QUAD)];
#pragma unroll
      for (int r = 0; r < staged_rows(true, QUAD); ++r)
        rows[r] = *reinterpret_cast<const float4*>(slot + r * kLane);
      if (t + kBufs < t1) {
        __syncwarp();   // the lane's reads of the slot precede the copy
        stage_lane_rows<QUAD>(a, slots + (t - t0) % kBufs * kSlot,
                              m + kBufs * kLane);
      }
      int first = 4;
      float qval = 0.0f;
      if (QUAD) {
        const float c0v[4] = {rows[0].x, rows[0].y, rows[0].z, rows[0].w};
        const float c1v[4] = {rows[1].x, rows[1].y, rows[1].z, rows[1].w};
        const float c2v[4] = {rows[2].x, rows[2].y, rows[2].z, rows[2].w};
        const float muv[4] = {rows[3].x, rows[3].y, rows[3].z, rows[3].w};
        const float sdv[4] = {rows[4].x, rows[4].y, rows[4].z, rows[4].w};
        const float epv[4] = {rows[5].x, rows[5].y, rows[5].z, rows[5].w};
        const float dsv[4] = {rows[6].x, rows[6].y, rows[6].z, rows[6].w};
        const float kv[4] = {rows[7].x, rows[7].y, rows[7].z, rows[7].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (first == 4 && m + e < n) {
            // quad_exercise's test: p > eps and p >= cont, IEEE division.
            const mcop::QuadRows q = {{c0v[e], c1v[e], c2v[e]}, muv[e],
                                      sdv[e], epv[e], kv[e]};
            const float s_e = expf(ls[e]);
            const float p = mcop::quad_payoff(s_e, q.strike, a.is_call);
            if (p > q.eps && p >= mcop::quad_rows_cont(q, s_e)) {
              first = e;
              qval = __fmul_rn(p, dsv[e]);
            }
          }
        }
      } else {
        const float l4[4] = {rows[0].x, rows[0].y, rows[0].z, rows[0].w};
        const float h4[4] = {rows[1].x, rows[1].y, rows[1].z, rows[1].w};
#pragma unroll
        for (int e = 3; e >= 0; --e)
          if (m + e < n && ls[e] >= l4[e] && ls[e] <= h4[e]) first = e;
      }
      const unsigned hits = __ballot_sync(kFull, first < 4);
      if (hits) {
        hit_lane = __ffs(hits) - 1;
        if (lane == hit_lane) {
          if (QUAD) {
            val = qval;
          } else {
            const float4 dv = rows[2];
            const float lsf = first == 0   ? ls[0]
                              : first == 1 ? ls[1]
                              : first == 2 ? ls[2]
                                           : ls[3];
            const float dsf = first == 0   ? dv.x
                              : first == 1 ? dv.y
                              : first == 2 ? dv.z
                                           : dv.w;
            const float st = expf(lsf);
            const float pay = a.is_call ? st - a.strike : a.strike - st;
            val = dsf * fmaxf(pay, 0.0f);
          }
        }
        // Warp-uniform: the segment stopped at its first hit; under CV the
        // last segment scans on to the terminal log price.
        stopped = true;
        if (!CV || seg != wpm - 1) break;
      }
    }
    if (PRICED) {
      cp_async_wait();
      if (lane == 0) unit_hit[u] = stopped;
      if (lane == hit_lane) unit_val[u] = val;
      if (CV && lane == 0)
        unit_cv[u] = seg == wpm - 1 ? expf(a.log_s0 + carry) : 0.0f;
    }
  }

  if (PRICED) {
    __syncthreads();
    if (tid == 0) {
      // Per member, the hit of its earliest segment that has one; the
      // members in order.
      float sum = 0.0f;
      for (int mp = 0; mp < members; ++mp) {
        for (int u = mp * wpm; u < (mp + 1) * wpm; ++u) {
          if (unit_hit[u]) {
            sum += unit_val[u];
            break;
          }
        }
      }
      a.out[blockIdx.x] = sum;
      if (CV) {
        float cv = 0.0f;
        for (int u = 0; u < units; ++u) cv += unit_cv[u];
        a.out[gridDim.x + blockIdx.x] = a.cv_disc * cv;
      }
    }
  }
}

using Kernel = void (*)(Args);

// This unit's body of the form, or null where the arguments name none (the
// quadratic policy has no pair form and no K8 form, CV no K8 form).
template <bool SEEDED>
Kernel kernel_of(bool priced, bool anti, bool cv, bool quad) {
  if ((quad && (anti || !priced)) || (cv && !priced)) return nullptr;
  if (quad)
    return cv ? factored_kernel<SEEDED, true, false, true, true, kUnitBf16>
              : factored_kernel<SEEDED, true, false, false, true, kUnitBf16>;
  if (!priced)
    return anti
               ? factored_kernel<SEEDED, false, true, false, false, kUnitBf16>
               : factored_kernel<SEEDED, false, false, false, false,
                                 kUnitBf16>;
  if (anti)
    return cv ? factored_kernel<SEEDED, true, true, true, false, kUnitBf16>
              : factored_kernel<SEEDED, true, true, false, false, kUnitBf16>;
  return cv ? factored_kernel<SEEDED, true, false, true, false, kUnitBf16>
            : factored_kernel<SEEDED, true, false, false, false, kUnitBf16>;
}

// Sets the form's dynamic shared memory on its body.
cudaError_t prepare(Kernel k, int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(k,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <bool PRICED>
cudaError_t launch(Args a, bool anti, bool cv, bool quad,
                   cudaStream_t stream) {
  a.n2 = horizon_n2(a.n);
  const int smem = smem_bytes(PRICED, quad);
  if (a.n2 < 0 || smem > kSmemLimit) return cudaErrorInvalidValue;
  a.m2 = a.n2 * kLane;
  a.s_pad = (a.n + kLane - 1) / kLane * kLane;
  a.paths = kRows / a.n2;
  a.drawn = anti ? a.rows / 2 : a.rows;
  const Kernel k = a.noise == nullptr
                       ? kernel_of<true>(PRICED, anti, cv, quad)
                       : kernel_of<false>(PRICED, anti, cv, quad);
  if (k == nullptr || a.rows < 1 || (anti && a.rows % 2) ||
      a.drawn % a.paths || a.bf16 != kUnitBf16)
    return cudaErrorInvalidValue;
  cudaError_t err = prepare(k, smem);
  if (err != cudaSuccess) return err;
  k<<<a.drawn / a.paths, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
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

// The dynamic shared memory of a K8 (priced == 0) or K9 block of the form
// (the quadratic policy with quadratic != 0) at this horizon, the same in
// both fGN input dtypes, or -1 for a horizon K8/K9 do not take.
int MCOP_ENTRY(mcop_factored_form_smem_bytes)(int n_steps, int priced,
                                              int quadratic) {
  if (horizon_n2(n_steps) < 0) return -1;
  const int smem = smem_bytes(priced != 0, priced != 0 && quadratic != 0);
  return smem > kSmemLimit ? -1 : smem;
}

// The largest block of any K8/K9 form at this horizon (K9's quadratic one),
// or -1 for a horizon they do not take.
int MCOP_ENTRY(mcop_factored_smem_bytes)(int n_steps) {
  return MCOP_ENTRY(mcop_factored_form_smem_bytes)(n_steps, 1, 1);
}

// Blocks of the K8 (priced == 0) or K9 form one SM runs at once, of this
// unit's seeded body, by cudaOccupancyMaxActiveBlocksPerMultiprocessor at
// the form's shared memory; minus a cudaError_t where the arguments name no
// body or the query fails.
int MCOP_ENTRY(mcop_factored_blocks_per_sm)(int n_steps, int priced,
                                            int antithetic, int with_cv,
                                            int quadratic) {
  const Kernel k = kernel_of<true>(priced != 0, antithetic != 0, with_cv != 0,
                                   quadratic != 0);
  const int smem = MCOP_ENTRY(mcop_factored_form_smem_bytes)(
      n_steps, priced, quadratic);
  if (k == nullptr || smem < 0) return -static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = prepare(k, smem);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, kThreads,
                                                        smem);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
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
