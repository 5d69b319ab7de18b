// K3 and K4, the pathwise Greeks kernels for Hopper (sm_90a), one device
// body with two entries, bound through a plain C interface and loaded with
// ctypes (models/greeks_cuda.py).
//
// mcop_greeks_chunk replaces montecarlooptionspricer_tpu/models/
//    pathgen_pallas.py:_greeks_kernel and _greeks_kernel_noise_in
//    (_greeks_body, _tangent_planes, _greek_stop_vals): one strike, given as
//    an argument.
// mcop_chain_greeks_chunk replaces _chain_greeks_kernel,
//    _chain_greeks_kernel_noise_in and _chain_greeks_kernel_grid
//    (_chain_greeks_body): a strike strip, each strike read from row 3 of
//    its table.
// Both: chol fGN form, log-boundary policy, in two forms: plain and
//    antithetic (the pair branch of _tangent_planes:849), each also on
//    bf16 fGN inputs (BF16, from the bf16 flag; StreamConfig.
//    fgn_matmul_dtype="bfloat16": _greeks_consts:1028 rounds Lt' and dLt'
//    to bf16, :1035-1036, and _tangent_planes:845-848 forms N @ Lt' and
//    N @ dLt' on bf16 inputs from one N).
//
// Build units (csrc/build_unit.cuh): this source is built twice, the
// float32 and the bf16 bodies apart; an entry given the other dtype's
// flag returns cudaErrorInvalidValue.
//
// What they compute, per path and step column c (column c = step c+1):
//   x' = N @ Lt' and hx = N @ dLt' (Lt' = 0.5 Lt, dLt' = 0.5 dLt/dH)
//   sv = exp(x' + vd), v = sv^2, svw = sv W sqrt(dt)
//   inc = (r - v/2) dt + svw and the shared bracket b = svw - v dt
//   running sums ls = log s0 + sum inc, cumb = sum b,
//   cume = sum (x'/eta + de) b, cumh = sum (hx + dh) b
// The policy of strike k is fixed (the envelope convention): the path
// stops at the first c with llo_k[c] <= ls_c <= lhi_k[c]; then t* =
// (c + 1) dt, d* = exp(-r t*), S* = exp(ls_c), p = +-(S* - K), and with
// act = (d* > 0 and p > 0), pv = d* p and base = d* (+-1) S* (both 0
// unless act), the six sums are
//   pv, base, base cumb, base cume, t* (base - pv), base cumh
// (the wrapper scales the second by 1/s0 and the third by 1/(2 xi):
// price, delta, vega_xi, vega_eta, rho_rate, vega_h).  Each block writes
// one partial sum per strike and output; no atomics.
//
// The antithetic form draws (or reads) N and W for half the paths.  Both
// products are linear in N, so they run once per pair: the partner of
// drawn row q takes -x', -hx and -W, and nothing else changes sign (the
// tangent rows de and dh are constants, and its eta bracket x'/eta + de
// reads its own -x').  Each member then carries its own increments,
// brackets, running sums, first hit and six sums, in log space as the
// plain form decides.
//
// Bound on the H100: operations.  Two triangular products, ~n^2
// multiply-adds per path (133k at n = 365), and ~4 operations per cell and
// strike for the sweep: at 131,072 paths and 365 steps that is 17.5e9 FMA,
// 0.54 ms at 67 TFLOP/s float32 for K3 and 0.59 ms for K4 at 21 strikes,
// against ~1 MB of bytes that must move (Lt', dLt', rows, sums).  Paired,
// the products are half of that; the per-cell work and the sweep are not.
//
// Design:
// * The path block, its noise and the tile product are K2's
//   (csrc/fgn_tile.cuh), with both factors multiplied from the same N
//   reads, so x' is K2's bit for bit; the log price is log s0 + (the
//   running sum of the increments), as JAX and the plain version
//   associate it (as K5 does; csrc/chain.cu).  At 365 steps the
//   N and W planes, four 64-column tiles (x' then inc, hx then b, the
//   eta and H brackets) and the two staged factors take 143,104 bytes at a
//   32-path block; a 64-path block would need 269,824 (models/
//   greeks_cuda.py smem_bytes).  In general a block of D = 16 * PM drawn
//   rows and BP members (D plain, 2D paired) takes 4 (2 D ld + 4 * 65 BP +
//   2 * 2048) bytes, ld = n rounded up to odd: the planes hold the drawn
//   rows only, the four tiles every member.  A paired block at 365 steps
//   with D = 32 (64 members) takes 4 (2 * 32 * 365 + 4 * 65 * 64 + 4096)
//   = 176,384 bytes and runs the products of the unpaired 32-path block;
//   D = 64 would take 336,384.  The reduction's [32][6][BP] floats fit the
//   four tiles (260 BP floats).
// * Per tile: the product, then the tangent brackets elementwise with all
//   threads, then one thread per path carries the four running sums along
//   the tile and writes them back in place, then every thread sweeps its
//   strikes: thread (path p, lane l) keeps, in registers, the stop index
//   and the four stopped sums of strikes l, l + L, ... (L = 256 / BP).
//   K3 is the same body with one strike.  The TPU's four tangent cumsum
//   matmuls and one-hot reductions become these loops.
// * One launch sweeps up to kGroup = 32 strikes (4 per thread at BP = 32,
//   8 at 64 pair members); a wider strip takes one launch per 32 strikes
//   on the same seed, whose Philox counter (global drawn row, step pair)
//   regenerates the same members and partners for every group.
// * t* and d* are recomputed from the stop index, as on the TPU.
// * The bf16 form (BF16) keeps the N plane in bf16 (each normal rounded to
//   nearest even, the rows zero-padded to whole k16 steps) and runs both
//   products on the tensor cores from one N: the Lt' and dLt' k-tiles are
//   staged side by side, each warp keeps the triangle skip of its 8
//   columns, and each A fragment of N is loaded once and issued into two
//   float32 accumulators (csrc/fgn_tile.cuh:fgn_tile_mma, NMAT 2).  W,
//   the tiles, the tangent brackets, the sums and the sweep are the
//   float32 form's; a pair's partner is -x', -hx to the bit.  Its plane
//   and staged tiles are narrower, so its block is the largest its own
//   model fits (models/greeks_cuda.py block_paths_for): 64 paths at 365
//   steps (64 members paired), twice the float32 form's plain block.

#include <cuda_runtime.h>
#include <stdint.h>

#include "build_unit.cuh"
#include "fgn_tile.cuh"

namespace {

using namespace mcop;

constexpr int kGroup = 32;   // strikes one launch sweeps
constexpr int kOut = 6;      // sums per strike

struct GreeksArgs {
  const float* noise;   // [2, drawn, n] or nullptr for the seeded entry
  const void* lt;       // [n, n] half-scaled Cholesky factor, and
  const void* dlt;      // [n, n] half-scaled dLt/dH: bf16 under the bf16
                        // form, else float32
  const float* vd;      // [n] half variance drift
  const float* de;      // [n] eta tangent row
  const float* dh;      // [n] H tangent row
  const float* tables;  // [n_strikes] log_boundary_rows tables: rows llo,
                        // lhi, disc, strike
  long long strike_stride, row_stride;   // floats
  int n_strikes;        // <= kGroup
  int strike_from_table;
  float strike;         // the strike when strike_from_table is 0
  float* out;           // [rows / BP, n_strikes, kOut] partial sums
  int rows, drawn, n;   // paths, rows of the noise planes, steps
  uint32_t key;
  float r, dt, sqrt_dt, log_s0, inv_eta;
  int is_call;
  bool bf16;            // the bf16 fGN-input form
};

// Tangent increment and brackets of one member at cell c from its x', hx
// and w: the increment inc, the bracket b and the eta and H brackets.
// Every rounding is explicit (no multiply-add contraction), so a pair's
// partner (-x, -hx, -w) rounds exactly as the unpaired kernel on the
// negated noise does.
struct Brackets {
  float inc, b, e, h;
};

__device__ __forceinline__ Brackets brackets(const GreeksArgs& a, float x,
                                             float hx, float w, int c) {
  const float sv = expf(x + a.vd[c]);
  const float v = __fmul_rn(sv, sv);
  const float svw = __fmul_rn(sv, __fmul_rn(w, a.sqrt_dt));
  const float b = __fsub_rn(svw, __fmul_rn(v, a.dt));
  return {__fadd_rn(__fmul_rn(__fsub_rn(a.r, __fmul_rn(0.5f, v)), a.dt), svw),
          b, __fmul_rn(__fadd_rn(__fmul_rn(x, a.inv_eta), a.de[c]), b),
          __fmul_rn(__fadd_rn(hx, a.dh[c]), b)};
}

// Block of D = 16 * PM drawn rows; BP = D paths, or 2D pair members (ANTI:
// member p < D is drawn row p, member D + p its partner).  BF16: the bf16
// fGN-input form.
template <int PM, bool SEEDED, bool ANTI, bool BF16>
__global__ void __launch_bounds__(kThreads, 1) greeks_kernel(GreeksArgs a) {
  constexpr int D = 16 * PM;
  constexpr int BP = ANTI ? 2 * D : D;
  constexpr int kLanes = kThreads / BP;   // strike lanes per path
  constexpr int kPer = kGroup / kLanes;   // strikes per thread
  constexpr int kTile = BP * kXStride;
  using E = fgn_elem<BF16>;
  extern __shared__ float smem[];
  const int n = a.n, ld = plane_ld(n);
  E* ns = reinterpret_cast<E*>(smem);     // [D][ld]; bf16: [D][ldn]
  float* ws = smem + n_plane_floats(n, D, BF16);   // [D][ld]
  float* t0 = ws + D * ld;                // x', then inc, then ls
  float* t1 = t0 + kTile;                 // hx, then b, then cumb
  float* t2 = t1 + kTile;                 // eta bracket, then cume
  float* t3 = t2 + kTile;                 // H bracket, then cumh
  E* lts = reinterpret_cast<E*>(t3 + kTile);
                                          // [2][kTileK][kTileCols];
                                          // bf16: [2][kTileCols][kTileKB]

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * D;        // first drawn row
  const int p = tid % BP, lane = tid / BP;
  load_noise<D, SEEDED, false, BF16>(a.noise, a.drawn, n, a.key, row0, ns,
                                     ws);

  // Running sums, thread tid < BP.
  float cum = 0.0f, cb = 0.0f, ce = 0.0f, ch = 0.0f;
  // Stop state of this thread's strikes.
  int stop[kPer];
  float s_ls[kPer], s_cb[kPer], s_ce[kPer], s_ch[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    stop[i] = -1;
    s_ls[i] = s_cb[i] = s_ce[i] = s_ch[i] = 0.0f;
  }

  for (int c0 = 0; c0 < n; c0 += kTileCols) {
    const int cn = min(c0 + kTileCols, n) - c0;
    fgn_tile<PM, 2, false, BF16>(static_cast<const E*>(a.lt),
                                 static_cast<const E*>(a.dlt), n, c0, ns,
                                 lts, t0, t1);

    // Increments and tangent brackets, elementwise over the tile (both
    // members of a pair from one x', one hx and one w).
    for (int idx = tid; idx < D * kTileCols; idx += kThreads) {
      const int q = idx / kTileCols, cc = idx - q * kTileCols;
      const int o = q * kXStride + cc;
      constexpr int po = D * kXStride;    // the partner's offset
      if (cc < cn) {
        const int c = c0 + cc;
        const float x = t0[o], hx = t1[o], w = ws[q * ld + c];
        const Brackets m = brackets(a, x, hx, w, c);
        t0[o] = m.inc;
        t1[o] = m.b;
        t2[o] = m.e;
        t3[o] = m.h;
        if (ANTI) {
          const Brackets m2 = brackets(a, -x, -hx, -w, c);
          t0[o + po] = m2.inc;
          t1[o + po] = m2.b;
          t2[o + po] = m2.e;
          t3[o + po] = m2.h;
        }
      } else {
        t0[o] = t1[o] = t2[o] = t3[o] = 0.0f;
        if (ANTI) t0[o + po] = t1[o + po] = t2[o + po] = t3[o + po] = 0.0f;
      }
    }
    __syncthreads();

    // The four running sums along the tile, one thread per path.
    if (tid < BP) {
      const int o = tid * kXStride;
      for (int cc = 0; cc < cn; ++cc) {
        cum += t0[o + cc];
        cb += t1[o + cc];
        ce += t2[o + cc];
        ch += t3[o + cc];
        t0[o + cc] = a.log_s0 + cum;
        t1[o + cc] = cb;
        t2[o + cc] = ce;
        t3[o + cc] = ch;
      }
    }
    __syncthreads();

    // The strike sweep: thread (p, lane) over its strikes' first hits.
    const int o = p * kXStride;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int k = lane + kLanes * i;
      if (k >= a.n_strikes || stop[i] >= 0) continue;
      const float* llo = a.tables + k * a.strike_stride + c0;
      const float* lhi = llo + a.row_stride;
      for (int cc = 0; cc < cn; ++cc) {
        const float l = t0[o + cc];
        if (l >= __ldg(llo + cc) && l <= __ldg(lhi + cc)) {
          stop[i] = c0 + cc;
          s_ls[i] = l;
          s_cb[i] = t1[o + cc];
          s_ce[i] = t2[o + cc];
          s_ch[i] = t3[o + cc];
          break;
        }
      }
    }
    // The next tile's product synchronises before it overwrites t0, t1;
    // its elementwise pass writes t2, t3 only after that.
  }

  __syncthreads();
  float* red = t0;                        // [n_strikes][kOut][BP]
  const float sgn = a.is_call ? 1.0f : -1.0f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int k = lane + kLanes * i;
    if (k >= a.n_strikes) continue;
    const bool ex = stop[i] >= 0;
    const float t_raw = static_cast<float>(stop[i] + 1) * a.dt;
    const float d = ex ? expf(-a.r * t_raw) : 0.0f;
    const float t_s = ex ? t_raw : 0.0f;
    const float strike =
        a.strike_from_table
            ? __ldg(a.tables + k * a.strike_stride + 3 * a.row_stride)
            : a.strike;
    const float s_stop = expf(s_ls[i]);
    const float pay = sgn * (s_stop - strike);
    const bool act = d > 0.0f && pay > 0.0f;
    const float pv = act ? d * pay : 0.0f;
    const float base = act ? d * sgn * s_stop : 0.0f;
    float* dst = red + k * kOut * BP + p;
    dst[0] = pv;
    dst[BP] = base;
    dst[2 * BP] = base * s_cb[i];
    dst[3 * BP] = base * s_ce[i];
    dst[4 * BP] = t_s * (base - pv);
    dst[5 * BP] = base * s_ch[i];
  }
  __syncthreads();
  for (int j = tid; j < a.n_strikes * kOut; j += kThreads) {
    float sum = 0.0f;
    for (int q = 0; q < BP; ++q) sum += red[j * BP + q];
    a.out[static_cast<size_t>(blockIdx.x) * a.n_strikes * kOut + j] = sum;
  }
}

// Shared memory of a block of bp paths (pair members when antithetic):
// the planes of the drawn rows, four tiles of every member, two staged
// factors; in the bf16 form's layout when bf16.
int smem_bytes(int n, int bp, bool anti, bool bf16) {
  const int d = anti ? bp / 2 : bp;
  return block_smem_bytes(n, d, 2, (4 * bp - 2 * d) * kXStride, false,
                          bf16);
}

template <int PM, bool SEEDED, bool ANTI>
cudaError_t launch_one(const GreeksArgs& a, cudaStream_t stream) {
  constexpr int D = 16 * PM;
  const int smem = smem_bytes(a.n, ANTI ? 2 * D : D, ANTI, kUnitBf16);
  auto kernel = greeks_kernel<PM, SEEDED, ANTI, kUnitBf16>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<a.drawn / D, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The seeded or noise-in entry, where a.bf16 names this unit's fGN input
// dtype.
template <bool ANTI>
cudaError_t launch_pm(const GreeksArgs& a, int pm, cudaStream_t s) {
  if (a.bf16 != kUnitBf16) return cudaErrorInvalidValue;
  const bool seeded = a.noise == nullptr;
  switch (pm) {
    case 4:
      return seeded ? launch_one<4, true, ANTI>(a, s)
                    : launch_one<4, false, ANTI>(a, s);
    case 2:
      return seeded ? launch_one<2, true, ANTI>(a, s)
                    : launch_one<2, false, ANTI>(a, s);
    case 1:
      return seeded ? launch_one<1, true, ANTI>(a, s)
                    : launch_one<1, false, ANTI>(a, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// block_paths counts paths: 16, 32 or 64 plain, 32, 64 or 128 pair members.
int launch(GreeksArgs& a, int block_paths, bool anti, cudaStream_t s) {
  const int unit = anti ? 32 : 16;
  if (a.n < 1 || a.rows < 1 || block_paths < unit || block_paths % unit ||
      block_paths > 4 * unit || a.rows % block_paths || a.n_strikes < 1 ||
      a.n_strikes > kGroup ||
      smem_bytes(a.n, block_paths, anti, kUnitBf16) > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  a.drawn = anti ? a.rows / 2 : a.rows;
  const int pm = block_paths / unit;
  const cudaError_t err =
      anti ? launch_pm<true>(a, pm, s) : launch_pm<false>(a, pm, s);
  return static_cast<int>(err);
}

GreeksArgs common(const float* noise, const void* lt, const void* dlt,
                  const float* vd, const float* de, const float* dh, int rows,
                  int n_steps, unsigned int key, float r, float dt,
                  float sqrt_dt, float log_s0, float inv_eta,
                  const float* tables, long long strike_stride,
                  long long row_stride, int is_call, int bf16, float* out) {
  GreeksArgs a{};
  a.noise = noise;
  a.lt = lt;
  a.dlt = dlt;
  a.vd = vd;
  a.de = de;
  a.dh = dh;
  a.tables = tables;
  a.strike_stride = strike_stride;
  a.row_stride = row_stride;
  a.out = out;
  a.rows = rows;
  a.n = n_steps;
  a.key = key;
  a.r = r;
  a.dt = dt;
  a.sqrt_dt = sqrt_dt;
  a.log_s0 = log_s0;
  a.inv_eta = inv_eta;
  a.is_call = is_call;
  a.bf16 = bf16 != 0;
  return a;
}

}  // namespace

extern "C" {

// block_paths counts paths (pair members when antithetic != 0); in this
// unit's fGN input dtype.
int MCOP_ENTRY(mcop_greeks_smem_bytes)(int n_steps, int block_paths,
                                       int antithetic) {
  return smem_bytes(n_steps, block_paths, antithetic != 0, kUnitBf16);
}

int MCOP_ENTRY(mcop_greeks_group)() { return kGroup; }

// K3.  noise may be null (seeded entry, stream of `key`).  rows counts
// paths; antithetic != 0 reads (or draws) rows / 2 rows of noise, [2,
// rows / 2, n_steps].  bf16 != 0 (the _bf16 unit only): the bf16 form, lt
// and dlt bf16, noise float32 (N rounded as it is read).  table: one
// log_boundary_rows table, rows row_stride floats apart.  out:
// [rows / block_paths, 6].
int MCOP_ENTRY(mcop_greeks_chunk)(
    const float* noise, const void* lt, const void* dlt, const float* vd,
    const float* de, const float* dh, int rows, int n_steps,
    int block_paths, unsigned int key, float r, float dt, float sqrt_dt,
    float log_s0, float inv_eta, const float* table, long long row_stride,
    float strike, int is_call, int antithetic, int bf16, float* out,
    void* stream) {
  GreeksArgs a = common(noise, lt, dlt, vd, de, dh, rows, n_steps, key, r,
                        dt, sqrt_dt, log_s0, inv_eta, table, 0, row_stride,
                        is_call, bf16, out);
  a.n_strikes = 1;
  a.strike_from_table = 0;
  a.strike = strike;
  return launch(a, block_paths, antithetic != 0,
                static_cast<cudaStream_t>(stream));
}

// K4.  As K3 with a strip: tables are the launch's n_strikes
// log_boundary_rows tables, strike_stride floats apart; each strike is row
// 3 of its table.  out: [rows / block_paths, n_strikes, 6].
int MCOP_ENTRY(mcop_chain_greeks_chunk)(
    const float* noise, const void* lt, const void* dlt, const float* vd,
    const float* de, const float* dh, int rows, int n_steps,
    int block_paths, unsigned int key, float r, float dt, float sqrt_dt,
    float log_s0, float inv_eta, const float* tables,
    long long strike_stride, long long row_stride, int n_strikes,
    int is_call, int antithetic, int bf16, float* out, void* stream) {
  GreeksArgs a = common(noise, lt, dlt, vd, de, dh, rows, n_steps, key, r,
                        dt, sqrt_dt, log_s0, inv_eta, tables, strike_stride,
                        row_stride, is_call, bf16, out);
  a.n_strikes = n_strikes;
  a.strike_from_table = 1;
  return launch(a, block_paths, antithetic != 0,
                static_cast<cudaStream_t>(stream));
}

}  // extern "C"
