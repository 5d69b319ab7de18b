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
// * The path block, its N plane and the tile product are K2's
//   (csrc/fgn_tile.cuh), with both factors multiplied from the same N
//   reads, so x' is K2's bit for bit; the log price is log s0 + (the
//   running sum of the increments), as JAX and the plain version
//   associate it (as K5 does; csrc/chain.cu).  No W plane stays resident:
//   the bracket pass takes each tile's W per step pair, redrawn from the
//   seeded stream at load_noise's counter or read from the injected plane
//   (csrc/strip_sweep.cuh:tile_w_pair).
// * Per tile: the products, then the tangent brackets per step pair with
//   all threads, then one thread per path carries the four running sums
//   along the tile and writes them back in place (64 dependent steps), then
//   the sweep.  The TPU's four tangent cumsum matmuls and one-hot
//   reductions become these passes.
// * The sweep is JAX's min-index reduction over columns written for a
//   warp, as in K5: lane l sits on columns l and l + 32, warp w owns
//   members w, w + 8, ... (BP / 8), and for each strike k of the launch
//   the warp reads k's log lo and log hi at its two columns from shared
//   memory, tests each of its members' log prices and takes two ballots
//   (columns 0-31, 32-63) with no branch, then branches once per strike,
//   where a live member hits; __ffs gives its first hit.  Lane k keeps
//   strike k's stop state for the warp's members: a stopped bit, the stop
//   column and the four stopped sums, read from the tiles at the hit
//   column.  A stopped (member, strike) is masked warp-uniformly and a
//   strike all the warp's members have left is skipped whole.  Nothing
//   walks the columns one by one or exits early.  K3 is the same body
//   with one strike.
// * The tables: rows llo and lhi of the launch's strikes for the tile's
//   columns are copied into shared memory with cp.async, issued before
//   the tile's products and waited for after the running sums
//   (n_strikes * 512 bytes: the reserve is sized by the launch's strikes,
//   the block by kGroup); the strike (row 3) is read once per lane at
//   the end.
// * One launch sweeps up to kGroup = 32 strikes (one per lane); a wider
//   strip takes one launch per 32 strikes on the same seed, whose Philox
//   counter (global drawn row, step pair) regenerates the same members
//   and partners for every group.
// * t* and d* are recomputed from the stop column, as on the TPU.
// * Shared memory (models/greeks_cuda.py smem_bytes): a block of D = 16 *
//   PM drawn rows and BP members (D plain, 2D paired) takes 4 (D ld + 4 *
//   65 BP + 2 F + 128 K) bytes, ld = n rounded up to odd, F = 2048 floats
//   a staged float32 factor tile, K strikes: the N plane holds the drawn
//   rows only, the four tiles every member.  The block is the largest the
//   model fits at kGroup strikes: at 365 steps 64 paths in float32 and
//   bf16, 64 members paired in float32 and 128 in bf16 (207,872 bytes);
//   a float32 plain block takes 192,768 bytes.  At 365 steps each runs
//   one to an SM.  The reduction's [32][6][BP] floats fit the four tiles
//   (260 BP floats).  Registers: at most 128 a thread
//   (two blocks an SM) up to 64 members, 255 at 128 (min_blocks).
// * The bf16 form (BF16) keeps the N plane in bf16 (each normal rounded to
//   nearest even, the rows zero-padded to whole k16 steps) and runs both
//   products on the tensor cores from one N: the Lt' and dLt' k-tiles are
//   staged side by side, each warp keeps the triangle skip of its 8
//   columns, and each A fragment of N is loaded once and issued into two
//   float32 accumulators (csrc/fgn_tile.cuh:fgn_tile_mma, NMAT 2).  W,
//   the tiles, the tangent brackets, the sums and the sweep are the
//   float32 form's; a pair's partner is -x', -hx to the bit.  Its plane
//   (2 D (ceil16(n) + 8) bytes) and staged tiles are narrower.

#include <cuda_runtime.h>
#include <stdint.h>

#include "build_unit.cuh"
#include "fgn_tile.cuh"
#include "strip_sweep.cuh"

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

// The blocks per SM a body's registers are held to: two (at most 128
// registers a thread) up to 64 members; one at 128, whose sweep keeps the
// stop state of 16 members a lane (80 registers) and whose four tiles
// leave no room for a second block anyway.
constexpr int min_blocks(int bp) { return bp > 64 ? 1 : 2; }

// Block of D = 16 * PM drawn rows; BP = D paths, or 2D pair members (ANTI:
// member p < D is drawn row p, member D + p its partner).  BF16: the bf16
// fGN-input form.
template <int PM, bool SEEDED, bool ANTI, bool BF16>
__global__ void __launch_bounds__(kThreads,
                                  min_blocks(ANTI ? 32 * PM : 16 * PM))
    greeks_kernel(GreeksArgs a) {
  constexpr int D = 16 * PM;
  constexpr int BP = ANTI ? 2 * D : D;
  constexpr int kPaths = BP / kWarps;     // members each warp sweeps
  constexpr unsigned kAllPaths = (1u << kPaths) - 1u;
  constexpr int kTile = BP * kXStride;
  constexpr int kHalf = kTileCols / 2;
  using E = fgn_elem<BF16>;
  extern __shared__ float smem[];
  const int n = a.n;
  E* ns = reinterpret_cast<E*>(smem);     // [D][ld]; bf16: [D][ldn]
  float* t0 = smem + n_plane_floats(n, D, BF16);   // x', then inc, then ls
  float* t1 = t0 + kTile;                 // hx, then b, then cumb
  float* t2 = t1 + kTile;                 // eta bracket, then cume
  float* t3 = t2 + kTile;                 // H bracket, then cumh
  E* lts = reinterpret_cast<E*>(t3 + kTile);
                                          // [2][kTileK][kTileCols];
                                          // bf16: [2][kTileCols][kTileKB]
  float* tab = t3 + kTile + staged_floats(2, BF16);
                                          // [n_strikes][2][kTileCols]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int row0 = blockIdx.x * D;        // first drawn row
  load_noise<D, SEEDED, false, BF16, false>(a.noise, a.drawn, n, a.key,
                                            row0, ns, nullptr);

  // Running sums, thread tid < BP.
  float cum = 0.0f, cb = 0.0f, ce = 0.0f, ch = 0.0f;
  // Lane k keeps strike k's stop state for members warp + kWarps * j: bit
  // j of `stopped`, the stop column and the four sums there.
  unsigned stopped = 0u;
  int stop[kPaths];
  float s_ls[kPaths], s_cb[kPaths], s_ce[kPaths], s_ch[kPaths];
#pragma unroll
  for (int j = 0; j < kPaths; ++j) {
    stop[j] = 0;
    s_ls[j] = s_cb[j] = s_ce[j] = s_ch[j] = 0.0f;
  }

  for (int c0 = 0; c0 < n; c0 += kTileCols) {
    const int cn = min(c0 + kTileCols, n) - c0;
    __syncthreads();   // the last tile's sweep is done with tab and t0-t3
    stage_strike_rows(a.tables, a.strike_stride, a.row_stride, a.n_strikes,
                      c0, cn, tab);
    fgn_tile<PM, 2, false, BF16>(static_cast<const E*>(a.lt),
                                 static_cast<const E*>(a.dlt), n, c0, ns,
                                 lts, t0, t1);

    // Increments and tangent brackets of each step pair (both members of a
    // pair from one x', one hx and one w), W drawn or read here.
    for (int idx = tid; idx < D * kHalf; idx += kThreads) {
      const int q = idx / kHalf, cc = 2 * (idx - q * kHalf);
      if (cc >= cn) continue;
      float w[2];
      tile_w_pair<SEEDED>(a.noise, a.drawn, n, a.key, row0 + q, c0 + cc, w);
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        if (cc + t >= cn) continue;
        const int o = q * kXStride + cc + t, c = c0 + cc + t;
        constexpr int po = D * kXStride;  // the partner's offset
        const float x = t0[o], hx = t1[o];
        const Brackets m = brackets(a, x, hx, w[t], c);
        t0[o] = m.inc;
        t1[o] = m.b;
        t2[o] = m.e;
        t3[o] = m.h;
        if (ANTI) {
          const Brackets m2 = brackets(a, -x, -hx, -w[t], c);
          t0[o + po] = m2.inc;
          t1[o + po] = m2.b;
          t2[o + po] = m2.e;
          t3[o + po] = m2.h;
        }
      }
    }
    __syncthreads();

    // The four running sums along the tile, one thread per member.
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
    cp_async_wait_all();
    __syncthreads();

    // The strike sweep: lanes on columns, the warp over its (member,
    // strike) items.
    const bool v0 = lane < cn, v1 = lane + 32 < cn;
    float l0[kPaths], l1[kPaths];
#pragma unroll
    for (int j = 0; j < kPaths; ++j) {
      const float* lp = &t0[(warp + kWarps * j) * kXStride];
      l0[j] = lp[lane];
      l1[j] = lp[lane + 32];
    }
    for (int k = 0; k < a.n_strikes; ++k) {
      const unsigned done = __shfl_sync(kFullMask, stopped, k);
      if (done == kAllPaths) continue;
      const float* tk = tab + k * kStagedStrikeFloats;
      const float lo0 = tk[lane], lo1 = tk[lane + 32];
      const float hi0 = tk[kTileCols + lane], hi1 = tk[kTileCols + lane + 32];
      // Every member's ballots first, with no branch; then one
      // warp-uniform branch, taken where a live member hits in this tile.
      unsigned b0[kPaths], b1[kPaths], hits = 0u;
#pragma unroll
      for (int j = 0; j < kPaths; ++j) {
        b0[j] = __ballot_sync(kFullMask,
                              v0 & (l0[j] >= lo0) & (l0[j] <= hi0));
        b1[j] = __ballot_sync(kFullMask,
                              v1 & (l1[j] >= lo1) & (l1[j] <= hi1));
        hits |= (b0[j] | b1[j]) != 0u ? 1u << j : 0u;
      }
      hits &= ~done;
      if (hits == 0u) continue;
#pragma unroll
      for (int j = 0; j < kPaths; ++j) {
        if (!((hits >> j) & 1u)) continue;
        const int c = first_hit(b0[j], b1[j]);
        if (lane == k) {
          const int o = (warp + kWarps * j) * kXStride + c;
          stop[j] = c0 + c;
          s_ls[j] = t0[o];
          s_cb[j] = t1[o];
          s_ce[j] = t2[o];
          s_ch[j] = t3[o];
          stopped |= 1u << j;
        }
      }
    }
    // The next tile synchronises before it overwrites tab and t0-t3.
  }

  __syncthreads();
  float* red = t0;                        // [n_strikes][kOut][BP]
  const float sgn = a.is_call ? 1.0f : -1.0f;
  if (lane < a.n_strikes) {
    const int k = lane;
    const float strike =
        a.strike_from_table
            ? __ldg(a.tables + k * a.strike_stride + 3 * a.row_stride)
            : a.strike;
#pragma unroll
    for (int j = 0; j < kPaths; ++j) {
      const bool ex = (stopped >> j) & 1u;
      const float t_raw = static_cast<float>(stop[j] + 1) * a.dt;
      const float d = ex ? expf(-a.r * t_raw) : 0.0f;
      const float t_s = ex ? t_raw : 0.0f;
      const float s_stop = expf(s_ls[j]);
      const float pay = sgn * (s_stop - strike);
      const bool act = d > 0.0f && pay > 0.0f;
      const float pv = act ? d * pay : 0.0f;
      const float base = act ? d * sgn * s_stop : 0.0f;
      float* dst = red + k * kOut * BP + warp + kWarps * j;
      dst[0] = pv;
      dst[BP] = base;
      dst[2 * BP] = base * s_cb[j];
      dst[3 * BP] = base * s_ce[j];
      dst[4 * BP] = t_s * (base - pv);
      dst[5 * BP] = base * s_ch[j];
    }
  }
  __syncthreads();
  for (int j = tid; j < a.n_strikes * kOut; j += kThreads) {
    float sum = 0.0f;
    for (int q = 0; q < BP; ++q) sum += red[j * BP + q];
    a.out[static_cast<size_t>(blockIdx.x) * a.n_strikes * kOut + j] = sum;
  }
}

// Shared memory of a block of bp paths (pair members when antithetic) for
// a launch of n_strikes strikes: the N plane of the drawn rows, four tiles
// of every member, two staged factors, the strikes' staged rows; in the
// bf16 form's layout when bf16.
int smem_bytes(int n, int bp, bool anti, bool bf16, int n_strikes) {
  const int d = anti ? bp / 2 : bp;
  return block_smem_bytes(
      n, d, 2, (4 * bp - 2 * d) * kXStride + n_strikes * kStagedStrikeFloats,
      false, bf16, false);
}

using Kernel = void (*)(GreeksArgs);

template <int PM, bool ANTI>
Kernel body_of(bool seeded) {
  return seeded ? greeks_kernel<PM, true, ANTI, kUnitBf16>
                : greeks_kernel<PM, false, ANTI, kUnitBf16>;
}

// This unit's body of the form (block_paths counts paths: 16, 32 or 64
// plain, 32, 64 or 128 pair members), or null where the arguments name
// none.
Kernel kernel_for(int n, int block_paths, bool seeded, bool anti,
                  int n_strikes) {
  const int unit = anti ? 32 : 16;
  if (n < 1 || block_paths < unit || block_paths % unit ||
      block_paths > 4 * unit || n_strikes < 1 || n_strikes > kGroup ||
      smem_bytes(n, block_paths, anti, kUnitBf16, n_strikes) > kSmemLimit)
    return nullptr;
  switch (block_paths / unit) {
    case 4:
      return anti ? body_of<4, true>(seeded) : body_of<4, false>(seeded);
    case 2:
      return anti ? body_of<2, true>(seeded) : body_of<2, false>(seeded);
    case 1:
      return anti ? body_of<1, true>(seeded) : body_of<1, false>(seeded);
    default:
      return nullptr;
  }
}

int launch(GreeksArgs& a, int block_paths, bool anti, int bf16,
           cudaStream_t s) {
  const Kernel k = kernel_for(a.n, block_paths, a.noise == nullptr, anti,
                              a.n_strikes);
  if (k == nullptr || (bf16 != 0) != kUnitBf16 || a.rows < 1 ||
      a.rows % block_paths)
    return static_cast<int>(cudaErrorInvalidValue);
  a.drawn = anti ? a.rows / 2 : a.rows;
  const int smem = smem_bytes(a.n, block_paths, anti, kUnitBf16, a.n_strikes);
  const cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int d = anti ? block_paths / 2 : block_paths;
  k<<<a.drawn / d, kThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

GreeksArgs common(const float* noise, const void* lt, const void* dlt,
                  const float* vd, const float* de, const float* dh, int rows,
                  int n_steps, unsigned int key, float r, float dt,
                  float sqrt_dt, float log_s0, float inv_eta,
                  const float* tables, long long strike_stride,
                  long long row_stride, int is_call, float* out) {
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
  return a;
}

}  // namespace

extern "C" {

// block_paths counts paths (pair members when antithetic != 0), for a
// launch of n_strikes strikes; in this unit's fGN input dtype.
int MCOP_ENTRY(mcop_greeks_smem_bytes)(int n_steps, int block_paths,
                                       int antithetic, int n_strikes) {
  return smem_bytes(n_steps, block_paths, antithetic != 0, kUnitBf16,
                    n_strikes);
}

int MCOP_ENTRY(mcop_greeks_group)() { return kGroup; }

// Blocks of the form's seeded body one SM runs at once at this launch's
// shared memory, by cudaOccupancyMaxActiveBlocksPerMultiprocessor; minus
// a cudaError_t where the arguments name no body or the query fails.
int MCOP_ENTRY(mcop_greeks_blocks_per_sm)(int n_steps, int block_paths,
                                          int antithetic, int n_strikes) {
  const Kernel k = kernel_for(n_steps, block_paths, true,
                              antithetic != 0, n_strikes);
  if (k == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  const int smem = smem_bytes(n_steps, block_paths, antithetic != 0,
                              kUnitBf16, n_strikes);
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, kThreads,
                                                        smem);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

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
                        is_call, out);
  a.n_strikes = 1;
  a.strike_from_table = 0;
  a.strike = strike;
  return launch(a, block_paths, antithetic != 0, bf16,
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
                        row_stride, is_call, out);
  a.n_strikes = n_strikes;
  a.strike_from_table = 1;
  return launch(a, block_paths, antithetic != 0, bf16,
                static_cast<cudaStream_t>(stream));
}

}  // extern "C"
