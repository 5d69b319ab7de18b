// The quadratic exercise policy of one cell, shared by the QUAD forms of K2
// (csrc/pathgen.cu, through QuadRows), K7 (csrc/pathgen_tiled.cu), K9
// (csrc/pathgen_factored.cu) and K5 (csrc/chain.cu, through QuadCell).
//
// Counterpart: montecarlooptionspricer_tpu/models/pathgen_pallas.py:
// _policy_value:277 (K2; K7's _policy_tile and K9's _priced_step test the
// same cell) and _policy_value_minreduce:302 (K5).  The table is
// pathgen_pallas.policy_rows' [8, s_pad] layout, row stride `stride`
// floats: c0, c1, c2 (the fit's standardized coefficients), mu, sd, eps,
// the discount and the strike.  At column c and price s:
//   p    = max(+-(s - strike), 0)
//   z    = (s - mu) / sd            (K5: (s - mu) * (1 / sd), where JAX
//                                    hoists the reciprocal per step; here
//                                    each cell takes it with the same
//                                    IEEE rounding)
//   cont = (c2 z + c1) z + c0
// and the cell exercises iff p > eps and p >= cont, worth p * disc.
//
// Every operation rounds to float32 on its own (__fmul_rn, __fadd_rn,
// __fdiv_rn, __frcp_rn): the JAX interpreter and the plain PyTorch versions
// (models/pathgen_cuda.py:quadratic_stops) round each step, and nvcc would
// otherwise contract the polynomial into fused multiply-adds.  A decision
// can then differ from the plain version's only where s itself does, by an
// ulp of exp inside the float32 root band.
#pragma once

#include <cuda_runtime.h>

namespace mcop {

// The payoff max(+-(s - strike), 0).
__device__ __forceinline__ float quad_payoff(float s, float strike,
                                             int is_call) {
  return fmaxf(is_call ? __fsub_rn(s, strike) : __fsub_rn(strike, s), 0.0f);
}

// The continuation value (c2 z + c1) z + c0, coefficient i read as
// coef(i) where the polynomial first needs it.
template <class Coef>
__device__ __forceinline__ float quad_cont(Coef coef, float z) {
  return __fadd_rn(__fmul_rn(__fadd_rn(__fmul_rn(coef(2), z), coef(1)), z),
                   coef(0));
}

// K7's and K9's cell: whether the path at price s exercises at column c,
// and then its value.
__device__ __forceinline__ bool quad_exercise(const float* tab,
                                              long long stride, int c,
                                              float s, int is_call,
                                              float* value) {
  const float p = quad_payoff(s, __ldg(tab + 7 * stride + c), is_call);
  if (!(p > __ldg(tab + 5 * stride + c))) return false;
  const float d = __fsub_rn(s, __ldg(tab + 3 * stride + c));
  const float sd = __ldg(tab + 4 * stride + c);
  const float z = __fdiv_rn(d, sd);
  const float cont =
      quad_cont([&](int i) { return __ldg(tab + i * stride + c); }, z);
  if (!(p >= cont)) return false;
  *value = __fmul_rn(p, __ldg(tab + 6 * stride + c));
  return true;
}

// K2's decision (csrc/pathgen.cu) tests one column against many paths: each
// lane reads its column's rows once per tile from the staged [8][stride]
// rows, and a cell's test is quad_exercise's, arithmetic and all: p =
// quad_payoff(s, strike) > eps and p >= quad_rows_cont (IEEE division, as
// _policy_value:277 divides); its value, p * disc, is taken at the hit.
struct QuadRows {
  float coef[3], mu, sd, eps, strike;
};

__device__ __forceinline__ QuadRows quad_rows(const float* tab, int stride,
                                              int c) {
  return {{tab[c], tab[stride + c], tab[2 * stride + c]},
          tab[3 * stride + c],
          tab[4 * stride + c],
          tab[5 * stride + c],
          tab[7 * stride + c]};
}

// The continuation value of K2's cell q at price s.
__device__ __forceinline__ float quad_rows_cont(const QuadRows& q, float s) {
  const float z = __fdiv_rn(__fsub_rn(s, q.mu), q.sd);
  return quad_cont([&](int i) { return q.coef[i]; }, z);
}

// K5's sweep (csrc/chain.cu) tests one column of one strike against many
// paths, so it reads the column's rows once and takes the reciprocal of sd
// once.
struct QuadCell {
  float coef[3], mu, rsd, eps, strike;
};

__device__ __forceinline__ QuadCell quad_cell(const float* tab,
                                              long long stride, int c) {
  return {{__ldg(tab + c), __ldg(tab + stride + c),
           __ldg(tab + 2 * stride + c)},
          __ldg(tab + 3 * stride + c),
          __frcp_rn(__ldg(tab + 4 * stride + c)),
          __ldg(tab + 5 * stride + c),
          __ldg(tab + 7 * stride + c)};
}

// Whether the path at price s exercises at K5's cell q.
__device__ __forceinline__ bool quad_cell_exercises(const QuadCell& q,
                                                    float s, int is_call) {
  const float p = quad_payoff(s, q.strike, is_call);
  const float z = __fmul_rn(__fsub_rn(s, q.mu), q.rsd);
  return (p > q.eps) &
         (p >= quad_cont([&](int i) { return q.coef[i]; }, z));
}

}  // namespace mcop
