// The quadratic exercise policy of one cell, shared by the QUAD forms of K2
// (csrc/pathgen.cu), K7 (csrc/pathgen_tiled.cu), K9
// (csrc/pathgen_factored.cu) and K5 (csrc/chain.cu).
//
// Counterpart: montecarlooptionspricer_tpu/models/pathgen_pallas.py:
// _policy_value:277 (K2; K7's _policy_tile and K9's _priced_step test the
// same cell) and _policy_value_minreduce:302 (K5).  The table is
// pathgen_pallas.policy_rows' [8, s_pad] layout, row stride `stride`
// floats: c0, c1, c2 (the fit's standardized coefficients), mu, sd, eps,
// the discount and the strike.  At column c and price s:
//   p    = max(+-(s - strike), 0)
//   z    = (s - mu) / sd            (RECIP: (s - mu) * (1 / sd), K5's form,
//                                    where JAX hoists the reciprocal per
//                                    step; here each cell takes it with the
//                                    same IEEE rounding)
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

template <bool RECIP>
__device__ __forceinline__ bool quad_exercise(const float* tab,
                                              long long stride, int c,
                                              float s, int is_call,
                                              float* value) {
  const float strike = __ldg(tab + 7 * stride + c);
  const float p =
      fmaxf(is_call ? __fsub_rn(s, strike) : __fsub_rn(strike, s), 0.0f);
  if (!(p > __ldg(tab + 5 * stride + c))) return false;
  const float d = __fsub_rn(s, __ldg(tab + 3 * stride + c));
  const float sd = __ldg(tab + 4 * stride + c);
  const float z = RECIP ? __fmul_rn(d, __frcp_rn(sd)) : __fdiv_rn(d, sd);
  const float cont = __fadd_rn(
      __fmul_rn(__fadd_rn(__fmul_rn(__ldg(tab + 2 * stride + c), z),
                          __ldg(tab + stride + c)),
                z),
      __ldg(tab + c));
  if (!(p >= cont)) return false;
  *value = __fmul_rn(p, __ldg(tab + 6 * stride + c));
  return true;
}

}  // namespace mcop
