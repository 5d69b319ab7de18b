"""Martingale-duality American estimator, per row (counterpart:
``montecarlooptionspricer_tpu/models/martingale.py``).

Primal/dual iterations on [rows, paths, M] paths with a polynomial
martingale surrogate per row:

  primal: each path's best discounted payoff over the live steps and its
          stop index (the first maximum; 0 when nothing is positive);
  dual:   each path's best of (discounted payoff - (M(S) - offset)),
          floored at 0;
  update: regress 0.5 * discPayoff at the stop index and 0.2 * discPayoff
          at (stop + M_row / 2) mod M_row on the basis, then offset =
          mean M(S0).

The price is 0.5 * (primal + the last dual).  The update's sample is
fixed by the primal, so the iterations reach their fixed point after one
update, and only the last dual is computed.  The discount clamps t at
maturity, and the update ignores the maturity mask at its second sample,
as the reference does.  M_row = n_steps + 1 is the row's own column count,
not the padded width, so a padded block wraps as its unpadded form.
"""

from __future__ import annotations

import torch

from ..ops.payoff import payoff
from ..ops.reductions import row_mean, row_sum
from ..ops.regression import PolyFit, eval_poly, fit_poly_masked
from ..ops.rows import discount_curve, per_row
from ..ops.timegrid import step_mask_rows


def martingale_price(paths, r, strike, maturity, dt, is_call,
                     poly_order: int = 2, max_iterations: int = 5,
                     n_steps=None, group=None) -> torch.Tensor:
    """[rows] martingale-duality prices of [rows, paths, M] blocks; with a
    process ``group`` the paths are this rank's shard, and the means and
    the surrogate's regression are pooled over the group's ranks."""
    rows, n, m = paths.shape
    dev = paths.device
    mat = per_row(maturity, rows, dev)
    m_act = (torch.full((rows,), m, dtype=torch.int64, device=dev)
             if n_steps is None
             else per_row(n_steps, rows, dev, torch.int64) + 1)
    df = discount_curve(r, m, dt, dev, maturity=mat)
    call = per_row(is_call, rows, dev, torch.bool)[:, None, None]
    dp = payoff(call, paths, per_row(strike, rows, dev)[:, None, None]) \
        * df[:, None, :]
    valid = step_mask_rows(m, dt, mat)[:, None, :]
    dpv = torch.where(valid, dp, -torch.inf)

    # Primal pass, the same for every iteration.  The stop index is the
    # first maximum, as JAX's argmax takes it.
    best = torch.amax(dpv, dim=-1)
    idx = torch.arange(m, device=dev)
    first_max = torch.amin(torch.where(dpv == best[..., None], idx, m),
                           dim=-1)
    stop = torch.where(best > 0.0, first_max, 0)
    primal = row_mean(torch.clamp_min(best, 0.0), group)

    s0 = paths[..., 0]
    j_other = torch.remainder(stop + (m_act // 2)[:, None], m_act[:, None])
    s_stop = torch.gather(paths, -1, stop[..., None])[..., 0]
    s_other = torch.gather(paths, -1, j_other[..., None])[..., 0]
    xs = torch.cat([s_stop, s_other], dim=-1)
    ys = torch.cat([0.5 * torch.gather(dp, -1, stop[..., None])[..., 0],
                    0.2 * torch.gather(dp, -1, j_other[..., None])[..., 0]],
                   dim=-1)
    del dp

    # The targets depend only on the primal's stop index, so every update
    # regresses the same sample and yields the same fit: the first
    # iteration's dual (zero martingale) is the primal, and every later
    # one uses that fit.  Only the last dual enters the price.
    if max_iterations < 2:
        dual = primal if max_iterations == 1 else torch.zeros_like(primal)
        return 0.5 * (primal + dual)
    fit = fit_poly_masked(xs, ys, torch.ones_like(xs), poly_order,
                          total=row_sum, group=group)
    offset = row_mean(eval_poly(PolyFit(fit.coeffs[:, None, :],
                                        fit.mu[:, None], fit.sd[:, None]),
                                s0), group)
    mval = eval_poly(PolyFit(fit.coeffs[:, None, None, :],
                             fit.mu[:, None, None], fit.sd[:, None, None]),
                     paths)
    cand = torch.where(valid, dpv - (mval - offset[:, None, None]),
                       -torch.inf)
    del mval
    dual = row_mean(torch.clamp_min(torch.amax(cand, dim=-1), 0.0), group)
    return 0.5 * (primal + dual)
