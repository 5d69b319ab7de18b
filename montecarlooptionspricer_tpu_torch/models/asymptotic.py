"""Asymptotic-analysis American estimator, per row (counterpart:
``montecarlooptionspricer_tpu/models/asymptotic.py``).

Paths are [rows, paths, steps + 1]; strike, maturity, sigma, dividend and
``is_call`` are [rows] tensors (or numbers, the same for every row).  The
boundary is a [rows, steps + 1] curve and each path's best exercise a
masked maximum.  Reference quirks kept: past eps = T - t > 1 the
boundary's square root has a negative argument, which the reference
turns into NaN and so an empty region (+inf for calls, -inf for puts
here); non-finite prices are skipped; the (r - D) correction applies
only for eps < 0.01.
"""

from __future__ import annotations

import torch

from ..ops.payoff import payoff
from ..ops.reductions import row_mean
from ..ops.rows import discount_curve, per_row
from ..ops.timegrid import step_mask_rows


def exercise_boundary(t, maturity, strike, r, dividend, sigma, is_call):
    """The early-exercise boundary B(t), broadcasting ``t`` against the
    per-row arguments (e.g. t [1, M] and the others [rows, 1])."""
    eps = maturity - t
    arg = eps * torch.log(1.0 / torch.clamp_min(eps, 1e-300))
    c0 = 0.5 * sigma * torch.sqrt(torch.clamp_min(arg, 0.0))
    correction = torch.where(eps < 0.01, 0.5 * (dividend - r) * eps, 0.0)
    boundary = torch.where(is_call, strike - c0 + correction,
                           strike + c0 + correction)
    invalid_fill = torch.where(is_call, torch.inf, -torch.inf)
    at_expiry = eps < 1e-10
    boundary = torch.where(at_expiry, strike, boundary)
    bad = (arg < 0.0) & ~at_expiry
    return torch.where(bad, invalid_fill, boundary)


def asymptotic_price(paths, r, strike, maturity, dt, is_call, sigma,
                     dividend, group=None) -> torch.Tensor:
    """[rows] means over paths of the best discounted payoff among the
    live steps where the path lies in the exercise region; with a process
    ``group`` over every rank's shard of the paths."""
    rows, _, m = paths.shape
    dev = paths.device

    def col(a, dtype=torch.float64):
        return per_row(a, rows, dev, torch.float32).to(dtype)[:, None]

    maturity = per_row(maturity, rows, dev)
    is_call = per_row(is_call, rows, dev, torch.bool)[:, None]
    valid_t = step_mask_rows(m, dt, maturity)               # [rows, M]
    # The boundary in float64, rounded once (card and host agree).
    t = torch.arange(m, dtype=torch.float64, device=dev) * dt
    boundary = exercise_boundary(t[None, :], col(maturity), col(strike), r,
                                 col(dividend), col(sigma),
                                 is_call).to(torch.float32)

    finite = torch.isfinite(paths)
    in_region = torch.where(is_call[:, None], paths > boundary[:, None, :],
                            paths < boundary[:, None, :])
    disc = discount_curve(r, m, dt, dev) * payoff(
        is_call[:, None], paths, col(strike, torch.float32)[:, None])
    mask = finite & in_region & valid_t[:, None, :]
    best = torch.amax(torch.where(mask, disc, 0.0), dim=-1)
    return row_mean(best, group)
