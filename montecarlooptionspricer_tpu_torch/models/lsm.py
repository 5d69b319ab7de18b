"""Longstaff-Schwartz backward induction (counterpart:
``montecarlooptionspricer_tpu/models/lsm.py``).

A Python loop over steps replaces the reference's ``lax.scan``; each step
is a handful of whole-column tensor ops, so the loop stays on the device
and never syncs.  Parity semantics kept from the reference:

* the regression targets are the realized carried values (the value
  matrix propagates max(immediate, continuation) backward);
* steps past maturity only discount;
* the ITM threshold is payoff > 1e-14, and a step with no ITM path skips
  the regression and only discounts.
"""

from __future__ import annotations

import math

import torch

from ..ops.payoff import payoff
from ..ops.reductions import global_mean
from ..ops.regression import PolyFit, eval_poly, fit_poly_masked
from ..ops.timegrid import step_mask

ITM_EPS = 1e-14


def _lsm_backward(paths, r, strike, maturity, dt, is_call: bool,
                  poly_order: int = 2):
    """(price, fits in forward step order) for paths [n, m]."""
    n_paths, m = paths.shape
    disc = math.exp(-r * dt)
    live = step_mask(m - 1, dt, maturity).tolist()
    v = payoff(is_call, paths[:, m - 1], strike)
    fits = [None] * (m - 1)
    for j in range(m - 2, -1, -1):
        s = paths[:, j]
        vd = v * disc
        p = payoff(is_call, s, strike)
        itm = (p > ITM_EPS).to(paths.dtype)
        fit = fit_poly_masked(s, vd, itm, poly_order)
        fits[j] = fit
        if not live[j]:
            v = vd
            continue
        cont = eval_poly(fit, s)
        v_exercised = torch.where(itm > 0, torch.maximum(p, cont), vd)
        v = torch.where(torch.sum(itm) > 0, v_exercised, vd)
    stacked = PolyFit(*(torch.stack([getattr(f, name) for f in fits])
                        for name in PolyFit._fields))
    return global_mean(v), stacked


def lsm_price(paths, r, strike, maturity, dt, is_call: bool,
              poly_order: int = 2) -> torch.Tensor:
    """American option price by LSM regression on paths [n, steps + 1]."""
    price, _ = _lsm_backward(paths, r, strike, maturity, dt, is_call,
                             poly_order)
    return price


def lsm_fit(paths, r, strike, maturity, dt, is_call: bool,
            poly_order: int = 2):
    """(price, fits): the LSM price and the per-step PolyFit, leading axis
    of length steps in forward order (index j covers step j), for use as
    an exercise policy on independent paths.  Fits at past-maturity steps
    are unused by the backward pass; consumers mask the live window."""
    return _lsm_backward(paths, r, strike, maturity, dt, is_call,
                         poly_order)
