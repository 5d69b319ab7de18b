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
    """(price, fits in forward step order) for paths [n, m].  ``strike`` is
    a number, or a [K] tensor of strikes sharing the paths: then every
    per-path quantity carries a leading strike axis, the price is [K] and
    each fit field gains a leading [K] axis, with the same launches per
    step as one strike."""
    n_paths, m = paths.shape
    disc = math.exp(-r * dt)
    live = step_mask(m - 1, dt, maturity).tolist()
    k = torch.as_tensor(strike, dtype=paths.dtype, device=paths.device)
    k = k[..., None]                       # [1] or [K, 1] against [n]
    v = payoff(is_call, paths[:, m - 1], k)
    fits = [None] * (m - 1)
    for j in range(m - 2, -1, -1):
        s = paths[:, j]
        vd = v * disc
        p = payoff(is_call, s, k)
        itm = (p > ITM_EPS).to(paths.dtype)
        fit = fit_poly_masked(s, vd, itm, poly_order)
        fits[j] = fit
        if not live[j]:
            v = vd
            continue
        cont = eval_poly(PolyFit(fit.coeffs[..., None, :], fit.mu[..., None],
                                 fit.sd[..., None]), s)
        v_exercised = torch.where(itm > 0, torch.maximum(p, cont), vd)
        # Per strike: a step with no ITM path only discounts.
        v = torch.where(torch.sum(itm, dim=-1, keepdim=True) > 0,
                        v_exercised, vd)
    stacked = PolyFit(*(torch.stack([getattr(f, name) for f in fits],
                                    dim=k.dim() - 1)
                        for name in PolyFit._fields))
    if k.dim() == 1:
        return global_mean(v), stacked
    return torch.mean(v, dim=-1), stacked


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
    are unused by the backward pass; consumers mask the live window.

    With a [K] strike tensor it fits the whole strip on the same paths in
    one backward pass (the counterpart of ``jax.vmap`` over strikes of the
    JAX function): the price is [K] and each field of the fit is [K,
    steps, ...]."""
    return _lsm_backward(paths, r, strike, maturity, dt, is_call,
                         poly_order)
