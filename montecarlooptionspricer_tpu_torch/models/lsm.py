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

Two forms share the step body (``_exercise_step``).  ``lsm_fit`` is the
engine's pilot fit on one path matrix (a strike strip when ``strike`` is a
[K] tensor), with the live window a host list.  ``lsm_price_rows`` is the
PredictionGen form: [rows, paths, n_pad + 1] blocks with per-row strike,
maturity, option type and step count, the live window a [rows, steps]
tensor, padded steps identities, and its sums ``row_sum``'s, so a row's
price has the same bits whatever batch it is priced in.
"""

from __future__ import annotations

import math

import torch

from ..ops.payoff import payoff
from ..ops.reductions import global_mean, mean_last, psum_if, row_mean, row_sum
from ..ops.regression import PolyFit, eval_poly, fit_poly_masked
from ..ops.rows import per_row
from ..ops.timegrid import step_mask, step_mask_rows
from ..utils.profiling import count, span

ITM_EPS = 1e-14


def _exercise_step(v, s, k, disc: float, is_call, poly_order: int,
                   decide: bool = True, total=torch.sum, group=None):
    """One backward step on carried values v [..., n] and prices s:
    (discounted carry, the step's value, the step's fit).  The value is
    max(payoff, fitted continuation) on ITM paths, or the carry where
    ``decide`` is false or no path is ITM (per leading index; on any rank
    of ``group``, whose ranks hold shards of the paths and fit the pooled
    moments)."""
    vd = v * disc
    p = payoff(is_call, s, k)
    itm = (p > ITM_EPS).to(s.dtype)
    fit = fit_poly_masked(s, vd, itm, poly_order, total=total, group=group)
    if not decide:
        return vd, vd, fit
    cont = eval_poly(PolyFit(fit.coeffs[..., None, :], fit.mu[..., None],
                             fit.sd[..., None]), s)
    v_exercised = torch.where(itm > 0, torch.maximum(p, cont), vd)
    any_itm = psum_if(total(itm, dim=-1, keepdim=True), group) > 0
    return vd, torch.where(any_itm, v_exercised, vd), fit


def _pad_fit(like) -> PolyFit:
    """The fit left at a padded step: coefficients 0 about mu 0, sd 1
    (never read: the policy cannot exercise past the live horizon)."""
    return PolyFit(torch.zeros_like(like.coeffs), torch.zeros_like(like.mu),
                   torch.ones_like(like.sd))


def _lsm_backward(paths, r, strike, maturity, dt, is_call: bool,
                  poly_order: int = 2, n_steps=None, group=None):
    """(price, fits in forward step order) for paths [n, m].  ``strike`` is
    a number, or a [K] tensor of strikes sharing the paths: then every
    per-path quantity carries a leading strike axis, the price is [K] and
    each fit field gains a leading [K] axis, with the same launches per
    step as one strike.  ``n_steps`` (a host int) marks the steps j >=
    n_steps of a padded block as identities (no discount, no regression
    effect), as JAX's padded scan does: the loop runs over the live steps
    only and the padded steps keep ``_pad_fit``.  ``r`` may be a 0-d
    tensor, whose gradient then flows through the discount.  With a
    process ``group`` the paths are this rank's shard: every regression
    pools its moments, and the price its mean, over the group's ranks."""
    n_paths, m = paths.shape
    disc = (torch.exp(-r * dt) if isinstance(r, torch.Tensor)
            else math.exp(-r * dt))
    live = step_mask(m - 1, dt, maturity).tolist()
    k = torch.as_tensor(strike, dtype=paths.dtype, device=paths.device)
    k = k[..., None]                       # [1] or [K, 1] against [n]
    fits = [None] * (m - 1)
    top = m - 1 if n_steps is None else min(int(n_steps), m - 1)
    if top < 1:
        raise ValueError(f"n_steps={n_steps} must be >= 1")
    strikes = k.shape[0] if k.dim() == 2 else 1
    count("lsm.steps", top)
    count("lsm.regressions", top * strikes)
    with span("mcop.lsm", steps=top, strikes=strikes):
        v = payoff(is_call, paths[:, m - 1], k)
        for j in range(top - 1, -1, -1):
            _, v, fits[j] = _exercise_step(v, paths[:, j], k, disc, is_call,
                                           poly_order, decide=live[j],
                                           group=group)
        fits[top:] = [_pad_fit(fits[0])] * (m - 1 - top)
        stacked = PolyFit(*(torch.stack([getattr(f, name) for f in fits],
                                        dim=k.dim() - 1)
                            for name in PolyFit._fields))
        if k.dim() == 1:
            return global_mean(v, group), stacked
        return mean_last(v, group), stacked


def lsm_price(paths, r, strike, maturity, dt, is_call: bool,
              poly_order: int = 2, n_steps=None, group=None) -> torch.Tensor:
    """American option price by LSM regression on paths [n, steps + 1].
    ``n_steps`` marks the columns past a padded block's true horizon as
    padding (identity steps): the block prices as its first n_steps + 1
    columns would.  Differentiable in the paths and in a 0-d tensor ``r``
    (``models.greeks.lsm_greeks``).  ``group``: the paths are this rank's
    shard of the group's (``_lsm_backward``)."""
    if n_steps is not None:
        return lsm_price_rows(paths[None], r, strike, maturity, dt, is_call,
                              poly_order, n_steps=n_steps, group=group)[0]
    price, _ = _lsm_backward(paths, r, strike, maturity, dt, is_call,
                             poly_order, group=group)
    return price


def lsm_price_rows(paths, r, strike, maturity, dt, is_call,
                   poly_order: int = 2, n_steps=None,
                   group=None) -> torch.Tensor:
    """[rows] LSM prices of [rows, paths, M] blocks, with per-row strike,
    maturity, option type and step count ([rows] tensors or numbers).
    The loop runs over the M - 1 steps, each one set of launches across
    the rows; steps j >= n_steps[row] leave that row's values as they
    are (JAX's padding semantics), and past-maturity steps only
    discount.  With a process ``group`` the paths axis is this rank's
    shard, and the moments and means are pooled over the group."""
    rows, _, m = paths.shape
    dev = paths.device
    disc = math.exp(-r * dt)
    k = per_row(strike, rows, dev)[:, None]
    call = per_row(is_call, rows, dev, torch.bool)[:, None]
    live = step_mask_rows(m - 1, dt, per_row(maturity, rows, dev))
    padded = None if n_steps is None else (
        torch.arange(m - 1, device=dev)[None, :]
        >= per_row(n_steps, rows, dev, torch.int64)[:, None])
    count("lsm.steps", m - 1)
    count("lsm.regressions", (m - 1) * rows)
    with span("mcop.lsm", steps=m - 1, strikes=rows):
        v = payoff(call, paths[..., m - 1], k)
        for j in range(m - 2, -1, -1):
            vd, v_reg, _ = _exercise_step(v, paths[..., j], k, disc, call,
                                          poly_order, total=row_sum,
                                          group=group)
            v_new = torch.where(live[:, j:j + 1], v_reg, vd)
            v = v_new if padded is None else torch.where(
                padded[:, j:j + 1], v, v_new)
        return row_mean(v, group)


def lsm_fit(paths, r, strike, maturity, dt, is_call: bool,
            poly_order: int = 2, n_steps=None, group=None):
    """(price, fits): the LSM price and the per-step PolyFit, leading axis
    of length steps in forward order (index j covers step j), for use as
    an exercise policy on independent paths.  Fits at past-maturity steps
    are unused by the backward pass; consumers mask the live window.
    ``n_steps`` (a host int, the bucketed block's live horizon; counterpart
    of JAX's traced ``n_steps``) makes the steps j >= n_steps identities:
    the price and the live fits are the padded scan's, and the padded
    steps' fits are placeholders (``lsm_policy_path_values`` with
    ``n_steps_live`` never reads them).

    With a [K] strike tensor it fits the whole strip on the same paths in
    one backward pass (the counterpart of ``jax.vmap`` over strikes of the
    JAX function): the price is [K] and each field of the fit is [K,
    steps, ...].  With a process ``group`` (JAX's ``axis_name``) the paths
    are this rank's shard of the pilot, and each step's regression pools
    its moments over the group's ranks: every rank ends with the same
    fits."""
    return _lsm_backward(paths, r, strike, maturity, dt, is_call,
                         poly_order, n_steps, group)
