"""Branching-process American estimator, per row: the mean of a
first-positive lower bound and a sub-simulation upper bound (counterpart:
``montecarlooptionspricer_tpu/models/branching.py``).

Paths are [rows, paths, M]; the per-row arguments are [rows] tensors or
numbers.  The upper bound's "best future payoff from column k" is a
reverse cumulative maximum of the discounted payoffs, computed once, and
the branch continuation a gather of it at column t + 1 on randomly drawn
paths.  The branches accumulate one [rows, paths, T] plane at a time, as
the JAX package's loop does: the whole [rows, paths, T, B] index tensor
of the 2,048-step bucket is ten times a plane.

The branch indices come from ``rp``: a [rows, paths, T, B] integer tensor
(the test seam, JAX's ``rp`` with a row axis), or a callable that returns
branch b's [rows, paths, T] plane (the seeded path, each row drawing from
its own generator).
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from ..ops.payoff import payoff
from ..ops.reductions import row_mean
from ..ops.rows import discount_curve, per_row
from ..ops.timegrid import step_mask_rows

BranchIndices = Union[torch.Tensor, Callable[[int], torch.Tensor]]


def _discounted_payoffs(paths, r, strike, dt, is_call):
    rows, _, m = paths.shape
    dev = paths.device
    k = per_row(strike, rows, dev)[:, None, None]
    call = per_row(is_call, rows, dev, torch.bool)[:, None, None]
    return discount_curve(r, m, dt, dev) * payoff(call, paths, k)


def _exercise_window(paths, dt, maturity, exercise_times, n_steps):
    """(ex [T] indices, valid [rows, T]): the listed exercise times that
    are live (t <= maturity) and, when ``n_steps`` is given, below the
    row's own horizon (a padded block's columns past it are not
    exercise times)."""
    rows, _, m = paths.shape
    dev = paths.device
    ex = (torch.arange(m - 1, device=dev) if exercise_times is None
          else torch.as_tensor(exercise_times, device=dev))
    valid = step_mask_rows(m, dt, per_row(maturity, rows, dev))[:, ex]
    if n_steps is not None:
        valid = valid & (ex[None, :] < per_row(n_steps, rows, dev,
                                               torch.int64)[:, None])
    return ex, valid


def lower_bound(paths, r, strike, maturity, dt, is_call,
                exercise_times=None, n_steps=None,
                group=None) -> torch.Tensor:
    """[rows] first-positive stopping values: each path stops at the first
    live exercise time with a strictly positive discounted payoff (0 when
    none).  ``exercise_times`` defaults to every column but the last.
    ``group``: the mean runs over every rank's shard of the paths."""
    ex, valid = _exercise_window(paths, dt, maturity, exercise_times,
                                 n_steps)
    dp = _discounted_payoffs(paths, r, strike, dt, is_call)[..., ex]
    pos = valid[:, None, :] & (dp > 0.0)
    n_ex = ex.shape[0]
    # The first positive column: the least index among them (ties cannot
    # arise), n_ex when there is none.
    idx = torch.arange(n_ex, device=paths.device)
    first = torch.amin(torch.where(pos, idx, n_ex), dim=-1)
    val = torch.gather(dp, -1, torch.clamp_max(first, n_ex - 1)[..., None])
    return row_mean(torch.where(first < n_ex, val[..., 0], 0.0), group)


def upper_bound(paths, r, strike, maturity, dt, is_call, num_branches: int,
                exercise_times=None, rp: Optional[BranchIndices] = None,
                n_steps=None, group=None) -> torch.Tensor:
    """[rows] sub-simulation upper bounds.  At each live exercise time the
    value is max(discounted payoff, continuation), the continuation being
    the mean over ``num_branches`` drawn paths of their best discounted
    payoff from the next column on (0 at the row's final exercise time,
    n_steps - 1 when ``n_steps`` is given); a path's bound is its best
    such value, floored at 0.  With a process ``group`` the paths are this
    rank's shard: the branches draw among them (``rp`` indexes the
    shard's paths, as JAX's branches do under ``shard_map``), and the mean
    runs over every rank's."""
    if rp is None:
        raise ValueError("upper_bound needs branch indices rp: a [rows, "
                         "paths, T, B] tensor or a callable of the branch")
    rows, _, m = paths.shape
    dev = paths.device
    dp_all = _discounted_payoffs(paths, r, strike, dt, is_call)
    live = step_mask_rows(m, dt, per_row(maturity, rows, dev))
    g = torch.where(live[:, None, :], dp_all, -torch.inf)
    revmax = torch.flip(torch.cummax(torch.flip(g, dims=(-1,)), dim=-1)[0],
                        dims=(-1,))
    revmax0 = torch.clamp_min(revmax, 0.0)
    del g, revmax

    ex, valid = _exercise_window(paths, dt, maturity, exercise_times,
                                 n_steps)
    n_ex = ex.shape[0]
    dp = dp_all[..., ex]
    del dp_all
    rev_next = revmax0[..., torch.clamp_max(ex + 1, m - 1)]
    del revmax0
    cont = torch.zeros_like(rev_next)
    for b in range(num_branches):
        plane = rp(b) if callable(rp) else rp[..., b]
        cont += torch.gather(rev_next, 1, plane.to(torch.int64))
    cont /= num_branches
    if n_steps is None:
        has_future = (torch.arange(n_ex, device=dev) < n_ex - 1)[None, :]
    else:
        has_future = ex[None, :] < (per_row(n_steps, rows, dev, torch.int64)
                                    - 1)[:, None]
    cont = torch.where(has_future[:, None, :], cont, 0.0)
    better = torch.maximum(dp, cont)
    best = torch.amax(torch.where(valid[:, None, :], better, 0.0), dim=-1)
    return row_mean(torch.clamp_min(best, 0.0), group)


def branching_price(paths, r, strike, maturity, dt, is_call,
                    num_branches: int, exercise_times=None,
                    rp: Optional[BranchIndices] = None,
                    n_steps=None, group=None) -> torch.Tensor:
    """[rows] 0.5 * (lower + upper), each over the ranks of ``group``."""
    lo = lower_bound(paths, r, strike, maturity, dt, is_call, exercise_times,
                     n_steps=n_steps, group=group)
    up = upper_bound(paths, r, strike, maturity, dt, is_call, num_branches,
                     exercise_times, rp=rp, n_steps=n_steps, group=group)
    return 0.5 * (lo + up)
