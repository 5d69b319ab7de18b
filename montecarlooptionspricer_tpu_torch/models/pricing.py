"""The four PredictionGen estimators on one batch of rows (counterpart:
``montecarlooptionspricer_tpu/models/pricing.py``, whose ``price_all`` the
JAX pipeline maps over rows with ``jax.vmap``).

Exercise times are every step 0..n_pad - 1 of the padded block; the
asymptotic estimator is exact under padding already (every padded column
lies past maturity), and the other three take the rows' true horizons.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from .asymptotic import asymptotic_price
from .branching import BranchIndices, branching_price
from .lsm import lsm_price_rows
from .martingale import martingale_price

ESTIMATORS = ("asymptotic", "branching", "lsm", "martingale")


@dataclasses.dataclass(frozen=True)
class PricerSpec:
    """Arguments of the four estimators.  strike, maturity, is_call, sigma
    (the asymptotic boundary's vol, the 20-day realized vol) and dividend
    are numbers or [rows] tensors; the counts are shared by the batch."""

    r: float = 0.04
    strike: Any = 100.0
    maturity: Any = 1.0
    dt: float = 1.0 / 252.0
    is_call: Any = False
    sigma: Any = 0.2
    dividend: Any = 0.08
    num_branches: int = 10
    poly_order: int = 2
    max_iterations: int = 5


def price_all(paths: torch.Tensor, spec: PricerSpec, rp: BranchIndices,
              n_steps: Optional[torch.Tensor] = None,
              group=None) -> torch.Tensor:
    """[rows, 4] prices (asymptotic, branching, lsm, martingale) of
    [rows, paths, n_pad + 1] blocks; ``rp`` gives the branching
    estimator's branch indices, ``n_steps`` [rows] the true horizons of a
    padded block (None: every column is a real step).  With a process
    ``group`` (JAX's ``axis_name``) the paths axis is this rank's shard:
    every mean and regression pools over the group's ranks, so each rank
    returns the same prices."""
    s = spec
    return torch.stack([
        asymptotic_price(paths, s.r, s.strike, s.maturity, s.dt, s.is_call,
                         s.sigma, s.dividend, group),
        branching_price(paths, s.r, s.strike, s.maturity, s.dt, s.is_call,
                        s.num_branches, rp=rp, n_steps=n_steps, group=group),
        lsm_price_rows(paths, s.r, s.strike, s.maturity, s.dt, s.is_call,
                       s.poly_order, n_steps=n_steps, group=group),
        martingale_price(paths, s.r, s.strike, s.maturity, s.dt, s.is_call,
                         s.poly_order, s.max_iterations, n_steps=n_steps,
                         group=group),
    ], dim=-1)
