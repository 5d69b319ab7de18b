"""Geometric Brownian motion paths (counterpart:
``montecarlooptionspricer_tpu/models/gbm.py``): the H = 1/2, eta = 0
limit of the rBergomi model, used to hold the American estimators
against the binomial tree."""

from __future__ import annotations

import math
import torch

from ..ops import rng as rng_ops


def generate_paths(gen: torch.Generator, s0, sigma, r, n_steps: int,
                   n_paths: int, dt: float = 1.0 / 252.0) -> torch.Tensor:
    """Risk-neutral GBM prices [n_paths, n_steps + 1] on the generator's
    device, paths[:, 0] == s0: S_j = S_{j-1} exp((r - sigma^2/2) dt +
    sigma sqrt(dt) W_j), W drawn from ``gen``."""
    w = rng_ops.normal(gen, (n_paths, n_steps))
    drift = (r - 0.5 * sigma * sigma) * dt
    log_s = math.log(s0) + torch.cumsum(drift + sigma * math.sqrt(dt) * w,
                                        dim=-1)
    return torch.cat([torch.full((w.shape[0], 1), float(s0),
                                 device=w.device), torch.exp(log_s)], dim=-1)
