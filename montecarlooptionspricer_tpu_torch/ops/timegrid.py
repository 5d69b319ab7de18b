"""Integer-exact time grid (counterpart:
``montecarlooptionspricer_tpu/ops/timegrid.py``).

A step j is live when ``j * dt <= maturity``.  In float32, ``j * dt`` can
land on the wrong side of an on-grid maturity, so the mask compares the
integer j with ``floor(maturity / dt + slack)`` instead.  The slack sum is
formed in float64 and rounded to float32 before the floor, exactly as the
reference does with Python-float arguments.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def last_valid_step(dt: float, maturity: float) -> float:
    """Largest j with j * dt <= maturity (in exact arithmetic).  The slack
    (1e-4 plus 1e-6 of the ratio) absorbs a maturity that arrives as
    float32(n * dt) while staying far below one step out to ~1e5 steps."""
    ratio = maturity / dt
    return float(math.floor(np.float32(ratio + 1e-4 + ratio * 1e-6)))


def step_mask(n: int, dt: float, maturity: float,
              device=None) -> torch.Tensor:
    """Boolean [n] mask of steps j = 0..n-1 with j * dt <= maturity."""
    return torch.arange(n, device=device) <= last_valid_step(dt, maturity)


def step_mask_rows(n: int, dt: float, maturity: torch.Tensor) -> torch.Tensor:
    """[rows, n] mask of steps j < n with j * dt <= maturity[row] for a
    float32 [rows] ``maturity`` on the device.  The slack sum is formed in
    float32, as the JAX package forms it for a traced float32 maturity
    (its pipeline's rows), so the two masks agree bit for bit."""
    ratio = maturity / dt
    last = torch.floor(ratio + 1e-4 + ratio * 1e-6)
    return (torch.arange(n, device=maturity.device)[None, :]
            <= last[:, None])
