"""Pathwise Greeks by reverse-mode differentiation (counterpart:
``montecarlooptionspricer_tpu/models/greeks.py``).

Each estimator is a function of its market inputs built from torch ops,
so one ``torch.autograd.grad`` gives the pathwise sensitivities from the
same Monte Carlo draws as the price.  The derivative flows through path
generation (``rough_volatility.generate_paths``: s0, xi and r enter the
Euler recursion and the variance curve) and through the LSM pricer's
smooth operations, its regressions included; the kinks (the payoff's max,
the exercise indicator) are almost surely differentiable, so the estimator
is the standard pathwise one (for LSM the value function's envelope
derivative with the regression policy at its optimum).  Plain PyTorch on
the generator's device, as JAX computes them in XLA.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..ops import rng as rng_ops
from . import rough_volatility
from .lsm import lsm_price


@dataclasses.dataclass(frozen=True)
class Greeks:
    """First-order sensitivities of one Monte Carlo price.  ``vega_xi``
    is d price / d xi from ``lsm_greeks`` (the forward-variance level) and
    d price / d sigma from ``european_greeks`` (the GBM control)."""

    price: float
    delta: float      # d price / d s0
    vega_xi: float    # d price / d model vol level (see the class docstring)
    rho_rate: float   # d price / d r


def _leaves(device, *values) -> list:
    return [torch.tensor(float(v), dtype=torch.float32, device=device,
                         requires_grad=True) for v in values]


def lsm_greeks(gen: torch.Generator, s0, xi, h, eta, rho, r, strike,
               maturity, n_steps: int, n_paths: int, dt: float = 1.0 / 252.0,
               is_call: bool = False, poly_order: int = 2) -> Greeks:
    """Price and pathwise (delta, vega_xi, rho) of an American option
    priced by LSM on rBergomi paths drawn from ``gen`` (on its device),
    all from one reverse pass.  ``is_call`` defaults to a put, the
    package-wide convention (``european_greeks`` defaults to a call)."""
    s0_, xi_, r_ = _leaves(gen.device, s0, xi, r)
    paths = rough_volatility.generate_paths(gen, s0_, xi_, h, eta, rho, r_,
                                            n_steps, n_paths, dt)
    price = lsm_price(paths, r_, strike, maturity, dt, is_call, poly_order)
    d_s0, d_xi, d_r = torch.autograd.grad(price, (s0_, xi_, r_))
    return Greeks(price=float(price.detach()), delta=float(d_s0),
                  vega_xi=float(d_xi), rho_rate=float(d_r))


def european_greeks(gen: torch.Generator, s0, sigma, r, strike, maturity,
                    n_steps: int, n_paths: int, dt: Optional[float] = None,
                    is_call: bool = True) -> Greeks:
    """The European GBM control, checkable against Black-Scholes: the
    pathwise delta, vega (``vega_xi`` holds d price / d sigma) and rho of
    the discounted terminal payoff on paths drawn from ``gen``.  The paths
    diffuse exactly to maturity, so an explicit ``dt`` must satisfy
    n_steps * dt == maturity (ValueError otherwise, as in JAX)."""
    if dt is None:
        dt = maturity / n_steps
    elif abs(n_steps * dt - maturity) > 1e-9 * max(1.0, abs(maturity)):
        raise ValueError(
            f"n_steps * dt = {n_steps * dt} != maturity = {maturity}: the "
            "GBM control diffuses exactly to maturity (omit dt to derive "
            "it as maturity / n_steps)")
    s0_, sig_, r_ = _leaves(gen.device, s0, sigma, r)
    z = rng_ops.normal(gen, (n_paths, n_steps))
    inc = (r_ - 0.5 * sig_ ** 2) * dt + sig_ * math.sqrt(dt) * z
    st = s0_ * torch.exp(torch.sum(inc, dim=-1))
    pay = torch.clamp_min(st - strike if is_call else strike - st, 0.0)
    price = torch.exp(-r_ * maturity) * torch.mean(pay)
    d_s0, d_sig, d_r = torch.autograd.grad(price, (s0_, sig_, r_))
    return Greeks(price=float(price.detach()), delta=float(d_s0),
                  vega_xi=float(d_sig), rho_rate=float(d_r))
