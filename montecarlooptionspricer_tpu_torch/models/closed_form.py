"""Black-Scholes prices, implied volatility and the binomial American
value (counterpart: ``norm_cdf``, ``black_scholes``, ``implied_vol`` and
``binomial_american`` of ``montecarlooptionspricer_tpu/models/
closed_form.py``, copied so the port imports nothing of the JAX package).
Float64 on the host; the chain's implied vols come from here, and the
binomial tree is the GBM-limit oracle of the duality bounds.
"""

from __future__ import annotations

import math

import numpy as np


def norm_cdf(x) -> float:
    return 0.5 * (1.0 + math.erf(float(x) / math.sqrt(2.0)))


def black_scholes(s0, strike, r, sigma, maturity, is_call: bool,
                  dividend: float = 0.0) -> float:
    """European Black-Scholes price with continuous dividend yield.

    sigma <= 0 with maturity > 0 returns the exact zero-vol limit, the
    discounted forward intrinsic max(0, +-(s0 e^{-qT} - K e^{-rT}))."""
    s0, strike = float(s0), float(strike)
    if maturity <= 0:
        return max(0.0, s0 - strike) if is_call else max(0.0, strike - s0)
    if sigma <= 0:
        fwd = s0 * np.exp(-dividend * maturity)
        k_disc = strike * np.exp(-r * maturity)
        return max(0.0, fwd - k_disc) if is_call else max(0.0, k_disc - fwd)
    sq = sigma * np.sqrt(maturity)
    d1 = (np.log(s0 / strike) + (r - dividend + 0.5 * sigma**2) * maturity) / sq
    d2 = d1 - sq
    if is_call:
        return (s0 * np.exp(-dividend * maturity) * norm_cdf(d1)
                - strike * np.exp(-r * maturity) * norm_cdf(d2))
    return (strike * np.exp(-r * maturity) * norm_cdf(-d2)
            - s0 * np.exp(-dividend * maturity) * norm_cdf(-d1))


def implied_vol(price, s0, strike, r, maturity, is_call: bool,
                dividend: float = 0.0, tol: float = 1e-8,
                max_iter: int = 100) -> float:
    """Black-Scholes implied volatility by bracketed bisection.  NaN when
    the price lies outside the no-arbitrage bracket (e.g. a deep-ITM
    American put worth more than any European)."""
    price = float(price)
    lo_price = black_scholes(s0, strike, r, 1e-9, maturity, is_call, dividend)
    hi = 5.0
    hi_price = black_scholes(s0, strike, r, hi, maturity, is_call, dividend)
    if not lo_price - tol <= price <= hi_price + tol:
        return float("nan")
    lo = 1e-9
    for _ in range(max_iter):
        mid = 0.5 * (lo + hi)
        if black_scholes(s0, strike, r, mid, maturity, is_call,
                         dividend) < price:
            lo = mid
        else:
            hi = mid
        if hi - lo < tol:
            break
    return 0.5 * (lo + hi)


def binomial_american(s0, strike, r, sigma, maturity, is_call: bool,
                      steps: int = 2000, dividend: float = 0.0) -> float:
    """Cox-Ross-Rubinstein binomial tree for American options (test
    oracle)."""
    dt = maturity / steps
    u = np.exp(sigma * np.sqrt(dt))
    d = 1.0 / u
    disc = np.exp(-r * dt)
    p = (np.exp((r - dividend) * dt) - d) / (u - d)
    p = min(max(p, 0.0), 1.0)

    j = np.arange(steps + 1)
    prices = s0 * u ** (steps - j) * d ** j
    if is_call:
        values = np.maximum(0.0, prices - strike)
    else:
        values = np.maximum(0.0, strike - prices)

    for n in range(steps - 1, -1, -1):
        j = np.arange(n + 1)
        prices = s0 * u ** (n - j) * d ** j
        values = disc * (p * values[:-1] + (1.0 - p) * values[1:])
        if is_call:
            exercise = np.maximum(0.0, prices - strike)
        else:
            exercise = np.maximum(0.0, strike - prices)
        values = np.maximum(values, exercise)
    return float(values[0])
