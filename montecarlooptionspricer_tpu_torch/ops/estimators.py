"""Rough-volatility parameters estimated from a price history
(counterpart: ``montecarlooptionspricer_tpu/ops/estimators.py``).

Host work in float64, once per option row on a history of at most 1825
points.  ``estimate_params`` and ``hurst_exponent_dfa`` run on the port's
native host engine (``csrc/host/features.cpp``, built at first use by
``kernels/host_build.py``), whose sums run in the JAX package's engine's
order, so the two agree to the bit.  The NumPy forms stay beside them as
their plain versions, ``estimate_params_plain`` and
``hurst_exponent_dfa_plain``: the tests and the card check hold the engine
against them to 1e-12 relative (H to 1e-9); the main path never calls
them.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..kernels import host_build


def log_returns(prices: np.ndarray) -> np.ndarray:
    """log(p_i / p_{i-1})."""
    prices = np.asarray(prices, dtype=np.float64)
    return np.log(prices[1:] / prices[:-1])


def _variance(v: np.ndarray) -> float:
    """Sample variance with n-1 denominator."""
    if v.size < 2:
        return 0.0
    return float(np.var(v, ddof=1))


def _covariance(x: np.ndarray, y: np.ndarray) -> float:
    """Sample covariance with n-1 denominator."""
    if x.size != y.size or x.size < 2:
        return 0.0
    return float(np.cov(x, y, ddof=1)[0, 1])


def estimate_r(logrets: np.ndarray, dt_yr: float = 1.0 / 252.0) -> float:
    """Annualized drift (unused by the pipeline, which fixes r)."""
    return float(np.mean(logrets)) / dt_yr if logrets.size else 0.0


def estimate_xi(logrets: np.ndarray, dt_yr: float = 1.0 / 252.0) -> float:
    """Annualized variance: the forward variance level xi."""
    return _variance(logrets) / dt_yr


def _detrend_segment(segment: np.ndarray) -> np.ndarray:
    """Remove the least-squares linear trend fitted against t = 1..n."""
    n = segment.size
    if n < 2:
        return segment
    t = np.arange(1, n + 1, dtype=np.float64)
    tm, ym = t.mean(), segment.mean()
    den = np.sum((t - tm) ** 2)
    if abs(den) < 1e-14:
        return segment
    slope = np.sum((t - tm) * (segment - ym)) / den
    intercept = ym - slope * tm
    return segment - (slope * t + intercept)


def hurst_exponent_dfa(data_in: np.ndarray) -> float:
    """Detrended-fluctuation-analysis Hurst estimate on the native engine;
    0.5 below the two windows the slope needs."""
    return host_build.load("features").hurst_dfa(
        np.ascontiguousarray(data_in, dtype=np.float64))


def hurst_exponent_dfa_plain(data_in: np.ndarray) -> float:
    """The plain version of ``hurst_exponent_dfa``: demean, cumulate,
    detrend in dyadic windows 4, 8, ..., n/4, then the log-log slope of
    the RMS fluctuation against the window size."""
    data = np.asarray(data_in, dtype=np.float64).copy()
    if data.size < 2:
        return 0.5
    data -= data.mean()
    data = np.cumsum(data)

    log_w, log_f = [], []
    w = 4
    max_w = data.size // 4
    while w <= max_w:
        flucts = []
        for start in range(0, data.size - w + 1, w):
            seg = _detrend_segment(data[start:start + w].copy())
            flucts.append(np.sqrt(np.mean(seg * seg)))
        mf = float(np.mean(flucts)) if flucts else 0.0
        if mf > 0.0:
            log_w.append(np.log(w))
            log_f.append(np.log(mf))
        w *= 2

    if len(log_w) < 2:
        return 0.5
    lw = np.asarray(log_w)
    lf = np.asarray(log_f)
    n = lw.size
    slope = ((n * np.sum(lw * lf) - lw.sum() * lf.sum())
             / (n * np.sum(lw * lw) - lw.sum() ** 2))
    return float(slope)


def estimate_h(logrets: np.ndarray) -> float:
    """Hurst exponent by DFA, in NumPy (``hurst_exponent_dfa_plain``)."""
    return hurst_exponent_dfa_plain(logrets)


def estimate_eta(logrets: np.ndarray, h: float = 0.0) -> float:
    """Vol of vol = 2 * stdev of the log returns (``h`` is accepted and
    ignored, as in the reference)."""
    del h
    return 2.0 * float(np.sqrt(_variance(logrets)))


def estimate_rho(logrets: np.ndarray) -> float:
    """Spot/vol correlation corr(r, r^2), set to -0.3 when positive."""
    sq = logrets * logrets
    denom = np.sqrt(_variance(logrets) * _variance(sq))
    rho = _covariance(logrets, sq) / denom if denom > 0 else 0.0
    if rho > 0.0:
        rho = -0.3
    return float(rho)


@dataclasses.dataclass(frozen=True)
class RBergomiParams:
    """Estimated rough-Bergomi parameters plus the market rate."""

    s0: float
    xi: float
    h: float
    eta: float
    rho: float
    r: float = 0.04

    @property
    def rho_complement(self) -> float:
        return float(np.sqrt(max(0.0, 1.0 - self.rho * self.rho)))


def estimate_params(historical_prices: np.ndarray, r: float = 0.04,
                    dt_yr: float = 1.0 / 252.0) -> RBergomiParams:
    """All parameters from a price history on the native engine; raises
    ValueError on fewer than two points."""
    s0, xi, h, eta, rho = host_build.load("features").estimate_params(
        np.ascontiguousarray(historical_prices, dtype=np.float64), dt_yr)
    return RBergomiParams(s0=s0, xi=xi, h=h, eta=eta, rho=rho, r=r)


def estimate_params_plain(historical_prices: np.ndarray, r: float = 0.04,
                          dt_yr: float = 1.0 / 252.0) -> RBergomiParams:
    """The plain version of ``estimate_params``, in NumPy."""
    historical_prices = np.ascontiguousarray(historical_prices,
                                             dtype=np.float64)
    if historical_prices.size < 2:
        raise ValueError("Historical prices vector too small.")
    rets = log_returns(historical_prices)
    return RBergomiParams(
        s0=float(historical_prices[-1]),
        xi=estimate_xi(rets, dt_yr),
        h=estimate_h(rets),
        eta=estimate_eta(rets),
        rho=estimate_rho(rets),
        r=r,
    )
