"""Spot-price histories and the per-row 20-day features (counterpart:
``montecarlooptionspricer_tpu/pipeline/spot.py``).

* dates are M/D/YYYY;
* the spot CSV is wide (Date,TICK1,TICK2,...), tickers lowercased,
  unparsable cells skipped;
* a row's history window is 10x / 6x / 4x its days to expiry, capped at
  1825 calendar days, walked back day by day over the dates present;
* the 20-day realized vol is annualized from the biased variance, the
  momentum the sum of the 20 log returns, on the port's native host
  engine (``csrc/host/features.cpp``, equal to the JAX package's engine to
  the bit); ``twenty_day_vol_and_momentum_plain`` is its NumPy plain
  version, which the tests and the card check hold it against.
"""

from __future__ import annotations

import datetime
import logging
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..kernels import host_build
from .csv_io import read_table

log = logging.getLogger(__name__)

SpotData = Dict[str, Dict[int, float]]


def parse_date_mmddyyyy(s: str) -> Optional[datetime.date]:
    """'M/D/YYYY' -> date; None on garbage."""
    try:
        parts = s.strip().split("/")
        if len(parts) != 3:
            return None
        month, day, year = int(parts[0]), int(parts[1]), int(parts[2])
        return datetime.date(year, month, day)
    except (ValueError, TypeError):
        return None


def date_to_yyyymmdd(d: datetime.date) -> int:
    return d.year * 10000 + d.month * 100 + d.day


def load_spot_prices(path: str) -> SpotData:
    """Wide CSV (header Date,TICK1,TICK2,...) -> {ticker: {yyyymmdd: px}};
    empty when the file cannot be read."""
    out: SpotData = {}
    try:
        tickers, rows = read_table(path)
    except (OSError, ValueError) as e:
        log.error("Cannot open %s: %s", path, e)
        return out
    for tokens in rows:
        if len(tokens) < 2:
            continue
        d = parse_date_mmddyyyy(tokens[0])
        if d is None:
            continue
        ymd = date_to_yyyymmdd(d)
        for i in range(1, min(len(tokens), len(tickers))):
            ticker = tickers[i]
            if ticker == "Date" or not ticker:
                continue
            try:
                px = float(tokens[i])
            except ValueError:
                continue
            out.setdefault(ticker.lower(), {})[ymd] = px
    log.info("Loaded spot data from %s (%d tickers)", path, len(out))
    return out


def compute_max_days(dte: int) -> int:
    """History window: 10x dte (<= 60 days), 6x (61-180), 4x (> 180),
    capped at 1825 calendar days."""
    factor = 10
    if 60 < dte <= 180:
        factor = 6
    elif dte > 180:
        factor = 4
    return min(factor * dte, 1825)


def fetch_spot_history(spot_data: SpotData, ticker: str,
                       quote_date: datetime.date, dte: int) -> List[float]:
    """Finite prices on the dates present from max_days back to the quote
    date, oldest first."""
    daily = spot_data.get(ticker.lower())
    if not daily:
        return []
    history: List[float] = []
    for back in range(compute_max_days(dte), -1, -1):
        d = quote_date - datetime.timedelta(days=back)
        if d.year < 1970:
            continue
        px = daily.get(date_to_yyyymmdd(d))
        if px is not None and np.isfinite(px):
            history.append(px)
    return history


def twenty_day_vol_and_momentum(hist: List[float]) -> Tuple[float, float]:
    """(annualized 20-day realized vol, 20-day momentum) on the native
    engine: (0, 0) below 21 points; a return with a non-positive price or
    a non-finite log is 0.  Only the last 21 points cross into the
    engine."""
    return host_build.load("features").vol_momentum(hist[-21:])


def twenty_day_vol_and_momentum_plain(
        hist: List[float]) -> Tuple[float, float]:
    """The plain version of ``twenty_day_vol_and_momentum``, in NumPy."""
    if len(hist) < 21:
        return 0.0, 0.0
    window = np.asarray(hist[-21:], dtype=np.float64)
    log_rets = np.zeros(20)
    for i in range(20):
        p0, p1 = window[i], window[i + 1]
        if p0 > 0.0 and p1 > 0.0:
            lr = np.log(p1 / p0)
            log_rets[i] = lr if np.isfinite(lr) else 0.0
    mean = log_rets.mean()
    var = max(0.0, float(np.mean(log_rets ** 2)) - mean * mean)
    return float(np.sqrt(var) * np.sqrt(252.0)), float(log_rets.sum())
