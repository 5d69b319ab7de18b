"""Market constants of the reference pipeline that the CLI reads.

Counterpart: ``montecarlooptionspricer_tpu/config.py`` ``MarketDefaults``.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MarketDefaults:
    """r: risk-free rate; trading_days: steps per year (the default step
    count is floor(maturity * trading_days))."""

    r: float = 0.04
    trading_days: float = 252.0
