"""Configuration of the port: market constants, the PredictionGen
pipeline's pricing and file settings, and the augmented CSV's columns.

Counterpart: ``montecarlooptionspricer_tpu/config.py`` (``MarketDefaults``,
``PricingConfig``, ``PipelineConfig``, ``AUGMENTED_COLUMNS``), with the
reference's constants as defaults.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MarketDefaults:
    """Hard-coded market constants of the reference pipeline.

    r: risk-free rate.
    dt: time step in years.
    dividend: dividend yield used when a row's cell fails to parse.
    trading_days: steps per year (a row's step count is
        floor(maturity * trading_days)).
    calendar_days: days per year of the days-to-expiry column.
    """

    r: float = 0.04
    dt: float = 1.0 / 252.0
    dividend: float = 0.08
    trading_days: float = 252.0
    calendar_days: float = 365.0


@dataclasses.dataclass(frozen=True)
class PricingConfig:
    """Per-row Monte Carlo pricing of the pipeline.

    num_paths: paths per option row.
    num_branches: branches of the branching estimator's upper bound.
    poly_order: basis order of the LSM and martingale regressions.
    max_iterations: martingale primal/dual iterations.
    rows_per_batch: rows priced together in one batch.
    qmc: randomized quasi-Monte Carlo noise (a Sobol base per bucket, a
      digital shift per row).
    antithetic: half the draws per row, paired as (Z, W) / (-Z, -W).

    JAX's ``max_history_days`` and ``dtype`` fields, which nothing reads
    (the history cap is ``pipeline.spot.compute_max_days``'s), are left
    out.
    """

    num_paths: int = 250
    num_branches: int = 10
    poly_order: int = 2
    max_iterations: int = 5
    seed: int = 0
    rows_per_batch: int = 64
    qmc: bool = False
    antithetic: bool = False

    def __post_init__(self):
        if self.qmc and self.antithetic:
            raise ValueError("antithetic is incompatible with qmc (the "
                             "Sobol set has its own stratification)")
        if self.antithetic and self.num_paths % 2:
            raise ValueError("antithetic needs an even num_paths")


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """File names and failure-containment settings of the pipeline."""

    option_csv: str = "option_data.csv"
    spot_csv: str = "nasdaq_stock_data.csv"
    output_csv: str = "option_data_augmented.csv"
    error_log: str = "error_log.txt"
    diagnostic_csv: str = "spot_data_diagnostic.csv"
    backup_suffix: str = ".backup.csv"
    # Health check: 8 GiB peak RSS, 1e8 errors.
    max_memory_bytes: int = 8 * 1024**3
    max_errors: int = 100_000_000
    health_check_interval_s: float = 5.0
    keep_alive_interval_s: float = 30.0


# Columns the pipeline appends to the option CSV.
AUGMENTED_COLUMNS = (
    "asymptotic_prediction", "branching_prediction", "lsm_prediction",
    "martingale_prediction", "twenty_day_vol", "twenty_day_momentum",
)
