"""Configuration of the port: market constants, the PredictionGen
pipeline's pricing and file settings, the augmented CSV's columns, and the
Bayesian meta-model's training and evaluation settings and feature schema.

Counterpart: ``montecarlooptionspricer_tpu/config.py`` (``MarketDefaults``,
``PricingConfig``, ``PipelineConfig``, ``AUGMENTED_COLUMNS``,
``TrainConfig``, ``EvalConfig``, ``INPUT_COLUMNS``, ``TARGET_COLUMN``),
with the reference's constants as defaults.
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
class TrainConfig:
    """Training of the Bayesian meta-model.

    Epochs up to ``warmup_epochs`` train on the MSE of the mean of the
    mixture means, later ones on the mixture density's negative
    log-likelihood; ``l2_lambda`` weighs the L2 term and
    ``grad_clip_norm`` the global-norm clip (``nn/trainer.py``).
    ``hidden_dim`` is accepted for the reference's constructor; the funnel
    widths are fixed.
    """

    input_dim: int = 17
    hidden_dim: int = 64
    num_epochs: int = 100
    batch_size: int = 256
    learning_rate: float = 3e-4
    warmup_epochs: int = 5
    l2_lambda: float = 1e-7
    grad_clip_norm: float = 1.0
    num_mixtures: int = 5
    seed: int = 0
    checkpoint_path: str = "checkpoint"
    model_path: str = "bayesian_model"


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """Evaluation of the meta-model: MC-dropout draws per row and the
    interval's half-width in standard deviations."""

    n_samples: int = 100
    stds: float = 3.0


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

# Input features and target of the meta-model, columns of the augmented CSV.
INPUT_COLUMNS = (
    "underlying_last", "dte", "strike_distance_pct", "delta", "gamma",
    "vega", "theta", "rho", "iv", "volume", "dividend",
    "asymptotic_prediction", "branching_prediction", "lsm_prediction",
    "martingale_prediction", "twenty_day_vol", "twenty_day_momentum",
)
TARGET_COLUMN = "last"
