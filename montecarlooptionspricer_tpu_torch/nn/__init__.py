"""The Bayesian meta-model: the network, its trainer, checkpoints and
feature CSVs (counterpart: ``montecarlooptionspricer_tpu/nn/``)."""

from .bnn import BayesianMetaModelNN, RealNVPFlow, split_mdn  # noqa: F401
from .trainer import BayesianTrainer, mdn_nll, warmup_mse  # noqa: F401
from . import checkpoint  # noqa: F401
