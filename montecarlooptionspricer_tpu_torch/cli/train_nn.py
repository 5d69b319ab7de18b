"""mcop-train-nn-torch: train the Bayesian meta-model on feature CSVs
(counterpart: ``montecarlooptionspricer_tpu/cli/train_nn.py``, with its
flags and defaults, plus ``--device``): read the train, validation and
test CSVs, train with a checkpoint every epoch (resumed when the
checkpoint exists), save the model, smoke-test a single and an MC-dropout
prediction, and report the validation and test MSE.

Runs on the CUDA device unless ``--device cpu`` is given; there is no
fallback.  Checkpoints and model files are ``.pt`` archives.  The JAX CLI's
persistent compilation cache has no counterpart: the meta-model builds no
kernel.

  mcop-train-nn-torch --train-csv train_data.csv --valid-csv valid_data.csv \\
      --test-csv test_data.csv --num-epochs 7 --device cpu
"""

from __future__ import annotations

import argparse
import logging
import sys

import numpy as np

from ..config import INPUT_COLUMNS, TARGET_COLUMN, TrainConfig
from ..utils import enable_persistent_cache, setup_logging

log = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    d = TrainConfig()
    p = argparse.ArgumentParser(prog="mcop-train-nn-torch")
    p.add_argument("--train-csv", default="train_data.csv")
    p.add_argument("--valid-csv", default="valid_data.csv")
    p.add_argument("--test-csv", default="test_data.csv")
    p.add_argument("--model-file", default="bayesian_model")
    p.add_argument("--checkpoint-file", default="checkpoint")
    p.add_argument("--num-epochs", type=int, default=d.num_epochs)
    p.add_argument("--batch-size", type=int, default=d.batch_size)
    p.add_argument("--learning-rate", type=float, default=d.learning_rate)
    p.add_argument("--hidden-dim", type=int, default=d.hidden_dim)
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--mc-samples", type=int, default=100)
    p.add_argument("--skip-bad-rows", action="store_true",
                   help="drop ragged/non-numeric rows (PredictionGen "
                        "sentinel-fills malformed inputs verbatim) instead "
                        "of erroring like the reference's std::stof")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the same "
                        "PyTorch path on the host)")
    return p


def main(argv=None) -> int:
    setup_logging()
    enable_persistent_cache()
    args = build_parser().parse_args(argv)

    from ..nn.data import read_csv
    from ..nn.trainer import BayesianTrainer

    input_columns = list(INPUT_COLUMNS)
    log.info("Reading training data...")
    x_train, y_train = read_csv(args.train_csv, input_columns, TARGET_COLUMN,
                                skip_bad_rows=args.skip_bad_rows)
    log.info("Reading validation data...")
    x_valid, y_valid = read_csv(args.valid_csv, input_columns, TARGET_COLUMN,
                                skip_bad_rows=args.skip_bad_rows)
    log.info("Reading test data...")
    x_test, y_test = read_csv(args.test_csv, input_columns, TARGET_COLUMN,
                              skip_bad_rows=args.skip_bad_rows)

    cfg = TrainConfig(input_dim=len(input_columns),
                      hidden_dim=args.hidden_dim,
                      num_epochs=args.num_epochs, batch_size=args.batch_size,
                      learning_rate=args.learning_rate, seed=args.seed)
    trainer = BayesianTrainer(len(input_columns), args.hidden_dim,
                              config=cfg, device=args.device)

    log.info("Starting training...")
    trainer.train_model(x_train, y_train, num_epochs=args.num_epochs,
                        batch_size=args.batch_size, lr=args.learning_rate,
                        checkpoint_path=args.checkpoint_file)
    trainer.save_model(args.model_file)

    loaded = BayesianTrainer(len(input_columns), args.hidden_dim,
                             config=cfg, device=args.device)
    loaded.load_model(args.model_file)

    feats = x_test[0]
    pred, _, _ = loaded.meta_model_prediction(feats, n_samples=1)
    log.info("Single Prediction for first test sample: %.6f (actual %.6f)",
             pred, y_test[0])
    mc_mean, mc_lo, mc_hi = loaded.meta_model_prediction(
        feats, n_samples=args.mc_samples)
    log.info("%dx MC-Dropout Prediction: %.6f (3-sigma interval: "
             "[%.6f, %.6f])", args.mc_samples, mc_mean, mc_lo, mc_hi)

    def mse(x, y):
        pred = loaded.forward(x)[:, 0].cpu().numpy()
        return float(np.mean((pred - y) ** 2))

    log.info("Validation MSE: %.6f", mse(x_valid, y_valid))
    log.info("Test MSE: %.6f", mse(x_test, y_test))
    log.info("Training and evaluation complete.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
