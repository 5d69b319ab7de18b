"""mcop-evaluate-nn-torch: MC-dropout evaluation of a trained meta-model
(counterpart: ``montecarlooptionspricer_tpu/cli/evaluate_nn.py``, with its
flags and defaults, plus ``--device``): per-row mean and +-stds interval
from ``--n-samples`` dropout draws, all draws of a batch of rows in one
forward; the results CSV; MAE, RMSE and the interval's coverage.

Runs on the CUDA device unless ``--device cpu`` is given; there is no
fallback.  The JAX CLI's persistent compilation cache has no counterpart:
the meta-model builds no kernel.

  mcop-evaluate-nn-torch --test-csv test_data.csv \\
      --model-file bayesian_model --calibrated-intervals --device cpu
"""

from __future__ import annotations

import argparse
import logging
import sys
import time

import numpy as np

from ..config import EvalConfig, INPUT_COLUMNS, TARGET_COLUMN, TrainConfig
from ..utils import enable_persistent_cache, setup_logging

log = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    d = EvalConfig()
    p = argparse.ArgumentParser(prog="mcop-evaluate-nn-torch")
    p.add_argument("--test-csv", default="test_data.csv")
    p.add_argument("--model-file", default="bayesian_model")
    p.add_argument("--results-csv", default="evaluation_results.csv")
    p.add_argument("--n-samples", type=int, default=d.n_samples)
    p.add_argument("--stds", type=float, default=d.stds)
    p.add_argument("--hidden-dim", type=int, default=TrainConfig().hidden_dim)
    p.add_argument("--batch-size", type=int, default=512)
    p.add_argument("--skip-bad-rows", action="store_true",
                   help="drop ragged/non-numeric rows (PredictionGen "
                        "sentinel-fills malformed inputs verbatim) instead "
                        "of erroring like the reference's std::stof")
    p.add_argument("--calibrated-intervals", action="store_true",
                   help="widen intervals with the MDN's own aleatoric "
                        "variance (sqrt(sigma_epi^2 + sigma_alea^2)): the "
                        "reference's +-stds interval uses only the "
                        "MC-dropout spread of the first mixture mean and "
                        "discards the model's noise estimate.  Off by "
                        "default: reference semantics")
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

    x_test, y_test = read_csv(args.test_csv, list(INPUT_COLUMNS),
                              TARGET_COLUMN,
                              skip_bad_rows=args.skip_bad_rows)
    trainer = BayesianTrainer(len(INPUT_COLUMNS), args.hidden_dim,
                              config=TrainConfig(input_dim=len(INPUT_COLUMNS),
                                                 hidden_dim=args.hidden_dim),
                              device=args.device)
    trainer.load_model(args.model_file)

    n = x_test.shape[0]
    if n == 0:
        log.error("No data rows in %s", args.test_csv)
        return 1
    sum_err = sum_sq = 0.0
    coverage_count = 0
    t0 = time.time()
    with open(args.results_csv, "w") as out:
        out.write("Index,Actual,Mean,Lower,Upper,Error,InsideInterval\n")
        for lo in range(0, n, args.batch_size):
            hi = min(lo + args.batch_size, n)
            draws = trainer.predict_mc(x_test[lo:hi],
                                       args.n_samples).cpu().numpy()
            mean = draws.mean(axis=0)
            std = draws.std(axis=0)
            if args.calibrated_intervals:
                alea = trainer.aleatoric_std(x_test[lo:hi]).cpu().numpy()
                std = np.sqrt(std * std + alea * alea)
            lower = mean - args.stds * std
            upper = mean + args.stds * std
            for j in range(hi - lo):
                actual = y_test[lo + j]
                err = abs(mean[j] - actual)
                inside = lower[j] <= actual <= upper[j]
                sum_err += err
                sum_sq += err * err
                coverage_count += int(inside)
                out.write(f"{lo + j},{actual:g},{mean[j]:g},{lower[j]:g},"
                          f"{upper[j]:g},{err:g},{int(inside)}\n")
            done = hi / n
            eta = (time.time() - t0) / max(done, 1e-9) - (time.time() - t0)
            log.info("progress %.1f%% ETA %.1fs", done * 100.0, eta)

    mae = sum_err / n
    rmse = float(np.sqrt(sum_sq / n))
    coverage = 100.0 * coverage_count / n
    log.info("=== EVALUATION RESULTS ===")
    log.info("Total Samples: %d", n)
    log.info("Mean Absolute Error (MAE): %.4f", mae)
    log.info("Root Mean Squared Error (RMSE): %.4f", rmse)
    log.info("Coverage (%.1f std dev%s): %.2f%%", args.stds,
             ", calibrated epi+alea" if args.calibrated_intervals else "",
             coverage)
    log.info("Detailed results saved in '%s'", args.results_csv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
