"""mcop-prediction-gen-torch: augment an options CSV with the four Monte
Carlo estimators' prices and the 20-day vol and momentum (counterpart:
``montecarlooptionspricer_tpu/cli/prediction_gen.py``, with its flags and
defaults, the reference's constants, plus ``--device``).

Runs on the CUDA device unless ``--device cpu`` is given; there is no
fallback.  ``--qmc`` drives each row's paths from a randomized Sobol set
(one base per bucket, a digital shift per row; with ``--antithetic`` it
exits 2).  ``--mesh-devices`` above 1 and ``--trace-dir`` (ROADMAP A15)
are not ported and exit 2.

  mcop-prediction-gen-torch --option-csv option_data.csv \\
      --spot-csv nasdaq_stock_data.csv --output-csv out.csv --device cpu
"""

from __future__ import annotations

import argparse
import logging
import sys

from ..config import MarketDefaults, PipelineConfig, PricingConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mcop-prediction-gen-torch",
        description="Augment an options CSV with four Monte Carlo price "
                    "estimates + realized vol/momentum features "
                    "(PyTorch/CUDA port).")
    d_pipe, d_price, d_mkt = PipelineConfig(), PricingConfig(), MarketDefaults()
    p.add_argument("--option-csv", default=d_pipe.option_csv)
    p.add_argument("--spot-csv", default=d_pipe.spot_csv)
    p.add_argument("--output-csv", default=d_pipe.output_csv)
    p.add_argument("--error-log", default=d_pipe.error_log)
    p.add_argument("--num-paths", type=int, default=d_price.num_paths,
                   help="MC paths per row (reference: 250)")
    p.add_argument("--num-branches", type=int, default=d_price.num_branches)
    p.add_argument("--poly-order", type=int, default=d_price.poly_order)
    p.add_argument("--max-iterations", type=int,
                   default=d_price.max_iterations)
    p.add_argument("--rows-per-batch", type=int,
                   default=d_price.rows_per_batch,
                   help="rows priced together in one batch")
    p.add_argument("--seed", type=int, default=d_price.seed)
    p.add_argument("--r", type=float, default=d_mkt.r)
    p.add_argument("--dividend", type=float, default=d_mkt.dividend)
    p.add_argument("--mesh-devices", type=int, default=0,
                   help="devices to shard row batches over (0 or 1: one "
                        "device; more is not ported, ROADMAP A15)")
    p.add_argument("--qmc", action="store_true",
                   help="drive path generation with randomized quasi-Monte "
                        "Carlo (scrambled Sobol): several-fold lower price "
                        "RMSE at the 250-path default budget")
    p.add_argument("--antithetic", action="store_true",
                   help="antithetic path pairing per row: half the draws, "
                        "negatively correlated pair members")
    p.add_argument("--resume", action="store_true",
                   help="append to an existing output CSV, continuing from "
                        "the first unwritten row")
    p.add_argument("--trace-dir", default="",
                   help="profiler trace directory (not ported, ROADMAP A15)")
    p.add_argument("--max-memory-gb", type=float,
                   default=d_pipe.max_memory_bytes / 1024**3,
                   help="health-check kill threshold on peak RSS")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the same "
                        "plain PyTorch path on the host)")
    return p


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: "
                               "%(message)s")
    args = build_parser().parse_args(argv)
    if args.mesh_devices > 1 or args.trace_dir:
        print("error: --mesh-devices > 1 and --trace-dir are not yet ported "
              "to the PyTorch/CUDA package (ROADMAP A15)", file=sys.stderr)
        return 2
    config = PipelineConfig(option_csv=args.option_csv,
                            spot_csv=args.spot_csv,
                            output_csv=args.output_csv,
                            error_log=args.error_log,
                            max_memory_bytes=int(args.max_memory_gb
                                                 * 1024**3))
    try:
        pricing = PricingConfig(num_paths=args.num_paths,
                                num_branches=args.num_branches,
                                poly_order=args.poly_order,
                                max_iterations=args.max_iterations,
                                rows_per_batch=args.rows_per_batch,
                                seed=args.seed, qmc=args.qmc,
                                antithetic=args.antithetic)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    market = MarketDefaults(r=args.r, dividend=args.dividend)

    from ..pipeline.driver import run_pipeline
    return run_pipeline(config, pricing, market, resume=args.resume,
                        device=args.device)


if __name__ == "__main__":
    sys.exit(main())
