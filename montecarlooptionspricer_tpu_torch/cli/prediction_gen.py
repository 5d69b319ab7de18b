"""mcop-prediction-gen-torch: augment an options CSV with the four Monte
Carlo estimators' prices and the 20-day vol and momentum (counterpart:
``montecarlooptionspricer_tpu/cli/prediction_gen.py``, with its flags and
defaults, the reference's constants, plus ``--device``).

Runs on the CUDA device unless ``--device cpu`` is given; there is no
fallback.  ``--qmc`` drives each row's paths from a randomized Sobol set
(one base per bucket, a digital shift per row; with ``--antithetic`` it
exits 2).  ``--mesh-devices N`` shards each batch's rows over a mesh of N
processes, one a device (``parallel.make_mesh``): start N of them with
torchrun; a mesh larger than the world raises ValueError.  Rank 0 writes
the output.  ``--trace-dir`` writes a ``torch.profiler`` Chrome trace of
the run there.

  mcop-prediction-gen-torch --option-csv option_data.csv \\
      --spot-csv nasdaq_stock_data.csv --output-csv out.csv --device cpu
  torchrun --nproc-per-node 2 -m \\
      montecarlooptionspricer_tpu_torch.cli.prediction_gen --device cpu \\
      --mesh-devices 2 --output-csv out.csv
"""

from __future__ import annotations

import argparse
import logging
import sys

from ..config import MarketDefaults, PipelineConfig, PricingConfig
from ..utils import device_trace, enable_persistent_cache


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
                   help="devices to shard row batches over (0: no mesh; "
                        "N: one process a device, started by torchrun)")
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
                   help="write a torch.profiler Chrome trace of the run "
                        "here")
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
    enable_persistent_cache()
    args = build_parser().parse_args(argv)
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

    mesh = None
    if args.mesh_devices:
        from ..parallel import make_mesh
        mesh = make_mesh(args.mesh_devices, args.device)

    from ..pipeline.driver import run_pipeline
    with device_trace(args.trace_dir):
        return run_pipeline(config, pricing, market, mesh,
                            resume=args.resume, device=args.device)


if __name__ == "__main__":
    sys.exit(main())
