"""mcop-price-torch: price one American option with the port's streaming
engine (counterpart: the single-strike branch of
``montecarlooptionspricer_tpu/cli/price.py``).

Runs on the CUDA device unless ``--device cpu`` is given; there is no
fallback to another device or generator.  Prints one JSON line.

Example:
  mcop-price-torch --strike 105 --put --maturity 1.448 --steps 365 \\
      --paths 1e7 --chunk-paths 131072 --pilot-paths 131072
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

from ..config import MarketDefaults

# Flags of the JAX CLI whose paths are not ported yet.
_NOT_PORTED = ("strikes", "greeks", "bounds", "serve", "qmc", "antithetic",
               "control_variate")


def build_parser() -> argparse.ArgumentParser:
    mkt = MarketDefaults()
    p = argparse.ArgumentParser(
        prog="mcop-price-torch",
        description="Price an American option on rough-Bergomi paths with "
                    "fit-then-stream LSM (PyTorch/CUDA port).")
    p.add_argument("--s0", type=float, default=100.0)
    p.add_argument("--xi", type=float, default=0.04,
                   help="forward variance level")
    p.add_argument("--hurst", type=float, default=0.1)
    p.add_argument("--eta", type=float, default=1.5, help="vol of vol")
    p.add_argument("--rho", type=float, default=-0.4)
    p.add_argument("--r", type=float, default=mkt.r)
    p.add_argument("--strike", type=float, default=100.0)
    p.add_argument("--maturity", type=float, default=1.0, help="years")
    p.add_argument("--steps", type=int, default=0,
                   help="time steps (default floor(maturity*252))")
    p.add_argument("--paths", type=float, default=1e6)
    p.add_argument("--put", dest="is_call", action="store_false")
    p.add_argument("--call", dest="is_call", action="store_true")
    p.set_defaults(is_call=False)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--chunk-paths", type=int, default=1 << 17)
    p.add_argument("--pilot-paths", type=int, default=0,
                   help="pilot policy-fit paths (0 = min(65536, chunk))")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the kernels' "
                        "plain versions)")
    for name in _NOT_PORTED:
        flag = "--" + name.replace("_", "-")
        if name == "strikes":
            p.add_argument(flag, default="", help="not yet ported")
        else:
            p.add_argument(flag, action="store_true", help="not yet ported")
    return p


def _j(v):
    """JSON-safe number: null for NaN (a single chunk has no stderr)."""
    return None if not math.isfinite(v) else round(float(v), 6)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    for name in _NOT_PORTED:
        if getattr(args, name):
            print(f"error: --{name.replace('_', '-')} is not yet ported to "
                  "the PyTorch/CUDA package (see ROADMAP.md)",
                  file=sys.stderr)
            return 2
    if args.paths < 1:
        print("error: --paths must be >= 1", file=sys.stderr)
        return 2

    from ..models import engine

    mkt = MarketDefaults()
    n_steps = args.steps or max(1, int(args.maturity * mkt.trading_days))
    n_paths = int(args.paths)
    # The chunk must divide the path count and the kernels' path block
    # (a multiple of 16); round both down, to at least one block.
    block = 16
    chunk = max(block, (min(args.chunk_paths, n_paths) // block) * block)
    n_paths = max(chunk, (n_paths // chunk) * chunk)
    pilot = args.pilot_paths or min(1 << 16, chunk)
    pilot = max(block, pilot // block * block)
    try:
        cfg = engine.StreamConfig(n_paths=n_paths, n_steps=n_steps,
                                  chunk_paths=chunk, pilot_paths=pilot,
                                  chunks_per_call=64)
        t0 = time.time()
        pricer = engine.StreamingPricer(
            args.s0, args.xi, args.hurst, args.eta, args.rho, args.r,
            args.strike, args.maturity, args.is_call, cfg,
            device=args.device)
        price, se = pricer.price(args.seed, with_stderr=True)
    except (ValueError, NotImplementedError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    out = {"price": _j(price), "stderr": _j(se), "n_paths": n_paths,
           "n_steps": n_steps, "is_call": args.is_call,
           "elapsed_s": round(time.time() - t0, 3)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
