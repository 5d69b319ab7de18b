"""mcop-price-torch: price an American option, a strike strip, and their
pathwise Greeks with the port's streaming engine (counterpart: the
single-strike, ``--strikes``, ``--greeks`` and ``--bounds`` branches of
``montecarlooptionspricer_tpu/cli/price.py``, with its JSON keys, and its
``--antithetic``, ``--control-variate``, ``--qmc`` and ``--qmc-fgn``
estimators).

Runs on the CUDA device unless ``--device cpu`` is given; there is no
fallback to another device or generator.  Prints one JSON line, with the
kernel family the run took (``engine.resolve_kernel_family``: "single",
"tiled", "factored" or "stream"); a non-finite number prints as null.
The path counts round as the JAX CLI's do: the chunk down to a multiple of
256 (at least 256), the path count down to a multiple of the chunk.

Examples (the second, past the single-tile horizon, runs the step-tiled
kernels; the third, past their 3,620 steps, the factored-DFT kernels of the
spectral law, up to 8,192 steps; the fourth prices a 21-strike strip with
implied vols, the fifth adds per-strike Greeks, the sixth prices with
antithetic pairs and the martingale control variate, the seventh prices
the strip's Greeks with antithetic pairs, the eighth a 1825-step strip on
the generic path stream, past the chain kernel's 512 steps, the ninth the
duality bracket [lower, upper] of one option from paired paths):
  mcop-price-torch --strike 105 --put --maturity 1.448 --steps 365 \\
      --paths 1e7 --chunk-paths 131072 --pilot-paths 131072
  mcop-price-torch --strike 105 --put --maturity 7.242 --steps 1825 \\
      --paths 1e7 --chunk-paths 131072 --pilot-paths 131072
  mcop-price-torch --strike 105 --put --maturity 15.873 --steps 4000 \\
      --paths 1e7 --chunk-paths 131072 --pilot-paths 131072
  mcop-price-torch --strikes 75,77.5,80,...,125 --put --maturity 1.448 \\
      --steps 365 --paths 1e7
  mcop-price-torch --strikes 95,100,105 --greeks --put --maturity 1.448
  mcop-price-torch --strike 105 --put --maturity 1.448 --steps 365 \\
      --paths 1e7 --antithetic --control-variate
  mcop-price-torch --strikes 95,100,105 --greeks --antithetic --put \\
      --maturity 1.448
  mcop-price-torch --strikes 75,77.5,80,...,125 --put --maturity 7.242 \\
      --steps 1825 --paths 1e7 --antithetic
  mcop-price-torch --strike 105 --put --maturity 1.448 --steps 365 \\
      --paths 1e7 --bounds --antithetic

``--qmc`` drives the price Brownian from a randomized Sobol set through
the kernels' noise-in entries (``--qmc-fgn`` the fGN planes too); as in
the JAX CLI it exits 2 with ``--antithetic``, ``--qmc-fgn`` without
``--qmc`` exits 2, and ``--qmc --greeks`` exits 2 (the jvp Greeks,
ROADMAP A10):
  mcop-price-torch --strike 105 --put --maturity 1.448 --steps 365 \\
      --paths 1e7 --qmc [--qmc-fgn]

``--antithetic`` pairs every quote: single strikes, ``--strikes``,
``--greeks`` and ``--bounds``.  ``--control-variate`` prices single
strikes, and with ``--greeks`` gives the plain Greeks, as the JAX CLI
does.  ``--bounds`` prints the JAX CLI's fields (price, lower, upper,
duality_gap and the two stderrs) and, as there, exits 2 with
``--strikes``, ``--greeks`` or ``--control-variate``.  ``--pathgen
xla`` prices on the generic path stream, as the JAX CLI's XLA generator
does (Greeks there need the jvp Greeks, ROADMAP A10).
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

from ..config import MarketDefaults

# Flags of the JAX CLI whose paths are not ported yet.
_NOT_PORTED = ("serve",)


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
                   help="pilot policy-fit paths (0 = min(65536, chunk)); "
                        "a multiple of 16, of 32 with --antithetic")
    p.add_argument("--strikes", default="",
                   help="comma-separated strike strip: prices, stderrs and "
                        "implied vols of one expiry on shared paths")
    p.add_argument("--greeks", action="store_true",
                   help="also delta, vega_xi, vega_eta, rho_rate and vega_h "
                        "(per strike with --strikes)")
    p.add_argument("--control-variate", action="store_true",
                   help="martingale control variate (e^{-rT} S_T, beta "
                        "fitted on the pilot); single strikes only")
    p.add_argument("--antithetic", action="store_true",
                   help="antithetic pairing: each chunk prices chunk/2 "
                        "pairs (N, W), (-N, -W) from half the draws, with "
                        "--strikes and --greeks too.  Incompatible with "
                        "--qmc")
    p.add_argument("--qmc", action="store_true",
                   help="randomized quasi-Monte Carlo price Brownian "
                        "(scrambled Sobol + per-chunk digital shift; "
                        "1-4.5x lower stderr per path by workload; the "
                        "kernels' noise-in entries)")
    p.add_argument("--qmc-fgn", action="store_true",
                   help="extend the Sobol set to the fGN planes "
                        "(3x dims): the right choice on high-vol-of-vol "
                        "markets where the variance rides the fGN; "
                        "requires --qmc")
    p.add_argument("--bounds", action="store_true",
                   help="duality bracket: the fitted policy's value (lower) "
                        "and the delta-hedge dual (upper) from the same "
                        "paths; single strikes only")
    p.add_argument("--pathgen", choices=("pallas", "xla"), default="pallas",
                   help="the hand-written kernels (pallas) or the generic "
                        "path stream (xla), as StreamConfig.pathgen_impl")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the kernels' "
                        "plain versions)")
    for name in _NOT_PORTED:
        p.add_argument("--" + name.replace("_", "-"), action="store_true",
                       help="not yet ported")
    return p


def _j(v):
    """JSON-safe number: null when not finite (a single chunk has no
    stderr; a deep-ITM put has no implied vol)."""
    return None if not math.isfinite(v) else round(float(v), 6)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    for name in _NOT_PORTED:
        if getattr(args, name):
            print(f"error: --{name.replace('_', '-')} is not yet ported to "
                  "the PyTorch/CUDA package (see ROADMAP.md)",
                  file=sys.stderr)
            return 2
    if args.antithetic and args.qmc:
        print("error: --antithetic is incompatible with --qmc (the Sobol "
              "set has its own stratification)", file=sys.stderr)
        return 2
    if args.paths < 1:
        print("error: --paths must be >= 1", file=sys.stderr)
        return 2
    if args.strikes and (args.control_variate or args.bounds):
        print("error: --control-variate/--bounds apply to single-strike "
              "pricing, not --strikes chains", file=sys.stderr)
        return 2
    if args.bounds and (args.greeks or args.control_variate):
        print("error: --bounds cannot combine with --greeks/"
              "--control-variate", file=sys.stderr)
        return 2

    from ..models import engine

    mkt = MarketDefaults()
    n_steps = args.steps or max(1, int(args.maturity * mkt.trading_days))
    n_paths = int(args.paths)
    # The JAX CLI's rounding: the chunk down to a multiple of 256 (which
    # the kernels' 16-path and 32-member blocks divide), at least 256, and
    # the path count down to a multiple of the chunk.
    block = 256
    chunk = max(block, (min(args.chunk_paths, n_paths) // block) * block)
    n_paths = max(chunk, (n_paths // chunk) * chunk)
    pilot = args.pilot_paths or min(1 << 16, chunk)
    unit = 32 if args.antithetic else 16
    if pilot < 1 or pilot % unit:
        print(f"error: --pilot-paths {pilot} must be a positive multiple of "
              f"{unit}, the kernels' path block"
              f"{' when paired' if args.antithetic else ''}",
              file=sys.stderr)
        return 2
    try:
        strikes = ([float(v) for v in args.strikes.split(",")]
                   if args.strikes else None)
        cfg = engine.StreamConfig(n_paths=n_paths, n_steps=n_steps,
                                  chunk_paths=chunk, pilot_paths=pilot,
                                  chunks_per_call=64,
                                  antithetic=args.antithetic,
                                  control_variate=args.control_variate,
                                  qmc=args.qmc, qmc_fgn=args.qmc_fgn,
                                  pathgen_impl=args.pathgen)
        market = dict(s0=args.s0, xi=args.xi, h=args.hurst, eta=args.eta,
                      rho=args.rho, r=args.r)
        t0 = time.time()
        if strikes:
            out, family = _price_chain(args, cfg, market, strikes, engine)
        else:
            out, family = _price_one(args, cfg, market, engine)
    except (ValueError, NotImplementedError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    out.update({"n_paths": n_paths, "n_steps": n_steps,
                "is_call": args.is_call, "kernel_family": family,
                "elapsed_s": round(time.time() - t0, 3)})
    print(json.dumps(out))
    return 0


def _price_one(args, cfg, market, engine) -> dict:
    pricer = engine.StreamingPricer(
        **market, strike=args.strike, maturity=args.maturity,
        is_call=args.is_call, config=cfg, device=args.device)
    if args.greeks:
        g, se = pricer.price_and_greeks(args.seed, with_stderr=True)
        out = {n: _j(v) for n, v in zip(engine.GREEK_ORDER, g)}
        out["stderrs"] = {n: _j(v) for n, v in zip(engine.GREEK_ORDER, se)}
        return out, pricer.kernel_family
    if args.bounds:
        lower, upper, lo_se, up_se = pricer.price_with_bounds(
            args.seed, with_stderr=True)
        return {"price": _j(lower), "lower": _j(lower), "upper": _j(upper),
                "duality_gap": _j(upper - lower), "lower_stderr": _j(lo_se),
                "upper_stderr": _j(up_se)}, pricer.kernel_family
    price, se = pricer.price(args.seed, with_stderr=True)
    return {"price": _j(price), "stderr": _j(se)}, pricer.kernel_family


def _price_chain(args, cfg, market, strikes, engine) -> dict:
    from ..models.closed_form import implied_vol

    chain = engine.StreamingChainPricer(
        **market, strikes=strikes, maturity=args.maturity,
        is_call=args.is_call, config=cfg, device=args.device)
    out = {"strikes": strikes}
    if args.greeks:
        # Whole-smile risk from one shared path stream: a [K] row per
        # output, keyed as the JAX CLI keys them.
        g, se = chain.price_and_greeks(args.seed, with_stderr=True)
        names = ("prices",) + engine.GREEK_ORDER[1:]
        out.update({n: [_j(v) for v in row] for n, row in zip(names, g)})
        out["stderrs"] = {n: [_j(v) for v in row]
                          for n, row in zip(names, se)}
        prices = g[0]
    else:
        prices, stderrs = chain.price(args.seed, with_stderr=True)
        out["prices"] = [_j(v) for v in prices]
        out["stderrs"] = [_j(v) for v in stderrs]
    # null outside the European no-arbitrage bracket, e.g. deep-ITM
    # American puts.
    out["implied_vols"] = [
        _j(implied_vol(v, args.s0, k, args.r, args.maturity, args.is_call))
        for v, k in zip(prices, strikes)]
    return out, chain.kernel_family


if __name__ == "__main__":
    sys.exit(main())
