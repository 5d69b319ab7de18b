"""mcop-price-torch: price an American option, a strike strip, and their
pathwise Greeks with the port's streaming engine, or serve quotes (counterpart:
``montecarlooptionspricer_tpu/cli/price.py``, every branch and flag, with
its JSON keys, and its ``--antithetic``, ``--control-variate``, ``--qmc``
and ``--qmc-fgn`` estimators).

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
the JAX CLI it exits 2 with ``--antithetic``, and ``--qmc-fgn`` without
``--qmc`` exits 2:
  mcop-price-torch --strike 105 --put --maturity 1.448 --steps 365 \\
      --paths 1e7 --qmc [--qmc-fgn]

``--antithetic`` pairs every quote: single strikes, ``--strikes``,
``--greeks`` and ``--bounds``.  ``--control-variate`` prices single
strikes, and with ``--greeks`` gives the plain Greeks, as the JAX CLI
does.  ``--bounds`` prints the JAX CLI's fields (price, lower, upper,
duality_gap and the two stderrs) and, as there, exits 2 with
``--strikes``, ``--greeks`` or ``--control-variate``.  ``--pathgen
xla`` prices on the generic path stream, as the JAX CLI's XLA generator
does.  ``--greeks`` runs the Greeks kernels K3/K4 where JAX runs its
fused Greeks and the jvp Greeks stream everywhere else (``--qmc``,
``--pathgen xla``, past 365 steps).

``--trace-dir D`` writes a ``torch.profiler`` Chrome trace of the pricer's
build and its pricing, in which the engine's ``mcop.*`` spans enclose
their kernels, and the same spans with host and device edges on one
clock, and the counters, as ``D/spans_<pid>.json``
(``utils.profiling.device_trace``).

``--serve`` reads JSON-lines quote requests on stdin and answers each on
stdout (``serve``), e.g.
  mcop-price-torch --serve --chunk-paths 131072 <<'EOF'
  {"id": 1, "strikes": [95, 100, 105], "put": true, "maturity": 0.1}
  EOF
"""

from __future__ import annotations

import argparse
import collections
import itertools
import json
import logging
import math
import sys
import time

from ..config import MarketDefaults
from ..ops.fgn import next_pow2
from ..utils import device_trace, enable_persistent_cache

log = logging.getLogger(__name__)


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
    p.add_argument("--trace-dir", default="",
                   help="write a torch.profiler Chrome trace of the "
                        "pricing, with the engine's spans, and the spans "
                        "and counters as spans_<pid>.json, here")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the kernels' "
                        "plain versions)")
    p.add_argument("--serve", action="store_true",
                   help="serve mode: JSON-lines quote requests on stdin, "
                        "JSON-lines answers on stdout; pricers persist "
                        "across requests by shape class")
    p.add_argument("--max-steps", type=int, default=4096,
                   help="serve mode: refuse requests whose pow2 step "
                        "bucket exceeds this (guards the O(steps^2) fGN "
                        "matrix build from one huge request)")
    p.add_argument("--max-paths", type=float, default=1 << 24,
                   help="serve mode: refuse requests for more paths than "
                        "this per quote")
    p.add_argument("--max-strikes", type=int, default=256,
                   help="serve mode: refuse strike strips longer than this")
    p.add_argument("--warm-buckets", default="",
                   help="serve mode: comma-separated STEPSxSTRIPS shape "
                        "classes (e.g. '32x4,64x8') whose pricers are built "
                        "before the first request")
    p.add_argument("--lru-size", type=int, default=16,
                   help="serve mode: most pricers kept; a shape class "
                        "evicted and quoted again is rebuilt")
    return p


def _j(v):
    """JSON-safe number: null when not finite (a single chunk has no
    stderr; a deep-ITM put has no implied vol)."""
    return None if not math.isfinite(v) else round(float(v), 6)


def main(argv=None) -> int:
    enable_persistent_cache()
    args = build_parser().parse_args(argv)
    if args.antithetic and args.qmc:
        print("error: --antithetic is incompatible with --qmc (the Sobol "
              "set has its own stratification)", file=sys.stderr)
        return 2
    if args.serve:
        return serve(args, MarketDefaults())
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
        with device_trace(args.trace_dir):
            if strikes:
                out, family = _price_chain(args, cfg, market, strikes,
                                           engine)
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


def _request(req, args, mkt) -> dict:
    """One request's fields, with the CLI's flags as defaults, checked
    before any pricer is built (the JAX server's guards): the pow2 step
    bucket against --max-steps, the path count against --max-paths, the
    strip against --max-strikes, H in (0, 1), finite s0 > 0, xi > 0,
    eta >= 0, rho and r, and finite strikes > 0."""
    if not isinstance(req, dict):
        raise ValueError("request must be a JSON object")
    if "strikes" in req:
        strikes = [float(v) for v in req["strikes"]]
    else:
        strikes = [float(req.get("strike", args.strike))]
    if not strikes:
        raise ValueError("empty strike strip")
    if "call" in req:
        is_call = bool(req["call"])
    elif "put" in req:
        is_call = not bool(req["put"])
    else:
        is_call = args.is_call
    maturity = float(req.get("maturity", args.maturity))
    n_steps = int(req.get("steps", args.steps)
                  or max(1, int(maturity * mkt.trading_days)))
    # isfinite: json.loads takes bare NaN and Infinity, and NaN passes
    # every sign comparison.
    if n_steps < 1 or not maturity > 0 or not math.isfinite(maturity):
        raise ValueError(f"invalid steps={n_steps} / maturity={maturity}")
    bucket = max(8, next_pow2(n_steps))
    if bucket > args.max_steps:
        raise ValueError(f"steps={n_steps} (pow2 bucket {bucket}) exceeds "
                         f"--max-steps={args.max_steps}")
    if len(strikes) > args.max_strikes:
        raise ValueError(f"{len(strikes)} strikes exceeds --max-strikes="
                         f"{args.max_strikes}")
    n_paths = int(req.get("paths", args.paths))
    if n_paths < 1:
        raise ValueError(f"invalid paths={n_paths}")
    if n_paths > args.max_paths:
        raise ValueError(f"paths={n_paths} exceeds --max-paths="
                         f"{int(args.max_paths)}")
    hurst = float(req.get("hurst", args.hurst))
    if not 0.0 < hurst < 1.0:
        raise ValueError(f"invalid hurst={hurst} (need 0 < H < 1)")
    market = tuple(float(req.get(name, getattr(args, name)))
                   for name in ("s0", "xi", "eta", "rho", "r"))
    s0, xi, eta, rho, r = market
    if not (s0 > 0 and xi > 0 and eta >= 0
            and all(map(math.isfinite, market))
            and all(k > 0 and math.isfinite(k) for k in strikes)):
        raise ValueError("invalid market: need finite s0 > 0, xi > 0, "
                         "eta >= 0, rho, r, and finite strikes > 0")
    return dict(strikes=strikes, is_call=is_call, maturity=maturity,
                n_steps=n_steps, bucket=bucket, n_paths=n_paths,
                seed=int(req.get("seed", args.seed)), hurst=hurst, s0=s0,
                xi=xi, eta=eta, rho=rho, r=r, greeks=bool(req.get("greeks")))


def serve(args, mkt, pricers=None) -> int:
    """JSON-lines quote server on stdin and stdout (counterpart: the JAX
    CLI's ``serve``, with its protocol).

    Request, one JSON object a line: {"id": any, "strikes": [..] |
    "strike": x, "put": bool | "call": bool, "maturity": years, "steps"?,
    "paths"?, "seed"?, "greeks"?, and the market "s0", "xi", "hurst",
    "eta", "rho", "r"?}, the CLI's flags as defaults.  Answer: {"id",
    "strikes", "prices", "stderrs", "implied_vols", "n_paths", "n_steps",
    "is_call", "compiled", "elapsed_s"}; with "greeks": true the strip's
    "delta", "vega_xi", "vega_eta", "rho_rate", "vega_h" rows and the
    stderrs of each; or {"id", "error"}, the id read from that line alone,
    and the server reads on.

    Pricers are kept in a bounded LRU (--lru-size) keyed by a shape
    class, (step bucket, strip bucket, call/put, chunk, pathgen, qmc):
    each is a ``StreamingChainPricer(bucketed=True, traced_market=True)``
    on the generic stream, so fresh strikes, maturities (the true step
    count inside the pow2 step bucket, at least 8), path budgets (chunks
    of the server's --chunk-paths), markets and H all reprice on the
    pricer a class already holds.  Strips are padded to a pow2 length,
    the dead lanes repeating the last strike, and sliced off the answer.
    "compiled" keeps the JAX server's key: here it is true when this quote
    built a new pricer for its shape class, or made the first Greeks quote
    on that class's pricer (JAX compiles there; the port builds the
    pricer's host constants, and its first jvp).  Requests past the guards
    (``_request``) are refused before any pricer is built.  --warm-buckets
    quotes go to the log, never to stdout.  Runs on --device (cuda unless
    cpu is asked for).  ``pricers``: the LRU to fill (a fresh OrderedDict
    when None), for a caller that inspects what the server built; each
    entry is [pricer, whether a Greeks quote ran on it]."""
    from ..models import engine
    from ..models.closed_form import implied_vol

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: "
                               "%(message)s")
    if pricers is None:
        pricers = collections.OrderedDict()
    max_pricers = max(1, args.lru_size)
    made = churn = 0
    seen = set()
    block = 256
    chunk = max(block, (args.chunk_paths // block) * block)

    def respond(obj, warm):
        if warm:
            log.info("serve: warmed %s (%s s)", obj.get("id"),
                     obj.get("elapsed_s", obj.get("error", "?")))
            return
        sys.stdout.write(json.dumps(obj) + "\n")
        sys.stdout.flush()

    warm_lines = []
    for spec in filter(None, args.warm_buckets.split(",")):
        steps_s, _, k_s = spec.partition("x")
        warm_lines.append(json.dumps({
            "id": f"__warm_{spec}", "steps": int(steps_s),
            "strikes": [args.s0] * max(1, int(k_s or 1)),
            "maturity": int(steps_s) / mkt.trading_days, "paths": 1}))

    log.info("serve: ready (JSON lines on stdin)")
    for is_warm, line in itertools.chain(
            ((True, w) for w in warm_lines),
            ((False, w) for w in sys.stdin)):
        line = line.strip()
        if not line:
            continue
        t0 = time.time()
        rid = None
        try:
            req = json.loads(line)
            rid = req.get("id") if isinstance(req, dict) else None
            q = _request(req, args, mkt)
            strikes, n_k = q["strikes"], len(q["strikes"])
            k_bucket = max(1, next_pow2(n_k))
            padded = strikes + [strikes[-1]] * (k_bucket - n_k)
            # Below one chunk a quote is served at one chunk; larger
            # budgets round down to whole chunks.
            n_paths = max(chunk, (q["n_paths"] // chunk) * chunk)
            key = (q["bucket"], k_bucket, q["is_call"], chunk,
                   args.pathgen, args.qmc)
            entry = pricers.get(key)
            compiled = entry is None
            if entry is not None:
                pricers.move_to_end(key)
            else:
                cfg = engine.StreamConfig(
                    n_paths=chunk, n_steps=q["bucket"], chunk_paths=chunk,
                    pilot_paths=args.pilot_paths or min(1 << 16, chunk),
                    chunks_per_call=64, pathgen_impl=args.pathgen,
                    qmc=args.qmc, qmc_fgn=args.qmc_fgn,
                    antithetic=args.antithetic)
                pricer = engine.StreamingChainPricer(
                    q["s0"], q["xi"], q["hurst"], q["eta"], q["rho"],
                    q["r"], strikes=padded,
                    maturity=q["bucket"] / mkt.trading_days,
                    is_call=q["is_call"], config=cfg, device=args.device,
                    bucketed=True, traced_market=True)
                entry = pricers[key] = [pricer, False]
                made += 1
                if key in seen:
                    # A class evicted and quoted again: its pricer is
                    # rebuilt (the host's float64 fGN matrices of the
                    # bucket, O(steps^2), and their copy to the device).
                    # Nothing is retained per rebuild.
                    churn += 1
                    log.warning(
                        "serve: shape class %s rebuilt after eviction (%d "
                        "rebuilds so far); consider --lru-size > %d to "
                        "avoid repeating its matrix build", key, churn,
                        max_pricers)
                seen.add(key)
                if len(pricers) > max_pricers:
                    pricers.popitem(last=False)
            pricer = entry[0]
            per_call = dict(strikes=padded, n_paths=n_paths,
                            n_steps_live=q["n_steps"],
                            maturity=q["maturity"], hurst=q["hurst"],
                            market=dict(s0=q["s0"], xi=q["xi"], r=q["r"],
                                        eta=q["eta"]))
            if q["greeks"]:
                compiled = compiled or not entry[1]
                g, se = pricer.price_and_greeks(q["seed"], with_stderr=True,
                                                **per_call)
                entry[1] = True
                names = ("prices",) + engine.GREEK_ORDER[1:]
                extra = {n: [_j(v) for v in row[:n_k]]
                         for n, row in zip(names, g)}
                extra["stderrs"] = {n: [_j(v) for v in row[:n_k]]
                                    for n, row in zip(names, se)}
                prices = g[0][:n_k]
            else:
                prices, stderrs = pricer.price(q["seed"], with_stderr=True,
                                               **per_call)
                prices = prices[:n_k]
                extra = {"prices": [_j(v) for v in prices],
                         "stderrs": [_j(v) for v in stderrs[:n_k]]}
            ivs = [implied_vol(float(v), q["s0"], k, q["r"], q["maturity"],
                               q["is_call"]) for v, k in zip(prices, strikes)]
            respond({"id": rid, "strikes": strikes, **extra,
                     "implied_vols": [_j(v) for v in ivs],
                     "n_paths": n_paths, "n_steps": q["n_steps"],
                     "is_call": q["is_call"], "compiled": compiled,
                     "elapsed_s": round(time.time() - t0, 3)}, is_warm)
        except Exception as e:  # noqa: BLE001 - one bad quote must not
            # end the server; the id is this line's, never a previous one.
            log.warning("serve: request failed: %s", e)
            respond({"id": rid, "error": str(e)}, is_warm)
    log.info("serve: stdin closed after %d pricer(s) built; exiting", made)
    return 0


if __name__ == "__main__":
    sys.exit(main())
