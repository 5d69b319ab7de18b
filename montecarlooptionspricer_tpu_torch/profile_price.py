"""Where one full-width price spends its time on the card, by the port's
own spans.

Runs the bench.py workload (1e7 paths x 365 steps, the same shape as
``chip_smoke.py``; ``--steps 1825`` takes the long horizon of the same
option, maturity steps/252) through ``StreamingPricer.price`` once to
warm up, then once more with the recorder on (``utils.profiling.tracing``,
no profiler), and prints one JSON line a span in the order the spans
ended (``mcop.pilot``, ``mcop.lsm``, ``mcop.fit``, ``mcop.tables``,
``mcop.chunks``, ``mcop.readback``, ``mcop.stream``, ``mcop.price``): its
parent, attributes, the port kernels it launched, and its host and
device milliseconds on one clock; then one line of the counters and the
price's wall.  ``--tiled-impl`` passes through to ``StreamConfig``
(``--steps 1825 --tiled-impl factored`` takes K8/K9 where K6/K7 would
run; ``--steps 4000`` takes K8/K9 by default).  ``--antithetic`` and
``--control-variate`` pass through to ``StreamConfig`` too: the stream
then runs that form of the priced kernel, and the fit adds the control's
beta and centre (``mcop.control_fit``).  ``--strikes`` prices that strike
strip of the same expiry through ``StreamingChainPricer`` instead: the
fit is one LSM backward pass over the strip, the stream K5 per chunk.
``--greeks`` prices the Greeks instead (``price_and_greeks``): the Greeks
kernel (K3, or K4 with ``--strikes``) where it runs, else the jvp Greeks
stream; each pairs with ``--antithetic``.  ``--pathgen xla`` takes the
generic path stream (``pathgen_stream``), which is also where
``--strikes`` goes past K5's 512 steps.  ``--bounds`` prices
``price_with_bounds`` (the pilot, its fits, the hedge's quartic fits and
the dual's scale, then the family's path kernel and the lower and upper
sums of each chunk's whole paths).  The Greeks and the bounds have no
``mcop.price`` root: their spans are those of the parts they share with
``price``.  ``--fgn-form`` passes through to ``StreamConfig.fgn_form`` as
the JAX bench's ``BENCH_FGN_FORM`` does: "spectral" runs the spectral
bodies (K1/K2 at 365 steps, K5 for a strip, K6/K7 with ``--tiled-impl
slab``; K8/K9 past 365 steps otherwise).  ``--policy-form quadratic``
sets ``StreamConfig.policy_form`` and ``chain_policy_form``: the stream
then runs the quadratic form of the priced kernel (K2, K7 or K9; K5 for a
strip).  ``--fgn-matmul-dtype bfloat16`` sets
``StreamConfig.fgn_matmul_dtype``: the bf16 fGN-input forms of the
family's kernels (K1/K2, K6/K7, K8/K9, in the fGN and policy forms the
other flags name), as the JAX bench runs its long horizons.

Usage (one CUDA card):
  python -m montecarlooptionspricer_tpu_torch.profile_price [--steps N]
      [--strikes 75,77.5,...,125] [--greeks] [--tiled-impl factored]
      [--antithetic] [--control-variate] [--pathgen xla] [--bounds]
      [--fgn-form {auto,chol,spectral}] [--policy-form quadratic]
      [--fgn-matmul-dtype bfloat16]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=365)
    parser.add_argument("--strikes", default="",
                        help="comma-separated strike strip (default: the "
                             "single strike 105)")
    parser.add_argument("--tiled-impl", default="auto",
                        choices=("auto", "slab", "factored"),
                        help="StreamConfig.tiled_impl")
    parser.add_argument("--greeks", action="store_true",
                        help="stream the Greeks: K3 (K4 with --strikes) "
                             "where they run, else the jvp Greeks stream")
    parser.add_argument("--antithetic", action="store_true",
                        help="StreamConfig.antithetic")
    parser.add_argument("--control-variate", action="store_true",
                        help="StreamConfig.control_variate (single strikes)")
    parser.add_argument("--bounds", action="store_true",
                        help="profile price_with_bounds (single strikes)")
    parser.add_argument("--fgn-form", default="auto",
                        choices=("auto", "chol", "spectral"),
                        help="StreamConfig.fgn_form")
    parser.add_argument("--policy-form", default="boundary",
                        choices=("boundary", "quadratic"),
                        help="StreamConfig.policy_form and "
                             "chain_policy_form")
    parser.add_argument("--pathgen", default="pallas",
                        choices=("pallas", "xla"),
                        help="StreamConfig.pathgen_impl")
    parser.add_argument("--fgn-matmul-dtype", default="float32",
                        choices=("float32", "bfloat16"),
                        help="StreamConfig.fgn_matmul_dtype")
    args = parser.parse_args(argv)
    steps = args.steps
    strikes = [float(v) for v in args.strikes.split(",") if v]
    if args.bounds and (strikes or args.greeks or args.control_variate):
        parser.error("--bounds prices one strike, without --greeks or "
                     "--control-variate")
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 1
    from .models import engine
    from .utils import profiling

    cfg = engine.StreamConfig(n_paths=76 << 17, n_steps=steps,
                              chunk_paths=1 << 17, pilot_paths=1 << 17,
                              dt=1.0 / 252.0, chunks_per_call=76,
                              tiled_impl=args.tiled_impl,
                              antithetic=args.antithetic,
                              control_variate=args.control_variate,
                              fgn_form=args.fgn_form,
                              policy_form=args.policy_form,
                              chain_policy_form=args.policy_form,
                              pathgen_impl=args.pathgen,
                              fgn_matmul_dtype=args.fgn_matmul_dtype)
    if strikes:
        pricer = engine.StreamingChainPricer(
            100.0, 0.04, 0.1, 1.5, -0.4, 0.04, strikes, steps / 252, False,
            cfg, device="cuda")
    else:
        pricer = engine.StreamingPricer(100.0, 0.04, 0.1, 1.5, -0.4, 0.04,
                                        105.0, steps / 252, False, cfg,
                                        device="cuda")
    price = (pricer.price_with_bounds if args.bounds
             else pricer.price_and_greeks if args.greeks else pricer.price)
    price(41)       # builds the kernels, warms every path
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    with profiling.tracing() as rec:
        t0 = time.perf_counter()
        price(42)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    for s in rec.spans():
        (h0, h1), dev = s["host_ns"], s["device_ns"]
        print(json.dumps({
            "span": s["name"], "id": s["id"], "parent": s["parent"],
            "attrs": s["attrs"], "launches": s["launches"],
            "host_ms": 1e-6 * (h1 - h0),
            "device_ms": 1e-6 * (dev[1] - dev[0])}), flush=True)
    print(json.dumps({
        "counters": rec.counters(), "wall_s": wall, "n_steps": steps,
        "n_strikes": len(strikes) or 1, "greeks": args.greeks,
        "bounds": args.bounds, "antithetic": args.antithetic,
        "control_variate": args.control_variate,
        "kernel_family": pricer.kernel_family, "fgn_form": args.fgn_form,
        "policy_form": args.policy_form, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
