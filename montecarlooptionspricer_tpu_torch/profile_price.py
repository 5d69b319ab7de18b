"""Where one full-width price spends its time on the card.

Runs the bench.py workload (1e7 paths x 365 steps, the same shape as
``chip_smoke.py``; ``--steps 1825`` takes the long horizon of the same
option, maturity steps/252) through ``StreamingPricer`` once to warm up,
then times its two stages, the pilot fit (the family's path kernel, K1,
K6 or K8, + the LSM fit) and the stream (tables + K2, K7 or K9 per chunk),
first on the host clock without a profiler and then under
``torch.profiler``.  ``--tiled-impl`` passes through to ``StreamConfig``
(``--steps 1825 --tiled-impl factored`` profiles K8/K9 where K6/K7 would
run; ``--steps 4000`` takes K8/K9 by default).  ``--antithetic`` and
``--control-variate`` pass through to ``StreamConfig`` too: the stream
then runs that form of the priced kernel, and the fit adds the control's
beta and centre.  ``--strikes`` prices that strike strip of the same
expiry through ``StreamingChainPricer`` instead: the fit is one LSM
backward pass over the strip, the stream K5 per chunk.  ``--greeks``
streams the Greeks instead: the Greeks kernel (K3, or K4 with
``--strikes``) where it runs, else the jvp Greeks stream (fitted on the
jvp generator's pilot); each pairs with ``--antithetic``.  ``--pathgen xla`` takes the generic path
stream (``pathgen_stream``): the stream stage then generates whole paths
and prices them in plain PyTorch, which is also where ``--strikes`` goes
past K5's 512 steps.  ``--bounds`` profiles ``price_with_bounds``: the
fit is ``bounds_fit`` (pilot, LSM fit, the hedge's quartic fits and the
dual's scale), the stream ``bounds_with_fit`` (the family's path kernel,
K1, K6 or K8, paired with ``--antithetic``, and the lower and upper sums of
each chunk's whole paths).  ``--fgn-form`` passes through to
``StreamConfig.fgn_form`` as the JAX bench's ``BENCH_FGN_FORM`` does:
"spectral" runs the spectral bodies (K1/K2 at 365 steps, K5 for a strip,
K6/K7 with ``--tiled-impl slab``; K8/K9 past 365 steps otherwise).
``--policy-form quadratic`` sets ``StreamConfig.policy_form`` and
``chain_policy_form``: the stream then runs the quadratic form of the
priced kernel (K2, K7 or K9; K5 for a strip), the fit and its tables
being otherwise the same.  ``--fgn-matmul-dtype bfloat16`` sets
``StreamConfig.fgn_matmul_dtype``: the bf16 fGN-input forms of the
family's kernels (K1/K2, K6/K7, K8/K9, in the fGN and policy forms the
other flags name), as the JAX bench runs its long horizons.  For each
stage it prints one JSON line: host wall seconds, device kernel launches
and busy seconds from the trace, the idle share 1 - busy / wall (against
the unprofiled and the profiled wall), and the kernels that take the most
device time.

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


def _stages(pricer, seed, greeks: bool, bounds: bool):
    from .models.engine import _pilot_stream_keys

    state = {}

    def fit():
        carrier = _pilot_stream_keys(seed)[0]
        if bounds:
            state["fits"] = pricer.bounds_fit(carrier)
        elif greeks:
            state["fits"] = pricer.greeks_fit(carrier)
        else:
            state["fits"] = pricer.fit(carrier)

    def stream():
        if bounds:
            pricer.bounds_with_fit(state["fits"], seed)
        elif greeks:
            pricer.greeks_with_fit(state["fits"], seed)
        else:
            pricer.price_with_fit(state["fits"], seed)

    return (("fit", fit), ("stream", stream))


def _timed(torch, fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


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
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 1
    from .models import engine

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
    seed = 42
    # Build the kernels, warm every path.
    if args.bounds:
        pricer.price_with_bounds(seed)
    elif args.greeks:
        pricer.price_and_greeks(seed)
    else:
        pricer.price(seed)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    for name, fn in _stages(pricer, seed, args.greeks, args.bounds):
        wall_plain = _timed(torch, fn)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall_prof = _timed(torch, fn)
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_s = sum(e.time_range.elapsed_us() for e in kernels) * 1e-6
        by_name = {}
        for e in kernels:
            by_name[e.name] = by_name.get(e.name, 0) + \
                e.time_range.elapsed_us()
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
        print(json.dumps({
            "stage": name, "n_steps": steps,
            "n_strikes": len(strikes) or 1, "greeks": args.greeks,
            "bounds": args.bounds,
            "antithetic": args.antithetic,
            "control_variate": args.control_variate,
            "kernel_family": pricer.kernel_family,
            "fgn_form": args.fgn_form, "policy_form": args.policy_form,
            "card": card,
            "wall_s": wall_plain,
            "wall_profiled_s": wall_prof, "device_launches": len(kernels),
            "device_busy_s": busy_s,
            "idle_share": 1.0 - busy_s / wall_plain,
            "idle_share_profiled": 1.0 - busy_s / wall_prof,
            "top_kernels_us": [[k[:80], v] for k, v in top]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
