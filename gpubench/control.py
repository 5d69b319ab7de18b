"""The readings the limits of ``correct`` are set from (PERF.md): for each
seed, the compared numbers of the program's answer, and of its two
controls, against the float64 reference.

    python3 -m gpubench.control --workload NAME --seeds 1,2,3 [--chunks N]

The controls are the reference put in the program's place in the
precision below the configuration's (float32, the fGN product in TF32),
and the program's own lower-precision path, its bf16 fGN inputs
(``fgn_matmul_dtype="bfloat16"``).  Faults of the stderr are planted in
the reference put in the program's place, read from its chunk totals:
the stderr of half the chunks, and under the control variate the stderr
of the uncorrected totals.  A limit lies above every sound reading and
below every control's or fault's that separates.  Every answer is read
against the witness of the program's request, the reference's answer
from the seed alone (``witness_gap_se``).  One JSON line a seed;
``--chunks`` cuts the request's chunks (the tests' size), else the
cell's own; ``--controls`` names the controls to run (none: the
program's readings alone).  Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import numpy as np
import torch

from . import correct, registry, run, system
from .reference import rbergomi_lsm as ref


def _control_tf32(config: dict, req, seed: int, device,
                  stream: bool = True):
    """The reference put in the program's place in TF32: its answer (None
    without ``stream``) and its state (pilot and own fit), as the check
    would read a program's."""
    c, s = config["contract"], config["stream"]
    lw = correct.law(config, device, torch.float32, tf32=True)
    strikes = torch.as_tensor(req.strikes, dtype=torch.float32,
                              device=lw.device)
    ls = ref.pilot_log_paths(lw, seed, int(s["pilot_paths"]))
    pilot = ref.with_s0(lw, ls)
    with lw.matmuls():
        fit = ref.lsm_fit(pilot, strikes, lw.r, lw.dt, bool(c["is_call"]))
    q = None
    if stream:
        beta = (ref.control_beta(lw, pilot, fit, strikes,
                                 bool(c["is_call"]))
                if req.control_variate else None)
        q = ref.stream(lw, fit, strikes, bool(c["is_call"]), seed,
                       req.n_chunks, int(s["chunk_paths"]), req.antithetic,
                       beta)
    f64 = ref.Fit(*(t.to(torch.float64) for t in (fit.coeffs, fit.mu,
                                                   fit.sd)))
    return q, correct.State(ls.to(torch.float64), f64, None)


def fit_readings(config: dict, traffic: dict, seeds, device: str = "cuda"):
    """Yield the start's and the fit's readings a seed (no stream):
    ``pilot_gap`` and ``fit_gap`` of the program, its bf16 path and the
    TF32 reference in its place."""
    req = system.request(config, traffic)
    pricers = {"program": system.Pricer(config, req, device),
               "bf16": system.Pricer(config, req, device,
                                     fgn_matmul_dtype="bfloat16")}
    c, s = config["contract"], config["stream"]
    lw = correct.law(config, device)
    strikes = torch.as_tensor(req.strikes, dtype=torch.float64,
                              device=lw.device)
    for seed in seeds:
        out = {"seed": seed}
        ls = ref.pilot_log_paths(lw, seed, int(s["pilot_paths"]))
        states = {name: correct.program_state(p, seed)
                  for name, p in pricers.items()}
        states["tf32"] = _control_tf32(config, req, seed, device, False)[1]
        for name, state in states.items():
            own = ref.lsm_fit(ref.with_s0(lw, state.pilot_ls), strikes,
                              lw.r, lw.dt, bool(c["is_call"]))
            out[name] = {"pilot_gap": float(torch.max(torch.abs(
                state.pilot_ls - ls))),
                "fit_gap": correct.fit_gap(state.fit, own, req.strikes)}
        yield out


def stderr_faults(q: ref.Quote, chunk: int) -> dict:
    """The stderr faults planted in the reference's answer ``q``, each
    read as ``correct.stderr_gap`` reads a program's stderr: the stderr
    of the first half of the chunks (the price over all of them), and
    under the control variate the stderr of the uncorrected totals."""
    def se(tot):
        return tot.std(0, ddof=1) / math.sqrt(tot.shape[0]) / chunk

    live = q.stderr > 0
    m = q.totals.shape[0]
    out = {"half_the_chunks": se(q.totals[:m // 2])}
    if q.raw_totals is not None:
        out["uncorrected_cv"] = se(q.raw_totals)
    return {name: float(np.max(np.abs(v - q.stderr)[live]
                               / q.stderr[live])) if live.any() else 0.0
            for name, v in out.items()}


def readings(config: dict, traffic: dict, seeds, device: str = "cuda",
             controls=("tf32", "bf16")):
    """Yield one dict of readings a seed: ``program``'s, and each
    control's, each the numbers ``correct.numbers`` compares against the
    float64 reference, the stderr faults' readings, and the seconds each
    answer took."""
    req = system.request(config, traffic)
    pricers = {"program": system.Pricer(config, req, device)}
    if "bf16" in controls:
        pricers["bf16"] = system.Pricer(config, req, device,
                                        fgn_matmul_dtype="bfloat16")
    for seed in seeds:
        out = {"seed": seed}
        for name, pricer in pricers.items():
            t0 = time.perf_counter()
            prices, stderrs = pricer.quote(seed)
            out[name + "_s"] = time.perf_counter() - t0
            state = correct.program_state(pricer, seed)
            t0 = time.perf_counter()
            refd = correct.reference(config, req, seed, state, device,
                                     witness=name == "program")
            out["reference_s"] = time.perf_counter() - t0
            if name == "program":
                wit = refd.witness
                out["faults"] = stderr_faults(
                    refd.quote, int(config["stream"]["chunk_paths"]))
            out[name] = correct.numbers(prices, stderrs, state, refd,
                                        req.strikes, wit)
            out[name + "_gap_se_by_strike"] = [
                abs(p - rp) / rs if rs else abs(p - rp)
                for p, rp, rs in zip(prices, refd.quote.price,
                                     refd.quote.stderr)]
            if name == "program":
                out["ref_price"] = [float(v) for v in refd.quote.price]
                out["ref_stderr"] = [float(v) for v in refd.quote.stderr]
                out["price"] = [float(v) for v in prices]
        if "tf32" in controls:
            t0 = time.perf_counter()
            q, state = _control_tf32(config, req, seed, device)
            out["tf32_s"] = time.perf_counter() - t0
            refd = correct.reference(config, req, seed, state, device)
            out["tf32"] = correct.numbers(q.price, q.stderr, state, refd,
                                          req.strikes, wit)
            out["tf32_gap_se_by_strike"] = [
                abs(p - rp) / rs if rs else abs(p - rp)
                for p, rp, rs in zip(q.price, refd.quote.price,
                                     refd.quote.stderr)]
        yield out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--chunks", type=int, default=0)
    ap.add_argument("--fit-only", action="store_true",
                    help="the start's and the fit's readings, no stream")
    ap.add_argument("--controls", default="tf32,bf16",
                    help="comma-separated controls to run, or none")
    args = ap.parse_args(argv)
    bench = registry.benchmark()
    cell = registry.workload(bench, args.workload)
    config = registry.config(cell["config"])
    traffic = registry.traffic(cell["traffic"])
    if args.chunks:
        traffic["n_chunks"] = args.chunks
    run.pin_caches(registry.ROOT)
    if not torch.cuda.is_available():
        print("gpubench.control: needs a CUDA device", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    if args.fit_only:
        outs = fit_readings(config, traffic, seeds)
    else:
        outs = readings(config, traffic, seeds, controls=tuple(
            c for c in args.controls.split(",") if c))
    for out in outs:
        print(json.dumps({"workload": args.workload, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
