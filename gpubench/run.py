"""One run of one cell of the benchmark of ``montecarlooptionspricer_tpu_torch``.

    python3 -m gpubench.run --workload NAME --seed N --seconds S --trace 0|1

A fresh process: it loads the port, builds the cell's pricer, warms up
the cell's own shapes with one price, then prices back to back (one
client, a closed loop) until the first price that finishes after
``--seconds``.  With ``--trace 0`` it reports the cell's end-to-end
metrics; with ``--trace 1`` it prices a fixed number of whole prices,
each split into its two halves and timed on the host's clock, then as
many again under ``torch.profiler``, and reports the per-layer metrics,
the device's busy time and a breakdown.  Either way a
sample of the answers is priced again by the plain reference once the
window has closed, and ``correct`` says whether each compared number lies
within its limit.  The last line of standard output is one JSON object;
the compared numbers and their limits are the last lines of standard
error and the result's last key.

It needs a CUDA device (and as many as the cell asks for): without one it
exits 2 and prints no result.  The kernel build cache lies at a fixed path
inside the checkout (``build/kernels``), so only a checkout's first run
compiles.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from . import correct, registry, system, trace, window

# Whole prices the traced run times split on the host's clock, and as many
# again under the profiler.
TRACED_PRICES = 3
# Top-level modules no run may hold once its window has closed.
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "montecarlooptionspricer_tpu")


def process_age_s() -> float:
    """Seconds since this process started (Linux; 0 where unknown)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(up - start / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


def pin_caches(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    build = root / "build"
    os.environ["MCOP_KERNEL_CACHE_DIR"] = str(build / "kernels")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")


def forbidden_modules() -> list:
    """The forbidden top-level names that ``sys.modules`` holds, each
    compared whole (the port's name begins with the JAX package's)."""
    tops = {name.split(".", 1)[0] for name in sys.modules}
    return sorted(tops.intersection(FORBIDDEN))


@dataclass
class Run:
    """What the metric readers read."""

    config: dict
    request: system.Request
    setup_s: float
    consts_s: float
    window: window.Window = None
    trace: trace.Trace = None
    halves: dict = None


def _traced_window(pricer, seeds, device: str, work: int):
    """TRACED_PRICES whole prices, each split into ``fit`` and
    ``price_with_fit`` with the device synchronized at each half's end and
    timed on the host's clock (``halves``: seconds of each half a price),
    then TRACED_PRICES more so split under the profiler, each half in a
    span; the profiler's host cost would about double the fit's time, so
    the halves are timed outside it: (window, halves, trace)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    if device != "cuda":
        raise RuntimeError("the traced run reads the device's trace: it "
                           "needs a CUDA device")
    win = window.Window()
    halves = {"fit": [], "stream": []}
    for _ in range(TRACED_PRICES):
        seed = next(seeds)
        t0 = time.perf_counter()
        fits = pricer.fit(seed)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        prices, stderrs = pricer.price_with_fit(fits, seed)
        t2 = time.perf_counter()
        halves["fit"].append(t1 - t0)
        halves["stream"].append(t2 - t1)
        win.done.append(window.Done(seed, t0, t2, work, prices, stderrs))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(TRACED_PRICES):
            seed = next(seeds)
            t0 = time.perf_counter()
            with record_function("gpubench.price"):
                with record_function("gpubench.fit"):
                    fits = pricer.fit(seed)
                    torch.cuda.synchronize()
                with record_function("gpubench.stream"):
                    prices, stderrs = pricer.price_with_fit(fits, seed)
                    torch.cuda.synchronize()
            win.done.append(window.Done(seed, t0, time.perf_counter(), work,
                                        prices, stderrs))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        return win, halves, trace.from_chrome(path)


def run_cell(bench: dict, cell: dict, config: dict, traffic: dict,
             seed: int, seconds: float, traced: bool, device: str = "cuda",
             t_start: float | None = None, quote_hook=None,
             cell_limits: dict | None = None) -> dict:
    """Run one cell and return its result line as a dict.  ``t_start``:
    the process's start on ``time.perf_counter``'s clock.  ``quote_hook``
    wraps the timed path (the tests' planted faults); ``cell_limits``
    stand in for the cell's file (the tests' cut sizes)."""
    import torch

    if t_start is None:
        t_start = time.perf_counter()
    req = system.request(config, traffic)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    pricer = system.Pricer(config, req, device=device)
    work = pricer.n_paths * req.n_strikes
    quote = pricer.quote if quote_hook is None else quote_hook(pricer)
    # Warm-up: one price at the cell's shapes, cut to one call of chunks.
    warm = min(req.n_chunks, int(config["stream"]["chunks_per_call"]))
    pricer.quote(system.request_seed(seed, -1), warm * pricer.chunk)
    if device == "cuda":
        torch.cuda.synchronize()
    run = Run(config, req, time.perf_counter() - t_start, pricer.consts_s)
    seeds = (system.request_seed(seed, i) for i in range(1 << 30))
    if traced:
        run.window, run.halves, run.trace = _traced_window(
            pricer, seeds, device, work)
    else:
        run.window = window.run_closed_loop(quote, seeds, seconds,
                                            time.perf_counter, work)
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda"
           else "cpu", "count": 1,
           "memory_peak_bytes": torch.cuda.max_memory_allocated()
           if device == "cuda" else 0}
    print(json.dumps({"kernel_family": pricer.kernel_family,
                      "form_launches": pricer.form_launches(),
                      "prices": len(run.window.done)}), file=sys.stderr,
          flush=True)

    kind = "per_layer" if traced else "end_to_end"
    reads = "layer_metrics" if traced else "end_to_end"
    metrics = {}
    for m in registry.metrics_of(bench, kind, cell["name"]):
        value = registry.reader(reads, m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    found = {"nonfinite_answers": correct.nonfinite(run.window.done)}
    limits = {"nonfinite_answers": {"limit": 0}, "replay_gap": {"limit": 0}}
    if traced:
        # The split halves answer as the timed entry does.
        limits["split_gap"] = {"limit": 0}
        d = run.window.done[0]
        whole = pricer.quote(d.seed)
        found["split_gap"] = float(max(
            np.max(np.abs(whole[0] - d.prices)),
            np.max(np.abs(whole[1] - d.stderrs))))
    states = []
    for d in correct.sample(run.window.done, seed):
        state = correct.program_state(pricer, d.seed)
        found["replay_gap"] = max(found.get("replay_gap", 0.0),
                                  correct.replay_gap(pricer, state, d))
        states.append((d, state))
    del pricer, quote
    if device == "cuda":
        torch.cuda.empty_cache()
    for d, state in states:
        refd = correct.reference(config, req, d.seed, state, device,
                                 witness=True)
        for name, v in correct.numbers(d.prices, d.stderrs, state, refd,
                                       req.strikes).items():
            found[name] = max(found.get(name, 0.0), v)
    del states
    limits.update(registry.limits(cell["name"]) if cell_limits is None
                  else cell_limits)
    ok, checks = correct.judge(found, limits)
    result = {"correct": ok, "attempted": len(run.window.done), "failed": 0,
              "metrics": metrics, "device": dev}
    if traced:
        start, end = run.trace.window
        dev["busy_s"] = trace.busy_s(run.trace.device, start, end)
        dev["window_s"] = end - start
        result["breakdown"] = {"device_ops": trace.top_device_ops(run.trace),
                               "idle_gaps": trace.idle_gaps(run.trace)}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    t_start = time.perf_counter() - process_age_s()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = registry.benchmark()
    cell = registry.workload(bench, args.workload)
    config = registry.config(cell["config"])
    traffic = registry.traffic(cell["traffic"])
    pin_caches(registry.ROOT)
    import torch

    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < int(cell["chips"]):
        print(f"gpubench: the cell needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run_cell(bench, cell, config, traffic, args.seed, args.seconds,
                      bool(args.trace), "cuda", t_start)
    held = forbidden_modules()
    if held:
        print(f"gpubench: the run loaded {', '.join(held)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
