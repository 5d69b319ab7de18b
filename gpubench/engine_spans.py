"""The program's own spans and counters in a traced run, and what the
per-layer metrics read from them.

The port records spans at its layer boundaries (``mcop.price`` >
``mcop.fit`` > ``mcop.pilot``, ``mcop.lsm``, ``mcop.control_fit``;
``mcop.stream`` > ``mcop.tables``, ``mcop.chunks``, ``mcop.readback``;
``mcop.setup.consts``, ``mcop.setup.kernels``) and counters, each with
host and device edges on one clock, while its recorder is on
(``utils.profiling.tracing``).  A traced run's readers call ``of(run)``,
which once a run starts one fresh process on the same device
(``python -m gpubench.engine_spans``, the job on its standard input):

1. the recorder on, it builds the cell's pricer and warms it up as the
   run does, so the set-up spans hold the kernel libraries' load from the
   warm build cache and the host constants;
2. it prices ``run.TRACED_PRICES`` whole prices through the timed entry
   (``Pricer.quote``) with the recorder on and no profiler, at the seeds
   that follow the run's traced prices;
3. it prices the first of them again with the recorder off:
   ``trace_gap``, the widest difference of price or stderr, must be 0;
4. it prices one more under ``torch.profiler`` with the recorder on, and
   sums the idle device time by the innermost engine span
   (``idle_by_span``).

A fresh process, because a reader sees the run's record and not its
pricer, and a process loads the libraries once.  Where the port has no
recorder, ``of`` returns {} and starts nothing, and the readers read
nothing.  Nothing here imports the port at module import time.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile

from . import registry, system, trace

PREFIX = "mcop."


def _has_recorder() -> bool:
    from montecarlooptionspricer_tpu_torch.utils import profiling
    return hasattr(profiling, "tracing")


def collect(config: dict, req: system.Request, seeds: list, warm_seed: int,
            warm_paths: int, device: str = "cuda") -> dict:
    """Run the job (module docstring) in a fresh process: {"setup",
    "prices": {"spans", "counters"}, "trace_gap", "idle_by_span",
    "idle_s"} (the last two None off CUDA)."""
    job = {"config": config, "request": dataclasses.asdict(req),
           "seeds": [int(s) for s in seeds], "warm_seed": int(warm_seed),
           "warm_paths": int(warm_paths), "device": device}
    out = subprocess.run(
        [sys.executable, "-m", "gpubench.engine_spans"], cwd=registry.ROOT,
        input=json.dumps(job), capture_output=True, text=True, timeout=900)
    if out.returncode != 0:
        raise RuntimeError(f"gpubench.engine_spans exited {out.returncode}:"
                           f"\n{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def of(run) -> dict:
    """The engine's spans of a traced run (``collect``), once a run; {}
    where the port has no recorder.  Prints one line of what no metric
    reads (``trace_gap``, ``idle_by_span``, each span's mean host and
    device milliseconds, the units' load and build times, the counters)
    to standard error, and raises if the traced prices differ from the
    untraced."""
    got = getattr(run, "engine_spans", None)
    if got is not None:
        return got
    run.engine_spans = {}
    if not run.window or not run.window.done or not _has_recorder():
        return run.engine_spans
    from . import run as run_mod

    cfg = run.config
    last = run.window.done[-1].seed
    warm = min(run.request.n_chunks, int(cfg["stream"]["chunks_per_call"]))
    got = collect(cfg, run.request,
                  [last + 1 + i for i in range(run_mod.TRACED_PRICES)],
                  last, warm * int(cfg["stream"]["chunk_paths"]))
    spans = got["prices"]["spans"]
    kernels = [s["attrs"] for s in got["setup"]["spans"]
               if s["name"] == PREFIX + "setup.kernels"]
    print(json.dumps({"engine_spans": {
        "trace_gap": got["trace_gap"], "idle_by_span": got["idle_by_span"],
        "idle_s": got["idle_s"],
        "ms": {name: [span_ms(spans, name, "host"),
                      span_ms(spans, name, "device")]
               for name in dict.fromkeys(s["name"] for s in spans)},
        "kernels": kernels, "counters": got["prices"]["counters"]}}),
        file=sys.stderr, flush=True)
    if got["trace_gap"] != 0.0:
        raise RuntimeError(f"a price traced differs from the same price "
                           f"untraced: trace_gap {got['trace_gap']!r}")
    run.engine_spans = got
    return got


def span_ms(spans: list, name: str, edges: str) -> float | None:
    """The mean over requests of the milliseconds of the spans ``name``
    of each request, on their "host" or "device" edges; None where there
    is none or it has no such edges."""
    per_request = {}
    for s in spans:
        if s["name"] != name:
            continue
        e = s[f"{edges}_ns"]
        if e is None:
            return None
        per_request[s["request"]] = per_request.get(s["request"], 0) \
            + (e[1] - e[0])
    if not per_request:
        return None
    return 1e-6 * sum(per_request.values()) / len(per_request)


def read(run, section: str, name: str, edges: str) -> float | None:
    """A reader's number: ``span_ms`` of ``name`` in ``section`` ("setup"
    or "prices") of ``of(run)``."""
    got = of(run)
    if not got:
        return None
    return span_ms(got[section]["spans"], name, edges)


def idle_by_span(events) -> tuple:
    """(idle, total): idle = [[engine span, seconds], ...], largest first,
    the seconds of the window of the ``mcop.price`` spans in which no
    device operation ran, each stretch split at the engine spans' edges
    and given to the innermost ``mcop.*`` span over it ("none" outside
    them); total = the window's idle seconds.  ``events``: a Chrome
    trace's ``traceEvents``."""
    spans, device = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        op = trace.Op(e.get("name", ""), e["ts"] * 1e-6,
                      (e["ts"] + e.get("dur", 0)) * 1e-6)
        cat = e.get("cat", "")
        if cat in trace.DEVICE_CATS:
            device.append(op)
        elif cat == "user_annotation" and op.name.startswith(PREFIX):
            spans.append(op)
    prices = [s for s in spans if s.name == PREFIX + "price"]
    if not prices:
        return [], 0.0
    start = min(s.start for s in prices)
    end = max(s.end for s in prices)
    busy = trace.union(device, start, end)
    edges = [start] + [x for iv in busy for x in iv] + [end]
    cuts = sorted({x for s in spans for x in (s.start, s.end)
                   if start < x < end})
    idle, total = {}, 0.0
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        total += b - a
        points = [a] + [x for x in cuts if a < x < b] + [b]
        for lo, hi in zip(points, points[1:]):
            mid = 0.5 * (lo + hi)
            over = [s for s in spans if s.start <= mid <= s.end]
            name = min(over, key=lambda s: s.end - s.start).name \
                if over else "none"
            idle[name] = idle.get(name, 0.0) + (hi - lo)
    ranked = sorted(idle.items(), key=lambda kv: -kv[1])
    return [[name, sec] for name, sec in ranked], total


def _job(job: dict) -> dict:
    """The fresh process's work (module docstring)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from montecarlooptionspricer_tpu_torch.utils import profiling

    device, seeds = job["device"], job["seeds"]
    with profiling.tracing() as rec:
        pricer = system.Pricer(job["config"], system.Request(**job["request"]),
                               device=device)
        pricer.quote(job["warm_seed"], job["warm_paths"])
    setup = {"spans": rec.spans(), "counters": rec.counters()}
    with profiling.tracing() as rec:
        traced = [pricer.quote(s) for s in seeds]
    prices = {"spans": rec.spans(), "counters": rec.counters()}
    again = pricer.quote(seeds[0])
    gap = float(max(np.max(np.abs(again[0] - traced[0][0])),
                    np.max(np.abs(again[1] - traced[0][1]))))
    idle, total = None, None
    if device == "cuda":
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof, \
                profiling.tracing():
            pricer.quote(seeds[-1] + 1)
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                idle, total = idle_by_span(json.load(f)["traceEvents"])
    return {"setup": setup, "prices": prices, "trace_gap": gap,
            "idle_by_span": idle, "idle_s": total}


if __name__ == "__main__":
    print(json.dumps(_job(json.load(sys.stdin))), flush=True)
