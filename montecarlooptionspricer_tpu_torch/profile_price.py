"""Where one full-width price spends its time on the card.

Runs the bench.py workload (1e7 paths x 365 steps, the same shape as
``chip_smoke.py``; ``--steps 1825`` takes the long horizon of the same
option, maturity steps/252) through ``StreamingPricer`` once to warm up,
then times
its two stages, the pilot fit (K1, or K6 past the single-tile horizon, +
the LSM fit) and the stream (tables + K2 or K7 per chunk), first on the host clock without a profiler and then under
``torch.profiler``.  For each stage it prints one JSON line: host wall
seconds, device kernel launches and busy seconds from the trace, the idle
share 1 - busy / wall (against the unprofiled and the profiled wall), and
the kernels that take the most device time.

Usage (one CUDA card):
  python -m montecarlooptionspricer_tpu_torch.profile_price [--steps N]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time


def _stages(pricer, seed):
    from .models.engine import _pilot_stream_keys

    state = {}

    def fit():
        state["fits"] = pricer.fit(_pilot_stream_keys(seed)[0])

    def stream():
        pricer.price_with_fit(state["fits"], seed)

    return (("fit", fit), ("stream", stream))


def _timed(torch, fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def main(argv=None) -> int:
    args = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    args.add_argument("--steps", type=int, default=365)
    steps = args.parse_args(argv).steps
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 1
    from .models import engine

    cfg = engine.StreamConfig(n_paths=76 << 17, n_steps=steps,
                              chunk_paths=1 << 17, pilot_paths=1 << 17,
                              dt=1.0 / 252.0, chunks_per_call=76)
    pricer = engine.StreamingPricer(100.0, 0.04, 0.1, 1.5, -0.4, 0.04,
                                    105.0, steps / 252, False, cfg,
                                    device="cuda")
    seed = 42
    pricer.price(seed)          # build the kernels, warm every path
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    for name, fn in _stages(pricer, seed):
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
            "kernel_family": pricer.kernel_family, "card": card,
            "wall_s": wall_plain,
            "wall_profiled_s": wall_prof, "device_launches": len(kernels),
            "device_busy_s": busy_s,
            "idle_share": 1.0 - busy_s / wall_plain,
            "idle_share_profiled": 1.0 - busy_s / wall_prof,
            "top_kernels_us": [[k[:80], v] for k, v in top]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
