#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Builds the port's CUDA kernels from the sources in this checkout, holds each
kernel against its plain PyTorch version at the main path's shapes, drives
the full-width fit-then-stream price (1e7 paths x 365 steps, the bench.py
workload) through the kernels, checks the price against the same seed
through the plain versions, and times each kernel.

Usage (from the root of a checkout, one CUDA card):  python3 chip_smoke.py

Every phase prints one JSON line and ends in torch.cuda.synchronize(); any
failure exits non-zero.  The line before the last is the kernels' JSON
record and the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

# The bench.py workload.
N_STEPS, DT = 365, 1.0 / 252.0
CHUNK, N_CHUNKS, PILOT = 1 << 17, 76, 1 << 17
MARKET = dict(s0=100.0, xi=0.04, h=0.1, eta=1.5, rho=-0.4, r=0.04)
STRIKE, MATURITY, IS_CALL = 105.0, N_STEPS * DT, False
SEED = 42

# Tolerances.  Paths: the kernel and the plain version sum the fGN product
# and the log-price recursion in different orders (float32), ~2e-4
# relative as the JAX package's own matmul-cumsum against float64.  Sums
# and price: a boundary decision can flip only inside the float32 root
# band, which moves a chunk sum by far less than 1e-4 relative.
PATH_RTOL = 2e-4
SUM_RTOL = 1e-4

# H100 SXM peaks (NVIDIA data sheet): float32 without tensor cores, HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

REPLACES = {
    "pathgen": "montecarlooptionspricer_tpu/models/pathgen_pallas.py:522",
    "priced_chunk": "montecarlooptionspricer_tpu/models/pathgen_pallas.py:685",
}
SOURCE = "montecarlooptionspricer_tpu_torch/csrc/pathgen.cu"


class SmokeError(RuntimeError):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeError(what)


def time_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of fn() over reps runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(rows: int, n: int, out_bytes: int) -> tuple[float, str]:
    """Least time for one launch at this shape: the larger of the bytes
    that must move (Lt', vd and the policy rows read once, the output
    written once) over HBM bandwidth and the float32 operations (the
    triangular fGN product, 2 per multiply-add, plus ~8 per cell for the
    variance, increment, running sum and test) over the float32 peak."""
    bytes_ = 4 * (n * n + 4 * n) + out_bytes
    flops = 2.0 * rows * n * (n + 1) / 2 + 8.0 * rows * n
    t_bytes, t_ops = bytes_ / PEAK_BYTES, flops / PEAK_F32_FLOPS
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def plain_price(pc, engine, lsm_fit, pricer, seed: int) -> float:
    """The main path with every kernel replaced by its plain version."""
    consts, dev = pricer.consts, pricer.device
    k_pilot, (run, start) = engine._pilot_stream_keys(seed)
    pilot = pc.pathgen_from_noise_ref(consts, pc.philox_normals_ref(
        pc._fold_words(*k_pilot), PILOT, N_STEPS, device=dev))
    _, fits = lsm_fit(pilot, MARKET["r"], STRIKE, MATURITY, DT, IS_CALL, 2)
    table = pricer._make_rows(fits)
    ex0, p0 = pc.time0_value(fits, MARKET["s0"], STRIKE, IS_CALL)
    if bool(ex0):
        return p0
    total = 0.0
    for i in range(N_CHUNKS):
        noise = pc.philox_normals_ref(pc._fold_words(run, start + i), CHUNK,
                                      N_STEPS, device=dev)
        total += float(pc.priced_chunk_from_noise_ref(consts, table, noise,
                                                      STRIKE, IS_CALL))
    return total / (N_CHUNKS * CHUNK)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device; chip_smoke.py measures the GPU path "
              "only", file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parent
    if not (root / "montecarlooptionspricer_tpu_torch").is_dir():
        print("error: run chip_smoke.py from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(root))
    from montecarlooptionspricer_tpu_torch.kernels import build
    from montecarlooptionspricer_tpu_torch.models import engine
    from montecarlooptionspricer_tpu_torch.models import pathgen_cuda as pc
    from montecarlooptionspricer_tpu_torch.models.lsm import lsm_fit

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()

    # Phase 1: build.
    t0 = time.perf_counter()
    lib_path, nvcc_s = build.build(verbose=True)
    build.load()
    torch.cuda.synchronize()
    emit({"phase": "build", "library": lib_path.name,
          "nvcc_s": round(nvcc_s, 3),
          "seconds": round(time.perf_counter() - t0, 3)})

    cfg = engine.StreamConfig(n_paths=CHUNK * N_CHUNKS, n_steps=N_STEPS,
                              chunk_paths=CHUNK, pilot_paths=PILOT, dt=DT,
                              chunks_per_call=N_CHUNKS)
    pricer = engine.StreamingPricer(**MARKET, strike=STRIKE,
                                    maturity=MATURITY, is_call=IS_CALL,
                                    config=cfg, device=dev)
    consts = pricer.consts
    key = pc._fold_words(12345, 7)

    def rel_err(got, want):
        return float(torch.max(torch.abs(got - want) / torch.abs(want)))

    # Phase 2: K1 noise-in against its plain version, elementwise.
    noise = pc.philox_normals_ref(key, PILOT, N_STEPS, device=dev)
    got = pc.pathgen(consts, noise=noise)
    want = pc.pathgen_from_noise_ref(consts, noise)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), "K1 noise-in: non-finite paths")
    err_k1_noise = rel_err(got, want)
    emit({"phase": "k1_noise_in", "rows": PILOT, "n_steps": N_STEPS,
          "block_paths": consts.block_paths, "max_rel_err": err_k1_noise,
          "rtol": PATH_RTOL})
    check(err_k1_noise <= PATH_RTOL, "K1 noise-in disagrees")

    # Phase 3: K1 seeded against Philox reference -> plain, elementwise.
    got = pc.pathgen(consts, rows=PILOT, key=key)
    torch.cuda.synchronize()
    err_k1 = rel_err(got, want)
    abs_k1 = float(torch.max(torch.abs(got - want)))
    emit({"phase": "k1_seeded", "max_rel_err": err_k1,
          "max_abs_err": abs_k1, "rtol": PATH_RTOL})
    check(err_k1 <= PATH_RTOL, "K1 seeded disagrees with philox_normals_ref")
    del got, want

    # Phase 4: K2 against its plain version on a fitted policy table.
    fits = pricer.fit(engine._pilot_stream_keys(SEED)[0])
    table = pricer._make_rows(fits)
    got_n = pc.priced_chunk(consts, table, STRIKE, IS_CALL, noise=noise)
    want_n = pc.priced_chunk_from_noise_ref(consts, table, noise, STRIKE,
                                            IS_CALL)
    noise_s = pc.philox_normals_ref(key, CHUNK, N_STEPS, device=dev)
    got_s = pc.priced_chunk(consts, table, STRIKE, IS_CALL, rows=CHUNK,
                            key=key)
    want_s = pc.priced_chunk_from_noise_ref(consts, table, noise_s, STRIKE,
                                            IS_CALL)
    torch.cuda.synchronize()
    err_k2_noise = abs(float(got_n) / float(want_n) - 1.0)
    err_k2 = abs(float(got_s) / float(want_s) - 1.0)
    abs_k2 = abs(float(got_s) - float(want_s))
    emit({"phase": "k2", "rows": CHUNK, "noise_in_sum": float(got_n),
          "noise_in_plain": float(want_n), "noise_in_rel_err": err_k2_noise,
          "seeded_sum": float(got_s), "seeded_plain": float(want_s),
          "seeded_rel_err": err_k2, "rtol": SUM_RTOL})
    check(err_k2_noise <= SUM_RTOL and err_k2 <= SUM_RTOL,
          "K2 disagrees with its plain version")
    del noise, noise_s

    # Phase 5: the full-width main path, through the kernels.
    pc.pathgen.launches = 0
    pc.priced_chunk.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    price, stderr = pricer.price(SEED, with_stderr=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"pathgen": pc.pathgen.launches,
                "priced_chunk": pc.priced_chunk.launches}
    n_paths = CHUNK * N_CHUNKS
    price_plain = plain_price(pc, engine, lsm_fit, pricer, SEED)
    torch.cuda.synchronize()
    price_rel = abs(price / price_plain - 1.0)
    emit({"phase": "price", "n_paths": n_paths, "n_steps": N_STEPS,
          "price": price, "stderr": stderr, "wall_s": wall,
          "paths_per_s": n_paths / wall, "launches": launches,
          "plain_price": price_plain, "rel_err": price_rel,
          "rtol": SUM_RTOL})
    check(launches == {"pathgen": 1, "priced_chunk": N_CHUNKS},
          f"main path launches {launches}, want 1 and {N_CHUNKS}")
    check(math.isfinite(price) and 0.0 < price < STRIKE,
          f"price {price} outside (0, strike)")
    check(math.isfinite(stderr) and 0.0 < stderr < 0.01 * price,
          f"stderr {stderr} implausible")
    check(price_rel <= SUM_RTOL, "price disagrees with the plain path")

    # Phase 6: times at the main path's shapes.
    def k1():
        pc.pathgen(consts, rows=PILOT, key=key)

    def k1_plain():
        pc.pathgen_from_noise_ref(consts, pc.philox_normals_ref(
            key, PILOT, N_STEPS, device=dev))

    def k2():
        pc.priced_chunk(consts, table, STRIKE, IS_CALL, rows=CHUNK, key=key)

    def k2_plain():
        pc.priced_chunk_from_noise_ref(consts, table, pc.philox_normals_ref(
            key, CHUNK, N_STEPS, device=dev), STRIKE, IS_CALL)

    a = torch.randn((CHUNK, N_STEPS), device=dev)
    lt = consts.lt_half
    lib_ms = time_ms(torch, lambda: torch.matmul(a, lt), reps=20)
    k1_b, k1_by = bound_ms(PILOT, N_STEPS, 4 * PILOT * (N_STEPS + 1))
    k2_b, k2_by = bound_ms(CHUNK, N_STEPS,
                           4 * (CHUNK // consts.block_paths))
    times = {"pathgen": (time_ms(torch, k1, 10), time_ms(torch, k1_plain, 3),
                         k1_b, k1_by, abs_k1),
             "priced_chunk": (time_ms(torch, k2, 10),
                              time_ms(torch, k2_plain, 3), k2_b, k2_by,
                              abs_k2)}
    # Host-clock split of one main-path run: pilot + fit, then the stream.
    t0 = time.perf_counter()
    fits = pricer.fit(engine._pilot_stream_keys(SEED)[0])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pricer.price_with_fit(fits, SEED)
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    emit({"phase": "times", "card": smi, "library_call":
          "torch.matmul [131072,365]x[365,365] float32 (fGN product only)",
          "library_ms": lib_ms, "fit_s": fit_s, "stream_s": stream_s,
          "k1_ms": times["pathgen"][0], "k2_ms": times["priced_chunk"][0]})
    kernels = []
    for kname, (ms, plain_ms, b_ms, b_by, err) in times.items():
        kernels.append({"name": kname, "route": "cuda", "source": SOURCE,
                        "replaces": REPLACES[kname],
                        "launches": launches[kname], "max_abs_err": err,
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                        "bound_by": b_by, "library_ms": lib_ms})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeError as e:
        print(f"error: {e}", file=sys.stderr)
        sys.exit(1)
