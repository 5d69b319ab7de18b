#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Builds the port's CUDA kernels from the sources in this checkout (one nvcc
per source, all started together), holds each kernel against its plain
PyTorch version at its path's shapes, and drives two full-width
fit-then-stream prices through the kernels, each with the launch counts set
to 0 just before it and read just after:

* the main path, 1e7 paths x 365 steps (the bench.py workload), through
  the single-tile kernels K1 and K2, checked against the same seed through
  the plain versions;
* the long horizon, 1e7 paths x 1825 steps (the reference's longest), through
  the step-tiled kernels K6 and K7, checked against the plain versions on
  its first 8 chunks under the same fit.

It also times K2 against K7 per chunk across horizons (the crossover that
sets engine.SINGLE_TILE_MAX_STEPS) and times each kernel.

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

# The long horizon: the same market and strike at the reference's longest
# horizon (steps = floor(maturity * 252) with an 1825-day cap), so the
# maturity is 1825/252.  The plain versions price its first LONG_CHECKED
# chunks under the kernels' fit.
LONG_STEPS, LONG_CHUNKS, LONG_CHECKED = 1825, 76, 8
LONG_MATURITY = LONG_STEPS * DT
K6_VS_K1_STEPS = 1008
CROSSOVER_STEPS = (365, 504, 1008, 1512)

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
    "tiled_pathgen":
        "montecarlooptionspricer_tpu/models/pathgen_pallas_tiled.py:267",
    "tiled_priced_chunk":
        "montecarlooptionspricer_tpu/models/pathgen_pallas_tiled.py:395",
}
SOURCES = {
    "pathgen": "montecarlooptionspricer_tpu_torch/csrc/pathgen.cu",
    "priced_chunk": "montecarlooptionspricer_tpu_torch/csrc/pathgen.cu",
    "tiled_pathgen": "montecarlooptionspricer_tpu_torch/csrc/pathgen_tiled.cu",
    "tiled_priced_chunk":
        "montecarlooptionspricer_tpu_torch/csrc/pathgen_tiled.cu",
}


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


def kernel_record(kname: str, launches: dict, ms: float, plain_ms: float,
                  b_ms: float, b_by: str, err: float,
                  library_ms: float) -> dict:
    """One kernel's entry of the kernels line."""
    return {"name": kname, "route": "cuda", "source": SOURCES[kname],
            "replaces": REPLACES[kname], "launches": launches[kname],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms}


def plain_stream_mean(pc, engine, pricer, fits, seed: int, n_chunks: int,
                      strike: float) -> float:
    """Mean discounted payoff of the first n_chunks chunks of seed's stream
    under ``fits``, through the plain versions (time-0 exercise decided as
    the engine decides it)."""
    consts, dev = pricer.consts, pricer.device
    _, (run, start) = engine._pilot_stream_keys(seed)
    table = pricer._make_rows(fits)
    ex0, p0 = pc.time0_value(fits, MARKET["s0"], strike, IS_CALL)
    if bool(ex0):
        return p0
    total = 0.0
    for i in range(n_chunks):
        noise = pc.philox_normals_ref(pc._fold_words(run, start + i), CHUNK,
                                      consts.n_steps, device=dev)
        total += float(pc.priced_chunk_from_noise_ref(consts, table, noise,
                                                      strike, IS_CALL))
    return total / (n_chunks * CHUNK)


def plain_price(pc, engine, lsm_fit, pricer, seed: int) -> float:
    """The main path with every kernel replaced by its plain version."""
    consts, dev = pricer.consts, pricer.device
    k_pilot, _ = engine._pilot_stream_keys(seed)
    pilot = pc.pathgen_from_noise_ref(consts, pc.philox_normals_ref(
        pc._fold_words(*k_pilot), PILOT, N_STEPS, device=dev))
    _, fits = lsm_fit(pilot, MARKET["r"], STRIKE, MATURITY, DT, IS_CALL, 2)
    return plain_stream_mean(pc, engine, pricer, fits, seed, N_CHUNKS,
                             STRIKE)


def threshold_table(torch, n: int, dev):
    """A log-boundary table that exercises a put once S <= 0.9 strike:
    timing input for the crossover, where K2 and K7 read the same table."""
    table = torch.zeros((8, n), dtype=torch.float32, device=dev)
    table[0] = -1e30
    table[1] = math.log(0.9 * STRIKE)
    t = torch.arange(1, n + 1, dtype=torch.float32, device=dev) * DT
    table[2] = torch.exp(-MARKET["r"] * t)
    return table


def long_horizon_phases(torch, pc, ptc, engine, smi, dev, key, rel_err,
                        reset_counts, read_counts) -> list:
    """The step-tiled kernels K6 and K7: each against its plain version at
    1825 steps, seeded K6 against seeded K1, the full-width long-horizon
    price through them, the K2/K7 crossover and their times.  Returns their
    entries of the kernels line."""
    cfg = engine.StreamConfig(n_paths=CHUNK * LONG_CHUNKS, n_steps=LONG_STEPS,
                              chunk_paths=CHUNK, pilot_paths=PILOT, dt=DT,
                              chunks_per_call=LONG_CHUNKS)
    pricer = engine.StreamingPricer(**MARKET, strike=STRIKE,
                                    maturity=LONG_MATURITY, is_call=IS_CALL,
                                    config=cfg, device=dev)
    consts = pricer.consts
    check(pricer.kernel_family == "tiled",
          f"{LONG_STEPS} steps resolved to {pricer.kernel_family!r}")

    # K6 noise-in and seeded against its plain version, elementwise.
    noise = pc.philox_normals_ref(key, PILOT, LONG_STEPS, device=dev)
    want = ptc.pathgen_from_noise_ref(consts, noise)
    got = ptc.tiled_pathgen(consts, noise=noise)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), "K6 noise-in: non-finite paths")
    err_noise = rel_err(got, want)
    emit({"phase": "k6_noise_in", "rows": PILOT, "n_steps": LONG_STEPS,
          "block_paths": ptc.block_paths_for(PILOT),
          "max_rel_err": err_noise, "rtol": PATH_RTOL})
    check(err_noise <= PATH_RTOL, "K6 noise-in disagrees")
    del got, noise
    got = ptc.tiled_pathgen(consts, rows=PILOT, key=key)
    torch.cuda.synchronize()
    err_k6 = rel_err(got, want)
    abs_k6 = float(torch.max(torch.abs(got - want)))
    emit({"phase": "k6_seeded", "max_rel_err": err_k6,
          "max_abs_err": abs_k6, "rtol": PATH_RTOL})
    check(err_k6 <= PATH_RTOL, "K6 seeded disagrees with philox_normals_ref")
    del got, want

    # Seeded K6 against seeded K1 with one key: one stream for both.
    mid = pc.make_path_consts(MARKET["s0"], MARKET["xi"], MARKET["h"],
                              MARKET["eta"], MARKET["r"], K6_VS_K1_STEPS, DT,
                              dev)
    one = pc.pathgen(mid, rows=PILOT, key=key)
    tiled = ptc.tiled_pathgen(mid, rows=PILOT, key=key)
    torch.cuda.synchronize()
    err_k6_k1 = rel_err(tiled, one)
    emit({"phase": "k6_vs_k1", "rows": PILOT, "n_steps": K6_VS_K1_STEPS,
          "k1_block_paths": mid.block_paths, "max_rel_err": err_k6_k1,
          "rtol": PATH_RTOL})
    check(err_k6_k1 <= PATH_RTOL, "seeded K6 and K1 draw different paths")
    del one, tiled, mid

    # The full-width long-horizon price, through K6 and K7.
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    price, stderr = pricer.price(SEED, with_stderr=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    # Host-clock split: pilot + fit, then the stream.
    t0 = time.perf_counter()
    fits = pricer.fit(engine._pilot_stream_keys(SEED)[0])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pricer.price_with_fit(fits, SEED)
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    fits_finite = all(bool(torch.isfinite(t).all()) for t in fits)
    checked = pricer.price_with_fit(fits, SEED,
                                    n_paths=LONG_CHECKED * CHUNK)
    checked_plain = plain_stream_mean(pc, engine, pricer, fits, SEED,
                                      LONG_CHECKED, STRIKE)
    checked_rel = abs(checked / checked_plain - 1.0)
    n_paths = CHUNK * LONG_CHUNKS
    emit({"phase": "price_long", "card": smi, "n_paths": n_paths,
          "n_steps": LONG_STEPS, "maturity": LONG_MATURITY,
          "kernel_family": pricer.kernel_family, "price": price,
          "stderr": stderr, "wall_s": wall, "paths_per_s": n_paths / wall,
          "fit_s": fit_s, "stream_s": stream_s, "launches": launches,
          "fits_finite": fits_finite, "checked_chunks": LONG_CHECKED,
          "checked_price": checked, "checked_plain_price": checked_plain,
          "checked_rel_err": checked_rel, "rtol": SUM_RTOL})
    check(launches == {"pathgen": 0, "priced_chunk": 0, "tiled_pathgen": 1,
                       "tiled_priced_chunk": LONG_CHUNKS},
          f"long-horizon launches {launches}, want 1 and {LONG_CHUNKS}")
    check(math.isfinite(price) and 0.0 < price < STRIKE,
          f"long-horizon price {price} outside (0, strike)")
    check(math.isfinite(stderr) and stderr > 0.0,
          f"long-horizon stderr {stderr} not finite and positive")
    check(fits_finite, "long-horizon fit has non-finite coefficients")
    check(checked_rel <= SUM_RTOL,
          "long-horizon price disagrees with the plain path")

    # K7 noise-in and seeded against its plain version on the fitted table.
    table = pricer._make_rows(fits)
    noise = pc.philox_normals_ref(key, CHUNK, LONG_STEPS, device=dev)
    got_n = float(ptc.tiled_priced_chunk(consts, table, STRIKE, IS_CALL,
                                         noise=noise))
    got_s = float(ptc.tiled_priced_chunk(consts, table, STRIKE, IS_CALL,
                                         rows=CHUNK, key=key))
    want = float(ptc.priced_chunk_from_noise_ref(consts, table, noise, STRIKE,
                                                 IS_CALL))
    del noise
    err_n, err_s = abs(got_n / want - 1.0), abs(got_s / want - 1.0)
    abs_k7 = abs(got_s - want)
    emit({"phase": "k7", "rows": CHUNK, "n_steps": LONG_STEPS,
          "noise_in_sum": got_n, "seeded_sum": got_s, "plain_sum": want,
          "noise_in_rel_err": err_n, "seeded_rel_err": err_s,
          "rtol": SUM_RTOL})
    check(err_n <= SUM_RTOL and err_s <= SUM_RTOL,
          "K7 disagrees with its plain version")

    # Crossover: K2 against K7 per chunk across horizons, on one key and
    # one table (their sums must agree too).
    horizons = []
    for n in CROSSOVER_STEPS:
        c = pc.make_path_consts(MARKET["s0"], MARKET["xi"], MARKET["h"],
                                MARKET["eta"], MARKET["r"], n, DT, dev)
        tab = threshold_table(torch, n, dev)

        def run_k2(c=c, tab=tab):
            return pc.priced_chunk(c, tab, STRIKE, IS_CALL, rows=CHUNK,
                                   key=key)

        def run_k7(c=c, tab=tab):
            return ptc.tiled_priced_chunk(c, tab, STRIKE, IS_CALL, rows=CHUNK,
                                          key=key)

        s2, s7 = float(run_k2()), float(run_k7())
        rel = abs(s7 / s2 - 1.0)
        horizons.append({"n_steps": n, "k2_block_paths": c.block_paths,
                         "k2_ms": time_ms(torch, run_k2, 3),
                         "k7_ms": time_ms(torch, run_k7, 3),
                         "sum_rel_err": rel})
        check(rel <= SUM_RTOL, f"K2 and K7 sums disagree at {n} steps")
    emit({"phase": "crossover", "card": smi, "rows": CHUNK,
          "table": "put exercised once S <= 0.9 strike",
          "horizons": horizons,
          "single_tile_max_steps": engine.SINGLE_TILE_MAX_STEPS})

    # Times at the long horizon's shapes.
    def k6():
        ptc.tiled_pathgen(consts, rows=PILOT, key=key)

    def k6_plain():
        ptc.pathgen_from_noise_ref(consts, pc.philox_normals_ref(
            key, PILOT, LONG_STEPS, device=dev))

    def k7():
        ptc.tiled_priced_chunk(consts, table, STRIKE, IS_CALL, rows=CHUNK,
                               key=key)

    def k7_plain():
        ptc.priced_chunk_from_noise_ref(consts, table, pc.philox_normals_ref(
            key, CHUNK, LONG_STEPS, device=dev), STRIKE, IS_CALL)

    a = torch.randn((CHUNK, LONG_STEPS), device=dev)
    lib_ms = time_ms(torch, lambda: torch.matmul(a, consts.lt_half), reps=10)
    del a
    k6_b, k6_by = bound_ms(PILOT, LONG_STEPS, 4 * PILOT * (LONG_STEPS + 1))
    k7_b, k7_by = bound_ms(CHUNK, LONG_STEPS,
                           4 * (CHUNK // ptc.block_paths_for(CHUNK)))
    k6_ms, k7_ms = time_ms(torch, k6, 5), time_ms(torch, k7, 5)
    records = [
        kernel_record("tiled_pathgen", launches, k6_ms,
                      time_ms(torch, k6_plain, 2), k6_b, k6_by, abs_k6,
                      lib_ms),
        kernel_record("tiled_priced_chunk", launches, k7_ms,
                      time_ms(torch, k7_plain, 2), k7_b, k7_by, abs_k7,
                      lib_ms)]
    emit({"phase": "times_long", "card": smi, "library_call":
          "torch.matmul [131072,1825]x[1825,1825] float32 (fGN product "
          "only)", "library_ms": lib_ms, "k6_ms": k6_ms, "k7_ms": k7_ms,
          "k6_bound_ms": k6_b, "k7_bound_ms": k7_b,
          "k6_plain_ms": records[0]["plain_ms"],
          "k7_plain_ms": records[1]["plain_ms"]})
    return records


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
    from montecarlooptionspricer_tpu_torch.models import (
        pathgen_tiled_cuda as ptc)
    from montecarlooptionspricer_tpu_torch.models.lsm import lsm_fit

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()

    # Launch counters of every kernel wrapper.
    wrappers = {"pathgen": pc.pathgen, "priced_chunk": pc.priced_chunk,
                "tiled_pathgen": ptc.tiled_pathgen,
                "tiled_priced_chunk": ptc.tiled_priced_chunk}

    def reset_counts():
        for fn in wrappers.values():
            fn.launches = 0

    def read_counts():
        return {k: fn.launches for k, fn in wrappers.items()}

    # Phase 1: build.
    t0 = time.perf_counter()
    lib_paths, nvcc_s = build.build(verbose=True)
    build.load()
    torch.cuda.synchronize()
    emit({"phase": "build", "libraries": [p.name for p in lib_paths],
          "nvcc_wall_s": round(nvcc_s, 3),
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
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    price, stderr = pricer.price(SEED, with_stderr=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    n_paths = CHUNK * N_CHUNKS
    price_plain = plain_price(pc, engine, lsm_fit, pricer, SEED)
    torch.cuda.synchronize()
    price_rel = abs(price / price_plain - 1.0)
    emit({"phase": "price", "n_paths": n_paths, "n_steps": N_STEPS,
          "price": price, "stderr": stderr, "wall_s": wall,
          "paths_per_s": n_paths / wall, "launches": launches,
          "plain_price": price_plain, "rel_err": price_rel,
          "rtol": SUM_RTOL})
    check(launches == {"pathgen": 1, "priced_chunk": N_CHUNKS,
                       "tiled_pathgen": 0, "tiled_priced_chunk": 0},
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
    k1_ms, k2_ms = time_ms(torch, k1, 10), time_ms(torch, k2, 10)
    kernels = [
        kernel_record("pathgen", launches, k1_ms, time_ms(torch, k1_plain, 3),
                      k1_b, k1_by, abs_k1, lib_ms),
        kernel_record("priced_chunk", launches, k2_ms,
                      time_ms(torch, k2_plain, 3), k2_b, k2_by, abs_k2,
                      lib_ms)]
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
          "k1_ms": k1_ms, "k2_ms": k2_ms})
    del a, table

    kernels += long_horizon_phases(torch, pc, ptc, engine, smi, dev, key,
                                   rel_err, reset_counts, read_counts)
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
