"""Time K1's, K7's and P1's matmul's phases by difference, on the card.

Each form below runs seeded at 131,072 rows (K1 at 365 steps, K7 on a put
exercised once S <= 0.9 strike at 1825 steps; P1's matmul at the shape of
PERF.md's row, 66 blocks of 512 rows, 384 steps, k 19 float32 and 31
bf16) on its source's unit built again with phases left out
(``-DMCOP_PHASES``, csrc/build_unit.cuh: the seeded draw, the variance exp
and Euler step with W, the running sum, and the decision or the price
stores, or P1's draw of a0 and writes of a; the product always runs).
The wrapper launches each build in turn, the whole build first, and a
phase's ms is the difference of two builds' ms (CUDA events, the mean of
10 launches after a warm one).  A build without every phase computes
nothing that means anything: only its time is read.  Prints one JSON
line; exits 1 without a CUDA device::

    python -m montecarlooptionspricer_tpu_torch.kernels.phase_split
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import types

import torch

from . import build

# Phase masks of csrc/build_unit.cuh, the whole build first: each drops one
# more phase than the one before it.
DRAW, EULER, SCAN, OUT = 1, 2, 4, 8
MASKS = (DRAW | EULER | SCAN | OUT, DRAW | EULER | SCAN, DRAW | EULER,
         DRAW, 0)
PHASES = ("decision_or_stores", "scan", "euler", "draw")
# Each kernel's source.
STEMS = {"K1": "pathgen", "K7": "pathgen_tiled", "P1": "roofline"}
MARKET = dict(s0=100.0, xi=0.04, h=0.1, eta=1.5, r=0.04)
STRIKE, DT, ROWS = 105.0, 1.0 / 252.0, 1 << 17
# (kernel, steps, fgn_dtype, fgn_form, antithetic).
FORMS = (("K7", 1825, "float32", "chol", False),
         ("K7", 1825, "float32", "chol", True),
         ("K1", 365, "float32", "chol", False),
         ("K1", 365, "float32", "chol", True),
         ("K1", 365, "bfloat16", "chol", False),
         ("K1", 365, "float32", "spectral", True),
         ("P1", 384, "float32", None, False),
         ("P1", 384, "bfloat16", None, False))


def _unit(stem: str, bf16: bool, mask: int) -> tuple:
    """The unit of ``stem`` that runs its seeded (``bf16`` or float32)
    bodies, built with ``mask``, in build.UNITS' layout."""
    if stem == "roofline":   # one unit, both dtypes, no noise input
        suffix, flags = "", ()
    else:
        suffix = ("_bf16" if bf16 else "") + "_seeded"
        flags = ((build._BF16,) if bf16 else ()) + (build._SEEDED,)
    return (f"{stem}{suffix}_phases{mask}", build.CSRC / f"{stem}.cu",
            flags + (f"-DMCOP_PHASES={mask}",), suffix)


@contextlib.contextmanager
def _launching(entries: dict):
    """The wrappers launch the given C entries while this is open."""
    saved = build.load
    build.load = lambda: types.SimpleNamespace(**entries)
    try:
        yield
    finally:
        build.load = saved


def _time_ms(fn, reps: int = 10) -> float:
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


def _runner(kernel: str, n: int, dtype: str, fgn_form: str, anti: bool,
            dev):
    from .. import roofline as rl
    from ..models import pathgen_cuda as pc
    from ..models import pathgen_tiled_cuda as ptc

    if kernel == "P1":
        b = rl.orthogonal(n).to(dev).to(getattr(torch, dtype))
        k = 31 if dtype == "bfloat16" else 19
        return lambda: rl.matmul(7, b, 66, k)
    consts = pc.make_path_consts(*MARKET.values(), n, DT, dev,
                                 fgn_form=fgn_form, fgn_dtype=dtype)
    key = pc._fold_words(12345, 18)
    if kernel == "K1":
        return lambda: pc.pathgen(consts, rows=ROWS, key=key,
                                  antithetic=anti)
    table = torch.zeros((8, n), dtype=torch.float32, device=dev)
    table[0] = -1e30
    table[1] = math.log(0.9 * STRIKE)
    table[2] = torch.exp(-MARKET["r"] * DT * torch.arange(
        1, n + 1, dtype=torch.float32, device=dev))
    return lambda: ptc.tiled_priced_chunk(consts, table, STRIKE, False,
                                          rows=ROWS, key=key,
                                          antithetic=anti)


def main() -> int:
    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    build.load()
    wanted = {(STEMS[k], d == "bfloat16" and k != "P1")
              for k, _, d, _, _ in FORMS}
    units = [(key, mask, _unit(*key, mask))
             for key in sorted(wanted) for mask in MASKS[1:]]
    paths, seconds, _ = build.build(units=tuple(u for _, _, u in units))
    variants = {(key, mask): build.bind(path, key[0], unit[3])
                for (key, mask, unit), path in zip(units, paths)}
    records = []
    for kernel, n, dtype, fgn_form, anti in FORMS:
        run = _runner(kernel, n, dtype, fgn_form, anti, dev)
        key = (STEMS[kernel], dtype == "bfloat16" and kernel != "P1")
        ms = [_time_ms(run)]
        for mask in MASKS[1:]:
            with _launching(variants[key, mask]):
                ms.append(_time_ms(run))
        records.append({
            "kernel": kernel, "n_steps": n, "fgn_dtype": dtype,
            "fgn_form": fgn_form, "antithetic": anti,
            "ms_by_mask": dict(zip(MASKS, ms)),
            "phase_ms": {**dict(zip(PHASES, (a - b for a, b in
                                             zip(ms, ms[1:])))),
                         "product": ms[-1]}})
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(json.dumps({"phase_split": records, "rows": ROWS,
                      "build_s": seconds, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
