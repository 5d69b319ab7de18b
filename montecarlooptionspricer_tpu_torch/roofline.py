"""P1: the roofline probes of the path kernels, measured on the card.

Counterpart: ``parity/vpu_roofline.py``, which measures the TPU's
ceilings with two Pallas microkernels; their Hopper counterparts live in
``csrc/roofline.cu``.

* P1/normals (``nrm_kernel``, ``pallas_call`` at :110): each block of 512
  columns draws ``k * unroll`` planes of [512, 512] Box-Muller normals from
  the path kernels' Philox stream and accumulates them; ``with_exp`` takes
  exp(plane * 1e-3) first, ``fma`` applies that many dependent
  plane * 0.999999 + 1e-7 (``FMA_CHAIN``).  Output: the [grid, 512] column
  sums (``stripe`` cuts JAX's [grid * 8, 128] from them).
* P1/matmul (``mm_kernel``, ``pallas_call`` at :177): a0 ~ normals [512,
  s_pad] per block (the N plane of the stream), then ``k * unroll``
  dependent steps a = a @ B, each by K6/K7's own tile product
  (``csrc/slab_tile.cuh``): float32 on the CUDA cores when B is float32,
  bf16 inputs on the tensor cores with float32 sums when B is
  torch.bfloat16, a rounded to bf16 at every step.  Output: the [grid,
  s_pad] column sums.

The wrappers run the plain versions for tensors (or a device) on the CPU
and launch the kernels on a CUDA device; nothing falls back.  ``measure``
times them with CUDA events and takes the rates from two-point deltas
that cancel the launch and the loop: unroll 3 against 1 at fixed k (the
normals and the matmul), with_exp and fma against the plain draw at the
same k (exp and FMA rates).  ``chol_cell_bound`` turns the rates into the
per-cell serial and overlap bounds of a chol kernel from its counts of
normals, exps, elementwise operations and multiply-adds per cell, as the
script does (``:212-245``); ``PORT_CELL_COUNTS`` are the port's counts.

Usage, on the card:
  python -m montecarlooptionspricer_tpu_torch.roofline --device cuda
      [--steps 365] [--paths-per-sec R --kernel K2 --fgn-dtype float32]
It prints one JSON line of the measured rates, their shares of the data
sheet's and, given the kernel's measured rate in paths per second, the
fraction of its ceiling it reaches.  Without a CUDA device it exits 1.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys

import numpy as np
import torch

from .models import pathgen_cuda as pc

BLOCK = LANES = 512         # a normals plane [BLOCK, LANES]; a matmul block
FMA_CHAIN = 8               # the FMA chain's length (the script's J)
MM_SPLIT = 4                # CUDA blocks of 128 rows per block of 512 rows
# rms of x - bf16(x), rounding to nearest even, for x standard normal.
BF16_ROUNDING_RMS = 1.7e-3
# H100 SXM data sheet (NVIDIA): float32 FMA slots, 132 SMs x 128 lanes x
# 1.98 GHz (67 TFLOP/s); dense bf16 tensor cores, 989 TFLOP/s.
PEAK_FMA_PER_S = 33.5e12
PEAK_BF16_MAC_PER_S = 989e12 / 2


def _launch_normals(key, grid, k, unroll, with_exp, fma, out, device):
    from .kernels import build

    err = build.load().mcop_roofline_normals(
        key & pc._U32, grid, k, unroll, int(bool(with_exp)), int(fma),
        out.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    pc._check(err, "roofline normals")


def normals_ref(key: int, grid: int, k: int, unroll: int = 1,
                with_exp: bool = False, fma: int = 0,
                device="cpu", block0: int = 0) -> torch.Tensor:
    """Plain P1/normals: [grid, 512] float32 column sums of blocks
    block0 .. block0 + grid - 1.  Column c's normals of plane t are both
    planes (N, W) of ``philox_normals_ref``'s row c over steps
    256 t .. 256 t + 255: the kernel's step pair 128 t + q gives rows
    4q .. 4q + 3 of the plane.  The FMA chain runs in float64 and rounds
    once per step, as the kernel's fused multiply-add does."""
    planes = k * unroll
    nw = pc.philox_normals_ref(key, grid * LANES, planes * BLOCK // 2,
                               device, row0=block0 * LANES)
    if with_exp:
        nw = torch.exp(nw * 1e-3)
    if fma:
        a = float(np.float32(0.999999))
        b = float(np.float32(1e-7))
        for _ in range(fma):
            nw = (nw.double() * a + b).float()
    return nw.sum(dim=(0, 2)).reshape(grid, LANES)


def normals(key: int, grid: int, k: int, unroll: int = 1,
            with_exp: bool = False, fma: int = 0,
            device="cuda") -> torch.Tensor:
    """P1/normals: [grid, 512] float32 column sums of ``k * unroll`` planes
    of [512, 512] normals per block of 512 columns, from the stream of
    ``key``; ``with_exp`` exp(plane * 1e-3) first, or ``fma`` (0 or
    FMA_CHAIN) dependent plane * 0.999999 + 1e-7."""
    device = torch.device(device)
    if fma not in (0, FMA_CHAIN) or (with_exp and fma):
        raise ValueError(f"fma must be 0 or {FMA_CHAIN}, and not with "
                         "with_exp")
    if device.type == "cpu":
        return normals_ref(key, grid, k, unroll, with_exp, fma)
    out = torch.empty((grid, LANES), dtype=torch.float32, device=device)
    _launch_normals(key, grid, k, unroll, with_exp, fma, out, device)
    normals.launches += 1
    return out


normals.launches = 0


def matmul_ref(key: int, b: torch.Tensor, grid: int, k: int,
               unroll: int = 1) -> torch.Tensor:
    """Plain P1/matmul: [grid, s_pad] float32 column sums of each block's
    512 rows after ``k * unroll`` steps a = a @ B from a0, the N plane of
    ``philox_normals_ref`` (rows of the block, s_pad steps); under a bf16
    B, a rounds to bf16 before every step and the product is the float32
    one of the bf16 values."""
    s_pad = b.shape[0]
    bf16 = b.dtype == torch.bfloat16
    bm = b.to(torch.float32)
    a = pc.philox_normals_ref(key, grid * BLOCK, s_pad, b.device)[0]
    for _ in range(k * unroll):
        a = pc._matmul_f32(pc.round_bf16(a) if bf16 else a, bm)
    return a.reshape(grid, BLOCK, s_pad).sum(dim=1)


def matmul(key: int, b: torch.Tensor, grid: int, k: int,
           unroll: int = 1) -> torch.Tensor:
    """P1/matmul on B's device: [grid, s_pad] float32 column sums after
    ``k * unroll`` dependent steps a = a @ B per block of 512 rows, B
    [s_pad, s_pad] (s_pad a multiple of 128) float32 (the CUDA cores) or
    torch.bfloat16 (the tensor cores)."""
    s_pad = b.shape[0]
    if (b.dim() != 2 or b.shape[1] != s_pad or s_pad % 128
            or b.dtype not in (torch.float32, torch.bfloat16)):
        raise ValueError(f"B must be [s_pad, s_pad] float32 or bfloat16, "
                         f"s_pad a multiple of 128; got {tuple(b.shape)} "
                         f"{b.dtype}")
    if b.device.type == "cpu":
        return matmul_ref(key, b, grid, k, unroll)
    if not b.is_contiguous():
        raise ValueError("B must be contiguous")
    from .kernels import build

    bf16 = b.dtype == torch.bfloat16
    # a's two buffers, and under bf16 their bf16 shadows in a third plane.
    work = torch.empty((3 if bf16 else 2, grid * BLOCK, s_pad),
                       dtype=torch.float32, device=b.device)
    out = torch.empty((grid * MM_SPLIT, s_pad), dtype=torch.float32,
                      device=b.device)
    err = build.load().mcop_roofline_matmul(
        key & pc._U32, b.data_ptr(), grid, s_pad, k, unroll, int(bf16),
        work.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(b.device).cuda_stream)
    pc._check(err, "roofline matmul")
    matmul.launches += 1
    return out.reshape(grid, MM_SPLIT, s_pad).sum(dim=1)


matmul.launches = 0


def chain_atol(bf16: bool, steps: int, scale: float) -> float:
    """Tolerance of P1/matmul against its plain version after ``steps``
    dependent steps (``scale``: the largest column sum).  Float32: the
    sums of the two orders drift apart by a random walk (B orthogonal
    keeps the norm), so the 3-step 1e-5 of the scale grows as the root of
    the steps.  bf16: a float32 difference of an ulp flips a rounding, B
    spreads it over the row, and within a few steps the two chains round
    independently: each step adds to each an error of rms 1.7e-3 an
    element (rounding a standard normal to bf16; the rows keep rms 1, a0
    standard normal and B orthogonal), so a column sum over a block's 512
    rows differs by rms sqrt(2 * 512 * steps) 1.7e-3; held to 6 of those
    (a wrong fragment or step moves a sum by the scale)."""
    if bf16:
        return 6.0 * math.sqrt(2 * BLOCK * steps) * BF16_ROUNDING_RMS
    return 1e-5 * math.sqrt(steps / 3) * scale


def stripe(out: torch.Tensor) -> torch.Tensor:
    """JAX's output layout of either probe: each block's lanes 0-127 of
    its column sums, repeated on 8 rows: [grid * 8, 128]."""
    grid = out.shape[0]
    return out[:, None, :128].expand(grid, 8, 128).reshape(grid * 8, 128)


def orthogonal(s_pad: int, seed: int = 0) -> torch.Tensor:
    """A random orthogonal [s_pad, s_pad] float32 matrix (QR of a numpy
    normal matrix, signs fixed by R's diagonal): unlike the script's
    identity, it moves every entry, so a misplaced fragment shows."""
    rng = np.random.default_rng(seed)
    q, r = np.linalg.qr(rng.normal(size=(s_pad, s_pad)))
    return torch.tensor(q * np.sign(np.diag(r))[None, :],
                        dtype=torch.float32)


# ---------------------------------------------------------------------------
# Accounting.

@dataclasses.dataclass(frozen=True)
class Rates:
    """Measured rates: normals, exps and FMA slots per second, and
    multiply-adds per second of the [512, s_pad] @ [s_pad, s_pad] product
    in float32 (CUDA cores) and bf16 (tensor cores), by the probe (the
    kernels' own tile product) and by the library's chain at the same
    shape (``lib_mm_*``, 0 when not measured)."""

    normals: float
    exp: float
    fma: float
    mm_f32: float
    mm_bf16: float
    lib_mm_f32: float = 0.0
    lib_mm_bf16: float = 0.0

    def mm(self, fgn_dtype: str) -> float:
        """The product's rate in ``fgn_dtype``: the faster of the probe's
        and the library's, since the probe's is that of the port's own
        code, which a library's product at the same shape may beat."""
        if pc.check_fgn_dtype(fgn_dtype):
            return max(self.mm_bf16, self.lib_mm_bf16)
        return max(self.mm_f32, self.lib_mm_f32)


def chol_cell_bound(rates: Rates, normals: float, exps: float,
                    elementwise: float, macs: float,
                    fgn_dtype: str = "float32") -> tuple:
    """(serial, overlap) seconds per cell of a chol kernel that does, per
    cell, ``normals`` draws, ``exps`` exps, ``elementwise`` other
    operations and ``macs`` multiply-adds of its matrix products (in
    ``fgn_dtype``), as ``parity/vpu_roofline.py:212-245`` bounds it: the
    elementwise side 2/r_nrm + 1/r_exp + 17/r_fma there, the products
    2 s_pad / r_mxu; serial charges their sum, overlap their larger."""
    t_elem = normals / rates.normals + exps / rates.exp \
        + elementwise / rates.fma
    t_mm = macs / rates.mm(fgn_dtype)
    return t_elem + t_mm, max(t_elem, t_mm)


# The TPU kernel's counts per padded cell (the script's): two normals (N,
# W), one exp, ~17 elementwise operations, and the fGN and cumsum matmuls,
# s_pad multiply-adds each.
TPU_CELL_COUNTS = dict(normals=2, exps=1, elementwise=17)


def tpu_cell_macs(n_steps: int) -> int:
    return 2 * pc._round_up(n_steps, pc.LANE)


# The port's counts per cell (csrc/pathgen.cu, csrc/pathgen_tiled.cu), on
# n cells a path, no padded steps, no cumsum matmul: two normals (N, W);
# the variance exp (K1 and K6 also the exp of the written price); the
# Euler increment's 8 operations (x + vd, v = sv sv, v/2, r - v/2, x dt,
# w sqrt(dt), sv (...), the sum) and the running sum's add, and for the
# priced kernels the boundary test's two compares; and the triangle's
# (n + 1) / 2 multiply-adds a cell on average.
PORT_CELL_COUNTS = {"K1": dict(normals=2, exps=2, elementwise=9),
                    "K2": dict(normals=2, exps=1, elementwise=11)}
PORT_CELL_COUNTS["K6"] = PORT_CELL_COUNTS["K1"]
PORT_CELL_COUNTS["K7"] = PORT_CELL_COUNTS["K2"]


def ceiling_ms(rates: Rates, kernel: str, rows: int, n_steps: int,
               fgn_dtype: str = "float32", overlap: bool = False) -> float:
    """The P1 ceiling of one launch of ``kernel`` (K1, K2, K6 or K7, plain
    form) at ``rows`` x ``n_steps`` on the port's counts: cells x
    (2/r_nrm + e_exp/r_exp + e/r_fma) + multiply-adds / r_mm, the serial
    sum (``overlap``: the larger of the two, for units that run side by
    side, as the tensor cores beside the CUDA cores do).  It is a time at
    the measured rates, not a bound of the card: the normals, exp and FMA
    rates are those of the kernels' own device functions, and r_mm is
    ``Rates.mm``."""
    serial, overlapped = chol_cell_bound(
        rates, **PORT_CELL_COUNTS[kernel], macs=(n_steps + 1) / 2,
        fgn_dtype=fgn_dtype)
    return rows * n_steps * (overlapped if overlap else serial) * 1e3


# ---------------------------------------------------------------------------
# Measurement (the card only).

def _time_ms(fn, reps: int = 3, trials: int = 3) -> float:
    """Least over ``trials`` of the mean device time of ``reps`` runs of
    fn(), by CUDA events, after one warm-up run."""
    fn()
    torch.cuda.synchronize()
    best = math.inf
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return best


def _calibrated_k(fn, k0: int, target_ms: float, k_max: int) -> int:
    """The k at which fn(k) takes about target_ms, from one timing at k0."""
    t0 = _time_ms(lambda: fn(k0), reps=1, trials=1)
    return int(min(k_max, max(1, round(k0 * target_ms / max(t0, 1e-3)))))


def measure(device, n_steps: int = 365, target_ms: float = 8.0,
            key: int = 7) -> dict:
    """Rates of this card from the two probes, with the launch times and
    shapes they come from and the library yardsticks: ``torch.randn`` of
    one launch's normals, and the ``torch.matmul`` chain of one launch's
    k steps at the same shape in float32 (TF32 off) and bf16.  Each probe
    is sized to fill the card (the normals 4 blocks an SM, the matmul
    2 CUDA blocks an SM) and its k chosen so that the unroll-1 launch takes
    about ``target_ms``."""
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("the roofline probes measure a CUDA device")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        grid = 4 * sms
        k = _calibrated_k(lambda kk: normals(key, grid, kk, device=device),
                          2, target_ms, 256)
        cells = grid * LANES * BLOCK * k        # normals of one launch
        t_n1 = _time_ms(lambda: normals(key, grid, k, 1, device=device))
        t_n3 = _time_ms(lambda: normals(key, grid, k, 3, device=device))
        t_exp = _time_ms(lambda: normals(key, grid, k, 1, True,
                                         device=device))
        t_fma = _time_ms(lambda: normals(key, grid, k, 1, False, FMA_CHAIN,
                                         device=device))
        buf = torch.empty(cells, dtype=torch.float32, device=device)
        randn_ms = _time_ms(lambda: torch.randn(cells, out=buf))
        del buf
        nrm = {"grid": grid, "k": k, "ms_u1": t_n1, "ms_u3": t_n3,
               "ms_exp": t_exp, "ms_fma": t_fma, "library_ms": randn_ms,
               "normals_per_launch": cells}
        # unroll 3 draws 2 cells more normals than unroll 1; with_exp and
        # the FMA chain add 1 exp and FMA_CHAIN multiply-adds per normal.
        rate_nrm = 2 * cells / ((t_n3 - t_n1) * 1e-3)
        rate_exp = cells / ((t_exp - t_n1) * 1e-3)
        rate_fma = cells * FMA_CHAIN / ((t_fma - t_n1) * 1e-3)

        s_pad = pc._round_up(n_steps, pc.LANE)
        mgrid = max(1, 2 * sms // MM_SPLIT)
        b32 = orthogonal(s_pad).to(device)
        mm = {"grid": mgrid, "s_pad": s_pad}
        mm_rates = {}
        for name, b in (("float32", b32), ("bfloat16",
                                           b32.to(torch.bfloat16))):
            kk = _calibrated_k(lambda j: matmul(key, b, mgrid, j), 4,
                               target_ms, 4096)
            t1 = _time_ms(lambda: matmul(key, b, mgrid, kk, 1))
            t3 = _time_ms(lambda: matmul(key, b, mgrid, kk, 3))
            macs = mgrid * BLOCK * s_pad * s_pad * kk
            a = torch.randn((mgrid * BLOCK, s_pad), device=device).to(b.dtype)

            def chain():
                x = a
                for _ in range(kk):
                    x = torch.matmul(x, b)
                return x

            lib_ms = _time_ms(chain)
            mm[name] = {"k": kk, "ms_u1": t1, "ms_u3": t3,
                        "library_ms": lib_ms, "macs_per_launch": macs}
            mm_rates[name] = 2 * macs / ((t3 - t1) * 1e-3)
            mm_rates["lib_" + name] = macs / (lib_ms * 1e-3)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    rates = Rates(normals=rate_nrm, exp=rate_exp, fma=rate_fma,
                  mm_f32=mm_rates["float32"], mm_bf16=mm_rates["bfloat16"],
                  lib_mm_f32=mm_rates["lib_float32"],
                  lib_mm_bf16=mm_rates["lib_bfloat16"])
    return {"rates": rates, "normals": nrm, "matmul": mm,
            "fma_share_of_peak": rate_fma / PEAK_FMA_PER_S,
            "mm_f32_share_of_peak": rates.mm_f32 / PEAK_FMA_PER_S,
            "mm_bf16_share_of_peak": rates.mm_bf16 / PEAK_BF16_MAC_PER_S,
            "lib_mm_f32_share_of_peak": rates.lib_mm_f32 / PEAK_FMA_PER_S,
            "lib_mm_bf16_share_of_peak":
                rates.lib_mm_bf16 / PEAK_BF16_MAC_PER_S}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", required=True,
                        help="the CUDA device to measure, e.g. cuda")
    parser.add_argument("--steps", type=int, default=365,
                        help="horizon of the matmul probe's shape and of "
                             "the ceiling")
    parser.add_argument("--paths-per-sec", type=float, default=None,
                        help="the kernel's measured rate (no default: "
                             "measure it on the same card)")
    parser.add_argument("--kernel", default="K2", choices=sorted(
        PORT_CELL_COUNTS), help="the kernel whose ceiling to compare")
    parser.add_argument("--fgn-dtype", default="float32",
                        choices=pc.FGN_DTYPES,
                        help="the kernel's fGN product dtype")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type != "cuda" or not torch.cuda.is_available():
        print(f"error: the roofline probes measure a CUDA device; "
              f"{args.device!r} is not one here", file=sys.stderr)
        return 1
    out = measure(device, args.steps)
    rates = out.pop("rates")
    record = {"device": torch.cuda.get_device_name(device),
              "rates": dataclasses.asdict(rates), **out}
    if args.paths_per_sec:
        ns_per_path = 1e9 / args.paths_per_sec
        ceiling = ceiling_ms(rates, args.kernel, 1, args.steps,
                             args.fgn_dtype) * 1e6
        record["ceiling"] = {"kernel": args.kernel,
                             "ceiling_ns_per_path": ceiling,
                             "measured_ns_per_path": ns_per_path,
                             "fraction": ceiling / ns_per_path}
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
