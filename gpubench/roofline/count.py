"""The yardstick of the kernels' layer: the least time the card could take
for a price's stream, counted from the cell's shapes against the published
peaks of one H100 SXM (NVIDIA's data sheet, dense rates).

A frozen copy of ``chip_smoke.py``'s ``bound_ms``, ``factored_bound_ms``
and ``QUAD_CELL_OPS`` as they stood when the benchmark was defined, so a
later change to the program cannot move it.  The count is of the work the
stream's function needs, whichever kernels implement it: the fGN product,
the path recursion and the exercise test of every cell, the factors and
tables read once and the sums written once.  It omits the generation of
the normals (Philox and Box-Muller), as ``bound_ms`` does, and the strike
sweep's data-dependent visits, so a share of it is a lower bound of the
share of the true least time.
"""

from __future__ import annotations

import math

PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
LANE_1 = 128
QUAD_CELL_OPS = 11.0


def bound_ms(rows: int, n: int, out_bytes: int, products: int = 1,
             per_cell: float = 8.0, policy_rows: int = 4,
             swept: int = 0, antithetic: bool = False,
             with_cv: bool = False, spectral: bool = False,
             sweep_ops: float = 4.0,
             quad_cells: int = 0, bf16: bool = False) -> tuple[float, str]:
    """Least time for one launch at this shape: the larger of the bytes
    that must move (the ``products`` triangular factors Lt' (and dLt'),
    vd and the ``policy_rows`` rows of [n] read once, the output written
    once) over HBM bandwidth and the float32 operations (each triangular
    fGN product, 2 per multiply-add, once per pair when ``antithetic``,
    plus ``per_cell`` per cell of every path: ~8 for the variance,
    increment, running sum and test, ~18 with the Greeks' tangent brackets
    and sums; plus ~4 per strike-cell that a strike sweep visits,
    ``swept``; plus QUAD_CELL_OPS per cell that a quadratic policy tests,
    ``quad_cells``; plus 2 per path for the control's exp and sum
    ``with_cv``) over the float32 peak.  Under ``spectral`` the fGN
    product is the two dense [n, n] products Zr @ Cr' and Zi @ Ci' (2 n^2
    multiply-adds per drawn path, both matrices read once), not the
    triangle.  Under ``bf16`` the product's operations go over the dense
    bf16 tensor-core peak and its factor is read at 2 bytes an entry; the
    rest stays float32."""
    mats = 2 if spectral else products
    bytes_ = ((2 if bf16 else 4) * mats * n * n + 4 * policy_rows * n
              + out_bytes)
    drawn = rows // 2 if antithetic else rows
    product = (2.0 * 2 * drawn * n * n if spectral
               else 2.0 * products * drawn * n * (n + 1) / 2)
    rest = (per_cell * rows * n + sweep_ops * swept
            + QUAD_CELL_OPS * quad_cells
            + (2.0 * rows if with_cv else 0.0))
    t_bytes = bytes_ / PEAK_BYTES
    t_ops = (product / (PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS)
             + rest / PEAK_F32_FLOPS)
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def factored_bound_ms(rows: int, n: int, out_bytes: int,
                      policy_rows: int = 0, antithetic: bool = False,
                      with_cv: bool = False, quad_cells: int = 0,
                      bf16: bool = False) -> tuple[float, str]:
    """Least time for one launch of the factored-DFT synthesis at this
    shape: the larger of the bytes that must move (the spectral diagonal
    [m2] complex, vd and ``policy_rows`` rows of [n] read once, the output
    written once) over HBM bandwidth, and the float32 operations over the
    float32 peak: per drawn path the diagonal's complex multiply (6 per
    step) and one length-m2 complex FFT (5 m2 log2 m2), once per pair when
    ``antithetic``; per path ~8 per step, and 2 for the control
    ``with_cv``; QUAD_CELL_OPS per cell a quadratic policy tests.  Under
    ``bf16`` the FFT's first 7 radix-2 stages go over the bf16 peak and
    the bf16 F1 (two [128, 128] planes at 2 bytes) is read once."""
    m2 = 1 << (n - 1).bit_length()
    bytes_ = (4 * (2 * m2 + (1 + policy_rows) * n) + out_bytes
              + (2 * 2 * LANE_1 * LANE_1 if bf16 else 0))
    drawn = rows // 2 if antithetic else rows
    stage1 = drawn * 5.0 * m2 * math.log2(LANE_1) if bf16 else 0.0
    flops = (drawn * (5.0 * m2 * math.log2(m2) + 6.0 * n) - stage1
             + rows * (8.0 * n + (2.0 if with_cv else 0.0))
             + QUAD_CELL_OPS * quad_cells)
    t_bytes = bytes_ / PEAK_BYTES
    t_ops = flops / PEAK_F32_FLOPS + stage1 / PEAK_BF16_FLOPS
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def stream_least_s(config: dict, n_strikes: int, n_chunks: int,
                   antithetic: bool, control_variate: bool) -> float:
    """Least seconds of a price's stream at a configuration's shapes:
    ``n_chunks`` chunks of its paths, counted from the configuration
    alone, never from the kernel that runs, in the form the
    configurations state: the triangular float32 fGN product of the
    Cholesky form and the boundary policy.  A strip reads vd and four
    rows of [n] per strike and writes a sum per strike.  (A configuration
    in another form, or past 3,620 steps where only the factored
    synthesis runs, is counted by a metric of its own on ``bound_ms``'s
    options or ``factored_bound_ms``.)"""
    n = int(config["grid"]["n_steps"])
    rows = int(config["stream"]["chunk_paths"])
    ms, _ = bound_ms(rows, n, 4 * n_strikes * (2 if control_variate else 1),
                     policy_rows=4 if n_strikes == 1 else 1 + 4 * n_strikes,
                     antithetic=antithetic, with_cv=control_variate)
    return n_chunks * ms * 1e-3
