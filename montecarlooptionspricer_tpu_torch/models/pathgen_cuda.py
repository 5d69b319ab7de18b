"""Fused rough-Bergomi path kernels for Hopper, their plain PyTorch
versions, and the policy tables they read.

Counterpart: ``montecarlooptionspricer_tpu/models/pathgen_pallas.py``.
Two kernels live in ``csrc/pathgen.cu``:

* K1 ``pathgen`` (replaces ``_pathgen_kernel`` / ``_pathgen_kernel_noise_in``):
  noise -> fGN ``X = N @ (0.5 Lt)`` -> ``sv = exp(X + vd)`` -> Euler
  log-recursion -> ``[rows, n_steps + 1]`` prices with S0 in column 0.
* K2 ``priced_chunk`` (replaces ``_priced_kernel`` /
  ``_priced_kernel_noise_in`` with ``policy_form="log_boundary"``): the same
  generation kept on chip, each path stopped at its first step inside the
  log exercise interval, one partial payoff sum per CUDA block.

Each kernel has a seeded entry (Philox4x32-10 written into the kernel) and
a noise-in entry.  The wrappers run the plain versions for tensors on the
CPU and launch the kernel for tensors on a CUDA device; nothing falls back.

Random stream layout (fixed, written once in ``csrc/philox.cuh`` for these
kernels and the step-tiled ones of ``pathgen_tiled_cuda``;
``philox_normals_ref`` reproduces it):
key = (fold(run_word, stream_index), 0); for path p of the chunk (global
row index, 0-based) and step pair j, counter = (p, j, 0, 0) gives four
words x0..x3.  Step 2j takes the Box-Muller pair of (x0, x1), step 2j+1
that of (x2, x3): u = (bits >> 8) * 2^-24 + 2^-25, radius
sqrt(-2 log u_a), angle 2 pi u_b, N = radius cos, W = radius sin.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

LANE = 128
TWO_PI = 2.0 * math.pi
_U32 = 0xFFFFFFFF


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


# ---------------------------------------------------------------------------
# Seed words and the counter-based generator.

_MIX1 = 0x9E3779B1  # golden-ratio odd constant
_MIX2 = 0x85EBCA77  # murmur3-style odd constant


def _fold_words(a: int, b: int) -> int:
    """Mix the (run_word, stream_index) carrier into one uint32 key word.
    For a fixed run word, b -> h is a bijection (xor, odd multiply,
    xorshift mod 2^32), so distinct stream indices never collide.  The
    bits equal the JAX package's int32 ``_fold_words``."""
    h = ((a * _MIX1) & _U32) ^ (b & _U32)
    h = (h * _MIX2) & _U32
    return h ^ (h >> 13)


def _uniform_open(bits: torch.Tensor) -> torch.Tensor:
    """uint32 words (held in int64) -> float32 uniforms in (0, 1]:
    (bits >> 8) * 2^-24 + 2^-25."""
    u = (bits >> 8).to(torch.int32).to(torch.float32) * (1.0 / (1 << 24))
    return u + (0.5 / (1 << 24))


_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85


def _mulhilo(a: torch.Tensor, m: int):
    """(hi, lo) 32-bit words of a * m, a < 2^32 in int64: the product is
    split at 16 bits of m so no intermediate passes 2^49."""
    lo_p = a * (m & 0xFFFF)
    hi_p = a * (m >> 16)
    lo = (((hi_p & 0xFFFF) << 16) + lo_p) & _U32
    hi = (hi_p + (lo_p >> 16)) >> 16
    return hi, lo


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 (Random123) on int64 tensors holding uint32 words."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, _PHILOX_M0)
        hi1, lo1 = _mulhilo(c2, _PHILOX_M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W0) & _U32
        k1 = (k1 + _PHILOX_W1) & _U32
    return c0, c1, c2, c3


def _box_muller(ba, bb):
    rad = torch.sqrt(-2.0 * torch.log(_uniform_open(ba)))
    ang = TWO_PI * _uniform_open(bb)
    return rad * torch.cos(ang), rad * torch.sin(ang)


def philox_normals_ref(key: int, rows: int, n_steps: int, device="cpu",
                       row0: int = 0) -> torch.Tensor:
    """[2, rows, n_steps] float32 (N, W) planes of the seeded kernels'
    stream (module docstring) for chunk rows row0 .. row0 + rows - 1."""
    pairs = (n_steps + 1) // 2
    p = torch.arange(row0, row0 + rows, dtype=torch.int64,
                     device=device)[:, None].expand(rows, pairs)
    j = torch.arange(pairs, dtype=torch.int64,
                     device=device)[None, :].expand(rows, pairs)
    zero = torch.zeros_like(p)
    x0, x1, x2, x3 = philox4x32_10(p, j, zero, zero, key & _U32, 0)
    n_even, w_even = _box_muller(x0, x1)
    n_odd, w_odd = _box_muller(x2, x3)
    n = torch.stack([n_even, n_odd], dim=-1).reshape(rows, 2 * pairs)
    w = torch.stack([w_even, w_odd], dim=-1).reshape(rows, 2 * pairs)
    return torch.stack([n[:, :n_steps], w[:, :n_steps]])


# ---------------------------------------------------------------------------
# The card's shared-memory model (mirrors csrc/pathgen.cu).

SMEM_LIMIT = 232_448        # dynamic shared memory one H100 block may use
TILE_COLS = 64              # step columns per fGN tile
TILE_K = 32                 # rows of Lt' staged per inner pass
BLOCK_CHOICES = (64, 32, 16)


def smem_bytes(n_steps: int, block_paths: int) -> int:
    """Shared memory of one CUDA block: the N and W planes (row stride
    n_steps rounded up to odd, so rows fall on distinct banks), the X tile
    (stride TILE_COLS + 1), the staged Lt' tile and the path-sum slots."""
    ld = n_steps | 1
    floats = (2 * block_paths * ld + block_paths * (TILE_COLS + 1)
              + TILE_K * TILE_COLS + block_paths)
    return 4 * floats


def max_block_paths(n_steps: int) -> int:
    """Largest path block (64, 32 or 16) whose shared memory fits one H100
    block at this horizon, or 0 when none does."""
    for bp in BLOCK_CHOICES:
        if smem_bytes(n_steps, bp) <= SMEM_LIMIT:
            return bp
    return 0


def supports(n_steps: int) -> bool:
    """Whether the single-tile kernels take this horizon."""
    return n_steps >= 1 and max_block_paths(n_steps) > 0


# ---------------------------------------------------------------------------
# Host-side constants and policy tables.

def _half_var_drift(n_steps: int, s_pad: int, xi, h, eta, dt) -> torch.Tensor:
    """[1, s_pad] float32 row of 0.5 (ln xi - 0.5 eta^2 t_c^{2H}) at the
    increment times t_c = c dt (pad columns zero): with the half-scaled fGN
    factor, exp(x' + this) is the square root of the forward variance."""
    t = torch.arange(n_steps, dtype=torch.float64) * dt
    hvd = 0.5 * (math.log(xi) - 0.5 * (eta * eta) * t ** (2.0 * h))
    out = torch.zeros((1, s_pad), dtype=torch.float32)
    out[0, :n_steps] = hvd.to(torch.float32)
    return out


@dataclasses.dataclass(frozen=True)
class PathConsts:
    """Everything the path kernels read besides noise and policy: the
    half-scaled upper-triangular Cholesky factor ``lt_half`` [n, n], the
    half variance drift ``vd`` [n], the market scalars and the single-tile
    kernels' path block (0 past their cap; the step-tiled kernels of
    ``pathgen_tiled_cuda`` choose theirs from the row count).  Its
    tensors' device decides where the wrappers run."""

    n_steps: int
    block_paths: int
    lt_half: torch.Tensor
    vd: torch.Tensor
    s0: float
    r: float
    dt: float

    @property
    def device(self) -> torch.device:
        return self.lt_half.device


def make_path_consts(s0, xi, h, eta, r, n_steps: int, dt: float,
                     device, block_paths: int = 0) -> PathConsts:
    """PathConsts for the chol fGN form, at any horizon.  ``block_paths``
    0 takes the largest single-tile block the card admits at this horizon
    (0 past the single-tile cap); the single-tile wrappers check it."""
    from .engine import _chol_matrix_host

    lt = torch.tensor(_chol_matrix_host(n_steps, h, eta, dt),
                      dtype=torch.float32)
    vd = _half_var_drift(n_steps, n_steps, xi, h, eta, dt)[0]
    bp = block_paths or max_block_paths(n_steps)
    return PathConsts(n_steps=n_steps, block_paths=bp,
                      lt_half=(0.5 * lt).to(device).contiguous(),
                      vd=vd.to(device).contiguous(), s0=float(s0),
                      r=float(r), dt=float(dt))


def _table_prep(fits, r, maturity, dt, n_steps: int, s_pad: int):
    """Column-shifted fit arrays (column c is step c + 1), the
    integer-exact live-window eps (the terminal step always live), and
    the exp(-r t) discount."""
    from ..ops.timegrid import step_mask

    f32 = torch.float32
    dev = fits.mu.device
    t = torch.arange(1, n_steps + 1, dtype=f32, device=dev) * dt

    def shifted(a, fill, pad_value=0.0):
        v = torch.cat([a[1:].to(f32), torch.full((1,), fill, dtype=f32,
                                                 device=dev)])
        return torch.nn.functional.pad(v, (0, s_pad - n_steps),
                                       value=pad_value)

    c0 = shifted(fits.coeffs[:, 0], -1e30)
    c1 = shifted(fits.coeffs[:, 1], 0.0)
    c2 = shifted(fits.coeffs[:, 2], 0.0)
    mu = shifted(fits.mu, 0.0)
    sd = torch.clamp_min(shifted(fits.sd, 1.0, pad_value=1.0), 1e-30)

    live = step_mask(n_steps + 1, dt, maturity, device=dev)[1:]
    eps = torch.where(live, torch.tensor(1e-14, dtype=f32, device=dev),
                      torch.tensor(1e30, dtype=f32, device=dev))
    eps[n_steps - 1] = 1e-14
    eps = torch.nn.functional.pad(eps, (0, s_pad - n_steps), value=1e30)
    disc = torch.exp(-r * t)
    disc = torch.nn.functional.pad(disc, (0, s_pad - n_steps))
    return c0, c1, c2, mu, sd, eps, disc


def boundary_rows(fits, r, strike, maturity, dt, n_steps: int,
                  is_call: bool) -> torch.Tensor:
    """[8, s_pad] exercise-interval table (counterpart
    ``pathgen_pallas.boundary_rows``): row 0 lo, row 1 hi (exercise iff
    lo <= S <= hi), row 2 disc * strike, row 3 the discount, row 4 the
    strike, rows 5-7 zero.  The quadratic decision is solved in the fit's
    standardized z basis with the stable root form; an empty set is
    [1e30, -1e30] and an unbounded side keeps its +-1e30 sentinel."""
    s_pad = _round_up(n_steps, LANE)
    big = 1e30
    c0, c1, c2, mu, sd, eps, disc = _table_prep(fits, r, maturity, dt,
                                                n_steps, s_pad)
    dev = mu.device
    strike_t = torch.tensor(strike, dtype=torch.float32, device=dev)
    big_t = torch.full_like(mu, big)

    if is_call:
        a, b, c = -c2, sd - c1, mu - strike_t - c0
        cap = torch.nextafter(strike_t + torch.clamp_min(eps, 0.0), big_t)
    else:
        a, b, c = -c2, -(sd + c1), strike_t - mu - c0
        cap = torch.nextafter(strike_t - torch.clamp_min(eps, 0.0), -big_t)

    where = torch.where
    lin = torch.abs(a) <= 1e-25
    safe_b = where(torch.abs(b) > 1e-30, b, 1.0)
    s_lin = -c / safe_b
    disc_q = b * b - 4.0 * a * c
    sq = torch.sqrt(torch.clamp_min(disc_q, 0.0))
    qq = -0.5 * (b + where(b < 0, -sq, sq))
    safe_a = where(lin, 1.0, a)
    safe_qq = where(torch.abs(qq) > 1e-30, qq, 1e-30)
    r1 = qq / safe_a
    r2 = c / safe_qq
    rlo = torch.minimum(r1, r2)
    rhi = torch.maximum(r1, r2)
    pos, neg = big_t, -big_t
    b_zero = torch.abs(b) <= 1e-30
    lin_lo = where(b_zero, where(c >= 0, neg, pos), where(b > 0, s_lin, neg))
    lin_hi = where(b_zero, where(c >= 0, pos, neg), where(b > 0, pos, s_lin))
    no_root = disc_q < 0
    if is_call:
        quad_lo = where(a < 0, where(no_root, pos, rlo),
                        where(no_root, neg, rhi))
        quad_hi = where(a < 0, where(no_root, neg, rhi), pos)
    else:
        quad_lo = where(a < 0, where(no_root, pos, rlo), neg)
        quad_hi = where(a < 0, where(no_root, neg, rhi),
                        where(no_root, pos, rlo))
    zlo = where(lin, lin_lo, quad_lo)
    zhi = where(lin, lin_hi, quad_hi)
    set_lo = where(torch.abs(zlo) >= big, zlo, mu + sd * zlo)
    set_hi = where(torch.abs(zhi) >= big, zhi, mu + sd * zhi)
    if is_call:
        lo_row, hi_row = torch.maximum(set_lo, cap), set_hi
    else:
        lo_row, hi_row = set_lo, torch.minimum(set_hi, cap)

    zeros = torch.zeros_like(mu)
    return torch.stack([lo_row, hi_row, disc * strike_t, disc,
                        strike_t.expand(s_pad), zeros, zeros, zeros])


def log_boundary_rows(table: torch.Tensor) -> torch.Tensor:
    """boundary_rows -> the log-space [8, s_pad] table K2 reads: row 0
    log lo, row 1 log hi, row 2 the discount, row 3 the strike.  The
    +-1e30 sentinels stay exact (lo <= 0 passes every S > 0)."""
    big = 1e30
    lo, hi, disc, strike = table[0], table[1], table[3], table[4]
    big_t = torch.full_like(lo, big)

    def to_log(v):
        safe = torch.log(torch.clamp_min(v, 1e-38))
        return torch.where(v <= 0.0, -big_t, torch.where(v >= big, big_t,
                                                          safe))

    zeros = torch.zeros_like(disc)
    return torch.stack([to_log(lo), to_log(hi), disc, strike,
                        zeros, zeros, zeros, zeros])


def time0_value(fits, s0, strike, is_call: bool):
    """(exercises_at_0 as a bool tensor, payoff_at_0 as a float): every
    path shares S0, so time-0 exercise is one decision made outside the
    kernels."""
    p0 = max(s0 - strike, 0.0) if is_call else max(strike - s0, 0.0)
    z0 = (s0 - fits.mu[0]) / fits.sd[0]
    cont0 = (fits.coeffs[0, 2] * z0 + fits.coeffs[0, 1]) * z0 \
        + fits.coeffs[0, 0]
    ex0 = (p0 > 1e-14) & (p0 >= cont0)
    return ex0, p0


# ---------------------------------------------------------------------------
# Plain versions (the CPU path, and the card's reference).

def _matmul_f32(a, b):
    """a @ b in full float32 on any device (TF32 pinned off on CUDA)."""
    if not a.is_cuda:
        return a @ b
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return a @ b
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _log_paths_ref(consts: PathConsts, noise: torch.Tensor) -> torch.Tensor:
    """[rows, n_steps] log prices, column c = step c + 1."""
    x = _matmul_f32(noise[0], consts.lt_half)
    sv = torch.exp(x + consts.vd)
    v = sv * sv
    inc = (consts.r - 0.5 * v) * consts.dt \
        + sv * (noise[1] * math.sqrt(consts.dt))
    return math.log(consts.s0) + torch.cumsum(inc, dim=1)


def pathgen_from_noise_ref(consts: PathConsts,
                           noise: torch.Tensor) -> torch.Tensor:
    """Plain K1: [2, rows, n_steps] (N, W) -> [rows, n_steps + 1] prices."""
    ls = _log_paths_ref(consts, noise)
    out = torch.empty((ls.shape[0], consts.n_steps + 1), dtype=torch.float32,
                      device=ls.device)
    out[:, 0] = consts.s0
    out[:, 1:] = torch.exp(ls)
    return out


def priced_chunk_from_noise_ref(consts: PathConsts, table: torch.Tensor,
                                noise: torch.Tensor, strike: float,
                                is_call: bool) -> torch.Tensor:
    """Plain K2: the chunk's payoff sum (0-d float32) under the log
    exercise-interval table (log_boundary_rows layout)."""
    n = consts.n_steps
    ls = _log_paths_ref(consts, noise)
    exf = (ls >= table[0, :n]) & (ls <= table[1, :n])
    hit = exf.any(dim=1)
    idx = exf.to(torch.int8).argmax(dim=1)      # first hit
    s_stop = torch.exp(ls.gather(1, idx[:, None])[:, 0])
    pay = s_stop - strike if is_call else strike - s_stop
    val = table[2, :n][idx] * torch.clamp_min(pay, 0.0)
    return torch.sum(torch.where(hit, val, torch.zeros_like(val)))


# ---------------------------------------------------------------------------
# Wrappers: plain version for CPU tensors, the kernel for CUDA tensors.

def _noise_or_rows(consts, rows, key, noise):
    if (key is None) == (noise is None):
        raise ValueError("pass exactly one of key (seeded) or noise")
    if noise is None:
        if rows is None:
            raise ValueError("the seeded entry needs rows")
        return rows
    if noise.shape[0] != 2 or noise.shape[2] != consts.n_steps:
        raise ValueError(f"noise must be [2, rows, {consts.n_steps}], got "
                         f"{tuple(noise.shape)}")
    return noise.shape[1]


def check_device_inputs(consts: PathConsts, noise, table=None) -> None:
    """The checks every kernel wrapper makes before a launch: the
    constants on a CUDA device, and noise and table contiguous float32 on
    that device."""
    dev = consts.device
    if dev.type != "cuda":
        raise ValueError(f"the kernels run on a CUDA device, not {dev}")
    for name, t in (("noise", noise), ("table", table)):
        if t is not None and (t.device != dev or t.dtype != torch.float32
                              or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32 on {dev}")


def _kernel_args(consts: PathConsts, rows: int, key, noise):
    """Validated pointer and scalar arguments shared by both single-tile
    kernels."""
    check_device_inputs(consts, noise)
    bp, cap = consts.block_paths, max_block_paths(consts.n_steps)
    if bp not in BLOCK_CHOICES or bp > cap:
        raise ValueError(f"block_paths={bp} not in {BLOCK_CHOICES} or over "
                         f"the single-tile cap {cap} at "
                         f"n_steps={consts.n_steps}")
    if rows % bp:
        raise ValueError(f"rows={rows} must divide by block_paths={bp}")
    noise_ptr = None if noise is None else noise.data_ptr()
    return (noise_ptr, consts.lt_half.data_ptr(), consts.vd.data_ptr(),
            rows, consts.n_steps, bp, 0 if key is None else key & _U32)


def _scalars(consts: PathConsts):
    c = ctypes.c_float
    return (c(consts.r), c(consts.dt), c(math.sqrt(consts.dt)),
            c(math.log(consts.s0)))


def _check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def pathgen(consts: PathConsts, rows: int = None, key: int = None,
            noise: torch.Tensor = None) -> torch.Tensor:
    """K1: [rows, n_steps + 1] float32 prices, S0 in column 0, from the
    seeded stream of ``key`` (a uint32 word, see _fold_words) or from
    injected ``noise`` [2, rows, n_steps]."""
    rows = _noise_or_rows(consts, rows, key, noise)
    if consts.device.type == "cpu":
        if noise is None:
            noise = philox_normals_ref(key, rows, consts.n_steps)
        return pathgen_from_noise_ref(consts, noise)
    args = _kernel_args(consts, rows, key, noise)
    out = torch.empty((rows, consts.n_steps + 1), dtype=torch.float32,
                      device=consts.device)
    from ..kernels import build

    err = build.load().mcop_pathgen(
        *args, *_scalars(consts), ctypes.c_float(consts.s0),
        out.data_ptr(), torch.cuda.current_stream(consts.device).cuda_stream)
    _check(err, "pathgen")
    pathgen.launches += 1
    return out


pathgen.launches = 0


def priced_chunk(consts: PathConsts, table: torch.Tensor, strike: float,
                 is_call: bool, rows: int = None, key: int = None,
                 noise: torch.Tensor = None) -> torch.Tensor:
    """K2: the chunk's discounted payoff sum (0-d float32 tensor) under
    the log_boundary_rows ``table``, from the seeded stream of ``key`` or
    from injected ``noise``.  On the card each block writes one partial
    sum and the blocks are summed in a fixed order, so a seed gives the
    same sum every run."""
    rows = _noise_or_rows(consts, rows, key, noise)
    if table.shape[0] < 3 or table.shape[1] < consts.n_steps:
        raise ValueError("table must be [8, >= n_steps] (log_boundary_rows)")
    if consts.device.type == "cpu":
        if noise is None:
            noise = philox_normals_ref(key, rows, consts.n_steps)
        return priced_chunk_from_noise_ref(consts, table, noise, strike,
                                           is_call)
    args = _kernel_args(consts, rows, key, noise)
    check_device_inputs(consts, None, table)
    partial = torch.empty((rows // consts.block_paths,), dtype=torch.float32,
                          device=consts.device)
    from ..kernels import build

    err = build.load().mcop_priced_chunk(
        *args, *_scalars(consts), table.data_ptr(), table.stride(0),
        ctypes.c_float(strike), int(bool(is_call)), partial.data_ptr(),
        torch.cuda.current_stream(consts.device).cuda_stream)
    _check(err, "priced_chunk")
    priced_chunk.launches += 1
    return torch.sum(partial)


priced_chunk.launches = 0
