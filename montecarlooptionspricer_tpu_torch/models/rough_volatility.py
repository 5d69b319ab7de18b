"""Rough-Bergomi price paths of the PredictionGen path (counterpart:
``montecarlooptionspricer_tpu/models/rough_volatility.py``).

The JAX package builds these in XLA, outside any Pallas kernel, so they
are plain PyTorch here: ``torch.fft`` for the two spectra and a cumulative
sum in log space for the Euler recursion

  S_j = S_{j-1} exp((r - v/2) dt + sqrt(v) dW).

The pipeline's form, ``generate_paths_bucketed``, carries a leading row
axis: one call builds [rows, paths, n_pad + 1] with each row's own s0, xi,
H, eta and step count, and each row's noise drawn from its own generator
(``ops.rng.generator_for_row``), so a row's paths never depend on the
batch it lands in.  ``rho`` is distributionally inert, as in the
reference: both of its Brownians are independent of the variance driver,
so their mix is one N(0, dt) increment.

The QMC forms (``generate_paths_qmc``, ``generate_paths_qmc_bucketed``)
drive all 3n normals of a path from one digitally shifted scrambled Sobol
set (``ops/qmc.py``): dimensions [0, n) build the price Brownian through
the PCA map, [n, 2n) and [2n, 3n) are the complex fGN plane.  The shift
is drawn from the row's generator (or injected); the inverse CDF runs in
float64 on the exact float32 uniforms, and the synthesis in float64, as
the pseudo-random forms' does.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from ..ops import fgn as fgn_ops
from ..ops import qmc as qmc_ops
from ..ops import rng as rng_ops
from ..ops.estimators import estimate_params


def variance_curve(gen: torch.Generator, xi, h, eta, n_steps: int,
                   n_paths: int, dt: float) -> torch.Tensor:
    """Per-path forward-variance curves v [paths, steps] from spectral fGN
    on complex noise drawn from ``gen``."""
    time_grid = (torch.arange(n_steps + 1, dtype=torch.float32,
                              device=gen.device) * dt)
    phi = fgn_ops.rbergomi_phi(fgn_ops.rbergomi_lambda(time_grid, h))
    re, im = rng_ops.complex_normal(gen, (n_paths, n_steps))
    x = fgn_ops.fractional_gaussian(phi, torch.complex(re, im), h, eta)
    return fgn_ops.forward_variance(x, time_grid, xi, h, eta)


def euler_log_paths(gen: torch.Generator, s0, r, rho, v: torch.Tensor,
                    dt: float) -> torch.Tensor:
    """[paths, steps + 1] prices from variance curves v, column 0 == s0;
    one N(0, dt) increment a step drawn from ``gen`` (``rho`` inert).
    ``s0`` and ``r`` may be 0-d tensors, whose gradients then flow
    (``models.greeks.lsm_greeks``)."""
    del rho
    n_paths, n_steps = v.shape
    w = rng_ops.normal(gen, (n_paths, n_steps))
    inc = ((r - 0.5 * v) * dt
           + torch.sqrt(torch.clamp_min(v, 0.0)) * (w * math.sqrt(dt)))
    if isinstance(s0, torch.Tensor):
        s = torch.exp(torch.log(s0) + torch.cumsum(inc, dim=-1))
        return torch.cat([s0 * torch.ones_like(s[:, :1]), s], dim=-1)
    s = torch.exp(math.log(s0) + torch.cumsum(inc, dim=-1))
    return torch.cat([torch.full((n_paths, 1), float(s0), device=v.device),
                      s], dim=-1)


def generate_paths(gen: torch.Generator, s0, xi, h, eta, rho, r,
                   n_steps: int, n_paths: int,
                   dt: float = 1.0 / 252.0) -> torch.Tensor:
    """rBergomi prices [n_paths, n_steps + 1] on the generator's device,
    paths[:, 0] == s0: the variance driver's noise first, then the price
    Brownian, both from ``gen``."""
    v = variance_curve(gen, xi, h, eta, n_steps, n_paths, dt)
    return euler_log_paths(gen, s0, r, rho, v, dt)


def _qmc_base(base_u, n_paths: int, dim: int, device) -> torch.Tensor:
    """The Sobol base as int32 bit patterns on ``device``: ``base_u`` (uint32
    words) when given, else the cached ``sobol_base(n_paths, dim)``."""
    if base_u is None:
        return qmc_ops.base_bits(n_paths, dim, torch.device(device))
    return qmc_ops.as_bits(base_u).to(device)


def _pca_t64(n: int, dt: float, device) -> torch.Tensor:
    """The transposed PCA map at ``n`` steps, float64 on ``device``."""
    return torch.tensor(np.ascontiguousarray(
        qmc_ops.brownian_pca_matrix(n, float(dt)).T), dtype=torch.float64,
        device=device)


def qmc_bucketed_noise(base: torch.Tensor, shifts: torch.Tensor, n_pad: int,
                       dt: float) -> tuple:
    """(zc [rows, paths, n_pad] complex128, dw [rows, paths, n_pad]
    float64) of each row's digital shift ``shifts`` [rows, 3 n_pad] of the
    base set ``base`` [paths, 3 n_pad]: the complex fGN plane from
    dimensions [n_pad, 3 n_pad), the increments from the PCA map at n_pad
    steps (they carry sqrt(dt)).  Each row's product has the same shape
    whatever the batch, so a row's bits do not depend on it."""
    pca_t = _pca_t64(n_pad, dt, base.device)
    zc, dw = [], []
    for shift in shifts:
        z = qmc_ops.normals(base, shift, torch.float64)
        zc.append(torch.complex(z[:, n_pad:2 * n_pad], z[:, 2 * n_pad:]))
        dw.append(z[:, :n_pad] @ pca_t)
    return torch.stack(zc), torch.stack(dw)


def generate_paths_qmc(gen: torch.Generator, s0, xi, h, eta, rho, r,
                       n_steps: int, n_paths: int, dt: float = 1.0 / 252.0,
                       base_u=None, shift: torch.Tensor = None
                       ) -> torch.Tensor:
    """rBergomi prices [n_paths, n_steps + 1] driven by randomized QMC
    noise: the same model as ``generate_paths``, with the 3 n
    normals of a path from the digitally shifted Sobol set (``base_u``
    [n_paths, 3 n] uint32, default ``sobol_base``; the shift [3 n] drawn
    from ``gen``, or injected as int32 bit patterns), the price Brownian
    by the PCA map at n steps.  Independent shifts give independent
    unbiased estimates.  The synthesis is the bucketed one's on a single
    row at n_pad = next_pow2(n), which is exact there."""
    del rho
    n = int(n_steps)
    if shift is None:
        shift = qmc_ops.draw_shift(gen, 3 * n)
    dev = shift.device
    z = qmc_ops.normals(_qmc_base(base_u, n_paths, 3 * n, dev), shift,
                        torch.float64)
    n_pad = fgn_ops.next_pow2(n)
    zc = torch.zeros((1, n_paths, n_pad), dtype=torch.complex128, device=dev)
    zc[0, :, :n] = torch.complex(z[:, n:2 * n], z[:, 2 * n:])
    dw = torch.zeros((1, n_paths, n_pad), dtype=torch.float64, device=dev)
    dw[0, :, :n] = z[:, :n] @ _pca_t64(n, dt, dev)
    row = [torch.tensor([float(v)], device=dev) for v in (s0, xi, h, eta)]
    return _bucketed_paths_from_noise(
        *row, r, torch.tensor([n], device=dev), n_pad,
        fgn_ops.next_pow2(n + 1), zc, dw, dt)[0, :, :n + 1]


def generate_paths_qmc_bucketed(gens, s0, xi, h, eta, rho, r, n_steps,
                                n_pad: int, m1: int, n_paths: int,
                                dt: float = 1.0 / 252.0, base_u=None,
                                shifts: torch.Tensor = None) -> torch.Tensor:
    """[rows, n_paths, n_pad + 1] prices, the bucketed form of
    ``generate_paths_qmc`` (see ``generate_paths_bucketed`` for the
    (n_pad, m1) contract): one base set [n_paths, 3 n_pad] for the bucket
    and each row's shift drawn from its generator in ``gens`` (or the
    injected ``shifts`` [rows, 3 n_pad]).  The PCA map is built at n_pad
    steps; any orthogonal construction gives exactly distributed
    increments, so a row's first n_steps of them are exact."""
    del rho
    if n_pad & (n_pad - 1):
        raise ValueError(f"n_pad={n_pad} must be a power of two")
    if shifts is None:
        shifts = torch.stack([qmc_ops.draw_shift(g, 3 * n_pad)
                              for g in gens])
    zc, dw = qmc_bucketed_noise(
        _qmc_base(base_u, n_paths, 3 * n_pad, shifts.device), shifts, n_pad,
        dt)
    return _bucketed_paths_from_noise(s0, xi, h, eta, r, n_steps, n_pad, m1,
                                      zc, dw, dt)


def draw_bucketed_noise(gens: Sequence[torch.Generator], n_draw: int,
                        n_pad: int, dt: float) -> tuple:
    """(zc [rows, n_draw, n_pad] complex64, dw [rows, n_draw, n_pad]): each
    row's complex fGN noise, then its Brownian increments scaled by
    sqrt(dt), drawn from its own generator in that order."""
    re, im, w = [], [], []
    for g in gens:
        a, b = rng_ops.complex_normal(g, (n_draw, n_pad))
        re.append(a)
        im.append(b)
        w.append(rng_ops.normal(g, (n_draw, n_pad)))
    zc = torch.complex(torch.stack(re), torch.stack(im))
    return zc, torch.stack(w).mul_(math.sqrt(dt))


def generate_paths_bucketed(gens: Sequence[torch.Generator], s0, xi, h,
                            eta, rho, r, n_steps, n_pad: int, m1: int,
                            n_paths: int, dt: float = 1.0 / 252.0,
                            antithetic: bool = False) -> torch.Tensor:
    """[rows, n_paths, n_pad + 1] prices, one row per generator in
    ``gens``, with per-row [rows] tensors s0, xi, h, eta and n_steps.

    Row b's columns 0..n_steps[b] are distributed as ``generate_paths`` at
    that step count, and the rest stay flat at S_{n_steps}.  Padding is
    exact because n_pad = next_pow2(n_steps) is the reference's circular
    convolution length for every row of the bucket and m1 =
    next_pow2(n_steps + 1) the lambda spectrum's (see
    ``_bucketed_paths_from_noise``).  ``antithetic`` draws half the paths
    and fills the block with (Z, W) / (-Z, -W): paths i and i +
    n_paths / 2 are partners."""
    del rho
    if n_pad & (n_pad - 1):
        raise ValueError(f"n_pad={n_pad} must be a power of two (it is the "
                         "reference's circular-convolution length M2)")
    if antithetic and n_paths % 2:
        raise ValueError("antithetic needs an even n_paths")
    n_draw = n_paths // 2 if antithetic else n_paths
    zc, dw = draw_bucketed_noise(gens, n_draw, n_pad, dt)
    return _bucketed_paths_from_noise(s0, xi, h, eta, r, n_steps, n_pad, m1,
                                      zc, dw, dt, antithetic=antithetic)


def _bucketed_paths_from_noise(s0, xi, h, eta, r, n_steps, n_pad: int,
                               m1: int, zc: torch.Tensor, dw: torch.Tensor,
                               dt: float,
                               antithetic: bool = False) -> torch.Tensor:
    """The masked-spectrum fGN and Euler cumsum of the bucketed form, on
    injected noise: ``zc`` [rows, n_draw, n_pad] complex, ``dw`` [rows,
    n_draw, n_pad] increments including their sqrt(dt) scale, and [rows]
    tensors s0, xi, h, eta, n_steps.

    The masking contract, as in the JAX package: lambda is zeroed past
    n_steps before the m1 FFT, phi * Z past n_steps - 1 before the n_pad
    FFT, and the increments past n_steps, which reproduces each row's
    exact-shape spectra.  Under ``antithetic`` the planes hold half the
    paths and the block is (x, dw) then (-x, -dw): the synthesis is
    linear, so it runs once a pair.

    The synthesis runs in float64 and rounds to the float32 prices once,
    where JAX runs it in float32.  The card's and the host's FFTs and
    transcendental functions then agree far below a float32 ulp, so the
    same noise gives the same prices' bits on either device (and on the
    host whichever vector path an element takes): an LSM regression
    whose in-the-money set gained or lost a path on a 1e-7 difference
    moves a row's price by ~1e-4."""
    dev = zc.device
    f64 = torch.float64
    s0, xi, h, eta = (torch.as_tensor(a, dtype=torch.float32, device=dev)
                      .to(f64) for a in (s0, xi, h, eta))
    n_steps = torch.as_tensor(n_steps, device=dev)
    zc = zc.to(torch.complex128)
    dw = dw.to(f64)
    time_grid = torch.arange(n_pad + 1, dtype=f64, device=dev) * dt
    lam = 0.5 * torch.pow(time_grid[None, :], 2.0 * h[:, None])
    lam = torch.where(torch.arange(n_pad + 1, device=dev)[None, :]
                      <= n_steps[:, None], lam, 0.0)
    phi = torch.conj(torch.fft.fft(lam, n=m1, dim=-1)).resolve_conj()

    kmask = (torch.arange(n_pad, device=dev)[None, :]
             < n_steps[:, None])[:, None, :]              # [rows, 1, n_pad]
    a = torch.where(kmask, phi[:, None, :n_pad] * zc, 0.0)
    x = ((torch.sqrt(2.0 * h) * eta)[:, None, None]
         * torch.real(torch.fft.fft(a, n=n_pad, dim=-1)) / n_pad)
    del a
    if antithetic:
        x = torch.cat([x, -x], dim=1)
        dw = torch.cat([dw, -dw], dim=1)

    ma = (-0.5 * (eta * eta)[:, None]
          * torch.pow(time_grid[None, :n_pad], 2.0 * h[:, None]))
    v = xi[:, None, None] * torch.exp(x + ma[:, None, :])
    del x
    inc = (r - 0.5 * v) * dt + torch.sqrt(torch.clamp_min(v, 0.0)) * dw
    del v
    inc = torch.where(kmask, inc, 0.0)
    s = torch.exp(torch.log(s0)[:, None, None] + torch.cumsum(inc, dim=-1))
    del inc
    s0_col = s0[:, None, None].expand(s.shape[:-1] + (1,))
    return torch.cat([s0_col, s], dim=-1).to(torch.float32)


def generate_paths_from_history(gen: torch.Generator, historical_prices,
                                forward_steps: int, path_num: int,
                                r: float = 0.04,
                                dt: float = 1.0 / 252.0) -> torch.Tensor:
    """The reference's GenerateStockPricePaths: estimate (xi, H, eta, rho)
    from the history on the host, then generate the paths."""
    p = estimate_params(np.asarray(historical_prices), r=r, dt_yr=dt)
    return generate_paths(gen, p.s0, p.xi, p.h, p.eta, p.rho, p.r,
                          forward_steps, path_num, dt)
