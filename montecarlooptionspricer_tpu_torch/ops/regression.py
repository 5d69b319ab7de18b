"""Masked polynomial least squares (counterpart:
``montecarlooptionspricer_tpu/ops/regression.py``).

The ITM row selection of the LSM regression is a {0,1} weight, so shapes
stay static: zero-weight rows leave the weighted normal equations
unchanged.  The fit lives in the standardized variable z = (x - mu) / sd,
which keeps the 3x3 Gram matrix O(1)-conditioned in float32.

The moment products are formed as explicit float32 sums of elementwise
products, never through a matrix-multiply routine, so no TF32 or other
reduced-precision mode can reach them: LSM carries max(payoff, fit)
backward, a ratchet that turns fit noise into price bias.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class PolyFit(NamedTuple):
    """A polynomial fit in standardized coordinates; a leading step axis
    (as ``lsm_fit`` returns) broadcasts through ``eval_poly``."""

    coeffs: torch.Tensor  # [..., order+1] coefficients in z
    mu: torch.Tensor      # [...] center
    sd: torch.Tensor      # [...] scale


def polyfit_from_numpy(coeffs, mu, sd, device) -> PolyFit:
    """A PolyFit of float32 tensors on ``device`` from array-likes, e.g.
    the numpy arrays of a fit made by the JAX package."""
    def cast(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)
    return PolyFit(cast(coeffs), cast(mu), cast(sd))


def poly_basis(z: torch.Tensor, order: int) -> torch.Tensor:
    """[..., order+1] monomial basis 1, z, ..., z^order."""
    return torch.stack([z ** k for k in range(order + 1)], dim=-1)


def fit_poly_masked(x, y, w, order: int, ridge: float = 1e-6) -> PolyFit:
    """Weighted polynomial least squares min_c sum_i w_i (P_c(x_i) - y_i)^2.

    x, y, w: [n] tensors (w a {0,1} mask in LSM).  With zero total weight
    the fit is a dead constant 1e30: a continuation nothing beats, so a
    policy read from it never exercises at that step."""
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    w = w.to(torch.float32)

    wsum = torch.sum(w)
    safe_wsum = torch.clamp_min(wsum, 1.0)
    mu = torch.sum(w * x) / safe_wsum
    var = torch.sum(w * (x - mu) ** 2) / safe_wsum
    # Relative floor: a (near-)constant regressor such as the S0 column is
    # a pure intercept fit, and z snaps to exactly 0 there (a constant
    # nonzero z from roundoff in mu would make the solve near-singular).
    sd_floor = 1e-6 * (torch.abs(mu) + 1.0)
    sd = torch.sqrt(torch.maximum(var, sd_floor * sd_floor))
    z = (x - mu) / sd
    z = torch.where(var > sd_floor * sd_floor, z, torch.zeros_like(z))

    basis = poly_basis(z, order)                          # [n, p+1]
    wb = basis * w[:, None]
    gram = torch.sum(wb[:, :, None] * basis[:, None, :], dim=0)
    rhs = torch.sum(wb * y[:, None], dim=0)

    # Diagonal-scaled Tikhonov term; 1e-6 is the smallest ridge that is
    # meaningful in float32, and smaller requests are raised to it.
    lam = max(ridge, 1e-6)
    ridge_diag = lam * (torch.diagonal(gram) + 1.0)
    a = gram + torch.diag(ridge_diag)
    if order + 1 <= 3:
        coeffs = _solve_spd_small(a, rhs, ridge_diag)
    else:
        coeffs = torch.cholesky_solve(rhs[:, None],
                                      torch.linalg.cholesky(a))[:, 0]
    dead = torch.zeros_like(coeffs)
    dead[0] = 1e30
    coeffs = torch.where(wsum > 0, coeffs, dead)
    return PolyFit(coeffs, mu, sd)


def _solve_spd_small(a, b, floor):
    """Solve a x = b for a = G + diag(floor), G positive semidefinite and
    floor > 0, of size 1..3, by an unrolled Cholesky factorization.

    Each exact pivot of a is at least floor[k] (Schur complements are
    monotone, and the diagonal term alone has pivot floor[k]), so a pivot
    that float32 cancellation pushes below it is clamped to it.  The JAX
    reference clamps to 1e-30 instead, which lets a near-rank-1 design's
    coefficients reach ~1e27 (ROADMAP C); for a healthy design the floor
    never engages and the two agree."""
    n = a.shape[-1]
    if n == 1:
        return b / torch.maximum(a[..., 0, 0:1], floor[..., 0:1])
    f = [floor[..., k] for k in range(n)]

    def sqrt(v, k):
        return torch.sqrt(torch.maximum(v, f[k]))

    if n == 2:
        a00, a01, a11 = a[..., 0, 0], a[..., 0, 1], a[..., 1, 1]
        l00 = sqrt(a00, 0)
        l10 = a01 / l00
        l11 = sqrt(a11 - l10 * l10, 1)
        y0 = b[..., 0] / l00
        y1 = (b[..., 1] - l10 * y0) / l11
        x1 = y1 / l11
        x0 = (y0 - l10 * x1) / l00
        return torch.stack([x0, x1], dim=-1)
    a00, a01, a02 = a[..., 0, 0], a[..., 0, 1], a[..., 0, 2]
    a11, a12, a22 = a[..., 1, 1], a[..., 1, 2], a[..., 2, 2]
    l00 = sqrt(a00, 0)
    l10 = a01 / l00
    l20 = a02 / l00
    l11 = sqrt(a11 - l10 * l10, 1)
    l21 = (a12 - l20 * l10) / l11
    l22 = sqrt(a22 - l20 * l20 - l21 * l21, 2)
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    y0 = b0 / l00
    y1 = (b1 - l10 * y0) / l11
    y2 = (b2 - l20 * y0 - l21 * y1) / l22
    x2 = y2 / l22
    x1 = (y1 - l21 * x2) / l11
    x0 = (y0 - l10 * x1 - l20 * x2) / l00
    return torch.stack([x0, x1, x2], dim=-1)


def eval_poly(fit: PolyFit, x):
    """The fitted polynomial at x (Horner in z)."""
    z = (x - fit.mu) / fit.sd
    order = fit.coeffs.shape[-1] - 1
    val = fit.coeffs[..., order]
    for k in range(order - 1, -1, -1):
        val = val * z + fit.coeffs[..., k]
    return val
