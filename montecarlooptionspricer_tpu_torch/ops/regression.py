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

from .reductions import psum_all, psum_if


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


def fit_poly_masked(x, y, w, order: int, ridge: float = 1e-6,
                    total=torch.sum, group=None) -> PolyFit:
    """Weighted polynomial least squares min_c sum_i w_i (P_c(x_i) - y_i)^2.

    x, y, w: [..., n] tensors that broadcast (w a {0,1} mask in LSM); the
    leading axes are a batch of independent fits, e.g. the strikes of a
    chain sharing one regressor column (the counterpart of ``jax.vmap``
    over the JAX function), and the fit's fields carry them.  With zero
    total weight the fit is a dead constant 1e30: a continuation nothing
    beats, so a policy read from it never exercises at that step.

    ``total(t, dim=...)`` forms the moment sums; the PredictionGen rows pass
    ``reductions.row_sum``, whose bits do not depend on the batch.  With a
    process ``group`` (JAX's ``axis_name``) the weight sum, the weighted
    sums of x and of its squared deviations, the Gram matrix and the
    right-hand side are each all-reduced over its ranks, which hold the
    sample's shards, so every rank solves the pooled system (the pivot
    floor included) and ends with the same fit."""
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    w = w.to(torch.float32)

    wsum, wx = psum_all(total(w, dim=-1), total(w * x, dim=-1), group=group)
    safe_wsum = torch.clamp_min(wsum, 1.0)
    mu = wx / safe_wsum
    var = psum_if(total(w * (x - mu[..., None]) ** 2, dim=-1),
                  group) / safe_wsum
    # Relative floor: a (near-)constant regressor such as the S0 column is
    # a pure intercept fit, and z snaps to exactly 0 there (a constant
    # nonzero z from roundoff in mu would make the solve near-singular).
    sd_floor = 1e-6 * (torch.abs(mu) + 1.0)
    sd = torch.sqrt(torch.maximum(var, sd_floor * sd_floor))
    z = (x - mu[..., None]) / sd[..., None]
    z = torch.where((var > sd_floor * sd_floor)[..., None], z,
                    torch.zeros_like(z))

    basis = poly_basis(z, order)                          # [..., n, p+1]
    wb = basis * w[..., None]
    gram, rhs = psum_all(total(wb[..., :, None] * basis[..., None, :],
                               dim=-3),
                         total(wb * y[..., None], dim=-2), group=group)

    # Diagonal-scaled Tikhonov term; 1e-6 is the smallest ridge that is
    # meaningful in float32, and smaller requests are raised to it.
    lam = max(ridge, 1e-6)
    ridge_diag = lam * (torch.diagonal(gram, dim1=-2, dim2=-1) + 1.0)
    a = gram + torch.diag_embed(ridge_diag)
    if order + 1 <= 3:
        coeffs = _solve_spd_small(a, rhs, ridge_diag)
    else:
        coeffs = torch.cholesky_solve(rhs[..., None],
                                      torch.linalg.cholesky(a))[..., 0]
    dead = torch.zeros_like(coeffs)
    dead[..., 0] = 1e30
    coeffs = torch.where((wsum > 0)[..., None], coeffs, dead)
    return PolyFit(coeffs, mu, sd)


def fit_poly_columns(x, y, order: int, ridge: float = 1e-6,
                     group=None) -> PolyFit:
    """Unweighted least squares of each row of y [G, n] on the same row of
    x [G, n]: ``fit_poly_masked`` with every weight 1, for a batch of G
    independent fits (the counterpart of ``jax.vmap`` over the JAX
    function with a ones mask, as the dual's hedge fits use it).

    The Gram matrix is Hankel, G_ij = sum_i z^(i+j), so it is built from
    the 2 order + 1 power sums of z and never as an [G, n, p+1, p+1]
    outer product: each pass holds one [G, n] power plane, whatever the
    order.  With a process ``group`` the rows of x and y are the ranks'
    shards of each fit's sample: the count, the sums behind mu and the
    variance, the power sums and the right-hand side are all-reduced over
    its ranks, so every rank ends with the pooled fit."""
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    n = x.shape[-1]
    sx = torch.sum(x, dim=-1)
    if group is not None:
        sx, count = psum_all(sx, torch.tensor([float(n)], device=x.device),
                             group=group)
        n = int(count.item())
    mu = sx / float(n)
    var = psum_if(torch.sum((x - mu[..., None]) ** 2, dim=-1),
                  group) / float(n)
    sd_floor = 1e-6 * (torch.abs(mu) + 1.0)
    sd = torch.sqrt(torch.maximum(var, sd_floor * sd_floor))
    z = (x - mu[..., None]) / sd[..., None]
    z = torch.where((var > sd_floor * sd_floor)[..., None], z,
                    torch.zeros_like(z))

    sums = [torch.full_like(mu, float(n))]         # sum z^k, k = 0..2p
    rhs = [torch.sum(y, dim=-1)]                   # sum y z^k, k = 0..p
    zk = z
    for k in range(1, 2 * order + 1):
        sums.append(torch.sum(zk, dim=-1))
        if k <= order:
            rhs.append(torch.sum(y * zk, dim=-1))
        if k < 2 * order:
            zk = zk * z
    power, rhs_t = psum_all(torch.stack(sums[1:], dim=-1),
                            torch.stack(rhs, dim=-1), group=group)
    power = torch.cat([sums[0][..., None], power], dim=-1)  # [..., 2p+1]
    idx = torch.arange(order + 1, device=x.device)
    gram = power[..., idx[:, None] + idx[None, :]]
    lam = max(ridge, 1e-6)
    ridge_diag = lam * (torch.diagonal(gram, dim1=-2, dim2=-1) + 1.0)
    a = gram + torch.diag_embed(ridge_diag)
    chol, _ = torch.linalg.cholesky_ex(a)
    coeffs = torch.cholesky_solve(rhs_t[..., None], chol)[..., 0]
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
