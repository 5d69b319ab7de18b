"""The port's ops (payoff, time grid, masked regression) against the JAX
package on the same numpy inputs."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from montecarlooptionspricer_tpu.ops.payoff import payoff as jpayoff
from montecarlooptionspricer_tpu.ops import regression as jreg
from montecarlooptionspricer_tpu.ops import timegrid as jtime
from montecarlooptionspricer_tpu_torch.ops.payoff import payoff as tpayoff
from montecarlooptionspricer_tpu_torch.ops import regression as treg
from montecarlooptionspricer_tpu_torch.ops import timegrid as ttime
from montecarlooptionspricer_tpu_torch.ops.reductions import global_mean


@pytest.mark.parametrize("is_call", [False, True])
def test_payoff_matches_jax_exactly(rng, is_call):
    s = rng.uniform(50, 150, size=1000).astype(np.float32)
    want = np.asarray(jpayoff(is_call, jnp.asarray(s), 101.5))
    got = tpayoff(is_call, torch.from_numpy(s), 101.5).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,dt,maturity", [
    (366, 1 / 252, 365 / 252),                       # on-grid, bench shape
    (2001, 1 / 252, float(np.float32(2000 / 252))),  # float32 maturity
    (50, 1 / 252, 30.5 / 252),                       # off-grid
    (33, 1 / 252, 32 / 252),
])
def test_step_mask_matches_jax_exactly(n, dt, maturity):
    want = np.asarray(jtime.step_mask(n, dt, maturity))
    got = ttime.step_mask(n, dt, maturity).numpy()
    np.testing.assert_array_equal(got, want)


def test_global_mean():
    v = torch.arange(10, dtype=torch.float32)
    assert float(global_mean(v)) == 4.5


def _fit_case(rng, case):
    n = 2048
    x = rng.normal(100.0, 15.0, size=n).astype(np.float32)
    y = (0.02 * (x - 95.0) ** 2 + rng.normal(0, 1, n)).astype(np.float32)
    w = (rng.uniform(size=n) < 0.4).astype(np.float32)
    if case == "all_zero_mask":
        w[:] = 0.0
    elif case == "constant_regressor":           # the S0 column
        x[:] = 100.0
    elif case == "two_rows":                     # rank-2 design, 3 params
        w[:] = 0.0
        w[[3, 17]] = 1.0
    return x, y, w


@pytest.mark.parametrize("case", ["random_mask", "all_zero_mask",
                                  "constant_regressor", "two_rows"])
def test_fit_poly_masked_matches_jax(rng, case):
    """Same float32 arithmetic up to the order of the sums (JAX forms the
    moments with a matmul): rtol 1e-5 on mu, sd and the fitted values, and
    on the coefficient vector relative to its largest entry (a small
    coefficient inherits the rounding of the large ones through the
    solve)."""
    x, y, w = _fit_case(rng, case)
    jf = jreg.fit_poly_masked(jnp.asarray(x), jnp.asarray(y),
                              jnp.asarray(w), 2)
    tf = treg.fit_poly_masked(torch.from_numpy(x), torch.from_numpy(y),
                              torch.from_numpy(w), 2)
    want_c = np.asarray(jf.coeffs)
    np.testing.assert_allclose(tf.coeffs.numpy(), want_c, rtol=1e-5,
                               atol=1e-5 * np.max(np.abs(want_c)))
    for a, b in ((tf.mu, jf.mu), (tf.sd, jf.sd)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)
    if case == "all_zero_mask":
        assert tf.coeffs[0].item() == float(np.float32(1e30))
    want = np.asarray(jreg.eval_poly(jf, jnp.asarray(x)))
    got = treg.eval_poly(tf, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_eval_poly_broadcasts_per_step_fits(rng):
    """A leading step axis on the fit broadcasts over [paths, steps]."""
    coeffs = rng.normal(size=(6, 3)).astype(np.float32)
    mu = rng.uniform(90, 110, 6).astype(np.float32)
    sd = rng.uniform(1, 10, 6).astype(np.float32)
    s = rng.uniform(80, 120, size=(40, 6)).astype(np.float32)
    want = np.asarray(jreg.eval_poly(
        jreg.PolyFit(jnp.asarray(coeffs), jnp.asarray(mu), jnp.asarray(sd)),
        jnp.asarray(s)))
    got = treg.eval_poly(treg.polyfit_from_numpy(coeffs, mu, sd, "cpu"),
                         torch.from_numpy(s)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def _ridge_fit_f64(x, y, w, order=2, lam=1e-6):
    """fit_poly_masked's regularized normal equations, solved in float64."""
    x, y, w = (np.asarray(a, np.float64) for a in (x, y, w))
    mu = np.sum(w * x) / max(np.sum(w), 1.0)
    sd = np.sqrt(np.sum(w * (x - mu) ** 2) / max(np.sum(w), 1.0))
    basis = ((x - mu) / sd)[:, None] ** np.arange(order + 1)
    gram = (basis * w[:, None]).T @ basis
    a = gram + np.diag(lam * (np.diag(gram) + 1.0))
    return np.linalg.solve(a, (basis * w[:, None]).T @ y), mu, sd


@pytest.mark.parametrize("seed", [0, 4])
def test_fit_poly_masked_near_rank_1_design(seed):
    """Every weighted row but one at the same price: the quadratic is
    fixed only up to the ridge.  The fitted values at the weighted rows
    match a float64 solve of the same system to rtol 1e-4.  (The JAX
    reference's fit is not the oracle here: on these seeds its last
    Cholesky pivot comes out negative in float32, is clamped to 1e-30, and
    its coefficients reach ~1e27.)"""
    rng = np.random.default_rng(seed)
    n = 2048
    x = np.full(n, 100.0, np.float32)
    y = (0.02 * (x - 95.0) ** 2 + rng.normal(0, 1, n)).astype(np.float32)
    w = (rng.uniform(size=n) < 0.4).astype(np.float32)
    x[5], w[5] = 101.0, 1.0
    tf = treg.fit_poly_masked(torch.from_numpy(x), torch.from_numpy(y),
                              torch.from_numpy(w), 2)
    coeffs, mu, sd = _ridge_fit_f64(x, y, w)
    assert np.all(np.isfinite(tf.coeffs.numpy()))
    np.testing.assert_allclose([float(tf.mu), float(tf.sd)], [mu, sd],
                               rtol=1e-5)
    rows = w > 0
    want = np.polynomial.polynomial.polyval((x[rows] - mu) / sd, coeffs)
    got = treg.eval_poly(tf, torch.from_numpy(x[rows])).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize("seed", [0, 4])
def test_solve_floors_pivot_below_ridge(seed):
    """The near-rank-1 design above with its Gram matrix formed in the
    float32 matmul order the JAX reference uses: the last Cholesky pivot
    a22 - l20^2 - l21^2 cancels below the ridge lam (g22 + 1) that bounds
    it from below (negative on seed 0).  The solver clamps it to that
    floor, so the coefficients stay finite and the fitted values on the
    weighted rows match a float64 solve of the same system to 1e-3."""
    rng = np.random.default_rng(seed)
    n = 2048
    x = np.full(n, 100.0, np.float32)
    y = (0.02 * (x - 95.0) ** 2 + rng.normal(0, 1, n)).astype(np.float32)
    w = (rng.uniform(size=n) < 0.4).astype(np.float32)
    x[5], w[5] = 101.0, 1.0
    tf = treg.fit_poly_masked(torch.from_numpy(x), torch.from_numpy(y),
                              torch.from_numpy(w), 2)
    z = (torch.from_numpy(x) - tf.mu) / tf.sd
    basis = treg.poly_basis(z, 2)
    wb = basis * torch.from_numpy(w)[:, None]
    gram = wb.T @ basis
    floor = 1e-6 * (torch.diagonal(gram) + 1.0)
    a = gram + torch.diag(floor)
    l0 = a[0] / torch.sqrt(a[0, 0])
    l21 = (a[1, 2] - l0[2] * l0[1]) / torch.sqrt(a[1, 1] - l0[1] ** 2)
    assert float(a[2, 2] - l0[2] ** 2 - l21 ** 2) < float(floor[2])

    coeffs = treg._solve_spd_small(a, wb.T @ torch.from_numpy(y), floor)
    assert np.all(np.isfinite(coeffs.numpy()))
    want_c, mu, sd = _ridge_fit_f64(x, y, w)
    rows = w > 0
    want = np.polynomial.polynomial.polyval((x[rows] - mu) / sd, want_c)
    got = treg.eval_poly(treg.PolyFit(coeffs, tf.mu, tf.sd),
                         torch.from_numpy(x[rows])).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3)
