"""The port's LSM backward induction against the JAX package's on one numpy
path matrix."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from montecarlooptionspricer_tpu.models import lsm as jlsm
from montecarlooptionspricer_tpu_torch.models import lsm as tlsm

DT = 1 / 252


def _paths(rng, n_paths=512, n_steps=48, s0=100.0):
    """Log-normal random-walk paths [n, n_steps + 1] in float32."""
    inc = rng.normal(-0.5 * 0.3 ** 2 * DT, 0.3 * np.sqrt(DT),
                     size=(n_paths, n_steps))
    logs = np.log(s0) + np.concatenate(
        [np.zeros((n_paths, 1)), np.cumsum(inc, axis=1)], axis=1)
    return np.exp(logs).astype(np.float32)


# (is_call, strike, maturity in steps): the 40-step maturity on 48 steps
# exercises the past-maturity discount; the strike-70 put has steps with
# no ITM path (the empty-ITM skip).
CASES = [(False, 102.0, 48), (True, 98.0, 40), (False, 70.0, 48)]


@pytest.mark.parametrize("is_call,strike,mat_steps", CASES)
def test_lsm_fit_matches_jax(rng, is_call, strike, mat_steps):
    """Per-step coefficients, mu and sd.  Float32 sums run in another
    order; a value-carrying ratchet can pass that rounding backward, so the
    coefficients are held at rtol 1e-4 relative to each step's largest
    coefficient (steps with >= 8 ITM paths), mu and sd at rtol 1e-5."""
    paths = _paths(rng)
    maturity = mat_steps * DT
    if strike == 70.0:
        p = np.maximum(strike - paths, 0.0)
        assert not (p[:, 1] > 1e-14).any()   # an empty-ITM step is covered
    _, jf = jlsm.lsm_fit(jnp.asarray(paths), 0.04, strike, maturity, DT,
                         is_call, 2)
    _, tf = tlsm.lsm_fit(torch.from_numpy(paths), 0.04, strike, maturity,
                         DT, is_call, 2)
    want_c = np.asarray(jf.coeffs)
    got_c = tf.coeffs.numpy()
    assert got_c.shape == want_c.shape == (paths.shape[1] - 1, 3)
    pay = np.maximum(paths - strike, 0) if is_call else np.maximum(
        strike - paths, 0)
    n_itm = (pay[:, :-1] > 1e-14).sum(axis=0)
    for j, k in enumerate(n_itm):
        if k == 0:       # dead fit: exactly (1e30, 0, 0) in both
            np.testing.assert_array_equal(got_c[j], want_c[j])
        elif k < 8:
            # A handful of ITM rows leaves the quadratic underdetermined up
            # to the ridge (e.g. two rows: only c0 + c2 is fixed), so hold
            # the well-determined quantity, the fitted values on those rows.
            x = paths[pay[:, j] > 1e-14, j]
            z = (x - np.asarray(jf.mu)[j]) / np.asarray(jf.sd)[j]
            fv = lambda c: (c[2] * z + c[1]) * z + c[0]
            np.testing.assert_allclose(fv(got_c[j]), fv(want_c[j]),
                                       rtol=1e-4, atol=1e-4)
        else:
            scale = np.max(np.abs(want_c[j]))
            err = np.abs(got_c[j] - want_c[j])
            assert np.all(err <= 1e-4 * (np.abs(want_c[j]) + scale)), (j, err)
    np.testing.assert_allclose(tf.mu.numpy(), np.asarray(jf.mu), rtol=1e-5)
    np.testing.assert_allclose(tf.sd.numpy(), np.asarray(jf.sd), rtol=1e-5)


@pytest.mark.parametrize("is_call,strike,mat_steps", CASES)
def test_lsm_price_matches_jax(rng, is_call, strike, mat_steps):
    """The price is a mean over paths of float32 carried values: rtol
    1e-5."""
    paths = _paths(rng)
    maturity = mat_steps * DT
    want = float(jlsm.lsm_price(jnp.asarray(paths), 0.04, strike, maturity,
                                DT, is_call, 2))
    got = float(tlsm.lsm_price(torch.from_numpy(paths), 0.04, strike,
                               maturity, DT, is_call, 2))
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("is_call,strike,mat_steps", CASES)
def test_lsm_price_matches_scalar_oracle(rng, is_call, strike, mat_steps):
    """The float64 scalar LSM oracle (per-step SVD least squares on the
    ITM rows): within 2% as the JAX package's own parity test holds it
    (the fit lives in another basis and float32)."""
    from oracles import lsm_price as oracle_price

    paths = _paths(rng)
    maturity = mat_steps * DT
    ref = oracle_price(paths.astype(np.float64), 0.04, strike, maturity, DT,
                       is_call, 2)
    got = float(tlsm.lsm_price(torch.from_numpy(paths), 0.04, strike,
                               maturity, DT, is_call, 2))
    assert abs(got - ref) < 2e-2 * max(1.0, abs(ref)), (got, ref)
