"""The port's PredictionGen pricers against the JAX package's on shared
numpy inputs: the rough-vol estimators on one history, the bucketed path
synthesis on injected noise, the four estimators row by row on those
paths and injected branch indices, and the batched ``price_all`` against
the port's own unpadded single-row calls.  Everything here is plain
PyTorch (the JAX package prices these rows in XLA, outside any Pallas
kernel), so nothing needs the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlooptionspricer_tpu.models import asymptotic as jasym
from montecarlooptionspricer_tpu.models import branching as jbr
from montecarlooptionspricer_tpu.models import lsm as jlsm
from montecarlooptionspricer_tpu.models import martingale as jmart
from montecarlooptionspricer_tpu.models import rough_volatility as jrv
from montecarlooptionspricer_tpu.ops import estimators as jest
from montecarlooptionspricer_tpu_torch.models import asymptotic as tasym
from montecarlooptionspricer_tpu_torch.models import branching as tbr
from montecarlooptionspricer_tpu_torch.models import gbm as tgbm
from montecarlooptionspricer_tpu_torch.models import lsm as tlsm
from montecarlooptionspricer_tpu_torch.models import martingale as tmart
from montecarlooptionspricer_tpu_torch.models import pricing as tpricing
from montecarlooptionspricer_tpu_torch.models import rough_volatility as trv
from montecarlooptionspricer_tpu_torch.ops import estimators as test_
from montecarlooptionspricer_tpu_torch.ops import rng as trng
from montecarlooptionspricer_tpu_torch.ops.reductions import row_sum

DT = 1.0 / 252.0
R = 0.04
PATHS = 128
BRANCHES = 4
# One bucket (n_pad 32, m1 32) of mixed horizons, and the power of two 32,
# which has its own m1 = 64.
BUCKETS = [((32, 32), [17, 25, 31, 20]), ((32, 64), [32])]
ROW = dict(s0=[100.0, 98.0, 103.0, 101.0], xi=[0.04, 0.09, 0.02, 0.05],
           h=[0.1, 0.3, 0.07, 0.45], eta=[1.5, 0.9, 2.0, 1.1],
           strike=[103.0, 97.0, 100.0, 104.0],
           is_call=[False, True, False, True],
           sigma=[0.2, 0.35, 0.15, 0.25], dividend=[0.01, 0.0, 0.03, 0.02])


def _rows(n_steps):
    """The per-row numpy float32 arguments of len(n_steps) rows, maturity
    half a step past each row's horizon (off the grid, as dte / 365 is)."""
    k = len(n_steps)
    out = {name: np.asarray(v[:k], np.float32) for name, v in ROW.items()
           if name != "is_call"}
    out["is_call"] = np.asarray(ROW["is_call"][:k])
    out["maturity"] = ((np.asarray(n_steps) + 0.5) * DT).astype(np.float32)
    out["n_steps"] = np.asarray(n_steps)
    return out


def _noise(rng, rows, n_draw, n_pad):
    zc = (rng.standard_normal((rows, n_draw, n_pad))
          + 1j * rng.standard_normal((rows, n_draw, n_pad))).astype(
              np.complex64)
    dw = (rng.standard_normal((rows, n_draw, n_pad)) * np.sqrt(DT)).astype(
        np.float32)
    return zc, dw


def _jax_paths(a, n_pad, m1, zc, dw, antithetic=False):
    """JAX's bucketed synthesis row by row (what its pipeline vmaps)."""
    return np.stack([np.asarray(jrv._bucketed_paths_from_noise(
        a["s0"][b], a["xi"][b], a["h"][b], a["eta"][b], R,
        int(a["n_steps"][b]), n_pad, m1, jnp.asarray(zc[b]),
        jnp.asarray(dw[b]), DT, jnp.float32, antithetic=antithetic))
        for b in range(len(a["n_steps"]))])


def _torch_paths(a, n_pad, m1, zc, dw, antithetic=False):
    return trv._bucketed_paths_from_noise(
        torch.from_numpy(a["s0"]), torch.from_numpy(a["xi"]),
        torch.from_numpy(a["h"]), torch.from_numpy(a["eta"]), R,
        torch.from_numpy(a["n_steps"]), n_pad, m1, torch.from_numpy(zc),
        torch.from_numpy(dw), DT, antithetic=antithetic).numpy()


@pytest.mark.parametrize("n_hist", [60, 400, 1260])
def test_estimate_params_matches_jax(rng, n_hist):
    """The port's estimate_params (its native host engine) against the
    JAX package's (its native engine where built, else its NumPy path):
    1e-12 relative on every parameter."""
    hist = 100.0 * np.exp(np.cumsum(rng.normal(0.0002, 0.015, n_hist)))
    want = jest.estimate_params(hist, r=R)
    got = test_.estimate_params(hist, r=R)
    for name in ("s0", "xi", "h", "eta", "rho", "r"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=1e-12, err_msg=name)
    assert got.rho_complement == pytest.approx(want.rho_complement,
                                               rel=1e-12)
    with pytest.raises(ValueError):
        test_.estimate_params(hist[:1])


@pytest.mark.parametrize("antithetic", [False, True], ids=["plain", "anti"])
@pytest.mark.parametrize("bucket", range(len(BUCKETS)))
def test_bucketed_paths_match_jax(rng, bucket, antithetic):
    """[rows, paths, n_pad + 1] from one call on injected noise against
    JAX's per-row synthesis: 2e-5 relative, and flat past each row's
    horizon."""
    (n_pad, m1), n_steps = BUCKETS[bucket]
    a = _rows(n_steps)
    n_draw = PATHS // 2 if antithetic else PATHS
    zc, dw = _noise(rng, len(n_steps), n_draw, n_pad)
    want = _jax_paths(a, n_pad, m1, zc, dw, antithetic)
    got = _torch_paths(a, n_pad, m1, zc, dw, antithetic)
    assert got.shape == want.shape == (len(n_steps), PATHS, n_pad + 1)
    np.testing.assert_allclose(got, want, rtol=2e-5)
    for b, n in enumerate(n_steps):
        assert (got[b, :, n + 1:] == got[b, :, n:n + 1]).all()


def _pricer_inputs(rng):
    (n_pad, m1), n_steps = BUCKETS[0]
    a = _rows(n_steps)
    zc, dw = _noise(rng, len(n_steps), PATHS, n_pad)
    paths = _jax_paths(a, n_pad, m1, zc, dw)
    rp = rng.integers(0, PATHS, (len(n_steps), PATHS, n_pad, BRANCHES))
    return a, paths, rp


def _jax_row(fn, a, b, *args, **kw):
    """A JAX estimator on row b with the pipeline's per-row types (float32
    scalars, a traced option type)."""
    f32 = lambda name: jnp.float32(a[name][b])
    return float(fn(*args[:1], R, f32("strike"), f32("maturity"), DT,
                    jnp.asarray(a["is_call"][b]), *args[1:], **kw))


def test_estimators_match_jax_row_by_row(rng):
    """The asymptotic estimator, the branching lower and upper bounds on
    the same branch indices, LSM and the martingale estimator with the
    rows' horizons, on padded paths, against JAX's per row: 1e-5 relative
    (the tolerance the LSM price is held to, test_torch_lsm.py)."""
    a, paths, rp = _pricer_inputs(rng)
    t = torch.from_numpy(paths)
    n_steps = torch.from_numpy(a["n_steps"])
    kw = dict(strike=torch.from_numpy(a["strike"]),
              maturity=torch.from_numpy(a["maturity"]), dt=DT,
              is_call=torch.from_numpy(a["is_call"]))
    got = {
        "asymptotic": tasym.asymptotic_price(
            t, R, **kw, sigma=torch.from_numpy(a["sigma"]),
            dividend=torch.from_numpy(a["dividend"])),
        "lower": tbr.lower_bound(t, R, **kw, n_steps=n_steps),
        "upper": tbr.upper_bound(t, R, **kw, num_branches=BRANCHES,
                                 rp=torch.from_numpy(rp), n_steps=n_steps),
        "lsm": tlsm.lsm_price_rows(t, R, **kw, n_steps=n_steps),
        "martingale": tmart.martingale_price(t, R, **kw, n_steps=n_steps),
    }
    ex = jnp.arange(paths.shape[-1] - 1)
    for b in range(len(a["n_steps"])):
        p = jnp.asarray(paths[b])
        n = jnp.int32(a["n_steps"][b])      # traced, as the pipeline's
        want = {
            "asymptotic": _jax_row(jasym.asymptotic_price, a, b, p,
                                   jnp.float32(a["sigma"][b]),
                                   jnp.float32(a["dividend"][b])),
            "lower": _jax_row(jbr.lower_bound, a, b, p, ex, n_steps=n),
            "upper": _jax_row(jbr.upper_bound, a, b, p, BRANCHES, ex,
                              jax.random.key(0), rp=jnp.asarray(rp[b]),
                              n_steps=n),
            "lsm": _jax_row(jlsm.lsm_price, a, b, p, 2, n_steps=n),
            "martingale": _jax_row(jmart.martingale_price, a, b, p, 2, 5,
                                   n_steps=n),
        }
        for name, w in want.items():
            assert w > 0.0, (name, b)
            np.testing.assert_allclose(float(got[name][b]), w, rtol=1e-5,
                                       err_msg=f"{name} row {b}")
        # The single-matrix API with a horizon is the same computation.
        one = tlsm.lsm_price(t[b], R, float(a["strike"][b]),
                             float(a["maturity"][b]), DT,
                             bool(a["is_call"][b]), 2, n_steps=int(n))
        assert float(one) == float(got["lsm"][b])


def test_branching_draws_accumulate_per_branch(rng):
    """The seeded form's callable of the branch gives the same bound as the
    [rows, paths, T, B] tensor it would stack."""
    a, paths, rp = _pricer_inputs(rng)
    t = torch.from_numpy(paths)
    kw = dict(strike=torch.from_numpy(a["strike"]),
              maturity=torch.from_numpy(a["maturity"]), dt=DT,
              is_call=torch.from_numpy(a["is_call"]), num_branches=BRANCHES,
              n_steps=torch.from_numpy(a["n_steps"]))
    rp_t = torch.from_numpy(rp)
    whole = tbr.upper_bound(t, R, rp=rp_t, **kw)
    planes = tbr.upper_bound(t, R, rp=lambda b: rp_t[..., b].contiguous(),
                             **kw)
    assert torch.equal(whole, planes)
    with pytest.raises(ValueError, match="branch indices"):
        tbr.upper_bound(t, R, **kw)


def test_price_all_padding_is_exact(rng):
    """The [rows, 4] batched ``price_all`` on padded blocks against the
    port's unpadded single-row calls on each row's first n_steps + 1
    columns (and its first n_steps exercise times' branch indices): the
    same bits."""
    a, paths, rp = _pricer_inputs(rng)
    t = torch.from_numpy(paths)
    spec = tpricing.PricerSpec(
        r=R, strike=torch.from_numpy(a["strike"]),
        maturity=torch.from_numpy(a["maturity"]), dt=DT,
        is_call=torch.from_numpy(a["is_call"]),
        sigma=torch.from_numpy(a["sigma"]),
        dividend=torch.from_numpy(a["dividend"]), num_branches=BRANCHES)
    batched = tpricing.price_all(t, spec, torch.from_numpy(rp),
                                 n_steps=torch.from_numpy(a["n_steps"]))
    assert batched.shape == (len(a["n_steps"]), 4)
    for b, n in enumerate(a["n_steps"]):
        one = tpricing.PricerSpec(
            r=R, strike=float(a["strike"][b]),
            maturity=float(a["maturity"][b]), dt=DT,
            is_call=bool(a["is_call"][b]), sigma=float(a["sigma"][b]),
            dividend=float(a["dividend"][b]), num_branches=BRANCHES)
        single = tpricing.price_all(t[b:b + 1, :, :n + 1], one,
                                    torch.from_numpy(rp[b:b + 1, :, :n]))
        assert torch.equal(single[0], batched[b]), (b, single, batched[b])


def test_row_sum_is_batch_independent(rng):
    """A row's ``row_sum`` has the same bits alone, in a larger batch and
    at another position in it."""
    x = torch.from_numpy(rng.standard_normal((6, 250)).astype(np.float32))
    whole = row_sum(x)
    for b in range(6):
        assert torch.equal(row_sum(x[b:b + 1])[0], whole[b])
        assert torch.equal(row_sum(torch.roll(x, 1, 0))[(b + 1) % 6],
                           whole[b])
    gram = row_sum(x[:, :, None] * x[:, None, :2], dim=-2)
    np.testing.assert_allclose(gram.numpy(),
                               torch.sum(x[:, :, None] * x[:, None, :2],
                                         dim=-2).numpy(), rtol=1e-5)


def test_row_generators_depend_on_seed_and_index():
    """A row's stream is a function of (seed, row index) alone."""
    draw = lambda s, i: trng.normal(trng.generator_for_row(s, i, "cpu"),
                                    (4,))
    assert torch.equal(draw(5, 7), draw(5, 7))
    assert not torch.equal(draw(5, 7), draw(5, 8))
    assert not torch.equal(draw(5, 7), draw(6, 7))
    re, im = trng.complex_normal(trng.generator_for_row(5, 7, "cpu"), (2, 3))
    assert re.shape == im.shape == (2, 3) and re.dtype == torch.float32


def test_gbm_lsm_brackets_binomial_american_put():
    """GBM paths through the row pricer's LSM: within 10 % of the binomial
    American put and above Black-Scholes - 0.15 (tests/test_pricers.py
    holds JAX's LSM so)."""
    from montecarlooptionspricer_tpu_torch.models.closed_form import (
        binomial_american, black_scholes)

    s0, k, r, sigma, t = 100.0, 110.0, 0.05, 0.25, 0.5
    steps = 50
    gen = torch.Generator().manual_seed(42)
    paths = tgbm.generate_paths(gen, s0, sigma, r, steps, 20_000, t / steps)
    assert paths.shape == (20_000, steps + 1)
    price = float(tlsm.lsm_price_rows(paths[None], r, k, t, t / steps,
                                      False)[0])
    amer = binomial_american(s0, k, r, sigma, t, False, steps=2000)
    euro = black_scholes(s0, k, r, sigma, t, False)
    assert euro - 0.15 < price < amer * 1.10, (price, euro, amer)
    assert abs(price - amer) / amer < 0.10


def test_seeded_single_row_paths_are_the_model():
    """``generate_paths`` and ``generate_paths_from_history``: s0 in
    column 0, finite positive prices, and the log-price mean near
    log s0 + r t (the variance's compensator keeps E[S_t] = s0 e^{rt})."""
    gen = torch.Generator().manual_seed(3)
    p = trv.generate_paths(gen, 100.0, 0.04, 0.1, 1.5, -0.4, R, 21, 4096)
    assert p.shape == (4096, 22) and (p[:, 0] == 100.0).all()
    assert torch.isfinite(p).all() and (p > 0).all()
    mean = float(p[:, -1].mean())
    assert abs(mean / (100.0 * np.exp(R * 21 * DT)) - 1.0) < 0.01
    hist = 100.0 * np.exp(np.cumsum(np.random.default_rng(0).normal(
        0.0, 0.01, 300)))
    q = trv.generate_paths_from_history(gen, hist, 10, 64)
    assert q.shape == (64, 11) and float(q[0, 0]) == pytest.approx(
        hist[-1], rel=1e-6)
    # The QMC form (refused naming A12 before it was ported): the same
    # model, s0 in column 0 and the same drift.
    pq = trv.generate_paths_qmc(gen, 100.0, 0.04, 0.1, 1.5, -0.4, R, 21,
                                4096)
    assert pq.shape == (4096, 22) and (pq[:, 0] == 100.0).all()
    assert torch.isfinite(pq).all() and (pq > 0).all()
    assert abs(float(pq[:, -1].mean()) / (100.0 * np.exp(R * 21 * DT))
               - 1.0) < 0.01


@pytest.mark.parametrize("antithetic", [False, True], ids=["plain", "anti"])
def test_seeded_bucketed_paths(antithetic):
    """``generate_paths_bucketed`` from per-row generators: each row's block
    is the row's own stream (the same alone as in the batch), flat past
    its horizon, and E[S_n] = s0 e^{r n dt} within 1 %."""
    (n_pad, m1), n_steps = BUCKETS[0]
    a = _rows(n_steps)
    args = [torch.from_numpy(a[k]) for k in ("s0", "xi", "h", "eta")]
    ns = torch.from_numpy(a["n_steps"])

    def paths(rows):
        gens = [trng.generator_for_row(9, i, "cpu") for i in rows]
        return trv.generate_paths_bucketed(
            gens, *(x[rows] for x in args), -0.4, R, ns[rows], n_pad, m1,
            4096, DT, antithetic=antithetic)

    whole = paths([0, 1, 2, 3])
    assert whole.shape == (4, 4096, n_pad + 1)
    assert torch.equal(paths([2])[0], whole[2])
    for b, n in enumerate(n_steps):
        assert (whole[b, :, n + 1:] == whole[b, :, n:n + 1]).all()
        want = a["s0"][b] * np.exp(R * n * DT)
        assert abs(float(whole[b, :, n].mean()) / want - 1.0) < 0.01
