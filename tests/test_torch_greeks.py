"""The port's pathwise Greeks against the JAX package: the plain version of
K3 and K4 (``greeks_cuda`` wrappers on CPU tensors) against JAX's fused
Greeks kernels in interpret mode on the same numpy noise and tables, and
against a float64 finite-difference oracle with the table held fixed; the
host constants; and ``price_and_greeks`` on both pricers.  K3 and K4
themselves are held against this plain version on the card in
test_torch_gpu.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlooptionspricer_tpu.models import engine as jengine
from montecarlooptionspricer_tpu.models import pathgen_pallas as jpp
from montecarlooptionspricer_tpu_torch.models import engine as tengine
from montecarlooptionspricer_tpu_torch.models import greeks_cuda as gc
from montecarlooptionspricer_tpu_torch.models import pathgen_cuda as pc
from montecarlooptionspricer_tpu_torch.ops.regression import (
    polyfit_from_numpy)

from test_torch_chain import BENCH_MARKET, jax_strip_fits
from test_torch_pathgen import (DT, KW, jax_pilot_fits, port_noise,
                                shared_noise)

N_STEPS, ROWS = 48, 256
MATURITY = N_STEPS * DT


def consts_cpu(n_steps=N_STEPS):
    return (pc.make_path_consts(KW["s0"], KW["xi"], KW["h"], KW["eta"],
                                KW["r"], n_steps, DT, "cpu"),
            pc.make_greeks_consts(KW["xi"], KW["h"], KW["eta"], n_steps, DT,
                                  "cpu"))


def strip_tables(rng, strikes, is_call):
    """JAX's S-space strip tables on a JAX pilot, and their log forms."""
    paths, _ = jax_pilot_fits(shared_noise(rng, 512, N_STEPS), 100.0,
                              MATURITY, is_call, n_steps=N_STEPS)
    _, tab = jax_strip_fits(paths, strikes, is_call)
    return tab, jax.vmap(jpp.log_boundary_rows)(tab)


def scaled_err(got, want):
    """|got - want| over each output's scale, floored at 1e-3 of the
    largest output (a near-zero Greek is held absolutely), as the JAX
    package's own Greeks test does."""
    scale = np.maximum(np.abs(want), 1e-3 * np.max(np.abs(want)))
    return np.abs(got - want) / scale


def test_greeks_consts_match_jax():
    """dLt/dH is the same float64 difference of the same float64 Cholesky
    (1e-12 against JAX's before its float32 cast; rtol 1e-6 after it), and
    the tangent rows equal JAX's aux rows 1 and 2."""
    for n in (32, 96):
        want = np.asarray(jengine._chol_dh_matrix_host(
            n, KW["h"], KW["eta"], DT, jnp.float32))
        got = tengine._chol_dh_matrix_host(n, KW["h"], KW["eta"], DT)
        np.testing.assert_allclose(np.float32(got), want, rtol=1e-6,
                                   atol=1e-6 * np.max(np.abs(want)))
        lp = tengine._chol_np(n, KW["h"] + 1e-5, KW["eta"], DT)
        lm = jengine._chol_np(n, KW["h"] - 1e-5, KW["eta"], DT)
        np.testing.assert_allclose(got, ((lp - lm) / 2e-5).T, rtol=0,
                                   atol=1e-12 * np.max(np.abs(got)))
        s_pad = pc._round_up(n, pc.LANE)
        _, dlt, _, _, aux = jpp._greeks_consts(n, s_pad, KW["xi"], KW["h"],
                                               KW["eta"], DT, jnp.float32)
        g = pc.make_greeks_consts(KW["xi"], KW["h"], KW["eta"], n, DT, "cpu")
        np.testing.assert_array_equal(g.dlt_half.numpy(),
                                      np.asarray(dlt)[:n, :n])
        np.testing.assert_array_equal(g.de.numpy(), np.asarray(aux)[1, :n])
        np.testing.assert_array_equal(g.dh.numpy(), np.asarray(aux)[2, :n])


@pytest.mark.parametrize("is_call,strike", [(False, 99.0), (True, 101.0)])
def test_greeks_ref_matches_jax(rng, is_call, strike):
    """Plain K3 against JAX's fused Greeks kernel on the same noise and
    table, all six outputs: 2e-4 of each output's scale (the cumsums run in
    another float32 order than the TPU kernel's triangular matmuls)."""
    _, ltab = strip_tables(rng, [strike], is_call)
    greeks, _ = jpp.make_pallas_greeks_chunk(
        **KW, strike=strike, maturity=MATURITY, dt=DT, n_steps=N_STEPS,
        chunk_paths=ROWS, block_paths=128, is_call=is_call, interpret=True,
        noise_input=True)
    noise = shared_noise(rng, ROWS, N_STEPS)
    want = np.asarray(greeks(jnp.asarray(noise), ltab[0]))
    consts, g = consts_cpu()
    got = gc.greeks_chunk(consts, g, torch.tensor(np.asarray(ltab[0])),
                          strike, is_call, noise=port_noise(noise, N_STEPS))
    assert got.shape == (6,) and want[0] > 0
    assert np.all(scaled_err(got.numpy(), want) < 2e-4), (got, want)


def _oracle_value(noise, lo, hi, strike, s0, xi, r, eta, h):
    """float64 sum of discounted payoffs under the fixed S-space interval
    table (the envelope convention: the table does not move with the
    parameters); tests/test_pallas_greeks.py's oracle."""
    n = noise[0, :, :N_STEPS].astype(np.float64)
    w = noise[1, :, :N_STEPS].astype(np.float64)
    lt = tengine._chol_np(N_STEPS, h, eta, DT).T
    x = n @ lt
    td = np.arange(N_STEPS) * DT
    v = xi * np.exp(x - 0.5 * eta * eta * td ** (2.0 * h))
    inc = (r - 0.5 * v) * DT + np.sqrt(v) * w * np.sqrt(DT)
    s = np.exp(np.log(s0) + np.cumsum(inc, axis=1))
    exf = (s >= lo[:N_STEPS]) & (s <= hi[:N_STEPS])
    any_ex = exf.any(axis=1)
    stop = np.where(any_ex, exf.argmax(axis=1), 0)
    s_stop = s[np.arange(s.shape[0]), stop]
    p = np.maximum(strike - s_stop, 0.0)
    return float(np.sum(np.where(any_ex, np.exp(-r * (stop + 1) * DT) * p,
                                 0.0)))


def test_greeks_ref_matches_f64_fd_oracle(rng):
    """Plain K3 against central finite differences of a float64 oracle of
    the same policy value with the table held fixed, all six outputs: 5e-3
    of each output's scale, as the JAX package holds its kernel (float32
    path noise accumulates through the tangent sums; a wrong sign or term
    is orders of magnitude larger)."""
    strike = 97.0
    tab, ltab = strip_tables(rng, [strike], False)
    lo, hi = (np.asarray(tab[0, i], np.float64) for i in (0, 1))
    noise = shared_noise(rng, ROWS, N_STEPS)
    consts, g = consts_cpu()
    got = gc.greeks_chunk(consts, g, torch.tensor(np.asarray(ltab[0])),
                          strike, False,
                          noise=port_noise(noise, N_STEPS)).numpy()
    base = dict(s0=KW["s0"], xi=KW["xi"], r=KW["r"], eta=KW["eta"],
                h=KW["h"])
    eps = dict(s0=1e-3, xi=1e-6, r=1e-5, eta=1e-5, h=1e-5)

    def fd(name):
        up, dn = dict(base), dict(base)
        up[name] += eps[name]
        dn[name] -= eps[name]
        return (_oracle_value(noise, lo, hi, strike, **up)
                - _oracle_value(noise, lo, hi, strike, **dn)) / (
                    2 * eps[name])

    want = np.array([_oracle_value(noise, lo, hi, strike, **base), fd("s0"),
                     fd("xi"), fd("eta"), fd("r"), fd("h")])
    assert np.all(scaled_err(got, want) < 5e-3), (got, want)


@pytest.mark.parametrize("strikes", [[94.0, 99.0, 104.0],
                                     [float(k) for k in
                                      np.linspace(88.0, 112.0, 13)]])
def test_chain_greeks_ref_matches_jax_and_single_strike(rng, strikes):
    """Plain K4 against JAX's chain Greeks kernel (13 strikes: JAX's two
    regenerated groups), 2e-4 of each output's scale, and each strike's
    column against plain K3 on the same noise and table (the same
    arithmetic: rtol 1e-6)."""
    _, ltab = strip_tables(rng, strikes, False)
    chain, _ = jpp.make_pallas_chain_greeks_chunk(
        **KW, strikes=len(strikes), maturity=MATURITY, dt=DT,
        n_steps=N_STEPS, chunk_paths=ROWS, block_paths=128, is_call=False,
        interpret=True, noise_input=True)
    noise = shared_noise(rng, ROWS, N_STEPS)
    want = np.asarray(chain(jnp.asarray(noise), ltab))
    consts, g = consts_cpu()
    tables = torch.tensor(np.asarray(ltab))
    tnoise = port_noise(noise, N_STEPS)
    got = gc.chain_greeks_chunk(consts, g, tables, False, noise=tnoise)
    assert got.shape == want.shape == (6, len(strikes))
    for j, strike in enumerate(strikes):
        assert np.all(scaled_err(got[:, j].numpy(), want[:, j]) < 2e-4), j
        one = gc.greeks_chunk(consts, g, tables[j], strike, False,
                              noise=tnoise)
        np.testing.assert_allclose(got[:, j].numpy(), one.numpy(),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("strikes", [[101.0], [94.0, 99.0, 104.0],
                                     [float(k) for k in
                                      np.linspace(88.0, 112.0, 13)]])
def test_greeks_pair_ref_matches_jax(rng, strikes):
    """Plain K3/anti (one strike) and K4/anti (3 and 13 strikes: JAX's
    two regenerated groups) against JAX's Greeks kernels with
    antithetic=True in interpret mode on the same half-row noise and
    tables: 2e-4 of each output's scale.  The paired plain version
    against the unpaired one on [X; -X]: 1e-5 of each output's scale."""
    _, ltab = strip_tables(rng, strikes, False)
    kw = dict(**KW, maturity=MATURITY, dt=DT, n_steps=N_STEPS,
              chunk_paths=ROWS, block_paths=128, is_call=False,
              interpret=True, noise_input=True, antithetic=True)
    noise = shared_noise(rng, ROWS // 2, N_STEPS)
    consts, g = consts_cpu()
    tables = torch.tensor(np.asarray(ltab))
    half = port_noise(noise, N_STEPS)
    doubled = torch.cat([half, -half], dim=1)
    if len(strikes) == 1:
        greeks, _ = jpp.make_pallas_greeks_chunk(strike=strikes[0], **kw)
        want = np.asarray(greeks(jnp.asarray(noise), ltab[0]))[:, None]
        got = gc.greeks_chunk(consts, g, tables[0], strikes[0], False,
                              noise=half, antithetic=True)[:, None]
        unpaired = gc.greeks_chunk(consts, g, tables[0], strikes[0], False,
                                   noise=doubled)[:, None]
    else:
        chain, _ = jpp.make_pallas_chain_greeks_chunk(strikes=len(strikes),
                                                      **kw)
        want = np.asarray(chain(jnp.asarray(noise), ltab))
        got = gc.chain_greeks_chunk(consts, g, tables, False, noise=half,
                                    antithetic=True)
        unpaired = gc.chain_greeks_chunk(consts, g, tables, False,
                                         noise=doubled)
    assert got.shape == want.shape == (6, len(strikes)) and want[0, 0] > 0
    for j in range(len(strikes)):
        assert np.all(scaled_err(got[:, j].numpy(), want[:, j]) < 2e-4), j
        assert np.all(scaled_err(got[:, j].numpy(),
                                 unpaired[:, j].numpy()) < 1e-5), j


def test_paired_greeks_stream_k3_and_k4_pairs():
    """price_and_greeks under antithetic (refused before K3 and K4 had
    pair forms): the single strike and the strip stream the pair forms,
    their price lanes equal the paired prices of K2 and K5 on the same
    seed (rtol 1e-4: log- and S-space decisions differ in the root band),
    and the strip's columns equal the single pricer's at the same strike
    (rtol 1e-5)."""
    cfg = tengine.StreamConfig(n_paths=4 * 512, n_steps=N_STEPS,
                               chunk_paths=512, pilot_paths=1024, dt=DT,
                               antithetic=True)
    pricer = tengine.StreamingPricer(**BENCH_MARKET, strike=103.0,
                                     maturity=MATURITY, is_call=False,
                                     config=cfg, device="cpu")
    greeks, se = pricer.price_and_greeks(2, with_stderr=True)
    np.testing.assert_allclose(greeks[0], pricer.price(2), rtol=1e-5)
    assert greeks[1] < 0 and greeks[2] > 0 and all(np.isfinite(se))
    chain = tengine.StreamingChainPricer(
        **BENCH_MARKET, strikes=[97.0, 103.0], maturity=MATURITY,
        is_call=False, config=cfg, device="cpu")
    cg = chain.price_and_greeks(2)
    np.testing.assert_allclose(cg[0], chain.price(2), rtol=1e-4)
    np.testing.assert_allclose(cg[:, 1], greeks, rtol=1e-5, atol=1e-6)


def test_price_lane_matches_price_and_time0():
    """price_and_greeks uses price()'s pilot, fit and table, so its price
    lane is price() on the same seed up to the stop step's recomputed
    discount (rtol 1e-5); a deep-ITM put exercises at time 0 and leaves
    (p0, -1, 0, 0, 0, 0) with zero stderrs."""
    cfg = tengine.StreamConfig(n_paths=4 * 512, n_steps=N_STEPS,
                               chunk_paths=512, pilot_paths=1024, dt=DT)
    pricer = tengine.StreamingPricer(**BENCH_MARKET, strike=103.0,
                                     maturity=MATURITY, is_call=False,
                                     config=cfg, device="cpu")
    greeks, se = pricer.price_and_greeks(2, with_stderr=True)
    price, price_se = pricer.price(2, with_stderr=True)
    assert len(greeks) == len(se) == 6
    np.testing.assert_allclose(greeks[0], price, rtol=1e-5)
    np.testing.assert_allclose(se[0], price_se, rtol=1e-4)
    assert greeks[1] < 0 and greeks[2] > 0 and all(np.isfinite(se))

    deep = tengine.StreamingPricer(**BENCH_MARKET, strike=1000.0,
                                   maturity=MATURITY, is_call=False,
                                   config=cfg, device="cpu")
    greeks, se = deep.price_and_greeks(2, with_stderr=True)
    assert greeks == (900.0, -1.0, 0.0, 0.0, 0.0, 0.0)
    assert se == (0.0,) * 6


def test_chain_greeks_price_row_matches_chain_price():
    """The chain's Greeks (K4, log-space decisions) and its prices (K5,
    S-space decisions) on one seed share the fits and the paths: the
    price row agrees to rtol 1e-4 (root-band flips), and a time-0 strike
    keeps its deterministic column."""
    cfg = tengine.StreamConfig(n_paths=4 * 512, n_steps=N_STEPS,
                               chunk_paths=512, pilot_paths=1024, dt=DT)
    strikes = [95.0, 100.0, 105.0, 1000.0]
    chain = tengine.StreamingChainPricer(
        **BENCH_MARKET, strikes=strikes, maturity=MATURITY, is_call=False,
        config=cfg, device="cpu")
    greeks, se = chain.price_and_greeks(4, with_stderr=True)
    prices = chain.price(4)
    assert greeks.shape == se.shape == (6, 4)
    np.testing.assert_allclose(greeks[0], prices, rtol=1e-4)
    np.testing.assert_array_equal(greeks[:, 3], [900.0, -1.0, 0, 0, 0, 0])
    np.testing.assert_array_equal(se[:, 3], 0.0)


@pytest.mark.parametrize("chain", [False, True])
def test_seeded_greeks_in_distribution_match_jax(chain):
    """The port's seeded Greeks (K3, or K4 per strike) against the JAX
    pricers' jvp Greeks through the XLA generator (another random stream)
    under JAX's fitted policy, converted with polyfit_from_numpy: each
    output within 5 combined stderr.  The fits are shared because the
    derivatives, unlike the price, move at first order with the exercise
    boundary, so two independent pilots disagree on them (the JAX
    package's own on-chip check shares its fits for this reason)."""
    n_steps, chunk, n_chunks, pilot = 32, 2048, 8, 4096
    maturity, strikes = n_steps * DT, [97.0, 103.0]
    cfg = tengine.StreamConfig(n_paths=n_chunks * chunk, n_steps=n_steps,
                               chunk_paths=chunk, pilot_paths=pilot, dt=DT)
    jcfg = jengine.StreamConfig(n_paths=n_chunks * chunk, n_steps=n_steps,
                                chunk_paths=chunk, pilot_paths=pilot, dt=DT,
                                pathgen_impl="xla")
    key = jax.random.key(1)
    k_pilot = jax.random.split(key)[0]
    if chain:
        jp = jengine.StreamingChainPricer(
            **BENCH_MARKET, strikes=strikes, maturity=maturity,
            is_call=False, config=jcfg)
        fits = jp._greek_fit(k_pilot, jnp.asarray(strikes, jnp.float32))
        tp = tengine.StreamingChainPricer(
            **BENCH_MARKET, strikes=strikes, maturity=maturity,
            is_call=False, config=cfg, device="cpu")
    else:
        jp = jengine.StreamingPricer(
            **BENCH_MARKET, strike=strikes[1], maturity=maturity,
            is_call=False, config=jcfg)
        fits = jp._greek_fit(k_pilot)
        tp = tengine.StreamingPricer(
            **BENCH_MARKET, strike=strikes[1], maturity=maturity,
            is_call=False, config=cfg, device="cpu")
    want, se_j = jp.price_and_greeks(key, with_stderr=True)
    got, se_t = tp.greeks_with_fit(polyfit_from_numpy(
        np.asarray(fits.coeffs), np.asarray(fits.mu), np.asarray(fits.sd),
        "cpu"), 1, with_stderr=True)
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape == ((6, 2) if chain else (6,))
    tol = 5 * np.hypot(np.asarray(se_t), np.asarray(se_j))
    assert np.all(np.abs(got - want) < tol), (got, want, tol)


@pytest.mark.parametrize("config", [dict(n_steps=400),
                                    dict(n_steps=32, pathgen_impl="xla"),
                                    dict(n_steps=32, poly_order=3)],
                         ids=["past-365", "xla", "poly3"])
def test_greeks_past_the_single_tile_horizon_raise(config):
    """Greeks past 365 steps and on the generic stream (refused naming
    ROADMAP A10 before the jvp Greeks were ported) ride the jvp Greeks
    stream on both pricers: finite, a put's delta below 0 and vega_xi
    above, the strip's row of one strike the single pricer's (the same
    pilot carrier and chunks), and the price lane within 5 combined stderr
    of ``price`` (on the "stream" family the same paths: 1e-5)."""
    cfg = tengine.StreamConfig(n_paths=1024, chunk_paths=256,
                               pilot_paths=256, dt=DT, **config)
    maturity = config["n_steps"] * DT
    pricer = tengine.StreamingPricer(**BENCH_MARKET, strike=100.0,
                                     maturity=maturity, is_call=False,
                                     config=cfg, device="cpu")
    chain = tengine.StreamingChainPricer(**BENCH_MARKET, strikes=[100.0],
                                         maturity=maturity, is_call=False,
                                         config=cfg, device="cpu")
    g, se = pricer.price_and_greeks(0, with_stderr=True)
    rows = chain.price_and_greeks(0)
    assert all(np.isfinite(g)) and g[1] < 0 < g[2]
    np.testing.assert_allclose(rows[:, 0], g, rtol=1e-5, atol=1e-7)
    price, p_se = pricer.price(0, with_stderr=True)
    if pricer.kernel_family == "stream":
        np.testing.assert_allclose(g[0], price, rtol=1e-5)
    else:
        assert abs(g[0] - price) < 5 * np.hypot(se[0], p_se)
