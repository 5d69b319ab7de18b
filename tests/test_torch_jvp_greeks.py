"""The jvp Greeks and the bucketed, traced-market stream of the port
(``pathgen_stream.hurst_matrices``/``with_market``/``paths_from_params``,
``paths_from_noise(n_live=)``, ``lsm_fit(n_steps=)``,
``lsm_policy_path_values(n_steps_live=)``, ``engine.jvp_chunk_greeks``,
the bucketed chain pricer, ``models/greeks.py``) against the JAX package
on its own draws, reproduced from its key splits and injected: the
traced-market chunk within 2e-5, the padded fit within the LSM tests'
tolerances, one chunk's jvp Greeks within 1e-4 of each output's scale
and within 1e-5 of ``torch.autograd`` on the same chunk, vega_h
included.  Everything runs on the CPU."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlooptionspricer_tpu.models import engine as jengine
from montecarlooptionspricer_tpu.models import greeks as jgreeks
from montecarlooptionspricer_tpu.models import lsm as jlsm
from montecarlooptionspricer_tpu.ops.regression import PolyFit as JFit
from montecarlooptionspricer_tpu_torch.models import closed_form
from montecarlooptionspricer_tpu_torch.models import engine as tengine
from montecarlooptionspricer_tpu_torch.models import greeks as tgreeks
from montecarlooptionspricer_tpu_torch.models import lsm as tlsm
from montecarlooptionspricer_tpu_torch.models import pathgen_stream as ps
from montecarlooptionspricer_tpu_torch.ops import rng as trng

from test_torch_pathgen import DT
from test_torch_tiled import BENCH_MARKET

N = 16                    # the step bucket
ROWS = 256
NEW = dict(s0=97.0, xi=0.06, r=0.03, eta=1.2)   # a per-call market
H_NEW = 0.3


@pytest.fixture(autouse=True)
def one_thread():
    """Forward mode runs many small ops; one thread keeps them off the
    pool's wake-ups on a shared host."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def jax_noise(key, rows, n, anti=False):
    """The draws of JAX's ``gen_with_params(key, ...)``: z [2, drawn, n]
    from the first key of ``split(key)``, dw [drawn, n] from the second,
    scaled by sqrt(dt)."""
    drawn = rows // 2 if anti else rows
    kz, kw = jax.random.split(key)
    z = jax.random.normal(kz, (2, drawn, n), jnp.float32)
    dw = jax.random.normal(kw, (drawn, n), jnp.float32) * float(np.sqrt(DT))
    return torch.from_numpy(np.array(z)), torch.from_numpy(np.array(dw))


def jax_gen(rows, anti=False):
    m = BENCH_MARKET
    return jengine.make_chunk_pathgen(
        m["s0"], m["xi"], m["h"], m["eta"], m["rho"], m["r"], N, DT, rows,
        traced_h=True, antithetic=anti)


def consts(**kw):
    m = BENCH_MARKET
    return ps.make_stream_consts(m["s0"], m["xi"], m["h"], m["eta"], m["r"],
                                 N, DT, "cpu", **kw)


def to_jax_fit(fits):
    return JFit(*(jnp.asarray(f.numpy()) for f in fits))


@pytest.mark.parametrize("anti", [False, True], ids=["plain", "anti"])
def test_traced_market_chunk_matches_jax(anti):
    """A chunk at a fresh market and H, live for 11 of 16 steps, against
    JAX's ``gen_with_params(key, s0, xi, r, eta, n_live, h_=)`` on the
    same draws: ``paths_from_noise`` on ``with_market`` constants (the
    traced build) and the out-of-place ``paths_from_params`` within 2e-5;
    flat past the horizon; at the pricer's own H ``with_market`` keeps
    the host build's matrices."""
    key = jax.random.key(11)
    gen = jax.jit(jax_gen(ROWS, anti).with_params,
                  static_argnames=("n_live",))
    want = np.asarray(gen(key, NEW["s0"], NEW["xi"], NEW["r"], NEW["eta"],
                          n_live=11, h_=H_NEW))
    z, dw = jax_noise(key, ROWS, N, anti)
    c = ps.with_market(consts(traced_h=True), h=H_NEW, **NEW)
    got = ps.paths_from_noise(c, z, dw, anti, n_live=11).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5)
    assert np.all(got[:, 12:] == got[:, 11:12])
    f32 = [torch.tensor(NEW[k]) for k in ("s0", "xi", "r", "eta")]
    again = ps.paths_from_params(c, z, dw, f32, (c.cr, c.ci, c.t_pow), anti,
                                 11).numpy()
    np.testing.assert_allclose(again, got, rtol=1e-6)
    own = consts()
    assert ps.with_market(own, h=BENCH_MARKET["h"]) is own
    moved = ps.with_market(own, h=H_NEW)
    np.testing.assert_allclose(moved.cr.numpy(), c.cr.numpy(), rtol=0,
                               atol=1e-7)


def test_padded_fit_and_policy_match_jax():
    """``lsm_fit(n_steps=)`` and ``lsm_policy_path_values(n_steps_live=)``
    on a block flat past step 11 against JAX's padded scan and policy on
    the same paths and fits: the price at rtol 1e-5, the live steps' mu
    and sd at 1e-5 and coefficients within 1e-4 of each step's scale, the
    policy values at 1e-6; the pad steps never exercise."""
    key = jax.random.key(5)
    z, dw = jax_noise(key, 1024, N)
    c = ps.with_market(consts(), **NEW)
    paths = ps.paths_from_noise(c, z, dw, n_live=11)
    mat = 11 * DT
    jp, jf = jlsm.lsm_fit(jnp.asarray(paths.numpy()), NEW["r"], 101.0, mat,
                          DT, False, 2, n_steps=11)
    tp, tf = tlsm.lsm_fit(paths, NEW["r"], 101.0, mat, DT, False, 2,
                          n_steps=11)
    np.testing.assert_allclose(float(tp), float(jp), rtol=1e-5)
    assert tf.coeffs.shape == (N, 3)
    want_c = np.asarray(jf.coeffs)[:11]
    err = np.abs(tf.coeffs.numpy()[:11] - want_c)
    scale = np.max(np.abs(want_c), axis=1, keepdims=True)
    assert np.all(err <= 1e-4 * (np.abs(want_c) + scale)), err
    for got, want in ((tf.mu, jf.mu), (tf.sd, jf.sd)):
        np.testing.assert_allclose(got.numpy()[:11], np.asarray(want)[:11],
                                   rtol=1e-5)
    want = np.asarray(jengine.lsm_policy_path_values(
        jnp.asarray(paths.numpy()), to_jax_fit(tf), NEW["r"], 101.0, mat,
        DT, False, n_steps_live=11))
    got = tengine.lsm_policy_path_values(paths, tf, NEW["r"], 101.0, mat, DT,
                                         False, n_steps_live=11).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # The padded price equals the exact-shape one on the first 12 columns.
    exact, _ = tlsm.lsm_fit(paths[:, :12], NEW["r"], 101.0, mat, DT, False)
    np.testing.assert_allclose(float(tp), float(exact), rtol=1e-6)


@pytest.mark.parametrize("traced", [False, True], ids=["bucketed", "traced"])
def test_bucketed_at_its_horizon_is_the_stream_chain(traced):
    """At n_live == n_steps and its own market a bucketed pricer (plain
    and traced-market) prices as the non-bucketed generic-stream chain on
    the same seed, within 1e-6; a shorter horizon prices below it (puts
    lose time value)."""
    cfg = tengine.StreamConfig(n_paths=4 * ROWS, n_steps=N, chunk_paths=ROWS,
                               pilot_paths=ROWS, dt=DT, pathgen_impl="xla")
    kw = dict(**BENCH_MARKET, strikes=[95.0, 100.0, 105.0], maturity=N * DT,
              is_call=False, config=cfg, device="cpu")
    ref = tengine.StreamingChainPricer(**kw)
    bucket = tengine.StreamingChainPricer(**kw, bucketed=True,
                                          traced_market=traced)
    want, want_se = ref.price(4, with_stderr=True)
    got, got_se = bucket.price(4, with_stderr=True, n_steps_live=N)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got_se, want_se, rtol=1e-6)
    short = bucket.price(4, n_steps_live=6, maturity=6 * DT)
    assert np.all(short < want + 1e-9)


def jax_chunk_lanes(key, fits, strike, market, n_live=None, anti=False):
    """JAX's ``_greek_jvp_loop`` over one chunk of ``gen.with_params``:
    the [6, ...] GREEK_ORDER sums."""
    gen = jax_gen(ROWS, anti)
    jfit = to_jax_fit(fits)
    strip = np.ndim(strike) == 1
    mat = (n_live or N) * DT

    def chunk_val(params, i):
        s0_, xi_, r_, eta_, h_ = params
        paths = gen.with_params(key, s0_, xi_, r_, eta_, n_live, h_=h_)
        if not strip:
            return jengine.lsm_policy_value(paths, jfit, r_, strike, mat, DT,
                                            False, n_live)[0]
        return jax.vmap(lambda k, f: jengine.lsm_policy_value(
            paths, f, r_, k, mat, DT, False, n_live)[0])(
                jnp.asarray(strike, jnp.float32), jfit)

    tail = (len(strike),) if strip else ()
    loop = jax.jit(lambda m: jengine._greek_jvp_loop(chunk_val, m, 1, tail,
                                                     None)[0])
    return np.asarray(loop(tuple(jnp.float32(v) for v in market)))


@pytest.mark.parametrize("case", ["one", "strip_live_anti"])
def test_jvp_chunk_matches_jax_and_autograd(case):
    """One chunk's jvp Greeks (``jvp_chunk_greeks``) against JAX's
    ``_greek_jvp_loop`` on the same draws, within 1e-4 of each output's
    scale, and against ``torch.autograd.grad`` of the same chunk value
    (H through the float64 build) within 1e-5 relative, vega_h included:
    one strike at the pricer's market, and a 2-strike strip at a fresh
    market and H, live for 11 steps, with antithetic pairs."""
    strip = case != "one"
    n_live, anti = (11, True) if strip else (None, False)
    key = jax.random.key(21)
    c = consts()
    market = (BENCH_MARKET["s0"], BENCH_MARKET["xi"], BENCH_MARKET["r"],
              BENCH_MARKET["eta"], BENCH_MARKET["h"])
    if strip:
        c = ps.with_market(consts(traced_h=True), h=H_NEW, **NEW)
        market = (NEW["s0"], NEW["xi"], NEW["r"], NEW["eta"], H_NEW)
    pilot = ps.paths_from_noise(c, *ps.draw_noise(
        c, 1024, ps.stream_generator("cpu", (3, 9))), n_live=n_live)
    strike = torch.tensor([98.0, 104.0]) if strip else 102.0
    mat = (n_live or N) * DT
    _, fits = tlsm.lsm_fit(pilot, c.r, strike, mat, DT, False,
                           n_steps=n_live)
    z, dw = jax_noise(key, ROWS, N, anti)
    got = tengine.jvp_chunk_greeks(c, z, dw, fits, strike, mat, False, anti,
                                   n_live).numpy()
    want = jax_chunk_lanes(key, fits, strike.tolist() if strip else strike,
                           market, n_live, anti)
    scale = np.max(np.abs(want), axis=tuple(range(1, want.ndim)),
                   keepdims=True)
    assert np.all(np.abs(got - want) <= 1e-4 * scale), (got, want)

    h64 = torch.tensor(market[4], dtype=torch.float64, requires_grad=True)
    prm = [torch.tensor(v, requires_grad=True) for v in market[:4]]
    mats = [m.float() for m in ps._hurst_build(h64, N, DT)]
    paths = ps.paths_from_params(c, z, dw, prm, mats, anti, n_live)
    ks = strike.tolist() if strip else [strike]
    for i, k in enumerate(ks):
        f = tengine.PolyFit(*(x[i] for x in fits)) if strip else fits
        val = tengine.lsm_policy_value(paths, f, prm[2], k, mat, DT, False,
                                       n_live)[0]
        grads = torch.autograd.grad(val, prm + [h64], retain_graph=True)
        s0_, xi_, r_, eta_, h_ = (float(g) for g in grads)
        auto = np.array([float(val.detach()), s0_, xi_, eta_, r_, h_])
        lane = got[:, i] if strip else got
        np.testing.assert_allclose(lane, auto, rtol=1e-5,
                                   atol=1e-5 * np.max(np.abs(auto)))


def test_pricers_jvp_greeks_routes():
    """The jvp route of both pricers: on the "stream" family the price
    lane is ``price`` of the same seed (the same pilot and chunks, within
    1e-5); a traced-market chain's Greeks at a fresh market price as its
    ``price`` there; a plain bucketed pricer has no Greeks."""
    cfg = tengine.StreamConfig(n_paths=2 * ROWS, n_steps=N, chunk_paths=ROWS,
                               pilot_paths=ROWS, dt=DT, pathgen_impl="xla")
    one = tengine.StreamingPricer(**BENCH_MARKET, strike=102.0,
                                  maturity=N * DT, is_call=False, config=cfg,
                                  device="cpu")
    g, se = one.price_and_greeks(7, with_stderr=True)
    np.testing.assert_allclose(g[0], one.price(7), rtol=1e-5)
    assert g[1] < 0 and g[2] > 0 and all(np.isfinite(se))
    kw = dict(**BENCH_MARKET, strikes=[98.0, 104.0], maturity=N * DT,
              is_call=False, config=cfg, device="cpu", bucketed=True)
    served = tengine.StreamingChainPricer(**kw, traced_market=True)
    call = dict(n_steps_live=11, maturity=11 * DT, hurst=H_NEW,
                market=dict(NEW))
    vals = served.price_and_greeks(7, **call)
    np.testing.assert_allclose(vals[0], served.price(7, **call), rtol=1e-5)
    assert vals.shape == (6, 2) and np.all(vals[1] < 0)
    with pytest.raises(ValueError, match="plain-bucketed"):
        tengine.StreamingChainPricer(**kw).price_and_greeks(
            7, n_steps_live=11)


def inject(monkeypatch, planes):
    """The port's ``rng.normal`` returning ``planes`` in order."""
    it = iter(planes)
    monkeypatch.setattr(trng, "normal",
                        lambda gen, shape: torch.from_numpy(next(it)))


def test_lsm_greeks_match_jax(monkeypatch):
    """``lsm_greeks`` (reverse mode through ``generate_paths`` and
    ``lsm_price``, the regressions included) against JAX's on JAX's draws
    (the variance driver's pair, then the price Brownian): price at 1e-5,
    delta, vega_xi and rho at 1e-4 of the largest."""
    key = jax.random.key(2)
    n_steps, n_paths = 4, 512
    k_var, k_euler = jax.random.split(key)
    k1, k2 = jax.random.split(k_var)
    draws = [np.array(jax.random.normal(k, (n_paths, n_steps), jnp.float32))
             for k in (k1, k2, k_euler)]
    m = BENCH_MARKET
    args = (m["s0"], m["xi"], m["h"], m["eta"], m["rho"], m["r"], 102.0,
            n_steps * DT, n_steps, n_paths)
    want = jgreeks.lsm_greeks(key, *args)
    inject(monkeypatch, draws)
    got = tgreeks.lsm_greeks(torch.Generator(), *args)
    np.testing.assert_allclose(got.price, want.price, rtol=1e-5)
    g = np.array([got.delta, got.vega_xi, got.rho_rate])
    w = np.array([want.delta, want.vega_xi, want.rho_rate])
    assert np.all(np.abs(g - w) <= 1e-4 * np.max(np.abs(w))), (g, w)


def test_european_greeks_match_jax_and_black_scholes(monkeypatch):
    """``european_greeks`` against JAX's on the same normals (1e-5), and
    seeded against Black-Scholes within 4 sigma-ish bands; an explicit dt
    off the maturity raises as in JAX."""
    key = jax.random.key(8)
    z = np.array(jax.random.normal(key, (4096, 10), jnp.float32))
    args = (100.0, 0.2, 0.03, 100.0, 1.0, 10, 4096)
    want = jgreeks.european_greeks(key, *args)
    inject(monkeypatch, [z])
    got = tgreeks.european_greeks(torch.Generator(), *args)
    for name in ("price", "delta", "vega_xi", "rho_rate"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=1e-5)
    monkeypatch.undo()
    seeded = tgreeks.european_greeks(torch.Generator().manual_seed(3),
                                     100.0, 0.2, 0.03, 100.0, 1.0, 10,
                                     200_000)
    bs = closed_form.black_scholes(100.0, 100.0, 0.03, 0.2, 1.0, True)
    d1 = (math.log(1.0) + (0.03 + 0.02) * 1.0) / 0.2
    nd1 = 0.5 * (1.0 + math.erf(d1 / math.sqrt(2.0)))
    vega = 100.0 * math.exp(-0.5 * d1 * d1) / math.sqrt(2.0 * math.pi)
    assert abs(seeded.price - bs) < 0.1
    assert abs(seeded.delta - nd1) < 0.01
    assert abs(seeded.vega_xi - vega) < 1.0
    with pytest.raises(ValueError, match="diffuses exactly"):
        tgreeks.european_greeks(torch.Generator(), *args[:6], 4096, dt=0.01)
