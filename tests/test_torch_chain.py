"""The port's strike chain against the JAX package: the plain version of
the chain kernel K5 (``chain_cuda.priced_chain`` on CPU tensors) against
JAX's chain kernel in interpret mode on the same numpy noise, the
strike-batched LSM fit against ``jax.vmap`` of JAX's, the strip's tables
and time-0 values, ``StreamingChainPricer`` on shared noise and in
distribution, its rejections, and the Black-Scholes copy.  K5 itself is
held against its plain version on the card in test_torch_gpu.py."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from montecarlooptionspricer_tpu.models import closed_form as jcf
from montecarlooptionspricer_tpu.models import engine as jengine
from montecarlooptionspricer_tpu.models import pathgen_pallas as jpp
from montecarlooptionspricer_tpu.models.lsm import lsm_fit as jlsm_fit
from montecarlooptionspricer_tpu_torch.models import chain_cuda as cc
from montecarlooptionspricer_tpu_torch.models import closed_form as tcf
from montecarlooptionspricer_tpu_torch.models import engine as tengine
from montecarlooptionspricer_tpu_torch.models import lsm as tlsm
from montecarlooptionspricer_tpu_torch.models import pathgen_cuda as pc
from montecarlooptionspricer_tpu_torch.ops.regression import (
    polyfit_from_numpy)

from test_torch_pathgen import (DT, KW, jax_pilot_fits, port_noise,
                                shared_noise)

N_STEPS, ROWS = 48, 256
MATURITY = N_STEPS * DT
STRIP3 = [94.0, 99.0, 104.0]
STRIP13 = [float(k) for k in np.linspace(88.0, 112.0, 13)]
STRIP40 = [float(k) for k in np.linspace(84.0, 116.0, 40)]
BENCH_MARKET = dict(s0=100.0, xi=0.04, h=0.1, eta=1.5, rho=-0.4, r=0.04)


def jax_strip_fits(paths, strikes, is_call, n_steps=N_STEPS):
    """``jax.vmap`` of JAX's lsm_fit over the strip (its chain pricer's
    fit) and the strip's S-space boundary tables."""
    mat = n_steps * DT

    def one(k):
        _, fits = jlsm_fit(paths, KW["r"], k, mat, DT, is_call, 2)
        return fits

    ks = jnp.asarray(strikes, jnp.float32)
    fits = jax.vmap(one)(ks)
    tables = jax.vmap(lambda f, k: jpp.boundary_rows(
        f, KW["r"], k, mat, DT, n_steps, is_call))(fits, ks)
    return fits, tables


def to_port_strip_fits(fits):
    return polyfit_from_numpy(np.asarray(fits.coeffs), np.asarray(fits.mu),
                              np.asarray(fits.sd), "cpu")


def consts_cpu(n_steps=N_STEPS):
    return pc.make_path_consts(KW["s0"], KW["xi"], KW["h"], KW["eta"],
                               KW["r"], n_steps, DT, "cpu")


@pytest.mark.parametrize("is_call,strikes", [(False, STRIP3),
                                             (False, STRIP13),
                                             (True, STRIP3),
                                             (True, STRIP13)])
def test_priced_chain_ref_matches_jax(rng, is_call, strikes):
    """Plain K5 against JAX's boundary-form chain kernel on the same noise
    and tables, 3 strikes (one group) and 13 (JAX's two regenerated
    groups): rtol 2e-4 on each strike's sum, atol 1e-3 of the largest
    (the paths' float32 sums run in another order, so a decision can flip
    inside the float32 root band)."""
    paths, _ = jax_pilot_fits(shared_noise(rng, 512, N_STEPS), 100.0,
                              MATURITY, is_call, n_steps=N_STEPS)
    _, jtab = jax_strip_fits(paths, strikes, is_call)
    chain, _ = jpp.make_pallas_priced_chain(
        **KW, strikes=strikes, maturity=MATURITY, dt=DT, n_steps=N_STEPS,
        chunk_paths=ROWS, block_paths=128, is_call=is_call, interpret=True,
        noise_input=True, fgn_form="chol", policy_form="boundary")
    noise = shared_noise(rng, ROWS, N_STEPS)
    want = np.asarray(chain(jnp.asarray(noise), jtab))
    got = cc.priced_chain(consts_cpu(), torch.tensor(np.asarray(jtab)),
                          is_call, noise=port_noise(noise, N_STEPS))
    assert got.shape == (len(strikes),) and want.max() > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4,
                               atol=1e-3 * want.max())


@pytest.mark.parametrize("is_call,strikes", [(False, STRIP3),
                                             (False, STRIP40),
                                             (True, STRIP13)])
def test_priced_chain_pair_ref_matches_jax(rng, is_call, strikes):
    """Plain K5/anti against JAX's boundary-form chain kernel with
    antithetic=True in interpret mode, on the same half-row noise and
    tables: rtol 1e-4 on each strike's sum, atol 1e-3 of the largest (a
    deep out-of-the-money sum is ~0).  40 strikes are JAX's four
    regenerated groups and the card's two, each pairing the same rows.
    The paired plain version against the unpaired one on [X; -X]: within
    1e-5."""
    paths, _ = jax_pilot_fits(shared_noise(rng, 512, N_STEPS), 100.0,
                              MATURITY, is_call, n_steps=N_STEPS)
    _, jtab = jax_strip_fits(paths, strikes, is_call)
    chain, _ = jpp.make_pallas_priced_chain(
        **KW, strikes=strikes, maturity=MATURITY, dt=DT, n_steps=N_STEPS,
        chunk_paths=ROWS, block_paths=128, is_call=is_call, interpret=True,
        noise_input=True, fgn_form="chol", policy_form="boundary",
        antithetic=True)
    noise = shared_noise(rng, ROWS // 2, N_STEPS)
    want = np.asarray(chain(jnp.asarray(noise), jtab))
    tables = torch.tensor(np.asarray(jtab))
    half = port_noise(noise, N_STEPS)
    got = cc.priced_chain(consts_cpu(), tables, is_call, noise=half,
                          antithetic=True)
    assert got.shape == (len(strikes),) and want.max() > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-3 * want.max())
    unpaired = cc.priced_chain(consts_cpu(), tables, is_call,
                               noise=torch.cat([half, -half], dim=1))
    np.testing.assert_allclose(got.numpy(), unpaired.numpy(), rtol=1e-5,
                               atol=1e-5 * want.max())
    # The seeded entry draws rows / 2 rows of K2's stream.
    key = pc._fold_words(9, 4)
    seeded = cc.priced_chain(consts_cpu(), tables, is_call, rows=ROWS,
                             key=key, antithetic=True)
    torch.testing.assert_close(seeded, cc.priced_chain_from_noise_ref(
        consts_cpu(), tables, pc.philox_normals_ref(key, ROWS // 2, N_STEPS),
        is_call, antithetic=True), rtol=0, atol=0)


@pytest.mark.parametrize("is_call", [False, True])
def test_strip_fit_matches_jax_vmap_and_single_fits(rng, is_call):
    """The strike-batched lsm_fit against jax.vmap of JAX's lsm_fit on one
    pilot (the tolerance scheme of test_torch_lsm: rtol 1e-4 of each
    step's largest coefficient where >= 8 paths are in the money, fitted
    values where fewer, dead fits exact; mu and sd rtol 1e-5), and against
    K separate port fits (the same float32 arithmetic per strike: rtol
    1e-6).  The strip spans steps with no path in the money."""
    strikes = [80.0, 97.0, 100.0, 103.0, 120.0]
    paths, _ = jax_pilot_fits(shared_noise(rng, 512, N_STEPS), 100.0,
                              MATURITY, is_call, n_steps=N_STEPS)
    jfits, _ = jax_strip_fits(paths, strikes, is_call)
    tpaths = torch.from_numpy(np.asarray(paths))
    price, tfits = tlsm.lsm_fit(tpaths, KW["r"], torch.tensor(strikes),
                                MATURITY, DT, is_call, 2)
    assert price.shape == (5,) and tfits.coeffs.shape == (5, N_STEPS, 3)
    p = np.asarray(paths)
    dead = 0
    for k, strike in enumerate(strikes):
        want_c = np.asarray(jfits.coeffs)[k]
        got_c = tfits.coeffs[k].numpy()
        pay = np.maximum(p - strike, 0) if is_call else np.maximum(
            strike - p, 0)
        n_itm = (pay[:, :-1] > 1e-14).sum(axis=0)
        for j, m in enumerate(n_itm):
            if m == 0:
                dead += 1
                np.testing.assert_array_equal(got_c[j], want_c[j])
            elif m < 8:
                x = p[pay[:, j] > 1e-14, j]
                z = (x - np.asarray(jfits.mu)[k, j]) / np.asarray(
                    jfits.sd)[k, j]
                fv = lambda c: (c[2] * z + c[1]) * z + c[0]
                np.testing.assert_allclose(fv(got_c[j]), fv(want_c[j]),
                                           rtol=1e-4, atol=1e-4)
            else:
                scale = np.max(np.abs(want_c[j]))
                assert np.all(np.abs(got_c[j] - want_c[j])
                              <= 1e-4 * (np.abs(want_c[j]) + scale)), (k, j)
        np.testing.assert_allclose(tfits.mu[k].numpy(),
                                   np.asarray(jfits.mu)[k], rtol=1e-5)
        np.testing.assert_allclose(tfits.sd[k].numpy(),
                                   np.asarray(jfits.sd)[k], rtol=1e-5)
        one_price, one = tlsm.lsm_fit(tpaths, KW["r"], strike, MATURITY, DT,
                                      is_call, 2)
        for got, want in zip(tfits, one):
            np.testing.assert_allclose(got[k].numpy(), want.numpy(),
                                       rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(float(price[k]), float(one_price),
                                   rtol=1e-6)
    assert dead > 0


class _OpCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.count += 1
        return func(*args, **(kwargs or {}))


def test_strip_fit_ops_do_not_grow_with_strikes(rng):
    """The strip's fit is one backward pass: it dispatches the same tensor
    operations (kernel launches on the card) for 2 or 21 strikes, and no
    more than for one strike, so the launches per LSM step do not grow
    with K."""
    paths = torch.exp(torch.cumsum(torch.from_numpy(
        rng.normal(0.0, 0.01, size=(256, 33)).astype(np.float32)), 1)
        + math.log(100.0))

    def ops(strike):
        with _OpCounter() as counter:
            tlsm.lsm_fit(paths, 0.04, strike, 32 * DT, DT, False, 2)
        return counter.count

    strip = ops(torch.tensor([99.0, 101.0]))
    assert strip <= ops(100.0)
    assert ops(torch.linspace(75.0, 125.0, 21)) == strip


@pytest.mark.parametrize("is_call", [False, True])
def test_strip_tables_and_time0_match_jax(rng, is_call):
    """[K, 8, s_pad] tables from one batched call against jax.vmap of JAX's
    boundary_rows on the same converted fits (sentinels exact, finite
    entries rtol 1e-5), and the per-strike time-0 values against JAX's
    per strike.  The strike-1000 put exercises at time 0 (a call without
    dividends never does early)."""
    strikes = [90.0, 100.0, 110.0, 1.0 if is_call else 1000.0]
    paths, _ = jax_pilot_fits(shared_noise(rng, 512, N_STEPS), 100.0,
                              MATURITY, is_call, n_steps=N_STEPS)
    jfits, jtab = jax_strip_fits(paths, strikes, is_call)
    tfits = to_port_strip_fits(jfits)
    strip = torch.tensor(strikes)
    ttab = pc.boundary_rows(tfits, KW["r"], strip, MATURITY, DT, N_STEPS,
                            is_call).numpy()
    want = np.asarray(jtab)
    assert ttab.shape == want.shape == (4, 8, 128)
    sentinel = np.abs(want) >= 1e30
    np.testing.assert_array_equal(ttab[sentinel], want[sentinel])
    np.testing.assert_allclose(ttab[~sentinel], want[~sentinel], rtol=1e-5,
                               atol=1e-6)
    ex0, p0 = pc.time0_value(tfits, KW["s0"], strip, is_call)
    for k, strike in enumerate(strikes):
        fit_k = jax.tree.map(lambda a: a[k], jfits)
        jex0, jp0 = jpp.time0_value(fit_k, KW["s0"], strike, is_call)
        assert bool(ex0[k]) == bool(jex0)
        assert float(p0[k]) == pytest.approx(jp0, rel=1e-7)
    assert bool(ex0[-1]) != is_call


def test_chain_on_shared_noise_matches_jax(rng):
    """StreamingChainPricer.price_with_fit on shared chunk noise, under
    JAX's strip fits converted with polyfit_from_numpy, against JAX's
    chain kernel on the same noise and tables: rtol 1e-4 per strike
    (float32 order; decisions flip only inside the root band)."""
    chunk, n_chunks, strikes = 256, 3, STRIP3
    paths, _ = jax_pilot_fits(shared_noise(rng, 512, N_STEPS), 100.0,
                              MATURITY, False, n_steps=N_STEPS)
    jfits, jtab = jax_strip_fits(paths, strikes, False)
    chunks = [shared_noise(rng, chunk, N_STEPS) for _ in range(n_chunks)]
    chain, _ = jpp.make_pallas_priced_chain(
        **KW, strikes=strikes, maturity=MATURITY, dt=DT, n_steps=N_STEPS,
        chunk_paths=chunk, block_paths=128, is_call=False, interpret=True,
        noise_input=True, fgn_form="chol", policy_form="boundary")
    want = sum(np.asarray(chain(jnp.asarray(c), jtab), np.float64)
               for c in chunks) / (n_chunks * chunk)

    cfg = tengine.StreamConfig(n_paths=n_chunks * chunk, n_steps=N_STEPS,
                               chunk_paths=chunk, pilot_paths=512, dt=DT,
                               chunks_per_call=2)
    pricer = tengine.StreamingChainPricer(
        **KW, strikes=strikes, maturity=MATURITY, is_call=False, config=cfg,
        device="cpu")
    noise = torch.stack([port_noise(c, N_STEPS) for c in chunks])
    got, se = pricer.price_with_fit(to_port_strip_fits(jfits), noise=noise,
                                    with_stderr=True)
    assert got.shape == se.shape == (3,)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert np.all(np.isfinite(se)) and np.all(se > 0)


def test_seeded_chain_in_distribution_matches_jax():
    """The port's seeded strip against the JAX StreamingChainPricer (XLA
    generator, another random stream): each strike within 5 combined
    stderr."""
    n_steps, chunk, n_chunks, pilot = 32, 2048, 8, 4096
    strikes, maturity = [95.0, 100.0, 105.0], 32 * DT
    cfg = tengine.StreamConfig(n_paths=n_chunks * chunk, n_steps=n_steps,
                               chunk_paths=chunk, pilot_paths=pilot, dt=DT)
    got, se_t = tengine.StreamingChainPricer(
        **BENCH_MARKET, strikes=strikes, maturity=maturity, is_call=False,
        config=cfg, device="cpu").price(0, with_stderr=True)
    jcfg = jengine.StreamConfig(n_paths=n_chunks * chunk, n_steps=n_steps,
                                chunk_paths=chunk, pilot_paths=pilot, dt=DT,
                                pathgen_impl="xla")
    want, se_j = jengine.StreamingChainPricer(
        **BENCH_MARKET, strikes=strikes, maturity=maturity, is_call=False,
        config=jcfg).price(jax.random.key(0), with_stderr=True)
    assert np.all(0 < se_t) and np.all(se_t < 0.05 * got)
    assert np.all(np.abs(got - want) < 5 * np.hypot(se_t, se_j)), (got, want)


def test_strip_of_one_matches_single_strike_pricer():
    """A one-strike strip and StreamingPricer on the same seed fit on the
    same pilot and stream the same paths: the chain decides in S space
    (K5's table), the single pricer in log space (K2's), and these differ
    only in the float32 root band, so the prices agree to rtol 1e-4."""
    cfg = tengine.StreamConfig(n_paths=4 * 512, n_steps=N_STEPS,
                               chunk_paths=512, pilot_paths=1024, dt=DT)
    chain = tengine.StreamingChainPricer(
        **BENCH_MARKET, strikes=[103.0], maturity=MATURITY, is_call=False,
        config=cfg, device="cpu")
    one = tengine.StreamingPricer(
        **BENCH_MARKET, strike=103.0, maturity=MATURITY, is_call=False,
        config=cfg, device="cpu")
    got = chain.price(5)
    want = one.price(5)
    np.testing.assert_allclose(got[0], want, rtol=1e-4)
    # A fresh strip of the same length reprices without a rebuild.
    again = chain.price(5, strikes=[103.0])
    np.testing.assert_array_equal(again, got)
    with pytest.raises(ValueError, match="strip length"):
        chain.price(5, strikes=[100.0, 103.0])


@pytest.mark.parametrize("kwargs,exc,match", [
    (dict(bucketed=True), None, None),
    (dict(traced_market=True), ValueError, "require bucketed=True"),
    (dict(config=dict(qmc_fgn=True)), ValueError, "qmc_fgn requires qmc"),
    (dict(config=dict(control_variate=True)), ValueError, "control_variate"),
])
def test_chain_unported_options_raise(kwargs, exc, match):
    """The options the chain refuses, as JAX's does: ``qmc_fgn`` without
    ``qmc``, ``control_variate``, and ``traced_market`` without
    ``bucketed`` (JAX's ValueError).  ``bucketed`` (refused naming ROADMAP
    A13 before the serving pricers were ported) builds on the generic
    stream and prices any live horizon of its bucket, the 32-step quote
    above the 20-step one."""
    cfg = dict(n_paths=1024, n_steps=32, chunk_paths=256, pilot_paths=256)
    cfg.update(kwargs.pop("config", {}))

    def build():
        return tengine.StreamingChainPricer(
            **BENCH_MARKET, strikes=[95.0, 100.0], maturity=32 * DT,
            is_call=False, config=tengine.StreamConfig(**cfg), device="cpu",
            **kwargs)
    if exc is not None:
        with pytest.raises(exc, match=match):
            build()
        return
    chain = build()
    assert chain.kernel_family == "stream"
    full = chain.price(1, n_steps_live=32)
    short = chain.price(1, n_steps_live=20, maturity=20 * DT)
    assert np.all(np.isfinite(full)) and 0 < full[0] < full[1]
    assert np.all(short < full)


def test_antithetic_strip_streams_k5_pairs():
    """An antithetic strip (refused before K5 had a pair form) streams
    K5/anti: the seeded price equals the mean of the paired plain
    version's sums over the chunks' keys under the same fits, to 1e-6,
    and its stderr lies below the plain strip's on the same seed."""
    cfg = dict(n_paths=4 * 512, n_steps=32, chunk_paths=512,
               pilot_paths=1024, dt=DT)
    strikes, maturity = [97.0, 103.0], 32 * DT
    chain = tengine.StreamingChainPricer(
        **BENCH_MARKET, strikes=strikes, maturity=maturity, is_call=False,
        config=tengine.StreamConfig(**cfg, antithetic=True), device="cpu")
    assert chain.kernel_family == "single"
    fits = chain.fit(tengine._pilot_stream_keys(2)[0])
    got, se = chain.price_with_fit(fits, 2, with_stderr=True)
    _, (run, start) = tengine._pilot_stream_keys(2)
    tables = chain._tables(fits, chain.strikes)
    want = sum(cc.priced_chain_from_noise_ref(
        chain.consts, tables, pc.philox_normals_ref(
            pc._fold_words(run, start + i), 256, 32), False, True).double()
        for i in range(4)) / 2048
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-6)
    plain = tengine.StreamingChainPricer(
        **BENCH_MARKET, strikes=strikes, maturity=maturity, is_call=False,
        config=tengine.StreamConfig(**cfg), device="cpu")
    _, se_plain = plain.price_with_fit(fits, 2, with_stderr=True)
    assert np.all(se < se_plain)


def test_strip_past_k5_takes_the_stream():
    """A 600-step strip, past K5's 512 steps (refused before the generic
    stream was ported), prices on the stream with a positive stderr per
    strike; at 512 steps the strip stays on K5 with the K6 pilot."""
    def chain(n_steps):
        return tengine.StreamingChainPricer(
            **BENCH_MARKET, strikes=[95.0, 100.0], maturity=n_steps * DT,
            is_call=False, config=tengine.StreamConfig(
                n_paths=2 * 256, n_steps=n_steps, chunk_paths=256,
                pilot_paths=256, dt=DT), device="cpu")

    assert chain(512).kernel_family == "tiled"
    past = chain(600)
    assert past.kernel_family == "stream"
    prices, stderrs = past.price(0, with_stderr=True)
    assert np.all(prices > 0) and np.all(stderrs > 0)


@pytest.mark.parametrize("is_call", [False, True])
def test_black_scholes_and_implied_vol_match_jax(is_call):
    """The port's float64 copies against the JAX package's on a grid:
    equal to 1e-12 (the same host arithmetic), NaN where JAX's is NaN."""
    for s0 in (80.0, 100.0, 125.0):
        for strike in (75.0, 100.0, 130.0):
            for maturity in (0.0, 0.1, 1.448):
                for sigma in (0.0, 0.05, 0.3, 1.2):
                    want = jcf.black_scholes(s0, strike, 0.04, sigma,
                                             maturity, is_call)
                    got = tcf.black_scholes(s0, strike, 0.04, sigma,
                                            maturity, is_call)
                    assert abs(got - want) <= 1e-12 * max(1.0, abs(want))
                if maturity == 0.0:
                    continue
                for price in (0.5, 3.0, 12.0, 30.0, 60.0):
                    want = jcf.implied_vol(price, s0, strike, 0.04, maturity,
                                           is_call)
                    got = tcf.implied_vol(price, s0, strike, 0.04, maturity,
                                          is_call)
                    assert (math.isnan(got) and math.isnan(want)) or \
                        abs(got - want) <= 1e-12, (s0, strike, price)
    assert tcf.norm_cdf(0.3) == jcf.norm_cdf(0.3)
