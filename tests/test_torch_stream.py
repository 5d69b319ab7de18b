"""The port's generic path stream (``models/pathgen_stream.py``) against
the JAX package's XLA generator ``engine.make_chunk_pathgen``: its
noise-in entry elementwise on JAX's own draws, in both syntheses, plain
and paired; its seeded torch stream in distribution; and the engine on the
stream (``poly_order`` 3, strips past K5, the control variate,
``pathgen_impl="xla"``) against JAX's XLA ``StreamingPricer`` and
``StreamingChainPricer``.  The stream is plain PyTorch on every device,
so nothing here needs the card."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlooptionspricer_tpu.models import engine as jengine
from montecarlooptionspricer_tpu.models.lsm import lsm_fit as jlsm_fit
from montecarlooptionspricer_tpu_torch.models import engine as tengine
from montecarlooptionspricer_tpu_torch.models import pathgen_stream as ps
from montecarlooptionspricer_tpu_torch.ops.regression import (
    polyfit_from_numpy)

from test_torch_pathgen import DT, KW
from test_torch_tiled import BENCH_MARKET


def jax_noise(key, drawn, n_steps):
    """The planes ``make_chunk_pathgen``'s generator draws from ``key``
    (its own schedule: kz, kw = split(key); z or zf [2, drawn, n] from
    kz, dw [drawn, n] from kw times sqrt(dt)), as numpy."""
    kz, kw = jax.random.split(key)
    z = jax.random.normal(kz, (2, drawn, n_steps), jnp.float32)
    dw = jax.random.normal(kw, (drawn, n_steps), jnp.float32) * math.sqrt(DT)
    return np.asarray(z), np.asarray(dw)


def stream_consts(n_steps, fgn_impl="matmul", market=KW):
    return ps.make_stream_consts(market["s0"], market["xi"], market["h"],
                                 market["eta"], market["r"], n_steps, DT,
                                 "cpu", fgn_impl=fgn_impl)


@pytest.mark.parametrize("n_steps", [96, 600])
@pytest.mark.parametrize("fgn_impl", ["matmul", "fft"])
@pytest.mark.parametrize("antithetic", [False, True], ids=["plain", "anti"])
def test_noise_in_matches_jax_generator(fgn_impl, antithetic, n_steps):
    """``paths_from_noise`` on the planes JAX draws against
    ``make_chunk_pathgen(fgn_impl=, antithetic=)`` on the same key:
    elementwise within 1e-4 relative on prices (the syntheses sum in
    another float32 order; at 600 steps the drift of the compensator and
    the cumulative sum add a few ulp a step)."""
    rows = 128
    key = jax.random.key(11)
    gen = jengine.make_chunk_pathgen(**KW, n_steps=n_steps, dt=DT,
                                     chunk_paths=rows, fgn_impl=fgn_impl,
                                     antithetic=antithetic)
    want = np.asarray(gen(key))
    z, dw = jax_noise(key, rows // 2 if antithetic else rows, n_steps)
    got = ps.paths_from_noise(stream_consts(n_steps, fgn_impl),
                              torch.tensor(z), torch.tensor(dw), antithetic)
    assert got.shape == want.shape == (rows, n_steps + 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4)


def test_unit_eta_matrices_and_spectrum_match_jax():
    """The stream's constants are the JAX generator's: the unit-eta
    spectral matrices from the same float64 code (1e-12 before JAX's
    float32 cast), and the FFT synthesis equals the matmul one on the same
    normals (2e-6 of the plane's largest entry)."""
    n = 200
    cr, ci = ps._unit_eta_matrices(n, KW["h"], DT)
    jcr, jci = jengine._fgn_matrices_np(n, KW["h"], 1.0, DT)
    np.testing.assert_allclose(cr, jcr, rtol=0, atol=1e-12)
    np.testing.assert_allclose(ci, jci, rtol=0, atol=1e-12)
    z = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, 64, n)).astype(np.float32))
    a = ps.fgn_plane(stream_consts(n, "matmul"), z)
    b = ps.fgn_plane(stream_consts(n, "fft"), z)
    assert float((a - b).abs().max()) <= 2e-6 * float(a.abs().max())


def test_seeded_stream_pairs_and_moments():
    """The seeded entry: ``chunk_paths`` is ``paths_from_noise`` on the
    carrier's generator draws (bitwise); a paired chunk's partner rows are
    the paths of the negated planes; distinct carriers draw distinct
    noise; and in distribution, at every checked step, the fGN plane has
    mean 0 and the variance of the spectral map (sum over k of Cr^2 +
    Ci^2), and the discounted price has mean s0, each within 5 stderr."""
    n, rows = 64, 4096
    consts = stream_consts(n)
    carrier = (12345, 7)
    z, dw = ps.draw_noise(consts, rows // 2,
                          ps.stream_generator("cpu", carrier))
    paired = ps.chunk_paths(consts, rows, carrier, antithetic=True)
    torch.testing.assert_close(
        paired, ps.paths_from_noise(consts, z, dw, antithetic=True),
        rtol=0, atol=0)
    torch.testing.assert_close(
        paired[rows // 2:], ps.paths_from_noise(consts, -z, -dw),
        rtol=1e-6, atol=0)
    torch.testing.assert_close(ps.fgn_plane(consts, -z),
                               -ps.fgn_plane(consts, z), rtol=0, atol=0)
    other = ps.draw_noise(consts, 8, ps.stream_generator("cpu", (12345, 8)))
    assert not torch.equal(other[0], z[:, :8])

    plain = ps.chunk_paths(consts, rows, (99, 1))
    t = torch.arange(n + 1, dtype=torch.float64) * DT
    disc = (plain.double() * torch.exp(-KW["r"] * t)).numpy()
    x = ps.fgn_plane(consts, ps.draw_noise(
        consts, rows, ps.stream_generator("cpu", (99, 2)))[0]).double()
    var = (consts.cr.double() ** 2 + consts.ci.double() ** 2).sum(dim=0)
    for col in (1, n // 2, n):
        d = disc[:, col]
        assert abs(d.mean() - KW["s0"]) < 5 * d.std() / math.sqrt(rows)
        xc, vc = x[:, col - 1], float(var[col - 1])
        assert abs(float(xc.mean())) < 5 * math.sqrt(vc / rows)
        assert abs(float(xc.var()) / vc - 1.0) < 5 * math.sqrt(2.0 / rows)
    # Partners are anticorrelated: the pair mean has under half the
    # variance of one path's.
    pair = 0.5 * (paired[: rows // 2, -1] + paired[rows // 2:, -1])
    assert float(pair.var()) < 0.5 * float(paired[:, -1].var())


def _jax_price(pricer_cls, seed, **kw):
    return pricer_cls(**kw).price(jax.random.key(seed), with_stderr=True)


def test_poly3_on_the_stream_matches_jax():
    """poly_order=3 takes the generic stream: the port's seeded price
    against JAX's XLA StreamingPricer at poly_order 3 (another random
    stream) within 5 combined stderr; and under one JAX fit carried with
    ``polyfit_from_numpy``, the port's policy values on JAX's own stream
    paths equal JAX's to 1e-5."""
    n_steps, chunk, n_chunks, pilot = 32, 2048, 8, 4096
    strike, maturity = 105.0, n_steps * DT
    cfg = tengine.StreamConfig(n_paths=n_chunks * chunk, n_steps=n_steps,
                               chunk_paths=chunk, pilot_paths=pilot, dt=DT,
                               poly_order=3)
    assert tengine.resolve_kernel_family(32, poly_order=3) == "stream"
    pricer = tengine.StreamingPricer(**BENCH_MARKET, strike=strike,
                                     maturity=maturity, is_call=False,
                                     config=cfg, device="cpu")
    assert pricer.kernel_family == "stream"
    got, se_t = pricer.price(0, with_stderr=True)
    jcfg = jengine.StreamConfig(n_paths=n_chunks * chunk, n_steps=n_steps,
                                chunk_paths=chunk, pilot_paths=pilot, dt=DT,
                                pathgen_impl="xla", poly_order=3)
    want, se_j = _jax_price(jengine.StreamingPricer, 0, **BENCH_MARKET,
                            strike=strike, maturity=maturity, is_call=False,
                            config=jcfg)
    assert 0 < se_t < 0.05 * got
    assert abs(got - want) < 5 * np.hypot(se_t, se_j), (got, want)

    gen = jengine.make_chunk_pathgen(**BENCH_MARKET, n_steps=n_steps, dt=DT,
                                     chunk_paths=chunk)
    paths = gen(jax.random.key(5))
    _, jfits = jlsm_fit(paths, BENCH_MARKET["r"], strike, maturity, DT,
                        False, 3)
    fits = polyfit_from_numpy(np.asarray(jfits.coeffs), np.asarray(jfits.mu),
                              np.asarray(jfits.sd), "cpu")
    test = gen(jax.random.key(6))
    want_v = np.asarray(jengine.lsm_policy_path_values(
        test, jfits, BENCH_MARKET["r"], strike, maturity, DT, False))
    got_v = tengine.lsm_policy_path_values(
        torch.from_numpy(np.asarray(test)), fits, BENCH_MARKET["r"], strike,
        maturity, DT, False)
    np.testing.assert_allclose(got_v.numpy(), want_v, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("antithetic", [False, True], ids=["plain", "anti"])
def test_strip_past_k5_on_the_stream_matches_jax(antithetic):
    """A 600-step strip, past K5's 512 steps, prices on the generic stream
    (pilot, one batched fit, each strike's policy value per chunk, plain
    or paired) within 5 combined stderr of JAX's XLA chain pricer."""
    n_steps, chunk, n_chunks, pilot = 600, 256, 6, 1024
    strikes, maturity = [95.0, 105.0], n_steps * DT
    cfg = tengine.StreamConfig(n_paths=n_chunks * chunk, n_steps=n_steps,
                               chunk_paths=chunk, pilot_paths=pilot, dt=DT,
                               antithetic=antithetic)
    chain = tengine.StreamingChainPricer(
        **BENCH_MARKET, strikes=strikes, maturity=maturity, is_call=False,
        config=cfg, device="cpu")
    assert chain.kernel_family == "stream"
    got, se_t = chain.price(1, with_stderr=True)
    jcfg = jengine.StreamConfig(n_paths=n_chunks * chunk, n_steps=n_steps,
                                chunk_paths=chunk, pilot_paths=pilot, dt=DT,
                                pathgen_impl="xla", antithetic=antithetic)
    want, se_j = _jax_price(jengine.StreamingChainPricer, 1, **BENCH_MARKET,
                            strikes=strikes, maturity=maturity,
                            is_call=False, config=jcfg)
    assert np.all(0 < se_t) and np.all(se_t < 0.1 * got)
    assert np.all(np.abs(got - want) < 5 * np.hypot(se_t, se_j)), (got, want)


def test_control_variate_on_the_stream_matches_jax():
    """pathgen_impl="xla" with the control variate: the pilot's beta and
    centre, and each chunk's policy values beside their martingale
    controls, within 5 combined stderr of JAX's XLA CV pricer, and a
    smaller stderr than the plain stream's on the same seed."""
    n_steps, chunk, n_chunks, pilot = 32, 2048, 8, 4096
    strike, maturity = 105.0, n_steps * DT
    kw = dict(n_paths=n_chunks * chunk, n_steps=n_steps, chunk_paths=chunk,
              pilot_paths=pilot, dt=DT, pathgen_impl="xla")
    market = dict(**BENCH_MARKET, strike=strike, maturity=maturity,
                  is_call=False)
    got, se_t = tengine.StreamingPricer(
        **market, config=tengine.StreamConfig(**kw, control_variate=True),
        device="cpu").price(2, with_stderr=True)
    _, se_plain = tengine.StreamingPricer(
        **market, config=tengine.StreamConfig(**kw),
        device="cpu").price(2, with_stderr=True)
    want, se_j = _jax_price(
        jengine.StreamingPricer, 2, **market,
        config=jengine.StreamConfig(**kw, control_variate=True))
    assert 0 < se_t < se_plain
    assert abs(got - want) < 5 * np.hypot(se_t, se_j), (got, want)


def test_chain_strike_equals_single_strike_on_the_stream():
    """A strike of a strip and a single-strike pricer with the same seed
    on the stream fit on the same pilot and price the same paths: equal to
    rtol 1e-6 (the batched fit's arithmetic per strike is the single
    fit's)."""
    cfg = tengine.StreamConfig(n_paths=4 * 512, n_steps=40, chunk_paths=512,
                               pilot_paths=1024, dt=DT, pathgen_impl="xla")
    chain = tengine.StreamingChainPricer(
        **BENCH_MARKET, strikes=[97.0, 103.0], maturity=40 * DT,
        is_call=False, config=cfg, device="cpu")
    one = tengine.StreamingPricer(**BENCH_MARKET, strike=103.0,
                                  maturity=40 * DT, is_call=False,
                                  config=cfg, device="cpu")
    np.testing.assert_allclose(chain.price(4)[1], one.price(4), rtol=1e-6)


def test_engine_reads_stream_noise():
    """``price_with_fit(noise=(z, dw))`` on the stream equals the mean of
    the policy values of ``paths_from_noise`` on each chunk's planes,
    paired under antithetic."""
    n_steps, chunk = 24, 256
    cfg = tengine.StreamConfig(n_paths=2 * chunk, n_steps=n_steps,
                               chunk_paths=chunk, pilot_paths=512, dt=DT,
                               pathgen_impl="xla", antithetic=True)
    pricer = tengine.StreamingPricer(**BENCH_MARKET, strike=102.0,
                                     maturity=n_steps * DT, is_call=False,
                                     config=cfg, device="cpu")
    fits = pricer.fit(tengine._pilot_stream_keys(3)[0])
    rng = np.random.default_rng(8)
    z = torch.from_numpy(rng.normal(size=(2, 2, chunk // 2, n_steps))
                         .astype(np.float32))
    dw = torch.from_numpy((rng.normal(size=(2, chunk // 2, n_steps))
                           * math.sqrt(DT)).astype(np.float32))
    got = pricer.price_with_fit(fits, noise=(z, dw))
    want = sum(float(tengine.lsm_policy_value(
        ps.paths_from_noise(pricer.consts, z[i], dw[i], True), fits,
        BENCH_MARKET["r"], 102.0, n_steps * DT, DT, False)[0])
        for i in range(2)) / (2 * chunk)
    assert abs(got / want - 1.0) < 1e-6


def test_out_of_scope_stream_options_raise():
    """The serving generator's live horizon and traced Hurst exponent
    (each refused naming ROADMAP A13/A10 before they were ported): paths
    stay flat past ``n_live``, and ``traced_h`` builds the matrices on the
    device within 1e-7 of the host build (and refuses the FFT synthesis,
    as JAX does).  The QMC noise (refused naming A12 before it was
    ported) builds its PCA map, and ``qmc_fgn`` is refused without
    ``qmc`` and on the FFT synthesis, as JAX refuses them."""
    consts = stream_consts(16)
    z = torch.randn((2, 4, 16), generator=torch.Generator().manual_seed(0))
    live = ps.paths_from_noise(consts, z, z[0], n_live=8)
    full = ps.paths_from_noise(consts, z, z[0])
    assert torch.equal(live[:, :9], full[:, :9])
    assert torch.equal(live[:, 9:], live[:, 8:9].expand(-1, 8))
    traced = ps.make_stream_consts(100.0, 0.04, 0.1, 1.5, 0.04, 16, DT,
                                   "cpu", traced_h=True)
    host = ps.make_stream_consts(100.0, 0.04, 0.1, 1.5, 0.04, 16, DT, "cpu")
    for a, b in ((traced.cr, host.cr), (traced.ci, host.ci),
                 (traced.t_pow, host.t_pow)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-7)
    with pytest.raises(ValueError, match="traced_h requires the matmul"):
        ps.make_stream_consts(100.0, 0.04, 0.1, 1.5, 0.04, 16, DT, "cpu",
                              traced_h=True, fgn_impl="fft")
    q = ps.make_stream_consts(100.0, 0.04, 0.1, 1.5, 0.04, 16, DT, "cpu",
                              qmc=True)
    assert q.qmc and q.pca_t.shape == (16, 16) and q.qmc_dims == 16
    for kw in (dict(qmc_fgn=True), dict(qmc=True, qmc_fgn=True,
                                        fgn_impl="fft")):
        with pytest.raises(ValueError, match="qmc_fgn requires"):
            ps.make_stream_consts(100.0, 0.04, 0.1, 1.5, 0.04, 16, DT,
                                  "cpu", **kw)
    with pytest.raises(ValueError, match="fgn_impl"):
        tengine.StreamConfig(n_paths=1024, n_steps=16, fgn_impl="dft")
    with pytest.raises(ValueError, match="pathgen_impl"):
        tengine.StreamConfig(n_paths=1024, n_steps=16, pathgen_impl="tpu")
