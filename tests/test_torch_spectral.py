"""The spectral fGN form of the port (``fgn_form="spectral"``: three noise
planes Zr, Zi, W and the dense X = Zr @ Cr' - Zi @ Ci') against the JAX
package: the plain versions of K1, K2, K5, K6 and K7 in that form (which
their wrappers run on CPU tensors) against JAX's interpreted spectral
kernels on the same numpy noise, the dense product's reach into the early
columns, the seeded stream in distribution, the strip past the single tile
(K8's pilot beside K5's spectral constants), the duality bounds, and the
Greeks' refusal.  The kernels themselves are held against these plain
versions on the card in test_torch_gpu.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlooptionspricer_tpu.models import engine as jengine
from montecarlooptionspricer_tpu.models import pathgen_pallas as jpp
from montecarlooptionspricer_tpu.models import pathgen_pallas_tiled as jtiled
from montecarlooptionspricer_tpu.models.lsm import lsm_fit as jlsm_fit
from montecarlooptionspricer_tpu_torch.models import chain_cuda as cc
from montecarlooptionspricer_tpu_torch.models import engine as tengine
from montecarlooptionspricer_tpu_torch.models import greeks_cuda as tgc
from montecarlooptionspricer_tpu_torch.models import pathgen_cuda as pc
from montecarlooptionspricer_tpu_torch.models import pathgen_tiled_cuda as ptc

from test_torch_bounds import jax_to_port_rows
from test_torch_chain import STRIP3, STRIP13, jax_strip_fits
from test_torch_pathgen import DT, KW, to_port_fits

BENCH_MARKET = dict(s0=100.0, xi=0.04, h=0.1, eta=1.5, rho=-0.4, r=0.04)
N_STEPS, ROWS, BLOCK = 64, 512, 256       # one JAX single tile (s_pad 128)
SLAB_STEPS, SLAB_ROWS = 150, 256          # two JAX slab tiles of 128
FORMS = [(False, False), (True, False), (False, True), (True, True)]
FORM_IDS = ["plain", "anti", "cv", "anti+cv"]


def spectral_noise(rng, rows, n_steps, scale=1.0):
    """[3, rows, s_pad] float32 numpy (Zr, Zi, W), zero past n_steps: the
    JAX kernels read the padded width, the port the first n_steps
    columns."""
    s_pad = pc._round_up(n_steps, pc.LANE)
    noise = np.zeros((3, rows, s_pad), np.float32)
    noise[:, :, :n_steps] = scale * rng.normal(size=(3, rows, n_steps))
    return noise


def port(noise, n_steps):
    return torch.from_numpy(np.ascontiguousarray(noise[:, :, :n_steps]))


def consts_cpu(n_steps=N_STEPS):
    return pc.make_path_consts(KW["s0"], KW["xi"], KW["h"], KW["eta"],
                               KW["r"], n_steps, DT, "cpu",
                               fgn_form="spectral")


def jax_gen(n_steps, rows, antithetic=False):
    gen, _ = jpp.make_pallas_pathgen_from_noise(
        **KW, n_steps=n_steps, dt=DT, chunk_paths=rows, block_paths=BLOCK,
        interpret=True, fgn_form="spectral", antithetic=antithetic)
    return gen


@functools.lru_cache(maxsize=None)
def jax_fits(is_call: bool, strike: float, n_steps: int = N_STEPS):
    """JAX's LSM fit on a pilot of its interpreted spectral kernel."""
    noise = spectral_noise(np.random.default_rng(11), ROWS, n_steps)
    paths = jax_gen(n_steps, ROWS)(jnp.asarray(noise))
    _, fits = jlsm_fit(paths, KW["r"], strike, n_steps * DT, DT, is_call, 2)
    return paths, fits


def log_tables(fits, strike, is_call, n_steps):
    """JAX's and the port's log_boundary_rows tables of one fit."""
    maturity = n_steps * DT
    jrows = jpp.log_boundary_rows(jpp.boundary_rows(
        fits, KW["r"], strike, maturity, DT, n_steps, is_call))
    table = pc.log_boundary_rows(pc.boundary_rows(
        to_port_fits(fits), KW["r"], strike, maturity, DT, n_steps,
        is_call)).contiguous()
    return jrows, table


def lanes(out, with_cv):
    return tuple(float(v) for v in (out if with_cv else (out,)))


# ---------------------------------------------------------------------------
# Constants and the seeded stream.

def test_spectral_constants_and_stream():
    """Cr' and Ci' are 0.5 x JAX's float32 spectral matrices to the bit,
    dense (the lower triangle counts); the seeded stream's Zr and W are
    the chol stream's N and W on the same key, its Zi standard normal
    (moments within 5 sigma), uncorrelated with both and apart from
    them, and a row window equals the same rows of the whole block."""
    n = 40
    c = consts_cpu(n)
    assert c.spectral and c.lt_half is None and c.n_planes == 3
    jcr, jci = jengine._fgn_matrices_host(n, KW["h"], KW["eta"], DT,
                                          jnp.float32)
    np.testing.assert_array_equal(c.cr_half.numpy(), 0.5 * np.asarray(jcr))
    np.testing.assert_array_equal(c.ci_half.numpy(), 0.5 * np.asarray(jci))
    assert float(torch.tril(c.cr_half, -1).abs().sum()) > 0
    assert float(torch.tril(c.ci_half, -1).abs().sum()) > 0

    rows, key = 4096, pc._fold_words(21, 3)
    spec = pc.philox_spectral_normals_ref(key, rows, n)
    chol = pc.philox_normals_ref(key, rows, n)
    assert spec.shape == (3, rows, n) and spec.dtype == torch.float32
    assert torch.equal(spec[0], chol[0]) and torch.equal(spec[2], chol[1])
    zi = spec[1].double()
    m = zi.numel()
    assert abs(float(zi.mean())) < 5 / m ** 0.5
    assert abs(float(zi.var()) - 1.0) < 5 * (2 / m) ** 0.5
    corr = torch.corrcoef(spec.double().reshape(3, -1))
    assert float((corr - torch.eye(3, dtype=torch.float64)).abs().max()) \
        < 5 / m ** 0.5
    window = pc.philox_spectral_normals_ref(key, 64, n, row0=128)
    assert torch.equal(window, spec[:, 128:192])
    assert torch.equal(pc.normals_ref(c, key, 64, row0=128), window)


# ---------------------------------------------------------------------------
# Each spectral plain version against JAX's interpreted spectral kernel.

@pytest.mark.parametrize("antithetic", [False, True], ids=["plain", "anti"])
def test_spectral_k1_matches_jax(rng, antithetic):
    """Plain K1 spectral (and K1/anti, [X; -X] against JAX's in-block pair
    layout after the row map) against ``make_pallas_pathgen_from_noise(
    fgn_form="spectral")``: rtol 2e-4 (another float32 order of the two
    products and the log-price sum).  The wrapper takes the plain version
    on CPU tensors, and refuses chol-shaped noise."""
    drawn = ROWS // 2 if antithetic else ROWS
    noise = spectral_noise(rng, drawn, N_STEPS)
    want = np.asarray(jax_gen(N_STEPS, ROWS, antithetic)(jnp.asarray(noise)))
    if antithetic:
        want = want[jax_to_port_rows(ROWS, BLOCK)]
    consts = consts_cpu()
    got = pc.pathgen_from_noise_ref(consts, port(noise, N_STEPS), antithetic)
    assert got.shape == (ROWS, N_STEPS + 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4)
    torch.testing.assert_close(
        pc.pathgen(consts, noise=port(noise, N_STEPS), antithetic=antithetic),
        got, rtol=0, atol=0)
    with pytest.raises(ValueError, match="spectral noise"):
        pc.pathgen(consts, noise=port(noise, N_STEPS)[[0, 2]])


def test_spectral_upper_rows_reach_early_columns(rng):
    """The spectral matrices are dense: noise only in steps 64..95 (the
    second 64-column tile of the single-tile kernels) moves the fGN plane
    of every step, the first tile's included, as JAX computes it.  A
    kernel that kept the chol form's triangle skip (rows past a tile's
    last column) would leave the first tile flat: the plain versions hold
    X there against JAX to 2e-4 of its scale, and the card tests hold the
    kernels against them on the same noise."""
    n, rows = 96, 256
    noise = spectral_noise(rng, rows, n)
    noise[:2, :, :64] = 0.0               # Zr, Zi zero in the first tile
    consts = pc.make_path_consts(KW["s0"], KW["xi"], KW["h"], KW["eta"],
                                 KW["r"], n, DT, "cpu", fgn_form="spectral")
    x = pc.fgn_x_ref(consts, port(noise, n))
    assert float(x[:, :64].abs().min()) > 0.0
    assert float(x[:, :64].std()) > 0.1 * float(x[:, 64:].std())
    want = np.asarray(jax_gen(n, rows)(jnp.asarray(noise)))
    got = pc.pathgen(consts, noise=port(noise, n)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4)
    no_fgn = port(noise, n).clone()
    no_fgn[:2] = 0.0                      # the same price noise, X = 0
    flat = pc.pathgen(consts, noise=no_fgn).numpy()
    assert np.abs(got[:, 1:65] - flat[:, 1:65]).max() > 1e-2


@pytest.mark.parametrize("antithetic,with_cv", FORMS, ids=FORM_IDS)
def test_spectral_k2_forms_match_jax(rng, antithetic, with_cv):
    """Plain K2 spectral in each form against ``make_pallas_priced_chunk(
    noise_input=True, fgn_form="spectral", policy_form="boundary")`` of
    that form on the same noise under JAX's fit: rtol 1e-4 on the payoff
    and control sums (a decision can flip only inside the float32 root
    band)."""
    strike, is_call = 102.0, False
    _, fits = jax_fits(is_call, strike)
    jrows, table = log_tables(fits, strike, is_call, N_STEPS)
    noise = spectral_noise(rng, ROWS // 2 if antithetic else ROWS, N_STEPS)
    chunk_sum, _ = jpp.make_pallas_priced_chunk(
        **KW, strike=strike, maturity=N_STEPS * DT, dt=DT, n_steps=N_STEPS,
        chunk_paths=ROWS, block_paths=BLOCK, is_call=is_call, interpret=True,
        noise_input=True, fgn_form="spectral", policy_form="boundary",
        antithetic=antithetic, with_cv=with_cv)
    want = lanes(chunk_sum(jnp.asarray(noise), jrows), with_cv)
    got = lanes(pc.priced_chunk(consts_cpu(), table, strike, is_call,
                                noise=port(noise, N_STEPS),
                                antithetic=antithetic, with_cv=with_cv),
                with_cv)
    assert want[0] > 0
    np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize("antithetic,strikes", [(False, STRIP3),
                                                (True, STRIP13)],
                         ids=["plain", "anti"])
def test_spectral_k5_matches_jax(rng, antithetic, strikes):
    """Plain K5 spectral against ``make_pallas_priced_chain(
    noise_input=True, fgn_form="spectral")`` (13 strikes: JAX's two
    regenerated groups), plain and paired, on the same noise and tables:
    rtol 1e-4 per strike, atol 1e-3 of the largest."""
    paths, _ = jax_fits(False, 100.0)
    _, jtab = jax_strip_fits(paths, strikes, False, n_steps=N_STEPS)
    chain, _ = jpp.make_pallas_priced_chain(
        **KW, strikes=strikes, maturity=N_STEPS * DT, dt=DT,
        n_steps=N_STEPS, chunk_paths=ROWS, block_paths=BLOCK, is_call=False,
        interpret=True, noise_input=True, fgn_form="spectral",
        policy_form="boundary", antithetic=antithetic)
    noise = spectral_noise(rng, ROWS // 2 if antithetic else ROWS, N_STEPS)
    want = np.asarray(chain(jnp.asarray(noise), jtab))
    got = cc.priced_chain(consts_cpu(), torch.tensor(np.asarray(jtab)),
                          False, noise=port(noise, N_STEPS),
                          antithetic=antithetic)
    assert got.shape == (len(strikes),) and want.max() > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-3 * want.max())


@pytest.mark.parametrize("antithetic", [False, True], ids=["plain", "anti"])
def test_spectral_k6_matches_jax(rng, antithetic):
    """Plain K6 spectral against ``make_tiled_pathgen(noise_input=True,
    fgn_form="spectral")`` at 150 steps (two JAX slab tiles; the first
    tile's columns read the second tile's rows): rtol 2e-4, paired after
    the row map."""
    block = 128
    drawn = SLAB_ROWS // 2 if antithetic else SLAB_ROWS
    noise = spectral_noise(rng, drawn, SLAB_STEPS)
    gen, s_pad = jtiled.make_tiled_pathgen(
        **KW, n_steps=SLAB_STEPS, dt=DT, chunk_paths=SLAB_ROWS,
        block_paths=block, interpret=True, noise_input=True,
        fgn_form="spectral", antithetic=antithetic)
    assert s_pad == 256
    want = np.asarray(gen(jnp.asarray(noise)))
    if antithetic:
        want = want[jax_to_port_rows(SLAB_ROWS, block)]
    got = ptc.tiled_pathgen(consts_cpu(SLAB_STEPS),
                            noise=port(noise, SLAB_STEPS),
                            antithetic=antithetic)
    assert got.shape == (SLAB_ROWS, SLAB_STEPS + 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4)


@pytest.mark.parametrize("antithetic,with_cv", FORMS, ids=FORM_IDS)
def test_spectral_k7_forms_match_jax(rng, antithetic, with_cv):
    """Plain K7 spectral in each form against ``make_tiled_priced_chunk(
    noise_input=True, fgn_form="spectral", policy_form="boundary")`` at
    150 steps under JAX's fit: rtol 1e-4."""
    strike, is_call, block = 100.0, False, 128
    _, fits = jax_fits(is_call, strike, SLAB_STEPS)
    jrows, table = log_tables(fits, strike, is_call, SLAB_STEPS)
    noise = spectral_noise(rng, SLAB_ROWS // 2 if antithetic else SLAB_ROWS,
                           SLAB_STEPS)
    chunk_sum, _ = jtiled.make_tiled_priced_chunk(
        **KW, strike=strike, maturity=SLAB_STEPS * DT, dt=DT,
        n_steps=SLAB_STEPS, chunk_paths=SLAB_ROWS, block_paths=block,
        is_call=is_call, interpret=True, noise_input=True,
        fgn_form="spectral", policy_form="boundary", antithetic=antithetic,
        with_cv=with_cv)
    want = lanes(chunk_sum(jnp.asarray(noise), jrows), with_cv)
    got = lanes(ptc.tiled_priced_chunk(
        consts_cpu(SLAB_STEPS), table, strike, is_call,
        noise=port(noise, SLAB_STEPS), antithetic=antithetic,
        with_cv=with_cv), with_cv)
    assert want[0] > 0
    np.testing.assert_allclose(got, want, rtol=1e-4)


# ---------------------------------------------------------------------------
# The engine in the spectral form.

def spectral_pricer(n_steps, fgn_form="spectral", **cfg):
    kw = dict(n_paths=4 * 1024, n_steps=n_steps, chunk_paths=1024,
              pilot_paths=2048, dt=DT, fgn_form=fgn_form)
    kw.update(cfg)
    return tengine.StreamingPricer(
        **BENCH_MARKET, strike=105.0, maturity=n_steps * DT, is_call=False,
        config=tengine.StreamConfig(**kw), device="cpu")


def test_spectral_price_in_distribution():
    """The port's seeded 100-step spectral price (K1/K2 spectral, plain
    versions) against the JAX StreamingPricer's (XLA generator,
    fgn_form="spectral", another random stream) and against the port's
    own chol price (the same law): within 5 combined stderr each."""
    n_steps, seed = 100, 0
    pricer = spectral_pricer(n_steps)
    assert pricer.kernel_family == "single" and pricer.consts.spectral
    got, se_t = pricer.price(seed, with_stderr=True)
    chol, se_c = spectral_pricer(n_steps, "auto").price(seed,
                                                        with_stderr=True)
    jcfg = jengine.StreamConfig(n_paths=4 * 1024, n_steps=n_steps,
                                chunk_paths=1024, pilot_paths=2048, dt=DT,
                                pathgen_impl="xla", fgn_form="spectral")
    want, se_j = jengine.StreamingPricer(
        **BENCH_MARKET, strike=105.0, maturity=n_steps * DT, is_call=False,
        config=jcfg).price(jax.random.key(seed), with_stderr=True)
    assert 0 < se_t < 0.05 * got and got != chol
    assert abs(got - want) < 5 * np.hypot(se_t, se_j), (got, want)
    assert abs(got - chol) < 5 * np.hypot(se_t, se_c), (got, chol)


@pytest.mark.parametrize("antithetic", [False, True], ids=["plain", "anti"])
def test_spectral_bounds_lower_equals_price(antithetic):
    """``price_with_bounds`` in the spectral form streams K1 spectral
    (K1/anti) whole paths drawn from ``price``'s chunks: at 365 steps on
    the bench market its lower bound agrees with ``price`` on the same
    seed within 1e-4, under the upper bound."""
    cfg = tengine.StreamConfig(n_paths=1 << 13, n_steps=365,
                               chunk_paths=1 << 12, pilot_paths=1 << 12,
                               antithetic=antithetic, fgn_form="spectral")
    p = tengine.StreamingPricer(**BENCH_MARKET, strike=105.0,
                                maturity=365 * DT, is_call=False, config=cfg,
                                device="cpu")
    assert p.consts.spectral and p.consts.block_paths == 32
    lo, up = p.price_with_bounds(42)
    price = p.price(42)
    assert lo < up
    assert abs(lo / price - 1.0) <= 1e-4


def test_spectral_strip_past_the_tile_fits_on_k8_pilot():
    """A 400-step spectral strip runs on the factored family's pilot (K8)
    and streams K5 on its own spectral constants: the fits of strike 105
    equal those of ``StreamingPricer`` at 105 on the same seed (one pilot;
    the batched fit's float32 arithmetic per strike, rtol 1e-6), and the
    strip's price at 105 lies within 5 combined stderr of the single
    pricer's (K9's noise, the same law)."""
    n_steps, seed = 400, 3
    cfg = tengine.StreamConfig(n_paths=4 * 512, n_steps=n_steps,
                               chunk_paths=512, pilot_paths=512, dt=DT,
                               fgn_form="spectral")
    chain = tengine.StreamingChainPricer(
        **BENCH_MARKET, strikes=[95.0, 105.0], maturity=n_steps * DT,
        is_call=False, config=cfg, device="cpu")
    one = tengine.StreamingPricer(
        **BENCH_MARKET, strike=105.0, maturity=n_steps * DT, is_call=False,
        config=cfg, device="cpu")
    assert chain.kernel_family == one.kernel_family == "factored"
    assert chain.chain_consts.spectral and chain.chain_consts.n_steps == 400
    carrier = tengine._pilot_stream_keys(seed)[0]
    strip_fits, one_fits = chain.fit(carrier), one.fit(carrier)
    for got, want in zip(strip_fits, one_fits):
        np.testing.assert_allclose(got[1].numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-6)
    prices, ses = chain.price(seed, with_stderr=True)
    price, se = one.price(seed, with_stderr=True)
    assert 0 < prices[0] < prices[1]
    assert abs(prices[1] - price) < 5 * np.hypot(ses[1], se)


@pytest.mark.parametrize("strip", [False, True], ids=["single", "strip"])
def test_spectral_greeks_raise(monkeypatch, strip):
    """JAX's fused Greeks run under chol only; a spectral configuration's
    Greeks take its jvp stream, and so do the port's (both pricers raised
    naming ROADMAP A10 before it was ported): finite Greeks, the price
    lane within 5 combined stderr of ``price``, and the chol K3/K4 never
    called on spectral paths."""
    cfg = tengine.StreamConfig(n_paths=1024, n_steps=32, chunk_paths=512,
                               pilot_paths=512, dt=DT, fgn_form="spectral")
    if strip:
        pricer = tengine.StreamingChainPricer(
            **BENCH_MARKET, strikes=[95.0, 105.0], maturity=32 * DT,
            is_call=False, config=cfg, device="cpu")
    else:
        pricer = tengine.StreamingPricer(
            **BENCH_MARKET, strike=105.0, maturity=32 * DT, is_call=False,
            config=cfg, device="cpu")
    assert pricer.kernel_family == "single"

    def refuse(*args, **kwargs):
        raise AssertionError("the chol K3/K4 ran on a spectral pricer")

    monkeypatch.setattr(tgc, "greeks_chunk", refuse)
    monkeypatch.setattr(tgc, "chain_greeks_chunk", refuse)
    g, se = pricer.price_and_greeks(0, with_stderr=True)
    price, p_se = pricer.price(0, with_stderr=True)
    g, se = np.asarray(g).reshape(6, -1), np.asarray(se).reshape(6, -1)
    price, p_se = np.atleast_1d(price), np.atleast_1d(p_se)
    assert np.all(np.isfinite(g)) and np.all(g[1] < 0)
    assert np.all(np.abs(g[0] - price) < 5 * np.hypot(se[0], p_se))
