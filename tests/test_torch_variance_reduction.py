"""The port's estimators, antithetic pairing and the martingale control
variate, against the JAX package: each form of the priced kernels K2, K7
and K9 (their plain versions, which the wrappers run on CPU tensors)
against the JAX kernel of that form in interpret mode on the same numpy
noise; the pair identity; the pilot's control fit; the slice as a whole on
shared noise under one JAX fit and in distribution from seeds; the
configurations that are refused; and the CLI's flags.  The kernels
themselves are held against these plain versions on the card in
test_torch_gpu.py."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlooptionspricer_tpu.models import engine as jengine
from montecarlooptionspricer_tpu.models import pathgen_pallas as jpp
from montecarlooptionspricer_tpu.models import pathgen_pallas_factored as jf
from montecarlooptionspricer_tpu.models import pathgen_pallas_tiled as jtiled
from montecarlooptionspricer_tpu_torch.cli import price as tcli
from montecarlooptionspricer_tpu_torch.models import engine as tengine
from montecarlooptionspricer_tpu_torch.models import pathgen_cuda as pc
from montecarlooptionspricer_tpu_torch.models import (
    pathgen_factored_cuda as pfc)
from montecarlooptionspricer_tpu_torch.models import pathgen_tiled_cuda as ptc

from test_torch_factored import consts_cpu as factored_consts
from test_torch_factored import factored_noise, xla_pilot_fits
from test_torch_pathgen import (DT, KW, jax_pilot_fits, port_noise,
                                shared_noise, to_port_fits)
from test_torch_tiled import BENCH_MARKET
from test_torch_tiled import pilot_fits as tiled_pilot_fits

# (antithetic, with_cv) of the three forms beside the plain one.
FORMS = [(True, False), (False, True), (True, True)]
FORM_IDS = ["anti", "cv", "anti+cv"]


def path_consts(n_steps):
    return pc.make_path_consts(KW["s0"], KW["xi"], KW["h"], KW["eta"],
                               KW["r"], n_steps, DT, "cpu")


def port_table(fits, strike, n_steps, is_call):
    return pc.log_boundary_rows(pc.boundary_rows(
        to_port_fits(fits), KW["r"], strike, n_steps * DT, DT, n_steps,
        is_call)).contiguous()


def jax_table(fits, strike, n_steps, is_call):
    return jpp.log_boundary_rows(jpp.boundary_rows(
        fits, KW["r"], strike, n_steps * DT, DT, n_steps, is_call))


def lanes(out, with_cv):
    """A priced kernel's output as a tuple of floats (payoff[, control])."""
    return tuple(float(v) for v in (out if with_cv else (out,)))


def jax_control_fit(paths, fits, strike, maturity, is_call, chunk):
    """beta and center as the JAX engine's CV fit_fn computes them, from
    its lsm_policy_path_values and martingale_control (one device)."""
    av = jengine.lsm_policy_path_values(paths, fits, KW["r"], strike,
                                        maturity, DT, is_call)
    cv = jengine.martingale_control(paths, KW["r"], DT)
    av_m, cv_m = jnp.mean(av), jnp.mean(cv)
    cvc, avc = cv - cv_m, av - av_m
    beta = jnp.sum(cvc * avc) / jnp.maximum(jnp.sum(cvc * cvc), 1e-12)
    center = (av_m - beta * cv_m) * jnp.float32(chunk)
    return float(beta), float(center)


# ---------------------------------------------------------------------------
# Each form's plain version against the JAX kernel of that form.

N_STEPS, CHUNK = 96, 512


@pytest.mark.parametrize("antithetic,with_cv", FORMS, ids=FORM_IDS)
@pytest.mark.parametrize("is_call,strike", [(False, 102.0), (True, 98.0)])
def test_k2_forms_match_jax(rng, antithetic, with_cv, is_call, strike):
    """Plain K2 in each form against ``make_pallas_priced_chunk(fgn_form=
    "chol", policy_form="boundary", antithetic=, with_cv=)`` on the same
    noise (half the rows when paired) under one JAX fit: both lanes at
    rtol 1e-4, the plain form's tolerance (float32 order; a decision flips
    only inside the root band)."""
    maturity = N_STEPS * DT
    _, fits = jax_pilot_fits(shared_noise(rng, CHUNK, N_STEPS), strike,
                             maturity, is_call)
    noise = shared_noise(rng, CHUNK // 2 if antithetic else CHUNK, N_STEPS)
    chunk_sum, _ = jpp.make_pallas_priced_chunk(
        **KW, strike=strike, maturity=maturity, dt=DT, n_steps=N_STEPS,
        chunk_paths=CHUNK, block_paths=256, is_call=is_call, interpret=True,
        noise_input=True, fgn_form="chol", policy_form="boundary",
        antithetic=antithetic, with_cv=with_cv)
    want = lanes(chunk_sum(jnp.asarray(noise),
                           jax_table(fits, strike, N_STEPS, is_call)),
                 with_cv)
    got = lanes(pc.priced_chunk(
        path_consts(N_STEPS), port_table(fits, strike, N_STEPS, is_call),
        strike, is_call, noise=port_noise(noise, N_STEPS),
        antithetic=antithetic, with_cv=with_cv), with_cv)
    assert want[0] > 0
    np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize("antithetic,with_cv", FORMS, ids=FORM_IDS)
def test_k7_forms_match_jax(rng, antithetic, with_cv):
    """Plain K7 in each form against ``make_tiled_priced_chunk(fgn_form=
    "chol")`` at 300 steps (three step tiles of 128 in JAX): rtol 1e-4."""
    n_steps, rows, strike = 300, 512, 102.0
    fits = tiled_pilot_fits(False, strike)
    noise = shared_noise(rng, rows // 2 if antithetic else rows, n_steps)
    chunk_sum, _ = jtiled.make_tiled_priced_chunk(
        **KW, strike=strike, maturity=n_steps * DT, dt=DT, n_steps=n_steps,
        chunk_paths=rows, block_paths=256, is_call=False, interpret=True,
        noise_input=True, fgn_form="chol", policy_form="boundary",
        antithetic=antithetic, with_cv=with_cv)
    want = lanes(chunk_sum(jnp.asarray(noise),
                           jax_table(fits, strike, n_steps, False)), with_cv)
    got = lanes(ptc.tiled_priced_chunk(
        path_consts(n_steps), port_table(fits, strike, n_steps, False),
        strike, False, noise=port_noise(noise, n_steps),
        antithetic=antithetic, with_cv=with_cv), with_cv)
    assert want[0] > 0
    np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize("n_steps,rows,block,antithetic,with_cv", [
    (200, 128, 64, True, False),
    (200, 128, 64, False, True),
    (200, 128, 64, True, True),
    # The reference's horizon class (m2 2048, N2 16, nine step tiles).
    (1100, 64, 32, True, True),
])
def test_k9_forms_match_jax(rng, n_steps, rows, block, antithetic, with_cv):
    """Plain K9 in each form against ``make_factored_priced_chunk(
    policy_form="boundary", antithetic=, with_cv=)`` under JAX's fit, on
    noise x1.5 so paths exercise: rtol 5e-4, the plain form's tolerance."""
    strike = 97.0
    fits = xla_pilot_fits(n_steps, strike, False)
    noise = 1.5 * factored_noise(rng, rows // 2 if antithetic else rows,
                                 n_steps, w_pad=0.0)
    chunk_sum, _ = jf.make_factored_priced_chunk(
        **KW, strike=strike, maturity=n_steps * DT, dt=DT, n_steps=n_steps,
        chunk_paths=rows, block_paths=block, is_call=False, interpret=True,
        noise_input=True, policy_form="boundary", antithetic=antithetic,
        with_cv=with_cv)
    want = lanes(chunk_sum(jnp.asarray(noise),
                           jax_table(fits, strike, n_steps, False)), with_cv)
    got = lanes(pfc.factored_priced_chunk(
        factored_consts(n_steps), port_table(fits, strike, n_steps, False),
        strike, False, noise=torch.from_numpy(noise), antithetic=antithetic,
        with_cv=with_cv), with_cv)
    assert want[0] > 0
    np.testing.assert_allclose(got, want, rtol=5e-4)


@pytest.mark.parametrize("family", ["single", "tiled", "factored"])
def test_pair_identity(rng, family):
    """Each family's paired form on [planes, r/2, m] equals its unpaired
    form on the concatenated [X; -X] (both lanes, rtol 1e-6): the pair's
    members are exactly the paths of the negated noise, and seeded, a
    paired chunk draws the stream's first r/2 rows."""
    n_steps, rows, strike = {"single": (96, 256, 100.0),
                             "tiled": (300, 256, 100.0),
                             "factored": (200, 128, 100.0)}[family]
    if family == "factored":
        consts = factored_consts(n_steps)
        noise = torch.from_numpy(factored_noise(rng, rows // 2, n_steps))
        priced, normals = (pfc.factored_priced_chunk,
                           pfc.philox_factored_normals_ref)
    else:
        consts = path_consts(n_steps)
        noise = torch.from_numpy(rng.normal(
            size=(2, rows // 2, n_steps)).astype(np.float32))
        priced = {"single": pc.priced_chunk,
                  "tiled": ptc.tiled_priced_chunk}[family]
        normals = pc.philox_normals_ref
    paths = pc.prices_from_log(
        (pfc if family == "factored" else pc)._log_paths_ref(consts, noise),
        consts.s0)
    _, fits = tengine.lsm_fit(paths, KW["r"], strike, n_steps * DT, DT,
                              False)
    table = tengine._fused_rows_builder(KW["r"], strike, n_steps * DT, DT,
                                        n_steps, False)(fits)
    for cv in (False, True):
        paired = lanes(priced(consts, table, strike, False, noise=noise,
                              antithetic=True, with_cv=cv), cv)
        both = torch.cat([noise, -noise], dim=1)
        unpaired = lanes(priced(consts, table, strike, False, noise=both,
                                with_cv=cv), cv)
        assert paired[0] > 0
        np.testing.assert_allclose(paired, unpaired, rtol=1e-6)
    key = pc._fold_words(9, 4)
    seeded = lanes(priced(consts, table, strike, False, rows=rows, key=key,
                          antithetic=True, with_cv=True), True)
    drawn = normals(key, rows // 2, n_steps)
    assert seeded == lanes(priced(consts, table, strike, False, noise=drawn,
                                  antithetic=True, with_cv=True), True)


# ---------------------------------------------------------------------------
# The control fit and the slice as a whole.

def test_control_fit_matches_jax(rng):
    """beta and center from one JAX pilot (paths of the interpreted chol
    kernel, JAX's fit): the port's control_fit against the JAX engine's
    CV fit arithmetic, rtol 1e-4; the per-path control to 1e-6."""
    n_steps, strike, chunk = 64, 103.0, 512
    maturity = n_steps * DT
    paths, fits = jax_pilot_fits(shared_noise(rng, 1024, n_steps), strike,
                                 maturity, False, n_steps=n_steps)
    want = jax_control_fit(paths, fits, strike, maturity, False, chunk)
    tpaths = torch.from_numpy(np.array(paths))
    got = tengine.control_fit(tpaths, to_port_fits(fits), KW["r"], strike,
                              maturity, DT, False, chunk)
    assert want[0] < 0                  # a put falls as S_T rises
    np.testing.assert_allclose(got, want, rtol=1e-4)
    np.testing.assert_allclose(
        tengine.martingale_control(tpaths, KW["r"], DT).numpy(),
        np.asarray(jengine.martingale_control(paths, KW["r"], DT)),
        rtol=1e-6)


@pytest.mark.parametrize("antithetic,with_cv", FORMS, ids=FORM_IDS)
def test_slice_on_shared_noise_matches_jax(rng, antithetic, with_cv):
    """One JAX pilot -> JAX's fit, beta and center -> the port's
    price_with_fit (a CVFit carried over as floats) on shared chunk noise,
    against the JAX fused estimate from the same form's kernel on the same
    noise: amer / n - beta (cv / n - s0) under CV, as the JAX engine's
    price() corrects it.  rtol 1e-4."""
    n_steps, chunk, n_chunks = 64, 512, 3
    strike, maturity = 103.0, n_steps * DT
    paths, fits = jax_pilot_fits(shared_noise(rng, 1024, n_steps), strike,
                                 maturity, False, n_steps=n_steps)
    beta, center = jax_control_fit(paths, fits, strike, maturity, False,
                                   chunk)
    chunks = [shared_noise(rng, chunk // 2 if antithetic else chunk,
                           n_steps) for _ in range(n_chunks)]
    chunk_sum, _ = jpp.make_pallas_priced_chunk(
        **KW, strike=strike, maturity=maturity, dt=DT, n_steps=n_steps,
        chunk_paths=chunk, block_paths=256, is_call=False, interpret=True,
        noise_input=True, fgn_form="chol", policy_form="boundary",
        antithetic=antithetic, with_cv=with_cv)
    rows = jax_table(fits, strike, n_steps, False)
    sums = np.sum([lanes(chunk_sum(jnp.asarray(c), rows), with_cv)
                   for c in chunks], axis=0)
    n = n_chunks * chunk
    want = sums[0] / n - (beta * (sums[1] / n - KW["s0"]) if with_cv
                          else 0.0)

    cfg = tengine.StreamConfig(n_paths=n, n_steps=n_steps, chunk_paths=chunk,
                               pilot_paths=1024, dt=DT, chunks_per_call=2,
                               antithetic=antithetic,
                               control_variate=with_cv)
    pricer = tengine.StreamingPricer(**KW, strike=strike, maturity=maturity,
                                     is_call=False, config=cfg, device="cpu")
    tfits = to_port_fits(fits)
    if with_cv:
        tfits = tengine.CVFit(tfits, beta, center)
    noise = torch.stack([port_noise(c, n_steps) for c in chunks])
    got, se = pricer.price_with_fit(tfits, noise=noise, with_stderr=True)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert np.isfinite(se) and se > 0


@pytest.mark.parametrize("antithetic,with_cv", FORMS, ids=FORM_IDS)
def test_slice_in_distribution_matches_jax(antithetic, with_cv):
    """The port's seeded price in each form against the JAX
    StreamingPricer's in the same form (XLA generator, another random
    stream), at the sizes of the plain form's test: within 5 combined
    stderr."""
    n_steps, chunk, n_chunks, pilot, seed = 32, 2048, 8, 4096, 0
    strike, maturity = 105.0, n_steps * DT
    form = dict(antithetic=antithetic, control_variate=with_cv)
    cfg = tengine.StreamConfig(n_paths=n_chunks * chunk, n_steps=n_steps,
                               chunk_paths=chunk, pilot_paths=pilot, dt=DT,
                               **form)
    got, se_t = tengine.StreamingPricer(
        **BENCH_MARKET, strike=strike, maturity=maturity, is_call=False,
        config=cfg, device="cpu").price(seed, with_stderr=True)
    jcfg = jengine.StreamConfig(n_paths=n_chunks * chunk, n_steps=n_steps,
                                chunk_paths=chunk, pilot_paths=pilot, dt=DT,
                                pathgen_impl="xla", **form)
    want, se_j = jengine.StreamingPricer(
        **BENCH_MARKET, strike=strike, maturity=maturity, is_call=False,
        config=jcfg).price(jax.random.key(seed), with_stderr=True)
    assert 0 < se_t < 0.05 * got
    assert abs(got - want) < 5 * np.hypot(se_t, se_j), (got, want, se_t, se_j)


@pytest.mark.parametrize("antithetic", [False, True])
def test_time0_exercise_under_cv_collapses_exactly(antithetic):
    """A deep-ITM put exercises at time 0: under the control variate the
    pilot's beta is 0 and its center the immediate payoff's chunk total,
    so the price is the payoff and the stderr exactly 0."""
    cfg = tengine.StreamConfig(n_paths=4 * 256, n_steps=16, chunk_paths=256,
                               pilot_paths=512, dt=DT, control_variate=True,
                               antithetic=antithetic)
    pricer = tengine.StreamingPricer(**BENCH_MARKET, strike=1000.0,
                                     maturity=16 * DT, is_call=False,
                                     config=cfg, device="cpu")
    fit = pricer.fit(tengine._pilot_stream_keys(3)[0])
    assert fit.beta == 0.0 and fit.center == 900.0 * 256
    price, se = pricer.price(3, with_stderr=True)
    assert price == 900.0 and se == 0.0


@pytest.mark.parametrize("form", [dict(control_variate=True),
                                  dict(antithetic=True)],
                         ids=["cv", "anti"])
def test_estimator_stderr_below_plain(form):
    """An at-the-money put on one seed (one pilot, so one fit): each
    estimator's stderr is positive and below the plain estimator's."""
    n_steps, chunk, n_chunks = 32, 1024, 16
    out = {}
    for name, kw in (("plain", {}), ("vr", form)):
        cfg = tengine.StreamConfig(n_paths=n_chunks * chunk, n_steps=n_steps,
                                   chunk_paths=chunk, pilot_paths=2048,
                                   dt=DT, **kw)
        out[name] = tengine.StreamingPricer(
            **BENCH_MARKET, strike=100.0, maturity=n_steps * DT,
            is_call=False, config=cfg, device="cpu").price(
                5, with_stderr=True)
    (p, se), (p_vr, se_vr) = out["plain"], out["vr"]
    assert 0 < se_vr < se
    assert abs(p_vr - p) < 5 * np.hypot(se, se_vr)


def test_greeks_under_cv_are_the_plain_greeks():
    """As in the JAX engine, whose fused Greeks stream ignores the
    control: price_and_greeks under control_variate equals the plain
    configuration's, price lane included; greeks_with_fit takes a CVFit."""
    out = []
    for cv in (False, True):
        cfg = tengine.StreamConfig(n_paths=2 * 512, n_steps=24,
                                   chunk_paths=512, pilot_paths=512, dt=DT,
                                   control_variate=cv)
        pricer = tengine.StreamingPricer(**BENCH_MARKET, strike=102.0,
                                         maturity=24 * DT, is_call=False,
                                         config=cfg, device="cpu")
        out.append(pricer.price_and_greeks(4, with_stderr=True))
    assert out[0] == out[1]
    fit = pricer.fit(tengine._pilot_stream_keys(4)[0])
    assert isinstance(fit, tengine.CVFit)
    assert pricer.greeks_with_fit(fit, 4, with_stderr=True) == out[1]


@pytest.mark.parametrize("family,n_steps", [("tiled", 400),
                                            ("factored", 4000)])
def test_long_horizon_forms_price(family, n_steps):
    """antithetic + control_variate on the long-horizon families (the
    seeded CPU path, small chunks): a finite price, a positive stderr."""
    cfg = tengine.StreamConfig(n_paths=2 * 64, n_steps=n_steps,
                               chunk_paths=64, pilot_paths=64, dt=DT,
                               antithetic=True, control_variate=True)
    pricer = tengine.StreamingPricer(**BENCH_MARKET, strike=105.0,
                                     maturity=n_steps * DT, is_call=False,
                                     config=cfg, device="cpu")
    assert pricer.kernel_family == family
    price, se = pricer.price(2, with_stderr=True)
    assert 0 < price < 105.0 and 0 < se < price


# ---------------------------------------------------------------------------
# What is refused.

@pytest.mark.parametrize("config,exc,match", [
    (dict(antithetic=True, policy_form="quadratic"), ValueError,
     "policy_form='boundary'"),
    (dict(antithetic=True, qmc=True), ValueError, "qmc"),
    (dict(antithetic=True, chunk_paths=48), ValueError, "divisible by 32"),
    (dict(antithetic=True, pilot_paths=272), ValueError, "divisible by 32"),
    (dict(qmc_fgn=True), ValueError, "qmc_fgn requires qmc"),
])
def test_estimator_configurations_refused(config, exc, match):
    kw = dict(n_paths=1024, n_steps=32, chunk_paths=256, pilot_paths=256)
    kw.update(config)
    with pytest.raises(exc, match=match):
        tengine.StreamingPricer(**BENCH_MARKET, strike=100.0,
                                maturity=32 * DT, is_call=False,
                                config=tengine.StreamConfig(**kw),
                                device="cpu")


def test_chains_and_greeks_take_the_pair_forms():
    """K5, K3 and K4 pair (refused, naming ROADMAP A5, before their pair
    forms were ported): the chain pricer and both Greeks entries price
    under antithetic, each with a smaller stderr than the plain form's on
    the same seed and fits."""
    kw = dict(n_paths=4 * 256, n_steps=32, chunk_paths=256, pilot_paths=256)
    market = dict(**BENCH_MARKET, maturity=32 * DT, is_call=False)
    pricers = {}
    for anti in (False, True):
        cfg = tengine.StreamConfig(**kw, antithetic=anti)
        pricers[anti] = (
            tengine.StreamingChainPricer(**market, strikes=[97.0, 103.0],
                                         config=cfg, device="cpu"),
            tengine.StreamingPricer(**market, strike=103.0, config=cfg,
                                    device="cpu"))
    chain, one = pricers[False]
    k_pilot = tengine._pilot_stream_keys(0)[0]
    strip_fits, fits = chain.fit(k_pilot), one.fit(k_pilot)
    plain = (chain.price_with_fit(strip_fits, 0, with_stderr=True)[1],
             one.greeks_with_fit(fits, 0, with_stderr=True)[1],
             chain.greeks_with_fit(strip_fits, 0, with_stderr=True)[1])
    chain, one = pricers[True]
    paired = (chain.price_with_fit(strip_fits, 0, with_stderr=True)[1],
              one.greeks_with_fit(fits, 0, with_stderr=True)[1],
              chain.greeks_with_fit(strip_fits, 0, with_stderr=True)[1])
    assert np.all(np.asarray(paired[0]) < np.asarray(plain[0]))
    assert paired[1][0] < plain[1][0]
    assert np.all(np.asarray(paired[2])[0] < np.asarray(plain[2])[0])
    greeks = one.price_and_greeks(0)
    assert len(greeks) == 6 and greeks[1] < 0


def test_fit_and_configuration_must_agree():
    """A CV configuration streams against a CVFit, any other against the
    bare PolyFit: a mismatch raises rather than pricing another
    estimator."""
    for cv in (False, True):
        cfg = tengine.StreamConfig(n_paths=512, n_steps=16, chunk_paths=256,
                                   pilot_paths=256, control_variate=cv)
        pricer = tengine.StreamingPricer(**BENCH_MARKET, strike=100.0,
                                         maturity=16 * DT, is_call=False,
                                         config=cfg, device="cpu")
        fit = pricer.fit(tengine._pilot_stream_keys(1)[0])
        wrong = fit.fits if cv else tengine.CVFit(fit, 0.0, 0.0)
        with pytest.raises(ValueError, match="CVFit"):
            pricer.price_with_fit(wrong, 1)


# ---------------------------------------------------------------------------
# The CLI.

_RUN = ["--strike", "102", "--put", "--maturity", "0.12", "--steps", "24",
        "--paths", "4096", "--chunk-paths", "2048", "--device", "cpu"]


@pytest.mark.parametrize("flags", [["--antithetic"], ["--control-variate"],
                                   ["--antithetic", "--control-variate"]])
def test_cli_estimators_price_on_cpu(capsys, flags):
    assert tcli.main(_RUN + flags) == 0
    out = json.loads(capsys.readouterr().out)
    assert set(out) == {"price", "stderr", "n_paths", "n_steps", "is_call",
                        "kernel_family", "elapsed_s"}
    assert out["n_paths"] == 4096 and out["price"] > 0 and out["stderr"] > 0


@pytest.mark.parametrize("flags,match", [
    (["--control-variate", "--strikes", "95,100"], "--control-variate"),
    (["--antithetic", "--pilot-paths", "1040"], "multiple of 32"),
    (["--pilot-paths", "1000"], "multiple of 16"),
])
def test_cli_estimator_combinations_exit_2(capsys, flags, match):
    """What the CLI refuses: the control variate on a strip, and an
    explicit pilot that the kernels' path block (16, 32 paired) does not
    divide, with the reason, never rounded silently."""
    assert tcli.main(_RUN + flags) == 2
    assert match in capsys.readouterr().err


@pytest.mark.parametrize("flags", [["--strikes", "95,100"], ["--greeks"],
                                   ["--strikes", "95,100", "--greeks"]],
                         ids=["strikes", "greeks", "strikes+greeks"])
def test_cli_antithetic_strips_and_greeks_on_cpu(capsys, flags):
    """--antithetic with --strikes, --greeks and both (exit 2 before K5,
    K3 and K4 had pair forms) prices on the CPU, with the keys of the
    unpaired quote and a smaller stderr than it on the same seed."""
    outs = []
    for pair in ([], ["--antithetic"]):
        assert tcli.main(_RUN + flags + pair) == 0
        outs.append(json.loads(capsys.readouterr().out))
    plain, paired = outs
    assert set(paired) == set(plain)
    assert paired["kernel_family"] == "single"
    se = paired["stderrs"]
    se_plain = plain["stderrs"]
    if "--greeks" in flags:
        lane = "prices" if "--strikes" in flags else "price"
        se, se_plain = se[lane], se_plain[lane]
    assert np.all(np.asarray(se) < np.asarray(se_plain)), (se, se_plain)


def test_cli_path_count_rounds_as_jax(capsys):
    """The chunk rounds down to a multiple of 256, as the JAX CLI's does:
    --paths 1000 prices 768 paths in both (992 in the port before)."""
    from montecarlooptionspricer_tpu.cli import price as jcli

    flags = ["--strike", "102", "--put", "--maturity", "0.05", "--steps",
             "12", "--paths", "1000"]
    assert tcli.main(flags + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert jcli.main(flags + ["--pathgen", "xla"]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["n_paths"] == want["n_paths"] == 768


def test_cli_control_variate_greeks_are_the_plain_greeks(capsys):
    """--control-variate --greeks prints what --greeks prints (the JAX
    CLI's Greeks ignore the control too), timing aside."""
    outs = []
    for flags in (["--greeks"], ["--greeks", "--control-variate"]):
        assert tcli.main(_RUN + flags) == 0
        out = json.loads(capsys.readouterr().out)
        out.pop("elapsed_s")
        outs.append(out)
    assert outs[0] == outs[1]
