"""The quadratic exercise-policy forms of the port (``policy_form=
"quadratic"`` on K2, K7 and K9, ``chain_policy_form="quadratic"`` on K5)
against the JAX package: ``policy_rows`` against JAX's, the plain versions
of the four kernels in that form (which their wrappers run on CPU tensors)
against JAX's interpreted kernels with ``policy_form="quadratic"`` on the
same numpy noise, the plain versions against ``lsm_policy_value`` on the
same whole paths, and the engine on the CPU: prices beside the boundary
form's on one seed, the pairing rule, the Greeks' refusal and unknown
names.  The kernels themselves are held against these plain versions on
the card in test_torch_gpu.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlooptionspricer_tpu.models import pathgen_pallas as jpp
from montecarlooptionspricer_tpu.models import pathgen_pallas_factored as jf
from montecarlooptionspricer_tpu.models import pathgen_pallas_tiled as jtiled
from montecarlooptionspricer_tpu_torch.models import chain_cuda as cc
from montecarlooptionspricer_tpu_torch.models import engine as tengine
from montecarlooptionspricer_tpu_torch.models import greeks_cuda as tgc
from montecarlooptionspricer_tpu_torch.models import pathgen_cuda as pc
from montecarlooptionspricer_tpu_torch.models import (
    pathgen_factored_cuda as pfc)
from montecarlooptionspricer_tpu_torch.models import pathgen_tiled_cuda as ptc
from montecarlooptionspricer_tpu_torch.models.lsm import ITM_EPS, lsm_fit
from montecarlooptionspricer_tpu_torch.ops.payoff import payoff
from montecarlooptionspricer_tpu_torch.ops.regression import eval_poly
from montecarlooptionspricer_tpu_torch.ops.timegrid import step_mask

from test_torch_chain import STRIP3, STRIP13, to_port_strip_fits
from test_torch_factored import factored_noise, xla_pilot_fits
from test_torch_pathgen import DT, KW, to_port_fits
from test_torch_spectral import BENCH_MARKET

FGN_FORMS = ["chol", "spectral"]
CV = [False, True]
CV_IDS = ["plain", "cv"]


def noise_planes(rng, fgn_form, rows, n_steps, scale=1.5):
    """[2 or 3, rows, s_pad] float32 numpy noise (N, W or Zr, Zi, W),
    zero past n_steps, times ``scale`` so that paths exercise."""
    planes = 3 if fgn_form == "spectral" else 2
    noise = np.zeros((planes, rows, pc._round_up(n_steps, pc.LANE)),
                     np.float32)
    noise[:, :, :n_steps] = scale * rng.normal(size=(planes, rows, n_steps))
    return noise


def port(noise, n_steps):
    return torch.from_numpy(np.ascontiguousarray(noise[:, :, :n_steps]))


def path_consts(fgn_form, n_steps):
    return pc.make_path_consts(KW["s0"], KW["xi"], KW["h"], KW["eta"],
                               KW["r"], n_steps, DT, "cpu",
                               fgn_form=fgn_form)


def quad_tables(strike, is_call, n_steps, maturity=None):
    """JAX's and the port's policy_rows of JAX's fit on an XLA pilot."""
    maturity = n_steps * DT if maturity is None else maturity
    fits = xla_pilot_fits(n_steps, strike, is_call)
    jrows = jpp.policy_rows(fits, KW["r"], strike, maturity, DT, n_steps,
                            is_call)
    table = pc.policy_rows(to_port_fits(fits), KW["r"], strike, maturity, DT,
                           n_steps, is_call).contiguous()
    return jrows, table


def lanes(out, with_cv):
    return tuple(float(v) for v in (out if with_cv else (out,)))


# ---------------------------------------------------------------------------
# The policy table.

@pytest.mark.parametrize("strip", [False, True], ids=["single", "strip"])
def test_policy_rows_match_jax(strip):
    """``policy_rows`` against JAX's elementwise (1e-6 relative), for one
    strike and for a [K] strip (``jax.vmap`` of JAX's), at a maturity
    shorter than the grid: the dead columns and the pad carry eps 1e30,
    the terminal column eps -1 and c0 -1e30."""
    n_steps, is_call, maturity = 40, False, 33 * DT
    if strip:
        strikes = STRIP3
        fits = jax.vmap(lambda k: xla_pilot_fits(n_steps, 100.0, is_call))(
            jnp.asarray(strikes))
        want = jax.vmap(lambda f, k: jpp.policy_rows(
            f, KW["r"], k, maturity, DT, n_steps, is_call))(
                fits, jnp.asarray(strikes, jnp.float32))
        got = pc.policy_rows(to_port_strip_fits(fits), KW["r"],
                             torch.tensor(strikes), maturity, DT, n_steps,
                             is_call)
    else:
        fits = xla_pilot_fits(n_steps, 100.0, is_call)
        want = jpp.policy_rows(fits, KW["r"], 100.0, maturity, DT, n_steps,
                               is_call)
        got = pc.policy_rows(to_port_fits(fits), KW["r"], 100.0, maturity,
                             DT, n_steps, is_call)
    want = np.asarray(want)
    assert got.shape == want.shape == (*((3,) if strip else ()), 8, 128)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    eps = got[..., 5, :].numpy()
    assert np.all(eps[..., 33:n_steps - 1] == 1e30)
    assert np.all(eps[..., n_steps:] == 1e30)
    assert np.all(eps[..., n_steps - 1] == -1.0)
    assert np.all(got[..., 0, n_steps - 1].numpy() == -1e30)


# ---------------------------------------------------------------------------
# Each plain version against JAX's interpreted kernel.

@pytest.mark.parametrize("with_cv", CV, ids=CV_IDS)
@pytest.mark.parametrize("fgn_form", FGN_FORMS)
def test_k2_quadratic_matches_jax(rng, fgn_form, with_cv):
    """Plain K2 in the quadratic form against ``make_pallas_priced_chunk(
    policy_form="quadratic")`` at 64 steps x 512 rows, noise x1.5 so paths
    exercise: sums rtol 1e-4 (another float32 order of the products and
    the log-price sum; a decision can flip only inside the root band)."""
    n_steps, rows, strike, is_call = 64, 512, 102.0, False
    jrows, table = quad_tables(strike, is_call, n_steps)
    noise = noise_planes(rng, fgn_form, rows, n_steps)
    chunk_sum, _ = jpp.make_pallas_priced_chunk(
        **KW, strike=strike, maturity=n_steps * DT, dt=DT, n_steps=n_steps,
        chunk_paths=rows, block_paths=256, is_call=is_call, interpret=True,
        noise_input=True, fgn_form=fgn_form, policy_form="quadratic",
        with_cv=with_cv)
    want = lanes(chunk_sum(jnp.asarray(noise), jrows), with_cv)
    consts = path_consts(fgn_form, n_steps)
    got = lanes(pc.priced_chunk(consts, table, strike, is_call,
                                noise=port(noise, n_steps), with_cv=with_cv,
                                policy_form="quadratic"), with_cv)
    assert want[0] > 0
    np.testing.assert_allclose(got, want, rtol=1e-4)
    # Many paths stop before the terminal column, which always exercises.
    s = torch.exp(pc._log_paths_ref(consts, port(noise, n_steps)))
    _, first, _ = pc.quadratic_stops(s, table, is_call)
    assert float((first < n_steps - 1).float().mean()) > 0.3


@pytest.mark.parametrize("late", [False, True], ids=["fitted", "tile2"])
@pytest.mark.parametrize("with_cv", CV, ids=CV_IDS)
@pytest.mark.parametrize("fgn_form", FGN_FORMS)
def test_k7_quadratic_matches_jax(rng, fgn_form, with_cv, late):
    """Plain K7 in the quadratic form against ``make_tiled_priced_chunk(
    policy_form="quadratic")`` at 150 steps (two JAX tiles of 128): rtol
    1e-4.  ``tile2`` closes the first tile (eps 1e30 in both tables), so
    every first hit falls in the second tile, where JAX carries "already
    exercised" across tiles in its scratch."""
    n_steps, rows, strike, is_call = 150, 256, 100.0, False
    jrows, table = quad_tables(strike, is_call, n_steps)
    if late:
        jrows = jrows.at[5, :128].set(1e30)
        table[5, :128] = 1e30
    noise = noise_planes(rng, fgn_form, rows, n_steps)
    chunk_sum, _ = jtiled.make_tiled_priced_chunk(
        **KW, strike=strike, maturity=n_steps * DT, dt=DT, n_steps=n_steps,
        chunk_paths=rows, block_paths=128, is_call=is_call, interpret=True,
        noise_input=True, fgn_form=fgn_form, policy_form="quadratic",
        with_cv=with_cv)
    want = lanes(chunk_sum(jnp.asarray(noise), jrows), with_cv)
    consts = path_consts(fgn_form, n_steps)
    got = lanes(ptc.tiled_priced_chunk(consts, table, strike, is_call,
                                       noise=port(noise, n_steps),
                                       with_cv=with_cv,
                                       policy_form="quadratic"), with_cv)
    assert want[0] > 0
    np.testing.assert_allclose(got, want, rtol=1e-4)
    if late:
        # The stops, on the plain version's paths: all past the first tile.
        s = torch.exp(pc._log_paths_ref(consts, port(noise, n_steps)))
        hit, first, _ = pc.quadratic_stops(s, table, is_call)
        assert bool(hit.all()) and int(first.min()) >= 128


@pytest.mark.parametrize("with_cv", CV, ids=CV_IDS)
def test_k9_quadratic_matches_jax(rng, with_cv):
    """Plain K9 in the quadratic form against ``make_factored_priced_chunk(
    policy_form="quadratic")`` at the sizes of the boundary form's test
    (200 steps, 128 rows, noise x1.5): rtol 5e-4, JAX's own tolerance for
    the factored DFT."""
    n_steps, rows, strike, is_call = 200, 128, 97.0, False
    jrows, table = quad_tables(strike, is_call, n_steps)
    noise = 1.5 * factored_noise(rng, rows, n_steps, w_pad=0.0)
    chunk_sum, _ = jf.make_factored_priced_chunk(
        **KW, strike=strike, maturity=n_steps * DT, dt=DT, n_steps=n_steps,
        chunk_paths=rows, block_paths=64, is_call=is_call, interpret=True,
        noise_input=True, policy_form="quadratic", with_cv=with_cv)
    want = lanes(chunk_sum(jnp.asarray(noise), jrows), with_cv)
    consts = pfc.make_factored_consts(KW["s0"], KW["xi"], KW["h"], KW["eta"],
                                      KW["r"], n_steps, DT, "cpu")
    got = lanes(pfc.factored_priced_chunk(
        consts, table, strike, is_call, noise=torch.from_numpy(noise),
        with_cv=with_cv, policy_form="quadratic"), with_cv)
    assert want[0] > 0
    np.testing.assert_allclose(got, want, rtol=5e-4)


def jax_strip_policy(n_steps, strikes, is_call):
    """``jax.vmap`` of JAX's lsm_fit over the strip on an XLA pilot (the
    port's copy of the fits), and the strip's policy_rows tables."""
    from montecarlooptionspricer_tpu.models import engine as jengine
    from montecarlooptionspricer_tpu.models.lsm import lsm_fit as jlsm_fit

    mat = n_steps * DT
    pilot = jengine.make_chunk_pathgen(
        KW["s0"], KW["xi"], KW["h"], KW["eta"], KW["rho"], KW["r"], n_steps,
        DT, 1 << 11)(jax.random.key(0))
    ks = jnp.asarray(strikes, jnp.float32)
    fits = jax.vmap(lambda k: jlsm_fit(pilot, KW["r"], k, mat, DT, is_call,
                                       2)[1])(ks)
    tables = jax.vmap(lambda f, k: jpp.policy_rows(
        f, KW["r"], k, mat, DT, n_steps, is_call))(fits, ks)
    return to_port_strip_fits(fits), tables


@pytest.mark.parametrize("strikes", [STRIP3, STRIP13], ids=["k3", "k13"])
@pytest.mark.parametrize("fgn_form", FGN_FORMS)
def test_k5_quadratic_matches_jax_and_lsm(rng, fgn_form, strikes):
    """Plain K5 in the quadratic form against ``make_pallas_priced_chain(
    policy_form="quadratic")`` on the same noise and tables (13 strikes:
    JAX's two regenerated groups): rtol 1e-4, atol 1e-3 of the largest;
    and against ``lsm_policy_value`` per strike on the same whole paths,
    rtol 2e-4 as tests/test_chain.py holds JAX's (no strike of the strip
    exercises at time 0, which the engine decides apart)."""
    n_steps, rows, is_call = 48, 256, False
    fits, jtab = jax_strip_policy(n_steps, strikes, is_call)
    noise = noise_planes(rng, fgn_form, rows, n_steps, scale=1.0)
    chain, _ = jpp.make_pallas_priced_chain(
        **KW, strikes=strikes, maturity=n_steps * DT, dt=DT,
        n_steps=n_steps, chunk_paths=rows, block_paths=128, is_call=is_call,
        interpret=True, noise_input=True, fgn_form=fgn_form,
        policy_form="quadratic")
    want = np.asarray(chain(jnp.asarray(noise), jtab))
    consts = path_consts(fgn_form, n_steps)
    got = cc.priced_chain(consts, torch.tensor(np.asarray(jtab)), is_call,
                          noise=port(noise, n_steps),
                          policy_form="quadratic")
    assert got.shape == (len(strikes),) and want.max() > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-3 * want.max())

    paths = pc.pathgen_from_noise_ref(consts, port(noise, n_steps))
    ex0, _ = pc.time0_value(fits, KW["s0"], torch.tensor(strikes), is_call)
    assert not bool(ex0.any())
    lsm = [float(tengine.lsm_policy_value(
        paths, tengine.PolyFit(*(f[k] for f in fits)), KW["r"], strike,
        n_steps * DT, DT, is_call)[0]) for k, strike in enumerate(strikes)]
    np.testing.assert_allclose(got.numpy(), lsm, rtol=2e-4,
                               atol=1e-3 * want.max())


# ---------------------------------------------------------------------------
# The plain versions against lsm_policy_value on whole paths.

def test_quadratic_equals_lsm_policy_where_the_boundary_form_differs():
    """On the bench market at 63 steps, put 105, under the fits of a
    256-path pilot whose continuations are concave at some steps (ROADMAP
    C, "one exercise interval per step": the boundary form keeps one
    interval of such a step's two, and here prices 0.26 % off), the
    quadratic plain version (K2's and K5's decision) and
    ``lsm_policy_value`` on the same whole paths agree to 1e-5, and every
    path whose stop differs stops inside the float32 root band
    (|p - cont| within 1e-5 of their scale, in float64): none outside
    it.  The boundary form differs by more than 1e-4 on the same paths."""
    n_steps, rows, strike, is_call = 63, 1 << 13, 105.0, False
    maturity = n_steps * DT
    mkt = {k: v for k, v in BENCH_MARKET.items() if k != "rho"}
    consts = pc.make_path_consts(**mkt, n_steps=n_steps, dt=DT,
                                 device="cpu")
    pilot = pc.pathgen(consts, rows=256, key=pc._fold_words(1, 1))
    _, fits = lsm_fit(pilot, mkt["r"], strike, maturity, DT, is_call, 2)
    ex0, _ = pc.time0_value(fits, mkt["s0"], strike, is_call)
    assert not bool(ex0)
    ls = pc._log_paths_ref(consts, pc.philox_normals_ref(
        pc._fold_words(1, 2), rows, n_steps))
    paths = pc.prices_from_log(ls, mkt["s0"])
    lsm = tengine.lsm_policy_path_values(paths, fits, mkt["r"], strike,
                                         maturity, DT, is_call)
    table = pc.policy_rows(fits, mkt["r"], strike, maturity, DT, n_steps,
                           is_call)
    quad = {"K2": pc.priced_sums(consts, ls, table, strike, is_call, False,
                                 "quadratic"),
            "K5": pc.quadratic_first_hit_sum(paths[:, 1:], table, is_call,
                                             recip=True)}
    want = float(torch.sum(lsm))
    for got in quad.values():
        assert abs(float(got) / want - 1.0) <= 1e-5
    boundary = pc.priced_sums(consts, ls, pc.log_boundary_rows(
        pc.boundary_rows(fits, mkt["r"], strike, maturity, DT, n_steps,
                         is_call)), strike, is_call, False)
    assert abs(float(boundary) / want - 1.0) > 1e-4

    # Stops: lsm_policy_path_values' decision on the whole paths, and its
    # margin p - cont in float64 at each step 1..n-1 (the kernels' column
    # c is step c + 1; the terminal column always exercises).
    pay = payoff(is_call, paths, strike)
    ex = ((pay[:, :-1] > ITM_EPS) & (pay[:, :-1] >= eval_poly(
        fits, paths[:, :-1])) & step_mask(n_steps, DT, maturity))
    ex = torch.cat([ex, torch.ones((rows, 1), dtype=torch.bool)], 1)
    lsm_col = ex[:, 1:].to(torch.int8).argmax(dim=1)
    s64 = paths[:, 1:-1].double()
    p = torch.clamp_min(strike - s64, 0.0)
    z = (s64 - fits.mu[1:].double()) / fits.sd[1:].double()
    c = fits.coeffs[1:].double()
    cont = (c[:, 2] * z + c[:, 1]) * z + c[:, 0]
    margin = (p - cont).abs() / torch.clamp_min(
        torch.maximum(p.abs(), cont.abs()), 1e-6)
    for recip in (False, True):
        _, first, _ = pc.quadratic_stops(paths[:, 1:], table, is_call, recip)
        flipped = torch.nonzero(first != lsm_col)[:, 0]
        for i in flipped.tolist():
            col = min(int(first[i]), int(lsm_col[i]))
            assert col < n_steps - 1 and float(margin[i, col]) <= 1e-5, i


# ---------------------------------------------------------------------------
# The engine on the CPU.

# JAX's test_fused_log_boundary_policy_matches_quadratic_on_chip: its market,
# its strike and its bound on the two forms' prices on one seed.
QUAD_MARKET = dict(s0=100.0, xi=0.04, h=0.2, eta=1.0, rho=-0.4, r=0.04)
QUAD_STRIKE = 102.0
ROOT_BAND_PRICE = 0.02


def record_policy(monkeypatch, owner, attr):
    """Wrap the priced kernel ``owner.attr`` to record the policy form
    each call asks for."""
    seen = []
    wrapped = getattr(owner, attr)

    def spy(*args, **kw):
        seen.append(kw.get("policy_form", "boundary"))
        return wrapped(*args, **kw)

    monkeypatch.setattr(owner, attr, spy)
    return seen


@pytest.mark.parametrize("n_steps,cfg,family", [
    (48, {}, "single"), (400, {}, "tiled"),
    (400, {"tiled_impl": "factored"}, "factored")],
    ids=["single", "tiled", "factored"])
def test_pricer_quadratic_prices_beside_boundary(monkeypatch, n_steps, cfg,
                                                 family):
    """``StreamingPricer(policy_form="quadratic")`` prices on each kernel
    family (K2, K7, K9 plain versions here), plain and with the control
    variate, under the fits of one pilot (the CV fit's policy for the
    plain runs): each call of the family's priced kernel asks for the
    quadratic form, and each price lies within JAX's root-band bound
    (0.02) of the boundary form's on the same seed and paths."""
    base = dict(n_paths=4 * 512, n_steps=n_steps, chunk_paths=512,
                pilot_paths=1024, dt=DT, **cfg)
    cv_fit = None
    for cv in (True, False):
        prices = {}
        for form in pc.POLICY_FORMS:
            pricer = tengine.StreamingPricer(
                **QUAD_MARKET, strike=QUAD_STRIKE, maturity=n_steps * DT,
                is_call=False, device="cpu",
                config=tengine.StreamConfig(**base, control_variate=cv,
                                            policy_form=form))
            assert pricer.kernel_family == family
            if cv_fit is None:
                cv_fit = pricer.fit(tengine._pilot_stream_keys(7)[0])
            seen = record_policy(monkeypatch, pricer, "_priced_chunk")
            prices[form] = pricer.price_with_fit(
                cv_fit if cv else cv_fit.fits, 7)
            assert seen == [form] * 4
        assert 0 < prices["quadratic"] < QUAD_STRIKE
        assert abs(prices["quadratic"] - prices["boundary"]) \
            < ROOT_BAND_PRICE, (cv, prices)


@pytest.mark.parametrize("n_steps,cfg,family", [
    (64, {}, "single"), (400, {"fgn_form": "spectral"}, "factored")],
    ids=["k1", "k8_pilot"])
def test_chain_quadratic_prices_beside_boundary(monkeypatch, n_steps, cfg,
                                                family):
    """``StreamingChainPricer(chain_policy_form="quadratic")`` prices a
    strip on K5 (its plain version here) at 64 steps and past 365 on the
    K8 pilot (K5 in the spectral form, at a reduced depth): K5 is asked
    for the quadratic form on the strip's policy_rows tables, and each
    strike lies within JAX's root-band bound of the boundary strip's
    price on the same seed."""
    strikes = [95.0, QUAD_STRIKE, 108.0]
    base = dict(n_paths=2 * 512, n_steps=n_steps, chunk_paths=512,
                pilot_paths=1024, dt=DT, **cfg)
    prices = {}
    for form in pc.POLICY_FORMS:
        chain = tengine.StreamingChainPricer(
            **QUAD_MARKET, strikes=strikes, maturity=n_steps * DT,
            is_call=False, device="cpu",
            config=tengine.StreamConfig(**base, chain_policy_form=form))
        assert chain.kernel_family == family
        if form == "boundary":
            fits = chain.fit(tengine._pilot_stream_keys(5)[0])
        seen = record_policy(monkeypatch, cc, "priced_chain")
        prices[form] = chain.price_with_fit(fits, 5)
        monkeypatch.undo()
        assert seen == [form] * 2
        if form == "quadratic":
            tables = chain._tables(fits, chain.strikes)
            assert tables.shape[1] == 8 and bool(
                (tables[:, 5, n_steps - 1] == -1.0).all())
    assert np.all(np.diff(prices["quadratic"]) > 0)
    np.testing.assert_allclose(prices["quadratic"], prices["boundary"],
                               rtol=0, atol=ROOT_BAND_PRICE)


@pytest.mark.parametrize("strip", [False, True], ids=["single", "strip"])
def test_pairs_with_quadratic_policy(strip):
    """JAX's pairing rule (``_anti_ok``): antithetic with a quadratic
    policy raises ValueError on a kernel family (no kernel pairs it) and
    prices on the generic stream (``pathgen_impl="xla"``), which pairs
    whole paths; the port used to refuse it there too."""
    kw = dict(n_paths=2 * 256, n_steps=32, chunk_paths=256, pilot_paths=256,
              dt=DT, antithetic=True)
    field = "chain_policy_form" if strip else "policy_form"
    kw[field] = "quadratic"

    def make(**extra):
        config = tengine.StreamConfig(**kw, **extra)
        if strip:
            return tengine.StreamingChainPricer(
                **QUAD_MARKET, strikes=[98.0, QUAD_STRIKE],
                maturity=32 * DT, is_call=False, config=config, device="cpu")
        return tengine.StreamingPricer(
            **QUAD_MARKET, strike=QUAD_STRIKE, maturity=32 * DT,
            is_call=False, config=config, device="cpu")

    with pytest.raises(ValueError, match=f"{field}='quadratic'"):
        make()
    pricer = make(pathgen_impl="xla")
    assert pricer.kernel_family == "stream"
    price, se = pricer.price(3, with_stderr=True)
    assert np.all(np.asarray(price) > 0) and np.all(np.asarray(se) > 0)


@pytest.mark.parametrize("strip", [False, True], ids=["single", "strip"])
def test_quadratic_greeks_raise_a10(monkeypatch, strip):
    """JAX's fused Greeks take the boundary policy only; under the
    quadratic one it runs the jvp stream, and so does the port (both
    pricers raised naming ROADMAP A10 before it was ported): finite
    Greeks, a put's delta below 0 and vega_xi above, the price lane within
    5 combined stderr of ``price``, and K3/K4 never called."""
    field = "chain_policy_form" if strip else "policy_form"
    config = tengine.StreamConfig(n_paths=512, n_steps=32, chunk_paths=256,
                                  pilot_paths=256, dt=DT,
                                  **{field: "quadratic"})
    if strip:
        pricer = tengine.StreamingChainPricer(
            **QUAD_MARKET, strikes=[98.0, QUAD_STRIKE], maturity=32 * DT,
            is_call=False, config=config, device="cpu")
    else:
        pricer = tengine.StreamingPricer(
            **QUAD_MARKET, strike=QUAD_STRIKE, maturity=32 * DT,
            is_call=False, config=config, device="cpu")
    def refuse(*args, **kwargs):
        raise AssertionError("K3/K4 ran under the quadratic policy")

    monkeypatch.setattr(tgc, "greeks_chunk", refuse)
    monkeypatch.setattr(tgc, "chain_greeks_chunk", refuse)
    g, se = pricer.price_and_greeks(0, with_stderr=True)
    price, p_se = pricer.price(0, with_stderr=True)
    g, se = np.asarray(g).reshape(6, -1), np.asarray(se).reshape(6, -1)
    price, p_se = np.atleast_1d(price), np.atleast_1d(p_se)
    assert np.all(np.isfinite(g)) and np.all(g[1] < 0) and np.all(g[2] > 0)
    assert np.all(np.abs(g[0] - price) < 5 * np.hypot(se[0], p_se))


def test_unknown_policy_names_raise():
    """Unknown policy names are refused where they enter: StreamConfig's
    two fields, as JAX's ``__post_init__`` refuses them, and the kernel
    wrappers' ``policy_form``; the wrappers also refuse pairs under the
    quadratic policy and a boundary-shaped table for it."""
    for field in ("policy_form", "chain_policy_form"):
        with pytest.raises(ValueError, match=f"unknown {field}"):
            tengine.StreamConfig(n_paths=256, n_steps=8, **{field: "cubic"})
    consts = path_consts("chol", 16)
    table = torch.zeros(8, 128)
    noise = torch.zeros(2, 32, 16)
    for wrapper in (pc.priced_chunk, ptc.tiled_priced_chunk):
        with pytest.raises(ValueError, match="policy_form must be one of"):
            wrapper(consts, table, 100.0, False, noise=noise,
                    policy_form="log_boundary")
        with pytest.raises(ValueError, match="no pair form"):
            wrapper(consts, table, 100.0, False, noise=noise[:, :16],
                    antithetic=True, policy_form="quadratic")
        with pytest.raises(ValueError, match="policy_rows"):
            wrapper(consts, table[:3], 100.0, False, noise=noise,
                    policy_form="quadratic")
    with pytest.raises(ValueError, match="no pair form"):
        cc.priced_chain(consts, table[None], False, noise=noise[:, :16],
                        antithetic=True, policy_form="quadratic")
    with pytest.raises(ValueError, match="policy_rows"):
        cc.priced_chain(consts, table[None, :4], False, noise=noise,
                        policy_form="quadratic")
