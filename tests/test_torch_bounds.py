"""The port's streamed duality bounds (``price_with_bounds``, the CLI's
``--bounds``) against the JAX package: the dual functions
(``fit_hedge_deltas``, ``_hedge_martingale``, ``dual_upper_values``,
``fit_dual_scale``) on one numpy pilot; the whole-path pair forms of K1, K6
and K8 (their plain versions, which the wrappers run on CPU tensors)
against JAX's interpreted pair kernels on the same noise; a chunk's lower
and upper sums on injected noise under shared fits, for every family,
plain and paired; the GBM-limit bracket around the binomial value; the
rough-Bergomi bracket; seeds and stderrs; the lower side against
``price``; and the CLI.  The kernels themselves are held against these
plain versions on the card in test_torch_gpu.py."""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlooptionspricer_tpu.models import closed_form as jclosed
from montecarlooptionspricer_tpu.models import engine as jengine
from montecarlooptionspricer_tpu.models import pathgen_pallas as jpp
from montecarlooptionspricer_tpu.models import pathgen_pallas_factored as jf
from montecarlooptionspricer_tpu.models import pathgen_pallas_tiled as jtiled
from montecarlooptionspricer_tpu.models.lsm import lsm_fit as jlsm_fit
from montecarlooptionspricer_tpu.ops.regression import eval_poly as jeval
from montecarlooptionspricer_tpu_torch.cli import price as tcli
from montecarlooptionspricer_tpu_torch.models import closed_form as tclosed
from montecarlooptionspricer_tpu_torch.models import engine as tengine
from montecarlooptionspricer_tpu_torch.models import pathgen_cuda as pc
from montecarlooptionspricer_tpu_torch.models import (
    pathgen_factored_cuda as pfc)
from montecarlooptionspricer_tpu_torch.models import pathgen_stream as ps
from montecarlooptionspricer_tpu_torch.models import pathgen_tiled_cuda as ptc
from montecarlooptionspricer_tpu_torch.ops import regression as treg

from test_torch_factored import consts_cpu as factored_consts
from test_torch_factored import factored_noise
from test_torch_pathgen import DT, KW, port_noise, shared_noise, to_port_fits
from test_torch_stream import jax_noise

R = KW["r"]


def path_consts(n_steps):
    return pc.make_path_consts(KW["s0"], KW["xi"], KW["h"], KW["eta"], R,
                               n_steps, DT, "cpu")


def numpy_pilot(n_steps, rows=4096, seed=5, scale=1.0):
    """[rows, n_steps + 1] float32 numpy paths: the plain K1 version on
    numpy noise (the dual functions compare on given paths, whoever
    made them)."""
    rng = np.random.default_rng(seed)
    noise = torch.from_numpy(
        (scale * rng.normal(size=(2, rows, n_steps))).astype(np.float32))
    return pc.pathgen_from_noise_ref(path_consts(n_steps), noise).numpy()


def jax_dual_fit(paths, strike, is_call, deltas_scale=1.0):
    """JAX's LSM fit, hedge fits (coefficients times ``deltas_scale``)
    and dual scale on numpy ``paths``: (fits, deltas, lam)."""
    n_steps = paths.shape[1] - 1
    maturity = n_steps * DT
    jp = jnp.asarray(paths)
    _, fits = jlsm_fit(jp, R, strike, maturity, DT, is_call, 2)
    deltas = jengine.fit_hedge_deltas(jp, fits, R, strike, maturity, DT,
                                      is_call)
    deltas = deltas._replace(coeffs=deltas.coeffs * deltas_scale)
    lam = jengine.fit_dual_scale(jp, deltas, R, strike, maturity, DT,
                                 is_call)
    return fits, deltas, float(lam)


OPTIONS = [(False, 105.0), (True, 97.0)]
OPTION_IDS = ["put105", "call97"]


# ---------------------------------------------------------------------------
# The dual functions on one pilot.

@pytest.mark.parametrize("n_steps", [32, 96])
@pytest.mark.parametrize("is_call,strike", OPTIONS, ids=OPTION_IDS)
def test_fit_hedge_deltas_matches_jax(n_steps, is_call, strike):
    """The quartic value-to-go fits of a 4096-path pilot under JAX's
    policy: the fitted values at every step's pilot prices within 1e-4 of
    the payoff scale (the strike).  Coefficients are not compared: the
    port sums the quartic Gram from power sums, JAX as a matmul, in
    another float32 order, and the quartic design amplifies that."""
    paths = numpy_pilot(n_steps)
    maturity = n_steps * DT
    _, fits = jlsm_fit(jnp.asarray(paths), R, strike, maturity, DT, is_call,
                       2)
    want = jengine.fit_hedge_deltas(jnp.asarray(paths), fits, R, strike,
                                    maturity, DT, is_call)
    got = tengine.fit_hedge_deltas(torch.from_numpy(paths), to_port_fits(fits),
                                   R, strike, maturity, DT, is_call)
    assert got.coeffs.shape == (n_steps, tengine.HEDGE_POLY_ORDER + 1)
    s = paths[:, :n_steps]
    want_v = np.asarray(jeval(want, jnp.asarray(s)))
    got_v = tengine.eval_poly(got, torch.from_numpy(s)).numpy()
    np.testing.assert_allclose(got_v, want_v, rtol=0, atol=1e-4 * strike)


@pytest.mark.parametrize("n_steps", [32, 96])
@pytest.mark.parametrize("is_call,strike", OPTIONS, ids=OPTION_IDS)
def test_martingale_and_dual_values_match_jax(n_steps, is_call, strike):
    """Under JAX's deltas and scale: the hedge martingale [n, m] and the
    dual upper values [n] at 1e-5 relative (floored at 1e-5 of each
    array's largest magnitude, for the martingale's near-zero cells)."""
    paths = numpy_pilot(n_steps)
    maturity = n_steps * DT
    _, deltas, lam = jax_dual_fit(paths, strike, is_call)
    tp, td = torch.from_numpy(paths), to_port_fits(deltas)
    want_m = np.asarray(jengine._hedge_martingale(
        jnp.asarray(paths), deltas, R, strike, DT, is_call))
    got_m = tengine._hedge_martingale(tp, td, R, strike, DT, is_call).numpy()
    assert np.abs(want_m).max() > 0.1
    np.testing.assert_allclose(got_m, want_m, rtol=1e-5,
                               atol=1e-5 * np.abs(want_m).max())
    want_u = np.asarray(jengine.dual_upper_values(
        jnp.asarray(paths), deltas, lam, R, strike, maturity, DT, is_call))
    got_u = tengine.dual_upper_values(tp, td, lam, R, strike, maturity, DT,
                                      is_call).numpy()
    np.testing.assert_allclose(got_u, want_u, rtol=1e-5,
                               atol=1e-5 * np.abs(want_u).max())


@pytest.mark.parametrize("n_steps,deltas_scale", [
    (32, 1.0), (96, 1.0),
    # Deltas a quarter of the fitted ones: the best scale lies past 2, so
    # JAX itself takes the extended [2, 10] grid.
    (96, 0.25)])
def test_fit_dual_scale_matches_jax(n_steps, deltas_scale):
    """Under JAX's deltas: the port's lam within one fine-grid step of
    JAX's (0.005, or 0.01 on the extended grid), and the pilot's dual
    objective at the port's lam within 1e-5 relative of JAX's objective at
    its own (both evaluated by JAX's dual_upper_values)."""
    strike, is_call = 105.0, False
    paths = numpy_pilot(n_steps)
    maturity = n_steps * DT
    _, deltas, lam_j = jax_dual_fit(paths, strike, is_call, deltas_scale)
    extended = deltas_scale != 1.0
    assert (lam_j > 2.0) == extended
    lam_t = tengine.fit_dual_scale(torch.from_numpy(paths),
                                   to_port_fits(deltas), R, strike, maturity, DT,
                                   is_call)
    assert lam_t.dim() == 0
    lam_t = float(lam_t)
    step = 0.01 if extended else 0.005
    assert abs(lam_t - lam_j) <= step * (1 + 1e-6)

    def obj(lam):
        return float(jnp.mean(jengine.dual_upper_values(
            jnp.asarray(paths), deltas, lam, R, strike, maturity, DT,
            is_call)))

    assert abs(obj(lam_t) / obj(lam_j) - 1.0) <= 1e-5


def _rowwise(fit):
    """A batch of per-row fits, broadcast against [rows, n] arguments."""
    return treg.PolyFit(fit.coeffs[:, None, :], fit.mu[:, None],
                        fit.sd[:, None])


@pytest.mark.parametrize("order", [2, 4])
def test_power_sum_fit_matches_masked_fit(order):
    """``fit_poly_columns`` (the Gram from power sums, a batch of
    columns) against ``fit_poly_masked`` with every weight 1 (the Gram as
    an outer product): the fitted values within 1e-4 of the targets'
    scale, a constant column included (a pure intercept)."""
    rng = np.random.default_rng(3)
    x = 100.0 * np.exp(0.2 * rng.normal(size=(5, 2048)))
    x[0] = 100.0
    y = np.maximum(105.0 - x, 0.0) + rng.normal(size=x.shape)
    x, y = (torch.from_numpy(v.astype(np.float32)) for v in (x, y))
    got = treg.fit_poly_columns(x, y, order)
    want = treg.fit_poly_masked(x, y, torch.ones_like(x), order)
    np.testing.assert_allclose(
        treg.eval_poly(_rowwise(got), x).numpy(),
        treg.eval_poly(_rowwise(want), x).numpy(), rtol=0,
        atol=1e-4 * float(y.abs().max()))


def test_hedge_fit_groups_do_not_change_it(monkeypatch):
    """The hedge fit in groups of three steps equals it in one group up
    to the float32 order of the column sums (fitted values within 1e-5 of
    the strike): each step's fit reads its own columns only."""
    paths = torch.from_numpy(numpy_pilot(32, rows=512))
    _, fits = tengine.lsm_fit(paths, R, 105.0, 32 * DT, DT, False)
    args = (R, 105.0, 32 * DT, DT, False)
    whole = tengine.fit_hedge_deltas(paths, fits, *args)
    monkeypatch.setattr(tengine, "_HEDGE_FIT_FLOATS", 3 * 512)
    grouped = tengine.fit_hedge_deltas(paths, fits, *args)
    s = paths[:, :32]
    torch.testing.assert_close(tengine.eval_poly(grouped, s),
                               tengine.eval_poly(whole, s), rtol=0,
                               atol=1e-5 * 105.0)


# ---------------------------------------------------------------------------
# The whole-path pair forms against JAX's interpreted pair kernels.

def jax_to_port_rows(rows: int, block: int) -> np.ndarray:
    """JAX's row of each port row: JAX lays a pair out inside each block
    (block / 2 drawn rows, then their partners), the port as [X; -X]
    (drawn rows [0, rows / 2), partners [rows / 2, rows))."""
    half = block // 2
    q = np.arange(rows // 2)
    drawn = (q // half) * block + q % half
    return np.concatenate([drawn, drawn + half])


@pytest.mark.parametrize("family", ["single", "tiled", "factored"])
def test_path_pair_forms_match_jax(rng, family):
    """Plain K1/anti, K6/anti and K8/anti against
    ``make_pallas_pathgen_from_noise(fgn_form="chol", antithetic=True)``,
    ``make_tiled_pathgen(noise_input=True, antithetic=True,
    fgn_form="chol")`` and ``make_factored_pathgen(noise_input=True,
    antithetic=True)`` in interpret mode on the same noise, after the row
    mapping: rtol 2e-4 (5e-4 for K8's four-step DFT), the unpaired
    kernels' tolerances.  Each equals the unpaired plain version on the
    concatenated [X; -X] noise, and seeded, on the stream's first rows /
    2 rows."""
    if family == "factored":
        n_steps, rows, block, rtol = 200, 128, 64, 5e-4
        noise = factored_noise(rng, rows // 2, n_steps)
        gen, _ = jf.make_factored_pathgen(
            **KW, n_steps=n_steps, dt=DT, chunk_paths=rows,
            block_paths=block, interpret=True, noise_input=True,
            antithetic=True)
        consts, port_in = factored_consts(n_steps), torch.from_numpy(noise)
        wrapper, normals = pfc.factored_pathgen, \
            pfc.philox_factored_normals_ref
    else:
        n_steps, rows, block, rtol = {"single": (96, 512, 256, 2e-4),
                                      "tiled": (300, 512, 256, 2e-4)}[family]
        noise = shared_noise(rng, rows // 2, n_steps)
        if family == "single":
            gen, _ = jpp.make_pallas_pathgen_from_noise(
                **KW, n_steps=n_steps, dt=DT, chunk_paths=rows,
                block_paths=block, interpret=True, fgn_form="chol",
                antithetic=True)
            wrapper = pc.pathgen
        else:
            gen, _ = jtiled.make_tiled_pathgen(
                **KW, n_steps=n_steps, dt=DT, chunk_paths=rows,
                block_paths=block, interpret=True, noise_input=True,
                fgn_form="chol", antithetic=True)
            wrapper = ptc.tiled_pathgen
        consts, port_in = path_consts(n_steps), port_noise(noise, n_steps)
        normals = pc.philox_normals_ref
    want = np.asarray(gen(jnp.asarray(noise)))[jax_to_port_rows(rows,
                                                                  block)]
    got = wrapper(consts, noise=port_in, antithetic=True)
    assert got.shape == (rows, n_steps + 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol)
    both = torch.cat([port_in, -port_in], dim=1)
    torch.testing.assert_close(got, wrapper(consts, noise=both), rtol=0,
                               atol=0)
    key = pc._fold_words(9, 5)
    torch.testing.assert_close(
        wrapper(consts, rows=rows, key=key, antithetic=True),
        wrapper(consts, noise=normals(key, rows // 2, n_steps),
                antithetic=True), rtol=0, atol=0)


def test_pair_forms_memory_model():
    """K8/anti keeps K8's shared memory, so it takes K8's whole range (one
    drawn path, two members, a block at 8,192 steps); K6/anti's blocks
    hold at most 64 drawn rows, which ``mcop_tiled_smem_bytes`` takes."""
    assert pfc.supports(8192) and pfc.paths_per_block(8192) == 1
    assert pfc.smem_bytes(8192) <= pc.SMEM_LIMIT
    for rows in (1 << 17, 96, 64, 32):
        bp = ptc.block_paths_for(rows, antithetic=True)
        assert bp in ptc.PAIRED_BLOCK_CHOICES and bp // 2 <= 64
        assert ptc.smem_bytes(bp, antithetic=True) <= pc.SMEM_LIMIT
    assert pc.path_block_paths(path_consts(365), 1 << 17, True) == 128


# ---------------------------------------------------------------------------
# A chunk's lower and upper sums under shared fits.

def _family_case(family, antithetic, rng):
    """(n_steps, chunk, StreamConfig fields, JAX generator of one chunk's
    paths from its numpy noise, the chunks' numpy noise, the port's noise
    argument)."""
    chunks = 2
    if family == "stream":
        n_steps, chunk = 96, 256
        drawn = chunk // 2 if antithetic else chunk
        gen = jengine.make_chunk_pathgen(**KW, n_steps=n_steps, dt=DT,
                                         chunk_paths=chunk,
                                         antithetic=antithetic)
        keys = [jax.random.key(20 + i) for i in range(chunks)]
        planes = [jax_noise(k, drawn, n_steps) for k in keys]
        port = (torch.tensor(np.stack([z for z, _ in planes])),
                torch.tensor(np.stack([dw for _, dw in planes])))
        return (n_steps, chunk, {"pathgen_impl": "xla"},
                [np.asarray(gen(k)) for k in keys], port)
    if family == "factored":
        n_steps, chunk, block = 400, 128, 64
        drawn = chunk // 2 if antithetic else chunk
        noise = [factored_noise(rng, drawn, n_steps, w_pad=0.0)
                 for _ in range(chunks)]
        gen, _ = jf.make_factored_pathgen(
            **KW, n_steps=n_steps, dt=DT, chunk_paths=chunk,
            block_paths=block, interpret=True, noise_input=True,
            antithetic=antithetic)
        return (n_steps, chunk, {"tiled_impl": "factored"},
                [np.asarray(gen(jnp.asarray(v))) for v in noise],
                torch.from_numpy(np.stack(noise)))
    n_steps, chunk = {"single": (96, 512), "tiled": (400, 512)}[family]
    drawn = chunk // 2 if antithetic else chunk
    noise = [shared_noise(rng, drawn, n_steps) for _ in range(chunks)]
    if family == "single":
        gen, _ = jpp.make_pallas_pathgen_from_noise(
            **KW, n_steps=n_steps, dt=DT, chunk_paths=chunk, block_paths=256,
            interpret=True, fgn_form="chol", antithetic=antithetic)
    else:
        gen, _ = jtiled.make_tiled_pathgen(
            **KW, n_steps=n_steps, dt=DT, chunk_paths=chunk, block_paths=256,
            interpret=True, noise_input=True, fgn_form="chol",
            antithetic=antithetic)
    return (n_steps, chunk, {},
            [np.asarray(gen(jnp.asarray(v))) for v in noise],
            torch.stack([port_noise(v, n_steps) for v in noise]))


@pytest.mark.parametrize("antithetic", [False, True], ids=["plain", "anti"])
@pytest.mark.parametrize("family", ["single", "tiled", "factored", "stream"])
def test_chunk_bounds_match_jax(rng, family, antithetic):
    """One JAX pilot -> JAX's (fits, deltas, lam) -> the port's
    ``bounds_with_fit`` on each chunk's injected noise, against JAX's
    ``lsm_policy_value`` and ``dual_upper_values`` summed over its own
    kernel's (or generator's) paths of the same noise: both bounds at
    1e-5 relative (float32 sums in another order; the shared policy's
    decisions flip only inside the root band)."""
    strike, is_call = 103.0, False
    n_steps, chunk, fields, jax_paths, noise = _family_case(
        family, antithetic, rng)
    maturity = n_steps * DT
    fits, deltas, lam = jax_dual_fit(jax_paths[0], strike, is_call)
    n = chunk * len(jax_paths)
    want_lo = sum(float(jengine.lsm_policy_value(
        jnp.asarray(p), fits, R, strike, maturity, DT, is_call)[0])
        for p in jax_paths) / n
    want_up = sum(float(jnp.sum(jengine.dual_upper_values(
        jnp.asarray(p), deltas, lam, R, strike, maturity, DT, is_call)))
        for p in jax_paths) / n
    cfg = tengine.StreamConfig(n_paths=n, n_steps=n_steps, chunk_paths=chunk,
                               pilot_paths=chunk, dt=DT, chunks_per_call=1,
                               antithetic=antithetic, **fields)
    pricer = tengine.StreamingPricer(**KW, strike=strike, maturity=maturity,
                                     is_call=is_call, config=cfg,
                                     device="cpu")
    assert pricer.kernel_family == family
    fit = (to_port_fits(fits), to_port_fits(deltas), torch.tensor(lam),
           torch.zeros(2))
    lo, up = pricer.bounds_with_fit(fit, noise=noise)
    assert 0 < want_lo < want_up
    np.testing.assert_allclose([lo, up], [want_lo, want_up], rtol=1e-5)


# ---------------------------------------------------------------------------
# The slice as a whole.

def test_binomial_american_matches_jax():
    """The port's copy of the binomial oracle: equal to JAX's to 1e-10."""
    for args in [(100.0, 105.0, 0.04, 0.25, 0.25, False),
                 (100.0, 95.0, 0.04, 0.3, 1.0, True),
                 (90.0, 100.0, 0.01, 0.2, 0.5, False)]:
        want = jclosed.binomial_american(*args, steps=500)
        assert abs(tclosed.binomial_american(*args, steps=500) - want) \
            <= 1e-10 * want


def gbm_pricer(antithetic=False):
    """The GBM limit of JAX's test_price_with_bounds_brackets_binomial_on_gbm
    (h = 0.5, eta = 1e-6, xi = sigma^2), on the port's kernels."""
    s0, strike, r, sigma, t = 100.0, 105.0, 0.04, 0.25, 0.25
    cfg = tengine.StreamConfig(n_paths=1 << 15, n_steps=63,
                               chunk_paths=1 << 13, pilot_paths=1 << 13,
                               dt=t / 63, antithetic=antithetic)
    return tengine.StreamingPricer(s0, sigma * sigma, 0.5, 1e-6, -0.3, r,
                                   strike, t, False, cfg, device="cpu")


@pytest.mark.parametrize("antithetic", [False, True], ids=["plain", "anti"])
def test_gbm_bracket_holds_the_binomial_value(antithetic):
    """As JAX's test: the bracket holds the binomial American value (0.05,
    ~3 stderr at 32k paths, of slack) and its gap stays under 8 %; the
    same seed gives the same bracket."""
    p = gbm_pricer(antithetic)
    lo, up = p.price_with_bounds(0)
    amer = tclosed.binomial_american(100.0, 105.0, 0.04, 0.25, 0.25, False,
                                     steps=1000)
    assert lo - 0.05 <= amer <= up + 0.05, (lo, amer, up)
    assert up - lo < 0.08 * amer
    assert p.price_with_bounds(0) == (lo, up)


RB = dict(s0=100.0, xi=0.04, h=0.2, eta=1.0, rho=-0.4, r=0.04, strike=102.0,
          maturity=32 / 252.0, is_call=False)


def rb_pricer(antithetic=False, n_paths=1 << 14, chunk_paths=1 << 12):
    """The rough-Bergomi case of JAX's test_price_with_bounds_rbergomi_and_
    mesh, single device."""
    cfg = tengine.StreamConfig(n_paths=n_paths, n_steps=32,
                               chunk_paths=chunk_paths, pilot_paths=1 << 12,
                               antithetic=antithetic)
    return tengine.StreamingPricer(**RB, config=cfg, device="cpu")


def test_rbergomi_bracket():
    lo, up = rb_pricer().price_with_bounds(1)
    assert np.isfinite(lo) and np.isfinite(up) and lo < up
    assert up - lo < 0.15 * lo


def test_seeds_and_stderrs():
    """A seed repeats its bracket and stderrs; another seed moves them;
    the stderrs are finite and positive, and on one seed the paired upper
    bound's stderr is at most the plain one's (32 chunks, so each stderr
    is itself known to ~13 %)."""
    kw = dict(n_paths=1 << 15, chunk_paths=1 << 10)
    plain, paired = rb_pricer(**kw), rb_pricer(antithetic=True, **kw)
    out = plain.price_with_bounds(1, with_stderr=True)
    assert plain.price_with_bounds(1, with_stderr=True) == out
    assert plain.price_with_bounds(2, with_stderr=True)[:2] != out[:2]
    lo, up, lo_se, up_se = out
    assert all(math.isfinite(v) and v > 0 for v in out)
    assert lo_se < 0.05 * lo and up_se < 0.05 * up
    anti = paired.price_with_bounds(1, with_stderr=True)
    assert all(math.isfinite(v) and v > 0 for v in anti)
    assert anti[3] <= up_se


@pytest.mark.parametrize("antithetic,policy_form,rtol", [
    (False, "boundary", 1e-4), (True, "boundary", 1e-4),
    (False, "quadratic", 1e-5)], ids=["plain", "anti", "quadratic"])
def test_lower_bound_equals_price_on_the_same_seed(antithetic, policy_form,
                                                   rtol):
    """At 365 steps on the bench market, the lower bound (the policy's
    S-space decisions on K1's whole paths, paired on K1/anti) and
    ``price`` (K2's log-space intervals on the same chunks and pairs,
    under the fits of the same pilot) agree within 1e-4 relative.  Under
    ``policy_form="quadratic"`` ``price`` takes K2's quadratic form, the
    lower bound's own policy on the same paths: within 1e-5."""
    cfg = tengine.StreamConfig(n_paths=1 << 13, n_steps=365,
                               chunk_paths=1 << 12, pilot_paths=1 << 12,
                               antithetic=antithetic, policy_form=policy_form)
    p = tengine.StreamingPricer(100.0, 0.04, 0.1, 1.5, -0.4, 0.04, 105.0,
                                365 / 252, False, cfg, device="cpu")
    lo, up = p.price_with_bounds(42)
    price = p.price(42)
    assert lo < up
    assert abs(lo / price - 1.0) <= rtol


def test_bounds_refusals():
    """JAX's refusal: bounds under the control variate (ValueError); under
    qmc (refused naming ROADMAP A12 before it was ported) the bracket
    streams whole QMC paths from the generic stream, as JAX's ride its
    XLA generator, and holds the price; with no card, a pricer for the
    card raises instead of running elsewhere."""
    cfg = tengine.StreamConfig(n_paths=512, n_steps=16, chunk_paths=256,
                               pilot_paths=256, control_variate=True)
    p = tengine.StreamingPricer(**RB, config=cfg, device="cpu")
    with pytest.raises(ValueError, match="control_variate"):
        p.price_with_bounds(0)
    q = tengine.StreamingPricer(**RB, config=tengine.StreamConfig(
        n_paths=512, n_steps=16, chunk_paths=256, pilot_paths=256,
        qmc=True), device="cpu")
    assert q.kernel_family == "single" and q.stream_consts.qmc
    lo, up = q.price_with_bounds(0)
    assert lo < up and abs(lo / q.price(0) - 1.0) < 0.02
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA"):
            tengine.StreamingPricer(**RB, config=tengine.StreamConfig(
                n_paths=512, n_steps=16, chunk_paths=256, pilot_paths=256),
                device="cuda")


# ---------------------------------------------------------------------------
# The CLI.

_RUN = ["--strike", "102", "--put", "--maturity", "0.12", "--steps", "24",
        "--paths", "4096", "--chunk-paths", "2048", "--device", "cpu"]


@pytest.mark.parametrize("pathgen", ["pallas", "xla"])
@pytest.mark.parametrize("antithetic", [False, True], ids=["plain", "anti"])
def test_cli_bounds_prints_jax_fields(capsys, antithetic, pathgen):
    """--bounds prints the JAX CLI's fields, with and without
    --antithetic, on the kernels and on the generic stream: the price is
    the lower bound and the gap is upper - lower."""
    flags = ["--bounds", "--pathgen", pathgen] + (
        ["--antithetic"] if antithetic else [])
    assert tcli.main(_RUN + flags) == 0
    out = json.loads(capsys.readouterr().out)
    assert set(out) == {"price", "lower", "upper", "duality_gap",
                        "lower_stderr", "upper_stderr", "n_paths", "n_steps",
                        "is_call", "kernel_family", "elapsed_s"}
    assert out["kernel_family"] == ("single" if pathgen == "pallas"
                                    else "stream")
    assert out["price"] == out["lower"] < out["upper"]
    assert abs(out["duality_gap"] - (out["upper"] - out["lower"])) <= 2e-6
    assert out["lower_stderr"] > 0 and out["upper_stderr"] > 0


@pytest.mark.parametrize("flags", [["--strikes", "95,100"], ["--greeks"],
                                   ["--control-variate"]])
def test_cli_bounds_combinations_exit_2(capsys, flags):
    """Where the JAX CLI exits 2: --bounds with --strikes, --greeks or
    --control-variate."""
    assert tcli.main(_RUN + ["--bounds"] + flags) == 2
    assert "--bounds" in capsys.readouterr().err
