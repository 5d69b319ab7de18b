"""The bf16 fGN-input forms of K8/K9, of the spectral bodies of K1/K2 and
K6/K7, and of the quadratic bodies of K2/K7/K9 (``StreamConfig.
fgn_matmul_dtype="bfloat16"``) against the JAX package: F1, Cr' and Ci'
bit for bit, and the plain versions (which the wrappers run on CPU
tensors) against JAX's interpreted kernels with ``fgn_dtype=jnp.bfloat16``
on the same numpy noise, paths at rtol 5e-6 (which the float32 form
misses by more than 10x) and sums at 1e-4; then a seeded factored price
beside the float32 one.  The kernels themselves are held against these
plain versions on the card in test_torch_gpu.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlooptionspricer_tpu.models import pathgen_pallas as jpp
from montecarlooptionspricer_tpu.models import pathgen_pallas_factored as jf
from montecarlooptionspricer_tpu.models import pathgen_pallas_tiled as jtiled
from montecarlooptionspricer_tpu_torch.models import engine as tengine
from montecarlooptionspricer_tpu_torch.models import pathgen_cuda as pc
from montecarlooptionspricer_tpu_torch.models import (
    pathgen_factored_cuda as pfc)
from montecarlooptionspricer_tpu_torch.models import pathgen_tiled_cuda as ptc

from test_torch_bf16 import PATH_RTOL, SUM_RTOL, lanes, max_rel, put_fits
from test_torch_bounds import jax_to_port_rows
from test_torch_factored import factored_noise, xla_pilot_fits
from test_torch_pathgen import DT, KW
from test_torch_quadratic import noise_planes, port, quad_tables
from test_torch_spectral import log_tables, spectral_noise
from test_torch_tiled import BENCH_MARKET

BF16 = "bfloat16"
FORMS = [(False, False), (True, False), (False, True), (True, True)]
FORM_IDS = ["plain", "anti", "cv", "anti+cv"]
# The factored family at 200 steps: m2 256, N2 2, two step tiles.
F_STEPS, F_ROWS, F_BLOCK = 200, 128, 64


def factored_consts(n_steps, fgn_dtype=BF16, market=KW):
    return pfc.make_factored_consts(market["s0"], market["xi"], market["h"],
                                    market["eta"], market["r"], n_steps, DT,
                                    "cpu", fgn_dtype=fgn_dtype)


def path_consts(n_steps, fgn_form, fgn_dtype=BF16, market=KW):
    return pc.make_path_consts(market["s0"], market["xi"], market["h"],
                               market["eta"], market["r"], n_steps, DT,
                               "cpu", fgn_form=fgn_form, fgn_dtype=fgn_dtype)


def bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int16).numpy().view(np.uint16)


# ---------------------------------------------------------------------------
# The bf16 constants.

@pytest.mark.parametrize("n_steps", [96, 200, 365])
def test_bf16_constants_match_jax(n_steps):
    """Cr' and Ci' of the spectral bf16 form equal JAX's ``_fgn_consts(...,
    jnp.bfloat16, "spectral")`` bit for bit; past 128 steps so does the
    factored form's bf16 F1 wherever |F1| > 1e-6, and within 1e-13 at the
    exact zeros of the DFT matrix.  There JAX builds F1 with np.exp of the
    unreduced angle, leaving trig noise up to 8e-14, while the port
    reduces the angle exactly first (at most 1.8e-16 left); bf16 keeps
    both tiny exponents, so those entries' bits differ by design (750 and
    762 of the 16,384, numerically nothing).  phi', the twiddle and the
    stage-2 table stay float32, as in JAX."""
    market = BENCH_MARKET
    c = path_consts(n_steps, "spectral", market=market)
    s_pad = pc._round_up(n_steps, pc.LANE)
    mats, _ = jpp._fgn_consts(n_steps, s_pad, market["h"], market["eta"], DT,
                              jnp.bfloat16, "spectral")
    for got, want in zip((c.cr_half, c.ci_half), mats):
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            bits(got), np.asarray(want)[:n_steps, :n_steps].view(np.uint16))
    if n_steps <= pc.LANE:
        return
    fc = factored_consts(n_steps, market=market)
    jconsts = jf._consts(market["s0"], market["xi"], market["h"],
                         market["eta"], market["rho"], market["r"], n_steps,
                         DT, jnp.bfloat16)[3]
    for got, want in zip((fc.f1r, fc.f1i), jconsts[:2]):
        want = np.asarray(want)
        assert got.dtype == torch.bfloat16
        big = np.abs(want.astype(np.float32)) > 1e-6
        np.testing.assert_array_equal(bits(got)[big],
                                      want.view(np.uint16)[big])
        np.testing.assert_allclose(got.float().numpy()[~big],
                                   want.astype(np.float32)[~big], rtol=0,
                                   atol=1e-13)
    for t in (fc.phi_r, fc.phi_i, fc.tw_r, fc.tw_i, fc.c2, fc.s2, fc.vd):
        assert t.dtype == torch.float32
    assert factored_consts(n_steps, "float32").f1r.dtype == torch.float32


def test_bf16_blocks_fit_the_float32_blocks():
    """The bf16 forms keep the float32 forms' path blocks: in every form,
    fGN form and horizon a bf16 block takes no more shared memory than
    the float32 block (its planes and staged tiles are narrower), so the
    blocks ``max_block_paths`` and ``block_paths_for`` choose fit; the
    slab's spectral bf16 block of 128 paths still leaves room for two
    blocks an SM."""
    for n in (47, 96, 365):
        for spec in (False, True):
            for anti, choices in ((False, pc.BLOCK_CHOICES),
                                  (True, pc.PAIRED_BLOCK_CHOICES)):
                for bp in choices:
                    for cv in (False, True):
                        assert pc.range_smem_bytes(
                            n, bp, anti, cv, spec, bf16=True) <= \
                            pc.range_smem_bytes(n, bp, anti, cv, spec)
    for spec in (False, True):
        for bp in ptc.BLOCK_CHOICES:
            for cv in (False, True):
                assert ptc.smem_bytes(bp, False, cv, spec, bf16=True) <= \
                    ptc.smem_bytes(bp, False, cv, spec)
    assert 2 * ptc.smem_bytes(128, spectral=True, bf16=True) <= 228 * 1024


# ---------------------------------------------------------------------------
# K8 and K9.

@pytest.mark.parametrize("antithetic", [False, True], ids=["plain", "anti"])
def test_k8_bf16_matches_jax(rng, antithetic):
    """Plain K8/bf16 (the four-step split on bf16 a and F1) and
    K8/bf16/anti against ``make_factored_pathgen(fgn_dtype=jnp.bfloat16,
    interpret=True, noise_input=True)`` at 200 steps: rtol 5e-6, which
    the float32 form (the FFT) misses by more than 10x; pairs after the
    row map from JAX's in-block layout."""
    drawn = F_ROWS // 2 if antithetic else F_ROWS
    noise = factored_noise(rng, drawn, F_STEPS)
    gen, _ = jf.make_factored_pathgen(
        **KW, n_steps=F_STEPS, dt=DT, chunk_paths=F_ROWS,
        block_paths=F_BLOCK, interpret=True, noise_input=True,
        fgn_dtype=jnp.bfloat16, antithetic=antithetic)
    want = np.asarray(gen(jnp.asarray(noise)))
    if antithetic:
        want = want[jax_to_port_rows(F_ROWS, F_BLOCK)]
    z = torch.from_numpy(noise)
    got = pfc.factored_pathgen(factored_consts(F_STEPS), noise=z,
                               antithetic=antithetic).numpy()
    f32 = pfc.factored_pathgen(factored_consts(F_STEPS, "float32"), noise=z,
                               antithetic=antithetic).numpy()
    assert got.shape == want.shape == (F_ROWS, F_STEPS + 1)
    np.testing.assert_allclose(got, want, rtol=PATH_RTOL)
    assert max_rel(f32, want) > 10 * PATH_RTOL


@pytest.mark.parametrize("antithetic,with_cv,policy_form", [
    *((a, c, "boundary") for a, c in FORMS), (False, False, "quadratic"),
    (False, True, "quadratic")],
    ids=[*FORM_IDS, "quad", "quad+cv"])
def test_k9_bf16_forms_match_jax(rng, antithetic, with_cv, policy_form):
    """Plain K9/bf16 in each of its six forms against
    ``make_factored_priced_chunk(fgn_dtype=jnp.bfloat16,
    policy_form=...)`` in interpret mode at 200 steps under one JAX fit,
    noise x1.5 so paths exercise: both lanes at rtol 1e-4."""
    strike, is_call = 97.0, False
    quadratic = policy_form == "quadratic"
    if quadratic:
        jrows, table = quad_tables(strike, is_call, F_STEPS)
    else:
        jrows, table = log_tables(xla_pilot_fits(F_STEPS, strike, is_call),
                                  strike, is_call, F_STEPS)
    noise = 1.5 * factored_noise(
        rng, F_ROWS // 2 if antithetic else F_ROWS, F_STEPS, w_pad=0.0)
    chunk_sum, _ = jf.make_factored_priced_chunk(
        **KW, strike=strike, maturity=F_STEPS * DT, dt=DT, n_steps=F_STEPS,
        chunk_paths=F_ROWS, block_paths=F_BLOCK, is_call=is_call,
        interpret=True, noise_input=True, fgn_dtype=jnp.bfloat16,
        policy_form=policy_form, antithetic=antithetic, with_cv=with_cv)
    want = lanes(chunk_sum(jnp.asarray(noise), jrows), with_cv)
    got = lanes(pfc.factored_priced_chunk(
        factored_consts(F_STEPS), table, strike, is_call,
        noise=torch.from_numpy(noise), antithetic=antithetic,
        with_cv=with_cv, policy_form=policy_form), with_cv)
    assert want[0] > 0
    np.testing.assert_allclose(got, want, rtol=SUM_RTOL)


# ---------------------------------------------------------------------------
# The spectral bodies of K1/K2 and K6/K7.

def test_k1_k2_spectral_bf16_match_jax(rng):
    """Plain K1/bf16/spectral and its pair against ``pathgen_pallas._build(
    fgn_form="spectral", fgn_dtype=jnp.bfloat16)`` at 96 steps (paths rtol
    5e-6, which the float32 spectral form misses by more than 10x), and
    K2/bf16/spectral in its four forms against ``make_pallas_priced_chunk``
    likewise (sums rtol 1e-4) under one JAX fit."""
    n, rows, block, strike = 96, 128, 128, 102.0
    c, c32 = path_consts(n, "spectral"), path_consts(n, "spectral", "float32")
    for antithetic in (False, True):
        noise = spectral_noise(rng, rows // 2 if antithetic else rows, n)
        call, jconsts, _ = jpp._build(
            **KW, n_steps=n, dt=DT, chunk_paths=rows, block_paths=block,
            interpret=True, noise_input=True, fgn_dtype=jnp.bfloat16,
            fgn_form="spectral", antithetic=antithetic)
        want = np.asarray(call(jnp.asarray(noise), *jconsts))[:, :n + 1]
        if antithetic:
            want = want[jax_to_port_rows(rows, block)]
        got = pc.pathgen(c, noise=port(noise, n),
                         antithetic=antithetic).numpy()
        f32 = pc.pathgen(c32, noise=port(noise, n),
                         antithetic=antithetic).numpy()
        np.testing.assert_allclose(got, want, rtol=PATH_RTOL)
        assert max_rel(f32, want) > 10 * PATH_RTOL
    fits = put_fits(n)
    jrows, table = log_tables(fits, strike, False, n)
    for antithetic, with_cv in FORMS:
        noise = spectral_noise(rng, rows // 2 if antithetic else rows, n)
        chunk_sum, _ = jpp.make_pallas_priced_chunk(
            **KW, strike=strike, maturity=n * DT, dt=DT, n_steps=n,
            chunk_paths=rows, block_paths=block, is_call=False,
            interpret=True, noise_input=True, fgn_dtype=jnp.bfloat16,
            fgn_form="spectral", policy_form="boundary",
            antithetic=antithetic, with_cv=with_cv)
        want = lanes(chunk_sum(jnp.asarray(noise), jrows), with_cv)
        got = lanes(pc.priced_chunk(c, table, strike, False,
                                    noise=port(noise, n),
                                    antithetic=antithetic, with_cv=with_cv),
                    with_cv)
        assert want[0] > 0
        np.testing.assert_allclose(got, want, rtol=SUM_RTOL)


def test_k6_k7_spectral_bf16_match_jax(rng):
    """Plain K6/bf16/spectral and its pair against ``make_tiled_pathgen(
    fgn_form="spectral", fgn_dtype=jnp.bfloat16)`` at 200 steps (two of
    JAX's slab tiles, the dense product reaching back across them): paths
    rtol 5e-6; K7/bf16/spectral in its four forms against
    ``make_tiled_priced_chunk`` likewise at rtol 1e-4."""
    n, rows, block, strike = F_STEPS, 128, 128, 102.0
    c = path_consts(n, "spectral")
    for antithetic in (False, True):
        noise = spectral_noise(rng, rows // 2 if antithetic else rows, n)
        gen, _ = jtiled.make_tiled_pathgen(
            **KW, n_steps=n, dt=DT, chunk_paths=rows, block_paths=block,
            interpret=True, noise_input=True, fgn_dtype=jnp.bfloat16,
            fgn_form="spectral", antithetic=antithetic)
        want = np.asarray(gen(jnp.asarray(noise)))
        if antithetic:
            want = want[jax_to_port_rows(rows, block)]
        got = ptc.tiled_pathgen(c, noise=port(noise, n),
                                antithetic=antithetic).numpy()
        np.testing.assert_allclose(got, want, rtol=PATH_RTOL)
    jrows, table = log_tables(put_fits(n), strike, False, n)
    for antithetic, with_cv in FORMS:
        noise = spectral_noise(rng, rows // 2 if antithetic else rows, n)
        chunk_sum, _ = jtiled.make_tiled_priced_chunk(
            **KW, strike=strike, maturity=n * DT, dt=DT, n_steps=n,
            chunk_paths=rows, block_paths=block, is_call=False,
            interpret=True, noise_input=True, fgn_dtype=jnp.bfloat16,
            fgn_form="spectral", policy_form="boundary",
            antithetic=antithetic, with_cv=with_cv)
        want = lanes(chunk_sum(jnp.asarray(noise), jrows), with_cv)
        got = lanes(ptc.tiled_priced_chunk(
            c, table, strike, False, noise=port(noise, n),
            antithetic=antithetic, with_cv=with_cv), with_cv)
        assert want[0] > 0
        np.testing.assert_allclose(got, want, rtol=SUM_RTOL)


# ---------------------------------------------------------------------------
# The quadratic bodies of K2 and K7.

@pytest.mark.parametrize("fgn_form", ["chol", "spectral"])
def test_k2_k7_quadratic_bf16_match_jax(rng, fgn_form):
    """Plain K2/bf16/quad[/cv] at 64 steps and K7/bf16/quad[/cv] at 150
    (two JAX tiles) in ``fgn_form`` against ``make_pallas_priced_chunk``
    and ``make_tiled_priced_chunk`` with ``policy_form="quadratic",
    fgn_dtype=jnp.bfloat16`` under JAX's fit, noise x1.5: rtol 1e-4."""
    strike, is_call = 102.0, False
    for n, rows, make, priced in (
            (64, 256, jpp.make_pallas_priced_chunk, pc.priced_chunk),
            (150, 128, jtiled.make_tiled_priced_chunk,
             ptc.tiled_priced_chunk)):
        jrows, table = quad_tables(strike, is_call, n)
        c = path_consts(n, fgn_form)
        for with_cv in (False, True):
            noise = noise_planes(rng, fgn_form, rows, n)
            chunk_sum, _ = make(
                **KW, strike=strike, maturity=n * DT, dt=DT, n_steps=n,
                chunk_paths=rows, block_paths=128, is_call=is_call,
                interpret=True, noise_input=True, fgn_dtype=jnp.bfloat16,
                fgn_form=fgn_form, policy_form="quadratic", with_cv=with_cv)
            want = lanes(chunk_sum(jnp.asarray(noise), jrows), with_cv)
            got = lanes(priced(c, table, strike, is_call,
                               noise=port(noise, n), with_cv=with_cv,
                               policy_form="quadratic"), with_cv)
            assert want[0] > 0
            np.testing.assert_allclose(got, want, rtol=SUM_RTOL)


# ---------------------------------------------------------------------------
# A seeded price on the factored family.

def test_factored_bf16_price_within_mc_noise_of_float32():
    """A seeded price at 400 steps on the factored family
    (``tiled_impl="factored"``: the K8 pilot, K9 per chunk) under bf16 lies
    within 0.05 of the float32 price of the same seed, the JAX package's
    own check (tests/test_engine.py:test_bf16_fgn_price_within_mc_stderr),
    and differs from it (the bf16 form ran)."""
    base = dict(n_paths=1 << 12, n_steps=400, chunk_paths=1 << 11,
                pilot_paths=1 << 11, tiled_impl="factored")
    prices = {}
    for dtype in ("float32", BF16):
        pricer = tengine.StreamingPricer(
            **BENCH_MARKET, strike=105.0, maturity=400 * DT, is_call=False,
            config=tengine.StreamConfig(**base, fgn_matmul_dtype=dtype),
            device="cpu")
        assert pricer.kernel_family == "factored"
        assert pricer.consts.bf16 == (dtype == BF16)
        prices[dtype] = pricer.price(3)
    assert abs(prices["float32"] - prices[BF16]) < 0.05
    assert prices["float32"] != prices[BF16]
