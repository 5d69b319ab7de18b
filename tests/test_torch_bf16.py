"""The bf16 fGN-input forms of K1/K2 and K6/K7 (``StreamConfig.
fgn_matmul_dtype="bfloat16"``) against the JAX package: the bf16 factor
bit for bit, the plain versions (which the wrappers run on CPU tensors)
against JAX's interpreted kernels with ``fgn_dtype=jnp.bfloat16`` on the
same numpy noise, the generic stream on JAX's own bf16 draws, the
engine's routing, and a seeded price beside the float32 one.  The kernels
themselves are held against these plain versions on the card in
test_torch_gpu.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlooptionspricer_tpu.models import engine as jengine
from montecarlooptionspricer_tpu.models import pathgen_pallas as jpp
from montecarlooptionspricer_tpu.models import pathgen_pallas_tiled as jtiled
from montecarlooptionspricer_tpu_torch.models import chain_cuda as cc
from montecarlooptionspricer_tpu_torch.models import engine as tengine
from montecarlooptionspricer_tpu_torch.models import greeks_cuda as gc
from montecarlooptionspricer_tpu_torch.models import pathgen_cuda as pc
from montecarlooptionspricer_tpu_torch.models import pathgen_stream as ps
from montecarlooptionspricer_tpu_torch.models import pathgen_tiled_cuda as ptc

from test_torch_bounds import jax_to_port_rows
from test_torch_pathgen import (DT, KW, jax_pilot_fits, port_noise,
                                shared_noise, to_port_fits)
from test_torch_stream import jax_noise
from test_torch_tiled import BENCH_MARKET

BF16 = "bfloat16"
ROWS, BLOCK = 256, 256
# Paths: the plain version and JAX's interpreted kernel take the same
# float32 product of the same bf16 values (summed in another order);
# 5.6e-7 apart at 96 steps.  The float32 form is ~1e-4 from JAX's bf16
# one, so this tolerance tells the two forms apart.
PATH_RTOL = 5e-6
SUM_RTOL = 1e-4


def consts(n_steps, fgn_dtype=BF16, market=KW):
    return pc.make_path_consts(market["s0"], market["xi"], market["h"],
                               market["eta"], market["r"], n_steps, DT,
                               "cpu", fgn_dtype=fgn_dtype)


def port_table(fits, strike, n_steps, is_call):
    return pc.log_boundary_rows(pc.boundary_rows(
        to_port_fits(fits), KW["r"], strike, n_steps * DT, DT, n_steps,
        is_call)).contiguous()


def jax_table(fits, strike, n_steps, is_call):
    return jpp.log_boundary_rows(jpp.boundary_rows(
        fits, KW["r"], strike, n_steps * DT, DT, n_steps, is_call))


@functools.lru_cache(maxsize=None)
def put_fits(n_steps):
    """JAX's LSM fit of the put at 102 on an interpreted float32 pilot."""
    rng = np.random.default_rng(5)
    _, fits = jax_pilot_fits(shared_noise(rng, 512, n_steps), 102.0,
                             n_steps * DT, False, n_steps=n_steps)
    return fits


def lanes(out, with_cv):
    return tuple(float(v) for v in (out if with_cv else (out,)))


def max_rel(got, want):
    return float(np.max(np.abs(got / want - 1.0)))


@pytest.mark.parametrize("n_steps,market", [(96, KW), (96, BENCH_MARKET),
                                            (365, BENCH_MARKET)],
                         ids=["96", "96-bench", "365-bench"])
def test_bf16_factor_is_jax_bit_for_bit(n_steps, market):
    """Lt' of the bf16 form equals JAX's padded bf16 matrix
    ``_fgn_consts(..., jnp.bfloat16, "chol")`` bit for bit, zero below the
    diagonal; the float32 form keeps float32."""
    c = consts(n_steps, market=market)
    s_pad = pc._round_up(n_steps, pc.LANE)
    mats, _ = jpp._fgn_consts(n_steps, s_pad, market["h"], market["eta"],
                              DT, jnp.bfloat16, "chol")
    want = np.asarray(mats[0])[:n_steps, :n_steps].view(np.uint16)
    assert c.lt_half.dtype == torch.bfloat16 and c.bf16
    got = c.lt_half.view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(got, want)
    assert consts(n_steps, "float32", market).lt_half.dtype == torch.float32


@pytest.mark.parametrize("antithetic", [False, True], ids=["plain", "anti"])
def test_k1_bf16_matches_jax(rng, antithetic):
    """Plain K1/bf16 (K1/bf16/anti) against JAX's interpreted chol kernel
    with bf16 matrices on the same noise, at rtol 5e-6 (paired rows mapped
    from JAX's in-block layout); the float32 form misses it by more than
    10x that, so the test holds the bf16 form and no other."""
    n = 96
    drawn = ROWS // 2 if antithetic else ROWS
    noise = shared_noise(rng, drawn, n)
    call, jconsts, _ = jpp._build(
        **KW, n_steps=n, dt=DT, chunk_paths=ROWS, block_paths=BLOCK,
        interpret=True, noise_input=True, fgn_dtype=jnp.bfloat16,
        fgn_form="chol", antithetic=antithetic)
    want = np.asarray(call(jnp.asarray(noise), *jconsts))[:, :n + 1]
    if antithetic:
        want = want[jax_to_port_rows(ROWS, BLOCK)]
    got = pc.pathgen(consts(n), noise=port_noise(noise, n),
                     antithetic=antithetic).numpy()
    f32 = pc.pathgen(consts(n, "float32"), noise=port_noise(noise, n),
                     antithetic=antithetic).numpy()
    assert got.shape == want.shape == (ROWS, n + 1)
    np.testing.assert_allclose(got, want, rtol=PATH_RTOL)
    assert max_rel(f32, want) > 10 * PATH_RTOL


@pytest.mark.parametrize("antithetic,with_cv",
                         [(False, False), (True, False), (False, True),
                          (True, True)],
                         ids=["plain", "anti", "cv", "anti+cv"])
def test_k2_bf16_forms_match_jax(rng, antithetic, with_cv):
    """Plain K2/bf16 in each form against ``make_pallas_priced_chunk(
    noise_input=True, fgn_dtype=jnp.bfloat16, fgn_form="chol",
    policy_form="boundary")`` in interpret mode under one JAX fit: both
    lanes at rtol 1e-4."""
    n, strike = 96, 102.0
    fits = put_fits(n)
    noise = shared_noise(rng, ROWS // 2 if antithetic else ROWS, n)
    chunk_sum, _ = jpp.make_pallas_priced_chunk(
        **KW, strike=strike, maturity=n * DT, dt=DT, n_steps=n,
        chunk_paths=ROWS, block_paths=BLOCK, is_call=False, interpret=True,
        noise_input=True, fgn_dtype=jnp.bfloat16, fgn_form="chol",
        policy_form="boundary", antithetic=antithetic, with_cv=with_cv)
    want = lanes(chunk_sum(jnp.asarray(noise),
                           jax_table(fits, strike, n, False)), with_cv)
    got = lanes(pc.priced_chunk(
        consts(n), port_table(fits, strike, n, False), strike, False,
        noise=port_noise(noise, n), antithetic=antithetic, with_cv=with_cv),
        with_cv)
    assert want[0] > 0
    np.testing.assert_allclose(got, want, rtol=SUM_RTOL)


def test_k6_k7_bf16_match_jax(rng):
    """Plain K6/bf16 and K6/bf16/anti against ``make_tiled_pathgen(
    fgn_dtype=jnp.bfloat16, fgn_form="chol")`` at 200 steps (two of JAX's
    step tiles) at rtol 5e-6, and K7/bf16 in its four forms against
    ``make_tiled_priced_chunk`` likewise at rtol 1e-4, on the same noise
    under one JAX fit."""
    n, strike = 200, 102.0
    c = consts(n)
    for antithetic in (False, True):
        noise = shared_noise(rng, ROWS // 2 if antithetic else ROWS, n)
        gen, _ = jtiled.make_tiled_pathgen(
            **KW, n_steps=n, dt=DT, chunk_paths=ROWS, block_paths=BLOCK,
            interpret=True, noise_input=True, fgn_dtype=jnp.bfloat16,
            fgn_form="chol", antithetic=antithetic)
        want = np.asarray(gen(jnp.asarray(noise)))
        if antithetic:
            want = want[jax_to_port_rows(ROWS, BLOCK)]
        got = ptc.tiled_pathgen(c, noise=port_noise(noise, n),
                                antithetic=antithetic).numpy()
        np.testing.assert_allclose(got, want, rtol=PATH_RTOL)
    fits = put_fits(n)
    for antithetic in (False, True):
        for with_cv in (False, True):
            noise = shared_noise(rng, ROWS // 2 if antithetic else ROWS, n)
            chunk_sum, _ = jtiled.make_tiled_priced_chunk(
                **KW, strike=strike, maturity=n * DT, dt=DT, n_steps=n,
                chunk_paths=ROWS, block_paths=BLOCK, is_call=False,
                interpret=True, noise_input=True, fgn_dtype=jnp.bfloat16,
                fgn_form="chol", policy_form="boundary",
                antithetic=antithetic, with_cv=with_cv)
            want = lanes(chunk_sum(jnp.asarray(noise),
                                   jax_table(fits, strike, n, False)),
                         with_cv)
            got = lanes(ptc.tiled_priced_chunk(
                c, port_table(fits, strike, n, False), strike, False,
                noise=port_noise(noise, n), antithetic=antithetic,
                with_cv=with_cv), with_cv)
            np.testing.assert_allclose(got, want, rtol=SUM_RTOL)


@pytest.mark.parametrize("antithetic", [False, True], ids=["plain", "anti"])
def test_stream_bf16_matches_jax_generator(antithetic):
    """The generic stream under bf16 on JAX's own draws (its normals drawn
    in bf16, so the stream's rounding leaves them as they are) against
    ``make_chunk_pathgen(fgn_dtype=jnp.bfloat16)`` elementwise at 1e-4,
    the float32 stream's tolerance; the FFT synthesis ignores the dtype."""
    n, rows = 96, 128
    drawn = rows // 2 if antithetic else rows
    key = jax.random.key(11)
    gen = jengine.make_chunk_pathgen(**KW, n_steps=n, dt=DT, chunk_paths=rows,
                                     fgn_dtype=jnp.bfloat16,
                                     antithetic=antithetic)
    want = np.asarray(gen(key))
    kz, _ = jax.random.split(key)
    z = np.asarray(jax.random.normal(kz, (2, drawn, n), jnp.bfloat16)
                   .astype(jnp.float32))
    _, dw = jax_noise(key, drawn, n)
    sc = ps.make_stream_consts(KW["s0"], KW["xi"], KW["h"], KW["eta"],
                               KW["r"], n, DT, "cpu", fgn_dtype=BF16)
    assert sc.bf16
    got = ps.paths_from_noise(sc, torch.tensor(z), torch.tensor(dw),
                              antithetic)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4)
    fft = ps.make_stream_consts(KW["s0"], KW["xi"], KW["h"], KW["eta"],
                                KW["r"], n, DT, "cpu", "fft",
                                fgn_dtype=BF16)
    assert not fft.bf16


def _cfg(n_steps, **kw):
    return tengine.StreamConfig(n_paths=1024, n_steps=n_steps,
                                chunk_paths=512, pilot_paths=512,
                                fgn_matmul_dtype=BF16, **kw)


@pytest.mark.parametrize("case", [
    dict(cfg=dict(n_steps=32, fgn_form="spectral"), family="single",
         forms=("bf16/spectral", "bf16/spectral")),
    dict(cfg=dict(n_steps=32, policy_form="quadratic"), family="single",
         forms=("bf16", "bf16/quad")),
    dict(cfg=dict(n_steps=400, policy_form="quadratic"), family="tiled",
         forms=("bf16", "bf16/quad")),
    dict(cfg=dict(n_steps=4000), family="factored", forms=("bf16", "bf16")),
    dict(cfg=dict(n_steps=1825, tiled_impl="factored"), family="factored",
         forms=("bf16", "bf16")),
    dict(cfg=dict(n_steps=32), strip=True),
    dict(cfg=dict(n_steps=32), greeks=True),
    dict(cfg=dict(n_steps=32), strip=True, greeks=True),
], ids=["spectral", "quadratic", "quadratic-slab", "factored-4000",
        "factored-1825", "k5-strip", "k3-greeks", "k4-strip-greeks"])
def test_bf16_routing_raises_b12(case):
    """Every kernel combination routes bf16 to its bf16 body: the family
    is the float32 one, the constants are bf16, and the family's path and
    priced wrappers count the form under "bf16/..." keys (no launch on the
    CPU, which runs the plain versions).  Nothing raises ROADMAP B12 any
    more: a strip on K5 pilots on K1/bf16 and has bf16 chain constants
    and K5's "bf16" key, the Greeks on K3 bf16 Lt' and dLt' and K3's
    "bf16" key, and a strip's Greeks (K4) the same with K4's key, each
    also under "bf16/anti"."""
    n = case["cfg"]["n_steps"]
    market = dict(**BENCH_MARKET, maturity=n * DT, is_call=False,
                  config=_cfg(**case["cfg"]), device="cpu")
    if case.get("strip") or case.get("greeks"):
        cls = (tengine.StreamingChainPricer if case.get("strip")
               else tengine.StreamingPricer)
        p = cls(**market, **({"strikes": [95.0, 105.0]} if case.get("strip")
                             else {"strike": 105.0}))
        assert p.kernel_family == "single" and p.consts.bf16
        assert "bf16" in p._pathgen.form_launches
        if case.get("strip"):
            assert p.chain_consts.bf16 and not p.chain_consts.spectral
        if case.get("greeks"):
            g = p.greeks_consts
            assert g.bf16 and g.dlt_half.dtype == torch.bfloat16
            assert p.consts.lt_half.dtype == torch.bfloat16
        wrapper = ((gc.chain_greeks_chunk if case.get("strip")
                    else gc.greeks_chunk) if case.get("greeks")
                   else cc.priced_chain)
        for anti in (False, True):
            assert pc.form_name(anti, bf16=True) in wrapper.form_launches
        return
    p = tengine.StreamingPricer(**market, strike=105.0)
    assert p.kernel_family == case["family"] and p.consts.bf16
    # K8/K9 are spectral by law and name no fGN form in their keys.
    spectral = (case["family"] != "factored"
                and case["cfg"].get("fgn_form") == "spectral")
    assert case["family"] == "factored" or p.consts.spectral == spectral
    path_form, priced_form = case["forms"]
    quadratic = case["cfg"].get("policy_form") == "quadratic"
    assert pc.form_name(False, False, spectral, quadratic,
                        True) == priced_form
    assert path_form in p._pathgen.form_launches
    assert priced_form in p._priced_chunk.form_launches


def test_bf16_routing():
    """bf16 keeps the float32 form's families (single to 365 steps, the
    chol slab past it), runs the generic stream under pathgen_impl="xla"
    and a quadratic policy there; strips run on K5/bf16 and the Greeks on
    K3/bf16 (no B12 raise any more), strips on the generic stream under
    pathgen_impl="xla"; an unknown dtype raises ValueError."""
    with pytest.raises(ValueError, match="fgn_matmul_dtype"):
        tengine.StreamConfig(n_paths=1024, n_steps=32,
                             fgn_matmul_dtype="float16")
    for n, family in ((32, "single"), (365, "single"), (366, "tiled"),
                      (3620, "tiled")):
        assert tengine.resolve_kernel_family(n) == family
    p = tengine.StreamingPricer(**BENCH_MARKET, strike=105.0,
                                maturity=32 * DT, is_call=False,
                                config=_cfg(32), device="cpu")
    assert p.kernel_family == "single" and p.consts.bf16
    assert p.greeks_consts.bf16
    greeks = p.price_and_greeks(0)
    assert len(greeks) == 6 and all(np.isfinite(greeks))
    s = tengine.StreamingPricer(
        **BENCH_MARKET, strike=105.0, maturity=32 * DT, is_call=False,
        config=_cfg(32, pathgen_impl="xla", policy_form="quadratic"),
        device="cpu")
    assert s.kernel_family == "stream" and s.consts.bf16
    strip = tengine.StreamingChainPricer(**BENCH_MARKET,
                                         strikes=[95.0, 105.0],
                                         maturity=32 * DT, is_call=False,
                                         config=_cfg(32), device="cpu")
    assert strip.kernel_family == "single" and strip.chain_consts.bf16
    chain = tengine.StreamingChainPricer(
        **BENCH_MARKET, strikes=[95.0, 105.0], maturity=32 * DT,
        is_call=False, config=_cfg(32, pathgen_impl="xla"), device="cpu")
    assert chain.kernel_family == "stream"


def test_bf16_price_within_mc_noise_of_float32():
    """A seeded price under bf16 lies within 0.05 of the float32 price of
    the same seed at 2^14 paths x 32 steps, the JAX package's own check
    (tests/test_engine.py:test_bf16_fgn_price_within_mc_stderr), and
    differs from it (the bf16 form ran)."""
    base = dict(n_paths=1 << 14, n_steps=32, chunk_paths=1 << 12,
                pilot_paths=1 << 11)
    market = dict(s0=100.0, xi=0.04, h=0.2, eta=1.0, rho=-0.4, r=0.04)
    prices = {}
    for dtype in ("float32", BF16):
        pricer = tengine.StreamingPricer(
            **market, strike=102.0, maturity=32 / 252.0, is_call=False,
            config=tengine.StreamConfig(**base, fgn_matmul_dtype=dtype),
            device="cpu")
        assert pricer.consts.bf16 == (dtype == BF16)
        prices[dtype] = pricer.price(5)
    assert abs(prices["float32"] - prices[BF16]) < 0.05
    assert prices["float32"] != prices[BF16]
