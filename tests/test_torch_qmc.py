"""Randomized QMC in the port (``ops/qmc.py``, the stream's QMC branch, the
fused QMC noise, the pricers' QMC routes, ``generate_paths_qmc[_
bucketed]``, the pipeline's and the CLIs' ``--qmc``) against the JAX
package: the Sobol base and the PCA map bit for bit, the digital shift bit
for bit on JAX's own ``jax.random.bits``, the normals within 2e-6, the
fused noise and the paths elementwise on JAX's key splits reproduced and
injected, and the seeded pricers in distribution.  Everything runs on the
CPU, where the kernel wrappers take their plain versions."""

import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlooptionspricer_tpu.config import (
    MarketDefaults as JMarket, PipelineConfig as JPipe,
    PricingConfig as JPricing)
from montecarlooptionspricer_tpu.models import engine as jengine
from montecarlooptionspricer_tpu.models import rough_volatility as jrv
from montecarlooptionspricer_tpu.ops import qmc as jqmc
from montecarlooptionspricer_tpu.pipeline.driver import (
    run_pipeline as jrun_pipeline)
from montecarlooptionspricer_tpu_torch.cli import price as tprice_cli
from montecarlooptionspricer_tpu_torch.cli import (
    prediction_gen as tpg_cli)
from montecarlooptionspricer_tpu_torch.config import (
    MarketDefaults, PipelineConfig, PricingConfig)
from montecarlooptionspricer_tpu_torch.models import engine as tengine
from montecarlooptionspricer_tpu_torch.models import pathgen_stream as ps
from montecarlooptionspricer_tpu_torch.models import rough_volatility as trv
from montecarlooptionspricer_tpu_torch.ops import qmc as tqmc
from montecarlooptionspricer_tpu_torch.pipeline import csv_io
from montecarlooptionspricer_tpu_torch.pipeline.driver import run_pipeline

from test_pipeline import make_option_csv, make_spot_csv, opt_row
from test_torch_pathgen import DT, KW
from test_torch_tiled import BENCH_MARKET


def bits(key, dim):
    """JAX's digital shift of ``key``: ``jax.random.bits`` as ``rotate``
    draws it, as the port's int32 bit patterns."""
    return tqmc.as_bits(np.asarray(jax.random.bits(key, (dim,), jnp.uint32)))


def normal(key, shape):
    return jax.random.normal(key, shape, jnp.float32)


def tensors(*arrays):
    """JAX arrays as torch tensors (uint32 words as int32 bit patterns)."""
    return [tqmc.as_bits(a) if a.dtype == np.uint32
            else torch.from_numpy(np.array(a)) for a in map(np.asarray,
                                                            arrays)]


# ---------------------------------------------------------------------------
# ops/qmc.py

@pytest.mark.parametrize("n,dim", [(250, 16), (1024, 96)])
def test_sobol_base_and_pca_bit_equal(n, dim):
    """The same scipy and NumPy calls give the same bits; both cached."""
    np.testing.assert_array_equal(tqmc.sobol_base(n, dim),
                                  jqmc.sobol_base(n, dim))
    assert tqmc.sobol_base(n, dim) is tqmc.sobol_base(n, dim)
    np.testing.assert_array_equal(tqmc.brownian_pca_matrix(dim, DT),
                                  jqmc.brownian_pca_matrix(dim, DT))


def test_rotate_bit_equal_and_interior():
    """The shift on JAX's own words gives JAX's uniforms bit for bit, and
    the all-ones and all-zeros digits after the shift (JAX's adversarial
    case) stay strictly inside (0, 1) with finite normals."""
    base = jqmc.sobol_base(128, 8)
    key = jax.random.key(1)
    rotate = jax.jit(jqmc.rotate)
    want = np.asarray(rotate(jnp.asarray(base), key))
    got = tqmc.rotate(tqmc.as_bits(base), bits(key, 8)).numpy()
    np.testing.assert_array_equal(got, want)
    key = jax.random.key(3)
    shift = jax.random.bits(key, (4,), jnp.uint32)
    for edge in ((shift ^ jnp.uint32(0xFFFFFFFF))[None, :], shift[None, :]):
        edge = np.asarray(edge)
        want = np.asarray(rotate(jnp.asarray(edge), key))
        got = tqmc.rotate(tqmc.as_bits(edge), bits(key, 4)).numpy()
        np.testing.assert_array_equal(got, want)
        assert np.all(got > 0.0) and np.all(got < 1.0)
        assert torch.isfinite(tqmc.normals(tqmc.as_bits(edge),
                                           bits(key, 4))).all()


def test_normals_match_jax():
    """float32 ndtri within 2e-6 of JAX's; the float64 form within 2e-6
    of it too (it is the more exact of the two)."""
    base = jqmc.sobol_base(4096, 32)
    key = jax.random.key(7)
    want = np.asarray(jax.jit(jqmc.normals)(jnp.asarray(base), key))
    got = tqmc.normals(tqmc.as_bits(base), bits(key, 32))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6)
    got64 = tqmc.normals(tqmc.as_bits(base), bits(key, 32), torch.float64)
    np.testing.assert_allclose(got64.numpy(), want, rtol=0, atol=2e-6)
    assert abs(float(got.mean())) < 0.05 and abs(float(got.std()) - 1) < 0.05


# ---------------------------------------------------------------------------
# The fused QMC noise and the stream's QMC chunk.

@pytest.mark.parametrize("qmc_fgn", [False, True], ids=["w", "fgn"])
@pytest.mark.parametrize("form,n_steps", [("chol", 40), ("spectral", 40),
                                          ("factored", 200)])
def test_fused_noise_matches_jax(form, n_steps, qmc_fgn):
    """``fused_qmc_noise`` on JAX's draws (its ``split(key, 3)`` into kq,
    kp, kt reproduced and injected) against ``_make_fused_qmc_noise``
    elementwise within 1e-5, with ``qmc_dim`` below the horizon: the
    dense forms n_steps wide, the factored form over m2 = 256 columns."""
    chunk, q = 512, 16
    cfg = dict(n_paths=chunk, n_steps=n_steps, chunk_paths=chunk, qmc=True,
               qmc_fgn=qmc_fgn, qmc_dim=q)
    width = 256 if form == "factored" else n_steps
    n_fgn = 1 if form == "chol" else 2
    dims = q + (n_fgn * q if qmc_fgn else 0)
    noise_fn = jengine._make_fused_qmc_noise(jengine.StreamConfig(**cfg),
                                             n_steps, width, form, DT)

    @jax.jit
    def reference(key):
        kq, kp, kt = jax.random.split(key, 3)
        if qmc_fgn:
            fgn = jnp.stack([normal(k, (chunk, width - q))
                             for k in jax.random.split(kp, n_fgn)])
        elif n_fgn == 1:
            fgn = normal(kp, (chunk, width))[None]
        else:
            fgn = normal(kp, (2, chunk, width))
        return (noise_fn(key), jax.random.bits(kq, (dims,), jnp.uint32),
                normal(kt, (chunk, n_steps - q)), fgn)

    want, *draws = reference(jax.random.key(5))
    fq = tengine.make_fused_qmc(tengine.StreamConfig(**cfg), form, "cpu")
    assert (fq.width, fq.n_fgn, fq.q_w, fq.q_f) == (width, n_fgn, q, q)
    got = tengine.fused_qmc_noise(fq, *tensors(*draws))
    assert got.shape == want.shape == (n_fgn + 1, chunk, width)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert (got[-1, :, n_steps:] == 0).all()


@pytest.mark.parametrize("qmc_fgn", [False, True], ids=["w", "fgn"])
def test_stream_qmc_chunk_matches_jax(qmc_fgn):
    """The stream's QMC chunk (``qmc_noise`` on JAX's draws: kz, kw =
    split(key), kw, kt = split(kw)) through ``paths_from_noise`` against
    ``make_chunk_pathgen(qmc=True)`` elementwise within 2e-5, truncated
    at qmc_dim 16 of 40 steps; the seeded chunk is finite and fresh."""
    rows, n, q = 256, 40, 16
    gen = jengine.make_chunk_pathgen(**KW, n_steps=n, dt=DT,
                                     chunk_paths=rows, qmc=True,
                                     qmc_fgn=qmc_fgn, qmc_dim=q)

    @jax.jit
    def reference(key):
        kz, kw = jax.random.split(key)
        kw, kt = jax.random.split(kw)
        return (gen(key), jax.random.bits(kw, (3 * q if qmc_fgn else q,),
                                          jnp.uint32),
                normal(kt, (rows, n - q)),
                normal(kz, (2, rows, n - q if qmc_fgn else n)))

    want, *draws = reference(jax.random.key(9))
    consts = ps.make_stream_consts(KW["s0"], KW["xi"], KW["h"], KW["eta"],
                                   KW["r"], n, DT, "cpu", qmc=True,
                                   qmc_fgn=qmc_fgn, qmc_dim=q)
    zq, dw = ps.qmc_noise(consts, *tensors(*draws))
    got = ps.paths_from_noise(consts, zq, dw).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5)
    seeded = ps.chunk_paths(consts, rows, (3, 0))
    assert torch.isfinite(seeded).all()
    assert not torch.equal(seeded, ps.chunk_paths(consts, rows, (3, 1)))


def test_generate_paths_qmc_matches_jax():
    """``generate_paths_qmc`` and its bucketed form (two rows of one
    bucket, other horizons and markets) on JAX's shifts against JAX's,
    elementwise within 2e-5."""
    key = jax.random.key(4)
    want = np.asarray(jax.jit(jrv.generate_paths_qmc, static_argnums=(7, 8))(
        key, 100.0, 0.04, 0.1, 1.5, -0.4, 0.04, 21, 128))
    got = trv.generate_paths_qmc(None, 100.0, 0.04, 0.1, 1.5, -0.4, 0.04,
                                 21, 128, shift=bits(key, 63))
    assert got.shape == (128, 22)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5)
    rows = dict(s0=[100.0, 95.0], xi=[0.04, 0.06], h=[0.1, 0.2],
                eta=[1.5, 1.1], n_steps=[17, 30])
    keys = [jax.random.key(10 + i) for i in range(2)]
    bucketed = jax.jit(jrv.generate_paths_qmc_bucketed,
                       static_argnums=(8, 9, 10))
    want = np.stack([np.asarray(bucketed(
        k, *(rows[f][i] for f in ("s0", "xi", "h", "eta")), -0.4, 0.04,
        rows["n_steps"][i], 32, 32, 64)) for i, k in enumerate(keys)])
    got = trv.generate_paths_qmc_bucketed(
        None, *(torch.tensor(rows[f]) for f in ("s0", "xi", "h", "eta")),
        -0.4, 0.04, torch.tensor(rows["n_steps"]), 32, 32, 64,
        shifts=torch.stack([bits(k, 96) for k in keys]))
    assert got.shape == (2, 64, 33)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5)


# ---------------------------------------------------------------------------
# The pricers.

@pytest.mark.parametrize("n_steps,extra,family,width,n_fgn", [
    (32, {}, "single", 32, 1),
    (32, dict(fgn_form="spectral"), "single", 32, 2),
    (400, {}, "tiled", 400, 1),
    (400, dict(tiled_impl="factored"), "factored", 512, 2),
    (32, dict(poly_order=3), "stream", None, None),
])
def test_qmc_routes(caplog, n_steps, extra, family, width, n_fgn):
    """The QMC route of each configuration: the family's noise-in kernel
    with noise of its layout (K2 chol and spectral, K7, K9 over m2), the
    pilot and the bounds on the generic stream's QMC generator; outside
    every noise-in kernel the generic stream, with a warning."""
    cfg = tengine.StreamConfig(n_paths=2048, n_steps=n_steps,
                               chunk_paths=1024, pilot_paths=1024, qmc=True,
                               qmc_dim=16, **extra)
    with caplog.at_level(logging.WARNING):
        p = tengine.StreamingPricer(**BENCH_MARKET, strike=105.0,
                                    maturity=n_steps * DT, is_call=False,
                                    config=cfg, device="cpu")
    assert p.kernel_family == family
    assert p.stream_consts.qmc and p.stream_consts.qmc_dim == 16
    warned = "no noise-in kernel" in caplog.text
    assert warned == (family == "stream")
    if family == "stream":
        assert p._fused_qmc is None and p.consts is p.stream_consts
        return
    assert (p._fused_qmc.width, p._fused_qmc.n_fgn) == (width, n_fgn)
    assert p._fused_qmc.rows == 1024
    noise = p._qmc_chunk_noise((1, 0))
    assert noise.shape == (n_fgn + 1, 1024, width)
    assert torch.equal(noise, p._qmc_chunk_noise((1, 0)))


def test_streaming_qmc_matches_jax_and_beats_prng():
    """A CPU ``StreamingPricer(qmc=True)`` (K2's plain version on the QMC
    noise, the pilot on the QMC stream) within 5 combined stderr of JAX's
    ``StreamingPricer(qmc=True, pathgen_impl="xla")``, with a stderr
    below the port's PRNG stderr at the same configuration."""
    n, chunk, n_chunks = 32, 4096, 8
    kw = dict(n_paths=chunk * n_chunks, n_steps=n, chunk_paths=chunk,
              pilot_paths=chunk, chunks_per_call=n_chunks)
    market = dict(**BENCH_MARKET, strike=105.0, maturity=n * DT,
                  is_call=False)
    j = jengine.StreamingPricer(
        *market.values(), jengine.StreamConfig(**kw, qmc=True,
                                               pathgen_impl="xla"))
    pj, sj = j.price(jax.random.key(1), with_stderr=True)
    se = {}
    for q in (False, True):
        p = tengine.StreamingPricer(
            **market, config=tengine.StreamConfig(**kw, qmc=q),
            device="cpu")
        price, se[q] = p.price(1, with_stderr=True)
    assert abs(price - pj) <= 5.0 * np.hypot(se[True], sj), (price, pj)
    assert se[True] < se[False], se


def test_chain_and_bounds_under_qmc():
    """A QMC strip (K5's plain version on QMC noise) rises in strike with
    stderrs below the PRNG strip's at the near-the-money strikes; the
    QMC bracket holds the price; Greeks under qmc (refused naming A10
    before the jvp Greeks were ported) ride the jvp stream on the QMC
    generator: finite, the single pricer's price lane within 5 combined
    stderr of its price and the strip's strike-105 row the single
    pricer's (the same pilot carrier and chunks)."""
    kw = dict(n_paths=4 * 2048, n_steps=16, chunk_paths=2048,
              pilot_paths=2048)
    market = dict(**BENCH_MARKET, maturity=16 * DT, is_call=False)
    se = {}
    for q in (False, True):
        chain = tengine.StreamingChainPricer(
            **market, strikes=[95.0, 100.0, 105.0],
            config=tengine.StreamConfig(**kw, qmc=q), device="cpu")
        prices, se[q] = chain.price(0, with_stderr=True)
    assert chain.kernel_family == "single"
    assert np.all(np.diff(prices) > 0), prices
    assert np.all(se[True][1:] < se[False][1:]), se
    p = tengine.StreamingPricer(**market, strike=105.0,
                                config=tengine.StreamConfig(**kw, qmc=True),
                                device="cpu")
    lo, up = p.price_with_bounds(0)
    assert lo < up and abs(lo / p.price(0) - 1.0) < 0.01
    g, g_se = p.price_and_greeks(0, with_stderr=True)
    price, p_se = p.price(0, with_stderr=True)
    assert all(np.isfinite(g)) and g[1] < 0 < g[2]
    assert abs(g[0] - price) < 5 * np.hypot(g_se[0], p_se)
    rows = chain.price_and_greeks(0)
    np.testing.assert_allclose(rows[:, 2], g, rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# The pipeline and the CLIs.

@pytest.fixture
def workdir(tmp_path, rng, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return make_spot_csv("nasdaq_stock_data.csv", rng)


def test_pipeline_qmc_matches_jax_and_resumes(workdir):
    """``--qmc`` on a tiny CSV (a sentinel row, 8 puts of one contract):
    JAX's columns and sentinel, each estimator's mean over the 8 rows
    (8 digital shifts) within 5 combined stderr of JAX's; a run cut after
    3 rows and resumed writes the one-shot run's bytes."""
    s = round(workdir["aapl"], 4)
    rows = [opt_row(ticker="ZZZZ")] + [
        opt_row(option_type=0, dte=30.0, s=s, sdp=-0.02)] * 8
    make_option_csv("option_data.csv", rows)
    assert jrun_pipeline(JPipe(output_csv="jax.csv"),
                         JPricing(rows_per_batch=8, seed=2, qmc=True),
                         JMarket()) == 0
    cfg = PipelineConfig(output_csv="torch.csv")
    pricing = PricingConfig(rows_per_batch=4, seed=2, qmc=True)
    assert run_pipeline(cfg, pricing, MarketDefaults(), device="cpu") == 0
    jh, jrows = csv_io.read_table("jax.csv")
    th, trows = csv_io.read_table("torch.csv")
    assert th == jh and len(trows) == len(jrows) == 9
    assert trows[0] == jrows[0] and trows[0][-6:] == ["0"] * 6
    got = np.asarray([[float(v) for v in r[-6:-2]] for r in trows[1:]])
    want = np.asarray([[float(v) for v in r[-6:-2]] for r in jrows[1:]])
    assert [r[:-6] for r in trows] == [r[:-6] for r in jrows]
    se = np.sqrt(got.var(axis=0, ddof=1) / 8 + want.var(axis=0, ddof=1) / 8)
    assert (np.abs(got.mean(axis=0) - want.mean(axis=0))
            <= 5.0 * se + 1e-9).all(), (got.mean(axis=0), want.mean(axis=0))
    full = open("torch.csv").read()
    with open("torch.csv", "w") as f:
        f.writelines(full.splitlines(keepends=True)[:4])
    assert run_pipeline(cfg, pricing, MarketDefaults(), resume=True,
                        device="cpu") == 0
    assert open("torch.csv").read() == full


def test_prediction_gen_cli_qmc(workdir, capsys):
    """``mcop-prediction-gen-torch --qmc`` writes the augmented CSV on the
    CPU; with ``--antithetic`` it exits 2, as PricingConfig refuses."""
    make_option_csv("option_data.csv", [opt_row(
        option_type=0, dte=30.0, s=round(workdir["aapl"], 4), sdp=-0.02)])
    assert tpg_cli.main(["--qmc", "--device", "cpu", "--num-paths", "64",
                         "--rows-per-batch", "2"]) == 0
    _, out = csv_io.read_table("option_data_augmented.csv")
    assert len(out) == 1 and all(float(v) != 0.0 for v in out[0][-6:-2])
    assert tpg_cli.main(["--qmc", "--antithetic", "--device", "cpu"]) == 2
    assert "incompatible" in capsys.readouterr().err


_RUN = ["--strike", "102", "--put", "--maturity", "0.12", "--steps", "24",
        "--paths", "4096", "--chunk-paths", "2048", "--device", "cpu"]


@pytest.mark.parametrize("flags,rc,match", [
    (["--qmc"], 0, None), (["--qmc", "--qmc-fgn"], 0, None),
    (["--qmc-fgn"], 2, "qmc_fgn requires qmc"),
    (["--qmc", "--antithetic"], 2, "incompatible with --qmc"),
    (["--qmc", "--greeks"], 0, None)])
def test_price_cli_qmc(capsys, flags, rc, match):
    """``mcop-price-torch --qmc`` and ``--qmc --qmc-fgn`` print a price on
    the CPU, and ``--qmc --greeks`` (refused naming A10 before the jvp
    Greeks were ported) the Greeks of the jvp stream on the QMC
    generator, as the JAX CLI does; the JAX CLI's refusals exit 2."""
    assert tprice_cli.main(_RUN + flags) == rc
    captured = capsys.readouterr()
    if rc:
        assert match in captured.err
        return
    out = json.loads(captured.out)
    assert out["kernel_family"] == "single"
    if "--greeks" in flags:
        assert out["price"] > 0 and out["delta"] < 0 < out["vega_xi"]
        assert all(v > 0 for v in out["stderrs"].values())
        return
    assert out["price"] > 0 and out["stderr"] > 0
