"""The port's factored-DFT long horizon (K8/K9 of ``pathgen_factored_cuda``,
the spectral fGN law) and its ``ops/fgn.py`` against the JAX package: the
host constants, the kernels' plain versions (what the wrappers run on CPU
tensors) against the JAX factored kernels in interpret mode on the same
numpy noise, the seeded slice against the JAX StreamingPricer in
distribution, the seeded stream's moments, the CLI past the slab's range,
and the engine's kernel-family table.  The kernels themselves are held
against these plain versions on the card in test_torch_gpu.py."""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlooptionspricer_tpu.models import engine as jengine
from montecarlooptionspricer_tpu.models import pathgen_pallas as jpp
from montecarlooptionspricer_tpu.models import pathgen_pallas_factored as jf
from montecarlooptionspricer_tpu.models.lsm import lsm_fit as jlsm_fit
from montecarlooptionspricer_tpu.ops import fgn as jfgn
from montecarlooptionspricer_tpu_torch.models import engine as tengine
from montecarlooptionspricer_tpu_torch.models import pathgen_cuda as pc
from montecarlooptionspricer_tpu_torch.models import (
    pathgen_factored_cuda as pfc)
from montecarlooptionspricer_tpu_torch.models import pathgen_tiled_cuda as ptc
from montecarlooptionspricer_tpu_torch.ops import fgn as tfgn

from test_torch_pathgen import DT, KW, to_port_fits
from test_torch_tiled import BENCH_MARKET


def consts_cpu(n_steps):
    return pfc.make_factored_consts(KW["s0"], KW["xi"], KW["h"], KW["eta"],
                                    KW["r"], n_steps, DT, "cpu")


def factored_noise(rng, rows, n_steps, w_pad=99.0):
    """[3, rows, m2] float32 numpy noise in the kernels' layout; the price
    Brownian past n_steps is ``w_pad`` and must not reach the paths."""
    noise = rng.normal(size=(3, rows, tfgn.next_pow2(n_steps)))
    noise[2, :, n_steps:] = w_pad
    return noise.astype(np.float32)


# ---------------------------------------------------------------------------
# ops/fgn.py and the host constants.

@pytest.mark.parametrize("dtype,rtol", [("float64", 1e-12),
                                        ("float32", 1e-6)])
def test_fgn_ops_match_jax(rng, dtype, rtol):
    """The port's ops/fgn.py against JAX's on the same inputs: 1e-12 in
    float64, 1e-6 (of each output's scale) in float32."""
    h, eta, xi, n = 0.12, 1.7, 0.05, 200
    tdt = getattr(torch, dtype)
    cdt = torch.complex128 if dtype == "float64" else torch.complex64
    t = np.arange(n + 1) * DT
    zr, zi = rng.normal(size=(2, 4, n))
    x = rng.normal(size=(4, n)) * 0.1

    def close(got, want, tol=rtol):
        got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
        want = np.asarray(want)
        scale = np.max(np.abs(want))
        np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)

    for k in (1, 5, 128, 129, 1825, 4096):
        assert tfgn.next_pow2(k) == jfgn.next_pow2(k)
    with jax.enable_x64(dtype == "float64"):
        jt = jnp.asarray(t, dtype)
        lam_j = jfgn.rbergomi_lambda(jt, h)
        phi_j = jfgn.rbergomi_phi(lam_j)
        zj = jnp.asarray(zr + 1j * zi, phi_j.dtype)
        fg_j = jfgn.fractional_gaussian(phi_j, zj, h, eta)
        cr_j, ci_j = jfgn.fgn_matrices(phi_j, n, h, eta, dtype=dtype)
        mm_j = jfgn.fractional_gaussian_matmul(
            cr_j, ci_j, jnp.asarray(zr, dtype), jnp.asarray(zi, dtype),
            precision=jax.lax.Precision.HIGHEST)
        fv_j = jfgn.forward_variance(jnp.asarray(x, dtype), jt, xi, h, eta)
        want = [np.asarray(v) for v in (lam_j, phi_j, fg_j, cr_j, ci_j,
                                        mm_j, fv_j)]
    tt = torch.tensor(t, dtype=tdt)
    lam = tfgn.rbergomi_lambda(tt, h)
    phi = tfgn.rbergomi_phi(lam)
    assert phi.dtype == cdt and phi.shape == (256,)
    z = torch.tensor(zr + 1j * zi, dtype=cdt)
    fg = tfgn.fractional_gaussian(phi, z, h, eta)
    cr, ci = tfgn.fgn_matrices(phi, n, h, eta, dtype=tdt)
    mm = tfgn.fractional_gaussian_matmul(cr, ci, torch.tensor(zr, dtype=tdt),
                                         torch.tensor(zi, dtype=tdt))
    fv = tfgn.forward_variance(torch.tensor(x, dtype=tdt), tt, xi, h, eta)
    for got, w in zip((lam, phi, fg, cr, ci, fv), want[:5] + want[6:]):
        assert got.dtype in (tdt, cdt)
        close(got, w)
    # JAX's matmul form returns float32 by design (preferred_element_type),
    # so it is held at float32's 1e-6; the port's keeps the inputs' type
    # and equals the FFT form at the stated tolerance.
    assert mm.dtype == tdt
    close(mm, want[5], tol=max(rtol, 1e-6))
    close(mm, fg)


@pytest.mark.parametrize("n_steps", [200, 1825, 4000])
def test_factored_consts_match_jax(n_steps):
    """FactoredConsts against JAX's ``_consts`` (both float64 on the host,
    cast once): 1e-7."""
    c = consts_cpu(n_steps)
    s_pad, m2, n2, jconsts, (vd_p, _, _), _ = jf._consts(
        KW["s0"], KW["xi"], KW["h"], KW["eta"], KW["rho"], KW["r"], n_steps,
        DT, jnp.float32)
    assert (c.s_pad, c.m2, c.phi_r.shape[0]) == (s_pad, m2, n2)
    for got, want in zip((c.f1r, c.f1i, c.phi_r, c.phi_i, c.tw_r, c.tw_i),
                         jconsts):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-7)
    np.testing.assert_allclose(c.vd.numpy(), np.asarray(vd_p)[0, :n_steps],
                               rtol=0, atol=1e-7)
    # The stage-2 table: cos and sin of 2 pi ((k2 j) mod N2) / N2.
    k = np.arange(n2)
    ang = 2 * np.pi * ((k[:, None] * k[None, :]) % n2) / n2
    np.testing.assert_allclose(c.c2.numpy(), np.cos(ang), atol=1e-7)
    np.testing.assert_allclose(c.s2.numpy(), np.sin(ang), atol=1e-7)
    np.testing.assert_array_equal(pfc.transposed_to_logical(m2).numpy(),
                                  jf.transposed_to_logical(m2))


# ---------------------------------------------------------------------------
# The plain versions against the JAX factored kernels, interpreted.

@pytest.mark.parametrize("n_steps,rows,block,rtol", [
    # 200 steps: m2 256, N2 2, two step tiles (the cross-tile carry).
    (200, 128, 64, 2e-4),
    # The reference's horizon class (m2 2048, N2 16) at 1100 steps, nine
    # tiles: JAX's own shape and tolerance for it.
    (1100, 32, 16, 5e-4),
])
def test_factored_pathgen_ref_matches_jax(rng, n_steps, rows, block, rtol):
    """Plain K8 against ``make_factored_pathgen(noise_input=True)`` on one
    noise array: the FFT and the four-step split sum in other float32
    orders."""
    noise = factored_noise(rng, rows, n_steps)
    gen, _ = jf.make_factored_pathgen(
        **KW, n_steps=n_steps, dt=DT, chunk_paths=rows, block_paths=block,
        interpret=True, noise_input=True)
    want = np.asarray(gen(jnp.asarray(noise)))
    got = pfc.factored_pathgen(consts_cpu(n_steps),
                               noise=torch.from_numpy(noise))
    assert got.shape == (rows, n_steps + 1)
    assert np.all(np.isfinite(got.numpy()))
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol)


@functools.lru_cache(maxsize=None)
def xla_pilot_fits(n_steps: int, strike: float, is_call: bool):
    """JAX's LSM fit on a pilot from its XLA generator."""
    pilot = jengine.make_chunk_pathgen(
        KW["s0"], KW["xi"], KW["h"], KW["eta"], KW["rho"], KW["r"], n_steps,
        DT, 1 << 11)(jax.random.key(0))
    _, fits = jlsm_fit(pilot, KW["r"], strike, n_steps * DT, DT, is_call, 2)
    return fits


@pytest.mark.parametrize("is_call,strike", [(False, 97.0), (True, 103.0)])
def test_factored_priced_chunk_ref_matches_jax(rng, is_call, strike):
    """Plain K9 against ``make_factored_priced_chunk(policy_form=
    "boundary")`` under JAX's fit carried over with polyfit_from_numpy,
    on noise x1.5 so paths exercise: rtol 5e-4 (JAX's own tolerance)."""
    n_steps, rows, maturity = 200, 128, 200 * DT
    fits = xla_pilot_fits(n_steps, strike, is_call)
    noise = 1.5 * factored_noise(rng, rows, n_steps, w_pad=0.0)
    chunk_sum, _ = jf.make_factored_priced_chunk(
        **KW, strike=strike, maturity=maturity, dt=DT, n_steps=n_steps,
        chunk_paths=rows, block_paths=64, is_call=is_call, interpret=True,
        noise_input=True, policy_form="boundary")
    jrows = jpp.log_boundary_rows(jpp.boundary_rows(
        fits, KW["r"], strike, maturity, DT, n_steps, is_call))
    want = float(chunk_sum(jnp.asarray(noise), jrows))
    table = pc.log_boundary_rows(pc.boundary_rows(
        to_port_fits(fits), KW["r"], strike, maturity, DT, n_steps,
        is_call)).contiguous()
    got = float(pfc.factored_priced_chunk(consts_cpu(n_steps), table, strike,
                                          is_call,
                                          noise=torch.from_numpy(noise)))
    assert want > 0
    np.testing.assert_allclose(got, want, rtol=5e-4)


def test_spectral_slice_in_distribution_matches_jax():
    """The port's seeded 600-step price on the factored family
    (fgn_form="spectral") against the JAX StreamingPricer's (XLA
    generator, another random stream): within 5 combined stderr."""
    n_steps, chunk, n_chunks, pilot, seed = 600, 1024, 4, 2048, 0
    strike, maturity = 105.0, n_steps * DT
    cfg = tengine.StreamConfig(n_paths=n_chunks * chunk, n_steps=n_steps,
                               chunk_paths=chunk, pilot_paths=pilot, dt=DT,
                               fgn_form="spectral")
    pricer = tengine.StreamingPricer(
        **BENCH_MARKET, strike=strike, maturity=maturity, is_call=False,
        config=cfg, device="cpu")
    assert pricer.kernel_family == "factored"
    got, se_t = pricer.price(seed, with_stderr=True)
    jcfg = jengine.StreamConfig(n_paths=n_chunks * chunk, n_steps=n_steps,
                                chunk_paths=chunk, pilot_paths=pilot, dt=DT,
                                pathgen_impl="xla", fgn_form="spectral")
    want, se_j = jengine.StreamingPricer(
        **BENCH_MARKET, strike=strike, maturity=maturity, is_call=False,
        config=jcfg).price(jax.random.key(seed), with_stderr=True)
    assert 0 < se_t < 0.05 * got
    assert abs(got - want) < 5 * np.hypot(se_t, se_j), (got, want, se_t, se_j)


# ---------------------------------------------------------------------------
# The seeded stream and the wrappers on the CPU.

def test_philox_factored_normals_moments():
    """Standard normal moments of each plane within 5 sigma of their
    sampling error, the planes uncorrelated, a stream apart from K1-K7's
    on the same key, and a row window equal to the same rows of the
    whole block (also across the row blocks it is computed in)."""
    rows, n_steps, key = 512, 1000, pc._fold_words(11, 4)
    noise = pfc.philox_factored_normals_ref(key, rows, n_steps)
    assert noise.shape == (3, rows, 1024) and noise.dtype == torch.float32
    count = rows * 1024
    for plane in noise.double():
        assert abs(float(plane.mean())) < 5 / count ** 0.5
        assert abs(float(plane.var()) - 1.0) < 5 * (2 / count) ** 0.5
        assert abs(float((plane ** 3).mean())) < 5 * (15 / count) ** 0.5
    flat = noise.double().reshape(3, -1)
    corr = torch.corrcoef(flat)
    assert float((corr - torch.eye(3, dtype=torch.float64)).abs().max()) \
        < 5 / count ** 0.5
    k1 = pc.philox_normals_ref(key, rows, n_steps)
    assert not torch.equal(noise[0, :, :n_steps], k1[0])
    window = pfc.philox_factored_normals_ref(key, 40, n_steps, row0=100,
                                             block_rows=16)
    torch.testing.assert_close(window, noise[:, 100:140], rtol=0, atol=0)


def test_factored_wrappers_on_cpu_run_plain_versions():
    """On CPU tensors the seeded wrappers are the plain versions on
    ``philox_factored_normals_ref``'s noise, exactly; bad inputs raise."""
    n_steps, rows, key = 300, 64, pc._fold_words(3, 2)
    consts = consts_cpu(n_steps)
    noise = pfc.philox_factored_normals_ref(key, rows, n_steps)
    paths = pfc.factored_pathgen(consts, rows=rows, key=key)
    torch.testing.assert_close(
        paths, pfc.factored_pathgen_from_noise_ref(consts, noise), rtol=0,
        atol=0)
    _, fits = tengine.lsm_fit(paths, KW["r"], 100.0, n_steps * DT, DT, False)
    table = tengine._fused_rows_builder(KW["r"], 100.0, n_steps * DT, DT,
                                        n_steps, False)(fits)
    got = pfc.factored_priced_chunk(consts, table, 100.0, False, rows=rows,
                                    key=key)
    assert float(got) == float(pfc.factored_priced_chunk_from_noise_ref(
        consts, table, noise, 100.0, False))
    with pytest.raises(ValueError):          # neither key nor noise
        pfc.factored_pathgen(consts, rows=rows)
    with pytest.raises(ValueError):          # the single-tile noise layout
        pfc.factored_pathgen(consts, noise=noise[:2, :, :n_steps])
    with pytest.raises(ValueError):          # a table too short
        pfc.factored_priced_chunk(consts, table[:, :10], 100.0, False,
                                  rows=rows, key=key)


def test_factored_plain_version_is_the_dense_spectral_map(rng):
    """The plain K8's fGN (permute, diagonal, one FFT) equals the dense
    float64 spectral map of ops/fgn.py on the logical noise, half-scaled
    (the kernels' contract), to float32 rounding."""
    n_steps, rows = 300, 8
    consts = consts_cpu(n_steps)
    noise = torch.from_numpy(factored_noise(rng, rows, n_steps))
    x = pfc.fgn_from_noise_ref(consts, noise)
    perm = pfc.transposed_to_logical(consts.m2)
    logical = torch.empty_like(noise[:2])
    logical[:, :, perm] = noise[:2]
    t = torch.arange(n_steps + 1, dtype=torch.float64) * DT
    phi = tfgn.rbergomi_phi(tfgn.rbergomi_lambda(t, KW["h"]))
    cr, ci = tfgn.fgn_matrices(phi, n_steps, KW["h"], KW["eta"],
                               dtype=torch.float64)
    want = 0.5 * tfgn.fractional_gaussian_matmul(
        cr, ci, logical[0, :, :n_steps].double(),
        logical[1, :, :n_steps].double())
    torch.testing.assert_close(x.double(), want, rtol=0,
                               atol=2e-6 * float(want.abs().max()))


def test_engine_streams_given_noise_on_the_factored_family(rng):
    """price_with_fit(noise=[n_chunks, 3, chunk, m2]) on the factored
    family streams each chunk through K9's entry: the mean of the plain
    chunk sums."""
    n_steps, chunk, n_chunks = 400, 64, 3
    cfg = tengine.StreamConfig(n_paths=chunk * n_chunks, n_steps=n_steps,
                               chunk_paths=chunk, pilot_paths=chunk,
                               tiled_impl="factored")
    pricer = tengine.StreamingPricer(**BENCH_MARKET, strike=100.0,
                                     maturity=n_steps * DT, is_call=False,
                                     config=cfg, device="cpu")
    assert pricer.kernel_family == "factored"
    assert isinstance(pricer.consts, pfc.FactoredConsts)
    assert pricer._priced_chunk is pfc.factored_priced_chunk
    assert pricer._pathgen is pfc.factored_pathgen
    fits = pricer.fit((5, 1))
    noise = torch.from_numpy(np.stack([factored_noise(rng, chunk, n_steps)
                                       for _ in range(n_chunks)]))
    got = pricer.price_with_fit(fits, noise=noise)
    table = pricer._make_rows(fits)
    want = sum(float(pfc.factored_priced_chunk_from_noise_ref(
        pricer.consts, table, noise[i], 100.0, False))
        for i in range(n_chunks)) / (chunk * n_chunks)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # Greeks on the factored family (refused naming A10 before the jvp
    # Greeks were ported) ride the jvp stream, the same spectral law: the
    # price lane within 5 combined stderr of the price.
    (g, g_se), (p, p_se) = (pricer.price_and_greeks(0, with_stderr=True),
                            pricer.price(0, with_stderr=True))
    assert all(np.isfinite(g)) and g[1] < 0 < g[2]
    assert abs(g[0] - p) < 5 * np.hypot(g_se[0], p_se)


def test_cli_prices_past_the_slab_on_cpu(capsys):
    """mcop-price-torch past the slab's 3,620 steps takes the factored
    family (auto).  Two chunks of 256, the CLI's smallest (JAX's
    rounding), so the stderr exists."""
    from montecarlooptionspricer_tpu_torch.cli import price as tcli

    steps = ptc.max_tiled_steps() + 80
    assert tengine.resolve_kernel_family(steps) == "factored"
    rc = tcli.main(["--strike", "105", "--put", "--maturity",
                    str(steps / 252), "--steps", str(steps), "--paths",
                    "512", "--chunk-paths", "256", "--pilot-paths", "128",
                    "--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 0 and out["kernel_family"] == "factored"
    assert out["n_steps"] == steps and out["n_paths"] == 512
    assert 0 < out["price"] < 105 and out["stderr"] > 0


# ---------------------------------------------------------------------------
# The family table and the memory model.

CAP = pfc.max_factored_steps()
SLAB = ptc.max_tiled_steps()


@pytest.mark.parametrize("n_steps,fgn_form,tiled_impl,want", [
    (365, "auto", "auto", "single"),
    (365, "chol", "factored", "single"),
    (1825, "auto", "auto", "tiled"),
    (1825, "chol", "slab", "tiled"),
    (1825, "auto", "factored", "factored"),
    (1825, "spectral", "auto", "factored"),
    (366, "spectral", "factored", "factored"),
    (SLAB, "auto", "auto", "tiled"),
    (SLAB + 1, "auto", "auto", "factored"),
    (4000, "auto", "auto", "factored"),
    (CAP, "spectral", "factored", "factored"),
    # An explicit chol that would need the factored kernels (JAX's
    # ValueError), tiled_impl past its kernel's range.
    (4000, "chol", "auto", (ValueError, "fgn_form='chol'")),
    (1825, "chol", "factored", (ValueError, "fgn_form='chol'")),
    (CAP + 1, "auto", "factored", (ValueError, "tiled_impl='auto'")),
    (4000, "auto", "slab", (ValueError, "tiled_impl='slab'")),
    (1825, "cholesky", "auto", (ValueError, "fgn_form")),
    # The spectral bodies of K1/K2 and of the slab K6/K7
    # (NotImplementedError naming ROADMAP B1/B2 and B7 before they were
    # ported).
    (365, "spectral", "auto", "single"),
    (1825, "spectral", "slab", "tiled"),
    # Past K8's range: the generic path stream (NotImplementedError
    # before it was ported).
    (CAP + 1, "auto", "auto", "stream"),
    (CAP + 1, "spectral", "auto", "stream"),
    # The spectral slab's range: both dense matrices in L2, 2,560 steps.
    (2560, "spectral", "slab", "tiled"),
    (2561, "spectral", "slab", (ValueError, "tiled_impl='slab'")),
])
def test_kernel_family_table(n_steps, fgn_form, tiled_impl, want):
    if isinstance(want, str):
        assert tengine.resolve_kernel_family(n_steps, fgn_form,
                                             tiled_impl) == want
        cfg = tengine.StreamConfig(n_paths=1024, n_steps=n_steps,
                                   fgn_form=fgn_form, tiled_impl=tiled_impl)
        assert cfg.n_steps == n_steps
        return
    exc, match = want
    with pytest.raises(exc, match=match):
        tengine.resolve_kernel_family(n_steps, fgn_form, tiled_impl)
    with pytest.raises(exc, match=match):
        tengine.StreamConfig(n_paths=1024, n_steps=n_steps,
                             fgn_form=fgn_form, tiled_impl=tiled_impl)


def test_factored_chain_raises():
    """A strip whose configuration resolves to K8/K9 (400 steps, spectral)
    raised naming ROADMAP B5 until K5 had its spectral form.  It now runs
    on the K8 pilot with K5 streaming on its own spectral constants (the
    plain versions here), in both pricers' law.  Its Greeks (refused
    naming ROADMAP A10 before the jvp Greeks were ported) ride the jvp
    stream: [6, 2], put deltas falling in the strike."""
    cfg = tengine.StreamConfig(n_paths=1024, n_steps=400, chunk_paths=512,
                               pilot_paths=512, fgn_form="spectral")
    chain = tengine.StreamingChainPricer(
        **BENCH_MARKET, strikes=[95.0, 105.0], maturity=400 * DT,
        is_call=False, config=cfg, device="cpu")
    assert tengine.chain_family(cfg) == chain.kernel_family == "factored"
    assert isinstance(chain.consts, pfc.FactoredConsts)
    assert chain.chain_consts.spectral
    prices = chain.price(0)
    assert prices.shape == (2,) and 0 < prices[0] < prices[1] < 105.0
    g, se = chain.price_and_greeks(0, with_stderr=True)
    assert g.shape == se.shape == (6, 2) and np.all(np.isfinite(g))
    assert g[1, 1] < g[1, 0] < 0 and np.all(g[0] > 0)


def test_factored_memory_model():
    """Shared memory per block fits the card up to 8,192 steps (N2 64, one
    path a block), and JAX's range at block 256 (to 4,096) is covered."""
    assert CAP == 8192
    m2 = 256
    while m2 <= CAP:
        assert pfc.smem_bytes(m2) <= pc.SMEM_LIMIT
        assert pfc.paths_per_block(m2) * m2 // pc.LANE == pfc.STAGE1_ROWS
        m2 *= 2
    assert pfc.smem_bytes(1825) == 108_096 and pfc.paths_per_block(1825) == 4
    assert pfc.smem_bytes(4000) == 108_096 and pfc.paths_per_block(4000) == 2
    for n in (129, 200, 1825, 4000, 4096):
        assert pfc.supports(n) and jf.supports(n)
    assert not pfc.supports(128) and not pfc.supports(CAP + 1)
    with pytest.raises(ValueError):
        consts_cpu(128)
