"""The bf16 fGN-input forms of the strike-chain kernel K5 and the Greeks
kernels K3/K4 (``StreamConfig.fgn_matmul_dtype="bfloat16"``) against the
JAX package: dLt' bit for bit, the plain versions (which the wrappers run
on CPU tensors) against JAX's interpreted kernels built with
``fgn_dtype=jnp.bfloat16`` on the same numpy noise and tables, their
memory models, and a seeded strip and seeded Greeks beside the float32
ones.  The kernels themselves are held against these plain versions on
the card in test_torch_gpu.py.

Sums are held at 1e-4 (K5, per strike, floored at 1e-3 of the
strip's largest sum) and at 2e-4 of each Greek's scale (K3/K4).  The
plain version and JAX's kernel take the same float32 products of the same
bf16 values and sum them in other orders (at most 2.2e-6 apart here); the
float32 form lies 1.6e-5 to 5e-3 from JAX's bf16 kernel, inside those
tolerances on some strips, so each case also shows the float32 form at
least BF16_CLOSER times farther from JAX's than the bf16 plain version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlooptionspricer_tpu.models import pathgen_pallas as jpp
from montecarlooptionspricer_tpu_torch.models import chain_cuda as cc
from montecarlooptionspricer_tpu_torch.models import engine as tengine
from montecarlooptionspricer_tpu_torch.models import greeks_cuda as gc
from montecarlooptionspricer_tpu_torch.models import pathgen_cuda as pc

from test_torch_chain import STRIP3, STRIP13, jax_strip_fits
from test_torch_greeks import scaled_err, strip_tables
from test_torch_pathgen import (DT, KW, jax_pilot_fits, port_noise,
                                shared_noise)
from test_torch_quadratic import jax_strip_policy, noise_planes, port
from test_torch_tiled import BENCH_MARKET

BF16 = "bfloat16"
N_STEPS, ROWS, BLOCK = 48, 256, 128
SUM_RTOL = 1e-4
GREEKS_RTOL = 2e-4
BF16_CLOSER = 10.0


def path_consts(fgn_form="chol", fgn_dtype=BF16, n_steps=N_STEPS):
    return pc.make_path_consts(KW["s0"], KW["xi"], KW["h"], KW["eta"],
                               KW["r"], n_steps, DT, "cpu",
                               fgn_form=fgn_form, fgn_dtype=fgn_dtype)


def greeks_consts(fgn_dtype=BF16, n_steps=N_STEPS):
    return (path_consts(fgn_dtype=fgn_dtype, n_steps=n_steps),
            pc.make_greeks_consts(KW["xi"], KW["h"], KW["eta"], n_steps, DT,
                                  "cpu", fgn_dtype=fgn_dtype))


def strip_err(got, want):
    """Largest |got - want| over each strike's sum, floored at 1e-3 of
    the strip's largest (a deep out-of-the-money sum is ~0)."""
    scale = np.maximum(np.abs(want), 1e-3 * np.max(np.abs(want)))
    return float(np.max(np.abs(got - want) / scale))


@pytest.mark.parametrize("n_steps", [32, 96])
def test_bf16_dlt_is_jax_bit_for_bit(n_steps):
    """dLt' of the bf16 Greeks constants equals JAX's ``_greeks_consts(...,
    jnp.bfloat16)`` matrix bit for bit (the float64 matrix rounded to bf16,
    then halved); the tangent rows stay float32, equal to JAX's aux rows;
    the constants carry their dtype."""
    s_pad = pc._round_up(n_steps, pc.LANE)
    _, dlt, _, _, aux = jpp._greeks_consts(n_steps, s_pad, KW["xi"],
                                           KW["h"], KW["eta"], DT,
                                           jnp.bfloat16)
    g = pc.make_greeks_consts(KW["xi"], KW["h"], KW["eta"], n_steps, DT,
                              "cpu", fgn_dtype=BF16)
    assert g.dlt_half.dtype == torch.bfloat16 and g.bf16
    np.testing.assert_array_equal(
        g.dlt_half.view(torch.int16).numpy().view(np.uint16),
        np.asarray(dlt)[:n_steps, :n_steps].view(np.uint16))
    np.testing.assert_array_equal(g.de.numpy(), np.asarray(aux)[1, :n_steps])
    np.testing.assert_array_equal(g.dh.numpy(), np.asarray(aux)[2, :n_steps])
    assert not pc.make_greeks_consts(KW["xi"], KW["h"], KW["eta"], n_steps,
                                     DT, "cpu").bf16


@pytest.mark.parametrize("fgn_form,antithetic,policy_form,strikes", [
    ("chol", False, "boundary", STRIP3),
    ("chol", True, "boundary", STRIP13),
    ("spectral", False, "boundary", STRIP13),
    ("spectral", True, "boundary", STRIP3),
    ("chol", False, "quadratic", STRIP3),
    ("spectral", False, "quadratic", STRIP13),
], ids=["bf16", "bf16-anti", "bf16-spectral", "bf16-spectral-anti",
        "bf16-quad", "bf16-spectral-quad"])
def test_k5_bf16_matches_jax(rng, fgn_form, antithetic, policy_form,
                             strikes):
    """Plain K5/bf16 in each of its six forms against
    ``make_pallas_priced_chain(fgn_dtype=jnp.bfloat16, noise_input=True,
    interpret=True)`` on the same noise and tables (13 strikes: JAX's two
    regenerated groups): 1e-4 per strike; the float32 form on the same
    noise lies BF16_CLOSER times farther from JAX's bf16 kernel."""
    if policy_form == "quadratic":
        _, jtab = jax_strip_policy(N_STEPS, strikes, False)
    else:
        paths, _ = jax_pilot_fits(shared_noise(rng, 512, N_STEPS), 100.0,
                                  N_STEPS * DT, False, n_steps=N_STEPS)
        _, jtab = jax_strip_fits(paths, strikes, False)
    noise = noise_planes(rng, fgn_form, ROWS // 2 if antithetic else ROWS,
                         N_STEPS, scale=1.0)
    chain, _ = jpp.make_pallas_priced_chain(
        **KW, strikes=strikes, maturity=N_STEPS * DT, dt=DT,
        n_steps=N_STEPS, chunk_paths=ROWS, block_paths=BLOCK, is_call=False,
        interpret=True, noise_input=True, fgn_form=fgn_form,
        policy_form=policy_form, antithetic=antithetic,
        fgn_dtype=jnp.bfloat16)
    want = np.asarray(chain(jnp.asarray(noise), jtab))
    tables = torch.tensor(np.asarray(jtab))
    got, f32 = (cc.priced_chain(path_consts(fgn_form, dtype), tables, False,
                                noise=port(noise, N_STEPS),
                                antithetic=antithetic,
                                policy_form=policy_form).numpy()
                for dtype in (BF16, "float32"))
    assert got.shape == (len(strikes),) and want.max() > 0
    err, err32 = strip_err(got, want), strip_err(f32, want)
    assert err < SUM_RTOL, err
    assert err * BF16_CLOSER < err32, (err, err32)


@pytest.mark.parametrize("antithetic", [False, True], ids=["plain", "anti"])
def test_k3_bf16_matches_jax(rng, antithetic):
    """Plain K3/bf16 (K3/bf16/anti) against ``make_pallas_greeks_chunk(
    fgn_dtype=jnp.bfloat16)`` in interpret mode on the same noise and
    table, all six outputs at 2e-4 of each output's scale; the float32
    form lies BF16_CLOSER times farther from it."""
    strike = 99.0
    _, ltab = strip_tables(rng, [strike], False)
    greeks, _ = jpp.make_pallas_greeks_chunk(
        **KW, strike=strike, maturity=N_STEPS * DT, dt=DT, n_steps=N_STEPS,
        chunk_paths=ROWS, block_paths=BLOCK, is_call=False, interpret=True,
        noise_input=True, fgn_dtype=jnp.bfloat16, antithetic=antithetic)
    noise = shared_noise(rng, ROWS // 2 if antithetic else ROWS, N_STEPS)
    want = np.asarray(greeks(jnp.asarray(noise), ltab[0]))
    got, f32 = (gc.greeks_chunk(*greeks_consts(dtype),
                                torch.tensor(np.asarray(ltab[0])), strike,
                                False, noise=port_noise(noise, N_STEPS),
                                antithetic=antithetic).numpy()
                for dtype in (BF16, "float32"))
    assert got.shape == (6,) and want[0] > 0
    err = float(np.max(scaled_err(got, want)))
    err32 = float(np.max(scaled_err(f32, want)))
    assert err < GREEKS_RTOL, (got, want)
    assert err * BF16_CLOSER < err32, (err, err32)


@pytest.mark.parametrize("antithetic", [False, True], ids=["plain", "anti"])
def test_k4_bf16_matches_jax(rng, antithetic):
    """Plain K4/bf16 (K4/bf16/anti) on 13 strikes against
    ``make_pallas_chain_greeks_chunk(fgn_dtype=jnp.bfloat16)`` (JAX's two
    regenerated groups) in interpret mode: 2e-4 of each output's scale
    per strike, the float32 form BF16_CLOSER times farther; each strike's
    column equals plain K3/bf16 on the same noise and table (rtol 1e-6)."""
    _, ltab = strip_tables(rng, STRIP13, False)
    chain, _ = jpp.make_pallas_chain_greeks_chunk(
        **KW, strikes=len(STRIP13), maturity=N_STEPS * DT, dt=DT,
        n_steps=N_STEPS, chunk_paths=ROWS, block_paths=BLOCK, is_call=False,
        interpret=True, noise_input=True, fgn_dtype=jnp.bfloat16,
        antithetic=antithetic)
    noise = shared_noise(rng, ROWS // 2 if antithetic else ROWS, N_STEPS)
    want = np.asarray(chain(jnp.asarray(noise), ltab))
    tables = torch.tensor(np.asarray(ltab))
    tnoise = port_noise(noise, N_STEPS)
    consts, g = greeks_consts()
    got, f32 = (gc.chain_greeks_chunk(*greeks_consts(dtype), tables, False,
                                      noise=tnoise,
                                      antithetic=antithetic).numpy()
                for dtype in (BF16, "float32"))
    assert got.shape == want.shape == (6, len(STRIP13))
    errs = [float(np.max(scaled_err(o[:, j], want[:, j])))
            for o in (got, f32) for j in range(len(STRIP13))]
    err, err32 = max(errs[:len(STRIP13)]), max(errs[len(STRIP13):])
    assert err < GREEKS_RTOL and err * BF16_CLOSER < err32, (err, err32)
    for j in (0, 6, 12):
        one = gc.greeks_chunk(consts, g, tables[j], STRIP13[j], False,
                              noise=tnoise, antithetic=antithetic)
        np.testing.assert_allclose(got[:, j], one.numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_k5_bf16_memory_model():
    """K5's bf16 block takes no more shared memory than the float32 block
    in every form and horizon (its N and Zi planes and staged tiles are
    bf16), so the block it chooses is never smaller: spectral 64 paths
    (128 paired) at 365 and 512 steps where float32 takes 32 (64).  The
    numbers are the card's model (csrc/chain.cu smem_bytes, held equal on
    the card)."""
    for n in (48, 365, 400, 512):
        for spec in (False, True):
            for anti, choices in ((False, pc.BLOCK_CHOICES),
                                  (True, pc.PAIRED_BLOCK_CHOICES)):
                for bp in choices:
                    assert cc.smem_bytes(n, bp, anti, spec, bf16=True) <= \
                        cc.smem_bytes(n, bp, anti, spec)
                assert cc.block_paths_for(n, 1 << 17, anti, spec, True) >= \
                    cc.block_paths_for(n, 1 << 17, anti, spec)
    # 64 drawn rows at 365 steps: N 64 x 376 bf16 (no W plane), the X tile
    # 64 x 65, one staged [64][40] bf16 tile and the lo and hi rows of 32
    # strikes for one 64-column tile.
    assert cc.smem_bytes(365, 64, bf16=True) == 4 * (
        64 * 376 // 2 + 64 * 65 + 64 * 40 // 2 + 32 * 2 * 64)
    blocks = {(n, anti, spec): cc.block_paths_for(n, 1 << 17, anti, spec,
                                                  True)
              for n in (365, 512) for anti in (False, True)
              for spec in (False, True)}
    assert blocks == {(365, False, False): 64, (365, True, False): 128,
                      (365, False, True): 64, (365, True, True): 128,
                      (512, False, False): 64, (512, True, False): 128,
                      (512, False, True): 64, (512, True, True): 128}


def test_k3_k4_bf16_memory_model():
    """The Greeks kernels' bf16 block: the bf16 N plane and two staged
    bf16 tiles (Lt' and dLt' side by side) take no more shared memory
    than the float32 block, so the block is never smaller: 64 paths at
    365 steps as in float32, 128 pair members where float32 takes 64."""
    for n in (48, 96, 365):
        for anti, choices in ((False, pc.BLOCK_CHOICES),
                              (True, pc.PAIRED_BLOCK_CHOICES)):
            for bp in choices:
                assert gc.smem_bytes(n, bp, anti, bf16=True) <= \
                    gc.smem_bytes(n, bp, anti)
            assert gc.block_paths_for(n, 1 << 17, anti, True) >= \
                gc.block_paths_for(n, 1 << 17, anti)
    assert gc.smem_bytes(365, 64, bf16=True) == 4 * (
        64 * 376 // 2 + 4 * 64 * 65 + 2 * 64 * 40 // 2 + 32 * 2 * 64)
    assert (gc.block_paths_for(365, 1 << 17, False, True),
            gc.block_paths_for(365, 1 << 17, True, True)) == (64, 128)


def test_greeks_refuse_other_dtype_constants():
    """Greeks constants of the other fGN input dtype than the path
    constants, or a dLt' of the wrong dtype, raise ValueError before any
    product (so no body mixes the two forms)."""
    consts, g = greeks_consts()
    consts32, g32 = greeks_consts("float32")
    noise = torch.zeros((2, 32, N_STEPS))
    table = torch.zeros((8, N_STEPS))
    for c, gg in ((consts, g32), (consts32, g)):
        with pytest.raises(ValueError, match="gconsts"):
            gc.greeks_chunk(c, gg, table, 100.0, False, noise=noise)
        with pytest.raises(ValueError, match="gconsts"):
            gc.chain_greeks_chunk(c, gg, table[None], False, noise=noise)
    bad = type(g)(dlt_half=g32.dlt_half, de=g.de, dh=g.dh, xi=g.xi,
                  eta=g.eta, fgn_dtype=BF16)
    with pytest.raises(ValueError, match="dlt_half"):
        gc.greeks_chunk(consts, bad, table, 100.0, False, noise=noise)


@pytest.mark.parametrize("greeks", [False, True], ids=["strip", "greeks"])
def test_bf16_strip_and_greeks_within_mc_noise_of_float32(greeks):
    """A seeded strip (K5) and seeded strip Greeks (K4) and single-strike
    Greeks (K3) under bf16 lie within 0.05 of the float32 ones of the same
    seed at 2^13 paths x 32 steps (the JAX package's bf16 check,
    tests/test_engine.py:test_bf16_fgn_price_within_mc_stderr), and differ
    from them (the bf16 form ran)."""
    base = dict(n_paths=1 << 13, n_steps=32, chunk_paths=1 << 12,
                pilot_paths=1 << 11)
    out = {}
    for dtype in ("float32", BF16):
        cfg = tengine.StreamConfig(**base, fgn_matmul_dtype=dtype)
        chain = tengine.StreamingChainPricer(
            **BENCH_MARKET, strikes=[98.0, 102.0], maturity=32 / 252.0,
            is_call=False, config=cfg, device="cpu")
        assert chain.kernel_family == "single"
        assert chain.chain_consts.bf16 == (dtype == BF16)
        if not greeks:
            out[dtype] = chain.price(5)
            continue
        one = tengine.StreamingPricer(**BENCH_MARKET, strike=102.0,
                                      maturity=32 / 252.0, is_call=False,
                                      config=cfg, device="cpu")
        assert one.greeks_consts.bf16 == (dtype == BF16)
        out[dtype] = np.concatenate([chain.price_and_greeks(5).ravel(),
                                     one.price_and_greeks(5)])
    diff = np.abs(out["float32"] - out[BF16])
    assert np.all(diff < 0.05) and np.any(diff > 0), diff
