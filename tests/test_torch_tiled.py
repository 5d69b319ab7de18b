"""The port's step-tiled long-horizon kernels (K6/K7 of
``pathgen_tiled_cuda``) through their wrappers on CPU tensors, which run
the plain versions, against the JAX package's chol slab kernels in
interpret mode on the same numpy noise; the long-horizon slice as a whole
against the JAX StreamingPricer in distribution; and the engine's choice
of kernel family.  The kernels themselves are held against these plain
versions on the card in test_torch_gpu.py."""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlooptionspricer_tpu.models import engine as jengine
from montecarlooptionspricer_tpu.models import pathgen_pallas as jpp
from montecarlooptionspricer_tpu.models import pathgen_pallas_tiled as jtiled
from montecarlooptionspricer_tpu_torch.models import engine as tengine
from montecarlooptionspricer_tpu_torch.models import pathgen_cuda as pc
from montecarlooptionspricer_tpu_torch.models import (
    pathgen_factored_cuda as pfc)
from montecarlooptionspricer_tpu_torch.models import pathgen_tiled_cuda as ptc

from test_torch_pathgen import (DT, KW, jax_pilot_fits, port_noise,
                                shared_noise, to_port_fits)

BENCH_MARKET = dict(s0=100.0, xi=0.04, h=0.1, eta=1.5, rho=-0.4, r=0.04)
N_STEPS, ROWS, BLOCK = 300, 512, 256     # 3 step tiles of 128 in JAX


def consts_cpu(n_steps=N_STEPS):
    return pc.make_path_consts(KW["s0"], KW["xi"], KW["h"], KW["eta"],
                               KW["r"], n_steps, DT, "cpu")


@functools.lru_cache(maxsize=None)
def pilot_fits(is_call: bool, strike: float):
    """JAX's LSM fit on a pilot from the interpreted chol kernel (one per
    option, shared by the cases that price it)."""
    rng = np.random.default_rng(7)
    _, fits = jax_pilot_fits(shared_noise(rng, ROWS, N_STEPS), strike,
                             N_STEPS * DT, is_call, n_steps=N_STEPS)
    return fits


def test_tiled_pathgen_matches_jax(rng):
    """rtol 2e-4: the fGN product and the log-price sum run in another
    float32 order than the TPU kernel's matmuls.  The padded tail of the
    JAX noise is 99.0 and must not leak into the paths."""
    noise = shared_noise(rng, ROWS, N_STEPS)
    noise[:, :, N_STEPS:] = 99.0
    gen, s_pad = jtiled.make_tiled_pathgen(
        **KW, n_steps=N_STEPS, dt=DT, chunk_paths=ROWS, block_paths=BLOCK,
        interpret=True, noise_input=True, fgn_form="chol")
    assert s_pad == 384
    want = np.asarray(gen(jnp.asarray(noise)))
    got = ptc.tiled_pathgen(consts_cpu(), noise=port_noise(noise, N_STEPS))
    assert got.shape == (ROWS, N_STEPS + 1)
    assert np.all(np.isfinite(got.numpy()))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4)


@pytest.mark.parametrize("is_call,strike,scale,rtol", [
    (False, 102.0, 1.0, 1e-4),
    (True, 98.0, 1.0, 1e-4),
    # Wild noise: paths exercise in tile 0 and must not contribute again
    # from a later tile; JAX's own tolerance for this case.
    (False, 102.0, 3.0, 5e-4),
])
def test_tiled_priced_chunk_matches_jax(rng, is_call, strike, scale, rtol):
    """Chunk payoff sums on shared noise under the same fit: rtol 1e-4 (a
    decision can flip only inside the float32 root band)."""
    maturity = N_STEPS * DT
    fits = pilot_fits(is_call, strike)
    noise = shared_noise(rng, ROWS, N_STEPS) * np.float32(scale)
    chunk_sum, _ = jtiled.make_tiled_priced_chunk(
        **KW, strike=strike, maturity=maturity, dt=DT, n_steps=N_STEPS,
        chunk_paths=ROWS, block_paths=BLOCK, is_call=is_call, interpret=True,
        noise_input=True, fgn_form="chol", policy_form="boundary")
    jrows = jpp.log_boundary_rows(jpp.boundary_rows(
        fits, KW["r"], strike, maturity, DT, N_STEPS, is_call))
    want = float(chunk_sum(jnp.asarray(noise), jrows))
    table = pc.log_boundary_rows(pc.boundary_rows(
        to_port_fits(fits), KW["r"], strike, maturity, DT, N_STEPS, is_call))
    got = float(ptc.tiled_priced_chunk(consts_cpu(), table, strike, is_call,
                                       noise=port_noise(noise, N_STEPS)))
    assert want > 0
    np.testing.assert_allclose(got, want, rtol=rtol)


def test_long_horizon_slice_in_distribution_matches_jax():
    """The port's seeded 1825-step price (the step-tiled family) against
    the JAX StreamingPricer's (XLA generator, another random stream):
    within 5 combined stderr."""
    n_steps, chunk, n_chunks, pilot, seed = 1825, 1024, 4, 2048, 0
    strike, maturity = 105.0, n_steps * DT
    cfg = tengine.StreamConfig(n_paths=n_chunks * chunk, n_steps=n_steps,
                               chunk_paths=chunk, pilot_paths=pilot, dt=DT)
    pricer = tengine.StreamingPricer(
        **BENCH_MARKET, strike=strike, maturity=maturity, is_call=False,
        config=cfg, device="cpu")
    assert pricer.kernel_family == "tiled"
    got, se_t = pricer.price(seed, with_stderr=True)
    jcfg = jengine.StreamConfig(n_paths=n_chunks * chunk, n_steps=n_steps,
                                chunk_paths=chunk, pilot_paths=pilot, dt=DT,
                                pathgen_impl="xla")
    want, se_j = jengine.StreamingPricer(
        **BENCH_MARKET, strike=strike, maturity=maturity, is_call=False,
        config=jcfg).price(jax.random.key(seed), with_stderr=True)
    assert 0 < se_t < 0.05 * got
    assert abs(got - want) < 5 * np.hypot(se_t, se_j), (got, want, se_t, se_j)


def test_kernel_family_by_horizon():
    """Single-tile up to the crossover, step-tiled past it (the 365-step
    main path stays single-tile), and the pricer routes through the
    family it names."""
    limit = tengine.SINGLE_TILE_MAX_STEPS
    assert limit >= 365 and pc.supports(limit)
    assert tengine.resolve_kernel_family(365) == "single"
    assert tengine.resolve_kernel_family(limit) == "single"
    assert tengine.resolve_kernel_family(limit + 1) == "tiled"
    assert tengine.resolve_kernel_family(1825) == "tiled"
    assert tengine.resolve_kernel_family(ptc.max_tiled_steps()) == "tiled"
    chunk_kernel = {"single": pc.priced_chunk,
                    "tiled": ptc.tiled_priced_chunk}
    for n_steps, family, impl in ((365, "single", "auto"),
                                  (1825, "tiled", "auto"),
                                  (1825, "tiled", "slab")):
        cfg = tengine.StreamConfig(n_paths=1024, n_steps=n_steps,
                                   chunk_paths=512, pilot_paths=512,
                                   tiled_impl=impl)
        pricer = tengine.StreamingPricer(**BENCH_MARKET, strike=100.0,
                                         maturity=n_steps * DT,
                                         is_call=False, config=cfg,
                                         device="cpu")
        assert pricer.kernel_family == family
        assert pricer._priced_chunk is chunk_kernel[family]


@pytest.mark.parametrize("field,value,family", [
    ("tiled_impl", "factored", "factored"),
    ("n_steps", pfc.max_factored_steps() + 1, "stream"),
])
def test_long_horizon_requests_resolve(field, value, family):
    """An explicit factored-DFT request at 1825 steps resolves to the
    factored family, and a horizon past K8's range, which raised before
    the generic path stream was ported, resolves to the stream."""
    kw = dict(n_paths=1024, n_steps=1825)
    kw[field] = value
    cfg = tengine.StreamConfig(**kw)
    assert tengine.resolve_kernel_family(
        cfg.n_steps, cfg.fgn_form, cfg.tiled_impl) == family


def test_tiled_memory_model():
    """Shared memory per block is fixed by the tile shapes and fits every
    block size; the horizon cap keeps Lt' inside L2; the block is the
    largest choice dividing the rows."""
    for bp in ptc.BLOCK_CHOICES:
        assert ptc.smem_bytes(bp) <= pc.SMEM_LIMIT
    assert ptc.smem_bytes(128) == 99_840
    cap = ptc.max_tiled_steps()
    assert 4 * cap * cap <= ptc.L2_BYTES < 4 * (cap + 1) ** 2
    assert ptc.supports(1825) and not ptc.supports(cap + 1)
    assert not ptc.supports(0)
    assert ptc.block_paths_for(1 << 17) == 128
    assert ptc.block_paths_for(96) == 32
    assert ptc.block_paths_for(48) == 16
    with pytest.raises(ValueError):
        ptc.block_paths_for(100)


def test_tiled_wrappers_on_cpu_equal_single_tile_plain_versions():
    """On CPU tensors both families run the same plain versions, seeded
    from the same Philox stream: K6/K7 compute K1/K2's function."""
    n_steps, rows, key = 40, 64, pc._fold_words(3, 1)
    consts = consts_cpu(n_steps)
    paths = ptc.tiled_pathgen(consts, rows=rows, key=key)
    torch.testing.assert_close(paths, pc.pathgen(consts, rows=rows, key=key),
                               rtol=0, atol=0)
    _, fits = tengine.lsm_fit(paths, KW["r"], 100.0, n_steps * DT, DT, False)
    table = tengine._fused_rows_builder(KW["r"], 100.0, n_steps * DT, DT,
                                        n_steps, False)(fits)
    got = ptc.tiled_priced_chunk(consts, table, 100.0, False, rows=rows,
                                 key=key)
    assert float(got) == float(pc.priced_chunk(consts, table, 100.0, False,
                                               rows=rows, key=key))
    with pytest.raises(ValueError):
        ptc.tiled_pathgen(consts, rows=rows)          # neither key nor noise


def test_cli_prices_long_horizon_on_cpu(capsys):
    """mcop-price-torch at 1825 steps takes the step-tiled family."""
    from montecarlooptionspricer_tpu_torch.cli import price as tcli

    rc = tcli.main(["--strike", "105", "--put", "--maturity", "7.242",
                    "--steps", "1825", "--paths", "2048", "--chunk-paths",
                    "1024", "--pilot-paths", "1024", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 0 and out["kernel_family"] == "tiled"
    assert out["n_steps"] == 1825 and out["n_paths"] == 2048
    assert 0 < out["price"] < 105 and out["stderr"] > 0


def test_cli_past_every_kernel_takes_the_stream(capsys, monkeypatch):
    """Past every kernel's horizon (exit 2 before the generic path stream
    was ported) the CLI prices on the stream and says so.  The kernels'
    caps are lowered to 300 steps here, so that a 400-step run is past
    them without an 8,193-step host matrix on the CPU."""
    from montecarlooptionspricer_tpu_torch.cli import price as tcli

    monkeypatch.setattr(ptc, "max_tiled_steps", lambda fgn_form="chol": 300)
    monkeypatch.setattr(pfc, "max_factored_steps", lambda: 300)
    assert tcli.main(["--steps", "400", "--maturity", "1.587", "--paths",
                      "512", "--chunk-paths", "256", "--pilot-paths", "256",
                      "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["kernel_family"] == "stream" and out["n_steps"] == 400
    assert 0 < out["price"] < 100 and out["stderr"] > 0
