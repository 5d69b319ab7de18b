"""The port's fit-then-stream slice as a whole against the JAX package:
on shared noise under one fit, and in distribution from seeds; plus the
engine's guards, the import boundary and the CLI."""

import json
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlooptionspricer_tpu.models import engine as jengine
from montecarlooptionspricer_tpu.models import pathgen_pallas as jpp
from montecarlooptionspricer_tpu_torch.cli import price as tcli
from montecarlooptionspricer_tpu_torch.models import engine as tengine

from test_torch_pathgen import (DT, KW, jax_pilot_fits, port_noise,
                                shared_noise, to_port_fits)

ROOT = Path(__file__).resolve().parents[1]
BENCH_MARKET = dict(s0=100.0, xi=0.04, h=0.1, eta=1.5, rho=-0.4, r=0.04)


def test_slice_on_shared_noise_matches_jax(rng):
    """Pilot noise -> JAX pilot paths and lsm_fit -> polyfit_from_numpy ->
    the port's tables and streamed sums on shared chunk noise, against the
    JAX chain on the same noise: rtol 1e-4 (float32 order; decisions flip
    only inside the root band)."""
    n_steps, chunk, n_chunks = 64, 512, 3
    strike, maturity, is_call = 103.0, n_steps * DT, False
    _, fits = jax_pilot_fits(shared_noise(rng, 1024, n_steps), strike,
                             maturity, is_call, n_steps=n_steps)
    chunks = [shared_noise(rng, chunk, n_steps) for _ in range(n_chunks)]

    chunk_sum, _ = jpp.make_pallas_priced_chunk(
        **KW, strike=strike, maturity=maturity, dt=DT, n_steps=n_steps,
        chunk_paths=chunk, block_paths=256, is_call=is_call, interpret=True,
        noise_input=True, fgn_form="chol", policy_form="boundary")
    rows = jpp.log_boundary_rows(jpp.boundary_rows(
        fits, KW["r"], strike, maturity, DT, n_steps, is_call))
    ex0, _ = jpp.time0_value(fits, KW["s0"], strike, is_call)
    assert not bool(ex0)
    want = sum(float(chunk_sum(jnp.asarray(c), rows)) for c in chunks)
    want /= n_chunks * chunk

    cfg = tengine.StreamConfig(n_paths=n_chunks * chunk, n_steps=n_steps,
                               chunk_paths=chunk, pilot_paths=1024, dt=DT,
                               chunks_per_call=2)
    pricer = tengine.StreamingPricer(**KW, strike=strike, maturity=maturity,
                                     is_call=is_call, config=cfg,
                                     device="cpu")
    noise = torch.stack([port_noise(c, n_steps) for c in chunks])
    got, se = pricer.price_with_fit(to_port_fits(fits), noise=noise,
                                    with_stderr=True)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert np.isfinite(se) and se > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_slice_in_distribution_matches_jax(seed):
    """The port's seeded price against the JAX StreamingPricer's (XLA
    generator, another random stream): within 5 combined stderr."""
    n_steps, chunk, n_chunks, pilot = 32, 2048, 8, 4096
    strike, maturity = 105.0, n_steps * DT
    cfg = tengine.StreamConfig(n_paths=n_chunks * chunk, n_steps=n_steps,
                               chunk_paths=chunk, pilot_paths=pilot, dt=DT)
    got, se_t = tengine.StreamingPricer(
        **BENCH_MARKET, strike=strike, maturity=maturity, is_call=False,
        config=cfg, device="cpu").price(seed, with_stderr=True)
    jcfg = jengine.StreamConfig(n_paths=n_chunks * chunk, n_steps=n_steps,
                                chunk_paths=chunk, pilot_paths=pilot, dt=DT,
                                pathgen_impl="xla")
    want, se_j = jengine.StreamingPricer(
        **BENCH_MARKET, strike=strike, maturity=maturity, is_call=False,
        config=jcfg).price(jax.random.key(seed), with_stderr=True)
    assert 0 < se_t < 0.05 * got
    assert abs(got - want) < 5 * np.hypot(se_t, se_j), (got, want, se_t, se_j)


def test_time0_exercise_collapses_exactly():
    """A deep-ITM put exercises at time 0 on every path: the price is the
    immediate payoff and every chunk total is the same (stderr 0)."""
    cfg = tengine.StreamConfig(n_paths=4 * 256, n_steps=16, chunk_paths=256,
                               pilot_paths=512, dt=DT)
    pricer = tengine.StreamingPricer(**BENCH_MARKET, strike=1000.0,
                                     maturity=16 * DT, is_call=False,
                                     config=cfg, device="cpu")
    price, se = pricer.price(3, with_stderr=True)
    assert price == 900.0 and se == 0.0


def test_chunk_stderr():
    assert np.isnan(tengine._chunk_stderr(10.0, 100.0, 1, 5))
    tot, sq = 12.5, 61.0
    np.testing.assert_allclose(tengine._chunk_stderr(tot, sq, 3, 7),
                               jengine._chunk_stderr(tot, sq, 3, 7),
                               rtol=1e-15)


def test_seed_carriers():
    """Pilot and stream carriers share the run word; the pilot's stream
    index lies past every admitted chunk index."""
    (run, pilot_idx), (run2, start) = tengine._pilot_stream_keys(7)
    assert run == run2 and 0 <= run < 2 ** 31 - 1
    assert start == 0 and pilot_idx == 3 << 28 > 1 << 20
    assert tengine._pilot_stream_keys(8)[0][0] != run
    tengine._check_pallas_chunk_range((1 << 20) - 1)
    with pytest.raises(ValueError):
        tengine._check_pallas_chunk_range(1 << 20)


@pytest.mark.parametrize("field,value", [("fgn_form", "spectral"),
                                         ("policy_form", "quadratic"),
                                         ("poly_order", 3),
                                         # past max_tiled_steps() (3,620)
                                         ("n_steps", 4000)])
def test_unported_configurations_raise(field, value):
    kw = dict(n_paths=1024, n_steps=32)
    kw[field] = value
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tengine.StreamConfig(**kw)


def test_default_device_is_cuda_without_fallback():
    cfg = tengine.StreamConfig(n_paths=1024, n_steps=16, chunk_paths=256,
                               pilot_paths=256)
    make = lambda: tengine.StreamingPricer(**BENCH_MARKET, strike=100.0,
                                           maturity=16 * DT, is_call=False,
                                           config=cfg)
    if torch.cuda.is_available():
        assert make().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def test_port_never_imports_jax():
    """No module of the port, nor chip_smoke.py, imports JAX or the JAX
    package: at run time (a fresh interpreter importing every module) and
    in the source (including imports inside functions)."""
    pkg = ROOT / "montecarlooptionspricer_tpu_torch"
    mods = sorted(
        "montecarlooptionspricer_tpu_torch." + ".".join(
            p.relative_to(pkg).with_suffix("").parts)
        for p in pkg.rglob("*.py") if p.name != "__init__.py")
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "spec = importlib.util.spec_from_file_location('cs', "
            f"{str(ROOT / 'chip_smoke.py')!r})\n"
            "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'montecarlooptionspricer_tpu' or "
            "m.startswith('montecarlooptionspricer_tpu.')]\n"
            "print(len(sys.modules), bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("[]"), out.stdout
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax\b|montecarlooptionspricer_tpu\b(?!_))",
        re.M)
    for path in [*pkg.rglob("*.py"), ROOT / "chip_smoke.py"]:
        assert not pattern.search(path.read_text()), path


def test_cli_prices_on_cpu(capsys):
    rc = tcli.main(["--strike", "102", "--put", "--maturity", "0.12",
                    "--steps", "24", "--paths", "4096", "--chunk-paths",
                    "2048", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 0
    assert set(out) == {"price", "stderr", "n_paths", "n_steps", "is_call",
                        "elapsed_s"}
    assert out["n_paths"] == 4096 and out["n_steps"] == 24
    assert out["price"] > 0 and out["stderr"] > 0 and not out["is_call"]


@pytest.mark.parametrize("flag", ["--greeks", "--bounds", "--serve", "--qmc",
                                  "--antithetic", "--control-variate",
                                  "--strikes=95,100"])
def test_cli_unported_flags_exit_2(capsys, flag):
    assert tcli.main([flag, "--device", "cpu"]) == 2
    assert "not yet ported" in capsys.readouterr().err


@pytest.mark.parametrize("is_call,strike", [(False, 102.0), (True, 98.0)])
def test_policy_value_oracle_matches_jax_and_fused_plain(rng, is_call,
                                                         strike):
    """lsm_policy_path_values (the quadratic policy on whole paths) against
    JAX's on the same paths and fit (rtol 1e-5), and the fused plain
    version (paths + log-boundary policy) against it on the port's own
    paths (rtol 1e-4: interval and quadratic decisions differ only inside
    the float32 root band)."""
    n_steps, rows = 96, 512
    maturity = n_steps * DT
    _, fits = jax_pilot_fits(shared_noise(rng, rows, n_steps), strike,
                             maturity, is_call, n_steps=n_steps)
    tfits = to_port_fits(fits)
    noise = shared_noise(rng, rows, n_steps)
    consts = tengine.pathgen_cuda.make_path_consts(
        KW["s0"], KW["xi"], KW["h"], KW["eta"], KW["r"], n_steps, DT, "cpu")
    paths = tengine.pathgen_cuda.pathgen_from_noise_ref(
        consts, port_noise(noise, n_steps))
    want = np.asarray(jengine.lsm_policy_path_values(
        jnp.asarray(paths.numpy()), fits, KW["r"], strike, maturity, DT,
        is_call))
    got = tengine.lsm_policy_path_values(paths, tfits, KW["r"], strike,
                                         maturity, DT, is_call)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)

    total, count = tengine.lsm_policy_value(paths, tfits, KW["r"], strike,
                                            maturity, DT, is_call)
    assert count == rows
    table = tengine._fused_rows_builder(KW["r"], strike, maturity, DT,
                                        n_steps, is_call)(tfits)
    fused = tengine.pathgen_cuda.priced_chunk_from_noise_ref(
        consts, table, port_noise(noise, n_steps), strike, is_call)
    ex0, _ = tengine.pathgen_cuda.time0_value(tfits, KW["s0"], strike,
                                              is_call)
    assert not bool(ex0)
    np.testing.assert_allclose(float(fused), float(total), rtol=1e-4)
