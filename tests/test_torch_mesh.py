"""The port's multi-device forms (``parallel/``, ``mesh=`` of both
streaming pricers, ``price_all(group=)``, ``BatchedPricer(mesh=)``,
``train_model(mesh=)``) at a world of two gloo processes on the CPU.

One spawn for the file: the fixture starts two ranks of
``tests/torch_mesh_worker.py`` on ``file://<tmp>/pg``, each runs every
sharded case and pickles its results; the tests hold them against the
JAX package at a mesh of 2 on the virtual CPU devices of
``tests/conftest.py`` (the regression, the LSM fit and the estimators on
the same split, ``StreamingPricer(mesh=)`` in distribution), and against
one process of the port (the rank-offset chunks summed, the pooled fits,
the PredictionGen CSV to the byte, the trainer to float32 reduction
order).  The kernels run their plain versions here; the card runs the
mesh at a world of one over NCCL (``chip_smoke.py --mesh``).
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

import torch_mesh_worker as W
from montecarlooptionspricer_tpu.models import asymptotic as jasym
from montecarlooptionspricer_tpu.models import branching as jbr
from montecarlooptionspricer_tpu.models import engine as jengine
from montecarlooptionspricer_tpu.models import lsm as jlsm
from montecarlooptionspricer_tpu.models import martingale as jmart
from montecarlooptionspricer_tpu.ops import reductions as jred
from montecarlooptionspricer_tpu.ops import regression as jreg
from montecarlooptionspricer_tpu.parallel import make_mesh as jax_mesh
from montecarlooptionspricer_tpu_torch.config import (
    MarketDefaults, PipelineConfig, PricingConfig)
from montecarlooptionspricer_tpu_torch.models import engine, lsm
from montecarlooptionspricer_tpu_torch.models import pathgen_cuda as pc
from montecarlooptionspricer_tpu_torch.models.pricing import PricerSpec
from montecarlooptionspricer_tpu_torch.ops.regression import (
    polyfit_from_numpy)
from montecarlooptionspricer_tpu_torch.parallel import (
    Mesh, init_distributed, sharded_price_rbergomi)
from montecarlooptionspricer_tpu_torch.parallel.mesh import mesh_device
from montecarlooptionspricer_tpu_torch.pipeline.driver import run_pipeline
from montecarlooptionspricer_tpu_torch.nn.trainer import BayesianTrainer
from test_pipeline import make_option_csv, make_spot_csv, opt_row

ROOT = Path(__file__).resolve().parents[1]
WORLD = 2
SIGMAS = 5.0
# A mesh of two without a process group: enough for the checks that raise
# before any collective.
FAKE = Mesh(None, 0, WORLD, torch.device("cpu"))


def _pipeline_inputs(work: Path) -> None:
    rng = np.random.default_rng(1234)
    spot = make_spot_csv(str(work / "nasdaq_stock_data.csv"), rng)
    s = round(spot["aapl"], 4)
    rows = [opt_row(option_type=i % 2, dte=30.0 + 5 * (i % 3), s=s,
                    sdp=0.02 * (-1) ** i) for i in range(7)]
    rows.insert(3, opt_row(option_type=0, dte=-3.0, s=s))   # a sentinel
    make_option_csv(str(work / "option_data.csv"), rows)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(rank 0's results, rank 1's, the work directory)."""
    work = tmp_path_factory.mktemp("mesh")
    _pipeline_inputs(work)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), os.environ.get("PYTHONPATH", "")]))
    logs = [open(work / f"rank{r}.log", "w") for r in range(WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_mesh_worker.py"),
         str(r), str(WORLD), str(work)], env=env, cwd=work, stdout=logs[r],
        stderr=subprocess.STDOUT) for r in range(WORLD)]
    try:
        rcs = [p.wait(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    for r, rc in enumerate(rcs):
        assert rc == 0, (work / f"rank{r}.log").read_text()[-3000:]
    out = [pickle.loads((work / f"rank{r}.pkl").read_bytes())
           for r in range(WORLD)]
    return out[0], out[1], work


def _sharded_jax(fn, *args):
    """``fn`` on a mesh of 2 virtual devices, every argument's leading
    axis split in halves, its (replicated) output read from shard 0."""
    mesh = jax_mesh(WORLD)
    sm = shard_map(lambda *a: jax.tree.map(lambda x: x[None], fn(*a)),
                   mesh=mesh, in_specs=(P("data"),) * len(args),
                   out_specs=P("data"))
    return jax.tree.map(lambda x: np.asarray(x)[0],
                        jax.jit(sm)(*(jnp.asarray(a) for a in args)))


def _close_in_stderr(a, a_se, b, b_se, what):
    a, a_se, b, b_se = (np.asarray(v, np.float64) for v in (a, a_se, b, b_se))
    bad = np.abs(a - b) > SIGMAS * np.sqrt(a_se ** 2 + b_se ** 2)
    assert not bad.any(), (what, a, a_se, b, b_se)


def _pricer(**kw):
    return engine.StreamingPricer(**W.MARKET, strike=W.STRIKE,
                                  maturity=W.MATURITY, is_call=False,
                                  config=W.stream_config(**kw), device="cpu")


def test_ranks_agree_and_mesh_shape(world):
    """Every rank returns the same numbers (the fits and totals pool over
    the group); make_mesh(3) in a world of 2 raises JAX's ValueError."""
    r0, r1, _ = world
    assert r0["mesh"] == (0, WORLD, "cpu") and r1["mesh"] == (1, WORLD,
                                                              "cpu")
    assert r0["too_big"] == ("requested a 3-device mesh but only 2 devices "
                             "are available") == r1["too_big"]
    for key in set(r0) - {"mesh", "pipeline", "resumed"}:
        assert pickle.dumps(r0[key]) == pickle.dumps(r1[key]), key
    assert "pipeline" not in r1     # rank 0 alone writes


def test_regression_matches_jax_sharded(world):
    """``fit_poly_masked(group)``, ``lsm_fit(group)`` and ``masked_mean``
    (an empty mask's 0 included) on halves of one numpy sample against
    JAX's with ``axis_name`` under ``shard_map`` on the same halves: 2e-5
    relative (float32 sums in another order)."""
    r0, _, _ = world
    x, y, w = W.regression_inputs()
    want = _sharded_jax(lambda b, c: jred.masked_mean(b, c, "data"), y, w)
    np.testing.assert_allclose(r0["masked_mean"][0], want, rtol=2e-5)
    assert r0["masked_mean"][1] == 0.0
    want = _sharded_jax(lambda a, b, c: tuple(jreg.fit_poly_masked(
        a, b, c, 2, axis_name="data")), x, y, w)
    for got, ref in zip(r0["fit"], want):
        np.testing.assert_allclose(got, ref, rtol=2e-5)
    pilot = W.gbm_paths(9, W.FIT_ROWS, W.N_STEPS)
    price, *fits = _sharded_jax(lambda p: (lambda o: (o[0], *o[1]))(
        jlsm.lsm_fit(p, 0.04, 105.0, W.MATURITY, W.DT, False,
                     axis_name="data")), pilot)
    np.testing.assert_allclose(r0["lsm_fit"][0], price, rtol=2e-5)
    for got, ref in zip(r0["lsm_fit"][1:], fits):
        np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)


def test_price_all_matches_jax_sharded(world):
    """The four estimators with a group, on halves of injected paths and
    each half's branch indices, against JAX's estimators with
    ``axis_name`` on the same halves: 1e-5 relative, as
    ``test_torch_pricers.py`` holds them."""
    r0, _, _ = world
    paths, rp = W.estimator_inputs()
    ex = jnp.arange(W.EST_STEPS)
    mat = W.EST_STEPS * W.DT
    args = (0.04, 104.0, mat, W.DT, False)

    def all4(p, b):
        return jnp.stack([
            jasym.asymptotic_price(p, *args, 0.25, 0.01, "data"),
            0.5 * (jbr.lower_bound(p, *args, ex, "data")
                   + jbr.upper_bound(p, *args, W.BRANCHES, ex,
                                     jax.random.key(0), "data", rp=b[0])),
            jlsm.lsm_price(p, *args, 2, "data"),
            jmart.martingale_price(p, *args, 2, 5, "data")])

    want = _sharded_jax(all4, paths, rp.reshape(WORLD, 1, *rp.shape[1:]))
    assert np.all(want > 0)
    np.testing.assert_allclose(r0["price_all"], want, rtol=1e-5)


def test_sharded_runners(world):
    """``sharded_price_rbergomi`` gives four finite prices, the sharded
    mean payoff of a lognormal call is its closed form within 5 stderr,
    and ``n_paths`` not divisible by the mesh raises ValueError."""
    r0, _, _ = world
    assert set(r0["sharded"]) == {"asymptotic", "branching", "lsm",
                                  "martingale"}
    assert all(np.isfinite(v) and v > 0 for v in r0["sharded"].values())
    closed = 100.0 * (2.0 * 0.5398278372770290 - 1.0)   # N(0.1) - N(-0.1)
    assert abs(r0["mean_payoff"] - closed) < SIGMAS * 100 * 0.2 / 64
    with pytest.raises(ValueError, match="not divisible by mesh size 2"):
        sharded_price_rbergomi(FAKE, PricerSpec(), 100.0, 0.04, 0.1, 1.0,
                               -0.3, 16, 513)


def _rank_chunks(pricer, fits, seed, n_paths):
    """Each rank's chunk totals, one process, from the rank-offset keys."""
    table = pricer._make_rows(fits)
    run, start = engine._pilot_stream_keys(seed)[1]
    per_rank = n_paths // (W.CHUNK * WORLD)
    return np.array([[float(pc.priced_chunk(
        pricer.consts, table, W.STRIKE, False, rows=W.CHUNK,
        key=pc._fold_words(run, start + ((r + 1) << 20) + i)))
        for i in range(per_rank)] for r in range(WORLD)], np.float64)


def test_sharded_pricer_exact(world):
    """Under a shared injected fit the world's price is the one-process
    sum of the same rank-offset chunks (1e-12 relative, each group's two
    totals summed in float32 as the stream sums them), its stderr that
    of their totals pooled to one center (1e-5: float32 squares)."""
    r0, _, _ = world
    pricer = _pricer()
    _, shared = lsm.lsm_fit(torch.from_numpy(W.shared_fit_paths()), 0.04,
                            W.STRIKE, W.MATURITY, W.DT, False)
    c = _rank_chunks(pricer, shared, W.SEED, W.N_PATHS).reshape(-1)
    price, se = r0["exact"]
    # Each group of chunks_per_call (2) chunks sums in float32 first.
    groups = c.astype(np.float32).reshape(-1, 2)
    total = (groups[:, 0] + groups[:, 1]).astype(np.float64).sum()
    assert abs(price / (total / W.N_PATHS) - 1.0) < 1e-12
    want_se = np.std(c, ddof=1) / np.sqrt(c.size) / W.CHUNK
    np.testing.assert_allclose(se, want_se, rtol=1e-5)


def test_sharded_pricer_pooled_fit(world):
    """``price`` fits on both ranks' pilots pooled: one process fitting
    the two rank-offset pilots at once and streaming the same chunks
    lands within 1e-4 of the world's price; the fits 2e-5."""
    r0, _, _ = world
    pricer = _pricer()
    run, index = engine._pilot_stream_keys(W.SEED)[0]
    pilot = torch.cat([pc.pathgen(pricer.consts, rows=W.PILOT,
                                  key=pc._fold_words(run, index + (
                                      (r + 1) << 20)))
                       for r in range(WORLD)])
    _, fits = lsm.lsm_fit(pilot, W.MARKET["r"], W.STRIKE, W.MATURITY, W.DT,
                          False)
    for got, ref in zip(r0["pooled_fit"], fits):
        np.testing.assert_allclose(got, ref.numpy(), rtol=2e-5, atol=2e-5)
    c = _rank_chunks(pricer, fits, W.SEED, W.N_PATHS)
    assert abs(r0["price"][0] / (c.sum() / W.N_PATHS) - 1.0) < 1e-4
    # The bounds stream the price's chunks: their lower side is the price.
    assert abs(r0["bounds"][0] / r0["price"][0] - 1.0) < 1e-6


def test_sharded_pricer_against_jax(world):
    """The port at a world of 2 against JAX's ``StreamingPricer(mesh=
    make_mesh(2))`` at the same configuration: within 5 combined stderr
    (the two packages' streams differ by construction)."""
    r0, _, _ = world
    cfg = jengine.StreamConfig(n_paths=W.N_PATHS, n_steps=W.N_STEPS,
                               chunk_paths=W.CHUNK, pilot_paths=W.PILOT,
                               dt=W.DT)
    j = jengine.StreamingPricer(**W.MARKET, strike=W.STRIKE,
                                maturity=W.MATURITY, is_call=False,
                                config=cfg, mesh=jax_mesh(WORLD))
    price, se = j.price(jax.random.key(W.SEED), with_stderr=True)
    _close_in_stderr(r0["price"][0], r0["price"][1], price, se, "price")


def test_sharded_methods_against_one_process(world):
    """Each method under the mesh (the bounds, K3's Greeks, the control
    variate, QMC, the K5 strip, K4's strip Greeks, a served traced-market
    quote) against the same method in one process on as many paths:
    within 5 combined stderr, elementwise.  The Greeks stream in one
    process under the world's pooled fits: a pathwise Greek moves with
    the policy at first order, and a stderr is conditional on its fit."""
    r0, _, _ = world
    seed = W.SEED
    one = _pricer()
    lo, up, lo_se, up_se = one.price_with_bounds(seed, with_stderr=True)
    _close_in_stderr(r0["bounds"][:2], r0["bounds"][2:], (lo, up),
                     (lo_se, up_se), "bounds")
    g, g_se = one.greeks_with_fit(
        polyfit_from_numpy(*r0["pooled_fit"], "cpu"), seed, with_stderr=True)
    _close_in_stderr(r0["greeks"][0], r0["greeks"][1], g, g_se, "greeks")
    for key, kw in (("cv", dict(control_variate=True)),
                    ("qmc", dict(qmc=True))):
        p, s = _pricer(**kw).price(seed, with_stderr=True)
        _close_in_stderr(r0[key][0], r0[key][1], p, s, key)
    chain = engine.StreamingChainPricer(
        **W.MARKET, strikes=W.STRIP, maturity=W.MATURITY, is_call=False,
        config=W.stream_config(), device="cpu")
    p, s = chain.price(seed, with_stderr=True)
    _close_in_stderr(r0["chain"][0], r0["chain"][1], p, s, "chain")
    p, s = chain.greeks_with_fit(
        polyfit_from_numpy(*r0["chain_fit"], "cpu"), seed, with_stderr=True)
    _close_in_stderr(r0["chain_greeks"][0], r0["chain_greeks"][1], p, s,
                     "chain_greeks")
    served = engine.StreamingChainPricer(
        **W.MARKET, strikes=W.STRIP, maturity=W.MATURITY, is_call=False,
        config=W.stream_config(chunk_paths=256, pilot_paths=256),
        device="cpu", bucketed=True, traced_market=True)
    p, s = served.price(seed, n_paths=2048, with_stderr=True,
                        n_steps_live=20, maturity=20 * W.DT,
                        market={"s0": 101.0})
    _close_in_stderr(r0["served"][0], r0["served"][1], p, s, "served")


def test_sharded_pricer_errors():
    """``n_paths`` not a multiple of chunk_paths x 2 and more than 256
    shards raise ValueError before any collective."""
    pricer = engine.StreamingPricer(
        **W.MARKET, strike=W.STRIKE, maturity=W.MATURITY, is_call=False,
        config=W.stream_config(), device="cpu", mesh=FAKE)
    with pytest.raises(ValueError, match="x 2 devices"):
        pricer.price(W.SEED, n_paths=3 * W.CHUNK)
    with pytest.raises(ValueError, match="256 shards"):
        engine.StreamingPricer(
            **W.MARKET, strike=W.STRIKE, maturity=W.MATURITY, is_call=False,
            config=W.stream_config(), device="cpu",
            mesh=Mesh(None, 0, 257, torch.device("cpu"))).price(
                W.SEED, n_paths=257 * W.CHUNK)
    engine._check_pallas_chunk_range(1, 256)


def test_prediction_gen_mesh_csv_byte_equal(world):
    """``run_pipeline(mesh=)`` at a world of 2 (batches of 3 rounded up to
    4, 2 rows a rank, a sentinel row) writes the one-process CSV byte for
    byte, and so do its resume after two rows and the CLI's
    ``--mesh-devices 2 --trace-dir``, each rank writing its trace."""
    r0, r1, work = world
    for key in ("pipeline_rc", "resume_rc", "cli_rc"):
        assert r0[key] == r1[key] == 0, key
    cfg = PipelineConfig(option_csv=str(work / "option_data.csv"),
                         spot_csv=str(work / "nasdaq_stock_data.csv"),
                         output_csv=str(work / "one_out.csv"),
                         error_log=str(work / "one_errors.txt"),
                         diagnostic_csv=str(work / "one_diag.csv"))
    assert run_pipeline(cfg, PricingConfig(num_paths=64, rows_per_batch=3,
                                           seed=5), MarketDefaults(),
                        device="cpu") == 0
    one = (work / "one_out.csv").read_text()
    assert len(one.splitlines()) == 9 and one.count(",0,0,0,0,0,0") == 1
    assert r0["pipeline"] == one
    assert r0["resumed"] == one
    assert (work / "cli_out.csv").read_text() == one
    assert len(list((work / "trace").glob("trace_*.json"))) == WORLD


def test_trainer_mesh_matches_one_process(world, tmp_path):
    """``train_model(mesh=)`` at a world of 2 against one process: the
    parameters within float32 reduction order, the same steps taken;
    with a padded last batch (its zero-weight rows all on rank 1) and,
    in the second run, a NaN row on rank 1 only, which skips the step on
    both ranks as on one process; ``batch_size % 2`` raises."""
    r0, _, _ = world
    x, y, x_nan = W.nn_data()
    for key, xs in (("train", x), ("train_nan", x_nan)):
        params, count, skipped = W.train(None, xs, y,
                                         str(tmp_path / f"ckpt_{key}"))
        got_params, got_count, got_skipped = r0[key]
        assert (got_count, got_skipped) == (count, skipped), key
        for name, ref in params.items():
            np.testing.assert_allclose(got_params[name], ref, rtol=1e-4,
                                       atol=2e-6, err_msg=name)
    assert r0["train_nan"][2] == 2 and r0["train"][2] == 0   # one an epoch
    t = BayesianTrainer(17, 64, device="cpu")
    with pytest.raises(ValueError, match="not divisible by mesh size 2"):
        t.train_model(x, y, num_epochs=1, batch_size=7, mesh=FAKE,
                      checkpoint_path=str(tmp_path / "none"))


def test_mesh_errors():
    """``init_distributed`` re-raises a failure that is not a second
    initialization and leaves no group; a mesh of another device type
    and a mesh that is no Mesh raise."""
    import torch.distributed as dist

    with pytest.raises(RuntimeError, match="rank < size"):
        init_distributed(backend="gloo", store=dist.HashStore(), rank=3,
                         world_size=2)
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="cannot run on device"):
        mesh_device(FAKE, "cuda")
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        mesh_device(object(), "cpu")
