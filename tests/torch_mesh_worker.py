"""One rank of the gloo world that ``tests/test_torch_mesh.py`` starts:

    python tests/torch_mesh_worker.py RANK WORLD WORKDIR

Joins the process group on ``file://WORKDIR/pg``, runs every sharded case
of the port on the CPU (their inputs made here from numpy seeds, or read
from WORKDIR), and pickles its results to ``WORKDIR/rank<RANK>.pkl``.
The test holds them against the JAX package and against one process.
This file imports no JAX: the ranks run the port alone.
"""

from __future__ import annotations

import os
import pickle
import sys

import numpy as np
import torch

MARKET = dict(s0=100.0, xi=0.04, h=0.2, eta=1.0, rho=-0.4, r=0.04)
STRIKE = 102.0
N_STEPS = 32
DT = 1.0 / 252.0
MATURITY = N_STEPS * DT
CHUNK = 1024
PILOT = 512
N_PATHS = 16 * CHUNK
SEED = 5
STRIP = (96.0, 102.0, 108.0)
# The regression and estimator inputs: the whole sample, split in halves.
FIT_ROWS = 512
EST_PATHS = 256
EST_STEPS = 16
BRANCHES = 4
# The trainer: 37 rows in batches of 8 (the last padded with 3 zero-weight
# rows, all on rank 1), a NaN feature on row 13 (rank 1's half of batch 2).
NN_ROWS, NN_BATCH, NN_NAN_ROW = 37, 8, 13


def stream_config(**kw):
    from montecarlooptionspricer_tpu_torch.models import engine

    base = dict(n_paths=N_PATHS, n_steps=N_STEPS, chunk_paths=CHUNK,
                pilot_paths=PILOT, dt=DT, chunks_per_call=2)
    base.update(kw)
    return engine.StreamConfig(**base)


def regression_inputs():
    """(x, y, w) float32 [FIT_ROWS]: a noisy quadratic, w a {0, 1} mask."""
    rng = np.random.default_rng(7)
    x = rng.uniform(80.0, 120.0, FIT_ROWS).astype(np.float32)
    y = (0.02 * (x - 100.0) ** 2 + rng.normal(0.0, 1.0, FIT_ROWS)).astype(
        np.float32)
    w = (rng.uniform(size=FIT_ROWS) < 0.7).astype(np.float32)
    return x, y, w


def gbm_paths(seed: int, n: int, steps: int) -> np.ndarray:
    """[n, steps + 1] float32 GBM paths from 100 at 25 % a year."""
    rng = np.random.default_rng(seed)
    inc = (0.04 - 0.5 * 0.0625) * DT + 0.25 * np.sqrt(DT) \
        * rng.standard_normal((n, steps))
    logs = np.concatenate([np.zeros((n, 1)), np.cumsum(inc, axis=1)], 1)
    return (100.0 * np.exp(logs)).astype(np.float32)


def estimator_inputs():
    """(paths [EST_PATHS, EST_STEPS + 1], rp [2, EST_PATHS / 2, EST_STEPS,
    BRANCHES]): each half's branch indices point into that half."""
    paths = gbm_paths(11, EST_PATHS, EST_STEPS)
    rng = np.random.default_rng(12)
    rp = rng.integers(0, EST_PATHS // 2,
                      (2, EST_PATHS // 2, EST_STEPS, BRANCHES))
    return paths, rp


def shared_fit_paths() -> np.ndarray:
    """The pilot of the injected shared fit (one process fits it)."""
    return gbm_paths(13, PILOT, N_STEPS)


def nn_data():
    rng = np.random.default_rng(21)
    x = rng.normal(size=(NN_ROWS, 17)).astype(np.float32)
    y = (1.0 + 0.5 * x[:, 0] - 0.2 * x[:, 3]).astype(np.float32)
    x_nan = x.copy()
    x_nan[NN_NAN_ROW, 2] = np.nan
    return x, y, x_nan


def train(mesh, x, y, ckpt: str):
    """A small trainer's state after 2 epochs (1 warm-up, 1 NLL):
    (parameters, Adam's count, non-finite steps)."""
    from montecarlooptionspricer_tpu_torch.config import TrainConfig
    from montecarlooptionspricer_tpu_torch.nn.trainer import BayesianTrainer

    t = BayesianTrainer(17, 64, config=TrainConfig(warmup_epochs=1, seed=3),
                        device="cpu")
    t.train_model(x, y, num_epochs=2, batch_size=NN_BATCH,
                  checkpoint_path=ckpt, mesh=mesh)
    return ({k: v.numpy().copy() for k, v in t.model.state_dict().items()},
            int(t.optimizer.count), int(t.optimizer.total_notfinite))


def _split(a, rank: int):
    half = a.shape[0] // 2
    return a[rank * half:(rank + 1) * half]


def _np_fit(fit):
    return tuple(np.asarray(f.numpy()) for f in fit)


def run(rank: int, world: int, work: str) -> dict:
    import torch.distributed as dist

    from montecarlooptionspricer_tpu_torch.config import (
        MarketDefaults, PipelineConfig, PricingConfig)
    from montecarlooptionspricer_tpu_torch.models import engine, lsm
    from montecarlooptionspricer_tpu_torch.models.pricing import (
        PricerSpec, price_all)
    from montecarlooptionspricer_tpu_torch.ops.reductions import masked_mean
    from montecarlooptionspricer_tpu_torch.ops.regression import (
        fit_poly_masked)
    from montecarlooptionspricer_tpu_torch.parallel import (
        init_distributed, make_mesh, sharded_mean_payoff,
        sharded_price_rbergomi)
    from montecarlooptionspricer_tpu_torch.pipeline.driver import (
        run_pipeline)

    init_distributed(backend="gloo", init_method=f"file://{work}/pg",
                     rank=rank, world_size=world)
    # A second initialization is a no-op.
    init_distributed(backend="gloo", init_method=f"file://{work}/pg",
                     rank=rank, world_size=world)
    out = {}
    try:
        make_mesh(world + 1, "cpu")
    except ValueError as e:
        out["too_big"] = str(e)
    mesh = make_mesh(world, "cpu")
    group = mesh.group
    out["mesh"] = (mesh.rank, mesh.size, str(mesh.device))

    # Regression and the LSM fit on this rank's half of the sample.
    x, y, w = (torch.from_numpy(_split(a, rank)) for a in regression_inputs())
    out["fit"] = _np_fit(fit_poly_masked(x, y, w, 2, group=group))
    out["masked_mean"] = (float(masked_mean(y, w, group)),
                          float(masked_mean(y, 0.0 * w, group)))
    pilot = torch.from_numpy(_split(gbm_paths(9, FIT_ROWS, N_STEPS), rank))
    price, fits = lsm.lsm_fit(pilot, 0.04, 105.0, MATURITY, DT, False,
                              group=group)
    out["lsm_fit"] = (float(price), *_np_fit(fits))

    # The four estimators on this rank's half of injected paths.
    paths, rp = estimator_inputs()
    spec = PricerSpec(r=0.04, strike=104.0, maturity=EST_STEPS * DT, dt=DT,
                      is_call=False, sigma=0.25, dividend=0.01,
                      num_branches=BRANCHES)
    out["price_all"] = price_all(
        torch.from_numpy(_split(paths, rank))[None], spec,
        torch.from_numpy(rp[rank])[None], group=group)[0].numpy()
    out["sharded"] = sharded_price_rbergomi(
        mesh, spec, 100.0, 0.04, 0.15, 1.5, -0.3, EST_STEPS, 512)(3)
    out["mean_payoff"] = sharded_mean_payoff(
        mesh, lambda p: torch.clamp_min(p[:, -1] - 100.0, 0.0),
        lambda gen, n: torch.exp(0.2 * torch.randn(n, 2, generator=gen)
                                 ) * 100.0, 4096)(4)

    # Both streaming pricers, every method, under the mesh.
    pricer = engine.StreamingPricer(**MARKET, strike=STRIKE,
                                    maturity=MATURITY, is_call=False,
                                    config=stream_config(), device="cpu",
                                    mesh=mesh)
    _, shared = lsm.lsm_fit(torch.from_numpy(shared_fit_paths()), 0.04,
                            STRIKE, MATURITY, DT, False)
    out["exact"] = pricer.price_with_fit(shared, SEED, with_stderr=True)
    out["pooled_fit"] = _np_fit(pricer.fit(
        engine._pilot_stream_keys(SEED)[0]))
    out["price"] = pricer.price(SEED, with_stderr=True)
    out["bounds"] = pricer.price_with_bounds(SEED, with_stderr=True)
    out["greeks"] = pricer.price_and_greeks(SEED, with_stderr=True)
    out["cv"] = engine.StreamingPricer(
        **MARKET, strike=STRIKE, maturity=MATURITY, is_call=False,
        config=stream_config(control_variate=True), device="cpu",
        mesh=mesh).price(SEED, with_stderr=True)
    out["qmc"] = engine.StreamingPricer(
        **MARKET, strike=STRIKE, maturity=MATURITY, is_call=False,
        config=stream_config(qmc=True), device="cpu",
        mesh=mesh).price(SEED, with_stderr=True)
    chain = engine.StreamingChainPricer(
        **MARKET, strikes=STRIP, maturity=MATURITY, is_call=False,
        config=stream_config(), device="cpu", mesh=mesh)
    out["chain"] = chain.price(SEED, with_stderr=True)
    out["chain_fit"] = _np_fit(chain.fit(engine._pilot_stream_keys(SEED)[0]))
    out["chain_greeks"] = chain.price_and_greeks(SEED, with_stderr=True)
    served = engine.StreamingChainPricer(
        **MARKET, strikes=STRIP, maturity=MATURITY, is_call=False,
        config=stream_config(chunk_paths=256, pilot_paths=256),
        device="cpu", bucketed=True, traced_market=True, mesh=mesh)
    out["served"] = served.price(SEED, n_paths=2048, with_stderr=True,
                                 n_steps_live=20, maturity=20 * DT,
                                 market={"s0": 101.0})

    # The PredictionGen pipeline: a run, then a resume after rank 0 cuts
    # the output back to two rows; rank 0 alone writes.
    cfg = PipelineConfig(option_csv=f"{work}/option_data.csv",
                         spot_csv=f"{work}/nasdaq_stock_data.csv",
                         output_csv=f"{work}/mesh_out.csv",
                         error_log=f"{work}/mesh_errors.txt",
                         diagnostic_csv=f"{work}/mesh_diag.csv")
    pricing = PricingConfig(num_paths=64, rows_per_batch=3, seed=5)
    out["pipeline_rc"] = run_pipeline(cfg, pricing, MarketDefaults(), mesh,
                                      device="cpu")
    dist.barrier()
    if rank == 0:
        with open(cfg.output_csv) as f:
            out["pipeline"] = f.read()
        with open(cfg.output_csv, "w") as f:
            f.writelines(out["pipeline"].splitlines(keepends=True)[:3])
    dist.barrier()
    out["resume_rc"] = run_pipeline(cfg, pricing, MarketDefaults(), mesh,
                                     resume=True, device="cpu")
    dist.barrier()
    if rank == 0:
        with open(cfg.output_csv) as f:
            out["resumed"] = f.read()
    # The same run through the CLI on the existing world, traced.
    from montecarlooptionspricer_tpu_torch.cli import prediction_gen

    out["cli_rc"] = prediction_gen.main([
        "--option-csv", cfg.option_csv, "--spot-csv", cfg.spot_csv,
        "--output-csv", f"{work}/cli_out.csv", "--num-paths", "64",
        "--rows-per-batch", "3", "--seed", "5", "--mesh-devices", str(world),
        "--trace-dir", f"{work}/trace", "--device", "cpu"])

    # The trainer: a clean run and one with a NaN row on rank 1 only.
    x, y, x_nan = nn_data()
    out["train"] = train(mesh, x, y, f"{work}/ckpt_mesh")
    out["train_nan"] = train(mesh, x_nan, y, f"{work}/ckpt_mesh_nan")
    dist.destroy_process_group()
    return out


def main() -> int:
    rank, world, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(2)
    out = run(rank, world, work)
    with open(os.path.join(work, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
