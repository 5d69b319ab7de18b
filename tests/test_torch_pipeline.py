"""The port's PredictionGen pipeline and its CLI against the JAX package's
on the same synthetic CSVs: the same header and sentinel rows, the same
non-price columns, prices within Monte Carlo error; and the port's own
determinism, resume, backup, sentinel and clean-up behaviour, as
tests/test_pipeline.py holds JAX's.  Runs on the CPU (``device="cpu"``)."""

import os
import signal
import threading

import numpy as np
import pytest
import torch

from montecarlooptionspricer_tpu.cli import prediction_gen as jcli
from montecarlooptionspricer_tpu.config import (
    MarketDefaults as JMarket, PipelineConfig as JPipe,
    PricingConfig as JPricing)
from montecarlooptionspricer_tpu.pipeline.driver import (
    run_pipeline as jrun_pipeline)
from montecarlooptionspricer_tpu_torch.cli import prediction_gen as tcli
from montecarlooptionspricer_tpu_torch.config import (
    AUGMENTED_COLUMNS, MarketDefaults, PipelineConfig, PricingConfig)
from montecarlooptionspricer_tpu_torch.pipeline import csv_io
from montecarlooptionspricer_tpu_torch.pipeline import driver as tdriver
from montecarlooptionspricer_tpu_torch.pipeline.driver import (
    SENTINEL, BatchedPricer, _resume_row_count, run_pipeline)

from test_pipeline import make_option_csv, make_spot_csv, opt_row

OUT = "option_data_augmented.csv"


@pytest.fixture
def workdir(tmp_path, rng, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return make_spot_csv("nasdaq_stock_data.csv", rng)


def _run(**kw):
    """The port's pipeline on the CPU with small batches."""
    pricing = dict(rows_per_batch=4, seed=5)
    pricing.update(kw.pop("pricing", {}))
    return run_pipeline(PipelineConfig(**kw.pop("config", {})),
                        PricingConfig(**pricing), MarketDefaults(),
                        device="cpu", **kw)


def _near_money(workdir):
    s = round(workdir["aapl"], 4)
    return [opt_row(option_type=0, dte=30.0, s=s, sdp=-0.02),
            opt_row(option_type=1, dte=30.0, s=s, sdp=0.02),
            opt_row(option_type=0, dte=45.0, s=s, sdp=-0.02)]


def test_pipeline_matches_jax(workdir):
    """Sentinel rows, one row of another bucket, and 16 puts and 16 calls
    of one contract through both pipelines: the same header, the same
    sentinel lines and input columns, the vol and momentum columns equal
    as parsed floats to 1e-5 relative (the .6g format), and each price
    column's mean over a contract's 16 identical rows within 5 combined
    stderr, each package's stderr from its spread over those rows."""
    s = round(workdir["aapl"], 4)
    rows = ["too,short,row", opt_row(s="-5.0"), opt_row(ticker="ZZZZ"),
            opt_row(dte=0.5), opt_row(s=s, dte=120.0, sdp=-0.03)]
    pair = [opt_row(option_type=0, dte=30.0, s=s, sdp=-0.02),
            opt_row(option_type=1, dte=30.0, s=s, sdp=0.02)]
    rows += pair * 16
    make_option_csv("option_data.csv", rows)
    assert jrun_pipeline(JPipe(output_csv="jax.csv"),
                         JPricing(rows_per_batch=32, seed=1),
                         JMarket()) == 0
    assert _run(config=dict(output_csv="torch.csv"),
                pricing=dict(rows_per_batch=32, seed=1)) == 0
    jh, jrows = csv_io.read_table("jax.csv")
    th, trows = csv_io.read_table("torch.csv")
    assert th == jh and th[-6:] == list(AUGMENTED_COLUMNS)
    assert len(trows) == len(jrows) == len(rows)
    for i, (t, j) in enumerate(zip(trows, jrows)):
        sentinel = j[-6:] == ["0"] * 6
        assert (t[-6:] == ["0"] * 6) == sentinel, i
        if sentinel:
            assert t == j, i
            continue
        assert t[:-6] == j[:-6], i
        np.testing.assert_allclose([float(v) for v in t[-2:]],
                                   [float(v) for v in j[-2:]], rtol=1e-5)
    assert [i for i, j in enumerate(jrows) if j[-6:] == ["0"] * 6] == \
        [0, 1, 2, 3]
    for first in (5, 6):              # the puts, then the calls
        got = np.asarray([[float(v) for v in r[-6:-2]]
                          for r in trows[first::2]])
        want = np.asarray([[float(v) for v in r[-6:-2]]
                           for r in jrows[first::2]])
        assert got.shape == want.shape == (16, 4)
        se = np.sqrt(got.var(axis=0, ddof=1) / 16
                     + want.var(axis=0, ddof=1) / 16)
        assert (se > 0).all()
        assert (np.abs(got.mean(axis=0) - want.mean(axis=0))
                <= 5.0 * se).all(), (got.mean(axis=0), want.mean(axis=0),
                                     se)


def test_pipeline_sentinel_rows_and_backup(workdir):
    """Rows that fail validation (short, bad number, no history, no step)
    become sentinels in order; earlier output is backed up."""
    make_option_csv("option_data.csv", [
        "too,short,row", opt_row(s="-5.0"), opt_row(ticker="ZZZZ"),
        opt_row(dte=0.5), opt_row()])
    with open(OUT, "w") as f:
        f.write("old contents\n")
    assert _run() == 0
    assert open("option_data_augmented.backup.csv").read() == \
        "old contents\n"
    _, rows = csv_io.read_table(OUT)
    assert len(rows) == 5 and rows[0][0] == "too"
    for i in range(4):
        assert rows[i][-6:] == ["0"] * 6, rows[i]
    assert all(np.isfinite(float(v)) for v in rows[4][-6:])
    assert any(float(v) != 0.0 for v in rows[4][-6:])
    assert os.path.exists("error_log.txt")
    assert os.path.exists("spot_data_diagnostic.csv")


def test_pipeline_deterministic(workdir):
    make_option_csv("option_data.csv", _near_money(workdir))
    assert _run() == 0
    first = open(OUT).read()
    assert _run() == 0
    assert open(OUT).read() == first
    assert _run(pricing=dict(seed=6)) == 0
    assert open(OUT).read() != first


def test_pipeline_resume_appends_remaining_rows(workdir):
    """A run cut after its first row and resumed writes the bytes of the
    one-shot run: each row's draws depend on (seed, row index) only,
    not on the batch it lands in."""
    make_option_csv("option_data.csv", _near_money(workdir))
    assert _run() == 0
    full = open(OUT).read()
    with open(OUT, "w") as f:
        f.writelines(full.splitlines(keepends=True)[:2])
    assert _run(resume=True) == 0
    assert open(OUT).read() == full
    assert not os.path.exists("option_data_augmented.backup.csv")


def test_pipeline_interrupted_run_leaves_marker_and_resumes(workdir,
                                                            monkeypatch):
    """A failing batch in the high bucket after the low bucket priced
    leaves fills before priced rows; the marker makes the resume redo
    them, and the result equals the clean one-shot run."""
    s = round(workdir["aapl"], 4)
    make_option_csv("option_data.csv", [
        opt_row(option_type=0, dte=120.0, s=s, sdp=-0.02),
        opt_row(option_type=1, dte=15.0, s=s, sdp=0.02),
        opt_row(option_type=0, dte=15.0, s=s, sdp=-0.02)])
    assert _run() == 0
    clean = open(OUT).read()
    real_price = BatchedPricer.price

    def boom_on_big(self, tasks, seed):
        if max(t.n_steps for t in tasks) > 60:
            raise RuntimeError("injected failure in big bucket")
        return real_price(self, tasks, seed)

    monkeypatch.setattr(tdriver.BatchedPricer, "price", boom_on_big)
    assert _run() == 1
    marker = OUT + ".resume"
    assert open(marker).read().strip() == "0"
    _, rows = csv_io.read_table(OUT)
    assert rows[0][-6:] == ["0"] * 6 and rows[1][-6:] != ["0"] * 6
    monkeypatch.setattr(tdriver.BatchedPricer, "price", real_price)
    assert _run(resume=True) == 0
    assert open(OUT).read() == clean
    assert not os.path.exists(marker)


def test_resume_row_count_repairs_tail(tmp_path):
    """A partial trailing line and a trailing sentinel run are truncated
    and not counted; a foreign header counts 0 and is left alone."""
    hdr, path = "h1,h2", str(tmp_path / "out.csv")
    with open(path, "w") as f:
        f.write(hdr + "\nrow0,1\nrow1,2\nrow2,")
    assert _resume_row_count(path, hdr) == 2
    assert open(path).read() == hdr + "\nrow0,1\nrow1,2\n"
    with open(path, "w") as f:
        f.write(hdr + "\nbad" + SENTINEL + "\ngood,0.5\nfill" + SENTINEL
                + "\n")
    assert _resume_row_count(path, hdr) == 2
    assert open(path).read() == hdr + "\nbad" + SENTINEL + "\ngood,0.5\n"
    with open(path, "w") as f:
        f.write("other\njunk,1\n")
    assert _resume_row_count(path, hdr) == 0


def test_run_leaves_no_handlers_or_threads(workdir):
    """The signal handlers are put back and the watchdog's threads have
    ended when ``run_pipeline`` returns, and ``timings`` is filled."""
    make_option_csv("option_data.csv", [opt_row()])
    before = {s: signal.getsignal(s)
              for s in (signal.SIGINT, signal.SIGTERM, signal.SIGUSR1)}
    threads = threading.active_count()
    timings = {}
    assert _run(timings=timings) == 0
    assert {s: signal.getsignal(s) for s in before} == before
    assert threading.active_count() == threads
    assert timings["host_s"] > 0 and timings["device_s"] > 0
    assert list(timings["buckets"]) == ["32/32"]
    assert len(timings["buckets"]["32/32"]) == 1


def test_unported_configurations_raise():
    """No silent fallback: a mesh that is no ``parallel.mesh.Mesh`` (it
    raised NotImplementedError before the mesh was ported) and
    a CUDA device on a host without one raise; QMC noise (refused naming
    A12 before it was ported) prices, and only its pairing with
    antithetic is refused."""
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        BatchedPricer(PricingConfig(), MarketDefaults(), "cpu", mesh=object())
    qmc = BatchedPricer(PricingConfig(qmc=True, num_paths=32),
                        MarketDefaults(), "cpu")
    task = tdriver.RowTask(
        index=0, line="x", n_steps=20, is_call=False, s0=100.0, xi=0.04,
        h=0.1, eta=1.5, rho=-0.4, strike=102.0, maturity=20 / 252,
        sigma=0.2, dividend=0.0, twenty_day_vol=0.2, twenty_day_momentum=0.0)
    prices = qmc.price([task], base_seed=0)
    assert prices.shape == (1, 4) and np.all(np.isfinite(prices))
    assert np.all(prices > 0)
    with pytest.raises(ValueError):
        PricingConfig(qmc=True, antithetic=True)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchedPricer(PricingConfig(), MarketDefaults())


def _flags(parser):
    return {a.dest: a.default for a in parser._actions if a.dest != "help"}


def test_cli_flags_and_refusals(workdir, capsys):
    """The CLI's flags are JAX's, with its defaults, plus --device; --qmc
    with --antithetic exits 2 (JAX's PricingConfig refusal; --qmc alone
    exited 2 naming A12 before it was ported); --mesh-devices 2 in a
    world of one process raises make_mesh's ValueError (it and
    --trace-dir exited 2 before they were ported; the traces
    are tests/test_torch_profiling.py's, the mesh tests/test_torch_
    mesh.py's); --device cpu writes the augmented CSV."""
    jflags = _flags(jcli.build_parser())
    tflags = _flags(tcli.build_parser())
    assert tflags.pop("device") == "cuda"
    assert tflags == jflags
    assert tcli.main(["--qmc", "--antithetic", "--device", "cpu"]) == 2
    assert "incompatible" in capsys.readouterr().err
    with pytest.raises(ValueError, match="2-device mesh but only 1"):
        tcli.main(["--mesh-devices", "2", "--device", "cpu"])
    make_option_csv("option_data.csv", _near_money(workdir)[:2])
    assert tcli.main(["--device", "cpu", "--num-paths", "64",
                      "--antithetic", "--rows-per-batch", "2"]) == 0
    header, rows = csv_io.read_table(OUT)
    assert header[-6:] == list(AUGMENTED_COLUMNS) and len(rows) == 2
    assert all(float(v) != 0.0 for r in rows for v in r[-6:-2])
