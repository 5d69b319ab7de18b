"""The port's meta-model around the network, on the CPU: feature CSVs
against the JAX package's ``read_csv``, the ``.pt`` checkpoints, resume
and SIGINT, a ``mesh=`` of the wrong type, and both CLIs
(``mcop-train-nn-torch``, ``mcop-evaluate-nn-torch``) driven as a user
would on 64/16/16 rows."""

import os
import signal

import numpy as np
import pytest
import torch

from montecarlooptionspricer_tpu.nn import data as jdata
from montecarlooptionspricer_tpu_torch.cli import evaluate_nn, train_nn
from montecarlooptionspricer_tpu_torch.config import (
    INPUT_COLUMNS, TARGET_COLUMN, TrainConfig)
from montecarlooptionspricer_tpu_torch.nn import checkpoint as ckpt_lib
from montecarlooptionspricer_tpu_torch.nn.data import read_csv
from montecarlooptionspricer_tpu_torch.nn.trainer import BayesianTrainer

from test_cli import _write_feature_csv


@pytest.fixture
def data_dir(tmp_path, rng, monkeypatch):
    for name, n in (("train_data.csv", 64), ("valid_data.csv", 16),
                    ("test_data.csv", 16)):
        _write_feature_csv(tmp_path / name, rng, n)
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _trainer(**kw):
    cfg = TrainConfig(warmup_epochs=1, batch_size=32, **kw)
    return BayesianTrainer(17, 64, config=cfg, device="cpu")


def _xy(rng, n=96):
    x = rng.normal(size=(n, 17)).astype(np.float32)
    return x, (1.0 + 0.5 * x[:, 0] - 0.2 * x[:, 3]).astype(np.float32)


@pytest.mark.parametrize("bad", [False, True], ids=["clean", "bad_rows"])
def test_read_csv_matches_jax(data_dir, bad):
    path = str(data_dir / "train_data.csv")
    if bad:
        with open(path, "a") as f:
            f.write("1,2,3\n")                              # ragged
            f.write(",".join(["x"] * (len(INPUT_COLUMNS) + 2)) + "\n")
        for reader in (read_csv, jdata.read_csv):
            with pytest.raises(ValueError):
                reader(path, INPUT_COLUMNS, TARGET_COLUMN)
    got = read_csv(path, INPUT_COLUMNS, TARGET_COLUMN, skip_bad_rows=bad)
    want = jdata.read_csv(path, INPUT_COLUMNS, TARGET_COLUMN,
                          skip_bad_rows=bad)
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    assert got[0].shape == (64, 17)
    with pytest.raises(ValueError, match="not found"):
        read_csv(path, INPUT_COLUMNS, "no_such_column")


def test_checkpoint_round_trip_and_failures(tmp_path):
    t = _trainer()
    t._make_optimizer(1e-3)
    path = str(tmp_path / "ck")
    t._save_checkpoint(path, 3, 0.25)
    assert os.path.exists(path + ".pt")
    params, opt_state, epoch, loss, gen = ckpt_lib.load_checkpoint(
        path, t.model.state_dict())
    assert (epoch, loss) == (3, 0.25)
    for k, v in t.model.state_dict().items():
        assert torch.equal(params[k], v)
    assert gen["device"] == "cpu"
    assert torch.equal(gen["state"], t.generator.get_state())
    assert int(opt_state["count"]) == 0 and set(opt_state["m"]) == set(params)
    # Absent, corrupt, or for another model: None (train from scratch).
    assert ckpt_lib.load_checkpoint(str(tmp_path / "none")) is None
    (tmp_path / "bad.pt").write_bytes(b"not an archive")
    assert ckpt_lib.load_checkpoint(str(tmp_path / "bad")) is None
    other = BayesianTrainer(17, 64, config=TrainConfig(num_mixtures=3),
                            device="cpu")
    assert ckpt_lib.load_checkpoint(path, other.model.state_dict()) is None
    # A model file round trip; a missing one raises.
    t.save_model(str(tmp_path / "model"))
    t2 = _trainer(seed=5)
    t2.load_model(str(tmp_path / "model"))
    x = np.ones((2, 17), np.float32)
    assert torch.equal(t2.forward(x), t.forward(x))
    with pytest.raises(FileNotFoundError):
        ckpt_lib.load_params(str(tmp_path / "missing"))


def test_resume_is_bit_equal_to_one_run(tmp_path, rng):
    """2 epochs in one call against 1 + resume + 1 (crossing the warm-up
    boundary), the dropout stream continued from the checkpoint."""
    x, y = _xy(rng)
    a = _trainer()
    a.train_model(x, y, num_epochs=2, checkpoint_path=str(tmp_path / "a"))
    ck = str(tmp_path / "b")
    _trainer().train_model(x, y, num_epochs=1, checkpoint_path=ck)
    b = _trainer()
    b.train_model(x, y, num_epochs=2, checkpoint_path=ck)
    assert b.current_epoch == 2
    for (n, pa), (_, pb) in zip(a.model.state_dict().items(),
                                b.model.state_dict().items()):
        assert torch.equal(pa, pb), n
    assert torch.equal(a.optimizer.m, b.optimizer.m)
    assert int(b.optimizer.count) == 6


def test_resume_on_another_device_type_is_refused(tmp_path):
    """A checkpoint whose dropout stream was drawn on the card cannot
    continue on the CPU: the resume raises instead of restarting the
    stream from the seed."""
    t = _trainer()
    t._make_optimizer(1e-3)
    ck = str(tmp_path / "ck")
    ckpt_lib.save_checkpoint(ck, t.model.state_dict(),
                             t.optimizer.state_dict(), 1, 0.5,
                             {"device": "cuda",
                              "state": torch.zeros(16, dtype=torch.uint8)})
    x, y = _xy(np.random.default_rng(0), 32)
    with pytest.raises(ValueError, match="drawn on cuda"):
        _trainer().train_model(x, y, num_epochs=2, checkpoint_path=ck)


def test_sigint_saves_and_returns(tmp_path, rng, monkeypatch):
    x, y = _xy(rng)
    t = _trainer()
    run_epoch = t.run_epoch

    def interrupted(*args, **kw):
        out = run_epoch(*args, **kw)
        os.kill(os.getpid(), signal.SIGINT)
        return out

    monkeypatch.setattr(t, "run_epoch", interrupted)
    handler = signal.getsignal(signal.SIGINT)
    ck = str(tmp_path / "ck")
    t.train_model(x, y, num_epochs=5, checkpoint_path=ck)
    assert t.current_epoch == 1
    assert ckpt_lib.load_checkpoint(ck)[2] == 1
    assert signal.getsignal(signal.SIGINT) is handler


def test_nan_batch_is_skipped(rng):
    """A batch with a NaN row: no update, Adam's count kept, the skip
    counted, and its loss out of the epoch's mean."""
    x, y = _xy(rng, 64)
    t = _trainer()
    t._make_optimizer(1e-3)
    xb, yb, wb = t.batched(x, y, 32)
    xb[1, 4, 2] = float("nan")
    before = {k: v.clone() for k, v in t.model.state_dict().items()}
    gen = t.generator.get_state()
    loss = t.run_epoch(xb, yb, wb, warmup=False)
    assert int(t.optimizer.count) == 1
    assert int(t.optimizer.total_notfinite) == 1
    t.model.load_state_dict(before)
    t.generator.set_state(gen)
    t.optimizer = None
    t._make_optimizer(1e-3)
    first, ok = t._step(xb[0], yb[0], wb[0], False)
    after_first = {k: v.clone() for k, v in t.model.state_dict().items()}
    skipped, nan_ok = t._step(xb[1], yb[1], wb[1], False)
    assert bool(ok) and not bool(nan_ok) and float(skipped) == 0.0
    assert float(loss) == float(first)
    for k, v in t.model.state_dict().items():
        assert torch.equal(v, after_first[k]), k
    assert int(t.optimizer.count) == 1


def test_mesh_is_not_ported(rng):
    """A mesh that is no ``parallel.mesh.Mesh`` raises TypeError (it raised
    NotImplementedError before the mesh was ported; the sharded trainer
    is tests/test_torch_mesh.py's)."""
    x, y = _xy(rng, 32)
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        _trainer().train_model(x, y, num_epochs=1, mesh=object())


def test_train_then_evaluate_cli(data_dir):
    args = ["--device", "cpu", "--batch-size", "32", "--mc-samples", "5",
            "--model-file", "model", "--checkpoint-file", "ckpt"]
    assert train_nn.main(args + ["--num-epochs", "7"]) == 0
    assert os.path.exists("model.pt") and os.path.exists("ckpt.pt")
    assert ckpt_lib.load_checkpoint("ckpt")[2] == 7
    for extra, name in (([], "plain.csv"),
                        (["--calibrated-intervals"], "calibrated.csv")):
        assert evaluate_nn.main(["--device", "cpu", "--model-file", "model",
                                 "--results-csv", name, "--n-samples", "5",
                                 "--batch-size", "8"] + extra) == 0
        with open(name) as f:
            lines = f.read().strip().splitlines()
        assert lines[0] == "Index,Actual,Mean,Lower,Upper,Error,InsideInterval"
        assert len(lines) == 1 + 16
        rows = np.array([[float(v) for v in ln.split(",")]
                         for ln in lines[1:]])
        assert np.isfinite(rows).all()
        assert (rows[:, 3] <= rows[:, 2]).all()
        assert (rows[:, 2] <= rows[:, 4]).all()
    plain = np.loadtxt("plain.csv", delimiter=",", skiprows=1)
    calibrated = np.loadtxt("calibrated.csv", delimiter=",", skiprows=1)
    np.testing.assert_array_equal(plain[:, 2], calibrated[:, 2])
    assert (calibrated[:, 4] - calibrated[:, 3] >=
            plain[:, 4] - plain[:, 3]).all()


def test_train_cli_resumes_from_checkpoint(data_dir):
    args = ["--device", "cpu", "--batch-size", "32", "--model-file", "m",
            "--checkpoint-file", "ck"]
    assert train_nn.main(args + ["--num-epochs", "2"]) == 0
    assert ckpt_lib.load_checkpoint("ck")[2] == 2
    assert train_nn.main(args + ["--num-epochs", "4"]) == 0
    assert ckpt_lib.load_checkpoint("ck")[2] == 4
