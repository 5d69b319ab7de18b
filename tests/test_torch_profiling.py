"""The port's profiling hooks and kernel build cache (``utils/profiling.py``,
``utils/jit_cache.py``, ``kernels/build.py``) on the CPU: a
``torch.profiler`` Chrome trace holding an ``annotate`` span, the no-op on
a falsy directory, the cache directory's environment override, and the
PredictionGen CLI's ``--trace-dir``."""

import json
import os

import numpy as np
import pytest
import torch

from montecarlooptionspricer_tpu_torch.cli import prediction_gen as tcli
from montecarlooptionspricer_tpu_torch.kernels import build
from montecarlooptionspricer_tpu_torch.utils import (
    annotate, device_trace, enable_persistent_cache)
from test_pipeline import make_option_csv, make_spot_csv, opt_row


def _trace_names(trace_dir) -> set:
    files = sorted(trace_dir.glob("trace_*.json"))
    assert len(files) == 1, files
    events = json.loads(files[0].read_text())["traceEvents"]
    return {e.get("name") for e in events}


def test_device_trace_holds_annotate_span(tmp_path):
    """A trace of a block with an ``annotate`` span and a CPU operator
    names both."""
    with device_trace(str(tmp_path / "trace")):
        with annotate("mcop_span"):
            torch.ones(64).cumsum(0)
    names = _trace_names(tmp_path / "trace")
    assert "mcop_span" in names
    assert any(n and "cumsum" in n for n in names)


@pytest.mark.parametrize("trace_dir", ["", None])
def test_device_trace_falsy_dir_is_a_no_op(tmp_path, monkeypatch,
                                           trace_dir):
    monkeypatch.chdir(tmp_path)
    with device_trace(trace_dir):
        with annotate("x"):
            pass
    assert list(tmp_path.iterdir()) == []


def test_persistent_cache_dir(tmp_path, monkeypatch):
    """Without the override the default ``build/kernels`` is set and
    returned; a second call keeps it (idempotent), whatever it asks; an
    override already in the environment wins, and the build's libraries
    follow it."""
    monkeypatch.delenv(build.CACHE_ENV, raising=False)
    default = str(build.DEFAULT_BUILD_DIR.resolve())
    assert enable_persistent_cache() == default
    assert os.environ[build.CACHE_ENV] == default
    assert enable_persistent_cache(str(tmp_path / "other")) == default
    monkeypatch.setenv(build.CACHE_ENV, str(tmp_path / "cache"))
    assert enable_persistent_cache() == str(tmp_path / "cache")
    assert build.build_dir() == tmp_path / "cache"
    name, src, flags, _ = build.UNITS[0]
    assert build.library_path(name, src, flags).parent == tmp_path / "cache"
    monkeypatch.delenv(build.CACHE_ENV)
    assert enable_persistent_cache(str(tmp_path / "asked")) == str(
        tmp_path / "asked")
    assert not (tmp_path / "asked").exists()    # nothing built here


def test_prediction_gen_cli_trace_dir(tmp_path, monkeypatch):
    """``--trace-dir`` writes a Chrome trace of the run, with one
    ``price_batch[n_pad x rows]`` span a batch."""
    monkeypatch.chdir(tmp_path)
    spot = make_spot_csv("nasdaq_stock_data.csv", np.random.default_rng(3))
    s = round(spot["aapl"], 4)
    make_option_csv("option_data.csv", [
        opt_row(option_type=0, dte=30.0, s=s, sdp=-0.02),
        opt_row(option_type=1, dte=30.0, s=s, sdp=0.02)])
    assert tcli.main(["--device", "cpu", "--num-paths", "32",
                      "--rows-per-batch", "2", "--trace-dir", "trace"]) == 0
    names = _trace_names(tmp_path / "trace")
    assert "price_batch[32x2]" in names
