"""The port's native host engine (``csrc/host/features.cpp``,
``csrc/host/fastcsv.cpp``, built by ``kernels/host_build.py``) on the CPU.

The features equal the JAX package's engine to the bit: ``native/
features.cpp`` is compiled here into a temporary directory with the
port's flags (nothing is written into the JAX package) and imported from
there.  They also hold the JAX package's NumPy functions and the port's
plain versions to 1e-12 relative (H to 1e-9).  The CSV reader equals its
plain version and the JAX package's Python reader list for list on every
case.  Then: the pipeline, the meta-model's loader and the history entry
run on the engine with the plain versions made to raise, the build
renames an edited source, survives two processes building at once and
raises on a broken compiler, and the PredictionGen host pass equals the
JAX package's, run on that engine, to the bit.
"""

from __future__ import annotations

import importlib.machinery
import importlib.util
import os
import shutil
import struct
import subprocess
import sys
import sysconfig
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from montecarlooptionspricer_tpu.config import MarketDefaults as JMarket
from montecarlooptionspricer_tpu.ops import estimators as jest
from montecarlooptionspricer_tpu.pipeline import csv_io as jcsv
from montecarlooptionspricer_tpu.pipeline import driver as jdriver
from montecarlooptionspricer_tpu.pipeline import spot as jspot
from montecarlooptionspricer_tpu_torch.config import (
    MarketDefaults, PipelineConfig, PricingConfig)
from montecarlooptionspricer_tpu_torch.kernels import build as kernel_build
from montecarlooptionspricer_tpu_torch.kernels import host_build
from montecarlooptionspricer_tpu_torch.models import rough_volatility
from montecarlooptionspricer_tpu_torch.nn import data as nn_data
from montecarlooptionspricer_tpu_torch.ops import estimators
from montecarlooptionspricer_tpu_torch.pipeline import csv_io
from montecarlooptionspricer_tpu_torch.pipeline import driver as tdriver
from montecarlooptionspricer_tpu_torch.pipeline import spot

from test_pipeline import make_option_csv, make_spot_csv, opt_row

REPO = Path(__file__).resolve().parents[1]
SIZES = (2, 3, 21, 60, 400, 1260, 1825)
RTOL, H_RTOL = 1e-12, 1e-9
PLAIN = ((estimators, "estimate_params_plain"),
         (estimators, "hurst_exponent_dfa_plain"),
         (spot, "twenty_day_vol_and_momentum_plain"),
         (csv_io, "read_table_plain"))


def bits(values) -> list:
    """Each float's IEEE-754 bytes, so that equality is to the bit."""
    return [struct.pack("<d", float(v)) for v in values]


def history(n: int, seed: int = 0) -> np.ndarray:
    """A seeded random-walk price history of ``n`` points."""
    rng = np.random.default_rng(1000 * seed + n)
    return 100.0 * np.exp(np.cumsum(rng.normal(3e-4, 0.012, n)))


def close(got: float, want: float, rtol: float = RTOL) -> bool:
    return abs(got - want) <= rtol * abs(want)


@pytest.fixture(scope="module")
def jax_engine(tmp_path_factory):
    """The JAX package's ``native/features.cpp`` built with the port's
    compiler and flags into a temporary directory, and imported."""
    out = tmp_path_factory.mktemp("jax_engine") / (
        "_features" + sysconfig.get_config_var("EXT_SUFFIX"))
    subprocess.run([*host_build.compiler(), *host_build.CXX_FLAGS,
                    *host_build.include_flags(), "-o", str(out),
                    str(REPO / "native" / "features.cpp")], check=True,
                   capture_output=True)
    loader = importlib.machinery.ExtensionFileLoader("_features", str(out))
    module = importlib.util.module_from_spec(
        importlib.util.spec_from_loader("_features", loader))
    loader.exec_module(module)
    return module


@pytest.fixture
def jax_numpy(monkeypatch):
    """The JAX package's Python paths: its engine and reader unloaded."""
    monkeypatch.setattr(jest, "_native", None)
    monkeypatch.setattr(jcsv, "_native", None)


def _raise(*args, **kwargs):
    raise AssertionError("a plain version ran on the main path")


@pytest.fixture
def engine_calls(monkeypatch):
    """Counts of the engine's functions called, by name, with every plain
    version made to raise."""
    counts = Counter()
    real = host_build.load

    class Counting:
        def __init__(self, module):
            self.module = module

        def __getattr__(self, name):
            fn = getattr(self.module, name)

            def call(*args):
                counts[name] += 1
                return fn(*args)
            return call

    monkeypatch.setattr(host_build, "load", lambda u: Counting(real(u)))
    for module, name in PLAIN:
        monkeypatch.setattr(module, name, _raise)
    return counts


# -- (a) the features -------------------------------------------------------

@pytest.mark.parametrize("n", SIZES)
def test_features_equal_jax_engine(jax_engine, n):
    """estimate_params, hurst_dfa and vol_momentum equal the JAX
    package's engine to the bit."""
    prices = history(n)
    rets = np.log(prices[1:] / prices[:-1])
    p = estimators.estimate_params(prices)
    assert bits((p.s0, p.xi, p.h, p.eta, p.rho)) == bits(
        jax_engine.estimate_params(prices, 1.0 / 252.0))
    assert bits([estimators.hurst_exponent_dfa(rets)]) == bits(
        [jax_engine.hurst_dfa(rets)])
    assert bits(spot.twenty_day_vol_and_momentum(list(prices))) == bits(
        jax_engine.vol_momentum(prices))


@pytest.mark.parametrize("n", SIZES)
def test_features_match_jax_numpy(jax_numpy, n):
    """The engine against the JAX package's NumPy functions: 1e-12
    relative, H 1e-9."""
    prices = history(n, seed=1)
    rets = jest.log_returns(prices)
    p = estimators.estimate_params(prices, dt_yr=1.0 / 365.0)
    assert p.s0 == prices[-1]
    assert close(p.xi, jest.estimate_xi(rets, 1.0 / 365.0))
    assert close(p.h, jest.hurst_exponent_dfa(rets), H_RTOL)
    assert close(p.eta, jest.estimate_eta(rets))
    assert close(p.rho, jest.estimate_rho(rets))
    vol, mom = spot.twenty_day_vol_and_momentum(list(prices))
    want_vol, want_mom = jspot.twenty_day_vol_and_momentum(list(prices))
    assert close(vol, want_vol) and close(mom, want_mom)


@pytest.mark.parametrize("n", SIZES)
def test_features_match_plain(n):
    """The engine against the port's plain versions: 1e-12 relative, H
    1e-9."""
    prices = history(n, seed=2)
    rets = estimators.log_returns(prices)
    got = estimators.estimate_params(prices, r=0.03)
    want = estimators.estimate_params_plain(prices, r=0.03)
    assert got.s0 == want.s0 and got.r == want.r == 0.03
    for name in ("xi", "eta", "rho"):
        assert close(getattr(got, name), getattr(want, name)), name
    assert close(got.h, want.h, H_RTOL)
    assert close(estimators.hurst_exponent_dfa(rets),
                 estimators.hurst_exponent_dfa_plain(rets), H_RTOL)
    got_vm = spot.twenty_day_vol_and_momentum(list(prices))
    want_vm = spot.twenty_day_vol_and_momentum_plain(list(prices))
    assert all(close(g, w) for g, w in zip(got_vm, want_vm))


def _bad_window() -> list:
    hist = list(history(60, seed=3))
    hist[-3], hist[-6], hist[-9], hist[-12] = -1.0, 0.0, np.inf, np.nan
    return hist


@pytest.mark.parametrize("case", ["list_input", "too_short", "vol_under_21",
                                  "bad_window"])
def test_features_edge_cases(jax_engine, case):
    """A list input (the engine's sequence path), ValueError under two
    points, (0, 0) under 21 points, and a 20-day window with a
    non-positive price and non-finite logs: the engine equals the JAX
    engine to the bit and the plain versions to 1e-12."""
    features = host_build.load("features")
    if case == "list_input":
        prices = history(400, seed=4)
        as_list = [float(v) for v in prices]
        p = estimators.estimate_params(as_list)
        assert bits(features.estimate_params(as_list)) == bits(
            (p.s0, p.xi, p.h, p.eta, p.rho)) == bits(
            jax_engine.estimate_params(as_list))
        rets = list(np.diff(np.log(prices)))
        assert features.hurst_dfa(rets) == jax_engine.hurst_dfa(rets) == \
            estimators.hurst_exponent_dfa(np.asarray(rets))
        assert features.vol_momentum(as_list) == \
            jax_engine.vol_momentum(as_list) == \
            spot.twenty_day_vol_and_momentum(as_list)
    elif case == "too_short":
        for prices in ([], [101.5]):
            for fn in (estimators.estimate_params,
                       estimators.estimate_params_plain,
                       jax_engine.estimate_params):
                with pytest.raises(ValueError,
                                   match="Historical prices vector too "
                                         "small."):
                    fn(np.asarray(prices, dtype=np.float64))
        assert estimators.hurst_exponent_dfa([0.01]) == 0.5
    elif case == "vol_under_21":
        hist = list(history(20, seed=5))
        for fn in (spot.twenty_day_vol_and_momentum,
                   spot.twenty_day_vol_and_momentum_plain,
                   jax_engine.vol_momentum):
            assert fn(hist) == (0.0, 0.0)
        assert spot.twenty_day_vol_and_momentum(hist + [100.0]) != (0.0, 0.0)
    else:
        hist = _bad_window()
        got = spot.twenty_day_vol_and_momentum(hist)
        assert all(np.isfinite(got)) and got != (0.0, 0.0)
        assert bits(got) == bits(jax_engine.vol_momentum(hist))
        with np.errstate(invalid="ignore", divide="ignore"):
            want = spot.twenty_day_vol_and_momentum_plain(hist)
        assert all(close(g, w) for g, w in zip(got, want))


# -- (b) the CSV reader -------------------------------------------------------

CSV_CASES = {
    "empty_line": b"a,b,c\n1,2,3\n\n4,5,6\n",
    "embedded_empty_field": b"a,b,c\n4,,6\n,,\n",
    "trailing_comma": b"a,b,c,\n7,8,\n",
    "crlf": b"a,b\r\nx y,z w\r\n  q,r\r\n",
    "lone_comma": b"a\n,\n",
    "whitespace_only_line": b"a,b\n1,2\n   \n\t\r\n3,4",
    "lone_cr_content": b"a,b\nx\ry,z\n\r\n\rq,\r\r\n",
    "invalid_utf8": b"a,\xffb\n\xe2,\xe2\x82,ok\xc3\n\xc3\xa9t\xc3\xa9,1\n",
    "header_only": b"a,b,c",
    "empty_header_line": b"\n1,2\n",
}


def _three_readers(path: str) -> list:
    return [csv_io.read_table(path), csv_io.read_table_plain(path),
            jcsv.read_table(path)]


@pytest.mark.parametrize("case", [*CSV_CASES, "missing_file", "empty_file",
                                  "roundtrip_10000"])
def test_read_table_cases(jax_numpy, tmp_path, case):
    """The native reader equals its plain version and the JAX package's
    split_line-based Python reader on each case, errors included."""
    path = tmp_path / "t.csv"
    if case == "missing_file":
        for read in (csv_io.read_table, csv_io.read_table_plain,
                     jcsv.read_table):
            with pytest.raises(OSError):
                read(str(path))
        return
    if case == "empty_file":
        path.write_bytes(b"")
        for read in (csv_io.read_table, csv_io.read_table_plain,
                     jcsv.read_table):
            with pytest.raises(ValueError, match=f"Empty CSV: {path}"):
                read(str(path))
        return
    if case == "roundtrip_10000":
        rng = np.random.default_rng(7)
        rows = [[str(i), f"{rng.uniform():.8f}", f"tick{i % 97}", "",
                 str(-i)] for i in range(10_000)]
        csv_io.write_csv(str(path), ["c0", "c1", "c2", "c3", "c4"], rows)
        got, plain, jax_py = _three_readers(path)
        assert got == plain == jax_py == (["c0", "c1", "c2", "c3", "c4"],
                                          rows)
        return
    path.write_bytes(CSV_CASES[case])
    got, plain, jax_py = _three_readers(str(path))
    assert got == plain == jax_py
    assert isinstance(got, tuple) and all(isinstance(r, list)
                                          for r in got[1])
    if case == "trailing_comma":
        assert got == (["a", "b", "c"], [["7", "8"]])
    if case == "lone_comma":
        assert got == (["a"], [[""]])
    if case == "invalid_utf8":
        assert "�" in got[0][1]


# -- (c) dispatch ---------------------------------------------------------------

def test_pipeline_runs_on_engine(engine_calls, tmp_path, rng, monkeypatch):
    """run_pipeline on the CPU reads both CSVs and computes every priced
    row's features on the engine, with the plain versions raising."""
    monkeypatch.chdir(tmp_path)
    s = round(make_spot_csv("nasdaq_stock_data.csv", rng)["aapl"], 4)
    make_option_csv("option_data.csv", [
        opt_row(option_type=0, dte=30.0, s=s, sdp=-0.02),
        opt_row(option_type=1, dte=45.0, s=s, sdp=0.02),
        opt_row(ticker="ZZZZ")])
    assert tdriver.run_pipeline(PipelineConfig(),
                                PricingConfig(rows_per_batch=4, seed=5),
                                MarketDefaults(), device="cpu") == 0
    assert engine_calls["read_table"] == 2
    assert engine_calls["estimate_params"] == 2
    assert engine_calls["vol_momentum"] == 2
    _, rows = csv_io.read_table("option_data_augmented.csv")
    assert len(rows) == 3 and rows[2][-6:] == ["0"] * 6
    assert all(float(v) != 0.0 for v in rows[0][-6:])


def test_nn_loader_and_history_entry_run_on_engine(engine_calls, tmp_path):
    """nn.data.read_csv and generate_paths_from_history run on the engine,
    with the plain versions raising."""
    path = tmp_path / "features.csv"
    csv_io.write_csv(str(path), ["x0", "x1", "y"],
                     [["1", "2", "3"], ["4", "5", "6"]])
    x, y = nn_data.read_csv(str(path), ["x1", "x0"], "y")
    assert engine_calls["read_table"] == 1
    np.testing.assert_array_equal(x, [[2.0, 1.0], [5.0, 4.0]])
    np.testing.assert_array_equal(y, [3.0, 6.0])
    paths = rough_volatility.generate_paths_from_history(
        torch.Generator().manual_seed(0), history(120), 8, 16)
    assert engine_calls["estimate_params"] == 1
    assert paths.shape == (16, 9) and bool(torch.isfinite(paths).all())


# -- (d) the build --------------------------------------------------------------

def test_host_build_edited_source_rebuilds(tmp_path, monkeypatch):
    """Under a temporary cache root the libraries land in its host/;
    editing a copied source gives a new library name, which builds and
    loads beside the first."""
    monkeypatch.setenv(kernel_build.CACHE_ENV, str(tmp_path / "cache"))
    assert host_build.host_build_dir() == tmp_path / "cache" / "host"
    src = tmp_path / "features.cpp"
    shutil.copy(host_build.UNITS["features"], src)
    first, _, _ = host_build.build({"features": src})
    with open(src, "a") as f:
        f.write("// edited\n")
    second, seconds, _ = host_build.build({"features": src})
    assert seconds > 0.0
    assert first["features"] != second["features"]
    assert sorted(p.name for p in (tmp_path / "cache" / "host").iterdir()) \
        == sorted([first["features"].name, second["features"].name])
    prices = history(60)
    assert host_build.import_library("features", second["features"]) \
        .estimate_params(prices) == host_build.load("features") \
        .estimate_params(prices)
    assert host_build.build({"features": src})[1] == 0.0


_WORKER = """
import sys
sys.path.insert(0, sys.argv[1])
from montecarlooptionspricer_tpu_torch.kernels import host_build
f = host_build.load("features")
c = host_build.load("fastcsv")
print(repr(f.estimate_params([100.0 + i % 7 for i in range(300)])))
print(repr(c.read_table(sys.argv[2])))
"""


def test_host_build_two_processes_at_once(tmp_path):
    """Two processes that build into one empty cache at once both load a
    good library, and one library per unit is left, no temporary file."""
    table = tmp_path / "t.csv"
    table.write_text("a,b\n1,2\n")
    env = dict(os.environ, **{kernel_build.CACHE_ENV: str(tmp_path / "c")})
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(REPO),
                               str(table)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert outs[0][0] == outs[1][0]
    assert outs[0][0].splitlines()[1] == "(['a', 'b'], [['1', '2']])"
    left = sorted(p.name for p in (tmp_path / "c" / "host").iterdir())
    assert len(left) == 2 and all(n.startswith(("_mcop_features_",
                                                "_mcop_fastcsv_"))
                                  and n.endswith(".so") for n in left), left


@pytest.mark.parametrize("fault", ["fails", "missing"])
def test_host_build_bad_compiler_raises(tmp_path, monkeypatch, fault):
    """A compiler that fails, or one that does not exist, raises with its
    log from the build and from every entry, and nothing falls back to a
    plain version."""
    monkeypatch.setenv(kernel_build.CACHE_ENV, str(tmp_path / "cache"))
    if fault == "fails":
        cxx = tmp_path / "bad-cxx"
        cxx.write_text('#!/bin/sh\nif [ "$1" = --version ]; then echo '
                       'bad-cxx 1.0; exit 0; fi\necho "bad-cxx: cannot '
                       'compile $*" >&2\nexit 3\n')
        cxx.chmod(0o755)
        match = "bad-cxx: cannot compile"
    else:
        cxx = tmp_path / "no-such-cxx"
        match = "cannot run"
    monkeypatch.setenv("CXX", str(cxx))
    for module, name in PLAIN:
        monkeypatch.setattr(module, name, _raise)
    host_build.load.cache_clear()
    try:
        with pytest.raises(RuntimeError, match=match):
            host_build.build()
        with pytest.raises(RuntimeError, match=match):
            estimators.estimate_params(history(60))
        with pytest.raises(RuntimeError, match=match):
            spot.twenty_day_vol_and_momentum(list(history(60)))
        with pytest.raises(RuntimeError, match=match):
            csv_io.read_table(str(tmp_path / "any.csv"))
    finally:
        host_build.load.cache_clear()
    host = tmp_path / "cache" / "host"
    assert not host.exists() or not any(host.iterdir())


# -- the PredictionGen host pass ---------------------------------------------

def test_host_pass_equals_jax_engine(jax_engine, tmp_path, rng, monkeypatch):
    """The rows of test_torch_pipeline.py::test_pipeline_matches_jax
    through the port's host pass (its CSV reader, spot loader, history
    walk and engine) and the JAX package's, run on its engine built from
    native/features.cpp: the same sentinels, and each priced row's vol,
    momentum, s0, xi, h, eta and rho equal to the bit."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(jest, "_native", jax_engine)
    s = round(make_spot_csv("nasdaq_stock_data.csv", rng)["aapl"], 4)
    rows = ["too,short,row", opt_row(s="-5.0"), opt_row(ticker="ZZZZ"),
            opt_row(dte=0.5), opt_row(s=s, dte=120.0, sdp=-0.03)]
    rows += [opt_row(option_type=0, dte=30.0, s=s, sdp=-0.02),
             opt_row(option_type=1, dte=30.0, s=s, sdp=0.02)] * 16
    make_option_csv("option_data.csv", rows)
    _, t_rows = csv_io.read_table("option_data.csv")
    _, j_rows = jcsv.read_table("option_data.csv")
    assert t_rows == j_rows
    t_spot = spot.load_spot_prices("nasdaq_stock_data.csv")
    j_spot = jspot.load_spot_prices("nasdaq_stock_data.csv")
    fields = ("twenty_day_vol", "twenty_day_momentum", "s0", "xi", "h",
              "eta", "rho")
    priced = 0
    for i, tokens in enumerate(t_rows):
        line = ",".join(tokens)
        t_task, t_why = tdriver._parse_row(i, line, tokens, t_spot,
                                           MarketDefaults(), lambda m: None)
        j_task, j_why = jdriver._parse_row(i, line, tokens, j_spot,
                                           JMarket(), lambda m: None)
        assert (t_task is None) == (j_task is None) and t_why == j_why, i
        if t_task is not None:
            priced += 1
            assert bits(getattr(t_task, f) for f in fields) == bits(
                getattr(j_task, f) for f in fields), i
    assert priced == len(rows) - 4
