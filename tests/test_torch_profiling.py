"""The port's profiling hooks and kernel build cache (``utils/profiling.py``,
``utils/jit_cache.py``, ``kernels/build.py``) on the CPU: a
``torch.profiler`` Chrome trace holding a ``span``, the no-op on a falsy
directory, the cache directory's environment override, the PredictionGen
CLI's ``--trace-dir``; the recorder's spans and counters (off by default,
nesting, the engine's span tree on both pricers, the same answers traced
and untraced), ``spans_<pid>.json`` beside the trace, the price CLI's
``--trace-dir``; and on the card, the spans' device edges."""

import json
import os

import numpy as np
import pytest
import torch

from montecarlooptionspricer_tpu_torch.cli import prediction_gen as tcli
from montecarlooptionspricer_tpu_torch.cli import price as pcli
from montecarlooptionspricer_tpu_torch.kernels import build
from montecarlooptionspricer_tpu_torch.models import engine
from montecarlooptionspricer_tpu_torch.utils import (
    count, device_trace, enable_persistent_cache, profiling, span, tracing)


def _trace_names(trace_dir) -> set:
    files = sorted(trace_dir.glob("trace_*.json"))
    assert len(files) == 1, files
    events = json.loads(files[0].read_text())["traceEvents"]
    return {e.get("name") for e in events}


def test_device_trace_holds_annotate_span(tmp_path):
    """A trace of a block with a ``span`` and a CPU operator names
    both."""
    with device_trace(str(tmp_path / "trace")):
        with span("mcop_span"):
            torch.ones(64).cumsum(0)
    names = _trace_names(tmp_path / "trace")
    assert "mcop_span" in names
    assert any(n and "cumsum" in n for n in names)


@pytest.mark.parametrize("trace_dir", ["", None])
def test_device_trace_falsy_dir_is_a_no_op(tmp_path, monkeypatch,
                                           trace_dir):
    monkeypatch.chdir(tmp_path)
    with device_trace(trace_dir):
        with span("x"):
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
    from test_pipeline import make_option_csv, make_spot_csv, opt_row

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


def test_tracing_off_records_nothing():
    """Off (the default) ``span`` returns one shared no-op context and
    ``count`` drops its count; a recorder sees only what ran inside its
    block, and the flag is off again after it."""
    assert profiling._recorder is None
    assert span("a") is span("b", request=1, steps=3)
    with span("a") as sp:
        sp.set(x=1)
        count("n", 5)
    with tracing() as rec:
        pass
    with span("after"):
        count("n")
    assert rec.spans() == [] and rec.counters() == {}
    assert profiling._recorder is None


def test_spans_nest_and_counters_add_up():
    """Children name their parent's id and take the root's request id;
    attributes set inside a span are kept; counters sum."""
    with tracing() as rec:
        with span("root", request=17, kind="r"):
            with span("child") as c:
                count("reads", 2)
                c.set(rows=4)
                with span("grandchild"):
                    count("reads")
            with span("sibling"):
                count("steps", 8)
    spans = {s["name"]: s for s in rec.spans()}
    assert [s["name"] for s in rec.spans()] == ["grandchild", "child",
                                                "sibling", "root"]
    root = spans["root"]
    assert root["parent"] is None and root["attrs"] == {"kind": "r"}
    assert spans["child"]["parent"] == root["id"]
    assert spans["grandchild"]["parent"] == spans["child"]["id"]
    assert spans["sibling"]["parent"] == root["id"]
    assert spans["child"]["attrs"] == {"rows": 4}
    assert {s["request"] for s in spans.values()} == {17}
    assert len({s["id"] for s in spans.values()}) == 4
    for s in spans.values():
        a, b = s["host_ns"]
        assert a <= b and s["launches"] == {}
    assert root["host_ns"][0] <= spans["child"]["host_ns"][0]
    assert spans["sibling"]["host_ns"][1] <= root["host_ns"][1]
    assert rec.counters() == {"reads": 3, "steps": 8}


STEPS = 16
CONFIG = dict(n_paths=4 * 2048, n_steps=STEPS, chunk_paths=2048,
              pilot_paths=2048, dt=1 / 252, chunks_per_call=2)
MARKET = (100.0, 0.04, 0.1, 1.5, -0.4, 0.04)
FIT = {("mcop.pilot", "mcop.fit"), ("mcop.lsm", "mcop.fit"),
       ("mcop.fit", "mcop.price")}
STREAM = {("mcop.tables", "mcop.stream"), ("mcop.chunks", "mcop.stream"),
          ("mcop.readback", "mcop.stream"), ("mcop.stream", "mcop.price"),
          ("mcop.price", None)}


def _pricer(kind: str, device="cpu"):
    cv = kind == "anti_cv"
    cfg = engine.StreamConfig(**CONFIG, antithetic=cv, control_variate=cv)
    if kind == "strip":
        return engine.StreamingChainPricer(*MARKET, [90.0, 100.0, 110.0],
                                           STEPS / 252, False, cfg,
                                           device=device)
    return engine.StreamingPricer(*MARKET, 100.0, STEPS / 252, False, cfg,
                                  device=device)


def _tree(spans) -> list:
    names = {s["id"]: s["name"] for s in spans}
    return sorted((s["name"], names.get(s["parent"])) for s in spans)


@pytest.mark.parametrize("kind", ["single", "anti_cv", "strip"])
def test_price_span_tree_and_answers(kind):
    """A price yields exactly the engine's span tree (``mcop.price`` >
    ``mcop.fit`` > pilot, LSM fit and, under the control variate, the
    control fit; ``mcop.stream`` > tables, chunks, readback), every span of
    the request's seed, with its attributes and counters, and the same
    price and stderr bits as untraced; building the pricer records its
    constants' span."""
    with tracing() as rec:
        pricer = _pricer(kind)
    (consts,) = rec.spans()
    assert consts["name"] == "mcop.setup.consts"
    assert consts["attrs"] == {"family": "single"}
    with tracing() as rec:
        traced = pricer.price(5, with_stderr=True)
    untraced = pricer.price(5, with_stderr=True)
    for a, b in zip(traced, untraced):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    spans = rec.spans()
    want = FIT | STREAM | ({("mcop.control_fit", "mcop.fit")}
                           if kind == "anti_cv" else set())
    assert _tree(spans) == sorted(want)
    assert {s["request"] for s in spans} == {5}
    by_name = {s["name"]: s for s in spans}
    strikes = 3 if kind == "strip" else 1
    assert by_name["mcop.lsm"]["attrs"] == {"steps": STEPS,
                                            "strikes": strikes}
    assert by_name["mcop.pilot"]["attrs"] == {"family": "single"}
    assert by_name["mcop.chunks"]["attrs"] == {"chunks": 4, "groups": 2}
    assert rec.counters() == {
        "lsm.steps": STEPS, "lsm.regressions": STEPS * strikes,
        "host_reads": 3}


def test_device_trace_writes_spans_beside_the_trace(tmp_path):
    """``device_trace`` turns the recorder on: the Chrome trace holds the
    engine's spans, and ``spans_<pid>.json`` beside it holds them with
    their edges, and the counters."""
    pricer = _pricer("single")
    with device_trace(str(tmp_path)):
        pricer.price(3)
    assert "mcop.lsm" in _trace_names(tmp_path)
    got = json.loads((tmp_path / f"spans_{os.getpid()}.json").read_text())
    assert {s["name"] for s in got["spans"]} == {a for a, _ in FIT | STREAM}
    assert all(len(s["host_ns"]) == 2 for s in got["spans"])
    assert got["counters"]["lsm.steps"] == STEPS


def test_price_cli_trace_dir(tmp_path, capsys):
    """``mcop-price-torch --trace-dir`` writes the Chrome trace with the
    engine's spans and ``spans_<pid>.json``, the pricer's build
    included, and prices as without it."""
    argv = ["--strike", "100", "--put", "--maturity", str(STEPS / 252),
            "--steps", str(STEPS), "--paths", "4096", "--chunk-paths",
            "2048", "--pilot-paths", "2048", "--device", "cpu"]
    assert pcli.main(argv) == 0
    plain = json.loads(capsys.readouterr().out)
    assert pcli.main(argv + ["--trace-dir", str(tmp_path / "t")]) == 0
    traced = json.loads(capsys.readouterr().out)
    assert traced["price"] == plain["price"]
    assert {"mcop.price", "mcop.chunks"} <= _trace_names(tmp_path / "t")
    (path,) = (tmp_path / "t").glob("spans_*.json")
    names = {s["name"] for s in json.loads(path.read_text())["spans"]}
    assert {"mcop.setup.consts", "mcop.price", "mcop.readback"} <= names


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_spans_on_the_card(cuda):
    """On the card every span's device edges resolve and follow its host
    start; the pilot's and the backward pass's device times fit inside
    the fit's wall (its host start to its device end); ``mcop.pilot``
    carries one K1 launch and ``mcop.chunks`` one K2 a chunk; the traced
    answer is the untraced one."""
    pricer = _pricer("single", device="cuda")
    untraced = pricer.price(9, with_stderr=True)   # builds, warms
    torch.cuda.synchronize()
    with tracing() as rec:
        traced = pricer.price(9, with_stderr=True)
    assert traced == untraced
    spans = {s["name"]: s for s in rec.spans()}
    slack = 50_000                                 # ns: the anchor's error
    for s in spans.values():
        (h0, _), (d0, d1) = s["host_ns"], s["device_ns"]
        assert d0 <= d1 and d0 >= h0 - slack, s
    pilot, lsm, fit = (spans[n]["device_ns"] for n in
                       ("mcop.pilot", "mcop.lsm", "mcop.fit"))
    wall = fit[1] - spans["mcop.fit"]["host_ns"][0]
    assert (pilot[1] - pilot[0]) + (lsm[1] - lsm[0]) <= wall + slack
    assert spans["mcop.pilot"]["launches"] == {"K1": 1}
    assert spans["mcop.chunks"]["launches"] == {"K2": 4}
    assert spans["mcop.lsm"]["launches"] == {}
