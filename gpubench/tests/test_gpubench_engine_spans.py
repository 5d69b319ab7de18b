"""The program's own spans in a traced run (``engine_spans``): the four
readers on synthetic spans, the idle time by engine span on a synthetic
Chrome trace, the benchmark's own trace reading unchanged beside engine
spans, and the fresh process's job end to end on the CPU."""

import pytest

from gpubench import engine_spans, registry, system, trace
from gpubench.run import Run
from gpubench.tests.helpers import tiny

READERS = ("pilot_ms", "lsm_ms", "lsm_dispatch_ms", "kernels_load_ms")


def _span(name, request, host, device):
    return {"name": name, "id": 0, "parent": None, "request": request,
            "attrs": {}, "launches": {}, "host_ns": list(host),
            "device_ns": None if device is None else list(device)}


def _run(spans=None, setup=None):
    config = registry.config("rbergomi_btw2020")
    req = system.request(config, registry.traffic("put_atm_1e8"))
    run = Run(config, req, 1.0, 0.25)
    run.engine_spans = {} if spans is None else {
        "prices": {"spans": spans, "counters": {}},
        "setup": {"spans": setup or [], "counters": {}}}
    return run


def _read(run):
    return {name: registry.reader("layer_metrics", name)(run)
            for name in READERS}


def test_readers_on_synthetic_spans():
    ms = 1_000_000
    spans = [
        _span("mcop.pilot", 1, (0, 1 * ms), (ms // 2, 2 * ms)),
        _span("mcop.lsm", 1, (1 * ms, 301 * ms), (2 * ms, 303 * ms)),
        _span("mcop.pilot", 2, (0, 1 * ms), (0, 3 * ms)),
        _span("mcop.lsm", 2, (1 * ms, 281 * ms), (3 * ms, 300 * ms)),
        _span("mcop.fit", 2, (0, 282 * ms), (0, 300 * ms))]
    setup = [_span("mcop.setup.kernels", None, (5 * ms, 47 * ms), None)]
    got = _read(_run(spans, setup))
    assert got["pilot_ms"] == pytest.approx(2.25)     # (1.5 + 3) / 2
    assert got["lsm_ms"] == pytest.approx(299.0)      # (301 + 297) / 2
    assert got["lsm_dispatch_ms"] == pytest.approx(290.0)
    assert got["kernels_load_ms"] == pytest.approx(42.0)


def test_readers_read_nothing_without_the_recorder_or_edges(monkeypatch):
    """A port without the recorder: ``of`` starts nothing and every
    reader reads None; spans without device edges (the CPU) give no
    device metric."""
    monkeypatch.setattr(engine_spans, "_has_recorder", lambda: False)
    monkeypatch.setattr(engine_spans, "collect", pytest.fail)
    run = _run()
    del run.engine_spans
    assert set(_read(run).values()) == {None}
    host_only = [_span("mcop.lsm", 1, (0, 2_000_000), None)]
    got = _read(_run(host_only))
    assert got["lsm_ms"] is None and got["pilot_ms"] is None
    assert got["lsm_dispatch_ms"] == pytest.approx(2.0)
    assert got["kernels_load_ms"] is None


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


EVENTS = [
    _x("gpubench.price", "user_annotation", 0, 1000),
    _x("gpubench.fit", "user_annotation", 0, 400),
    _x("gpubench.stream", "user_annotation", 400, 600),
    _x("mcop.price", "user_annotation", 0, 1000),
    _x("mcop.fit", "user_annotation", 0, 400),
    _x("mcop.pilot", "user_annotation", 0, 40),
    _x("mcop.lsm", "user_annotation", 40, 340),
    _x("mcop.stream", "user_annotation", 400, 600),
    _x("mcop.chunks", "user_annotation", 420, 560),
    _x("mcop.readback", "user_annotation", 980, 20),
    _x("aten::sum", "cpu_op", 100, 300),
    _x("pathgen", "kernel", 10, 20),
    _x("reduce", "kernel", 50, 20),
    _x("copy", "gpu_memcpy", 60, 30),
    _x("priced", "kernel", 450, 500),
    {"ph": "i", "name": "marker", "ts": 5},
]


def test_idle_by_span_splits_each_gap_at_the_engine_spans():
    idle, total = engine_spans.idle_by_span(EVENTS)
    got = dict(idle)
    # busy [10, 30], [50, 90], [450, 950]; idle [0, 10], [30, 50],
    # [90, 450], [950, 1000] microseconds.
    assert total == pytest.approx(440e-6)
    assert sum(got.values()) == pytest.approx(total)
    assert got["mcop.pilot"] == pytest.approx(20e-6)     # 0-10, 30-40
    assert got["mcop.lsm"] == pytest.approx(300e-6)      # 40-50, 90-380
    assert got["mcop.fit"] == pytest.approx(20e-6)       # 380-400
    assert got["mcop.chunks"] == pytest.approx(60e-6)    # 420-450, 950-980
    assert got["mcop.stream"] == pytest.approx(20e-6)    # 400-420
    assert got["mcop.readback"] == pytest.approx(20e-6)
    assert idle[0][0] == "mcop.lsm"
    assert engine_spans.idle_by_span(EVENTS[4:]) == ([], 0.0)


def test_benchmark_spans_unchanged_beside_engine_spans():
    """``trace.from_events`` reads the benchmark's own spans and no
    engine span, and its idle gaps still name the benchmark's halves."""
    bare = [e for e in EVENTS if not e.get("name", "").startswith("mcop.")]
    with_engine, without = trace.from_events(EVENTS), trace.from_events(bare)
    assert with_engine.spans == without.spans
    assert set(with_engine.spans) == set(trace.SPANS)
    assert trace.idle_gaps(with_engine) == trace.idle_gaps(without)


def test_the_job_end_to_end_on_the_cpu():
    """The fresh process at a tiny size: set-up spans, one span tree a
    traced price with the control fit, the counters, and the traced
    answer equal to the untraced (``trace_gap`` 0); no profiler pass off
    CUDA."""
    _, _, config, traffic = tiny("put_1y_k100_1e8_anti_cv")
    req = system.request(config, traffic)
    got = engine_spans.collect(config, req, [11, 12], 10, 2 * 2048,
                               device="cpu")
    assert got["trace_gap"] == 0.0
    assert got["idle_by_span"] is None and got["idle_s"] is None
    setup = [s["name"] for s in got["setup"]["spans"]]
    assert setup[0] == "mcop.setup.consts" and setup[-1] == "mcop.price"
    spans = got["prices"]["spans"]
    assert {s["request"] for s in spans} == {11, 12}
    assert sum(s["name"] == "mcop.control_fit" for s in spans) == 2
    assert got["prices"]["counters"]["lsm.steps"] == 2 * 16
    run = _run(spans)
    assert _read(run)["lsm_dispatch_ms"] > 0.0
