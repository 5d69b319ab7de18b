"""The traced run's reading from a Chrome trace: spans, the union of
device intervals, kernels inside spans, the top operations and the
longest idle gaps, and the per-layer readers on it."""

import pytest

from gpubench import registry, system, trace
from gpubench.run import Run


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


EVENTS = [
    _x("gpubench.price", "user_annotation", 0, 1000),
    _x("gpubench.fit", "user_annotation", 0, 400),
    _x("gpubench.stream", "user_annotation", 400, 600),
    _x("aten::sum", "cpu_op", 100, 300),
    _x("reduce", "kernel", 10, 20),
    _x("reduce", "kernel", 50, 20),
    _x("copy", "gpu_memcpy", 60, 30),
    _x("priced", "kernel", 450, 500),
    _x("priced", "kernel", 900, 100),
    {"ph": "i", "name": "marker", "ts": 5},
]


def test_union_busy_and_inside():
    tr = trace.from_events(EVENTS)
    assert tr.window == pytest.approx((0.0, 1e-3))
    # [10, 30], [50, 90], [450, 1000] microseconds
    assert trace.busy_s(tr.device, *tr.window) == pytest.approx(610e-6)
    fit = tr.spans["gpubench.fit"]
    assert len(trace.inside(tr.kernels, fit)) == 2


def test_top_ops_and_idle_gaps():
    tr = trace.from_events(EVENTS)
    top = trace.top_device_ops(tr)
    assert top[0][0] == "priced" and top[0][1] == pytest.approx(600e-6)
    gaps = trace.idle_gaps(tr)
    assert gaps[0][1] == pytest.approx(360e-6)          # 90 .. 450
    assert gaps[0][0].startswith("fit: ")
    assert "aten::sum" in gaps[0][0]


def test_layer_readers_on_a_trace():
    config = registry.config("rbergomi_btw2020")
    req = system.request(config, registry.traffic("put_atm_1e8"))
    run = Run(config, req, 1.0, 0.25, trace=trace.from_events(EVENTS),
              halves={"fit": [0.3e-3, 0.5e-3], "stream": [0.6e-3]})
    read = {name: registry.reader("layer_metrics", name)(run)
            for name in ("fit_ms", "stream_ms", "fit_launches",
                         "device_idle_pct", "consts_ms",
                         "stream_roofline_pct")}
    assert read["fit_ms"] == pytest.approx(0.4)
    assert read["stream_ms"] == pytest.approx(0.6)
    assert read["fit_launches"] == 2
    assert read["device_idle_pct"] == pytest.approx(39.0)
    assert read["consts_ms"] == pytest.approx(250.0)
    assert read["stream_roofline_pct"] > 100.0       # a toy trace's 550 us


def test_no_device_ops_reads_nothing():
    tr = trace.from_events([e for e in EVENTS
                            if e.get("cat") not in trace.DEVICE_CATS])
    config = registry.config("rbergomi_btw2020")
    req = system.request(config, registry.traffic("put_atm_1e8"))
    run = Run(config, req, 1.0, 0.25, trace=tr)
    for name in ("fit_launches", "device_idle_pct", "stream_roofline_pct"):
        assert registry.reader("layer_metrics", name)(run) is None
