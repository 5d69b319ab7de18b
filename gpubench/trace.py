"""The traced run's reading: spans, device operations and their gaps from
a ``torch.profiler`` Chrome trace.

The benchmark marks each traced price and its two halves with
``torch.profiler.record_function`` spans (``gpubench.price``,
``gpubench.fit``, ``gpubench.stream``), synchronizing the device at each
span's end, so every device operation a half launched runs inside its
span.  Times here are the trace's microseconds turned into seconds, host
and device on the profiler's one clock.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

SPANS = ("gpubench.price", "gpubench.fit", "gpubench.stream")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Op:
    name: str
    start: float
    end: float


@dataclass
class Trace:
    """What a traced run read: the benchmark's spans by name, the device
    operations (kernels, copies, fills) and the kernels alone, and the
    host's operators (to name what the host did in a device gap)."""

    spans: dict = field(default_factory=dict)
    device: list = field(default_factory=list)
    kernels: list = field(default_factory=list)
    host: list = field(default_factory=list)

    @property
    def window(self) -> tuple:
        """(start, end) of the traced prices."""
        prices = self.spans["gpubench.price"]
        return prices[0].start, prices[-1].end


def from_chrome(path) -> Trace:
    """Read a profiler's exported Chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return from_events(events)


def from_events(events) -> Trace:
    tr = Trace(spans={name: [] for name in SPANS})
    for e in events:
        if e.get("ph") != "X":
            continue
        op = Op(e.get("name", ""), e["ts"] * 1e-6,
                (e["ts"] + e.get("dur", 0)) * 1e-6)
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            tr.device.append(op)
            if cat == "kernel":
                tr.kernels.append(op)
        elif cat == "user_annotation" and op.name in tr.spans:
            tr.spans[op.name].append(op)
        elif cat == "cpu_op":
            tr.host.append(op)
    for ops in (tr.device, tr.kernels, tr.host, *tr.spans.values()):
        ops.sort(key=lambda o: o.start)
    return tr


def union(ops, start: float, end: float) -> list:
    """The merged intervals of ``ops`` clipped to [start, end]."""
    out = []
    for o in sorted(ops, key=lambda o: o.start):
        a, b = max(o.start, start), min(o.end, end)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_s(ops, start: float, end: float) -> float:
    """Seconds of [start, end] in which any of ``ops`` ran."""
    return sum(b - a for a, b in union(ops, start, end))


def inside(ops, spans) -> list:
    """The ops that start inside one of ``spans``."""
    out, i = [], 0
    spans = sorted(spans, key=lambda s: s.start)
    for o in sorted(ops, key=lambda o: o.start):
        while i < len(spans) and spans[i].end < o.start:
            i += 1
        if i < len(spans) and spans[i].start <= o.start <= spans[i].end:
            out.append(o)
    return out


def top_device_ops(tr: Trace, k: int = 10) -> list:
    """[[name, seconds], ...]: the device operations that took most time in
    the traced window, summed by name."""
    start, end = tr.window
    total = {}
    for o in tr.device:
        a, b = max(o.start, start), min(o.end, end)
        if b > a:
            total[o.name] = total.get(o.name, 0.0) + (b - a)
    ranked = sorted(total.items(), key=lambda kv: -kv[1])[:k]
    return [[name[:120], sec] for name, sec in ranked]


def _host_at(tr: Trace, t: float) -> str:
    """What the host did at time t: the innermost benchmark span and
    operator running then."""
    span = next((name for name in ("gpubench.fit", "gpubench.stream")
                 for s in tr.spans[name] if s.start <= t <= s.end),
                "gpubench.price")
    ops = [o for o in tr.host if o.start <= t <= o.end]
    op = min(ops, key=lambda o: o.end - o.start).name if ops else "python"
    return f"{span.split('.')[1]}: {op}"[:120]


def idle_gaps(tr: Trace, k: int = 10) -> list:
    """[[what the host did, seconds], ...]: the longest stretches of the
    traced window with no device operation, each named by the host's
    innermost span and operator at its middle."""
    start, end = tr.window
    busy = union(tr.device, start, end)
    edges = [start] + [x for iv in busy for x in iv] + [end]
    gaps = [(b - a, a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    gaps.sort(reverse=True)
    return [[_host_at(tr, 0.5 * (a + b)), g] for g, a, b in gaps[:k]]
