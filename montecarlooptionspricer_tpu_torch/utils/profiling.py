"""Profiling hooks (counterpart: ``montecarlooptionspricer_tpu/utils/
profiling.py``): ``torch.profiler`` traces in the Chrome trace format
(chrome://tracing, Perfetto), and the port's own spans and counters.

``span(name, **attrs)`` marks a region of the program and ``count(name,
n)`` adds to a counter.  Both do nothing but test one module-level flag
unless a ``tracing()`` block is open.  Inside one, a span records its
name, an id, its parent span's id, the request id (``request=`` on the
root span, inherited by its children), its attributes, its host edges on
``time.perf_counter_ns`` and the port kernels it launched (the
difference of the wrappers' own ``launches`` counters at its edges).  It
also enters ``torch.profiler.record_function``, so under a profiler the
span lands on the trace beside the device's kernels.  Where CUDA is
present it records an event at each edge on the current stream; the
events are read only when the spans are collected, and put on the host's
clock through one anchor event recorded when tracing starts, so host and
device edges share one clock without a profiler.  Nothing in a span
synchronizes.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import logging
import os
import time
from typing import Iterator, Optional

import torch

log = logging.getLogger(__name__)

# The Recorder of the open ``tracing()`` block; None while tracing is off.
_recorder = None


class _Off:
    """The one context ``span`` returns while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        """Attributes known only inside the span: dropped."""


_OFF = _Off()


def _kernel_wrappers() -> tuple:
    """(name, wrapper) of each port kernel whose wrapper counts its own
    launches (``wrapper.launches``)."""
    from ..models import (chain_cuda, greeks_cuda, pathgen_cuda,
                          pathgen_factored_cuda, pathgen_tiled_cuda)
    return (("K1", pathgen_cuda.pathgen), ("K2", pathgen_cuda.priced_chunk),
            ("K3", greeks_cuda.greeks_chunk),
            ("K4", greeks_cuda.chain_greeks_chunk),
            ("K5", chain_cuda.priced_chain),
            ("K6", pathgen_tiled_cuda.tiled_pathgen),
            ("K7", pathgen_tiled_cuda.tiled_priced_chunk),
            ("K8", pathgen_factored_cuda.factored_pathgen),
            ("K9", pathgen_factored_cuda.factored_priced_chunk))


class _Span:
    """One span while tracing is on (``span``)."""

    __slots__ = ("rec", "name", "id", "parent", "request", "attrs",
                 "host", "events", "launches", "_before", "_fn")

    def __init__(self, rec: "Recorder", name: str, request, attrs: dict):
        self.rec, self.name, self.request = rec, name, request
        self.attrs = attrs

    def set(self, **attrs) -> None:
        """Add attributes known only inside the span."""
        self.attrs.update(attrs)

    def __enter__(self):
        rec = self.rec
        parent = rec._stack[-1] if rec._stack else None
        self.id = next(rec._ids)
        self.parent = parent.id if parent else None
        if self.request is None and parent is not None:
            self.request = parent.request
        rec._stack.append(self)
        self._before = rec._launches()
        self.host = [time.perf_counter_ns(), None]
        self._fn = torch.profiler.record_function(self.name)
        self._fn.__enter__()
        self.events = None
        if rec._anchor is not None:
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        if self.events is not None:
            self.events[1].record()
        self._fn.__exit__(*exc)
        self.host[1] = time.perf_counter_ns()
        self.launches = {name: b - a for (name, _), a, b in
                         zip(rec._kernels, self._before, rec._launches())
                         if b != a}
        rec._stack.pop()
        rec._done.append(self)
        return False


class Recorder:
    """The spans and counters of one ``tracing()`` block."""

    def __init__(self):
        self._ids = itertools.count()
        self._stack = []
        self._done = []
        self._counts = {}
        self._kernels = _kernel_wrappers()
        self._anchor = None
        if torch.cuda.is_available():
            # The one synchronization: device times are the anchor's host
            # time plus the device's time since the anchor.
            torch.cuda.synchronize()
            t0 = time.perf_counter_ns()
            self._anchor = torch.cuda.Event(enable_timing=True)
            self._anchor.record()
            self._anchor.synchronize()
            self._anchor_ns = (t0 + time.perf_counter_ns()) // 2

    def _launches(self) -> list:
        return [fn.launches for _, fn in self._kernels]

    def spans(self) -> list:
        """The finished spans in the order they ended, each a dict: name,
        id, parent, request, attrs, launches ({kernel: launches} inside
        it), host_ns and device_ns ([start, end] on the host's
        ``perf_counter_ns`` clock; device_ns None without CUDA).  Waits
        for the device to pass every span's end."""
        if self._anchor is not None and self._done:
            torch.cuda.synchronize()
        out = []
        for s in self._done:
            device = None
            if s.events is not None:
                device = [self._anchor_ns + round(
                    1e6 * self._anchor.elapsed_time(e)) for e in s.events]
            out.append({"name": s.name, "id": s.id, "parent": s.parent,
                        "request": s.request, "attrs": s.attrs,
                        "launches": s.launches, "host_ns": s.host,
                        "device_ns": device})
        return out

    def counters(self) -> dict:
        """{counter: total} of every ``count`` made in the block."""
        return dict(self._counts)


def span(name: str, request=None, **attrs):
    """A context marking one region of the program (module docstring):
    the shared no-op context while tracing is off.  ``request`` names the
    request of a root span; a child takes its parent's."""
    rec = _recorder
    if rec is None:
        return _OFF
    return _Span(rec, name, request, attrs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while tracing is on."""
    rec = _recorder
    if rec is not None:
        rec._counts[name] = rec._counts.get(name, 0) + n


@contextlib.contextmanager
def tracing() -> Iterator[Recorder]:
    """Turn the spans and counters on for the block; yields its
    ``Recorder``.  Spans are for one thread: a span's parent is the span
    open when it started."""
    global _recorder
    prev, rec = _recorder, Recorder()
    _recorder = rec
    try:
        yield rec
    finally:
        _recorder = prev


@contextlib.contextmanager
def device_trace(trace_dir: Optional[str]) -> Iterator[None]:
    """Trace the block with ``torch.profiler`` (the CPU, and CUDA where a
    device is present) and the port's spans, and write both to
    ``trace_dir``: ``trace_<pid>.json``, a Chrome trace, and
    ``spans_<pid>.json``, the spans and counters (``Recorder``).  A no-op
    when ``trace_dir`` is falsy, so callers can pass an optional
    ``--trace-dir`` straight through."""
    if not trace_dir:
        yield
        return
    os.makedirs(trace_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    path = os.path.join(trace_dir, f"trace_{os.getpid()}.json")
    log.info("torch.profiler trace -> %s", path)
    with torch.profiler.profile(activities=activities) as prof, \
            tracing() as rec:
        yield
    prof.export_chrome_trace(path)
    with open(os.path.join(trace_dir, f"spans_{os.getpid()}.json"),
              "w") as f:
        json.dump({"spans": rec.spans(), "counters": rec.counters()}, f)
    log.info("trace complete: open %s in chrome://tracing or Perfetto",
             path)
