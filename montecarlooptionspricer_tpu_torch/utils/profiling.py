"""Profiling hooks (counterpart: ``montecarlooptionspricer_tpu/utils/
profiling.py``): ``torch.profiler`` traces in the Chrome trace format
(chrome://tracing, Perfetto), and named spans so the pipeline's batches
show up on the timeline.  The console progress lives in the pipeline and
the trainer.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Iterator, Optional

import torch

log = logging.getLogger(__name__)


@contextlib.contextmanager
def device_trace(trace_dir: Optional[str]) -> Iterator[None]:
    """Trace the block with ``torch.profiler`` (the CPU, and CUDA where a
    device is present) and write it to ``trace_dir`` as
    ``trace_<pid>.json``, a Chrome trace.  A no-op when ``trace_dir`` is
    falsy, so callers can pass an optional ``--trace-dir`` straight
    through."""
    if not trace_dir:
        yield
        return
    os.makedirs(trace_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    path = os.path.join(trace_dir, f"trace_{os.getpid()}.json")
    log.info("torch.profiler trace -> %s", path)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(path)
    log.info("trace complete: open %s in chrome://tracing or Perfetto",
             path)


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named span on the profiler's timeline
    (``torch.profiler.record_function``), plus a debug-level wall-clock
    line: the reference's console telemetry, kept."""
    t0 = time.perf_counter()
    with torch.profiler.record_function(name):
        yield
    log.debug("%s: %.3fs", name, time.perf_counter() - t0)
