"""Health monitoring, keep-alive heartbeat and signal handling of the
pipeline (counterpart: ``montecarlooptionspricer_tpu/pipeline/watchdog.py``).

* a health check every 5 s: peak RSS past 8 GiB or more than 1e8 errors
  terminates the run;
* a keep-alive line in the error log every 30 s;
* SIGINT / SIGTERM / SIGUSR1 log and set the terminate flag;
* a catastrophic failure short-circuits the remaining work.

Peak RSS includes the CUDA context and whatever the process held before
the run, as the reference's getrusage reading does.
"""

from __future__ import annotations

import logging
import resource
import signal
import threading
from typing import Callable, Optional

from ..config import PipelineConfig

log = logging.getLogger(__name__)


def current_memory_bytes() -> int:
    """Peak RSS of this process in bytes."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


class ProcessStats:
    """Counters and flags shared by the pipeline's threads."""

    def __init__(self, config: Optional[PipelineConfig] = None):
        self.config = config or PipelineConfig()
        self._lock = threading.Lock()
        self.total_memory_usage = 0
        self.error_count = 0
        self.should_terminate = threading.Event()
        self.catastrophic_failure = False
        self.failure_reason = ""

    def add_error(self) -> None:
        with self._lock:
            self.error_count += 1

    def fail(self, reason: str) -> None:
        with self._lock:
            self.catastrophic_failure = True
            self.failure_reason = reason
        self.should_terminate.set()

    def is_healthy(self) -> bool:
        return (not self.should_terminate.is_set()
                and self.error_count < self.config.max_errors
                and self.total_memory_usage < self.config.max_memory_bytes)


class Watchdog:
    """The health-check and keep-alive threads; ``stop`` ends both."""

    def __init__(self, stats: ProcessStats,
                 error_log_write: Callable[[str], None],
                 progress: Callable[[], int]):
        self.stats = stats
        self._write = error_log_write
        self._progress = progress
        self._threads = []

    def _health_loop(self) -> None:
        cfg = self.stats.config
        while not self.stats.should_terminate.wait(cfg.health_check_interval_s):
            self.stats.total_memory_usage = current_memory_bytes()
            if not self.stats.is_healthy():
                self._write("Process health check failed! Initiating "
                            "shutdown...\n")
                # Catastrophic, so the run exits non-zero and leaves a
                # resume marker rather than passing for a clean finish.
                self.stats.fail("health check failed (memory/error limit)")
                return

    def _keepalive_loop(self) -> None:
        cfg = self.stats.config
        while not self.stats.should_terminate.wait(cfg.keep_alive_interval_s):
            self._write(
                f"Still alive, last row processed = {self._progress()}, "
                f"memory usage ~{self.stats.total_memory_usage} bytes.\n")

    def start(self) -> None:
        for target in (self._health_loop, self._keepalive_loop):
            t = threading.Thread(target=target, daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self.stats.should_terminate.set()
        for t in self._threads:
            t.join(timeout=2.0)


def install_signal_handlers(stats: ProcessStats,
                            error_log_write: Callable[[str], None]
                            ) -> Callable[[], None]:
    """SIGINT / SIGTERM / SIGUSR1 -> log and terminate, so in-flight rows
    flush sentinel results first.  Returns a function that puts back the
    handlers that were there before (a no-op off the main thread, where
    none can be installed).

    The handler only sets flags and hands the message to a thread: it
    runs on the main thread, which may hold the error log's lock when the
    signal lands."""

    def handler(signum, frame):
        stats.should_terminate.set()
        stats.catastrophic_failure = True
        stats.failure_reason = f"signal {signum}"
        threading.Thread(
            target=error_log_write,
            args=(f"Caught signal {signum}. Terminating process.\n",),
            daemon=True).start()

    previous = {}
    for sig in (signal.SIGINT, signal.SIGTERM, signal.SIGUSR1):
        try:
            previous[sig] = signal.signal(sig, handler)
        except (ValueError, OSError):       # not the main thread
            break

    def restore() -> None:
        for sig, old in previous.items():
            if old is not None:         # None: set outside Python
                signal.signal(sig, old)

    return restore
