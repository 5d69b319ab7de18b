"""Ordered, thread-safe output (counterpart:
``montecarlooptionspricer_tpu/pipeline/writer.py``).

Rows finish out of order (priced by bucket), but the output keeps the
input's row order: the contiguous ready prefix is written as it forms,
and the file is flushed every ``FLUSH_INTERVAL`` writes.
"""

from __future__ import annotations

import threading
from typing import Dict


class SafeFileWriter:
    """Lock-guarded writer with periodic flush and one reopen on error."""

    FLUSH_INTERVAL = 100

    def __init__(self, path: str, mode: str = "w"):
        self.path = path
        self._lock = threading.Lock()
        self._file = open(path, mode)
        self._count = 0

    def write(self, data: str) -> None:
        with self._lock:
            try:
                if self._file.closed:
                    self._file = open(self.path, "a")
                self._file.write(data)
            except OSError:
                # Close the wedged handle, reopen in append and retry once;
                # a second failure propagates.
                try:
                    self._file.close()
                except OSError:
                    pass
                self._file = open(self.path, "a")
                self._file.write(data)
            self._count += 1
            if self._count % self.FLUSH_INTERVAL == 0:
                self._file.flush()

    def write_line(self, data: str) -> None:
        self.write(data + "\n")

    def close(self) -> None:
        with self._lock:
            if not self._file.closed:
                self._file.flush()
                self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class OrderedResultWriter:
    """Buffers row lines and writes the contiguous ready prefix in input
    order."""

    def __init__(self, writer: SafeFileWriter, total_rows: int,
                 start_index: int = 0):
        self._writer = writer
        self._total = total_rows
        self._pending: Dict[int, str] = {}
        self._next = start_index       # rows below it are already on disk
        self._lock = threading.Lock()

    @property
    def next_row_to_write(self) -> int:
        return self._next

    def put(self, index: int, line: str) -> None:
        with self._lock:
            self._pending[index] = line
            while self._next < self._total and self._next in self._pending:
                self._writer.write_line(self._pending.pop(self._next))
                self._next += 1

    def flush_remaining(self) -> None:
        """Write whatever is ready past a gap, in order, and mark the
        writer complete: a late put() can no longer emit a line out of
        order."""
        with self._lock:
            for i in sorted(self._pending):
                self._writer.write_line(self._pending[i])
            self._pending.clear()
            self._next = self._total
