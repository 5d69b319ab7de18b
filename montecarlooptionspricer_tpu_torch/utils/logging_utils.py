"""Console logging of the port's command-line tools (counterpart:
``montecarlooptionspricer_tpu/utils/logging_utils.py``)."""

from __future__ import annotations

import logging
import sys


def setup_logging(level: int = logging.INFO) -> None:
    # stderr, not stdout: CLIs that print machine-readable results own
    # stdout, and interleaved log records would break their readers.
    logging.basicConfig(
        level=level,
        stream=sys.stderr,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
        datefmt="%H:%M:%S",
        force=True,
    )
