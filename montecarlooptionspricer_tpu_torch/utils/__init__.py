"""Utilities of the port's command-line tools: logging, profiling spans and
traces, the kernel build cache."""

from .jit_cache import enable_persistent_cache  # noqa: F401
from .logging_utils import setup_logging  # noqa: F401
from .profiling import count, device_trace, span, tracing  # noqa: F401
