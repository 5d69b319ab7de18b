"""The kernel build cache (counterpart: ``montecarlooptionspricer_tpu/
utils/jit_cache.py``, JAX's persistent compilation cache).

The port's kernels are compiled by ``nvcc`` at first use into one shared
library per build unit (``kernels/build.py``), named by a hash of its
sources and flags, so a library built once is loaded by every later
process: that directory is the port's persistent cache.  It defaults to
``build/kernels`` in the checkout; the environment variable
``MCOP_KERNEL_CACHE_DIR`` moves it.
"""

from __future__ import annotations

import os

from ..kernels import build


def enable_persistent_cache(cache_dir: str | None = None) -> str:
    """Point the kernel build cache at a directory and return the active
    one.  Idempotent: a directory already set in ``MCOP_KERNEL_CACHE_DIR``
    (by the caller's environment or an earlier call) stays; otherwise
    ``cache_dir``, or the default ``build/kernels`` of the checkout, is set
    there.  Nothing is built here."""
    current = os.environ.get(build.CACHE_ENV)
    if not current:
        current = os.path.abspath(cache_dir or build.DEFAULT_BUILD_DIR)
        os.environ[build.CACHE_ENV] = current
    return current
