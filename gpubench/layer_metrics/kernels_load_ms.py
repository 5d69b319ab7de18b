"""Kernel libraries: milliseconds of loading the port's kernel libraries
(``kernels/build.py:load``: every unit's library bound with ``ctypes``,
from the warm build cache), the host's edges of the program's
``mcop.setup.kernels`` span in the fresh process of ``engine_spans``; a
unit this process compiled shows its nvcc seconds as an attribute of the
span, printed beside the result, not here."""

from gpubench import engine_spans


def read(run):
    return engine_spans.read(run, "setup", "mcop.setup.kernels", "host")
