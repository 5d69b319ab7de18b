"""Seconds from the process's start to the window's: imports, the CUDA
context, the kernel libraries (built on a checkout's first run, loaded
from its cache after), the pricer's host constants and one warm price."""


def read(run):
    return run.setup_s
