"""Kernels: milliseconds of a price's pilot block through the family's
path kernel (K1, or K6 past 365 steps), the device's edges of the
program's ``mcop.pilot`` span; the mean over the traced prices of
``engine_spans`` (the recorder on, no profiler)."""

from gpubench import engine_spans


def read(run):
    return engine_spans.read(run, "prices", "mcop.pilot", "device")
