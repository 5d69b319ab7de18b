"""Device: the share of the traced prices' wall in which no device
operation ran (the union of kernel, copy and fill intervals), in
percent."""

from gpubench import trace


def read(run):
    start, end = run.trace.window
    if end <= start or not run.trace.device:
        return None
    return 100.0 * (1.0 - trace.busy_s(run.trace.device, start, end)
                    / (end - start))
