"""Throughput of priced work: option-paths (paths x strikes) of every
completed price over the whole window, on the host's clock."""

from gpubench import window


def read(run):
    return window.option_paths_per_s(run.window)
