"""Seconds to price to a stderr of 0.001: the window's seconds a price
times the mean over prices and strikes of (stderr / 0.001)^2, with each
price's own stderr (conditional on its pilot's fit)."""

from gpubench import window


def read(run):
    return window.s_to_target_se(run.window)
