"""The measured window of a closed loop and the arithmetic of its
end-to-end metrics.

A run prices back to back from the window's start; the window ends when
the first price finishes after ``seconds``, so no price is cut and none is
left uncounted.  Every rate is taken over all the work and all the time of
the window.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# The stderr a desk prices to (currency units, S0 = 100).
TARGET_STDERR = 1e-3


@dataclass
class Done:
    """One completed request: its seed, host-clock start and end, the
    option-paths it priced (paths x strikes) and its answer."""

    seed: int
    start: float
    end: float
    option_paths: int
    prices: np.ndarray
    stderrs: np.ndarray


@dataclass
class Window:
    """The completed requests of a run's window, in order."""

    done: list = field(default_factory=list)

    @property
    def start(self) -> float:
        return self.done[0].start

    @property
    def end(self) -> float:
        return self.done[-1].end

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def closed(self, seconds: float) -> bool:
        """Whether the window is over: a price has finished at or past
        ``seconds`` after its start."""
        return bool(self.done) and self.seconds >= seconds


def run_closed_loop(quote, seeds, seconds: float, clock,
                    work: int) -> Window:
    """Back-to-back requests ``quote(seed) -> (prices, stderrs)`` over
    ``seeds`` (an iterator) until the window closes after ``seconds``:
    each request is timed on ``clock`` from its call to its answer, which
    ``quote`` returns on the host."""
    win = Window()
    for seed in seeds:
        t0 = clock()
        prices, stderrs = quote(seed)
        win.done.append(Done(seed, t0, clock(), work, prices, stderrs))
        if win.closed(seconds):
            break
    return win


def option_paths_per_s(win: Window) -> float:
    """Option-paths (paths x strikes) of every completed price over the
    whole window."""
    return sum(d.option_paths for d in win.done) / win.seconds


def s_to_target_se(win: Window, target: float = TARGET_STDERR) -> float:
    """Seconds to price to a stderr of ``target``: the window's seconds a
    price times the mean over prices and strikes of stderr^2 / target^2
    (the stderr falls as one over the root of the paths)."""
    se2 = np.mean([np.mean(np.square(d.stderrs)) for d in win.done])
    return win.seconds / len(win.done) * float(se2) / target ** 2
