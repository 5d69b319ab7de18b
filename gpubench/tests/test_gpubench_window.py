"""The window's arithmetic: the rate over the whole window, the last
price included, and the seconds to a target stderr."""

import numpy as np
import pytest

from gpubench import window


def _done(starts_ends, work=100, se=(1e-3,)):
    return [window.Done(i, a, b, work, np.zeros(len(se)), np.array(se))
            for i, (a, b) in enumerate(starts_ends)]


def test_rate_counts_every_price_over_the_whole_window():
    win = window.Window(_done([(10.0, 11.0), (11.0, 12.5), (12.5, 14.0)]))
    assert win.seconds == pytest.approx(4.0)
    assert window.option_paths_per_s(win) == pytest.approx(300 / 4.0)


def test_closed_loop_ends_at_the_first_price_past_the_seconds():
    clock = iter([0.0, 0.4, 0.4, 0.9, 0.9, 1.3, 1.3, 1.7]).__next__
    win = window.run_closed_loop(lambda s: (np.zeros(1), np.ones(1)),
                                 iter(range(10)), 1.0, clock, 7)
    assert [d.seed for d in win.done] == [0, 1, 2]
    assert win.seconds == pytest.approx(1.3)
    assert window.option_paths_per_s(win) == pytest.approx(21 / 1.3)


def test_s_to_target_se_from_walls_and_stderrs():
    win = window.Window(_done([(0.0, 1.0), (1.0, 3.0)], se=(2e-3, 0.0)))
    # 1.5 s a price; mean of (2e-3)^2 and 0 over strikes is 2e-6.
    assert window.s_to_target_se(win) == pytest.approx(1.5 * 2.0)
    win = window.Window(_done([(0.0, 2.0)], se=(5e-4,)))
    assert window.s_to_target_se(win, target=1e-3) == pytest.approx(0.5)
