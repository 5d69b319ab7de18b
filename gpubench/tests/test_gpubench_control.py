"""The control at a size a test run holds: the program's own lower
precision path (bf16 fGN inputs) fails a number that sound runs pass."""

import pytest
import torch

from gpubench import control, registry
from gpubench.tests.helpers import tiny

CELLS = ["put_1y_k100_1e8", "strip_1y_k70-120_1e8",
         "put_1y_k100_1e8_anti_cv", "put_2y_k100_1e8"]


@pytest.fixture(autouse=True)
def few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("cell_name", CELLS)
def test_bf16_control_fails_the_pilot_gap(cell_name):
    _, _, config, traffic = tiny(cell_name, n_steps=24)
    limit = registry.limits(cell_name)["pilot_gap"]["limit"]
    for out in control.readings(config, traffic, [21, 22], device="cpu",
                                controls=("bf16",)):
        assert out["program"]["pilot_gap"] <= limit / 3
        assert out["bf16"]["pilot_gap"] > limit
