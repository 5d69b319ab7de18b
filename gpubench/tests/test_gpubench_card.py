"""On the card: a cell's run end to end, and its controls at a cut size.
Run there with ``python -m pytest gpubench/tests -m gpu`` (they skip
without a CUDA device)."""

import json
import subprocess
import sys

import pytest
import torch

from gpubench import control, registry


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
def test_a_cell_runs_correct_on_the_card(card, trace):
    out = subprocess.run(
        [sys.executable, "-m", "gpubench.run", "--workload",
         "put_1y_k100_1e8", "--seed", "3", "--seconds", "2", "--trace",
         str(trace)], cwd=registry.ROOT, capture_output=True, text=True,
        timeout=1500)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["kind"] == torch.cuda.get_device_name(0)
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        assert line["metrics"]["stream_roofline_pct"]["value"] <= 100.0


@pytest.mark.gpu
@pytest.mark.parametrize("cell_name", ["put_1y_k100_1e8",
                                       "put_2y_k100_1e8"])
def test_controls_fail_on_the_card(card, cell_name):
    bench = registry.benchmark()
    cell = registry.workload(bench, cell_name)
    config = registry.config(cell["config"])
    traffic = registry.traffic(cell["traffic"])
    traffic["n_chunks"] = 16
    limit = registry.limits(cell_name)["pilot_gap"]["limit"]
    for out in control.readings(config, traffic, [41]):
        assert out["program"]["pilot_gap"] <= limit
        assert out["bf16"]["pilot_gap"] > limit
        assert out["tf32"]["pilot_gap"] > limit
