"""A run end to end on the CPU at a tiny size: its last line, its checks,
and faults planted under the timed path that turn ``correct`` false."""

import json
import math
import subprocess
import sys

import numpy as np
import pytest
import torch

from gpubench import correct, registry, run
from gpubench.reference import rbergomi_lsm as ref
from gpubench.tests.helpers import SEED, tiny, tiny_limits

CELLS = ["put_1y_k100_1e8", "strip_1y_k70-120_1e8",
         "put_1y_k100_1e8_anti_cv", "put_2y_k100_1e8"]


@pytest.fixture(autouse=True)
def few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _run(cell_name, quote_hook=None, **kw):
    bench, cell, config, traffic = tiny(cell_name, **kw)
    return run.run_cell(bench, cell, config, traffic, SEED, 0.3, False,
                        "cpu", quote_hook=quote_hook,
                        cell_limits=tiny_limits(cell_name))


def test_last_line_parses_with_the_contract_keys(capsys):
    result = _run("put_1y_k100_1e8")
    line = json.loads(json.dumps(result))
    assert set(line) >= {"correct", "attempted", "failed", "metrics",
                         "device"}
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["attempted"] >= 1
    assert set(line["metrics"]) == {"option_paths_per_s", "s_to_target_se",
                                    "setup_s"}
    for m in line["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert {"price_gap_se", "stderr_gap"} <= set(line["checks"])
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    family = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
    assert family["kernel_family"] == "single"


@pytest.mark.parametrize("cell_name", CELLS)
def test_each_cell_runs_correct(cell_name):
    kw = {"n_steps": 24} if cell_name == "put_2y_k100_1e8" else {}
    assert _run(cell_name, **kw)["correct"] is True


def _half_the_chunks(pricer):
    """Half of the chunks left out underneath, the mean taken over the
    rest: the engine's chunk groups cut to their first half."""
    inner = pricer.pricer
    groups = inner._groups

    def first_half(*args, **kw):
        _, gs = groups(*args, **kw)
        kept = gs[:max(1, len(gs) // 2)]
        return sum(map(len, kept)) * inner.config.chunk_paths, kept
    inner._groups = first_half
    return pricer.quote


def _altered(pricer, monkeypatch):
    """Every chunk's sum altered by 1 % where the kernel produces it."""
    from montecarlooptionspricer_tpu_torch.models import chain_cuda

    def alter(fn):
        def chunk(*args, **kw):
            out = fn(*args, **kw)
            if isinstance(out, tuple):
                return (out[0] * 1.01,) + tuple(out[1:])
            return out * 1.01
        return chunk
    inner = pricer.pricer
    if hasattr(inner, "_priced_chunk"):
        inner._priced_chunk = alter(inner._priced_chunk)
    monkeypatch.setattr(chain_cuda, "priced_chain",
                        alter(chain_cuda.priced_chain))
    return pricer.quote


@pytest.mark.parametrize("cell_name", CELLS[:3])
def test_half_the_chunks_is_not_correct(cell_name):
    assert _run(cell_name, quote_hook=_half_the_chunks)["correct"] is False


@pytest.mark.parametrize("cell_name", CELLS[:3])
def test_altered_answer_is_not_correct(cell_name, monkeypatch):
    result = _run(cell_name,
                  quote_hook=lambda p: _altered(p, monkeypatch))
    assert result["correct"] is False
    assert result["checks"]["replay_gap"]["value"] == 0.0


def _stderr_scaled(factor, monkeypatch):
    """Every stderr the engine works out from its chunk totals scaled by
    ``factor`` where it is produced (sqrt 2: the stderr that half the
    chunks would give), the prices left as they are."""
    from montecarlooptionspricer_tpu_torch.models import engine
    inner = engine._chunk_stderr
    monkeypatch.setattr(engine, "_chunk_stderr",
                        lambda *a, **kw: inner(*a, **kw) * factor)


@pytest.mark.parametrize("factor", [math.sqrt(2.0), 1.05])
@pytest.mark.parametrize("cell_name", CELLS[:3])
def test_stderr_fault_is_not_correct(cell_name, factor, monkeypatch):
    _stderr_scaled(factor, monkeypatch)
    result = _run(cell_name)
    assert result["correct"] is False
    checks = result["checks"]
    assert checks["replay_gap"]["value"] == 0.0
    assert checks["price_gap_se"]["value"] <= checks["price_gap_se"]["limit"]
    assert checks["stderr_gap"]["value"] > checks["stderr_gap"]["limit"]


@pytest.mark.parametrize("cell_name", CELLS[:3])
def test_witness_is_read_from_the_seed_alone(cell_name):
    """The witness streams the reference's own fit on its own pilot: from
    the program's state it takes nothing but the paths' seed."""
    from gpubench import system
    _, _, config, traffic = tiny(cell_name)
    req = system.request(config, traffic)
    pricer = system.Pricer(config, req, device="cpu")
    prices, stderrs = pricer.quote(SEED)
    state = correct.program_state(pricer, SEED)
    stranger = correct.State(state.pilot_ls + 0.01, state.fit, None)
    ref_a = correct.reference(config, req, SEED, state, "cpu", witness=True)
    ref_b = correct.reference(config, req, SEED, stranger, "cpu",
                              witness=True)
    assert np.array_equal(ref_a.witness.price, ref_b.witness.price)
    found = correct.numbers(prices, stderrs, state, ref_a, req.strikes)
    assert 0.0 <= found["witness_gap_se"] < math.inf


def test_stderr_gap_is_relative_and_exact_at_zero():
    quote = ref.Quote(np.array([1.0, 0.0]), np.array([0.002, 0.0]))
    assert correct.stderr_gap(np.array([0.0021, 0.0]), quote) == \
        pytest.approx(0.05)
    assert correct.stderr_gap(np.array([0.002, 1e-9]), quote) == math.inf
    assert correct.stderr_gap(np.array([np.nan, 0.0]), quote) == math.inf


def test_no_card_exits_without_a_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, "-m", "gpubench.run", "--workload",
         "put_1y_k100_1e8", "--seed", str(SEED), "--seconds", "1"],
        cwd=registry.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 2
    assert out.stdout == ""
    assert "CUDA" in out.stderr


def test_traced_run_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    bench, cell, config, traffic = tiny("put_1y_k100_1e8")
    with pytest.raises(RuntimeError, match="CUDA"):
        run.run_cell(bench, cell, config, traffic, SEED, 0.3, True, "cpu")


def test_nonfinite_answer_is_not_correct():
    def nan(pricer):
        def quote(seed):
            prices, stderrs = pricer.quote(seed)
            return np.full_like(prices, np.nan), stderrs
        return quote
    assert _run("put_1y_k100_1e8", quote_hook=nan)["correct"] is False
