"""The frozen count equals ``chip_smoke.py``'s at the shapes of PERF.md's
kernel table, and a price's stream counts its chunks."""

import importlib.util

import pytest

from gpubench import registry
from gpubench.roofline import count

CASES = [
    ((131072, 365, 4 * 1024), {}),                           # K2
    ((131072, 365, 4 * 1024), {"antithetic": True, "with_cv": True}),
    ((131072, 365, 4 * 1024), {"spectral": True}),
    ((131072, 365, 4 * 1024), {"bf16": True}),
    ((131072, 365, 4 * 2048), {"policy_rows": 1 + 4 * 21,
                               "swept": 10 ** 9}),           # K5
    ((131072, 365, 4 * 6), {"products": 2, "per_cell": 18.0,
                            "policy_rows": 5}),              # K3
    ((131072, 1825, 4 * 131072 * 1826), {}),                 # K6
    ((131072, 1825, 4 * 2048), {"quad_cells": 10 ** 9}),     # K7/quad
]
FACTORED = [((131072, 4000, 4 * 2048), {}),
            ((131072, 4000, 4 * 2048), {"antithetic": True, "bf16": True}),
            ((131072, 1825, 4 * 2048), {"with_cv": True, "policy_rows": 4})]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", registry.ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("args,kw", CASES)
def test_bound_equals_chip_smoke(smoke, args, kw):
    assert count.bound_ms(*args, **kw) == smoke.bound_ms(*args, **kw)


@pytest.mark.parametrize("args,kw", FACTORED)
def test_factored_bound_equals_chip_smoke(smoke, args, kw):
    assert (count.factored_bound_ms(*args, **kw)
            == smoke.factored_bound_ms(*args, **kw))


def test_k2_bound_is_the_table_s():
    ms, by = count.bound_ms(131072, 365, 4 * 1024)
    assert by == "operations" and round(ms, 3) == 0.267


def test_stream_counts_chunks_and_strikes():
    config = registry.config("rbergomi_btw2020")
    one = count.stream_least_s(config, 1, 1, False, False)
    assert count.stream_least_s(config, 1, 763, False, False) == \
        pytest.approx(763 * one)
    assert count.stream_least_s(config, 6, 1, False, False) >= one
    assert count.stream_least_s(config, 1, 1, True, True) < one
