"""Tiny cells for the CPU tests: a cell's configuration and traffic cut
to a few steps and chunks, run through ``run.run_cell`` on the CPU."""

from __future__ import annotations

from gpubench import registry

SEED = 2 ** 31 + 12345


def tiny(cell_name: str, n_steps: int = 16, chunk: int = 2048,
         n_chunks: int = 8, here=registry.HERE):
    """(bench, cell, config, traffic) of ``cell_name`` at a tiny size."""
    bench = registry.benchmark(here.parent)
    cell = registry.workload(bench, cell_name)
    config = registry.config(cell["config"], here)
    traffic = registry.traffic(cell["traffic"], here)
    config["grid"]["n_steps"] = n_steps
    config["contract"]["maturity"] = n_steps * config["grid"]["dt"]
    config["stream"].update(chunk_paths=chunk, pilot_paths=chunk,
                            chunks_per_call=4)
    traffic["n_chunks"] = n_chunks
    return bench, cell, config, traffic


def tiny_limits(cell_name: str, here=registry.HERE) -> dict:
    """The cell's limits that hold at the tests' size: all but the
    witness's.  That limit holds at a cell's 1e8 paths; at the tests'
    16,384 one decision that the program's fit and the reference's own
    fit part on moves a price by 1/128 of a stderr at the money and by
    stderrs far out of it, and sound runs read up to 0.13."""
    limits = registry.limits(cell_name, here)
    del limits["witness_gap_se"]
    return limits
