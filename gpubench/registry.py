"""Where the benchmark finds each of its pieces, by the names that
``BENCHMARK.json`` gives them: a configuration in ``configs/<name>.json``,
a traffic mix in ``traffic/<name>.json``, a per-layer metric's reader in
``layer_metrics/<name>.py``, an end-to-end metric's in
``end_to_end/<name>.py`` and a cell's limits of correctness in
``limits/<workload>.json``.  Adding a piece is adding its file."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str, here: Path = HERE) -> dict:
    return _json(here / "configs" / f"{name}.json")


def traffic(name: str, here: Path = HERE) -> dict:
    return _json(here / "traffic" / f"{name}.json")


def limits(workload_name: str, here: Path = HERE) -> dict:
    return _json(here / "limits" / f"{workload_name}.json")


def reader(kind: str, name: str, here: Path = HERE):
    """The ``read`` function of metric ``name``'s file under ``kind``
    ("layer_metrics" or "end_to_end")."""
    path = here / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"gpubench_{kind}_{name}".replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def metrics_of(bench: dict, kind: str, workload_name: str) -> list:
    """The metrics of ``kind`` ("end_to_end" or "per_layer") that a cell
    reports: those without a ``workloads`` list, and those that list it."""
    return [m for m in bench[kind]
            if workload_name in m.get("workloads", [workload_name])]
