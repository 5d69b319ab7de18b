"""A new configuration, traffic mix and per-layer metric are found by
name from files of their own, with no edit to any file there."""

import json
import shutil
import subprocess
import sys

from gpubench import registry

RUNNER = """
import json, torch
torch.set_num_threads(2)
from gpubench import registry, run
from gpubench.tests.helpers import tiny, tiny_limits
bench, cell, config, traffic = tiny("dummy_cell")
config["grid"]["n_steps"] = 12
config["contract"]["maturity"] = 12 * config["grid"]["dt"]
res = run.run_cell(bench, cell, config, traffic, 7, 0.2, False, "cpu",
                   cell_limits=tiny_limits("dummy_cell"))
assert registry.HERE.parent.name == "copy", registry.HERE
print(json.dumps(res))
"""

METRIC = '''
def read(run):
    return 1.0 + len(run.window.done)
'''


def test_added_files_are_found_without_an_edit(tmp_path):
    copy = tmp_path / "copy"
    shutil.copytree(registry.HERE, copy / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = registry.benchmark()
    before = {p.relative_to(copy).as_posix(): p.read_bytes()
              for p in (copy / "gpubench").rglob("*") if p.is_file()}
    g = copy / "gpubench"
    config = registry.config("rbergomi_btw2020")
    config.update(name="dummy_market", source="a test's market")
    config["market"]["xi"] = 0.04
    (g / "configs" / "dummy_market.json").write_text(json.dumps(config))
    traffic = registry.traffic("put_atm_1e8")
    traffic["strikes"] = [95.0, 105.0]
    traffic["pricer"] = "strip"
    (g / "traffic" / "dummy_strip.json").write_text(json.dumps(traffic))
    (g / "end_to_end" / "dummy_e2e.py").write_text(METRIC)
    (g / "limits" / "dummy_cell.json").write_text(
        (g / "limits" / "strip_1y_k70-120_1e8.json").read_text())
    bench["configs"].append({"name": "dummy_market", "source": "test",
                             "file": "gpubench/configs/dummy_market.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "dummy_cell", "config": "dummy_market",
                               "traffic": "dummy_strip", "chips": 1,
                               "why": "test"})
    bench["end_to_end"].append({"name": "dummy_e2e", "unit": "n",
                                "better": "higher", "bound": 0.01,
                                "source": "host_clock",
                                "workloads": ["dummy_cell"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    out = subprocess.run([sys.executable, "-c", RUNNER], cwd=copy,
                         capture_output=True, text=True, timeout=600,
                         env={"PYTHONPATH": f"{copy}:{registry.ROOT}",
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert res["metrics"]["dummy_e2e"]["value"] == res["attempted"] + 1
    assert set(res["metrics"]) >= {"option_paths_per_s", "setup_s"}
    after = {p.relative_to(copy).as_posix(): p.read_bytes()
             for p in (copy / "gpubench").rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items())
