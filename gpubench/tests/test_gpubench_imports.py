"""Nothing a run loads is JAX or the JAX package (top-level names
compared whole), and the reference loads nothing of the port."""

import ast
import subprocess
import sys

from gpubench import registry, run

PORT = "montecarlooptionspricer_tpu_torch"


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, PORT + "_fake", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_fake", object())
    assert "montecarlooptionspricer_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "montecarlooptionspricer_tpu.models",
                        object())
    assert run.forbidden_modules() == ["montecarlooptionspricer_tpu"]


RUN = """
import sys, torch
torch.set_num_threads(2)
from gpubench import run
from gpubench.tests.helpers import tiny, tiny_limits
cell = "put_1y_k100_1e8_anti_cv"
res = run.run_cell(*tiny(cell), 3, 0.2, False, "cpu",
                   cell_limits=tiny_limits(cell))
assert res["correct"], res
print(run.forbidden_modules())
print(sorted(m for m in sys.modules if m.split(".")[0] == "%s"))
""" % PORT

REFERENCE = """
import sys, torch
from gpubench import correct
from gpubench.reference import rbergomi_lsm as ref
from gpubench.tests.helpers import tiny
from gpubench.system import request
_, _, config, traffic = tiny("strip_1y_k70-120_1e8")
req = request(config, traffic)
law = correct.law(config, "cpu")
k = torch.tensor(req.strikes, dtype=torch.float64)
fit = ref.lsm_fit(ref.with_s0(law, ref.pilot_log_paths(law, 5, 2048)), k,
                  law.r, law.dt, False)
q = ref.stream(law, fit, k, False, 5, req.n_chunks, 2048)
assert q.price.shape == (6,)
print(sorted({m.split(".")[0] for m in sys.modules}))
"""


def _python(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=registry.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()


def test_a_run_loads_no_jax():
    lines = _python(RUN)
    assert lines[-2] == "[]"
    assert PORT in lines[-1]          # the port did run


def test_reference_loads_nothing_of_the_port():
    tops = _python(REFERENCE)[-1]
    assert "montecarlooptionspricer_tpu" not in tops
    assert "jax" not in tops.replace("jaxtyping", "")


def test_reference_sources_import_no_program():
    for path in (registry.HERE / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for name in names:
                assert name.split(".")[0] in {"__future__", "contextlib",
                                              "math",
                                              "dataclasses", "numpy",
                                              "torch"}, (path, name)
