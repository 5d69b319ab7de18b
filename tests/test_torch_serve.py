"""``mcop-price-torch --serve`` in process on the CPU (``cli/price.py:
serve`` with stdin replaced), the counterparts of the JAX CLI's six serve
tests (``tests/test_cli.py``): ids in order, the ``compiled`` flags,
fresh strikes, xi, H, s0, r and path budgets repricing on the pricer a
shape class holds, the guards, the NaN and Infinity lines, warm buckets
kept off stdout, the 100-request replay; and one served strip against the
JAX package's served strip (``bucketed=True, traced_market=True``, XLA)
within 5 combined stderr."""

import io
import json
import sys

import jax
import numpy as np
import pytest
import torch

from montecarlooptionspricer_tpu.models import engine as jengine
from montecarlooptionspricer_tpu_torch.cli import price as tcli

from test_torch_tiled import BENCH_MARKET

BASE = ["--serve", "--device", "cpu", "--chunk-paths", "256"]


@pytest.fixture(autouse=True)
def one_thread():
    """Many small ops a quote; one thread keeps them off the pool's
    wake-ups on a shared host."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def serve(monkeypatch, capsys, lines, flags=()):
    """Run the server on ``lines`` (dicts or raw strings) and return its
    answers, one dict a stdout line."""
    text = "\n".join(x if isinstance(x, str) else json.dumps(x)
                     for x in lines) + "\n"
    monkeypatch.setattr(sys, "stdin", io.StringIO(text))
    assert tcli.main(BASE + list(flags)) == 0
    out = capsys.readouterr().out
    return [json.loads(line) for line in out.strip().splitlines()]


def quote(i, strikes, **kw):
    req = {"id": i, "strikes": strikes, "put": True, "maturity": 0.1,
           "steps": 8, "paths": 1024}
    req.update(kw)
    return req


def test_serve_mode(monkeypatch, capsys):
    """Answers in order; a fresh strip and a fresh xi reprice on the
    class's pricer (compiled false); an empty strip answers an error and
    the server reads on; the first Greeks quote on a class is compiled,
    the second is not, with put deltas falling in the strike."""
    rows = serve(monkeypatch, capsys, [
        quote(1, [95.0, 100.0, 105.0]), quote(2, [92.0, 99.0, 111.0]),
        {"id": 3, "strikes": [], "put": True},
        quote(4, [100.0, 103.0, 106.0], xi=0.09),
        quote(5, [95.0, 100.0, 105.0], greeks=True),
        quote(6, [96.0, 101.0, 104.0], greeks=True)])
    assert [r["id"] for r in rows] == [1, 2, 3, 4, 5, 6]
    r1, r2, r3, r4, r5, r6 = rows
    assert r1["compiled"] and len(r1["prices"]) == 3
    assert r1["prices"][0] < r1["prices"][1] < r1["prices"][2]
    assert not r2["compiled"] and r2["prices"][0] < r2["prices"][2]
    assert "error" in r3
    assert not r4["compiled"] and r4["prices"][1] > r2["prices"][1]
    assert r5["compiled"] and len(r5["delta"]) == 3
    assert r5["delta"][0] > r5["delta"][2]
    assert all(np.isfinite(v) for v in r5["vega_h"])
    assert not r6["compiled"] and len(r6["vega_xi"]) == 3


def test_serve_buckets_maturities(monkeypatch, capsys):
    """20 and 30 steps share the pow2 bucket 32: the second expiry
    reprices on the first's pricer with its own step count, and its puts
    are worth more."""
    rows = serve(monkeypatch, capsys, [
        {"id": 1, "strikes": [95.0, 105.0], "put": True, "maturity": 0.08,
         "paths": 1024},
        {"id": 2, "strikes": [95.0, 105.0], "put": True, "maturity": 0.12,
         "paths": 1024}])
    r1, r2 = rows
    assert r1["compiled"] and r1["n_steps"] == 20
    assert not r2["compiled"] and r2["n_steps"] == 30
    assert r2["prices"][0] > r1["prices"][0] - 0.05
    assert r2["prices"][1] > r1["prices"][1] - 0.05


def test_serve_guards_and_reuse_buckets(monkeypatch, capsys):
    """Huge steps, paths and strips are refused before any pricer is
    built; 3 and 4 strikes share the strip bucket 4 and a doubled budget
    reuses the pricer; H outside (0, 1) and NaN or Infinity in maturity,
    strikes or the market answer errors, never prices."""
    rows = serve(monkeypatch, capsys, [
        {"id": 1, "strike": 100.0, "put": True, "maturity": 0.1,
         "steps": 500000, "paths": 1024},
        quote(2, [100.0], paths=1e9), quote(3, [100.0] * 9),
        quote(4, [95.0, 100.0, 105.0]), quote(5, [94.0, 99.0, 104.0, 109.0]),
        quote(6, [95.0, 100.0, 105.0], paths=2048),
        quote(7, [100.0], hurst=-0.1),
        '{"id": 8, "strike": 100.0, "put": true, "maturity": NaN, '
        '"steps": 8, "paths": 1024}',
        '{"id": 9, "strikes": [Infinity], "put": true, "maturity": 0.1, '
        '"steps": 8, "paths": 1024}',
        '{"id": 10, "strike": 100.0, "put": true, "maturity": 0.1, '
        '"steps": 8, "paths": 1024, "s0": NaN}'], ["--max-strikes", "8"])
    assert [r["id"] for r in rows] == list(range(1, 11))
    r1, r2, r3, r4, r5, r6, r7, r8, r9, r10 = rows
    assert "max-steps" in r1["error"]
    assert "max-paths" in r2["error"]
    assert "max-strikes" in r3["error"]
    assert r4["compiled"] and len(r4["prices"]) == 3
    assert r4["prices"][0] < r4["prices"][1] < r4["prices"][2]
    assert not r5["compiled"] and len(r5["prices"]) == 4
    assert not r6["compiled"] and r6["n_paths"] == 2048
    assert len(r6["stderrs"]) == 3
    assert "hurst" in r7["error"]
    assert "maturity" in r8["error"]
    assert "strikes" in r9["error"]
    assert "s0" not in r10 and "market" in r10["error"]


def test_serve_reprices_fresh_hurst_without_rebuild(monkeypatch, capsys):
    """A fresh H, then a fresh s0, xi and r, reprice on the class's
    pricer; H moves the prices and a lower spot raises the puts."""
    rows = serve(monkeypatch, capsys, [
        quote(1, [95.0, 105.0], hurst=0.1), quote(2, [95.0, 105.0],
                                                 hurst=0.35),
        quote(3, [95.0, 105.0], s0=97.0, xi=0.06, r=0.03)])
    r1, r2, r3 = rows
    assert r1["compiled"] and not r2["compiled"] and not r3["compiled"]
    assert r1["prices"] != r2["prices"]
    assert r3["prices"][1] > r1["prices"][1]


def test_serve_warm_buckets(monkeypatch, capsys):
    """--warm-buckets builds the named classes first: the first real
    quote of a warmed class is not compiled, and the warm answers stay
    off stdout."""
    rows = serve(monkeypatch, capsys, [
        {"id": 1, "strikes": [95.0, 100.0], "put": True, "maturity": 0.1,
         "steps": 20, "paths": 1024}], ["--warm-buckets", "20x2"])
    assert len(rows) == 1 and rows[0]["id"] == 1
    assert not rows[0]["compiled"]


def test_serve_compile_count_100_replay(monkeypatch, capsys):
    """A 100-request mixed replay (step buckets 8 and 32, strip buckets 2
    and 4, fresh strips, budgets, markets, H and seeds, Greeks every 5th
    quote) plus 2 malformed lines: exactly 8 compiled rows (4 classes and
    their first Greeks quotes), 2 error rows in place, 20 Greeks rows."""
    reqs = []
    for i in range(100):
        k = [2, 3][i % 2]
        steps = [8, 24][(i // 2) % 2]
        reqs.append({
            "id": i,
            "strikes": [94.0 + 4 * j + (i % 9) * 0.5 for j in range(k)],
            "put": True, "steps": steps, "maturity": steps / 252.0,
            "paths": [256, 512][i % 2], "hurst": 0.1 + 0.02 * (i % 8),
            "s0": 100.0 + 0.2 * (i % 7), "xi": 0.04 + 0.002 * (i % 4),
            "seed": i, "greeks": i % 5 == 4})
    reqs.insert(33, "{broken json")
    reqs.insert(66, {"id": "bad", "strike": 100.0, "maturity": 0.1,
                     "hurst": 2.0})
    rows = serve(monkeypatch, capsys, reqs)
    assert len(rows) == 102
    assert len([r for r in rows if "error" in r]) == 2
    assert rows[33] == {"id": None, "error": rows[33]["error"]}
    assert rows[66]["id"] == "bad"
    compiled = [r["id"] for r in rows if r.get("compiled")]
    assert len(compiled) == 8, compiled
    ok = [r for r in rows if "error" not in r]
    assert all(r["prices"] for r in ok)
    assert sum("delta" in r for r in ok) == 20


def test_served_strip_matches_jax(monkeypatch, capsys):
    """One served strip (2,048 paths, 12 live steps in bucket 16, a fresh
    market and H) against the JAX package's served strip on its XLA
    generator (``StreamingChainPricer(bucketed=True, traced_market=True)``,
    the same call), each strike within 5 combined stderr."""
    strikes = [95.0, 100.0, 105.0, 105.0]
    call = dict(n_steps_live=12, maturity=12 / 252.0, hurst=0.2,
                market=dict(s0=99.0, xi=0.05, r=0.03, eta=1.3))
    cfg = jengine.StreamConfig(n_paths=2048, n_steps=16, chunk_paths=256,
                               pilot_paths=256, chunks_per_call=8)
    jchain = jengine.StreamingChainPricer(
        **BENCH_MARKET, strikes=strikes, maturity=16 / 252.0, is_call=False,
        config=cfg, bucketed=True, traced_market=True)
    want, want_se = jchain.price(jax.random.key(3), with_stderr=True, **call)
    rows = serve(monkeypatch, capsys, [
        {"id": 0, "strikes": strikes[:3], "put": True, "maturity": 12 / 252.0,
         "steps": 12, "paths": 2048, "hurst": 0.2, "seed": 3,
         **call["market"]}])
    got, got_se = np.array(rows[0]["prices"]), np.array(rows[0]["stderrs"])
    tol = 5 * np.hypot(got_se, np.asarray(want_se)[:3])
    assert np.all(np.abs(got - np.asarray(want)[:3]) < tol), (got, want)
