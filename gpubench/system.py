"""The system under test: the port's streaming pricers, built from a
configuration file and a traffic file.

This is the only module of the benchmark that imports the port
(``montecarlooptionspricer_tpu_torch``); it takes from it the pricer, its
two halves ``fit`` and ``price_with_fit`` (the traced run's spans, and
the state ``correct`` reads), its pilot block and the kernel family it
chose.  Nothing here imports at module import time.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np


@dataclass
class Request:
    """What one request of a traffic mix prices: the pricer kind, its
    strikes, paths and estimators."""

    pricer: str
    strikes: list
    n_chunks: int
    antithetic: bool
    control_variate: bool

    @property
    def n_strikes(self) -> int:
        return len(self.strikes)


def request(config: dict, traffic: dict) -> Request:
    """The request a traffic mix sends against a configuration."""
    contract = config["contract"]
    which = traffic["strikes"]
    if which == "atm":
        strikes = [float(contract["atm_strike"])]
    elif which == "all":
        strikes = [float(k) for k in contract["strikes"]]
    else:
        strikes = [float(k) for k in which]
    if traffic["pricer"] not in ("single", "strip"):
        raise ValueError(f"unknown pricer {traffic['pricer']!r}")
    if traffic["pricer"] == "single" and len(strikes) != 1:
        raise ValueError("a single pricer quotes one strike")
    return Request(traffic["pricer"], strikes, int(traffic["n_chunks"]),
                   bool(traffic["antithetic"]),
                   bool(traffic["control_variate"]))


def request_seed(seed: int, i: int) -> int:
    """The seed of the i-th request of a run (i = -1: the warm-up's)."""
    return int(seed) * 1_000_003 + 1 + int(i)


def _arrays(quote) -> tuple:
    """(prices, stderrs) of either pricer as float64 arrays, one value per
    strike."""
    return tuple(np.atleast_1d(np.asarray(v, np.float64)) for v in quote)


class Pricer:
    """One built pricer of a cell and its quote call."""

    def __init__(self, config: dict, req: Request, device: str = "cuda",
                 fgn_matmul_dtype: str | None = None):
        from montecarlooptionspricer_tpu_torch.models import engine

        self._engine = engine
        m, c, g = config["market"], config["contract"], config["grid"]
        fields = dict(config["stream"])
        if fgn_matmul_dtype is not None:
            fields["fgn_matmul_dtype"] = fgn_matmul_dtype
        self.req = req
        self.chunk = int(fields["chunk_paths"])
        self.n_paths = req.n_chunks * self.chunk
        cfg = engine.StreamConfig(
            n_paths=self.n_paths, n_steps=int(g["n_steps"]), dt=float(g["dt"]),
            antithetic=req.antithetic, control_variate=req.control_variate,
            **fields)
        args = (m["s0"], m["xi"], m["h"], m["eta"], m["rho"], m["r"])
        t0 = time.perf_counter()
        if req.pricer == "single":
            self.pricer = engine.StreamingPricer(
                *args, req.strikes[0], c["maturity"], bool(c["is_call"]), cfg,
                device=device)
        else:
            self.pricer = engine.StreamingChainPricer(
                *args, req.strikes, c["maturity"], bool(c["is_call"]), cfg,
                device=device)
        self.consts_s = time.perf_counter() - t0

    @property
    def kernel_family(self) -> str:
        return self.pricer.kernel_family

    def quote(self, seed: int, n_paths: int | None = None) -> tuple:
        """(prices, stderrs), float64 arrays of one value per strike: the
        timed path, ``price(seed, with_stderr=True)``."""
        n = self.n_paths if n_paths is None else n_paths
        return _arrays(self.pricer.price(seed, n, with_stderr=True))

    def fit(self, seed: int):
        """The first half of ``price``: the pilot and its fit."""
        k_pilot, _ = self._engine._pilot_stream_keys(seed)
        return self.pricer.fit(k_pilot)

    def pilot(self, seed: int):
        """[pilot, n + 1] prices of request ``seed``'s pilot block (S0 in
        column 0), through the family's path kernel as ``fit`` draws it."""
        k_pilot, _ = self._engine._pilot_stream_keys(seed)
        return self.pricer._pilot(k_pilot)

    def price_with_fit(self, fits, seed: int) -> tuple:
        """The second half of ``price``: the stream under ``fits``."""
        return _arrays(self.pricer.price_with_fit(
            fits, seed, self.n_paths, with_stderr=True))

    def form_launches(self) -> dict:
        """The port's launch counters of the kernels this cell can run
        (printed on an earlier line; never judged)."""
        from montecarlooptionspricer_tpu_torch.models import (
            chain_cuda, pathgen_cuda, pathgen_tiled_cuda)
        out = {}
        for name, fn in (("K1", pathgen_cuda.pathgen),
                         ("K2", pathgen_cuda.priced_chunk),
                         ("K5", chain_cuda.priced_chain),
                         ("K6", pathgen_tiled_cuda.tiled_pathgen),
                         ("K7", pathgen_tiled_cuda.tiled_priced_chunk)):
            counts = getattr(fn, "form_launches", None)
            if counts:
                live = {k: v for k, v in dict(counts).items() if v}
                if live:
                    out[name] = live
        return out
