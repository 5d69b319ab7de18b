"""How a run decides ``correct``: a sample of the window's answers, drawn
from the seed, held against the plain reference
(``reference.rbergomi_lsm``), each number compared with its limit in
``limits/<workload>.json``.

An answer is a price and its stderr per strike, each the mean over 1e8
paths, so unbiased rounding of single paths averages out of it, and the
policy a float32 fit draws differs from a float64 fit's in the decisions
of the paths that lie on its boundary.  So the reference follows the
program's own state at one point, and checks the stages it skips by
themselves (PERF.md, section 2).  A cell's limits file names the numbers
it compares: those its control separates from sound runs.

* ``pilot_gap``: the pilot block the price fitted on (the program's path
  kernel, recomputed from the sampled request's seed) against the
  reference's pilot from the same seed: the widest gap of a log price.
* ``fit_gap``: the program's fitted continuation against the fit the
  reference works out on the program's pilot, at the reference's
  regressor mean and one standard deviation either side, each step and
  strike, over the strike.
* ``price_gap_se``: the answer against the reference's stream of the
  same request under the program's fit: the widest gap of a strike's
  price in units of the reference's stderr (exact where that stderr is
  0).
* ``stderr_gap``: the answer's stderr against that stream's: the widest
  gap of a strike's stderr as a share of the reference's (exact where
  that is 0).
* ``witness_gap_se``: the answer against the reference's answer from the
  seed alone, its own fit on its own pilot streamed on the same paths,
  read as ``price_gap_se`` is: the one number that holds the whole
  request, fit and stream, against the reference end to end.
* ``replay_gap``: the program's answer from that state (``price_with_fit``
  on the recomputed fit) against the window's answer: 0, so the state is
  the one the timed path used.

The reference runs in float64 after the window has closed and the
device's peak memory has been read.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass

import numpy as np
import torch

from .reference import rbergomi_lsm as ref


def sample(done: list, seed: int) -> list:
    """The sampled answers: one completed request, drawn from the seed."""
    return [random.Random(int(seed)).choice(done)]


def law(config: dict, device, dtype=torch.float64,
        tf32: bool = False) -> ref.Law:
    m, g = config["market"], config["grid"]
    return ref.Law(m["s0"], m["xi"], m["h"], m["eta"], m["r"],
                   int(g["n_steps"]), float(g["dt"]), torch.device(device),
                   dtype, tf32)


@dataclass
class State:
    """The program's state behind one answer: its pilot's log prices
    [pilot, n] and its fit as the reference reads fits."""

    pilot_ls: torch.Tensor
    fit: ref.Fit
    program_fit: object


def program_state(pricer, seed: int) -> State:
    """Recompute request ``seed``'s pilot and fit through the program
    (``program_fit`` as the program streams under it)."""
    pilot = pricer.pilot(seed)
    raw = pricer.fit(seed)
    fits = getattr(raw, "fits", raw)               # a CVFit's policy

    def f64(t, dims):
        t = t.detach().to(torch.float64)
        return t if t.dim() == dims else t[None]

    return State(torch.log(pilot[:, 1:].to(torch.float64)),
                 ref.Fit(f64(fits.coeffs, 3), f64(fits.mu, 2),
                         f64(fits.sd, 2)), raw)


def replay_gap(pricer, state: State, done) -> float:
    """Widest gap between the answer ``done`` and the program's answer to
    the same request streamed under the recomputed fit."""
    prices, stderrs = pricer.price_with_fit(state.program_fit, done.seed)
    return float(max(np.max(np.abs(prices - done.prices)),
                     np.max(np.abs(stderrs - done.stderrs))))


@dataclass
class Reference:
    """The reference's pilot, its fit on the program's pilot, its answer
    under the program's fit and, as a witness, its answer under its own
    fit on its own pilot."""

    pilot_ls: torch.Tensor
    fit: ref.Fit
    quote: ref.Quote
    witness: ref.Quote | None = None


def reference(config: dict, req, seed: int, state: State, device,
              dtype=torch.float64, tf32: bool = False,
              witness: bool = False) -> Reference:
    """The reference's side of request ``seed``: its own pilot, the LSM
    fit it works out from the program's pilot (``state.pilot_ls``), and
    its answer under the program's fit ``state.fit`` (the control
    variate's beta its own, from its pilot under that fit).  With
    ``witness``, also its answer from the seed alone: its own fit on its
    own pilot, streamed on the same paths."""
    lw = law(config, device, dtype, tf32)
    c, s = config["contract"], config["stream"]
    is_call = bool(c["is_call"])
    strikes = torch.as_tensor(req.strikes, dtype=dtype, device=lw.device)
    with lw.matmuls():
        own = ref.lsm_fit(ref.with_s0(lw, state.pilot_ls.to(dtype)), strikes,
                          lw.r, lw.dt, is_call)
    fit = ref.Fit(*(t.to(dtype) for t in (state.fit.coeffs, state.fit.mu,
                                          state.fit.sd)))
    ls = ref.pilot_log_paths(lw, seed, int(s["pilot_paths"]))
    pilot = ref.with_s0(lw, ls)
    fits = [fit]
    if witness:
        with lw.matmuls():
            fits.append(ref.lsm_fit(pilot, strikes, lw.r, lw.dt, is_call))
    policies = [(f, ref.control_beta(lw, pilot, f, strikes, is_call)
                 if req.control_variate else None) for f in fits]
    quotes = ref.stream_policies(lw, policies, strikes, is_call, seed,
                                 req.n_chunks, int(s["chunk_paths"]),
                                 req.antithetic)
    return Reference(ls, own, quotes[0], quotes[1] if witness else None)


# Steps whose regression the fit gap reads: those with at least this many
# pilot paths in the money.  Below it a 3x3 normal system in float32 is
# near singular, and a step that few paths reach decides few stream paths.
FIT_MIN_PATHS = 1000


def fit_gap(fit: ref.Fit, own: ref.Fit, strikes) -> float:
    """Widest gap of the two fits' continuation at the reference's
    regressor mean and one sd either side, at steps 1..n-1 (those a chunk
    path decides at) with FIT_MIN_PATHS in the money or more, each strike,
    over the strike."""
    k = torch.as_tensor(strikes, dtype=torch.float64,
                        device=own.mu.device)[:, None]
    read = own.count[:, 1:] >= FIT_MIN_PATHS
    gap = 0.0
    for z in (-1.0, 0.0, 1.0):
        s = own.mu[:, 1:] + z * own.sd[:, 1:]

        def cont(f):
            c = f.coeffs[:, 1:]
            u = (s - f.mu[:, 1:]) / f.sd[:, 1:]
            return (c[..., 2] * u + c[..., 1]) * u + c[..., 0]

        d = torch.where(read, torch.abs(cont(fit) - cont(own)) / k, 0.0)
        gap = max(gap, float(d.max()))
    return gap


def price_gap_se(prices: np.ndarray, stderrs: np.ndarray,
                 quote: ref.Quote) -> float:
    """Widest gap between an answer's price and the reference's over the
    strikes, in units of the reference's stderr; exact (0 or infinite)
    where that stderr is 0 (time-0 exercise: every path shares S0)."""
    if not (np.all(np.isfinite(prices)) and np.all(np.isfinite(stderrs))):
        return math.inf
    gap = 0.0
    for p, s, rp, rs in zip(prices, stderrs, quote.price, quote.stderr):
        if rs == 0.0:
            if p != rp or s != 0.0:
                return math.inf
        else:
            gap = max(gap, abs(p - rp) / rs)
    return gap


def stderr_gap(stderrs: np.ndarray, quote: ref.Quote) -> float:
    """Widest gap between an answer's stderr and the reference's over the
    strikes, as a share of the reference's; exact (0 or infinite) where
    that is 0."""
    if not np.all(np.isfinite(stderrs)):
        return math.inf
    gap = 0.0
    for s, rs in zip(stderrs, quote.stderr):
        if rs == 0.0:
            if s != 0.0:
                return math.inf
        else:
            gap = max(gap, abs(s - rs) / rs)
    return gap


def numbers(prices, stderrs, state: State, refd: Reference, strikes,
            witness: ref.Quote | None = None) -> dict:
    """Every compared number of one answer but ``replay_gap``; the
    witness is ``refd``'s unless given."""
    out = {"pilot_gap": float(torch.max(torch.abs(
               state.pilot_ls - refd.pilot_ls))),
           "fit_gap": fit_gap(state.fit, refd.fit, strikes),
           "price_gap_se": price_gap_se(prices, stderrs, refd.quote),
           "stderr_gap": stderr_gap(stderrs, refd.quote)}
    witness = refd.witness if witness is None else witness
    if witness is not None:
        out["witness_gap_se"] = price_gap_se(prices, stderrs, witness)
    return out


def judge(found: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, checks): every number at or below its limit; ``checks``
    maps each number's short name to its value and limit."""
    checks = {name: {"value": float(found[name]),
                     "limit": float(limits[name]["limit"])}
              for name in limits}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks


def nonfinite(done: list) -> int:
    """Answers of the window with a price or stderr that is not finite."""
    return sum(int(not (np.all(np.isfinite(d.prices))
                        and np.all(np.isfinite(d.stderrs)))) for d in done)
