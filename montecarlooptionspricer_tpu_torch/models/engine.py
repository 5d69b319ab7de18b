"""Fit-then-stream LSM pricing engine (counterpart:
``montecarlooptionspricer_tpu/models/engine.py``, the single-device
``StreamingPricer.price`` path with the fused kernels).

  pilot:  K1 (``pathgen_cuda.pathgen``) generates a pilot block, and the
          LSM backward induction (``lsm.lsm_fit``) fits one exercise
          policy per step;
  tables: each step's quadratic decision becomes a log-space exercise
          interval (``boundary_rows`` -> ``log_boundary_rows``); time-0
          exercise is decided on the host side;
  stream: K2 (``pathgen_cuda.priced_chunk``) regenerates each chunk's
          paths on chip from its own random stream and returns the
          chunk's payoff sum; chunk totals and their squares give the
          price and its stderr.

Only this path is ported.  Other configurations raise
``NotImplementedError`` naming their ROADMAP item; nothing runs another
path silently.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from ..ops.payoff import payoff
from ..ops.regression import PolyFit, eval_poly, polyfit_from_numpy  # noqa: F401
from ..ops.timegrid import step_mask
from . import pathgen_cuda
from .lsm import ITM_EPS, lsm_fit

PILOT_STREAM = 3 << 28     # stream index of the pilot, past every chunk


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """The fields the ported path reads.  ``block_paths`` is the CUDA
    path block (0 = the largest the card admits at this horizon, see
    ``pathgen_cuda.max_block_paths``)."""

    n_paths: int
    n_steps: int
    chunk_paths: int = 1 << 16
    pilot_paths: int = 1 << 14
    dt: float = 1.0 / 252.0
    poly_order: int = 2
    chunks_per_call: int = 16
    block_paths: int = 0
    fgn_form: str = "auto"
    policy_form: str = "boundary"

    def __post_init__(self):
        if self.fgn_form not in ("auto", "chol"):
            raise NotImplementedError(
                f"fgn_form={self.fgn_form!r}: only the Cholesky form is "
                "ported (spectral: ROADMAP B1/B2 remaining forms)")
        if self.policy_form != "boundary":
            raise NotImplementedError(
                f"policy_form={self.policy_form!r}: only the log-boundary "
                "policy is ported (quadratic: ROADMAP B1 remaining forms)")
        if self.poly_order != 2:
            raise NotImplementedError(
                "the fused kernels read quadratic fits; other poly_order "
                "values need the generic path stream (ROADMAP A3)")
        if not pathgen_cuda.supports(self.n_steps):
            raise NotImplementedError(
                f"n_steps={self.n_steps} exceeds the single-tile kernels "
                "(ROADMAP A8: long horizon)")
        if self.chunks_per_call < 1:
            raise ValueError("chunks_per_call must be >= 1")


# ---------------------------------------------------------------------------
# Host float64 constants (numpy copies of the reference's builders).

def _fgn_matrices_np(n_steps: int, h: float, eta: float, dt: float) -> tuple:
    """Spectral fGN matrices (Cr, Ci) in float64."""
    t = np.arange(n_steps + 1, dtype=np.float64) * dt
    lam = 0.5 * t ** (2.0 * h)
    m1 = 1
    while m1 < lam.size:
        m1 <<= 1
    phi = np.conj(np.fft.fft(lam, n=m1))
    m2 = 1
    while m2 < n_steps:
        m2 <<= 1
    k = np.arange(n_steps)[:, None].astype(np.float64)
    m = np.arange(n_steps)[None, :].astype(np.float64)
    c = phi[:n_steps, None] * np.exp(-2j * np.pi * k * m / m2)
    scale = np.sqrt(2.0 * h) * eta / m2
    return np.real(c) * scale, np.imag(c) * scale


def _chol_np(n_steps: int, h: float, eta: float, dt: float) -> np.ndarray:
    """Lower-triangular float64 Cholesky factor of the spectral fGN
    covariance Cr^T Cr + Ci^T Ci, with an escalating diagonal jitter for
    roundoff-level rank deficiency."""
    cr, ci = _fgn_matrices_np(n_steps, h, eta, dt)
    cov = cr.T @ cr + ci.T @ ci
    scale = float(np.max(np.diag(cov))) or 1.0
    for jitter in (0.0, 1e-14, 1e-10, 1e-6):
        try:
            return np.linalg.cholesky(cov + jitter * scale *
                                      np.eye(n_steps))
        except np.linalg.LinAlgError:
            continue
    raise np.linalg.LinAlgError(
        f"fGN covariance not PSD at n={n_steps}, h={h}")


@functools.lru_cache(maxsize=64)
def _chol_matrix_host(n_steps: int, h: float, eta: float,
                      dt: float) -> np.ndarray:
    """Upper-triangular float64 Lt = L^T, so X = N @ Lt has the spectral
    map's law from one noise plane.  Cached and read-only."""
    lt = np.ascontiguousarray(_chol_np(n_steps, h, eta, dt).T)
    lt.setflags(write=False)
    return lt


# ---------------------------------------------------------------------------
# Seeds, ranges, stderr.

def _seed_run_word(seed: int) -> int:
    """31-bit run word from an integer seed (splitmix64 finalizer)."""
    m64 = (1 << 64) - 1
    z = (int(seed) + 0x9E3779B97F4A7C15) & m64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & m64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & m64
    z ^= z >> 31
    return z % (2 ** 31 - 1)


def _pilot_stream_keys(seed: int):
    """(pilot, stream) carriers, each a (run_word, stream_index) pair: the
    pilot's index 3 << 28 lies past every chunk index, so pilot and stream
    noise never coincide (no foresight bias)."""
    run = _seed_run_word(seed)
    return (run, PILOT_STREAM), (run, 0)


def _check_pallas_chunk_range(n_chunks: int) -> None:
    """Keep the stream index inside the seed scheme's int32 ranges:
    fewer than 2^20 chunks, below the pilot marker."""
    if n_chunks >= 1 << 20:
        raise ValueError(f"{n_chunks} chunks exceeds the seed scheme's "
                         "2^20 range; raise chunk_paths")


def _chunk_stderr(totals, sumsq, m: int, per_chunk: int,
                  center: float = 0.0):
    """Stderr of the per-path streamed mean from the sum of m iid chunk
    totals and the sum of their squares.  NaN for a single chunk (no
    variance information, never a false 0)."""
    totals = np.asarray(totals, np.float64)
    sumsq = np.asarray(sumsq, np.float64)
    if m < 2:
        return np.full_like(totals, np.nan)
    mean_c = totals / m - center
    var_c = np.maximum(sumsq / m - mean_c ** 2, 0.0) * (m / (m - 1.0))
    return np.sqrt(var_c / m) / per_chunk


def _fused_rows_builder(r, strike, maturity, dt, n_steps: int,
                        is_call: bool):
    """fits -> the log-space boundary table K2 reads."""
    def make_rows(fits):
        tab = pathgen_cuda.boundary_rows(fits, r, strike, maturity, dt,
                                         n_steps, is_call)
        return pathgen_cuda.log_boundary_rows(tab).contiguous()
    return make_rows


# ---------------------------------------------------------------------------
# Policy evaluation on whole paths (the test oracle of the fused kernel).

def lsm_policy_path_values(paths, fits: PolyFit, r, strike, maturity, dt,
                           is_call: bool) -> torch.Tensor:
    """[n] discounted payoff of each path under the fitted policy: the
    first step j < n_steps that is in the money with payoff >= the fitted
    continuation, else the terminal payoff."""
    n, m = paths.shape
    t = torch.arange(m, dtype=paths.dtype, device=paths.device) * dt
    p = payoff(is_call, paths, strike)
    cont = eval_poly(fits, paths[:, : m - 1])
    live = step_mask(m - 1, dt, maturity, device=paths.device)[None, :]
    exercise = (p[:, : m - 1] > ITM_EPS) & (p[:, : m - 1] >= cont) & live
    exercise = torch.cat([exercise, torch.ones((n, 1), dtype=torch.bool,
                                               device=paths.device)], dim=1)
    stop = exercise.to(torch.int8).argmax(dim=1)
    disc = torch.exp(-r * t)
    return (p * disc[None, :]).gather(1, stop[:, None])[:, 0]


def lsm_policy_value(paths, fits: PolyFit, r, strike, maturity, dt,
                     is_call: bool):
    """(sum of lsm_policy_path_values, path count)."""
    value = lsm_policy_path_values(paths, fits, r, strike, maturity, dt,
                                   is_call)
    return torch.sum(value), paths.shape[0]


# ---------------------------------------------------------------------------

class StreamingPricer:
    """Fit-then-stream pricer of one American option under rough Bergomi.

    Runs on ``device`` ("cuda" unless the caller asks for "cpu"); on the
    CPU the kernels' plain versions run in their place."""

    def __init__(self, s0, xi, h, eta, rho, r, strike, maturity,
                 is_call: bool, config: StreamConfig, device="cuda"):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run "
                               "the plain versions")
        if device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {device}")
        if config.chunk_paths % 16 or config.pilot_paths % 16:
            raise ValueError("chunk_paths and pilot_paths must divide by 16")
        del rho  # the price Brownian is drawn independent of the fGN driver
        self.config = config
        self.device = device
        self.s0, self.r = float(s0), float(r)
        self.strike, self.maturity = float(strike), float(maturity)
        self.is_call = bool(is_call)
        block = config.block_paths or pathgen_cuda.max_block_paths(
            config.n_steps)
        while config.chunk_paths % block or config.pilot_paths % block:
            block //= 2
        self.consts = pathgen_cuda.make_path_consts(
            s0, xi, h, eta, r, config.n_steps, config.dt, device,
            block_paths=block)
        self._make_rows = _fused_rows_builder(
            self.r, self.strike, self.maturity, config.dt, config.n_steps,
            self.is_call)

    def fit(self, carrier) -> PolyFit:
        """Pilot block from the (run_word, stream_index) ``carrier``
        through K1, then the LSM policy fit."""
        pilot = pathgen_cuda.pathgen(
            self.consts, rows=self.config.pilot_paths,
            key=pathgen_cuda._fold_words(*carrier))
        _, fits = lsm_fit(pilot, self.r, self.strike, self.maturity,
                          self.config.dt, self.is_call,
                          self.config.poly_order)
        return fits

    def price(self, seed: int, n_paths: Optional[int] = None,
              with_stderr: bool = False):
        """Price on ``n_paths`` (default ``config.n_paths``) fresh paths
        from the integer ``seed``; ``with_stderr`` returns (price, stderr)
        with the stderr of the iid chunk totals, conditional on the
        pilot's fitted policy."""
        k_pilot, _ = _pilot_stream_keys(seed)
        n_paths = self._n_paths(n_paths)
        return self.price_with_fit(self.fit(k_pilot), seed, n_paths,
                                   with_stderr)

    def price_with_fit(self, fits: PolyFit, seed: int = 0,
                       n_paths: Optional[int] = None,
                       with_stderr: bool = False,
                       noise: Optional[torch.Tensor] = None):
        """Stream against a given policy ``fits`` (e.g. one made elsewhere
        and converted with ``polyfit_from_numpy``).  With ``noise``
        [n_chunks, 2, chunk_paths, n_steps] the chunks read that noise
        instead of the seeded stream."""
        config = self.config
        chunk = config.chunk_paths
        if noise is not None:
            n_paths = noise.shape[0] * chunk
        n_paths = self._n_paths(n_paths)
        n_chunks = n_paths // chunk
        _, (run, start) = _pilot_stream_keys(seed)
        table = self._make_rows(fits)
        ex0, p0 = pathgen_cuda.time0_value(fits, self.s0, self.strike,
                                           self.is_call)
        p0_t = torch.tensor(p0, dtype=torch.float32, device=self.device)

        # Float32 accumulation on the device per group of chunks_per_call
        # chunks (no sync inside a group), float64 across groups.
        total = sq = 0.0
        done = 0
        while done < n_chunks:
            count = min(config.chunks_per_call, n_chunks - done)
            tot_g = torch.zeros((), dtype=torch.float32, device=self.device)
            sq_g = torch.zeros_like(tot_g)
            for i in range(done, done + count):
                if noise is None:
                    kw = {"rows": chunk, "key": pathgen_cuda._fold_words(
                        run, start + i)}
                else:
                    kw = {"noise": noise[i]}
                c = pathgen_cuda.priced_chunk(self.consts, table,
                                              self.strike, self.is_call,
                                              **kw)
                tot_g = tot_g + c
                sq_g = sq_g + c * c
            # Time-0 exercise: every path shares S0, so the run collapses
            # to the immediate payoff and every chunk total is the same.
            all0 = p0_t * float(count * chunk)
            c0 = p0_t * float(chunk)
            sq0 = float(count) * c0 * c0
            total += float(torch.where(ex0, all0, tot_g))
            sq += float(torch.where(ex0, sq0, sq_g))
            done += count
        if not with_stderr:
            return total / n_paths
        return (total / n_paths,
                float(_chunk_stderr(total, sq, n_chunks, chunk)))

    def _n_paths(self, n_paths: Optional[int]) -> int:
        if n_paths is None:
            n_paths = self.config.n_paths
        n_chunks, rem = divmod(n_paths, self.config.chunk_paths)
        if rem or n_chunks < 1:
            raise ValueError(f"n_paths={n_paths} is not a positive multiple "
                             f"of chunk_paths={self.config.chunk_paths}")
        _check_pallas_chunk_range(n_chunks)
        return n_paths
