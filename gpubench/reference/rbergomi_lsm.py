"""Plain reference of a priced quote: rough-Bergomi paths, the LSM fit on
a pilot block and the price of fresh chunks under the fitted policy.

Written from the model's and the algorithm's definitions in plain PyTorch
and NumPy; it imports nothing of the program under test and takes nothing
it made.  From the seed and the configuration it works out again every
quantity the program derives: the fGN covariance and its Cholesky factor,
the counter-based Philox4x32-10 stream with its Box-Muller normals, the
pilot's paths, the regression of each step, and every chunk's paths,
decisions and sums.

The law (the upstream project's discretization, ``RoughVolatility.cpp``):
over steps j = 0..n-1 of length dt, the log-variance driver is X = N @ L^T
with N iid normal and L the Cholesky factor of C = Cr^T Cr + Ci^T Ci, where
Cr + i Ci is the spectral map of lambda_k = 0.5 (k dt)^{2H} (its FFT on the
next power of two above n + 1, each of the first n modes spread over the
next power of two at or above n, scaled by sqrt(2H) eta / m2).  The spot
variance is v_j = xi exp(X_j - 0.5 eta^2 (j dt)^{2H}), the log price takes
(r - v_j / 2) dt + sqrt(v_j dt) W_j with W iid normal and independent of N
(so the correlation rho of the published model changes no number).

The random stream: a chunk's key word is a fold of (run word, stream
index); path p's step pair k draws Philox4x32-10 at counter (p, k, 0, 0),
key (word, 0), and each pair of words (x0, x1), (x2, x3) gives one
Box-Muller pair, N = radius cos, W = radius sin, from u = (bits >> 8)
2^-24 + 2^-25.  Pairs (antithetic) draw half the rows and take (N, W) and
(-N, -W).

The fit (Longstaff-Schwartz in the carried-value form): backward from the
terminal payoff, each step discounts the carried values and, on the paths
in the money, regresses them on 1, z, z^2 with z the regressor
standardized over those paths (a ridge of 1e-6 of each diagonal entry
plus 1e-6), and carries max(payoff, fitted continuation) on them.  The
configurations state the boundary policy: at each step the set where the
payoff is at least the fitted continuation, cut to one interval (a put's
lower piece, a call's upper one; ``exercise_interval``), and a chunk path
stops at its first step in the money inside it (the terminal step
exercises in the money), worth the discounted payoff.  The control
variate's beta is fitted on the pilot's values under the fitted quadratic
itself, as the program fits it.

Everything runs in ``dtype`` (float64 for the reference); ``tf32`` runs
the fGN product on the tensor cores' TF32, the control's precision.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass

import numpy as np
import torch

U32 = 0xFFFFFFFF
PILOT_STREAM = 3 << 28
ITM_EPS = 1e-14
RIDGE = 1e-6
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)


# ---------------------------------------------------------------------------
# Seeds and the counter-based stream.

def run_word(seed: int) -> int:
    """31-bit run word of an integer seed (the splitmix64 finalizer)."""
    m64 = (1 << 64) - 1
    z = (int(seed) + 0x9E3779B97F4A7C15) & m64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & m64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & m64
    z ^= z >> 31
    return z % (2 ** 31 - 1)


def key_word(run: int, index: int) -> int:
    """The uint32 key word of stream ``index`` under ``run``."""
    h = ((run * 0x9E3779B1) & U32) ^ (index & U32)
    h = (h * 0x85EBCA77) & U32
    return h ^ (h >> 13)


def _mulhilo(a: torch.Tensor, m: int):
    """(hi, lo) 32-bit words of a * m for uint32 words held in int64.  The
    int64 product wraps modulo 2^64 (two's complement), which keeps both
    words; ``check_wrap`` confirms that on the device before use."""
    prod = a * m
    return (prod >> 32) & U32, prod & U32


def check_wrap(device) -> None:
    """Raise unless the device's int64 multiply wraps as ``_mulhilo``
    needs."""
    a = torch.tensor([U32, 0x80000001, 0xDEADBEEF], dtype=torch.int64,
                     device=device)
    for m in PHILOX_M:
        hi, lo = _mulhilo(a, m)
        want = [divmod(int(x) * m, 1 << 32) for x in a.tolist()]
        if [tuple(v) for v in zip(hi.tolist(), lo.tolist())] != want:
            raise RuntimeError(f"int64 multiply does not wrap on {device}")


def philox(c0, c1, c2, c3, k0, k1: int = 0):
    """Philox4x32-10 on int64 tensors of uint32 words; ``k0`` an int or a
    tensor that broadcasts (one key word per chunk)."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + PHILOX_W[0]) & U32
        k1 = (k1 + PHILOX_W[1]) & U32
    return c0, c1, c2, c3


def _uniform(bits: torch.Tensor, dtype) -> torch.Tensor:
    return (bits >> 8).to(dtype) * 2.0 ** -24 + 2.0 ** -25


def _box_muller(ba, bb, dtype):
    rad = torch.sqrt(-2.0 * torch.log(_uniform(ba, dtype)))
    ang = (2.0 * math.pi) * _uniform(bb, dtype)
    return rad * torch.cos(ang), rad * torch.sin(ang)


def normals(keys, rows: int, n_steps: int, device, dtype):
    """(N, W), each [len(keys), rows, n_steps], of the chunks whose key
    words are ``keys``."""
    pairs = (n_steps + 1) // 2
    k0 = torch.tensor([int(k) for k in keys], dtype=torch.int64,
                      device=device)[:, None, None]
    p = torch.arange(rows, dtype=torch.int64, device=device)[None, :, None]
    j = torch.arange(pairs, dtype=torch.int64, device=device)[None, None, :]
    shape = (len(keys), rows, pairs)
    p, j = p.expand(shape), j.expand(shape)
    zero = torch.zeros(shape, dtype=torch.int64, device=device)
    x0, x1, x2, x3 = philox(p, j, zero, zero, k0)
    del p, j, zero
    n0, w0 = _box_muller(x0, x1, dtype)
    del x0, x1
    n1, w1 = _box_muller(x2, x3, dtype)
    del x2, x3
    n = torch.stack([n0, n1], -1).reshape(len(keys), rows, 2 * pairs)
    w = torch.stack([w0, w1], -1).reshape(len(keys), rows, 2 * pairs)
    return n[..., :n_steps], w[..., :n_steps]


# ---------------------------------------------------------------------------
# The law's constants.

def fgn_factor(n_steps: int, h: float, eta: float, dt: float) -> np.ndarray:
    """Upper-triangular float64 L^T of the fGN covariance (module
    docstring), with a diagonal jitter only where the factorization of the
    exact matrix fails."""
    t = np.arange(n_steps + 1, dtype=np.float64) * dt
    lam = 0.5 * t ** (2.0 * h)
    m1 = 1 << (lam.size - 1).bit_length()
    phi = np.conj(np.fft.fft(lam, n=m1))
    m2 = 1 << (n_steps - 1).bit_length()
    k = np.arange(n_steps, dtype=np.float64)[:, None]
    mm = np.arange(n_steps, dtype=np.float64)[None, :]
    c = phi[:n_steps, None] * np.exp(-2j * np.pi * k * mm / m2)
    c *= math.sqrt(2.0 * h) * eta / m2
    cov = c.real.T @ c.real + c.imag.T @ c.imag
    scale = float(np.max(np.diag(cov))) or 1.0
    for jitter in (0.0, 1e-14, 1e-10, 1e-6):
        try:
            chol = np.linalg.cholesky(cov + jitter * scale * np.eye(n_steps))
            return np.ascontiguousarray(chol.T)
        except np.linalg.LinAlgError:
            continue
    raise np.linalg.LinAlgError(f"fGN covariance not PSD at n={n_steps}")


@dataclass
class Law:
    """The market and the grid, with the law's constants on ``device``."""

    s0: float
    xi: float
    h: float
    eta: float
    r: float
    n_steps: int
    dt: float
    device: torch.device
    dtype: torch.dtype = torch.float64
    tf32: bool = False

    def __post_init__(self):
        check_wrap(self.device)
        self.lt = torch.tensor(fgn_factor(self.n_steps, self.h, self.eta,
                                          self.dt), dtype=self.dtype,
                               device=self.device)
        t = np.arange(self.n_steps, dtype=np.float64) * self.dt
        drift = math.log(self.xi) - 0.5 * self.eta ** 2 * t ** (2.0 * self.h)
        self.log_drift = torch.tensor(drift, dtype=self.dtype,
                                      device=self.device)

    @contextlib.contextmanager
    def matmuls(self):
        """Matrix products in this law's precision: TF32 under ``tf32``,
        else the dtype's own."""
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev

    def log_paths(self, n: torch.Tensor, w: torch.Tensor,
                  antithetic: bool = False) -> torch.Tensor:
        """[..., rows, n_steps] log prices at steps 1..n from normals [...,
        rows, n_steps]; ``antithetic`` appends the (-N, -W) partners."""
        with self.matmuls():
            x = n @ self.lt
        if antithetic:
            x, w = torch.cat([x, -x], -2), torch.cat([w, -w], -2)
        v = torch.exp(x + self.log_drift)
        inc = (self.r - 0.5 * v) * self.dt + torch.sqrt(v * self.dt) * w
        return math.log(self.s0) + torch.cumsum(inc, -1)


# ---------------------------------------------------------------------------
# The fit.

@dataclass
class Fit:
    """Per step j = 0..n-1 (column j of the paths, S0 at j = 0) and strike:
    coefficients [K, n, 3] in z = (S - mu) / sd, mu and sd [K, n]."""

    coeffs: torch.Tensor
    mu: torch.Tensor
    sd: torch.Tensor
    count: torch.Tensor | None = None   # [K, n] paths in the money (fit)

    def continuation(self, s: torch.Tensor, j) -> torch.Tensor:
        """Fitted continuation at step(s) ``j`` of prices ``s``
        [K, rows, ...] (``j`` an int or a slice matching s's last axis)."""
        c = self.coeffs[:, j]
        mu, sd = self.mu[:, j], self.sd[:, j]
        if isinstance(j, int):
            z = (s - mu[:, None]) / sd[:, None]
            return (c[:, None, 2] * z + c[:, None, 1]) * z + c[:, None, 0]
        z = (s - mu[:, None, :]) / sd[:, None, :]
        return ((c[:, None, :, 2] * z + c[:, None, :, 1]) * z
                + c[:, None, :, 0])


def payoff(s, strikes, is_call: bool):
    """max(0, +-(s - K)) with ``strikes`` [K] against s [K, ...] or s
    broadcast over a leading strike axis."""
    k = strikes.reshape((-1,) + (1,) * (s.dim() - 1)) if s.dim() else strikes
    return torch.clamp_min(s - k if is_call else k - s, 0.0)


def _regress(x, y, w):
    """Weighted quadratic least squares of y on x over [K, rows] with 0/1
    weights w: (coeffs [K, 3], mu [K], sd [K]) in the standardized z."""
    wsum = w.sum(-1)
    safe = torch.clamp_min(wsum, 1.0)
    mu = (w * x).sum(-1) / safe
    var = (w * (x - mu[:, None]) ** 2).sum(-1) / safe
    floor = 1e-6 * (torch.abs(mu) + 1.0)
    sd = torch.sqrt(torch.maximum(var, floor * floor))
    z = (x - mu[:, None]) / sd[:, None]
    z = torch.where((var > floor * floor)[:, None], z, torch.zeros_like(z))
    basis = torch.stack([torch.ones_like(z), z, z * z], -1)   # [K, rows, 3]
    wb = basis * w[..., None]
    gram = torch.einsum("krp,krq->kpq", wb, basis)
    rhs = torch.einsum("krp,kr->kp", wb, y)
    diag = RIDGE * (torch.diagonal(gram, dim1=-2, dim2=-1) + 1.0)
    a = gram + torch.diag_embed(diag)
    coeffs = torch.linalg.solve(a, rhs[..., None])[..., 0]
    dead = torch.zeros_like(coeffs)
    dead[:, 0] = 1e30
    return torch.where((wsum > 0)[:, None], coeffs, dead), mu, sd


def lsm_fit(s: torch.Tensor, strikes: torch.Tensor, r: float, dt: float,
            is_call: bool) -> Fit:
    """The LSM fit on pilot prices ``s`` [rows, n + 1] (S0 in column 0) for
    each strike of ``strikes`` [K], every step of the horizon live."""
    rows, m = s.shape
    kk = strikes.numel()
    disc = math.exp(-r * dt)
    v = payoff(s[:, -1].expand(kk, rows), strikes, is_call)
    coeffs = torch.zeros((kk, m - 1, 3), dtype=s.dtype, device=s.device)
    mu = torch.zeros((kk, m - 1), dtype=s.dtype, device=s.device)
    sd = torch.ones((kk, m - 1), dtype=s.dtype, device=s.device)
    count = torch.zeros((kk, m - 1), dtype=s.dtype, device=s.device)
    for j in range(m - 2, -1, -1):
        v = v * disc
        x = s[:, j].expand(kk, rows)
        p = payoff(x, strikes, is_call)
        itm = (p > ITM_EPS).to(s.dtype)
        count[:, j] = itm.sum(-1)
        c, mu[:, j], sd[:, j] = _regress(x, v, itm)
        coeffs[:, j] = c
        z = (x - mu[:, j, None]) / sd[:, j, None]
        cont = (c[:, None, 2] * z + c[:, None, 1]) * z + c[:, None, 0]
        v = torch.where(itm > 0, torch.maximum(p, cont), v)
    return Fit(coeffs, mu, sd, count)


# ---------------------------------------------------------------------------
# Pricing.

BIG = 1e30


def exercise_interval(fit: Fit, strikes: torch.Tensor, is_call: bool):
    """(lo, hi), each [K, n]: the exercise interval of the boundary policy
    at each step.  The set where the payoff is at least the fitted
    continuation, a quadratic inequality in z, may have two pieces; the
    policy keeps one, a put's lower and a call's upper, cut to the strikes
    in the money ((-inf, K) for a put, (K, inf) for a call).  An empty
    interval is [BIG, -BIG]."""
    k = strikes[:, None].to(fit.mu.dtype)
    c0, c1, c2 = fit.coeffs.unbind(-1)
    mu, sd = fit.mu, fit.sd
    if is_call:
        a, b, c = -c2, sd - c1, mu - k - c0
    else:
        a, b, c = -c2, -(sd + c1), k - mu - c0
    lin = torch.abs(a) <= 1e-25
    disc = b * b - 4.0 * a * c
    no_root = disc < 0
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    safe_a = torch.where(lin, torch.ones_like(a), a)
    r1, r2 = (-b - sq) / (2.0 * safe_a), (-b + sq) / (2.0 * safe_a)
    rlo, rhi = torch.minimum(r1, r2), torch.maximum(r1, r2)
    pos, neg = torch.full_like(a, BIG), torch.full_like(a, -BIG)
    b_zero = torch.abs(b) <= 1e-30
    s_lin = -c / torch.where(b_zero, torch.ones_like(b), b)
    lin_lo = torch.where(b_zero, torch.where(c >= 0, neg, pos),
                         torch.where(b > 0, s_lin, neg))
    lin_hi = torch.where(b_zero, torch.where(c >= 0, pos, neg),
                         torch.where(b > 0, pos, s_lin))
    if is_call:
        q_lo = torch.where(a < 0, torch.where(no_root, pos, rlo),
                           torch.where(no_root, neg, rhi))
        q_hi = torch.where(a < 0, torch.where(no_root, neg, rhi), pos)
    else:
        q_lo = torch.where(a < 0, torch.where(no_root, pos, rlo), neg)
        q_hi = torch.where(a < 0, torch.where(no_root, neg, rhi),
                           torch.where(no_root, pos, rlo))
    zlo = torch.where(lin, lin_lo, q_lo)
    zhi = torch.where(lin, lin_hi, q_hi)
    lo = torch.where(torch.abs(zlo) >= BIG, zlo, mu + sd * zlo)
    hi = torch.where(torch.abs(zhi) >= BIG, zhi, mu + sd * zhi)
    return lo, hi


def stopped_values(ls: torch.Tensor, fit: Fit, strikes: torch.Tensor,
                   r: float, dt: float, is_call: bool,
                   interval=None) -> torch.Tensor:
    """[K, rows] discounted payoff of each path of log prices ``ls`` [rows,
    n] (steps 1..n) stopped at its first step in the money and inside the
    exercise interval (``exercise_interval``; the terminal step exercises
    in the money), 0 where none."""
    rows, n = ls.shape
    lo, hi = interval if interval is not None else exercise_interval(
        fit, strikes, is_call)
    s = torch.exp(ls)[None]                              # [1, rows, n]
    p = payoff(s, strikes, is_call)                      # [K, rows, n]
    inside = (s[..., :-1] >= lo[:, None, 1:n]) \
        & (s[..., :-1] <= hi[:, None, 1:n])              # steps 1..n-1
    ex = torch.cat([(p[..., :-1] > ITM_EPS) & inside,
                    p[..., -1:] > ITM_EPS], -1)
    first = ex.to(torch.int8).argmax(-1)                 # [K, rows]
    disc = torch.exp(-r * dt * torch.arange(1, n + 1, dtype=ls.dtype,
                                            device=ls.device))
    val = (p * disc).gather(-1, first[..., None])[..., 0]
    return torch.where(ex.any(-1), val, torch.zeros_like(val))


@dataclass
class Quote:
    """What a priced request answers, per strike, with the chunk totals
    [chunks, K] its stderr came from (``raw_totals``: before the control
    variate's correction, where there is one)."""

    price: np.ndarray
    stderr: np.ndarray
    totals: np.ndarray | None = None
    raw_totals: np.ndarray | None = None


def pilot_log_paths(law: Law, seed: int, pilot: int) -> torch.Tensor:
    """[pilot, n] log prices at steps 1..n of the pilot block of ``seed``."""
    n, w = normals([key_word(run_word(seed), PILOT_STREAM)], pilot,
                   law.n_steps, law.device, law.dtype)
    return law.log_paths(n, w)[0]


def with_s0(law: Law, ls: torch.Tensor) -> torch.Tensor:
    """[rows, n + 1] prices, S0 in column 0, from log prices [rows, n]."""
    s0 = torch.full((ls.shape[0], 1), law.s0, dtype=ls.dtype,
                    device=ls.device)
    return torch.cat([s0, torch.exp(ls)], 1)


def control_beta(law: Law, s: torch.Tensor, fit: Fit, strikes,
                 is_call: bool) -> float:
    """The control variate's beta on pilot prices ``s`` [rows, n + 1] under
    ``fit``: the centred cross moment of each path's policy value (time 0
    a decision column too, the terminal payoff where none exercises) and
    its control e^{-rT} S_T, over the control's centred second moment."""
    p = payoff(s[None], strikes, is_call)
    cont = fit.continuation(s[None, :, :-1], slice(0, law.n_steps))
    ex = torch.cat([(p[..., :-1] > ITM_EPS) & (p[..., :-1] >= cont),
                    torch.ones_like(p[..., -1:], dtype=torch.bool)], -1)
    first = ex.to(torch.int8).argmax(-1)
    disc = torch.exp(-law.r * law.dt * torch.arange(
        law.n_steps + 1, dtype=s.dtype, device=s.device))
    av = (p * disc).gather(-1, first[..., None])[0, :, 0]
    ctl = math.exp(-law.r * law.n_steps * law.dt) * s[:, -1]
    avc, ctc = av - av.mean(), ctl - ctl.mean()
    return float((avc * ctc).sum() / torch.clamp_min((ctc * ctc).sum(),
                                                     1e-12))


def stream(law: Law, fit: Fit, strikes, is_call: bool, seed: int,
           n_chunks: int, chunk: int, antithetic: bool = False,
           beta: float | None = None, batch: int = 4) -> Quote:
    """Per-strike prices and chunk-total stderrs of ``n_chunks`` fresh
    chunks of ``seed`` under ``fit``; with ``beta`` (one strike) each chunk
    total is corrected by beta (e^{-rT} sum S_T - chunk s0).  Time-0
    exercise (every path shares S0) prices each strike at its payoff
    with stderr 0."""
    return stream_policies(law, [(fit, beta)], strikes, is_call, seed,
                           n_chunks, chunk, antithetic, batch)[0]


def stream_policies(law: Law, policies, strikes, is_call: bool, seed: int,
                    n_chunks: int, chunk: int, antithetic: bool = False,
                    batch: int = 4) -> list:
    """``stream`` under each (fit, beta) of ``policies`` on the same
    paths, drawn once: one Quote each."""
    dev, dt_ = law.device, law.dtype
    strikes = torch.as_tensor(strikes, dtype=dt_, device=dev).reshape(-1)
    run = run_word(seed)
    cv_disc = math.exp(-law.r * law.n_steps * law.dt)
    drawn = chunk // 2 if antithetic else chunk
    totals = [[] for _ in policies]
    raw = [[] for _ in policies]
    intervals = [exercise_interval(fit, strikes, is_call)
                 for fit, _ in policies]
    for start in range(0, n_chunks, batch):
        idx = range(start, min(start + batch, n_chunks))
        n, w = normals([key_word(run, i) for i in idx], drawn, law.n_steps,
                       dev, dt_)
        ls = law.log_paths(n, w, antithetic)
        del n, w
        for b in range(len(idx)):
            ctl = None
            for i, (fit, beta) in enumerate(policies):
                t = stopped_values(ls[b], fit, strikes, law.r, law.dt,
                                   is_call, intervals[i]).sum(-1)
                raw[i].append(t)
                if beta is not None:
                    if ctl is None:
                        ctl = (cv_disc * torch.exp(ls[b, :, -1]).sum()
                               - chunk * law.s0)
                    t = t - beta * ctl
                totals[i].append(t)
        del ls
    p0 = payoff(torch.tensor(law.s0, dtype=dt_, device=dev), strikes,
                is_call)
    s0 = torch.full((strikes.numel(), 1), law.s0, dtype=dt_, device=dev)
    quotes = []
    for (fit, beta), tot_i, raw_i in zip(policies, totals, raw):
        tot = torch.stack(tot_i).to(torch.float64)       # [chunks, K]
        price = tot.mean(0) / chunk
        se = tot.std(0, unbiased=True) / math.sqrt(n_chunks) / chunk
        ex0 = (p0 > ITM_EPS) & (p0 >= fit.continuation(s0, 0)[:, 0])
        price = torch.where(ex0, p0.to(torch.float64), price)
        se = torch.where(ex0, torch.zeros_like(se), se)
        quotes.append(Quote(
            price.cpu().numpy(), se.cpu().numpy(), tot.cpu().numpy(),
            torch.stack(raw_i).to(torch.float64).cpu().numpy()
            if beta is not None else None))
    return quotes
