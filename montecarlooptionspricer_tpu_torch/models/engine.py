"""Fit-then-stream LSM pricing engine (counterpart:
``montecarlooptionspricer_tpu/models/engine.py``, the single-device
``StreamingPricer`` and ``StreamingChainPricer`` with the fused kernels,
the bucketed serving chains and the jvp Greeks).

  pilot:  the family's path kernel (K1 ``pathgen_cuda.pathgen``, K6
          ``pathgen_tiled_cuda.tiled_pathgen`` or K8
          ``pathgen_factored_cuda.factored_pathgen`` at long horizons)
          generates a pilot block, and the LSM backward induction
          (``lsm.lsm_fit``) fits one exercise policy per step;
  tables: each step's quadratic decision becomes a log-space exercise
          interval (``boundary_rows`` -> ``log_boundary_rows``), or under
          ``policy_form="quadratic"`` stays the fitted quadratic, which
          the kernels evaluate per cell (``policy_rows``); time-0
          exercise is decided on the host side;
  stream: the family's priced kernel (K2 ``pathgen_cuda.priced_chunk``,
          K7 ``pathgen_tiled_cuda.tiled_priced_chunk`` or K9
          ``pathgen_factored_cuda.factored_priced_chunk``) regenerates
          each chunk's paths on chip from its own random stream and
          returns the chunk's payoff sum; chunk totals and their squares
          give the price and its stderr.

The estimators (counterpart: ``StreamConfig.antithetic`` and
``control_variate`` of the JAX engine) are forms of the same priced
kernels: ``antithetic`` prices each chunk as chunk_paths / 2 pairs (N, W),
(-N, -W) from half the draws; ``control_variate`` has the kernel return
the martingale-control sum e^{-rT} sum S_T beside the payoff sum, and the
price is corrected by beta (mean control - s0), with beta and the
stderr's centre fitted on the pilot (``control_fit``).  The pilot stays
plain under both.

``resolve_kernel_family`` picks the family from the horizon, the fGN form
and ``tiled_impl`` (counterpart: ``_resolve_tiled_module``): the
single-tile kernels up to ``SINGLE_TILE_MAX_STEPS``, the slab K6/K7 past
it up to ``pathgen_tiled_cuda.max_tiled_steps()``, and the factored-DFT
kernels K8/K9 (the spectral law) past that up to
``pathgen_factored_cuda.max_factored_steps()``, or wherever the spectral
form or ``tiled_impl="factored"`` asks for them.  ``fgn_form="spectral"``
runs the spectral bodies of K1/K2 (three noise planes, ``X = Zr @ Cr' -
Zi @ Ci'``) up to ``SINGLE_TILE_MAX_STEPS``, of K6/K7 under
``tiled_impl="slab"`` (to 2,560 steps), and K8/K9 past the single tile
otherwise; "auto" and "chol" run the chol bodies.

A strike strip (``StreamingChainPricer``) fits every strike in one LSM
backward pass on the single-strike pricer's pilot and streams the strip
through K5 (``chain_cuda.priced_chain``) on S-space boundary tables (the
strip's quadratic ``policy_rows`` under ``chain_policy_form=
"quadratic"``), K5 in the fGN form of that pilot's law (spectral on the
factored family).
Greeks (``price_and_greeks`` on both pricers) stream the same fits
through the pathwise tangent kernels K3 and K4 (``greeks_cuda``) on the
single-tile horizons, chol only, as in JAX.  K5, K3 and K4 pair under
``antithetic`` as K2 does.

The generic path stream (``pathgen_stream``, the counterpart of the JAX
engine's XLA generator, family "stream") prices whole chunks in plain
PyTorch wherever no kernel applies: ``pathgen_impl="xla"``, a
``poly_order`` other than 2, horizons past K8's range, and strips past
K5's 512 steps.  Its pilot is the same generator's (plain under
``antithetic``), fitted by ``lsm_fit`` at any order, and each chunk is
priced by ``lsm_policy_value`` (with ``martingale_control`` under
``control_variate``), as the JAX engine's XLA branch does.  The kernels
never give way to it: it is chosen by the configuration alone.

The streamed duality bounds (``StreamingPricer.price_with_bounds``,
counterpart of the JAX method) bracket the price from the same chunks:
the pilot fits the policy, the hedge's quartic value-to-go fits
(``fit_hedge_deltas``) and the dual's scale (``fit_dual_scale``); each
chunk's whole paths come from the family's path kernel (K1, K6 or K8,
their pair forms under ``antithetic``) or the generic stream, and give the
policy's value (lower) and the delta-hedge dual (upper,
``dual_upper_values``).  The dual is plain PyTorch, as JAX computes it in
XLA.

Randomized quasi-Monte Carlo (``qmc``, counterpart: the JAX engine's
``qmc_fused`` route) feeds the priced kernels through their noise-in
entries: each chunk's planes are built on the device from a scrambled
Sobol set with its own digital shift (``make_fused_qmc``,
``fused_qmc_draws``, ``fused_qmc_noise``, the counterpart of
``_make_fused_qmc_noise``), the price Brownian by the PCA map, and the
chunk streams through K2, K7 or K9 (K5 for a strip) in any of its forms
but the pair.  The pilot, and the whole paths of ``price_with_bounds``,
come from the generic stream's QMC generator, as JAX's come from its XLA
generator.  A configuration outside every noise-in kernel streams through
the generic stream with a warning; Greeks under ``qmc`` take the jvp
Greeks stream on the QMC generator, as JAX's do.

Under a ``mesh`` (``parallel.mesh.Mesh``, counterpart: the ``mesh=`` of
the JAX pricers) each rank of the mesh's process group prices its own
chunks of every loop step, so one "chunk" of ``n_paths`` means
``chunk_paths`` x mesh size paths.  Rank r adds (r + 1) << 20 to the
stream index of every carrier it draws (the pilot's, each chunk's, the QMC
and generic-stream carriers: JAX's Pallas ``shard_mix``); its pilot is its
shard of a pilot of ``pilot_paths`` x size paths, whose regression
moments, control-variate moments, hedge fits and dual scale are
all-reduced, so every rank holds the same fits.  Each rank sums its chunk
totals on its device and one collective at the end pools the float64
totals and squares: only those partial sums cross devices.

``fgn_matmul_dtype="bfloat16"`` (counterpart: the JAX field of that name,
JAX's bench default at long horizons) runs the fGN product on bf16 inputs
with float32 sums, in every estimator, fGN and policy form of
``StreamingPricer.price`` and ``price_with_bounds``, of
``StreamingChainPricer.price`` and of both pricers' ``price_and_greeks``:
the bf16 forms of K1/K2 on the single tile, of K6/K7 on the slab (chol,
and spectral under ``tiled_impl="slab"``) and of K8/K9 on the factored
family (stage 1 on bf16 inputs), each family's range as under float32;
strips on K5/bf16 (every form, to 512 steps, piloted on K1, K6 or K8 in
their bf16 forms), Greeks on K3/bf16 and K4/bf16 (piloted on K1/bf16), as
the JAX engine sends the dtype into its chain and Greeks kernels; and the
bf16 matmul synthesis on the generic stream.  The bounds stream K1/K6/K8
in that form.

The jvp Greeks stream (counterpart: ``_greek_jvp_loop`` over the JAX
engine's ``traced_h`` XLA generator) carries the Greeks wherever K3/K4 do
not reach: past 365 steps, on the generic stream, under the spectral form,
the quadratic policy and qmc.  Each chunk's noise is drawn as the generic
stream draws it; ``jvp_chunk_greeks`` runs one ``torch.func.jvp`` over the
market (s0, xi, r, eta, H), vmapped over the five basis tangents, through
``pathgen_stream.paths_from_params`` (H enters through the matrices'
derivative, ``pathgen_stream.hurst_matrices``) and the fixed policy's
value, in row blocks that bound its memory.  It is plain PyTorch, as JAX
runs it in XLA.  Greeks under ``control_variate`` are the plain Greeks,
as in the JAX engine.  The quadratic policy forms select the priced
kernels' quadratic bodies and nothing else: the generic stream and the
bounds decide on whole paths by the fitted quadratic under either form,
and pairs with a quadratic policy raise on a kernel family (no kernel
pairs it, as in JAX) and price on the generic stream.

The serving pricers (``StreamingChainPricer(bucketed=True[,
traced_market=True])``, counterpart of the JAX branches of those names)
ride the generic stream: a step bucket with a per-call live horizon and
maturity, and under ``traced_market`` the whole market per call, Greeks
included (``cli/price.py --serve``).  Nothing runs another path silently.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import math
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from ..ops import qmc as qmc_ops
from ..ops.fgn import next_pow2
from ..ops.payoff import payoff
from ..ops.reductions import gather_ranks, global_mean, psum_all, psum_if
from ..ops.regression import (PolyFit, eval_poly, fit_poly_columns,
                              polyfit_from_numpy)  # noqa: F401
from ..ops.timegrid import step_mask
from ..parallel.mesh import mesh_device
from ..utils.profiling import count, span
from . import (chain_cuda, greeks_cuda, pathgen_cuda, pathgen_factored_cuda,
               pathgen_stream, pathgen_tiled_cuda)
from .greeks_cuda import GREEK_ORDER  # noqa: F401
from .lsm import ITM_EPS, lsm_fit

PILOT_STREAM = 3 << 28     # stream index of the pilot, past every chunk

log = logging.getLogger(__name__)

# Longest horizon priced by the single-tile kernels K1/K2; the step-tiled
# K6/K7 take every longer one.  chip_smoke.py's crossover phase measured K7
# faster than K2 per 131072-path chunk at every horizon it covers, 365 steps
# included (PERF.md section 5), so the constant sits at the bench horizon,
# which stays on K1/K2 until a benchmark can show the switch end to end.
SINGLE_TILE_MAX_STEPS = 365


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """The fields the ported path reads.  ``block_paths`` is the
    single-tile kernels' CUDA path block (0 = the largest the card admits
    at this horizon, see ``pathgen_cuda.max_block_paths``); the long-horizon
    kernels choose theirs.  ``fgn_form`` ("auto", "chol" or "spectral")
    and ``tiled_impl`` ("auto", "slab" or "factored") name the fGN law and
    the long-horizon kernels as the JAX fields do; ``pathgen_impl``
    ("pallas": the hand-written kernels, the port's default; "xla": the
    generic path stream, JAX's default) and ``fgn_impl`` ("auto" =
    "matmul", or "fft": the stream's synthesis) too;
    ``resolve_kernel_family`` says what each combination runs
    (``kernel_fgn_form``: "spectral" runs the spectral bodies of K1/K2,
    K5 and K6/K7, "auto" and "chol" the chol ones).  ``policy_form``
    (K2, K7 and K9) and ``chain_policy_form`` (K5) pick the priced
    kernels' exercise policy, "boundary" (log-space or S-space exercise
    intervals) or "quadratic" (the fitted quadratic per cell).
    ``antithetic``, ``qmc`` and ``control_variate`` name the JAX package's
    estimators: antithetic pairing needs chunk and pilot sizes divisible
    by 32 and excludes qmc; on a kernel family it needs the boundary
    policy (``_check_pairing``).  ``qmc_fgn`` (it needs ``qmc``) extends
    the Sobol set to the fGN planes, and ``qmc_dim`` (>= 1) is the
    Sobol coordinates of each plane, the leading PCA components of the
    price Brownian, the rest PRNG-filled, as the JAX fields.
    ``fgn_matmul_dtype``
    ("float32" or "bfloat16") is the fGN product's input dtype; the
    family does not depend on it, and every kernel body runs in both."""

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
    chain_policy_form: str = "boundary"
    tiled_impl: str = "auto"
    antithetic: bool = False
    qmc: bool = False
    qmc_fgn: bool = False
    qmc_dim: int = 256
    control_variate: bool = False
    pathgen_impl: str = "pallas"
    fgn_impl: str = "auto"
    fgn_matmul_dtype: str = "float32"

    def __post_init__(self):
        pathgen_cuda.check_fgn_dtype(self.fgn_matmul_dtype)
        if self.qmc_fgn and not self.qmc:
            raise ValueError("qmc_fgn requires qmc=True")
        if self.qmc_dim < 1:
            raise ValueError("qmc_dim must be >= 1")
        if self.antithetic and self.qmc:
            raise ValueError("antithetic is incompatible with qmc (the "
                             "Sobol set has its own stratification)")
        if self.antithetic and (self.chunk_paths % 32
                                or self.pilot_paths % 32):
            raise ValueError("antithetic needs chunk_paths and pilot_paths "
                             "divisible by 32 (half of each block's paths "
                             "are drawn)")
        for name in ("policy_form", "chain_policy_form"):
            if getattr(self, name) not in pathgen_cuda.POLICY_FORMS:
                raise ValueError(f"unknown {name}: {getattr(self, name)!r}")
        if self.poly_order < 1:
            raise ValueError(f"poly_order={self.poly_order} must be >= 1")
        pathgen_stream.resolve_fgn_impl(self.fgn_impl)
        resolve_kernel_family(self.n_steps, self.fgn_form, self.tiled_impl,
                              self.pathgen_impl, self.poly_order)
        if self.chunks_per_call < 1:
            raise ValueError("chunks_per_call must be >= 1")


def resolve_kernel_family(n_steps: int, fgn_form: str = "auto",
                          tiled_impl: str = "auto",
                          pathgen_impl: str = "pallas",
                          poly_order: int = 2) -> str:
    """The kernel family of a configuration (counterpart:
    ``_resolve_tiled_module`` and the JAX engine's fallbacks to its XLA
    generator): "single" (K1/K2), "tiled" (the chol slab K6/K7),
    "factored" (the factored-DFT K8/K9, spectral law) or "stream" (the
    generic path stream, ``pathgen_stream``, no kernel).

    * ``pathgen_impl="xla"`` or a ``poly_order`` other than 2 (the fused
      kernels read quadratic fits): stream, at every horizon.
    * Every form: single (K1/K2 in the form's bodies) up to
      SINGLE_TILE_MAX_STEPS.
    * "auto"/"chol": then the chol slab up to
      ``pathgen_tiled_cuda.max_tiled_steps()`` (3,620), then factored up
      to ``pathgen_factored_cuda.max_factored_steps()``, then the stream;
      an explicit "chol" that would need the factored kernels raises
      ValueError (they have no Cholesky form).
    * "spectral": then factored, then the stream; with
      ``tiled_impl="slab"`` the spectral slab up to
      ``max_tiled_steps("spectral")`` (2,560), as JAX takes its slab
      under spectral only when asked.
    * ``tiled_impl="factored"`` past the single-tile horizon: factored,
      or ValueError past K8's range; ``tiled_impl="slab"`` past the
      slab's range of the form: ValueError."""
    if n_steps < 1:
        raise ValueError(f"n_steps={n_steps} must be >= 1")
    if fgn_form not in ("auto", "chol", "spectral"):
        raise ValueError(f"unknown fgn_form: {fgn_form!r}")
    if tiled_impl not in ("auto", "slab", "factored"):
        raise ValueError(f"unknown tiled_impl: {tiled_impl!r}")
    if pathgen_impl not in ("pallas", "xla"):
        raise ValueError(f"unknown pathgen_impl: {pathgen_impl!r}")
    if pathgen_impl == "xla" or poly_order != 2:
        return "stream"
    form = kernel_fgn_form(fgn_form)
    if (n_steps <= SINGLE_TILE_MAX_STEPS
            and pathgen_cuda.supports(n_steps, form)):
        return "single"
    slab = tiled_impl == "slab" or (tiled_impl == "auto" and form == "chol")
    if slab and pathgen_tiled_cuda.supports(n_steps, form):
        return "tiled"
    cap = pathgen_factored_cuda.max_factored_steps()
    if tiled_impl != "slab" and pathgen_factored_cuda.supports(n_steps):
        if fgn_form == "chol":
            raise ValueError(
                "fgn_form='chol' cannot run on the factored-DFT kernels "
                "(spectral only); use fgn_form='auto', or tiled_impl='slab' "
                "within the slab's range "
                f"({pathgen_tiled_cuda.max_tiled_steps()} steps)")
        return "factored"
    if tiled_impl == "factored":
        raise ValueError(
            f"tiled_impl='factored' cannot cover n_steps={n_steps} (K8/K9 "
            f"take {pathgen_factored_cuda.LANE} < n <= {cap}); use "
            "tiled_impl='auto', which takes the generic path stream past "
            "them")
    if tiled_impl == "slab":
        raise ValueError(
            f"tiled_impl='slab' cannot cover n_steps={n_steps} (K6/K7 take "
            f"n <= {pathgen_tiled_cuda.max_tiled_steps(form)} in the {form} "
            "form); use tiled_impl='auto'")
    return "stream"


def kernel_fgn_form(fgn_form: str, family: str = "single") -> str:
    """The fGN form of the kernel bodies a configuration runs on
    ``family``: "spectral" where ``fgn_form`` asks for it and on the
    factored family (the spectral law), else "chol" (JAX's "auto")."""
    if fgn_form == "spectral" or family == "factored":
        return "spectral"
    return "chol"


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


@functools.lru_cache(maxsize=64)
def _chol_dh_matrix_host(n_steps: int, h: float, eta: float, dt: float,
                         eps: float = 1e-5) -> np.ndarray:
    """d(Lt)/dH by a float64 central difference of ``_chol_np``, upper
    triangular: the host constant behind the Greeks kernels' vega_h.
    The map h -> Lt is smooth away from the jitter fallback, so the
    truncation error is O(eps^2) ~ 1e-10 relative.  Cached and
    read-only."""
    lp = _chol_np(n_steps, h + eps, eta, dt)
    lm = _chol_np(n_steps, h - eps, eta, dt)
    dlt = np.ascontiguousarray(((lp - lm) / (2.0 * eps)).T)
    dlt.setflags(write=False)
    return dlt


def _check_pairing(quadratic: bool, family: str, config: StreamConfig,
                   field: str) -> None:
    """The JAX engine's pairing rule (``_anti_ok``): under ``antithetic``
    a kernel family needs the boundary policy, as only its bodies pair;
    the generic stream pairs whole paths under either policy form."""
    if config.antithetic and quadratic and family != "stream":
        raise ValueError(
            f"antithetic=True with {field}='quadratic' has no kernel on the "
            f"{family!r} family (only the boundary bodies pair): use "
            f"{field}='boundary', or pathgen_impl='xla' for the generic "
            "stream, which pairs whole paths")


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


def _check_pallas_chunk_range(n_chunks: int, n_dev: int = 1) -> None:
    """Keep the stream index inside the seed scheme's int32 ranges: fewer
    than 2^20 chunks a rank, and at most 256 ranks, whose offsets (r + 1)
    << 20 stay below the pilot marker 3 << 28 plus them; past either bound
    two chunks or ranks would draw the same stream."""
    if n_chunks >= 1 << 20:
        raise ValueError(f"{n_chunks} chunks exceeds the seed scheme's "
                         "2^20 range; raise chunk_paths")
    if n_dev > 256:
        raise ValueError("the seed scheme supports <= 256 shards")


def _shard_offset(mesh) -> int:
    """The stream-index offset of this rank's carriers: 0 without a mesh,
    (rank + 1) << 20 on one (JAX's Pallas ``shard_mix``)."""
    return 0 if mesh is None else (mesh.rank + 1) << 20


def _pool_centred(total, sq, center, n_local: int, group):
    """(total, sum of squares, center) of every rank's chunk totals, from
    each rank's float64 ``total`` and ``sq`` about its own ``center`` (its
    first chunk's total), in one collective.  The squares move to rank 0's
    center b by the exact shift sum (c - b)^2 = sum (c - a)^2
    + 2 (a - b) sum (c - a) + n (a - b)^2 in float64, where
    sum (c - a) = total - n a."""
    if group is None:
        return total, sq, center
    t, q, a = gather_ranks(torch.stack([total, sq, center]), group).unbind(1)
    d = a - a[0]
    q = q + 2.0 * d * (t - n_local * a) + n_local * d * d
    return t.sum(0), q.sum(0), a[0]


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
                        is_call: bool, policy_form: str = "boundary"):
    """fits -> the table the priced kernels read: the log-space boundary
    table, or the quadratic ``policy_rows`` under
    ``policy_form="quadratic"`` (counterpart: the JAX engine's
    ``_fused_rows_builder``)."""
    if pathgen_cuda.check_policy(policy_form):
        def make_rows(fits):
            return pathgen_cuda.policy_rows(fits, r, strike, maturity, dt,
                                            n_steps, is_call).contiguous()
        return make_rows

    def make_rows(fits):
        tab = pathgen_cuda.boundary_rows(fits, r, strike, maturity, dt,
                                         n_steps, is_call)
        return pathgen_cuda.log_boundary_rows(tab).contiguous()
    return make_rows


# ---------------------------------------------------------------------------
# Policy evaluation on whole paths (the test oracle of the fused kernel).

def _time_discount(m: int, r, dt, device) -> torch.Tensor:
    """[m] float32 exp(-r t) at t = j dt, j = 0..m-1."""
    return torch.exp(-r * (torch.arange(m, dtype=torch.float32,
                                        device=device) * dt))


def lsm_policy_path_values(paths, fits: PolyFit, r, strike, maturity, dt,
                           is_call: bool, n_steps_live=None) -> torch.Tensor:
    """[n] discounted payoff of each path under the fitted policy: the
    first step j < n_steps that is in the money with payoff >= the fitted
    continuation, else the terminal payoff.  ``n_steps_live`` (a host int,
    the contract's horizon in a step-bucketed block that is flat past it)
    forces exercise at that column and keeps the pad columns from
    exercising, so the padded block prices as the exact-shape one.  ``r``
    may be a 0-d tensor (the jvp Greeks' rho)."""
    n, m = paths.shape
    p = payoff(is_call, paths, strike)
    cont = eval_poly(fits, paths[:, : m - 1])
    live = step_mask(m - 1, dt, maturity, device=paths.device)[None, :]
    exercise = (p[:, : m - 1] > ITM_EPS) & (p[:, : m - 1] >= cont) & live
    exercise = torch.cat([exercise, torch.ones((n, 1), dtype=torch.bool,
                                               device=paths.device)], dim=1)
    if n_steps_live is not None and n_steps_live < m - 1:
        col = torch.arange(m, device=paths.device)[None, :]
        exercise = (exercise & (col < n_steps_live)) | (col == n_steps_live)
    stop = exercise.to(torch.int8).argmax(dim=1)
    disc = _time_discount(m, r, dt, paths.device)
    return (p * disc[None, :]).gather(1, stop[:, None])[:, 0]


def lsm_policy_value(paths, fits: PolyFit, r, strike, maturity, dt,
                     is_call: bool, n_steps_live=None):
    """(sum of lsm_policy_path_values, path count)."""
    value = lsm_policy_path_values(paths, fits, r, strike, maturity, dt,
                                   is_call, n_steps_live)
    return torch.sum(value), paths.shape[0]


def martingale_control(paths, r, dt) -> torch.Tensor:
    """[n] per-path martingale control e^{-rT} S_T: its expectation is
    exactly S0 under the Euler log scheme (the price Brownian is
    independent of the variance driver)."""
    m = paths.shape[1]
    return torch.exp(torch.tensor(-r * (m - 1) * dt,
                                  dtype=paths.dtype)) * paths[:, -1]


# ---------------------------------------------------------------------------
# The jvp Greeks stream (counterpart: ``_greek_jvp_loop`` and the chunk
# functions of the JAX engine's Greeks streams, which XLA runs, not a
# kernel): forward mode over the market (s0, xi, r, eta, H) through the
# generic stream's synthesis and the fixed policy.

# Floats of one [rows, steps + 1] path plane per row block of a jvp chunk:
# the five tangent lanes and the primal make each live plane six times
# this (2^26 floats, 256 MB), and a block holds a few at once.  A 131,072-
# row chunk is one block up to 511 steps and four at 1825.
_JVP_BLOCK_FLOATS = 1 << 26


def jvp_market(consts: pathgen_stream.StreamConsts) -> tuple:
    """(primals, tangents) of the jvp at the market of ``consts``: primals
    (s0, xi, r, eta) as float32 0-d tensors and the synthesis (cr, ci,
    t_pow) of ``consts``; tangents, one per primal, each with a leading
    axis of the five basis directions s0, xi, r, eta, H: the unit vectors
    for the scalars, and H's derivative of the matrices and of t^{2H}
    (``pathgen_stream.hurst_matrices(with_dh=True)``) in the fifth."""
    if consts.fgn_impl != "matmul":
        raise ValueError("the jvp Greeks take the matmul fGN synthesis")
    dev = consts.device
    f32 = dict(dtype=torch.float32, device=dev)
    _, dmats = pathgen_stream.hurst_matrices(
        consts.n_steps, consts.dt, consts.h, dev,
        "bfloat16" if consts.bf16 else "float32", with_dh=True)
    eye = torch.eye(5, **f32)
    scalars = tuple(torch.tensor(v, **f32)
                    for v in (consts.s0, consts.xi, consts.r, consts.eta))
    tangents = tuple(eye[:, j] for j in range(4)) + tuple(
        eye[:, 4].reshape(5, *([1] * d.dim())) * d for d in dmats)
    return scalars + (consts.cr, consts.ci, consts.t_pow), tangents


def jvp_lanes(chunk_val, primals: tuple, tangents: tuple) -> torch.Tensor:
    """[6, ...] rows (``GREEK_ORDER``) of ``chunk_val``'s value and its
    derivatives in (s0, xi, r, eta, H): one ``torch.func.jvp`` vmapped
    over the five basis tangents, so the primal runs once (the JAX
    engine's ``_greek_jvp_loop`` body), the lanes reordered as JAX's
    [vals, d s0, d xi, d eta, d r, d H]."""
    vals, grads = torch.func.vmap(
        lambda *t: torch.func.jvp(chunk_val, primals, t))(*tangents)
    return torch.stack([vals[0], grads[0], grads[1], grads[3], grads[2],
                        grads[4]])


def jvp_chunk_greeks(consts: pathgen_stream.StreamConsts, z: torch.Tensor,
                     dw: torch.Tensor, fits: PolyFit, strike, maturity,
                     is_call: bool, antithetic: bool = False, n_live=None,
                     market: Optional[tuple] = None) -> torch.Tensor:
    """One chunk's jvp Greeks: [6] (one strike, a number) or [6, K] (a
    [K] strike tensor with fits of a leading [K] axis) sums over the
    chunk's paths of the policy values and their derivatives, rows in
    ``GREEK_ORDER``, from the noise (z [2, drawn, n], dw [drawn, n]) as
    ``pathgen_stream.paths_from_noise`` takes it, at the market of
    ``consts`` (``market``: its ``jvp_market``, built here when None).  The
    rows
    go through in blocks of at most ``_JVP_BLOCK_FLOATS`` path floats
    (the sums are linear in the rows): each block's tangent planes are
    five times its primal's."""
    primals, tangents = market if market is not None else jvp_market(consts)
    strip = isinstance(strike, torch.Tensor) and strike.dim() == 1
    ks = strike.tolist() if strip else [strike]
    dt = consts.dt

    def chunk_val(zb, dwb):
        def value(s0, xi, r, eta, cr, ci, tp):
            paths = pathgen_stream.paths_from_params(
                consts, zb, dwb, (s0, xi, r, eta), (cr, ci, tp), antithetic,
                n_live)
            if not strip:
                return lsm_policy_value(paths, fits, r, strike, maturity, dt,
                                        is_call, n_live)[0]
            return torch.stack([lsm_policy_value(
                paths, PolyFit(*(f[i] for f in fits)), r, k, maturity, dt,
                is_call, n_live)[0] for i, k in enumerate(ks)])
        return value

    drawn = z.shape[1]
    width = (consts.n_steps + 1) * (2 if antithetic else 1)
    n_blocks = -(-drawn * width // _JVP_BLOCK_FLOATS)
    step = -(-drawn // n_blocks)
    total = None
    for a in range(0, drawn, step):
        lanes = jvp_lanes(chunk_val(z[:, a:a + step], dw[a:a + step]),
                          primals, tangents)
        total = lanes if total is None else total + lanes
    return total


# ---------------------------------------------------------------------------
# The duality upper bound (counterpart: ``_hedge_martingale``,
# ``fit_hedge_deltas``, ``dual_upper_values`` and ``fit_dual_scale`` of the
# JAX engine, which computes them in XLA, not in a kernel: here they are
# plain PyTorch on the paths' device).

def _exercise_window(m: int, dt, maturity, device) -> torch.Tensor:
    """[m] bool: the dual's exercise dates, step 0 and the live steps
    (t <= maturity), and the terminal step always."""
    return torch.cat([step_mask(m - 1, dt, maturity, device=device),
                      torch.ones(1, dtype=torch.bool, device=device)])


def _hedge_martingale(paths, delta_fits: PolyFit, r, strike, dt,
                      is_call: bool) -> torch.Tensor:
    """[n, m] path values of the delta-hedge martingale
    M_t = sum_{k<t} g_k(S_k) (e^{-r t_{k+1}} S_{k+1} - e^{-r t_k} S_k),
    g_k the derivative of the pilot's fitted value-to-go at step k,
    clipped to the no-arbitrage delta band ([0, 1] for a call, [-1, 0] for
    a put).  M is a martingale for any deterministic g_k, so the fit's
    quality sets the bound's tightness, never its validity.  Updates its
    temporaries in place (one [n, m - 1] plane at a time)."""
    n, m = paths.shape
    disc = _time_discount(m, r, dt, paths.device)[None, :]
    s_steps = paths[:, : m - 1]
    zstd = (s_steps - delta_fits.mu[None, :]) / delta_fits.sd[None, :]
    order = delta_fits.coeffs.shape[-1] - 1
    dv = torch.zeros_like(zstd)
    for k in range(order, 0, -1):        # Horner on the derivative
        dv.mul_(zstd).add_(k * delta_fits.coeffs[None, :, k])
    del zstd
    dv.div_(delta_fits.sd[None, :])
    g = dv.clamp_(0.0, 1.0) if is_call else dv.clamp_(-1.0, 0.0)
    ds = disc[:, 1:] * paths[:, 1:] - disc[:, : m - 1] * s_steps
    return torch.cat([torch.zeros((n, 1), dtype=paths.dtype,
                                  device=paths.device),
                      torch.cumsum(g.mul_(ds), dim=1)], dim=1)


# Quartic value-to-go fits for the dual's hedge deltas (the JAX engine's
# choice: on the GBM limit it gave the tightest gap of the orders tried).
HEDGE_POLY_ORDER = 4
# Steps per group of the hedge fit: each group's power planes are
# [steps, pilot rows], about 2^26 floats (256 MB) at most.
_HEDGE_FIT_FLOATS = 1 << 26


def fit_hedge_deltas(pilot, fits: PolyFit, r, strike, maturity, dt,
                     is_call: bool, group=None) -> PolyFit:
    """[m - 1] quartic fits of the realized value-to-go on S_k over all
    pilot paths, whose derivatives drive the dual's delta hedge
    (``_hedge_martingale``).  The value-to-go at step k is the discounted
    payoff the fitted policy ``fits`` collects from step k onward, in
    time-k dollars.  The JAX engine vmaps its masked fit over the steps;
    here ``fit_poly_columns`` fits a group of steps at once from power
    sums, in groups that bound the memory of the pilot's transposed
    planes.  With a process ``group`` the pilot is this rank's shard and
    the sums pool over the group's ranks."""
    n, m = pilot.shape
    dev = pilot.device
    disc = _time_discount(m, r, dt, dev)
    p = payoff(is_call, pilot, strike)
    s_steps = pilot[:, : m - 1]
    cont = eval_poly(fits, s_steps)
    live = step_mask(m - 1, dt, maturity, device=dev)[None, :]
    ex = (p[:, : m - 1] > ITM_EPS) & (p[:, : m - 1] >= cont) & live
    del cont
    ex = torch.cat([ex, torch.ones((n, 1), dtype=torch.bool, device=dev)],
                   dim=1)
    # tau_k = the first exercise step >= k (a reverse running minimum).
    cols = torch.arange(m, device=dev)[None, :]
    idx = torch.where(ex, cols, torch.full_like(cols, m))
    del ex
    tau = torch.flip(torch.cummin(torch.flip(idx, [1]), dim=1).values, [1])
    del idx
    vtg = (p * disc[None, :]).gather(1, tau).div_(disc[None, :])[:, : m - 1]
    del tau, p
    step = max(1, _HEDGE_FIT_FLOATS // n)
    parts = [fit_poly_columns(s_steps[:, j:j + step].T,
                              vtg[:, j:j + step].T, HEDGE_POLY_ORDER,
                              group=group)
             for j in range(0, m - 1, step)]
    return PolyFit(*(torch.cat(f) for f in zip(*parts)))


def dual_upper_values(paths, delta_fits: PolyFit, lam, r, strike,
                      maturity, dt, is_call: bool) -> torch.Tensor:
    """[n] duality upper-bound values: the max over the exercise dates
    (step 0, the live steps, the terminal step) of Z_t - lam M_t, with
    Z_t = e^{-rt} payoff(S_t) and M the delta-hedge martingale.  For any
    scale lam, E[max_t (Z_t - lam M_t)] >= sup_tau E[Z_tau] (the
    Rogers / Haugh-Kogan dual), so the streamed mean is an upper bound
    beside the fitted policy's lower bound; lam (``fit_dual_scale``) only
    sets its tightness."""
    m = paths.shape[1]
    z = payoff(is_call, paths, strike) * _time_discount(m, r, dt,
                                                        paths.device)
    mart = _hedge_martingale(paths, delta_fits, r, strike, dt, is_call)
    live = _exercise_window(m, dt, maturity, paths.device)[None, :]
    vals = torch.where(live, z - lam * mart,
                       torch.tensor(-math.inf, device=paths.device))
    return torch.max(vals, dim=1).values


def fit_dual_scale(paths, delta_fits: PolyFit, r, strike, maturity, dt,
                   is_call: bool, group=None) -> torch.Tensor:
    """The hedge scale lam (a 0-d float32 tensor on the paths' device)
    that minimizes the pilot's dual bound, as the JAX engine searches it:
    41 lam in [0, 2]; where the coarse argmin lands on the last point,
    41 more in [2, 10]; then 21 points of +-0.05 (+-0.1 on the extended
    grid) around the winner.  Z and the unit-scale martingale are hoisted
    out of the sweep, one [n, m] pass per lam; ties go to the first
    index.  The coarse argmin is read on the host once.  With a process
    ``group`` each lam's mean pools every rank's shard of the pilot, so
    the ranks pick the same lam."""
    m = paths.shape[1]
    dev = paths.device
    z = payoff(is_call, paths, strike) * _time_discount(m, r, dt, dev)
    mart = _hedge_martingale(paths, delta_fits, r, strike, dt, is_call)
    live = _exercise_window(m, dt, maturity, dev)[None, :]
    z = torch.where(live, z, torch.tensor(-math.inf, device=dev))
    mart = torch.where(live, mart, torch.zeros((), device=dev))

    def obj(lams: torch.Tensor) -> torch.Tensor:
        return torch.stack([global_mean(torch.max(z - lam * mart,
                                                  dim=1).values, group)
                            for lam in lams])

    f32 = dict(dtype=torch.float32, device=dev)
    lams = torch.linspace(0.0, 2.0, 41, **f32)
    i0 = int(torch.argmin(obj(lams)))
    if i0 == lams.shape[0] - 1:
        ext = torch.linspace(2.0, 10.0, 41, **f32)
        l0, half = ext[torch.argmin(obj(ext))], 0.1
    else:
        l0, half = lams[i0], 0.05
    fine = l0 + torch.linspace(-1.0, 1.0, 21, **f32) * half
    return fine[torch.argmin(obj(fine))]


class CVFit(NamedTuple):
    """What the control-variate stream needs from the pilot: the policy
    ``fits``, the control's coefficient ``beta`` and ``center``, the
    pilot's estimate of a corrected chunk total, on which the stream
    centres its squares (float32 squares of raw CV-corrected totals cancel
    to a false stderr of 0).  A JAX fit carries over with its beta and
    center as floats."""

    fits: PolyFit
    beta: float
    center: float


def control_fit(paths, fits: PolyFit, r, strike, maturity, dt,
                is_call: bool, chunk_paths: int,
                group=None) -> tuple[float, float]:
    """(beta, center) from pilot ``paths`` under ``fits``: beta from the
    centred moments of the policy values and the control, center = (mean
    value - beta mean control) * chunk_paths, in the paths' float32.  With
    a process ``group`` the means and moments pool every rank's shard of
    the pilot (JAX's pooled beta), so the ranks share beta and center."""
    with span("mcop.control_fit"):
        av = lsm_policy_path_values(paths, fits, r, strike, maturity, dt,
                                    is_call)
        cv = martingale_control(paths, r, dt)
        av_m, cv_m = global_mean(av, group), global_mean(cv, group)
        cvc, avc = cv - cv_m, av - av_m
        cross, var = psum_all(torch.sum(cvc * avc), torch.sum(cvc * cvc),
                              group=group)
        beta = cross / torch.clamp_min(var, 1e-12)
        center = (av_m - beta * cv_m) * float(chunk_paths)
        count("host_reads", 2)
        return float(beta), float(center)


# ---------------------------------------------------------------------------
# Randomized QMC noise for the priced kernels' noise-in entries.

@dataclasses.dataclass(frozen=True)
class FusedQMC:
    """What a chunk's QMC noise needs besides its draws (counterpart: the
    closure of ``_make_fused_qmc_noise``): the chunk's Sobol base ``bits``
    [rows, dims] (int32 bit patterns on the device), the transposed PCA
    map ``pca_t`` [n, n] (it carries sqrt(dt), divided back out:
    ``inv_sqrt_dt``), the planes' ``width`` (n_steps, or the factored
    kernels' m2), the fGN planes ``n_fgn`` (1 chol, 2 spectral or
    factored), and the Sobol coordinates of the Brownian ``q_w`` and of
    each fGN plane under ``qmc_fgn``, ``q_f``."""

    n_steps: int
    width: int
    n_fgn: int
    q_w: int
    q_f: int
    qmc_fgn: bool
    inv_sqrt_dt: float
    bits: torch.Tensor
    pca_t: torch.Tensor

    @property
    def rows(self) -> int:
        return self.bits.shape[0]

    @property
    def device(self) -> torch.device:
        return self.bits.device


def make_fused_qmc(config: StreamConfig, fgn_form: str,
                   device) -> FusedQMC:
    """The QMC noise of a chunk of ``config.chunk_paths`` rows for the
    noise-in entry of the ``fgn_form`` bodies: "chol" (N, W), "spectral"
    (Zr, Zi, W), each [rows, n_steps], or "factored" (Zr, Zi, W) over the
    factored kernels' m2-wide frequency planes (W in its first n_steps
    columns, zero after).  The Sobol set is the truncated one of
    ``config.qmc_dim``: the leading q_w = min(n, qmc_dim) PCA components
    of the price Brownian, and under ``qmc_fgn`` the leading q_f =
    min(width, qmc_dim) columns of each fGN plane (for the factored
    planes their storage order's), the rest PRNG-filled, as JAX builds
    it."""
    n, dt = config.n_steps, float(config.dt)
    width = next_pow2(n) if fgn_form == "factored" else n
    n_fgn = 1 if fgn_form == "chol" else 2
    q_w, q_f = min(n, config.qmc_dim), min(width, config.qmc_dim)
    dims = q_w + (n_fgn * q_f if config.qmc_fgn else 0)
    pca_t = torch.tensor(np.ascontiguousarray(
        qmc_ops.brownian_pca_matrix(n, dt).T), dtype=torch.float32,
        device=device)
    return FusedQMC(n, width, n_fgn, q_w, q_f, bool(config.qmc_fgn),
                    float(1.0 / np.sqrt(dt)),
                    qmc_ops.base_bits(config.chunk_paths, dims,
                                      torch.device(device)), pca_t)


def fused_qmc_draws(q: FusedQMC, gen: torch.Generator) -> tuple:
    """A chunk's draws from ``gen``, in this order (counterpart: JAX's
    ``split(key, 3)`` into kq, kp, kt): the digital shift [dims], the
    PRNG tail of the PCA coordinates [rows, n - q_w], and the fGN normals
    [n_fgn, rows, width] (under ``qmc_fgn`` their tails [n_fgn, rows,
    width - q_f])."""
    dev = q.device
    shift = qmc_ops.draw_shift(gen, q.bits.shape[1])
    tail = torch.randn((q.rows, q.n_steps - q.q_w), generator=gen,
                       device=dev)
    cols = q.width - q.q_f if q.qmc_fgn else q.width
    return shift, tail, torch.randn((q.n_fgn, q.rows, cols), generator=gen,
                                    device=dev)


def fused_qmc_noise(q: FusedQMC, shift: torch.Tensor, w_tail: torch.Tensor,
                    fgn: torch.Tensor) -> torch.Tensor:
    """[n_fgn + 1, rows, width] float32 noise from a chunk's draws
    (``fused_qmc_draws``', or JAX's injected): the fGN planes first, then
    W, the PCA'd Brownian increments divided by sqrt(dt) (the kernels
    scale W by sqrt(dt) themselves).  A fresh contiguous tensor, so its
    planes start 16-byte aligned."""
    zq = qmc_ops.normals(q.bits, shift)
    out = torch.empty((q.n_fgn + 1, q.rows, q.width), dtype=torch.float32,
                      device=q.device)
    w = pathgen_stream.pca_increments(zq[:, :q.q_w], w_tail, q.pca_t)
    out[-1, :, :q.n_steps] = w.mul_(q.inv_sqrt_dt)
    out[-1, :, q.n_steps:] = 0.0
    del w
    for i in range(q.n_fgn):
        if q.qmc_fgn:
            lo = q.q_w + i * q.q_f
            out[i, :, :q.q_f] = zq[:, lo:lo + q.q_f]
            out[i, :, q.q_f:] = fgn[i]
        else:
            out[i] = fgn[i]
    return out


class _FusedStream:
    """What both pricers share: the device, the path constants of the
    family (the fused kernels', or the generic stream's), the pilot, and
    the chunk loop that turns per-chunk sums into float64 totals and
    chunk-total stderrs.  ``stream_consts`` are the generic stream's
    constants wherever whole paths come from it: on the "stream" family
    (they are ``consts``), and under ``qmc`` for the pilot and the
    bounds' chunks (then beside the kernels' ``consts``).  Under ``mesh``
    the device is the mesh's (of ``device``'s type), and ``_group`` the
    process group every fit and total pools over (None without one)."""

    def __init__(self, s0, xi, h, eta, r, maturity, is_call: bool,
                 config: StreamConfig, device, family: Optional[str] = None,
                 mesh=None):
        device = mesh_device(mesh, device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run "
                               "the plain versions")
        if device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {device}")
        if config.chunk_paths % 16 or config.pilot_paths % 16:
            raise ValueError("chunk_paths and pilot_paths must divide by 16")
        self.config = config
        self.device = device
        self.mesh = mesh
        self.n_dev = 1 if mesh is None else mesh.size
        self._group = None if mesh is None else mesh.group
        self._shard = _shard_offset(mesh)
        self.s0, self.r = float(s0), float(r)
        self.maturity = float(maturity)
        self.is_call = bool(is_call)
        self._xi, self._h, self._eta = float(xi), float(h), float(eta)
        self.kernel_family = family or resolve_kernel_family(
            config.n_steps, config.fgn_form, config.tiled_impl,
            config.pathgen_impl, config.poly_order)
        self._fused_qmc = None
        with span("mcop.setup.consts", family=self.kernel_family):
            self._make_consts(s0, xi, h, eta, r, config, device)

    def _make_consts(self, s0, xi, h, eta, r, config: StreamConfig,
                     device) -> None:
        """The family's path constants (``consts``; ``stream_consts`` on
        the generic stream and under ``qmc``)."""
        self.stream_consts = None
        if self.kernel_family == "stream" or config.qmc:
            self.stream_consts = pathgen_stream.make_stream_consts(
                s0, xi, h, eta, r, config.n_steps, config.dt, device,
                config.fgn_impl, fgn_dtype=config.fgn_matmul_dtype,
                qmc=config.qmc, qmc_fgn=config.qmc_fgn,
                qmc_dim=config.qmc_dim)
        if self.kernel_family == "stream":
            self.consts = self.stream_consts
            return
        if self.kernel_family == "factored":
            # The family builds only its own constants: no Cholesky.
            self._pathgen = pathgen_factored_cuda.factored_pathgen
            self.consts = pathgen_factored_cuda.make_factored_consts(
                s0, xi, h, eta, r, config.n_steps, config.dt, device,
                fgn_dtype=config.fgn_matmul_dtype)
            return
        form = kernel_fgn_form(config.fgn_form)
        if self.kernel_family == "single":
            block = config.block_paths or pathgen_cuda.max_block_paths(
                config.n_steps, form)
            while config.chunk_paths % block or config.pilot_paths % block:
                block //= 2
            self._pathgen = pathgen_cuda.pathgen
        else:
            block = 0
            self._pathgen = pathgen_tiled_cuda.tiled_pathgen
        self.consts = pathgen_cuda.make_path_consts(
            s0, xi, h, eta, r, config.n_steps, config.dt, device,
            block_paths=block, fgn_form=form,
            fgn_dtype=config.fgn_matmul_dtype)

    @functools.cached_property
    def greeks_consts(self) -> pathgen_cuda.GreeksConsts:
        """The Greeks kernels' constants in the configuration's fGN input
        dtype, built at first use."""
        return pathgen_cuda.make_greeks_consts(
            self._xi, self._h, self._eta, self.config.n_steps,
            self.config.dt, self.device,
            fgn_dtype=self.config.fgn_matmul_dtype)

    def _warn_stream_fallback(self, what: str) -> None:
        """The loud fallback of the JAX engine (its ``qmc_fused``
        selection): a QMC configuration of the kernels that no noise-in
        kernel covers streams through the generic stream, and says so."""
        if self.config.qmc and self.kernel_family == "stream" \
                and self.config.pathgen_impl == "pallas":
            log.warning(
                "qmc=True with pathgen_impl='pallas': no noise-in kernel "
                "covers %s at n_steps=%d (poly_order=%d); the QMC stream "
                "rides the generic path stream at reduced throughput", what,
                self.config.n_steps, self.config.poly_order)

    def _shard_mix(self, carrier) -> tuple:
        """``carrier`` with this rank's offset added to its stream index."""
        run, index = carrier
        return run, index + self._shard

    def _pilot(self, carrier) -> torch.Tensor:
        """Pilot block from the (run_word, stream_index) ``carrier``
        through the family's path kernel, or the generic stream's
        generator (plain under ``antithetic``; its QMC generator under
        ``qmc``); under a mesh this rank's shard of the pilot, from the
        carrier shifted by its offset."""
        carrier = self._shard_mix(carrier)
        with span("mcop.pilot", family=self.kernel_family):
            if self.stream_consts is not None:
                return pathgen_stream.chunk_paths(
                    self.stream_consts, self.config.pilot_paths, carrier)
            return self._pathgen(self.consts, rows=self.config.pilot_paths,
                                 key=pathgen_cuda._fold_words(*carrier))

    def _stream_paths(self, rows=None, carrier=None, noise=None,
                      consts=None, n_live=None):
        """One chunk of the generic stream (``consts``, default
        ``stream_consts``): from the seeded ``carrier`` or from ``noise`` =
        (z, dw), paired under ``antithetic``, flat past ``n_live``."""
        anti, consts = self.config.antithetic, consts or self.stream_consts
        if noise is not None:
            return pathgen_stream.paths_from_noise(consts, *noise, anti,
                                                   n_live)
        return pathgen_stream.chunk_paths(consts, rows, carrier, anti,
                                          n_live)

    def _chunk_paths(self, rows=None, key=None, carrier=None, noise=None):
        """One chunk's whole paths (kw from ``_groups``): the family's path
        kernel K1, K6 or K8 in its pair form under ``antithetic`` (the
        drawn rows' paths, then their partners'), or the generic
        stream's (under ``qmc`` too, as JAX's whole paths ride its XLA
        generator)."""
        if self.stream_consts is not None:
            return self._stream_paths(rows, carrier, noise)
        return self._pathgen(self.consts, rows=rows, key=key, noise=noise,
                             antithetic=self.config.antithetic)

    def _qmc_chunk_noise(self, carrier) -> torch.Tensor:
        """The QMC noise of the chunk of ``carrier``, from a generator
        seeded from it, so chunks are independent randomizations."""
        q = self._fused_qmc
        gen = pathgen_stream.stream_generator(self.device, carrier)
        return fused_qmc_noise(q, *fused_qmc_draws(q, gen))

    def _kernel_chunks(self, kernel):
        """``kernel(**kw)`` over the chunks of ``_groups``; under ``qmc``
        each seeded chunk (a carrier) reads its QMC noise through the
        kernel's noise-in entry, built one chunk at a time."""
        if self._fused_qmc is None:
            return kernel

        def chunk(carrier=None, noise=None):
            if noise is None:
                noise = self._qmc_chunk_noise(carrier)
            return kernel(noise=noise)
        return chunk

    def _kernel_greeks(self) -> bool:
        """Whether the fused Greeks kernels K3/K4 take this configuration:
        where the JAX engine keeps its fused Greeks (the single-tile
        horizons, the chol form, the boundary policy, not qmc).  Every
        other configuration takes the jvp Greeks stream."""
        return (self.kernel_family == "single" and not self.config.qmc
                and not self.quadratic and not self.consts.spectral
                and greeks_cuda.supports(self.config.n_steps))

    @functools.cached_property
    def jvp_consts(self) -> pathgen_stream.StreamConsts:
        """The jvp Greeks' generator (counterpart: the JAX engine's
        dedicated ``traced_h=True`` matmul generators): the generic
        stream's constants where they run the matmul synthesis, so on the
        "stream" family the Greeks' pilot and chunks are ``price``'s, else
        the matmul stream's of the same market, QMC and dtype."""
        sc = self.stream_consts
        if sc is not None and sc.fgn_impl == "matmul":
            return sc
        cfg = self.config
        return pathgen_stream.make_stream_consts(
            self.s0, self._xi, self._h, self._eta, self.r, cfg.n_steps,
            cfg.dt, self.device, "matmul", fgn_dtype=cfg.fgn_matmul_dtype,
            qmc=cfg.qmc, qmc_fgn=cfg.qmc_fgn, qmc_dim=cfg.qmc_dim)

    def _stream_fit(self, carrier, strike, consts=None, maturity=None,
                    n_live=None) -> PolyFit:
        """A policy fitted on the generic stream: the plain pilot of
        ``carrier`` from ``consts`` (default ``jvp_consts``, the jvp
        Greeks' generator; a bucketed chain's call constants, flat past
        ``n_live``), fitted at ``strike`` (a number, or a [K] strip) in
        one backward pass, the steps past ``n_live`` padding."""
        consts = consts or self.jvp_consts
        with span("mcop.pilot", family="stream"):
            pilot = pathgen_stream.chunk_paths(
                consts, self.config.pilot_paths, self._shard_mix(carrier),
                n_live=n_live)
        _, fits = lsm_fit(pilot, consts.r, strike,
                          self.maturity if maturity is None else maturity,
                          self.config.dt, self.is_call,
                          self.config.poly_order, n_steps=n_live,
                          group=self._group)
        return fits

    def _jvp_stream(self, fits: PolyFit, strike, seed: int,
                    n_paths: Optional[int], with_stderr: bool, noise=None,
                    consts=None, maturity=None, n_live=None):
        """The jvp Greeks stream: each chunk's noise from its carrier (the
        generic stream's seeding, ``price``'s chunks on the "stream"
        family) or from ``noise`` = (z, dw), through ``jvp_chunk_greeks``
        (pairs at the noise level under ``antithetic``), then ``_stream``'s
        float64 totals and centred stderrs.  The policy decides time 0 on
        the whole paths, so no time-0 shortcut."""
        consts = consts or self.jvp_consts
        maturity = self.maturity if maturity is None else maturity
        anti = self.config.antithetic
        market = jvp_market(consts)

        def chunk(rows=None, carrier=None, noise=None):
            if noise is None:
                gen = pathgen_stream.stream_generator(self.device, carrier)
                noise = pathgen_stream.draw_noise(
                    consts, rows // 2 if anti else rows, gen)
            return jvp_chunk_greeks(consts, *noise, fits, strike, maturity,
                                    self.is_call, anti, n_live, market)

        shape = (6,) + tuple(strike.shape if isinstance(strike, torch.Tensor)
                             else ())
        zeros = torch.zeros(shape, dtype=torch.float32, device=self.device)
        return self._stream(chunk, seed, n_paths, noise, zeros.bool(), zeros,
                            with_stderr, carriers=True)

    def _n_paths(self, n_paths: Optional[int]) -> int:
        """``n_paths`` (default ``config.n_paths``), checked to be a
        positive multiple of chunk_paths x the mesh size (one loop step's
        paths) inside the seed scheme's ranges."""
        if n_paths is None:
            n_paths = self.config.n_paths
        per_step = self.config.chunk_paths * self.n_dev
        n_chunks, rem = divmod(n_paths, per_step)
        if rem or n_chunks < 1:
            raise ValueError(
                f"n_paths={n_paths} is not a positive multiple of chunk_paths"
                f"={self.config.chunk_paths} (x {self.n_dev} devices: "
                f"{per_step})")
        _check_pallas_chunk_range(n_chunks, self.n_dev)
        return n_paths

    def _groups(self, seed: int, n_paths: Optional[int], noise,
                whole_paths: bool = False, carriers: bool = False):
        """(n_paths, groups): each group of at most chunks_per_call chunks
        lists each chunk's arguments: the seeded rows and key of chunk i
        (the carrier (run_word, stream_index) on the generic stream, and
        the carrier alone for the QMC noise of a kernel), or ``noise[i]``
        (a (z[i], dw[i]) pair of the stream's (z, dw)).  ``whole_paths``:
        chunks of whole paths (the bounds'), from the generic stream
        wherever ``stream_consts`` are set.  ``carriers``: the generic
        stream's seeding on any family (the jvp Greeks').  Under a mesh
        the groups list this rank's chunks, n_paths / (chunk_paths x size)
        of them, at stream indices past its offset, and ``noise`` holds
        this rank's chunks."""
        chunk = self.config.chunk_paths
        stream = carriers or self.kernel_family == "stream" or (
            whole_paths and self.stream_consts is not None)
        qmc_kernel = not stream and self._fused_qmc is not None
        if noise is not None:
            noise = list(zip(*noise)) if stream else noise
            n_paths = len(noise) * chunk * self.n_dev
        n_paths = self._n_paths(n_paths)
        n_chunks = n_paths // (chunk * self.n_dev)
        _, (run, start) = _pilot_stream_keys(seed)
        start += self._shard

        def seeded(i):
            if stream:
                return {"rows": chunk, "carrier": (run, start + i)}
            if qmc_kernel:
                return {"carrier": (run, start + i)}
            return {"rows": chunk,
                    "key": pathgen_cuda._fold_words(run, start + i)}

        groups = []
        for done in range(0, n_chunks, self.config.chunks_per_call):
            stop = min(done + self.config.chunks_per_call, n_chunks)
            groups.append([seeded(i) if noise is None else {"noise": noise[i]}
                           for i in range(done, stop)])
        return n_paths, groups

    def _stream(self, chunk_sum, seed: int, n_paths: Optional[int], noise,
                ex0, v0: torch.Tensor, with_stderr: bool,
                carriers: bool = False):
        """Stream n_paths fresh paths through ``chunk_sum(**kw)`` (kw from
        ``_groups``): the per-path means of its float32 outputs, float64,
        and with ``with_stderr`` their chunk-total stderrs.  Where ``ex0``
        holds, time-0 exercise: every path shares S0, so each path is
        worth ``v0`` and every chunk total is v0 * chunk_paths exactly
        (stderr 0).  The squares are taken about the first chunk's total
        (the stderr's ``center``; any constant gives the same variance):
        float32 squares of raw totals cancel where the chunks' spread is
        small against their mean, as under ``qmc``.  ``carriers`` as
        ``_groups`` takes it.  Under a mesh each rank streams its own
        chunks about its own first total, and ``_pool_centred`` pools the
        ranks' float64 sums in one collective after the last group."""
        chunk = self.config.chunk_paths
        n_paths, groups = self._groups(seed, n_paths, noise,
                                       carriers=carriers)

        # Float32 accumulation on the device per group of chunks_per_call
        # chunks (no sync inside a group), float64 across groups.
        c0 = v0 * float(chunk)
        total = sq = 0.0
        center = None
        with span("mcop.chunks", chunks=sum(map(len, groups)),
                  groups=len(groups)):
            for group in groups:
                tot_g = sq_g = 0.0
                for kw in group:
                    c = chunk_sum(**kw)
                    if center is None:
                        center = torch.where(ex0, c0, c)
                    tot_g = tot_g + c
                    sq_g = sq_g + (c - center) ** 2
                all0 = v0 * float(len(group) * chunk)
                total = total + torch.where(ex0, all0, tot_g).double()
                sq = sq + torch.where(ex0, 0.0, sq_g).double()
            total, sq, center = _pool_centred(
                total, sq, center.double(), n_paths // (chunk * self.n_dev),
                self._group)
        with span("mcop.readback"):
            count("host_reads", 3 if with_stderr else 2)
            total, sq = total.cpu().numpy(), sq.cpu().numpy()
            if not with_stderr:
                return total / n_paths
            return (total / n_paths,
                    _chunk_stderr(total, sq, n_paths // chunk, chunk,
                                  center=center.cpu().numpy()))

    def _stream_cv(self, chunk_sum, seed: int, n_paths: Optional[int],
                   noise, ex0, p0: float, cv: CVFit, with_stderr: bool):
        """The control-variate stream (counterpart: the JAX engine's fused
        CV stream and its host correction): ``chunk_sum`` returns (payoff
        sum a, control sum c) per chunk; the corrected totals a - beta c
        accumulate centred on ``cv.center`` in float32 on the device, and
        the price is sum a / n - beta (sum c / n - s0).  Time-0 exercise
        sets a = p0 n and c = s0 n, so the correction vanishes and every
        corrected total is the same constant (stderr 0).  Under a mesh the
        ranks share the center (a pooled fit's), so their float64 sums add
        in one collective after the last group."""
        chunk = self.config.chunk_paths
        n_paths, groups = self._groups(seed, n_paths, noise)
        f32 = dict(dtype=torch.float32, device=self.device)
        beta, center = (torch.tensor(v, **f32) for v in (cv.beta, cv.center))
        p0_t, s0_t = (torch.tensor(v, **f32) for v in (p0, self.s0))
        t0 = (p0_t - beta * s0_t) * float(chunk) - center
        acc = 0.0
        with span("mcop.chunks", chunks=sum(map(len, groups)),
                  groups=len(groups)):
            for group in groups:
                n_g = len(group)
                a_g = c_g = q_g = 0.0
                for kw in group:
                    da, dc = chunk_sum(**kw)
                    t = da - beta * dc - center
                    a_g, c_g, q_g = a_g + da, c_g + dc, q_g + t * t
                n_f = torch.tensor(float(n_g * chunk), **f32)
                acc = acc + torch.stack([
                    torch.where(ex0, p0_t * n_f, a_g),
                    torch.where(ex0, s0_t * n_f, c_g),
                    torch.where(ex0, float(n_g) * t0 * t0, q_g)]).double()
            acc = psum_if(acc, self._group)
        with span("mcop.readback"):
            count("host_reads")
            amer, ctl, sq = acc.tolist()
            value = amer / n_paths - cv.beta * (ctl / n_paths - self.s0)
            if not with_stderr:
                return value
            return value, _chunk_stderr(amer - cv.beta * ctl, sq,
                                        n_paths // chunk, chunk,
                                        center=cv.center)


class StreamingPricer(_FusedStream):
    """Fit-then-stream pricer of one American option under rough Bergomi.

    Runs on ``device`` ("cuda" unless the caller asks for "cpu"); on the
    CPU the kernels' plain versions run in their place.  ``antithetic`` and
    ``control_variate`` stream through the priced kernel's forms of those
    names; the pilot and its fit are the plain ones.  On the generic path
    stream (``kernel_family`` "stream") each chunk's whole paths are
    priced by ``lsm_policy_value`` under the fitted policy of any order,
    and under ``control_variate`` beside their ``martingale_control``.
    Under ``qmc`` the pilot is the generic stream's QMC block and each
    chunk's QMC noise streams through the family's priced kernel
    (``_kernel_chunks``), or on the "stream" family through the stream's
    QMC generator, with a warning when the kernels were asked for.

    With ``mesh`` (a ``parallel.mesh.Mesh``; counterpart: the JAX
    ``mesh=``) every rank of its group, one process per device, runs this
    pricer on its own device: each prices its own chunks, and the fits and
    the chunk totals pool over the group (module docstring), so every
    method returns the same numbers on every rank."""

    def __init__(self, s0, xi, h, eta, rho, r, strike, maturity,
                 is_call: bool, config: StreamConfig, device="cuda",
                 mesh=None):
        del rho  # the price Brownian is drawn independent of the fGN noise
        family = resolve_kernel_family(config.n_steps, config.fgn_form,
                                       config.tiled_impl, config.pathgen_impl,
                                       config.poly_order)
        self.quadratic = config.policy_form == "quadratic"
        super().__init__(s0, xi, h, eta, r, maturity, is_call, config,
                         device, family, mesh)
        _check_pairing(self.quadratic, self.kernel_family, config,
                       "policy_form")
        self._warn_stream_fallback("this configuration")
        if config.qmc and family != "stream":
            self._fused_qmc = make_fused_qmc(
                config, "factored" if family == "factored"
                else kernel_fgn_form(config.fgn_form), self.device)
        self.strike = float(strike)
        self._priced_chunk = {
            "single": pathgen_cuda.priced_chunk,
            "tiled": pathgen_tiled_cuda.tiled_priced_chunk,
            "factored": pathgen_factored_cuda.factored_priced_chunk,
            "stream": None,
        }[self.kernel_family]
        self._make_rows = _fused_rows_builder(
            self.r, self.strike, self.maturity, config.dt, config.n_steps,
            self.is_call, config.policy_form)

    def _policy_fit(self, carrier):
        pilot = self._pilot(carrier)
        _, fits = lsm_fit(pilot, self.r, self.strike, self.maturity,
                          self.config.dt, self.is_call,
                          self.config.poly_order, group=self._group)
        return pilot, fits

    def fit(self, carrier) -> Union[PolyFit, CVFit]:
        """Pilot block from the (run_word, stream_index) ``carrier``
        through the family's path kernel (or the generic stream), then the
        LSM policy fit; under ``control_variate`` a CVFit with the
        control's beta and centre from the same pilot."""
        with span("mcop.fit"):
            pilot, fits = self._policy_fit(carrier)
            if not self.config.control_variate:
                return fits
            return CVFit(fits, *control_fit(
                pilot, fits, self.r, self.strike, self.maturity,
                self.config.dt, self.is_call, self.config.chunk_paths,
                self._group))

    def price(self, seed: int, n_paths: Optional[int] = None,
              with_stderr: bool = False):
        """Price on ``n_paths`` (default ``config.n_paths``) fresh paths
        from the integer ``seed``; ``with_stderr`` returns (price, stderr)
        with the stderr of the iid chunk totals, conditional on the
        pilot's fitted policy."""
        k_pilot, _ = _pilot_stream_keys(seed)
        n_paths = self._n_paths(n_paths)
        with span("mcop.price", request=seed):
            return self.price_with_fit(self.fit(k_pilot), seed, n_paths,
                                       with_stderr)

    def _stream_chunk_sum(self, fits: PolyFit, with_cv: bool):
        """The generic stream's chunk: the sum of the policy values of its
        whole paths (time-0 exercise included), and with ``with_cv`` the
        sum of their martingale controls."""
        def chunk_sum(**kw):
            paths = self._stream_paths(**kw)
            total, _ = lsm_policy_value(paths, fits, self.r, self.strike,
                                        self.maturity, self.config.dt,
                                        self.is_call)
            if not with_cv:
                return total
            return total, torch.sum(martingale_control(paths, self.r,
                                                       self.config.dt))
        return chunk_sum

    def price_with_fit(self, fits: Union[PolyFit, CVFit], seed: int = 0,
                       n_paths: Optional[int] = None,
                       with_stderr: bool = False,
                       noise: Optional[torch.Tensor] = None):
        """Stream against a given policy ``fits`` (e.g. one made elsewhere
        and converted with ``polyfit_from_numpy``; under
        ``control_variate`` a CVFit, beta and center as floats).  With
        ``noise`` the chunks read that noise instead of the seeded stream:
        [n_chunks, 2, chunk_paths, n_steps] (N, W) on the single and tiled
        families, [n_chunks, 3, chunk_paths, n_steps] (Zr, Zi, W) there
        under ``fgn_form="spectral"``, [n_chunks, 3, chunk_paths, m2] (Zr,
        Zi in the transposed storage order, W; m2 = next_pow2(n_steps)) on
        the factored family
        (see ``pathgen_factored_cuda``), (z [n_chunks, 2, chunk_paths,
        n_steps], dw [n_chunks, chunk_paths, n_steps]) on the generic
        stream (``pathgen_stream.paths_from_noise``); chunk_paths / 2 rows
        a chunk under ``antithetic``."""
        config = self.config
        if config.control_variate != isinstance(fits, CVFit):
            raise ValueError(
                "control_variate=True streams against a CVFit (fits, beta, "
                "center), any other configuration against the PolyFit "
                f"alone; got {type(fits).__name__}")
        cv = fits if config.control_variate else None
        fits = cv.fits if cv else fits
        with span("mcop.stream"):
            if self.kernel_family == "stream":
                # Time 0 is one of the policy's columns on whole paths.
                ex0 = torch.zeros((), dtype=torch.bool, device=self.device)
                p0 = 0.0
                chunk_sum = self._stream_chunk_sum(fits, cv is not None)
            else:
                with span("mcop.tables"):
                    table = self._make_rows(fits)
                    ex0, p0 = pathgen_cuda.time0_value(
                        fits, self.s0, self.strike, self.is_call)
                chunk_sum = self._kernel_chunks(functools.partial(
                    self._priced_chunk, self.consts, table, self.strike,
                    self.is_call, antithetic=config.antithetic,
                    with_cv=cv is not None, policy_form=config.policy_form))
            if cv is not None:
                out = self._stream_cv(chunk_sum, seed, n_paths, noise, ex0,
                                      p0, cv, with_stderr)
            else:
                p0_t = torch.tensor(p0, dtype=torch.float32,
                                    device=self.device)
                out = self._stream(chunk_sum, seed, n_paths, noise, ex0, p0_t,
                                   with_stderr)
        if not with_stderr:
            return float(out)
        return float(out[0]), float(out[1])

    def _require_bounds(self) -> None:
        if self.config.control_variate:
            raise ValueError(
                "duality bounds do not combine with control_variate: the "
                "lower bound is the fitted policy's plain value")

    def price_with_bounds(self, seed: int, n_paths: Optional[int] = None,
                          with_stderr: bool = False):
        """(lower, upper): a price bracket from the same streamed chunks
        (counterpart: the JAX ``price_with_bounds``).  The lower bound is
        the fitted policy's value (any stopping rule under-exercises the
        optimum), the upper bound the delta-hedge dual
        (``dual_upper_values``), its scale tuned on the pilot; the gap is
        a certificate of the price's accuracy.  Each chunk's whole paths
        come from the family's path kernel (K1, K6 or K8, its pair form
        under ``antithetic``) or the generic stream, seeded as ``price``
        seeds its chunks, so chunk i holds the paths (and pairs) of
        ``price``'s chunk i.  ``with_stderr`` returns (lower, upper,
        lower_se, upper_se) from the iid chunk totals, each centred on the
        pilot's estimate."""
        k_pilot, _ = _pilot_stream_keys(seed)
        n_paths = self._n_paths(n_paths)
        return self.bounds_with_fit(self.bounds_fit(k_pilot), seed, n_paths,
                                    with_stderr)

    def bounds_fit(self, carrier):
        """(fits, deltas, lam, cc) from the plain pilot of ``carrier``
        (counterpart: the JAX engine's ``bounds_fit_fn``): the LSM policy,
        the hedge's quartic value-to-go fits, the dual's scale (0-d
        tensor), and cc = (mean lower value, mean upper value) x
        chunk_paths, the pilot's estimates of a chunk's two totals (a
        [2] float32 tensor), on which the stderrs centre."""
        self._require_bounds()
        pilot, fits = self._policy_fit(carrier)
        args = (self.r, self.strike, self.maturity, self.config.dt,
                self.is_call)
        deltas = fit_hedge_deltas(pilot, fits, *args, group=self._group)
        lam = fit_dual_scale(pilot, deltas, *args, group=self._group)
        lv = lsm_policy_path_values(pilot, fits, *args)
        uv = dual_upper_values(pilot, deltas, lam, *args)
        cc = torch.stack([global_mean(lv, self._group),
                          global_mean(uv, self._group)]) \
            * float(self.config.chunk_paths)
        return fits, deltas, lam, cc

    def bounds_with_fit(self, fit, seed: int = 0,
                        n_paths: Optional[int] = None,
                        with_stderr: bool = False, noise=None):
        """Stream the bounds against ``fit`` = (fits, deltas, lam, cc), as
        ``bounds_fit`` returns it: each chunk's whole paths, their lower
        sum (``lsm_policy_value``) and upper sum (``dual_upper_values``)
        and the squares of both about cc, summed in float32 on the device
        per group of ``chunks_per_call`` chunks and in float64 across
        groups (and across a mesh's ranks, which share cc, in one
        collective).  ``noise`` takes the layouts of ``price_with_fit``."""
        self._require_bounds()
        fits, deltas, lam, cc = fit
        chunk = self.config.chunk_paths
        n_paths, groups = self._groups(seed, n_paths, noise,
                                       whole_paths=True)
        args = (self.r, self.strike, self.maturity, self.config.dt,
                self.is_call)
        acc = 0.0
        for group in groups:
            sums = torch.zeros(4, dtype=torch.float32, device=self.device)
            for kw in group:
                paths = self._chunk_paths(**kw)
                a = lsm_policy_value(paths, fits, *args)[0]
                b = torch.sum(dual_upper_values(paths, deltas, lam, *args))
                del paths
                sums += torch.stack([a, b, (a - cc[0]) ** 2,
                                     (b - cc[1]) ** 2])
            acc = acc + sums.double()
        lo, up, lsq, usq = psum_if(acc, self._group).tolist()
        if not with_stderr:
            return lo / n_paths, up / n_paths
        m = n_paths // chunk
        c_lo, c_up = cc.double().cpu().tolist()
        return (lo / n_paths, up / n_paths,
                float(_chunk_stderr(lo, lsq, m, chunk, center=c_lo)),
                float(_chunk_stderr(up, usq, m, chunk, center=c_up)))

    def price_and_greeks(self, seed: int, n_paths: Optional[int] = None,
                         with_stderr: bool = False):
        """(price, delta, vega_xi, vega_eta, rho_rate, vega_h)
        (``GREEK_ORDER``) on ``n_paths`` fresh paths from ``seed``:
        pathwise forward tangents with the exercise policy fixed from a
        pilot fit (counterpart of the JAX method).  Where JAX keeps its
        fused Greeks (``_kernel_greeks``: single tile, chol, boundary
        policy, not qmc) they stream through K3 (its pair form under
        ``antithetic``) with the same pilot and fit as ``price``; time-0
        exercise leaves (p0, +-1, 0, 0, 0, 0).  Everywhere else (past 365
        steps, the generic stream, spectral, quadratic, qmc) they are the
        jvp Greeks stream (``jvp_chunk_greeks``) on the matmul generic
        stream, its pilot from the same carrier as ``price``'s (on the
        "stream" family ``price``'s own pilot and chunks), paired at the
        noise level under ``antithetic`` and on the QMC generator under
        ``qmc``.  ``with_stderr`` returns (greeks, stderrs), each a tuple
        of six floats.  Under ``control_variate`` these are the plain
        Greeks, price lane included, as in the JAX engine."""
        k_pilot, _ = _pilot_stream_keys(seed)
        n_paths = self._n_paths(n_paths)
        return self.greeks_with_fit(self.greeks_fit(k_pilot), seed, n_paths,
                                    with_stderr)

    def greeks_fit(self, carrier) -> PolyFit:
        """The policy ``price_and_greeks`` streams under: ``price``'s pilot
        fit where K3 runs, else the jvp generator's pilot fit."""
        if self._kernel_greeks():
            return self._policy_fit(carrier)[1]
        return self._stream_fit(carrier, self.strike)

    def greeks_with_fit(self, fits: Union[PolyFit, CVFit], seed: int = 0,
                        n_paths: Optional[int] = None,
                        with_stderr: bool = False, noise=None):
        """``price_and_greeks`` against a given policy ``fits`` (a CVFit's
        beta and center are not read); ``noise`` = (z [n_chunks, 2, drawn,
        n], dw [n_chunks, drawn, n]) feeds the jvp stream's chunks (not
        K3's)."""
        if isinstance(fits, CVFit):
            fits = fits.fits
        if self._kernel_greeks():
            if noise is not None:
                raise ValueError("noise feeds the jvp Greeks stream only")
            return self._k3_greeks(fits, seed, n_paths, with_stderr)
        out = self._jvp_stream(fits, self.strike, seed, n_paths,
                               with_stderr, noise)
        if not with_stderr:
            return tuple(float(v) for v in out)
        return (tuple(float(v) for v in out[0]),
                tuple(float(v) for v in out[1]))

    def _k3_greeks(self, fits: PolyFit, seed: int, n_paths: Optional[int],
                   with_stderr: bool):
        table = self._make_rows(fits)
        ex0, p0 = pathgen_cuda.time0_value(fits, self.s0, self.strike,
                                           self.is_call)
        v0 = torch.tensor([p0, 1.0 if self.is_call else -1.0, 0, 0, 0, 0],
                          dtype=torch.float32, device=self.device)
        gconsts = self.greeks_consts
        out = self._stream(
            lambda **kw: greeks_cuda.greeks_chunk(
                self.consts, gconsts, table, self.strike, self.is_call,
                antithetic=self.config.antithetic, **kw),
            seed, n_paths, None, ex0, v0, with_stderr)
        if not with_stderr:
            return tuple(float(v) for v in out)
        return (tuple(float(v) for v in out[0]),
                tuple(float(v) for v in out[1]))


def chain_family(config: StreamConfig) -> str:
    """The family a strike strip runs on (counterpart: the JAX chain
    pricer's choice of its fused chain kernel or its XLA generator): the
    generic stream under ``pathgen_impl="xla"``, a ``poly_order`` other
    than 2, or past K5's horizon (``chain_cuda.MAX_CHAIN_STEPS``), else
    the single-strike pricer's pilot family, with K5 streaming in that
    family's fGN form (``kernel_fgn_form``)."""
    family = resolve_kernel_family(config.n_steps, config.fgn_form,
                                   config.tiled_impl, config.pathgen_impl,
                                   config.poly_order)
    if not chain_cuda.supports(config.n_steps,
                               kernel_fgn_form(config.fgn_form, family)):
        return "stream"
    return family


_MARKET_KEYS = ("s0", "xi", "r", "eta")


class _Call(NamedTuple):
    """What one call of a bucketed chain pricer prices against: the
    stream's constants at the call's market (the pricer's own without
    ``traced_market``), the maturity and the live horizon (None on a
    non-bucketed pricer)."""

    consts: pathgen_stream.StreamConsts
    maturity: float
    n_live: Optional[int]


class StreamingChainPricer(_FusedStream):
    """Price a strike strip of one expiry on shared paths (counterpart of
    the JAX ``StreamingChainPricer``).

    The pilot comes from the single-strike pricer's path kernel (K1 up to
    365 steps; past them K6 on the slab, or K8 on the factored family,
    which ``fgn_form="spectral"`` and ``tiled_impl="factored"`` take)
    with the carriers ``StreamingPricer`` uses, so a strike of the strip
    and a single-strike pricer with the same seed fit on the same pilot,
    and stream the same paths up to 365 steps and on the slab.  K5 runs
    in the fGN form of the pilot's law: on the factored family it keeps
    its own spectral constants (``chain_consts``) beside K8's.  One
    backward pass fits the whole strip (``lsm_fit`` with a
    strike tensor), and each chunk runs K5 once per 32 strikes, every
    strike swept against the same path block (K5's pair form under
    ``antithetic``).  ``price_and_greeks`` runs K4 on the same stream
    where JAX keeps its fused chain Greeks, and the jvp Greeks stream
    (``jvp_chunk_greeks``, per strike) everywhere else.
    K5 takes horizons up to 512 steps (the JAX chain kernel's cap); past
    it, under ``pathgen_impl="xla"`` and for a ``poly_order`` other than
    2 the whole pricer takes the generic path stream (``chain_family``):
    its pilot, one batched fit, and each strike's ``lsm_policy_value`` on
    every chunk's whole paths, plain or paired.  Under ``qmc`` the pilot
    is the generic stream's QMC block and each chunk's QMC noise streams
    through K5's noise-in entry; past K5 the generic stream's QMC
    generator takes the strip, with a warning (JAX's chain falls back
    silently).

    ``bucketed=True`` (the serving pricer) takes the generic stream at any
    configuration and treats ``config.n_steps`` as a step bucket:
    ``price(..., n_steps_live=, maturity=)`` prices any contract of at
    most that many steps on paths flat past its horizon, its fit and
    policy padded as JAX's.  ``traced_market=True`` (``traced_h`` is its
    alias; it needs ``bucketed``) makes the whole market a per-call input
    too (``market=`` s0, xi, r, eta and ``hurst=``): H rebuilds the
    synthesis's matrices on the device (``pathgen_stream.with_market``),
    except at the pricer's own H, which keeps the host build, so a quote
    at the construction market prices as the non-bucketed stream does.
    Its ``price_and_greeks`` is the jvp over that per-call market, on the
    fits of ``price``; a plain bucketed pricer has no Greeks, as in JAX.
    Runs on ``device`` ("cuda" unless the caller asks for "cpu").  With
    ``mesh`` every rank prices its own chunks of each method, bucketed and
    traced-market calls included, on fits pooled over the mesh's group,
    as ``StreamingPricer`` does."""

    def __init__(self, s0, xi, h, eta, rho, r, strikes, maturity,
                 is_call: bool, config: StreamConfig, device="cuda",
                 bucketed: bool = False, traced_h: bool = False,
                 traced_market: bool = False, mesh=None):
        del rho  # the price Brownian is drawn independent of the fGN noise
        traced_market = bool(traced_market or traced_h)
        if traced_market and not bucketed:
            raise ValueError("traced_market/traced_h require bucketed=True "
                             "(the serving configuration)")
        if config.control_variate:
            raise ValueError(
                "control_variate is not supported by the chain pricer: the "
                "chain kernel emits per-strike payoff sums only (no control "
                "sums); use StreamingPricer per strike for CV estimates.")
        if traced_market and pathgen_stream.resolve_fgn_impl(
                config.fgn_impl) != "matmul":
            raise ValueError("traced_h requires the matmul fGN synthesis")
        self._bucketed = bool(bucketed)
        self._traced_market = traced_market
        family = "stream" if bucketed else chain_family(config)
        super().__init__(s0, xi, h, eta, r, maturity, is_call, config,
                         device, family, mesh)
        self.quadratic = config.chain_policy_form == "quadratic"
        _check_pairing(self.quadratic, family, config, "chain_policy_form")
        self.strikes = self._strip(strikes)
        self._market_defaults = dict(s0=self.s0, xi=self._xi, r=self.r,
                                     eta=self._eta, hurst=self._h)
        self._hurst_consts = {}
        # K5's constants: the pilot family's (K1's, K6's), or on the
        # factored family the spectral single-tile constants of the same
        # law (K8's FactoredConsts carry no dense matrices), in the
        # configuration's fGN input dtype.
        self.chain_consts = self.consts
        if family == "factored":
            self.chain_consts = pathgen_cuda.make_path_consts(
                s0, xi, h, eta, r, config.n_steps, config.dt, self.device,
                fgn_form="spectral", fgn_dtype=config.fgn_matmul_dtype)
        if bucketed:
            # Serving chains ride the generic stream by construction, as
            # JAX's ride its XLA generator: no warning.
            return
        # JAX's chain falls back to its XLA generator silently here.
        self._warn_stream_fallback("a strike strip")
        if config.qmc and family != "stream":
            self._fused_qmc = make_fused_qmc(
                config, self.chain_consts.fgn_form, self.device)

    def _strip(self, strikes) -> torch.Tensor:
        strip = torch.as_tensor(strikes, dtype=torch.float32).reshape(-1)
        if strip.numel() < 1:
            raise ValueError("the strike strip is empty")
        if hasattr(self, "strikes") and strip.shape != self.strikes.shape:
            raise ValueError(
                f"strike strip length {strip.numel()} != the pricer's "
                f"{self.strikes.numel()}; build a new pricer")
        return strip.to(self.device)

    def _call(self, n_steps_live, maturity, hurst, market,
              greeks: bool = False) -> Optional[_Call]:
        """The per-call inputs checked as the JAX methods check them, then
        the call's ``_Call`` (None on a non-bucketed pricer)."""
        n = self.config.n_steps
        if greeks and self._bucketed and not self._traced_market:
            raise ValueError(
                "price_and_greeks is not available on a plain-bucketed "
                "chain pricer (its market is fixed at construction); use a "
                "non-bucketed StreamingChainPricer, or bucketed=True with "
                "traced_market=True (the serving configuration)")
        if greeks and not self._bucketed and (
                n_steps_live is not None or maturity is not None
                or hurst is not None or market is not None):
            raise ValueError(
                "n_steps_live/maturity/market/hurst are per-call inputs "
                "only for a traced-market pricer")
        if self._bucketed:
            if n_steps_live is None:
                raise ValueError("bucketed pricer needs n_steps_live")
            if not 1 <= n_steps_live <= n:
                raise ValueError(f"n_steps_live={n_steps_live} outside [1, "
                                 f"{n}] bucket")
        elif n_steps_live is not None or maturity is not None:
            raise ValueError(
                "n_steps_live/maturity are per-call inputs only for a "
                "bucketed pricer (construct with bucketed=True)")
        if (hurst is not None or market is not None) \
                and not self._traced_market:
            raise ValueError("hurst/market are per-call inputs only for a "
                             "traced-market pricer (construct with "
                             "traced_market=True)")
        if market is not None:
            bad = set(market) - set(_MARKET_KEYS)
            if bad:
                raise ValueError(f"unknown market override keys: {bad} "
                                 "(use s0/xi/r/eta; hurst= for H)")
        if not self._bucketed:
            return None
        consts = self.stream_consts
        if self._traced_market:
            m = dict(self._market_defaults)
            m.update(market or {})
            if hurst is not None:
                m["hurst"] = hurst
            consts = pathgen_stream.with_market(
                self._consts_at(float(m["hurst"])),
                **{k: m[k] for k in _MARKET_KEYS})
        return _Call(consts, self.maturity if maturity is None
                     else float(maturity), int(n_steps_live))

    def _consts_at(self, h: float) -> pathgen_stream.StreamConsts:
        """The stream's constants with the synthesis at H = ``h``: the
        host build at the pricer's own H, else the device build, kept for
        the last few H a server quotes."""
        if h == self.stream_consts.h:
            return self.stream_consts
        if h not in self._hurst_consts:
            if len(self._hurst_consts) >= 4:
                self._hurst_consts.pop(next(iter(self._hurst_consts)))
            self._hurst_consts[h] = pathgen_stream.with_market(
                self.stream_consts, h=h)
        return self._hurst_consts[h]

    def fit(self, carrier, strikes=None, call: Optional[_Call] = None
            ) -> PolyFit:
        """The pilot from ``carrier`` (K1, K6 or the generic stream), then
        one LSM backward pass over the strip (default the pricer's): fits
        with a leading [K] axis.  ``call`` (a bucketed pricer's) fits on
        the call's market, maturity and live horizon."""
        strip = self.strikes if strikes is None else self._strip(strikes)
        with span("mcop.fit"):
            if call is not None:
                return self._stream_fit(carrier, strip, call.consts,
                                        call.maturity, call.n_live)
            _, fits = lsm_fit(self._pilot(carrier), self.r, strip,
                              self.maturity, self.config.dt, self.is_call,
                              self.config.poly_order, group=self._group)
            return fits

    def _tables(self, fits: PolyFit, strip: torch.Tensor) -> torch.Tensor:
        """The strip's [K, 8, s_pad] tables K5 reads: S-space
        ``boundary_rows``, or ``policy_rows`` under
        ``chain_policy_form="quadratic"``."""
        rows = (pathgen_cuda.policy_rows if self.quadratic
                else pathgen_cuda.boundary_rows)
        return rows(fits, self.r, strip, self.maturity, self.config.dt,
                    self.config.n_steps, self.is_call).contiguous()

    def price(self, seed: int, n_paths: Optional[int] = None,
              strikes=None, with_stderr: bool = False, *,
              n_steps_live: Optional[int] = None,
              maturity: Optional[float] = None,
              hurst: Optional[float] = None, market=None):
        """[K] prices (numpy float64) of the strip on ``n_paths`` fresh
        paths from ``seed``; ``strikes`` prices a fresh strip of the same
        length without a rebuild.  ``with_stderr`` returns (prices,
        stderrs), each per strike, conditional on the pilot's fits.  A
        bucketed pricer takes ``n_steps_live`` (required) and
        ``maturity``, a traced-market one also ``market`` (a dict of
        s0/xi/r/eta) and ``hurst``, as the JAX method does."""
        call = self._call(n_steps_live, maturity, hurst, market)
        strip = self.strikes if strikes is None else self._strip(strikes)
        k_pilot, _ = _pilot_stream_keys(seed)
        n_paths = self._n_paths(n_paths)
        with span("mcop.price", request=seed):
            return self.price_with_fit(self.fit(k_pilot, strip, call), seed,
                                       n_paths, strip, with_stderr,
                                       call=call)

    def _stream_chunk_sums(self, fits: PolyFit, strip: torch.Tensor,
                           call: Optional[_Call] = None):
        """The generic stream's chunk: [K] sums of each strike's policy
        values on the chunk's whole paths, one strike at a time, at the
        call's market, maturity and live horizon where ``call`` is given."""
        ks = strip.tolist()
        consts = call.consts if call else self.stream_consts
        maturity = call.maturity if call else self.maturity
        n_live = call.n_live if call else None

        def chunk_sums(**kw):
            paths = self._stream_paths(**kw, consts=consts, n_live=n_live)
            return torch.stack([
                lsm_policy_value(paths, PolyFit(*(f[k] for f in fits)),
                                 consts.r, strike, maturity,
                                 self.config.dt, self.is_call, n_live)[0]
                for k, strike in enumerate(ks)])
        return chunk_sums

    def price_with_fit(self, fits: PolyFit, seed: int = 0,
                       n_paths: Optional[int] = None, strikes=None,
                       with_stderr: bool = False,
                       noise: Optional[torch.Tensor] = None,
                       call: Optional[_Call] = None):
        """Stream the strip against given fits (leading [K] axis), e.g.
        converted from the JAX package with ``polyfit_from_numpy``.  With
        ``noise`` the chunks read that noise instead of the seeded stream:
        [n_chunks, 2 or 3, chunk_paths, n_steps] on K5 (3 planes Zr, Zi,
        W in the spectral form, ``chain_consts.n_planes``), (z, dw) as
        ``StreamingPricer.price_with_fit`` takes them on the generic
        stream; chunk_paths / 2 rows a chunk under ``antithetic``.
        ``call``: a bucketed pricer's per-call inputs (``_call``)."""
        strip = self.strikes if strikes is None else self._strip(strikes)
        with span("mcop.stream"):
            if self.kernel_family == "stream":
                ex0 = torch.zeros(strip.shape, dtype=torch.bool,
                                  device=self.device)
                return self._stream(
                    self._stream_chunk_sums(fits, strip, call), seed,
                    n_paths, noise, ex0, torch.zeros_like(strip),
                    with_stderr)
            with span("mcop.tables"):
                tables = self._tables(fits, strip)
                ex0, p0 = pathgen_cuda.time0_value(fits, self.s0, strip,
                                                   self.is_call)
            return self._stream(
                self._kernel_chunks(functools.partial(
                    chain_cuda.priced_chain, self.chain_consts, tables,
                    self.is_call, antithetic=self.config.antithetic,
                    policy_form=self.config.chain_policy_form)),
                seed, n_paths, noise, ex0, p0, with_stderr)

    def price_and_greeks(self, seed: int, n_paths: Optional[int] = None,
                         strikes=None, with_stderr: bool = False, *,
                         n_steps_live: Optional[int] = None,
                         maturity: Optional[float] = None,
                         hurst: Optional[float] = None, market=None):
        """[6, K] (numpy float64, rows in ``GREEK_ORDER``) per-strike price
        and Greeks of the strip; ``with_stderr`` returns (values,
        stderrs).  Where JAX keeps its fused chain Greeks
        (``_kernel_greeks``) through K4 (its pair form under
        ``antithetic``), with the fits of the same pilot as ``price``;
        time-0 exercise leaves (p0, +-1, 0, 0, 0, 0) for that strike.
        Everywhere else the jvp Greeks stream, per strike, on the matmul
        generic stream; on a traced-market pricer over the call's market,
        maturity and horizon on the fits ``price`` takes (the serving
        Greeks).  A plain bucketed pricer raises ValueError, as JAX's."""
        call = self._call(n_steps_live, maturity, hurst, market, True)
        strip = self.strikes if strikes is None else self._strip(strikes)
        k_pilot, _ = _pilot_stream_keys(seed)
        n_paths = self._n_paths(n_paths)
        if call is not None:
            return self._jvp_stream(
                self.fit(k_pilot, strip, call), strip, seed, n_paths,
                with_stderr, consts=call.consts, maturity=call.maturity,
                n_live=call.n_live)
        return self.greeks_with_fit(self.greeks_fit(k_pilot, strip), seed,
                                    n_paths, strip, with_stderr)

    def greeks_fit(self, carrier, strikes=None) -> PolyFit:
        """The fits a non-bucketed ``price_and_greeks`` streams under:
        ``price``'s where K4 runs, else the jvp generator's pilot fit."""
        strip = self.strikes if strikes is None else self._strip(strikes)
        if self._kernel_greeks():
            return self.fit(carrier, strip)
        return self._stream_fit(carrier, strip)

    def greeks_with_fit(self, fits: PolyFit, seed: int = 0,
                        n_paths: Optional[int] = None, strikes=None,
                        with_stderr: bool = False, noise=None):
        """``price_and_greeks`` against given fits (leading [K] axis) on a
        non-bucketed pricer; ``noise`` = (z, dw) feeds the jvp stream's
        chunks (not K4's)."""
        strip = self.strikes if strikes is None else self._strip(strikes)
        if not self._kernel_greeks():
            return self._jvp_stream(fits, strip, seed, n_paths, with_stderr,
                                    noise)
        if noise is not None:
            raise ValueError("noise feeds the jvp Greeks stream only")
        tables = pathgen_cuda.log_boundary_rows(
            self._tables(fits, strip)).contiguous()
        ex0, p0 = pathgen_cuda.time0_value(fits, self.s0, strip,
                                           self.is_call)
        zeros = torch.zeros_like(p0)
        sgn = torch.full_like(p0, 1.0 if self.is_call else -1.0)
        v0 = torch.stack([p0, sgn, zeros, zeros, zeros, zeros])
        gconsts = self.greeks_consts
        return self._stream(
            lambda **kw: greeks_cuda.chain_greeks_chunk(
                self.consts, gconsts, tables, self.is_call,
                antithetic=self.config.antithetic, **kw),
            seed, n_paths, None, ex0, v0, with_stderr)
