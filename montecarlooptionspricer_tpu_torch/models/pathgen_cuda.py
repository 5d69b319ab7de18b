"""Fused rough-Bergomi path kernels for Hopper, their plain PyTorch
versions, and the policy tables they read.

Counterpart: ``montecarlooptionspricer_tpu/models/pathgen_pallas.py``.
Two kernels live in ``csrc/pathgen.cu``:

* K1 ``pathgen`` (replaces ``_pathgen_kernel`` / ``_pathgen_kernel_noise_in``):
  noise -> fGN ``X = N @ (0.5 Lt)`` -> ``sv = exp(X + vd)`` -> Euler
  log-recursion -> ``[rows, n_steps + 1]`` prices with S0 in column 0.  Its
  ``antithetic`` form (the whole-path pair body, ``_euler_from_noise`` with
  ``_logpaths_from_x_anti``) reads rows / 2 rows of noise and writes the
  drawn rows' paths to rows [0, rows / 2) and their partners' (-N, -W) to
  [rows / 2, rows): ``[X; -X]`` of the unpaired form (``pair_planes``).
  JAX lays each pair out inside each Pallas block instead; whole-path
  consumers sum over rows, so the order reaches only the tests.
* K2 ``priced_chunk`` (replaces ``_priced_kernel`` /
  ``_priced_kernel_noise_in``): the same generation kept on chip, each
  path stopped at its first exercising step, one partial payoff sum per
  CUDA block.  Under ``policy_form="boundary"`` (JAX's "log_boundary") a
  step exercises when the log price lies inside its log exercise interval
  (``log_boundary_rows``); under ``policy_form="quadratic"`` (JAX's
  ``_policy_value:277``) when the payoff is in the money and at least the
  fitted quadratic continuation, evaluated per cell on S = exp(log S)
  (``policy_rows``, ``quadratic_stops``).  Its ``antithetic`` and
  ``with_cv`` forms (``FORMS``) are the JAX maker's: paired noise carries
  half the rows, each drawn row priced as (N, W) and (-N, -W)
  (``pair_planes``), and the control-variate forms also return the
  chunk's martingale-control sum ``cv_disc * sum_p S_{p,n}``, cv_disc =
  exp(-r n dt).  The quadratic policy has the plain and CV forms
  (``QUAD_FORMS``); JAX pairs only the boundary bodies.

Both run in two fGN forms, carried by the ``PathConsts`` they are given
(``make_path_consts(fgn_form=)``): "chol", one noise plane N and the
upper-triangular Cholesky factor, ``X = N @ Lt'``; and "spectral"
(counterpart: ``fgn_form="spectral"``, ``_fgn_x:142``), three planes (Zr,
Zi, W) and the reference's dense two-matrix map ``X = Zr @ Cr' - Zi @ Ci'``
(``Cr' = 0.5 Cr``, ``Ci' = 0.5 Ci``, ``engine._fgn_matrices_np``).  The
two are the same Gaussian law.  Noise is [2, rows, n_steps] (N, W) or
[3, rows, n_steps] (Zr, Zi, W).  The launch counters count each form
apart (``form_name``: "spectral", "spectral/anti", ...).

Both fGN forms also run with bf16 fGN inputs (``make_path_consts(
fgn_dtype="bfloat16")``; counterpart: ``StreamConfig.fgn_matmul_dtype`` and
the ``fgn_dtype`` of the JAX makers, ``_fgn_consts:1359`` and
``_fgn_x:142``): ``lt_half`` (or ``cr_half`` and ``ci_half``) is a
torch.bfloat16 matrix, bit-equal to JAX's bf16 one (the float64 matrix
rounded to bf16, then halved, which is exact), and the kernels round the
noise planes they multiply (N, or Zr and Zi) to bf16 (nearest even) and
sum the products on the tensor cores in float32.  The plain versions
round them likewise and take the float32 products of the bf16 values.
The launch counters put "bf16/" ahead of the float32 form's name:
"bf16", "bf16/anti", ..., "bf16/spectral/quad/cv" (``form_name``).  The
strike-chain kernel K5 (``chain_cuda``) and the Greeks kernels K3/K4
(``greeks_cuda``, with ``make_greeks_consts(fgn_dtype="bfloat16")``'s
bf16 dLt') run the bf16 form likewise.

Each kernel has a seeded entry (Philox4x32-10 written into the kernel) and
a noise-in entry.  The wrappers run the plain versions for tensors on the
CPU and launch the kernel for tensors on a CUDA device; nothing falls back.

Random stream layout (fixed, written once in ``csrc/philox.cuh`` for these
kernels and the step-tiled ones of ``pathgen_tiled_cuda``;
``philox_normals_ref`` reproduces it):
key = (fold(run_word, stream_index), 0); for path p of the chunk (global
row index, 0-based) and step pair j, counter = (p, j, 0, 0) gives four
words x0..x3.  Step 2j takes the Box-Muller pair of (x0, x1), step 2j+1
that of (x2, x3): u = (bits >> 8) * 2^-24 + 2^-25, radius
sqrt(-2 log u_a), angle 2 pi u_b, N = radius cos, W = radius sin.  A
paired chunk of ``rows`` paths draws rows / 2 rows: drawn row q is the
stream's row q, in K1's pair form as in K2's, so one key gives both the
same pairs.  The spectral form's Zr and W are that N and W; its Zi of
steps 4q .. 4q+3 comes from counter (p, q, 3, 0), the cos and sin of the
pair of (x0, x1), then of (x2, x3) (``philox_spectral_normals_ref``), a
third word no other stream uses, so one key gives the chol and spectral
bodies the same W.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch

LANE = 128
TWO_PI = 2.0 * math.pi
_U32 = 0xFFFFFFFF


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


# ---------------------------------------------------------------------------
# Seed words and the counter-based generator.

_MIX1 = 0x9E3779B1  # golden-ratio odd constant
_MIX2 = 0x85EBCA77  # murmur3-style odd constant


def _fold_words(a: int, b: int) -> int:
    """Mix the (run_word, stream_index) carrier into one uint32 key word.
    For a fixed run word, b -> h is a bijection (xor, odd multiply,
    xorshift mod 2^32), so distinct stream indices never collide.  The
    bits equal the JAX package's int32 ``_fold_words``."""
    h = ((a * _MIX1) & _U32) ^ (b & _U32)
    h = (h * _MIX2) & _U32
    return h ^ (h >> 13)


def _uniform_open(bits: torch.Tensor) -> torch.Tensor:
    """uint32 words (held in int64) -> float32 uniforms in (0, 1]:
    (bits >> 8) * 2^-24 + 2^-25."""
    u = (bits >> 8).to(torch.int32).to(torch.float32) * (1.0 / (1 << 24))
    return u + (0.5 / (1 << 24))


_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85


def _mulhilo(a: torch.Tensor, m: int):
    """(hi, lo) 32-bit words of a * m, a < 2^32 in int64: the product is
    split at 16 bits of m so no intermediate passes 2^49."""
    lo_p = a * (m & 0xFFFF)
    hi_p = a * (m >> 16)
    lo = (((hi_p & 0xFFFF) << 16) + lo_p) & _U32
    hi = (hi_p + (lo_p >> 16)) >> 16
    return hi, lo


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 (Random123) on int64 tensors holding uint32 words."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, _PHILOX_M0)
        hi1, lo1 = _mulhilo(c2, _PHILOX_M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W0) & _U32
        k1 = (k1 + _PHILOX_W1) & _U32
    return c0, c1, c2, c3


def _box_muller(ba, bb):
    rad = torch.sqrt(-2.0 * torch.log(_uniform_open(ba)))
    ang = TWO_PI * _uniform_open(bb)
    return rad * torch.cos(ang), rad * torch.sin(ang)


def philox_normals_ref(key: int, rows: int, n_steps: int, device="cpu",
                       row0: int = 0) -> torch.Tensor:
    """[2, rows, n_steps] float32 (N, W) planes of the seeded kernels'
    stream (module docstring) for chunk rows row0 .. row0 + rows - 1."""
    pairs = (n_steps + 1) // 2
    p = torch.arange(row0, row0 + rows, dtype=torch.int64,
                     device=device)[:, None].expand(rows, pairs)
    j = torch.arange(pairs, dtype=torch.int64,
                     device=device)[None, :].expand(rows, pairs)
    zero = torch.zeros_like(p)
    x0, x1, x2, x3 = philox4x32_10(p, j, zero, zero, key & _U32, 0)
    n_even, w_even = _box_muller(x0, x1)
    n_odd, w_odd = _box_muller(x2, x3)
    n = torch.stack([n_even, n_odd], dim=-1).reshape(rows, 2 * pairs)
    w = torch.stack([w_even, w_odd], dim=-1).reshape(rows, 2 * pairs)
    return torch.stack([n[:, :n_steps], w[:, :n_steps]])


SPECTRAL_ZI_WORD = 3   # third counter word of the spectral form's Zi


def normal_quads_ref(key: int, rows: int, n_steps: int, word: int,
                     device="cpu", row0: int = 0) -> torch.Tensor:
    """[rows, n_steps] float32 normals of the stream ``normal_quad`` of
    csrc/philox.cuh: counter (row, q, word, 0) gives steps 4q .. 4q+3, the
    cos and sin of the Box-Muller pair of (x0, x1), then of (x2, x3)."""
    quads = (n_steps + 3) // 4
    p = torch.arange(row0, row0 + rows, dtype=torch.int64,
                     device=device)[:, None].expand(rows, quads)
    q = torch.arange(quads, dtype=torch.int64,
                     device=device)[None, :].expand(rows, quads)
    x0, x1, x2, x3 = philox4x32_10(p, q, torch.full_like(p, word),
                                   torch.zeros_like(p), key & _U32, 0)
    c_a, s_a = _box_muller(x0, x1)
    c_b, s_b = _box_muller(x2, x3)
    return torch.stack([c_a, s_a, c_b, s_b], -1).reshape(
        rows, 4 * quads)[:, :n_steps]


def philox_spectral_normals_ref(key: int, rows: int, n_steps: int,
                                device="cpu", row0: int = 0) -> torch.Tensor:
    """[3, rows, n_steps] float32 (Zr, Zi, W) planes of the spectral form's
    seeded stream (module docstring): Zr and W the chol stream's N and W,
    Zi from the third counter word SPECTRAL_ZI_WORD."""
    nw = philox_normals_ref(key, rows, n_steps, device, row0)
    zi = normal_quads_ref(key, rows, n_steps, SPECTRAL_ZI_WORD, device, row0)
    return torch.stack([nw[0], zi, nw[1]])


def normals_ref(consts, key: int, rows: int, device="cpu",
                row0: int = 0) -> torch.Tensor:
    """The seeded kernels' noise of ``consts``' fGN form: [2, rows, n] (N,
    W) or, spectral, [3, rows, n] (Zr, Zi, W)."""
    make = (philox_spectral_normals_ref if consts.spectral
            else philox_normals_ref)
    return make(key, rows, consts.n_steps, device, row0)


# ---------------------------------------------------------------------------
# The card's shared-memory model (mirrors csrc/pathgen.cu).

SMEM_LIMIT = 232_448        # dynamic shared memory one H100 block may use
TILE_COLS = 64              # step columns per fGN tile
TILE_K = 32                 # rows of Lt' staged per inner pass
BLOCK_CHOICES = (64, 32, 16)
PAIRED_BLOCK_CHOICES = (128, 64, 32)   # pair members; half of them drawn

# The estimator forms of the priced kernels K2, K7 and K9: the launch
# counters' keys (the chol form's; SPECTRAL prefixes the spectral form's).
FORMS = ("plain", "anti", "cv", "anti+cv")
# Their forms under the quadratic exercise policy, which JAX does not pair.
QUAD_FORMS = ("quad", "quad/cv")
# The forms of the whole-path kernels K1, K6 and K8.
PATH_FORMS = FORMS[:2]
SPECTRAL = "spectral"
FGN_FORMS = ("chol", SPECTRAL)
# The fGN product's input dtypes (StreamConfig.fgn_matmul_dtype), and the
# launch counters' prefix of the bf16 forms.
FGN_DTYPES = ("float32", "bfloat16")
BF16 = "bf16"
# The exercise-policy forms of the priced kernels (StreamConfig.policy_form):
# log-space exercise intervals, or the fitted quadratic per cell.
POLICY_FORMS = ("boundary", "quadratic")


def _prefixed(prefix: str, form: str) -> str:
    return prefix if form == "plain" else f"{prefix}/{form}"


def _spectral_name(form: str) -> str:
    return _prefixed(SPECTRAL, form)


def form_name(antithetic: bool, with_cv: bool = False,
              spectral: bool = False, quadratic: bool = False,
              bf16: bool = False) -> str:
    """A launch counter's key: "plain", "anti", "cv" or "anti+cv", "quad"
    or "quad/cv" under the quadratic policy, "spectral",
    "spectral/anti", "spectral/quad", ... for the spectral fGN form, and
    "bf16" ahead of either for the bf16 fGN-input form: "bf16",
    "bf16/anti", ..., "bf16/spectral/quad/cv"."""
    if quadratic:
        name = QUAD_FORMS[int(bool(with_cv))]
    else:
        name = FORMS[int(bool(antithetic)) + 2 * int(bool(with_cv))]
    if spectral:
        name = _spectral_name(name)
    return _prefixed(BF16, name) if bf16 else name


def check_policy(policy_form: str, antithetic: bool = False) -> bool:
    """Whether ``policy_form`` ("boundary" or "quadratic") is the
    quadratic one; ValueError for another name, or for the quadratic
    policy with ``antithetic`` (JAX's makers refuse it too: only the
    boundary bodies pair)."""
    if policy_form not in POLICY_FORMS:
        raise ValueError(f"policy_form must be one of {POLICY_FORMS}, got "
                         f"{policy_form!r}")
    quadratic = policy_form == "quadratic"
    if quadratic and antithetic:
        raise ValueError("antithetic requires policy_form='boundary' (the "
                         "quadratic policy has no pair form)")
    return quadratic


def bf16_names(forms) -> list:
    """The bf16 fGN-input form's counter keys of ``forms``."""
    return [_prefixed(BF16, f) for f in forms]


def new_form_counts(forms=FORMS, bf16: bool = False) -> dict:
    """Zeroed launch counters of ``forms`` in both fGN forms, and with
    ``bf16`` of the same in the bf16 fGN-input form."""
    names = [*forms, *map(_spectral_name, forms)]
    return dict.fromkeys([*names, *(bf16_names(names) if bf16 else ())], 0)


TILE_KB = TILE_K + 8   # bf16 row stride of a staged factor tile


def block_smem_bytes(n_steps: int, block_paths: int, n_products: int = 1,
                     extra: int = 0, spectral: bool = False,
                     bf16: bool = False, w_plane: bool = True,
                     tile_k: int = TILE_K) -> int:
    """Shared memory of one single-tile CUDA block (``block_smem_bytes`` of
    csrc/fgn_tile.cuh, which K1-K5 share): the N and W planes (row stride
    n_steps rounded up to odd, so rows fall on distinct banks; under
    ``spectral`` Zr, Zi and W; no W plane without ``w_plane``, as K5 and
    K3/K4 draw W per tile), per fGN product an X tile (stride
    TILE_COLS + 1), the staged factor tiles (one per product, or Cr' and
    Ci' under ``spectral``, ``tile_k`` rows each) and ``extra`` floats.
    Under ``bf16`` the planes multiplied (N, or Zr and Zi) are bf16 with
    row stride n_steps rounded up to 16 plus 8, and each staged tile is
    bf16 [TILE_COLS][TILE_KB]."""
    ld = n_steps | 1
    planes = 2 if spectral else 1        # planes multiplied
    tiles = 2 if spectral else n_products  # factor tiles staged
    plane = (block_paths * (_round_up(n_steps, 16) + 8) // 2 if bf16
             else block_paths * ld)
    staged = tiles * (TILE_COLS * TILE_KB // 2 if bf16
                      else tile_k * TILE_COLS)
    floats = (planes * plane + (block_paths * ld if w_plane else 0) + extra
              + n_products * block_paths * (TILE_COLS + 1) + staged)
    return 4 * floats


def range_smem_bytes(n_steps: int, block_paths: int,
                     antithetic: bool = False, with_cv: bool = False,
                     spectral: bool = False, bf16: bool = False) -> int:
    """The single-tile family's range model (``max_block_paths``): the
    shared memory of a block that keeps a W plane resident beside its
    noise planes, one product tile and ``block_paths`` floats more (twice
    ``with_cv``); a paired block of ``block_paths`` members keeps half as
    many rows of noise and a product tile of every member.  No kernel takes
    this layout (K1 and K2 draw W per tile, ``priced_smem_bytes``); it
    fixes where the single tile ends and the slab begins: 365 steps."""
    drawn = block_paths // 2 if antithetic else block_paths
    return block_smem_bytes(
        n_steps, drawn, extra=(block_paths - drawn) * (TILE_COLS + 1)
        + (2 if with_cv else 1) * block_paths, spectral=spectral, bf16=bf16)


def priced_tile_k(antithetic: bool = False, spectral: bool = False,
                  bf16: bool = False, priced: bool = True) -> int:
    """Rows of Lt' K2 (K1 with ``priced`` False) stages per pass of its
    float32 product (``priced_tile_k`` of csrc/pathgen.cu): 16 for the
    unpaired chol block, which then fits two blocks an SM at 365 steps, 8
    for K1's spectral pair (two blocks an SM where TILE_K leaves one),
    else TILE_K."""
    if not (antithetic or spectral or bf16):
        return 16
    return 8 if not priced and antithetic and spectral and not bf16 \
        else TILE_K


def priced_smem_bytes(n_steps: int, block_paths: int,
                      antithetic: bool = False, spectral: bool = False,
                      bf16: bool = False, priced: bool = True) -> int:
    """K2 (K1 with ``priced`` False; ``priced_smem_bytes`` of
    csrc/pathgen.cu): the planes without W (both draw W per tile), one
    product tile of every member (K2's partial sums at the end, the
    control lane's too) and the staged factor tiles of ``priced_tile_k``
    rows, in whose room K2's decision rows of a step tile are staged once
    the product is done: the same in both policies."""
    drawn = drawn_rows(block_paths, antithetic)
    return block_smem_bytes(
        n_steps, drawn, extra=(block_paths - drawn) * (TILE_COLS + 1),
        spectral=spectral, bf16=bf16, w_plane=False,
        tile_k=priced_tile_k(antithetic, spectral, bf16, priced))


def pathgen_smem_bytes(n_steps: int, block_paths: int,
                       antithetic: bool = False, spectral: bool = False,
                       bf16: bool = False) -> int:
    """K1's block (``mcop_path_smem_bytes``): K2's layout, its spectral
    pair staging 8 rows of the factors a pass."""
    return priced_smem_bytes(n_steps, block_paths, antithetic, spectral,
                             bf16, priced=False)


SM_SMEM = 233_472          # shared memory of one H100 SM
BLOCK_RESERVE = 1_024      # the runtime's shared memory per resident block
MAX_BLOCKS_PER_SM = 8      # 2,048 threads an SM, 256 a block


def smem_blocks_per_sm(smem: int) -> int:
    """Blocks of 256 threads taking ``smem`` bytes of shared memory each
    that one SM holds by its shared memory and threads (registers aside)."""
    return min(MAX_BLOCKS_PER_SM, SM_SMEM // (smem + BLOCK_RESERVE))


def priced_min_blocks(antithetic: bool = False, spectral: bool = False,
                      bf16: bool = False) -> int:
    """K1's and K2's ``__launch_bounds__`` minimum of blocks an SM
    (csrc/pathgen.cu tile_kernel), which caps their registers: 3 for the
    bf16 forms but the paired chol one (three of their blocks fit an SM at
    365 steps), else 2."""
    return 3 if bf16 and (spectral or not antithetic) else 2


# K2's largest block per form (bf16, spectral, antithetic), below the
# largest that fits where a smaller block, more of them an SM, ran faster
# at 365 steps on the H100 (PERF.md §6, PR 14): the float32 chol pair
# (64 members, three an SM: 0.81x of 128), the bf16 spectral form (32
# paths, three an SM: 0.85x of 64) and its pair (64, 0.84x of 128).  The
# float32 spectral pair and the bf16 chol pair ran slower halved.
PRICED_BLOCK_CAPS = {(False, False, True): 64, (True, True, False): 32,
                     (True, True, True): 64}
# K1's largest block per form (bf16, spectral, antithetic), below the largest
# that fits where a smaller block ran faster at 365 steps (NVIDIA H100 80GB
# HBM3, 700 W; ``chip_smoke.py --k1-forms`` times every block, PERF.md §6):
# the float32 chol pair (64 members: 1.02 ms against 1.35 at 128) and
# spectral pair (64: 3.32 against 3.85), the bf16 spectral form (32: 2.31
# against 2.78) and its pair (64: 1.23 against 1.50).
PATHGEN_BLOCK_CAPS = {**PRICED_BLOCK_CAPS, (False, True, True): 64}


def fitting_block(smem, n_steps: int, rows: int = 0,
                  antithetic: bool = False, cap: int = 128) -> int:
    """Largest of BLOCK_CHOICES (PAIRED_BLOCK_CHOICES when ``antithetic``)
    up to ``cap`` whose ``smem(n_steps, block)`` fits one H100 block (and
    which divides ``rows`` when given), or 0 when none does."""
    for bp in PAIRED_BLOCK_CHOICES if antithetic else BLOCK_CHOICES:
        if (bp <= cap and smem(n_steps, bp) <= SMEM_LIMIT
                and (not rows or rows % bp == 0)):
            return bp
    return 0


def slab_ld(n_steps: int) -> int:
    """Row stride, in elements, of a factor the step-tiled kernels copy 16
    bytes at a time (``slab_ld`` of csrc/slab_tile.cuh): n rounded up to
    8."""
    return _round_up(n_steps, 8)


def _check_form(fgn_form: str) -> bool:
    """Whether ``fgn_form`` ("chol" or "spectral") is the spectral one."""
    if fgn_form not in FGN_FORMS:
        raise ValueError(f"fgn_form must be one of {FGN_FORMS}, got "
                         f"{fgn_form!r}")
    return fgn_form == SPECTRAL


def check_fgn_dtype(fgn_dtype: str) -> bool:
    """Whether ``fgn_dtype`` ("float32" or "bfloat16") is the bf16 one."""
    if fgn_dtype not in FGN_DTYPES:
        raise ValueError(f"fgn_matmul_dtype must be one of {FGN_DTYPES}, "
                         f"got {fgn_dtype!r}")
    return fgn_dtype == "bfloat16"


def max_block_paths(n_steps: int, fgn_form: str = "chol") -> int:
    """The single-tile family's range at this horizon in this fGN form:
    the largest path block (64, 32 or 16) whose ``range_smem_bytes``
    fits, or 0 (the spectral form's three planes take 32 at 365
    steps)."""
    spectral = _check_form(fgn_form)
    return fitting_block(
        lambda n, b: range_smem_bytes(n, b, spectral=spectral), n_steps)


def supports(n_steps: int, fgn_form: str = "chol") -> bool:
    """Whether the single-tile kernels take this horizon in this form."""
    return n_steps >= 1 and max_block_paths(n_steps, fgn_form) > 0


# ---------------------------------------------------------------------------
# Host-side constants and policy tables.

def _half_var_drift(n_steps: int, s_pad: int, xi, h, eta, dt) -> torch.Tensor:
    """[1, s_pad] float32 row of 0.5 (ln xi - 0.5 eta^2 t_c^{2H}) at the
    increment times t_c = c dt (pad columns zero): with the half-scaled fGN
    factor, exp(x' + this) is the square root of the forward variance."""
    t = torch.arange(n_steps, dtype=torch.float64) * dt
    hvd = 0.5 * (math.log(xi) - 0.5 * (eta * eta) * t ** (2.0 * h))
    out = torch.zeros((1, s_pad), dtype=torch.float32)
    out[0, :n_steps] = hvd.to(torch.float32)
    return out


@dataclasses.dataclass(frozen=True)
class PathConsts:
    """Everything the path kernels read besides noise and policy: the fGN
    form's half-scaled factors, either the upper-triangular Cholesky
    factor ``lt_half`` [n, n] (chol) or the dense spectral matrices
    ``cr_half`` and ``ci_half`` [n, n] (spectral), the half variance drift
    ``vd`` [n], the market scalars and the single-tile kernels' path block
    (0 past their cap; the step-tiled kernels of ``pathgen_tiled_cuda``
    choose theirs from the row count).  Its tensors' device decides where
    the wrappers run."""

    n_steps: int
    block_paths: int
    lt_half: Optional[torch.Tensor]
    vd: torch.Tensor
    s0: float
    r: float
    dt: float
    cr_half: Optional[torch.Tensor] = None
    ci_half: Optional[torch.Tensor] = None
    fgn_dtype: str = "float32"

    @property
    def device(self) -> torch.device:
        return self.vd.device

    @property
    def spectral(self) -> bool:
        return self.cr_half is not None

    @property
    def bf16(self) -> bool:
        """Whether these are the bf16 fGN-input form's constants."""
        return self.fgn_dtype == "bfloat16"

    def check_dtype(self) -> None:
        """The factors in the dtype their form names: torch.bfloat16 under
        ``fgn_dtype="bfloat16"``, float32 otherwise (ValueError on a
        mismatch, so no kernel reads one as the other)."""
        want = torch.bfloat16 if self.bf16 else torch.float32
        factors = [t for t in (self.lt_half, self.cr_half, self.ci_half)
                   if t is not None]
        if any(t.dtype != want for t in factors):
            raise ValueError(
                f"fgn_dtype={self.fgn_dtype!r} needs {want} factors, got "
                f"{[t.dtype for t in factors]}")

    @property
    def fgn_form(self) -> str:
        return SPECTRAL if self.spectral else "chol"

    @property
    def n_planes(self) -> int:
        """Noise planes a row reads: 3 (Zr, Zi, W) or 2 (N, W)."""
        return 3 if self.spectral else 2

    def factor_ptrs(self) -> tuple:
        """The kernels' (lt, ci) pointer arguments: (Lt', null) or (Cr',
        Ci')."""
        if self.spectral:
            return self.cr_half.data_ptr(), self.ci_half.data_ptr()
        return self.lt_half.data_ptr(), None

    @functools.cached_property
    def slab_factors(self) -> tuple:
        """The factors as the step-tiled kernels read them: each row padded
        with zeros to ``slab_ld(n_steps)`` elements, so every copy of a
        k-tile is 16 bytes (csrc/slab_tile.cuh); (Lt', None) or (Cr',
        Ci'), made at first use and kept with the constants."""
        ld = slab_ld(self.n_steps)

        def pad(m):
            return torch.nn.functional.pad(m, (0, ld - m.shape[1]))

        if self.spectral:
            return pad(self.cr_half), pad(self.ci_half)
        return pad(self.lt_half), None

    def slab_factor_ptrs(self) -> tuple:
        """The step-tiled kernels' (lt, ci) pointer arguments: those of
        ``slab_factors``."""
        fac, fci = self.slab_factors
        return fac.data_ptr(), None if fci is None else fci.data_ptr()


def make_path_consts(s0, xi, h, eta, r, n_steps: int, dt: float,
                     device, block_paths: int = 0,
                     fgn_form: str = "chol",
                     fgn_dtype: str = "float32") -> PathConsts:
    """PathConsts for the chol or the spectral fGN form, at any horizon:
    0.5 times the float64 host factors (``engine._chol_matrix_host``, or
    ``engine._fgn_matrices_np``'s Cr and Ci) cast to float32, or under
    ``fgn_dtype="bfloat16"`` each matrix rounded to torch.bfloat16 and
    halved, bit for bit JAX's ``_fgn_consts`` matrices (float64 ->
    float32 -> bf16, nearest even, as ``jnp.asarray`` rounds; halving is
    exact).  ``block_paths`` 0 takes the largest single-tile
    block the card admits at this horizon and form (0 past the single-tile
    cap; the bf16 form keeps the float32 form's blocks); the single-tile
    wrappers check it."""
    from .engine import _chol_matrix_host, _fgn_matrices_np

    spectral = _check_form(fgn_form)
    bf16 = check_fgn_dtype(fgn_dtype)

    def half(m):
        m = 0.5 * torch.tensor(np.asarray(m), dtype=torch.float32)
        if bf16:
            m = m.to(torch.bfloat16)
        return m.to(device).contiguous()

    vd = _half_var_drift(n_steps, n_steps, xi, h, eta, dt)[0]
    common = dict(n_steps=n_steps,
                  block_paths=block_paths or max_block_paths(n_steps,
                                                             fgn_form),
                  vd=vd.to(device).contiguous(), s0=float(s0), r=float(r),
                  dt=float(dt), fgn_dtype=fgn_dtype)
    if spectral:
        cr, ci = _fgn_matrices_np(n_steps, h, eta, dt)
        return PathConsts(lt_half=None, cr_half=half(cr), ci_half=half(ci),
                          **common)
    return PathConsts(lt_half=half(_chol_matrix_host(n_steps, h, eta, dt)),
                      **common)


@dataclasses.dataclass(frozen=True)
class GreeksConsts:
    """What the Greeks kernels K3 and K4 read beside a PathConsts
    (counterpart: the ``dlt'`` and ``aux`` rows of
    ``pathgen_pallas._greeks_consts``): the half-scaled dLt/dH factor
    ``dlt_half`` [n, n] (upper triangular; torch.bfloat16 under
    ``fgn_dtype="bfloat16"``, which the PathConsts' must match), the
    tangent rows ``de`` [n] (d ln sv/d eta less x'/eta) and ``dh`` [n] (the
    drift's H derivative), and the scalars xi and eta the tangents divide
    by.  Its tensors live on the PathConsts' device."""

    dlt_half: torch.Tensor
    de: torch.Tensor
    dh: torch.Tensor
    xi: float
    eta: float
    fgn_dtype: str = "float32"

    @property
    def bf16(self) -> bool:
        """Whether these are the bf16 fGN-input form's constants."""
        return self.fgn_dtype == "bfloat16"


def make_greeks_consts(xi, h, eta, n_steps: int, dt: float, device,
                       fgn_dtype: str = "float32") -> GreeksConsts:
    """GreeksConsts from the float64 host dLt/dH (``_chol_dh_matrix_host``)
    and the tangent rows -eta/2 t^2H and -eta^2/2 t^2H ln t at the drift
    times t = c dt (0 at t = 0).  Under ``fgn_dtype="bfloat16"`` dLt is
    rounded to torch.bfloat16 and halved, bit for bit JAX's
    ``_greeks_consts(..., jnp.bfloat16)`` dLt' (as ``make_path_consts``
    rounds Lt')."""
    from .engine import _chol_dh_matrix_host

    bf16 = check_fgn_dtype(fgn_dtype)
    dlt = 0.5 * torch.tensor(_chol_dh_matrix_host(n_steps, h, eta, dt),
                             dtype=torch.float32)
    if bf16:
        dlt = dlt.to(torch.bfloat16)
    td = np.arange(n_steps, dtype=np.float64) * dt
    t2h = td ** (2.0 * h)
    lnt = np.where(td > 0, np.log(np.maximum(td, 1e-300)), 0.0)

    def row(v):
        return torch.tensor(v, dtype=torch.float32).to(device).contiguous()

    return GreeksConsts(dlt_half=dlt.to(device).contiguous(),
                        de=row(-0.5 * eta * t2h),
                        dh=row(-0.5 * (eta * eta) * t2h * lnt),
                        xi=float(xi), eta=float(eta), fgn_dtype=fgn_dtype)


def _table_prep(fits, r, maturity, dt, n_steps: int, s_pad: int,
                terminal_eps: float):
    """Column-shifted fit arrays (column c is step c + 1), the
    integer-exact live-window eps with ``terminal_eps`` at the terminal
    column (1e-14 keeps the in-the-money test there, -1 forces exercise)
    and 1e30 past maturity and in the pad, and the exp(-r t) discount.
    Fits may carry leading batch axes (a strike strip), which the fit
    arrays keep; eps and the discount are shared."""
    from ..ops.timegrid import step_mask

    f32 = torch.float32
    dev = fits.mu.device
    t = torch.arange(1, n_steps + 1, dtype=f32, device=dev) * dt

    def shifted(a, fill, pad_value=0.0):
        a = a.to(f32)
        v = torch.cat([a[..., 1:], torch.full((*a.shape[:-1], 1), fill,
                                              dtype=f32, device=dev)], -1)
        return torch.nn.functional.pad(v, (0, s_pad - n_steps),
                                       value=pad_value)

    c0 = shifted(fits.coeffs[..., 0], -1e30)
    c1 = shifted(fits.coeffs[..., 1], 0.0)
    c2 = shifted(fits.coeffs[..., 2], 0.0)
    mu = shifted(fits.mu, 0.0)
    sd = torch.clamp_min(shifted(fits.sd, 1.0, pad_value=1.0), 1e-30)

    live = step_mask(n_steps + 1, dt, maturity, device=dev)[1:]
    eps = torch.where(live, torch.tensor(1e-14, dtype=f32, device=dev),
                      torch.tensor(1e30, dtype=f32, device=dev))
    eps[n_steps - 1] = terminal_eps
    eps = torch.nn.functional.pad(eps, (0, s_pad - n_steps), value=1e30)
    disc = torch.exp(-r * t)
    disc = torch.nn.functional.pad(disc, (0, s_pad - n_steps))
    return c0, c1, c2, mu, sd, eps, disc


def boundary_rows(fits, r, strike, maturity, dt, n_steps: int,
                  is_call: bool) -> torch.Tensor:
    """[8, s_pad] exercise-interval table (counterpart
    ``pathgen_pallas.boundary_rows``): row 0 lo, row 1 hi (exercise iff
    lo <= S <= hi), row 2 disc * strike, row 3 the discount, row 4 the
    strike, rows 5-7 zero.  The quadratic decision is solved in the fit's
    standardized z basis with the stable root form; an empty set is
    [1e30, -1e30] and an unbounded side keeps its +-1e30 sentinel.

    With a [K] ``strike`` tensor and fits carrying a leading [K] axis (a
    strike strip, ``lsm_fit`` with strikes) it returns the strip's
    [K, 8, s_pad] tables, the counterpart of ``jax.vmap`` over strikes;
    the chain kernel K5 reads them."""
    s_pad = _round_up(n_steps, LANE)
    big = 1e30
    c0, c1, c2, mu, sd, eps, disc = _table_prep(fits, r, maturity, dt,
                                                n_steps, s_pad, 1e-14)
    dev = mu.device
    strike_t = torch.as_tensor(strike, dtype=torch.float32,
                               device=dev)[..., None]
    big_t = torch.full_like(mu, big)

    if is_call:
        a, b, c = -c2, sd - c1, mu - strike_t - c0
        cap = torch.nextafter(strike_t + torch.clamp_min(eps, 0.0), big_t)
    else:
        a, b, c = -c2, -(sd + c1), strike_t - mu - c0
        cap = torch.nextafter(strike_t - torch.clamp_min(eps, 0.0), -big_t)

    where = torch.where
    lin = torch.abs(a) <= 1e-25
    safe_b = where(torch.abs(b) > 1e-30, b, 1.0)
    s_lin = -c / safe_b
    disc_q = b * b - 4.0 * a * c
    sq = torch.sqrt(torch.clamp_min(disc_q, 0.0))
    qq = -0.5 * (b + where(b < 0, -sq, sq))
    safe_a = where(lin, 1.0, a)
    safe_qq = where(torch.abs(qq) > 1e-30, qq, 1e-30)
    r1 = qq / safe_a
    r2 = c / safe_qq
    rlo = torch.minimum(r1, r2)
    rhi = torch.maximum(r1, r2)
    pos, neg = big_t, -big_t
    b_zero = torch.abs(b) <= 1e-30
    lin_lo = where(b_zero, where(c >= 0, neg, pos), where(b > 0, s_lin, neg))
    lin_hi = where(b_zero, where(c >= 0, pos, neg), where(b > 0, pos, s_lin))
    no_root = disc_q < 0
    if is_call:
        quad_lo = where(a < 0, where(no_root, pos, rlo),
                        where(no_root, neg, rhi))
        quad_hi = where(a < 0, where(no_root, neg, rhi), pos)
    else:
        quad_lo = where(a < 0, where(no_root, pos, rlo), neg)
        quad_hi = where(a < 0, where(no_root, neg, rhi),
                        where(no_root, pos, rlo))
    zlo = where(lin, lin_lo, quad_lo)
    zhi = where(lin, lin_hi, quad_hi)
    set_lo = where(torch.abs(zlo) >= big, zlo, mu + sd * zlo)
    set_hi = where(torch.abs(zhi) >= big, zhi, mu + sd * zhi)
    if is_call:
        lo_row, hi_row = torch.maximum(set_lo, cap), set_hi
    else:
        lo_row, hi_row = set_lo, torch.minimum(set_hi, cap)

    zeros = torch.zeros_like(mu)
    return torch.stack([lo_row, hi_row, disc * strike_t,
                        disc.expand_as(mu), strike_t.expand_as(mu), zeros,
                        zeros, zeros], dim=-2)


def policy_rows(fits, r, strike, maturity, dt, n_steps: int,
                is_call: bool) -> torch.Tensor:
    """[8, s_pad] quadratic policy table (counterpart
    ``pathgen_pallas.policy_rows``): rows c0, c1, c2 (the fit's
    standardized coefficients), mu, sd, eps, the discount and the strike,
    column c = step c + 1.  The terminal column always exercises (c0 =
    -1e30, eps = -1); steps past maturity and the pad never do (eps =
    1e30).  With a [K] ``strike`` tensor and fits carrying a leading [K]
    axis it returns the strip's [K, 8, s_pad] tables, as
    ``boundary_rows``.  ``is_call`` is not read (the kernels take the
    payoff's sign), as in JAX."""
    del is_call
    s_pad = _round_up(n_steps, LANE)
    c0, c1, c2, mu, sd, eps, disc = _table_prep(fits, r, maturity, dt,
                                                n_steps, s_pad, -1.0)
    strike_t = torch.as_tensor(strike, dtype=torch.float32,
                               device=mu.device)[..., None]
    return torch.stack([c0, c1, c2, mu, sd, eps.expand_as(mu),
                        disc.expand_as(mu), strike_t.expand_as(mu)], dim=-2)


def log_boundary_rows(table: torch.Tensor) -> torch.Tensor:
    """boundary_rows -> the log-space [..., 8, s_pad] table K2, K3 and K4
    read: row 0 log lo, row 1 log hi, row 2 the discount, row 3 the
    strike.  The +-1e30 sentinels stay exact (lo <= 0 passes every
    S > 0)."""
    big = 1e30
    lo, hi = table[..., 0, :], table[..., 1, :]
    disc, strike = table[..., 3, :], table[..., 4, :]
    big_t = torch.full_like(lo, big)

    def to_log(v):
        safe = torch.log(torch.clamp_min(v, 1e-38))
        return torch.where(v <= 0.0, -big_t, torch.where(v >= big, big_t,
                                                          safe))

    zeros = torch.zeros_like(disc)
    return torch.stack([to_log(lo), to_log(hi), disc, strike,
                        zeros, zeros, zeros, zeros], dim=-2)


def time0_value(fits, s0, strike, is_call: bool):
    """(exercises_at_0 as a bool tensor, payoff_at_0): every path shares
    S0, so time-0 exercise is one decision made outside the kernels.  For
    a number ``strike`` the payoff is a float; for a [K] strike tensor and
    fits with a leading [K] axis both are [K] tensors (counterpart of the
    chain stream's per-strike time-0 values)."""
    if torch.is_tensor(strike):
        p0 = torch.clamp_min(s0 - strike if is_call else strike - s0, 0.0)
    else:
        p0 = max(s0 - strike, 0.0) if is_call else max(strike - s0, 0.0)
    z0 = (s0 - fits.mu[..., 0]) / fits.sd[..., 0]
    cont0 = (fits.coeffs[..., 0, 2] * z0 + fits.coeffs[..., 0, 1]) * z0 \
        + fits.coeffs[..., 0, 0]
    ex0 = (p0 > 1e-14) & (p0 >= cont0)
    return ex0, p0


# ---------------------------------------------------------------------------
# Plain versions (the CPU path, and the card's reference).

def _matmul_f32(a, b):
    """a @ b in full float32 on any device (TF32 pinned off on CUDA)."""
    if not a.is_cuda:
        return a @ b
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return a @ b
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def log_paths_from_x(consts, x: torch.Tensor,
                     w: torch.Tensor) -> torch.Tensor:
    """[rows, n_steps] log prices, column c = step c + 1, from the
    half-scaled fGN plane ``x`` and the price Brownian ``w`` (both
    [rows, n_steps]): sv = exp(x + vd), the Euler log increments and their
    running sum.  ``consts`` carries vd, s0, r and dt (a PathConsts, or
    the factored kernels' FactoredConsts)."""
    sv = torch.exp(x + consts.vd)
    v = sv * sv
    inc = (consts.r - 0.5 * v) * consts.dt + sv * (w * math.sqrt(consts.dt))
    return math.log(consts.s0) + torch.cumsum(inc, dim=1)


def pair_planes(x: torch.Tensor, w: torch.Tensor):
    """Antithetic members from the drawn rows: [x; -x] and [w; -w] (the
    fGN map is linear, so -x is the plane of -N exactly)."""
    return torch.cat([x, -x]), torch.cat([w, -w])


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to bf16 (nearest even), as float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def fgn_matmul_ref(plane: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """plane @ m in float32.  For a bf16 factor ``m`` (the bf16 form) the
    plane is rounded to bf16 first and the product is the float32 one of
    the bf16 values (every product of two bf16 values is exact in
    float32), as JAX's ``jnp.dot`` of bf16 inputs with float32 sums."""
    if m.dtype == torch.bfloat16:
        return _matmul_f32(round_bf16(plane), m.to(torch.float32))
    return _matmul_f32(plane, m)


def fgn_x_ref(consts: PathConsts, noise: torch.Tensor) -> torch.Tensor:
    """[rows, n_steps] half-scaled fGN plane of the noise planes: N @ Lt'
    (chol), or Zr @ Cr' - Zi @ Ci' (spectral, ``_fgn_x``), float32.  The
    bf16 form rounds N (Zr and Zi) to bf16 (``fgn_matmul_ref``), as JAX's
    ``_fgn_x`` does with bf16 matrices."""
    if consts.spectral:
        return (fgn_matmul_ref(noise[0], consts.cr_half)
                - fgn_matmul_ref(noise[1], consts.ci_half))
    return fgn_matmul_ref(noise[0], consts.lt_half)


def _log_paths_ref(consts: PathConsts, noise: torch.Tensor,
                   antithetic: bool = False) -> torch.Tensor:
    """[rows, n_steps] log prices, column c = step c + 1 (2 rows per row of
    noise when ``antithetic``), from [2 or 3, rows, n_steps] noise (W
    last)."""
    x, w = fgn_x_ref(consts, noise), noise[-1]
    if antithetic:
        x, w = pair_planes(x, w)
    return log_paths_from_x(consts, x, w)


def prices_from_log(ls: torch.Tensor, s0: float) -> torch.Tensor:
    """[rows, n_steps] log prices -> [rows, n_steps + 1] prices with s0 in
    column 0."""
    out = torch.empty((ls.shape[0], ls.shape[1] + 1), dtype=torch.float32,
                      device=ls.device)
    out[:, 0] = s0
    out[:, 1:] = torch.exp(ls)
    return out


def pathgen_from_noise_ref(consts: PathConsts, noise: torch.Tensor,
                           antithetic: bool = False) -> torch.Tensor:
    """Plain K1: [2, rows, n_steps] (N, W), or [3, rows, n_steps] (Zr, Zi,
    W) spectral, -> [rows, n_steps + 1] prices;
    with ``antithetic`` [2 rows, n_steps + 1], the pairs' partners below
    the drawn rows."""
    return prices_from_log(_log_paths_ref(consts, noise, antithetic),
                           consts.s0)


def cv_discount(consts) -> float:
    """exp(-r T) of the martingale control e^{-rT} S_T (T = n_steps dt)."""
    return math.exp(-consts.r * consts.n_steps * consts.dt)


def priced_sums(consts, ls: torch.Tensor, table: torch.Tensor,
                strike: float, is_call: bool, with_cv: bool,
                policy_form: str = "boundary"):
    """The priced kernels' output from log paths: the payoff sum under
    the log_boundary_rows ``table`` (``policy_form="quadratic"``: under
    the policy_rows ``table``, on S = exp(ls), strike from its row 7),
    and with ``with_cv`` also the control sum cv_disc * sum_p
    exp(ls[p, -1])."""
    if check_policy(policy_form):
        val = quadratic_first_hit_sum(torch.exp(ls), table, is_call)
    else:
        val = first_hit_sum(ls, table, strike, is_call)
    if not with_cv:
        return val
    return val, cv_discount(consts) * torch.sum(torch.exp(ls[:, -1]))


def priced_chunk_from_noise_ref(consts: PathConsts, table: torch.Tensor,
                                noise: torch.Tensor, strike: float,
                                is_call: bool, antithetic: bool = False,
                                with_cv: bool = False,
                                policy_form: str = "boundary"):
    """Plain K2: the chunk's payoff sum (0-d float32) under the log
    exercise-interval table (log_boundary_rows layout), or under
    ``policy_form="quadratic"`` the policy_rows table; with
    ``antithetic`` the rows of ``noise`` are priced as pairs, with
    ``with_cv`` the result is (payoff sum, control sum)."""
    return priced_sums(consts, _log_paths_ref(consts, noise, antithetic),
                       table, strike, is_call, with_cv, policy_form)


def first_hit_sum(ls: torch.Tensor, table: torch.Tensor, strike: float,
                  is_call: bool) -> torch.Tensor:
    """Payoff sum (0-d float32) of [rows, n] log paths, each stopped at its
    first step inside the log exercise interval of ``table``
    (log_boundary_rows layout); a path that never enters it adds 0."""
    n = ls.shape[1]
    exf = (ls >= table[0, :n]) & (ls <= table[1, :n])
    hit = exf.any(dim=1)
    idx = exf.to(torch.int8).argmax(dim=1)      # first hit
    s_stop = torch.exp(ls.gather(1, idx[:, None])[:, 0])
    pay = s_stop - strike if is_call else strike - s_stop
    val = table[2, :n][idx] * torch.clamp_min(pay, 0.0)
    return torch.sum(torch.where(hit, val, torch.zeros_like(val)))


def quadratic_stops(s: torch.Tensor, table: torch.Tensor, is_call: bool,
                    recip: bool = False):
    """(hit, first step, value) of each of the [rows, n] price paths ``s``
    (column c = step c + 1) under the quadratic policy table ``table``
    (policy_rows layout; counterpart ``_policy_value:277``): a cell
    exercises when its payoff p = max(+-(s - strike), 0) exceeds eps and
    is at least the continuation (c2 z + c1) z + c0, z = (s - mu) / sd;
    the first one is worth disc * p.  ``recip`` takes z = (s - mu) *
    (1 / sd), the reciprocal per step, as the chain kernel's
    ``_policy_value_minreduce:302`` does.  Every operation rounds to
    float32 on its own, as the JAX interpreter's."""
    n = s.shape[1]
    c0, c1, c2, mu, sd, eps, disc, strike = table[:, :n].unbind(0)
    p = torch.clamp_min(s - strike if is_call else strike - s, 0.0)
    z = (s - mu) * (1.0 / sd) if recip else (s - mu) / sd
    cont = (c2 * z + c1) * z + c0
    exf = (p > eps) & (p >= cont)
    idx = exf.to(torch.int8).argmax(dim=1)      # first hit
    val = (p * disc).gather(1, idx[:, None])[:, 0]
    return exf.any(dim=1), idx, val


def quadratic_first_hit_sum(s: torch.Tensor, table: torch.Tensor,
                            is_call: bool,
                            recip: bool = False) -> torch.Tensor:
    """Payoff sum (0-d float32) of the [rows, n] price paths ``s`` under
    the quadratic policy (``quadratic_stops``); a path that never
    exercises adds 0 (none does under policy_rows, whose terminal column
    always exercises)."""
    hit, _, val = quadratic_stops(s, table, is_call, recip)
    return torch.sum(torch.where(hit, val, torch.zeros_like(val)))


# ---------------------------------------------------------------------------
# Wrappers: plain version for CPU tensors, the kernel for CUDA tensors.

def _noise_or_rows(consts, rows, key, noise, antithetic: bool = False):
    """The chunk's path count: ``rows`` for the seeded entry, else from
    the noise [planes, rows (rows / 2 when antithetic), n_steps], planes
    2 (chol) or 3 (spectral)."""
    if (key is None) == (noise is None):
        raise ValueError("pass exactly one of key (seeded) or noise")
    if noise is None:
        if rows is None:
            raise ValueError("the seeded entry needs rows")
        if antithetic and rows % 2:
            raise ValueError(f"antithetic rows={rows} must be even")
        return rows
    planes = consts.n_planes
    if (noise.dim() != 3 or noise.shape[0] != planes
            or noise.shape[2] != consts.n_steps):
        raise ValueError(f"{consts.fgn_form} noise must be [{planes}, rows, "
                         f"{consts.n_steps}], got {tuple(noise.shape)}")
    return noise.shape[1] * (2 if antithetic else 1)


def drawn_rows(rows: int, antithetic: bool) -> int:
    """Rows of noise a chunk of ``rows`` paths draws."""
    return rows // 2 if antithetic else rows


def check_device_inputs(consts: PathConsts, noise, table=None) -> None:
    """The checks every kernel wrapper makes before a launch: the
    constants on a CUDA device, and noise and table contiguous float32 on
    that device."""
    dev = consts.device
    if dev.type != "cuda":
        raise ValueError(f"the kernels run on a CUDA device, not {dev}")
    for name, t in (("noise", noise), ("table", table)):
        if t is not None and (t.device != dev or t.dtype != torch.float32
                              or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32 on {dev}")


def _no_block(kernel: str, consts: PathConsts, rows: int,
              antithetic: bool) -> ValueError:
    form = form_name(antithetic, spectral=consts.spectral, bf16=consts.bf16)
    return ValueError(f"no {kernel} block fits the {form!r} form at "
                      f"n_steps={consts.n_steps} and divides rows={rows}")


def path_block_paths(consts: PathConsts, rows: int,
                     antithetic: bool = False) -> int:
    """The single-tile range model's block of a K1 form:
    ``consts.block_paths``, or paired the largest of PAIRED_BLOCK_CHOICES
    whose ``range_smem_bytes`` fits and which divides ``rows``.  K1
    launches on its own block, ``pathgen_block_paths``."""
    if not antithetic:
        return consts.block_paths
    bp = fitting_block(lambda n, b: range_smem_bytes(
        n, b, True, spectral=consts.spectral), consts.n_steps, rows, True)
    if not bp:
        raise _no_block("K1", consts, rows, True)
    return bp


def pathgen_block_paths(consts: PathConsts, rows: int,
                        antithetic: bool = False) -> int:
    """The path block of a K1 launch, its own as K2's is: the largest of
    BLOCK_CHOICES (PAIRED_BLOCK_CHOICES, in pair members, when
    ``antithetic``), up to the form's PATHGEN_BLOCK_CAPS, whose shared
    memory (``pathgen_smem_bytes``) in the constants' fGN form and dtype
    fits and which divides ``rows``."""
    bp = fitting_block(
        lambda n, b: pathgen_smem_bytes(n, b, antithetic, consts.spectral,
                                        consts.bf16),
        consts.n_steps, rows, antithetic, PATHGEN_BLOCK_CAPS.get(
            (consts.bf16, consts.spectral, bool(antithetic)), 128))
    if not bp:
        raise _no_block("K1", consts, rows, antithetic)
    return bp


def pathgen_blocks_per_sm(consts: PathConsts, rows: int,
                          antithetic: bool = False) -> int:
    """Blocks of K1 one SM of the card runs at once in the form of
    ``consts`` and ``antithetic``, at the block ``pathgen_block_paths``
    picks (the CUDA runtime's occupancy query on the seeded body)."""
    bp = pathgen_block_paths(consts, rows, antithetic)
    from ..kernels import build

    got = build.entry(build.load(), "pathgen", "mcop_path_blocks_per_sm",
                      consts.bf16, True)(
        consts.n_steps, bp, int(antithetic), int(consts.spectral))
    if got < 0:
        raise RuntimeError(f"mcop_path_blocks_per_sm failed: cudaError "
                           f"{-got}")
    return got


def priced_block_paths(consts: PathConsts, rows: int,
                       antithetic: bool = False) -> int:
    """The path block of a K2 launch, K2's own as K5's is (not
    ``consts.block_paths``, which is K1's): the largest of BLOCK_CHOICES
    (PAIRED_BLOCK_CHOICES, in pair members, when ``antithetic``), up to
    the form's PRICED_BLOCK_CAPS, whose shared memory in the constants'
    fGN form and dtype fits and which divides ``rows``, the same in both
    policies, with or without the control variate: at 365 steps 64 paths
    and 128 members paired, but 64 for the float32 pairs, 32 and 64 for
    the bf16 spectral forms."""
    bp = fitting_block(
        lambda n, b: priced_smem_bytes(n, b, antithetic, consts.spectral,
                                       consts.bf16),
        consts.n_steps, rows, antithetic, PRICED_BLOCK_CAPS.get(
            (consts.bf16, consts.spectral, bool(antithetic)), 128))
    if not bp:
        raise _no_block("K2", consts, rows, antithetic)
    return bp


def priced_blocks_per_sm(consts: PathConsts, rows: int,
                         antithetic: bool = False, with_cv: bool = False,
                         policy_form: str = "boundary") -> int:
    """Blocks of K2 one SM of the card runs at once in the form of
    ``consts`` (its fGN form and dtype), ``antithetic``, ``with_cv`` and
    ``policy_form``, at the block ``priced_block_paths`` picks (the CUDA
    runtime's occupancy query on the seeded body)."""
    quadratic = check_policy(policy_form, antithetic)
    bp = priced_block_paths(consts, rows, antithetic)
    from ..kernels import build

    got = build.entry(build.load(), "pathgen", "mcop_priced_blocks_per_sm",
                      consts.bf16, True)(
        consts.n_steps, bp, int(antithetic), int(with_cv),
        int(consts.spectral), int(quadratic))
    if got < 0:
        raise RuntimeError(f"mcop_priced_blocks_per_sm failed: cudaError "
                           f"{-got}")
    return got


def _kernel_args(consts: PathConsts, rows: int, key, noise,
                 block_paths: int = 0):
    """Validated pointer and scalar arguments shared by both single-tile
    kernels (``block_paths`` 0: the constants' block, K1 and plain K2)."""
    check_device_inputs(consts, noise)
    bp = consts.block_paths
    cap = max_block_paths(consts.n_steps, consts.fgn_form)
    if bp not in BLOCK_CHOICES or bp > cap:
        raise ValueError(f"block_paths={bp} not in {BLOCK_CHOICES} or over "
                         f"the single-tile cap {cap} at "
                         f"n_steps={consts.n_steps}")
    bp = block_paths or bp
    if rows % bp:
        raise ValueError(f"rows={rows} must divide by block_paths={bp}")
    noise_ptr = None if noise is None else noise.data_ptr()
    return (noise_ptr, *consts.factor_ptrs(), consts.vd.data_ptr(),
            rows, consts.n_steps, bp, 0 if key is None else key & _U32)


def _scalars(consts: PathConsts):
    c = ctypes.c_float
    return (c(consts.r), c(consts.dt), c(math.sqrt(consts.dt)),
            c(math.log(consts.s0)))


def _check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def pathgen(consts: PathConsts, rows: int = None, key: int = None,
            noise: torch.Tensor = None,
            antithetic: bool = False) -> torch.Tensor:
    """K1: [rows, n_steps + 1] float32 prices, S0 in column 0, from the
    seeded stream of ``key`` (a uint32 word, see _fold_words) or from
    injected ``noise`` [planes, rows, n_steps] (``consts.n_planes``: 2 for
    the chol form, 3 for the spectral).  With ``antithetic`` the rows are
    rows / 2 pairs (the seeded entry draws rows / 2 rows, noise is
    [planes, rows / 2, n_steps]): the drawn rows' paths, then their
    partners'.  On the card it launches on its own block
    (``pathgen_block_paths``) and adds log s0 to the running sum of the
    increments, as the plain version does."""
    rows = _noise_or_rows(consts, rows, key, noise, antithetic)
    consts.check_dtype()
    if consts.device.type == "cpu":
        if noise is None:
            noise = normals_ref(consts, key, drawn_rows(rows, antithetic))
        return pathgen_from_noise_ref(consts, noise, antithetic)
    bp = pathgen_block_paths(consts, rows, antithetic)
    args = _kernel_args(consts, rows, key, noise, bp)
    out = torch.empty((rows, consts.n_steps + 1), dtype=torch.float32,
                      device=consts.device)
    from ..kernels import build

    err = build.entry(build.load(), "pathgen", "mcop_pathgen", consts.bf16,
                      noise is None)(
        *args, *_scalars(consts), ctypes.c_float(consts.s0),
        int(bool(antithetic)), int(consts.bf16), out.data_ptr(),
        torch.cuda.current_stream(consts.device).cuda_stream)
    _check(err, "pathgen")
    pathgen.launches += 1
    pathgen.form_launches[form_name(antithetic, False, consts.spectral,
                                    bf16=consts.bf16)] += 1
    return out


pathgen.launches = 0
pathgen.form_launches = new_form_counts(PATH_FORMS, bf16=True)


def sums_from_partials(partial: torch.Tensor, with_cv: bool):
    """A priced kernel's [1 or 2, blocks] partial sums, summed per lane in
    a fixed order: the payoff sum, or (payoff sum, control sum)."""
    sums = torch.sum(partial, dim=1)
    return (sums[0], sums[1]) if with_cv else sums[0]


def check_table(table: torch.Tensor, n_steps: int,
                quadratic: bool) -> None:
    """A priced kernel's table: [8, >= n_steps], log_boundary_rows or
    (``quadratic``) policy_rows; the boundary kernels read rows 0-2."""
    if (table.dim() != 2 or table.shape[0] < (8 if quadratic else 3)
            or table.shape[1] < n_steps):
        layout = "policy_rows" if quadratic else "log_boundary_rows"
        raise ValueError(f"table must be [8, >= n_steps] ({layout}), got "
                         f"{tuple(table.shape)}")


def priced_chunk(consts: PathConsts, table: torch.Tensor, strike: float,
                 is_call: bool, rows: int = None, key: int = None,
                 noise: torch.Tensor = None, antithetic: bool = False,
                 with_cv: bool = False, policy_form: str = "boundary"):
    """K2: the chunk's discounted payoff sum (0-d float32 tensor) under
    the log_boundary_rows ``table`` (``policy_form="quadratic"``: the
    policy_rows ``table``, which carries its strike in row 7), from the
    seeded stream of ``key`` or from injected ``noise``; with
    ``with_cv``, (payoff sum, control sum).  With ``antithetic`` (the
    boundary policy only) the chunk's ``rows`` paths are rows / 2 pairs:
    the seeded entry draws rows / 2 rows, and injected noise is [planes,
    rows / 2, n_steps] (planes as K1's).  On the card each block writes
    one partial sum per lane and the blocks are summed in a fixed order,
    so a seed gives the same sums every run."""
    quadratic = check_policy(policy_form, antithetic)
    rows = _noise_or_rows(consts, rows, key, noise, antithetic)
    check_table(table, consts.n_steps, quadratic)
    consts.check_dtype()
    if consts.device.type == "cpu":
        if noise is None:
            noise = normals_ref(consts, key, drawn_rows(rows, antithetic))
        return priced_chunk_from_noise_ref(consts, table, noise, strike,
                                           is_call, antithetic, with_cv,
                                           policy_form)
    bp = priced_block_paths(consts, rows, antithetic)
    args = _kernel_args(consts, rows, key, noise, bp)
    check_device_inputs(consts, None, table)
    partial = torch.empty((2 if with_cv else 1, rows // bp),
                          dtype=torch.float32, device=consts.device)
    from ..kernels import build

    err = build.entry(build.load(), "pathgen", "mcop_priced_chunk",
                      consts.bf16, noise is None)(
        *args, *_scalars(consts), table.data_ptr(), table.stride(0),
        ctypes.c_float(strike), int(bool(is_call)), int(bool(antithetic)),
        int(bool(with_cv)), int(quadratic), int(consts.bf16),
        ctypes.c_float(cv_discount(consts)), partial.data_ptr(),
        torch.cuda.current_stream(consts.device).cuda_stream)
    _check(err, "priced_chunk")
    priced_chunk.launches += 1
    priced_chunk.noise_launches += noise is not None
    priced_chunk.form_launches[form_name(antithetic, with_cv,
                                         consts.spectral, quadratic,
                                         consts.bf16)] += 1
    return sums_from_partials(partial, with_cv)


priced_chunk.launches = 0
priced_chunk.noise_launches = 0           # launches on injected noise
priced_chunk.form_launches = new_form_counts(FORMS + QUAD_FORMS, bf16=True)
