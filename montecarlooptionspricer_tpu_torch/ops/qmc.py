"""Randomized quasi-Monte Carlo path noise (counterpart:
``montecarlooptionspricer_tpu/ops/qmc.py``).

One scrambled Sobol base point set per (points, dim) shape, generated on
the host (``scipy.stats.qmc``) and stored as uint32 fixed-point digits;
each randomization applies a RANDOM DIGITAL SHIFT (XOR of the base-2
digits with one random word per dimension) on the device.  The digital
shift is the structure-preserving randomization for digital nets (an
additive Cranley-Patterson rotation would break the net property), and
independent shifts give independent unbiased estimates.  Uniforms map to
normals with the inverse CDF (``ndtri``), the QMC-correct transform
(Box-Muller would scramble the low-discrepancy structure).

torch has few uint32 kernels, so the digits live on the device as int32
bit patterns: XOR is the same on either, and the logical right shift of
the uint32 is the arithmetic shift of the int32 masked to its low bits.
The shift words come from an explicit ``torch.Generator`` (``draw_shift``)
or are injected, as the tests inject JAX's ``jax.random.bits``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# The uniform's 23 top digits: u = (top23 + 0.5) * 2^-23.
_TOP_MASK = (1 << 23) - 1
_TOP_SCALE = 1.0 / (1 << 23)


@functools.lru_cache(maxsize=32)
def sobol_base(n_paths: int, dim: int, seed: int = 0) -> np.ndarray:
    """[n_paths, dim] uint32 scrambled-Sobol base points in fixed point
    (u * 2^32), cached per shape and read-only: the same scipy call as
    the JAX package's, so the same bits.

    Non-power-of-two counts keep the first n of the next 2^m points; a
    partial base-2 block loses some of the net's balance, but an
    Owen-scrambled Sobol prefix remains low-discrepancy.  Use
    power-of-two path counts for the full guarantee."""
    from scipy.stats import qmc

    m = max(1, int(np.ceil(np.log2(max(n_paths, 2)))))
    eng = qmc.Sobol(d=dim, scramble=True, seed=seed)
    pts = eng.random_base2(m)[:n_paths]
    out = np.floor(pts * float(1 << 32)).astype(np.uint64).astype(np.uint32)
    out.setflags(write=False)
    return out


def as_bits(words) -> torch.Tensor:
    """uint32 words (a numpy array, e.g. ``sobol_base`` or JAX's
    ``jax.random.bits``) as an int32 tensor of the same bit patterns."""
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(words, dtype=np.uint32)).view(np.int32).copy())


@functools.lru_cache(maxsize=16)
def base_bits(n_paths: int, dim: int, device) -> torch.Tensor:
    """``sobol_base(n_paths, dim)`` as int32 bit patterns on ``device``,
    cached (a chunk's base at 131,072 points and 256 dims is 134 MB)."""
    return as_bits(sobol_base(n_paths, dim)).to(device)


def draw_shift(gen: torch.Generator, dim: int) -> torch.Tensor:
    """[dim] random uint32 words (as int32 bit patterns) from ``gen``, on
    its device: one digital shift."""
    return torch.randint(-(1 << 31), 1 << 31, (dim,), dtype=torch.int32,
                         generator=gen, device=gen.device)


def rotate(base: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Random digital shift: XOR every point's base-2 digits with one
    uint32 word per dimension (``base`` [n, dim] and ``shift`` [dim] as
    int32 bit patterns), then map to STRICTLY interior (0, 1) float32
    uniforms so ndtri stays finite.

    The interior guarantee is exact, not approximate: u = (top23 + 0.5)
    * 2^-23.  top23 + 0.5 is integer-exact in float32 (it needs 24
    significand bits), the 2^-23 scale is a power of two, so u ranges
    over [2^-24, 1 - 2^-24] with NO rounding; a +0.5ulp offset on a
    24-bit uniform is NOT safe: for all-ones top bits it lands exactly
    halfway to 1.0 and round-to-even returns 1.0, so ndtri(u) = +inf
    would poison ~1/128 of dimensions per digital shift at 2^17-point
    nets."""
    top = ((base ^ shift) >> 9) & _TOP_MASK
    return (top.to(torch.float32) + 0.5) * _TOP_SCALE


def normals(base: torch.Tensor, shift: torch.Tensor,
            dtype=torch.float32) -> torch.Tensor:
    """Digitally shifted QMC standard normals via the inverse CDF, the
    ndtri evaluated in ``dtype`` on the exact float32 uniforms (float64
    and back is the PredictionGen synthesis's choice)."""
    return torch.special.ndtri(rotate(base, shift).to(dtype))


@functools.lru_cache(maxsize=32)
def brownian_pca_matrix(n_steps: int, dt: float) -> np.ndarray:
    """[n, n] map M with dw = z @ M.T for z ~ N(0, I): the principal-
    components construction of a Brownian path, read-only.

    Columns of U sqrt(L) are ordered by decreasing eigenvalue of the
    Brownian covariance dt*min(i+1, j+1), so the first QMC coordinates
    carry most of the path's variance (the standard effective-dimension
    reduction that makes low-discrepancy points pay off for path-dependent
    payoffs).  The same NumPy calls as the JAX package's, so the same
    bits."""
    i = np.arange(1, n_steps + 1, dtype=np.float64)
    cov = dt * np.minimum(i[:, None], i[None, :])
    vals, vecs = np.linalg.eigh(cov)
    order = np.argsort(vals)[::-1]
    a = vecs[:, order] * np.sqrt(np.maximum(vals[order], 0.0))[None, :]
    # Difference to increments: dw_k = W_k - W_{k-1}.
    m = np.asarray(np.diff(a, axis=0, prepend=np.zeros((1, n_steps))),
                   np.float32)
    m.setflags(write=False)
    return m
