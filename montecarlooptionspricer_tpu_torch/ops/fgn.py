"""Spectral fractional-Gaussian-noise synthesis for the rBergomi model
(counterpart: ``montecarlooptionspricer_tpu/ops/fgn.py``, the same
functions on torch tensors).

The reference's transforms, reproduced exactly (its forward FFT uses
e^{+i...}, the conjugate of the torch/numpy forward convention, and its
inverse is e^{-i...}/n):

  phi        = conj(fft(pad(lambda, M1)))
  X[m]       = Re( fft(pad(phi[:N] * Z, M2))/M2 ) * sqrt(2H) * eta

``fractional_gaussian`` is the plain FFT form; ``fgn_matrices`` with
``fractional_gaussian_matmul`` the same map as two real [N, N] products.
The factored-DFT kernels (``models/pathgen_factored_cuda``) compute the
FFT form with a four-step split; their plain versions call
``spectral_synthesis`` with the scale folded into the diagonal.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def next_pow2(n: int) -> int:
    """Smallest power of two >= n."""
    p = 1
    while p < n:
        p <<= 1
    return p


def rbergomi_lambda(time_grid: torch.Tensor, h) -> torch.Tensor:
    """lambda_i = 0.5 * t_i^{2H}."""
    return 0.5 * torch.pow(time_grid, 2.0 * h)


def rbergomi_phi(lam: torch.Tensor) -> torch.Tensor:
    """Forward spectrum of the padded lambda sequence: a complex tensor of
    length next_pow2(len(lam))."""
    m1 = next_pow2(lam.shape[-1])
    return torch.conj(torch.fft.fft(lam, n=m1, dim=-1)).resolve_conj()


def spectral_synthesis(diag: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Re fft(pad(diag[:N] * z, M2))[..., :N] for [..., N] complex ``z``:
    the synthesis with its scale folded into ``diag``."""
    n = z.shape[-1]
    a = diag[:n] * z
    return torch.real(torch.fft.fft(a, n=next_pow2(n), dim=-1))[..., :n]


def fractional_gaussian(phi: torch.Tensor, z: torch.Tensor, h,
                        eta) -> torch.Tensor:
    """Batched fGN synthesis: [..., N] complex standard gaussians ``z`` and
    the spectrum ``phi`` (its first N entries used) -> [..., N] real fGN
    increments."""
    m2 = next_pow2(z.shape[-1])
    return math.sqrt(2.0 * h) * eta * (spectral_synthesis(phi, z) / m2)


def fgn_matrices(phi: torch.Tensor, n: int, h, eta,
                 dtype=torch.float32) -> tuple:
    """The real matrices (Cr, Ci) of the DFT-as-matmul form:
    C[k, m] = phi_k e^{-2 pi i k m / M2} sqrt(2H) eta / M2 for k, m < N.
    The angle's integer part (k*m) mod M2 is reduced exactly before it is
    formed, so the cosine never sees an argument past 2 pi (unreduced,
    k*m reaches ~1.7e7 at n = 4096 and a float32 angle carries ~1 rad of
    rounding).  The angle is float64 for a complex128 ``phi``, else
    float32.  ``h`` may be a 0-d tensor (the traced-H build), and then
    the matrices carry its tangents."""
    m2 = next_pow2(n)
    idx = np.arange(n, dtype=np.int64)
    km = (idx[:, None] * idx[None, :]) % m2
    real_t = torch.float64 if phi.dtype == torch.complex128 else torch.float32
    ang = torch.as_tensor((-2.0 * np.pi / m2) * km, dtype=real_t,
                          device=phi.device)
    if isinstance(h, torch.Tensor):
        scale = torch.sqrt(2.0 * h) * (eta / m2)
    else:
        scale = math.sqrt(2.0 * h) * eta / m2
    c = phi[:n][:, None] * torch.polar(torch.ones_like(ang), ang)
    return ((torch.real(c) * scale).to(dtype),
            (torch.imag(c) * scale).to(dtype))


def fractional_gaussian_matmul(cr, ci, zr, zi) -> torch.Tensor:
    """Matmul form of ``fractional_gaussian``: X = Zr @ Cr - Zi @ Ci."""
    return zr @ cr - zi @ ci


def forward_variance(x: torch.Tensor, time_grid: torch.Tensor, xi, h,
                     eta) -> torch.Tensor:
    """v_t = xi * exp(X_t - 0.5 eta^2 t^{2H}) on the first len(X) grid
    points."""
    n = x.shape[-1]
    t = time_grid[:n]
    ma = -0.5 * (eta * eta) * torch.pow(t, 2.0 * h)
    return xi * torch.exp(x + ma)
