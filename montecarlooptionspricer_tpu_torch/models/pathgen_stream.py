"""The generic path stream: whole rough-Bergomi chunks in plain PyTorch
(counterpart: ``engine.make_chunk_pathgen`` of
``montecarlooptionspricer_tpu/models/engine.py``, the XLA generator).

The JAX package computes this generator in XLA, outside any Pallas
kernel, so it is plain PyTorch here too: ``torch.matmul`` or
``torch.fft``, and torch's own random numbers.  It carries what the
fused kernels do not: horizons past their caps, strips past the chain
kernel's 512 steps, policies other than the quadratic
(``StreamConfig.poly_order``) and ``StreamConfig.pathgen_impl="xla"``.

Per chunk, with unit-eta spectral matrices (the fGN is linear in eta):

  x_hat = Zr @ Cr - Zi @ Ci               (fgn_impl "matmul")
        = Re(FFT(phi * (Zr + i Zi)))[:n] * sqrt(2H) / M2   ("fft")
  v     = xi exp(eta x_hat - eta^2 t^{2H} / 2)
  inc   = (r - v / 2) dt + sqrt(v) dW,  dW = N(0, 1) sqrt(dt)
  S     = [s0, s0 exp(cumsum(inc))]      [rows, n_steps + 1]

Antithetic pairing is the noise plane's: Z and dW are drawn for rows / 2
rows, and rows i and i + rows / 2 are partners, (Z, dW) and (-Z, -dW).
The synthesis is linear, so it runs once per pair and the partner's plane
is -x_hat.

Two entries: ``paths_from_noise`` takes the (z, dw) planes (JAX's own
draws in the tests, held elementwise), and ``chunk_paths`` draws them from
a ``torch.Generator`` on the constants' device, seeded from a (run word,
stream index) carrier.  That stream is torch's, not JAX's threefry, so it
is held against JAX in distribution.  The matmul form runs in full float32
(TF32 pinned off).

Under ``fgn_dtype="bfloat16"`` (``StreamConfig.fgn_matmul_dtype``; JAX's
``make_chunk_pathgen(fgn_dtype=)``) the matmul synthesis takes bf16 inputs
with float32 sums: Cr and Ci rounded to bf16 (as ``_fgn_matrices_host``
casts them) and Zr, Zi rounded to bf16 before the product.  JAX draws its
normals in bf16; the stream draws float32 and rounds, which on JAX's own
draws is the identity.  The FFT synthesis ignores the dtype, as in JAX."""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..ops import fgn
from ..ops import qmc as qmc_ops
from ..ops.rng import mix64
from .pathgen_cuda import _matmul_f32, check_fgn_dtype, round_bf16

FGN_IMPLS = ("auto", "matmul", "fft")


def resolve_fgn_impl(fgn_impl: str) -> str:
    """"auto" is "matmul", as in the JAX engine's ``_resolve_fgn_impl``."""
    if fgn_impl not in FGN_IMPLS:
        raise ValueError(f"unknown fgn_impl: {fgn_impl!r}")
    return "matmul" if fgn_impl == "auto" else fgn_impl


@dataclasses.dataclass(frozen=True)
class StreamConsts:
    """What the stream reads besides noise: the market scalars, the
    variance compensator's t^{2H} row ``t_pow`` [n], and the synthesis's
    constants: ``cr``, ``ci`` [n, n] (unit-eta spectral matrices) for
    "matmul", the complex spectrum ``phi`` [n] and ``fft_scale`` for
    "fft", and ``bf16``: the matmul synthesis on bf16 inputs (``cr`` and
    ``ci`` then hold bf16 values).  Under ``qmc`` the price Brownian is
    the randomized Sobol set's, ``pca_t`` [n, n] the transposed PCA map
    (it carries the sqrt(dt) scale), the leading ``min(n, qmc_dim)``
    coordinates Sobol (and the fGN planes' too under ``qmc_fgn``).  Its
    tensors' device is where the stream runs."""

    n_steps: int
    dt: float
    s0: float
    xi: float
    r: float
    eta: float
    fgn_impl: str
    t_pow: torch.Tensor
    cr: torch.Tensor = None
    ci: torch.Tensor = None
    phi: torch.Tensor = None
    fft_scale: float = 0.0
    bf16: bool = False
    qmc: bool = False
    qmc_fgn: bool = False
    qmc_dim: int = 256
    pca_t: torch.Tensor = None
    h: float = None

    @property
    def device(self) -> torch.device:
        return self.t_pow.device

    @property
    def q_w(self) -> int:
        """Sobol coordinates of each QMC plane: min(n_steps, qmc_dim)."""
        return min(self.n_steps, self.qmc_dim)

    @property
    def qmc_dims(self) -> int:
        """Dimensions of the Sobol set: q_w, or 3 q_w under qmc_fgn."""
        return 3 * self.q_w if self.qmc_fgn else self.q_w


def _unit_eta_matrices(n_steps: int, h: float, dt: float):
    """float64 (Cr, Ci) at eta = 1, the JAX engine's
    ``_fgn_matrices_host(n, h, 1.0, dt)`` before its cast."""
    from .engine import _fgn_matrices_np

    return _fgn_matrices_np(n_steps, h, 1.0, dt)


def safe_tpow(t: torch.Tensor, p) -> torch.Tensor:
    """t ** p for t >= 0 with a tensor exponent, 0 at t = 0 in value and
    in every derivative (counterpart: the JAX engine's ``_safe_tpow``):
    ``torch.pow``'s exponent tangent t^p log t is NaN at t = 0."""
    pos = t > 0
    safe_t = torch.where(pos, t, torch.ones_like(t))
    return torch.where(pos, torch.exp(p * torch.log(safe_t)),
                       torch.zeros_like(t))


def _hurst_build(h: torch.Tensor, n_steps: int, dt: float) -> tuple:
    """float64 (Cr, Ci, t^{2H}) at eta = 1 from a float64 0-d ``h`` on its
    device: the JAX engine's in-graph ``traced_h`` build
    (``make_chunk_pathgen``) in float64, differentiable in ``h``."""
    t = torch.arange(n_steps + 1, dtype=torch.float64, device=h.device) * dt
    lam = 0.5 * safe_tpow(t, 2.0 * h)
    phi = torch.conj(torch.fft.fft(lam.to(torch.complex128),
                                   n=fgn.next_pow2(n_steps + 1)))
    cr, ci = fgn.fgn_matrices(phi, n_steps, h, 1.0, dtype=torch.float64)
    return cr, ci, safe_tpow(t[:n_steps], 2.0 * h)


def hurst_matrices(n_steps: int, dt: float, h, device,
                   fgn_dtype: str = "float32", with_dh: bool = False):
    """(cr, ci, t_pow) float32 on ``device`` at the Hurst exponent ``h``:
    the unit-eta spectral matrices [n, n] (bf16 values under
    ``fgn_dtype="bfloat16"``) and t^{2H} [n], built in float64 on the
    device and rounded once, within about an ulp of ``make_stream_consts``'s
    host build at the same H.  ``with_dh`` also returns their float32
    derivatives in H, (dcr, dci, dt_pow), by forward mode through the same
    build: the tangents of vega_h."""
    bf16 = check_fgn_dtype(fgn_dtype)
    h64 = torch.tensor(float(h), dtype=torch.float64, device=device)
    if with_dh:
        vals, tans = torch.func.jvp(
            lambda hh: _hurst_build(hh, n_steps, float(dt)), (h64,),
            (torch.ones_like(h64),))
    else:
        vals, tans = _hurst_build(h64, n_steps, float(dt)), None
    cr, ci, tp = (v.to(torch.float32) for v in vals)
    if bf16:
        cr, ci = round_bf16(cr), round_bf16(ci)
    if tans is None:
        return cr, ci, tp
    return (cr, ci, tp), tuple(v.to(torch.float32) for v in tans)


def with_market(consts: StreamConsts, s0=None, xi=None, r=None, eta=None,
                h=None) -> StreamConsts:
    """``consts`` with fresh market scalars; a new ``h`` rebuilds the
    matmul synthesis's matrices and t^{2H} (``hurst_matrices``).  Fields
    left None keep their values, and the noise draws do not change."""
    kw = {k: float(v) for k, v in (("s0", s0), ("xi", xi), ("r", r),
                                   ("eta", eta)) if v is not None}
    if h is not None and float(h) != consts.h:
        if consts.fgn_impl != "matmul":
            raise ValueError("traced_h requires the matmul fGN synthesis")
        kw["cr"], kw["ci"], kw["t_pow"] = hurst_matrices(
            consts.n_steps, consts.dt, h, consts.device,
            "bfloat16" if consts.bf16 else "float32")
        kw["h"] = float(h)
    return dataclasses.replace(consts, **kw) if kw else consts


def make_stream_consts(s0, xi, h, eta, r, n_steps: int, dt: float, device,
                       fgn_impl: str = "auto", traced_h: bool = False,
                       qmc: bool = False, fgn_dtype: str = "float32",
                       qmc_fgn: bool = False,
                       qmc_dim: int = 256) -> StreamConsts:
    """StreamConsts on ``device`` from float64 host constants (the matmul
    synthesis's matrices rounded to bf16 under ``fgn_dtype="bfloat16"``;
    the PCA map under ``qmc``).  ``traced_h`` builds the matrices and
    t^{2H} from H on the device instead (``hurst_matrices``), as the JAX
    generator's in-graph build does: the matmul synthesis only."""
    impl = resolve_fgn_impl(fgn_impl)
    if traced_h and impl != "matmul":
        raise ValueError("traced_h requires the matmul fGN synthesis")
    if qmc_fgn and not qmc:
        raise ValueError("qmc_fgn requires qmc=True")
    if qmc_fgn and impl == "fft":
        raise ValueError("qmc_fgn requires the matmul fGN synthesis (the "
                         "fft branch draws its own noise)")
    if qmc_dim < 1:
        raise ValueError("qmc_dim must be >= 1")
    bf16 = check_fgn_dtype(fgn_dtype) and impl == "matmul"
    t = torch.arange(n_steps + 1, dtype=torch.float32) * dt
    f32 = dict(dtype=torch.float32, device=device)
    kw = dict(n_steps=n_steps, dt=float(dt), s0=float(s0), xi=float(xi),
              r=float(r), eta=float(eta), fgn_impl=impl,
              t_pow=torch.pow(t[:n_steps], 2.0 * h).to(device),
              qmc=bool(qmc), qmc_fgn=bool(qmc_fgn), qmc_dim=int(qmc_dim),
              h=float(h))
    if qmc:
        kw["pca_t"] = torch.tensor(np.ascontiguousarray(
            qmc_ops.brownian_pca_matrix(n_steps, float(dt)).T), **f32)
    if traced_h:
        kw["cr"], kw["ci"], kw["t_pow"] = hurst_matrices(
            n_steps, dt, h, device, fgn_dtype)
        return StreamConsts(bf16=bf16, **kw)
    if impl == "matmul":
        cr, ci = (torch.tensor(m, **f32)
                  for m in _unit_eta_matrices(n_steps, float(h), float(dt)))
        if bf16:
            cr, ci = round_bf16(cr), round_bf16(ci)
        return StreamConsts(cr=cr, ci=ci, bf16=bf16, **kw)
    t64 = np.arange(n_steps + 1, dtype=np.float64) * dt
    phi = np.conj(np.fft.fft(0.5 * t64 ** (2.0 * h),
                             n=fgn.next_pow2(n_steps + 1)))[:n_steps]
    return StreamConsts(
        phi=torch.tensor(phi.astype(np.complex64), device=device),
        fft_scale=float(np.sqrt(2.0 * h)) / fgn.next_pow2(n_steps), **kw)


def fgn_plane(consts: StreamConsts, z: torch.Tensor) -> torch.Tensor:
    """[rows, n] unit-eta fGN plane from the [2, rows, n] (Zr, Zi)
    normals: the matmul (on bf16-rounded normals under ``consts.bf16``)
    or the FFT synthesis."""
    if consts.fgn_impl == "matmul":
        if consts.bf16:
            z = round_bf16(z)
        return _matmul_f32(z[0], consts.cr) - _matmul_f32(z[1], consts.ci)
    a = consts.phi[None, :] * torch.complex(z[0], z[1])
    x = torch.fft.fft(a, n=fgn.next_pow2(consts.n_steps), dim=-1)
    return torch.real(x)[..., :consts.n_steps] * consts.fft_scale


def paths_from_noise(consts: StreamConsts, z: torch.Tensor, dw: torch.Tensor,
                     antithetic: bool = False,
                     n_live=None) -> torch.Tensor:
    """[rows, n_steps + 1] float32 prices, s0 in column 0, from the normals
    ``z`` [2, drawn, n] and the scaled price Brownian ``dw`` [drawn, n]
    (N(0, 1) sqrt(dt), as the JAX generator draws it); rows = 2 drawn
    under ``antithetic``, the partner of row i at row i + drawn.
    ``n_live`` (< n_steps) zeroes the increments at steps >= n_live, so
    each path stays flat past its live horizon (the bucketed generator's
    padding); at n_steps or None the bits are the unmasked ones."""
    n = consts.n_steps
    if z.dim() != 3 or z.shape[0] != 2 or z.shape[2] != n or \
            tuple(dw.shape) != tuple(z.shape[1:]):
        raise ValueError(f"noise must be z [2, rows, {n}] and dw [rows, "
                         f"{n}], got {tuple(z.shape)} and {tuple(dw.shape)}")
    x = fgn_plane(consts, z)
    if antithetic:
        x, dw = torch.cat([x, -x]), torch.cat([dw, -dw])
    eta = consts.eta
    v = consts.xi * torch.exp(eta * x - 0.5 * (eta * eta) * consts.t_pow)
    del x
    inc = (consts.r - 0.5 * v) * consts.dt + torch.sqrt(
        torch.clamp_min(v, 0.0)) * dw
    del v
    if n_live is not None and n_live < n:
        inc[:, n_live:] = 0.0
    out = torch.empty((inc.shape[0], n + 1), dtype=torch.float32,
                      device=inc.device)
    out[:, 0] = consts.s0
    torch.cumsum(inc, dim=1, out=out[:, 1:])
    del inc
    out[:, 1:].add_(math.log(consts.s0)).exp_()
    return out


def paths_from_params(consts: StreamConsts, z: torch.Tensor,
                      dw: torch.Tensor, market, mats, antithetic=False,
                      n_live=None) -> torch.Tensor:
    """``paths_from_noise`` with the market ``market`` = (s0, xi, r, eta)
    and the synthesis ``mats`` = (cr, ci, t_pow) as tensors (0-d, [n, n],
    [n]), out of place throughout, so ``torch.func.jvp`` and ``vmap``
    carry their tangents (counterpart: ``gen_with_params``).  The matmul
    synthesis only (the jvp generator's, as in JAX); the noise is as
    ``paths_from_noise`` takes it."""
    s0, xi, r, eta = market
    cr, ci, t_pow = mats
    n = consts.n_steps
    zz = round_bf16(z) if consts.bf16 else z
    x = _matmul_f32(zz[0], cr) - _matmul_f32(zz[1], ci)
    if antithetic:
        x, dw = torch.cat([x, -x]), torch.cat([dw, -dw])
    v = xi * torch.exp(eta * x - 0.5 * (eta * eta) * t_pow)
    inc = (r - 0.5 * v) * consts.dt + torch.sqrt(torch.clamp_min(v, 0.0)) * dw
    if n_live is not None and n_live < n:
        live = torch.arange(n, device=inc.device) < n_live
        inc = torch.where(live, inc, torch.zeros_like(inc))
    s = torch.exp(torch.log(s0) + torch.cumsum(inc, dim=1))
    return torch.cat([s0 * torch.ones_like(s[:, :1]), s], dim=1)


def stream_generator(device, carrier) -> torch.Generator:
    """A torch.Generator on ``device`` seeded from the (run_word,
    stream_index) ``carrier`` (run word below 2^31, index below 2^32)
    through a 64-bit bijection: the card's Philox generator takes the
    whole 64-bit seed, so distinct carriers never share one; the CPU's
    Mersenne twister keeps its low 32 bits, which the mix makes depend on
    both words."""
    run, index = carrier
    gen = torch.Generator(device=device)
    gen.manual_seed(mix64((int(run) << 32) | (int(index) & 0xFFFFFFFF)))
    return gen


def pca_increments(z_lead: torch.Tensor, tail: torch.Tensor,
                   pca_t: torch.Tensor) -> torch.Tensor:
    """[rows, n] Brownian increments z @ M^T (the PCA map carries sqrt(dt))
    from the leading Sobol normals ``z_lead`` [rows, q] and the PRNG tail
    ``tail`` [rows, n - q] of the PCA coordinates, in full float32 (TF32
    off): the rotation realizes the low-discrepancy structure, and a
    rounded product would drown the sub-MC accuracy QMC buys."""
    zw = torch.cat([z_lead, tail], dim=1) if tail.shape[1] else z_lead
    return _matmul_f32(zw, pca_t)


def draw_qmc(consts: StreamConsts, drawn: int, gen: torch.Generator):
    """A QMC chunk's draws from ``gen``, in this order: the digital shift
    [qmc_dims] (int32 bit patterns), the PCA tail [drawn, n - q_w], and
    the fGN normals [2, drawn, n] (under ``qmc_fgn`` their tails [2,
    drawn, n - q_w])."""
    n, q, dev = consts.n_steps, consts.q_w, consts.device
    shift = qmc_ops.draw_shift(gen, consts.qmc_dims)
    tail = torch.randn((drawn, n - q), generator=gen, device=dev)
    z = torch.randn((2, drawn, n - q if consts.qmc_fgn else n),
                    generator=gen, device=dev)
    return shift, tail, z


def qmc_noise(consts: StreamConsts, shift: torch.Tensor,
              w_tail: torch.Tensor, z_part: torch.Tensor):
    """(z [2, rows, n], dw [rows, n]) of a QMC chunk from its draws
    (``draw_qmc``'s, or JAX's injected): the shifted Sobol normals of the
    rows' base set, the leading q_w PCA coordinates Sobol and ``w_tail``
    after them, and z the drawn fGN normals, or under ``qmc_fgn`` Sobol
    dimensions [q, 2q) and [2q, 3q) as (Zr, Zi) with ``z_part`` their
    tails (counterpart: ``make_chunk_pathgen``'s qmc branch)."""
    rows, q = w_tail.shape[0], consts.q_w
    zq = qmc_ops.normals(
        qmc_ops.base_bits(rows, consts.qmc_dims, consts.device), shift)
    dw = pca_increments(zq[:, :q], w_tail, consts.pca_t)
    if not consts.qmc_fgn:
        return z_part, dw
    lead = torch.stack([zq[:, q:2 * q], zq[:, 2 * q:]])
    return (torch.cat([lead, z_part], dim=2) if z_part.shape[2] else lead,
            dw)


def draw_noise(consts: StreamConsts, drawn: int, gen: torch.Generator):
    """(z [2, drawn, n], dw [drawn, n]) from ``gen``: standard normals,
    dw scaled by sqrt(dt); under ``qmc`` the QMC chunk's planes."""
    if consts.qmc:
        return qmc_noise(consts, *draw_qmc(consts, drawn, gen))
    n, dev = consts.n_steps, consts.device
    z = torch.randn((2, drawn, n), generator=gen, device=dev)
    dw = torch.randn((drawn, n), generator=gen, device=dev)
    return z, dw.mul_(math.sqrt(consts.dt))


def chunk_paths(consts: StreamConsts, rows: int, carrier,
                antithetic: bool = False, n_live=None) -> torch.Tensor:
    """[rows, n_steps + 1] prices of the chunk of ``carrier``: its noise
    drawn by ``stream_generator`` (rows / 2 rows under ``antithetic``),
    flat past ``n_live`` (``paths_from_noise``)."""
    if antithetic and consts.qmc:
        raise ValueError("antithetic is incompatible with qmc")
    if antithetic and rows % 2:
        raise ValueError(f"antithetic rows={rows} must be even")
    drawn = rows // 2 if antithetic else rows
    z, dw = draw_noise(consts, drawn,
                       stream_generator(consts.device, carrier))
    return paths_from_noise(consts, z, dw, antithetic, n_live)
