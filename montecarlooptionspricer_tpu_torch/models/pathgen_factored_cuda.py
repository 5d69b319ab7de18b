"""Factored-DFT rough-Bergomi path kernels for Hopper: the spectral fGN law
at long horizons.

Counterpart: ``montecarlooptionspricer_tpu/models/pathgen_pallas_factored.py``.
Two kernels live in ``csrc/pathgen_factored.cu``:

* K8 ``factored_pathgen`` (replaces ``_factored_pathgen_kernel`` /
  ``_factored_pathgen_kernel_noise_in``): ``[rows, n_steps + 1]`` prices
  with S0 in column 0, plain or paired (``antithetic``: noise [3, rows / 2,
  m2], the drawn rows' paths, then their partners' (-Z, -W), as K1's pair
  form lays them out; stages 1 and 2 run once per drawn path, and the
  pair form's shared memory is the plain form's, so it takes every
  horizon K8 takes).
* K9 ``factored_priced_chunk`` (replaces ``_factored_priced_kernel`` /
  ``_factored_priced_kernel_noise_in``): the chunk's payoff sum under a
  log exercise-interval table, one partial sum per CUDA block, in K2's
  four forms (``antithetic``: noise [3, rows / 2, m2], each drawn row
  priced as (Z, W) and (-Z, -W); ``with_cv``: the control sum beside it),
  or under the quadratic policy table (``policy_form="quadratic"``,
  ``_priced_step:300-327``), plain and CV.

The fGN increments are the reference's spectral synthesis, half-scaled
(``FactoredConsts``): X = Re DFT_m2(Z * phi'), a length-m2 DFT
(m2 = next_pow2(n_steps)) of the complex fGN noise Z with the diagonal
phi' = 0.5 sqrt(2H) eta phi / m2 in front (zero at k >= n_steps).  The
kernels split it four-step, k = N2 k1 + k2 and m = m1 + 128 j
(N2 = m2 / 128): stage 1 is a 128-point FFT over k1 of each (path, k2)
row, then the twiddle W_m2^{k2 m1}; stage 2 is an N2-point FFT over k2 of
each (path, m1) column, output j being step tile j.  The roots of unity
come from the host tables (F1's row 1 and the stage-2 table's row 1).
The bf16 form keeps stage 1 as the dense [rows N2, 128] x [128, 128]
product against F1 on the tensor cores.  The noise is stored
transposed, so stage 1 reads it in place: storage column c = 128 k2 + k1
holds logical frequency k = N2 k1 + k2 (``transposed_to_logical``).  The
Euler recursion and the first-hit test are those of the other kernels, and
the plain versions share their code (``pathgen_cuda.log_paths_from_x``,
``priced_sums``).

Both also run with bf16 fGN inputs (``make_factored_consts(
fgn_dtype="bfloat16")``; counterpart: ``fgn_dtype`` of the JAX makers,
``_consts:129-131`` and ``_stage1:158``): F1 is a torch.bfloat16 matrix
(the float32 F1 rounded to nearest even), the kernels round a = Z * phi'
to bf16 and run stage 1 on the tensor cores with float32 sums; phi', the
twiddle, stage 2 and everything after stay float32, as in JAX.  The plain
version is then the four-step split itself (``four_step_x``), the
rounding sitting on stage 1's inputs, which the FFT has no place for.
The counters count these forms as "bf16", "bf16/anti", ...,
"bf16/quad/cv".

Noise layout (the JAX noise-in entry's): [3, rows, m2] float32, planes 0
and 1 the real and imaginary fGN normals in storage order, plane 2 the
price Brownian in step order (its first s_pad columns read).

Random stream of the seeded entries (fixed, written in
``csrc/philox.cuh``; ``philox_factored_normals_ref`` reproduces it), with
key = (fold(run_word, stream_index), 0) as for the other kernels and p the
path's global row: counter (p, i, 1, 0) gives the fGN noise of storage
columns 2i and 2i+1, (Zr, Zi) = (radius cos, radius sin) of the
Box-Muller pair of (x0, x1) and of (x2, x3) in turn; counter (p, q, 2, 0)
gives the price Brownian of steps 4q .. 4q+3, the cos and sin of the pair
of (x0, x1), then of (x2, x3).  The third counter word keeps it apart
from the stream of K1-K7 (third word 0).

The wrappers run the plain versions for tensors on the CPU and launch the
kernel for tensors on a CUDA device; nothing falls back.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import numpy as np
import torch

from ..ops import fgn
from . import pathgen_cuda as pc

LANE = pc.LANE

# ---------------------------------------------------------------------------
# The card's memory model (mirrors csrc/pathgen_factored.cu).

STAGE1_ROWS = 64        # (path, k2) rows of stage 1 per block
MAX_N2 = STAGE1_ROWS    # a block holds at least one path
ROW_STRIDE = LANE + 16  # floats a row of the Re and Im planes
THREADS = 256
# The staging region: the bf16 form's F1 k-tiles (two [128][40] bf16
# planes), then four steps a thread of the decision's table rows, for two
# tiles at once (one under the quadratic policy).
F1_TILE_FLOATS = LANE * 40
STAGED_ROWS = {"path": 0, "boundary": 3, "quadratic": 8}
STAGED_TILES = {"path": 0, "boundary": 2, "quadratic": 1}


def _n2(n_steps: int) -> int:
    return fgn.next_pow2(n_steps) // LANE


def paths_per_block(n_steps: int) -> int:
    """Paths of one CUDA block: STAGE1_ROWS / N2."""
    return STAGE1_ROWS // _n2(n_steps)


def smem_bytes(n_steps: int, policy: str = "quadratic") -> int:
    """Shared memory of one CUDA block of K8 (``policy="path"``) or of K9
    under the ``"boundary"`` or ``"quadratic"`` policy, the same at every
    horizon and in both fGN input dtypes: the Re and Im planes (STAGE1_ROWS
    rows of ROW_STRIDE floats, the third and fourth of each group of four
    rows shifted by 8 floats), the root tables (W_128 and W_N2 up to
    MAX_N2, complex) and the staging region.  The default is the largest
    form's, K9's quadratic one, what ``mcop_factored_smem_bytes`` reports."""
    del n_steps
    plane = STAGE1_ROWS * ROW_STRIDE + 8
    roots = 2 * LANE + 2 * MAX_N2
    stage = max(F1_TILE_FLOATS,
                THREADS * 4 * STAGED_ROWS[policy] * STAGED_TILES[policy])
    return 4 * (2 * plane + roots + stage)


def max_factored_steps() -> int:
    """Largest horizon K8/K9 take: the longest m2 whose block holds at
    least one path (N2 <= STAGE1_ROWS) inside the card's shared memory."""
    best, m2 = 0, 2 * LANE
    while m2 // LANE <= MAX_N2 and smem_bytes(m2) <= pc.SMEM_LIMIT:
        best, m2 = m2, 2 * m2
    return best


def supports(n_steps: int) -> bool:
    """Steps must span two step tiles (a shorter horizon is the single-tile
    kernels' work) and fit ``max_factored_steps``."""
    return LANE < n_steps <= max_factored_steps()


# ---------------------------------------------------------------------------
# Host constants.

@dataclasses.dataclass(frozen=True)
class FactoredConsts:
    """What K8 and K9 read besides noise and policy (counterpart:
    ``pathgen_pallas_factored._consts``): the stage-1 DFT matrix ``f1r``,
    ``f1i`` [128, 128], the half-scaled spectral diagonal in storage order
    ``phi_r``, ``phi_i`` [N2, 128], the twiddle ``tw_r``, ``tw_i``
    [N2, 128], the stage-2 table ``c2``, ``s2`` [N2, N2] (cos and sin of
    2 pi ((k2 j) mod N2) / N2), the half variance drift ``vd`` [n] and
    the market scalars.  Under ``fgn_dtype="bfloat16"`` F1 is
    torch.bfloat16 and the rest stays float32.  Its tensors' device
    decides where the wrappers run."""

    n_steps: int
    f1r: torch.Tensor
    f1i: torch.Tensor
    phi_r: torch.Tensor
    phi_i: torch.Tensor
    tw_r: torch.Tensor
    tw_i: torch.Tensor
    c2: torch.Tensor
    s2: torch.Tensor
    vd: torch.Tensor
    s0: float
    r: float
    dt: float
    fgn_dtype: str = "float32"

    @property
    def device(self) -> torch.device:
        return self.vd.device

    @property
    def bf16(self) -> bool:
        """Whether these are the bf16 fGN-input form's constants."""
        return self.fgn_dtype == "bfloat16"

    def check_dtype(self) -> None:
        """F1 in the dtype its form names, torch.bfloat16 under
        ``fgn_dtype="bfloat16"`` and float32 otherwise (ValueError on a
        mismatch, so no kernel reads one as the other)."""
        want = torch.bfloat16 if self.bf16 else torch.float32
        if self.f1r.dtype != want or self.f1i.dtype != want:
            raise ValueError(
                f"fgn_dtype={self.fgn_dtype!r} needs {want} F1, got "
                f"{self.f1r.dtype}, {self.f1i.dtype}")

    @property
    def m2(self) -> int:
        return fgn.next_pow2(self.n_steps)

    @property
    def s_pad(self) -> int:
        return pc._round_up(self.n_steps, LANE)


def _unit_root(num: np.ndarray, den: int) -> np.ndarray:
    """exp(-2 pi i num / den) in float64, num reduced mod den exactly."""
    return np.exp((-2j * np.pi / den) * (num % den))


def make_factored_consts(s0, xi, h, eta, r, n_steps: int, dt: float,
                         device, fgn_dtype: str = "float32") -> FactoredConsts:
    """FactoredConsts built in float64 on the host and cast once to
    float32 (F1 then to bf16 under ``fgn_dtype="bfloat16"``).  The
    diagonal carries the half-scaling of the other kernels' ``lt_half``:
    with the extra 0.5, exp(x + vd) is sqrt(v).  No Cholesky factor is
    built."""
    bf16 = pc.check_fgn_dtype(fgn_dtype)
    if not supports(n_steps):
        raise ValueError(f"n_steps={n_steps} outside the factored kernels' "
                         f"range ({LANE} < n <= {max_factored_steps()})")
    m2 = fgn.next_pow2(n_steps)
    n2 = m2 // LANE
    t = torch.arange(n_steps + 1, dtype=torch.float64) * dt
    phi = fgn.rbergomi_phi(fgn.rbergomi_lambda(t, h)).numpy()
    a_diag = np.zeros(m2, np.complex128)
    a_diag[:n_steps] = phi[:n_steps] * (0.5 * math.sqrt(2.0 * h) * eta / m2)
    k1 = np.arange(LANE, dtype=np.int64)
    k2 = np.arange(n2, dtype=np.int64)
    phi_t = a_diag[n2 * k1[None, :] + k2[:, None]]             # [n2, 128]
    f1 = _unit_root(np.outer(k1, k1), LANE)                     # [k1, m1]
    tw = _unit_root(np.outer(k2, k1), m2)                       # [k2, m1]
    st2 = _unit_root(np.outer(k2, k2), n2)                      # [k2, j]

    def dev(v, dtype=torch.float32):
        t = torch.tensor(v, dtype=torch.float32).to(dtype)
        return t.to(device).contiguous()

    f1_dtype = torch.bfloat16 if bf16 else torch.float32
    vd = pc._half_var_drift(n_steps, n_steps, xi, h, eta, dt)[0]
    # W_N2^{k2 j} = cos - i sin: stage 2 adds Re S' cos + Im S' sin.
    return FactoredConsts(
        n_steps=n_steps, f1r=dev(f1.real, f1_dtype),
        f1i=dev(f1.imag, f1_dtype), phi_r=dev(phi_t.real),
        phi_i=dev(phi_t.imag), tw_r=dev(tw.real), tw_i=dev(tw.imag),
        c2=dev(st2.real), s2=dev(-st2.imag), vd=vd.to(device).contiguous(),
        s0=float(s0), r=float(r), dt=float(dt), fgn_dtype=fgn_dtype)


def transposed_to_logical(cols: int) -> torch.Tensor:
    """Column permutation from the kernels' transposed fGN-noise storage
    (flat c = 128 k2 + k1) to logical frequency order (k = N2 k1 + k2):
    given a stored plane ZT, the logical plane is Z[:, perm] = ZT."""
    n2 = cols // LANE
    k1 = torch.arange(LANE)
    k2 = torch.arange(n2)
    return (n2 * k1[None, :] + k2[:, None]).reshape(-1)


def _to_logical(plane: torch.Tensor) -> torch.Tensor:
    """[..., m2] stored in (k2, k1) order -> logical frequency order."""
    m2 = plane.shape[-1]
    lead = plane.shape[:-1]
    return plane.reshape(*lead, m2 // LANE, LANE).transpose(-1, -2) \
        .reshape(*lead, m2)


# ---------------------------------------------------------------------------
# The seeded stream, reproduced.

def philox_factored_normals_ref(key: int, rows: int, n_steps: int,
                                device="cpu", row0: int = 0,
                                block_rows: int = 1 << 14) -> torch.Tensor:
    """[3, rows, m2] float32 noise of the seeded kernels' stream (module
    docstring) for chunk rows row0 .. row0 + rows - 1, computed in blocks
    of ``block_rows`` rows to bound the int64 temporaries."""
    m2 = fgn.next_pow2(n_steps)
    out = torch.empty((3, rows, m2), dtype=torch.float32, device=device)
    k = key & pc._U32
    for b0 in range(0, rows, block_rows):
        nb = min(block_rows, rows - b0)
        p = torch.arange(row0 + b0, row0 + b0 + nb, dtype=torch.int64,
                         device=device)[:, None]
        j = torch.arange(m2 // 2, dtype=torch.int64, device=device)[None, :]
        pp, jj = p.expand(nb, m2 // 2), j.expand(nb, m2 // 2)
        x0, x1, x2, x3 = pc.philox4x32_10(pp, jj, torch.full_like(pp, 1),
                                          torch.zeros_like(pp), k, 0)
        c_a, s_a = pc._box_muller(x0, x1)
        c_b, s_b = pc._box_muller(x2, x3)
        out[0, b0:b0 + nb] = torch.stack([c_a, c_b], -1).reshape(nb, m2)
        out[1, b0:b0 + nb] = torch.stack([s_a, s_b], -1).reshape(nb, m2)
        out[2, b0:b0 + nb] = pc.normal_quads_ref(k, nb, m2, 2, device,
                                                 row0 + b0)
    return out


# ---------------------------------------------------------------------------
# Plain versions (the CPU path, and the card's reference).

def four_step_x(consts: FactoredConsts, noise: torch.Tensor,
                block_rows: int = 1 << 14) -> torch.Tensor:
    """[rows, n_steps] half-scaled fGN increments from [3, rows, m2] noise
    by the kernels' own four-step split (``_stage1:158``, then stage 2):
    a = Z * phi' in float32, each product and sum rounded apart in the
    kernels' order (rounded to bf16 under the bf16 form, with the bf16
    F1); S = a @ F1 with float32 products and sums; the float32 twiddle;
    and x = Re S' @ cos2 + Im S' @ sin2 over k2.  The rows go in blocks of
    ``block_rows`` to bound the temporaries."""
    n, m2, n2 = consts.n_steps, consts.m2, _n2(consts.n_steps)
    rows = noise.shape[1]
    f1r = consts.f1r.to(torch.float32)
    f1i = consts.f1i.to(torch.float32)
    out = torch.empty((rows, n), dtype=torch.float32, device=noise.device)
    for b0 in range(0, rows, block_rows):
        zr = noise[0, b0:b0 + block_rows].reshape(-1, n2, LANE)
        zi = noise[1, b0:b0 + block_rows].reshape(-1, n2, LANE)
        ar = zr * consts.phi_r - zi * consts.phi_i
        ai = zr * consts.phi_i + zi * consts.phi_r
        if consts.bf16:
            ar, ai = pc.round_bf16(ar), pc.round_bf16(ai)
        sr = pc._matmul_f32(ar, f1r) - pc._matmul_f32(ai, f1i)
        si = pc._matmul_f32(ar, f1i) + pc._matmul_f32(ai, f1r)
        spr = sr * consts.tw_r - si * consts.tw_i     # [rows, k2, m1]
        spi = sr * consts.tw_i + si * consts.tw_r
        x = (pc._matmul_f32(spr.transpose(1, 2), consts.c2)
             + pc._matmul_f32(spi.transpose(1, 2), consts.s2))   # [., m1, j]
        out[b0:b0 + block_rows] = x.transpose(1, 2).reshape(-1, m2)[:, :n]
    return out


def fgn_from_noise_ref(consts: FactoredConsts,
                       noise: torch.Tensor) -> torch.Tensor:
    """[rows, n_steps] half-scaled fGN increments from [3, rows, m2] noise:
    planes 0 and 1 permuted to logical order, then the reference's
    spectral synthesis with the half-scaled diagonal; under the bf16 form
    the four-step split (``four_step_x``), where the rounding of stage
    1's inputs has its place."""
    if consts.bf16:
        return four_step_x(consts, noise)
    n, m2 = consts.n_steps, consts.m2
    diag = torch.complex(_to_logical(consts.phi_r.reshape(m2)),
                         _to_logical(consts.phi_i.reshape(m2)))
    z = torch.complex(_to_logical(noise[0])[:, :n],
                      _to_logical(noise[1])[:, :n])
    return fgn.spectral_synthesis(diag, z)


def _log_paths_ref(consts: FactoredConsts, noise: torch.Tensor,
                   antithetic: bool = False) -> torch.Tensor:
    x, w = fgn_from_noise_ref(consts, noise), noise[2, :, :consts.n_steps]
    if antithetic:
        x, w = pc.pair_planes(x, w)
    return pc.log_paths_from_x(consts, x, w)


def factored_pathgen_from_noise_ref(consts: FactoredConsts,
                                    noise: torch.Tensor,
                                    antithetic: bool = False) -> torch.Tensor:
    """Plain K8: [3, rows, m2] noise -> [rows, n_steps + 1] prices; with
    ``antithetic`` [2 rows, n_steps + 1], the partners below the drawn
    rows."""
    return pc.prices_from_log(_log_paths_ref(consts, noise, antithetic),
                              consts.s0)


def factored_priced_chunk_from_noise_ref(consts: FactoredConsts,
                                         table: torch.Tensor,
                                         noise: torch.Tensor, strike: float,
                                         is_call: bool,
                                         antithetic: bool = False,
                                         with_cv: bool = False,
                                         policy_form: str = "boundary"):
    """Plain K9: the chunk's payoff sum (0-d float32) under the log
    exercise-interval table (log_boundary_rows layout), or under
    ``policy_form="quadratic"`` the policy_rows table; with
    ``antithetic`` the rows of ``noise`` are priced as pairs, with
    ``with_cv`` the result is (payoff sum, control sum)."""
    return pc.priced_sums(consts, _log_paths_ref(consts, noise, antithetic),
                          table, strike, is_call, with_cv, policy_form)


# ---------------------------------------------------------------------------
# Wrappers: plain version for CPU tensors, the kernel for CUDA tensors.

def _noise_or_rows(consts: FactoredConsts, rows, key, noise,
                   antithetic: bool = False) -> int:
    """The chunk's path count: ``rows`` for the seeded entry, else from
    the noise [3, rows (rows / 2 when antithetic), m2]."""
    if (key is None) == (noise is None):
        raise ValueError("pass exactly one of key (seeded) or noise")
    if noise is None:
        if rows is None:
            raise ValueError("the seeded entry needs rows")
        if antithetic and rows % 2:
            raise ValueError(f"antithetic rows={rows} must be even")
        return rows
    if noise.dim() != 3 or noise.shape[0] != 3 or noise.shape[2] != consts.m2:
        raise ValueError(f"noise must be [3, rows, {consts.m2}], got "
                         f"{tuple(noise.shape)}")
    return noise.shape[1] * (2 if antithetic else 1)


def _const_ptrs(consts: FactoredConsts, rows: int, noise,
                drawn: int = None) -> tuple:
    """Validated leading arguments of a launch: the noise pointer (None
    for the seeded entry), the nine constant tensors' pointers, the rows
    and the horizon.  ``drawn`` (default ``rows``) rows of noise must
    fill whole blocks."""
    pc.check_device_inputs(consts, noise)
    if noise is not None and noise.data_ptr() % 16:
        raise ValueError("noise must start on a 16-byte boundary (the "
                         "kernels read it as float4)")
    tensors = (consts.f1r, consts.f1i, consts.phi_r, consts.phi_i,
               consts.tw_r, consts.tw_i, consts.c2, consts.s2, consts.vd)
    for t in tensors:
        if t.device != consts.device or not t.is_contiguous():
            raise ValueError("FactoredConsts tensors must be contiguous on "
                             "one device")
    per = paths_per_block(consts.n_steps)
    drawn = rows if drawn is None else drawn
    if drawn < 1 or drawn % per:
        raise ValueError(f"{drawn} rows of noise must be a positive multiple "
                         f"of the {per} drawn paths of a block at n_steps="
                         f"{consts.n_steps}")
    return (None if noise is None else noise.data_ptr(),
            *(t.data_ptr() for t in tensors), rows, consts.n_steps)


def blocks_per_sm(consts: FactoredConsts, priced: bool = True,
                  antithetic: bool = False, with_cv: bool = False,
                  policy_form: str = "boundary") -> int:
    """Blocks of K8 (``priced=False``) or K9 one SM of the card runs at
    once in the form of ``consts`` (its fGN input dtype), ``antithetic``,
    ``with_cv`` and ``policy_form`` (the CUDA runtime's occupancy query on
    the seeded body)."""
    quadratic = priced and pc.check_policy(policy_form, antithetic)
    from ..kernels import build

    got = build.entry(build.load(), "pathgen_factored",
                      "mcop_factored_blocks_per_sm", consts.bf16)(
        consts.n_steps, int(priced), int(antithetic), int(with_cv),
        int(quadratic))
    if got < 0:
        raise RuntimeError(f"mcop_factored_blocks_per_sm failed: cudaError "
                           f"{-got}")
    return got


def _key_word(key) -> int:
    return 0 if key is None else key & pc._U32


def factored_pathgen(consts: FactoredConsts, rows: int = None,
                     key: int = None, noise: torch.Tensor = None,
                     antithetic: bool = False) -> torch.Tensor:
    """K8: [rows, n_steps + 1] float32 prices, S0 in column 0, from the
    seeded stream of ``key`` or from injected ``noise`` [3, rows, m2].
    With ``antithetic`` the rows are rows / 2 pairs (the seeded entry
    draws rows / 2 rows, noise is [3, rows / 2, m2]): the drawn rows'
    paths, then their partners'."""
    rows = _noise_or_rows(consts, rows, key, noise, antithetic)
    consts.check_dtype()
    drawn = pc.drawn_rows(rows, antithetic)
    if consts.device.type == "cpu":
        if noise is None:
            noise = philox_factored_normals_ref(key, drawn, consts.n_steps)
        return factored_pathgen_from_noise_ref(consts, noise, antithetic)
    ptrs = _const_ptrs(consts, rows, noise, drawn)
    out = torch.empty((rows, consts.n_steps + 1), dtype=torch.float32,
                      device=consts.device)
    from ..kernels import build

    err = build.entry(build.load(), "pathgen_factored",
                      "mcop_factored_pathgen", consts.bf16)(
        *ptrs, _key_word(key), *pc._scalars(consts), ctypes.c_float(consts.s0),
        int(bool(antithetic)), int(consts.bf16), out.data_ptr(),
        torch.cuda.current_stream(consts.device).cuda_stream)
    pc._check(err, "factored_pathgen")
    factored_pathgen.launches += 1
    factored_pathgen.form_launches[pc.form_name(antithetic,
                                                bf16=consts.bf16)] += 1
    return out


factored_pathgen.launches = 0
factored_pathgen.form_launches = dict.fromkeys(
    [*pc.PATH_FORMS, *pc.bf16_names(pc.PATH_FORMS)], 0)


def factored_priced_chunk(consts: FactoredConsts, table: torch.Tensor,
                          strike: float, is_call: bool, rows: int = None,
                          key: int = None, noise: torch.Tensor = None,
                          antithetic: bool = False, with_cv: bool = False,
                          policy_form: str = "boundary"):
    """K9: the chunk's discounted payoff sum (0-d float32 tensor) under the
    log_boundary_rows ``table`` (``policy_form="quadratic"``: the
    policy_rows ``table``), from the seeded stream of ``key`` or from
    injected ``noise`` [3, rows, m2], and with ``with_cv`` the control sum
    beside it.  With ``antithetic`` (the boundary policy only) the chunk's
    ``rows`` paths are rows / 2 pairs (the seeded entry draws rows / 2
    rows; noise is [3, rows / 2, m2]).  Each block writes one partial sum
    per lane and the blocks are summed in a fixed order, so a seed gives
    the same sums every run."""
    quadratic = pc.check_policy(policy_form, antithetic)
    rows = _noise_or_rows(consts, rows, key, noise, antithetic)
    pc.check_table(table, consts.n_steps, quadratic)
    consts.check_dtype()
    drawn = pc.drawn_rows(rows, antithetic)
    if consts.device.type == "cpu":
        if noise is None:
            noise = philox_factored_normals_ref(key, drawn, consts.n_steps)
        return factored_priced_chunk_from_noise_ref(
            consts, table, noise, strike, is_call, antithetic, with_cv,
            policy_form)
    ptrs = _const_ptrs(consts, rows, noise, drawn)
    pc.check_device_inputs(consts, None, table)
    partial = torch.empty(
        (2 if with_cv else 1, drawn // paths_per_block(consts.n_steps)),
        dtype=torch.float32, device=consts.device)
    from ..kernels import build

    err = build.entry(build.load(), "pathgen_factored",
                      "mcop_factored_priced_chunk", consts.bf16)(
        *ptrs, _key_word(key), *pc._scalars(consts), table.data_ptr(),
        table.stride(0), ctypes.c_float(strike), int(bool(is_call)),
        int(bool(antithetic)), int(bool(with_cv)), int(quadratic),
        int(consts.bf16), ctypes.c_float(pc.cv_discount(consts)),
        partial.data_ptr(),
        torch.cuda.current_stream(consts.device).cuda_stream)
    pc._check(err, "factored_priced_chunk")
    factored_priced_chunk.launches += 1
    factored_priced_chunk.noise_launches += noise is not None
    factored_priced_chunk.form_launches[pc.form_name(
        antithetic, with_cv, quadratic=quadratic, bf16=consts.bf16)] += 1
    return pc.sums_from_partials(partial, with_cv)


factored_priced_chunk.launches = 0
factored_priced_chunk.noise_launches = 0  # launches on injected noise
factored_priced_chunk.form_launches = dict.fromkeys(
    [*pc.FORMS, *pc.QUAD_FORMS, *pc.bf16_names(pc.FORMS + pc.QUAD_FORMS)], 0)
