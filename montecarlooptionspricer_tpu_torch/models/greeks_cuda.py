"""The pathwise Greeks kernels K3 and K4 for Hopper, their plain PyTorch
version and their shared-memory model.

Counterparts: ``make_pallas_greeks_chunk`` and
``make_pallas_chain_greeks_chunk`` in
``montecarlooptionspricer_tpu/models/pathgen_pallas.py``.  One device body
in ``csrc/greeks.cu`` serves both:

* K3 ``greeks_chunk`` (replaces ``_greeks_kernel`` /
  ``_greeks_kernel_noise_in``): one strike, given as an argument;
* K4 ``chain_greeks_chunk`` (replaces ``_chain_greeks_kernel`` /
  ``_noise_in`` / ``_grid``): a strike strip, each strike read from row 3
  of its table.

Both return the chunk's sums of price, delta, vega_xi, vega_eta, rho_rate
and vega_h (``GREEK_ORDER``) under the log_boundary_rows policy held
fixed: forward tangents of the policy value, written out as
``_tangent_planes`` and ``_greek_stop_vals`` do (the module docstring of
the CUDA source gives the algebra).  Their ``antithetic`` forms (the
pair branch of ``_tangent_planes``) price each drawn row as the pair (N,
W), (-N, -W): both fGN products run once per pair, and the partner takes
-x', -hx and -W, nothing else negated.  Both run in the fGN input dtype
of their constants: float32, or bf16 (``make_path_consts`` and
``make_greeks_consts`` with ``fgn_dtype="bfloat16"``, the JAX makers'
``fgn_dtype=jnp.bfloat16``): Lt' and dLt' are bf16, the kernel rounds N
to bf16 and sums both products on the tensor cores in float32, and the
plain version takes the float32 products of the same bf16 values
(``pathgen_cuda.fgn_matmul_ref``); the counters count "bf16" and
"bf16/anti".  The seeded entries draw K1's and K2's Philox stream.  The
wrappers run the plain version for tensors on the CPU and launch the
kernel for tensors on a CUDA device; nothing falls back.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import pathgen_cuda as pc

GREEK_ORDER = ("price", "delta", "vega_xi", "vega_eta", "rho_rate",
               "vega_h")

# ---------------------------------------------------------------------------
# The card's memory model (mirrors csrc/greeks.cu).

GROUP = 32                  # strikes one launch sweeps (csrc/greeks.cu kGroup)
STAGED_STRIKE_FLOATS = 2 * pc.TILE_COLS   # a strike's staged rows, one tile
FORMS = pc.FORMS[:2]   # the forms of K3 and K4
# The counters' keys: each form in float32 and in the bf16 fGN-input form.
FORM_KEYS = (*FORMS, *pc.bf16_names(FORMS))


def smem_bytes(n_steps: int, block_paths: int, antithetic: bool = False,
               bf16: bool = False, n_strikes: int = GROUP) -> int:
    """Shared memory of one CUDA block: the N plane of the drawn rows (no W
    plane, which the kernels draw per tile), four step tiles of every path
    (pair member when ``antithetic``: x' and hx, then the running sums;
    they also hold the block's sums at the end), the staged Lt' and dLt'
    rows and the log lo and log hi rows of a launch's ``n_strikes``
    strikes for one tile; under ``bf16`` the N plane and the two staged
    factor tiles in bf16."""
    drawn = pc.drawn_rows(block_paths, antithetic)
    return pc.block_smem_bytes(
        n_steps, drawn, n_products=2,
        extra=(4 * block_paths - 2 * drawn) * (pc.TILE_COLS + 1)
        + n_strikes * STAGED_STRIKE_FLOATS, bf16=bf16, w_plane=False)


def supports(n_steps: int) -> bool:
    """Whether K3 and K4 take this horizon."""
    return n_steps >= 1 and pc.fitting_block(smem_bytes, n_steps) > 0


def block_paths_for(n_steps: int, rows: int, antithetic: bool = False,
                    bf16: bool = False) -> int:
    """The Greeks kernels' path block: the largest of
    pathgen_cuda.BLOCK_CHOICES (PAIRED_BLOCK_CHOICES, in pair members, when
    ``antithetic``) whose shared memory at GROUP strikes fits at this
    horizon and which divides ``rows``: 64 at 365 steps, 64 paired, in
    float32 and bf16."""
    bp = pc.fitting_block(lambda n, b: smem_bytes(n, b, antithetic, bf16),
                          n_steps, rows, antithetic)
    if not bp:
        raise ValueError(f"no Greeks block divides rows={rows} at "
                         f"n_steps={n_steps}")
    return bp


def blocks_per_sm(consts: pc.PathConsts, rows: int, n_strikes: int = GROUP,
                  antithetic: bool = False) -> int:
    """Blocks of K3 (``n_strikes`` 1) or K4 one SM of the card runs at
    once in the dtype of ``consts``, ``antithetic``, at the block
    ``block_paths_for`` picks (the CUDA runtime's occupancy query on the
    seeded body)."""
    bp = block_paths_for(consts.n_steps, rows, antithetic, consts.bf16)
    from ..kernels import build

    got = build.entry(build.load(), "greeks", "mcop_greeks_blocks_per_sm",
                      consts.bf16)(consts.n_steps, bp, int(antithetic),
                                   n_strikes)
    if got < 0:
        raise RuntimeError(f"mcop_greeks_blocks_per_sm failed: cudaError "
                           f"{-got}")
    return got


def _to_greek_order(sums: torch.Tensor, consts: pc.PathConsts,
                    gconsts: pc.GreeksConsts) -> torch.Tensor:
    """Raw sums [6, ...] -> GREEK_ORDER, in place: delta divided by s0,
    vega_xi by 2 xi.  Scalar multiplies, so nothing is copied from the
    host and the stream never waits."""
    sums[1].mul_(1.0 / consts.s0)
    sums[2].mul_(1.0 / (2.0 * gconsts.xi))
    return sums


# ---------------------------------------------------------------------------
# Plain version.

def greeks_from_noise_ref(consts: pc.PathConsts, gconsts: pc.GreeksConsts,
                          tables: torch.Tensor, strikes: torch.Tensor,
                          noise: torch.Tensor, is_call: bool,
                          antithetic: bool = False) -> torch.Tensor:
    """Plain K3 and K4: [6, K] chunk sums in GREEK_ORDER under the
    [K, 8, >= n_steps] log_boundary_rows ``tables`` with strikes
    ``strikes`` [K], on the paths of ``noise`` [2, rows, n_steps]; with
    ``antithetic`` each row of noise is priced as a pair, the partner on
    -x', -hx and -W.  The bf16 form rounds N to bf16 for both products
    (``pathgen_cuda.fgn_matmul_ref``)."""
    n = consts.n_steps
    x = pc.fgn_matmul_ref(noise[0], consts.lt_half)
    hx = pc.fgn_matmul_ref(noise[0], gconsts.dlt_half)
    w = noise[1]
    if antithetic:
        x, w = pc.pair_planes(x, w)
        hx = torch.cat([hx, -hx])
    sv = torch.exp(x + consts.vd)
    v = sv * sv
    svw = sv * (w * math.sqrt(consts.dt))
    inc = (consts.r - 0.5 * v) * consts.dt + svw
    b = svw - v * consts.dt
    ls = math.log(consts.s0) + torch.cumsum(inc, dim=1)
    cumb = torch.cumsum(b, dim=1)
    cume = torch.cumsum((x * (1.0 / gconsts.eta) + gconsts.de) * b, dim=1)
    cumh = torch.cumsum((hx + gconsts.dh) * b, dim=1)
    del x, hx, w, sv, v, svw, inc, b
    sgn = 1.0 if is_call else -1.0
    sums = []
    for tab, k in zip(tables, strikes):
        exf = (ls >= tab[0, :n]) & (ls <= tab[1, :n])
        hit = exf.any(dim=1)
        idx = exf.to(torch.int8).argmax(dim=1)[:, None]
        ls_s, cb_s, ce_s, ch_s = (a.gather(1, idx)[:, 0]
                                  for a in (ls, cumb, cume, cumh))
        t_raw = (idx[:, 0].to(torch.float32) + 1.0) * consts.dt
        zero = torch.zeros_like(t_raw)
        d = torch.where(hit, torch.exp(-consts.r * t_raw), zero)
        t_s = torch.where(hit, t_raw, zero)
        s_stop = torch.exp(ls_s)
        p = sgn * (s_stop - k)
        act = (d > 0.0) & (p > 0.0)
        pv = torch.where(act, d * p, zero)
        base = torch.where(act, d * sgn * s_stop, zero)
        sums.append(torch.stack([
            torch.sum(pv), torch.sum(base), torch.sum(base * cb_s),
            torch.sum(base * ce_s), torch.sum(t_s * (base - pv)),
            torch.sum(base * ch_s)]))
    return _to_greek_order(torch.stack(sums, dim=1), consts, gconsts)


# ---------------------------------------------------------------------------
# Wrappers: plain version for CPU tensors, the kernel for CUDA tensors.

def _check_tables(consts: pc.PathConsts, tables: torch.Tensor) -> None:
    if consts.spectral:
        raise NotImplementedError(
            "the Greeks kernels K3/K4 take the chol fGN form only, as the "
            "JAX package's fused Greeks do; the pricers send a spectral "
            "configuration's Greeks to the jvp Greeks stream "
            "(engine.jvp_chunk_greeks)")
    if tables.dim() != 3 or tables.shape[1] < 4 or \
            tables.shape[2] < consts.n_steps:
        raise ValueError("tables must be [K, 8, >= n_steps] "
                         f"(log_boundary_rows), got {tuple(tables.shape)}")
    if not supports(consts.n_steps):
        raise ValueError(f"n_steps={consts.n_steps} is past the Greeks "
                         "kernels' shared memory")


def _check_gconsts(consts: pc.PathConsts, gconsts: pc.GreeksConsts) -> None:
    """The Greeks constants in the PathConsts' fGN input dtype, dLt' in
    it (torch.bfloat16 or float32), on its device: ValueError otherwise,
    so no product mixes the two forms."""
    if gconsts.fgn_dtype != consts.fgn_dtype:
        raise ValueError(f"gconsts are {gconsts.fgn_dtype!r}, the path "
                         f"constants {consts.fgn_dtype!r}")
    n = consts.n_steps
    mat = torch.bfloat16 if consts.bf16 else torch.float32
    for name, t, shape, dtype in (
            ("dlt_half", gconsts.dlt_half, (n, n), mat),
            ("de", gconsts.de, (n,), torch.float32),
            ("dh", gconsts.dh, (n,), torch.float32)):
        if (tuple(t.shape) != shape or t.device != consts.device
                or t.dtype != dtype or not t.is_contiguous()):
            raise ValueError(f"gconsts.{name} must be contiguous {dtype} "
                             f"{shape} on {consts.device}")


def _launch(name, consts, gconsts, rows, key, noise, tables, extra, k,
            antithetic):
    """One launch of the Greeks body; returns its [k, 6] raw sums."""
    n = consts.n_steps
    bp = block_paths_for(n, rows, antithetic, consts.bf16)
    partial = torch.empty((rows // bp, k, 6), dtype=torch.float32,
                          device=consts.device)
    from ..kernels import build

    err = build.entry(build.load(), "greeks", name, consts.bf16)(
        None if noise is None else noise.data_ptr(),
        consts.lt_half.data_ptr(), gconsts.dlt_half.data_ptr(),
        consts.vd.data_ptr(), gconsts.de.data_ptr(), gconsts.dh.data_ptr(),
        rows, n, bp, 0 if key is None else key & pc._U32,
        *pc._scalars(consts), ctypes.c_float(1.0 / gconsts.eta),
        tables.data_ptr(), *extra, int(bool(antithetic)), int(consts.bf16),
        partial.data_ptr(),
        torch.cuda.current_stream(consts.device).cuda_stream)
    pc._check(err, name)
    return torch.sum(partial, dim=0)


def greeks_chunk(consts: pc.PathConsts, gconsts: pc.GreeksConsts,
                 table: torch.Tensor, strike: float, is_call: bool,
                 rows: int = None, key: int = None,
                 noise: torch.Tensor = None,
                 antithetic: bool = False) -> torch.Tensor:
    """K3: the chunk's [6] float32 sums in GREEK_ORDER under the
    log_boundary_rows ``table`` [8, >= n_steps] of ``strike``, from the
    seeded stream of ``key`` or from injected ``noise``.  With
    ``antithetic`` the chunk's ``rows`` paths are rows / 2 pairs (noise
    [2, rows / 2, n_steps])."""
    rows = pc._noise_or_rows(consts, rows, key, noise, antithetic)
    consts.check_dtype()
    _check_tables(consts, table[None])
    _check_gconsts(consts, gconsts)
    if consts.device.type == "cpu":
        if noise is None:
            noise = pc.philox_normals_ref(
                key, pc.drawn_rows(rows, antithetic), consts.n_steps)
        return greeks_from_noise_ref(
            consts, gconsts, table[None], torch.tensor([float(strike)]),
            noise, is_call, antithetic)[:, 0]
    pc.check_device_inputs(consts, noise, table)
    raw = _launch("mcop_greeks_chunk", consts, gconsts, rows, key, noise,
                  table, (table.stride(0), ctypes.c_float(strike),
                          int(bool(is_call))), 1, antithetic)
    greeks_chunk.launches += 1
    greeks_chunk.form_launches[pc.form_name(antithetic,
                                            bf16=consts.bf16)] += 1
    return _to_greek_order(raw[0], consts, gconsts)


greeks_chunk.launches = 0
greeks_chunk.form_launches = dict.fromkeys(FORM_KEYS, 0)


def chain_greeks_chunk(consts: pc.PathConsts, gconsts: pc.GreeksConsts,
                       tables: torch.Tensor, is_call: bool, rows: int = None,
                       key: int = None, noise: torch.Tensor = None,
                       antithetic: bool = False) -> torch.Tensor:
    """K4: the chunk's [6, K] float32 sums in GREEK_ORDER under the
    strip's log_boundary_rows ``tables`` [K, 8, >= n_steps] (each strike
    is row 3 of its table), from the seeded stream of ``key`` or from
    injected ``noise``; ``antithetic`` as in ``greeks_chunk``.  One launch
    sweeps up to GROUP strikes; a wider strip takes one launch per group
    on the same key or noise, which regenerates the same pairs."""
    rows = pc._noise_or_rows(consts, rows, key, noise, antithetic)
    consts.check_dtype()
    _check_tables(consts, tables)
    _check_gconsts(consts, gconsts)
    if consts.device.type == "cpu":
        if noise is None:
            noise = pc.philox_normals_ref(
                key, pc.drawn_rows(rows, antithetic), consts.n_steps)
        return greeks_from_noise_ref(consts, gconsts, tables, tables[:, 3, 0],
                                     noise, is_call, antithetic)
    pc.check_device_inputs(consts, noise, tables)
    form = pc.form_name(antithetic, bf16=consts.bf16)
    raws = []
    for g in range(0, tables.shape[0], GROUP):
        k = min(GROUP, tables.shape[0] - g)
        raws.append(_launch(
            "mcop_chain_greeks_chunk", consts, gconsts, rows, key, noise,
            tables[g], (tables.stride(0), tables.stride(1), k,
                        int(bool(is_call))), k, antithetic))
        chain_greeks_chunk.launches += 1
        chain_greeks_chunk.form_launches[form] += 1
    return _to_greek_order(torch.cat(raws).T, consts, gconsts)


chain_greeks_chunk.launches = 0
chain_greeks_chunk.form_launches = dict.fromkeys(FORM_KEYS, 0)

