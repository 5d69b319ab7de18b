"""The strike-chain kernel K5 for Hopper, its plain PyTorch version and
its shared-memory model.

Counterpart: ``make_pallas_priced_chain`` in
``montecarlooptionspricer_tpu/models/pathgen_pallas.py``.  K5
``priced_chain`` (``csrc/chain.cu``, replaces ``_chain_kernel`` /
``_chain_kernel_noise_in`` / ``_chain_kernel_grid``) generates each path block of a chunk once, as K2
does, and sweeps every strike of the strip against it: the chunk's [K]
payoff sums under the strip's S-space ``boundary_rows`` tables, each path
stopped at its first step with lo <= S <= hi and worth disc * strike -
disc * S for a put (disc * S - disc * strike for a call), with no clamp,
as ``_policy_value_boundary`` decides.  Under ``policy_form="quadratic"``
(JAX's ``chain_policy_form="quadratic"``, ``_policy_value_minreduce:302``)
it reads the strip's ``policy_rows`` tables instead and stops each path at
the first step whose payoff is in the money and at least the fitted
quadratic continuation, z = (S - mu) * (1 / sd), worth disc * payoff
(``pathgen_cuda.quadratic_stops`` with ``recip``).  Its ``antithetic``
form (the JAX maker's ``antithetic=True``, ``_chain_paths``; boundary
policy only) prices each drawn row as the pair (N, W), (-N, -W), the fGN
product once per pair, each member swept against every strike.  Both run in the fGN form of the
``PathConsts`` they are given: chol, or spectral (three noise planes Zr,
Zi, W and the dense ``X = Zr @ Cr' - Zi @ Ci'``, the JAX chain kernel's
default form), as K2's; and each form in the fGN input dtype of those
constants: float32, or bf16 (``make_path_consts(fgn_dtype="bfloat16")``,
the JAX maker's ``fgn_dtype=jnp.bfloat16``): the kernel rounds N (Zr and
Zi) to bf16 and sums the product on the tensor cores in float32, and the
plain version takes the float32 product of the same bf16 values
(``pathgen_cuda.fgn_x_ref``).  The counters count it under "bf16/..."
(``pathgen_cuda.form_name``).

The seeded entry draws K1's and K2's Philox stream (``pathgen_cuda``) of
its form, so a strike of the strip sees the paths a single-strike K2 sees
on the same key (K2/anti's pairs under ``antithetic``).  The wrapper runs
the plain version for tensors on the CPU and launches the kernel for
tensors on a CUDA device; nothing falls back.
"""

from __future__ import annotations

import torch

from . import pathgen_cuda as pc

# ---------------------------------------------------------------------------
# The card's memory model (mirrors csrc/chain.cu).

GROUP = 32                  # strikes one launch sweeps (csrc/chain.cu kGroup)
# Floats one strike's staged rows take in a block: lo and hi of one step
# tile (csrc/strip_sweep.cuh kStagedStrikeFloats).
STAGED_STRIKE_FLOATS = 2 * pc.TILE_COLS
MAX_CHAIN_STEPS = 512       # the JAX chain kernel's cap (pathgen_pallas.py)
# K5's forms, the launch counter's keys: plain and paired under the
# boundary policy, and the quadratic policy's plain form.
FORMS = (*pc.FORMS[:2], pc.QUAD_FORMS[0])


def smem_bytes(n_steps: int, block_paths: int, antithetic: bool = False,
               spectral: bool = False, bf16: bool = False,
               quadratic: bool = False, n_strikes: int = GROUP) -> int:
    """Shared memory of one CUDA block: K2's N plane of the drawn rows (Zr
    and Zi ``spectral``; no W plane, which K5 draws per tile), one step
    tile of every path (pair member when ``antithetic``; it also holds the
    block's per-strike sums at the end), the staged factor rows (Lt', or
    Cr' and Ci') and the lo and hi rows of a launch's ``n_strikes``
    strikes for one tile (none under ``quadratic``, whose sweep reads its
    rows from device memory); under ``bf16`` the multiplied planes and the
    staged factor tiles in bf16 (``pathgen_cuda.block_smem_bytes``)."""
    drawn = pc.drawn_rows(block_paths, antithetic)
    staged = 0 if quadratic else n_strikes * STAGED_STRIKE_FLOATS
    return pc.block_smem_bytes(
        n_steps, drawn,
        extra=(block_paths - drawn) * (pc.TILE_COLS + 1) + staged,
        spectral=spectral, bf16=bf16, w_plane=False)


def supports(n_steps: int, fgn_form: str = "chol") -> bool:
    """Whether K5 takes this horizon in this fGN form: at most the JAX
    chain kernel's 512 steps, with a block that fits shared memory."""
    spectral = pc._check_form(fgn_form)
    return (1 <= n_steps <= MAX_CHAIN_STEPS and pc.fitting_block(
        lambda n, b: smem_bytes(n, b, spectral=spectral), n_steps) > 0)


def block_paths_for(n_steps: int, rows: int, antithetic: bool = False,
                    spectral: bool = False, bf16: bool = False,
                    quadratic: bool = False) -> int:
    """K5's path block: the largest of pathgen_cuda.BLOCK_CHOICES
    (PAIRED_BLOCK_CHOICES, in pair members, when ``antithetic``) whose
    shared memory at GROUP strikes fits at this horizon and which divides
    ``rows``: 64 at 365 and at 512 steps, 128 paired; ``spectral``, 32 at
    both (64 paired) in float32 and 64 (128 paired) in bf16."""
    bp = pc.fitting_block(
        lambda n, b: smem_bytes(n, b, antithetic, spectral, bf16,
                                quadratic), n_steps, rows, antithetic)
    if not bp:
        raise ValueError(f"no K5 block divides rows={rows} at "
                         f"n_steps={n_steps}")
    return bp


def blocks_per_sm(consts: pc.PathConsts, rows: int, n_strikes: int = GROUP,
                  antithetic: bool = False,
                  policy_form: str = "boundary") -> int:
    """Blocks of K5 one SM of the card runs at once for a launch of
    ``n_strikes`` strikes in the form of ``consts`` (its fGN form and
    dtype), ``antithetic`` and ``policy_form``, at the block
    ``block_paths_for`` picks (the CUDA runtime's occupancy query on the
    seeded body)."""
    quadratic = pc.check_policy(policy_form, antithetic)
    bp = block_paths_for(consts.n_steps, rows, antithetic, consts.spectral,
                         consts.bf16, quadratic)
    from ..kernels import build

    got = build.entry(build.load(), "chain", "mcop_chain_blocks_per_sm",
                      consts.bf16)(consts.n_steps, bp, int(antithetic),
                                   int(consts.spectral), int(quadratic),
                                   n_strikes)
    if got < 0:
        raise RuntimeError(f"mcop_chain_blocks_per_sm failed: cudaError "
                           f"{-got}")
    return got


# ---------------------------------------------------------------------------
# Plain version.

def priced_chain_from_noise_ref(consts: pc.PathConsts, tables: torch.Tensor,
                                noise: torch.Tensor, is_call: bool,
                                antithetic: bool = False,
                                policy_form: str = "boundary"
                                ) -> torch.Tensor:
    """Plain K5: [K] chunk payoff sums under the [K, 8, >= n_steps]
    boundary_rows ``tables`` on the paths of ``noise`` [2 or 3, rows,
    n_steps] (the planes of ``consts``' form; ``_policy_value_boundary``
    per strike on the S plane), or under ``policy_form="quadratic"`` the
    policy_rows ``tables`` (``_policy_value_minreduce``); with
    ``antithetic`` each row of noise is priced as a pair."""
    n = consts.n_steps
    s = torch.exp(pc._log_paths_ref(consts, noise, antithetic))
    if pc.check_policy(policy_form, antithetic):
        return torch.stack([pc.quadratic_first_hit_sum(s, tab, is_call,
                                                       recip=True)
                            for tab in tables])
    ds = s * tables[0, 3, :n]
    sums = []
    for tab in tables:
        exf = (s >= tab[0, :n]) & (s <= tab[1, :n])
        hit = exf.any(dim=1)
        idx = exf.to(torch.int8).argmax(dim=1)
        val = (ds - tab[2, :n]) if is_call else (tab[2, :n] - ds)
        val = val.gather(1, idx[:, None])[:, 0]
        sums.append(torch.sum(torch.where(hit, val, torch.zeros_like(val))))
    return torch.stack(sums)


# ---------------------------------------------------------------------------
# Wrapper: plain version for CPU tensors, the kernel for CUDA tensors.

def priced_chain(consts: pc.PathConsts, tables: torch.Tensor, is_call: bool,
                 rows: int = None, key: int = None,
                 noise: torch.Tensor = None, antithetic: bool = False,
                 policy_form: str = "boundary") -> torch.Tensor:
    """K5: the chunk's [K] float32 payoff sums under the strip's
    boundary_rows ``tables`` [K, 8, >= n_steps] (``policy_form=
    "quadratic"``: its policy_rows tables), from the seeded stream of
    ``key`` or from injected ``noise`` [planes, rows, n_steps] (2 planes
    chol, 3 spectral).  With ``antithetic`` (the boundary policy only) the
    chunk's ``rows`` paths are rows / 2 pairs: the seeded entry draws
    rows / 2 rows, and injected noise is [planes, rows / 2, n_steps].  On
    the card one launch sweeps up to GROUP strikes; a wider strip takes
    one launch per group on the same key or noise, which regenerates the
    same paths (and pairs).  Each block writes one partial sum per strike
    and the blocks are summed in a fixed order, so a seed gives the same
    sums every run."""
    quadratic = pc.check_policy(policy_form, antithetic)
    rows = pc._noise_or_rows(consts, rows, key, noise, antithetic)
    consts.check_dtype()
    n = consts.n_steps
    if (tables.dim() != 3 or tables.shape[1] < (8 if quadratic else 4)
            or tables.shape[2] < n):
        layout = "policy_rows" if quadratic else "boundary_rows"
        raise ValueError(f"tables must be [K, 8, >= n_steps] ({layout} of "
                         f"a strip), got {tuple(tables.shape)}")
    if not supports(n, consts.fgn_form):
        raise ValueError(f"n_steps={n} is past K5's horizon "
                         f"({MAX_CHAIN_STEPS})")
    if consts.device.type == "cpu":
        if noise is None:
            noise = pc.normals_ref(consts, key,
                                   pc.drawn_rows(rows, antithetic))
        return priced_chain_from_noise_ref(consts, tables, noise, is_call,
                                           antithetic, policy_form)
    pc.check_device_inputs(consts, noise, tables)
    bp = block_paths_for(n, rows, antithetic, consts.spectral, consts.bf16,
                         quadratic)
    from ..kernels import build

    launch = build.entry(build.load(), "chain", "mcop_priced_chain",
                         consts.bf16)
    form = pc.form_name(antithetic, False, consts.spectral, quadratic,
                        consts.bf16)
    stream = torch.cuda.current_stream(consts.device).cuda_stream
    sums = []
    for g in range(0, tables.shape[0], GROUP):
        k = min(GROUP, tables.shape[0] - g)
        partial = torch.empty((rows // bp, k), dtype=torch.float32,
                              device=consts.device)
        err = launch(
            None if noise is None else noise.data_ptr(),
            *consts.factor_ptrs(), consts.vd.data_ptr(), rows, n, bp,
            0 if key is None else key & pc._U32, *pc._scalars(consts),
            tables[g].data_ptr(), tables.stride(0), tables.stride(1), k,
            int(bool(is_call)), int(bool(antithetic)), int(quadratic),
            int(consts.bf16), partial.data_ptr(), stream)
        pc._check(err, "priced_chain")
        priced_chain.launches += 1
        priced_chain.noise_launches += noise is not None
        priced_chain.form_launches[form] += 1
        sums.append(torch.sum(partial, dim=0))
    return torch.cat(sums)


priced_chain.launches = 0
priced_chain.noise_launches = 0           # launches on injected noise
priced_chain.form_launches = pc.new_form_counts(FORMS, bf16=True)

