"""Step-tiled rough-Bergomi path kernels for Hopper: the long horizons.

Counterpart: ``montecarlooptionspricer_tpu/models/pathgen_pallas_tiled.py``
(its slab, chol and spectral: ``_fgn_tile:125``).  Two kernels live in
``csrc/pathgen_tiled.cu``:

* K6 ``tiled_pathgen`` (replaces ``_tiled_pathgen_kernel`` /
  ``_tiled_pathgen_kernel_noise_in``): ``[rows, n_steps + 1]`` prices with
  S0 in column 0, plain or paired (``antithetic``: the drawn rows' paths,
  then their partners', as K1's pair form lays them out).
* K7 ``tiled_priced_chunk`` (replaces ``_tiled_priced_kernel`` /
  ``_tiled_priced_kernel_noise_in``): the chunk's payoff sum under a log
  exercise-interval table, in K2's four forms (``antithetic``,
  ``with_cv``), or under the quadratic policy table
  (``policy_form="quadratic"``, ``_policy_tile:161``), plain and CV.

They compute the same function as K1 and K2 of ``pathgen_cuda``, re-blocked
over the step axis, in the fGN form of the ``PathConsts`` they are given
(chol, or spectral: three noise planes and the dense ``Zr @ Cr' - Zi @
Ci'``), and the seeded entries draw the same Philox stream.  So their plain
versions are K1's and K2's, named here as ``pathgen_from_noise_ref`` and
``priced_chunk_from_noise_ref``.  The
wrappers run the plain versions for tensors on the CPU and launch the
kernel for tensors on a CUDA device; nothing falls back.

Both also run with bf16 fGN inputs, chol and spectral, in every form (a
PathConsts of ``fgn_dtype="bfloat16"``; counterpart: the slab's
``fgn_dtype``, ``_consts:88`` and its bf16 noise tiles): the kernels round
each N (Zr, Zi) k-tile to bf16 and read bf16 Lt' (Cr', Ci') k-tiles,
summing the products on the tensor cores in float32; the plain versions
are K1's and K2's bf16 ones.  Their counters count it as "bf16",
"bf16/anti", ..., "bf16/spectral/quad/cv".

The noise planes [2, rows, n_steps] (N, W), or [3, rows, n_steps] (Zr, Zi,
W) spectral, stay in device memory and the kernels stream them, with the
factors, through a ring of k-tile stages in shared memory filled by
cp.async copies a few k-tiles ahead (the design note in the CUDA source says
why).  The seeded entries first draw their rows into a workspace the
wrapper allocates (``workspace_floats``: under bf16 the multiplied planes
already rounded to bf16); the kernels read the factors with rows padded to
``pc.slab_ld`` (``PathConsts.slab_factors``).  K7 decides each 128-column
tile with a warp's lanes across its columns, its table rows staged per
tile, and adds log s0 to the running sum of the increments, as the plain
version does.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import pathgen_cuda as pc

pathgen_from_noise_ref = pc.pathgen_from_noise_ref
priced_chunk_from_noise_ref = pc.priced_chunk_from_noise_ref

# ---------------------------------------------------------------------------
# The card's memory model (mirrors csrc/pathgen_tiled.cu).

TILE_COLS = 128             # step columns per output tile
BLOCK_CHOICES = (128, 64, 32, 16)
PAIRED_BLOCK_CHOICES = (128, 64, 32)   # members: 64, 32 or 16 drawn rows
L2_BYTES = 50 * 1024 * 1024  # H100 SXM L2 cache
X_STRIDE = TILE_COLS + 1    # row stride of the X tile
TAB_FLOATS = 8 * TILE_COLS  # the decision's staged rows of one tile
N_KB = 16 + 8               # bf16 row stride of N's staged k-tile
FAC_KB = TILE_COLS + 8      # bf16 row stride of the factor's


def tile_k(spectral: bool = False, bf16: bool = False) -> int:
    """Steps of a staged k-tile (``tile_k`` of csrc/slab_tile.cuh): 32 for
    the float32 chol form, else 16."""
    return 32 if not (spectral or bf16) else 16


def stages(spectral: bool = False, bf16: bool = False) -> int:
    """Stages of the product's ring: 3, or 6 for the bf16 chol form."""
    return 6 if bf16 and not spectral else 3


def ring_floats(drawn: int, spectral: bool = False,
                bf16: bool = False) -> int:
    """Floats of the ring of a block of ``drawn`` rows: per stage N^T
    [tile_k][drawn + 4] and the factor's k-tile [tile_k][TILE_COLS] in
    float32, or N's [drawn][N_KB] and the factor's [tile_k][FAC_KB]
    k-tiles in bf16; two of each under ``spectral``."""
    tk = tile_k(spectral, bf16)
    per = ((drawn * N_KB + tk * FAC_KB) // 2 if bf16
           else tk * (drawn + 4 + TILE_COLS))
    return stages(spectral, bf16) * (2 if spectral else 1) * per


def smem_bytes(block_paths: int, antithetic: bool = False,
               with_cv: bool = False, spectral: bool = False,
               bf16: bool = False) -> int:
    """Shared memory of one CUDA block (``mcop_tiled_smem_bytes``): the
    decision's staged rows [8][TILE_COLS] and the X tile of its
    ``block_paths`` paths [block_paths][X_STRIDE], in whose room the
    product's ring (``ring_floats`` of its drawn rows) lives while it
    runs; the control variate takes none more (its sums are reduced
    through the X tile).  It does not depend on the horizon: at 128
    paths 99,840 bytes in float32 (the ring) and 70,144 in bf16 (the X
    tile), two blocks an SM in every form."""
    drawn = block_paths // 2 if antithetic else block_paths
    return 4 * max(ring_floats(drawn, spectral, bf16),
                   TAB_FLOATS + block_paths * X_STRIDE)


def workspace_floats(drawn: int, n_steps: int, spectral: bool = False,
                     bf16: bool = False) -> int:
    """Floats of the seeded entries' workspace of ``drawn`` rows
    (csrc/pathgen_tiled.cu:draw_rows): the noise-in layout [2 or 3, drawn,
    n_steps] in float32; under ``bf16`` the N (and Zi) planes as bf16 rows
    of ``pc.slab_ld(n_steps)``, then W [drawn, n_steps] in float32."""
    planes = 2 if spectral else 1
    if bf16:
        return planes * drawn * pc.slab_ld(n_steps) // 2 + drawn * n_steps
    return (planes + 1) * drawn * n_steps


def max_tiled_steps(fgn_form: str = "chol") -> int:
    """Largest horizon the tiled kernels take in this fGN form: every
    block streams the whole of its factors (n^2 float32 each: Lt', or the
    dense Cr' and Ci'), and up to this horizon they stay resident in the
    card's L2: 3,620 steps chol, 2,560 spectral.  Shared memory, fixed by
    the tile shapes (``smem_bytes``), bounds the block and not the
    horizon."""
    n_mats = 2 if pc._check_form(fgn_form) else 1
    return math.isqrt(L2_BYTES // (4 * n_mats))


def supports(n_steps: int, fgn_form: str = "chol") -> bool:
    """Whether the tiled kernels take this horizon in this form."""
    return 1 <= n_steps <= max_tiled_steps(fgn_form)


def block_paths_for(rows: int, antithetic: bool = False) -> int:
    """The CUDA path block for ``rows``: the largest of BLOCK_CHOICES that
    divides it; paired, the largest of PAIRED_BLOCK_CHOICES (members, half
    of them drawn: at most 64 drawn rows, as ``mcop_tiled_smem_bytes``
    refuses a paired block of 128 drawn rows)."""
    choices = PAIRED_BLOCK_CHOICES if antithetic else BLOCK_CHOICES
    for bp in choices:
        if rows % bp == 0:
            return bp
    raise ValueError(f"rows={rows} must divide by {choices[-1]}")


# ---------------------------------------------------------------------------
# Wrappers: plain version for CPU tensors, the kernel for CUDA tensors.

def _plane_args(consts: pc.PathConsts, rows: int, key, noise,
                antithetic: bool = False):
    """(noise plane, seeded flag, block, key word) for a launch: the given
    noise, or a workspace the seeded kernel fills from the stream (its
    drawn rows only, ``workspace_floats``)."""
    pc.check_device_inputs(consts, noise)
    bp = block_paths_for(rows, antithetic)
    if noise is not None:
        return noise, 0, bp, 0
    plane = torch.empty(workspace_floats(
        pc.drawn_rows(rows, antithetic), consts.n_steps, consts.spectral,
        consts.bf16), dtype=torch.float32, device=consts.device)
    return plane, 1, bp, key & pc._U32


def blocks_per_sm(consts: pc.PathConsts, rows: int, priced: bool = True,
                  antithetic: bool = False, with_cv: bool = False,
                  policy_form: str = "boundary") -> int:
    """Blocks of K7 (K6 with ``priced`` False) one SM of the card runs at
    once in the form of ``consts`` (its fGN form and dtype),
    ``antithetic``, ``with_cv`` and ``policy_form``, at the block
    ``block_paths_for`` picks (the CUDA runtime's occupancy query on the
    seeded body)."""
    quadratic = pc.check_policy(policy_form, antithetic)
    from ..kernels import build

    got = build.entry(build.load(), "pathgen_tiled",
                      "mcop_tiled_blocks_per_sm", consts.bf16, True)(
        block_paths_for(rows, antithetic), int(priced), int(antithetic),
        int(with_cv), int(consts.spectral), int(quadratic))
    if got < 0:
        raise RuntimeError(f"mcop_tiled_blocks_per_sm failed: cudaError "
                           f"{-got}")
    return got


def tiled_pathgen(consts: pc.PathConsts, rows: int = None, key: int = None,
                  noise: torch.Tensor = None,
                  antithetic: bool = False) -> torch.Tensor:
    """K6: [rows, n_steps + 1] float32 prices, S0 in column 0, from the
    seeded stream of ``key`` or from injected ``noise`` [planes, rows,
    n_steps] (2 planes chol, 3 spectral); the same function as
    ``pathgen_cuda.pathgen``, in both its forms (``antithetic``: rows / 2
    drawn rows, noise [planes, rows / 2, n_steps], the partners' paths
    below the drawn rows')."""
    rows = pc._noise_or_rows(consts, rows, key, noise, antithetic)
    consts.check_dtype()
    if consts.device.type == "cpu":
        if noise is None:
            noise = pc.normals_ref(consts, key,
                                   pc.drawn_rows(rows, antithetic))
        return pathgen_from_noise_ref(consts, noise, antithetic)
    plane, seeded, bp, word = _plane_args(consts, rows, key, noise,
                                          antithetic)
    out = torch.empty((rows, consts.n_steps + 1), dtype=torch.float32,
                      device=consts.device)
    from ..kernels import build

    err = build.entry(build.load(), "pathgen_tiled", "mcop_tiled_pathgen",
                      consts.bf16, bool(seeded))(
        plane.data_ptr(), seeded, *consts.slab_factor_ptrs(),
        consts.vd.data_ptr(), rows, consts.n_steps, bp, word,
        *pc._scalars(consts), ctypes.c_float(consts.s0),
        int(bool(antithetic)), int(consts.bf16), out.data_ptr(),
        torch.cuda.current_stream(consts.device).cuda_stream)
    pc._check(err, "tiled_pathgen")
    tiled_pathgen.launches += 1
    tiled_pathgen.form_launches[pc.form_name(antithetic, False,
                                             consts.spectral,
                                             bf16=consts.bf16)] += 1
    return out


tiled_pathgen.launches = 0
tiled_pathgen.form_launches = pc.new_form_counts(pc.PATH_FORMS, bf16=True)


def tiled_priced_chunk(consts: pc.PathConsts, table: torch.Tensor,
                       strike: float, is_call: bool, rows: int = None,
                       key: int = None, noise: torch.Tensor = None,
                       antithetic: bool = False, with_cv: bool = False,
                       policy_form: str = "boundary"):
    """K7: the chunk's discounted payoff sum (0-d float32 tensor) under
    the log_boundary_rows ``table`` (``policy_form="quadratic"``: the
    policy_rows ``table``), from the seeded stream of ``key`` or from
    injected ``noise``, and with ``with_cv`` the control sum beside it;
    the same function as ``pathgen_cuda.priced_chunk`` in each form
    (``antithetic``: rows / 2 drawn rows, noise [planes, rows / 2,
    n_steps]).  Each block writes one partial sum per lane and the blocks
    are summed in a fixed order."""
    quadratic = pc.check_policy(policy_form, antithetic)
    rows = pc._noise_or_rows(consts, rows, key, noise, antithetic)
    pc.check_table(table, consts.n_steps, quadratic)
    consts.check_dtype()
    if consts.device.type == "cpu":
        if noise is None:
            noise = pc.normals_ref(consts, key,
                                   pc.drawn_rows(rows, antithetic))
        return priced_chunk_from_noise_ref(consts, table, noise, strike,
                                           is_call, antithetic, with_cv,
                                           policy_form)
    plane, seeded, bp, word = _plane_args(consts, rows, key, noise,
                                          antithetic)
    pc.check_device_inputs(consts, None, table)
    partial = torch.empty((2 if with_cv else 1, rows // bp),
                          dtype=torch.float32, device=consts.device)
    from ..kernels import build

    err = build.entry(build.load(), "pathgen_tiled",
                      "mcop_tiled_priced_chunk", consts.bf16, bool(seeded))(
        plane.data_ptr(), seeded, *consts.slab_factor_ptrs(),
        consts.vd.data_ptr(), rows, consts.n_steps, bp, word,
        *pc._scalars(consts), table.data_ptr(), table.stride(0),
        ctypes.c_float(strike), int(bool(is_call)), int(bool(antithetic)),
        int(bool(with_cv)), int(quadratic), int(consts.bf16),
        ctypes.c_float(pc.cv_discount(consts)), partial.data_ptr(),
        torch.cuda.current_stream(consts.device).cuda_stream)
    pc._check(err, "tiled_priced_chunk")
    tiled_priced_chunk.launches += 1
    tiled_priced_chunk.noise_launches += not seeded
    tiled_priced_chunk.form_launches[pc.form_name(
        antithetic, with_cv, consts.spectral, quadratic, consts.bf16)] += 1
    return pc.sums_from_partials(partial, with_cv)


tiled_priced_chunk.launches = 0
tiled_priced_chunk.noise_launches = 0     # launches on injected noise
tiled_priced_chunk.form_launches = pc.new_form_counts(
    pc.FORMS + pc.QUAD_FORMS, bf16=True)
