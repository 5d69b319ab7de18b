"""Step-tiled rough-Bergomi path kernels for Hopper: the long horizons.

Counterpart: ``montecarlooptionspricer_tpu/models/pathgen_pallas_tiled.py``
(its chol slab).  Two kernels live in ``csrc/pathgen_tiled.cu``:

* K6 ``tiled_pathgen`` (replaces ``_tiled_pathgen_kernel`` /
  ``_tiled_pathgen_kernel_noise_in``): ``[rows, n_steps + 1]`` prices with
  S0 in column 0.
* K7 ``tiled_priced_chunk`` (replaces ``_tiled_priced_kernel`` /
  ``_tiled_priced_kernel_noise_in`` with ``policy_form="boundary"``): the
  chunk's payoff sum under a log exercise-interval table.

They compute the same function as K1 and K2 of ``pathgen_cuda``, re-blocked
over the step axis, and the seeded entries draw the same Philox stream.  So
their plain versions are K1's and K2's, named here as
``pathgen_from_noise_ref`` and ``priced_chunk_from_noise_ref``.  The
wrappers run the plain versions for tensors on the CPU and launch the
kernel for tensors on a CUDA device; nothing falls back.

The noise plane [2, rows, n_steps] stays in device memory and the kernels
stream it through shared memory in k-tiles (the design note in the CUDA
source says why); the seeded entries first draw their rows into a
workspace plane the wrapper allocates.
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
TILE_K = 16                 # steps per staged k-tile of N and Lt'
BLOCK_CHOICES = (128, 64, 32, 16)
L2_BYTES = 50 * 1024 * 1024  # H100 SXM L2 cache


def smem_bytes(block_paths: int) -> int:
    """Shared memory of one CUDA block: the N^T k-tile (row stride
    block_paths + 4), the Lt' k-tile, the X tile (stride TILE_COLS + 1)
    and the path-sum slots.  It does not depend on the horizon."""
    floats = (TILE_K * (block_paths + 4) + TILE_K * TILE_COLS
              + block_paths * (TILE_COLS + 1) + block_paths)
    return 4 * floats


def max_tiled_steps() -> int:
    """Largest horizon the tiled kernels take: every block streams the
    whole triangle of Lt' (n^2 float32), and up to this horizon it stays
    resident in the card's L2.  Shared memory, fixed by the tile shapes
    (``smem_bytes``), bounds the block and not the horizon."""
    return math.isqrt(L2_BYTES // 4)


def supports(n_steps: int) -> bool:
    """Whether the tiled kernels take this horizon."""
    return 1 <= n_steps <= max_tiled_steps()


def block_paths_for(rows: int) -> int:
    """The CUDA path block for ``rows``: the largest of BLOCK_CHOICES that
    divides it."""
    for bp in BLOCK_CHOICES:
        if rows % bp == 0:
            return bp
    raise ValueError(f"rows={rows} must divide by {BLOCK_CHOICES[-1]}")


# ---------------------------------------------------------------------------
# Wrappers: plain version for CPU tensors, the kernel for CUDA tensors.

def _plane_args(consts: pc.PathConsts, rows: int, key, noise):
    """(noise plane, seeded flag, block, key word) for a launch: the given
    noise, or a workspace the seeded kernel fills from the stream."""
    pc.check_device_inputs(consts, noise)
    bp = block_paths_for(rows)
    if noise is not None:
        return noise, 0, bp, 0
    plane = torch.empty((2, rows, consts.n_steps), dtype=torch.float32,
                        device=consts.device)
    return plane, 1, bp, key & pc._U32


def tiled_pathgen(consts: pc.PathConsts, rows: int = None, key: int = None,
                  noise: torch.Tensor = None) -> torch.Tensor:
    """K6: [rows, n_steps + 1] float32 prices, S0 in column 0, from the
    seeded stream of ``key`` or from injected ``noise`` [2, rows,
    n_steps]; the same function as ``pathgen_cuda.pathgen``."""
    rows = pc._noise_or_rows(consts, rows, key, noise)
    if consts.device.type == "cpu":
        if noise is None:
            noise = pc.philox_normals_ref(key, rows, consts.n_steps)
        return pathgen_from_noise_ref(consts, noise)
    plane, seeded, bp, word = _plane_args(consts, rows, key, noise)
    out = torch.empty((rows, consts.n_steps + 1), dtype=torch.float32,
                      device=consts.device)
    from ..kernels import build

    err = build.load().mcop_tiled_pathgen(
        plane.data_ptr(), seeded, consts.lt_half.data_ptr(),
        consts.vd.data_ptr(), rows, consts.n_steps, bp, word,
        *pc._scalars(consts), ctypes.c_float(consts.s0), out.data_ptr(),
        torch.cuda.current_stream(consts.device).cuda_stream)
    pc._check(err, "tiled_pathgen")
    tiled_pathgen.launches += 1
    return out


tiled_pathgen.launches = 0


def tiled_priced_chunk(consts: pc.PathConsts, table: torch.Tensor,
                       strike: float, is_call: bool, rows: int = None,
                       key: int = None,
                       noise: torch.Tensor = None) -> torch.Tensor:
    """K7: the chunk's discounted payoff sum (0-d float32 tensor) under
    the log_boundary_rows ``table``, from the seeded stream of ``key`` or
    from injected ``noise``; the same function as
    ``pathgen_cuda.priced_chunk``.  Each block writes one partial sum and
    the blocks are summed in a fixed order."""
    rows = pc._noise_or_rows(consts, rows, key, noise)
    if table.shape[0] < 3 or table.shape[1] < consts.n_steps:
        raise ValueError("table must be [8, >= n_steps] (log_boundary_rows)")
    if consts.device.type == "cpu":
        if noise is None:
            noise = pc.philox_normals_ref(key, rows, consts.n_steps)
        return priced_chunk_from_noise_ref(consts, table, noise, strike,
                                           is_call)
    plane, seeded, bp, word = _plane_args(consts, rows, key, noise)
    pc.check_device_inputs(consts, None, table)
    partial = torch.empty((rows // bp,), dtype=torch.float32,
                          device=consts.device)
    from ..kernels import build

    err = build.load().mcop_tiled_priced_chunk(
        plane.data_ptr(), seeded, consts.lt_half.data_ptr(),
        consts.vd.data_ptr(), rows, consts.n_steps, bp, word,
        *pc._scalars(consts), table.data_ptr(), table.stride(0),
        ctypes.c_float(strike), int(bool(is_call)), partial.data_ptr(),
        torch.cuda.current_stream(consts.device).cuda_stream)
    pc._check(err, "tiled_priced_chunk")
    tiled_priced_chunk.launches += 1
    return torch.sum(partial)


tiled_priced_chunk.launches = 0
