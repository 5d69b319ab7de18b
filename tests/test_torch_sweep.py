"""The shared-memory models of the strike-sweep kernels K5
(``models/chain_cuda.py``) and K3/K4 (``models/greeks_cuda.py``) against
the C layout of ``csrc/chain.cu`` and ``csrc/greeks.cu``, written out here
region by region as the kernels carve their dynamic shared memory, and the
blocks they pick.  The card tests hold the same models equal to the C
entries' byte counts (``tests/test_torch_gpu.py``); these run on the CPU in
milliseconds."""

import pytest

from montecarlooptionspricer_tpu_torch.models import chain_cuda as cc
from montecarlooptionspricer_tpu_torch.models import greeks_cuda as gc
from montecarlooptionspricer_tpu_torch.models import pathgen_cuda as pc

ROWS = 1 << 17
SM_BYTES = 233_472       # shared memory of one H100 SM
BLOCK_RESERVE = 1_024    # the runtime's reserve per resident block


def _plane(n, drawn, bf16):
    """Floats of one multiplied noise plane: float32 rows of n rounded up
    to odd, or bf16 rows of n rounded up to 16 plus 8."""
    if bf16:
        return drawn * ((n + 15) // 16 * 16 + 8) // 2
    return drawn * (n | 1)


def _staged(tiles, bf16):
    """Floats of the staged factor tiles: [32][64] float32, or [64][40]
    bf16, each."""
    return tiles * (64 * 40 // 2 if bf16 else 32 * 64)


def chain_layout(n, bp, anti, spec, bf16, quad=False, k=cc.GROUP):
    """csrc/chain.cu chain_kernel: N (and Zi) planes of the drawn rows, an
    X tile [BP][65] of every member, the staged factor tiles (two under
    SPEC), and lo and hi [64] of each of the launch's k strikes (none
    under QUAD).  No W plane."""
    drawn = bp // 2 if anti else bp
    planes = 2 if spec else 1
    return 4 * (planes * _plane(n, drawn, bf16) + bp * 65
                + _staged(planes, bf16) + (0 if quad else k * 2 * 64))


def greeks_layout(n, bp, anti, bf16, k=gc.GROUP):
    """csrc/greeks.cu greeks_kernel: the N plane of the drawn rows, four
    tiles [BP][65] of every member, two staged factor tiles (Lt', dLt'),
    and log lo and log hi [64] of each of the launch's k strikes.  No W
    plane."""
    drawn = bp // 2 if anti else bp
    return 4 * (_plane(n, drawn, bf16) + 4 * bp * 65 + _staged(2, bf16)
                + k * 2 * 64)


def _largest(smem, anti):
    """The largest block whose smem(bp) fits one block, as the models
    choose."""
    for bp in pc.PAIRED_BLOCK_CHOICES if anti else pc.BLOCK_CHOICES:
        if smem(bp) <= pc.SMEM_LIMIT and ROWS % bp == 0:
            return bp
    return 0


def _earlier_chain(n, bp, anti, spec, bf16):
    """K5's layout before the sweep's redesign: a resident W plane and no
    staged strike rows."""
    drawn = bp // 2 if anti else bp
    return (chain_layout(n, bp, anti, spec, bf16, quad=True)
            + 4 * drawn * (n | 1))


def _earlier_greeks(n, bp, anti, bf16):
    drawn = bp // 2 if anti else bp
    return greeks_layout(n, bp, anti, bf16, k=0) + 4 * drawn * (n | 1)


# K5's blocks, (antithetic, spectral, bf16) -> paths (pair members).
K5_BLOCKS = {
    47: {(a, s, b): 128 if a else 64 for a in (0, 1) for s in (0, 1)
         for b in (0, 1)},
    365: {(0, 0, 0): 64, (0, 0, 1): 64, (0, 1, 0): 32, (0, 1, 1): 64,
          (1, 0, 0): 128, (1, 0, 1): 128, (1, 1, 0): 64, (1, 1, 1): 128},
    512: {(0, 0, 0): 64, (0, 0, 1): 64, (0, 1, 0): 32, (0, 1, 1): 64,
          (1, 0, 0): 128, (1, 0, 1): 128, (1, 1, 0): 64, (1, 1, 1): 128},
}
# K3/K4's blocks, (antithetic, bf16) -> paths (pair members).
GREEKS_BLOCKS = {
    47: {(0, 0): 64, (0, 1): 64, (1, 0): 128, (1, 1): 128},
    365: {(0, 0): 64, (0, 1): 64, (1, 0): 64, (1, 1): 128},
    512: {(0, 0): 64, (0, 1): 64, (1, 0): 64, (1, 1): 128},
}


@pytest.mark.parametrize("n", [47, 365, 512])
def test_k5_memory_model_is_the_c_layout(n):
    """cc.smem_bytes equals the C layout for every block, form, dtype,
    policy and strike count; the block is the largest that fits at GROUP
    strikes (64 paths, 128 members, in every form at 47 steps), never
    smaller than before the redesign, and a quadratic block never smaller
    than the boundary one."""
    for anti, choices in ((False, pc.BLOCK_CHOICES),
                          (True, pc.PAIRED_BLOCK_CHOICES)):
        for spec in (False, True):
            for bf16 in (False, True):
                for bp in choices:
                    for quad in (False, True)[:1 if anti else 2]:
                        for k in (1, 21, cc.GROUP):
                            assert cc.smem_bytes(n, bp, anti, spec, bf16,
                                                 quad, k) == chain_layout(
                                n, bp, anti, spec, bf16, quad, k)
                got = cc.block_paths_for(n, ROWS, anti, spec, bf16)
                assert got == K5_BLOCKS[n][(anti, spec, bf16)]
                assert got == _largest(
                    lambda b: chain_layout(n, b, anti, spec, bf16), anti)
                assert got >= _largest(lambda b: _earlier_chain(
                    n, b, anti, spec, bf16), anti)
                if not anti:
                    assert cc.block_paths_for(n, ROWS, False, spec, bf16,
                                              quadratic=True) >= got


def test_k5_bf16_chol_blocks_share_an_sm():
    """The design's promise at 365 steps: a bf16 chol block, plain (64
    paths) or paired (128 members), at 21 and at 32 strikes, leaves room
    for a second block on the SM; the float32 blocks do not."""
    for k in (21, cc.GROUP):
        for anti, bp in ((False, 64), (True, 128)):
            assert 2 * (cc.smem_bytes(365, bp, anti, bf16=True,
                                      n_strikes=k)
                        + BLOCK_RESERVE) <= SM_BYTES
            assert 2 * (cc.smem_bytes(365, bp, anti, n_strikes=k)
                        + BLOCK_RESERVE) > SM_BYTES
    assert cc.smem_bytes(365, 64, bf16=True, n_strikes=32) == 86_272
    assert cc.smem_bytes(365, 128, True, bf16=True,
                         n_strikes=32) == 102_912


@pytest.mark.parametrize("n", [47, 365, 512])
def test_k3_k4_memory_model_is_the_c_layout(n):
    """gc.smem_bytes equals the C layout for every block, dtype and strike
    count (K3 is one strike); the block is the largest that fits at GROUP
    strikes and never smaller than before the redesign."""
    for anti, choices in ((False, pc.BLOCK_CHOICES),
                          (True, pc.PAIRED_BLOCK_CHOICES)):
        for bf16 in (False, True):
            for bp in choices:
                for k in (1, 21, gc.GROUP):
                    assert gc.smem_bytes(n, bp, anti, bf16, k) == \
                        greeks_layout(n, bp, anti, bf16, k)
            got = gc.block_paths_for(n, ROWS, anti, bf16)
            assert got == GREEKS_BLOCKS[n][(anti, bf16)] == _largest(
                lambda b: greeks_layout(n, b, anti, bf16), anti)
            assert got >= _largest(
                lambda b: _earlier_greeks(n, b, anti, bf16), anti)
    assert gc.smem_bytes(365, 64) == 192_768
