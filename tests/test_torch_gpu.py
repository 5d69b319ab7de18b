"""Each CUDA kernel of the port against its plain PyTorch version on the
card.  Skips without a CUDA device.  The file imports no JAX, so on a
machine without JAX it runs with the repository's conftest switched off:

    python -m pytest --noconftest tests/test_torch_gpu.py -m gpu
"""

import pytest
import torch

from montecarlooptionspricer_tpu_torch.models import engine
from montecarlooptionspricer_tpu_torch.models import pathgen_cuda as pc
from montecarlooptionspricer_tpu_torch.models import pathgen_tiled_cuda as ptc

MARKET = dict(s0=100.0, xi=0.05, h=0.15, eta=1.4, r=0.04)
DT = 1 / 252


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n_steps,block_paths", [(96, 64), (365, 64),
                                                 (200, 32), (47, 16)])
def test_kernels_match_plain_versions(cuda, n_steps, block_paths):
    """Paths elementwise at rtol 2e-4 and chunk sums at rtol 1e-4 (float32
    sums in another order; a stop decision flips only inside the root
    band), for the seeded and the noise-in entries, at the main path's
    chunk of 131072 rows: one flipped path moves a sum by up to a few
    payoffs, so a small chunk's relative error is dominated by single
    flips (2e-4 measured on an H100 at 4096 rows and 365 steps)."""
    rows = 1 << 17
    consts = pc.make_path_consts(*MARKET.values(), n_steps, DT, cuda,
                                 block_paths=block_paths)
    key = pc._fold_words(5, 9)
    noise = pc.philox_normals_ref(key, rows, n_steps, device=cuda)
    want = pc.pathgen_from_noise_ref(consts, noise)
    for got in (pc.pathgen(consts, noise=noise),
                pc.pathgen(consts, rows=rows, key=key)):
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=2e-4, atol=0)

    strike, maturity = 100.0, n_steps * DT
    _, fits = engine.lsm_fit(want, MARKET["r"], strike, maturity, DT, False)
    table = pc.log_boundary_rows(pc.boundary_rows(
        fits, MARKET["r"], strike, maturity, DT, n_steps, False)).contiguous()
    ref = float(pc.priced_chunk_from_noise_ref(consts, table, noise, strike,
                                               False))
    assert ref > 0
    for got in (pc.priced_chunk(consts, table, strike, False, noise=noise),
                pc.priced_chunk(consts, table, strike, False, rows=rows,
                                key=key)):
        torch.cuda.synchronize()
        assert abs(float(got) / ref - 1.0) < 1e-4


@pytest.mark.gpu
def test_wrapper_rejects_bad_inputs(cuda):
    consts = pc.make_path_consts(*MARKET.values(), 32, DT, cuda)
    with pytest.raises(ValueError):      # rows not a multiple of the block
        pc.pathgen(consts, rows=100, key=1)
    with pytest.raises(ValueError):      # noise on the wrong device
        pc.pathgen(consts, noise=torch.zeros((2, 64, 32)))


@pytest.mark.gpu
@pytest.mark.parametrize("n_steps", [1825, 1008, 300])
def test_tiled_kernels_match_plain_versions(cuda, n_steps):
    """K6 paths elementwise at rtol 2e-4 and K7 chunk sums at rtol 1e-4
    against their plain versions, seeded and noise-in, at the main path's
    chunk of 131072 rows; 300 steps is below the crossover and goes
    through the tiled wrappers directly."""
    rows = 1 << 17
    consts = pc.make_path_consts(*MARKET.values(), n_steps, DT, cuda)
    key = pc._fold_words(5, 11)
    noise = pc.philox_normals_ref(key, rows, n_steps, device=cuda)
    want = ptc.pathgen_from_noise_ref(consts, noise)
    for got in (ptc.tiled_pathgen(consts, noise=noise),
                ptc.tiled_pathgen(consts, rows=rows, key=key)):
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=2e-4, atol=0)
        del got

    strike, maturity = 100.0, n_steps * DT
    _, fits = engine.lsm_fit(want[: 1 << 14], MARKET["r"], strike, maturity,
                             DT, False)
    del want
    table = pc.log_boundary_rows(pc.boundary_rows(
        fits, MARKET["r"], strike, maturity, DT, n_steps, False)).contiguous()
    ref = float(ptc.priced_chunk_from_noise_ref(consts, table, noise, strike,
                                                False))
    assert ref > 0
    for got in (ptc.tiled_priced_chunk(consts, table, strike, False,
                                       noise=noise),
                ptc.tiled_priced_chunk(consts, table, strike, False,
                                       rows=rows, key=key)):
        torch.cuda.synchronize()
        assert abs(float(got) / ref - 1.0) < 1e-4


@pytest.mark.gpu
def test_tiled_priced_first_exercise_across_tiles(cuda):
    """Wild noise (x3): many paths first enter the exercise interval in the
    first step tile and enter it again in later tiles; each must count
    once, at its first hit, so K7 (per-path stop state carried across
    tiles in registers) matches its plain version (first hit by argmax
    over the whole path) at rtol 1e-4."""
    n_steps, rows, strike = 1825, 1 << 17, 100.0
    consts = pc.make_path_consts(*MARKET.values(), n_steps, DT, cuda)
    noise = 3.0 * pc.philox_normals_ref(pc._fold_words(6, 1), rows, n_steps,
                                        device=cuda)
    paths = ptc.tiled_pathgen(consts, noise=noise[:, : 1 << 14].contiguous())
    _, fits = engine.lsm_fit(paths, MARKET["r"], strike, n_steps * DT, DT,
                             False)
    del paths
    table = pc.log_boundary_rows(pc.boundary_rows(
        fits, MARKET["r"], strike, n_steps * DT, DT, n_steps,
        False)).contiguous()
    ls = pc._log_paths_ref(consts, noise[:, :4096])
    ex = (ls >= table[0, :n_steps]) & (ls <= table[1, :n_steps])
    first_in_tile0 = ex[:, : ptc.TILE_COLS].any(1)
    assert float((first_in_tile0 & ex[:, ptc.TILE_COLS:].any(1))
                 .float().mean()) > 0.02
    del ls, ex
    ref = float(ptc.priced_chunk_from_noise_ref(consts, table, noise, strike,
                                                False))
    got = float(ptc.tiled_priced_chunk(consts, table, strike, False,
                                       noise=noise))
    assert ref > 0
    assert abs(got / ref - 1.0) < 1e-4


@pytest.mark.gpu
def test_seeded_k6_matches_seeded_k1(cuda):
    """One key through K1 and K6 at a horizon both cover: the same paths
    up to float32 rounding, so both kernels draw one stream."""
    n_steps, rows, key = 1008, 1 << 15, pc._fold_words(8, 2)
    consts = pc.make_path_consts(*MARKET.values(), n_steps, DT, cuda)
    one = pc.pathgen(consts, rows=rows, key=key)
    tiled = ptc.tiled_pathgen(consts, rows=rows, key=key)
    torch.cuda.synchronize()
    torch.testing.assert_close(tiled, one, rtol=2e-4, atol=0)


@pytest.mark.gpu
def test_tiled_wrappers_reject_bad_inputs(cuda):
    from montecarlooptionspricer_tpu_torch.kernels import build

    for bp in ptc.BLOCK_CHOICES:      # the Python memory model is the card's
        assert build.load().mcop_tiled_smem_bytes(bp) == ptc.smem_bytes(bp)
    consts = pc.make_path_consts(*MARKET.values(), 400, DT, cuda)
    table = torch.zeros((8, 512), device=cuda)
    with pytest.raises(ValueError):      # rows not a multiple of 16
        ptc.tiled_pathgen(consts, rows=100, key=1)
    with pytest.raises(ValueError):
        ptc.tiled_priced_chunk(consts, table, 100.0, False, rows=40, key=1)
    with pytest.raises(ValueError):      # noise on the wrong device
        ptc.tiled_pathgen(consts, noise=torch.zeros((2, 64, 400)))
    with pytest.raises(ValueError):      # table on the wrong device
        ptc.tiled_priced_chunk(consts, table.cpu(), 100.0, False, rows=64,
                               key=1)
