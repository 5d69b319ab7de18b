"""Each CUDA kernel of the port against its plain PyTorch version on the
card.  Skips without a CUDA device.  The file imports no JAX, so on a
machine without JAX it runs with the repository's conftest switched off:

    python -m pytest --noconftest tests/test_torch_gpu.py -m gpu
"""

import pytest
import torch

from montecarlooptionspricer_tpu_torch.models import engine
from montecarlooptionspricer_tpu_torch.models import pathgen_cuda as pc

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
