"""Each CUDA kernel of the port against its plain PyTorch version on the
card.  Skips without a CUDA device.  The file imports no JAX, so on a
machine without JAX it runs with the repository's conftest switched off:

    python -m pytest --noconftest tests/test_torch_gpu.py -m gpu
"""

import ctypes
import dataclasses

import pytest
import torch

from montecarlooptionspricer_tpu_torch.models import chain_cuda as cc
from montecarlooptionspricer_tpu_torch.models import engine
from montecarlooptionspricer_tpu_torch.models import greeks_cuda as gc
from montecarlooptionspricer_tpu_torch.models import pathgen_cuda as pc
from montecarlooptionspricer_tpu_torch.models import (
    pathgen_factored_cuda as pfc)
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
        assert build.load().mcop_tiled_smem_bytes(bp, 0, 0, 0) == \
            ptc.smem_bytes(bp)
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


def _strip_tables(cuda, consts, noise, strikes, scale=1.0):
    """S-space tables of a put strip fitted on the first 16384 paths of
    ``noise`` (times ``scale``), and their log forms."""
    n = consts.n_steps
    pilot = pc.pathgen_from_noise_ref(
        consts, (scale * noise[:, : 1 << 14]).contiguous())
    strip = torch.tensor(strikes, device=cuda)
    _, fits = engine.lsm_fit(pilot, MARKET["r"], strip, n * DT, DT, False)
    tables = pc.boundary_rows(fits, MARKET["r"], strip, n * DT, DT, n,
                              False).contiguous()
    return tables, pc.log_boundary_rows(tables).contiguous()


def _rel(got, want):
    """Largest |got - want| over each row's scale, floored at 1e-3 of the
    row's largest entry (a deep out-of-the-money strike's sum is ~0)."""
    floor = 1e-3 * want.abs().amax(dim=-1, keepdim=True)
    return float(((got - want).abs() / torch.maximum(want.abs(), floor))
                 .max())


@pytest.mark.gpu
@pytest.mark.parametrize("n_steps,n_strikes", [(96, 23), (365, 23),
                                               (365, 40), (400, 23),
                                               (512, 23)])
def test_chain_kernel_matches_plain_version(cuda, n_steps, n_strikes):
    """K5's [K] sums against its plain version, seeded and noise-in, at the
    main path's chunk of 131072 rows: rtol 1e-4 per strike (a decision
    flips only inside the float32 root band).  23 strikes do not divide
    the kernel's strike lanes; 40 take two launches of one key.  400 and
    512 steps are past the single tile, where the chain's pilot runs on K6
    and K5 still streams (64-path blocks)."""
    rows = 1 << 17
    consts = pc.make_path_consts(*MARKET.values(), n_steps, DT, cuda)
    key = pc._fold_words(5, 13)
    noise = pc.philox_normals_ref(key, rows, n_steps, device=cuda)
    tables, _ = _strip_tables(cuda, consts, noise,
                              torch.linspace(80.0, 120.0, n_strikes).tolist())
    want = cc.priced_chain_from_noise_ref(consts, tables, noise, False)
    before = cc.priced_chain.launches
    for got in (cc.priced_chain(consts, tables, False, noise=noise),
                cc.priced_chain(consts, tables, False, rows=rows, key=key)):
        torch.cuda.synchronize()
        assert got.shape == (n_strikes,)
        assert _rel(got, want) < 1e-4
    assert cc.priced_chain.launches - before == 2 * -(-n_strikes // cc.GROUP)


@pytest.mark.gpu
@pytest.mark.parametrize("n_steps,n_strikes", [(96, 23), (365, 21),
                                               (365, 40), (400, 23),
                                               (512, 23)])
def test_chain_pair_form_matches_plain_version(cuda, n_steps, n_strikes):
    """K5/anti at 131072 rows (65536 drawn): against its plain version,
    seeded and on noise, rtol 1e-4 per strike; against the unpaired K5 on
    the concatenated [X; -X] noise, rtol 1e-5 (each member's arithmetic is
    the unpaired path's, only the block sums' order differs).  40 strikes
    take two launches, which must regenerate the same pairs; the paired
    block holds 128 members at every horizon (no W plane resident)."""
    rows = 1 << 17
    consts = pc.make_path_consts(*MARKET.values(), n_steps, DT, cuda)
    key = pc._fold_words(5, 23)
    noise = pc.philox_normals_ref(key, rows // 2, n_steps, device=cuda)
    tables, _ = _strip_tables(cuda, consts, noise,
                              torch.linspace(80.0, 120.0, n_strikes).tolist())
    assert cc.block_paths_for(n_steps, rows, True) == 128
    want = cc.priced_chain_from_noise_ref(consts, tables, noise, False, True)
    before = dict(cc.priced_chain.form_launches)
    for got in (cc.priced_chain(consts, tables, False, noise=noise,
                                antithetic=True),
                cc.priced_chain(consts, tables, False, rows=rows, key=key,
                                antithetic=True)):
        torch.cuda.synchronize()
        assert got.shape == (n_strikes,)
        assert _rel(got, want) < 1e-4
    groups = -(-n_strikes // cc.GROUP)
    assert cc.priced_chain.form_launches["anti"] - before["anti"] == \
        2 * groups
    unpaired = cc.priced_chain(consts, tables, False,
                               noise=torch.cat([noise, -noise], dim=1))
    paired = cc.priced_chain(consts, tables, False, noise=noise,
                             antithetic=True)
    torch.cuda.synchronize()
    assert _rel(paired, unpaired) < 1e-5


@pytest.mark.gpu
def test_chain_kernel_wild_noise(cuda):
    """x3 noise: paths cross several strikes' intervals within one step
    tile and again in later tiles; each strike must stop at its own first
    hit, so K5 matches its plain version at rtol 1e-4."""
    n_steps, rows = 365, 1 << 17
    consts = pc.make_path_consts(*MARKET.values(), n_steps, DT, cuda)
    noise = 3.0 * pc.philox_normals_ref(pc._fold_words(6, 3), rows, n_steps,
                                        device=cuda)
    tables, _ = _strip_tables(cuda, consts, noise,
                              torch.linspace(70.0, 130.0, 21).tolist())
    want = cc.priced_chain_from_noise_ref(consts, tables, noise, False)
    got = cc.priced_chain(consts, tables, False, noise=noise)
    torch.cuda.synchronize()
    assert float(want.min()) > 0
    assert _rel(got, want) < 1e-4


@pytest.mark.gpu
def test_seeded_chain_of_one_matches_k2(cuda):
    """Seeded K5 with one strike against seeded K2 on the same key and the
    same fit: K5 decides on the S-space table, K2 on its log form, which
    differ only in the root band (rtol 1e-4)."""
    n_steps, rows = 365, 1 << 17
    consts = pc.make_path_consts(*MARKET.values(), n_steps, DT, cuda)
    key = pc._fold_words(5, 17)
    noise = pc.philox_normals_ref(key, rows, n_steps, device=cuda)
    tables, logs = _strip_tables(cuda, consts, noise, [104.0])
    k5 = float(cc.priced_chain(consts, tables, False, rows=rows, key=key)[0])
    k2 = float(pc.priced_chunk(consts, logs[0], 104.0, False, rows=rows,
                               key=key))
    assert k2 > 0 and abs(k5 / k2 - 1.0) < 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("n_steps", [96, 365])
def test_greeks_kernels_match_plain_version(cuda, n_steps):
    """K4's [6, K] sums and K3's [6] against their plain version, seeded
    and noise-in, at 131072 rows: 2e-4 of each output's scale (the tangent
    sums run in another float32 order; a decision flips only inside the
    root band).  K4's columns equal K3 on each strike (the same body) up
    to the order of the cross-block sum: 1e-6 of each output's largest."""
    rows = 1 << 17
    consts = pc.make_path_consts(*MARKET.values(), n_steps, DT, cuda)
    g = pc.make_greeks_consts(MARKET["xi"], MARKET["h"], MARKET["eta"],
                              n_steps, DT, cuda)
    key = pc._fold_words(5, 19)
    noise = pc.philox_normals_ref(key, rows, n_steps, device=cuda)
    strikes = torch.linspace(85.0, 115.0, 23).tolist()
    _, logs = _strip_tables(cuda, consts, noise, strikes)
    want = gc.greeks_from_noise_ref(consts, g, logs,
                                    torch.tensor(strikes, device=cuda),
                                    noise, False)
    for kw in ({"noise": noise}, {"rows": rows, "key": key}):
        got = gc.chain_greeks_chunk(consts, g, logs, False, **kw)
        torch.cuda.synchronize()
        assert got.shape == (6, 23)
        assert _rel(got, want) < 2e-4
        for j in (0, 11, 22):
            one = gc.greeks_chunk(consts, g, logs[j], strikes[j], False,
                                  **kw)
            torch.cuda.synchronize()
            scale = got.abs().amax(dim=1)
            assert bool(((one - got[:, j]).abs() <= 1e-6 * scale).all())


@pytest.mark.gpu
@pytest.mark.parametrize("n_steps,n_strikes", [(96, 23), (365, 21),
                                               (365, 40)])
def test_greeks_pair_forms_match_plain_version(cuda, n_steps, n_strikes):
    """K3/anti and K4/anti at 131072 rows (65536 drawn): against their
    plain version, seeded and on noise, 2e-4 of each output's scale;
    against the unpaired forms on the concatenated [X; -X] noise, 1e-5 of
    each output's scale (the partner negates x', hx and W only, so each
    member's arithmetic is the unpaired path's).  K4's columns equal
    K3/anti per strike up to the cross-block sum's order."""
    rows = 1 << 17
    consts = pc.make_path_consts(*MARKET.values(), n_steps, DT, cuda)
    g = pc.make_greeks_consts(MARKET["xi"], MARKET["h"], MARKET["eta"],
                              n_steps, DT, cuda)
    key = pc._fold_words(5, 29)
    noise = pc.philox_normals_ref(key, rows // 2, n_steps, device=cuda)
    strikes = torch.linspace(85.0, 115.0, n_strikes).tolist()
    _, logs = _strip_tables(cuda, consts, noise, strikes)
    assert gc.block_paths_for(n_steps, rows, True) == (
        128 if n_steps <= 96 else 64)
    want = gc.greeks_from_noise_ref(consts, g, logs,
                                    torch.tensor(strikes, device=cuda),
                                    noise, False, True)
    for kw in ({"noise": noise}, {"rows": rows, "key": key}):
        got = gc.chain_greeks_chunk(consts, g, logs, False, antithetic=True,
                                    **kw)
        torch.cuda.synchronize()
        assert got.shape == (6, n_strikes)
        assert _rel(got, want) < 2e-4
        for j in (0, n_strikes // 2):
            one = gc.greeks_chunk(consts, g, logs[j], strikes[j], False,
                                  antithetic=True, **kw)
            torch.cuda.synchronize()
            assert _rel(one[:, None], want[:, j:j + 1]) < 2e-4
            scale = got.abs().amax(dim=1)
            assert bool(((one - got[:, j]).abs() <= 1e-6 * scale).all())
    doubled = torch.cat([noise, -noise], dim=1)
    unpaired = gc.chain_greeks_chunk(consts, g, logs, False, noise=doubled)
    paired = gc.chain_greeks_chunk(consts, g, logs, False, noise=noise,
                                   antithetic=True)
    one_u = gc.greeks_chunk(consts, g, logs[0], strikes[0], False,
                            noise=doubled)
    one_p = gc.greeks_chunk(consts, g, logs[0], strikes[0], False,
                            noise=noise, antithetic=True)
    torch.cuda.synchronize()
    assert _rel(paired, unpaired) < 1e-5
    assert _rel(one_p[:, None], one_u[:, None]) < 1e-5


@pytest.mark.gpu
def test_chain_and_greeks_wrappers_reject_bad_inputs(cuda):
    from montecarlooptionspricer_tpu_torch.kernels import build

    lib = build.load()
    for n in (96, 365, 512):       # the Python memory models are the card's
        for k in (1, 21, cc.GROUP):
            for bp in pc.BLOCK_CHOICES:
                for quad in (0, 1):
                    assert lib.mcop_chain_smem_bytes(n, bp, 0, 0, quad,
                                                     k) == \
                        cc.smem_bytes(n, bp, quadratic=bool(quad),
                                      n_strikes=k)
                assert lib.mcop_greeks_smem_bytes(n, bp, 0, k) == \
                    gc.smem_bytes(n, bp, n_strikes=k)
            for bp in pc.PAIRED_BLOCK_CHOICES:
                assert lib.mcop_chain_smem_bytes(n, bp, 1, 0, 0, k) == \
                    cc.smem_bytes(n, bp, True, n_strikes=k)
                assert lib.mcop_greeks_smem_bytes(n, bp, 1, k) == \
                    gc.smem_bytes(n, bp, True, n_strikes=k)
    assert lib.mcop_chain_group() == cc.GROUP
    assert lib.mcop_greeks_group() == gc.GROUP
    consts = pc.make_path_consts(*MARKET.values(), 64, DT, cuda)
    g = pc.make_greeks_consts(MARKET["xi"], MARKET["h"], MARKET["eta"], 64,
                              DT, cuda)
    tables = torch.zeros((3, 8, 128), device=cuda)
    with pytest.raises(ValueError):      # rows not a multiple of 16
        cc.priced_chain(consts, tables, False, rows=40, key=1)
    with pytest.raises(ValueError):      # tables on the wrong device
        cc.priced_chain(consts, tables.cpu(), False, rows=64, key=1)
    with pytest.raises(ValueError):      # one table, not a strip
        cc.priced_chain(consts, tables[0], False, rows=64, key=1)
    with pytest.raises(ValueError):      # noise on the wrong device
        gc.greeks_chunk(consts, g, tables[0], 100.0, False,
                        noise=torch.zeros((2, 64, 64)))
    with pytest.raises(ValueError):      # non-contiguous tables
        gc.chain_greeks_chunk(consts, g, tables[:, :, ::2], False, rows=64,
                              key=1)
    with pytest.raises(ValueError):      # Greeks constants on the CPU
        gc.chain_greeks_chunk(consts, pc.make_greeks_consts(
            MARKET["xi"], MARKET["h"], MARKET["eta"], 64, DT, "cpu"),
            tables, False, rows=64, key=1)


@pytest.mark.gpu
@pytest.mark.parametrize("n_steps,rows", [(1825, 1 << 17), (4000, 1 << 17),
                                          (200, 1 << 17), (8192, 1 << 16)])
def test_factored_kernels_match_plain_versions(cuda, n_steps, rows):
    """K8 paths elementwise at rtol 5e-4 (the JAX package's own
    factored-vs-dense tolerance at m2 2048) and K9 chunk sums at rtol 1e-4
    against their plain versions, seeded (so also against
    philox_factored_normals_ref) and noise-in, at the main path's chunk of
    131072 rows; at K8's cap of 8192 steps (N2 64, one path a block) on
    65536 rows, which keeps the plain version's planes in memory."""
    consts = pfc.make_factored_consts(*MARKET.values(), n_steps, DT, cuda)
    key = pc._fold_words(5, 23)
    noise = pfc.philox_factored_normals_ref(key, rows, n_steps, device=cuda)
    want = pfc.factored_pathgen_from_noise_ref(consts, noise)
    for got in (pfc.factored_pathgen(consts, noise=noise),
                pfc.factored_pathgen(consts, rows=rows, key=key)):
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=5e-4, atol=0)
        del got

    strike, maturity = 100.0, n_steps * DT
    _, fits = engine.lsm_fit(want[: 1 << 14], MARKET["r"], strike, maturity,
                             DT, False)
    del want
    table = pc.log_boundary_rows(pc.boundary_rows(
        fits, MARKET["r"], strike, maturity, DT, n_steps, False)).contiguous()
    ref = float(pfc.factored_priced_chunk_from_noise_ref(consts, table, noise,
                                                         strike, False))
    assert ref > 0
    for got in (pfc.factored_priced_chunk(consts, table, strike, False,
                                          noise=noise),
                pfc.factored_priced_chunk(consts, table, strike, False,
                                          rows=rows, key=key)):
        torch.cuda.synchronize()
        assert abs(float(got) / ref - 1.0) < 1e-4


@pytest.mark.gpu
def test_factored_priced_first_exercise_wild_noise(cuda):
    """Wild noise (x3): many paths enter the exercise interval in their
    first step tile and again later; each must count once, at its first
    hit (K9's ballot over a warp's 128 steps, then the warp leaves the
    path), so K9 matches its plain version at rtol 1e-4."""
    n_steps, rows, strike = 1825, 1 << 17, 100.0
    consts = pfc.make_factored_consts(*MARKET.values(), n_steps, DT, cuda)
    noise = 3.0 * pfc.philox_factored_normals_ref(pc._fold_words(6, 5), rows,
                                                  n_steps, device=cuda)
    paths = pfc.factored_pathgen(consts,
                                 noise=noise[:, : 1 << 14].contiguous())
    _, fits = engine.lsm_fit(paths, MARKET["r"], strike, n_steps * DT, DT,
                             False)
    del paths
    table = pc.log_boundary_rows(pc.boundary_rows(
        fits, MARKET["r"], strike, n_steps * DT, DT, n_steps,
        False)).contiguous()
    ls = pfc._log_paths_ref(consts, noise[:, :4096])
    ex = (ls >= table[0, :n_steps]) & (ls <= table[1, :n_steps])
    assert float((ex[:, :128].any(1) & ex[:, 128:].any(1)).float().mean()) \
        > 0.02
    del ls, ex
    ref = float(pfc.factored_priced_chunk_from_noise_ref(consts, table, noise,
                                                         strike, False))
    got = float(pfc.factored_priced_chunk(consts, table, strike, False,
                                          noise=noise))
    assert ref > 0
    assert abs(got / ref - 1.0) < 1e-4


@pytest.mark.gpu
def test_factored_price_matches_slab_price_under_same_fits(cuda):
    """1e6 paths x 1825 steps: the factored family (spectral law, K9)
    against the chol slab (K7) under one set of fits from the slab's
    pilot.  The two laws are the same and the noise differs: within 5
    combined stderr."""
    n_steps, chunk = 1825, 1 << 17
    kw = dict(s0=100.0, xi=0.04, h=0.1, eta=1.5, rho=-0.4, r=0.04,
              strike=105.0, maturity=n_steps * DT, is_call=False,
              device=cuda)
    prices = {}
    slab = None
    for impl in ("slab", "factored"):
        cfg = engine.StreamConfig(n_paths=8 * chunk, n_steps=n_steps,
                                  chunk_paths=chunk, pilot_paths=chunk,
                                  tiled_impl=impl)
        pricer = engine.StreamingPricer(**kw, config=cfg)
        if slab is None:
            slab = pricer
            fits = pricer.fit(engine._pilot_stream_keys(3)[0])
        prices[impl] = pricer.price_with_fit(fits, 3, with_stderr=True)
    assert pricer.kernel_family == "factored" \
        and slab.kernel_family == "tiled"
    (p_s, se_s), (p_f, se_f) = prices["slab"], prices["factored"]
    assert 0 < se_s < 0.01 * p_s and 0 < se_f < 0.01 * p_f
    assert abs(p_f - p_s) < 5 * (se_s ** 2 + se_f ** 2) ** 0.5, prices


@pytest.mark.gpu
def test_factored_wrappers_reject_bad_inputs(cuda):
    from montecarlooptionspricer_tpu_torch.kernels import build

    lib = build.load()
    for n in (129, 200, 1825, 4000, 8192):   # the Python memory model
        assert lib.mcop_factored_smem_bytes(n) == pfc.smem_bytes(n)
    assert lib.mcop_factored_smem_bytes(128) == -1
    assert lib.mcop_factored_smem_bytes(8193) == -1
    consts = pfc.make_factored_consts(*MARKET.values(), 400, DT, cuda)
    table = torch.zeros((8, 512), device=cuda)
    with pytest.raises(ValueError):      # rows not a multiple of 8 paths
        pfc.factored_pathgen(consts, rows=100, key=1)
    with pytest.raises(ValueError):
        pfc.factored_priced_chunk(consts, table, 100.0, False, rows=4,
                                  key=1)
    with pytest.raises(ValueError):      # noise on the wrong device
        pfc.factored_pathgen(consts, noise=torch.zeros((3, 64, 512)))
    with pytest.raises(ValueError):      # noise off a 16-byte boundary
        flat = torch.zeros(3 * 64 * 512 + 1, device=cuda)
        pfc.factored_pathgen(consts, noise=flat[1:].view(3, 64, 512))
    with pytest.raises(ValueError):      # table on the wrong device
        pfc.factored_priced_chunk(consts, table.cpu(), 100.0, False,
                                  rows=64, key=1)


# ---------------------------------------------------------------------------
# The estimator forms of K2, K7 and K9 (antithetic, control variate, both).

FORMS = [(True, False), (False, True), (True, True)]


def _fitted_table(consts, paths, n_steps, strike=100.0):
    _, fits = engine.lsm_fit(paths, MARKET["r"], strike, n_steps * DT, DT,
                             False)
    return pc.log_boundary_rows(pc.boundary_rows(
        fits, MARKET["r"], strike, n_steps * DT, DT, n_steps,
        False)).contiguous()


def _check_forms(priced, ref, consts, table, normals, rows, key):
    """Each form of one priced kernel against its plain version, seeded
    (so also against the stream's reference) and on noise: payoff and
    control sums at rtol 1e-4 (a stop decision flips only inside the
    float32 root band; the control sums order differs).  Paired, the
    kernel on [planes, rows / 2, m] against its unpaired form on the
    concatenated [X; -X] noise: each member's arithmetic is the unpaired
    path's, so only the order of the block sums differs (rtol 1e-5)."""
    for anti, cv in FORMS:
        noise = normals(key, rows // 2 if anti else rows)
        want = ref(consts, table, noise, 100.0, False, anti, cv)
        want = want if cv else (want,)
        form = dict(antithetic=anti, with_cv=cv)
        for got in (priced(consts, table, 100.0, False, noise=noise, **form),
                    priced(consts, table, 100.0, False, rows=rows, key=key,
                           **form)):
            torch.cuda.synchronize()
            for g, w in zip(got if cv else (got,), want):
                assert float(w) > 0
                assert abs(float(g) / float(w) - 1.0) < 1e-4, (anti, cv)
        if anti:
            paired = priced(consts, table, 100.0, False, noise=noise, **form)
            unpaired = priced(consts, table, 100.0, False,
                              noise=torch.cat([noise, -noise], dim=1),
                              with_cv=cv)
            torch.cuda.synchronize()
            for g, w in zip(paired if cv else (paired,),
                            unpaired if cv else (unpaired,)):
                assert abs(float(g) / float(w) - 1.0) < 1e-5, cv
        del noise


@pytest.mark.gpu
@pytest.mark.parametrize("n_steps", [96, 365])
def test_k2_forms_match_plain_versions(cuda, n_steps):
    """K2's antithetic, CV and paired-CV forms at the main path's chunk of
    131072 rows (the paired blocks hold 128, 64 or 32 members; the float32
    chol pair's 64)."""
    rows, key = 1 << 17, pc._fold_words(5, 31)
    consts = pc.make_path_consts(*MARKET.values(), n_steps, DT, cuda)
    table = _fitted_table(consts, pc.pathgen(consts, rows=1 << 14, key=key),
                          n_steps)
    assert pc.priced_block_paths(consts, rows, True) == 64
    _check_forms(pc.priced_chunk, pc.priced_chunk_from_noise_ref, consts,
                 table, lambda k, r: pc.philox_normals_ref(
                     k, r, n_steps, device=cuda), rows, key)


@pytest.mark.gpu
@pytest.mark.parametrize("n_steps", [1825, 300])
def test_k7_forms_match_plain_versions(cuda, n_steps):
    """K7's forms at 131072 rows; 300 steps crosses three step tiles."""
    rows, key = 1 << 17, pc._fold_words(5, 37)
    consts = pc.make_path_consts(*MARKET.values(), n_steps, DT, cuda)
    table = _fitted_table(
        consts, ptc.tiled_pathgen(consts, rows=1 << 14, key=key), n_steps)
    _check_forms(ptc.tiled_priced_chunk, ptc.priced_chunk_from_noise_ref,
                 consts, table, lambda k, r: pc.philox_normals_ref(
                     k, r, n_steps, device=cuda), rows, key)


@pytest.mark.gpu
@pytest.mark.parametrize("n_steps,rows", [(1825, 1 << 17), (4000, 1 << 17),
                                          (8192, 1 << 14)])
def test_k9_forms_match_plain_versions(cuda, n_steps, rows):
    """K9's forms at 131072 rows; at 8192 steps a paired block holds one
    drawn path and its partner (16384 rows keep the plain version's
    planes in memory).  The CV forms scan every path to its last step
    after the first hit."""
    key = pc._fold_words(5, 41)
    consts = pfc.make_factored_consts(*MARKET.values(), n_steps, DT, cuda)
    table = _fitted_table(
        consts, pfc.factored_pathgen(consts, rows=1 << 13, key=key), n_steps)
    _check_forms(pfc.factored_priced_chunk,
                 pfc.factored_priced_chunk_from_noise_ref, consts, table,
                 lambda k, r: pfc.philox_factored_normals_ref(
                     k, r, n_steps, device=cuda), rows, key)


@pytest.mark.gpu
def test_form_wrappers_reject_bad_inputs(cuda):
    """Odd path counts and blocks that do not fill under pairing raise
    before a launch; the tiled kernels' memory model is the card's in
    every form."""
    from montecarlooptionspricer_tpu_torch.kernels import build

    for bp in ptc.PAIRED_BLOCK_CHOICES:
        for cv in (0, 1):
            assert build.load().mcop_tiled_smem_bytes(bp, 1, cv, 0) == \
                ptc.smem_bytes(bp, True, bool(cv))
    consts = pc.make_path_consts(*MARKET.values(), 96, DT, cuda)
    table = torch.zeros((8, 128), device=cuda)
    with pytest.raises(ValueError):      # odd rows
        pc.priced_chunk(consts, table, 100.0, False, rows=65, key=1,
                        antithetic=True)
    with pytest.raises(ValueError):      # no paired block divides 48 rows
        pc.priced_chunk(consts, table, 100.0, False, rows=48, key=1,
                        antithetic=True)
    with pytest.raises(ValueError):
        ptc.tiled_priced_chunk(consts, table, 100.0, False, rows=48, key=1,
                               antithetic=True)
    fconsts = pfc.make_factored_consts(*MARKET.values(), 400, DT, cuda)
    ftable = torch.zeros((8, 512), device=cuda)
    with pytest.raises(ValueError):      # 4 drawn rows, 8 paths a block
        pfc.factored_priced_chunk(fconsts, ftable, 100.0, False, rows=8,
                                  key=1, antithetic=True)


@pytest.mark.gpu
def test_generic_stream_on_the_card(cuda):
    """The generic path stream on the card: its matmul and FFT syntheses
    agree on the same noise (2e-4 of the largest price), a paired chunk's
    members are the unpaired paths of (z, dw) and (-z, -dw) (1e-5 of the
    largest price), and a 600-step strip, past K5, prices through it
    without launching a kernel."""
    from montecarlooptionspricer_tpu_torch.models import pathgen_stream as ps

    n_steps = 600
    market = (MARKET["s0"], MARKET["xi"], MARKET["h"], MARKET["eta"],
              MARKET["r"])
    consts = ps.make_stream_consts(*market, n_steps, DT, cuda)
    fft = ps.make_stream_consts(*market, n_steps, DT, cuda, fgn_impl="fft")
    z, dw = ps.draw_noise(consts, 2048, ps.stream_generator(cuda, (7, 3)))
    a = ps.paths_from_noise(consts, z, dw)
    b = ps.paths_from_noise(fft, z, dw)
    paired = ps.paths_from_noise(consts, z, dw, antithetic=True)
    minus = ps.paths_from_noise(consts, -z, -dw)
    torch.cuda.synchronize()
    scale = float(a.abs().max())
    assert bool(torch.isfinite(a).all())
    assert float((a - b).abs().max()) <= 2e-4 * scale
    assert float((paired - torch.cat([a, minus])).abs().max()) <= 1e-5 * scale
    cfg = engine.StreamConfig(n_paths=4 << 12, n_steps=n_steps,
                              chunk_paths=1 << 12, pilot_paths=1 << 12,
                              dt=DT, antithetic=True)
    chain = engine.StreamingChainPricer(
        *market[:4], -0.4, MARKET["r"], [95.0, 105.0], n_steps * DT, False,
        cfg, device=cuda)
    before = cc.priced_chain.launches + pc.pathgen.launches
    prices, stderrs = chain.price(3, with_stderr=True)
    assert chain.kernel_family == "stream"
    assert cc.priced_chain.launches + pc.pathgen.launches == before
    assert (prices > 0).all() and (stderrs > 0).all()


# The whole-path pair forms of K1, K6 and K8: (wrapper, plain version,
# seeded stream's reference, constants, path rtol) per family.
def _path_family(family, n_steps, cuda):
    if family == "factored":
        return (pfc.factored_pathgen, pfc.factored_pathgen_from_noise_ref,
                pfc.philox_factored_normals_ref,
                pfc.make_factored_consts(*MARKET.values(), n_steps, DT, cuda),
                5e-4)
    wrapper = pc.pathgen if family == "single" else ptc.tiled_pathgen
    return (wrapper, pc.pathgen_from_noise_ref, pc.philox_normals_ref,
            pc.make_path_consts(*MARKET.values(), n_steps, DT, cuda), 2e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("family,n_steps", [
    ("single", 47), ("single", 365), ("tiled", 1825), ("factored", 4000),
    ("factored", 8192)])
def test_path_pair_forms_match_plain_versions(cuda, family, n_steps):
    """K1/anti, K6/anti and K8/anti at the main path's chunk of 131072
    rows (65536 drawn): paths elementwise against their plain versions,
    seeded (so also against the stream's reference) and on noise, at the
    unpaired kernels' path tolerances (2e-4; 5e-4 for K8's four-step DFT);
    and on noise against the unpaired kernel on the concatenated [X; -X]
    noise at rtol 1e-6, as each member's arithmetic is the unpaired
    path's (the fGN map is linear, so the partner's plane is exactly
    -x).  K8/anti at 8192 steps is K8's cap: the pair form keeps the
    plain form's shared memory."""
    rows, key = 1 << 17, pc._fold_words(5, 41)
    wrapper, ref, normals, consts, rtol = _path_family(family, n_steps,
                                                       cuda)
    noise = normals(key, rows // 2, n_steps, device=cuda)
    want = ref(consts, noise, antithetic=True)
    assert want.shape == (rows, n_steps + 1)
    got = wrapper(consts, rows=rows, key=key, antithetic=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=rtol, atol=0)
    del got, want
    got = wrapper(consts, noise=noise, antithetic=True)
    torch.cuda.synchronize()
    both = torch.cat([noise, -noise], dim=1)
    del noise
    torch.testing.assert_close(got, wrapper(consts, noise=both), rtol=1e-6,
                               atol=0)
    del both
    want = ref(consts, normals(key, rows // 2, n_steps, device=cuda),
               antithetic=True)
    torch.testing.assert_close(got, want, rtol=rtol, atol=0)


@pytest.mark.gpu
def test_seeded_k1_pair_lower_sum_matches_k2_pair(cuda):
    """One key gives K1/anti and K2/anti the same pairs: the fitted
    policy's value summed over K1/anti's whole paths (the bounds' lower
    side, S-space decisions) equals K2/anti's priced sum (log-space
    interval decisions) within 1e-4, at 365 steps and 131072 rows; the
    decisions differ only inside the float32 root band."""
    n_steps, rows, strike = 365, 1 << 17, 100.0
    maturity = n_steps * DT
    consts = pc.make_path_consts(*MARKET.values(), n_steps, DT, cuda)
    pilot = pc.pathgen(consts, rows=1 << 15, key=pc._fold_words(5, 43))
    _, fits = engine.lsm_fit(pilot, MARKET["r"], strike, maturity, DT, False)
    table = pc.log_boundary_rows(pc.boundary_rows(
        fits, MARKET["r"], strike, maturity, DT, n_steps, False)).contiguous()
    key = pc._fold_words(5, 44)
    ex0, _ = pc.time0_value(fits, MARKET["s0"], strike, False)
    assert not bool(ex0)
    lower, _ = engine.lsm_policy_value(
        pc.pathgen(consts, rows=rows, key=key, antithetic=True), fits,
        MARKET["r"], strike, maturity, DT, False)
    priced = pc.priced_chunk(consts, table, strike, False, rows=rows,
                             key=key, antithetic=True)
    torch.cuda.synchronize()
    assert float(priced) > 0
    assert abs(float(lower) / float(priced) - 1.0) < 1e-4


@pytest.mark.gpu
def test_bounds_on_the_card(cuda):
    """price_with_bounds at a small width on each kernel family, plain
    and paired: lower <= upper, finite stderrs, the family's path kernel
    launched once for the pilot and once per chunk in the right form, and
    the priced kernels never."""
    for n_steps, kw, wrapper in (
            (96, {}, pc.pathgen), (400, {}, ptc.tiled_pathgen),
            (400, {"tiled_impl": "factored"}, pfc.factored_pathgen)):
        for anti in (False, True):
            cfg = engine.StreamConfig(n_paths=1 << 15, n_steps=n_steps,
                                      chunk_paths=1 << 13,
                                      pilot_paths=1 << 13, dt=DT,
                                      antithetic=anti, **kw)
            pricer = engine.StreamingPricer(
                MARKET["s0"], MARKET["xi"], MARKET["h"], MARKET["eta"], -0.4,
                MARKET["r"], 100.0, n_steps * DT, False, cfg, device=cuda)
            wrapper.launches = 0
            wrapper.form_launches = dict.fromkeys(wrapper.form_launches, 0)
            before = (pc.priced_chunk.launches,
                      ptc.tiled_priced_chunk.launches,
                      pfc.factored_priced_chunk.launches)
            lo, up, lo_se, up_se = pricer.price_with_bounds(
                3, with_stderr=True)
            assert lo <= up and 0 < lo_se < 1 and 0 < up_se < 1
            want = dict.fromkeys(wrapper.form_launches, 0)
            want.update(plain=1 + (0 if anti else 4), anti=4 if anti else 0)
            assert wrapper.form_launches == want
            assert before == (pc.priced_chunk.launches,
                              ptc.tiled_priced_chunk.launches,
                              pfc.factored_priced_chunk.launches)


# ---------------------------------------------------------------------------
# The spectral fGN form of K1/K2, K5 and K6/K7 (three noise planes, the
# dense X = Zr @ Cr' - Zi @ Ci').

def _spectral(n_steps, cuda, block_paths=0):
    return pc.make_path_consts(*MARKET.values(), n_steps, DT, cuda,
                               block_paths=block_paths, fgn_form="spectral")


def _check_path_forms(pathgen, consts, rows, key, cuda):
    """A whole-path kernel's spectral forms: plain and paired against the
    plain versions at rtol 2e-4, seeded and on noise, and the pair form on
    [3, rows / 2, n] equal to the bit to the unpaired form on [X; -X]
    (every rounding of a partner's cell is the unpaired path's)."""
    noise = pc.philox_spectral_normals_ref(key, rows, consts.n_steps,
                                           device=cuda)
    want = pc.pathgen_from_noise_ref(consts, noise)
    for got in (pathgen(consts, noise=noise),
                pathgen(consts, rows=rows, key=key)):
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=2e-4, atol=0)
    del want, noise
    half = pc.philox_spectral_normals_ref(key, rows // 2, consts.n_steps,
                                          device=cuda)
    want = pc.pathgen_from_noise_ref(consts, half, True)
    paired = pathgen(consts, noise=half, antithetic=True)
    for got in (paired, pathgen(consts, rows=rows, key=key,
                                antithetic=True)):
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=2e-4, atol=0)
    del want
    unpaired = pathgen(consts, noise=torch.cat([half, -half], dim=1))
    torch.cuda.synchronize()
    assert torch.equal(paired, unpaired)


@pytest.mark.gpu
@pytest.mark.parametrize("n_steps", [96, 365])
def test_spectral_k1_k2_match_plain_versions(cuda, n_steps):
    """K1 and K2 spectral in every form at the main path's chunk of 131072
    rows (a 32-path block at 365 steps, 64 members paired)."""
    rows, key = 1 << 17, pc._fold_words(5, 43)
    consts = _spectral(n_steps, cuda)
    assert consts.block_paths == (32 if n_steps == 365 else 64)
    _check_path_forms(pc.pathgen, consts, rows, key, cuda)
    table = _fitted_table(consts, pc.pathgen(consts, rows=1 << 14, key=key),
                          n_steps)
    normals = lambda k, r: pc.philox_spectral_normals_ref(  # noqa: E731
        k, r, n_steps, device=cuda)
    noise = normals(key, rows)
    want = float(pc.priced_chunk_from_noise_ref(consts, table, noise, 100.0,
                                                False))
    for got in (pc.priced_chunk(consts, table, 100.0, False, noise=noise),
                pc.priced_chunk(consts, table, 100.0, False, rows=rows,
                                key=key)):
        torch.cuda.synchronize()
        assert want > 0 and abs(float(got) / want - 1.0) < 1e-4
    del noise
    _check_forms(pc.priced_chunk, pc.priced_chunk_from_noise_ref, consts,
                 table, normals, rows, key)


@pytest.mark.gpu
@pytest.mark.parametrize("n_steps,n_strikes", [(365, 21), (512, 23)])
def test_spectral_chain_matches_plain_version(cuda, n_steps, n_strikes):
    """K5 spectral, plain and paired, seeded and noise-in, at 131072 rows:
    1e-4 of each strike's scale (floored at 1e-3 of the largest); paired
    on [3, rows / 2, n] against the unpaired form on [X; -X] at 1e-5."""
    rows, key = 1 << 17, pc._fold_words(5, 47)
    consts = _spectral(n_steps, cuda)
    strikes = [float(k) for k in torch.linspace(80.0, 120.0, n_strikes)]
    noise = pc.philox_spectral_normals_ref(key, rows, n_steps, device=cuda)
    tables, _ = _strip_tables(cuda, consts, noise, strikes)
    for anti in (False, True):
        nz = noise[:, : rows // 2].contiguous() if anti else noise
        want = cc.priced_chain_from_noise_ref(consts, tables, nz, False,
                                              anti)
        for got in (cc.priced_chain(consts, tables, False, noise=nz,
                                    antithetic=anti),
                    cc.priced_chain(consts, tables, False, rows=rows,
                                    key=key, antithetic=anti)):
            torch.cuda.synchronize()
            assert _rel(got, want) < 1e-4, anti
        if anti:
            paired = cc.priced_chain(consts, tables, False, noise=nz,
                                     antithetic=True)
            unpaired = cc.priced_chain(consts, tables, False,
                                       noise=torch.cat([nz, -nz], dim=1))
            torch.cuda.synchronize()
            assert _rel(paired, unpaired) < 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("n_steps", [1825, 300])
def test_spectral_slab_matches_plain_versions(cuda, n_steps):
    """K6 and K7 spectral in every form at 131072 rows; 300 steps crosses
    three output tiles, each reading every k-tile."""
    rows, key = 1 << 17, pc._fold_words(5, 53)
    consts = _spectral(n_steps, cuda)
    _check_path_forms(ptc.tiled_pathgen, consts, rows, key, cuda)
    table = _fitted_table(
        consts, ptc.tiled_pathgen(consts, rows=1 << 14, key=key), n_steps)
    normals = lambda k, r: pc.philox_spectral_normals_ref(  # noqa: E731
        k, r, n_steps, device=cuda)
    noise = normals(key, rows)
    want = float(ptc.priced_chunk_from_noise_ref(consts, table, noise, 100.0,
                                                 False))
    for got in (ptc.tiled_priced_chunk(consts, table, 100.0, False,
                                       noise=noise),
                ptc.tiled_priced_chunk(consts, table, 100.0, False,
                                       rows=rows, key=key)):
        torch.cuda.synchronize()
        assert want > 0 and abs(float(got) / want - 1.0) < 1e-4
    del noise
    _check_forms(ptc.tiled_priced_chunk, ptc.priced_chunk_from_noise_ref,
                 consts, table, normals, rows, key)


@pytest.mark.gpu
def test_spectral_wrappers_reject_bad_inputs(cuda):
    """The spectral memory models are the card's; chol-shaped noise [2,
    ...] under the spectral form (and [3, ...] under chol) raises before a
    launch."""
    from montecarlooptionspricer_tpu_torch.kernels import build

    lib = build.load()
    for n in (96, 365, 512):
        for anti, choices in ((0, pc.BLOCK_CHOICES),
                              (1, pc.PAIRED_BLOCK_CHOICES)):
            for bp in choices:
                assert lib.mcop_chain_smem_bytes(n, bp, anti, 1, 0,
                                                 cc.GROUP) == \
                    cc.smem_bytes(n, bp, bool(anti), True)
                for spec in (0, 1):   # K1's and K2's layout
                    assert lib.mcop_priced_smem_bytes(n, bp, anti, spec) == \
                        pc.priced_smem_bytes(n, bp, bool(anti), bool(spec))
    for anti, choices in ((0, ptc.BLOCK_CHOICES),
                          (1, ptc.PAIRED_BLOCK_CHOICES)):
        for bp in choices:
            for cv in (0, 1):
                assert lib.mcop_tiled_smem_bytes(bp, anti, cv, 1) == \
                    ptc.smem_bytes(bp, bool(anti), bool(cv), True)
    spec, chol = _spectral(64, cuda), pc.make_path_consts(
        *MARKET.values(), 64, DT, cuda)
    table = torch.zeros((8, 128), device=cuda)
    tables = torch.zeros((3, 8, 128), device=cuda)
    two = torch.zeros((2, 64, 64), device=cuda)
    three = torch.zeros((3, 64, 64), device=cuda)
    for fn in (lambda c, z: pc.pathgen(c, noise=z),
               lambda c, z: pc.priced_chunk(c, table, 100.0, False, noise=z),
               lambda c, z: cc.priced_chain(c, tables, False, noise=z),
               lambda c, z: ptc.tiled_pathgen(c, noise=z),
               lambda c, z: ptc.tiled_priced_chunk(c, table, 100.0, False,
                                                   noise=z)):
        with pytest.raises(ValueError, match="spectral noise"):
            fn(spec, two)
        with pytest.raises(ValueError, match="chol noise"):
            fn(chol, three)
    g = pc.make_greeks_consts(MARKET["xi"], MARKET["h"], MARKET["eta"], 64,
                              DT, cuda)
    with pytest.raises(NotImplementedError, match="jvp Greeks stream"):
        gc.greeks_chunk(spec, g, table, 100.0, False, rows=64, key=1)


@pytest.mark.gpu
def test_spectral_engine_on_the_card(cuda):
    """StreamingPricer and StreamingChainPricer with fgn_form="spectral"
    launch only the spectral bodies (K1 and K2; K1 and K5 at 96 steps;
    K8 and K5 at 400), and the single-strike price agrees with its plain
    versions on the same seed and fits within 1e-4."""
    counters = (pc.pathgen, pc.priced_chunk, cc.priced_chain,
                pfc.factored_pathgen)
    for fn in counters:
        fn.form_launches = dict.fromkeys(fn.form_launches, 0)
    cfg = engine.StreamConfig(n_paths=4 << 14, n_steps=96,
                              chunk_paths=1 << 14, pilot_paths=1 << 14,
                              dt=DT, fgn_form="spectral")
    pricer = engine.StreamingPricer(**MARKET, rho=0.0, strike=100.0,
                                    maturity=96 * DT, is_call=False,
                                    config=cfg, device=cuda)
    fits = pricer.fit(engine._pilot_stream_keys(3)[0])
    price = pricer.price_with_fit(fits, 3)
    consts = pricer.consts
    table = pricer._make_rows(fits)
    _, (run, start) = engine._pilot_stream_keys(3)
    total = sum(float(pc.priced_chunk_from_noise_ref(
        consts, table, pc.philox_spectral_normals_ref(
            pc._fold_words(run, start + i), 1 << 14, 96, device=cuda),
        100.0, False)) for i in range(4))
    assert abs(price / (total / (4 << 14)) - 1.0) < 1e-4
    assert pc.pathgen.form_launches == dict(
        dict.fromkeys(pc.pathgen.form_launches, 0), spectral=1)
    assert pc.priced_chunk.form_launches["spectral"] == 4
    assert sum(pc.priced_chunk.form_launches.values()) == 4
    for n_steps in (96, 400):
        chain = engine.StreamingChainPricer(
            **MARKET, rho=0.0, strikes=[95.0, 105.0],
            maturity=n_steps * DT, is_call=False,
            config=engine.StreamConfig(
                n_paths=2 << 14, n_steps=n_steps, chunk_paths=1 << 14,
                pilot_paths=1 << 14, dt=DT, fgn_form="spectral"),
            device=cuda)
        assert chain.kernel_family == ("single" if n_steps == 96
                                       else "factored")
        prices = chain.price(3)
        assert all(0.0 < p < 105.0 for p in prices)
    assert cc.priced_chain.form_launches == dict(
        dict.fromkeys(cc.priced_chain.form_launches, 0), spectral=4)
    assert pfc.factored_pathgen.form_launches["plain"] == 1


@pytest.mark.gpu
def test_spectral_upper_rows_reach_early_columns_on_card(cuda):
    """Zr and Zi zero in the first output tile of each kernel (64 columns
    for K1, 128 for K6) and random past it: the dense Cr' and Ci' carry
    that noise into the first tile, so a kernel that kept the chol form's
    triangle skip would leave it flat there.  Each kernel's paths against
    its plain version at rtol 2e-4, and the first tile moved by more than
    1e-2 from the paths without fGN noise."""
    for pathgen, n_steps, tile in ((pc.pathgen, 150, pc.TILE_COLS),
                                   (ptc.tiled_pathgen, 300, ptc.TILE_COLS)):
        consts = _spectral(n_steps, cuda)
        noise = pc.philox_spectral_normals_ref(pc._fold_words(5, 59),
                                               1 << 14, n_steps, device=cuda)
        noise[:2, :, :tile] = 0.0
        got = pathgen(consts, noise=noise)
        torch.cuda.synchronize()
        torch.testing.assert_close(
            got, pc.pathgen_from_noise_ref(consts, noise), rtol=2e-4, atol=0)
        no_fgn = noise.clone()
        no_fgn[:2] = 0.0
        flat = pathgen(consts, noise=no_fgn)
        torch.cuda.synchronize()
        assert float((got[:, 1:tile + 1] - flat[:, 1:tile + 1]).abs()
                     .max()) > 1e-2


# ---------------------------------------------------------------------------
# The quadratic exercise-policy forms (QUAD) of K2, K7, K9 and K5.

def _policy_table(consts, paths, n_steps, strike=100.0):
    """policy_rows of a put fitted on ``paths``, and the log boundary table
    of the same fit."""
    _, fits = engine.lsm_fit(paths, MARKET["r"], strike, n_steps * DT, DT,
                             False)
    quad = pc.policy_rows(fits, MARKET["r"], strike, n_steps * DT, DT,
                          n_steps, False).contiguous()
    return quad, pc.log_boundary_rows(pc.boundary_rows(
        fits, MARKET["r"], strike, n_steps * DT, DT, n_steps,
        False)).contiguous()


def _check_quad_forms(priced, ref, consts, tables, normals, rows, key,
                      spectral=False, bf16=False):
    """The quadratic form of one priced kernel, plain and CV, against its
    plain version, seeded and on noise: both lanes at rtol 1e-4 (a stop
    decision flips only inside the float32 root band, where an exp of
    the kernel and of PyTorch differ by an ulp).  Seeded, against the
    boundary form on the same key: the same paths, so the control sums
    agree to 1e-6 and the payoff sums to 1e-3 (the two policies decide
    apart only in the root band and where a step's exercise set is two
    intervals).  Each launch counts under its own form (``bf16``: the
    bf16 form's key)."""
    quad, boundary = tables
    noise = normals(key, rows)
    for cv in (False, True):
        want = ref(consts, quad, noise, 100.0, False, False, cv, "quadratic")
        want = want if cv else (want,)
        name = pc.form_name(False, cv, spectral, quadratic=True, bf16=bf16)
        before = priced.form_launches[name]
        seeded = priced(consts, quad, 100.0, False, rows=rows, key=key,
                        with_cv=cv, policy_form="quadratic")
        for got in (priced(consts, quad, 100.0, False, noise=noise,
                           with_cv=cv, policy_form="quadratic"), seeded):
            torch.cuda.synchronize()
            for g, w in zip(got if cv else (got,), want):
                assert float(w) > 0
                assert abs(float(g) / float(w) - 1.0) < 1e-4, cv
        assert priced.form_launches[name] - before == 2
        other = priced(consts, boundary, 100.0, False, rows=rows, key=key,
                       with_cv=cv)
        torch.cuda.synchronize()
        for i, (g, b) in enumerate(zip(seeded if cv else (seeded,),
                                       other if cv else (other,))):
            assert abs(float(g) / float(b) - 1.0) < (1e-6 if i else 1e-3)
    del noise


@pytest.mark.gpu
@pytest.mark.parametrize("fgn_form", ["chol", "spectral"])
@pytest.mark.parametrize("n_steps", [96, 365])
def test_quadratic_k2_matches_plain_version(cuda, n_steps, fgn_form):
    """K2/quad and K2/quad/cv, chol and spectral, at the main path's chunk
    of 131072 rows."""
    rows, key = 1 << 17, pc._fold_words(5, 61)
    consts = pc.make_path_consts(*MARKET.values(), n_steps, DT, cuda,
                                 fgn_form=fgn_form)
    tables = _policy_table(consts, pc.pathgen(consts, rows=1 << 14, key=key),
                           n_steps)
    _check_quad_forms(pc.priced_chunk, pc.priced_chunk_from_noise_ref,
                      consts, tables, lambda k, r: pc.normals_ref(
                          consts, k, r, device=cuda), rows, key,
                      fgn_form == "spectral")


@pytest.mark.gpu
@pytest.mark.parametrize("fgn_form", ["chol", "spectral"])
@pytest.mark.parametrize("n_steps", [1825, 300])
def test_quadratic_k7_matches_plain_version(cuda, n_steps, fgn_form):
    """K7/quad and K7/quad/cv, chol and spectral (the slab), at 131072
    rows; 300 steps crosses three step tiles."""
    rows, key = 1 << 17, pc._fold_words(5, 67)
    consts = pc.make_path_consts(*MARKET.values(), n_steps, DT, cuda,
                                 fgn_form=fgn_form)
    tables = _policy_table(
        consts, ptc.tiled_pathgen(consts, rows=1 << 14, key=key), n_steps)
    _check_quad_forms(ptc.tiled_priced_chunk, ptc.priced_chunk_from_noise_ref,
                      consts, tables, lambda k, r: pc.normals_ref(
                          consts, k, r, device=cuda), rows, key,
                      fgn_form == "spectral")


@pytest.mark.gpu
@pytest.mark.parametrize("n_steps,rows", [(1825, 1 << 17), (4000, 1 << 17)])
def test_quadratic_k9_matches_plain_version(cuda, n_steps, rows):
    """K9/quad and K9/quad/cv at 131072 rows (the lanes of a warp test
    their four steps each in order ahead of the ballot)."""
    key = pc._fold_words(5, 71)
    consts = pfc.make_factored_consts(*MARKET.values(), n_steps, DT, cuda)
    tables = _policy_table(
        consts, pfc.factored_pathgen(consts, rows=1 << 13, key=key), n_steps)
    _check_quad_forms(pfc.factored_priced_chunk,
                      pfc.factored_priced_chunk_from_noise_ref, consts,
                      tables, lambda k, r: pfc.philox_factored_normals_ref(
                          k, r, n_steps, device=cuda), rows, key)


@pytest.mark.gpu
@pytest.mark.parametrize("fgn_form", ["chol", "spectral"])
@pytest.mark.parametrize("n_steps,n_strikes", [(365, 21), (512, 23),
                                               (365, 40)])
def test_quadratic_chain_matches_plain_version(cuda, n_steps, n_strikes,
                                               fgn_form):
    """K5/quad, chol and spectral, seeded and noise-in, at 131072 rows,
    against its plain version: 1e-4 of each strike's scale (floored at
    1e-3 of the largest).  40 strikes take two launches of one key."""
    rows, key = 1 << 17, pc._fold_words(5, 73)
    consts = pc.make_path_consts(*MARKET.values(), n_steps, DT, cuda,
                                 fgn_form=fgn_form)
    noise = pc.normals_ref(consts, key, rows, device=cuda)
    pilot = pc.pathgen_from_noise_ref(consts, noise[:, : 1 << 14])
    strip = torch.linspace(80.0, 120.0, n_strikes, device=cuda)
    _, fits = engine.lsm_fit(pilot, MARKET["r"], strip, n_steps * DT, DT,
                             False)
    tables = pc.policy_rows(fits, MARKET["r"], strip, n_steps * DT, DT,
                            n_steps, False).contiguous()
    want = cc.priced_chain_from_noise_ref(consts, tables, noise, False,
                                          policy_form="quadratic")
    name = pc.form_name(False, spectral=fgn_form == "spectral",
                        quadratic=True)
    before = cc.priced_chain.form_launches[name]
    for got in (cc.priced_chain(consts, tables, False, noise=noise,
                                policy_form="quadratic"),
                cc.priced_chain(consts, tables, False, rows=rows, key=key,
                                policy_form="quadratic")):
        torch.cuda.synchronize()
        assert got.shape == (n_strikes,)
        assert _rel(got, want) < 1e-4
    assert cc.priced_chain.form_launches[name] - before == \
        2 * -(-n_strikes // cc.GROUP)


@pytest.mark.gpu
def test_quadratic_engine_on_the_card(cuda):
    """StreamingPricer(policy_form="quadratic") launches K1 and K2/quad
    only (K2/quad/cv under the control variate), its price agreeing with
    its plain versions on the same seed and fits within 1e-4; the strip
    under chain_policy_form="quadratic" launches K1 and K5/quad only; a
    quadratic policy with pairs raises before any launch."""
    counters = (pc.pathgen, pc.priced_chunk, cc.priced_chain)
    for fn in counters:
        fn.form_launches = dict.fromkeys(fn.form_launches, 0)
    n = 96
    for cv in (False, True):
        cfg = engine.StreamConfig(n_paths=4 << 14, n_steps=n,
                                  chunk_paths=1 << 14, pilot_paths=1 << 14,
                                  dt=DT, policy_form="quadratic",
                                  control_variate=cv)
        pricer = engine.StreamingPricer(**MARKET, rho=0.0, strike=100.0,
                                        maturity=n * DT, is_call=False,
                                        config=cfg, device=cuda)
        fits = pricer.fit(engine._pilot_stream_keys(3)[0])
        price = pricer.price_with_fit(fits, 3)
        if not cv:
            table = pricer._make_rows(fits)
            assert table.shape[0] == 8
            _, (run, start) = engine._pilot_stream_keys(3)
            total = sum(float(pc.priced_chunk_from_noise_ref(
                pricer.consts, table, pc.philox_normals_ref(
                    pc._fold_words(run, start + i), 1 << 14, n,
                    device=cuda), 100.0, False,
                policy_form="quadratic")) for i in range(4))
            assert abs(price / (total / (4 << 14)) - 1.0) < 1e-4
    assert pc.priced_chunk.form_launches == dict(
        dict.fromkeys(pc.priced_chunk.form_launches, 0),
        **{"quad": 4, "quad/cv": 4})
    chain = engine.StreamingChainPricer(
        **MARKET, rho=0.0, strikes=[95.0, 105.0], maturity=n * DT,
        is_call=False, device=cuda,
        config=engine.StreamConfig(n_paths=2 << 14, n_steps=n,
                                   chunk_paths=1 << 14, pilot_paths=1 << 14,
                                   dt=DT, chain_policy_form="quadratic"))
    prices = chain.price(3)
    assert all(0.0 < p < 105.0 for p in prices)
    assert cc.priced_chain.form_launches == dict(
        dict.fromkeys(cc.priced_chain.form_launches, 0), quad=2)
    assert pc.pathgen.form_launches["plain"] == 3
    with pytest.raises(ValueError, match="policy_form='quadratic'"):
        engine.StreamingPricer(
            **MARKET, rho=0.0, strike=100.0, maturity=n * DT, is_call=False,
            config=engine.StreamConfig(
                n_paths=2 << 14, n_steps=n, chunk_paths=1 << 14,
                pilot_paths=1 << 14, dt=DT, policy_form="quadratic",
                antithetic=True), device=cuda)


# ---------------------------------------------------------------------------
# The bf16 fGN-input forms of K1/K2 and K6/K7, and the P1 roofline probes.

def _bf16_consts(n_steps, device, **kw):
    return (pc.make_path_consts(*MARKET.values(), n_steps, DT, device,
                                fgn_dtype="bfloat16", **kw),
            pc.make_path_consts(*MARKET.values(), n_steps, DT, device, **kw))


def _check_bf16_family(cuda, family, n_steps, fgn_form="chol"):
    """K1/bf16, K1/bf16/anti (K6 likewise) paths at rtol 2e-4 against the
    bf16 plain version, and 10x closer to it than to the float32 plain
    version (the tensor cores' float32 sums do not round each add, but
    the bf16 rounding of the noise and the factors is what sets the two
    forms apart); the four K2/bf16 forms (K7) at rtol 1e-4; pairs to the
    bit against the unpaired form on [X; -X]; seeded and on noise; each
    launch counted under its form in ``fgn_form``."""
    rows, key = 1 << 17, pc._fold_words(5, 83)
    consts, consts32 = _bf16_consts(n_steps, cuda, fgn_form=fgn_form)
    spectral = fgn_form == "spectral"
    path, priced = {"single": (pc.pathgen, pc.priced_chunk),
                    "tiled": (ptc.tiled_pathgen, ptc.tiled_priced_chunk)}[
        family]
    for anti in (False, True):
        drawn = rows // 2 if anti else rows
        noise = pc.normals_ref(consts, key, drawn, device=cuda)
        want = pc.pathgen_from_noise_ref(consts, noise, anti)
        want32 = pc.pathgen_from_noise_ref(consts32, noise, anti)
        name = pc.form_name(anti, spectral=spectral, bf16=True)
        before = path.form_launches[name]
        for got in (path(consts, noise=noise, antithetic=anti),
                    path(consts, rows=rows, key=key, antithetic=anti)):
            torch.cuda.synchronize()
            err = float(((got - want) / want).abs().max())
            err32 = float(((got - want32) / want32).abs().max())
            assert err < 2e-4 and err * 10 < err32, (err, err32)
        assert path.form_launches[name] - before == 2
        if anti:
            both = torch.cat([noise, -noise], dim=1)
            torch.testing.assert_close(
                path(consts, noise=noise, antithetic=True),
                path(consts, noise=both), rtol=0, atol=0)
    quad, table = _policy_table(consts32, want32[: 1 << 14], n_steps)
    del quad
    for anti in (False, True):
        for cv in (False, True):
            drawn = rows // 2 if anti else rows
            noise = pc.normals_ref(consts, key, drawn, device=cuda)
            ref = pc.priced_chunk_from_noise_ref(consts, table, noise, 100.0,
                                                 False, anti, cv)
            ref = ref if cv else (ref,)
            name = pc.form_name(anti, cv, spectral, bf16=True)
            before = priced.form_launches[name]
            for got in (priced(consts, table, 100.0, False, noise=noise,
                               antithetic=anti, with_cv=cv),
                        priced(consts, table, 100.0, False, rows=rows,
                               key=key, antithetic=anti, with_cv=cv)):
                got = got if cv else (got,)
                torch.cuda.synchronize()
                for g, w in zip(got, ref):
                    assert abs(float(g) / float(w) - 1.0) < 1e-4
            assert priced.form_launches[name] - before == 2


@pytest.mark.gpu
@pytest.mark.parametrize("family,n_steps", [("single", 365), ("single", 47),
                                            ("tiled", 1825),
                                            ("tiled", 300)])
def test_bf16_kernels_match_plain_versions(cuda, family, n_steps):
    """The chol bodies' bf16 forms (``_check_bf16_family``)."""
    _check_bf16_family(cuda, family, n_steps)


@pytest.mark.gpu
@pytest.mark.parametrize("family,n_steps", [("single", 365), ("single", 47),
                                            ("tiled", 1825),
                                            ("tiled", 300)])
def test_bf16_spectral_kernels_match_plain_versions(cuda, family, n_steps):
    """The spectral bodies' bf16 forms (``_check_bf16_family``): both
    bf16 planes zero past a ragged n (47, 365), the dense product over
    every k < n."""
    _check_bf16_family(cuda, family, n_steps, "spectral")


@pytest.mark.gpu
@pytest.mark.parametrize("n_steps", [1825, 4000])
def test_bf16_factored_matches_plain_versions(cuda, n_steps):
    """K8/bf16 and K8/bf16/anti paths at rtol 5e-4 (K8's float32
    tolerance) against the bf16 plain version (the four-step split), and
    10x closer to it than to the float32 plain version (the FFT); the pair
    to the bit against the unpaired form on [X; -X]; the six K9/bf16
    forms at rtol 1e-4; seeded and on noise, each launch counted under its
    form."""
    rows, key = 1 << 17, pc._fold_words(5, 89)
    consts = pfc.make_factored_consts(*MARKET.values(), n_steps, DT, cuda,
                                      fgn_dtype="bfloat16")
    consts32 = pfc.make_factored_consts(*MARKET.values(), n_steps, DT, cuda)
    path, priced = pfc.factored_pathgen, pfc.factored_priced_chunk
    for anti in (False, True):
        drawn = rows // 2 if anti else rows
        noise = pfc.philox_factored_normals_ref(key, drawn, n_steps,
                                                device=cuda)
        want = pfc.factored_pathgen_from_noise_ref(consts, noise, anti)
        want32 = pfc.factored_pathgen_from_noise_ref(consts32, noise, anti)
        name = pc.form_name(anti, bf16=True)
        before = path.form_launches[name]
        for got in (path(consts, noise=noise, antithetic=anti),
                    path(consts, rows=rows, key=key, antithetic=anti)):
            torch.cuda.synchronize()
            err = float(((got - want) / want).abs().max())
            err32 = float(((got - want32) / want32).abs().max())
            assert err < 5e-4 and err * 10 < err32, (err, err32)
        assert path.form_launches[name] - before == 2
        if anti:
            torch.testing.assert_close(
                path(consts, noise=noise, antithetic=True),
                path(consts, noise=torch.cat([noise, -noise], dim=1)),
                rtol=0, atol=0)
        del noise, want, want32
    quad, table = _policy_table(
        consts, path(consts32, rows=1 << 13, key=key), n_steps)
    del quad
    for anti in (False, True):
        for cv in (False, True):
            drawn = rows // 2 if anti else rows
            noise = pfc.philox_factored_normals_ref(key, drawn, n_steps,
                                                    device=cuda)
            ref = pfc.factored_priced_chunk_from_noise_ref(
                consts, table, noise, 100.0, False, anti, cv)
            ref = ref if cv else (ref,)
            name = pc.form_name(anti, cv, bf16=True)
            before = priced.form_launches[name]
            for got in (priced(consts, table, 100.0, False, noise=noise,
                               antithetic=anti, with_cv=cv),
                        priced(consts, table, 100.0, False, rows=rows,
                               key=key, antithetic=anti, with_cv=cv)):
                got = got if cv else (got,)
                torch.cuda.synchronize()
                for g, w in zip(got, ref):
                    assert abs(float(g) / float(w) - 1.0) < 1e-4
            assert priced.form_launches[name] - before == 2
    tables = _policy_table(
        consts, path(consts32, rows=1 << 13, key=key), n_steps)
    _check_quad_forms(priced, pfc.factored_priced_chunk_from_noise_ref,
                      consts, tables,
                      lambda k, r: pfc.philox_factored_normals_ref(
                          k, r, n_steps, device=cuda), rows, key, bf16=True)


@pytest.mark.gpu
@pytest.mark.parametrize("fgn_form", ["chol", "spectral"])
@pytest.mark.parametrize("family,n_steps", [("single", 365), ("single", 96),
                                            ("tiled", 1825),
                                            ("tiled", 300)])
def test_bf16_quadratic_matches_plain_versions(cuda, family, n_steps,
                                               fgn_form):
    """K2/bf16/quad[/cv] and K7/bf16/quad[/cv], chol and spectral, at
    131072 rows (``_check_quad_forms``)."""
    rows, key = 1 << 17, pc._fold_words(5, 97)
    consts, consts32 = _bf16_consts(n_steps, cuda, fgn_form=fgn_form)
    path, priced, ref = {
        "single": (pc.pathgen, pc.priced_chunk,
                   pc.priced_chunk_from_noise_ref),
        "tiled": (ptc.tiled_pathgen, ptc.tiled_priced_chunk,
                  ptc.priced_chunk_from_noise_ref)}[family]
    tables = _policy_table(consts, path(consts32, rows=1 << 14, key=key),
                           n_steps)
    _check_quad_forms(priced, ref, consts, tables, lambda k, r: pc.normals_ref(
        consts, k, r, device=cuda), rows, key, fgn_form == "spectral",
        bf16=True)


@pytest.mark.gpu
@pytest.mark.parametrize("fgn_form", ["chol", "spectral"])
@pytest.mark.parametrize("n_steps,n_strikes", [(365, 21), (512, 23),
                                               (365, 40), (47, 23)])
def test_bf16_chain_matches_plain_versions(cuda, n_steps, n_strikes,
                                           fgn_form):
    """K5/bf16 in its six forms (plain, paired and quadratic, chol and
    spectral) at 131072 rows, seeded and noise-in, against the bf16 plain
    version: 1e-4 of each strike's scale (floored at 1e-3 of the largest)
    and 10x closer to it than to the float32 plain version on the same
    noise; the pair against unpaired K5/bf16 on [X; -X] (1e-5).  40
    strikes take two launches of one key; 47 steps leave a ragged last
    k16 step (so does 365).  Each launch counts under its "bf16/..."
    key."""
    rows, key = 1 << 17, pc._fold_words(5, 101)
    consts, consts32 = _bf16_consts(n_steps, cuda, fgn_form=fgn_form)
    spectral = fgn_form == "spectral"
    strip = torch.linspace(80.0, 120.0, n_strikes, device=cuda)
    pilot = pc.pathgen_from_noise_ref(consts32, pc.normals_ref(
        consts32, key, 1 << 14, device=cuda, row0=rows))
    _, fits = engine.lsm_fit(pilot, MARKET["r"], strip, n_steps * DT, DT,
                             False)
    launches = 2 * -(-n_strikes // cc.GROUP)
    for anti, quad in ((False, False), (True, False), (False, True)):
        rows_fn = pc.policy_rows if quad else pc.boundary_rows
        tables = rows_fn(fits, MARKET["r"], strip, n_steps * DT, DT,
                         n_steps, False).contiguous()
        policy = "quadratic" if quad else "boundary"
        noise = pc.normals_ref(consts, key, rows // 2 if anti else rows,
                               device=cuda)
        want = cc.priced_chain_from_noise_ref(consts, tables, noise, False,
                                              anti, policy)
        want32 = cc.priced_chain_from_noise_ref(consts32, tables, noise,
                                                False, anti, policy)
        name = pc.form_name(anti, spectral=spectral, quadratic=quad,
                            bf16=True)
        before = cc.priced_chain.form_launches[name]
        for got in (cc.priced_chain(consts, tables, False, noise=noise,
                                    antithetic=anti, policy_form=policy),
                    cc.priced_chain(consts, tables, False, rows=rows,
                                    key=key, antithetic=anti,
                                    policy_form=policy)):
            torch.cuda.synchronize()
            assert got.shape == (n_strikes,)
            err, err32 = _rel(got, want), _rel(got, want32)
            assert err < 1e-4 and err * 10 < err32, (name, err, err32)
        assert cc.priced_chain.form_launches[name] - before == launches
        if anti:
            unpaired = cc.priced_chain(consts, tables, False,
                                       noise=torch.cat([noise, -noise], 1))
            paired = cc.priced_chain(consts, tables, False, noise=noise,
                                     antithetic=True)
            torch.cuda.synchronize()
            assert _rel(paired, unpaired) < 1e-5
        del noise


@pytest.mark.gpu
@pytest.mark.parametrize("n_steps,n_strikes", [(365, 21), (96, 23),
                                               (365, 40), (47, 23)])
def test_bf16_greeks_match_plain_versions(cuda, n_steps, n_strikes):
    """K3/bf16, K4/bf16 and their pair forms at 131072 rows, seeded and
    noise-in, against the bf16 plain version: 2e-4 of each output's scale;
    K4's columns equal K3's per strike (the same body, 1e-6 of each
    output's largest); the pairs against the unpaired forms on [X; -X]
    (1e-5).  Each launch counts under "bf16" or "bf16/anti"."""
    rows, key = 1 << 17, pc._fold_words(5, 103)
    consts, consts32 = _bf16_consts(n_steps, cuda)
    g = pc.make_greeks_consts(MARKET["xi"], MARKET["h"], MARKET["eta"],
                              n_steps, DT, cuda, fgn_dtype="bfloat16")
    strikes = torch.linspace(85.0, 115.0, n_strikes).tolist()
    _, logs = _strip_tables(cuda, consts32, pc.philox_normals_ref(
        key, 1 << 14, n_steps, device=cuda, row0=rows), strikes)
    for anti in (False, True):
        noise = pc.philox_normals_ref(key, rows // 2 if anti else rows,
                                      n_steps, device=cuda)
        want = gc.greeks_from_noise_ref(consts, g, logs,
                                        torch.tensor(strikes, device=cuda),
                                        noise, False, anti)
        name = pc.form_name(anti, bf16=True)
        before = (gc.greeks_chunk.form_launches[name],
                  gc.chain_greeks_chunk.form_launches[name])
        for kw in ({"noise": noise}, {"rows": rows, "key": key}):
            got = gc.chain_greeks_chunk(consts, g, logs, False,
                                        antithetic=anti, **kw)
            torch.cuda.synchronize()
            assert got.shape == (6, n_strikes)
            assert _rel(got, want) < 2e-4, name
            for j in (0, n_strikes // 2, n_strikes - 1):
                one = gc.greeks_chunk(consts, g, logs[j], strikes[j], False,
                                      antithetic=anti, **kw)
                torch.cuda.synchronize()
                scale = got.abs().amax(dim=1)
                assert bool(((one - got[:, j]).abs() <= 1e-6 * scale).all())
        assert (gc.greeks_chunk.form_launches[name] - before[0],
                gc.chain_greeks_chunk.form_launches[name] - before[1]) == (
            6, 2 * -(-n_strikes // gc.GROUP))
        if anti:
            doubled = torch.cat([noise, -noise], dim=1)
            unpaired = gc.chain_greeks_chunk(consts, g, logs, False,
                                             noise=doubled)
            paired = gc.chain_greeks_chunk(consts, g, logs, False,
                                           noise=noise, antithetic=True)
            torch.cuda.synchronize()
            assert _rel(paired, unpaired) < 1e-5
        del noise


@pytest.mark.gpu
def test_bf16_wrappers_refuse_other_constants(cuda):
    """A bf16 PathConsts whose factor (or spectral matrix) is float32, or
    the reverse, and a bf16 FactoredConsts with a float32 F1, raise before
    any launch; so do K5 on such mixed constants and K3/K4 on Greeks
    constants of the other dtype than the path constants'; and a C entry
    given the other dtype's flag (K5, K3, K4, K8 included), or (K1/K2,
    K6/K7, whose seeded and noise-in bodies build apart) the other noise
    source, returns cudaErrorInvalidValue (1) without running another
    body."""
    from montecarlooptionspricer_tpu_torch.kernels import build

    consts, consts32 = _bf16_consts(96, cuda)
    bad = dataclasses.replace(consts, lt_half=consts32.lt_half)
    with pytest.raises(ValueError, match="bfloat16"):
        pc.pathgen(bad, rows=64, key=1)
    bad = dataclasses.replace(consts32, lt_half=consts.lt_half)
    with pytest.raises(ValueError, match="float32"):
        ptc.tiled_pathgen(bad, rows=64, key=1)
    spec, spec32 = _bf16_consts(96, cuda, fgn_form="spectral")
    bad = dataclasses.replace(spec, ci_half=spec32.ci_half)
    with pytest.raises(ValueError, match="bfloat16"):
        pc.priced_chunk(bad, torch.zeros((8, 96), device=cuda), 100.0,
                        False, rows=64, key=1, policy_form="quadratic")
    fac = pfc.make_factored_consts(*MARKET.values(), 400, DT, cuda,
                                   fgn_dtype="bfloat16")
    fac32 = pfc.make_factored_consts(*MARKET.values(), 400, DT, cuda)
    bad = dataclasses.replace(fac, f1r=fac32.f1r, f1i=fac32.f1i)
    with pytest.raises(ValueError, match="bfloat16"):
        pfc.factored_pathgen(bad, rows=64, key=1)
    tables = torch.zeros((2, 8, 96), device=cuda)
    for c, c_other, match in ((consts, consts32, "bfloat16"),
                              (consts32, consts, "float32")):
        bad = dataclasses.replace(c, lt_half=c_other.lt_half)
        with pytest.raises(ValueError, match=match):
            cc.priced_chain(bad, tables, False, rows=64, key=1)
    bad = dataclasses.replace(spec, ci_half=spec32.ci_half)
    with pytest.raises(ValueError, match="bfloat16"):
        cc.priced_chain(bad, tables, False, rows=64, key=1)
    g32 = pc.make_greeks_consts(MARKET["xi"], MARKET["h"], MARKET["eta"], 96,
                                DT, cuda)
    g = pc.make_greeks_consts(MARKET["xi"], MARKET["h"], MARKET["eta"], 96,
                              DT, cuda, fgn_dtype="bfloat16")
    for c, gg in ((consts, g32), (consts32, g)):
        with pytest.raises(ValueError, match="gconsts"):
            gc.greeks_chunk(c, gg, tables[0], 100.0, False, rows=64, key=1)
        with pytest.raises(ValueError, match="gconsts"):
            gc.chain_greeks_chunk(c, gg, tables, False, rows=64, key=1)
    bad = dataclasses.replace(g, dlt_half=g32.dlt_half)
    with pytest.raises(ValueError, match="dlt_half"):
        gc.greeks_chunk(consts, bad, tables[0], 100.0, False, rows=64, key=1)
    lib = build.load()
    stream = torch.cuda.current_stream(cuda).cuda_stream
    partial = torch.empty((64, 2, 6), device=cuda)
    for c, bf16 in ((consts32, 1), (consts, 0)):
        err = build.entry(lib, "chain", "mcop_priced_chain", not bf16)(
            None, *c.factor_ptrs(), c.vd.data_ptr(), 64, 96, 64, 1,
            *pc._scalars(c), tables.data_ptr(), tables.stride(0),
            tables.stride(1), 2, 0, 0, 0, bf16, partial.data_ptr(), stream)
        assert err == 1
        gg = g32 if c is consts32 else g
        err = build.entry(lib, "greeks", "mcop_chain_greeks_chunk",
                          not bf16)(
            None, c.lt_half.data_ptr(), gg.dlt_half.data_ptr(),
            c.vd.data_ptr(), gg.de.data_ptr(), gg.dh.data_ptr(), 64, 96, 32,
            1, *pc._scalars(c), ctypes.c_float(1.0 / gg.eta),
            tables.data_ptr(), tables.stride(0), tables.stride(1), 2, 0, 0,
            bf16, partial.data_ptr(), stream)
        assert err == 1
    out = torch.empty((64, 401), device=cuda)
    for c, bf16 in ((fac32, 1), (fac, 0)):
        err = build.entry(lib, "pathgen_factored", "mcop_factored_pathgen",
                          not bf16)(
            *pfc._const_ptrs(c, 64, None), 1, *pc._scalars(c),
            ctypes.c_float(c.s0), 0, bf16, out.data_ptr(),
            torch.cuda.current_stream(cuda).cuda_stream)
        assert err == 1
    out = torch.empty((64, 97), device=cuda)
    for seeded in (False, True):
        args = pc._kernel_args(consts32, 64, 1, None)
        # The seeded call (noise null) to the noise-in unit, and a call
        # with noise to the seeded unit.
        if seeded:
            args = (torch.zeros((2, 64, 96), device=cuda).data_ptr(),
                    *args[1:])
        err = build.entry(lib, "pathgen", "mcop_pathgen", False, seeded)(
            *args, *pc._scalars(consts32), ctypes.c_float(consts32.s0), 0, 0,
            out.data_ptr(), torch.cuda.current_stream(cuda).cuda_stream)
        assert err == 1


@pytest.mark.gpu
def test_bf16_memory_models_are_the_cards(cuda):
    """The bf16 units' shared-memory entries equal the Python models of
    K1/K2, K6/K7, K5 and K3/K4 under bf16 in every form, and K8/K9's is
    the float32 form's at every horizon."""
    from montecarlooptionspricer_tpu_torch.kernels import build

    lib = build.load()
    for n in (47, 96, 365):
        for anti, choices in ((0, pc.BLOCK_CHOICES),
                              (1, pc.PAIRED_BLOCK_CHOICES)):
            for bp in choices:
                for spec in (0, 1):   # K1's and K2's layout
                    assert lib.mcop_priced_smem_bytes_bf16(
                        n, bp, anti, spec) == pc.priced_smem_bytes(
                        n, bp, bool(anti), bool(spec), bf16=True)
    for anti, choices in ((0, ptc.BLOCK_CHOICES),
                          (1, ptc.PAIRED_BLOCK_CHOICES)):
        for bp in choices:
            for cv in (0, 1):
                for spec in (0, 1):
                    assert lib.mcop_tiled_smem_bytes_bf16(
                        bp, anti, cv, spec) == ptc.smem_bytes(
                        bp, bool(anti), bool(cv), bool(spec), bf16=True)
    for n in (129, 1825, 4000, 8192):
        assert lib.mcop_factored_smem_bytes_bf16(n) == pfc.smem_bytes(n)
    for n in (47, 96, 365, 512):
        for anti, choices in ((0, pc.BLOCK_CHOICES),
                              (1, pc.PAIRED_BLOCK_CHOICES)):
            for bp in choices:
                for spec in (0, 1):
                    assert lib.mcop_chain_smem_bytes_bf16(
                        n, bp, anti, spec, 0, cc.GROUP) == cc.smem_bytes(
                        n, bp, bool(anti), bool(spec), bf16=True)
                assert lib.mcop_greeks_smem_bytes_bf16(
                    n, bp, anti, gc.GROUP) == gc.smem_bytes(
                    n, bp, bool(anti), bf16=True)
    assert lib.mcop_chain_group_bf16() == cc.GROUP
    assert lib.mcop_greeks_group_bf16() == gc.GROUP


@pytest.mark.gpu
def test_bf16_engine_on_the_card(cuda):
    """StreamConfig(fgn_matmul_dtype="bfloat16") prices through K1/bf16 and
    K2/bf16 at 96 steps and K6/bf16 and K7/bf16 at 400, launching no other
    form, each within 1e-4 of its plain versions on the same fits."""
    for n, family, path, priced in (
            (96, "single", pc.pathgen, pc.priced_chunk),
            (400, "tiled", ptc.tiled_pathgen, ptc.tiled_priced_chunk)):
        for fn in (path, priced):
            fn.form_launches = dict.fromkeys(fn.form_launches, 0)
        cfg = engine.StreamConfig(n_paths=2 << 14, n_steps=n,
                                  chunk_paths=1 << 14, pilot_paths=1 << 14,
                                  dt=DT, fgn_matmul_dtype="bfloat16")
        pricer = engine.StreamingPricer(**MARKET, rho=0.0, strike=100.0,
                                        maturity=n * DT, is_call=False,
                                        config=cfg, device=cuda)
        assert pricer.kernel_family == family
        fits = pricer.fit(engine._pilot_stream_keys(3)[0])
        price = pricer.price_with_fit(fits, 3)
        assert path.form_launches == dict(
            dict.fromkeys(path.form_launches, 0), bf16=1)
        assert priced.form_launches == dict(
            dict.fromkeys(priced.form_launches, 0), bf16=2)
        table = pricer._make_rows(fits)
        _, (run, start) = engine._pilot_stream_keys(3)
        total = sum(float(pc.priced_chunk_from_noise_ref(
            pricer.consts, table, pc.philox_normals_ref(
                pc._fold_words(run, start + i), 1 << 14, n, device=cuda),
            100.0, False)) for i in range(2))
        assert abs(price / (total / (2 << 14)) - 1.0) < 1e-4


@pytest.mark.gpu
def test_bf16_strip_and_greeks_engine_on_the_card(cuda):
    """Under StreamConfig(fgn_matmul_dtype="bfloat16") a strip prices on
    K1/bf16 and K5/bf16 at 96 steps (K6/bf16 and K5/bf16 at 400,
    K8/bf16 and K5/bf16/spectral at 400 spectral), and the Greeks stream
    K3/bf16 and K4/bf16 (K3/bf16/anti, K4/bf16/anti paired), launching no
    other form; the strip within 1e-4 of its plain versions on the same
    fits, the Greeks' price lanes within 1e-4 of the strip's."""
    strikes = [95.0, 100.0, 105.0]
    counted = (pc.pathgen, ptc.tiled_pathgen, pfc.factored_pathgen,
               cc.priced_chain, gc.greeks_chunk, gc.chain_greeks_chunk)

    def reset():
        for fn in counted:
            fn.form_launches = dict.fromkeys(fn.form_launches, 0)

    def launched():
        return {(fn.__name__, k): v for fn in counted
                for k, v in fn.form_launches.items() if v}

    for n, kw, path, k5 in (
            (96, {}, "pathgen", "bf16"),
            (400, {}, "tiled_pathgen", "bf16"),
            (400, {"fgn_form": "spectral"}, "factored_pathgen",
             "bf16/spectral")):
        cfg = engine.StreamConfig(n_paths=2 << 14, n_steps=n,
                                  chunk_paths=1 << 14, pilot_paths=1 << 14,
                                  dt=DT, fgn_matmul_dtype="bfloat16", **kw)
        chain = engine.StreamingChainPricer(**MARKET, rho=0.0,
                                            strikes=strikes, maturity=n * DT,
                                            is_call=False, config=cfg,
                                            device=cuda)
        assert chain.chain_consts.bf16
        reset()
        fits = chain.fit(engine._pilot_stream_keys(3)[0])
        prices = chain.price_with_fit(fits, 3)
        assert launched() == {(path, "bf16"): 1, ("priced_chain", k5): 2}
        tables = chain._tables(fits, chain.strikes)
        _, (run, start) = engine._pilot_stream_keys(3)
        total = sum(cc.priced_chain_from_noise_ref(
            chain.chain_consts, tables, pc.normals_ref(
                chain.chain_consts, pc._fold_words(run, start + i), 1 << 14,
                device=cuda), False).double() for i in range(2))
        want = (total / (2 << 14)).cpu().numpy()
        assert float(abs(prices / want - 1.0).max()) < 1e-4
    for anti in (False, True):
        cfg = engine.StreamConfig(n_paths=2 << 14, n_steps=96,
                                  chunk_paths=1 << 14, pilot_paths=1 << 14,
                                  dt=DT, fgn_matmul_dtype="bfloat16",
                                  antithetic=anti)
        chain = engine.StreamingChainPricer(**MARKET, rho=0.0,
                                            strikes=strikes,
                                            maturity=96 * DT, is_call=False,
                                            config=cfg, device=cuda)
        one = engine.StreamingPricer(**MARKET, rho=0.0, strike=100.0,
                                     maturity=96 * DT, is_call=False,
                                     config=cfg, device=cuda)
        name = pc.form_name(anti, bf16=True)
        reset()
        greeks = one.price_and_greeks(3)
        strip = chain.price_and_greeks(3)
        assert launched() == {("pathgen", "bf16"): 2,
                              ("greeks_chunk", name): 2,
                              ("chain_greeks_chunk", name): 2}
        prices = chain.price(3)
        assert float(abs(strip[0] / prices - 1.0).max()) < 1e-4
        assert abs(greeks[0] / prices[1] - 1.0) < 1e-4
        assert abs(strip[1, 1] / greeks[1] - 1.0) < 1e-5


@pytest.mark.gpu
def test_roofline_probes_match_plain_versions(cuda):
    """P1/normals in its four variants against its plain version: the
    column sums of 1024 normals a plane pair, to 4e-5 a normal (float32
    sums in another order; expf, logf, sinf, cosf of the card and of
    PyTorch differ by an ulp), where a wrong counter moves a sum by ~30;
    P1/matmul in float32 and bf16 on the identity and a random
    orthogonal B against its plain version after 3 steps, float32 to 1e-5
    and bf16 to 2e-3 of the largest column sum (a value on a rounding tie
    of the tensor cores' sums may round to the other bf16 neighbour)."""
    from montecarlooptionspricer_tpu_torch import roofline as rl

    key = 11
    for unroll, with_exp, fma in ((1, False, 0), (3, False, 0),
                                  (1, True, 0), (1, False, rl.FMA_CHAIN)):
        got = rl.normals(key, 3, 2, unroll, with_exp, fma, device=cuda)
        want = rl.normals_ref(key, 3, 2, unroll, with_exp, fma, device=cuda)
        torch.cuda.synchronize()
        assert got.shape == (3, 512)
        assert float((got - want).abs().max()) < 4e-5 * 1024 * unroll
    for b in (torch.eye(384, device=cuda), rl.orthogonal(384).to(cuda)):
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-3)):
            bb = b.to(dtype).contiguous()
            got = rl.matmul(key, bb, 2, 3)
            want = rl.matmul_ref(key, bb, 2, 3)
            torch.cuda.synchronize()
            assert got.shape == (2, 384)
            assert float((got - want).abs().max()) <= \
                tol * float(want.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("s_pad", [128, 512])
def test_roofline_matmul_long_chain(cuda, s_pad):
    """P1/matmul through 30 dependent steps (k 10, unroll 3) on a random
    orthogonal B, one and four column tiles, against its plain version,
    to ``roofline.chain_atol``: float32 within the random walk of two
    summation orders, bf16 within that of two independent roundings."""
    from montecarlooptionspricer_tpu_torch import roofline as rl

    key, grid, k, unroll = 5, 3, 10, 3
    b = rl.orthogonal(s_pad, seed=1).to(cuda)
    for dtype in (torch.float32, torch.bfloat16):
        bb = b.to(dtype).contiguous()
        got = rl.matmul(key, bb, grid, k, unroll)
        want = rl.matmul_ref(key, bb, grid, k, unroll)
        torch.cuda.synchronize()
        assert got.shape == (grid, s_pad)
        assert float((got - want).abs().max()) <= rl.chain_atol(
            dtype == torch.bfloat16, k * unroll, float(want.abs().max()))


# ---------------------------------------------------------------------------
# The strike sweep's edges (K5, K3/K4): synthetic tables that force each
# strike's first hit to a chosen column of the 365-step horizon.

# The columns the strikes cycle through: the first, the last of the first
# tile and the first of the second (the tile edge), the last step, never
# (the [1e30, -1e30] sentinels), then several in one tile and two in later
# tiles.
_EDGE_COLUMNS = (0, 63, 64, 364, None, 5, 17, 40, 130, 200)


def _edge_bounds(values, n_strikes):
    """Lower and upper rows [K, n] of ``n_strikes`` synthetic strikes on the
    paths' ``values`` [rows, n] (S, log S or the payoff): strike j cannot
    hit before column c_j of _EDGE_COLUMNS, hits at c_j where its value is
    at least a quantile (10 % to 90 % over the strikes) and at every later
    column, so each path stops at c_j or c_j + 1 (or never, at the last
    step); the "never" strike keeps the sentinels throughout."""
    n = values.shape[1]
    lo = torch.full((n_strikes, n), 1e30, device=values.device)
    hi = torch.full((n_strikes, n), -1e30, device=values.device)
    for j in range(n_strikes):
        c = _EDGE_COLUMNS[j % len(_EDGE_COLUMNS)]
        if c is None:
            continue
        lo[j, c] = torch.quantile(values[:, c],
                                  0.1 + 0.8 * j / max(n_strikes - 1, 1))
        lo[j, c + 1:] = -1e30
        hi[j, c:] = 1e30
    return lo, hi


@pytest.mark.gpu
@pytest.mark.parametrize("n_strikes", [1, 31, 32, 33])
@pytest.mark.parametrize("form", ["plain", "anti", "quad"])
@pytest.mark.parametrize("fgn_dtype", ["float32", "bfloat16"])
def test_chain_sweep_edges(cuda, fgn_dtype, form, n_strikes):
    """K5 (boundary plain and paired, quadratic) on synthetic tables whose
    first hits fall at column 0, at the tile edge (63, 64), at the last
    step, never, and at several strikes in one tile, at 131072 rows and
    365 steps: seeded and noise-in against the plain version (1e-4 of each
    strike's scale), two seeded launches bit for bit, and the pair against
    the unpaired form on [X; -X] (1e-5).  33 strikes take two launches of
    one key.  The quadratic tables hold cont at the payoff's quantile (c0,
    with c1 = c2 = mu = 0, sd = 1, eps = -1)."""
    n, rows, key, strike = 365, 1 << 17, pc._fold_words(5, 107), 105.0
    anti, quad = form == "anti", form == "quad"
    policy = "quadratic" if quad else "boundary"
    consts = pc.make_path_consts(*MARKET.values(), n, DT, cuda,
                                 fgn_dtype=fgn_dtype)
    noise = pc.philox_normals_ref(key, rows // 2 if anti else rows, n,
                                  device=cuda)
    s = torch.exp(pc._log_paths_ref(consts, noise, anti))
    disc = torch.exp(-MARKET["r"] * DT * torch.arange(1, n + 1,
                                                      device=cuda))
    if quad:
        lo, _ = _edge_bounds(torch.clamp(strike - s, min=0.0), n_strikes)
        tables = torch.zeros((n_strikes, 8, n), device=cuda)
        tables[:, 0] = lo
        tables[:, 4] = 1.0
        tables[:, 5] = -1.0
        tables[:, 6] = disc
        tables[:, 7] = strike
    else:
        lo, hi = _edge_bounds(s, n_strikes)
        tables = torch.stack([lo, hi, (strike * disc).expand_as(lo),
                              disc.expand_as(lo)], dim=1).contiguous()
    del s
    want = cc.priced_chain_from_noise_ref(consts, tables, noise, False, anti,
                                          policy)
    got_n, got_s, again = (
        cc.priced_chain(consts, tables, False, antithetic=anti,
                        policy_form=policy, **kw)
        for kw in ({"noise": noise}, {"rows": rows, "key": key},
                   {"rows": rows, "key": key}))
    torch.cuda.synchronize()
    assert float(want.abs().max()) > 0
    assert _rel(got_n, want) < 1e-4 and _rel(got_s, want) < 1e-4
    assert torch.equal(got_s, again)
    if anti:
        unpaired = cc.priced_chain(consts, tables, False,
                                   noise=torch.cat([noise, -noise], dim=1))
        torch.cuda.synchronize()
        assert _rel(got_n, unpaired) < 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("n_strikes", [1, 31, 32, 33])
@pytest.mark.parametrize("anti", [False, True])
@pytest.mark.parametrize("fgn_dtype", ["float32", "bfloat16"])
def test_greeks_sweep_edges(cuda, fgn_dtype, anti, n_strikes):
    """K4 and K3 (plain and paired) on synthetic log tables whose first
    hits fall at column 0, at the tile edge, at the last step, never, and
    at several strikes in one tile, at 131072 rows and 365 steps: K4
    seeded and noise-in against the plain version (2e-4 of each output's
    scale), two seeded launches bit for bit, K3 on the first and last
    strike against it likewise, and the pair against the unpaired form on
    [X; -X] (1e-5).  33 strikes take two launches of one key."""
    n, rows, key = 365, 1 << 17, pc._fold_words(5, 109)
    consts = pc.make_path_consts(*MARKET.values(), n, DT, cuda,
                                 fgn_dtype=fgn_dtype)
    g = pc.make_greeks_consts(MARKET["xi"], MARKET["h"], MARKET["eta"], n,
                              DT, cuda, fgn_dtype=fgn_dtype)
    noise = pc.philox_normals_ref(key, rows // 2 if anti else rows, n,
                                  device=cuda)
    lo, hi = _edge_bounds(pc._log_paths_ref(consts, noise, anti), n_strikes)
    strikes = torch.linspace(95.0, 115.0, n_strikes, device=cuda)
    disc = torch.exp(-MARKET["r"] * DT * torch.arange(1, n + 1,
                                                      device=cuda))
    logs = torch.stack([lo, hi, disc.expand_as(lo),
                        strikes[:, None].expand_as(lo)], dim=1).contiguous()
    want = gc.greeks_from_noise_ref(consts, g, logs, strikes, noise, False,
                                    anti)
    got_n, got_s, again = (
        gc.chain_greeks_chunk(consts, g, logs, False, antithetic=anti, **kw)
        for kw in ({"noise": noise}, {"rows": rows, "key": key},
                   {"rows": rows, "key": key}))
    ones = [gc.greeks_chunk(consts, g, logs[j], float(strikes[j]), False,
                            rows=rows, key=key, antithetic=anti)
            for j in (0, n_strikes - 1)]
    torch.cuda.synchronize()
    assert got_s.shape == (6, n_strikes)
    assert _rel(got_n, want) < 2e-4 and _rel(got_s, want) < 2e-4
    assert torch.equal(got_s, again)
    for one, j in zip(ones, (0, n_strikes - 1)):
        assert _rel(one[:, None], want[:, j:j + 1]) < 2e-4
    if anti:
        unpaired = gc.chain_greeks_chunk(
            consts, g, logs, False, noise=torch.cat([noise, -noise], dim=1))
        torch.cuda.synchronize()
        assert _rel(got_n, unpaired) < 1e-5


# ---------------------------------------------------------------------------
# K2's redesign: every form at the horizons round the tile edges, tables
# that force its first hits to chosen columns, the quadratic policy where
# the boundary would decide otherwise, its memory model and blocks, and K2
# against K5 at one strike.

# K2's 24 forms: (fgn_dtype, fgn_form, antithetic, cv, policy_form).
K2_FORMS = [(d, f, a, cv, p) for d in ("float32", "bfloat16")
            for f in ("chol", "spectral")
            for a, cv, p in ((False, False, "boundary"),
                             (True, False, "boundary"),
                             (False, True, "boundary"),
                             (True, True, "boundary"),
                             (False, False, "quadratic"),
                             (False, True, "quadratic"))]


def _k2_edge_columns(n):
    """The columns whose exercise set is open: the last of the first tile
    and the first of the second (63, 64, where they exist) and the last
    step; before and between them none is."""
    return sorted({c for c in (63, 64, n - 1) if c < n})


def _k2_edge_tables(ls, first_tile=False, cols=None):
    """A log_boundary_rows table and a policy_rows table on the log paths
    ``ls`` [rows, n] (a put at 105): each open column stops about a third of
    the paths still running (the bottom third of log S, or the top third
    of the payoff less 0.5 z, z = (S - mu) / sd with mu and sd the
    column's mean and standard deviation), every other column none, so
    paths stop at 63, 64 or n - 1 or never.  ``first_tile``: every path
    stops at column min(5, n - 1).  ``cols`` names other open columns."""
    n, dev = ls.shape[1], ls.device
    disc = torch.exp(-MARKET["r"] * DT * torch.arange(1, n + 1, device=dev))
    log_t = torch.zeros((8, n), device=dev)
    log_t[0], log_t[1], log_t[2] = 1e30, -1e30, disc
    quad = torch.zeros((8, n), device=dev)
    quad[3], quad[4], quad[5], quad[6], quad[7] = 0.0, 1.0, 1e30, disc, 105.0
    quad[1] = 0.5
    s = torch.exp(ls)
    if cols is None:
        cols = [min(5, n - 1)] if first_tile else _k2_edge_columns(n)
    for c in cols:
        if first_tile:
            log_t[0, c], log_t[1, c] = -1e30, 1e30
            quad[0, c], quad[1, c], quad[5, c] = -1e30, 0.0, -1.0
            continue
        log_t[0, c] = -1e30
        log_t[1, c] = torch.quantile(ls[:, c], 1 / 3)
        mu, sd = s[:, c].mean(), s[:, c].std()
        z = (s[:, c] - mu) / sd
        pay = torch.clamp_min(105.0 - s[:, c], 0.0)
        quad[0, c] = torch.quantile(pay - 0.5 * z, 2 / 3)
        quad[3, c], quad[4, c], quad[5, c] = mu, sd, -1.0
    return log_t.contiguous(), quad.contiguous()


def _check_k2_form(cuda, consts, table, noise, key, anti, cv, policy,
                   rows, priced=pc.priced_chunk):
    """One K2 form (K7's, ``priced`` its wrapper), seeded and noise-in,
    against its plain version (each lane at rtol 1e-4), two seeded
    launches bit for bit, and paired against the unpaired form on [X; -X]
    (1e-5)."""
    want = pc.priced_chunk_from_noise_ref(consts, table, noise, 105.0, False,
                                          anti, cv, policy)
    want = want if cv else (want,)
    form = dict(antithetic=anti, with_cv=cv, policy_form=policy)
    got_n, got_s, again = (
        priced(consts, table, 105.0, False, **form, **kw)
        for kw in ({"noise": noise}, {"rows": rows, "key": key},
                   {"rows": rows, "key": key}))
    torch.cuda.synchronize()
    for got in (got_n, got_s):
        for g, w in zip(got if cv else (got,), want):
            assert float(w) > 0
            assert abs(float(g) / float(w) - 1.0) < 1e-4, form
    for g, w in zip(got_s if cv else (got_s,), again if cv else (again,)):
        assert torch.equal(g, w)
    if anti:
        unpaired = priced(consts, table, 105.0, False,
                          noise=torch.cat([noise, -noise], dim=1),
                          with_cv=cv)
        torch.cuda.synchronize()
        for g, w in zip(got_n if cv else (got_n,),
                        unpaired if cv else (unpaired,)):
            assert abs(float(g) / float(w) - 1.0) < 1e-5, form


@pytest.mark.gpu
@pytest.mark.parametrize("n_steps", [1, 47, 64, 65, 96, 365])
def test_k2_every_form_on_edge_tables(cuda, n_steps):
    """K2 in each of its 24 forms at 131072 rows, on tables whose first hits
    fall at columns 63, 64 and n - 1 or never (``_k2_edge_tables``), then
    on a table every path leaves in the first tile: against the plain
    versions, seeded and noise-in, with pairs against [X; -X].  Each
    launch counts under its form."""
    rows, key = 1 << 17, pc._fold_words(5, 131)
    for dtype, fgn_form, anti, cv, policy in K2_FORMS:
        consts = pc.make_path_consts(*MARKET.values(), n_steps, DT, cuda,
                                     fgn_form=fgn_form, fgn_dtype=dtype)
        noise = pc.normals_ref(consts, key, rows // 2 if anti else rows,
                               device=cuda)
        ls = pc._log_paths_ref(consts, noise, anti)
        name = pc.form_name(anti, cv, fgn_form == "spectral",
                            policy == "quadratic", dtype == "bfloat16")
        before = pc.priced_chunk.form_launches[name]
        for first_tile in (False, True):
            log_t, quad = _k2_edge_tables(ls, first_tile)
            _check_k2_form(cuda, consts, quad if policy == "quadratic"
                           else log_t, noise, key, anti, cv, policy, rows)
        assert pc.priced_chunk.form_launches[name] - before == 6
        del noise, ls


@pytest.mark.gpu
@pytest.mark.parametrize("fgn_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("policy", ["boundary", "quadratic"])
def test_k2_wild_noise(cuda, policy, fgn_dtype):
    """x3 noise at 365 steps on the edge tables of its own paths: paths
    cross the open columns' sets far apart; K2 and K2/cv still match their
    plain versions (rtol 1e-4), and K2/anti its pair on [X; -X]."""
    n, rows, key = 365, 1 << 17, pc._fold_words(6, 131)
    consts = pc.make_path_consts(*MARKET.values(), n, DT, cuda,
                                 fgn_dtype=fgn_dtype)
    for anti, cv in ((False, False), (False, True), (True, False)):
        if anti and policy == "quadratic":
            continue
        noise = 3.0 * pc.normals_ref(consts, key, rows // 2 if anti else rows,
                                     device=cuda)
        log_t, quad = _k2_edge_tables(pc._log_paths_ref(consts, noise, anti))
        want = pc.priced_chunk_from_noise_ref(
            consts, quad if policy == "quadratic" else log_t, noise, 105.0,
            False, anti, cv, policy)
        got = pc.priced_chunk(consts, quad if policy == "quadratic"
                              else log_t, 105.0, False, noise=noise,
                              antithetic=anti, with_cv=cv,
                              policy_form=policy)
        torch.cuda.synchronize()
        for g, w in zip(got if cv else (got,), want if cv else (want,)):
            assert float(w) > 0 and abs(float(g) / float(w) - 1.0) < 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("fgn_form", ["chol", "spectral"])
@pytest.mark.parametrize("n_steps", [96, 365])
def test_k2_quadratic_where_boundary_decides_otherwise(cuda, n_steps,
                                                       fgn_form):
    """A policy table whose exercise set at columns 63, 64 and n - 1 is two
    intervals of S (c2 = -1: the paths with the payoff plus z^2 in its top
    third, both tails), and the log boundary table of its hull (one
    interval, from the least to the largest log price there): the hull
    also stops the middle paths the quadratic keeps running, so the two
    plain sums differ by over 1 %; K2/quad (float32 and bf16) follows the
    quadratic plain version and K2 the boundary one, seeded and noise-in
    (rtol 1e-4)."""
    rows, key = 1 << 17, pc._fold_words(5, 137)
    for dtype in ("float32", "bfloat16"):
        consts = pc.make_path_consts(*MARKET.values(), n_steps, DT, cuda,
                                     fgn_form=fgn_form, fgn_dtype=dtype)
        noise = pc.normals_ref(consts, key, rows, device=cuda)
        ls = pc._log_paths_ref(consts, noise)
        s = torch.exp(ls)
        disc = torch.exp(-MARKET["r"] * DT
                         * torch.arange(1, n_steps + 1, device=cuda))
        quad = torch.zeros((8, n_steps), device=cuda)
        quad[2], quad[4], quad[5], quad[6], quad[7] = -1.0, 1.0, 1e30, disc, \
            105.0
        hull = torch.zeros((8, n_steps), device=cuda)
        hull[0], hull[1], hull[2] = 1e30, -1e30, disc
        for c in _k2_edge_columns(n_steps):
            mu, sd = s[:, c].mean(), s[:, c].std()
            z = (s[:, c] - mu) / sd
            g = torch.clamp_min(105.0 - s[:, c], 0.0) + z * z
            quad[0, c] = torch.quantile(g, 2 / 3)
            quad[3, c], quad[4, c], quad[5, c] = mu, sd, -1.0
            hull[0, c], hull[1, c] = ls[:, c].min(), ls[:, c].max()
        quad, hull = quad.contiguous(), hull.contiguous()
        want = {}
        for table, policy in ((quad, "quadratic"), (hull, "boundary")):
            want[policy] = float(pc.priced_chunk_from_noise_ref(
                consts, table, noise, 105.0, False, policy_form=policy))
            for got in (pc.priced_chunk(consts, table, 105.0, False,
                                        noise=noise, policy_form=policy),
                        pc.priced_chunk(consts, table, 105.0, False,
                                        rows=rows, key=key,
                                        policy_form=policy)):
                assert abs(float(got) / want[policy] - 1.0) < 1e-4, (
                    dtype, policy)
        assert abs(want["quadratic"] / want["boundary"] - 1.0) > 0.01
        del noise, ls, s


@pytest.mark.gpu
def test_k2_memory_model_and_blocks_are_the_cards(cuda):
    """Every unit's mcop_priced_smem_bytes equals pc.priced_smem_bytes, and
    the runtime holds each form's block (the wrapper's pick) at least as
    often as the launch bounds' minimum allows within shared memory, and
    no more than shared memory allows."""
    from montecarlooptionspricer_tpu_torch.kernels import build

    lib = build.load()
    for bf16 in (False, True):
        for seeded in (False, True):
            entry = build.entry(lib, "pathgen", "mcop_priced_smem_bytes",
                                bf16, seeded)
            for n in (1, 47, 96, 365):
                for anti, choices in ((False, pc.BLOCK_CHOICES),
                                      (True, pc.PAIRED_BLOCK_CHOICES)):
                    for bp in choices:
                        for spec in (False, True):
                            assert entry(n, bp, anti, spec) == \
                                pc.priced_smem_bytes(n, bp, anti, spec,
                                                     bf16)
    for n in (47, 96, 365):
        for dtype, fgn_form, anti, cv, policy in K2_FORMS:
            consts = pc.make_path_consts(*MARKET.values(), n, DT, cuda,
                                         fgn_form=fgn_form, fgn_dtype=dtype)
            bp = pc.priced_block_paths(consts, 1 << 17, anti)
            smem = pc.priced_smem_bytes(n, bp, anti, consts.spectral,
                                        consts.bf16)
            most = pc.smem_blocks_per_sm(smem)
            least = min(most, pc.priced_min_blocks(anti, consts.spectral,
                                                   consts.bf16))
            got = pc.priced_blocks_per_sm(consts, 1 << 17, anti, cv, policy)
            assert least <= got <= most, (n, dtype, fgn_form, anti, cv,
                                          policy, got)


@pytest.mark.gpu
@pytest.mark.parametrize("fgn_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fgn_form", ["chol", "spectral"])
@pytest.mark.parametrize("form", ["plain", "anti", "quad"])
def test_seeded_k2_matches_seeded_k5_of_one_strike(cuda, form, fgn_form,
                                                   fgn_dtype):
    """Seeded K2 against seeded K5 with one strike on the same key and fit,
    in each form K5 has: K5 decides on the S-space table (the quadratic
    with the reciprocal of sd), K2 on the log table (with the division),
    which differ only in the root band (rtol 1e-4)."""
    n_steps, rows = 365, 1 << 17
    anti, quad = form == "anti", form == "quad"
    policy = "quadratic" if quad else "boundary"
    consts = pc.make_path_consts(*MARKET.values(), n_steps, DT, cuda,
                                 fgn_form=fgn_form, fgn_dtype=fgn_dtype)
    key = pc._fold_words(5, 139)
    pilot = pc.pathgen(consts, rows=1 << 14, key=pc._fold_words(5, 141))
    _, fits = engine.lsm_fit(pilot, MARKET["r"], 104.0, n_steps * DT, DT,
                             False)
    if quad:
        k5_table = pc.policy_rows(fits, MARKET["r"], 104.0, n_steps * DT,
                                  DT, n_steps, False).contiguous()
        k2_table = k5_table
    else:
        k5_table = pc.boundary_rows(fits, MARKET["r"], 104.0, n_steps * DT,
                                    DT, n_steps, False).contiguous()
        k2_table = pc.log_boundary_rows(k5_table).contiguous()
    k5 = float(cc.priced_chain(consts, k5_table[None], False, rows=rows,
                               key=key, antithetic=anti,
                               policy_form=policy)[0])
    k2 = float(pc.priced_chunk(consts, k2_table, 104.0, False, rows=rows,
                               key=key, antithetic=anti, policy_form=policy))
    assert k2 > 0 and abs(k5 / k2 - 1.0) < 1e-4


# ---------------------------------------------------------------------------
# K8 and K9 as FFTs: every form on edge tables, the memory model.

K89_FORMS = [(d, a, cv, p) for d in ("float32", "bfloat16")
             for a, cv, p in ((False, False, "boundary"),
                              (True, False, "boundary"),
                              (False, True, "boundary"),
                              (True, True, "boundary"),
                              (False, False, "quadratic"),
                              (False, True, "quadratic"))]


def _k89_edge_columns(n):
    """K9's open columns: the edges of its step tiles and of its scan
    segments (127, 128, 1023, 1024, 2047, 2048, where they exist) and the
    last step."""
    return sorted({c for c in (127, 128, 1023, 1024, 2047, 2048, n - 1)
                   if c < n})


def _check_k9_form(consts, table, noise, key, anti, cv, policy, rows):
    """One K9 form, seeded and noise-in, against its plain version (each
    lane at rtol 1e-4), two seeded launches bit for bit, and paired against
    the unpaired form on [X; -X] (1e-5)."""
    priced = pfc.factored_priced_chunk
    want = pfc.factored_priced_chunk_from_noise_ref(
        consts, table, noise, 105.0, False, anti, cv, policy)
    want = want if cv else (want,)
    form = dict(antithetic=anti, with_cv=cv, policy_form=policy)
    got_n, got_s, again = (
        priced(consts, table, 105.0, False, **form, **kw)
        for kw in ({"noise": noise}, {"rows": rows, "key": key},
                   {"rows": rows, "key": key}))
    torch.cuda.synchronize()
    for got in (got_n, got_s):
        for g, w in zip(got if cv else (got,), want):
            assert float(w) > 0
            assert abs(float(g) / float(w) - 1.0) < 1e-4, form
    for g, w in zip(got_s if cv else (got_s,), again if cv else (again,)):
        assert torch.equal(g, w)
    if anti:
        unpaired = priced(consts, table, 105.0, False,
                          noise=torch.cat([noise, -noise], dim=1),
                          with_cv=cv)
        torch.cuda.synchronize()
        for g, w in zip(got_n if cv else (got_n,),
                        unpaired if cv else (unpaired,)):
            assert abs(float(g) / float(w) - 1.0) < 1e-5, form


@pytest.mark.gpu
@pytest.mark.parametrize("n_steps", [129, 200, 400, 1825, 4000, 8192])
def test_k89_every_form_on_edge_tables(cuda, n_steps):
    """K8 in its four forms and K9 in its twelve at 131072 rows (32768 at
    8192 steps, which keeps the plain planes in memory), seeded and
    noise-in: K8's paths at rtol 5e-4 against the plain version (the bf16
    form's: the four-step split), the pair to the bit against the unpaired
    kernel on [X; -X]; K9 on tables whose first hits fall at the edges of
    its step tiles and scan segments, at n - 1 or never (each open column
    stops a third of the paths still running), against the plain versions
    at rtol 1e-4, two seeded launches bit for bit and pairs against
    [X; -X] (1e-5).  Each launch counts under its form."""
    rows = 1 << 17 if n_steps <= 4096 else 1 << 15
    key = pc._fold_words(5, 151)
    path = pfc.factored_pathgen
    cols = _k89_edge_columns(n_steps)
    for dtype in ("float32", "bfloat16"):
        consts = pfc.make_factored_consts(*MARKET.values(), n_steps, DT,
                                          cuda, fgn_dtype=dtype)
        for anti in (False, True):
            noise = pfc.philox_factored_normals_ref(
                key, rows // 2 if anti else rows, n_steps, device=cuda)
            want = pfc.factored_pathgen_from_noise_ref(consts, noise, anti)
            name = pc.form_name(anti, bf16=dtype == "bfloat16")
            before = path.form_launches[name]
            for got in (path(consts, noise=noise, antithetic=anti),
                        path(consts, rows=rows, key=key, antithetic=anti)):
                torch.cuda.synchronize()
                torch.testing.assert_close(got, want, rtol=5e-4, atol=0)
                del got
            assert path.form_launches[name] - before == 2
            del want
            if anti:
                torch.testing.assert_close(
                    path(consts, noise=noise, antithetic=True),
                    path(consts, noise=torch.cat([noise, -noise], dim=1)),
                    rtol=0, atol=0)
            ls = pfc._log_paths_ref(consts, noise, anti)
            log_t, quad = _k2_edge_tables(ls, cols=cols)
            del ls
            for d, a, cv, policy in K89_FORMS:
                if d != dtype or a != anti:
                    continue
                name = pc.form_name(anti, cv, quadratic=policy == "quadratic",
                                    bf16=dtype == "bfloat16")
                before = pfc.factored_priced_chunk.form_launches[name]
                _check_k9_form(consts, quad if policy == "quadratic"
                               else log_t, noise, key, anti, cv, policy,
                               rows)
                assert pfc.factored_priced_chunk.form_launches[name] \
                    - before == 3
            del noise


@pytest.mark.gpu
def test_k89_memory_model_and_blocks_are_the_cards(cuda):
    """Each unit's mcop_factored_smem_bytes and mcop_factored_form_smem_bytes
    equal pfc.smem_bytes (the same at every horizon and in both dtypes,
    -1 outside the range), and the runtime holds each K8 and K9 form's block
    at least as often as the launch bounds' minimum of two allows within
    shared memory, and no more than shared memory allows."""
    from montecarlooptionspricer_tpu_torch.kernels import build

    lib = build.load()
    for bf16 in (False, True):
        smem = build.entry(lib, "pathgen_factored",
                           "mcop_factored_smem_bytes", bf16)
        form = build.entry(lib, "pathgen_factored",
                           "mcop_factored_form_smem_bytes", bf16)
        for n in (129, 200, 400, 1825, 4000, 8192):
            assert smem(n) == pfc.smem_bytes(n)
            assert form(n, 0, 0) == pfc.smem_bytes(n, "path")
            assert form(n, 1, 0) == pfc.smem_bytes(n, "boundary")
            assert form(n, 1, 1) == pfc.smem_bytes(n, "quadratic")
        assert smem(128) == smem(8193) == form(8193, 1, 0) == -1
    for n in (1825, 4000, 8192):
        for dtype in ("float32", "bfloat16"):
            consts = pfc.make_factored_consts(*MARKET.values(), n, DT, cuda,
                                              fgn_dtype=dtype)
            for anti in (False, True):
                most = pc.smem_blocks_per_sm(pfc.smem_bytes(n, "path"))
                got = pfc.blocks_per_sm(consts, False, anti)
                assert min(2, most) <= got <= most, (n, dtype, anti, got)
            for d, anti, cv, policy in K89_FORMS:
                if d != dtype:
                    continue
                most = pc.smem_blocks_per_sm(pfc.smem_bytes(n, policy))
                got = pfc.blocks_per_sm(consts, True, anti, cv, policy)
                assert min(2, most) <= got <= most, (n, dtype, anti, cv,
                                                     policy, got)


# ---------------------------------------------------------------------------
# K1 without a W plane, on its own blocks; K7's slab product on a ring of
# cp.async stages and its decision on a warp's lanes across a 128-column
# tile.

# K1's 8 forms: (fgn_dtype, fgn_form).
K1_FORMS = [(d, f) for d in ("float32", "bfloat16")
            for f in ("chol", "spectral")]


@pytest.mark.gpu
@pytest.mark.parametrize("n_steps", [47, 365])
def test_k1_every_form_and_memory_model(cuda, n_steps):
    """K1 in each of its 8 forms at 131072 rows against its plain version,
    seeded and noise-in (rtol 2e-4), the pair form equal to the bit to the
    unpaired form on [X; -X]; its units' shared memory is its model, and
    the runtime holds each form's block at least as often as the launch
    bounds' minimum allows within shared memory, and no more than shared
    memory allows."""
    from montecarlooptionspricer_tpu_torch.kernels import build

    rows, key = 1 << 17, pc._fold_words(5, 161)
    lib = build.load()
    for dtype, fgn_form in K1_FORMS:
        consts = pc.make_path_consts(*MARKET.values(), n_steps, DT, cuda,
                                     fgn_form=fgn_form, fgn_dtype=dtype)
        spec, bf16 = consts.spectral, consts.bf16
        for anti in (False, True):
            noise = pc.normals_ref(consts, key, rows // 2 if anti else rows,
                                   device=cuda)
            want = pc.pathgen_from_noise_ref(consts, noise, anti)
            got_n = pc.pathgen(consts, noise=noise, antithetic=anti)
            for got in (got_n, pc.pathgen(consts, rows=rows, key=key,
                                          antithetic=anti)):
                torch.cuda.synchronize()
                torch.testing.assert_close(got, want, rtol=2e-4, atol=0)
            if anti:
                unpaired = pc.pathgen(consts,
                                      noise=torch.cat([noise, -noise], dim=1))
                torch.cuda.synchronize()
                assert torch.equal(got_n, unpaired)
                del unpaired
            del noise, want, got_n, got
            bp = pc.pathgen_block_paths(consts, rows, anti)
            smem = pc.pathgen_smem_bytes(n_steps, bp, anti, spec, bf16)
            for seeded in (False, True):
                assert build.entry(lib, "pathgen", "mcop_path_smem_bytes",
                                   bf16, seeded)(n_steps, bp, anti,
                                                 spec) == smem
            most = pc.smem_blocks_per_sm(smem)
            least = min(most, pc.priced_min_blocks(anti, spec, bf16))
            got = pc.pathgen_blocks_per_sm(consts, rows, anti)
            assert least <= got <= most, (dtype, fgn_form, anti, got)


@pytest.mark.gpu
@pytest.mark.parametrize("n_steps", [129, 400])
def test_k7_every_form_on_edge_tables(cuda, n_steps):
    """K7 in each of its 24 forms at 131072 rows, on tables whose first
    hits fall at the four ballots' and the 128-column tiles' edges (31,
    32, 63, 64, 95, 96, 127, 128) and n - 1 or never, then on a table
    every path leaves in the first tile: against the plain versions,
    seeded and noise-in, two seeded launches bit for bit, pairs against
    [X; -X].  Each launch counts under its form."""
    rows, key = 1 << 17, pc._fold_words(5, 171)
    cols = [c for c in (31, 32, 63, 64, 95, 96, 127, 128, n_steps - 1)
            if c < n_steps]
    for dtype, fgn_form, anti, cv, policy in K2_FORMS:
        consts = pc.make_path_consts(*MARKET.values(), n_steps, DT, cuda,
                                     fgn_form=fgn_form, fgn_dtype=dtype)
        noise = pc.normals_ref(consts, key, rows // 2 if anti else rows,
                               device=cuda)
        ls = pc._log_paths_ref(consts, noise, anti)
        name = pc.form_name(anti, cv, fgn_form == "spectral",
                            policy == "quadratic", dtype == "bfloat16")
        before = ptc.tiled_priced_chunk.form_launches[name]
        for first_tile in (False, True):
            log_t, quad = _k2_edge_tables(ls, first_tile,
                                          None if first_tile else cols)
            _check_k2_form(cuda, consts, quad if policy == "quadratic"
                           else log_t, noise, key, anti, cv, policy, rows,
                           ptc.tiled_priced_chunk)
        assert ptc.tiled_priced_chunk.form_launches[name] - before == 6
        del noise, ls


@pytest.mark.gpu
def test_k6_k7_memory_model_and_blocks_are_the_cards(cuda):
    """Every unit's mcop_tiled_smem_bytes equals ptc.smem_bytes in every
    block, pairing, fGN form and control lane, and the runtime holds two or
    three blocks of each of K7's 24 forms and K6's 8 an SM (two float32
    blocks of 99,840 bytes, two or three bf16 ones of 70,144 by the launch
    bounds' registers)."""
    from montecarlooptionspricer_tpu_torch.kernels import build

    lib = build.load()
    for bf16 in (False, True):
        for seeded in (False, True):
            entry = build.entry(lib, "pathgen_tiled",
                                "mcop_tiled_smem_bytes", bf16, seeded)
            for anti, choices in ((False, ptc.BLOCK_CHOICES),
                                  (True, ptc.PAIRED_BLOCK_CHOICES)):
                for bp in choices:
                    for cv in (False, True):
                        for spec in (False, True):
                            assert entry(bp, anti, cv, spec) == \
                                ptc.smem_bytes(bp, anti, cv, spec, bf16)
    for dtype in ("float32", "bfloat16"):
        for fgn_form in ("chol", "spectral"):
            consts = pc.make_path_consts(*MARKET.values(), 400, DT, cuda,
                                         fgn_form=fgn_form, fgn_dtype=dtype)
            for anti in (False, True):
                got = ptc.blocks_per_sm(consts, 1 << 17, False, anti)
                assert 2 <= got <= 3, (dtype, fgn_form, anti, got)
            for _, _, anti, cv, policy in K2_FORMS[:6]:
                got = ptc.blocks_per_sm(consts, 1 << 17, True, anti, cv,
                                        policy)
                assert 2 <= got <= 3, (dtype, fgn_form, anti, cv, policy,
                                       got)


# The PredictionGen path: plain PyTorch on the card (no kernel of the port
# lies on it), held against the same code on the host.

def _pg_tasks(n_steps, seed=0):
    """RowTasks of one bucket with near-the-money contracts."""
    from montecarlooptionspricer_tpu_torch.pipeline.driver import RowTask

    g = torch.Generator().manual_seed(seed)
    u = torch.rand((len(n_steps), 6), generator=g).tolist()
    return [RowTask(index=i, line=f"row{i}", n_steps=n,
                    is_call=bool(i % 2), s0=100.0 + 10 * a, xi=0.02 + 0.08 * b,
                    h=0.05 + 0.4 * c, eta=0.5 + 1.5 * d, rho=-0.3,
                    strike=95.0 + 15 * e, maturity=(n + 0.5) / 252.0,
                    sigma=0.1 + 0.3 * f, dividend=0.01,
                    twenty_day_vol=0.2, twenty_day_momentum=0.0)
            for i, (n, (a, b, c, d, e, f)) in enumerate(zip(n_steps, u))]


def _pg_pricers(device):
    from montecarlooptionspricer_tpu_torch.config import (
        MarketDefaults, PricingConfig)
    from montecarlooptionspricer_tpu_torch.pipeline.driver import (
        BatchedPricer)

    return BatchedPricer(PricingConfig(), MarketDefaults(), device)


@pytest.mark.gpu
def test_prediction_gen_price_from_noise_card_matches_host(cuda):
    """One batch of 8 rows at n_pad 256 from one injected noise and branch
    indices, on the card and on the host: each estimator within 1e-5
    relative."""
    tasks = _pg_tasks([129, 140, 170, 200, 220, 240, 250, 255])
    g = torch.Generator().manual_seed(1)
    shape = (8, 250, 256)
    zc = torch.complex(torch.randn(shape, generator=g),
                       torch.randn(shape, generator=g))
    dw = torch.randn(shape, generator=g) / 252 ** 0.5
    rp = torch.randint(0, 250, shape + (10,), generator=g)
    on_card = _pg_pricers(cuda).price_from_noise(tasks, zc, dw, rp)
    on_host = _pg_pricers("cpu").price_from_noise(tasks, zc, dw, rp)
    assert on_card.shape == on_host.shape == (8, 4)
    assert (on_host > 0).all()
    torch.testing.assert_close(torch.from_numpy(on_card),
                               torch.from_numpy(on_host), rtol=1e-5, atol=0)


@pytest.mark.gpu
def test_prediction_gen_rows_do_not_depend_on_their_batch(cuda):
    """A row's seeded prices have the same bits in a batch of 8 and in a
    batch of 3 rows padded to 8, at another position."""
    pricer = _pg_pricers(cuda)
    tasks = _pg_tasks([33, 40, 47, 50, 55, 60, 62, 63])
    whole = pricer.price(tasks, 7)
    part = pricer.price(tasks[3:6], 7)
    assert (whole[3:6] == part).all()


@pytest.mark.gpu
def test_prediction_gen_2048_bucket_batch(cuda):
    """The largest bucket at the reference's width, 64 rows x 250 paths x
    2049 columns, seeded: finite prices, within a quarter of the card's
    memory."""
    pricer = _pg_pricers(cuda)
    n_steps = [1025 + 16 * i for i in range(64)]
    torch.cuda.reset_peak_memory_stats()
    out = pricer.price(_pg_tasks(n_steps), 3)
    peak = torch.cuda.max_memory_allocated()
    assert out.shape == (64, 4)
    assert torch.isfinite(torch.from_numpy(out)).all()
    assert peak < torch.cuda.get_device_properties(0).total_memory / 4, peak


# ---------------------------------------------------------------------------
# Randomized QMC: the noise made on the card, and the noise-in entries of
# K2, K5, K7 and K9 on its noise.

QMC_MARKET = dict(**MARKET, rho=-0.4)


@pytest.mark.gpu
def test_qmc_normals_on_the_card(cuda):
    """The card's shift words span 32 bits, its digital shift equals the
    host's bit for bit, the uniforms stay inside (0, 1), and its float32
    ndtri lies within 2e-6 of float64."""
    from montecarlooptionspricer_tpu_torch.ops import qmc

    shift = qmc.draw_shift(torch.Generator(device=cuda).manual_seed(1), 64)
    assert int(shift.min()) < 0 < int(shift.max())
    base = qmc.base_bits(1 << 17, 64, cuda)
    u = qmc.rotate(base, shift)
    assert torch.equal(u.cpu(), qmc.rotate(base.cpu(), shift.cpu()))
    assert bool((u > 0).all()) and bool((u < 1).all())
    err = (qmc.normals(base, shift).double()
           - qmc.normals(base, shift, torch.float64)).abs().max()
    assert float(err) <= 2e-6


@pytest.mark.gpu
@pytest.mark.parametrize("form,n_steps,qmc_fgn", [
    ("chol", 365, False), ("chol", 365, True), ("spectral", 365, True),
    ("chol", 1825, False), ("factored", 4000, False),
    ("factored", 1000, True)])
def test_qmc_noise_card_matches_host(cuda, form, n_steps, qmc_fgn):
    """``fused_qmc_noise`` on the card against its host build from the
    same draws, within 1e-5 at 365 steps and sqrt(n / 365) times that
    past it (the PCA product's n-term sums in another float32 order)."""
    rows = 2048
    cfg = engine.StreamConfig(n_paths=rows, n_steps=n_steps, chunk_paths=rows,
                              pilot_paths=rows, dt=DT, qmc=True,
                              qmc_fgn=qmc_fgn)
    host = engine.make_fused_qmc(cfg, form, "cpu")
    draws = engine.fused_qmc_draws(host, torch.Generator().manual_seed(3))
    want = engine.fused_qmc_noise(host, *draws)
    got = engine.fused_qmc_noise(engine.make_fused_qmc(cfg, form, cuda),
                                 *(d.to(cuda) for d in draws))
    torch.cuda.synchronize()
    torch.testing.assert_close(got.cpu(), want, rtol=0,
                               atol=1e-5 * (n_steps / 365) ** 0.5)


def _qmc_pricer(cuda, n_steps, rows, n_chunks=1, **extra):
    cfg = engine.StreamConfig(n_paths=rows * n_chunks, n_steps=n_steps,
                              chunk_paths=rows, pilot_paths=1 << 14, dt=DT,
                              qmc=True, **extra)
    return engine.StreamingPricer(**QMC_MARKET, strike=100.0,
                                  maturity=n_steps * DT, is_call=False,
                                  config=cfg, device=cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("n_steps,extra,family", [
    (96, {}, "single"), (96, dict(fgn_form="spectral"), "single"),
    (96, dict(control_variate=True), "single"),
    (96, dict(policy_form="quadratic"), "single"),
    (96, dict(fgn_matmul_dtype="bfloat16"), "single"),
    (96, dict(qmc_fgn=True), "single"), (400, {}, "tiled"),
    (400, dict(control_variate=True), "tiled"),
    (400, dict(fgn_matmul_dtype="bfloat16"), "tiled"),
    (400, dict(tiled_impl="factored"), "factored"),
    (400, dict(tiled_impl="factored", qmc_fgn=True), "factored")])
def test_priced_kernels_on_qmc_noise(cuda, n_steps, extra, family):
    """K2, K7 and K9 on a chunk of the QMC stream's noise (131,072 rows,
    the pilot's fits) against their plain versions, each lane within
    1e-4."""
    p = _qmc_pricer(cuda, n_steps, 1 << 17, **extra)
    assert p.kernel_family == family
    cv = p.config.control_variate
    fits = p.fit((7, engine.PILOT_STREAM))
    table = p._make_rows(fits.fits if cv else fits)
    noise = p._qmc_chunk_noise((7, 0))
    ref = (pfc.factored_priced_chunk_from_noise_ref if family == "factored"
           else pc.priced_chunk_from_noise_ref)
    got = p._priced_chunk(p.consts, table, 100.0, False, noise=noise,
                          with_cv=cv, policy_form=p.config.policy_form)
    want = ref(p.consts, table, noise, 100.0, False, False, cv,
               p.config.policy_form)
    torch.cuda.synchronize()
    for g, w in zip(*((got, want) if cv else ((got,), (want,)))):
        assert abs(float(g) / float(w) - 1.0) < 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("n_steps,extra", [(96, {}), (400, {}),
                                           (400, dict(fgn_form="spectral"))])
def test_k5_on_qmc_noise(cuda, n_steps, extra):
    """K5 on a chunk of the QMC stream's noise in its pilot family's form
    (chol at 96 and on the slab at 400 steps; spectral on the factored
    family) against its plain version."""
    cfg = engine.StreamConfig(n_paths=1 << 17, n_steps=n_steps,
                              chunk_paths=1 << 17, pilot_paths=1 << 14,
                              dt=DT, qmc=True, **extra)
    chain = engine.StreamingChainPricer(
        **QMC_MARKET, strikes=[90.0, 100.0, 110.0], maturity=n_steps * DT,
        is_call=False, config=cfg, device=cuda)
    fits = chain.fit((7, engine.PILOT_STREAM))
    tables = chain._tables(fits, chain.strikes)
    noise = chain._qmc_chunk_noise((7, 0))
    got = cc.priced_chain(chain.chain_consts, tables, False, noise=noise)
    want = cc.priced_chain_from_noise_ref(chain.chain_consts, tables, noise,
                                          False)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("n_steps,extra,wrapper", [
    (96, {}, pc.priced_chunk), (400, {}, ptc.tiled_priced_chunk),
    (400, dict(tiled_impl="factored"), pfc.factored_priced_chunk)])
def test_qmc_price_streams_through_noise_in(cuda, n_steps, extra, wrapper):
    """``price`` under qmc launches the family's priced kernel once a
    chunk, every launch on injected noise, and no path kernel (the pilot
    rides the generic stream)."""
    p = _qmc_pricer(cuda, n_steps, 1 << 14, n_chunks=4, **extra)
    path_kernels = (pc.pathgen, ptc.tiled_pathgen, pfc.factored_pathgen)
    for fn in (wrapper, *path_kernels):
        fn.launches = 0
    wrapper.noise_launches = 0
    price, se = p.price(3, with_stderr=True)
    assert wrapper.launches == wrapper.noise_launches == 4
    assert all(fn.launches == 0 for fn in path_kernels)
    assert 0 < price < 100.0 and 0 < se < 0.1 * price


# ---------------------------------------------------------------------------
# The serving stream and the jvp Greeks (plain PyTorch on the card).

def _traced_inputs(dev, n_steps=64, rows=4096, anti=False):
    """Traced-market constants at a fresh market and H on ``dev``, a
    seeded host noise pair copied there, and a pilot fit on the host."""
    from montecarlooptionspricer_tpu_torch.models import pathgen_stream as ps

    c = ps.with_market(ps.make_stream_consts(
        *MARKET.values(), n_steps, DT, dev, traced_h=True), h=0.3, s0=97.0,
        xi=0.06, r=0.03, eta=1.2)
    gen = torch.Generator().manual_seed(17)
    drawn = rows // 2 if anti else rows
    z = torch.randn((2, drawn, n_steps), generator=gen)
    dw = torch.randn((drawn, n_steps), generator=gen) * DT ** 0.5
    return c, z.to(dev), dw.to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("anti", [False, True], ids=["plain", "anti"])
def test_traced_market_chunk_card_matches_host(cuda, anti):
    """A traced-market chunk (fresh market and H, live for 40 of 64 steps)
    on the card against the same chunk on the host: the matrices within
    1e-6 of their scale and the paths at rtol 2e-5 (float32 products in
    another order)."""
    from montecarlooptionspricer_tpu_torch.models import pathgen_stream as ps

    c_d, z, dw = _traced_inputs(cuda, anti=anti)
    c_h, _, _ = _traced_inputs(torch.device("cpu"), anti=anti)
    for a, b in ((c_d.cr, c_h.cr), (c_d.ci, c_h.ci), (c_d.t_pow, c_h.t_pow)):
        assert float((a.cpu() - b).abs().max()) <= 1e-6 * float(
            b.abs().max())
    got = ps.paths_from_noise(c_d, z, dw, anti, n_live=40)
    want = ps.paths_from_noise(c_h, z.cpu(), dw.cpu(), anti, n_live=40)
    torch.cuda.synchronize()
    assert got.is_cuda
    torch.testing.assert_close(got.cpu(), want, rtol=2e-5, atol=0)
    assert torch.equal(got[:, 41:], got[:, 40:41].expand(-1, 24))


@pytest.mark.gpu
def test_jvp_chunk_on_the_card_matches_autograd(cuda):
    """One chunk's jvp Greeks on the card (a 2-strike strip, pairs, live
    for 40 of 64 steps) against ``torch.autograd.grad`` of the same chunk
    value on the card (H through the float64 build), each lane within
    1e-4 of its scale; the price lane within 1e-5 of the plain stream's
    policy value on the same paths."""
    from montecarlooptionspricer_tpu_torch.models import pathgen_stream as ps

    c, z, dw = _traced_inputs(cuda, anti=True)
    strikes = torch.tensor([95.0, 103.0], device=cuda)
    mat = 40 * DT
    pilot = ps.paths_from_noise(c, *ps.draw_noise(
        c, 8192, ps.stream_generator(cuda, (4, 2))), n_live=40)
    _, fits = engine.lsm_fit(pilot, c.r, strikes, mat, DT, False,
                             n_steps=40)
    got = engine.jvp_chunk_greeks(c, z, dw, fits, strikes, mat, False, True,
                                  40)
    h64 = torch.tensor(c.h, dtype=torch.float64, device=cuda,
                       requires_grad=True)
    prm = [torch.tensor(v, device=cuda, requires_grad=True)
           for v in (c.s0, c.xi, c.r, c.eta)]
    mats = [m.float() for m in ps._hurst_build(h64, c.n_steps, DT)]
    paths = ps.paths_from_params(c, z, dw, prm, mats, True, 40)
    plain = ps.paths_from_noise(c, z, dw, True, 40)
    for i, k in enumerate(strikes.tolist()):
        f = engine.PolyFit(*(x[i] for x in fits))
        val = engine.lsm_policy_value(paths, f, prm[2], k, mat, DT, False,
                                      40)[0]
        grads = torch.autograd.grad(val, prm + [h64], retain_graph=True)
        s0_, xi_, r_, eta_, h_ = (float(g) for g in grads)
        want = torch.tensor([float(val.detach()), s0_, xi_, eta_, r_, h_])
        lane = got[:, i].cpu()
        assert float((lane - want).abs().max()) <= 1e-4 * float(
            want.abs().max()), (lane, want)
        ref = float(engine.lsm_policy_value(plain, f, c.r, k, mat, DT, False,
                                            40)[0])
        assert abs(float(lane[0]) / ref - 1.0) < 1e-5


def _nn_pair(cuda):
    """The meta-model's trainer on the card and on the host: one seed, so
    the same initial weights."""
    from montecarlooptionspricer_tpu_torch.nn.trainer import BayesianTrainer

    torch.backends.cuda.matmul.allow_tf32 = False
    return (BayesianTrainer(17, 64, device=cuda),
            BayesianTrainer(17, 64, device="cpu"))


@pytest.mark.gpu
def test_nn_eval_forward_card_matches_host(cuda):
    """The eval forward of 512 rows within 1e-5 abs / 1e-4 rel of the
    host's."""
    card, host = _nn_pair(cuda)
    x = torch.randn(512, 17, generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(card.forward(x).cpu(), host.forward(x),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
def test_nn_eval_forward_peak_is_linear_in_rows(cuda):
    """The eval forward's peak bytes grow with the rows, not with their
    square: 65,536 rows take at most 10x the peak of 8,192 (8x if linear;
    a batch attention's scores would make it 64x)."""
    card, _ = _nn_pair(cuda)
    x = torch.randn(65_536, 17, generator=torch.Generator().manual_seed(5))
    peak = {}
    for rows in (8_192, 65_536):
        torch.cuda.synchronize(cuda)
        base = torch.cuda.memory_allocated(cuda)
        torch.cuda.reset_peak_memory_stats(cuda)
        assert card.forward(x[:rows]).shape == (rows, 15)
        torch.cuda.synchronize(cuda)
        peak[rows] = torch.cuda.max_memory_allocated(cuda) - base
    assert peak[65_536] <= 10 * peak[8_192], peak


@pytest.mark.gpu
@pytest.mark.parametrize("warmup", [True, False], ids=["warmup", "mdn"])
def test_nn_masked_step_card_matches_host(cuda, warmup):
    """One batch of 256 rows on injected masks: the loss within 1e-5 rel,
    each gradient within 1e-4 of its max-abs; then the optimizer's update
    on the host's gradients within 1e-6 of the host's."""
    card, host = _nn_pair(cuda)
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(256, 17, generator=gen)
    y = 1.0 + 0.5 * torch.randn(256, 1, generator=gen)
    w = torch.ones(256)
    w[-7:] = 0.0
    masks = host.model.draw_masks((256,), gen, "cpu")
    loss_h, grads_h = host.loss_and_grads(x, y, w, warmup=warmup,
                                          masks=masks)
    loss_c, grads_c = card.loss_and_grads(
        x.to(cuda), y.to(cuda), w.to(cuda), warmup=warmup,
        masks=[m.to(cuda) for m in masks])
    assert abs(float(loss_c) / float(loss_h) - 1.0) <= 1e-5
    for (name, _), gc_, gh in zip(host.model.named_parameters(), grads_c,
                                  grads_h):
        scale = float(gh.abs().max())
        assert float((gc_.cpu() - gh).abs().max()) <= 1e-4 * scale, name
    for t in (card, host):
        t._make_optimizer(3e-4)
    assert bool(card.optimizer.step([g.to(cuda) for g in grads_h]))
    assert bool(host.optimizer.step(grads_h))
    torch.testing.assert_close(card.optimizer._update.cpu(),
                               host.optimizer._update, rtol=0, atol=1e-6)


@pytest.fixture
def nccl_mesh(cuda):
    """The port's mesh over NCCL at a world of one (the card's process
    group), destroyed after the test."""
    import torch.distributed as dist

    from montecarlooptionspricer_tpu_torch.parallel import make_mesh

    if dist.is_initialized():
        pytest.skip("a process group already exists in this process")
    try:
        yield make_mesh(1, "cuda")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.mark.gpu
def test_mesh_nccl_world_of_one(nccl_mesh):
    """``make_mesh(1, "cuda")`` gives an NCCL group of one rank on the
    card; a mesh of two raises ValueError (JAX's message)."""
    import torch.distributed as dist

    from montecarlooptionspricer_tpu_torch.parallel import make_mesh

    assert dist.get_backend() == "nccl"
    assert (nccl_mesh.rank, nccl_mesh.size) == (0, 1)
    assert nccl_mesh.device.type == "cuda"
    with pytest.raises(ValueError, match="2-device mesh but only 1"):
        make_mesh(2, "cuda")


@pytest.mark.gpu
def test_mesh_pricer_on_the_card(nccl_mesh):
    """``StreamingPricer(mesh=)`` at 365 steps on 4 chunks of 16,384:
    K1 once and K2 4 times; the fit through the group is the fit without
    one on the same pilot to the bit; K2 on the rank-offset key against
    its plain version (1e-4)."""
    cfg = engine.StreamConfig(n_paths=4 << 14, n_steps=365,
                              chunk_paths=1 << 14, pilot_paths=1 << 14,
                              chunks_per_call=4)
    pricer = engine.StreamingPricer(**MARKET, rho=-0.4, strike=100.0,
                                    maturity=365 * DT, is_call=False,
                                    config=cfg, device="cuda",
                                    mesh=nccl_mesh)
    pc.pathgen.launches = pc.priced_chunk.launches = 0
    price, stderr = pricer.price(3, with_stderr=True)
    assert (pc.pathgen.launches, pc.priced_chunk.launches) == (1, 4)
    assert 0.0 < price < 100.0 and 0.0 < stderr < 0.05 * price
    carrier = engine._pilot_stream_keys(3)[0]
    pilot = pricer._pilot(carrier)
    with_group = engine.lsm_fit(pilot, MARKET["r"], 100.0, 365 * DT, DT,
                                False, group=nccl_mesh.group)[1]
    without = engine.lsm_fit(pilot, MARKET["r"], 100.0, 365 * DT, DT,
                             False)[1]
    assert all(torch.equal(a, b) for a, b in zip(with_group, without))
    table = pricer._make_rows(with_group)
    run, start = engine._pilot_stream_keys(3)[1]
    key = pc._fold_words(run, start + (1 << 20))
    got = float(pc.priced_chunk(pricer.consts, table, 100.0, False,
                                rows=1 << 14, key=key))
    want = float(pc.priced_chunk_from_noise_ref(
        pricer.consts, table, pc.philox_normals_ref(key, 1 << 14, 365,
                                                    device=pricer.device),
        100.0, False))
    assert abs(got / want - 1.0) < 1e-4


@pytest.mark.gpu
def test_mesh_trainer_epoch_on_the_card(nccl_mesh, tmp_path):
    """One ``train_model(mesh=)`` epoch at a world of one leaves the
    parameters and Adam's moments of the one-device epoch to the bit."""
    import numpy as np

    from montecarlooptionspricer_tpu_torch.config import TrainConfig
    from montecarlooptionspricer_tpu_torch.nn.trainer import BayesianTrainer

    rng = np.random.default_rng(2)
    x = rng.normal(size=(1024, 17)).astype(np.float32)
    y = (1.0 + 0.5 * x[:, 0]).astype(np.float32)
    out = []
    for mesh in (None, nccl_mesh):
        t = BayesianTrainer(17, 64, config=TrainConfig(seed=1),
                            device="cuda")
        t.train_model(x, y, num_epochs=1, batch_size=128,
                      checkpoint_path=str(tmp_path / f"c{mesh is None}"),
                      mesh=mesh)
        out.append((t.model.state_dict(), t.optimizer.m, t.optimizer.v))
    for k, v in out[0][0].items():
        assert torch.equal(v, out[1][0][k]), k
    assert torch.equal(out[0][1], out[1][1])
    assert torch.equal(out[0][2], out[1][2])
