"""K1's and K7's layouts and K7's decision on the CPU: their shared-memory
models against the C layouts of ``csrc/pathgen.cu:tile_kernel`` (K1 takes
K2's) and ``csrc/pathgen_tiled.cu:tiled_kernel`` with the ring of
``csrc/slab_tile.cuh``, written out here region by region as the kernels
carve their dynamic shared memory; the blocks and the blocks an SM that K1
picks in its 8 forms and K6/K7 in their 8 and 24; the seeded workspace and
the padded factors of the slab; the single-tile and slab ranges and the
kernel family table left as they were; and a Python mirror of K7's
decision (lanes on columns l, l + 32, l + 64 and l + 96, four ballots a
path and 128-column tile) held equal to the plain versions'
``first_hit_sum`` and ``quadratic_stops``.  The card tests hold the C
entries equal to the same models (``tests/test_torch_gpu.py``); these run
in about a second."""

import numpy as np
import pytest
import torch
from test_torch_k2_layout import (_boundary_table, _ffs, _log_paths,
                                  _policy_table, quad_cell_test)

from montecarlooptionspricer_tpu_torch.models import engine
from montecarlooptionspricer_tpu_torch.models import pathgen_cuda as pc
from montecarlooptionspricer_tpu_torch.models import pathgen_tiled_cuda as ptc

ROWS = 1 << 17
MARKET = dict(s0=100.0, xi=0.04, h=0.1, eta=1.5, r=0.04)
DT = 1.0 / 252.0
STEPS = (1, 47, 96, 365)
# K1's and K6's 8 forms: (bf16, spectral, antithetic).
PATH_FORMS = [(b, s, a) for b in (False, True) for s in (False, True)
              for a in (False, True)]
# K7's 24: (bf16, spectral, antithetic, cv, quadratic).
K7_FORMS = [(b, s, a, cv, q) for b in (False, True) for s in (False, True)
            for a, cv, q in ((0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 0),
                             (0, 0, 1), (0, 1, 1))]
SM_SMEM, BLOCK_RESERVE = 233_472, 1_024


def _consts(n, bf16, spec):
    return pc.make_path_consts(*MARKET.values(), n, DT, "cpu",
                               fgn_form="spectral" if spec else "chol",
                               fgn_dtype="bfloat16" if bf16 else "float32")


# ---------------------------------------------------------------------------
# K1.

def k1_layout(n, bp, anti, spec, bf16):
    """tile_kernel with PRICED false: the N (and Zi) planes of the drawn
    rows (float32 rows of n | 1, or bf16 rows of n rounded up to 16 plus
    8), an X tile [BP][65] of every member and the staged factor tiles
    ([TK][64] float32, TK 16 for the unpaired chol block, 8 for the
    spectral pair and 32 else, or [64][40] bf16; two under SPEC).  No W
    plane: W is drawn (or read) per tile pair."""
    drawn = bp // 2 if anti else bp
    planes = 2 if spec else 1
    plane = (drawn * ((n + 15) // 16 * 16 + 8) // 2 if bf16
             else drawn * (n | 1))
    tk = (16 if not (anti or spec or bf16) else 8 if anti and spec
          and not bf16 else 32)
    staged = planes * (64 * 40 // 2 if bf16 else tk * 64)
    return 4 * (planes * plane + bp * 65 + staged)


@pytest.mark.parametrize("n", STEPS)
def test_k1_memory_model_is_the_c_layout(n):
    """K1's block (``pc.pathgen_smem_bytes``) takes K2's layout in every
    block, fGN form, pairing and dtype but the float32 spectral pair's,
    which stages 8 rows of the factors a pass: the range model less its W
    plane at least."""
    for anti, choices in ((False, pc.BLOCK_CHOICES),
                          (True, pc.PAIRED_BLOCK_CHOICES)):
        for spec in (False, True):
            for bf16 in (False, True):
                for bp in choices:
                    got = pc.pathgen_smem_bytes(n, bp, anti, spec, bf16)
                    assert got == k1_layout(n, bp, anti, spec, bf16)
                    if not (anti and spec and not bf16):
                        assert got == pc.priced_smem_bytes(n, bp, anti,
                                                           spec, bf16)
                    drawn = bp // 2 if anti else bp
                    assert got <= pc.range_smem_bytes(
                        n, bp, anti, False, spec, bf16) - 4 * drawn * (n | 1)


# K1's blocks at 365 steps, (bf16, spectral, antithetic) -> paths (pair
# members): the largest that fits up to PATHGEN_BLOCK_CAPS.
K1_BLOCKS_365 = {(0, 0, 0): 64, (0, 0, 1): 64, (0, 1, 0): 64, (0, 1, 1): 64,
                 (1, 0, 0): 64, (1, 0, 1): 128, (1, 1, 0): 32,
                 (1, 1, 1): 64}
# Blocks one SM holds by shared memory at those blocks (233,472 bytes, 1,024
# a block reserved): two float32 chol blocks and three of its pairs, one
# float32 spectral block and two of its pairs, three bf16 blocks but the
# chol pair's two.
K1_SMEM_BLOCKS_365 = {(0, 0, 0): 2, (0, 0, 1): 3, (0, 1, 0): 1,
                      (0, 1, 1): 2, (1, 0, 0): 3, (1, 0, 1): 2,
                      (1, 1, 0): 3, (1, 1, 1): 3}


@pytest.mark.parametrize("n", STEPS)
def test_k1_blocks_in_every_form(n):
    """The block K1 picks in each of its 8 forms (its own, not the range
    model's) fits and divides the chunk, and the launch bounds' minimum of
    blocks an SM is K2's; at 365 steps the blocks and the blocks an SM by
    shared memory are the design's."""
    for bf16, spec, anti in PATH_FORMS:
        consts = _consts(n, bf16, spec)
        bp = pc.pathgen_block_paths(consts, ROWS, anti)
        cap = pc.PATHGEN_BLOCK_CAPS.get((bf16, spec, anti), 128)
        assert bp <= cap and ROWS % bp == 0
        smem = pc.pathgen_smem_bytes(n, bp, anti, spec, bf16)
        assert smem <= pc.SMEM_LIMIT
        blocks = pc.smem_blocks_per_sm(smem)
        assert blocks == min(8, SM_SMEM // (smem + BLOCK_RESERVE)) >= 1
        assert pc.priced_min_blocks(anti, spec, bf16) == (
            3 if bf16 and (spec or not anti) else 2)
        if n == 365:
            assert bp == K1_BLOCKS_365[bf16, spec, anti]
            assert blocks == K1_SMEM_BLOCKS_365[bf16, spec, anti]
    with pytest.raises(ValueError):        # no paired block divides 48
        pc.pathgen_block_paths(_consts(365, False, False), 48, True)


# ---------------------------------------------------------------------------
# K6/K7 and the slab's ring.

def k7_layout(bp, anti, spec, bf16):
    """tiled_kernel: the decision's staged rows [8][128] and the X tile
    [BP][129], in whose room the product's ring of k-tile stages lives
    while it runs: per stage N^T [TK][D+4] and the factor's [TK][128]
    float32 k-tiles (TK 32, 16 spectral; three stages), or N's [D][24] and
    the factor's [16][136] bf16 k-tiles (six stages, three spectral); two
    of each tile under SPEC.  Every tile starts on 16 bytes."""
    d = bp // 2 if anti else bp
    tiles = 2 if spec else 1
    if bf16:
        n_tile, f_tile, stages = 2 * d * 24, 2 * 16 * 136, 3 if spec else 6
    else:
        tk = 16 if spec else 32
        n_tile, f_tile, stages = 4 * tk * (d + 4), 4 * tk * 128, 3
    assert n_tile % 16 == 0 and f_tile % 16 == 0
    ring = stages * tiles * (n_tile + f_tile)
    return max(ring, 4 * (8 * 128 + bp * 129))


def test_k7_memory_model_is_the_c_layout():
    """ptc.smem_bytes equals the C layout for every block, pairing, fGN
    form and dtype, with and without the control variate (its sums go
    through the X tile): at 128 paths the ring's 99,840 bytes in
    float32 (75,264 for 128 pair members, whose ring holds 64 rows) and
    the X tile's 70,144 in bf16, so shared memory holds two blocks an SM
    in float32 and three in bf16 (the launch bounds' 128 registers
    two)."""
    for anti, choices in ((False, ptc.BLOCK_CHOICES),
                          (True, ptc.PAIRED_BLOCK_CHOICES)):
        for bp in choices:
            for spec in (False, True):
                for bf16 in (False, True):
                    for cv in (False, True):
                        assert ptc.smem_bytes(bp, anti, cv, spec, bf16) == \
                            k7_layout(bp, anti, spec, bf16)
                    d = bp // 2 if anti else bp
                    assert 4 * ptc.ring_floats(d, spec, bf16) <= \
                        ptc.smem_bytes(bp, anti, False, spec, bf16)
    for spec in (False, True):
        for bf16 in (False, True):
            smem = ptc.smem_bytes(128, False, False, spec, bf16)
            assert smem == (70_144 if bf16 else 99_840)
            assert pc.smem_blocks_per_sm(smem) == (3 if bf16 else 2)
            assert ptc.smem_bytes(128, True, True, spec, bf16) == (
                70_144 if bf16 else 75_264)


def test_k6_k7_blocks_in_every_form():
    """K7's 24 forms and K6's 8 take 128 paths (128 members paired) at the
    chunk, the largest block, and fit; smaller row counts take the
    largest block that divides them."""
    for bf16, spec, anti, cv, quad in K7_FORMS:
        bp = ptc.block_paths_for(ROWS, bool(anti))
        assert bp == 128
        assert ptc.smem_bytes(bp, bool(anti), bool(cv), spec, bf16) <= \
            pc.SMEM_LIMIT
    for bf16, spec, anti in PATH_FORMS:
        assert ptc.block_paths_for(ROWS, anti) == 128
    assert ptc.block_paths_for(96) == 32
    assert ptc.block_paths_for(96, True) == 32
    with pytest.raises(ValueError):
        ptc.block_paths_for(48, True)


@pytest.mark.parametrize("n", [1, 7, 8, 365, 1825, 3620])
def test_slab_workspace_and_padded_factors(n):
    """The seeded workspace: the noise-in layout in float32; under bf16 the
    N (and Zi) planes as bf16 rows of slab_ld(n) (16-byte rows: whole
    cp.async copies), then W [drawn, n] in float32 on a 16-byte boundary.
    The factors the slab reads are the constants' with zero rows padded to
    slab_ld(n), the same values before it."""
    drawn = 256
    ld = pc.slab_ld(n)
    assert ld % 8 == 0 and n <= ld < n + 8
    for spec in (False, True):
        planes = 2 if spec else 1
        assert ptc.workspace_floats(drawn, n, spec) == (planes + 1) * drawn * n
        w_at = planes * drawn * ld // 2
        assert w_at % 4 == 0
        assert ptc.workspace_floats(drawn, n, spec, True) == \
            w_at + drawn * n
    if n <= 365:
        for bf16 in (False, True):
            for spec in (False, True):
                consts = _consts(n, bf16, spec)
                mats = ((consts.cr_half, consts.ci_half) if spec
                        else (consts.lt_half, None))
                for got, want in zip(consts.slab_factors, mats):
                    if want is None:
                        assert got is None
                        continue
                    assert got.shape == (n, ld) and got.is_contiguous()
                    assert got.dtype == want.dtype
                    assert torch.equal(got[:, :n], want)
                    assert not bool(got[:, n:].float().any())


# ---------------------------------------------------------------------------
# The ranges K1's and K7's layouts leave as they were.

# The largest range block of max_block_paths and where it falls, per form:
# (first horizon, block).
RANGE_STEPS = {"chol": [(1, 64), (406, 32), (844, 16), (1720, 0)],
               "spectral": [(1, 64), (260, 32), (540, 16), (1104, 0)]}
HORIZONS = (1, 47, 129, 365, 366, 1008, 1825, 2560, 2561, 3620, 3621, 4000,
            8192, 8193, 10000)
# resolve_kernel_family(n, fgn_form, tiled_impl) for fgn_form in (auto,
# chol, spectral) x tiled_impl in (auto, slab, factored); E: ValueError.
S, T, F, X, E = "single", "tiled", "factored", "stream", ValueError
FAMILIES = {
    1: [S] * 9, 47: [S] * 9, 129: [S] * 9, 365: [S] * 9,
    **{n: [T, T, F, T, T, E, F, T, F] for n in (366, 1008, 1825, 2560)},
    **{n: [T, T, F, T, T, E, F, E, F] for n in (2561, 3620)},
    **{n: [F, E, F, E, E, E, F, E, F] for n in (3621, 4000, 8192)},
    **{n: [X, E, E, X, E, E, X, E, E] for n in (8193, 10000)}}


def test_ranges_and_families_unchanged():
    """max_block_paths, supports and max_tiled_steps give the range
    model's values at every horizon and form, resolve_kernel_family its
    table, and K6_VS_K1_STEPS = 1008 runs on K1."""
    for form, steps in RANGE_STEPS.items():
        bounds = [first for first, _ in steps[1:]] + [9000]
        for (first, block), end in zip(steps, bounds):
            for n in {first, (first + end) // 2, end - 1}:
                assert pc.max_block_paths(n, form) == block, (form, n)
                assert pc.supports(n, form) == (block > 0)
    assert ptc.max_tiled_steps() == ptc.max_tiled_steps("chol") == 3620
    assert ptc.max_tiled_steps("spectral") == 2560
    assert ptc.supports(3620) and not ptc.supports(3621)
    assert ptc.supports(2560, "spectral")
    assert not ptc.supports(2561, "spectral")
    for n in HORIZONS:
        want = FAMILIES[n]
        i = 0
        for form in ("auto", "chol", "spectral"):
            for impl in ("auto", "slab", "factored"):
                if want[i] is ValueError:
                    with pytest.raises(ValueError):
                        engine.resolve_kernel_family(n, form, impl)
                else:
                    assert engine.resolve_kernel_family(n, form, impl) == \
                        want[i], (n, form, impl)
                i += 1
    mid = _consts(1008, False, False)
    assert pc.supports(1008) and mid.block_paths == 16
    assert pc.pathgen_block_paths(mid, ROWS) == 32


# ---------------------------------------------------------------------------
# K7's decision's mirror.

def warp_first_hits4(test):
    """(hit, first column) of each row of the [rows, n] bool ``test``, as
    K7's warps find them: per 128-column tile, lane l's tests of columns
    l, l + 32, l + 64 and l + 96 (columns past n false) make four ballots,
    bit l each; a row that had not stopped and has a set bit stops at the
    first set bit of the first nonzero ballot, 32 h + __ffs(b[h]) - 1; a
    stopped row is masked."""
    rows, n = test.shape
    stopped = torch.zeros(rows, dtype=torch.bool)
    first = torch.zeros(rows, dtype=torch.long)
    weights = 1 << torch.arange(32, dtype=torch.long)
    for c0 in range(0, n, 128):
        tile = torch.zeros((rows, 128), dtype=torch.bool)
        tile[:, :min(128, n - c0)] = test[:, c0:c0 + 128]
        b = [(tile[:, 32 * h:32 * h + 32].long() * weights).sum(dim=1)
             for h in range(4)]
        any_hit = (b[0] | b[1] | b[2] | b[3]) != 0
        col = torch.full((rows,), -1, dtype=torch.long)
        for h in (3, 2, 1, 0):       # the first nonzero ballot wins
            col = torch.where(b[h] != 0, 32 * h + _ffs(b[h]) - 1, col)
        new = any_hit & ~stopped
        first = torch.where(new, c0 + col, first)
        stopped |= new
    return stopped, first


def _with_edge_hits(table, n, cols):
    """The boundary table opened (log 100 .. log 100 + 0.5) at ``cols``."""
    for c in cols:
        if c < n:
            table[0, c], table[1, c] = float(np.log(100.0)), \
                float(np.log(100.0)) + 0.5
    return table


@pytest.mark.parametrize("n", [1, 47, 96, 127, 128, 129, 257, 400])
@pytest.mark.parametrize("is_call", [False, True])
def test_k7_decision_mirror_matches_plain_versions(n, is_call):
    """The four-ballot first hit over 128-column tiles picks the plain
    versions' first column on every path, boundary and quadratic: the
    payoff sums are bit-equal to ``first_hit_sum`` and the (hit, column,
    value) of every path to ``quadratic_stops``, with paths that never
    hit and hits at the ballots' and the tiles' edges among them."""
    rng = np.random.default_rng(2000 + n + int(is_call))
    ls = _log_paths(rng, 512, n)
    strike = 104.0
    table = _with_edge_hits(_boundary_table(rng, n), n,
                            (31, 32, 95, 96, 127, 128))
    exf = (ls >= table[0]) & (ls <= table[1])
    hit, first = warp_first_hits4(exf)
    assert torch.equal(hit, exf.any(dim=1))
    assert torch.equal(first[hit], exf.to(torch.int8).argmax(dim=1)[hit])
    s_stop = torch.exp(ls.gather(1, first[:, None])[:, 0])
    pay = s_stop - strike if is_call else strike - s_stop
    val = table[2][first] * torch.clamp_min(pay, 0.0)
    got = torch.sum(torch.where(hit, val, torch.zeros_like(val)))
    assert torch.equal(got, pc.first_hit_sum(ls, table, strike, is_call))
    if n > 128:
        assert bool((~hit).any())
        for c in (31, 32, 127, 128):
            assert bool((first[hit] == c).any()), c

    s = torch.exp(ls)
    qtable = _policy_table(rng, n, strike)
    test, p = quad_cell_test(s, qtable, is_call)
    q_hit, q_first = warp_first_hits4(test)
    q_val = (p * qtable[6]).gather(1, q_first[:, None])[:, 0]
    want_hit, want_first, want_val = pc.quadratic_stops(s, qtable, is_call)
    assert torch.equal(q_hit, want_hit)
    assert torch.equal(q_first[q_hit], want_first[want_hit])
    assert torch.equal(q_val[q_hit], want_val[want_hit])
