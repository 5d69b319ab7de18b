"""K2's layout and decision on the CPU: its shared-memory model against the
C layout of ``csrc/pathgen.cu:priced_kernel``, written out here region by
region as the kernel carves its dynamic shared memory, the block and the
blocks an SM holds that it picks in each of its 24 forms, the single-tile
range model left as it was, and a Python mirror of its
parallel first-hit decision (lanes on columns l and l + 32, two ballots a
path and tile) held equal to the plain versions' ``first_hit_sum`` and
``quadratic_stops``.  The card tests hold the C entries equal to the same
models (``tests/test_torch_gpu.py``); these run in about a second."""

import math

import numpy as np
import pytest
import torch

from montecarlooptionspricer_tpu_torch.models import engine
from montecarlooptionspricer_tpu_torch.models import pathgen_cuda as pc

ROWS = 1 << 17
MARKET = dict(s0=100.0, xi=0.04, h=0.1, eta=1.5, r=0.04)
DT = 1.0 / 252.0
STEPS = (1, 47, 96, 365)
# The 24 forms: (bf16, spectral, antithetic, cv, quadratic).
FORMS = [(b, s, a, cv, q) for b in (False, True) for s in (False, True)
         for a, cv, q in ((0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 0),
                          (0, 0, 1), (0, 1, 1))]


def _plane(n, drawn, bf16):
    """Floats of one multiplied noise plane: float32 rows of n rounded up
    to odd, or bf16 rows of n rounded up to 16 plus 8."""
    if bf16:
        return drawn * ((n + 15) // 16 * 16 + 8) // 2
    return drawn * (n | 1)


def k2_layout(n, bp, anti, spec, bf16):
    """priced_kernel: N (and Zi) planes of the drawn rows, an X tile
    [BP][65] of every member (the partial sums at the end) and the staged
    factor tiles ([TK][64] float32, TK 16 for the unpaired chol block and
    32 else, or [64][40] bf16; two under SPEC), whose room also takes the
    tile's [3 or 8][64] staged rows after the product.  No W plane."""
    drawn = bp // 2 if anti else bp
    planes = 2 if spec else 1
    tk = 16 if not (anti or spec or bf16) else 32
    staged = planes * (64 * 40 // 2 if bf16 else tk * 64)
    assert staged // planes >= 8 * 64
    return 4 * (planes * _plane(n, drawn, bf16) + bp * 65 + staged)


def range_layout(n, bp, anti, cv, spec, bf16):
    """The single-tile range model (pc.range_smem_bytes, the layout with a
    resident W plane): the planes and a W plane [D][n | 1], the X tile of
    every member, the staged factor tiles and (1 or 2) * BP floats."""
    drawn = bp // 2 if anti else bp
    planes = 2 if spec else 1
    staged = planes * (64 * 40 // 2 if bf16 else 32 * 64)
    return 4 * (planes * _plane(n, drawn, bf16) + drawn * (n | 1) + bp * 65
                + staged + (2 if cv else 1) * bp)


def _consts(n, bf16, spec):
    return pc.make_path_consts(*MARKET.values(), n, DT, "cpu",
                               fgn_form="spectral" if spec else "chol",
                               fgn_dtype="bfloat16" if bf16 else "float32")


# K2's blocks, (bf16, spectral, antithetic) -> paths (pair members): the
# largest that fits up to the measured caps (64 members for the float32
# chol pair, 32 and 64 for the bf16 spectral forms), and at 365 steps 64
# for the float32 spectral pair.
K2_BLOCKS = {n: {(b, s, a): 128 if a else 64 for b in (0, 1)
                 for s in (0, 1) for a in (0, 1)} for n in STEPS}
for _n in STEPS:
    K2_BLOCKS[_n].update({(0, 0, 1): 64, (1, 1, 0): 32, (1, 1, 1): 64})
K2_BLOCKS[365][0, 1, 1] = 64
# Blocks one SM holds by its 233,472 bytes of shared memory (1,024 a block
# reserved, at most 8 blocks of 256 threads) at 365 steps, per form
# (bf16, spectral, antithetic) in either policy: three bf16 blocks but the
# chol pair's two, two float32 chol blocks and three of its pairs, one
# float32 spectral block.
K2_SMEM_BLOCKS_365 = {(0, 0, 0): 2, (0, 0, 1): 3, (0, 1, 0): 1,
                      (0, 1, 1): 1, (1, 0, 0): 3, (1, 0, 1): 2,
                      (1, 1, 0): 3, (1, 1, 1): 3}


@pytest.mark.parametrize("n", STEPS)
def test_k2_memory_model_is_the_c_layout(n):
    """pc.priced_smem_bytes equals the C layout for every block, fGN form,
    pairing and dtype (the policy and the control variate take no memory
    more), and is the range model's less its W plane at least."""
    for anti, choices in ((False, pc.BLOCK_CHOICES),
                          (True, pc.PAIRED_BLOCK_CHOICES)):
        for spec in (False, True):
            for bf16 in (False, True):
                for bp in choices:
                    got = pc.priced_smem_bytes(n, bp, anti, spec, bf16)
                    assert got == k2_layout(n, bp, anti, spec, bf16)
                    drawn = bp // 2 if anti else bp
                    assert got <= range_layout(n, bp, anti, False, spec,
                                               bf16) - 4 * drawn * (n | 1)


@pytest.mark.parametrize("n", STEPS)
def test_k2_blocks_in_every_form(n):
    """The block K2 picks in each of its 24 forms (the largest that fits up
    to the form's cap, the same in both policies) fits, and the blocks an
    SM holds by shared memory and the launch bounds' minimum are the
    design's: at 365 steps three bf16 blocks an SM but the chol pair's two,
    two float32 chol blocks and three of its pairs, one float32 spectral
    block."""
    for bf16, spec, anti, cv, quad in FORMS:
        consts = _consts(n, bf16, spec)
        bp = pc.priced_block_paths(consts, ROWS, bool(anti))
        assert bp == K2_BLOCKS[n][bf16, spec, anti]
        smem = pc.priced_smem_bytes(n, bp, bool(anti), spec, bf16)
        assert smem <= pc.SMEM_LIMIT
        blocks = pc.smem_blocks_per_sm(smem)
        assert blocks == min(8, 233_472 // (smem + 1_024)) >= 1
        minimum = pc.priced_min_blocks(bool(anti), spec, bf16)
        assert minimum == (3 if bf16 and (spec or not anti) else 2)
        if n == 365:
            assert blocks == K2_SMEM_BLOCKS_365[bf16, spec, anti]
    bf16_chol = _consts(365, True, False)
    assert pc.priced_smem_bytes(365, 64, bf16=True) == 69_888
    assert pc.priced_smem_bytes(365, 64) == 114_176
    assert pc.priced_block_paths(bf16_chol, ROWS) == 64
    with pytest.raises(ValueError):        # no paired block divides 48
        pc.priced_block_paths(bf16_chol, 48, True)


def test_k1_model_and_single_tile_range_unchanged():
    """The range model keeps the layout with a W plane, which no kernel
    takes (K1's is tests/test_torch_k1_k7_layout.py's), and sets the
    single-tile family's range: 64 paths at 365 steps chol
    (211,968 bytes; 163,584 bf16), 32 spectral, the pair forms' range
    blocks 128 and 64; 365 steps single, 366 the slab."""
    for n in STEPS:
        for anti, choices in ((False, pc.BLOCK_CHOICES),
                              (True, pc.PAIRED_BLOCK_CHOICES)):
            for bp in choices:
                for cv in (False, True):
                    for spec in (False, True):
                        for bf16 in (False, True):
                            assert pc.range_smem_bytes(
                                n, bp, anti, cv, spec, bf16) == range_layout(
                                n, bp, anti, cv, spec, bf16)
    assert pc.range_smem_bytes(365, 64) == 211_968
    assert pc.range_smem_bytes(365, 64, bf16=True) == 163_584
    assert pc.max_block_paths(365) == 64
    assert pc.max_block_paths(365, "spectral") == 32
    assert pc.path_block_paths(_consts(365, False, False), ROWS, True) == 128
    assert pc.path_block_paths(_consts(365, False, True), ROWS, True) == 64
    assert pc.supports(365) and pc.supports(365, "spectral")
    assert engine.resolve_kernel_family(365) == "single"
    assert engine.resolve_kernel_family(366) == "tiled"


# ---------------------------------------------------------------------------
# The decision's mirror.

def _ffs(x):
    """1 + the index of the lowest set bit of each int64 entry, 0 for 0
    (CUDA's __ffs)."""
    low = x & -x
    return torch.where(x != 0, torch.log2(low.clamp_min(1).double()).long()
                       + 1, 0)


def warp_first_hits(test):
    """(hit, first column) of each row of the [rows, n] bool ``test``, as
    K2's warps find them: per 64-column tile, lane l's tests of columns l
    and l + 32 (columns past n false) make two ballots, bit l each; a row
    that had not stopped and has a set bit stops at first_hit (the first
    set bit of b0, else 31 + __ffs(b1)); a stopped row is masked."""
    rows, n = test.shape
    stopped = torch.zeros(rows, dtype=torch.bool)
    first = torch.zeros(rows, dtype=torch.long)
    weights = 1 << torch.arange(32, dtype=torch.long)
    for c0 in range(0, n, 64):
        tile = torch.zeros((rows, 64), dtype=torch.bool)
        tile[:, :min(64, n - c0)] = test[:, c0:c0 + 64]
        b0 = (tile[:, :32].long() * weights).sum(dim=1)
        b1 = (tile[:, 32:].long() * weights).sum(dim=1)
        new = ((b0 | b1) != 0) & ~stopped
        col = torch.where(b0 != 0, _ffs(b0) - 1, 31 + _ffs(b1))
        first = torch.where(new, c0 + col, first)
        stopped |= new
    return stopped, first


def _log_paths(rng, rows, n):
    """Seeded random log paths near log 100: steps of 2 %, a few wild."""
    steps = rng.normal(0.0, 0.02, (rows, n)) * np.where(
        rng.random((rows, 1)) < 0.1, 4.0, 1.0)
    return torch.from_numpy(math.log(100.0) + np.cumsum(steps, axis=1)
                            ).float()


def _boundary_table(rng, n):
    """A log_boundary_rows-style [8, n] table: a narrow interval around a
    random centre per step, closed (lo > hi) at nine steps in ten, open to
    the upper half at columns 63, 64 and n - 1 (where they exist);
    discounts in row 2."""
    centre = math.log(100.0) + rng.normal(0.0, 0.08, n)
    width = rng.uniform(0.0, 0.01, n)
    lo, hi = centre - width, centre + width
    closed = rng.random(n) < 0.9
    lo[closed], hi[closed] = 1e30, -1e30
    for c in (63, 64, n - 1):
        if c < n:
            lo[c], hi[c] = math.log(100.0), math.log(100.0) + 0.5
    table = np.zeros((8, n))
    table[0], table[1] = lo, hi
    table[2] = np.exp(-0.04 * DT * np.arange(1, n + 1))
    return torch.from_numpy(table).float()


def _policy_table(rng, n, strike):
    """A policy_rows-style [8, n] table: random standardized quadratics
    (c0, c1, c2), mu near 100, sd in [1, 10], eps, discounts, strike."""
    table = np.zeros((8, n))
    table[0] = rng.uniform(0.0, 8.0, n)
    table[1] = rng.normal(0.0, 2.0, n)
    table[2] = rng.normal(0.0, 0.5, n)
    table[3] = rng.uniform(95.0, 105.0, n)
    table[4] = rng.uniform(1.0, 10.0, n)
    table[5] = np.where(rng.random(n) < 0.2, 1e30, 1e-14)
    table[6] = np.exp(-0.04 * DT * np.arange(1, n + 1))
    table[7] = strike
    return torch.from_numpy(table).float()


def quad_cell_test(s, table, is_call):
    """K2's quadratic test (csrc/pathgen.cu priced_kernel, with
    csrc/quad_policy.cuh's quad_payoff and quad_rows_cont) on [rows, n]
    prices: p > eps and p >= (c2 z + c1) z + c0, z = (s - mu) / sd, every
    step rounded to float32 on its own; also p."""
    n = s.shape[1]
    c0, c1, c2, mu, sd, eps, _, strike = table[:, :n].unbind(0)
    p = torch.clamp_min(s - strike if is_call else strike - s, 0.0)
    z = (s - mu) / sd
    return (p > eps) & (p >= (c2 * z + c1) * z + c0), p


@pytest.mark.parametrize("n", [1, 47, 64, 65, 96, 365])
@pytest.mark.parametrize("is_call", [False, True])
def test_decision_mirror_matches_plain_versions(n, is_call):
    """The two-ballot first hit over tiles picks the plain versions' first
    column on every path, boundary and quadratic: the payoff sums are
    bit-equal to ``first_hit_sum`` and the (hit, column, value) of every
    path to ``quadratic_stops``, with paths that never hit and hits at
    columns 63, 64 and n - 1 among them."""
    rng = np.random.default_rng(1000 + n + int(is_call))
    ls = _log_paths(rng, 512, n)
    strike = 104.0
    table = _boundary_table(rng, n)
    exf = (ls >= table[0]) & (ls <= table[1])
    hit, first = warp_first_hits(exf)
    assert torch.equal(hit, exf.any(dim=1))
    assert torch.equal(first[hit], exf.to(torch.int8).argmax(dim=1)[hit])
    s_stop = torch.exp(ls.gather(1, first[:, None])[:, 0])
    pay = s_stop - strike if is_call else strike - s_stop
    val = table[2][first] * torch.clamp_min(pay, 0.0)
    got = torch.sum(torch.where(hit, val, torch.zeros_like(val)))
    assert torch.equal(got, pc.first_hit_sum(ls, table, strike, is_call))
    if n > 64:
        assert bool((~hit).any()) and bool((first[hit] == 63).any())
        assert bool((first[hit] == 64).any())

    s = torch.exp(ls)
    qtable = _policy_table(rng, n, strike)
    test, p = quad_cell_test(s, qtable, is_call)
    q_hit, q_first = warp_first_hits(test)
    q_val = (p * qtable[6]).gather(1, q_first[:, None])[:, 0]
    want_hit, want_first, want_val = pc.quadratic_stops(s, qtable, is_call)
    assert torch.equal(q_hit, want_hit)
    assert torch.equal(q_first[q_hit], want_first[want_hit])
    assert torch.equal(q_val[q_hit], want_val[want_hit])
