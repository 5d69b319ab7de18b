"""P1, the roofline probes (``montecarlooptionspricer_tpu_torch.roofline``,
counterpart ``parity/vpu_roofline.py``): their plain versions (which the
wrappers run on the CPU) against the draws of the path kernels' stream and
against a jnp statement of the TPU kernel's body, the accounting against
the script's formula, and the entry's refusal to time anything but a CUDA
device.  The kernels themselves are held against these plain versions on
the card in test_torch_gpu.py."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlooptionspricer_tpu_torch import roofline as rl
from montecarlooptionspricer_tpu_torch.models import pathgen_cuda as pc

KEY = 7


def test_normals_probe_draws_the_path_kernels_stream():
    """Column c of the plain P1/normals sums the N and W planes of
    ``philox_normals_ref``'s row c over the plane's 256 steps (the kernel's
    step pairs 128 t .. 128 t + 127), and those draws are standard normal:
    the mean within 5 stderr of 0, the variance within 5 stderr of 1.
    (JAX's ``_normals`` reads zeros in interpret mode, so only the law can
    be held against the TPU's draws.)"""
    grid, k, unroll = 2, 1, 2
    out = rl.normals(KEY, grid, k, unroll, device="cpu")
    assert out.shape == (grid, rl.LANES)
    for c in (0, 1, 511, 700, 1023):
        nw = pc.philox_normals_ref(KEY, 1, 256 * k * unroll, row0=c)
        np.testing.assert_allclose(float(out.reshape(-1)[c]),
                                   float(nw.sum()), rtol=1e-5, atol=1e-4)
    v = pc.philox_normals_ref(KEY, grid * rl.LANES, 256).double().reshape(-1)
    n = v.numel()
    assert abs(float(v.mean())) < 5 / math.sqrt(n)
    assert abs(float(v.var()) - 1.0) < 5 * math.sqrt(2.0 / n)


def test_exp_and_fma_variants_are_their_numpy_arithmetic():
    """with_exp sums exp(v * 1e-3) and the FMA chain 8 dependent
    v * 0.999999 + 1e-7 (fused: one rounding a step) of the same draws,
    held against numpy on those draws to 1e-6 of the sum of magnitudes."""
    grid, k = 1, 1
    v = pc.philox_normals_ref(KEY, grid * rl.LANES, 256 * k).numpy()
    e = np.exp(v * np.float32(1e-3))
    f = v.astype(np.float64)
    for _ in range(rl.FMA_CHAIN):
        f = (f * np.float64(np.float32(0.999999))
             + np.float64(np.float32(1e-7))).astype(np.float32).astype(
                 np.float64)
    for got, want in ((rl.normals(KEY, grid, k, with_exp=True, device="cpu"),
                       e), (rl.normals(KEY, grid, k, fma=rl.FMA_CHAIN,
                                       device="cpu"), f)):
        want_sum = want.sum(axis=(0, 2)).reshape(grid, rl.LANES)
        scale = np.abs(want).sum(axis=(0, 2)).max()
        np.testing.assert_allclose(got.numpy(), want_sum, rtol=0,
                                   atol=1e-6 * scale)
    with pytest.raises(ValueError):
        rl.normals(KEY, 1, 1, fma=3, device="cpu")


def jax_mm(a0, b, steps, dtype, grid):
    """``mm_kernel``'s body (parity/vpu_roofline.py:161-174), its output
    stripe included, on a given a0: a = dot(a.astype(dtype), B) with float32
    sums, ``steps`` times; each block's column sums, lanes 0-127 on 8 rows."""
    a = jnp.asarray(a0)
    bb = jnp.asarray(b).astype(dtype)
    for _ in range(steps):
        a = jnp.dot(a.astype(dtype), bb, preferred_element_type=jnp.float32)
    s_pad = a.shape[1]
    sums = jnp.sum(a.reshape(grid, rl.BLOCK, s_pad), axis=1)
    return np.asarray(jnp.repeat(sums[:, None, :128], 8, axis=1)
                      .reshape(grid * 8, 128))


@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-5),
                                        ("bfloat16", 1e-3)])
@pytest.mark.parametrize("which", ["identity", "orthogonal"])
def test_matmul_probe_is_the_tpu_kernels_body(dtype, rtol, which):
    """The plain P1/matmul's JAX stripe against the jnp statement of
    ``mm_kernel`` on the same a0 (the N plane of the stream) after 3 steps:
    float32 to 1e-5 of the largest column sum, bf16 to 1e-3 (both sum the
    exact products of bf16 values in float32, in other orders; a value on
    a rounding tie may round to the other bf16 neighbour).  The script's B
    is the identity; a random orthogonal B moves every entry."""
    grid, s_pad, k, unroll = 2, 128, 1, 3
    b = torch.eye(s_pad) if which == "identity" else rl.orthogonal(s_pad)
    tb = b.to(torch.bfloat16) if dtype == "bfloat16" else b
    got = rl.stripe(rl.matmul(KEY, tb, grid, k, unroll)).numpy()
    a0 = pc.philox_normals_ref(KEY, grid * rl.BLOCK, s_pad)[0].numpy()
    want = jax_mm(a0, b.numpy(), k * unroll, jnp.dtype(dtype), grid)
    assert got.shape == want.shape == (grid * 8, 128)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * np.abs(want).max())
    if which == "identity" and dtype == "float32":    # a stays a0
        a0_sums = a0.reshape(grid, rl.BLOCK, s_pad).sum(1)[:, :128]
        np.testing.assert_allclose(got[::8], a0_sums, rtol=0,
                                   atol=1e-6 * np.abs(a0_sums).max())


@pytest.mark.parametrize("bf16", [False, True])
def test_chain_atol_holds_another_summation_order(bf16):
    """``chain_atol``'s model on the CPU: the plain P1/matmul chain
    against the same chain whose products are summed in float64 and then
    rounded (another order, as the card's) stays within the tolerance
    after 30 steps, while a chain one step short misses it by far."""
    grid, s_pad, steps = 2, 128, 30
    b = rl.orthogonal(s_pad, seed=3)
    bb = b.to(torch.bfloat16) if bf16 else b
    want = rl.matmul_ref(KEY, bb, grid, steps)
    a = pc.philox_normals_ref(KEY, grid * rl.BLOCK, s_pad)[0]
    bd = bb.double()
    for i in range(steps):
        x = pc.round_bf16(a) if bf16 else a
        a = (x.double() @ bd).float()
        if i == steps - 2:
            short = a.reshape(grid, rl.BLOCK, s_pad).sum(1)
    other = a.reshape(grid, rl.BLOCK, s_pad).sum(1)
    atol = rl.chain_atol(bf16, steps, float(want.abs().max()))
    assert float((other - want).abs().max()) <= atol
    assert float((short - want).abs().max()) > 20 * atol


def test_bf16_rounding_rms():
    """``chain_atol``'s per-element rounding error: rounding standard
    normals to bf16 (nearest even) errs by rms 1.7e-3, to 3 %."""
    x = torch.randn(1 << 20, generator=torch.Generator().manual_seed(0))
    rms = float((pc.round_bf16(x) - x).pow(2).mean().sqrt())
    assert rms == pytest.approx(rl.BF16_ROUNDING_RMS, rel=0.03)


def test_chol_cell_bound_reproduces_the_script():
    """With the TPU's counts (2 normals, 1 exp, 17 elementwise, 2 s_pad
    multiply-adds a cell) the bounds are the script's t_vpu = 2/r_nrm +
    1/r_exp + 17/r_fma and t_mxu = 2 s_pad/r_mxu, overlap max(), serial
    the sum; the port's ceiling is cells x its own per-cell serial bound."""
    rates = rl.Rates(normals=4e11, exp=2e12, fma=3e13, mm_f32=1.2e13,
                     mm_bf16=2e14)
    for dtype, r_mm in (("float32", rates.mm_f32),
                        ("bfloat16", rates.mm_bf16)):
        t_vpu = 2 / rates.normals + 1 / rates.exp + 17 / rates.fma
        t_mxu = 2 * 384 / r_mm
        serial, overlap = rl.chol_cell_bound(
            rates, **rl.TPU_CELL_COUNTS, macs=rl.tpu_cell_macs(365),
            fgn_dtype=dtype)
        assert serial == pytest.approx(t_vpu + t_mxu, rel=1e-12)
        assert overlap == pytest.approx(max(t_vpu, t_mxu), rel=1e-12)
        rows, n = 1 << 17, 365
        per_cell = 2 / rates.normals + 1 / rates.exp + 11 / rates.fma \
            + (n + 1) / 2 / r_mm
        assert rl.ceiling_ms(rates, "K2", rows, n, dtype) == pytest.approx(
            rows * n * per_cell * 1e3, rel=1e-12)


def test_normals_plain_version_by_blocks():
    """The plain P1/normals of blocks block0 .. block0 + grid - 1 are those
    rows of the whole grid's (the card's check holds a whole launch
    against it group of blocks by group)."""
    full = rl.normals_ref(KEY, 3, 1, 2)
    assert torch.equal(rl.normals_ref(KEY, 2, 1, 2, block0=1), full[1:])
    assert torch.equal(rl.normals_ref(KEY, 1, 1, 2, block0=2), full[2:])


def test_ceiling_takes_the_faster_product_and_overlaps():
    """The product's rate is the faster of the probe's (the kernels' own
    tile product) and the library chain's; the overlapped ceiling is the
    larger of the elementwise and product times, the serial their sum."""
    base = dict(normals=4e11, exp=2e12, fma=3e13, mm_f32=1e13, mm_bf16=1e13)
    slow_lib = rl.Rates(**base, lib_mm_f32=5e12, lib_mm_bf16=5e12)
    fast_lib = rl.Rates(**base, lib_mm_f32=2e13, lib_mm_bf16=7e13)
    assert slow_lib.mm("float32") == 1e13 == slow_lib.mm("bfloat16")
    assert fast_lib.mm("float32") == 2e13
    assert fast_lib.mm("bfloat16") == 7e13
    rows, n = 1 << 10, 1825
    t_elem = 2 / 4e11 + 1 / 2e12 + 11 / 3e13
    t_mm = (n + 1) / 2 / 7e13
    cells_ms = rows * n * 1e3
    assert rl.ceiling_ms(fast_lib, "K7", rows, n, "bfloat16") == \
        pytest.approx(cells_ms * (t_elem + t_mm), rel=1e-12)
    assert rl.ceiling_ms(fast_lib, "K7", rows, n, "bfloat16",
                         overlap=True) == pytest.approx(
        cells_ms * max(t_elem, t_mm), rel=1e-12)


def test_entry_refuses_without_cuda(capsys):
    """The entry never times on the CPU: without a CUDA device (or when
    asked for the CPU) it exits 1 with a message; ``measure`` raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert rl.main(["--device", "cuda"]) == 1
    assert rl.main(["--device", "cpu"]) == 1
    assert "CUDA device" in capsys.readouterr().err
    with pytest.raises(RuntimeError):
        rl.measure("cpu")
