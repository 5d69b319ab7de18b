"""The port's path kernels' plain versions, host constants, policy tables
and counter-based generator against the JAX package on the same numpy
inputs.  The JAX Pallas kernels run in interpret mode with injected noise,
as the JAX package's own tests run them on the CPU.  The kernels
themselves are held against these plain versions on the card in
test_torch_gpu.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from montecarlooptionspricer_tpu.models import engine as jengine
from montecarlooptionspricer_tpu.models import pathgen_pallas as jpp
from montecarlooptionspricer_tpu.models.lsm import lsm_fit as jlsm_fit
from montecarlooptionspricer_tpu_torch.models import engine as tengine
from montecarlooptionspricer_tpu_torch.models import pathgen_cuda as pc
from montecarlooptionspricer_tpu_torch.ops.regression import (
    polyfit_from_numpy)

KW = dict(s0=100.0, xi=0.05, h=0.15, eta=1.4, rho=-0.5, r=0.04)
DT = 1 / 252
N_STEPS, CHUNK = 96, 512


def shared_noise(rng, rows, n_steps):
    """[2, rows, s_pad] float32 numpy noise, zero past n_steps: the JAX
    kernels read the padded width, the port the first n_steps columns."""
    s_pad = pc._round_up(n_steps, pc.LANE)
    noise = np.zeros((2, rows, s_pad), np.float32)
    noise[:, :, :n_steps] = rng.normal(size=(2, rows, n_steps))
    return noise


def port_noise(noise, n_steps):
    return torch.from_numpy(np.ascontiguousarray(noise[:, :, :n_steps]))


def consts_cpu(n_steps=N_STEPS):
    return pc.make_path_consts(KW["s0"], KW["xi"], KW["h"], KW["eta"],
                               KW["r"], n_steps, DT, "cpu")


def jax_pilot_fits(noise, strike, maturity, is_call, n_steps=N_STEPS):
    """JAX paths from the interpreted chol kernel, and JAX's LSM fit."""
    gen, _ = jpp.make_pallas_pathgen_from_noise(
        **KW, n_steps=n_steps, dt=DT, chunk_paths=noise.shape[1],
        block_paths=256, interpret=True, fgn_form="chol")
    paths = gen(jnp.asarray(noise))
    _, fits = jlsm_fit(paths, KW["r"], strike, maturity, DT, is_call, 2)
    return paths, fits


def to_port_fits(fits):
    return polyfit_from_numpy(np.asarray(fits.coeffs), np.asarray(fits.mu),
                              np.asarray(fits.sd), "cpu")


def test_chol_and_drift_match_jax():
    """The same float64 numpy code: equal to 1e-12."""
    for n in (32, 96):
        np.testing.assert_allclose(
            tengine._chol_np(n, KW["h"], KW["eta"], DT),
            jengine._chol_np(n, KW["h"], KW["eta"], DT), rtol=0, atol=1e-12)
        np.testing.assert_allclose(
            tengine._chol_matrix_host(n, KW["h"], KW["eta"], DT),
            np.asarray(jengine._chol_matrix_host(n, KW["h"], KW["eta"], DT,
                                                 jnp.float32)),
            rtol=1e-6, atol=1e-7)   # JAX's copy is cast to float32
        s_pad = pc._round_up(n, pc.LANE)
        np.testing.assert_allclose(
            pc._half_var_drift(n, s_pad, KW["xi"], KW["h"], KW["eta"],
                               DT).numpy(),
            np.asarray(jpp._half_var_drift(n, s_pad, KW["xi"], KW["h"],
                                           KW["eta"], DT)),
            rtol=0, atol=1e-12)


def test_fold_words_matches_jax():
    for a, b in [(0, 0), (12345, 7), (2 ** 31 - 2, 3 << 28), (99, 2 ** 20)]:
        want = int(np.asarray(jpp._fold_words(jnp.int32(a), jnp.int32(b)))
                   .astype(np.uint32))
        assert pc._fold_words(a, b) == want


@pytest.mark.parametrize("is_call,strike", [(False, 102.0), (True, 98.0),
                                            (False, 80.0)])
def test_boundary_tables_match_jax(rng, is_call, strike):
    """Tables from JAX-made fits.  The strike-80 put has empty-ITM steps
    (dead fits), whose sentinels must come through exactly; finite entries
    agree to rtol 1e-5 (exp, log and sqrt may round one ulp apart)."""
    maturity = N_STEPS * DT
    noise = shared_noise(rng, CHUNK, N_STEPS)
    paths, fits = jax_pilot_fits(noise, strike, maturity, is_call)
    if strike == 80.0:
        assert not (np.asarray(paths)[:, 1] < strike).any()
    tfits = to_port_fits(fits)
    jtab = np.asarray(jpp.boundary_rows(fits, KW["r"], strike, maturity, DT,
                                        N_STEPS, is_call))
    ttab = pc.boundary_rows(tfits, KW["r"], strike, maturity, DT, N_STEPS,
                            is_call).numpy()
    jlog = np.asarray(jpp.log_boundary_rows(jnp.asarray(jtab)))
    tlog = pc.log_boundary_rows(torch.tensor(jtab)).numpy()
    for got, want in ((ttab, jtab), (tlog, jlog)):
        assert got.shape == want.shape == (8, pc._round_up(N_STEPS, 128))
        sentinel = np.abs(want) >= 1e30
        np.testing.assert_array_equal(got[sentinel], want[sentinel])
        np.testing.assert_allclose(got[~sentinel], want[~sentinel],
                                   rtol=1e-5, atol=1e-6)
    ex0_j, p0_j = jpp.time0_value(fits, KW["s0"], strike, is_call)
    ex0_t, p0_t = pc.time0_value(tfits, KW["s0"], strike, is_call)
    assert bool(ex0_t) == bool(ex0_j) and p0_t == p0_j


def test_pathgen_from_noise_ref_matches_jax(rng):
    """rtol 2e-4: the fGN product and the log-price sum run in another
    float32 order than the TPU kernel's matmuls."""
    noise = shared_noise(rng, CHUNK, N_STEPS)
    gen, _ = jpp.make_pallas_pathgen_from_noise(
        **KW, n_steps=N_STEPS, dt=DT, chunk_paths=CHUNK, block_paths=256,
        interpret=True, fgn_form="chol")
    want = np.asarray(gen(jnp.asarray(noise)))
    consts = consts_cpu()
    got = pc.pathgen_from_noise_ref(consts, port_noise(noise, N_STEPS))
    assert got.shape == (CHUNK, N_STEPS + 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4)
    # The wrapper takes the plain version for CPU tensors.
    np.testing.assert_array_equal(
        pc.pathgen(consts, noise=port_noise(noise, N_STEPS)).numpy(),
        got.numpy())


@pytest.mark.parametrize("is_call,strike", [(False, 102.0), (True, 98.0)])
def test_priced_chunk_ref_matches_jax(rng, is_call, strike):
    """Chunk payoff sums on shared noise under the same fit: rtol 1e-4
    (a decision can flip only inside the float32 root band)."""
    maturity = N_STEPS * DT
    _, fits = jax_pilot_fits(shared_noise(rng, CHUNK, N_STEPS), strike,
                             maturity, is_call)
    noise = shared_noise(rng, CHUNK, N_STEPS)
    chunk_sum, _ = jpp.make_pallas_priced_chunk(
        **KW, strike=strike, maturity=maturity, dt=DT, n_steps=N_STEPS,
        chunk_paths=CHUNK, block_paths=256, is_call=is_call, interpret=True,
        noise_input=True, fgn_form="chol", policy_form="boundary")
    jrows = jpp.log_boundary_rows(jpp.boundary_rows(
        fits, KW["r"], strike, maturity, DT, N_STEPS, is_call))
    want = float(chunk_sum(jnp.asarray(noise), jrows))
    table = pc.log_boundary_rows(pc.boundary_rows(
        to_port_fits(fits), KW["r"], strike, maturity, DT, N_STEPS, is_call))
    consts = consts_cpu()
    got = float(pc.priced_chunk_from_noise_ref(
        consts, table, port_noise(noise, N_STEPS), strike, is_call))
    assert want > 0
    np.testing.assert_allclose(got, want, rtol=1e-4)
    wrapped = pc.priced_chunk(consts, table, strike, is_call,
                              noise=port_noise(noise, N_STEPS))
    assert float(wrapped) == got


def test_philox_known_answer():
    """Random123's philox4x32_10 vector at zero counter and zero key."""
    z = torch.zeros((), dtype=torch.int64)
    got = [int(v) for v in pc.philox4x32_10(z, z, z, z, 0, 0)]
    assert got == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]


def test_philox_normals_moments_and_streams():
    """Standard normal moments within 5 sigma of their sampling error;
    distinct stream words give uncorrelated, different planes; a row
    window equals the same rows of the whole block."""
    rows, n = 4096, 33
    a = pc.philox_normals_ref(pc._fold_words(77, 0), rows, n).double()
    b = pc.philox_normals_ref(pc._fold_words(77, 1), rows, n).double()
    m = a.numel() / 2
    for plane in a:
        assert abs(float(plane.mean())) < 5 / m ** 0.5
        assert abs(float(plane.var()) - 1.0) < 5 * (2 / m) ** 0.5
        assert abs(float(((plane - plane.mean()) ** 4).mean())
                   / float(plane.var()) ** 2 - 3.0) < 0.2
    corr_nw = float(torch.corrcoef(a.reshape(2, -1))[0, 1])
    corr_ab = float(torch.corrcoef(torch.stack(
        [a[0].flatten(), b[0].flatten()]))[0, 1])
    assert abs(corr_nw) < 5 / m ** 0.5 and abs(corr_ab) < 5 / m ** 0.5
    assert not torch.equal(a, b)
    window = pc.philox_normals_ref(pc._fold_words(77, 0), 64, n, row0=128)
    assert torch.equal(window, a[:, 128:192].float())


def test_block_limits():
    """The card's shared-memory model: the bench horizon takes the 64-path
    block, longer horizons smaller blocks, then none."""
    assert pc.max_block_paths(365) == 64
    assert pc.range_smem_bytes(365, 64) <= pc.SMEM_LIMIT
    assert pc.max_block_paths(800) == 32
    assert pc.max_block_paths(1500) == 16
    assert not pc.supports(2000)
