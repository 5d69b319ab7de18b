"""The FFT plan and the segmented running sum of K8/K9
(``csrc/pathgen_factored.cu``), mirrored in numpy and held against the
port's plain versions and JAX's factored stages on the same noise, plus the
kernels' memory model.

The mirrors follow the kernel's own indices: one block's Re and Im planes
as flat float32 arrays (row r at ``row_off(r)``), stage 1 as eight lanes a
row (a radix-16 DFT over k1 = t + 8u, the inner twiddle W_128^(t v), the
exchange at ``xpos(v) + t``, a radix-8 DFT for v = t and v = t + 8, the
twiddle fused into the store), stage 2 as lane pairs of N2/2-point DFTs
over the even and odd k2 with one exchange, every DFT radix-2 decimation
in frequency with its bit-reversed output read through ``brev``, and the
roots taken from the host tables as the kernel takes them.  A layout or
index fault in the plan shows here as a wrong x; the card tests hold the
kernel itself against the plain versions."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlooptionspricer_tpu.models import pathgen_pallas_factored as jf
from montecarlooptionspricer_tpu_torch.models import pathgen_cuda as pc
from montecarlooptionspricer_tpu_torch.models import (
    pathgen_factored_cuda as pfc)
from montecarlooptionspricer_tpu_torch.ops import fgn as tfgn

from test_torch_factored import consts_cpu, factored_noise
from test_torch_pathgen import DT, KW

LANE = pfc.LANE
RS = pfc.ROW_STRIDE
ROWS = pfc.STAGE1_ROWS
F32 = np.float32


def row_off(r):
    return r * RS + ((r & 2) << 2)


def xpos(v):
    return 9 * (v & 7)


def brev(k, n):
    r, b = 0, 1
    while b < n:
        r, k, b = (r << 1) | (k & 1), k >> 1, b << 1
    return r


def fft_dif(re, im, wr, wi, stride):
    """The kernel's fft_dif on [N, ...] float32 arrays (in place): radix-2
    decimation in frequency, W_N^e = (wr[e stride], wi[e stride]), the
    roots 1 and -i exact; X[k] ends in element brev(k, N)."""
    n = re.shape[0]
    h = n // 2
    while h >= 1:
        for b in range(0, n, 2 * h):
            for j in range(h):
                i0, i1 = b + j, b + j + h
                dr, di = re[i0] - re[i1], im[i0] - im[i1]
                re[i0] = re[i0] + re[i1]
                im[i0] = im[i0] + im[i1]
                e = j * (n // (2 * h))
                if e == 0:
                    re[i1], im[i1] = dr, di
                elif 4 * e == n:
                    re[i1], im[i1] = di, -dr
                else:
                    c, s = wr[e * stride], wi[e * stride]
                    re[i1], im[i1] = dr * c - di * s, dr * s + di * c
        h //= 2


def mirror_x(consts, noise):
    """[rows, n] half-scaled fGN increments of [3, rows, m2] float32 noise
    through the kernel's plan, block by block (P = 64 / N2 paths)."""
    n, n2 = consts.n_steps, consts.m2 // LANE
    p_blk = ROWS // n2
    rows = noise.shape[1]
    assert rows % p_blk == 0
    t_ = lambda x: x.numpy().astype(F32)                     # noqa: E731
    phr, phi = t_(consts.phi_r), t_(consts.phi_i)            # [n2, 128]
    twr, twi = t_(consts.tw_r), t_(consts.tw_i)
    rtr, rti = t_(consts.f1r)[1], t_(consts.f1i)[1]          # W_128^e
    w2r, w2i = t_(consts.c2)[1], -t_(consts.s2)[1]           # W_N2^e
    out = np.empty((rows, n), F32)
    t = np.arange(8)
    rr = np.arange(ROWS)
    offs = np.array([row_off(r) for r in rr])                # [64]
    for b0 in range(0, rows, p_blk):
        plane_r = np.full(ROWS * RS + 8, np.nan, F32)
        plane_i = np.full(ROWS * RS + 8, np.nan, F32)
        # a = Z * phi' into the rows, storage column 128 k2 + k1.
        zr = noise[0, b0:b0 + p_blk].reshape(ROWS, LANE)
        zi = noise[1, b0:b0 + p_blk].reshape(ROWS, LANE)
        pr, pi = np.tile(phr, (p_blk, 1)), np.tile(phi, (p_blk, 1))
        cols = offs[:, None] + np.arange(LANE)[None, :]
        plane_r[cols] = zr * pr - zi * pi
        plane_i[cols] = zr * pi + zi * pr
        # Stage 1: lane t of row r holds k1 = t + 8 u.
        u = np.arange(16)
        idx = offs[None, :, None] + t[None, None, :] + 8 * u[:, None, None]
        xr, xi = plane_r[idx], plane_i[idx]                  # [16, 64, 8]
        fft_dif(xr, xi, rtr, rti, 8)
        for v in range(1, 16):                               # W_128^(t v)
            e = (t * v) & (LANE - 1)
            c, s = rtr[e], rti[e]
            yr, yi = xr[brev(v, 16)], xi[brev(v, 16)]
            xr[brev(v, 16)], xi[brev(v, 16)] = yr * c - yi * s, yr * s + yi * c
        # The exchange, v < 8 then v >= 8, through the row's own floats.
        ex = offs[None, :, None] + np.arange(8)[:, None, None]   # + s
        halves = []
        for h in range(2):
            for v in range(8 * h, 8 * h + 8):
                at = offs[:, None] + xpos(v) + t[None, :]
                plane_r[at], plane_i[at] = xr[brev(v, 16)], xi[brev(v, 16)]
            halves.append((plane_r[ex + xpos(t)], plane_i[ex + xpos(t)]))
        (ur, ui), (vr, vi) = halves
        fft_dif(ur, ui, rtr, rti, 16)
        fft_dif(vr, vi, rtr, rti, 16)
        k2 = rr % n2
        for w in range(8):
            for m_of_t, (sr, si) in ((t + 16 * w, (ur, ui)),
                                     (t + 8 + 16 * w, (vr, vi))):
                a_r, a_i = sr[brev(w, 8)], si[brev(w, 8)]    # [64, 8]
                tr = twr[k2[:, None], m_of_t[None, :]]
                ti = twi[k2[:, None], m_of_t[None, :]]
                at = offs[:, None] + m_of_t[None, :]
                plane_r[at] = a_r * tr - a_i * ti
                plane_i[at] = a_r * ti + a_i * tr
        # Stage 2: lane pair (2c, 2c + 1) of column c of path pl.
        nh = n2 // 2
        pl = np.arange(p_blk)[:, None, None]
        c = np.arange(LANE)[None, :, None]
        e = np.arange(2)[None, None, :]
        q = np.arange(nh)
        rows_q = pl * n2 + 2 * q[:, None, None, None] + e     # [nh,P,1,2]
        at = np.vectorize(row_off)(rows_q) + c
        xr2, xi2 = plane_r[at], plane_i[at]                  # [nh,P,128,2]
        fft_dif(xr2, xi2, w2r, w2i, 2)
        x_out = np.empty((n2, p_blk, LANE), F32)
        for j in range(nh):
            k = brev(j, nh)
            tj = xr2[k] * w2r[j] - xi2[k] * w2i[j]
            mine = np.where(e[0] == 1, tj, xr2[k])           # [P,128,2]
            other = mine[..., ::-1]
            x_out[j] = (mine + other)[..., 0]
            x_out[j + nh] = (other - mine)[..., 1]
        steps = x_out.transpose(1, 0, 2).reshape(p_blk, n2 * LANE)
        out[b0:b0 + p_blk] = steps[:, :n]
    return out


# ---------------------------------------------------------------------------
# The FFT plan.

def test_fft_dif_is_the_dft():
    """fft_dif with exact roots, read through brev, is the DFT (float64 to
    1e-12) for every length the kernel runs: 1 to 32 (stage 2's halves),
    8 and 16 (stage 1)."""
    rng = np.random.default_rng(3)
    for n in (1, 2, 4, 8, 16, 32):
        x = rng.normal(size=(n, 5)) + 1j * rng.normal(size=(n, 5))
        w = np.exp(-2j * np.pi * np.arange(max(n, 1)) / max(n, 1))
        re, im = x.real.copy(), x.imag.copy()
        fft_dif(re, im, w.real, w.imag, 1)
        got = np.stack([re[brev(k, n)] + 1j * im[brev(k, n)]
                        for k in range(n)])
        np.testing.assert_allclose(got, np.fft.fft(x, axis=0), rtol=0,
                                   atol=1e-12 * n)


def test_layout_rows_and_exchange_stay_apart():
    """Each row's data (128 floats) and its stage-1 exchange (up to
    xpos(7) + 7) end before the next row starts; the planes hold 64
    rows; and the bank arithmetic of the source's note holds: the stage-1
    exchange reads 9 t + s over four rows of a warp cover 32 banks, and
    stage 2's two parities sit 16 banks apart."""
    top = max(xpos(v) + 7 for v in range(16))
    assert top < LANE
    for r in range(ROWS - 1):
        assert row_off(r) + max(top, LANE - 1) < row_off(r + 1)
    assert row_off(ROWS - 1) + LANE <= ROWS * RS + 8
    for r0 in range(0, ROWS, 4):
        banks = {(row_off(r0 + i) + 9 * t) % 32 for i in range(4)
                 for t in range(8)}
        assert len(banks) == 32
    for q in range(ROWS // 2):
        assert (row_off(2 * q + 1) - row_off(2 * q)) % 32 == 16


@pytest.mark.parametrize("n_steps,rows", [(129, 64), (200, 32), (400, 16),
                                          (1000, 8), (1825, 8), (4000, 2),
                                          (8192, 1)])
def test_fft_plan_matches_spectral_synthesis(n_steps, rows):
    """The mirror of the kernel's plan against the reference spectral
    synthesis (``fgn_from_noise_ref``: the logical permutation, then
    ``fgn.spectral_synthesis``) and the dense four-step split
    (``four_step_x``) on the same noise, for every N2 from 2 to 64: within
    2e-6 of the increments' largest magnitude (float32 FFT against float32
    and float64-rounded sums; the dense split itself reads 1e-6 apart)."""
    consts = consts_cpu(n_steps)
    noise = factored_noise(np.random.default_rng(n_steps), rows, n_steps)
    got = mirror_x(consts, noise)
    t_noise = torch.from_numpy(noise)
    for ref in (pfc.fgn_from_noise_ref(consts, t_noise),
                pfc.four_step_x(consts, t_noise)):
        ref = ref.numpy()
        scale = np.max(np.abs(ref))
        np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6 * scale)


@pytest.mark.parametrize("n_steps,rows", [(129, 32), (200, 32), (400, 16),
                                          (1825, 4)])
def test_fft_plan_matches_jax_stages(n_steps, rows):
    """The mirror against JAX's own stages, ``_stage1`` (a @ F1 and the
    twiddle) then ``_stage2_tile`` for each step tile, on the same seeded
    noise (k2-major planes): within 2e-6 of the largest increment."""
    consts = consts_cpu(n_steps)
    noise = factored_noise(np.random.default_rng(7 + n_steps), rows,
                           n_steps)
    got = mirror_x(consts, noise)
    _, m2, n2, jc, _, _ = jf._consts(KW["s0"], KW["xi"], KW["h"], KW["eta"],
                                     0.0, KW["r"], n_steps, DT, jnp.float32)
    zr3 = jnp.asarray(noise[0].reshape(rows, n2, LANE).transpose(1, 0, 2))
    zi3 = jnp.asarray(noise[1].reshape(rows, n2, LANE).transpose(1, 0, 2))
    sr, si = jf._stage1(zr3, zi3, *jc, jnp.float32)
    want = np.concatenate(
        [np.asarray(jf._stage2_tile(sr, si, jnp.int32(j), n2=n2, block=rows))
         for j in range(-(-n_steps // LANE))], axis=1)[:, :n_steps]
    scale = np.max(np.abs(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6 * scale)


# ---------------------------------------------------------------------------
# Pass B: the segmented running sum and the first hit.

def warp_scan_tile(v):
    """The kernel's tile scan of [members, 128] float32 increments: lane
    prefix p1..p4, a Hillis-Steele warp scan of p4, the exclusive lane
    base; returns (the lane's base excl [members, 32], p [members, 32, 4],
    the tile total [members])."""
    v = v.reshape(v.shape[0], 32, 4)
    p = np.cumsum(v, axis=2, dtype=F32)      # p1 .. p4, each rounded
    s = p[:, :, 3].copy()
    off = 1
    while off < 32:
        y = np.zeros_like(s)
        y[:, off:] = s[:, :-off]
        s = s + y
        off *= 2
    excl = np.zeros_like(s)
    excl[:, 1:] = s[:, :-1]
    return excl, p, s[:, 31]


def pass_b_mirror(inc, log_s0, table, strike, is_call, n2, with_cv,
                  quadratic, cv_disc):
    """The kernel's pass B on [rows, n] float32 increments: kWarps / P
    segments of whole tiles a path or pair member (one where P >= 8; the
    pairing does not change them), segment sums exchanged,
    each segment scanned from the earlier ones' sum, its first hit, the
    earliest segment's hit per member, the last segment's terminal under
    CV.  Returns the payoff sum (and the control sum)."""
    rows, n = inc.shape
    p_blk = ROWS // n2
    wpm = 1 if p_blk >= 8 else 8 // p_blk
    s_pad = -(-n // LANE) * LANE
    n_tiles = s_pad // LANE
    tps = -(-n_tiles // wpm)
    v = np.zeros((rows, s_pad), F32)
    v[:, :n] = inc
    tab = table.numpy().astype(F32)
    val = np.zeros(rows, F32)
    hit = np.zeros(rows, bool)
    term = np.zeros(rows, F32)
    seg_sums = []
    for seg in range(wpm):
        t0 = min(seg * tps, n_tiles)
        t1 = min(t0 + tps, n_tiles)
        tot = np.zeros(rows, F32)
        for t in range(t0, t1):
            q = v[:, t * LANE:(t + 1) * LANE].reshape(rows, 32, 4)
            tot = tot + ((q[:, :, 0] + q[:, :, 1]) + (q[:, :, 2] + q[:, :, 3])
                         ).sum(axis=1, dtype=F32)
        seg_sums.append((t0, t1, tot))
    for seg, (t0, t1, _) in enumerate(seg_sums):
        carry = np.zeros(rows, F32)
        for s in range(seg):
            carry = carry + seg_sums[s][2]
        seg_hit = np.zeros(rows, bool)
        for t in range(t0, t1):
            excl, p, total = warp_scan_tile(v[:, t * LANE:(t + 1) * LANE])
            base = carry[:, None] + excl
            ls = (F32(log_s0) + (base[:, :, None] + p)).reshape(rows, LANE)
            carry = carry + total
            cols = t * LANE + np.arange(LANE)
            ok = cols < n
            cc = np.minimum(cols, n - 1)
            if quadratic:
                s_ = np.exp(ls)
                c0, c1, c2, mu, sd, eps, dsc, k = tab[:, cc]
                pay = np.maximum(s_ - k if is_call else k - s_, F32(0))
                z = (s_ - mu) / sd
                cont = (c2 * z + c1) * z + c0
                ex = ok & (pay > eps) & (pay >= cont)
                worth = pay * dsc
            else:
                ex = ok & (ls >= tab[0, cc]) & (ls <= tab[1, cc])
                st = np.exp(ls)
                worth = tab[2, cc] * np.maximum(
                    st - F32(strike) if is_call else F32(strike) - st, F32(0))
            first = np.argmax(ex, axis=1)
            new = ex.any(axis=1) & ~seg_hit
            pick = new & ~hit
            val[pick] = worth[pick, first[pick]]
            hit |= pick
            seg_hit |= ex.any(axis=1)
        if seg == wpm - 1:
            term = np.exp(F32(log_s0) + carry)
    total = F32(val.sum(dtype=np.float64))
    if not with_cv:
        return total
    return total, F32(cv_disc * term.sum(dtype=np.float64))


def _hit_table(n, hits, quadratic, is_call):
    """A policy table that exercises exactly at steps ``hits``: log bounds
    (-inf, +inf) there and an empty interval elsewhere, or a policy_rows
    table whose eps is +inf except there, with the continuation -1e30."""
    if quadratic:
        tab = torch.zeros((8, n), dtype=torch.float32)
        tab[0] = -1e30
        tab[4] = 1.0
        tab[5] = float("inf")
        tab[6] = 0.97
        tab[7] = 120.0 if not is_call else 80.0
        for h in hits:
            tab[5, h] = -1.0
        return tab
    tab = torch.empty((3, n), dtype=torch.float32)
    tab[0], tab[1], tab[2] = 1.0, -1.0, 0.97
    for h in hits:
        tab[0, h], tab[1, h] = -float("inf"), float("inf")
    return tab


@pytest.mark.parametrize("n_steps", [400, 1825, 4000])
@pytest.mark.parametrize("hits", [(0,), ("last",), (1023,), (1024,),
                                  (2047, 3072), (), (1024, 2048, 3072)])
@pytest.mark.parametrize("form", ["plain", "cv", "quad", "quad/cv"])
def test_pass_b_mirror_matches_priced_sums(n_steps, hits, form):
    """The segmented scan and first hit against ``priced_sums`` (the
    plain versions' cumsum and argmax) on seeded random increments and
    forced hits: at step 0, at n - 1, at the last step of a segment and
    the first of the next (1023, 1024 at 1825 and 4000 steps), in two
    segments (the earlier wins), at the first step of every later
    segment, and nowhere; the boundary and quadratic policies, plain and
    CV (a pair member is segmented as the unpaired path).  Sums within
    1e-5 relative (float32 running sums in two associations)."""
    cv, quad = "cv" in form, "quad" in form
    consts = consts_cpu(n_steps)
    n2 = consts.m2 // LANE
    if hits == ("last",):
        hits = (n_steps - 1,)
    hits = tuple(h for h in hits if h < n_steps)
    members = ROWS // n2
    rng = np.random.default_rng(n_steps + len(hits))
    inc = (rng.normal(size=(2 * members, n_steps)) * 0.01
           - 1e-4).astype(F32)
    is_call = quad and n_steps == 400
    table = _hit_table(n_steps, hits, quad, is_call)
    strike = 100.0
    log_s0 = float(np.log(np.float32(KW["s0"])))
    got = pass_b_mirror(inc, log_s0, table, strike, is_call, n2, cv, quad,
                        pc.cv_discount(consts))
    ls = torch.from_numpy(log_s0 + np.cumsum(inc.astype(np.float64), axis=1)
                          ).to(torch.float32)
    want = pc.priced_sums(consts, ls, table, strike, is_call, cv,
                          "quadratic" if quad else "boundary")
    got, want = (got, want) if cv else ((got,), (want,))
    for g, w in zip(got, want):
        w = float(w)
        assert abs(float(g) - w) <= 1e-5 * max(abs(w), 1.0), (g, w)
    if not hits:
        assert float(want[0]) == 0.0 == float(got[0])


# ---------------------------------------------------------------------------
# The memory model.

def test_factored_fft_memory_model():
    """Every N2 from 2 to 64 takes 64 stage-1 rows (P = 64 / N2 paths) in
    95,808 bytes (K8), 99,904 (the boundary forms, two tiles of rows
    staged) or 108,096 (the quadratic ones, one tile of eight rows), two
    blocks an SM by shared memory (1 KB of it reserved a block); 8,192
    steps is the range, N2 = 128 being past one path a block."""
    sm = 233_472
    for n2 in (2, 4, 8, 16, 32, 64):
        m2 = n2 * LANE
        assert pfc.paths_per_block(m2) * n2 == ROWS
        assert pfc.smem_bytes(m2, "path") == 95_808
        assert pfc.smem_bytes(m2, "boundary") == 99_904
        assert pfc.smem_bytes(m2, "quadratic") == 108_096
        assert pfc.smem_bytes(m2) == 108_096
        for policy in ("path", "boundary", "quadratic"):
            assert sm // (pfc.smem_bytes(m2, policy) + 1024) == 2
    assert pfc.max_factored_steps() == 8192
    assert pfc.supports(8192) and not pfc.supports(8193)
    assert tfgn.next_pow2(8193) // LANE > pfc.MAX_N2
