#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Builds the port's CUDA kernels from the sources in this checkout (one nvcc
per build unit, all started together; the ``build`` line gives each
unit's seconds) and, beside them, its native host engine with the host
C++ compiler (``host_build_s``), holds each kernel against its plain PyTorch version at
its path's shapes, and drives full-width
fit-then-stream runs through the kernels, each with the launch counts set
to 0 just before it and read just after:

* the main path, 1e7 paths x 365 steps (the bench.py workload), through
  the single-tile kernels K1 and K2, checked against the same seed through
  the plain versions;
* the strike chain of the same expiry, 21 strikes from 75 to 125, through
  K1 once and the chain kernel K5 per chunk (``chain_price``), checked
  against the plain versions on its first 8 chunks under the same fits;
* the pathwise Greeks of the bench option through K3 (``greeks``) and of
  the strip through K4 (``chain_greeks``), each price lane checked against
  the prices above;
* the long horizon, 1e7 paths x 1825 steps (the reference's longest), through
  the step-tiled kernels K6 and K7, checked against the plain versions on
  its first 8 chunks under the same fit;
* the same horizon on the factored-DFT kernels K8 and K9 (the spectral
  law, ``tiled_impl="factored"``, ``price_factored``), also streamed under
  the fits of the K6 pilot and held within 5 combined stderr of K7's price;
* 1e7 paths x 4000 steps (``price_xlong``), past the slab's range, through
  K8 once and K9 76 times, checked against the plain versions on its first
  8 chunks under the same fit;
* the estimators: each of the three forms of K2, K7 and K9 (antithetic,
  control variate, both) against its plain version on the seeded stream
  and on noise, paired against unpaired on the negated noise
  (``k2_forms`` at 365 steps, ``k7_forms`` at 1825, ``k9_forms`` at 4000),
  then nine full-width prices, one per form and horizon (``price_anti``,
  ``price_cv``, ``price_anti_cv`` at 365 steps, ``price_long_anti``,
  ``price_long_cv``, ``price_long_vr`` at 1825, ``price_xlong_anti``,
  ``price_xlong_cv``, ``price_xlong_vr`` at 4000), each through the plain
  pilot kernel once and its form 76 times, its first 8 chunks checked
  against the plain versions under the same fits (and beta and centre),
  and its price held within 5 combined stderr of the plain estimator's
  price of the same seed, with the variance ratio (se_plain / se)^2 > 1;
* the pair forms of the chain and Greeks kernels: K5/anti, K3/anti and
  K4/anti against their plain versions and their unpaired forms on the
  negated noise (``k5_anti``, ``k3_k4_anti``), then the paired strip
  (``chain_anti``: K1, one batched fit, K5/anti 76 times, its first 8
  chunks against the plain versions, strike 105 within 5 combined stderr
  of ``price_anti``, each strike's variance ratio against the plain
  strip) and the paired Greeks of the bench option and the strip
  (``greeks_anti``, ``chain_greeks_anti``: K1 and K3/anti or K4/anti 76
  times, price lanes against ``chain_anti``);
* K5 and K5/anti past the single tile, at 400 and 512 steps, against
  their plain versions (``chain_past_tile``);
* the generic path stream, which launches no kernel: the strip at 1825
  steps, plain and paired, on CHAIN_STREAM_CHUNKS chunks (``chain_stream``,
  strike 105 within 5 combined stderr of ``price_long``), 10,000 steps,
  past K8, on
  the FFT synthesis against the matmul synthesis on the same noise and
  fits (``stream_xlong``), and a cubic policy at 365 steps against its
  fits on independent plain K1 paths (``stream_poly3``);
* the streamed duality bounds (``price_with_bounds``) and the whole-path
  pair forms they stream under ``antithetic``: K1/anti, K6/anti and
  K8/anti against their plain versions (seeded and on noise) and against
  their unpaired forms on [X; -X] (``path_pair_forms``, timed beside their
  bounds and yardsticks), then the bracket of the bench option at full
  width, plain and paired, its lower bound held against ``price`` on the
  same seed (``bounds``: K1 once and K1 or K1/anti 76 times, no priced
  kernel), the bracket at 1825 steps on K6/K6-anti and at 4000 steps on
  K8/K8-anti cut to 16 chunks (``bounds_long``), and the GBM-limit bracket
  around the binomial American value (``bounds_gbm``);
* the spectral fGN form (``fgn_form="spectral"``: three noise planes and
  the dense X = Zr @ Cr' - Zi @ Ci'), on every kernel that has it:
  ``spectral_forms`` holds K1 and K2 (365 steps), K5 (365 steps, 21
  strikes), K6 and K7 (1825 steps) in each of their forms against their
  plain versions, seeded and on noise, and each pair form against its
  unpaired form on [X; -X], timed beside the two-product yardstick and
  the dense bound; ``price_spectral`` prices 1e7 x 365 through K1/spectral
  once and K2/spectral 76 times, its first 8 chunks against the plain
  versions and the price within 5 combined stderr of the chol ``price``;
  ``price_spectral_vr_{anti,cv,anti_cv}`` its three estimator forms, each
  with its variance ratio; ``chain_spectral`` the 21-strike strip at full
  width, plain and paired (strike 105 within 5 combined stderr of
  ``price_spectral``), and at 400 steps on the K8 pilot with K5/spectral
  (cut to 16 chunks) against K8/K9's single-strike price;
  ``price_spectral_slab`` 1e7 x 1825 on K6/K7 spectral
  (``tiled_impl="slab"``) within 5 combined stderr of ``price_factored``
  (the same law), and its estimator forms cut to 16 chunks
  (``price_spectral_slab_{anti,cv,anti_cv}``); ``bounds_spectral`` the
  bench bracket on K1/spectral and K1/spectral/anti, its lower bound held
  against ``price_spectral``, and the slab's paired bracket at 1825 steps
  cut to 16 chunks;
* the quadratic exercise-policy forms (``policy_form="quadratic"`` on K2,
  K7 and K9, ``chain_policy_form="quadratic"`` on K5): ``quadratic_forms``
  holds each of the 12 forms (K2/quad, K2/quad/cv and their spectral
  forms at 365 steps, K7's likewise at 1825, K9/quad and K9/quad/cv at
  4000, K5/quad and K5/spectral/quad on the 21 strikes at 365) against
  its plain version, seeded and on noise, timed beside its boundary
  row's yardstick and its bound; ``price_quadratic`` prices 1e7 x 365
  through K1 once and K2/quad 76 times, within 1e-4 of ``price`` on the
  same seed, its first 8 chunks against the plain versions, and its
  bounds' lower side (K1 77 times) within 1e-5 of it;
  ``price_quadratic_cv`` within 1e-4 of ``price_cv``;
  ``price_quadratic_{spectral,long,slab,factored}[_cv]``, cut to 16
  chunks, within 5 combined stderr of a price of the same law; and
  ``chain_quadratic`` the strip at 365 steps, chol and spectral (76
  chunks), and at 400 on the K8 pilot (16 chunks), each strike within
  1e-4 of the boundary strip under the same fits, or within 5 combined
  stderr.  Each checks that only the quadratic forms launched;
* the bf16 fGN-input forms (``fgn_matmul_dtype="bfloat16"``, the tensor
  cores' product): ``bf16_forms`` holds K1/bf16 and K2/bf16 at 365 steps,
  K6/bf16 and K7/bf16 at 1825, in each of their forms against their plain
  versions (paths 2e-4 and 10x closer to the bf16 plain version than to
  the float32 one; sums 1e-4), seeded and on noise, pairs against [X; -X],
  timed beside the bf16 product's yardstick and the bound;
  ``price_bf16`` prices 1e7 x 365 through K1/bf16 once and K2/bf16 76
  times, within 1e-4 of its plain versions and 5 combined stderr of
  ``price``; ``price_bf16_long`` 1e7 x 1825 through K6/bf16 and K7/bf16,
  its first 16 chunks against the plain versions, within 5 combined
  stderr of ``price_long``; ``price_bf16[_long]_{anti,cv,anti_cv}`` and
  ``price_bf16[_long]_bounds_anti`` run each estimator form and the
  paired bounds (K1/bf16/anti, K6/bf16/anti) on 16 chunks;
* the bf16 forms of K8/K9, of the spectral bodies of K1/K2 and K6/K7,
  and of the quadratic bodies of K2/K7/K9 (``bf16_later_phases``):
  ``bf16_factored_forms`` (K8/bf16 and its pair at 1825 and 4000 steps,
  paths 5e-4 and 10x closer to the bf16 plain version, the four-step
  split, than to the float32 FFT; K9/bf16's four boundary forms at 4000),
  ``bf16_spectral_forms`` (K1/K2 at 365, K6/K7 at 1825, every form),
  ``bf16_quadratic_forms`` (K2 and K7 chol and spectral, K9), each
  against its plain version and timed; the prices ``price_bf16_xlong``
  (1e7 x 4000 through K8/bf16 once and K9/bf16 76 times, its first 8
  chunks against the plain versions, within 5 combined stderr of
  ``price_xlong``), ``price_bf16_spectral`` (1e7 x 365, within 5
  combined stderr of ``price_spectral``), ``price_bf16_spectral_slab``
  (1825, 16 chunks) and ``price_bf16_quadratic`` (1e7 x 365 within 1e-4
  of ``price_bf16`` on the same seed), each family's estimator forms
  (``..._anti``, ``..._cv``, ``price_bf16_xlong_vr`` and
  ``..._anti_cv``), paired bounds (``..._bounds_anti``) and quadratic
  runs (``..._quadratic[_cv]``, ``price_bf16_quadratic_long[_cv]``) on 16
  chunks under the policy of the same pilot, each launching only its
  bf16 forms;
* the bf16 forms of K5 and K3/K4 (``bf16_chain_greeks_phases``):
  ``chain_bf16`` (the 21-strike strip at 1e7 x 365 through K1/bf16 once
  and K5/bf16 76 times, ``chain_price``'s checks but the fit count,
  strike 105 within 5 combined stderr of the float32 strip and 2 stderr
  of ``price_bf16``), ``bf16_chain_forms`` (the six K5/bf16 forms at 365
  steps, plain and paired at 512, seeded and noise-in against their plain
  versions, sums 1e-4 and 10x closer to the bf16 plain version than to
  the float32 one, pairs against [X; -X]),
  the other K5/bf16 forms' strips on 16 chunks under their pilot's fits
  (``chain_bf16_{anti,quadratic,spectral_anti,spectral_quadratic}``),
  ``chain_bf16_spectral`` (400 steps on K8/bf16 and K5/bf16/spectral, 16
  chunks, beside a single-strike K8/K9 bf16 price), ``bf16_greeks_forms``
  (K3/bf16, K4/bf16 and their pairs against their plain versions, 2e-4
  of each Greek's scale), ``greeks_bf16`` (K1/bf16 once and K3/bf16 76
  times, the price lane within 1e-4 of ``price_bf16``, each Greek within
  5 combined stderr of the float32 ``greeks``), ``chain_greeks_bf16``
  (K4/bf16 76 times) and the pairs' Greeks on 16 chunks
  (``greeks_bf16_anti``, ``chain_greeks_bf16_anti``), each launching only
  its bf16 forms;
* P1 (``roofline``): the normals probe in its four variants and the
  matmul probe in float32 and bf16, on the identity and a random
  orthogonal B, against their plain versions, then the card's rates
  (normals, exp, FMA, and the slab's tile product's multiply-adds in
  float32 and bf16), each probe again against its plain version at the
  shapes the rates come from, the library yardsticks, and each of
  K1/K2/K6/K7 (float32 and bf16) beside its P1 ceiling;
* the native host engine (``host_engine``, ``csrc/host/``, no kernel of
  the card): ``estimate_params``, the DFA Hurst estimate and the 20-day
  vol and momentum against their NumPy plain versions on seeded
  histories of 2, 21, 60, 400, 1260 and 1825 points (1e-12 relative, H
  1e-9), with the µs of one row's features, native and plain, at each
  size; ``read_table`` against ``read_table_plain`` on
  ``prediction_gen``'s option and spot CSVs, equal as lists, each timed;
  the host build's seconds;
* the PredictionGen pipeline (``prediction_gen``), plain PyTorch on the
  card, where no kernel of the port lies (every launch count must stay
  0), its host pass (the CSVs, each row's parameters, vol and momentum)
  on the host engine: ``run_pipeline`` on a 256-row option CSV and a 2,600-day spot CSV
  made from the seed, 250 paths a row, 10 branches, 64 rows a batch,
  days to expiry over 7-1825 so every bucket n_pad 4..2048 runs, 8 rows
  planted to fail validation; the exit code, the rows, the header, the
  sentinels at exactly the planted rows, finite prices elsewhere, a
  resume of the output cut after 192 rows byte-equal to the one-shot
  run, one batch of 8 rows at n_pad 256 through
  ``BatchedPricer.price_from_noise`` on the card and on the host from one
  injected noise (each estimator within 1e-5 relative), and GBM paths
  through the row pricer's LSM within 10 % of the binomial American put
  and above Black-Scholes - 0.15; it prints the wall, rows/s, the host
  pass's and the device pass's seconds, and each bucket's batches and ms
  a batch;
* randomized QMC (``qmc=True``: a digitally shifted scrambled Sobol set,
  built on the card per chunk and fed to the kernels' noise-in entries):
  ``qmc_noise`` holds the QMC noise on the card against its host build and the
  card's float32 ndtri against float64; ``qmc_price`` (1e7 x 365, K2 76
  times on QMC noise, no path kernel: the pilot rides the generic
  stream's QMC generator), ``qmc_price_cv`` (K2/cv), ``qmc_fgn`` (the fGN
  planes in the Sobol set), ``qmc_price_long`` (1825 steps on K7),
  ``qmc_price_xlong`` (4000 on K9), the last four cut to 16 chunks, and
  ``qmc_chain`` (the strip on K5 at full width) each count one noise-in
  launch a chunk, hold chunk 0's kernel against its plain version, time
  the noise beside the kernel, and stream under the PRNG run's fits
  within 5 combined stderr of it, with the variance ratio per path (> 1
  at 365 steps); ``qmc_fallback`` checks that a configuration outside
  every noise-in kernel streams on the generic stream with a warning;
  ``qmc_prediction_gen`` runs ``--qmc`` on 128 of ``prediction_gen``'s
  rows, every bucket among them, and a resume byte-equal;
* the serving CLI and the jvp Greeks stream, plain PyTorch on the generic
  stream, which launch no kernel: ``serve`` feeds 40 mixed quotes (step
  buckets 8 and 32, strips of 2 and 3 strikes, Greeks every 5th), 2
  malformed lines and the bench strip (21 strikes, 365 live steps in
  bucket 512, 8 chunks) to the in-process ``mcop-price-torch --serve`` on
  the card, checks 9 pricers or first Greeks quotes built, 2 errors,
  every pricer's tensors on the card and no launch, holds the served
  strike 105 within 5 combined stderr of ``serve_reference`` (K1 + K5 on
  the Cholesky factor of the 512-step bucket's covariance, the law a
  server prices a 365-step quote in) and prints its distance from
  ``chain_price`` and each class's first and warm quote seconds;
  ``greeks_jvp`` streams the jvp Greeks of the bench option at 365 steps
  (16 chunks; each Greek within 5 combined stderr of ``greeks``, the
  price lane within 1e-5 of ``price_with_fit`` on the same fits) and at
  1825 steps (8 chunks; the price lane within 5 combined stderr of
  ``price_long``), with the seconds a chunk and the peak device bytes;
* the Bayesian meta-model, plain PyTorch, which launches no kernel: ``nn``
  trains it at its full width through ``mcop-train-nn-torch`` (65,536
  rows of synthetic features, 7 epochs across the warm-up, batch 256) and
  evaluates 8,192 rows through ``mcop-evaluate-nn-torch`` at 100 draws,
  plain and calibrated, and holds the card against the host: the eval
  forward, one masked batch's gradients and update, the NaN-batch skip,
  an epoch with no host sync, a resume against one run, the MC-dropout
  interval of one row; with s an epoch, ms and CUDA operators a step,
  rows/s, peak device bytes and the device's busy share;
* the multi-device forms (``parallel/``) over NCCL at a world of one, the
  machine's one card: ``mesh`` builds the mesh (a mesh of two raises),
  prices the bench option on 8 chunks under ``mesh=`` (K1 once, K2 8
  times, K2 on the rank-offset key against its plain version, the fit
  through the group equal to the bit to the fit without one, the price
  within 4 combined stderr of one device's), the strip on K5, the
  pipeline on 64 rows (its CSV byte-equal to one device's), one trainer
  epoch (equal to the bit), and a ``device_trace`` naming K2's kernel and
  the pipeline's ``price_batch`` span.

It also times K2 against K7 and K9 per chunk across horizons, in float32
and bf16 (the crossover that sets engine.SINGLE_TILE_MAX_STEPS and the
long-horizon family choice) and times each kernel and form (K8 and K9 at
1825 and 4000 steps).  Each K5 form is timed on one strike beside
the strip (``one_strike_ms``, ``sweep_ms``: the strike sweep's share),
each K4 form beside K3 of the same form (``k4_minus_k3_ms``), and each
K5, K3 and K4 entry of the kernels line carries the blocks one SM runs at
once (``blocks_per_sm``, the C entries' occupancy query); each K2 entry
carries its blocks per SM, the ms of K1 in the same fGN form, dtype and
pairing (``k1_ms``) and K5's one-strike ms in its form where K5 has it
(``k5_one_strike_ms``); each K1, K6, K7, K8 and K9 entry carries its
blocks per SM.
``python3 chip_smoke.py --k2-forms [ROOT]`` times K2's 24 forms alone
(``k2_forms_main``), ``--k9-forms [ROOT]`` K9's 12 forms and K8's four
(``k9_forms_main``), ``--k1-forms [ROOT]`` K1's 8 forms and the ms of
each block that fits (``k1_forms_main``), ``--k7-forms [ROOT]`` K7's 24
forms, K6's 8 and P1's matmul with digests of K6's and P1's outputs
(``k7_forms_main``), on this checkout or another; ``--prediction-gen
[ROOT]`` the ``host_engine`` and ``prediction_gen`` phases alone, the host
engine built and no kernel (``prediction_gen_main``); ``--qmc [ROOT]``
the QMC phases alone after the PRNG runs they are held against
(``qmc_main``); ``--serve-jvp
[ROOT]`` the ``serve`` and ``greeks_jvp`` phases alone after the kernel
runs they are held against (``serve_jvp_main``); ``--nn [ROOT]`` the
``nn`` phase alone, with no kernel built (``nn_main``); ``--mesh [ROOT]``
the ``mesh`` phase alone, after the build (``mesh_main``).

Usage (from the root of a checkout, one CUDA card):  python3 chip_smoke.py

Every phase prints one JSON line, with the seconds since the start
("t_s"), and ends in torch.cuda.synchronize(); any failure exits
non-zero.  The kernels' JSON record, then the card's name and power
limit, come before the last line, which is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import threading
import time
from pathlib import Path

# The bench.py workload.
N_STEPS, DT = 365, 1.0 / 252.0
CHUNK, N_CHUNKS, PILOT = 1 << 17, 76, 1 << 17
MARKET = dict(s0=100.0, xi=0.04, h=0.1, eta=1.5, rho=-0.4, r=0.04)
STRIKE, MATURITY, IS_CALL = 105.0, N_STEPS * DT, False
SEED = 42

# The long horizon: the same market and strike at the reference's longest
# horizon (steps = floor(maturity * 252) with an 1825-day cap), so the
# maturity is 1825/252.  The plain versions price its first LONG_CHECKED
# chunks under the kernels' fit.
LONG_STEPS, LONG_CHUNKS, LONG_CHECKED = 1825, 76, 8
LONG_MATURITY = LONG_STEPS * DT
K6_VS_K1_STEPS = 1008
CROSSOVER_STEPS = (365, 504, 1008, 1512)

# The extra-long horizon: 4000 steps (maturity 4000/252), past the chol
# slab's 3,620, which only the factored-DFT kernels K8/K9 (the spectral law)
# cover; the JAX package's records name it.  Its plain versions price the
# first XLONG_CHECKED chunks under the kernels' fit.
XLONG_STEPS, XLONG_CHUNKS, XLONG_CHECKED = 4000, 76, 8
XLONG_MATURITY = XLONG_STEPS * DT
FACTORED_STEPS = (LONG_STEPS, XLONG_STEPS)

# The strike strip of the chain and Greeks phases: one expiry's chain around
# s0, deep in and out of the money (the top strikes exercise at time 0).
STRIP = tuple(75.0 + 2.5 * i for i in range(21))
CHAIN_CHECKED = 8
# K5 past the single tile: the strip's pilot runs on K6 there.
PAST_TILE_STEPS = (400, 512)
# The generic path stream past K8's 8,192 steps: a few chunks of 16384
# (the FFT synthesis's complex plane at 10,000 steps is 2.1 GB a chunk).
XLONG_STREAM_STEPS = 10_000
XLONG_STREAM_CHUNK = 1 << 14
XLONG_STREAM_CHUNKS = 4
# The 21-strike strip on the generic stream at 1825 steps, cut from the
# full width's 76 chunks to keep the script inside its time (~24 s a run
# at 76).
CHAIN_STREAM_CHUNKS = 16
# Chunks of plain K1 paths that price the cubic policy's reference.
POLY3_CHECKED = 16
# The spectral fGN form: the strip past the single tile runs on the K8
# pilot with K5 on its own spectral constants, and the slab's estimator
# forms at 1825 steps; both are cut to 16 chunks (the LSM fit at 1825
# steps is seconds a run, and each slab chunk runs the dense products).
SPECTRAL_PAST_TILE_STEPS = 400
SPECTRAL_PAST_TILE_CHUNKS = 16
SPECTRAL_SLAB_FORM_CHUNKS = 16
# Blocks of 512 columns of the P1 normals probe per call of its plain
# version when it is held against a whole launch (~3 GB a call at k 26).
PROBE_REF_BLOCKS = 16

# Tolerances.  Paths: the kernel and the plain version sum the fGN product
# and the log-price recursion in different orders (float32), ~2e-4
# relative as the JAX package's own matmul-cumsum against float64.  Sums
# and price: a boundary decision can flip only inside the float32 root
# band, which moves a chunk sum by far less than 1e-4 relative.  Greeks:
# the tangent sums also run in another float32 order, so each of the six
# chunk sums is held at 2e-4 of its scale (floored at 1e-3 of the largest
# strike's, for near-zero deep out-of-the-money sums), as the CPU tests
# hold the plain version against JAX; K4 and K3 run one body, so a strike's
# column of K4 equals K3 up to the cross-block sum's order (1e-6 of each
# output's largest strike).
PATH_RTOL = 2e-4
# K8's paths: the four-step DFT and the plain version's FFT sum in other
# float32 orders; the JAX package's own factored-vs-dense tolerance at m2
# 2048 (tests/test_pallas_factored.py).  Prices under one set of fits on
# two laws' noise (K9 against K7): within 5 combined stderr.
FACTORED_PATH_RTOL = 5e-4
STDERR_SIGMAS = 5.0
SUM_RTOL = 1e-4
GREEKS_RTOL = 2e-4
SAME_BODY_RTOL = 1e-6
# A paired kernel against its unpaired form on the negated noise: each
# member's arithmetic is the unpaired path's, so only the order of the
# block sums differs.
PAIR_RTOL = 1e-5
# A whole-path pair form against its unpaired form on the negated noise,
# path by path: every rounding of the partner's cell is the unpaired
# path's (the kernels round the Euler increment explicitly), so the two
# agree to the bit; the tolerance is a few float32 ulps.
PATH_PAIR_RTOL = 1e-6
# The duality bounds past the bench horizon stream this many of the 76
# chunks, so the script stays within its time (the LSM fit at 4000 steps
# alone takes several seconds a run).
BOUNDS_LONG_CHUNKS = 16
# The GBM limit of the JAX package's bracket test (tests/test_engine.py):
# h = 1/2 and a vanishing vol of vol make the rough-Bergomi paths
# geometric Brownian motion with sigma = sqrt(xi), where the binomial
# tree gives the American value; the bracket must hold it within
# GBM_SIGMAS stderr and its gap stay under GBM_GAP of it.
GBM = dict(s0=100.0, sigma=0.25, h=0.5, eta=1e-6, rho=-0.3, r=0.04,
           strike=105.0, maturity=0.25, n_steps=63)
GBM_SIGMAS = 3.0
GBM_GAP = 0.08
# The estimator forms, (antithetic, with_cv), beside the plain one.
FORMS = ((True, False), (False, True), (True, True))
# The strip's batched fit against one strike's, in operators dispatched on
# CUDA tensors: a fit that looped over the 21 strikes would dispatch ~21
# times as many, so the strip's count is held to 1 % over one strike's.
FIT_LAUNCH_SLACK = 0.01

# The quadratic exercise-policy forms: the price runs past the bench horizon
# (and the spectral ones, whose law the chol runs cover) stream this many of
# the 76 chunks, so the script stays within its time (each runs its own
# pilot fit, seconds at 1825 and 4000 steps).  Operations of the policy per
# cell a path tests up to its first hit: the exp of the price and ~10 for
# the payoff, z, the polynomial and the two compares (K2, K7, K9); ~12 per
# strike-cell of K5's sweep, which has S already.
QUAD_CHUNKS = 16
QUAD_CELL_OPS = 11.0
QUAD_SWEEP_OPS = 12.0
# Under the quadratic policy the bounds' lower side and ``price`` decide by
# the same fitted quadratic on the same paths: only the float32 order of
# the sums differs.
QUAD_LOWER_RTOL = 1e-5

# The PredictionGen pipeline (``prediction_gen``): an option CSV of
# PG_ROWS rows, PG_SENTINELS of them planted to fail validation, against a
# wide spot CSV of two tickers over PG_SPOT_DAYS calendar days (the
# 1825-day history cap is reached), both made from SEED; the reference's
# width (250 paths a row, 10 branches, order 2, 5 iterations, 64 rows a
# batch).  Days to expiry spread log-uniformly over 7-1825, with one row
# forced into each bucket n_pad 4 .. 2048.  The resume reprocesses the rows
# from PG_RESUME_FROM on.  The card-against-host check prices
# PG_CHECK_ROWS rows of the n_pad 256 bucket on one injected noise.
# (PG_ROWS cut from 512 to 256 and PG_RESUME_FROM from 384 to 192 to keep
# the script inside its time.)
PG_ROWS, PG_SENTINELS, PG_SPOT_DAYS = 256, 8, 2600
PG_PRICING = dict(num_paths=250, num_branches=10, poly_order=2,
                  max_iterations=5, rows_per_batch=64, seed=SEED)
PG_BUCKET_DTE = (7, 10, 20, 40, 80, 150, 300, 600, 1200, 1825)
PG_RESUME_FROM = 192
PG_CHECK_ROWS, PG_CHECK_PAD, PG_CHECK_RTOL = 8, 256, 1e-5
PG_PHASE_LIMIT_S = 60.0
# The native host engine (``host_engine``): its features held against their
# plain versions on seeded histories of HOST_SIZES points (1e-12 relative,
# H 1e-9, as the CPU tests hold the JAX package's engine against its NumPy
# path), each timed for at least HOST_TIME_S a form.
HOST_SIZES = (2, 21, 60, 400, 1260, 1825)
HOST_RTOL, HOST_H_RTOL = 1e-12, 1e-9
HOST_TIME_S = 0.2
PG_OPTION_HEADER = ("ticker,option_type,quote_date,underlying_last,dte,"
                    "strike_distance_pct,delta,gamma,vega,theta,rho,iv,"
                    "volume,last,dividend")

# Randomized QMC (``qmc_*``): the price Brownian's leading PCA components
# (and under ``qmc_fgn`` the fGN planes') from a digitally shifted Sobol
# set, built on the card and fed to the noise-in entries of K2, K5, K7 and
# K9.  The CV and qmc_fgn forms and the horizons past the bench stream
# QMC_CUT_CHUNKS chunks (each runs its own pilot fit, seconds at 1825 and
# 4000 steps, and the host builds each Sobol base once); the card's noise is
# held against its host build on QMC_HOST_ROWS rows within QMC_NOISE_ATOL
# at 365 steps, growing as sqrt(n / 365) with the PCA product's length;
# the pipeline runs QMC_PG_ROWS of ``prediction_gen``'s rows, every bucket
# among them, and resumes from QMC_PG_RESUME_FROM.
QMC_CUT_CHUNKS = 16
QMC_HOST_ROWS = 4096
QMC_NOISE_ATOL = 1e-5
QMC_PG_ROWS, QMC_PG_RESUME_FROM = 128, 112

# H100 SXM peaks (NVIDIA data sheet): float32 without tensor cores, dense
# bf16 on the tensor cores, HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# K8/K9's stage-1 DFT length (N1 = 128, one step tile).
LANE_1 = 128

# The bf16 fGN-input forms: the long price's plain-version check streams
# this many chunks, and their estimator prices and paired bounds stream
# BF16_FORM_CHUNKS chunks (each form's pilot fit at 1825 steps is seconds).
BF16_LONG_CHECKED = 16
BF16_FORM_CHUNKS = 16
BF16_FORM_CHECKED = 4
# A bf16 path form must lie this many times closer to the bf16 plain
# version than to the float32 one (the discriminating check).
BF16_CLOSER = 10.0
# The bf16 forms of K8/K9, of the spectral bodies and of the quadratic
# bodies: the 4000-step price checks its first BF16_XLONG_CHECKED chunks
# against the plain versions; the prices past the bench horizon other than
# it (each with a pilot fit of seconds) stream BF16_CUT_CHUNKS chunks.
BF16_XLONG_CHECKED = 8
BF16_CUT_CHUNKS = 16

# The bf16 forms of slice 11, by kernel: (kernel, JAX file:line of the
# bf16 body, forms).
BF16_LATER_FORMS = (
    (1, "pathgen_pallas.py:142", ("/spectral", "/spectral/anti")),
    (2, "pathgen_pallas.py:142",
     ("/spectral", "/spectral/anti", "/spectral/cv", "/spectral/anti+cv",
      "/quad", "/quad/cv", "/spectral/quad", "/spectral/quad/cv")),
    (6, "pathgen_pallas_tiled.py:308", ("/spectral", "/spectral/anti")),
    (7, "pathgen_pallas_tiled.py:435",
     ("/spectral", "/spectral/anti", "/spectral/cv", "/spectral/anti+cv",
      "/quad", "/quad/cv", "/spectral/quad", "/spectral/quad/cv")),
    (8, "pathgen_pallas_factored.py:158", ("", "/anti")),
    (9, "pathgen_pallas_factored.py:158",
     ("", "/anti", "/cv", "/anti+cv", "/quad", "/quad/cv")))
# The bf16 forms of K5 (slice 12): (form, JAX file:line of its body).
BF16_K5_FORMS = (("", "pathgen_pallas.py:1943"),
                 ("/anti", "pathgen_pallas.py:432"),
                 ("/spectral", "pathgen_pallas.py:1943"),
                 ("/spectral/anti", "pathgen_pallas.py:432"),
                 ("/quad", "pathgen_pallas.py:302"),
                 ("/spectral/quad", "pathgen_pallas.py:302"))
CSRC_OF = {1: "pathgen.cu", 2: "pathgen.cu", 6: "pathgen_tiled.cu",
           7: "pathgen_tiled.cu", 8: "pathgen_factored.cu",
           9: "pathgen_factored.cu"}

REPLACES = {
    "pathgen": "montecarlooptionspricer_tpu/models/pathgen_pallas.py:522",
    "priced_chunk": "montecarlooptionspricer_tpu/models/pathgen_pallas.py:685",
    "tiled_pathgen":
        "montecarlooptionspricer_tpu/models/pathgen_pallas_tiled.py:267",
    "tiled_priced_chunk":
        "montecarlooptionspricer_tpu/models/pathgen_pallas_tiled.py:395",
    "priced_chain": "montecarlooptionspricer_tpu/models/pathgen_pallas.py:446",
    "greeks_chunk": "montecarlooptionspricer_tpu/models/pathgen_pallas.py:1016",
    "chain_greeks_chunk":
        "montecarlooptionspricer_tpu/models/pathgen_pallas.py:954",
    "factored_pathgen":
        "montecarlooptionspricer_tpu/models/pathgen_pallas_factored.py:222",
    "factored_priced_chunk":
        "montecarlooptionspricer_tpu/models/pathgen_pallas_factored.py:330",
    # The estimator forms, keyed kernel/form: the JAX body of each form.
    "K2/anti": "montecarlooptionspricer_tpu/models/pathgen_pallas.py:161",
    "K2/cv": "montecarlooptionspricer_tpu/models/pathgen_pallas.py:567",
    "K2/anti+cv": "montecarlooptionspricer_tpu/models/pathgen_pallas.py:650",
    "K7/anti":
        "montecarlooptionspricer_tpu/models/pathgen_pallas_tiled.py:382",
    "K7/cv": "montecarlooptionspricer_tpu/models/pathgen_pallas_tiled.py:207",
    "K7/anti+cv":
        "montecarlooptionspricer_tpu/models/pathgen_pallas_tiled.py:395",
    "K9/anti":
        "montecarlooptionspricer_tpu/models/pathgen_pallas_factored.py:330",
    "K9/cv":
        "montecarlooptionspricer_tpu/models/pathgen_pallas_factored.py:330",
    "K9/anti+cv":
        "montecarlooptionspricer_tpu/models/pathgen_pallas_factored.py:330",
    # The pair forms of the chain and Greeks kernels: their pair branches.
    "K5/anti": "montecarlooptionspricer_tpu/models/pathgen_pallas.py:432",
    "K3/anti": "montecarlooptionspricer_tpu/models/pathgen_pallas.py:849",
    "K4/anti": "montecarlooptionspricer_tpu/models/pathgen_pallas.py:849",
    # The whole-path pair bodies the duality bounds stream.
    "K1/anti": "montecarlooptionspricer_tpu/models/pathgen_pallas.py:261",
    "K6/anti":
        "montecarlooptionspricer_tpu/models/pathgen_pallas_tiled.py:267",
    "K8/anti":
        "montecarlooptionspricer_tpu/models/pathgen_pallas_factored.py:222",
    # The spectral fGN form (_fgn_x:142; the slab's _fgn_tile:125) of each
    # kernel and form, keyed kernel/spectral[/form]: the JAX body it runs
    # under fgn_form="spectral".
    "K1/spectral": "montecarlooptionspricer_tpu/models/pathgen_pallas.py:522",
    "K1/spectral/anti":
        "montecarlooptionspricer_tpu/models/pathgen_pallas.py:261",
    "K2/spectral": "montecarlooptionspricer_tpu/models/pathgen_pallas.py:685",
    "K2/spectral/anti":
        "montecarlooptionspricer_tpu/models/pathgen_pallas.py:161",
    "K2/spectral/cv":
        "montecarlooptionspricer_tpu/models/pathgen_pallas.py:567",
    "K2/spectral/anti+cv":
        "montecarlooptionspricer_tpu/models/pathgen_pallas.py:650",
    "K5/spectral": "montecarlooptionspricer_tpu/models/pathgen_pallas.py:446",
    "K5/spectral/anti":
        "montecarlooptionspricer_tpu/models/pathgen_pallas.py:432",
    "K6/spectral":
        "montecarlooptionspricer_tpu/models/pathgen_pallas_tiled.py:267",
    "K6/spectral/anti":
        "montecarlooptionspricer_tpu/models/pathgen_pallas_tiled.py:382",
    "K7/spectral":
        "montecarlooptionspricer_tpu/models/pathgen_pallas_tiled.py:395",
    "K7/spectral/anti":
        "montecarlooptionspricer_tpu/models/pathgen_pallas_tiled.py:382",
    "K7/spectral/cv":
        "montecarlooptionspricer_tpu/models/pathgen_pallas_tiled.py:207",
    "K7/spectral/anti+cv":
        "montecarlooptionspricer_tpu/models/pathgen_pallas_tiled.py:395",
    # The quadratic exercise-policy forms, keyed kernel[/spectral]/quad[/cv]:
    # the cell-level policy of each family, and its control lane.
    **{f"K2{f}/quad": "montecarlooptionspricer_tpu/models/pathgen_pallas.py:277"
       for f in ("", "/spectral")},
    **{f"K2{f}/quad/cv":
       "montecarlooptionspricer_tpu/models/pathgen_pallas.py:549"
       for f in ("", "/spectral")},
    **{f"K7{f}/quad":
       "montecarlooptionspricer_tpu/models/pathgen_pallas_tiled.py:161"
       for f in ("", "/spectral")},
    **{f"K7{f}/quad/cv":
       "montecarlooptionspricer_tpu/models/pathgen_pallas_tiled.py:320"
       for f in ("", "/spectral")},
    "K9/quad":
        "montecarlooptionspricer_tpu/models/pathgen_pallas_factored.py:300",
    "K9/quad/cv":
        "montecarlooptionspricer_tpu/models/pathgen_pallas_factored.py:282",
    **{f"K5{f}/quad": "montecarlooptionspricer_tpu/models/pathgen_pallas.py:302"
       for f in ("", "/spectral")},
    # The bf16 fGN-input forms (fgn_dtype=jnp.bfloat16): the single tile's
    # product _fgn_x:142 on bf16 matrices, the slab's bf16 noise tiles of
    # its path (:308) and priced (:435) kernels.
    **{f"K{k}/bf16{f}":
       "montecarlooptionspricer_tpu/models/pathgen_pallas.py:142"
       for k, forms in ((1, ("", "/anti")),
                        (2, ("", "/anti", "/cv", "/anti+cv")))
       for f in forms},
    **{f"K6/bf16{f}":
       "montecarlooptionspricer_tpu/models/pathgen_pallas_tiled.py:308"
       for f in ("", "/anti")},
    **{f"K7/bf16{f}":
       "montecarlooptionspricer_tpu/models/pathgen_pallas_tiled.py:435"
       for f in ("", "/anti", "/cv", "/anti+cv")},
    # The bf16 forms of the spectral and quadratic bodies (the same bf16
    # product and bf16 noise tiles, on Zr and Zi) and of K8/K9 (_stage1 on
    # bf16 a and F1).
    **{f"K{k}/bf16{f}": f"montecarlooptionspricer_tpu/models/{src}"
       for k, src, forms in BF16_LATER_FORMS for f in forms},
    # The bf16 forms of K5 and K3/K4 (slice 12): the chain kernel on the
    # bf16 factor of _fgn_consts (taken at pathgen_pallas.py:1943), its
    # pair branch and quadratic sweep likewise; the Greeks' two bf16
    # products from one N (_tangent_planes:845-848) and their pair branch.
    **{f"K5/bf16{f}": f"montecarlooptionspricer_tpu/models/{src}"
       for f, src in BF16_K5_FORMS},
    **{f"K{k}/bf16{f}": f"montecarlooptionspricer_tpu/models/{src}"
       for k in (3, 4) for f, src in (("", "pathgen_pallas.py:845"),
                                      ("/anti", "pathgen_pallas.py:849"))},
    # P1: the roofline probes.
    "P1/normals": "parity/vpu_roofline.py:110",
    "P1/matmul": "parity/vpu_roofline.py:177",
}
SOURCES = {
    "pathgen": "montecarlooptionspricer_tpu_torch/csrc/pathgen.cu",
    "priced_chunk": "montecarlooptionspricer_tpu_torch/csrc/pathgen.cu",
    "tiled_pathgen": "montecarlooptionspricer_tpu_torch/csrc/pathgen_tiled.cu",
    "tiled_priced_chunk":
        "montecarlooptionspricer_tpu_torch/csrc/pathgen_tiled.cu",
    "priced_chain": "montecarlooptionspricer_tpu_torch/csrc/chain.cu",
    "greeks_chunk": "montecarlooptionspricer_tpu_torch/csrc/greeks.cu",
    "chain_greeks_chunk": "montecarlooptionspricer_tpu_torch/csrc/greeks.cu",
    "factored_pathgen":
        "montecarlooptionspricer_tpu_torch/csrc/pathgen_factored.cu",
    "factored_priced_chunk":
        "montecarlooptionspricer_tpu_torch/csrc/pathgen_factored.cu",
    **{f"K2/{f}": "montecarlooptionspricer_tpu_torch/csrc/pathgen.cu"
       for f in ("anti", "cv", "anti+cv")},
    **{f"K7/{f}": "montecarlooptionspricer_tpu_torch/csrc/pathgen_tiled.cu"
       for f in ("anti", "cv", "anti+cv")},
    **{f"K9/{f}": "montecarlooptionspricer_tpu_torch/csrc/pathgen_factored.cu"
       for f in ("anti", "cv", "anti+cv")},
    "K5/anti": "montecarlooptionspricer_tpu_torch/csrc/chain.cu",
    "K3/anti": "montecarlooptionspricer_tpu_torch/csrc/greeks.cu",
    "K4/anti": "montecarlooptionspricer_tpu_torch/csrc/greeks.cu",
    "K1/anti": "montecarlooptionspricer_tpu_torch/csrc/pathgen.cu",
    "K6/anti": "montecarlooptionspricer_tpu_torch/csrc/pathgen_tiled.cu",
    "K8/anti": "montecarlooptionspricer_tpu_torch/csrc/pathgen_factored.cu",
    **{f"K{k}/spectral{f}": f"montecarlooptionspricer_tpu_torch/csrc/{src}"
       for k, src, forms in (
           (1, "pathgen.cu", ("", "/anti")),
           (2, "pathgen.cu", ("", "/anti", "/cv", "/anti+cv")),
           (5, "chain.cu", ("", "/anti")),
           (6, "pathgen_tiled.cu", ("", "/anti")),
           (7, "pathgen_tiled.cu", ("", "/anti", "/cv", "/anti+cv")))
       for f in forms},
    **{f"K{k}{spec}/quad{cv}": f"montecarlooptionspricer_tpu_torch/csrc/{src}"
       for k, src, cvs in ((2, "pathgen.cu", ("", "/cv")),
                           (7, "pathgen_tiled.cu", ("", "/cv")),
                           (9, "pathgen_factored.cu", ("", "/cv")),
                           (5, "chain.cu", ("",)))
       for spec in (("",) if k == 9 else ("", "/spectral")) for cv in cvs},
    **{f"K{k}/bf16{f}": f"montecarlooptionspricer_tpu_torch/csrc/{src}"
       for k, src, forms in (
           (1, "pathgen.cu", ("", "/anti")),
           (2, "pathgen.cu", ("", "/anti", "/cv", "/anti+cv")),
           (6, "pathgen_tiled.cu", ("", "/anti")),
           (7, "pathgen_tiled.cu", ("", "/anti", "/cv", "/anti+cv")))
       for f in forms},
    **{f"K{k}/bf16{f}":
       f"montecarlooptionspricer_tpu_torch/csrc/{CSRC_OF[k]}"
       for k, _, forms in BF16_LATER_FORMS for f in forms},
    **{f"K5/bf16{f}": "montecarlooptionspricer_tpu_torch/csrc/chain.cu"
       for f, _ in BF16_K5_FORMS},
    **{f"K{k}/bf16{f}": "montecarlooptionspricer_tpu_torch/csrc/greeks.cu"
       for k in (3, 4) for f in ("", "/anti")},
    "P1/normals": "montecarlooptionspricer_tpu_torch/csrc/roofline.cu",
    "P1/matmul": "montecarlooptionspricer_tpu_torch/csrc/roofline.cu",
}
# The priced wrappers whose launches count per form: the plain form keeps
# the wrapper's name, the others are keyed kernel/form.
FORM_WRAPPERS = {"K2": "priced_chunk", "K7": "tiled_priced_chunk",
                 "K9": "factored_priced_chunk", "K5": "priced_chain",
                 "K3": "greeks_chunk", "K4": "chain_greeks_chunk",
                 "K1": "pathgen", "K6": "tiled_pathgen",
                 "K8": "factored_pathgen"}


def expected_counts(**nonzero) -> dict:
    """Launch counts of a run that launched only the named kernels."""
    return {k: nonzero.get(k, 0) for k in REPLACES}


class SmokeError(RuntimeError):
    pass


# perf_counter() when main() started: each phase's record carries the
# seconds since then ("t_s"), so a run shows where the script's time goes.
_START = [0.0]


def emit(obj) -> None:
    if "phase" in obj:
        obj = {**obj, "t_s": round(time.perf_counter() - _START[0], 1)}
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeError(what)


def time_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of fn() over reps runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def plain_time(torch, fn, reps: int) -> float:
    """A plain version's ms: the mean of ``reps`` runs after a warm run,
    or with one rep a single run (the checks just ran it at this shape,
    so nothing is cold)."""
    return time_ms(torch, fn, reps, warmup=1 if reps > 1 else 0)


def bound_ms(rows: int, n: int, out_bytes: int, products: int = 1,
             per_cell: float = 8.0, policy_rows: int = 4,
             swept: int = 0, antithetic: bool = False,
             with_cv: bool = False, spectral: bool = False,
             sweep_ops: float = 4.0,
             quad_cells: int = 0, bf16: bool = False) -> tuple[float, str]:
    """Least time for one launch at this shape: the larger of the bytes
    that must move (the ``products`` triangular factors Lt' (and dLt'),
    vd and the ``policy_rows`` rows of [n] read once, the output written
    once) over HBM bandwidth and the float32 operations (each triangular
    fGN product, 2 per multiply-add, once per pair when ``antithetic``,
    plus ``per_cell`` per cell of every path: ~8 for the variance,
    increment, running sum and test, ~18 with the Greeks' tangent brackets
    and sums; plus ~4 per strike-cell that a strike sweep visits,
    ``swept``, counted from this run's stop steps (``sweep_ops``: ~12
    under the quadratic policy); plus QUAD_CELL_OPS per cell that a
    quadratic policy tests, ``quad_cells``, counted likewise; plus 2 per
    path for the control's exp and sum ``with_cv``) over the float32
    peak.  Under
    ``spectral`` the fGN product is the two dense [n, n] products Zr @ Cr'
    and Zi @ Ci' (2 n^2 multiply-adds per drawn path, both matrices read
    once), not the triangle.  Under ``bf16`` the product's operations go
    over the dense bf16 tensor-core peak and its factor is read at 2
    bytes an entry; the rest stays float32."""
    mats = 2 if spectral else products
    bytes_ = ((2 if bf16 else 4) * mats * n * n + 4 * policy_rows * n
              + out_bytes)
    drawn = rows // 2 if antithetic else rows
    product = (2.0 * 2 * drawn * n * n if spectral
               else 2.0 * products * drawn * n * (n + 1) / 2)
    rest = (per_cell * rows * n + sweep_ops * swept
            + QUAD_CELL_OPS * quad_cells
            + (2.0 * rows if with_cv else 0.0))
    t_bytes = bytes_ / PEAK_BYTES
    t_ops = (product / (PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS)
             + rest / PEAK_F32_FLOPS)
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def kernel_record(kname: str, launches: dict, ms: float, plain_ms: float,
                  b_ms: float, b_by: str, err: float,
                  library_ms: float, **extra) -> dict:
    """One kernel's entry of the kernels line (``extra`` keys after the
    contract's)."""
    return {"name": kname, "route": "cuda", "source": SOURCES[kname],
            "replaces": REPLACES[kname], "launches": launches[kname],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
            **extra}


def plain_stream_mean(pc, engine, pricer, fits, seed: int, n_chunks: int,
                      strike: float, normals=None, chunk_ref=None,
                      antithetic: bool = False,
                      with_cv: bool = False) -> float:
    """Price of the first n_chunks chunks of seed's stream under ``fits``
    (a CVFit ``with_cv``), through the plain versions of the form
    (time-0 exercise decided as the engine decides it): the mean
    discounted payoff, less beta (mean control - s0) under CV.
    ``normals`` and ``chunk_ref`` name the family's seeded stream and
    plain priced chunk (default K1/K2's)."""
    normals = normals or pc.philox_normals_ref
    chunk_ref = chunk_ref or pc.priced_chunk_from_noise_ref
    consts, dev = pricer.consts, pricer.device
    _, (run, start) = engine._pilot_stream_keys(seed)
    cv = fits if with_cv else None
    fits = cv.fits if with_cv else fits
    table = pricer._make_rows(fits)
    ex0, p0 = pc.time0_value(fits, MARKET["s0"], strike, IS_CALL)
    if bool(ex0):
        return p0
    total = control = 0.0
    for i in range(n_chunks):
        noise = normals(pc._fold_words(run, start + i),
                        CHUNK // 2 if antithetic else CHUNK, consts.n_steps,
                        device=dev)
        out = chunk_ref(consts, table, noise, strike, IS_CALL, antithetic,
                        with_cv)
        total += float(out[0] if with_cv else out)
        control += float(out[1]) if with_cv else 0.0
        del noise
    n = n_chunks * CHUNK
    return total / n - (cv.beta * (control / n - MARKET["s0"]) if with_cv
                        else 0.0)


def plain_price(pc, engine, lsm_fit, pricer, seed: int) -> float:
    """The main path with every kernel replaced by its plain version."""
    consts, dev = pricer.consts, pricer.device
    k_pilot, _ = engine._pilot_stream_keys(seed)
    pilot = pc.pathgen_from_noise_ref(consts, pc.philox_normals_ref(
        pc._fold_words(*k_pilot), PILOT, N_STEPS, device=dev))
    _, fits = lsm_fit(pilot, MARKET["r"], STRIKE, MATURITY, DT, IS_CALL, 2)
    return plain_stream_mean(pc, engine, pricer, fits, seed, N_CHUNKS,
                             STRIKE)


def timed(torch, fn):
    """(fn(), host seconds), the device synchronised at both ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def swept_cells(torch, paths, lo, hi) -> int:
    """Strike-cells a first-hit sweep visits: for each strike, each path's
    columns up to its first lo <= path <= hi, or all n where it never
    hits (paths [rows, n] in the space of lo and hi [K, n])."""
    n = paths.shape[1]
    total = 0
    for k in range(lo.shape[0]):
        exf = (paths >= lo[k]) & (paths <= hi[k])
        first = exf.to(torch.int8).argmax(dim=1) + 1
        total += int(torch.where(exf.any(dim=1), first, n).sum())
    return total


def scaled_err(torch, got, want) -> float:
    """Largest |got - want| over each entry's scale, floored at 1e-3 of
    its row's largest |want|.  A row is one output over the strikes: the
    six rows of Greeks sums, or the one row of a strip's sums."""
    want = want.double().reshape(-1, want.shape[-1])
    got = got.double().reshape(want.shape)
    floor = 1e-3 * want.abs().amax(dim=-1, keepdim=True)
    return float(((got - want).abs() / torch.maximum(want.abs(), floor))
                 .max())


# The keys a K5, K3 or K4 form's times carry into its kernels-line entry:
# the sweep's split and the blocks an SM runs at once.
SPLIT_KEYS = ("one_strike_ms", "sweep_ms", "blocks_per_sm",
              "one_strike_blocks_per_sm", "k3_ms", "k4_minus_k3_ms",
              "k3_blocks_per_sm")


def split_of(t: dict) -> dict:
    """The SPLIT_KEYS of one form's times."""
    return {k: t[k] for k in SPLIT_KEYS if k in t}


def k5_split(torch, cc, consts, tables, ms: float, key: int, reps: int,
             antithetic: bool = False,
             policy_form: str = "boundary") -> dict:
    """Where a K5 form's ``ms`` on the strip's tables goes: the same form's
    one-strike launch (strike STRIKE's table, the same key and rows)
    beside it, their difference (the strike sweep's share), and the
    blocks one SM runs at once for either launch (the occupancy query of
    the C entry)."""
    one = tables[STRIP.index(STRIKE)][None]
    one_ms = time_ms(torch, lambda: cc.priced_chain(
        consts, one, IS_CALL, rows=CHUNK, key=key, antithetic=antithetic,
        policy_form=policy_form), reps)
    return {"one_strike_ms": one_ms, "sweep_ms": ms - one_ms,
            "blocks_per_sm": cc.blocks_per_sm(
                consts, CHUNK, tables.shape[0], antithetic, policy_form),
            "one_strike_blocks_per_sm": cc.blocks_per_sm(
                consts, CHUNK, 1, antithetic, policy_form)}


def k4_split(gc, consts, k4_ms: float, k3_ms: float, n_strikes: int,
             antithetic: bool = False) -> dict:
    """Where a K4 form's ``k4_ms`` goes: K3 of the same form from the same
    run (one strike on the same body), K4 - K3 (the sweep of the other
    strikes), and the blocks one SM runs at once of K4 and of K3."""
    return {"k3_ms": k3_ms, "k4_minus_k3_ms": k4_ms - k3_ms,
            "blocks_per_sm": gc.blocks_per_sm(consts, CHUNK, n_strikes,
                                              antithetic),
            "k3_blocks_per_sm": gc.blocks_per_sm(consts, CHUNK, 1,
                                                 antithetic)}


def cuda_ops(torch, fn) -> int:
    """Operators fn() dispatches with a CUDA tensor among their arguments
    or results, counted by a TorchDispatchMode as each is dispatched: none
    is lost, so a run counts the same every time."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if any(isinstance(t, torch.Tensor) and t.is_cuda
                   for t in tree_flatten((args, kwargs, out))[0]):
                self.n += 1
            return out

    with Count() as count:
        fn()
    torch.cuda.synchronize()
    return count.n


def warm_up(torch, dev) -> float:
    """Pay the process's one-time host costs (the CUDA context, the first
    TorchDispatchMode, ~9 s, and the first vmapped forward-mode jvp, 8-10
    s, PERF.md) on tiny tensors, so that no phase's time carries them and
    they overlap the kernels' build; returns the seconds taken."""
    t0 = time.perf_counter()
    x = torch.ones(8, device=dev)
    cuda_ops(torch, lambda: x + 1.0)
    torch.func.vmap(lambda t: torch.func.jvp(torch.sin, (x,), (t,)))(
        torch.eye(8, device=dev))
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def k2_split(pc, kernels: list, dev) -> None:
    """Each K2 entry of the kernels line gains the blocks one SM runs at
    once of its form (``blocks_per_sm``, the C entry's occupancy query at
    the block the wrapper picks), the ms of K1 in the same fGN form, dtype
    and pairing (``k1_ms``) and, where K5 has the form (plain, paired,
    quadratic), K5's one-strike ms in it (``k5_one_strike_ms``; null for
    the CV forms), both from this run's entries."""
    by_name = {k["name"]: k for k in kernels}
    market = [MARKET[k] for k in ("s0", "xi", "h", "eta", "r")]
    consts = {}
    for rec in kernels:
        name = rec["name"]
        if name != "priced_chunk" and not name.startswith("K2/"):
            continue
        parts = name.split("/")[1:]
        bf16, spec = "bf16" in parts, "spectral" in parts
        quad = "quad" in parts
        anti = "anti" in parts or "anti+cv" in parts
        cv = "cv" in parts or "anti+cv" in parts
        base = [p for p, on in (("bf16", bf16), ("spectral", spec)) if on]
        k1 = "/".join(["K1", *base, *(["anti"] if anti else [])])
        k5 = "/".join(["K5", *base, *(["anti"] if anti else []),
                       *(["quad"] if quad else [])])
        k1 = "pathgen" if k1 == "K1" else k1
        k5 = "priced_chain" if k5 == "K5" else k5
        if (bf16, spec) not in consts:
            consts[bf16, spec] = pc.make_path_consts(
                *market, N_STEPS, DT, dev,
                fgn_form="spectral" if spec else "chol",
                fgn_dtype="bfloat16" if bf16 else "float32")
        rec["blocks_per_sm"] = pc.priced_blocks_per_sm(
            consts[bf16, spec], CHUNK, anti, cv,
            "quadratic" if quad else "boundary")
        rec["k1_ms"] = by_name[k1]["ms"]
        rec["k5_one_strike_ms"] = (None if cv
                                   else by_name[k5]["one_strike_ms"])


def k1_k7_split(pc, ptc, kernels: list, dev) -> None:
    """Each K1 entry of the kernels line gains the blocks one SM runs at
    once of its form at N_STEPS and each K6 and K7 entry of its form at
    LONG_STEPS (``blocks_per_sm``, the C entries' occupancy queries at the
    blocks the wrappers pick)."""
    market = [MARKET[k] for k in ("s0", "xi", "h", "eta", "r")]
    consts = {}
    names = {"pathgen": "K1", "tiled_pathgen": "K6",
             "tiled_priced_chunk": "K7"}
    for rec in kernels:
        name = names.get(rec["name"], rec["name"])
        kernel, parts = name.split("/")[0], name.split("/")[1:]
        if kernel not in ("K1", "K6", "K7"):
            continue
        bf16, spec = "bf16" in parts, "spectral" in parts
        anti = "anti" in parts or "anti+cv" in parts
        n = N_STEPS if kernel == "K1" else LONG_STEPS
        if (n, bf16, spec) not in consts:
            consts[n, bf16, spec] = pc.make_path_consts(
                *market, n, DT, dev, fgn_form="spectral" if spec else "chol",
                fgn_dtype="bfloat16" if bf16 else "float32")
        c = consts[n, bf16, spec]
        if kernel == "K1":
            rec["blocks_per_sm"] = pc.pathgen_blocks_per_sm(c, CHUNK, anti)
        else:
            rec["blocks_per_sm"] = ptc.blocks_per_sm(
                c, CHUNK, kernel == "K7", anti,
                "cv" in parts or "anti+cv" in parts,
                "quadratic" if "quad" in parts else "boundary")


def k89_split(pfc, kernels: list, dev) -> None:
    """Each K8 and K9 entry of the kernels line gains the blocks one SM runs
    at once of its form at XLONG_STEPS (``blocks_per_sm``, the C entry's
    occupancy query)."""
    market = [MARKET[k] for k in ("s0", "xi", "h", "eta", "r")]
    consts = {}
    for rec in kernels:
        name = rec["name"]
        k8 = name == "factored_pathgen" or name.startswith("K8/")
        if not (k8 or name == "factored_priced_chunk"
                or name.startswith("K9/")):
            continue
        parts = name.split("/")[1:]
        bf16 = "bf16" in parts
        if bf16 not in consts:
            consts[bf16] = pfc.make_factored_consts(
                *market, XLONG_STEPS, DT, dev,
                fgn_dtype="bfloat16" if bf16 else "float32")
        rec["blocks_per_sm"] = pfc.blocks_per_sm(
            consts[bf16], priced=not k8,
            antithetic="anti" in parts or "anti+cv" in parts,
            with_cv="cv" in parts or "anti+cv" in parts,
            policy_form="quadratic" if "quad" in parts else "boundary")


def plain_chain_means(torch, pc, cc, engine, chain, fits, seed: int,
                      n_chunks: int, antithetic: bool = False):
    """Per-strike mean discounted payoff of the first n_chunks chunks of
    seed's stream under the strip's ``fits``, through the plain versions
    (time-0 exercise decided per strike as the engine decides it; each
    drawn row priced as a pair ``antithetic``), on K5's constants and
    stream in their fGN form and dtype, under the strip's policy form."""
    consts, dev = chain.chain_consts, chain.device
    _, (run, start) = engine._pilot_stream_keys(seed)
    tables = chain._tables(fits, chain.strikes)
    ex0, p0 = pc.time0_value(fits, MARKET["s0"], chain.strikes, IS_CALL)
    total = torch.zeros(len(STRIP), dtype=torch.float64, device=dev)
    for i in range(n_chunks):
        noise = pc.normals_ref(consts, pc._fold_words(run, start + i),
                               CHUNK // 2 if antithetic else CHUNK,
                               device=dev)
        total += cc.priced_chain_from_noise_ref(
            consts, tables, noise, IS_CALL, antithetic,
            chain.config.chain_policy_form).double()
    mean = total / (n_chunks * CHUNK)
    return torch.where(ex0, p0.double(), mean).cpu().numpy()


def chain_and_greeks_phases(torch, pc, cc, gc, engine, smi, dev, key,
                            pricer, price: float, stderr: float,
                            reset_counts, read_counts) -> tuple:
    """The chain kernel K5 and the Greeks kernels K3 and K4 at the bench
    shape: each against its plain version (K5 also against K2, K4 against
    K3 per strike), then the strip's price, the bench option's Greeks and
    the strip's Greeks at full width through them.  ``price`` and
    ``stderr`` are the main path's.  Returns their entries of the kernels
    line, their times, the strip's (prices, stderrs) and the Greeks'
    ((greeks, stderrs) of the bench option, (values, stderrs) of the
    strip))."""
    import numpy as np

    chain = engine.StreamingChainPricer(**MARKET, strikes=STRIP,
                                        maturity=MATURITY, is_call=IS_CALL,
                                        config=pricer.config, device=dev)
    consts, g = chain.consts, chain.greeks_consts
    k_pilot = engine._pilot_stream_keys(SEED)[0]
    i_k = STRIP.index(STRIKE)
    fits = chain.fit(k_pilot)
    tables = chain._tables(fits, chain.strikes)
    logs = pc.log_boundary_rows(tables).contiguous()
    noise = pc.philox_normals_ref(key, CHUNK, N_STEPS, device=dev)

    # K5, noise-in and seeded, against its plain version at K = 1 and 21,
    # and seeded K5 at K = 1 against seeded K2 under the same fit.
    k5 = []
    for tab in (tables[i_k:i_k + 1], tables):
        want = cc.priced_chain_from_noise_ref(consts, tab, noise, IS_CALL)
        got_n = cc.priced_chain(consts, tab, IS_CALL, noise=noise)
        got_s = cc.priced_chain(consts, tab, IS_CALL, rows=CHUNK, key=key)
        torch.cuda.synchronize()
        k5.append({"n_strikes": tab.shape[0],
                   "noise_in_rel_err": scaled_err(torch, got_n, want),
                   "seeded_rel_err": scaled_err(torch, got_s, want)})
        check(k5[-1]["noise_in_rel_err"] <= SUM_RTOL
              and k5[-1]["seeded_rel_err"] <= SUM_RTOL,
              f"K5 disagrees with its plain version at K={tab.shape[0]}")
    abs_k5 = float(torch.max(torch.abs(got_s - want)))
    k5_one = float(cc.priced_chain(consts, tables[i_k:i_k + 1], IS_CALL,
                                   rows=CHUNK, key=key)[0])
    k2_one = float(pc.priced_chunk(consts, logs[i_k], STRIKE, IS_CALL,
                                   rows=CHUNK, key=key))
    k5_vs_k2 = abs(k5_one / k2_one - 1.0)
    emit({"phase": "k5", "rows": CHUNK, "n_steps": N_STEPS,
          "block_paths": cc.block_paths_for(N_STEPS, CHUNK),
          "strikes_per_launch": cc.GROUP, "checks": k5,
          "k5_sum_k1": k5_one, "k2_sum": k2_one, "k5_vs_k2_rel": k5_vs_k2,
          "rtol": SUM_RTOL})
    check(k5_vs_k2 <= SUM_RTOL, "seeded K5 and K2 disagree on one strike")

    # The strip's price at full width, through K1 once and K5 per chunk.
    reset_counts()
    (prices, stderrs), wall = timed(
        torch, lambda: chain.price(SEED, with_stderr=True))
    launches = read_counts()
    fits, fit_s = timed(torch, lambda: chain.fit(k_pilot))
    _, stream_s = timed(torch, lambda: chain.price_with_fit(fits, SEED))
    fit_ops = cuda_ops(torch, lambda: chain.fit(k_pilot))
    single_fit_ops = cuda_ops(torch, lambda: pricer.fit(k_pilot))
    checked = chain.price_with_fit(fits, SEED, n_paths=CHAIN_CHECKED * CHUNK)
    checked_plain = plain_chain_means(torch, pc, cc, engine, chain, fits,
                                      SEED, CHAIN_CHECKED)
    checked_rel = scaled_err(torch, torch.from_numpy(checked),
                             torch.from_numpy(checked_plain))
    n_paths = CHUNK * N_CHUNKS
    p_k, se_k = float(prices[i_k]), float(stderrs[i_k])
    emit({"phase": "chain_price", "card": smi, "n_paths": n_paths,
          "n_steps": N_STEPS, "strikes": list(STRIP),
          "prices": prices.tolist(), "stderrs": stderrs.tolist(),
          "wall_s": wall, "paths_strikes_per_s": n_paths * len(STRIP) / wall,
          "fit_s": fit_s, "stream_s": stream_s, "launches": launches,
          "fit_cuda_ops": fit_ops,
          "single_strike_fit_cuda_ops": single_fit_ops,
          "checked_chunks": CHAIN_CHECKED,
          "checked_rel_err": checked_rel, "rtol": SUM_RTOL,
          "strike": STRIKE, "price_at_strike": p_k,
          "stderr_at_strike": se_k, "single_strike_price": price})
    check(launches == expected_counts(pathgen=1, priced_chain=N_CHUNKS),
          f"chain launches {launches}, want 1 and {N_CHUNKS}")
    check(bool(np.all(np.isfinite(prices))) and bool(np.all(prices > 0)),
          "chain prices not finite and positive")
    check(bool(np.all(np.diff(prices) > 0)),
          "put prices do not rise with the strike")
    check(checked_rel <= SUM_RTOL, "chain prices disagree with the plain path")
    check(abs(p_k - price) <= 2.0 * stderr,
          f"strike {STRIKE} of the strip {p_k} is over 2 stderr from the "
          f"single-strike price {price}")
    check(0 < fit_ops
          <= (1.0 + FIT_LAUNCH_SLACK) * single_fit_ops,
          f"the strip's fit dispatches {fit_ops} CUDA operators, over "
          f"{FIT_LAUNCH_SLACK:.0%} more than one strike's "
          f"{single_fit_ops}")

    # K3 and K4 against their plain version on the strip's log tables, and
    # K4's columns against K3 per strike.
    want = gc.greeks_from_noise_ref(consts, g, logs, chain.strikes, noise,
                                    IS_CALL)
    k4_n = gc.chain_greeks_chunk(consts, g, logs, IS_CALL, noise=noise)
    k4_s = gc.chain_greeks_chunk(consts, g, logs, IS_CALL, rows=CHUNK,
                                 key=key)
    k3_n = gc.greeks_chunk(consts, g, logs[i_k], STRIKE, IS_CALL,
                           noise=noise)
    k3_s = gc.greeks_chunk(consts, g, logs[i_k], STRIKE, IS_CALL,
                           rows=CHUNK, key=key)
    torch.cuda.synchronize()
    err_k3 = [scaled_err(torch, got[:, None], want[:, i_k:i_k + 1])
              for got in (k3_n, k3_s)]
    abs_k3 = float(torch.max(torch.abs(k3_s - want[:, i_k])))
    emit({"phase": "k3", "rows": CHUNK, "n_steps": N_STEPS,
          "block_paths": gc.block_paths_for(N_STEPS, CHUNK),
          "strike": STRIKE, "seeded": k3_s.tolist(),
          "plain": want[:, i_k].tolist(), "noise_in_rel_err": err_k3[0],
          "seeded_rel_err": err_k3[1], "rtol": GREEKS_RTOL})
    check(max(err_k3) <= GREEKS_RTOL, "K3 disagrees with its plain version")
    err_k4 = [scaled_err(torch, got, want) for got in (k4_n, k4_s)]
    abs_k4 = float(torch.max(torch.abs(k4_s - want)))
    per_strike = torch.stack([
        gc.greeks_chunk(consts, g, logs[j], k, IS_CALL, rows=CHUNK, key=key)
        for j, k in enumerate(STRIP)], dim=1)
    same_body = float(((per_strike - k4_s).abs()
                       / k4_s.abs().amax(dim=1, keepdim=True)).max())
    emit({"phase": "k4", "rows": CHUNK, "n_strikes": len(STRIP),
          "noise_in_rel_err": err_k4[0], "seeded_rel_err": err_k4[1],
          "rtol": GREEKS_RTOL, "k3_per_strike_rel_err": same_body,
          "k3_per_strike_rtol": SAME_BODY_RTOL})
    check(max(err_k4) <= GREEKS_RTOL, "K4 disagrees with its plain version")
    check(same_body <= SAME_BODY_RTOL, "K4's columns differ from K3's")
    del per_strike

    # The bench option's Greeks at full width, through K1 once and K3 per
    # chunk, on price()'s pilot and fit.
    reset_counts()
    (greeks, greeks_se), g_wall = timed(
        torch, lambda: pricer.price_and_greeks(SEED, with_stderr=True))
    g_launches = read_counts()
    one_fits, g_fit_s = timed(torch, lambda: pricer.fit(k_pilot))
    _, g_stream_s = timed(torch,
                          lambda: pricer.greeks_with_fit(one_fits, SEED))
    g_rel = abs(greeks[0] / price - 1.0)
    emit({"phase": "greeks", "card": smi, "n_paths": n_paths,
          "greeks": dict(zip(gc.GREEK_ORDER, greeks)),
          "stderrs": dict(zip(gc.GREEK_ORDER, greeks_se)), "wall_s": g_wall,
          "paths_per_s": n_paths / g_wall, "fit_s": g_fit_s,
          "stream_s": g_stream_s, "launches": g_launches,
          "price_lane_rel_err": g_rel, "rtol": SUM_RTOL})
    check(g_launches == expected_counts(pathgen=1, greeks_chunk=N_CHUNKS),
          f"greeks launches {g_launches}, want 1 and {N_CHUNKS}")
    check(all(math.isfinite(v) for v in (*greeks, *greeks_se)),
          "non-finite Greeks")
    check(g_rel <= SUM_RTOL, "the Greeks' price lane disagrees with price()")

    # The strip's Greeks at full width, through K1 once and K4 per chunk.
    reset_counts()
    (cg, cg_se), cg_wall = timed(
        torch, lambda: chain.price_and_greeks(SEED, with_stderr=True))
    cg_launches = read_counts()
    _, cg_stream_s = timed(torch, lambda: chain.greeks_with_fit(fits, SEED))
    cg_rel = scaled_err(torch, torch.from_numpy(cg[0]),
                        torch.from_numpy(prices))
    emit({"phase": "chain_greeks", "card": smi, "n_paths": n_paths,
          "strikes": list(STRIP),
          "greeks": {n: row.tolist() for n, row in zip(gc.GREEK_ORDER, cg)},
          "wall_s": cg_wall, "paths_per_s": n_paths / cg_wall,
          "stream_s": cg_stream_s, "launches": cg_launches,
          "price_row_rel_err": cg_rel, "rtol": SUM_RTOL})
    check(cg_launches == expected_counts(pathgen=1,
                                         chain_greeks_chunk=N_CHUNKS),
          f"chain Greeks launches {cg_launches}, want 1 and {N_CHUNKS}")
    check(bool(np.all(np.isfinite(cg))) and bool(np.all(np.isfinite(cg_se))),
          "non-finite chain Greeks")
    check(cg_rel <= SUM_RTOL, "the chain Greeks' price row disagrees with "
          "the chain's prices")

    # Times at the bench shape; bounds count this chunk's swept cells.
    ls = pc._log_paths_ref(consts, noise)
    k5_swept = swept_cells(torch, torch.exp(ls), tables[:, 0, :N_STEPS],
                           tables[:, 1, :N_STEPS])
    k4_swept = swept_cells(torch, ls, logs[:, 0, :N_STEPS],
                           logs[:, 1, :N_STEPS])
    k3_swept = swept_cells(torch, ls, logs[i_k:i_k + 1, 0, :N_STEPS],
                           logs[i_k:i_k + 1, 1, :N_STEPS])
    del ls, noise
    blocks_k5 = CHUNK // cc.block_paths_for(N_STEPS, CHUNK)
    blocks_g = CHUNK // gc.block_paths_for(N_STEPS, CHUNK)
    k_n = len(STRIP)
    # Rows of [n] read: vd and each strike's lo, hi, dk and disc (K5); vd,
    # de, dh and each strike's log lo and log hi (K3, K4).
    k5_b = bound_ms(CHUNK, N_STEPS, 4 * blocks_k5 * k_n,
                    policy_rows=1 + 4 * k_n, swept=k5_swept)
    k3_b = bound_ms(CHUNK, N_STEPS, 4 * blocks_g * 6, products=2,
                    per_cell=18.0, policy_rows=3 + 2, swept=k3_swept)
    k4_b = bound_ms(CHUNK, N_STEPS, 4 * blocks_g * 6 * k_n, products=2,
                    per_cell=18.0, policy_rows=3 + 2 * k_n, swept=k4_swept)

    def k5_run():
        cc.priced_chain(consts, tables, IS_CALL, rows=CHUNK, key=key)

    def k5_plain():
        cc.priced_chain_from_noise_ref(consts, tables, pc.philox_normals_ref(
            key, CHUNK, N_STEPS, device=dev), IS_CALL)

    def k3_run():
        gc.greeks_chunk(consts, g, logs[i_k], STRIKE, IS_CALL, rows=CHUNK,
                        key=key)

    def k3_plain():
        gc.greeks_from_noise_ref(consts, g, logs[i_k:i_k + 1],
                                 chain.strikes[i_k:i_k + 1],
                                 pc.philox_normals_ref(key, CHUNK, N_STEPS,
                                                       device=dev), IS_CALL)

    def k4_run():
        gc.chain_greeks_chunk(consts, g, logs, IS_CALL, rows=CHUNK, key=key)

    def k4_plain():
        gc.greeks_from_noise_ref(consts, g, logs, chain.strikes,
                                 pc.philox_normals_ref(key, CHUNK, N_STEPS,
                                                       device=dev), IS_CALL)

    a = torch.randn((CHUNK, N_STEPS), device=dev)
    lib1_ms = time_ms(torch, lambda: torch.matmul(a, consts.lt_half), reps=20)
    lib2_ms = time_ms(torch, lambda: (torch.matmul(a, consts.lt_half),
                                      torch.matmul(a, g.dlt_half)), reps=20)
    del a
    times = {"k5_ms": time_ms(torch, k5_run, 10),
             "k3_ms": time_ms(torch, k3_run, 10),
             "k4_ms": time_ms(torch, k4_run, 10),
             "k5_plain_ms": time_ms(torch, k5_plain, 3),
             "k3_plain_ms": time_ms(torch, k3_plain, 3),
             "k4_plain_ms": time_ms(torch, k4_plain, 3),
             "library_one_product_ms": lib1_ms,
             "library_two_products_ms": lib2_ms,
             "k5_swept_cells": k5_swept, "k3_swept_cells": k3_swept,
             "k4_swept_cells": k4_swept, "chain_fit_s": fit_s,
             "chain_stream_s": stream_s}
    split5 = k5_split(torch, cc, consts, tables, times["k5_ms"], key, 10)
    split4 = k4_split(gc, consts, times["k4_ms"], times["k3_ms"], k_n)
    times.update({"k5_one_strike_ms": split5["one_strike_ms"],
                  "k5_sweep_ms": split5["sweep_ms"],
                  "k5_blocks_per_sm": split5["blocks_per_sm"],
                  "k4_minus_k3_ms": split4["k4_minus_k3_ms"],
                  "k4_blocks_per_sm": split4["blocks_per_sm"],
                  "k3_blocks_per_sm": split4["k3_blocks_per_sm"]})
    launch_counts = {**launches, "greeks_chunk": g_launches["greeks_chunk"],
                     "chain_greeks_chunk":
                         cg_launches["chain_greeks_chunk"]}
    records = [
        kernel_record("priced_chain", launch_counts, times["k5_ms"],
                      times["k5_plain_ms"], *k5_b, abs_k5, lib1_ms,
                      **split5),
        kernel_record("greeks_chunk", launch_counts, times["k3_ms"],
                      times["k3_plain_ms"], *k3_b, abs_k3, lib2_ms,
                      blocks_per_sm=split4["k3_blocks_per_sm"]),
        kernel_record("chain_greeks_chunk", launch_counts, times["k4_ms"],
                      times["k4_plain_ms"], *k4_b, abs_k4, lib2_ms,
                      **split4)]
    for name, (b, _) in (("k5", k5_b), ("k3", k3_b), ("k4", k4_b)):
        times[name + "_bound_ms"] = b
    return (records, times, (prices, stderrs),
            ((greeks, greeks_se), (cg, cg_se)))


def threshold_table(torch, n: int, dev):
    """A log-boundary table that exercises a put once S <= 0.9 strike:
    timing input for the crossover, where K2 and K7 read the same table."""
    table = torch.zeros((8, n), dtype=torch.float32, device=dev)
    table[0] = -1e30
    table[1] = math.log(0.9 * STRIKE)
    t = torch.arange(1, n + 1, dtype=torch.float32, device=dev) * DT
    table[2] = torch.exp(-MARKET["r"] * t)
    return table


def long_horizon_phases(torch, pc, ptc, engine, smi, dev, key, rel_err,
                        reset_counts, read_counts) -> list:
    """The step-tiled kernels K6 and K7: each against its plain version at
    1825 steps, seeded K6 against seeded K1, the full-width long-horizon
    price through them, the K2/K7 crossover and their times.  Returns their
    entries of the kernels line, the price's fits, the price, its stderr
    and its stream's seconds."""
    cfg = engine.StreamConfig(n_paths=CHUNK * LONG_CHUNKS, n_steps=LONG_STEPS,
                              chunk_paths=CHUNK, pilot_paths=PILOT, dt=DT,
                              chunks_per_call=LONG_CHUNKS)
    pricer = engine.StreamingPricer(**MARKET, strike=STRIKE,
                                    maturity=LONG_MATURITY, is_call=IS_CALL,
                                    config=cfg, device=dev)
    consts = pricer.consts
    check(pricer.kernel_family == "tiled",
          f"{LONG_STEPS} steps resolved to {pricer.kernel_family!r}")

    # K6 noise-in and seeded against its plain version, elementwise.
    noise = pc.philox_normals_ref(key, PILOT, LONG_STEPS, device=dev)
    want = ptc.pathgen_from_noise_ref(consts, noise)
    got = ptc.tiled_pathgen(consts, noise=noise)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), "K6 noise-in: non-finite paths")
    err_noise = rel_err(got, want)
    emit({"phase": "k6_noise_in", "rows": PILOT, "n_steps": LONG_STEPS,
          "block_paths": ptc.block_paths_for(PILOT),
          "max_rel_err": err_noise, "rtol": PATH_RTOL})
    check(err_noise <= PATH_RTOL, "K6 noise-in disagrees")
    del got, noise
    got = ptc.tiled_pathgen(consts, rows=PILOT, key=key)
    torch.cuda.synchronize()
    err_k6 = rel_err(got, want)
    abs_k6 = float(torch.max(torch.abs(got - want)))
    emit({"phase": "k6_seeded", "max_rel_err": err_k6,
          "max_abs_err": abs_k6, "rtol": PATH_RTOL})
    check(err_k6 <= PATH_RTOL, "K6 seeded disagrees with philox_normals_ref")
    del got, want

    # Seeded K6 against seeded K1 with one key: one stream for both.
    mid = pc.make_path_consts(MARKET["s0"], MARKET["xi"], MARKET["h"],
                              MARKET["eta"], MARKET["r"], K6_VS_K1_STEPS, DT,
                              dev)
    one = pc.pathgen(mid, rows=PILOT, key=key)
    tiled = ptc.tiled_pathgen(mid, rows=PILOT, key=key)
    torch.cuda.synchronize()
    err_k6_k1 = rel_err(tiled, one)
    emit({"phase": "k6_vs_k1", "rows": PILOT, "n_steps": K6_VS_K1_STEPS,
          "k1_block_paths": mid.block_paths, "max_rel_err": err_k6_k1,
          "rtol": PATH_RTOL})
    check(err_k6_k1 <= PATH_RTOL, "seeded K6 and K1 draw different paths")
    del one, tiled, mid

    # The full-width long-horizon price, through K6 and K7: price()'s
    # fit and stream on one pilot, timed apart on the host clock.
    reset_counts()
    fits, price, stderr, fit_s, stream_s = fit_and_price(torch, engine,
                                                         pricer)
    launches = read_counts()
    wall = fit_s + stream_s
    fits_finite = all(bool(torch.isfinite(t).all()) for t in fits)
    checked = pricer.price_with_fit(fits, SEED,
                                    n_paths=LONG_CHECKED * CHUNK)
    checked_plain = plain_stream_mean(pc, engine, pricer, fits, SEED,
                                      LONG_CHECKED, STRIKE)
    checked_rel = abs(checked / checked_plain - 1.0)
    n_paths = CHUNK * LONG_CHUNKS
    emit({"phase": "price_long", "card": smi, "n_paths": n_paths,
          "n_steps": LONG_STEPS, "maturity": LONG_MATURITY,
          "kernel_family": pricer.kernel_family, "price": price,
          "stderr": stderr, "wall_s": wall, "paths_per_s": n_paths / wall,
          "fit_s": fit_s, "stream_s": stream_s, "launches": launches,
          "fits_finite": fits_finite, "checked_chunks": LONG_CHECKED,
          "checked_price": checked, "checked_plain_price": checked_plain,
          "checked_rel_err": checked_rel, "rtol": SUM_RTOL})
    check(launches == expected_counts(tiled_pathgen=1,
                                      tiled_priced_chunk=LONG_CHUNKS),
          f"long-horizon launches {launches}, want 1 and {LONG_CHUNKS}")
    check(math.isfinite(price) and 0.0 < price < STRIKE,
          f"long-horizon price {price} outside (0, strike)")
    check(math.isfinite(stderr) and stderr > 0.0,
          f"long-horizon stderr {stderr} not finite and positive")
    check(fits_finite, "long-horizon fit has non-finite coefficients")
    check(checked_rel <= SUM_RTOL,
          "long-horizon price disagrees with the plain path")

    # K7 noise-in and seeded against its plain version on the fitted table.
    table = pricer._make_rows(fits)
    noise = pc.philox_normals_ref(key, CHUNK, LONG_STEPS, device=dev)
    got_n = float(ptc.tiled_priced_chunk(consts, table, STRIKE, IS_CALL,
                                         noise=noise))
    got_s = float(ptc.tiled_priced_chunk(consts, table, STRIKE, IS_CALL,
                                         rows=CHUNK, key=key))
    want = float(ptc.priced_chunk_from_noise_ref(consts, table, noise, STRIKE,
                                                 IS_CALL))
    del noise
    err_n, err_s = abs(got_n / want - 1.0), abs(got_s / want - 1.0)
    abs_k7 = abs(got_s - want)
    emit({"phase": "k7", "rows": CHUNK, "n_steps": LONG_STEPS,
          "noise_in_sum": got_n, "seeded_sum": got_s, "plain_sum": want,
          "noise_in_rel_err": err_n, "seeded_rel_err": err_s,
          "rtol": SUM_RTOL})
    check(err_n <= SUM_RTOL and err_s <= SUM_RTOL,
          "K7 disagrees with its plain version")

    # Crossover: K2 against K7 per chunk across horizons, on one key and
    # one table (their sums must agree too), in float32 and bf16, with K9
    # (the factored family, another stream: timed only) beside them.
    from montecarlooptionspricer_tpu_torch.models import (
        pathgen_factored_cuda as pfc)

    horizons = []
    for n in CROSSOVER_STEPS:
        tab = threshold_table(torch, n, dev)
        for dtype in pc.FGN_DTYPES:
            c = pc.make_path_consts(MARKET["s0"], MARKET["xi"], MARKET["h"],
                                    MARKET["eta"], MARKET["r"], n, DT, dev,
                                    fgn_dtype=dtype)
            fc = pfc.make_factored_consts(
                MARKET["s0"], MARKET["xi"], MARKET["h"], MARKET["eta"],
                MARKET["r"], n, DT, dev, fgn_dtype=dtype)

            def run_k2(c=c, tab=tab):
                return pc.priced_chunk(c, tab, STRIKE, IS_CALL, rows=CHUNK,
                                       key=key)

            def run_k7(c=c, tab=tab):
                return ptc.tiled_priced_chunk(c, tab, STRIKE, IS_CALL,
                                              rows=CHUNK, key=key)

            def run_k9(fc=fc, tab=tab):
                return pfc.factored_priced_chunk(fc, tab, STRIKE, IS_CALL,
                                                 rows=CHUNK, key=key)

            s2, s7 = float(run_k2()), float(run_k7())
            rel = abs(s7 / s2 - 1.0)
            horizons.append({"n_steps": n, "fgn_dtype": dtype,
                             "k2_block_paths": pc.priced_block_paths(
                                 c, CHUNK),
                             "k2_ms": time_ms(torch, run_k2, 3),
                             "k7_ms": time_ms(torch, run_k7, 3),
                             "k9_ms": time_ms(torch, run_k9, 3),
                             "sum_rel_err": rel})
            check(rel <= SUM_RTOL,
                  f"K2 and K7 sums disagree at {n} steps ({dtype})")
    emit({"phase": "crossover", "card": smi, "rows": CHUNK,
          "table": "put exercised once S <= 0.9 strike",
          "horizons": horizons,
          "single_tile_max_steps": engine.SINGLE_TILE_MAX_STEPS})

    # Times at the long horizon's shapes.
    def k6():
        ptc.tiled_pathgen(consts, rows=PILOT, key=key)

    def k6_plain():
        ptc.pathgen_from_noise_ref(consts, pc.philox_normals_ref(
            key, PILOT, LONG_STEPS, device=dev))

    def k7():
        ptc.tiled_priced_chunk(consts, table, STRIKE, IS_CALL, rows=CHUNK,
                               key=key)

    def k7_plain():
        ptc.priced_chunk_from_noise_ref(consts, table, pc.philox_normals_ref(
            key, CHUNK, LONG_STEPS, device=dev), STRIKE, IS_CALL)

    a = torch.randn((CHUNK, LONG_STEPS), device=dev)
    lib_ms = time_ms(torch, lambda: torch.matmul(a, consts.lt_half), reps=10)
    del a
    k6_b, k6_by = bound_ms(PILOT, LONG_STEPS, 4 * PILOT * (LONG_STEPS + 1))
    k7_b, k7_by = bound_ms(CHUNK, LONG_STEPS,
                           4 * (CHUNK // ptc.block_paths_for(CHUNK)))
    k6_ms, k7_ms = time_ms(torch, k6, 5), time_ms(torch, k7, 5)
    records = [
        kernel_record("tiled_pathgen", launches, k6_ms,
                      time_ms(torch, k6_plain, 2), k6_b, k6_by, abs_k6,
                      lib_ms),
        kernel_record("tiled_priced_chunk", launches, k7_ms,
                      time_ms(torch, k7_plain, 2), k7_b, k7_by, abs_k7,
                      lib_ms)]
    emit({"phase": "times_long", "card": smi, "library_call":
          "torch.matmul [131072,1825]x[1825,1825] float32 (fGN product "
          "only)", "library_ms": lib_ms, "k6_ms": k6_ms, "k7_ms": k7_ms,
          "k6_bound_ms": k6_b, "k7_bound_ms": k7_b,
          "k6_plain_ms": records[0]["plain_ms"],
          "k7_plain_ms": records[1]["plain_ms"]})
    return records, fits, price, stderr, stream_s


def factored_bound_ms(rows: int, n: int, out_bytes: int,
                      policy_rows: int = 0, antithetic: bool = False,
                      with_cv: bool = False, quad_cells: int = 0,
                      bf16: bool = False) -> tuple[float, str]:
    """Least time for one K8/K9 launch at this shape: the larger of the
    bytes that must move (the spectral diagonal [m2] complex, vd and
    ``policy_rows`` rows of [n] read once, the output written once; the
    seeded entry reads no noise) over HBM bandwidth, and the float32
    operations the function needs over the float32 peak: per drawn path
    the diagonal's complex multiply (6 per step) and one length-m2 complex
    FFT (5 m2 log2 m2), once per pair when ``antithetic``; per path ~8 per
    step, and 2 for the control ``with_cv``; QUAD_CELL_OPS per cell a
    quadratic policy tests (``quad_cells``).  The float32 kernels run that
    FFT (128-point FFTs over k1, then N2-point FFTs over k2).  Under
    ``bf16`` the FFT's first log2(128) = 7 radix-2 stages (stage 1's
    128-point DFTs, 5 m2 7 operations a path) run on bf16 inputs, so
    they go over the dense bf16 tensor-core peak and the rest over the
    float32 peak, and the bf16 F1 (two [128, 128] planes at 2 bytes) is
    read once."""
    m2 = 1 << (n - 1).bit_length()
    bytes_ = (4 * (2 * m2 + (1 + policy_rows) * n) + out_bytes
              + (2 * 2 * LANE_1 * LANE_1 if bf16 else 0))
    drawn = rows // 2 if antithetic else rows
    stage1 = drawn * 5.0 * m2 * math.log2(LANE_1) if bf16 else 0.0
    flops = (drawn * (5.0 * m2 * math.log2(m2) + 6.0 * n) - stage1
             + rows * (8.0 * n + (2.0 if with_cv else 0.0))
             + QUAD_CELL_OPS * quad_cells)
    t_bytes = bytes_ / PEAK_BYTES
    t_ops = flops / PEAK_F32_FLOPS + stage1 / PEAK_BF16_FLOPS
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def fit_and_price(torch, engine, pricer, n_paths=None) -> tuple:
    """price()'s two stages timed apart on one pilot: fit() on SEED's
    pilot key, then price_with_fit() (what price(SEED) runs, so the price
    is price()'s).  Returns (fits, price, stderr, fit_s, stream_s)."""
    fits, fit_s = timed(
        torch, lambda: pricer.fit(engine._pilot_stream_keys(SEED)[0]))
    (price, stderr), stream_s = timed(torch, lambda: pricer.price_with_fit(
        fits, SEED, n_paths, with_stderr=True))
    return fits, price, stderr, fit_s, stream_s


def factored_price_phase(torch, engine, smi, dev, name: str,
                         n_steps: int, cfg_kw: dict, reset_counts,
                         read_counts):
    """One full-width price through the factored family: price()'s fit
    and stream (``fit_and_price``) with the launch counts read around
    them.  Returns (pricer, fits, price, stderr, the phase's record)."""
    maturity = n_steps * DT
    cfg = engine.StreamConfig(n_paths=CHUNK * XLONG_CHUNKS, n_steps=n_steps,
                              chunk_paths=CHUNK, pilot_paths=PILOT, dt=DT,
                              chunks_per_call=XLONG_CHUNKS, **cfg_kw)
    pricer = engine.StreamingPricer(**MARKET, strike=STRIKE,
                                    maturity=maturity, is_call=IS_CALL,
                                    config=cfg, device=dev)
    check(pricer.kernel_family == "factored",
          f"{name}: {n_steps} steps resolved to {pricer.kernel_family!r}")
    reset_counts()
    fits, price, stderr, fit_s, stream_s = fit_and_price(torch, engine,
                                                         pricer)
    launches = read_counts()
    wall = fit_s + stream_s
    n_paths = CHUNK * XLONG_CHUNKS
    record = {"phase": name, "card": smi, "n_paths": n_paths,
              "n_steps": n_steps, "maturity": maturity, **cfg_kw,
              "kernel_family": pricer.kernel_family, "price": price,
              "stderr": stderr, "wall_s": wall, "paths_per_s": n_paths / wall,
              "fit_s": fit_s, "stream_s": stream_s, "launches": launches}
    check(launches == expected_counts(factored_pathgen=1,
                                      factored_priced_chunk=XLONG_CHUNKS),
          f"{name} launches {launches}, want K8 once and K9 "
          f"{XLONG_CHUNKS} times and nothing else")
    check(math.isfinite(price) and 0.0 < price < STRIKE,
          f"{name} price {price} outside (0, strike)")
    check(math.isfinite(stderr) and stderr > 0.0,
          f"{name} stderr {stderr} not finite and positive")
    check(all(bool(torch.isfinite(t).all()) for t in fits),
          f"{name}: non-finite fit coefficients")
    return pricer, fits, price, stderr, record


def factored_phases(torch, pc, pfc, engine, smi, dev, key, rel_err,
                    reset_counts, read_counts, long_fits, long_price: float,
                    long_stderr: float) -> list:
    """The factored-DFT kernels K8 and K9 (the spectral law): K8 against
    its plain version at 1825 and 4000 steps, the full-width prices at 1825
    steps (``tiled_impl="factored"``, also streamed under the fits of
    ``price_long``'s K6 pilot against ``price_long``) and at 4000 steps
    (auto), K9 against its plain version under those fits, and their
    times.  Returns their entries of the kernels line (at 4000 steps, the
    horizon only they cover), the 4000-step run's fits, price, stderr
    and stream seconds, and the 1825-step run's (price, stderr)."""
    consts = {n: pfc.make_factored_consts(
        MARKET["s0"], MARKET["xi"], MARKET["h"], MARKET["eta"], MARKET["r"],
        n, DT, dev) for n in FACTORED_STEPS}

    # K8 noise-in and seeded against its plain version, elementwise.
    k8 = {}
    for n in FACTORED_STEPS:
        noise = pfc.philox_factored_normals_ref(key, PILOT, n, device=dev)
        want = pfc.factored_pathgen_from_noise_ref(consts[n], noise)
        got_n = pfc.factored_pathgen(consts[n], noise=noise)
        del noise
        torch.cuda.synchronize()
        err_n = rel_err(got_n, want)
        del got_n
        got_s = pfc.factored_pathgen(consts[n], rows=PILOT, key=key)
        torch.cuda.synchronize()
        k8[n] = {"n_steps": n, "noise_in_rel_err": err_n,
                 "seeded_rel_err": rel_err(got_s, want),
                 "seeded_abs_err": float(torch.max(torch.abs(got_s - want))),
                 "finite": bool(torch.isfinite(got_s).all())}
        del got_s, want
    emit({"phase": "k8", "rows": PILOT,
          "paths_per_block": {n: pfc.paths_per_block(n)
                              for n in FACTORED_STEPS},
          "smem_bytes": {n: pfc.smem_bytes(n) for n in FACTORED_STEPS},
          "checks": list(k8.values()), "rtol": FACTORED_PATH_RTOL})
    check(all(c["finite"] and c["noise_in_rel_err"] <= FACTORED_PATH_RTOL
              and c["seeded_rel_err"] <= FACTORED_PATH_RTOL
              for c in k8.values()), "K8 disagrees with its plain version")

    # 1825 steps on the factored family, and K9 under price_long's fits.
    pricer, _, price, stderr, rec = factored_price_phase(
        torch, engine, smi, dev, "price_factored", LONG_STEPS,
        {"tiled_impl": "factored"}, reset_counts, read_counts)
    factored_long = (price, stderr)
    under_k6, under_k6_se = pricer.price_with_fit(long_fits, SEED,
                                                  with_stderr=True)
    sigmas = abs(under_k6 - long_price) / math.hypot(under_k6_se,
                                                     long_stderr)
    emit({**rec, "price_under_k6_fits": under_k6,
          "stderr_under_k6_fits": under_k6_se, "price_long": long_price,
          "stderr_long": long_stderr, "combined_stderrs_apart": sigmas,
          "limit": STDERR_SIGMAS})
    check(sigmas <= STDERR_SIGMAS,
          f"K9 under K6's fits is {sigmas:.2f} combined stderr from K7")
    tables = {LONG_STEPS: pricer._make_rows(long_fits)}

    # 4000 steps, auto: only K8/K9 cover it.
    pricer, fits, price, stderr, rec = factored_price_phase(
        torch, engine, smi, dev, "price_xlong", XLONG_STEPS, {},
        reset_counts, read_counts)
    xlong_launches = rec["launches"]
    xlong = (fits, price, stderr, rec["stream_s"])
    checked = pricer.price_with_fit(fits, SEED,
                                    n_paths=XLONG_CHECKED * CHUNK)
    checked_plain = plain_stream_mean(
        pc, engine, pricer, fits, SEED, XLONG_CHECKED, STRIKE,
        normals=pfc.philox_factored_normals_ref,
        chunk_ref=pfc.factored_priced_chunk_from_noise_ref)
    checked_rel = abs(checked / checked_plain - 1.0)
    emit({**rec, "checked_chunks": XLONG_CHECKED, "checked_price": checked,
          "checked_plain_price": checked_plain,
          "checked_rel_err": checked_rel, "rtol": SUM_RTOL})
    check(checked_rel <= SUM_RTOL,
          "the 4000-step price disagrees with the plain path")
    tables[XLONG_STEPS] = pricer._make_rows(fits)
    del pricer

    # K9 noise-in and seeded against its plain version on those tables.
    k9 = {}
    for n in FACTORED_STEPS:
        noise = pfc.philox_factored_normals_ref(key, CHUNK, n, device=dev)
        args = (consts[n], tables[n], STRIKE, IS_CALL)
        got_n = float(pfc.factored_priced_chunk(*args, noise=noise))
        got_s = float(pfc.factored_priced_chunk(*args, rows=CHUNK, key=key))
        want = float(pfc.factored_priced_chunk_from_noise_ref(
            consts[n], tables[n], noise, STRIKE, IS_CALL))
        del noise
        k9[n] = {"n_steps": n, "noise_in_sum": got_n, "seeded_sum": got_s,
                 "plain_sum": want, "noise_in_rel_err": abs(got_n / want - 1),
                 "seeded_rel_err": abs(got_s / want - 1),
                 "seeded_abs_err": abs(got_s - want)}
    emit({"phase": "k9", "rows": CHUNK, "checks": list(k9.values()),
          "rtol": SUM_RTOL})
    check(all(c["noise_in_rel_err"] <= SUM_RTOL
              and c["seeded_rel_err"] <= SUM_RTOL for c in k9.values()),
          "K9 disagrees with its plain version")

    # Times at both horizons: the kernels, their plain versions, the
    # library yardstick and the bounds.
    times = {}
    for n in FACTORED_STEPS:
        c, tab, m2 = consts[n], tables[n], pfc.fgn.next_pow2(n)

        def k8_run(c=c):
            pfc.factored_pathgen(c, rows=PILOT, key=key)

        def k8_plain(c=c, n=n):
            pfc.factored_pathgen_from_noise_ref(
                c, pfc.philox_factored_normals_ref(key, PILOT, n,
                                                   device=dev))

        def k9_run(c=c, tab=tab):
            pfc.factored_priced_chunk(c, tab, STRIKE, IS_CALL, rows=CHUNK,
                                      key=key)

        def k9_plain(c=c, tab=tab, n=n):
            pfc.factored_priced_chunk_from_noise_ref(
                c, tab, pfc.philox_factored_normals_ref(key, CHUNK, n,
                                                        device=dev),
                STRIKE, IS_CALL)

        a = torch.randn((CHUNK, m2), dtype=torch.complex64, device=dev)
        lib_ms = time_ms(torch, lambda: torch.fft.fft(a, dim=1), reps=10)
        del a
        k8_b = factored_bound_ms(PILOT, n, 4 * PILOT * (n + 1))
        k9_b = factored_bound_ms(
            CHUNK, n, 4 * (CHUNK // pfc.paths_per_block(n)), policy_rows=3)
        times[n] = {"n_steps": n, "k8_ms": time_ms(torch, k8_run, 5),
                    "k9_ms": time_ms(torch, k9_run, 5),
                    "k8_plain_ms": time_ms(torch, k8_plain, 2),
                    "k9_plain_ms": time_ms(torch, k9_plain, 2),
                    "library_ms": lib_ms, "k8_bound_ms": k8_b[0],
                    "k9_bound_ms": k9_b[0], "bound_by": k8_b[1],
                    "k9_bound_by": k9_b[1]}
    emit({"phase": "times_factored", "card": smi, "library_call":
          "torch.fft.fft of the chunk's [131072, m2] complex64 plane (the "
          "synthesis alone)", "horizons": list(times.values())})
    t = times[XLONG_STEPS]
    return [
        kernel_record("factored_pathgen", xlong_launches, t["k8_ms"],
                      t["k8_plain_ms"], t["k8_bound_ms"], t["bound_by"],
                      k8[XLONG_STEPS]["seeded_abs_err"], t["library_ms"]),
        kernel_record("factored_priced_chunk", xlong_launches, t["k9_ms"],
                      t["k9_plain_ms"], t["k9_bound_ms"], t["k9_bound_by"],
                      k9[XLONG_STEPS]["seeded_abs_err"], t["library_ms"]),
    ], xlong, factored_long


def lanes(out, with_cv: bool) -> tuple:
    """A priced kernel's output as floats: (payoff sum[, control sum])."""
    return tuple(float(v) for v in (out if with_cv else (out,)))


def forms_phase(torch, pc, smi, name: str, kernel: str, priced, chunk_ref,
                consts, table, normals, key, library, bound,
                spectral: bool = False, bf16: bool = False,
                plain_reps: int = 2) -> dict:
    """One priced kernel's three estimator forms (and, ``spectral`` or
    ``bf16``, its plain form too, all in the spectral fGN form or the bf16
    fGN-input form) at the bench chunk: each
    against its plain version on the seeded stream and on noise (both
    lanes within SUM_RTOL), paired against its unpaired form on the
    concatenated negated noise (PAIR_RTOL), then timed beside its plain
    version (``plain_time`` over ``plain_reps`` runs), the library
    yardstick ``library(antithetic)`` and its bound ``bound(antithetic,
    with_cv)`` = (ms, by).  Returns the forms' numbers keyed
    kernel/form."""
    out, checks = {}, []
    for anti, cv in ((((False, False),) if spectral or bf16 else ())
                     + FORMS):
        form = f"{kernel}/{pc.form_name(anti, cv, spectral, bf16=bf16)}"
        drawn = CHUNK // 2 if anti else CHUNK
        kw = dict(antithetic=anti, with_cv=cv)
        noise = normals(key, drawn)
        want = lanes(chunk_ref(consts, table, noise, STRIKE, IS_CALL, anti,
                               cv), cv)
        got_n = lanes(priced(consts, table, STRIKE, IS_CALL, noise=noise,
                             **kw), cv)
        got_s = lanes(priced(consts, table, STRIKE, IS_CALL, rows=CHUNK,
                             key=key, **kw), cv)
        pair = None
        if anti:
            unpaired = lanes(priced(
                consts, table, STRIKE, IS_CALL,
                noise=torch.cat([noise, -noise], dim=1), with_cv=cv), cv)
            pair = max(abs(g / u - 1.0) for g, u in zip(got_n, unpaired))
        del noise
        torch.cuda.synchronize()
        err_n = max(abs(g / w - 1.0) for g, w in zip(got_n, want))
        err_s = max(abs(g / w - 1.0) for g, w in zip(got_s, want))
        checks.append({"form": form, "plain": want, "noise_in": got_n,
                       "seeded": got_s, "noise_in_rel_err": err_n,
                       "seeded_rel_err": err_s, "pair_rel_err": pair})
        check(err_n <= SUM_RTOL and err_s <= SUM_RTOL,
              f"{form} disagrees with its plain version")
        check(pair is None or pair <= PAIR_RTOL,
              f"{form} paired disagrees with its unpaired form on [X; -X]")

        def run(kw=kw):
            priced(consts, table, STRIKE, IS_CALL, rows=CHUNK, key=key, **kw)

        def plain(anti=anti, cv=cv, drawn=drawn):
            chunk_ref(consts, table, normals(key, drawn), STRIKE, IS_CALL,
                      anti, cv)

        b_ms, b_by = bound(anti, cv)
        out[form] = {"ms": time_ms(torch, run, 5),
                     "plain_ms": plain_time(torch, plain, plain_reps),
                     "library_ms": library(anti), "bound_ms": b_ms,
                     "bound_by": b_by,
                     "max_abs_err": max(abs(g - w)
                                        for g, w in zip(got_s, want))}
    emit({"phase": name, "card": smi, "kernel": kernel, "rows": CHUNK,
          "n_steps": consts.n_steps, "checks": checks, "times": out,
          "rtol": SUM_RTOL, "pair_rtol": PAIR_RTOL})
    return out


def vr_price_phase(torch, pc, engine, smi, dev, name: str, kernel: str,
                   n_steps: int, form: dict, pilot: str, plain: tuple,
                   normals, chunk_ref, reset_counts, read_counts,
                   n_chunks: int = N_CHUNKS) -> dict:
    """One full-width price in an estimator ``form`` (StreamConfig's
    antithetic and control_variate, and any other StreamConfig field it
    names, e.g. fgn_form): price()'s fit and stream (``fit_and_price``)
    with the launch counts read around them (the plain ``pilot`` kernel
    once, the form ``n_chunks`` times), the first 8 chunks against the
    plain versions under the same fits (and beta and centre), and the
    price against the plain estimator's ``plain`` = (price, stderr,
    stream seconds) of the same seed: within 5 combined stderr, with the
    variance ratio (se_plain / se)^2 > 1 and the ratio per stream second.
    Returns the form's key, its launches in price() and (price,
    stderr)."""
    anti = form.get("antithetic", False)
    cv = form.get("control_variate", False)
    spectral = form.get("fgn_form") == "spectral"
    key = f"{kernel}/{pc.form_name(anti, cv, spectral)}"
    cfg = engine.StreamConfig(n_paths=CHUNK * n_chunks, n_steps=n_steps,
                              chunk_paths=CHUNK, pilot_paths=PILOT, dt=DT,
                              chunks_per_call=n_chunks, **form)
    pricer = engine.StreamingPricer(**MARKET, strike=STRIKE,
                                    maturity=n_steps * DT, is_call=IS_CALL,
                                    config=cfg, device=dev)
    reset_counts()
    fits, price, stderr, fit_s, stream_s = fit_and_price(torch, engine,
                                                         pricer)
    launches = read_counts()
    wall = fit_s + stream_s
    checked = pricer.price_with_fit(fits, SEED, n_paths=LONG_CHECKED * CHUNK)
    checked_plain = plain_stream_mean(pc, engine, pricer, fits, SEED,
                                      LONG_CHECKED, STRIKE, normals,
                                      chunk_ref, anti, cv)
    checked_rel = abs(checked / checked_plain - 1.0)
    p_plain, se_plain, stream_plain = plain
    sigmas = abs(price - p_plain) / math.hypot(stderr, se_plain)
    ratio = (se_plain / stderr) ** 2
    n_paths = CHUNK * n_chunks
    emit({"phase": name, "card": smi, "n_paths": n_paths, "n_steps": n_steps,
          **form, "kernel_family": pricer.kernel_family, "price": price,
          "stderr": stderr, "wall_s": wall, "paths_per_s": n_paths / wall,
          "stream_s": stream_s, "launches": launches,
          "beta": fits.beta if cv else None,
          "checked_chunks": LONG_CHECKED, "checked_price": checked,
          "checked_plain_price": checked_plain,
          "checked_rel_err": checked_rel, "rtol": SUM_RTOL,
          "plain_price": p_plain, "plain_stderr": se_plain,
          "combined_stderrs_apart": sigmas, "limit": STDERR_SIGMAS,
          "variance_ratio": ratio,
          "variance_ratio_per_stream_s": ratio * stream_plain / stream_s})
    check(launches == expected_counts(**{pilot: 1, key: n_chunks}),
          f"{name} launches {launches}, want {pilot} once and {key} "
          f"{n_chunks} times and nothing else")
    check(math.isfinite(price) and 0.0 < price < STRIKE,
          f"{name} price {price} outside (0, strike)")
    check(math.isfinite(stderr) and stderr > 0.0,
          f"{name} stderr {stderr} not finite and positive")
    check(checked_rel <= SUM_RTOL, f"{name} disagrees with the plain path")
    check(sigmas <= STDERR_SIGMAS,
          f"{name} is {sigmas:.2f} combined stderr from the plain price")
    check(ratio > 1.0, f"{name}: variance ratio {ratio} <= 1")
    return key, launches[key], (price, stderr)


VR_FORMS = (("anti", dict(antithetic=True)),
            ("cv", dict(control_variate=True)),
            ("anti_cv", dict(antithetic=True, control_variate=True)))


def estimator_phases(torch, pc, ptc, pfc, engine, smi, dev, key, pricer,
                     plain_runs: dict, reset_counts, read_counts) -> list:
    """The three forms of K2 (365 steps), K7 (1825) and K9 (4000): each
    against its plain version (``forms_phase``), then the nine estimator
    prices (``vr_price_phase``) against the plain runs ``plain_runs``
    {steps: (fits, price, stderr, stream seconds)}.  Returns the forms'
    entries of the kernels line and each price's (price, stderr) by
    phase name."""
    def matmul_ms(lt, n):
        def library(anti):
            a = torch.randn((CHUNK // 2 if anti else CHUNK, n), device=dev)
            ms = time_ms(torch, lambda: torch.matmul(a, lt), reps=10)
            del a
            return ms
        return library


    def table_of(n):
        return engine._fused_rows_builder(MARKET["r"], STRIKE, n * DT, DT, n,
                                          IS_CALL)(plain_runs[n][0])

    families = []
    # K2 at the bench horizon, on the main path's constants.
    c2 = pricer.consts
    families.append((
        "K2", "pathgen", N_STEPS, "k2_forms", pc.priced_chunk,
        pc.priced_chunk_from_noise_ref, c2, pc.philox_normals_ref,
        matmul_ms(c2.lt_half, N_STEPS),
        lambda anti, cv: bound_ms(
            CHUNK, N_STEPS, 4 * (2 if cv else 1)
            * (CHUNK // pc.priced_block_paths(c2, CHUNK, anti)),
            antithetic=anti, with_cv=cv)))
    c7 = pc.make_path_consts(MARKET["s0"], MARKET["xi"], MARKET["h"],
                             MARKET["eta"], MARKET["r"], LONG_STEPS, DT, dev)
    families.append((
        "K7", "tiled_pathgen", LONG_STEPS, "k7_forms",
        ptc.tiled_priced_chunk, ptc.priced_chunk_from_noise_ref, c7,
        pc.philox_normals_ref,
        matmul_ms(c7.lt_half, LONG_STEPS),
        lambda anti, cv: bound_ms(
            CHUNK, LONG_STEPS, 4 * (2 if cv else 1)
            * (CHUNK // ptc.block_paths_for(CHUNK, anti)),
            antithetic=anti, with_cv=cv)))
    c9 = pfc.make_factored_consts(MARKET["s0"], MARKET["xi"], MARKET["h"],
                                  MARKET["eta"], MARKET["r"], XLONG_STEPS,
                                  DT, dev)
    families.append((
        "K9", "factored_pathgen", XLONG_STEPS, "k9_forms",
        pfc.factored_priced_chunk, pfc.factored_priced_chunk_from_noise_ref,
        c9, pfc.philox_factored_normals_ref,
        lambda anti, lib=fft_library(torch, XLONG_STEPS, dev): lib(
            CHUNK // 2 if anti else CHUNK),
        lambda anti, cv: factored_bound_ms(
            CHUNK, XLONG_STEPS, 4 * (2 if cv else 1)
            * ((CHUNK // 2 if anti else CHUNK)
               // pfc.paths_per_block(XLONG_STEPS)),
            policy_rows=3, antithetic=anti, with_cv=cv)))

    prefix = {N_STEPS: "price", LONG_STEPS: "price_long",
              XLONG_STEPS: "price_xlong"}
    records, prices = [], {}
    for kernel, pilot, n, phase, priced, ref, consts, stream, lib, bound \
            in families:
        times = forms_phase(
            torch, pc, smi, phase, kernel, priced, ref, consts, table_of(n),
            lambda k, rows, n=n, stream=stream: stream(k, rows, n,
                                                       device=dev),
            key, lib, bound)
        launches = {}   # each form's count from its own price run
        for suffix, form in VR_FORMS:
            name = f"{prefix[n]}_{suffix}"
            if n != N_STEPS and suffix == "anti_cv":
                name = f"{prefix[n]}_vr"
            form_key, count, prices[name] = vr_price_phase(
                torch, pc, engine, smi, dev, name, kernel, n, form, pilot,
                plain_runs[n][1:], stream, ref, reset_counts, read_counts)
            launches[form_key] = count
        for form, t in times.items():
            records.append(kernel_record(form, launches, t["ms"],
                                         t["plain_ms"], t["bound_ms"],
                                         t["bound_by"], t["max_abs_err"],
                                         t["library_ms"]))
    return records, prices


def pair_phases(torch, pc, cc, gc, engine, smi, dev, key, pricer,
                strip_plain: tuple, price_anti: tuple, reset_counts,
                read_counts) -> list:
    """The pair forms K5/anti, K3/anti and K4/anti at the bench shape:
    each against its plain version (seeded and on noise) and against its
    unpaired form on the negated noise [X; -X]; then the paired strip
    (``chain_anti``), the paired Greeks of the bench option
    (``greeks_anti``) and of the strip (``chain_greeks_anti``) at full
    width, each with its launches read around it.  ``strip_plain`` is
    (prices, stderrs) of the plain strip, ``price_anti`` (price, stderr)
    of the paired single strike.  Returns their entries of the kernels
    line."""
    import dataclasses

    import numpy as np

    cfg = dataclasses.replace(pricer.config, antithetic=True)
    chain = engine.StreamingChainPricer(**MARKET, strikes=STRIP,
                                        maturity=MATURITY, is_call=IS_CALL,
                                        config=cfg, device=dev)
    one = engine.StreamingPricer(**MARKET, strike=STRIKE, maturity=MATURITY,
                                 is_call=IS_CALL, config=cfg, device=dev)
    consts, g = chain.consts, chain.greeks_consts
    i_k = STRIP.index(STRIKE)
    k_pilot = engine._pilot_stream_keys(SEED)[0]
    fits = chain.fit(k_pilot)
    tables = chain._tables(fits, chain.strikes)
    logs = pc.log_boundary_rows(tables).contiguous()
    half = pc.philox_normals_ref(key, CHUNK // 2, N_STEPS, device=dev)
    doubled = torch.cat([half, -half], dim=1)

    # K5/anti against its plain version and its unpaired form.
    want = cc.priced_chain_from_noise_ref(consts, tables, half, IS_CALL, True)
    got_n = cc.priced_chain(consts, tables, IS_CALL, noise=half,
                            antithetic=True)
    got_s = cc.priced_chain(consts, tables, IS_CALL, rows=CHUNK, key=key,
                            antithetic=True)
    unpaired = cc.priced_chain(consts, tables, IS_CALL, noise=doubled)
    torch.cuda.synchronize()
    k5 = {"noise_in_rel_err": scaled_err(torch, got_n, want),
          "seeded_rel_err": scaled_err(torch, got_s, want),
          "pair_rel_err": scaled_err(torch, got_n, unpaired)}
    abs_k5 = float(torch.max(torch.abs(got_s - want)))
    emit({"phase": "k5_anti", "rows": CHUNK, "n_steps": N_STEPS,
          "block_paths": cc.block_paths_for(N_STEPS, CHUNK, True), **k5,
          "rtol": SUM_RTOL, "pair_rtol": PAIR_RTOL})
    check(k5["noise_in_rel_err"] <= SUM_RTOL
          and k5["seeded_rel_err"] <= SUM_RTOL,
          "K5/anti disagrees with its plain version")
    check(k5["pair_rel_err"] <= PAIR_RTOL,
          "K5/anti disagrees with unpaired K5 on [X; -X]")

    # K3/anti and K4/anti likewise.
    want_g = gc.greeks_from_noise_ref(consts, g, logs, chain.strikes, half,
                                      IS_CALL, True)
    errs, abs_g = {}, {}
    for name, run, ref in (
            ("k3", lambda **kw: gc.greeks_chunk(
                consts, g, logs[i_k], STRIKE, IS_CALL, **kw)[:, None],
             want_g[:, i_k:i_k + 1]),
            ("k4", lambda **kw: gc.chain_greeks_chunk(
                consts, g, logs, IS_CALL, **kw), want_g)):
        got_n = run(noise=half, antithetic=True)
        got_s = run(rows=CHUNK, key=key, antithetic=True)
        unp = run(noise=doubled)
        torch.cuda.synchronize()
        errs[name] = {"noise_in_rel_err": scaled_err(torch, got_n, ref),
                      "seeded_rel_err": scaled_err(torch, got_s, ref),
                      "pair_rel_err": scaled_err(torch, got_n, unp)}
        abs_g[name] = float(torch.max(torch.abs(got_s - ref)))
        check(errs[name]["noise_in_rel_err"] <= GREEKS_RTOL
              and errs[name]["seeded_rel_err"] <= GREEKS_RTOL,
              f"{name.upper()}/anti disagrees with its plain version")
        check(errs[name]["pair_rel_err"] <= PAIR_RTOL,
              f"{name.upper()}/anti disagrees with its unpaired form")
    emit({"phase": "k3_k4_anti", "rows": CHUNK, "n_steps": N_STEPS,
          "block_paths": gc.block_paths_for(N_STEPS, CHUNK, True),
          "checks": errs, "rtol": GREEKS_RTOL, "pair_rtol": PAIR_RTOL})
    del doubled, unpaired

    # The paired strip at full width: K1 once, one batched fit, K5/anti.
    reset_counts()
    (prices, stderrs), wall = timed(
        torch, lambda: chain.price(SEED, with_stderr=True))
    launches = read_counts()
    _, fit_s = timed(torch, lambda: chain.fit(k_pilot))
    _, stream_s = timed(torch, lambda: chain.price_with_fit(fits, SEED))
    checked = chain.price_with_fit(fits, SEED, n_paths=CHAIN_CHECKED * CHUNK)
    checked_plain = plain_chain_means(torch, pc, cc, engine, chain, fits,
                                      SEED, CHAIN_CHECKED, antithetic=True)
    checked_rel = scaled_err(torch, torch.from_numpy(checked),
                             torch.from_numpy(checked_plain))
    p_plain, se_plain = strip_plain
    live = stderrs > 0          # time-0 strikes have no variance
    ratios = np.where(live, (se_plain / np.where(live, stderrs, 1.0)) ** 2,
                      np.nan)
    p_k, se_k = float(prices[i_k]), float(stderrs[i_k])
    sigmas = abs(p_k - price_anti[0]) / math.hypot(se_k, price_anti[1])
    n_paths = CHUNK * N_CHUNKS
    emit({"phase": "chain_anti", "card": smi, "n_paths": n_paths,
          "n_steps": N_STEPS, "strikes": list(STRIP),
          "prices": prices.tolist(), "stderrs": stderrs.tolist(),
          "wall_s": wall, "paths_strikes_per_s": n_paths * len(STRIP) / wall,
          "fit_s": fit_s, "stream_s": stream_s, "launches": launches,
          "checked_chunks": CHAIN_CHECKED, "checked_rel_err": checked_rel,
          "rtol": SUM_RTOL, "strike": STRIKE, "price_at_strike": p_k,
          "stderr_at_strike": se_k, "price_anti": list(price_anti),
          "combined_stderrs_apart": sigmas, "limit": STDERR_SIGMAS,
          "variance_ratio_per_strike": [
              None if not math.isfinite(v) else float(v) for v in ratios]})
    check(launches == expected_counts(pathgen=1, **{"K5/anti": N_CHUNKS}),
          f"chain_anti launches {launches}, want K1 once and K5/anti "
          f"{N_CHUNKS} times")
    check(bool(np.all(np.isfinite(prices))) and bool(np.all(prices > 0)),
          "paired chain prices not finite and positive")
    check(bool(np.all(np.diff(prices) > 0)),
          "paired put prices do not rise with the strike")
    check(checked_rel <= SUM_RTOL,
          "paired chain prices disagree with the plain path")
    check(sigmas <= STDERR_SIGMAS,
          f"strike {STRIKE} of the paired strip is {sigmas:.2f} combined "
          "stderr from price_anti")
    check(ratios[i_k] > 1.0,
          f"paired strike {STRIKE}'s variance is not below the plain "
          "strip's")

    # The paired Greeks of the bench option (K3/anti) and of the strip
    # (K4/anti) at full width, their price lanes against the paired strip.
    reset_counts()
    (greeks, greeks_se), g_wall = timed(
        torch, lambda: one.price_and_greeks(SEED, with_stderr=True))
    g_launches = read_counts()
    g_rel = abs(greeks[0] / p_k - 1.0)
    emit({"phase": "greeks_anti", "card": smi, "n_paths": n_paths,
          "greeks": dict(zip(gc.GREEK_ORDER, greeks)),
          "stderrs": dict(zip(gc.GREEK_ORDER, greeks_se)), "wall_s": g_wall,
          "paths_per_s": n_paths / g_wall, "launches": g_launches,
          "price_lane_rel_err": g_rel, "rtol": SUM_RTOL})
    check(g_launches == expected_counts(pathgen=1,
                                        **{"K3/anti": N_CHUNKS}),
          f"greeks_anti launches {g_launches}, want K1 once and K3/anti "
          f"{N_CHUNKS} times")
    check(all(math.isfinite(v) for v in (*greeks, *greeks_se)),
          "non-finite paired Greeks")
    check(g_rel <= SUM_RTOL,
          "the paired Greeks' price lane disagrees with chain_anti")
    reset_counts()
    (cg, cg_se), cg_wall = timed(
        torch, lambda: chain.price_and_greeks(SEED, with_stderr=True))
    cg_launches = read_counts()
    cg_rel = scaled_err(torch, torch.from_numpy(cg[0]),
                        torch.from_numpy(prices))
    emit({"phase": "chain_greeks_anti", "card": smi, "n_paths": n_paths,
          "strikes": list(STRIP),
          "greeks": {n: row.tolist() for n, row in zip(gc.GREEK_ORDER, cg)},
          "wall_s": cg_wall, "paths_per_s": n_paths / cg_wall,
          "launches": cg_launches, "price_row_rel_err": cg_rel,
          "rtol": SUM_RTOL})
    check(cg_launches == expected_counts(pathgen=1,
                                         **{"K4/anti": N_CHUNKS}),
          f"chain_greeks_anti launches {cg_launches}, want K1 once and "
          f"K4/anti {N_CHUNKS} times")
    check(bool(np.all(np.isfinite(cg))) and bool(np.all(np.isfinite(cg_se))),
          "non-finite paired chain Greeks")
    check(cg_rel <= SUM_RTOL, "the paired chain Greeks' price row disagrees "
          "with chain_anti's prices")

    # Times at the bench shape; bounds count this chunk's swept cells on
    # the paired paths, the products once per pair.
    ls = pc._log_paths_ref(consts, half, antithetic=True)
    k5_swept = swept_cells(torch, torch.exp(ls), tables[:, 0, :N_STEPS],
                           tables[:, 1, :N_STEPS])
    k4_swept = swept_cells(torch, ls, logs[:, 0, :N_STEPS],
                           logs[:, 1, :N_STEPS])
    k3_swept = swept_cells(torch, ls, logs[i_k:i_k + 1, 0, :N_STEPS],
                           logs[i_k:i_k + 1, 1, :N_STEPS])
    del ls
    blocks_k5 = CHUNK // cc.block_paths_for(N_STEPS, CHUNK, True)
    blocks_g = CHUNK // gc.block_paths_for(N_STEPS, CHUNK, True)
    k_n = len(STRIP)
    bounds = {
        "K5/anti": bound_ms(CHUNK, N_STEPS, 4 * blocks_k5 * k_n,
                            policy_rows=1 + 4 * k_n, swept=k5_swept,
                            antithetic=True),
        "K3/anti": bound_ms(CHUNK, N_STEPS, 4 * blocks_g * 6, products=2,
                            per_cell=18.0, policy_rows=3 + 2,
                            swept=k3_swept, antithetic=True),
        "K4/anti": bound_ms(CHUNK, N_STEPS, 4 * blocks_g * 6 * k_n,
                            products=2, per_cell=18.0,
                            policy_rows=3 + 2 * k_n, swept=k4_swept,
                            antithetic=True)}

    def normals():
        return pc.philox_normals_ref(key, CHUNK // 2, N_STEPS, device=dev)

    runs = {
        "K5/anti": (lambda: cc.priced_chain(consts, tables, IS_CALL,
                                            rows=CHUNK, key=key,
                                            antithetic=True),
                    lambda: cc.priced_chain_from_noise_ref(
                        consts, tables, normals(), IS_CALL, True)),
        "K3/anti": (lambda: gc.greeks_chunk(consts, g, logs[i_k], STRIKE,
                                            IS_CALL, rows=CHUNK, key=key,
                                            antithetic=True),
                    lambda: gc.greeks_from_noise_ref(
                        consts, g, logs[i_k:i_k + 1],
                        chain.strikes[i_k:i_k + 1], normals(), IS_CALL,
                        True)),
        "K4/anti": (lambda: gc.chain_greeks_chunk(consts, g, logs, IS_CALL,
                                                  rows=CHUNK, key=key,
                                                  antithetic=True),
                    lambda: gc.greeks_from_noise_ref(
                        consts, g, logs, chain.strikes, normals(), IS_CALL,
                        True))}
    a = torch.randn((CHUNK // 2, N_STEPS), device=dev)
    lib1 = time_ms(torch, lambda: torch.matmul(a, consts.lt_half), reps=20)
    lib2 = time_ms(torch, lambda: (torch.matmul(a, consts.lt_half),
                                   torch.matmul(a, g.dlt_half)), reps=20)
    del a, half
    counts = {"K5/anti": launches["K5/anti"],
              "K3/anti": g_launches["K3/anti"],
              "K4/anti": cg_launches["K4/anti"]}
    errs_abs = {"K5/anti": abs_k5, "K3/anti": abs_g["k3"],
                "K4/anti": abs_g["k4"]}
    libs = {"K5/anti": lib1, "K3/anti": lib2, "K4/anti": lib2}
    records, times = [], {}
    for name, (run, plain) in runs.items():
        ms, plain_ms = time_ms(torch, run, 10), time_ms(torch, plain, 3)
        times[name] = {"ms": ms, "plain_ms": plain_ms,
                       "bound_ms": bounds[name][0]}
    times["K5/anti"].update(k5_split(torch, cc, consts, tables,
                                     times["K5/anti"]["ms"], key, 10, True))
    times["K4/anti"].update(k4_split(gc, consts, times["K4/anti"]["ms"],
                                     times["K3/anti"]["ms"], k_n, True))
    times["K3/anti"]["blocks_per_sm"] = times["K4/anti"]["k3_blocks_per_sm"]
    for name, t in times.items():
        records.append(kernel_record(name, counts, t["ms"], t["plain_ms"],
                                     *bounds[name], errs_abs[name],
                                     libs[name], **split_of(t)))
    emit({"phase": "times_anti", "card": smi, "library_call":
          "torch.matmul [65536,365]x[365,365] float32 (the fGN product of "
          "the drawn rows only; K3/K4: with [365,365] dLt' too)",
          "library_one_product_ms": lib1, "library_two_products_ms": lib2,
          "k5_swept_cells": k5_swept, "k3_swept_cells": k3_swept,
          "k4_swept_cells": k4_swept, "kernels": times,
          "chain_anti_fit_s": fit_s, "chain_anti_stream_s": stream_s})
    return records


def chain_past_tile_phase(torch, pc, cc, engine, smi, dev, key) -> None:
    """K5 and K5/anti past the single tile, at 400 and 512 steps (the
    strip's pilot runs on K6 there): each against its plain version,
    seeded and on noise, and the pair against the unpaired form on
    [X; -X], on the strip's tables fitted from a pilot at that horizon."""
    checks = []
    for n in PAST_TILE_STEPS:
        cfg = engine.StreamConfig(n_paths=CHUNK, n_steps=n,
                                  chunk_paths=CHUNK, pilot_paths=PILOT,
                                  dt=DT)
        chain = engine.StreamingChainPricer(**MARKET, strikes=STRIP,
                                            maturity=n * DT,
                                            is_call=IS_CALL, config=cfg,
                                            device=dev)
        check(chain.kernel_family == "tiled",
              f"a {n}-step strip resolved to {chain.kernel_family!r}")
        consts = chain.consts
        tables = chain._tables(chain.fit(engine._pilot_stream_keys(SEED)[0]),
                               chain.strikes)
        for anti in (False, True):
            noise = pc.philox_normals_ref(key, CHUNK // 2 if anti else CHUNK,
                                          n, device=dev)
            want = cc.priced_chain_from_noise_ref(consts, tables, noise,
                                                  IS_CALL, anti)
            got_n = cc.priced_chain(consts, tables, IS_CALL, noise=noise,
                                    antithetic=anti)
            got_s = cc.priced_chain(consts, tables, IS_CALL, rows=CHUNK,
                                    key=key, antithetic=anti)
            pair = None
            if anti:
                pair = scaled_err(torch, got_n, cc.priced_chain(
                    consts, tables, IS_CALL,
                    noise=torch.cat([noise, -noise], dim=1)))
            torch.cuda.synchronize()
            rec = {"n_steps": n, "antithetic": anti,
                   "block_paths": cc.block_paths_for(n, CHUNK, anti),
                   "noise_in_rel_err": scaled_err(torch, got_n, want),
                   "seeded_rel_err": scaled_err(torch, got_s, want),
                   "pair_rel_err": pair}
            checks.append(rec)
            del noise
            check(rec["noise_in_rel_err"] <= SUM_RTOL
                  and rec["seeded_rel_err"] <= SUM_RTOL,
                  f"K5{'/anti' if anti else ''} disagrees with its plain "
                  f"version at {n} steps")
            check(pair is None or pair <= PAIR_RTOL,
                  f"K5/anti disagrees with unpaired K5 at {n} steps")
    emit({"phase": "chain_past_tile", "card": smi, "rows": CHUNK,
          "n_strikes": len(STRIP), "checks": checks, "rtol": SUM_RTOL,
          "pair_rtol": PAIR_RTOL})


def stream_phases(torch, pc, engine, smi, dev, price_long: tuple,
                  price_main: tuple, reset_counts, read_counts) -> None:
    """The generic path stream, which no kernel runs: the 21-strike strip
    at 1825 steps, plain and paired, on CHAIN_STREAM_CHUNKS chunks
    (``chain_stream``),
    strike 105 against ``price_long`` = (price, stderr) of the K6/K7 run;
    past K8's range, 10,000 steps on the FFT synthesis against the matmul
    synthesis under the same fits (``stream_xlong``); and the cubic
    policy at 365 steps against its own fits on independent plain K1 paths
    (``stream_poly3``; ``price_main``, the quadratic policy's price, is
    printed beside it).  Each price within 5 combined stderr."""
    import dataclasses

    import numpy as np

    i_k = STRIP.index(STRIKE)
    k_pilot = engine._pilot_stream_keys(SEED)[0]
    base = engine.StreamConfig(n_paths=CHUNK * CHAIN_STREAM_CHUNKS,
                               n_steps=LONG_STEPS, chunk_paths=CHUNK,
                               pilot_paths=PILOT, dt=DT,
                               chunks_per_call=CHAIN_STREAM_CHUNKS)
    runs = {}
    for anti in (False, True):
        cfg = dataclasses.replace(base, antithetic=anti)
        chain = engine.StreamingChainPricer(**MARKET, strikes=STRIP,
                                            maturity=LONG_MATURITY,
                                            is_call=IS_CALL, config=cfg,
                                            device=dev)
        check(chain.kernel_family == "stream",
              f"a {LONG_STEPS}-step strip resolved to "
              f"{chain.kernel_family!r}")
        # fit() and price_with_fit() are price()'s two stages, timed apart.
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        fits, fit_s = timed(torch, lambda: chain.fit(k_pilot))
        (prices, stderrs), stream_s = timed(
            torch, lambda: chain.price_with_fit(fits, SEED,
                                                with_stderr=True))
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated()
        wall = fit_s + stream_s
        p_k, se_k = float(prices[i_k]), float(stderrs[i_k])
        sigmas = abs(p_k - price_long[0]) / math.hypot(se_k, price_long[1])
        n_paths = CHUNK * CHAIN_STREAM_CHUNKS
        runs[anti] = (prices, stderrs)
        emit({"phase": "chain_stream", "card": smi, "antithetic": anti,
              "n_paths": n_paths, "n_steps": LONG_STEPS,
              "chunk_paths": CHUNK, "fgn_impl": chain.consts.fgn_impl,
              "strikes": list(STRIP), "prices": prices.tolist(),
              "stderrs": stderrs.tolist(), "wall_s": wall,
              "paths_strikes_per_s": n_paths * len(STRIP) / wall,
              "fit_s": fit_s, "stream_s": stream_s,
              "peak_device_bytes": peak, "launches": launches,
              "price_at_strike": p_k, "stderr_at_strike": se_k,
              "price_long": list(price_long),
              "combined_stderrs_apart": sigmas, "limit": STDERR_SIGMAS})
        check(launches == expected_counts(),
              f"chain_stream launched kernels: {launches}")
        check(bool(np.all(np.isfinite(prices))) and bool(np.all(prices > 0))
              and bool(np.all(np.diff(prices) > 0)),
              "stream strip prices not finite, positive and rising")
        check(sigmas <= STDERR_SIGMAS,
              f"stream strike {STRIKE} is {sigmas:.2f} combined stderr from "
              "price_long")
        del chain
    se_plain, se_anti = runs[False][1], runs[True][1]
    live = se_anti > 0
    ratio = np.where(live, (se_plain / np.where(live, se_anti, 1.0)) ** 2,
                     np.nan)
    emit({"phase": "chain_stream_pairs", "card": smi,
          "variance_ratio_per_strike": [
              None if not math.isfinite(v) else float(v) for v in ratio]})
    check(ratio[i_k] > 1.0,
          f"paired stream strike {STRIKE}'s variance is not below the "
          "plain one's")

    # Past K8's range: the FFT synthesis, its fits, and the matmul
    # synthesis (the plain reference) on the same seed under those fits.
    cfg = engine.StreamConfig(n_paths=XLONG_STREAM_CHUNK * XLONG_STREAM_CHUNKS,
                              n_steps=XLONG_STREAM_STEPS,
                              chunk_paths=XLONG_STREAM_CHUNK,
                              pilot_paths=XLONG_STREAM_CHUNK, dt=DT,
                              pathgen_impl="xla", fgn_impl="fft")
    mat = XLONG_STREAM_STEPS * DT
    fft = engine.StreamingPricer(**MARKET, strike=STRIKE, maturity=mat,
                                 is_call=IS_CALL, config=cfg, device=dev)
    check(fft.kernel_family == "stream", "10,000 steps did not resolve to "
          "the stream")
    reset_counts()
    fits, fit_s = timed(torch, lambda: fft.fit(k_pilot))
    (price, stderr), stream_s = timed(
        torch, lambda: fft.price_with_fit(fits, SEED, with_stderr=True))
    launches = read_counts()
    ref = engine.StreamingPricer(
        **MARKET, strike=STRIKE, maturity=mat, is_call=IS_CALL,
        config=dataclasses.replace(cfg, fgn_impl="matmul"), device=dev)
    (price_ref, se_ref), ref_s = timed(
        torch, lambda: ref.price_with_fit(fits, SEED, with_stderr=True))
    _, (run, start) = engine._pilot_stream_keys(SEED)
    a = fft._stream_paths(rows=XLONG_STREAM_CHUNK, carrier=(run, start))
    b = ref._stream_paths(rows=XLONG_STREAM_CHUNK, carrier=(run, start))
    path_err = float(((a - b).abs() / b.abs()).max())
    del a, b
    sigmas = abs(price - price_ref) / math.hypot(stderr, se_ref)
    emit({"phase": "stream_xlong", "card": smi,
          "n_paths": XLONG_STREAM_CHUNK * XLONG_STREAM_CHUNKS,
          "n_steps": XLONG_STREAM_STEPS, "fgn_impl": "fft", "price": price,
          "stderr": stderr, "fit_s": fit_s, "stream_s": stream_s,
          "launches": launches, "matmul_price_same_fits": price_ref, "matmul_stderr": se_ref,
          "matmul_stream_s": ref_s, "first_chunk_path_rel_err": path_err,
          "path_rtol": PATH_RTOL, "combined_stderrs_apart": sigmas,
          "limit": STDERR_SIGMAS})
    check(launches == expected_counts(),
          f"stream_xlong launched kernels: {launches}")
    check(math.isfinite(price) and 0.0 < price < STRIKE and stderr > 0.0,
          f"stream_xlong price {price} +- {stderr} implausible")
    check(path_err <= PATH_RTOL,
          "the FFT and matmul syntheses disagree on the same noise")
    check(sigmas <= STDERR_SIGMAS,
          f"stream_xlong is {sigmas:.2f} combined stderr from the matmul run")
    del fft, ref

    # The cubic policy at the bench horizon, its fits also priced on
    # independent paths of the plain K1 version (the chol law from Philox).
    cfg = engine.StreamConfig(n_paths=CHUNK * N_CHUNKS, n_steps=N_STEPS,
                              chunk_paths=CHUNK, pilot_paths=PILOT, dt=DT,
                              chunks_per_call=N_CHUNKS, poly_order=3)
    cubic = engine.StreamingPricer(**MARKET, strike=STRIKE,
                                   maturity=MATURITY, is_call=IS_CALL,
                                   config=cfg, device=dev)
    reset_counts()
    fits, fit_s = timed(torch, lambda: cubic.fit(k_pilot))
    (price, stderr), stream_s = timed(
        torch, lambda: cubic.price_with_fit(fits, SEED, with_stderr=True))
    launches = read_counts()
    ref, se_ref = plain_policy_price(torch, pc, engine, fits, POLY3_CHECKED)
    sigmas = abs(price - ref) / math.hypot(stderr, se_ref)
    emit({"phase": "stream_poly3", "card": smi, "n_paths": CHUNK * N_CHUNKS,
          "n_steps": N_STEPS, "kernel_family": cubic.kernel_family,
          "price": price, "stderr": stderr, "fit_s": fit_s,
          "stream_s": stream_s,
          "paths_per_s": CHUNK * N_CHUNKS / (fit_s + stream_s),
          "launches": launches, "plain_k1_chunks": POLY3_CHECKED,
          "plain_k1_price_same_fits": ref, "plain_k1_stderr": se_ref,
          "combined_stderrs_apart": sigmas, "limit": STDERR_SIGMAS,
          "quadratic_main_path_price": list(price_main)})
    check(cubic.kernel_family == "stream" and launches == expected_counts(),
          f"stream_poly3 ran {cubic.kernel_family!r} with {launches}")
    check(math.isfinite(price) and 0.0 < price < STRIKE and stderr > 0.0,
          f"stream_poly3 price {price} +- {stderr} implausible")
    check(sigmas <= STDERR_SIGMAS,
          f"stream_poly3 is {sigmas:.2f} combined stderr from the plain K1 "
          "paths under its fits")


def path_pair_phase(torch, pc, ptc, pfc, smi, dev, key, rel_err) -> dict:
    """K1/anti (365 steps), K6/anti (1825) and K8/anti (4000) at the bench
    chunk of 131072 rows, 65536 drawn: paths elementwise against their
    plain versions seeded and on noise (PATH_RTOL, K8's
    FACTORED_PATH_RTOL), and on noise against the unpaired kernel on the
    concatenated [X; -X] noise (PATH_PAIR_RTOL); then each timed beside
    its plain version, its bound (the product or the FFT once per pair,
    the full [rows, n + 1] output written once) and its yardstick
    (``torch.matmul`` of the drawn rows by Lt', or ``torch.fft.fft`` of
    their complex plane).  Returns their numbers keyed by form."""
    def path_consts(n):
        return pc.make_path_consts(MARKET["s0"], MARKET["xi"], MARKET["h"],
                                   MARKET["eta"], MARKET["r"], n, DT, dev)

    drawn = CHUNK // 2
    c8 = pfc.make_factored_consts(MARKET["s0"], MARKET["xi"], MARKET["h"],
                                  MARKET["eta"], MARKET["r"], XLONG_STEPS,
                                  DT, dev)
    cases = (
        ("K1/anti", pc.pathgen, pc.pathgen_from_noise_ref,
         pc.philox_normals_ref, path_consts(N_STEPS), N_STEPS, PATH_RTOL),
        ("K6/anti", ptc.tiled_pathgen, ptc.pathgen_from_noise_ref,
         pc.philox_normals_ref, path_consts(LONG_STEPS), LONG_STEPS,
         PATH_RTOL),
        ("K8/anti", pfc.factored_pathgen, pfc.factored_pathgen_from_noise_ref,
         pfc.philox_factored_normals_ref, c8, XLONG_STEPS,
         FACTORED_PATH_RTOL))
    out, checks = {}, []
    for form, wrapper, ref, normals, consts, n, rtol in cases:
        noise = normals(key, drawn, n, device=dev)
        want = ref(consts, noise, antithetic=True)
        got = wrapper(consts, rows=CHUNK, key=key, antithetic=True)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"{form}: non-finite paths")
        err_s = rel_err(got, want)
        abs_s = float(torch.max(torch.abs(got - want)))
        del got
        got = wrapper(consts, noise=noise, antithetic=True)
        torch.cuda.synchronize()
        err_n = rel_err(got, want)
        del want
        doubled = torch.cat([noise, -noise], dim=1)
        del noise
        unpaired = wrapper(consts, noise=doubled)
        torch.cuda.synchronize()
        err_pair = rel_err(got, unpaired)
        del got, unpaired, doubled
        checks.append({"form": form, "n_steps": n, "seeded_rel_err": err_s,
                       "noise_in_rel_err": err_n, "pair_rel_err": err_pair,
                       "rtol": rtol, "pair_rtol": PATH_PAIR_RTOL})
        check(err_s <= rtol and err_n <= rtol,
              f"{form} disagrees with its plain version")
        check(err_pair <= PATH_PAIR_RTOL,
              f"{form} disagrees with its unpaired form on [X; -X]")

        def run(wrapper=wrapper, consts=consts):
            wrapper(consts, rows=CHUNK, key=key, antithetic=True)

        def plain(ref=ref, normals=normals, consts=consts, n=n):
            ref(consts, normals(key, drawn, n, device=dev), antithetic=True)

        out_bytes = 4 * CHUNK * (n + 1)
        if form == "K8/anti":
            a = torch.randn((drawn, pfc.fgn.next_pow2(n)),
                            dtype=torch.complex64, device=dev)
            lib_ms = time_ms(torch, lambda: torch.fft.fft(a, dim=1), reps=10)
            b_ms, b_by = factored_bound_ms(CHUNK, n, out_bytes,
                                           antithetic=True)
        else:
            a = torch.randn((drawn, n), device=dev)
            lt = consts.lt_half
            lib_ms = time_ms(torch, lambda: torch.matmul(a, lt), reps=10)
            b_ms, b_by = bound_ms(CHUNK, n, out_bytes, antithetic=True)
        del a
        out[form] = {"ms": time_ms(torch, run, 5),
                     "plain_ms": time_ms(torch, plain, 2),
                     "library_ms": lib_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "max_abs_err": abs_s}
    emit({"phase": "path_pair_forms", "card": smi, "rows": CHUNK,
          "checks": checks, "times": out, "library_calls":
          "torch.matmul [65536,n]x[n,n] float32 (K1/anti, K6/anti: the "
          "drawn rows' fGN product); torch.fft.fft of the drawn rows' "
          "[65536, m2] complex64 plane (K8/anti)"})
    return out


def bounds_phases(torch, pc, engine, closed_form, smi, dev, prices: dict,
                  reset_counts, read_counts) -> dict:
    """The streamed duality bounds at full width.  ``bounds``: the bench
    option (365 steps, 76 chunks), plain and paired, through
    ``price_with_bounds`` with the launch counts read around it (K1 once
    for the pilot and 76 times, or K1/anti 76 times, and no priced
    kernel), lower <= upper with finite stderrs, and the lower bound
    within SUM_RTOL of ``price`` on the same seed (``prices``: "plain"
    and "anti", each (price, stderr)); then fit and stream timed apart.
    ``bounds_long``: 1825 steps on K6 and K6/anti, 4000 on K8 and
    K8/anti, BOUNDS_LONG_CHUNKS chunks each, with the peak device bytes.
    ``bounds_gbm``: the GBM limit, where the binomial American value
    must lie inside the bracket within GBM_SIGMAS stderr.  Returns the
    pair forms' launches in these runs."""
    import dataclasses

    k_pilot = engine._pilot_stream_keys(SEED)[0]
    pair_launches = {}

    def one(name, pricer, n_chunks, pilot_kernel, form):
        """One bracket: fit and stream timed apart (wall = their sum),
        through price_with_bounds when the run is the full 76 chunks."""
        anti = pricer.config.antithetic
        n_paths = n_chunks * CHUNK
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        if n_chunks == N_CHUNKS:
            (lo, up, lo_se, up_se), wall = timed(
                torch, lambda: pricer.price_with_bounds(SEED,
                                                        with_stderr=True))
            launches = read_counts()
            fit, fit_s = timed(torch, lambda: pricer.bounds_fit(k_pilot))
            _, stream_s = timed(torch, lambda: pricer.bounds_with_fit(
                fit, SEED, n_paths))
        else:
            fit, fit_s = timed(torch, lambda: pricer.bounds_fit(k_pilot))
            (lo, up, lo_se, up_se), stream_s = timed(
                torch, lambda: pricer.bounds_with_fit(fit, SEED, n_paths,
                                                      with_stderr=True))
            launches = read_counts()
            wall = fit_s + stream_s
        peak = torch.cuda.max_memory_allocated()
        want = expected_counts(**{pilot_kernel: 1 if anti else 1 + n_chunks},
                               **({form: n_chunks} if anti else {}))
        rec = {"phase": name, "card": smi, "n_paths": n_paths,
               "n_steps": pricer.config.n_steps, "antithetic": anti,
               "kernel_family": pricer.kernel_family, "lower": lo,
               "upper": up, "lower_stderr": lo_se, "upper_stderr": up_se,
               "duality_gap": up - lo, "lam": float(fit[2]), "wall_s": wall,
               "fit_s": fit_s, "stream_s": stream_s,
               "paths_per_s": n_paths / wall, "peak_device_bytes": peak,
               "launches": launches}
        check(launches == want, f"{name} launches {launches}, want "
              f"{pilot_kernel} once and {form if anti else pilot_kernel} "
              f"{n_chunks} times and nothing else")
        check(math.isfinite(lo) and math.isfinite(up) and lo <= up,
              f"{name}: lower {lo} and upper {up} not an ordered bracket")
        check(all(math.isfinite(v) and v > 0 for v in (lo_se, up_se)),
              f"{name}: stderrs {lo_se}, {up_se} not finite and positive")
        if anti:
            pair_launches[form] = launches[form]
        return rec, fit

    base = engine.StreamConfig(n_paths=CHUNK * N_CHUNKS, n_steps=N_STEPS,
                               chunk_paths=CHUNK, pilot_paths=PILOT, dt=DT,
                               chunks_per_call=N_CHUNKS)
    upper_se = {}
    for anti in (False, True):
        pricer = engine.StreamingPricer(
            **MARKET, strike=STRIKE, maturity=MATURITY, is_call=IS_CALL,
            config=dataclasses.replace(base, antithetic=anti), device=dev)
        rec, _ = one("bounds", pricer, N_CHUNKS, "pathgen", "K1/anti")
        price, _ = prices["anti" if anti else "plain"]
        rel = abs(rec["lower"] / price - 1.0)
        upper_se[anti] = rec["upper_stderr"]
        extra = {}
        if anti:
            extra["upper_variance_ratio"] = (upper_se[False]
                                             / upper_se[True]) ** 2
        emit({**rec, "price_same_seed": price, "lower_vs_price_rel_err": rel,
              "rtol": SUM_RTOL, **extra})
        check(rel <= SUM_RTOL, f"bounds (antithetic={anti}): the lower bound "
              f"is {rel:.2e} from price() on the same seed")
        del pricer

    for n, family, pilot_kernel, form, kw in (
            (LONG_STEPS, "tiled", "tiled_pathgen", "K6/anti", {}),
            (XLONG_STEPS, "factored", "factored_pathgen", "K8/anti", {})):
        for anti in (False, True):
            cfg = dataclasses.replace(
                base, n_paths=CHUNK * BOUNDS_LONG_CHUNKS, n_steps=n,
                chunks_per_call=BOUNDS_LONG_CHUNKS, antithetic=anti, **kw)
            pricer = engine.StreamingPricer(**MARKET, strike=STRIKE,
                                            maturity=n * DT, is_call=IS_CALL,
                                            config=cfg, device=dev)
            check(pricer.kernel_family == family,
                  f"{n} steps resolved to {pricer.kernel_family!r}")
            rec, _ = one("bounds_long", pricer, BOUNDS_LONG_CHUNKS,
                         pilot_kernel, form)
            emit({**rec, "reduced": {"n_chunks": {
                "from": N_CHUNKS, "to": BOUNDS_LONG_CHUNKS}}})
            del pricer

    g = GBM
    dt = g["maturity"] / g["n_steps"]
    amer = closed_form.binomial_american(g["s0"], g["strike"], g["r"],
                                         g["sigma"], g["maturity"], IS_CALL,
                                         steps=2000)
    for anti in (False, True):
        cfg = dataclasses.replace(base, n_steps=g["n_steps"], dt=dt,
                                  antithetic=anti)
        pricer = engine.StreamingPricer(
            g["s0"], g["sigma"] ** 2, g["h"], g["eta"], g["rho"], g["r"],
            g["strike"], g["maturity"], IS_CALL, cfg, device=dev)
        reset_counts()
        (lo, up, lo_se, up_se), wall = timed(
            torch, lambda: pricer.price_with_bounds(SEED, with_stderr=True))
        launches = read_counts()
        inside = (lo - GBM_SIGMAS * lo_se <= amer
                  <= up + GBM_SIGMAS * up_se)
        emit({"phase": "bounds_gbm", "card": smi, "n_paths": CHUNK * N_CHUNKS,
              "n_steps": g["n_steps"], "antithetic": anti, "market": g,
              "lower": lo, "upper": up, "lower_stderr": lo_se,
              "upper_stderr": up_se, "binomial_american": amer,
              "gap_over_value": (up - lo) / amer, "gap_limit": GBM_GAP,
              "sigmas": GBM_SIGMAS, "wall_s": wall, "launches": launches})
        check(launches == expected_counts(
            pathgen=1 if anti else 1 + N_CHUNKS,
            **({"K1/anti": N_CHUNKS} if anti else {})),
            f"bounds_gbm launches {launches}")
        check(inside, f"bounds_gbm: the binomial value {amer} lies outside "
              f"[{lo} - {GBM_SIGMAS} x {lo_se}, {up} + {GBM_SIGMAS} x "
              f"{up_se}]")
        check((up - lo) / amer < GBM_GAP,
              f"bounds_gbm: the gap {(up - lo) / amer:.3f} of the value "
              f"passes {GBM_GAP}")
        del pricer
    return pair_launches


def plain_policy_price(torch, pc, engine, fits, n_chunks: int) -> tuple:
    """(price, stderr) of the bench option under ``fits`` (any order) on
    n_chunks chunks of whole paths from the plain K1 version, seeded apart
    from every other run (run word of seed SEED + 1)."""
    import numpy as np

    consts = pc.make_path_consts(MARKET["s0"], MARKET["xi"], MARKET["h"],
                                 MARKET["eta"], MARKET["r"], N_STEPS, DT,
                                 fits.mu.device)
    _, (run, start) = engine._pilot_stream_keys(SEED + 1)
    totals = []
    for i in range(n_chunks):
        paths = pc.pathgen_from_noise_ref(consts, pc.philox_normals_ref(
            pc._fold_words(run, start + i), CHUNK, N_STEPS,
            device=fits.mu.device))
        totals.append(float(engine.lsm_policy_value(
            paths, fits, MARKET["r"], STRIKE, MATURITY, DT, IS_CALL)[0]))
        del paths
    totals = np.asarray(totals)
    return (float(totals.sum() / (n_chunks * CHUNK)),
            float(engine._chunk_stderr(totals.sum(), (totals ** 2).sum(),
                                       n_chunks, CHUNK)))


def spectral_path_forms(torch, pc, smi, dev, key, rel_err, kernel: str,
                        wrapper, consts, library) -> dict:
    """``kernel``/spectral and its pair form at the bench chunk of 131072
    rows: paths elementwise against the plain versions, seeded (so also
    against ``philox_spectral_normals_ref``) and on noise (PATH_RTOL),
    the pair form on [3, rows / 2, n] against the unpaired kernel on the
    concatenated [X; -X] noise (PATH_PAIR_RTOL), then each timed beside
    its plain version, the two-product yardstick ``library(rows)`` and
    its bound (the dense products, once per pair).  Returns their numbers
    keyed by form."""
    n, out, checks = consts.n_steps, {}, []
    for anti in (False, True):
        form = f"{kernel}/{pc.form_name(anti, spectral=True)}"
        drawn = CHUNK // 2 if anti else CHUNK
        noise = pc.philox_spectral_normals_ref(key, drawn, n, device=dev)
        want = pc.pathgen_from_noise_ref(consts, noise, anti)
        got = wrapper(consts, rows=CHUNK, key=key, antithetic=anti)
        torch.cuda.synchronize()
        finite = bool(torch.isfinite(got).all())
        err_s = rel_err(got, want)
        abs_s = float(torch.max(torch.abs(got - want)))
        del got
        got = wrapper(consts, noise=noise, antithetic=anti)
        torch.cuda.synchronize()
        err_n = rel_err(got, want)
        del want
        err_pair = None
        if anti:
            unpaired = wrapper(consts, noise=torch.cat([noise, -noise], 1))
            torch.cuda.synchronize()
            err_pair = rel_err(got, unpaired)
            del unpaired
        del got, noise
        checks.append({"form": form, "seeded_rel_err": err_s,
                       "noise_in_rel_err": err_n, "pair_rel_err": err_pair})
        check(finite and err_s <= PATH_RTOL and err_n <= PATH_RTOL,
              f"{form} disagrees with its plain version")
        check(err_pair is None or err_pair <= PATH_PAIR_RTOL,
              f"{form} disagrees with its unpaired form on [X; -X]")

        def run(anti=anti):
            wrapper(consts, rows=CHUNK, key=key, antithetic=anti)

        def plain(anti=anti, drawn=drawn):
            pc.pathgen_from_noise_ref(consts, pc.philox_spectral_normals_ref(
                key, drawn, n, device=dev), anti)

        b_ms, b_by = bound_ms(CHUNK, n, 4 * CHUNK * (n + 1),
                              antithetic=anti, spectral=True)
        out[form] = {"ms": time_ms(torch, run, 5),
                     "plain_ms": time_ms(torch, plain, 2),
                     "library_ms": library(drawn), "bound_ms": b_ms,
                     "bound_by": b_by, "max_abs_err": abs_s}
    emit({"phase": "spectral_forms", "card": smi, "kernel": kernel,
          "rows": CHUNK, "n_steps": n, "block_paths": consts.block_paths,
          "checks": checks, "times": out, "rtol": PATH_RTOL,
          "pair_rtol": PATH_PAIR_RTOL})
    return out


def spectral_library(torch, consts, dev):
    """rows -> ms of the spectral form's yardstick: two torch.matmul,
    [rows, n] x Cr' and [rows, n] x Ci', in the matrices' dtype (float32
    with TF32 off, or bf16 inputs with float32 sums)."""
    def library(rows):
        dtype = consts.cr_half.dtype
        a = torch.randn((rows, consts.n_steps), device=dev).to(dtype)
        b = torch.randn((rows, consts.n_steps), device=dev).to(dtype)
        ms = time_ms(torch, lambda: (torch.matmul(a, consts.cr_half),
                                     torch.matmul(b, consts.ci_half)),
                     reps=10)
        del a, b
        return ms
    return library


def fft_library(torch, n: int, dev):
    """rows -> ms of K8/K9's yardstick: torch.fft.fft of a [rows, m2]
    complex64 plane (the synthesis alone)."""
    def library(rows):
        a = torch.randn((rows, 1 << (n - 1).bit_length()),
                        dtype=torch.complex64, device=dev)
        ms = time_ms(torch, lambda: torch.fft.fft(a, dim=1), reps=10)
        del a
        return ms
    return library


def spectral_price_phase(torch, pc, engine, smi, name: str, pricer, pilot,
                         form: str, n_chunks: int, chunk_ref, ref: tuple,
                         ref_name: str, reset_counts, read_counts) -> dict:
    """One spectral price: price()'s fit and stream (``fit_and_price``)
    with the launch counts read around them (``pilot`` once, ``form``
    n_chunks times), its first LONG_CHECKED chunks against the plain
    versions under the same fits, and the price within STDERR_SIGMAS
    combined stderr of ``ref`` = (price, stderr) of the same law.
    Returns the record."""
    reset_counts()
    fits, price, stderr, fit_s, stream_s = fit_and_price(torch, engine,
                                                         pricer)
    launches = read_counts()
    wall = fit_s + stream_s
    checked = pricer.price_with_fit(fits, SEED, n_paths=LONG_CHECKED * CHUNK)
    checked_plain = plain_stream_mean(
        pc, engine, pricer, fits, SEED, LONG_CHECKED, STRIKE,
        pc.philox_spectral_normals_ref, chunk_ref)
    checked_rel = abs(checked / checked_plain - 1.0)
    sigmas = abs(price - ref[0]) / math.hypot(stderr, ref[1])
    n_paths = CHUNK * n_chunks
    rec = {"phase": name, "card": smi, "n_paths": n_paths,
           "n_steps": pricer.config.n_steps, "fgn_form": "spectral",
           "tiled_impl": pricer.config.tiled_impl,
           "kernel_family": pricer.kernel_family, "price": price,
           "stderr": stderr, "wall_s": wall, "paths_per_s": n_paths / wall,
           "fit_s": fit_s, "stream_s": stream_s, "launches": launches,
           "checked_chunks": LONG_CHECKED, "checked_price": checked,
           "checked_plain_price": checked_plain,
           "checked_rel_err": checked_rel, "rtol": SUM_RTOL,
           ref_name: ref[0], f"{ref_name}_stderr": ref[1],
           "combined_stderrs_apart": sigmas, "limit": STDERR_SIGMAS}
    emit(rec)
    check(launches == expected_counts(**{pilot: 1, form: n_chunks}),
          f"{name} launches {launches}, want {pilot} once and {form} "
          f"{n_chunks} times and nothing else")
    check(math.isfinite(price) and 0.0 < price < STRIKE,
          f"{name} price {price} outside (0, strike)")
    check(math.isfinite(stderr) and 0.0 < stderr < 0.01 * price,
          f"{name} stderr {stderr} implausible")
    check(checked_rel <= SUM_RTOL, f"{name} disagrees with the plain path")
    check(sigmas <= STDERR_SIGMAS,
          f"{name} is {sigmas:.2f} combined stderr from {ref_name}")
    return {**rec, "fits": fits}


def spectral_chain_phases(torch, pc, cc, engine, smi, dev, key, base,
                          price_spectral: tuple, times: dict,
                          reset_counts, read_counts) -> dict:
    """K5/spectral and K5/spectral/anti at the bench shape against their
    plain versions (21 strikes; the pair on [X; -X]), timed; then
    ``chain_spectral``: the 21-strike strip at full width, plain and
    paired (K1/spectral once, the K5 form 76 times), its first 8 chunks
    against the plain versions under the same fits and strike 105 within
    5 combined stderr of ``price_spectral``; and at 400 steps (K8 once and
    the K5 form SPECTRAL_PAST_TILE_CHUNKS times) against a single-strike
    price on K8/K9 of the same seed and length.  Returns each K5 form's
    launches in its run."""
    import dataclasses

    import numpy as np

    k_pilot = engine._pilot_stream_keys(SEED)[0]
    i_k, k_n = STRIP.index(STRIKE), len(STRIP)
    launches, strips = {}, {}
    for anti in (False, True):
        form = f"K5/{pc.form_name(anti, spectral=True)}"
        chain = engine.StreamingChainPricer(
            **MARKET, strikes=STRIP, maturity=MATURITY, is_call=IS_CALL,
            config=dataclasses.replace(base, antithetic=anti), device=dev)
        consts = chain.chain_consts
        fits = chain.fit(k_pilot)
        tables = chain._tables(fits, chain.strikes)
        drawn = CHUNK // 2 if anti else CHUNK
        noise = pc.philox_spectral_normals_ref(key, drawn, N_STEPS,
                                               device=dev)
        want = cc.priced_chain_from_noise_ref(consts, tables, noise,
                                              IS_CALL, anti)
        got_n = cc.priced_chain(consts, tables, IS_CALL, noise=noise,
                                antithetic=anti)
        got_s = cc.priced_chain(consts, tables, IS_CALL, rows=CHUNK,
                                key=key, antithetic=anti)
        pair = None
        if anti:
            pair = scaled_err(torch, got_n, cc.priced_chain(
                consts, tables, IS_CALL,
                noise=torch.cat([noise, -noise], dim=1)))
        torch.cuda.synchronize()
        errs = [scaled_err(torch, g, want) for g in (got_n, got_s)]
        swept = swept_cells(torch, torch.exp(pc._log_paths_ref(
            consts, noise, anti)), tables[:, 0, :N_STEPS],
            tables[:, 1, :N_STEPS])
        del noise
        check(max(errs) <= SUM_RTOL, f"{form} disagrees with its plain "
              "version")
        check(pair is None or pair <= PAIR_RTOL,
              f"{form} disagrees with its unpaired form on [X; -X]")
        blocks = CHUNK // cc.block_paths_for(N_STEPS, CHUNK, anti, True)

        def run(anti=anti):
            cc.priced_chain(consts, tables, IS_CALL, rows=CHUNK, key=key,
                            antithetic=anti)

        def plain(anti=anti, drawn=drawn):
            cc.priced_chain_from_noise_ref(
                consts, tables, pc.philox_spectral_normals_ref(
                    key, drawn, N_STEPS, device=dev), IS_CALL, anti)

        b_ms, b_by = bound_ms(CHUNK, N_STEPS, 4 * blocks * k_n,
                              policy_rows=1 + 4 * k_n, swept=swept,
                              antithetic=anti, spectral=True)
        times[form] = {"ms": time_ms(torch, run, 5),
                       "plain_ms": time_ms(torch, plain, 2),
                       "library_ms": spectral_library(torch, consts,
                                                      dev)(drawn),
                       "bound_ms": b_ms, "bound_by": b_by,
                       "max_abs_err": float(torch.max(torch.abs(
                           got_s - want)))}
        times[form].update(k5_split(torch, cc, consts, tables,
                                    times[form]["ms"], key, 5, anti))
        emit({"phase": "spectral_forms", "card": smi, "kernel": "K5",
              "form": form, "rows": CHUNK, "n_steps": N_STEPS,
              "n_strikes": k_n, "swept_cells": swept,
              "block_paths": CHUNK // blocks, "noise_in_rel_err": errs[0],
              "seeded_rel_err": errs[1], "pair_rel_err": pair,
              "rtol": SUM_RTOL, "pair_rtol": PAIR_RTOL,
              "times": times[form]})

        reset_counts()
        (prices, stderrs), wall = timed(
            torch, lambda: chain.price(SEED, with_stderr=True))
        counts = read_counts()
        fits, fit_s = timed(torch, lambda: chain.fit(k_pilot))
        _, stream_s = timed(torch, lambda: chain.price_with_fit(fits, SEED))
        checked = chain.price_with_fit(fits, SEED,
                                       n_paths=CHAIN_CHECKED * CHUNK)
        checked_rel = scaled_err(torch, torch.from_numpy(checked),
                                 torch.from_numpy(plain_chain_means(
                                     torch, pc, cc, engine, chain, fits,
                                     SEED, CHAIN_CHECKED, anti)))
        p_k, se_k = float(prices[i_k]), float(stderrs[i_k])
        sigmas = abs(p_k - price_spectral[0]) / math.hypot(
            se_k, price_spectral[1])
        strips[anti] = stderrs
        n_paths = CHUNK * N_CHUNKS
        rec = {"phase": "chain_spectral", "card": smi, "n_paths": n_paths,
               "n_steps": N_STEPS, "antithetic": anti,
               "strikes": list(STRIP), "prices": prices.tolist(),
               "stderrs": stderrs.tolist(), "wall_s": wall,
               "paths_strikes_per_s": n_paths * k_n / wall, "fit_s": fit_s,
               "stream_s": stream_s, "launches": counts,
               "checked_chunks": CHAIN_CHECKED,
               "checked_rel_err": checked_rel, "rtol": SUM_RTOL,
               "price_at_strike": p_k, "stderr_at_strike": se_k,
               "price_spectral": price_spectral[0],
               "combined_stderrs_apart": sigmas, "limit": STDERR_SIGMAS}
        if anti:
            live = stderrs > 0      # time-0 strikes have no variance
            rec["variance_ratio_per_strike"] = [
                float((strips[False][j] / stderrs[j]) ** 2) if live[j]
                else None for j in range(k_n)]
        emit(rec)
        check(counts == expected_counts(**{"K1/spectral": 1,
                                           form: N_CHUNKS}),
              f"chain_spectral launches {counts}")
        check(bool(np.all(np.isfinite(prices))) and
              bool(np.all(np.diff(prices) > 0)),
              "chain_spectral prices not finite and rising with the strike")
        check(checked_rel <= SUM_RTOL,
              "chain_spectral disagrees with the plain path")
        check(sigmas <= STDERR_SIGMAS, f"chain_spectral strike {STRIKE} is "
              f"{sigmas:.2f} combined stderr from price_spectral")
        launches[form] = counts[form]
        del chain

    # Past the single tile: the K8 pilot, K5 on its own spectral constants.
    n, m = SPECTRAL_PAST_TILE_STEPS, SPECTRAL_PAST_TILE_CHUNKS
    cfg = dataclasses.replace(base, n_paths=m * CHUNK, n_steps=n,
                              chunks_per_call=m)
    one = engine.StreamingPricer(**MARKET, strike=STRIKE, maturity=n * DT,
                                 is_call=IS_CALL, config=cfg, device=dev)
    single, single_se = one.price(SEED, with_stderr=True)
    del one
    for anti in (False, True):
        form = f"K5/{pc.form_name(anti, spectral=True)}"
        chain = engine.StreamingChainPricer(
            **MARKET, strikes=STRIP, maturity=n * DT, is_call=IS_CALL,
            config=dataclasses.replace(cfg, antithetic=anti), device=dev)
        check(chain.kernel_family == "factored" and
              chain.chain_consts.spectral,
              f"the {n}-step spectral strip resolved to "
              f"{chain.kernel_family!r}")
        reset_counts()
        (prices, stderrs), wall = timed(
            torch, lambda: chain.price(SEED, with_stderr=True))
        counts = read_counts()
        fits = chain.fit(k_pilot)
        checked = chain.price_with_fit(fits, SEED,
                                       n_paths=CHAIN_CHECKED * CHUNK)
        checked_rel = scaled_err(torch, torch.from_numpy(checked),
                                 torch.from_numpy(plain_chain_means(
                                     torch, pc, cc, engine, chain, fits,
                                     SEED, CHAIN_CHECKED, anti)))
        p_k, se_k = float(prices[i_k]), float(stderrs[i_k])
        sigmas = abs(p_k - single) / math.hypot(se_k, single_se)
        emit({"phase": "chain_spectral", "card": smi, "n_paths": m * CHUNK,
              "n_steps": n, "antithetic": anti,
              "kernel_family": chain.kernel_family,
              "prices": prices.tolist(), "stderrs": stderrs.tolist(),
              "wall_s": wall, "launches": counts,
              "checked_chunks": CHAIN_CHECKED,
              "checked_rel_err": checked_rel, "rtol": SUM_RTOL,
              "price_at_strike": p_k, "stderr_at_strike": se_k,
              "single_strike_price_k9": single,
              "single_strike_stderr_k9": single_se,
              "combined_stderrs_apart": sigmas, "limit": STDERR_SIGMAS,
              "reduced": {"n_chunks": {"from": N_CHUNKS, "to": m}}})
        check(counts == expected_counts(**{"factored_pathgen": 1, form: m}),
              f"chain_spectral at {n} steps launches {counts}")
        check(bool(np.all(np.isfinite(prices))) and
              bool(np.all(np.diff(prices) > 0)),
              f"the {n}-step spectral strip is not finite and rising")
        check(checked_rel <= SUM_RTOL,
              f"the {n}-step spectral strip disagrees with the plain path")
        check(sigmas <= STDERR_SIGMAS, f"the {n}-step spectral strip at "
              f"{STRIKE} is {sigmas:.2f} combined stderr from K9's price")
        del chain
    return launches


def spectral_bounds_phase(torch, pc, engine, smi, dev, base, prices: dict,
                          reset_counts, read_counts) -> dict:
    """``bounds_spectral``: the bench bracket on K1/spectral (pilot and 76
    chunks) and on K1/spectral/anti (76 chunks), no priced kernel, the
    lower bound within SUM_RTOL of the same seed's ``prices`` ("plain":
    price_spectral, "anti": its paired form); then the spectral slab's
    paired bracket at 1825 steps (K6/spectral once, K6/spectral/anti
    BOUNDS_LONG_CHUNKS times).  Returns the pair forms' launches."""
    import dataclasses

    k_pilot = engine._pilot_stream_keys(SEED)[0]
    pair_launches = {}
    runs = [(N_STEPS, N_CHUNKS, anti, "K1") for anti in (False, True)]
    runs.append((LONG_STEPS, BOUNDS_LONG_CHUNKS, True, "K6"))
    for n, m, anti, kernel in runs:
        cfg = dataclasses.replace(
            base, n_paths=m * CHUNK, n_steps=n, chunks_per_call=m,
            antithetic=anti, tiled_impl="slab" if kernel == "K6" else "auto")
        pricer = engine.StreamingPricer(**MARKET, strike=STRIKE,
                                        maturity=n * DT, is_call=IS_CALL,
                                        config=cfg, device=dev)
        reset_counts()
        fit, fit_s = timed(torch, lambda: pricer.bounds_fit(k_pilot))
        (lo, up, lo_se, up_se), stream_s = timed(
            torch, lambda: pricer.bounds_with_fit(fit, SEED, m * CHUNK,
                                                  with_stderr=True))
        launches = read_counts()
        pilot, form = f"{kernel}/spectral", f"{kernel}/spectral/anti"
        want = expected_counts(**{pilot: 1 if anti else 1 + m},
                               **({form: m} if anti else {}))
        rec = {"phase": "bounds_spectral", "card": smi,
               "n_paths": m * CHUNK, "n_steps": n, "antithetic": anti,
               "kernel_family": pricer.kernel_family, "lower": lo,
               "upper": up, "lower_stderr": lo_se, "upper_stderr": up_se,
               "duality_gap": up - lo, "lam": float(fit[2]),
               "wall_s": fit_s + stream_s, "fit_s": fit_s,
               "stream_s": stream_s,
               "paths_per_s": m * CHUNK / (fit_s + stream_s),
               "launches": launches}
        if n == N_STEPS:
            price = prices["anti" if anti else "plain"][0]
            rec.update(price_same_seed=price,
                       lower_vs_price_rel_err=abs(lo / price - 1.0),
                       rtol=SUM_RTOL)
        else:
            rec["reduced"] = {"n_chunks": {"from": N_CHUNKS, "to": m}}
        emit(rec)
        check(launches == want, f"bounds_spectral launches {launches}, "
              f"want {want}")
        check(math.isfinite(lo) and math.isfinite(up) and lo <= up,
              f"bounds_spectral: lower {lo} and upper {up} not ordered")
        check(all(math.isfinite(v) and v > 0 for v in (lo_se, up_se)),
              f"bounds_spectral: stderrs {lo_se}, {up_se}")
        check(n != N_STEPS or rec["lower_vs_price_rel_err"] <= SUM_RTOL,
              f"bounds_spectral (antithetic={anti}): the lower bound is "
              "off price_spectral on the same seed")
        if anti:
            pair_launches[form] = launches[form]
        del pricer
    return pair_launches


def spectral_phases(torch, pc, cc, ptc, engine, smi, dev, key, rel_err,
                    refs: dict, reset_counts, read_counts) -> list:
    """The spectral fGN form (``fgn_form="spectral"``) on every kernel
    that has it: ``spectral_forms`` (K1, K2, K5 at 365 steps, K6, K7 at
    1825, each form against its plain version and its pair against the
    negated noise, timed), ``price_spectral`` (1e7 x 365, within 5
    combined stderr of the chol ``price``, refs["price"]),
    ``price_spectral_vr_*`` (its three estimator forms),
    ``chain_spectral`` (365 and 400 steps), ``price_spectral_slab``
    (1e7 x 1825 on K6/K7 with tiled_impl="slab", within 5 combined stderr
    of the factored K9 price refs["price_factored"], the same law) and
    its estimator forms at SPECTRAL_SLAB_FORM_CHUNKS chunks
    (``price_spectral_slab_*``), and ``bounds_spectral``.  Returns the
    spectral forms' entries of the kernels line and price_spectral's
    (price, stderr)."""
    import dataclasses

    base = engine.StreamConfig(n_paths=CHUNK * N_CHUNKS, n_steps=N_STEPS,
                               chunk_paths=CHUNK, pilot_paths=PILOT, dt=DT,
                               chunks_per_call=N_CHUNKS, fgn_form="spectral")
    k_pilot = engine._pilot_stream_keys(SEED)[0]
    times, launches = {}, {}

    # K1 and K2 at the bench horizon, then the price and its forms.
    pricer = engine.StreamingPricer(**MARKET, strike=STRIKE,
                                    maturity=MATURITY, is_call=IS_CALL,
                                    config=base, device=dev)
    consts = pricer.consts
    check(pricer.kernel_family == "single" and consts.spectral,
          f"spectral at {N_STEPS} steps resolved to "
          f"{pricer.kernel_family!r}")
    lib = spectral_library(torch, consts, dev)
    times.update(spectral_path_forms(torch, pc, smi, dev, key, rel_err, "K1",
                                     pc.pathgen, consts, lib))
    table = pricer._make_rows(pricer.fit(k_pilot))
    times.update(forms_phase(
        torch, pc, smi, "spectral_forms", "K2", pc.priced_chunk,
        pc.priced_chunk_from_noise_ref, consts, table,
        lambda k, rows: pc.philox_spectral_normals_ref(k, rows, N_STEPS,
                                                       device=dev),
        key, lambda anti: lib(CHUNK // 2 if anti else CHUNK),
        lambda anti, cv: bound_ms(
            CHUNK, N_STEPS, 4 * (2 if cv else 1)
            * (CHUNK // pc.priced_block_paths(consts, CHUNK, anti)),
            antithetic=anti, with_cv=cv, spectral=True), spectral=True))
    rec = spectral_price_phase(
        torch, pc, engine, smi, "price_spectral", pricer, "K1/spectral",
        "K2/spectral", N_CHUNKS, pc.priced_chunk_from_noise_ref,
        refs["price"], "price_chol", reset_counts, read_counts)
    price_spectral = (rec["price"], rec["stderr"])
    for form in ("K1/spectral", "K2/spectral"):
        launches[form] = rec["launches"][form]
    del pricer
    vr = {}
    for suffix, form in VR_FORMS:
        form_key, count, vr[suffix] = vr_price_phase(
            torch, pc, engine, smi, dev, f"price_spectral_vr_{suffix}", "K2",
            N_STEPS, {**form, "fgn_form": "spectral"}, "K1/spectral",
            (*price_spectral, rec["stream_s"]),
            pc.philox_spectral_normals_ref, pc.priced_chunk_from_noise_ref,
            reset_counts, read_counts)
        launches[form_key] = count

    launches.update(spectral_chain_phases(
        torch, pc, cc, engine, smi, dev, key, base, price_spectral, times,
        reset_counts, read_counts))

    # The slab: K6 and K7 at 1825 steps (tiled_impl="slab").
    cfg = dataclasses.replace(base, n_steps=LONG_STEPS, tiled_impl="slab")
    pricer = engine.StreamingPricer(**MARKET, strike=STRIKE,
                                    maturity=LONG_MATURITY, is_call=IS_CALL,
                                    config=cfg, device=dev)
    consts = pricer.consts
    check(pricer.kernel_family == "tiled" and consts.spectral,
          f"the spectral slab resolved to {pricer.kernel_family!r}")
    lib = spectral_library(torch, consts, dev)
    times.update(spectral_path_forms(torch, pc, smi, dev, key, rel_err, "K6",
                                     ptc.tiled_pathgen, consts, lib))
    table = pricer._make_rows(pricer.fit(k_pilot))
    times.update(forms_phase(
        torch, pc, smi, "spectral_forms", "K7", ptc.tiled_priced_chunk,
        ptc.priced_chunk_from_noise_ref, consts, table,
        lambda k, rows: pc.philox_spectral_normals_ref(k, rows, LONG_STEPS,
                                                       device=dev),
        key, lambda anti: lib(CHUNK // 2 if anti else CHUNK),
        lambda anti, cv: bound_ms(
            CHUNK, LONG_STEPS, 4 * (2 if cv else 1)
            * (CHUNK // ptc.block_paths_for(CHUNK, anti)),
            antithetic=anti, with_cv=cv, spectral=True), spectral=True))
    rec = spectral_price_phase(
        torch, pc, engine, smi, "price_spectral_slab", pricer, "K6/spectral",
        "K7/spectral", N_CHUNKS, ptc.priced_chunk_from_noise_ref,
        refs["price_factored"], "price_factored", reset_counts, read_counts)
    for form in ("K6/spectral", "K7/spectral"):
        launches[form] = rec["launches"][form]
    m = SPECTRAL_SLAB_FORM_CHUNKS
    plain_m, stream_m = timed(torch, lambda: pricer.price_with_fit(
        rec["fits"], SEED, n_paths=m * CHUNK, with_stderr=True))
    del pricer
    for suffix, form in VR_FORMS:
        form_key, count, _ = vr_price_phase(
            torch, pc, engine, smi, dev, f"price_spectral_slab_{suffix}",
            "K7", LONG_STEPS,
            {**form, "fgn_form": "spectral", "tiled_impl": "slab"},
            "K6/spectral", (*plain_m, stream_m),
            pc.philox_spectral_normals_ref, ptc.priced_chunk_from_noise_ref,
            reset_counts, read_counts, n_chunks=m)
        launches[form_key] = count

    launches.update(spectral_bounds_phase(
        torch, pc, engine, smi, dev, base,
        {"plain": price_spectral, "anti": vr["anti"]}, reset_counts,
        read_counts))
    emit({"phase": "times_spectral", "card": smi, "library_call":
          "two torch.matmul, [rows, n] x Cr' and [rows, n] x Ci' float32 "
          "(the drawn rows' spectral fGN products)", "kernels": times})
    return [kernel_record(form, launches, t["ms"], t["plain_ms"],
                          t["bound_ms"], t["bound_by"], t["max_abs_err"],
                          t["library_ms"], **split_of(t))
            for form, t in times.items()], price_spectral


def quad_forms_phase(torch, pc, smi, kernel: str, priced, chunk_ref,
                     consts, table, normals, key, library, bound, log_paths,
                     spectral: bool = False, bf16: bool = False,
                     phase: str = "quadratic_forms",
                     plain_reps: int = 2) -> dict:
    """``phase``: one priced kernel's quadratic form (``bf16``: its bf16
    form), plain and CV, at the bench chunk of 131072 rows under the
    policy_rows ``table``:
    each lane against its plain version, seeded and on noise (SUM_RTOL),
    then timed beside its plain version (``plain_time`` over
    ``plain_reps`` runs), the library yardstick ``library()`` and its
    bound ``bound(with_cv, cells)`` = (ms, by),
    ``cells`` the cells the policy tests on this noise (each path up to
    its first hit, from ``log_paths(consts, noise)``).  Returns the forms'
    numbers keyed kernel/form."""
    out, checks = {}, []
    noise = normals(key, CHUNK)
    _, first, _ = pc.quadratic_stops(torch.exp(log_paths(consts, noise)),
                                     table, IS_CALL)
    cells = int((first + 1).sum())
    del first
    for cv in (False, True):
        form = f"{kernel}/{pc.form_name(False, cv, spectral, True, bf16)}"
        kw = dict(with_cv=cv, policy_form="quadratic")
        want = lanes(chunk_ref(consts, table, noise, STRIKE, IS_CALL, False,
                               cv, "quadratic"), cv)
        got_n = lanes(priced(consts, table, STRIKE, IS_CALL, noise=noise,
                             **kw), cv)
        got_s = lanes(priced(consts, table, STRIKE, IS_CALL, rows=CHUNK,
                             key=key, **kw), cv)
        torch.cuda.synchronize()
        err_n = max(abs(g / w - 1.0) for g, w in zip(got_n, want))
        err_s = max(abs(g / w - 1.0) for g, w in zip(got_s, want))
        checks.append({"form": form, "plain": want, "noise_in": got_n,
                       "seeded": got_s, "noise_in_rel_err": err_n,
                       "seeded_rel_err": err_s})
        check(err_n <= SUM_RTOL and err_s <= SUM_RTOL,
              f"{form} disagrees with its plain version")

        def run(kw=kw):
            priced(consts, table, STRIKE, IS_CALL, rows=CHUNK, key=key, **kw)

        def plain(cv=cv):
            chunk_ref(consts, table, normals(key, CHUNK), STRIKE, IS_CALL,
                      False, cv, "quadratic")

        b_ms, b_by = bound(cv, cells)
        out[form] = {"ms": time_ms(torch, run, 5),
                     "plain_ms": plain_time(torch, plain, plain_reps),
                     "library_ms": library(), "bound_ms": b_ms,
                     "bound_by": b_by,
                     "max_abs_err": max(abs(g - w)
                                        for g, w in zip(got_s, want))}
    del noise
    emit({"phase": phase, "card": smi, "kernel": kernel,
          "fgn_form": getattr(consts, "fgn_form", "spectral"),
          "fgn_matmul_dtype": consts.fgn_dtype,
          "rows": CHUNK, "n_steps": consts.n_steps, "policy_cells": cells,
          "checks": checks, "times": out, "rtol": SUM_RTOL})
    return out


def quad_chain_forms(torch, pc, cc, engine, smi, dev, key, base,
                     spectral: bool) -> dict:
    """``quadratic_forms`` of K5: K5/quad (or K5/spectral/quad) on the
    21-strike strip's policy_rows tables at 365 steps and 131072 rows,
    seeded and noise-in against its plain version (SUM_RTOL of each
    strike's scale), timed beside the fGN-product yardstick and its bound
    (QUAD_SWEEP_OPS per strike-cell swept, counted from this noise's
    stops).  Returns its numbers keyed by form."""
    import dataclasses

    chain = engine.StreamingChainPricer(
        **MARKET, strikes=STRIP, maturity=MATURITY, is_call=IS_CALL,
        config=dataclasses.replace(base, chain_policy_form="quadratic",
                                   fgn_form="spectral" if spectral
                                   else "auto"), device=dev)
    consts, k_n = chain.chain_consts, len(STRIP)
    form = f"K5/{pc.form_name(False, spectral=spectral, quadratic=True)}"
    tables = chain._tables(chain.fit(engine._pilot_stream_keys(SEED)[0]),
                           chain.strikes)
    check(tables.shape[1] == 8, "the quadratic strip's tables are not "
          "policy_rows")
    noise = pc.normals_ref(consts, key, CHUNK, device=dev)
    want = cc.priced_chain_from_noise_ref(consts, tables, noise, IS_CALL,
                                          policy_form="quadratic")
    got_n = cc.priced_chain(consts, tables, IS_CALL, noise=noise,
                            policy_form="quadratic")
    got_s = cc.priced_chain(consts, tables, IS_CALL, rows=CHUNK, key=key,
                            policy_form="quadratic")
    torch.cuda.synchronize()
    errs = [scaled_err(torch, g, want) for g in (got_n, got_s)]
    s = torch.exp(pc._log_paths_ref(consts, noise))
    swept = sum(int((pc.quadratic_stops(s, tab, IS_CALL, True)[1] + 1).sum())
                for tab in tables)
    del noise, s
    check(max(errs) <= SUM_RTOL, f"{form} disagrees with its plain version")
    blocks = CHUNK // cc.block_paths_for(N_STEPS, CHUNK, False, spectral,
                                         quadratic=True)

    def run():
        cc.priced_chain(consts, tables, IS_CALL, rows=CHUNK, key=key,
                        policy_form="quadratic")

    def plain():
        cc.priced_chain_from_noise_ref(
            consts, tables, pc.normals_ref(consts, key, CHUNK, device=dev),
            IS_CALL, policy_form="quadratic")

    if spectral:
        lib_ms = spectral_library(torch, consts, dev)(CHUNK)
    else:
        a = torch.randn((CHUNK, N_STEPS), device=dev)
        lib_ms = time_ms(torch, lambda: torch.matmul(a, consts.lt_half),
                         reps=10)
        del a
    b_ms, b_by = bound_ms(CHUNK, N_STEPS, 4 * blocks * k_n,
                          policy_rows=1 + 8 * k_n, swept=swept,
                          sweep_ops=QUAD_SWEEP_OPS, spectral=spectral)
    out = {form: {"ms": time_ms(torch, run, 5),
                  "plain_ms": time_ms(torch, plain, 2), "library_ms": lib_ms,
                  "bound_ms": b_ms, "bound_by": b_by,
                  "max_abs_err": float(torch.max(torch.abs(got_s - want)))}}
    out[form].update(k5_split(torch, cc, consts, tables, out[form]["ms"],
                              key, 5, policy_form="quadratic"))
    emit({"phase": "quadratic_forms", "card": smi, "kernel": "K5",
          "form": form, "rows": CHUNK, "n_steps": N_STEPS,
          "n_strikes": k_n, "swept_cells": swept,
          "block_paths": CHUNK // blocks, "noise_in_rel_err": errs[0],
          "seeded_rel_err": errs[1], "rtol": SUM_RTOL, "times": out[form]})
    return out


def quad_price_phase(torch, engine, smi, dev, name: str, n_steps: int,
                     n_chunks: int, cfg_kw: dict, want: dict, ref: tuple,
                     ref_name: str, reset_counts, read_counts,
                     rtol: float = 0.0, fits=None):
    """One price under ``policy_form="quadratic"``: fit() and
    price_with_fit(), price()'s two stages, with the launch counts read
    around them (exactly ``want``: the pilot kernel once and the quadratic
    form n_chunks times, no boundary form), held against ``ref`` = (price,
    stderr) of ``ref_name``: within ``rtol`` relative where ``rtol`` is
    set (the boundary form's price on the same seed and chunks), else
    within STDERR_SIGMAS combined stderr.  Given ``fits`` (the policy of
    another run's pilot on the same seed) it streams under them and
    ``want`` names no pilot.  Returns (pricer, price, stderr, launches,
    fits)."""
    cfg = engine.StreamConfig(n_paths=CHUNK * n_chunks, n_steps=n_steps,
                              chunk_paths=CHUNK, pilot_paths=PILOT, dt=DT,
                              chunks_per_call=n_chunks,
                              policy_form="quadratic", **cfg_kw)
    pricer = engine.StreamingPricer(**MARKET, strike=STRIKE,
                                    maturity=n_steps * DT, is_call=IS_CALL,
                                    config=cfg, device=dev)
    reused = fits is not None
    reset_counts()
    if not reused:
        fits, fit_s = timed(torch, lambda: pricer.fit(
            engine._pilot_stream_keys(SEED)[0]))
    (price, stderr), stream_s = timed(
        torch, lambda: pricer.price_with_fit(fits, SEED, with_stderr=True))
    launches = read_counts()
    n_paths = CHUNK * n_chunks
    rel = abs(price / ref[0] - 1.0)
    sigmas = abs(price - ref[0]) / math.hypot(stderr, ref[1])
    wall = stream_s if reused else fit_s + stream_s
    rec = {"phase": name, "card": smi, "n_paths": n_paths,
           "n_steps": n_steps, "policy_form": "quadratic", **cfg_kw,
           "kernel_family": pricer.kernel_family, "price": price,
           "stderr": stderr, "wall_s": wall, "paths_per_s": n_paths / wall,
           "fit_s": None if reused else fit_s, "stream_s": stream_s,
           "fits_of_another_run": reused, "launches": launches,
           "ref": ref_name, "ref_price": ref[0], "ref_stderr": ref[1],
           "rel_err": rel, "combined_stderrs_apart": sigmas,
           "limit": rtol or STDERR_SIGMAS}
    if n_chunks != N_CHUNKS:
        rec["reduced"] = {"n_chunks": {"from": N_CHUNKS, "to": n_chunks}}
    emit(rec)
    check(launches == expected_counts(**want),
          f"{name} launches {launches}, want {want} and nothing else")
    check(math.isfinite(price) and 0.0 < price < STRIKE,
          f"{name} price {price} outside (0, strike)")
    check(math.isfinite(stderr) and stderr > 0.0,
          f"{name} stderr {stderr} not finite and positive")
    if rtol:
        check(rel <= rtol, f"{name} is {rel:.2e} from {ref_name} on the "
              "same seed")
    else:
        check(sigmas <= STDERR_SIGMAS,
              f"{name} is {sigmas:.2f} combined stderr from {ref_name}")
    return pricer, price, stderr, launches, fits


def quad_chain_phase(torch, engine, smi, dev, base, n_steps: int,
                     n_chunks: int, fgn_form: str, want: dict,
                     reset_counts, read_counts) -> dict:
    """``chain_quadratic``: the 21-strike strip under
    ``chain_policy_form="quadratic"``, fit() and price_with_fit() (price()'s
    two stages) with the launches read around them (exactly ``want``),
    then the boundary strip under the same
    fits on the same seed: each strike within SUM_RTOL of it, or within
    STDERR_SIGMAS combined stderr where a step's exercise set is two
    intervals (the boundary form keeps one).  Returns its launches."""
    import dataclasses

    import numpy as np

    cfg = dataclasses.replace(base, n_paths=CHUNK * n_chunks,
                              n_steps=n_steps, chunks_per_call=n_chunks,
                              fgn_form=fgn_form)
    chains = {form: engine.StreamingChainPricer(
        **MARKET, strikes=STRIP, maturity=n_steps * DT, is_call=IS_CALL,
        config=dataclasses.replace(cfg, chain_policy_form=form), device=dev)
        for form in ("quadratic", "boundary")}
    reset_counts()
    fits, fit_s = timed(torch, lambda: chains["quadratic"].fit(
        engine._pilot_stream_keys(SEED)[0]))
    (prices, stderrs), stream_s = timed(
        torch, lambda: chains["quadratic"].price_with_fit(fits, SEED,
                                                          with_stderr=True))
    counts = read_counts()
    wall = fit_s + stream_s
    b_prices, b_stderrs = chains["boundary"].price_with_fit(
        fits, SEED, with_stderr=True)
    rel = np.abs(prices / b_prices - 1.0)
    sigmas = np.abs(prices - b_prices) / np.maximum(
        np.hypot(stderrs, b_stderrs), 1e-300)
    ok = (rel <= SUM_RTOL) | (sigmas <= STDERR_SIGMAS)
    n_paths = CHUNK * n_chunks
    rec = {"phase": "chain_quadratic", "card": smi, "n_paths": n_paths,
           "n_steps": n_steps, "fgn_form": fgn_form,
           "kernel_family": chains["quadratic"].kernel_family,
           "strikes": list(STRIP), "prices": prices.tolist(),
           "stderrs": stderrs.tolist(), "wall_s": wall, "fit_s": fit_s,
           "stream_s": stream_s,
           "paths_strikes_per_s": n_paths * len(STRIP) / wall,
           "launches": counts, "boundary_prices": b_prices.tolist(),
           "rel_err_per_strike": rel.tolist(),
           "combined_stderrs_apart": sigmas.tolist(), "rtol": SUM_RTOL,
           "limit": STDERR_SIGMAS}
    if n_chunks != N_CHUNKS:
        rec["reduced"] = {"n_chunks": {"from": N_CHUNKS, "to": n_chunks}}
    emit(rec)
    check(counts == expected_counts(**want),
          f"chain_quadratic at {n_steps} steps launches {counts}, want "
          f"{want}")
    check(bool(np.all(np.isfinite(prices))) and
          bool(np.all(np.diff(prices) > 0)),
          f"the {n_steps}-step quadratic strip is not finite and rising")
    check(bool(np.all(ok)), f"the {n_steps}-step quadratic strip is off "
          "the boundary strip on the same seed")
    return counts


def quadratic_phases(torch, pc, cc, ptc, pfc, engine, smi, dev, key,
                     refs: dict, reset_counts, read_counts) -> list:
    """The quadratic exercise-policy forms of K2, K7, K9 and K5:
    ``quadratic_forms`` (each of the 12 forms against its plain version at
    131072 rows: K2 and K5 at 365 steps, K7 at 1825, K9 at 4000, timed);
    ``price_quadratic`` (1e7 x 365 on K2/quad, within 1e-4 of the
    boundary ``price`` on the same seed, its first 8 chunks against the
    plain versions, and the bounds' lower bound within 1e-5 of it) and
    ``price_quadratic_cv``; the spectral single tile
    (``price_quadratic_spectral[_cv]``), the chol and spectral slabs
    (``price_quadratic_long[_cv]``, ``price_quadratic_slab[_cv]``) and the
    factored family (``price_quadratic_factored[_cv]``) cut to QUAD_CHUNKS
    chunks; and ``chain_quadratic`` (21 strikes at 365 steps, chol and
    spectral, and at 400 steps on the K8 pilot).  ``refs`` holds the
    boundary runs' (price, stderr) and fits.  Returns the 12 forms'
    entries of the kernels line, launches from their price runs."""
    import functools

    times, launches = {}, {}
    single = {f: pc.make_path_consts(
        MARKET["s0"], MARKET["xi"], MARKET["h"], MARKET["eta"], MARKET["r"],
        N_STEPS, DT, dev, fgn_form=f) for f in pc.FGN_FORMS}
    slab = {f: pc.make_path_consts(
        MARKET["s0"], MARKET["xi"], MARKET["h"], MARKET["eta"], MARKET["r"],
        LONG_STEPS, DT, dev, fgn_form=f) for f in pc.FGN_FORMS}
    c9 = pfc.make_factored_consts(MARKET["s0"], MARKET["xi"], MARKET["h"],
                                  MARKET["eta"], MARKET["r"], XLONG_STEPS,
                                  DT, dev)

    def table_of(n, fits):
        return engine._fused_rows_builder(MARKET["r"], STRIKE, n * DT, DT, n,
                                          IS_CALL, "quadratic")(fits)

    def matmul_ms(consts, n):
        if consts.spectral:
            return lambda: spectral_library(torch, consts, dev)(CHUNK)

        def library():
            a = torch.randn((CHUNK, n), device=dev)
            ms = time_ms(torch, lambda: torch.matmul(a, consts.lt_half),
                         reps=10)
            del a
            return ms
        return library


    for f, consts in single.items():
        spec = f == "spectral"
        times.update(quad_forms_phase(
            torch, pc, smi, "K2", pc.priced_chunk,
            pc.priced_chunk_from_noise_ref, consts,
            table_of(N_STEPS, refs["fits"]),
            lambda k, rows, c=consts: pc.normals_ref(c, k, rows, device=dev),
            key, matmul_ms(consts, N_STEPS),
            lambda cv, cells, c=consts, spec=spec: bound_ms(
                CHUNK, N_STEPS, 4 * (2 if cv else 1)
                * (CHUNK // pc.priced_block_paths(c, CHUNK)),
                policy_rows=8, with_cv=cv, spectral=spec, quad_cells=cells),
            pc._log_paths_ref, spec))
    for f, consts in slab.items():
        spec = f == "spectral"
        times.update(quad_forms_phase(
            torch, pc, smi, "K7", ptc.tiled_priced_chunk,
            ptc.priced_chunk_from_noise_ref, consts,
            table_of(LONG_STEPS, refs["long_fits"]),
            lambda k, rows, c=consts: pc.normals_ref(c, k, rows, device=dev),
            key, matmul_ms(consts, LONG_STEPS),
            lambda cv, cells, spec=spec: bound_ms(
                CHUNK, LONG_STEPS, 4 * (2 if cv else 1)
                * (CHUNK // ptc.block_paths_for(CHUNK)), policy_rows=8,
                with_cv=cv, spectral=spec, quad_cells=cells),
            pc._log_paths_ref, spec))
    times.update(quad_forms_phase(
        torch, pc, smi, "K9", pfc.factored_priced_chunk,
        pfc.factored_priced_chunk_from_noise_ref, c9,
        table_of(XLONG_STEPS, refs["xlong_fits"]),
        lambda k, rows: pfc.philox_factored_normals_ref(k, rows, XLONG_STEPS,
                                                        device=dev),
        key, lambda: fft_library(torch, XLONG_STEPS, dev)(CHUNK),
        lambda cv, cells: factored_bound_ms(
            CHUNK, XLONG_STEPS, 4 * (2 if cv else 1)
            * (CHUNK // pfc.paths_per_block(XLONG_STEPS)), policy_rows=8,
            with_cv=cv, quad_cells=cells),
        pfc._log_paths_ref))
    base = engine.StreamConfig(n_paths=CHUNK * N_CHUNKS, n_steps=N_STEPS,
                               chunk_paths=CHUNK, pilot_paths=PILOT, dt=DT,
                               chunks_per_call=N_CHUNKS)
    for spec in (False, True):
        times.update(quad_chain_forms(torch, pc, cc, engine, smi, dev, key,
                                      base, spec))
    del single, slab, c9

    # The bench cell, its bounds and its CV form.
    k_pilot = engine._pilot_stream_keys(SEED)[0]
    pricer, price, stderr, counts, fits = quad_price_phase(
        torch, engine, smi, dev, "price_quadratic", N_STEPS, N_CHUNKS,
        {}, {"pathgen": 1, "K2/quad": N_CHUNKS}, refs["price"], "price",
        reset_counts, read_counts, rtol=SUM_RTOL)
    launches["K2/quad"] = counts["K2/quad"]
    checked = pricer.price_with_fit(fits, SEED, n_paths=LONG_CHECKED * CHUNK)
    checked_plain = plain_stream_mean(
        pc, engine, pricer, fits, SEED, LONG_CHECKED, STRIKE,
        chunk_ref=functools.partial(pc.priced_chunk_from_noise_ref,
                                    policy_form="quadratic"))
    checked_rel = abs(checked / checked_plain - 1.0)
    reset_counts()
    fit, bounds_fit_s = timed(torch, lambda: pricer.bounds_fit(k_pilot))
    (lo, up, lo_se, up_se), bounds_stream_s = timed(
        torch, lambda: pricer.bounds_with_fit(fit, SEED, with_stderr=True))
    b_counts = read_counts()
    lower_rel = abs(lo / price - 1.0)
    emit({"phase": "price_quadratic_checks", "card": smi,
          "checked_chunks": LONG_CHECKED,
          "checked_price": checked, "checked_plain_price": checked_plain,
          "checked_rel_err": checked_rel, "rtol": SUM_RTOL,
          "bounds": {"lower": lo, "upper": up, "lower_stderr": lo_se,
                     "upper_stderr": up_se, "fit_s": bounds_fit_s,
                     "stream_s": bounds_stream_s, "launches": b_counts,
                     "lower_vs_price_rel_err": lower_rel,
                     "rtol": QUAD_LOWER_RTOL}})
    check(checked_rel <= SUM_RTOL,
          "price_quadratic disagrees with the plain path")
    check(b_counts == expected_counts(pathgen=1 + N_CHUNKS),
          f"the quadratic bounds launch {b_counts}, want K1 only")
    check(math.isfinite(lo) and math.isfinite(up) and lo <= up,
          f"the quadratic bounds {lo}, {up} are not ordered")
    check(lower_rel <= QUAD_LOWER_RTOL, f"the quadratic lower bound is "
          f"{lower_rel:.2e} from price_quadratic on the same seed")
    del pricer
    got = {"price_quadratic": (price, stderr)}
    _, p, se, counts, _ = quad_price_phase(
        torch, engine, smi, dev, "price_quadratic_cv", N_STEPS,
        N_CHUNKS, {"control_variate": True},
        {"pathgen": 1, "K2/quad/cv": N_CHUNKS}, refs["price_cv"],
        "price_cv", reset_counts, read_counts, rtol=SUM_RTOL)
    got["price_quadratic_cv"] = (p, se)
    launches["K2/quad/cv"] = counts["K2/quad/cv"]

    # The cut runs: the spectral single tile and slab against the chol
    # quadratic prices (the same law), the chol slab and the factored
    # family against their boundary prices.  The CV run fits; the plain
    # run streams under its policy (a CVFit's fits).
    m = QUAD_CHUNKS
    runs = (
        ("price_quadratic_spectral", N_STEPS, {"fgn_form": "spectral"},
         "K1/spectral", "K2/spectral/quad", "price_quadratic"),
        ("price_quadratic_long", LONG_STEPS, {}, "tiled_pathgen", "K7/quad",
         "price_long"),
        ("price_quadratic_slab", LONG_STEPS,
         {"fgn_form": "spectral", "tiled_impl": "slab"}, "K6/spectral",
         "K7/spectral/quad", "price_quadratic_long"),
        ("price_quadratic_factored", XLONG_STEPS, {}, "factored_pathgen",
         "K9/quad", "price_xlong"))
    for name, n, kw, pilot, form, ref in runs:
        cv_fit = None
        for cv in (True, False):
            suffix = "_cv" if cv else ""
            ref_key = ref + suffix
            key_form = form + suffix.replace("_", "/")
            want = {key_form: m, **({} if cv_fit else {pilot: 1})}
            _, p, se, counts, fit = quad_price_phase(
                torch, engine, smi, dev, name + suffix, n, m,
                {**kw, "control_variate": cv}, want,
                got.get(ref_key) or refs[ref_key], ref_key, reset_counts,
                read_counts, fits=cv_fit and cv_fit.fits)
            cv_fit = cv_fit or fit
            got[name + suffix] = (p, se)
            launches[key_form] = counts[key_form]

    # The strips.
    for n, n_chunks, fgn_form, pilot, form in (
            (N_STEPS, N_CHUNKS, "auto", "pathgen", "K5/quad"),
            (N_STEPS, N_CHUNKS, "spectral", "K1/spectral",
             "K5/spectral/quad"),
            (SPECTRAL_PAST_TILE_STEPS, QUAD_CHUNKS, "spectral",
             "factored_pathgen", "K5/spectral/quad")):
        counts = quad_chain_phase(torch, engine, smi, dev, base, n,
                                  n_chunks, fgn_form,
                                  {pilot: 1, form: n_chunks}, reset_counts,
                                  read_counts)
        launches.setdefault(form, counts[form])
    emit({"phase": "times_quadratic", "card": smi, "library_call":
          "the boundary rows' yardsticks: torch.matmul of the fGN product "
          "(two, [rows, n] x Cr' and x Ci', spectral) or torch.fft.fft of "
          "the [131072, m2] complex64 plane (K9)", "kernels": times})
    return [kernel_record(form, launches, t["ms"], t["plain_ms"],
                          t["bound_ms"], t["bound_by"], t["max_abs_err"],
                          t["library_ms"], **split_of(t))
            for form, t in times.items()]


def bf16_library(torch, consts, dev, extra=()):
    """rows -> ms of the bf16 form's yardstick: torch.matmul of a bf16
    [rows, n] plane by the bf16 Lt' (the fGN product alone), and by each
    bf16 matrix of ``extra`` (K3/K4: dLt' too)."""
    def library(rows):
        a = torch.randn((rows, consts.n_steps), device=dev).to(torch.bfloat16)
        ms = time_ms(torch, lambda: [torch.matmul(a, m) for m in (
            consts.lt_half, *extra)], reps=10)
        del a
        return ms
    return library


def bf16_path_forms(torch, pc, smi, dev, key, kernel: str, wrapper, consts,
                    consts32, library, phase: str = "bf16_forms",
                    spectral: bool = False, normals=None, ref=None,
                    rtol: float = PATH_RTOL, bound=None,
                    plain_reps: int = 2) -> dict:
    """``kernel``/bf16 (``spectral``: ``kernel``/bf16/spectral) and its pair
    form at the bench chunk of 131072 rows: paths elementwise against the
    bf16 plain version ``ref`` (default K1's), seeded and on the noise of
    ``normals(key, rows)`` (default K1/K2's stream) within ``rtol``, and
    BF16_CLOSER times closer to it than to the float32 plain version on
    the same noise (the discriminating check); the pair form against the
    unpaired kernel on the concatenated [X; -X] noise (PATH_PAIR_RTOL);
    then each timed beside its plain version, the bf16 product's
    yardstick ``library(rows)`` and its bound ``bound(antithetic)``
    (default the single tile's chol bound); the plain version's time is
    the mean of ``plain_reps`` runs (``plain_time``).  Emits ``phase``;
    returns their numbers keyed by form."""
    n, out, checks = consts.n_steps, {}, []
    ref = ref or pc.pathgen_from_noise_ref
    normals = normals or (lambda k, rows: pc.philox_normals_ref(
        k, rows, n, device=dev))
    bound = bound or (lambda anti: bound_ms(
        CHUNK, n, 4 * CHUNK * (n + 1), antithetic=anti, bf16=True))
    for anti in (False, True):
        form = f"{kernel}/{pc.form_name(anti, spectral=spectral, bf16=True)}"
        drawn = CHUNK // 2 if anti else CHUNK
        noise = normals(key, drawn)
        want = ref(consts, noise, anti)
        got = wrapper(consts, rows=CHUNK, key=key, antithetic=anti)
        torch.cuda.synchronize()
        finite = bool(torch.isfinite(got).all())
        err_s = float(torch.max(torch.abs(got - want) / want))
        abs_s = float(torch.max(torch.abs(got - want)))
        want32 = ref(consts32, noise, anti)
        err_32 = float(torch.max(torch.abs(got - want32) / want32))
        del got, want32
        got = wrapper(consts, noise=noise, antithetic=anti)
        torch.cuda.synchronize()
        err_n = float(torch.max(torch.abs(got - want) / want))
        del want
        err_pair = None
        if anti:
            unpaired = wrapper(consts, noise=torch.cat([noise, -noise], 1))
            torch.cuda.synchronize()
            err_pair = float(torch.max(torch.abs(got - unpaired) / unpaired))
            del unpaired
        del got, noise
        checks.append({"form": form, "seeded_rel_err": err_s,
                       "noise_in_rel_err": err_n,
                       "float32_plain_rel_err": err_32,
                       "pair_rel_err": err_pair})
        check(finite and err_s <= rtol and err_n <= rtol,
              f"{form} disagrees with its plain version")
        check(err_s * BF16_CLOSER <= err_32,
              f"{form} is not {BF16_CLOSER}x closer to the bf16 plain "
              f"version ({err_s:.2e}) than to the float32 one "
              f"({err_32:.2e})")
        check(err_pair is None or err_pair <= PATH_PAIR_RTOL,
              f"{form} disagrees with its unpaired form on [X; -X]")

        def run(anti=anti):
            wrapper(consts, rows=CHUNK, key=key, antithetic=anti)

        def plain(anti=anti, drawn=drawn):
            ref(consts, normals(key, drawn), anti)

        b_ms, b_by = bound(anti)
        out[form] = {"ms": time_ms(torch, run, 5),
                     "plain_ms": plain_time(torch, plain, plain_reps),
                     "library_ms": library(drawn), "bound_ms": b_ms,
                     "bound_by": b_by, "max_abs_err": abs_s}
    emit({"phase": phase, "card": smi, "kernel": kernel,
          "rows": CHUNK, "n_steps": n, "checks": checks, "times": out,
          "rtol": rtol, "closer_than_float32": BF16_CLOSER,
          "pair_rtol": PATH_PAIR_RTOL})
    return out


def bf16_price_phase(torch, pc, engine, lsm_fit, smi, name: str, pricer,
                     pilot: str, form: str, n_checked: int, chunk_ref,
                     ref: tuple, ref_name: str, reset_counts,
                     read_counts, normals=None, fits=None,
                     rtol: float = 0.0) -> dict:
    """One bf16 price: the pilot fit and the stream (the pricer's chunks)
    timed apart with the launch counts read around both (``pilot`` once,
    ``form`` once a chunk, nothing else); against the plain versions (the
    whole price, pilot included, when ``n_checked`` is N_CHUNKS; else the
    first n_checked chunks under the same fits, on the stream of
    ``normals``, default K1/K2's) within SUM_RTOL, and within
    STDERR_SIGMAS combined stderr of ``ref`` = (price, stderr) on the
    same seed (with ``rtol``: within rtol of it, relative).  Given
    ``fits`` (another run's policy from the same pilot: same seed,
    family, fGN form and dtype; a CVFit under the control variate) it
    streams under them and ``pilot`` is not launched.  Returns the record
    with the fits."""
    k_pilot = engine._pilot_stream_keys(SEED)[0]
    n_chunks = pricer.config.n_paths // CHUNK
    reused = fits is not None
    reset_counts()
    if not reused:
        fits, fit_s = timed(torch, lambda: pricer.fit(k_pilot))
    (price, stderr), stream_s = timed(
        torch, lambda: pricer.price_with_fit(fits, SEED, with_stderr=True))
    launches = read_counts()
    fit_s = None if reused else fit_s
    wall = stream_s + (fit_s or 0.0)
    if n_checked == N_CHUNKS and not reused:
        checked, plain = price, plain_price(pc, engine, lsm_fit, pricer,
                                            SEED)
    else:
        checked = pricer.price_with_fit(fits, SEED,
                                        n_paths=n_checked * CHUNK)
        plain = plain_stream_mean(
            pc, engine, pricer, fits, SEED, n_checked, STRIKE,
            normals=normals, chunk_ref=chunk_ref,
            antithetic=pricer.config.antithetic,
            with_cv=pricer.config.control_variate)
    rel = abs(checked / plain - 1.0)
    sigmas = abs(price - ref[0]) / math.hypot(stderr, ref[1])
    ref_rel = abs(price / ref[0] - 1.0)
    n_paths = CHUNK * n_chunks
    rec = {"phase": name, "card": smi, "n_paths": n_paths,
           "n_steps": pricer.config.n_steps, "fgn_matmul_dtype": "bfloat16",
           "fgn_form": pricer.config.fgn_form,
           "policy_form": pricer.config.policy_form,
           "kernel_family": pricer.kernel_family, "price": price,
           "stderr": stderr, "wall_s": wall, "paths_per_s": n_paths / wall,
           "fit_s": fit_s, "stream_s": stream_s,
           "fits_of_another_run": reused, "launches": launches,
           "checked_chunks": n_checked, "checked_price": checked,
           "checked_plain_price": plain, "checked_rel_err": rel,
           "rtol": SUM_RTOL, ref_name: ref[0], f"{ref_name}_stderr": ref[1],
           "combined_stderrs_apart": sigmas, "limit": STDERR_SIGMAS}
    if rtol:
        rec.update(ref_rel_err=ref_rel, limit=rtol)
    reduced = {}
    if n_checked != N_CHUNKS:
        reduced["checked_chunks"] = {"from": N_CHUNKS, "to": n_checked}
    if n_chunks != N_CHUNKS:
        reduced["n_chunks"] = {"from": N_CHUNKS, "to": n_chunks}
    if reduced:
        rec["reduced"] = reduced
    emit(rec)
    want = {form: n_chunks, **({} if reused else {pilot: 1})}
    check(launches == expected_counts(**want),
          f"{name} launches {launches}, want {want} and nothing else")
    check(math.isfinite(price) and 0.0 < price < STRIKE,
          f"{name} price {price} outside (0, strike)")
    check(math.isfinite(stderr) and 0.0 < stderr < 0.01 * price,
          f"{name} stderr {stderr} implausible")
    check(rel <= SUM_RTOL, f"{name} disagrees with the plain path")
    if rtol:
        check(ref_rel <= rtol,
              f"{name} is {ref_rel:.2e} from {ref_name} on the same seed")
    else:
        check(sigmas <= STDERR_SIGMAS,
              f"{name} is {sigmas:.2f} combined stderr from {ref_name}")
    return {**rec, "fits": fits}


def bf16_estimator_phases(torch, pc, engine, smi, dev, kernel: str,
                          path_kernel: str, base, fits, chunk_ref, prefix,
                          reset_counts, read_counts, normals=None,
                          spectral: bool = False, bounds: bool = True,
                          m: int = BF16_FORM_CHUNKS,
                          both_name: str = "anti_cv") -> tuple:
    """The bf16 forms of the estimators on ``m`` chunks: each VR form's
    price (``price_with_fit`` on the plain pilot's ``fits``; the control
    variate's beta and centre from one CV fit of the same pilot) with its
    launches read around it (the form m times, nothing else), its first
    BF16_FORM_CHECKED chunks against the plain versions (on the stream of
    ``normals``, default K1/K2's), within STDERR_SIGMAS combined stderr
    of the plain bf16 price on the same chunks, with a variance ratio > 1;
    then, with ``bounds``, the paired bounds (``bf16_bounds_phase``).
    ``spectral`` names the spectral forms' keys; the paired CV form's
    phase ends in ``both_name``.  Returns (the forms' launches, the CV
    fit, the plain bf16 price on the m chunks as (price, stderr, stream
    seconds))."""
    import dataclasses

    n = base.n_steps
    cfg = dataclasses.replace(base, n_paths=m * CHUNK, chunks_per_call=m)

    def pricer_of(**kw):
        return engine.StreamingPricer(**MARKET, strike=STRIKE,
                                      maturity=n * DT, is_call=IS_CALL,
                                      config=dataclasses.replace(cfg, **kw),
                                      device=dev)

    plain_pricer = pricer_of()
    (p_plain, se_plain), stream_plain = timed(
        torch, lambda: plain_pricer.price_with_fit(fits, SEED,
                                                   with_stderr=True))
    del plain_pricer
    cv_fit, cv_fit_s = timed(torch, lambda: pricer_of(
        control_variate=True).fit(engine._pilot_stream_keys(SEED)[0]))
    launches = {}
    for suffix, form in VR_FORMS:
        anti = form.get("antithetic", False)
        cv = form.get("control_variate", False)
        key = f"{kernel}/{pc.form_name(anti, cv, spectral, bf16=True)}"
        pricer = pricer_of(**form)
        f = cv_fit if cv else fits
        reset_counts()
        (price, stderr), stream_s = timed(
            torch, lambda: pricer.price_with_fit(f, SEED, with_stderr=True))
        counts = read_counts()
        checked = pricer.price_with_fit(f, SEED,
                                        n_paths=BF16_FORM_CHECKED * CHUNK)
        checked_plain = plain_stream_mean(
            pc, engine, pricer, f, SEED, BF16_FORM_CHECKED, STRIKE,
            normals=normals, chunk_ref=chunk_ref, antithetic=anti,
            with_cv=cv)
        rel = abs(checked / checked_plain - 1.0)
        sigmas = abs(price - p_plain) / math.hypot(stderr, se_plain)
        ratio = (se_plain / stderr) ** 2
        name = f"{prefix}_{both_name if anti and cv else suffix}"
        emit({"phase": name, "card": smi, "n_paths": m * CHUNK,
              "n_steps": n, **form, "fgn_matmul_dtype": "bfloat16",
              "fgn_form": base.fgn_form, "tiled_impl": base.tiled_impl,
              "kernel_family": pricer.kernel_family,
              "price": price, "stderr": stderr, "stream_s": stream_s,
              "paths_per_s": m * CHUNK / stream_s, "launches": counts,
              "beta": cv_fit.beta if cv else None,
              "cv_fit_s": cv_fit_s if cv else None,
              "checked_chunks": BF16_FORM_CHECKED, "checked_price": checked,
              "checked_plain_price": checked_plain, "checked_rel_err": rel,
              "rtol": SUM_RTOL, "plain_price": p_plain,
              "plain_stderr": se_plain, "combined_stderrs_apart": sigmas,
              "limit": STDERR_SIGMAS, "variance_ratio": ratio,
              "variance_ratio_per_stream_s": ratio * stream_plain / stream_s,
              "reduced": {"n_chunks": {"from": N_CHUNKS, "to": m}}})
        check(counts == expected_counts(**{key: m}),
              f"{name} launches {counts}, want {key} {m} times and nothing "
              "else")
        check(math.isfinite(price) and 0.0 < price < STRIKE
              and math.isfinite(stderr) and stderr > 0.0,
              f"{name} price {price} +- {stderr} implausible")
        check(rel <= SUM_RTOL, f"{name} disagrees with the plain path")
        check(sigmas <= STDERR_SIGMAS,
              f"{name} is {sigmas:.2f} combined stderr from the plain price")
        check(ratio > 1.0, f"{name}: variance ratio {ratio} <= 1")
        launches[key] = counts[key]
        del pricer
    if bounds:
        launches.update(bf16_bounds_phase(
            torch, pc, engine, smi, dev, path_kernel, cfg, prefix, spectral,
            reset_counts, read_counts))
    return launches, cv_fit, (p_plain, se_plain, stream_plain)


def bf16_bounds_phase(torch, pc, engine, smi, dev, path_kernel: str, cfg,
                      prefix: str, spectral: bool, reset_counts,
                      read_counts) -> dict:
    """``{prefix}_bounds_anti``: the paired bounds of ``cfg`` (its chunks)
    in the bf16 form, ``bounds_fit`` with the pilot kernel once and
    ``path_kernel``/bf16[/spectral]/anti once a chunk, nothing else, an
    ordered bracket.  Returns the pair form's launches."""
    import dataclasses

    m, n = cfg.n_paths // CHUNK, cfg.n_steps
    pricer = engine.StreamingPricer(
        **MARKET, strike=STRIKE, maturity=n * DT, is_call=IS_CALL,
        config=dataclasses.replace(cfg, antithetic=True), device=dev)
    pilot = (f"{path_kernel}/"
             f"{pc.form_name(False, spectral=spectral, bf16=True)}")
    pair = f"{path_kernel}/{pc.form_name(True, spectral=spectral, bf16=True)}"
    reset_counts()
    fit, fit_s = timed(torch, lambda: pricer.bounds_fit(
        engine._pilot_stream_keys(SEED)[0]))
    (lo, up, lo_se, up_se), stream_s = timed(
        torch, lambda: pricer.bounds_with_fit(fit, SEED, m * CHUNK,
                                              with_stderr=True))
    counts = read_counts()
    emit({"phase": f"{prefix}_bounds_anti", "card": smi,
          "n_paths": m * CHUNK, "n_steps": n, "antithetic": True,
          "fgn_matmul_dtype": "bfloat16", "fgn_form": cfg.fgn_form,
          "tiled_impl": cfg.tiled_impl,
          "kernel_family": pricer.kernel_family, "lower": lo, "upper": up,
          "lower_stderr": lo_se, "upper_stderr": up_se,
          "duality_gap": up - lo, "fit_s": fit_s, "stream_s": stream_s,
          "paths_per_s": m * CHUNK / (fit_s + stream_s),
          "launches": counts,
          "reduced": {"n_chunks": {"from": N_CHUNKS, "to": m}}})
    check(counts == expected_counts(**{pilot: 1, pair: m}),
          f"{prefix}_bounds_anti launches {counts}")
    check(math.isfinite(lo) and math.isfinite(up) and lo <= up,
          f"{prefix}_bounds_anti: [{lo}, {up}] is not an ordered bracket")
    return {pair: counts[pair]}


def bf16_phases(torch, pc, ptc, engine, lsm_fit, smi, dev, key,
                refs: dict, reset_counts, read_counts) -> tuple:
    """The bf16 fGN-input forms (``fgn_matmul_dtype="bfloat16"``):
    ``bf16_forms`` holds K1/bf16 and K2/bf16 (365 steps), K6/bf16 and
    K7/bf16 (1825) in each of their forms against their plain versions,
    seeded and on noise, timed beside the bf16 product's yardstick and the
    bound; ``price_bf16`` prices 1e7 x 365 through K1/bf16 once and
    K2/bf16 76 times (within SUM_RTOL of its plain versions, within 5
    combined stderr of refs["price"]); ``price_bf16_long`` 1e7 x 1825
    through K6/bf16 and K7/bf16 (its first BF16_LONG_CHECKED chunks against
    the plain versions, within 5 combined stderr of refs["price_long"]);
    then each horizon's estimator forms and paired bounds on
    BF16_FORM_CHUNKS chunks.  Returns (the forms' kernel records, their
    times keyed by form, each price's (price, stderr), fits and CV fit
    keyed by phase name)."""
    import dataclasses

    base = engine.StreamConfig(n_paths=CHUNK * N_CHUNKS, n_steps=N_STEPS,
                               chunk_paths=CHUNK, pilot_paths=PILOT, dt=DT,
                               chunks_per_call=N_CHUNKS,
                               fgn_matmul_dtype="bfloat16")
    k_pilot = engine._pilot_stream_keys(SEED)[0]
    times, launches, runs = {}, {}, {}
    horizons = (
        (N_STEPS, MATURITY, "single", "K1", "K2", pc.pathgen,
         pc.priced_chunk, pc.priced_chunk_from_noise_ref, "price_bf16",
         N_CHUNKS, refs["price"], "price_float32",
         lambda consts, anti, cv: CHUNK // pc.priced_block_paths(
             consts, CHUNK, anti)),
        (LONG_STEPS, LONG_MATURITY, "tiled", "K6", "K7", ptc.tiled_pathgen,
         ptc.tiled_priced_chunk, ptc.priced_chunk_from_noise_ref,
         "price_bf16_long", BF16_LONG_CHECKED, refs["price_long"],
         "price_long_float32",
         lambda consts, anti, cv: CHUNK // ptc.block_paths_for(CHUNK, anti)))
    for (n, maturity, family, k_path, k_priced, path, priced, chunk_ref,
         name, n_checked, ref, ref_name, blocks) in horizons:
        cfg = dataclasses.replace(base, n_steps=n)
        pricer = engine.StreamingPricer(**MARKET, strike=STRIKE,
                                        maturity=maturity, is_call=IS_CALL,
                                        config=cfg, device=dev)
        consts = pricer.consts
        check(pricer.kernel_family == family and consts.bf16,
              f"bf16 at {n} steps resolved to {pricer.kernel_family!r}")
        consts32 = pc.make_path_consts(
            MARKET["s0"], MARKET["xi"], MARKET["h"], MARKET["eta"],
            MARKET["r"], n, DT, dev, block_paths=consts.block_paths)
        lib = bf16_library(torch, consts, dev)
        times.update(bf16_path_forms(torch, pc, smi, dev, key, k_path, path,
                                     consts, consts32, lib))
        del consts32
        table = pricer._make_rows(pricer.fit(k_pilot))
        times.update(forms_phase(
            torch, pc, smi, "bf16_forms", k_priced, priced, chunk_ref, consts,
            table, lambda k, rows, n=n: pc.philox_normals_ref(
                k, rows, n, device=dev),
            key, lambda anti, lib=lib: lib(CHUNK // 2 if anti else CHUNK),
            lambda anti, cv, n=n, consts=consts, blocks=blocks: bound_ms(
                CHUNK, n, 4 * (2 if cv else 1) * blocks(consts, anti, cv),
                antithetic=anti, with_cv=cv, bf16=True), bf16=True))
        del table
        rec = bf16_price_phase(
            torch, pc, engine, lsm_fit, smi, name, pricer, f"{k_path}/bf16",
            f"{k_priced}/bf16", n_checked, chunk_ref, ref, ref_name,
            reset_counts, read_counts)
        for form in (f"{k_path}/bf16", f"{k_priced}/bf16"):
            launches[form] = rec["launches"][form]
        del pricer
        form_launches, cv_fit, _ = bf16_estimator_phases(
            torch, pc, engine, smi, dev, k_priced, k_path, cfg, rec["fits"],
            chunk_ref, name, reset_counts, read_counts)
        launches.update(form_launches)
        runs[name] = {"price": (rec["price"], rec["stderr"]),
                      "fits": rec["fits"], "cv_fit": cv_fit}
    records = [kernel_record(form, launches, t["ms"], t["plain_ms"],
                             t["bound_ms"], t["bound_by"], t["max_abs_err"],
                             t["library_ms"]) for form, t in times.items()]
    return records, times, runs


def bf16_later_phases(torch, pc, ptc, pfc, engine, lsm_fit, smi, dev, key,
                      refs: dict, reset_counts, read_counts) -> list:
    """The bf16 forms of K8/K9, of the spectral bodies of K1/K2 and K6/K7
    and of the quadratic bodies of K2/K7/K9, each against its plain
    version (seeded and on noise), timed beside its yardstick and bound,
    and each launched on a price path:

    * ``bf16_factored_forms``: K8/bf16 and its pair at 1825 and 4000
      steps (paths FACTORED_PATH_RTOL and BF16_CLOSER times closer to the
      bf16 plain version, the four-step split, than to the float32 one,
      the FFT), K9/bf16's four boundary forms at 4000 under
      refs["xlong_fits"]; ``price_bf16_xlong`` 1e7 x 4000 (K8/bf16 once,
      K9/bf16 76 times, its first BF16_XLONG_CHECKED chunks against the
      plain versions, within 5 combined stderr of refs["price_xlong"]);
      ``price_bf16_xlong_{anti,cv,vr}`` on BF16_CUT_CHUNKS chunks;
      ``price_bf16_factored_bounds_anti`` (K8/bf16/anti at 1825 steps on
      the factored family);
    * ``bf16_spectral_forms``: K1/K2 at 365 steps, K6/K7 at 1825, in every
      form; ``price_bf16_spectral`` (1e7 x 365, within 5 combined stderr
      of refs["price_spectral"]), ``price_bf16_spectral_slab`` (1825,
      BF16_CUT_CHUNKS chunks, within 5 combined stderr of
      refs["price_factored"], the same law), each with its estimator
      forms and paired bounds on BF16_CUT_CHUNKS chunks;
    * ``bf16_quadratic_forms``: K2/bf16 chol and spectral at 365, K7/bf16
      likewise at 1825, K9/bf16 at 4000, quadratic plain and CV;
      ``price_bf16_quadratic`` (1e7 x 365 within SUM_RTOL of
      refs["price_bf16"] on the same seed) and the quadratic prices of
      every other bf16 family on BF16_CUT_CHUNKS chunks, each under the
      policy (and CV fit) of the same pilot's boundary run.

    Each price reads its launch counts around it: only its bf16 forms
    ran.  Returns the 28 forms' entries of the kernels line."""
    import dataclasses
    import functools

    m = BF16_CUT_CHUNKS
    base = engine.StreamConfig(n_paths=CHUNK * N_CHUNKS, n_steps=N_STEPS,
                               chunk_paths=CHUNK, pilot_paths=PILOT, dt=DT,
                               chunks_per_call=N_CHUNKS,
                               fgn_matmul_dtype="bfloat16")
    market = [MARKET[k] for k in ("s0", "xi", "h", "eta", "r")]
    times, launches = {}, {}

    def cfg_of(n, n_chunks=N_CHUNKS, **kw):
        return dataclasses.replace(base, n_steps=n, n_paths=n_chunks * CHUNK,
                                   chunks_per_call=n_chunks, **kw)

    def pricer_of(cfg):
        return engine.StreamingPricer(**MARKET, strike=STRIKE,
                                      maturity=cfg.n_steps * DT,
                                      is_call=IS_CALL, config=cfg,
                                      device=dev)

    def table_of(n, fits, policy_form="boundary"):
        return engine._fused_rows_builder(MARKET["r"], STRIKE, n * DT, DT, n,
                                          IS_CALL, policy_form)(fits)

    def quad_runs(names, n, cfg_kw, priced, spectral, pilot_fits, cv_fit,
                  ref, normals, chunk_ref):
        """The quadratic runs ``names`` = (plain or None, CV) on m chunks
        under the boundary run's policy and CV fit of the same pilot (no
        pilot launched), within 5 combined stderr of ``ref`` = that run's
        plain price on the same chunks; returns the quadratic forms'
        launches."""
        out = {}
        for name, cv, fits in zip(names, (False, True),
                                  (pilot_fits, cv_fit)):
            if name is None:
                continue
            pricer = pricer_of(cfg_of(n, m, policy_form="quadratic",
                                      control_variate=cv, **cfg_kw))
            form = f"{priced}/{pc.form_name(False, cv, spectral, True, True)}"
            rec = bf16_price_phase(
                torch, pc, engine, lsm_fit, smi, name, pricer, None, form,
                BF16_FORM_CHECKED,
                functools.partial(chunk_ref, policy_form="quadratic"), ref[:2],
                f"boundary_bf16_{m}_chunks", reset_counts, read_counts,
                normals=normals, fits=fits)
            out[form] = rec["launches"][form]
            del pricer
        return out

    # -- K8/K9: the forms, then the 4000-step price and its estimators.
    fc = {n: pfc.make_factored_consts(*market, n, DT, dev,
                                      fgn_dtype="bfloat16")
          for n in FACTORED_STEPS}
    for n in FACTORED_STEPS:
        fc32 = pfc.make_factored_consts(*market, n, DT, dev)
        t = bf16_path_forms(
            torch, pc, smi, dev, key, "K8", pfc.factored_pathgen, fc[n],
            fc32, fft_library(torch, n, dev), phase="bf16_factored_forms",
            normals=lambda k, rows, n=n: pfc.philox_factored_normals_ref(
                k, rows, n, device=dev),
            ref=pfc.factored_pathgen_from_noise_ref,
            rtol=FACTORED_PATH_RTOL,
            bound=lambda anti, n=n: factored_bound_ms(
                CHUNK, n, 4 * CHUNK * (n + 1), antithetic=anti, bf16=True),
            plain_reps=1)
        if n == XLONG_STEPS:
            times.update(t)
        del fc32
    xn = XLONG_STEPS
    x_normals = functools.partial(pfc.philox_factored_normals_ref, n_steps=xn,
                                  device=dev)
    lib = fft_library(torch, xn, dev)
    times.update(forms_phase(
        torch, pc, smi, "bf16_factored_forms", "K9",
        pfc.factored_priced_chunk, pfc.factored_priced_chunk_from_noise_ref,
        fc[xn], table_of(xn, refs["xlong_fits"]),
        lambda k, rows: x_normals(k, rows), key,
        lambda anti: lib(CHUNK // 2 if anti else CHUNK),
        lambda anti, cv: factored_bound_ms(
            CHUNK, xn, 4 * (2 if cv else 1)
            * ((CHUNK // 2 if anti else CHUNK) // pfc.paths_per_block(xn)),
            policy_rows=3, antithetic=anti, with_cv=cv, bf16=True),
        bf16=True, plain_reps=1))
    times.update(quad_forms_phase(
        torch, pc, smi, "K9", pfc.factored_priced_chunk,
        pfc.factored_priced_chunk_from_noise_ref, fc[xn],
        table_of(xn, refs["xlong_fits"], "quadratic"),
        lambda k, rows: x_normals(k, rows), key, lambda: lib(CHUNK),
        lambda cv, cells: factored_bound_ms(
            CHUNK, xn, 4 * (2 if cv else 1) * (CHUNK // pfc.paths_per_block(
                xn)), policy_rows=8, with_cv=cv, quad_cells=cells,
            bf16=True),
        pfc._log_paths_ref, bf16=True, phase="bf16_quadratic_forms",
        plain_reps=1))
    del fc
    cfg = cfg_of(xn)
    pricer = pricer_of(cfg)
    check(pricer.kernel_family == "factored" and pricer.consts.bf16,
          f"bf16 at {xn} steps resolved to {pricer.kernel_family!r}")
    rec = bf16_price_phase(
        torch, pc, engine, lsm_fit, smi, "price_bf16_xlong", pricer,
        "K8/bf16", "K9/bf16", BF16_XLONG_CHECKED,
        pfc.factored_priced_chunk_from_noise_ref, refs["price_xlong"],
        "price_xlong_float32", reset_counts, read_counts,
        normals=pfc.philox_factored_normals_ref)
    launches.update({f: rec["launches"][f] for f in ("K8/bf16", "K9/bf16")})
    del pricer
    form_launches, cv_fit, plain_m = bf16_estimator_phases(
        torch, pc, engine, smi, dev, "K9", "K8", cfg, rec["fits"],
        pfc.factored_priced_chunk_from_noise_ref, "price_bf16_xlong",
        reset_counts, read_counts, normals=pfc.philox_factored_normals_ref,
        bounds=False, m=m, both_name="vr")
    launches.update(form_launches)
    launches.update(quad_runs(
        ("price_bf16_xlong_quadratic", "price_bf16_xlong_quadratic_cv"), xn,
        {}, "K9", False, rec["fits"], cv_fit, plain_m,
        pfc.philox_factored_normals_ref,
        pfc.factored_priced_chunk_from_noise_ref))
    # The paired bounds on K8/bf16/anti, at 1825 steps on the factored
    # family (its pilot fits in a third of the 4000-step time).
    launches.update(bf16_bounds_phase(
        torch, pc, engine, smi, dev, "K8",
        cfg_of(LONG_STEPS, m, tiled_impl="factored"),
        "price_bf16_factored", False, reset_counts, read_counts))

    # -- The spectral bodies: K1/K2 at 365 steps, K6/K7 on the slab at
    # 1825, each price first, then its forms under the price's fits, its
    # estimators, bounds and quadratic runs.
    spectral_normals = pc.philox_spectral_normals_ref
    for (n, n_chunks, cfg_kw, k_path, k_priced, path, priced, chunk_ref,
         name, ref, ref_name, blocks) in (
            (N_STEPS, N_CHUNKS, {"fgn_form": "spectral"}, "K1", "K2",
             pc.pathgen, pc.priced_chunk, pc.priced_chunk_from_noise_ref,
             "price_bf16_spectral", refs["price_spectral"],
             "price_spectral_float32",
             lambda c, anti, cv: CHUNK // pc.priced_block_paths(
                 c, CHUNK, anti)),
            (LONG_STEPS, m, {"fgn_form": "spectral", "tiled_impl": "slab"},
             "K6", "K7", ptc.tiled_pathgen, ptc.tiled_priced_chunk,
             ptc.priced_chunk_from_noise_ref, "price_bf16_spectral_slab",
             refs["price_factored"], "price_factored_float32",
             lambda c, anti, cv: CHUNK // ptc.block_paths_for(CHUNK, anti))):
        cfg = cfg_of(n, n_chunks, **cfg_kw)
        pricer = pricer_of(cfg)
        consts = pricer.consts
        check(consts.spectral and consts.bf16,
              f"{name}: the constants are not the bf16 spectral form's")
        pilot = f"{k_path}/bf16/spectral"
        rec = bf16_price_phase(
            torch, pc, engine, lsm_fit, smi, name, pricer, pilot,
            f"{k_priced}/bf16/spectral", LONG_CHECKED, chunk_ref, ref,
            ref_name, reset_counts, read_counts, normals=spectral_normals)
        launches.update({f: rec["launches"][f] for f in (
            pilot, f"{k_priced}/bf16/spectral")})
        del pricer
        consts32 = pc.make_path_consts(*market, n, DT, dev,
                                       block_paths=consts.block_paths,
                                       fgn_form="spectral")
        lib = spectral_library(torch, consts, dev)
        s_normals = functools.partial(spectral_normals, n_steps=n,
                                      device=dev)
        times.update(bf16_path_forms(
            torch, pc, smi, dev, key, k_path, path, consts, consts32, lib,
            phase="bf16_spectral_forms", spectral=True,
            normals=lambda k, rows, f=s_normals: f(k, rows),
            bound=lambda anti, n=n: bound_ms(
                CHUNK, n, 4 * CHUNK * (n + 1), antithetic=anti,
                spectral=True, bf16=True), plain_reps=1))
        del consts32
        times.update(forms_phase(
            torch, pc, smi, "bf16_spectral_forms", k_priced, priced,
            chunk_ref, consts, table_of(n, rec["fits"]),
            lambda k, rows, f=s_normals: f(k, rows), key,
            lambda anti, lib=lib: lib(CHUNK // 2 if anti else CHUNK),
            lambda anti, cv, n=n, c=consts, b=blocks: bound_ms(
                CHUNK, n, 4 * (2 if cv else 1) * b(c, anti, cv),
                antithetic=anti, with_cv=cv, spectral=True, bf16=True),
            spectral=True, bf16=True, plain_reps=1))
        times.update(quad_forms_phase(
            torch, pc, smi, k_priced, priced, chunk_ref, consts,
            table_of(n, rec["fits"], "quadratic"),
            lambda k, rows, f=s_normals: f(k, rows), key,
            lambda lib=lib: lib(CHUNK),
            lambda cv, cells, n=n, c=consts, b=blocks: bound_ms(
                CHUNK, n, 4 * (2 if cv else 1) * b(c, False, cv),
                policy_rows=8, with_cv=cv, spectral=True, quad_cells=cells,
                bf16=True),
            pc._log_paths_ref, True, bf16=True,
            phase="bf16_quadratic_forms", plain_reps=1))
        del consts
        form_launches, cv_fit, plain_m = bf16_estimator_phases(
            torch, pc, engine, smi, dev, k_priced, k_path, cfg, rec["fits"],
            chunk_ref, name, reset_counts, read_counts,
            normals=spectral_normals, spectral=True, m=m)
        launches.update(form_launches)
        launches.update(quad_runs(
            (f"{name}_quadratic", f"{name}_quadratic_cv"), n, cfg_kw,
            k_priced, True, rec["fits"], cv_fit, plain_m, spectral_normals,
            chunk_ref))

    # -- The chol bodies' quadratic forms: K2 at 365, K7 at 1825.
    for n, k_priced, priced, blocks in (
            (N_STEPS, "K2", pc.priced_chunk,
             lambda c, cv: CHUNK // pc.priced_block_paths(c, CHUNK)),
            (LONG_STEPS, "K7", ptc.tiled_priced_chunk,
             lambda c, cv: CHUNK // ptc.block_paths_for(CHUNK))):
        consts = pc.make_path_consts(*market, n, DT, dev,
                                     fgn_dtype="bfloat16")
        fits = refs["bf16"]["price_bf16" if n == N_STEPS
                            else "price_bf16_long"]["fits"]
        lib = bf16_library(torch, consts, dev)
        times.update(quad_forms_phase(
            torch, pc, smi, k_priced, priced, pc.priced_chunk_from_noise_ref,
            consts, table_of(n, fits, "quadratic"),
            lambda k, rows, n=n: pc.philox_normals_ref(k, rows, n,
                                                       device=dev),
            key, lambda lib=lib: lib(CHUNK),
            lambda cv, cells, n=n, c=consts, b=blocks: bound_ms(
                CHUNK, n, 4 * (2 if cv else 1) * b(c, cv), policy_rows=8,
                with_cv=cv, quad_cells=cells, bf16=True),
            pc._log_paths_ref, bf16=True, phase="bf16_quadratic_forms",
            plain_reps=1))
        del consts
    # price_bf16_quadratic: the whole bench run, pilot included, on the
    # seed of price_bf16; then its CV form and the slab's quadratic runs
    # under the policy and CV fit of price_bf16(_long)'s pilot.
    cfg = cfg_of(N_STEPS, policy_form="quadratic")
    pricer = pricer_of(cfg)
    rec = bf16_price_phase(
        torch, pc, engine, lsm_fit, smi, "price_bf16_quadratic", pricer,
        "K1/bf16", "K2/bf16/quad", LONG_CHECKED,
        functools.partial(pc.priced_chunk_from_noise_ref,
                          policy_form="quadratic"),
        refs["bf16"]["price_bf16"]["price"], "price_bf16", reset_counts,
        read_counts, rtol=SUM_RTOL)
    launches["K2/bf16/quad"] = rec["launches"]["K2/bf16/quad"]
    del pricer
    for n, names, k_priced, run in (
            (N_STEPS, (None, "price_bf16_quadratic_cv"), "K2", "price_bf16"),
            (LONG_STEPS, ("price_bf16_quadratic_long",
                          "price_bf16_quadratic_long_cv"), "K7",
             "price_bf16_long")):
        bf = refs["bf16"][run]
        pricer = pricer_of(cfg_of(n, m))
        plain_m, stream_m = timed(torch, lambda: pricer.price_with_fit(
            bf["fits"], SEED, with_stderr=True))
        del pricer
        launches.update(quad_runs(
            names, n, {}, k_priced, False, bf["fits"], bf["cv_fit"],
            (*plain_m, stream_m), None, pc.priced_chunk_from_noise_ref))
    return [kernel_record(form, launches, t["ms"], t["plain_ms"],
                          t["bound_ms"], t["bound_by"], t["max_abs_err"],
                          t["library_ms"]) for form, t in times.items()]


def bf16_strip_forms(torch, pc, cc, smi, dev, key, chain, fits, n: int,
                     forms, times: dict) -> None:
    """``bf16_chain_forms`` at horizon ``n``: each K5/bf16 form of
    ``forms`` = ((antithetic, quadratic), ...) in the fGN form of
    ``chain``'s constants, on the strip's tables of ``fits``, at the bench
    chunk of 131072 rows: seeded and noise-in against its plain version
    (SUM_RTOL of each strike's scale, ``scaled_err``) and BF16_CLOSER
    times closer to it than to the float32 plain version on the same
    noise; a pair against the unpaired form on [X; -X] (PAIR_RTOL); then
    timed beside its plain version (one run), the bf16 product's
    yardstick and its bound.  Emits the phase, then checks.  Adds the
    forms' numbers to ``times``, keyed K5/form."""
    consts = chain.chain_consts
    consts32 = pc.make_path_consts(
        *(MARKET[k] for k in ("s0", "xi", "h", "eta", "r")), n, DT, dev,
        fgn_form=consts.fgn_form)
    spectral, k_n = consts.spectral, len(STRIP)
    if spectral:
        library = spectral_library(torch, consts, dev)
    else:
        library = bf16_library(torch, consts, dev)
    checks, fails = [], []
    for anti, quad in forms:
        form = f"K5/{pc.form_name(anti, False, spectral, quad, True)}"
        policy = "quadratic" if quad else "boundary"
        rows_of = pc.policy_rows if quad else pc.boundary_rows
        tables = rows_of(fits, MARKET["r"], chain.strikes, n * DT, DT, n,
                         IS_CALL).contiguous()
        drawn = CHUNK // 2 if anti else CHUNK
        noise = pc.normals_ref(consts, key, drawn, device=dev)
        want = cc.priced_chain_from_noise_ref(consts, tables, noise,
                                              IS_CALL, anti, policy)
        want32 = cc.priced_chain_from_noise_ref(consts32, tables, noise,
                                                IS_CALL, anti, policy)
        got_n = cc.priced_chain(consts, tables, IS_CALL, noise=noise,
                                antithetic=anti, policy_form=policy)
        got_s = cc.priced_chain(consts, tables, IS_CALL, rows=CHUNK, key=key,
                                antithetic=anti, policy_form=policy)
        pair = None
        if anti:
            pair = scaled_err(torch, got_n, cc.priced_chain(
                consts, tables, IS_CALL,
                noise=torch.cat([noise, -noise], dim=1)))
        torch.cuda.synchronize()
        s = torch.exp(pc._log_paths_ref(consts, noise, anti))
        if quad:
            swept = sum(int((pc.quadratic_stops(s, tab, IS_CALL, True)[1]
                             + 1).sum()) for tab in tables)
        else:
            swept = swept_cells(torch, s, tables[:, 0, :n], tables[:, 1, :n])
        del noise, s
        rec = {"form": form, "n_steps": n,
               "block_paths": cc.block_paths_for(n, CHUNK, anti, spectral,
                                                 True),
               "noise_in_rel_err": scaled_err(torch, got_n, want),
               "seeded_rel_err": scaled_err(torch, got_s, want),
               "float32_plain_rel_err": scaled_err(torch, got_s, want32),
               "pair_rel_err": pair, "swept_cells": swept}
        checks.append(rec)
        if max(rec["noise_in_rel_err"], rec["seeded_rel_err"]) > SUM_RTOL:
            fails.append(f"{form} disagrees with its plain version at {n} "
                         "steps")
        if rec["seeded_rel_err"] * BF16_CLOSER > rec["float32_plain_rel_err"]:
            fails.append(f"{form} at {n} steps is not {BF16_CLOSER}x closer "
                         "to the bf16 plain version than to the float32 one")
        if pair is not None and pair > PAIR_RTOL:
            fails.append(f"{form} disagrees with its unpaired form on "
                         "[X; -X]")

        def run(tables=tables, anti=anti, policy=policy):
            cc.priced_chain(consts, tables, IS_CALL, rows=CHUNK, key=key,
                            antithetic=anti, policy_form=policy)

        def plain(tables=tables, anti=anti, policy=policy, drawn=drawn):
            cc.priced_chain_from_noise_ref(consts, tables, pc.normals_ref(
                consts, key, drawn, device=dev), IS_CALL, anti, policy)

        blocks = CHUNK // rec["block_paths"]
        b_ms, b_by = bound_ms(
            CHUNK, n, 4 * blocks * k_n,
            policy_rows=1 + (8 if quad else 4) * k_n, swept=swept,
            antithetic=anti, spectral=spectral,
            sweep_ops=QUAD_SWEEP_OPS if quad else 4.0, bf16=True)
        key_t = form if n == N_STEPS else f"{form}@{n}"
        times[key_t] = {"ms": time_ms(torch, run, 5),
                        "plain_ms": plain_time(torch, plain, 1),
                        "library_ms": library(drawn), "bound_ms": b_ms,
                        "bound_by": b_by,
                        "max_abs_err": float(torch.max(torch.abs(
                            got_s - want)))}
        times[key_t].update(k5_split(torch, cc, consts, tables,
                                     times[key_t]["ms"], key, 5, anti,
                                     policy))
        rec["times"] = times[key_t]
    emit({"phase": "bf16_chain_forms", "card": smi, "kernel": "K5",
          "fgn_form": consts.fgn_form, "rows": CHUNK, "n_steps": n,
          "n_strikes": k_n, "checks": checks, "rtol": SUM_RTOL,
          "closer_than_float32": BF16_CLOSER, "pair_rtol": PAIR_RTOL})
    check(not fails, "; ".join(fails))


def bf16_greeks_forms(torch, pc, gc, smi, dev, key, consts, g, logs,
                      strikes, times: dict) -> None:
    """``bf16_greeks_forms``: K3/bf16, K3/bf16/anti (strike 105), K4/bf16
    and K4/bf16/anti (21 strikes) at the bench chunk, seeded and noise-in,
    against their plain version (GREEKS_RTOL of each Greek's scale); K3
    against K4's column at 105 (the same body, SAME_BODY_RTOL); the pairs
    against the unpaired forms on [X; -X] (PAIR_RTOL); then each timed
    beside its plain version (one run), the two bf16 products' yardstick
    and its bound (two products).  Emits the phase, then checks.  Adds
    the forms' numbers to ``times``."""
    i_k, k_n = STRIP.index(STRIKE), len(STRIP)
    library = bf16_library(torch, consts, dev, (g.dlt_half,))
    checks, fails = [], []
    for anti in (False, True):
        drawn = CHUNK // 2 if anti else CHUNK
        noise = pc.philox_normals_ref(key, drawn, N_STEPS, device=dev)
        want = gc.greeks_from_noise_ref(consts, g, logs, strikes, noise,
                                        IS_CALL, anti)
        ls = pc._log_paths_ref(consts, noise, anti)
        swept = {"K3": swept_cells(torch, ls, logs[i_k:i_k + 1, 0, :N_STEPS],
                                   logs[i_k:i_k + 1, 1, :N_STEPS]),
                 "K4": swept_cells(torch, ls, logs[:, 0, :N_STEPS],
                                   logs[:, 1, :N_STEPS])}
        del ls
        runs = {
            "K3": (lambda anti, **kw: gc.greeks_chunk(
                consts, g, logs[i_k], STRIKE, IS_CALL, antithetic=anti,
                **kw)[:, None], want[:, i_k:i_k + 1], 1),
            "K4": (lambda anti, **kw: gc.chain_greeks_chunk(
                consts, g, logs, IS_CALL, antithetic=anti, **kw), want, k_n)}
        got = {}
        for kernel, (run, ref, k) in runs.items():
            form = f"{kernel}/{pc.form_name(anti, bf16=True)}"
            got_n = run(anti, noise=noise)
            got_s = run(anti, rows=CHUNK, key=key)
            pair = None
            if anti:
                pair = scaled_err(torch, got_n, run(
                    False, noise=torch.cat([noise, -noise], dim=1)))
            torch.cuda.synchronize()
            got[kernel] = got_s
            rec = {"form": form, "n_strikes": k,
                   "block_paths": gc.block_paths_for(N_STEPS, CHUNK, anti,
                                                     True),
                   "noise_in_rel_err": scaled_err(torch, got_n, ref),
                   "seeded_rel_err": scaled_err(torch, got_s, ref),
                   "pair_rel_err": pair, "swept_cells": swept[kernel]}
            checks.append(rec)
            if max(rec["noise_in_rel_err"],
                   rec["seeded_rel_err"]) > GREEKS_RTOL:
                fails.append(f"{form} disagrees with its plain version")
            if pair is not None and pair > PAIR_RTOL:
                fails.append(f"{form} disagrees with its unpaired form on "
                             "[X; -X]")

            def plain(anti=anti, drawn=drawn, k=k):
                gc.greeks_from_noise_ref(
                    consts, g, logs[i_k:i_k + 1] if k == 1 else logs,
                    strikes[i_k:i_k + 1] if k == 1 else strikes,
                    pc.philox_normals_ref(key, drawn, N_STEPS, device=dev),
                    IS_CALL, anti)

            blocks = CHUNK // rec["block_paths"]
            b_ms, b_by = bound_ms(CHUNK, N_STEPS, 4 * blocks * 6 * k,
                                  products=2, per_cell=18.0,
                                  policy_rows=3 + 2 * k,
                                  swept=swept[kernel], antithetic=anti,
                                  bf16=True)
            times[form] = {"ms": time_ms(torch, lambda run=run, anti=anti:
                                         run(anti, rows=CHUNK, key=key), 5),
                           "plain_ms": plain_time(torch, plain, 1),
                           "library_ms": library(drawn), "bound_ms": b_ms,
                           "bound_by": b_by,
                           "max_abs_err": float(torch.max(torch.abs(
                               got_s - ref)))}
            if kernel == "K4":
                k3 = times[f"K3/{pc.form_name(anti, bf16=True)}"]
                times[form].update(k4_split(gc, consts, times[form]["ms"],
                                            k3["ms"], k, anti))
                k3["blocks_per_sm"] = times[form]["k3_blocks_per_sm"]
            rec["times"] = times[form]
        same = float(((got["K3"][:, 0] - got["K4"][:, i_k]).abs()
                      / got["K4"].abs().amax(dim=1)).max())
        checks.append({"form": f"K3/{pc.form_name(anti, bf16=True)} vs K4",
                       "k4_column_rel_err": same})
        if same > SAME_BODY_RTOL:
            fails.append(f"K3/{pc.form_name(anti, bf16=True)} differs from "
                         "K4's column")
        del noise
    emit({"phase": "bf16_greeks_forms", "card": smi, "rows": CHUNK,
          "n_steps": N_STEPS, "checks": checks, "rtol": GREEKS_RTOL,
          "pair_rtol": PAIR_RTOL, "same_body_rtol": SAME_BODY_RTOL})
    check(not fails, "; ".join(fails))


def bf16_strip_run(torch, pc, cc, engine, smi, name: str, chain, fits,
                   form: str, pilot, n_chunks: int, ref: tuple,
                   ref_name: str, reset_counts, read_counts,
                   n_checked: int = CHAIN_CHECKED) -> dict:
    """One bf16 strip on ``n_chunks`` chunks of SEED's stream: with
    ``fits`` None, fit() (``pilot`` launched once) and price_with_fit()
    timed apart; else streamed under ``fits`` (another run's, of the same
    pilot: no pilot launched).  Its launches are exactly those (``form``
    once a chunk); prices finite and rising with the strike; its first
    ``n_checked`` chunks within SUM_RTOL of the plain versions under the
    same fits; strike 105 within STDERR_SIGMAS combined stderr of ``ref``
    = (price, stderr).  Emits ``name``; returns the record with the
    prices, stderrs and fits."""
    import numpy as np

    i_k, k_n, n = STRIP.index(STRIKE), len(STRIP), chain.config.n_steps
    reset_counts()
    fit_s = None
    if fits is None:
        fits, fit_s = timed(torch, lambda: chain.fit(
            engine._pilot_stream_keys(SEED)[0]))
    (prices, stderrs), stream_s = timed(torch, lambda: chain.price_with_fit(
        fits, SEED, n_chunks * CHUNK, with_stderr=True))
    launches = read_counts()
    checked = chain.price_with_fit(fits, SEED, n_paths=n_checked * CHUNK)
    checked_rel = scaled_err(torch, torch.from_numpy(checked),
                             torch.from_numpy(plain_chain_means(
                                 torch, pc, cc, engine, chain, fits, SEED,
                                 n_checked, chain.config.antithetic)))
    p_k, se_k = float(prices[i_k]), float(stderrs[i_k])
    sigmas = abs(p_k - ref[0]) / math.hypot(se_k, ref[1])
    n_paths = n_chunks * CHUNK
    wall = stream_s + (fit_s or 0.0)
    rec = {"phase": name, "card": smi, "n_paths": n_paths, "n_steps": n,
           "fgn_matmul_dtype": "bfloat16",
           "fgn_form": chain.chain_consts.fgn_form,
           "antithetic": chain.config.antithetic,
           "chain_policy_form": chain.config.chain_policy_form,
           "kernel_family": chain.kernel_family, "strikes": list(STRIP),
           "prices": prices.tolist(), "stderrs": stderrs.tolist(),
           "wall_s": wall, "paths_strikes_per_s": n_paths * k_n / wall,
           "fit_s": fit_s, "stream_s": stream_s,
           "fits_of_another_run": fit_s is None, "launches": launches,
           "checked_chunks": n_checked, "checked_rel_err": checked_rel,
           "rtol": SUM_RTOL, "strike": STRIKE, "price_at_strike": p_k,
           "stderr_at_strike": se_k, ref_name: list(ref),
           "combined_stderrs_apart": sigmas, "limit": STDERR_SIGMAS}
    if n_chunks != N_CHUNKS:
        rec["reduced"] = {"n_chunks": {"from": N_CHUNKS, "to": n_chunks}}
    emit(rec)
    want = {form: n_chunks, **({} if fit_s is None else {pilot: 1})}
    check(launches == expected_counts(**want),
          f"{name} launches {launches}, want {want} and nothing else")
    check(bool(np.all(np.isfinite(prices))) and bool(np.all(prices > 0))
          and bool(np.all(np.diff(prices) > 0)),
          f"{name} prices are not finite, positive and rising")
    check(checked_rel <= SUM_RTOL, f"{name} disagrees with the plain path")
    check(sigmas <= STDERR_SIGMAS,
          f"{name} strike {STRIKE} is {sigmas:.2f} combined stderr from "
          f"{ref_name}")
    return {**rec, "fits": fits}


def bf16_greeks_run(torch, engine, gc, smi, name: str, pricer, fits,
                    form: str, pilot, n_chunks: int, price_ref: float,
                    float32: tuple, reset_counts, read_counts) -> dict:
    """The Greeks (``pricer`` a StreamingPricer, [6]; a
    StreamingChainPricer, [6, K]) on ``n_chunks`` chunks of SEED's stream:
    with ``fits`` None, fit() (``pilot`` launched once) and
    greeks_with_fit() timed apart; else streamed under ``fits``.  Its
    launches are exactly those; every Greek and stderr finite; the price
    lane within SUM_RTOL of ``price_ref`` (a price or [K] prices of the
    same seed and fits' law; ``scaled_err``); with ``float32`` = (Greeks, stderrs) of the
    float32 run of the same seed, each Greek within STDERR_SIGMAS combined
    stderr of it.  Emits ``name``; returns the record."""
    import numpy as np

    reset_counts()
    fit_s = None
    if fits is None:
        fits, fit_s = timed(torch, lambda: pricer.fit(
            engine._pilot_stream_keys(SEED)[0]))
    (greeks, ses), stream_s = timed(torch, lambda: pricer.greeks_with_fit(
        fits, SEED, n_chunks * CHUNK, with_stderr=True))
    launches = read_counts()
    greeks, ses = np.asarray(greeks), np.asarray(ses)
    price_rel = scaled_err(torch, torch.from_numpy(np.atleast_1d(greeks[0])),
                           torch.from_numpy(np.atleast_1d(np.asarray(
                               price_ref, dtype=np.float64))))
    n_paths = n_chunks * CHUNK
    wall = stream_s + (fit_s or 0.0)
    rec = {"phase": name, "card": smi, "n_paths": n_paths,
           "n_steps": pricer.config.n_steps, "fgn_matmul_dtype": "bfloat16",
           "antithetic": pricer.config.antithetic,
           "greeks": {k: v.tolist() for k, v in zip(gc.GREEK_ORDER, greeks)},
           "stderrs": {k: v.tolist() for k, v in zip(gc.GREEK_ORDER, ses)},
           "wall_s": wall, "paths_per_s": n_paths / wall, "fit_s": fit_s,
           "stream_s": stream_s, "fits_of_another_run": fit_s is None,
           "launches": launches, "price_lane_rel_err": price_rel,
           "rtol": SUM_RTOL}
    sigmas = None
    if float32 is not None:
        g32, se32 = (np.asarray(v) for v in float32)
        both = np.hypot(ses, se32)
        sigmas = float(np.max(np.where(both > 0, np.abs(greeks - g32)
                                       / np.where(both > 0, both, 1.0),
                                       0.0)))
        rec.update(float32_combined_stderrs_apart=sigmas,
                   limit=STDERR_SIGMAS)
    if n_chunks != N_CHUNKS:
        rec["reduced"] = {"n_chunks": {"from": N_CHUNKS, "to": n_chunks}}
    emit(rec)
    want = {form: n_chunks, **({} if fit_s is None else {pilot: 1})}
    check(launches == expected_counts(**want),
          f"{name} launches {launches}, want {want} and nothing else")
    check(bool(np.all(np.isfinite(greeks))) and bool(np.all(np.isfinite(
        ses))), f"non-finite {name}")
    check(price_rel <= SUM_RTOL, f"{name}'s price lane is {price_rel:.2e} "
          "from the price of the same seed")
    check(sigmas is None or sigmas <= STDERR_SIGMAS,
          f"{name} is {sigmas} combined stderr from the float32 Greeks")
    return rec


def bf16_chain_greeks_phases(torch, pc, cc, gc, engine, smi, dev, key,
                             refs: dict, reset_counts, read_counts) -> list:
    """The bf16 forms of K5 and K3/K4 (``fgn_matmul_dtype="bfloat16"``):
    ``chain_bf16`` prices the 21-strike strip at 1e7 x 365 through K1/bf16
    once and K5/bf16 76 times (``chain_price``'s checks but the fit
    count: strike 105 within 2 stderr of ``price_bf16`` and 5 combined
    stderr of the float32 strip); ``bf16_chain_forms`` holds the six
    K5/bf16 forms at 365 steps and plain and paired at 512 against their
    plain versions (``bf16_strip_forms``); ``bf16_greeks_forms`` K3/bf16,
    K4/bf16 and their pairs (``bf16_greeks_forms``); the other K5/bf16
    forms stream 16 chunks under their pilot's fits
    (``chain_bf16_{anti,quadratic,spectral_anti,spectral_quadratic}``);
    ``chain_bf16_spectral`` the strip at 400 steps on K8/bf16 and
    K5/bf16/spectral (16 chunks) beside a single-strike K8/K9 bf16 price
    of the same seed; ``greeks_bf16`` the bench option's Greeks at full
    width (K1/bf16 once, K3/bf16 76 times: price lane within 1e-4 of
    ``price_bf16``, each Greek within 5 combined stderr of the float32
    ``greeks``), ``chain_greeks_bf16`` the strip's (K4/bf16 76 times,
    price row against ``chain_bf16``, each Greek within 5 combined stderr
    of the float32 ``chain_greeks``) and their pair forms on 16 chunks
    (``greeks_bf16_anti``, ``chain_greeks_bf16_anti``: price lanes against
    the paired bf16 strip of the same chunks).  ``refs``: "price_bf16"
    (price, stderr), "strip" (float32 prices, stderrs), "greeks" and
    "chain_greeks" (float32 values, stderrs).  Returns the ten forms'
    entries of the kernels line."""
    import dataclasses

    import numpy as np

    m, times, launches = BF16_FORM_CHUNKS, {}, {}
    base = engine.StreamConfig(n_paths=CHUNK * N_CHUNKS, n_steps=N_STEPS,
                               chunk_paths=CHUNK, pilot_paths=PILOT, dt=DT,
                               chunks_per_call=N_CHUNKS,
                               fgn_matmul_dtype="bfloat16")
    i_k = STRIP.index(STRIKE)

    def chain_of(n=N_STEPS, n_chunks=N_CHUNKS, **kw):
        cfg = dataclasses.replace(base, n_steps=n, n_paths=n_chunks * CHUNK,
                                  chunks_per_call=n_chunks, **kw)
        chain = engine.StreamingChainPricer(
            **MARKET, strikes=STRIP, maturity=n * DT, is_call=IS_CALL,
            config=cfg, device=dev)
        check(chain.chain_consts.bf16, f"the {n}-step bf16 strip {kw} has "
              "float32 constants")
        return chain

    # chain_bf16: the strip at full width; its fits serve every K5/bf16
    # form run, the K5 and Greeks form checks and the strip's Greeks.
    chain = chain_of()
    strip32 = tuple(float(v[i_k]) for v in refs["strip"])
    rec = bf16_strip_run(torch, pc, cc, engine, smi, "chain_bf16", chain,
                         None, "K5/bf16", "K1/bf16", N_CHUNKS, strip32,
                         "chain_price_float32", reset_counts, read_counts)
    launches["K5/bf16"] = rec["launches"]["K5/bf16"]
    fits, bf16_prices = rec["fits"], np.asarray(rec["prices"])
    p_k, se_k = rec["price_at_strike"], rec["stderr_at_strike"]
    one_sigmas = abs(p_k - refs["price_bf16"][0]) / refs["price_bf16"][1]
    emit({"phase": "chain_bf16_vs_price_bf16", "strike": STRIKE,
          "price_at_strike": p_k, "price_bf16": list(refs["price_bf16"]),
          "stderrs_from_price_bf16": one_sigmas, "limit": 2.0})
    check(one_sigmas <= 2.0, f"chain_bf16 strike {STRIKE} {p_k} is over 2 "
          f"stderr from price_bf16 {refs['price_bf16'][0]}")
    bf16_strip_forms(torch, pc, cc, smi, dev, key, chain, fits, N_STEPS,
                     ((False, False), (True, False), (False, True)), times)
    for suffix, kw, form in (("anti", {"antithetic": True}, "K5/bf16/anti"),
                             ("quadratic", {"chain_policy_form":
                                            "quadratic"}, "K5/bf16/quad")):
        run = bf16_strip_run(torch, pc, cc, engine, smi,
                             f"chain_bf16_{suffix}", chain_of(n_chunks=m,
                                                              **kw),
                             fits, form, None, m, (p_k, se_k), "chain_bf16",
                             reset_counts, read_counts,
                             n_checked=BF16_FORM_CHECKED)
        launches[form] = run["launches"][form]
    # The spectral forms at 365 steps: their own pilot's fits.
    spec = chain_of(fgn_form="spectral")
    spec_fits = spec.fit(engine._pilot_stream_keys(SEED)[0])
    bf16_strip_forms(torch, pc, cc, smi, dev, key, spec, spec_fits, N_STEPS,
                     ((False, False), (True, False), (False, True)), times)
    del spec
    for suffix, kw, form in (
            ("_anti", {"antithetic": True}, "K5/bf16/spectral/anti"),
            ("_quadratic", {"chain_policy_form": "quadratic"},
             "K5/bf16/spectral/quad")):
        run = bf16_strip_run(torch, pc, cc, engine, smi,
                             f"chain_bf16_spectral{suffix}",
                             chain_of(n_chunks=m, fgn_form="spectral", **kw),
                             spec_fits, form, None, m, (p_k, se_k),
                             "chain_bf16", reset_counts, read_counts,
                             n_checked=BF16_FORM_CHECKED)
        launches[form] = run["launches"][form]
    # Past the single tile: plain and paired at 512 steps (K6/bf16 pilot).
    far = chain_of(n=PAST_TILE_STEPS[-1])
    check(far.kernel_family == "tiled", "the 512-step bf16 strip resolved "
          f"to {far.kernel_family!r}")
    bf16_strip_forms(torch, pc, cc, smi, dev, key, far,
                     far.fit(engine._pilot_stream_keys(SEED)[0]),
                     PAST_TILE_STEPS[-1], ((False, False), (True, False)),
                     {})
    del far

    # chain_bf16_spectral: 400 steps, the K8/bf16 pilot, 16 chunks, beside
    # a single-strike K8/bf16 + K9/bf16 price of the same seed.
    n = SPECTRAL_PAST_TILE_STEPS
    one = engine.StreamingPricer(
        **MARKET, strike=STRIKE, maturity=n * DT, is_call=IS_CALL,
        config=dataclasses.replace(base, n_steps=n, n_paths=m * CHUNK,
                                   chunks_per_call=m, fgn_form="spectral"),
        device=dev)
    single = one.price(SEED, with_stderr=True)
    del one
    far = chain_of(n=n, n_chunks=m, fgn_form="spectral")
    check(far.kernel_family == "factored" and far.chain_consts.spectral,
          f"the {n}-step spectral bf16 strip resolved to "
          f"{far.kernel_family!r}")
    run = bf16_strip_run(torch, pc, cc, engine, smi, "chain_bf16_spectral",
                         far, None, "K5/bf16/spectral", "K8/bf16", m,
                         single, "single_strike_price_k9_bf16",
                         reset_counts, read_counts)
    launches["K5/bf16/spectral"] = run["launches"]["K5/bf16/spectral"]
    del far

    # The Greeks: the forms on the strip's log tables, then the full-width
    # runs and their pairs on 16 chunks under the same pilots' fits.
    consts = chain.consts
    g = chain.greeks_consts
    check(g.bf16 and consts.bf16, "the bf16 Greeks constants are float32")
    logs = pc.log_boundary_rows(chain._tables(fits, chain.strikes)
                                ).contiguous()
    bf16_greeks_forms(torch, pc, gc, smi, dev, key, consts, g, logs,
                      chain.strikes, times)
    one = engine.StreamingPricer(**MARKET, strike=STRIKE, maturity=MATURITY,
                                 is_call=IS_CALL, config=base, device=dev)
    grec = bf16_greeks_run(torch, engine, gc, smi, "greeks_bf16", one, None,
                           "K3/bf16", "K1/bf16", N_CHUNKS,
                           refs["price_bf16"][0], refs["greeks"],
                           reset_counts, read_counts)
    launches["K3/bf16"] = grec["launches"]["K3/bf16"]
    crec = bf16_greeks_run(torch, engine, gc, smi, "chain_greeks_bf16",
                           chain, None, "K4/bf16", "K1/bf16", N_CHUNKS,
                           bf16_prices, refs["chain_greeks"], reset_counts,
                           read_counts)
    launches["K4/bf16"] = crec["launches"]["K4/bf16"]
    anti_cfg = dataclasses.replace(base, antithetic=True, n_paths=m * CHUNK,
                                   chunks_per_call=m)
    anti_strip = chain_of(n_chunks=m, antithetic=True)
    anti_prices = anti_strip.price_with_fit(fits, SEED)
    one_fits = one.fit(engine._pilot_stream_keys(SEED)[0])
    one = engine.StreamingPricer(**MARKET, strike=STRIKE, maturity=MATURITY,
                                 is_call=IS_CALL, config=anti_cfg,
                                 device=dev)
    for name, pricer, f, form, ref in (
            ("greeks_bf16_anti", one, one_fits, "K3/bf16/anti",
             float(anti_prices[i_k])),
            ("chain_greeks_bf16_anti", anti_strip, fits, "K4/bf16/anti",
             anti_prices)):
        run = bf16_greeks_run(torch, engine, gc, smi, name, pricer, f, form,
                              None, m, ref, None, reset_counts, read_counts)
        launches[form] = run["launches"][form]
    return [kernel_record(form, launches, t["ms"], t["plain_ms"],
                          t["bound_ms"], t["bound_by"], t["max_abs_err"],
                          t["library_ms"], **split_of(t))
            for form, t in times.items()]


def roofline_phase(torch, rl, smi, dev, kernels: list, reset_counts,
                   read_counts) -> list:
    """P1: each probe against its plain version on a small grid (the
    normals in their four variants; the matmul in float32 and bf16 on the
    identity and a random orthogonal B), then the rates
    (``roofline.measure``, its launches counted), each probe again at the
    shapes the rates come from, the library yardsticks, and the P1
    ceiling of K1/K2 and K6/K7 in both dtypes (serial and overlapped)
    beside their measured times in ``kernels`` (their fraction of it; the
    rates in paths per second).  Adds "ceiling_ms" and
    "ceiling_overlap_ms" to those records and returns the probes'
    records."""
    key, checks = 11, []
    for unroll, with_exp, fma in ((1, False, 0), (3, False, 0),
                                  (1, True, 0), (1, False, rl.FMA_CHAIN)):
        got = rl.normals(key, 8, 2, unroll, with_exp, fma, device=dev)
        want = rl.normals_ref(key, 8, 2, unroll, with_exp, fma, device=dev)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        tol = 4e-5 * 1024 * unroll
        checks.append({"probe": "normals", "unroll": unroll,
                       "with_exp": with_exp, "fma": fma, "max_abs_err": err,
                       "atol": tol})
        check(err <= tol, f"P1/normals {checks[-1]} disagrees")
    s_pad = 384
    for which, b in (("identity", torch.eye(s_pad, device=dev)),
                     ("orthogonal", rl.orthogonal(s_pad).to(dev))):
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-3)):
            bb = b.to(dtype).contiguous()
            got = rl.matmul(key, bb, 2, 3)
            want = rl.matmul_ref(key, bb, 2, 3)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            checks.append({"probe": "matmul", "b": which,
                           "dtype": str(dtype), "max_abs_err": err,
                           "atol": tol * scale})
            check(err <= tol * scale, f"P1/matmul {checks[-1]} disagrees")

    reset_counts()
    res = rl.measure(dev, N_STEPS)
    launches = read_counts()
    rates = res["rates"]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    # Each probe again at the shapes the rates come from, against its
    # plain version: the normals' unroll-1 launch on its whole grid (the
    # kernels line's ms, plain_ms and max_abs_err; the plain version in
    # groups of blocks), its unroll-3, exp and FMA launches on three of
    # their blocks; the matmul at the measured grid and k, unroll 1 and 3,
    # in both dtypes, on the orthogonal B the rates were measured with.
    nrm = res["normals"]
    grid, k_n = nrm["grid"], nrm["k"]

    def normals_plain(unroll=1, with_exp=False, fma=0, blocks=None):
        blocks = range(grid) if blocks is None else blocks
        groups = [blocks[i:i + PROBE_REF_BLOCKS]
                  for i in range(0, len(blocks), PROBE_REF_BLOCKS)]
        return torch.cat([rl.normals_ref(key, len(g), k_n, unroll, with_exp,
                                         fma, device=dev, block0=g[0])
                          for g in groups])

    got = rl.normals(key, grid, k_n, device=dev)
    want, plain_s = timed(torch, normals_plain)
    nrm_err = float((got - want).abs().max())
    tol = 4e-5 * rl.BLOCK * k_n
    checks.append({"probe": "normals", "grid": grid, "k": k_n, "unroll": 1,
                   "blocks": "all", "max_abs_err": nrm_err, "atol": tol})
    check(nrm_err <= tol, f"P1/normals {checks[-1]} disagrees")
    del got, want
    few = [0, grid // 2, grid - 1]
    for unroll, with_exp, fma in ((3, False, 0), (1, True, 0),
                                  (1, False, rl.FMA_CHAIN)):
        got = rl.normals(key, grid, k_n, unroll, with_exp, fma,
                         device=dev)[few]
        want = torch.cat([normals_plain(unroll, with_exp, fma, [blk])
                          for blk in few])
        err = float((got - want).abs().max())
        tol = 4e-5 * rl.BLOCK * k_n * unroll
        checks.append({"probe": "normals", "grid": grid, "k": k_n,
                       "unroll": unroll, "with_exp": with_exp, "fma": fma,
                       "blocks": few, "max_abs_err": err, "atol": tol})
        check(err <= tol, f"P1/normals {checks[-1]} disagrees")
    count = nrm["normals_per_launch"]
    nrm_rec = {"ms": nrm["ms_u1"], "plain_ms": plain_s * 1e3,
               "library_ms": nrm["library_ms"]}
    b_ops = 2.0 * count / PEAK_F32_FLOPS
    b_bytes = 4.0 * grid * rl.LANES / PEAK_BYTES
    nrm_rec["bound_ms"] = max(b_ops, b_bytes) * 1e3
    nrm_rec["bound_by"] = "operations" if b_ops >= b_bytes else "bytes"

    mm = res["matmul"]
    mgrid = mm["grid"]
    b32 = rl.orthogonal(mm["s_pad"]).to(dev)
    mm_err, mm_plain = {}, {}
    for name, bb in (("float32", b32), ("bfloat16", b32.to(torch.bfloat16))):
        k_m = mm[name]["k"]
        for unroll in (1, 3):
            got = rl.matmul(key, bb, mgrid, k_m, unroll)
            want, plain_s = timed(torch, lambda: rl.matmul_ref(
                key, bb, mgrid, k_m, unroll))
            err = float((got - want).abs().max())
            atol = rl.chain_atol(name == "bfloat16", k_m * unroll,
                                 float(want.abs().max()))
            checks.append({"probe": "matmul", "b": "orthogonal",
                           "dtype": name, "grid": mgrid, "k": k_m,
                           "unroll": unroll, "max_abs_err": err,
                           "atol": atol})
            check(err <= atol, f"P1/matmul {checks[-1]} disagrees")
            if unroll == 1:
                mm_err[name], mm_plain[name] = err, plain_s * 1e3
            del got, want
    mm_rec = {"ms": mm["float32"]["ms_u1"],
              "library_ms": mm["float32"]["library_ms"],
              "plain_ms": mm_plain["float32"]}
    bf = mm["bfloat16"]
    macs32 = mm["float32"]["macs_per_launch"]
    mm_rec["bound_ms"] = max(2.0 * macs32 / PEAK_F32_FLOPS,
                             4.0 * (s_pad * s_pad + mgrid * rl.MM_SPLIT
                                    * s_pad) / PEAK_BYTES) * 1e3
    mm_rec["bound_by"] = "operations"
    del b32

    # The ceilings: the port's kernels at their main-path shapes.
    by_name = {k["name"]: k for k in kernels}
    shapes = {"pathgen": ("K1", PILOT, N_STEPS, "float32"),
              "priced_chunk": ("K2", CHUNK, N_STEPS, "float32"),
              "tiled_pathgen": ("K6", PILOT, LONG_STEPS, "float32"),
              "tiled_priced_chunk": ("K7", CHUNK, LONG_STEPS, "float32"),
              "K1/bf16": ("K1", PILOT, N_STEPS, "bfloat16"),
              "K2/bf16": ("K2", CHUNK, N_STEPS, "bfloat16"),
              "K6/bf16": ("K6", PILOT, LONG_STEPS, "bfloat16"),
              "K7/bf16": ("K7", CHUNK, LONG_STEPS, "bfloat16")}
    ceilings = {}
    for name, (kernel, rows, n, dtype) in shapes.items():
        c_ms = rl.ceiling_ms(rates, kernel, rows, n, dtype)
        o_ms = rl.ceiling_ms(rates, kernel, rows, n, dtype, overlap=True)
        rec = by_name[name]
        rec["ceiling_ms"] = c_ms
        rec["ceiling_overlap_ms"] = o_ms
        ceilings[name] = {"ceiling_ms": c_ms, "ceiling_overlap_ms": o_ms,
                          "ms": rec["ms"], "fraction": c_ms / rec["ms"],
                          "overlap_fraction": o_ms / rec["ms"],
                          "paths_per_s": rows / (rec["ms"] * 1e-3)}
    emit({"phase": "roofline", "card": smi, "sms": sms, "checks": checks,
          "rates": {"normals_per_s": rates.normals, "exp_per_s": rates.exp,
                    "fma_per_s": rates.fma,
                    "mm_f32_mac_per_s": rates.mm_f32,
                    "mm_bf16_mac_per_s": rates.mm_bf16,
                    "lib_mm_f32_mac_per_s": rates.lib_mm_f32,
                    "lib_mm_bf16_mac_per_s": rates.lib_mm_bf16},
          "data_sheet": {"fma_per_s": rl.PEAK_FMA_PER_S,
                         "bf16_mac_per_s": rl.PEAK_BF16_MAC_PER_S},
          "fma_share_of_peak": res["fma_share_of_peak"],
          "mm_f32_share_of_peak": res["mm_f32_share_of_peak"],
          "mm_bf16_share_of_peak": res["mm_bf16_share_of_peak"],
          "lib_mm_f32_share_of_peak": res["lib_mm_f32_share_of_peak"],
          "lib_mm_bf16_share_of_peak": res["lib_mm_bf16_share_of_peak"],
          "normals": nrm, "matmul": mm, "launches": launches,
          "records": {"P1/normals": nrm_rec, "P1/matmul": mm_rec},
          "matmul_bf16": {"ms": bf["ms_u1"], "plain_ms": mm_plain["bfloat16"],
                          "library_ms": bf["library_ms"],
                          "max_abs_err": mm_err["bfloat16"]},
          "ceilings": ceilings})
    check(all(v > 0 and math.isfinite(v) for v in (
        rates.normals, rates.exp, rates.fma, rates.mm_f32, rates.mm_bf16)),
        f"roofline rates {rates} not finite and positive")
    check(launches["P1/normals"] > 0 and launches["P1/matmul"] > 0,
          f"roofline launches {launches}")
    return [kernel_record("P1/normals", launches, nrm_rec["ms"],
                          nrm_rec["plain_ms"], nrm_rec["bound_ms"],
                          nrm_rec["bound_by"], nrm_err,
                          nrm_rec["library_ms"]),
            kernel_record("P1/matmul", launches, mm_rec["ms"],
                          mm_rec["plain_ms"], mm_rec["bound_ms"],
                          mm_rec["bound_by"], mm_err["float32"],
                          mm_rec["library_ms"],
                          bf16_ms=bf["ms_u1"],
                          bf16_plain_ms=mm_plain["bfloat16"],
                          bf16_max_abs_err=mm_err["bfloat16"],
                          bf16_library_ms=bf["library_ms"],
                          bf16_bound_ms=2.0 * bf["macs_per_launch"]
                          / PEAK_BF16_FLOPS * 1e3)]


def pipeline_inputs(work: Path, seed: int) -> list:
    """The ``prediction_gen`` phase's inputs in WORK, made from SEED: a
    wide spot CSV (two tickers, PG_SPOT_DAYS calendar days) and an option
    CSV of PG_ROWS rows, puts and calls within 10 % of the money, PG_SENTINELS
    of them planted at random rows to fail validation.  Returns the planted
    rows' indices."""
    import datetime

    import numpy as np
    from montecarlooptionspricer_tpu_torch.pipeline import csv_io

    rng = np.random.default_rng(seed)
    end = datetime.date(2024, 6, 28)
    tickers = ("aaa", "bbb")
    px = {t: 100.0 for t in tickers}
    spot = {t: {} for t in tickers}
    table = []
    for back in range(PG_SPOT_DAYS, -1, -1):
        d = end - datetime.timedelta(days=back)
        row = [f"{d.month}/{d.day}/{d.year}"]
        for t in tickers:
            px[t] *= float(np.exp(rng.normal(0.0002, 0.015)))
            row.append(f"{px[t]:.4f}")
            spot[t][d] = float(row[-1])
        table.append(row)
    csv_io.write_csv(str(work / "spot.csv"),
                     ["Date"] + [t.upper() for t in tickers], table)

    def line(ticker, option_type, d, s, dte, sdp, dividend):
        date = d if isinstance(d, str) else f"{d.month}/{d.day}/{d.year}"
        return (f"{ticker},{option_type},{date},{s},{dte},{sdp},0.5,0.01,"
                f"0.2,-0.05,0.03,0.25,100,2.5,{dividend}")

    s_end = spot["aaa"][end]
    planted = [
        "bad,row",                                        # short row
        line("aaa", 0, end, "abc", 30, 0.0, 0.01),        # not a number
        line("aaa", 0, end, -5.0, 30, 0.0, 0.01),         # spot <= 0
        line("aaa", 0, end, s_end, 30, 1.5, 0.01),        # distance > 1
        line("zzz", 0, end, 100.0, 30, 0.0, 0.01),        # no history
        line("aaa", 1, "13/45/2024", s_end, 30, 0.0, 0.01),  # bad date
        line("aaa", 0, end, s_end, 1.0, 0.0, 0.01),       # 0 steps
        line("bbb", 1, end, s_end, 1.5, 0.0, 0.01),       # 11 days: vol 0
    ]
    assert len(planted) == PG_SENTINELS
    at = sorted(int(i) for i in rng.choice(PG_ROWS, PG_SENTINELS,
                                           replace=False))
    dtes = list(PG_BUCKET_DTE) + [
        float(round(v)) for v in np.exp(rng.uniform(
            np.log(7.0), np.log(1825.0),
            PG_ROWS - PG_SENTINELS - len(PG_BUCKET_DTE)))]
    rng.shuffle(dtes)
    planted_it, dte_it = iter(planted), iter(dtes)
    lines = []
    for i in range(PG_ROWS):
        if i in at:
            lines.append(next(planted_it))
            continue
        t = tickers[int(rng.integers(2))]
        d = end - datetime.timedelta(days=int(rng.integers(0, 600)))
        lines.append(line(t, int(rng.integers(2)), d, spot[t][d],
                          next(dte_it), round(float(rng.uniform(-0.1, 0.1)),
                                              4),
                          round(float(rng.uniform(0.0, 0.03)), 4)))
    (work / "options.csv").write_text(
        PG_OPTION_HEADER + "\n" + "".join(ln + "\n" for ln in lines))
    return at


def pipeline_stage_ms(torch, pricing, market, tasks, zc, dw, rp,
                      dev) -> dict:
    """Host-clock ms of each stage of one batch of ``tasks`` on the card,
    the device synchronized around each: the paths, then each estimator,
    as ``BatchedPricer.price_from_noise`` runs them."""
    from montecarlooptionspricer_tpu_torch.models import (
        asymptotic, branching, lsm, martingale)
    from montecarlooptionspricer_tpu_torch.models import (
        rough_volatility as rv)
    from montecarlooptionspricer_tpu_torch.pipeline.driver import bucket_key

    def col(name, dtype=torch.float32):
        return torch.tensor([getattr(t, name) for t in tasks], dtype=dtype,
                            device=dev)

    out = {}

    def stage(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        out[name] = 1e3 * (time.perf_counter() - t0)
        return result

    n_pad, m1 = bucket_key(tasks[0].n_steps)
    n_steps = col("n_steps", torch.int64)
    kw = dict(strike=col("strike"), maturity=col("maturity"), dt=market.dt,
              is_call=col("is_call", torch.bool))
    paths = stage("paths", lambda: rv._bucketed_paths_from_noise(
        col("s0"), col("xi"), col("h"), col("eta"), market.r, n_steps, n_pad,
        m1, zc.to(dev), dw.to(dev), market.dt))
    stage("asymptotic", lambda: asymptotic.asymptotic_price(
        paths, market.r, sigma=col("sigma"), dividend=col("dividend"), **kw))
    stage("branching", lambda: branching.branching_price(
        paths, market.r, num_branches=pricing.num_branches, rp=rp.to(dev),
        n_steps=n_steps, **kw))
    stage("lsm", lambda: lsm.lsm_price_rows(
        paths, market.r, poly_order=pricing.poly_order, n_steps=n_steps,
        **kw))
    stage("martingale", lambda: martingale.martingale_price(
        paths, market.r, poly_order=pricing.poly_order,
        max_iterations=pricing.max_iterations, n_steps=n_steps, **kw))
    return out


def per_call_us(fn) -> float:
    """Host-clock microseconds a call of ``fn``, over at least HOST_TIME_S
    and three calls, after one call."""
    fn()
    reps, t0 = 0, time.perf_counter()
    while reps < 3 or time.perf_counter() - t0 < HOST_TIME_S:
        fn()
        reps += 1
    return 1e6 * (time.perf_counter() - t0) / reps


def host_rel(got: float, want: float) -> float:
    """|got - want| / |want|, 0 where the two are equal (0 and 0 too)."""
    return 0.0 if got == want else abs(got - want) / abs(want)


def host_engine_phase(smi, built=None) -> None:
    """``host_engine``: the port's native host engine (``csrc/host/``,
    built with the host C++ compiler; ``built`` is ``host_build.build()``'s
    result where the build ran beside nvcc, else it builds here) against
    its plain versions: ``estimate_params``, ``hurst_exponent_dfa`` and
    ``twenty_day_vol_and_momentum`` on seeded histories of HOST_SIZES
    points (HOST_RTOL relative, H HOST_H_RTOL), each size's host features
    of one option row (the parameters and the 20-day vol and momentum)
    timed native and plain; ``read_table`` against ``read_table_plain`` on
    the ``prediction_gen`` phase's option and spot CSVs, equal as lists,
    each timed."""
    import shutil
    import tempfile

    import numpy as np
    from montecarlooptionspricer_tpu_torch.kernels import host_build
    from montecarlooptionspricer_tpu_torch.ops import estimators as est
    from montecarlooptionspricer_tpu_torch.pipeline import csv_io
    from montecarlooptionspricer_tpu_torch.pipeline import spot as spot_mod

    t_phase = time.perf_counter()
    libs, build_s, unit_s = built or host_build.build()
    rng = np.random.default_rng(SEED)
    sizes = {}
    for n in HOST_SIZES:
        prices = 100.0 * np.exp(np.cumsum(rng.normal(2e-4, 0.015, n)))
        rets = np.log(prices[1:] / prices[:-1])
        hist = [float(v) for v in prices]
        got, want = est.estimate_params(prices), est.estimate_params_plain(
            prices)
        err = {k: host_rel(getattr(got, k), getattr(want, k))
               for k in ("s0", "xi", "h", "eta", "rho")}
        err["hurst_dfa"] = host_rel(est.hurst_exponent_dfa(rets),
                                    est.hurst_exponent_dfa_plain(rets))
        vm = spot_mod.twenty_day_vol_and_momentum(hist)
        vm_plain = spot_mod.twenty_day_vol_and_momentum_plain(hist)
        err["vol"], err["momentum"] = (host_rel(vm[0], vm_plain[0]),
                                       host_rel(vm[1], vm_plain[1]))
        native_us = per_call_us(lambda: (
            est.estimate_params(prices),
            spot_mod.twenty_day_vol_and_momentum(hist)))
        plain_us = per_call_us(lambda: (
            est.estimate_params_plain(prices),
            spot_mod.twenty_day_vol_and_momentum_plain(hist)))
        sizes[n] = {"max_rel_err": err, "native_us_per_row": native_us,
                    "plain_us_per_row": plain_us,
                    "plain_over_native": plain_us / native_us}
        h_err = max(err["h"], err["hurst_dfa"])
        check(h_err <= HOST_H_RTOL and max(
            v for k, v in err.items() if k not in ("h", "hurst_dfa"))
            <= HOST_RTOL, f"host_engine: {n} points, errors {err}")
    work = Path(tempfile.mkdtemp(prefix="mcop_host_engine_"))
    try:
        pipeline_inputs(work, SEED)
        tables = {}
        for name in ("options.csv", "spot.csv"):
            path = str(work / name)
            table = csv_io.read_table(path)
            check(table == csv_io.read_table_plain(path),
                  f"host_engine: read_table differs from its plain version "
                  f"on {name}")
            tables[name] = {
                "rows": len(table[1]), "bytes": (work / name).stat().st_size,
                "native_ms": 1e-3 * per_call_us(
                    lambda: csv_io.read_table(path)),
                "plain_ms": 1e-3 * per_call_us(
                    lambda: csv_io.read_table_plain(path))}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    emit({"phase": "host_engine",
          "libraries": [p.name for p in libs.values()],
          "compiler": host_build.compiler(),
          "flags": list(host_build.CXX_FLAGS), "build_s": build_s,
          "build_s_per_unit": unit_s, "features": sizes,
          "rtol": HOST_RTOL, "h_rtol": HOST_H_RTOL, "read_table": tables,
          "seconds": time.perf_counter() - t_phase, "card": smi})


def prediction_gen_phase(torch, smi, dev, reset_counts, read_counts) -> None:
    """``prediction_gen``: the PredictionGen path at the reference's width
    through ``run_pipeline`` on the card (no CUDA kernel of the port lies
    on it: the JAX package prices these rows in XLA, so every kernel's
    launch count must stay 0).  Checks the exit code, the rows, the
    header, the planted sentinel rows and finite prices elsewhere, that a
    resume of the output cut after PG_RESUME_FROM rows writes the one-shot
    run's bytes, one batch of the n_pad 256 bucket priced through
    ``BatchedPricer.price_from_noise`` on the card and on the host from
    one injected noise (each estimator within PG_CHECK_RTOL relative, the
    path's plain-version check), and GBM paths through the row pricer's
    LSM against the binomial tree and Black-Scholes."""
    import shutil
    import tempfile

    import numpy as np
    from montecarlooptionspricer_tpu_torch.config import (
        AUGMENTED_COLUMNS, MarketDefaults, PipelineConfig, PricingConfig)
    from montecarlooptionspricer_tpu_torch.models import gbm
    from montecarlooptionspricer_tpu_torch.models.closed_form import (
        binomial_american, black_scholes)
    from montecarlooptionspricer_tpu_torch.models.lsm import lsm_price_rows
    from montecarlooptionspricer_tpu_torch.models.pricing import ESTIMATORS
    from montecarlooptionspricer_tpu_torch.pipeline import csv_io, driver
    from montecarlooptionspricer_tpu_torch.pipeline import spot as spot_mod
    from montecarlooptionspricer_tpu_torch.pipeline.watchdog import (
        current_memory_bytes)

    t_phase = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="mcop_prediction_gen_"))
    try:
        planted = pipeline_inputs(work, SEED)
        # The watchdog reads this process's peak RSS, which the earlier
        # phases set: keep its 8 GiB of room above what they left.
        limit = PipelineConfig().max_memory_bytes
        peak_rss = current_memory_bytes()
        if peak_rss >= limit // 2:
            limit += peak_rss
        config = PipelineConfig(
            option_csv=str(work / "options.csv"),
            spot_csv=str(work / "spot.csv"),
            output_csv=str(work / "out.csv"),
            error_log=str(work / "error_log.txt"),
            diagnostic_csv=str(work / "diagnostic.csv"),
            max_memory_bytes=limit)
        pricing = PricingConfig(**PG_PRICING)
        market = MarketDefaults()

        timings = {}
        reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rc = driver.run_pipeline(config, pricing, market, device=dev,
                                 timings=timings)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        peak_device = torch.cuda.max_memory_allocated()
        buckets = {key: {"batches": len(secs),
                         "ms_per_batch": 1e3 * sum(secs) / len(secs)}
                   for key, secs in timings.get("buckets", {}).items()}
        emit({"phase": "prediction_gen_run", "rows": PG_ROWS, "rc": rc,
              "wall_s": wall, "rows_per_s": PG_ROWS / wall,
              "host_s": timings.get("host_s"),
              "device_s": timings.get("device_s"), "buckets": buckets,
              "peak_rss_bytes_before": peak_rss,
              "max_memory_bytes": limit, "peak_device_bytes": peak_device,
              "card": smi})
        check(rc == 0, f"prediction_gen: run_pipeline exit code {rc}")
        check(launches == expected_counts(),
              f"prediction_gen launched kernels: {launches}")
        header, rows = csv_io.read_table(config.option_csv)
        out_header, out_rows = csv_io.read_table(config.output_csv)
        check(out_header == header + list(AUGMENTED_COLUMNS),
              f"prediction_gen: header {out_header}")
        check(len(out_rows) == len(rows) == PG_ROWS,
              f"prediction_gen: {len(out_rows)} rows out of {len(rows)}")
        one_shot = (work / "out.csv").read_bytes()
        body = one_shot.decode().splitlines()[1:]
        sentinels = [i for i, ln in enumerate(body)
                     if ln.endswith(driver.SENTINEL)]
        check(sentinels == planted,
              f"prediction_gen: sentinels at {sentinels}, planted {planted}")
        prices = np.asarray([[float(v) for v in r[-6:-2]]
                             for i, r in enumerate(out_rows)
                             if i not in planted])
        check(bool(np.isfinite(prices).all()),
              "prediction_gen: non-finite prices")
        check(len(buckets) >= len(PG_BUCKET_DTE),
              f"prediction_gen: buckets {sorted(buckets)}")

        # Resume of the output cut after PG_RESUME_FROM rows.
        cut = one_shot.splitlines(keepends=True)[:1 + PG_RESUME_FROM]
        (work / "out.csv").write_bytes(b"".join(cut))
        t0 = time.perf_counter()
        rc = driver.run_pipeline(config, pricing, market, resume=True,
                                 device=dev)
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        resumed = (work / "out.csv").read_bytes()
        differ = [i for i, (a, b) in enumerate(zip(
            resumed.splitlines(), one_shot.splitlines())) if a != b]
        check(rc == 0 and resumed == one_shot,
              f"prediction_gen: resume rc {rc}, {len(differ)} lines differ "
              f"(first {differ[:3]}), {len(resumed)} against "
              f"{len(one_shot)} bytes")

        # One batch of the n_pad 256 bucket on the card and on the host.
        spot_data = spot_mod.load_spot_prices(config.spot_csv)
        tasks = []
        for idx, tokens in enumerate(rows):
            task, _ = driver._parse_row(idx, ",".join(tokens), tokens,
                                        spot_data, market, lambda m: None)
            if task is not None and driver.bucket_key(task.n_steps) == (
                    PG_CHECK_PAD, PG_CHECK_PAD):
                tasks.append(task)
            if len(tasks) == PG_CHECK_ROWS:
                break
        check(len(tasks) == PG_CHECK_ROWS,
              f"prediction_gen: {len(tasks)} rows at n_pad {PG_CHECK_PAD}")
        gen = torch.Generator().manual_seed(SEED)
        shape = (PG_CHECK_ROWS, pricing.num_paths, PG_CHECK_PAD)
        zc = torch.complex(torch.randn(shape, generator=gen),
                           torch.randn(shape, generator=gen))
        dw = torch.randn(shape, generator=gen) * math.sqrt(market.dt)
        rp = torch.randint(0, pricing.num_paths,
                           shape + (pricing.num_branches,), generator=gen)
        on_card = driver.BatchedPricer(pricing, market, dev).price_from_noise(
            tasks, zc, dw, rp)
        on_host = driver.BatchedPricer(pricing, market, "cpu") \
            .price_from_noise(tasks, zc, dw, rp)
        stage_ms = pipeline_stage_ms(torch, pricing, market, tasks, zc, dw,
                                     rp, dev)
        diff = np.abs(on_card.astype(np.float64) - on_host)
        rel = np.where(diff == 0.0, 0.0, diff / np.maximum(np.abs(on_host),
                                                           1e-30))
        noise_err = {name: float(rel[:, i].max())
                     for i, name in enumerate(ESTIMATORS)}

        # GBM through the row pricer's LSM (tests/test_pricers.py's bracket).
        s0, k, r, sigma, mat, steps = 100.0, 110.0, 0.05, 0.25, 0.5, 50
        paths = gbm.generate_paths(
            torch.Generator(device=dev).manual_seed(SEED), s0, sigma, r,
            steps, 20_000, mat / steps)
        lsm = float(lsm_price_rows(paths[None], r, k, mat, mat / steps,
                                   False)[0])
        amer = binomial_american(s0, k, r, sigma, mat, False, steps=2000)
        euro = black_scholes(s0, k, r, sigma, mat, False)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    phase_s = time.perf_counter() - t_phase
    emit({"phase": "prediction_gen", "rows": PG_ROWS, "wall_s": wall,
          "rows_per_s": PG_ROWS / wall, "host_s": timings["host_s"],
          "device_s": timings["device_s"], "buckets": buckets,
          "resume_from": PG_RESUME_FROM, "resume_s": resume_s,
          "resume_byte_equal": True, "sentinel_rows": planted,
          "noise_rows": PG_CHECK_ROWS, "noise_n_pad": PG_CHECK_PAD,
          "card_vs_host_rel_err": noise_err, "rtol": PG_CHECK_RTOL,
          "stage_ms": stage_ms, "peak_device_bytes": peak_device,
          "gbm_lsm": lsm, "binomial": amer, "black_scholes": euro,
          "kernel_launches": sum(launches.values()), "phase_s": phase_s,
          "phase_limit_s": PG_PHASE_LIMIT_S, "card": smi})
    check(max(noise_err.values()) <= PG_CHECK_RTOL,
          f"prediction_gen: card against host {noise_err}")
    check(euro - 0.15 < lsm < amer * 1.10 and abs(lsm - amer) / amer < 0.10,
          f"prediction_gen: GBM LSM {lsm} against binomial {amer}, "
          f"Black-Scholes {euro}")


# ---------------------------------------------------------------------------
# Randomized QMC: the noise, its cells on K2, K5, K7 and K9, the
# fallback to the generic stream, and the pipeline's ``--qmc``.

def qmc_noise_phase(torch, engine, smi, dev) -> None:
    """``qmc_noise``: the QMC noise made on the card against its host build
    from one set of draws on QMC_HOST_ROWS rows (chol at 365 steps without
    and with qmc_fgn, spectral with it, the factored planes at 1000 steps
    with it), within QMC_NOISE_ATOL; the card's float32 ndtri against
    float64 on a chunk's uniforms; the shift words spanning both signs of
    their int32 patterns (full 32-bit words)."""
    from montecarlooptionspricer_tpu_torch.ops import qmc as qmc_ops

    errs, tols = {}, {}
    for form, n, fgn in (("chol", N_STEPS, False), ("chol", N_STEPS, True),
                         ("spectral", N_STEPS, True),
                         ("factored", 1000, True)):
        cfg = engine.StreamConfig(
            n_paths=QMC_HOST_ROWS, n_steps=n, chunk_paths=QMC_HOST_ROWS,
            pilot_paths=QMC_HOST_ROWS, dt=DT, qmc=True, qmc_fgn=fgn)
        host = engine.make_fused_qmc(cfg, form, "cpu")
        draws = engine.fused_qmc_draws(host,
                                       torch.Generator().manual_seed(SEED))
        want = engine.fused_qmc_noise(host, *draws)
        got = engine.fused_qmc_noise(engine.make_fused_qmc(cfg, form, dev),
                                     *(d.to(dev) for d in draws))
        torch.cuda.synchronize()
        name = f"{form}/{n}" + ("/qmc_fgn" if fgn else "")
        errs[name] = float((got.cpu() - want).abs().max())
        tols[name] = QMC_NOISE_ATOL * math.sqrt(n / N_STEPS)
    shift = qmc_ops.draw_shift(torch.Generator(device=dev).manual_seed(SEED),
                               256)
    u = qmc_ops.rotate(qmc_ops.base_bits(CHUNK, 256, dev), shift)
    ndtri_err = float((torch.special.ndtri(u).double()
                       - torch.special.ndtri(u.double())).abs().max())
    signs = (int(shift.min()) < 0 < int(shift.max()))
    emit({"phase": "qmc_noise", "card": smi, "host_rows": QMC_HOST_ROWS,
          "card_vs_host_max_abs_err": errs, "atol": tols,
          "ndtri_f32_vs_f64_max_abs_err": ndtri_err,
          "ndtri_points": u.numel(), "shift_spans_32_bits": signs})
    check(all(errs[k] <= tols[k] for k in errs),
          f"qmc_noise: the card's noise differs from the host's: {errs}")
    check(ndtri_err <= 2e-6, f"qmc_noise: float32 ndtri off by {ndtri_err}")
    check(signs, "qmc_noise: the shift words do not span 32 bits")


def qmc_noise_times(torch, pc, pricer, n: int, kernel, c0) -> dict:
    """The QMC noise's ms per chunk (the chunk of carrier ``c0``)
    beside the kernel's on that noise, the PCA product alone (TF32 off),
    and its peak device bytes over what was allocated before
    it."""
    q = pricer._fused_qmc
    a = torch.randn((q.rows, n), device=q.device)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    pricer._qmc_chunk_noise(c0)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    out = {"noise_ms": time_ms(torch, lambda: pricer._qmc_chunk_noise(c0),
                                 3),
           "pca_matmul_ms": time_ms(torch,
                                    lambda: pc._matmul_f32(a, q.pca_t), 3),
           "kernel_ms": time_ms(torch, kernel, 5),
           "noise_peak_bytes": peak}
    out["noise_over_kernel"] = out["noise_ms"] / out["kernel_ms"]
    return out


def qmc_price_phase(torch, pc, pfc, engine, smi, dev, name: str,
                    n_steps: int, form: dict, n_chunks: int, prng: tuple,
                    reset_counts, read_counts, check_ratio: bool) -> tuple:
    """One QMC price: price()'s fit (the pilot on the generic stream's QMC
    generator, no kernel) and stream (each chunk's QMC noise through the
    family's noise-in kernel, ``n_chunks`` launches, every one on injected
    noise), the launch counts read around them; chunk 0's noise through
    the kernel against its plain version; the noise's and the kernel's
    times.  ``prng`` = (price, stderr, paths, fits) is the same
    configuration's PRNG price and the fits it streamed under: the QMC
    chunks streamed under those fits too (a stderr is conditional on its
    pilot's fit, so two pilots' prices differ by more than their
    stderrs) lie within 5 combined stderr of it, and their variance ratio
    per path (se_prng^2 n_prng) / (se^2 n) is held > 1 where
    ``check_ratio``.  The QMC pilot's price is reported beside it.
    Returns (kernel name, noise-in launches)."""
    cfg = engine.StreamConfig(n_paths=CHUNK * n_chunks, n_steps=n_steps,
                              chunk_paths=CHUNK, pilot_paths=PILOT, dt=DT,
                              chunks_per_call=n_chunks, qmc=True, **form)
    pricer = engine.StreamingPricer(**MARKET, strike=STRIKE,
                                    maturity=n_steps * DT, is_call=IS_CALL,
                                    config=cfg, device=dev)
    wrapper = pricer._priced_chunk
    kname = {"single": "K2", "tiled": "K7",
             "factored": "K9"}[pricer.kernel_family]
    cv = cfg.control_variate
    key = (wrapper.__name__ if not cv
           else f"{kname}/{pc.form_name(False, True)}")
    reset_counts()
    wrapper.noise_launches = 0
    fits, price, stderr, fit_s, stream_s = fit_and_price(torch, engine,
                                                         pricer)
    launches, noise_launches = read_counts(), wrapper.noise_launches
    table = pricer._make_rows(fits.fits if cv else fits)
    c0 = (engine._pilot_stream_keys(SEED)[1][0], 0)     # chunk 0's carrier
    noise = pricer._qmc_chunk_noise(c0)
    ref = (pfc.factored_priced_chunk_from_noise_ref
           if pricer.kernel_family == "factored"
           else pc.priced_chunk_from_noise_ref)

    def kernel():
        return wrapper(pricer.consts, table, STRIKE, IS_CALL, noise=noise,
                       with_cv=cv, policy_form=cfg.policy_form)

    got, want = kernel(), ref(pricer.consts, table, noise, STRIKE, IS_CALL,
                              False, cv, cfg.policy_form)
    got, want = (got[0], want[0]) if cv else (got, want)
    torch.cuda.synchronize()
    err = abs(float(got) / float(want) - 1.0)
    times = qmc_noise_times(torch, pc, pricer, n_steps, kernel, c0)
    del noise
    p_prng, se_prng, n_prng, prng_fits = prng
    n_paths = CHUNK * n_chunks
    shared, se_shared = pricer.price_with_fit(prng_fits, SEED,
                                              with_stderr=True)
    sigmas = abs(shared - p_prng) / math.hypot(se_shared, se_prng)
    ratio = (se_prng ** 2 * n_prng) / (se_shared ** 2 * n_paths)
    pilot_sigmas = abs(price - p_prng) / math.hypot(stderr, se_prng)
    wall = fit_s + stream_s
    emit({"phase": name, "card": smi, "n_paths": n_paths, "n_steps": n_steps,
          **form, "qmc_dim": cfg.qmc_dim, "kernel": kname,
          "kernel_family": pricer.kernel_family, "price": price,
          "stderr": stderr, "wall_s": wall, "paths_per_s": n_paths / wall,
          "fit_s": fit_s, "stream_s": stream_s, "launches": launches,
          "noise_in_launches": noise_launches,
          "chunk0_kernel_vs_plain_rel_err": err, "rtol": SUM_RTOL, **times,
          "prng_price": p_prng, "prng_stderr": se_prng,
          "prng_paths": n_prng, "price_under_prng_fits": shared,
          "stderr_under_prng_fits": se_shared,
          "combined_stderrs_apart": sigmas, "limit": STDERR_SIGMAS,
          "variance_ratio_per_path": ratio,
          "qmc_pilot_combined_stderrs_apart": pilot_sigmas})
    check(launches == expected_counts(**{key: n_chunks}),
          f"{name} launches {launches}, want {key} {n_chunks} times and "
          "nothing else")
    check(noise_launches == n_chunks,
          f"{name}: {noise_launches} noise-in launches, want {n_chunks}")
    check(math.isfinite(price) and 0.0 < price < STRIKE,
          f"{name} price {price} outside (0, strike)")
    check(math.isfinite(stderr) and stderr > 0.0,
          f"{name} stderr {stderr} not finite and positive")
    check(err <= SUM_RTOL,
          f"{name}: {kname} on QMC noise disagrees with its plain version")
    check(math.isfinite(se_shared) and se_shared > 0.0,
          f"{name}: stderr {se_shared} under the PRNG fits")
    check(sigmas <= STDERR_SIGMAS,
          f"{name} is {sigmas:.2f} combined stderr from the PRNG price")
    if check_ratio:
        check(ratio > 1.0, f"{name}: variance ratio {ratio} <= 1")
    return kname, noise_launches


def qmc_chain_phase(torch, pc, cc, engine, smi, dev, strip_prng: tuple,
                    reset_counts, read_counts) -> int:
    """``qmc_chain``: the 21-strike strip at 1e7 x 365 under QMC, the
    pilot on the QMC stream and each chunk's noise through K5's noise-in
    entry once; K5 on chunk 0's noise against its plain version; prices
    rising in strike.  ``strip_prng`` = (prices, stderrs, fits) is the
    PRNG strip on as many paths and the fits it streamed under: the QMC
    chunks under those fits hold each strike within 5 combined stderr of
    it, with the variance ratio at the bench strike > 1.  Returns K5's
    noise-in launches."""
    import numpy as np

    cfg = engine.StreamConfig(n_paths=CHUNK * N_CHUNKS, n_steps=N_STEPS,
                              chunk_paths=CHUNK, pilot_paths=PILOT, dt=DT,
                              chunks_per_call=N_CHUNKS, qmc=True)
    chain = engine.StreamingChainPricer(**MARKET, strikes=STRIP,
                                        maturity=MATURITY, is_call=IS_CALL,
                                        config=cfg, device=dev)
    reset_counts()
    cc.priced_chain.noise_launches = 0
    (prices, stderrs), wall = timed(
        torch, lambda: chain.price(SEED, with_stderr=True))
    launches, noise_launches = read_counts(), cc.priced_chain.noise_launches
    fits = chain.fit(engine._pilot_stream_keys(SEED)[0])
    tables = chain._tables(fits, chain.strikes)
    c0 = (engine._pilot_stream_keys(SEED)[1][0], 0)
    noise = chain._qmc_chunk_noise(c0)

    def kernel():
        return cc.priced_chain(chain.chain_consts, tables, IS_CALL,
                               noise=noise)

    err = scaled_err(torch, kernel(), cc.priced_chain_from_noise_ref(
        chain.chain_consts, tables, noise, IS_CALL))
    times = qmc_noise_times(torch, pc, chain, N_STEPS, kernel, c0)
    del noise
    p_prng, se_prng = (np.asarray(v, np.float64) for v in strip_prng[:2])
    shared, se_shared = chain.price_with_fit(strip_prng[2], SEED,
                                             with_stderr=True)
    combined = np.hypot(se_shared, se_prng)
    with np.errstate(divide="ignore", invalid="ignore"):
        sigmas = np.where(combined > 0, np.abs(shared - p_prng) / combined,
                          np.where(shared == p_prng, 0.0, np.inf))
        ratios = (se_prng / se_shared) ** 2
        pilot_sigmas = np.abs(prices - p_prng) / np.hypot(stderrs, se_prng)
    i_k = STRIP.index(STRIKE)
    n_paths = CHUNK * N_CHUNKS
    emit({"phase": "qmc_chain", "card": smi, "n_paths": n_paths,
          "n_steps": N_STEPS, "strikes": list(STRIP), "kernel": "K5",
          "prices": prices.tolist(), "stderrs": stderrs.tolist(),
          "wall_s": wall, "paths_strikes_per_s": n_paths * len(STRIP) / wall,
          "launches": launches, "noise_in_launches": noise_launches,
          "chunk0_kernel_vs_plain_rel_err": err, "rtol": SUM_RTOL, **times,
          "prng_prices": p_prng.tolist(), "prng_stderrs": se_prng.tolist(),
          "prices_under_prng_fits": shared.tolist(),
          "stderrs_under_prng_fits": se_shared.tolist(),
          "combined_stderrs_apart": [float(v) for v in sigmas],
          "qmc_pilot_combined_stderrs_apart": [float(v)
                                               for v in pilot_sigmas],
          "limit": STDERR_SIGMAS,
          "variance_ratios": [float(v) for v in ratios],
          "variance_ratio_at_strike": float(ratios[i_k])})
    check(launches == expected_counts(priced_chain=N_CHUNKS),
          f"qmc_chain launches {launches}, want K5 {N_CHUNKS} times")
    check(noise_launches == N_CHUNKS,
          f"qmc_chain: {noise_launches} noise-in launches")
    check(bool(np.all(np.isfinite(prices))) and bool(np.all(prices > 0)),
          "qmc_chain: prices not finite and positive")
    check(bool(np.all(np.diff(prices) > 0)),
          "qmc_chain: put prices do not rise in strike")
    check(err <= SUM_RTOL, "qmc_chain: K5 on QMC noise disagrees with its "
          "plain version")
    check(float(np.max(sigmas)) <= STDERR_SIGMAS,
          f"qmc_chain: a strike is {float(np.max(sigmas)):.2f} combined "
          "stderr from the PRNG strip")
    check(ratios[i_k] > 1.0,
          f"qmc_chain: variance ratio {ratios[i_k]} <= 1 at {STRIKE}")
    return noise_launches


def qmc_fallback_phase(engine, smi, dev) -> None:
    """``qmc_fallback``: a QMC configuration that no noise-in kernel covers
    (a cubic policy at 365 steps; a strip past K5's 512 steps, where the
    JAX chain falls back silently) resolves to the generic stream and logs
    a warning; one that a kernel covers logs none."""
    import logging

    seen = []

    class Keep(logging.Handler):
        def emit(self, record):
            seen.append(record.getMessage())

    logger = logging.getLogger(engine.__name__)
    handler = Keep(logging.WARNING)
    logger.addHandler(handler)
    cases = {}
    try:
        for name, n, extra, strip in (("cubic_365", N_STEPS,
                                       dict(poly_order=3), False),
                                      ("strip_600", 600, {}, True),
                                      ("kernel_365", N_STEPS, {}, False)):
            seen.clear()
            cfg = engine.StreamConfig(
                n_paths=CHUNK, n_steps=n, chunk_paths=CHUNK,
                pilot_paths=PILOT, dt=DT, qmc=True, **extra)
            kw = dict(**MARKET, maturity=n * DT, is_call=IS_CALL,
                      config=cfg, device=dev)
            p = (engine.StreamingChainPricer(strikes=STRIP, **kw) if strip
                 else engine.StreamingPricer(strike=STRIKE, **kw))
            cases[name] = {"kernel_family": p.kernel_family,
                           "warned": any("no noise-in kernel" in m
                                         for m in seen)}
    finally:
        logger.removeHandler(handler)
    emit({"phase": "qmc_fallback", "card": smi, "cases": cases})
    for name in ("cubic_365", "strip_600"):
        check(cases[name] == {"kernel_family": "stream", "warned": True},
              f"qmc_fallback {name}: {cases[name]}")
    check(cases["kernel_365"] == {"kernel_family": "single",
                                  "warned": False},
          f"qmc_fallback kernel_365: {cases['kernel_365']}")


def prng_pricer(engine, dev, n_steps: int, n_chunks: int,
                strip: bool = False, **form):
    """The bench market's pricer (the strip's with ``strip``) at
    ``n_steps`` on ``n_chunks`` chunks, with the StreamConfig fields
    ``form``."""
    cfg = engine.StreamConfig(n_paths=CHUNK * n_chunks, n_steps=n_steps,
                              chunk_paths=CHUNK, pilot_paths=PILOT, dt=DT,
                              chunks_per_call=n_chunks, **form)
    kw = dict(**MARKET, maturity=n_steps * DT, is_call=IS_CALL, config=cfg,
              device=dev)
    if strip:
        return engine.StreamingChainPricer(strikes=STRIP, **kw)
    return engine.StreamingPricer(strike=STRIKE, **kw)


def qmc_phases(torch, pc, cc, pfc, engine, smi, dev, prng: dict,
               reset_counts, read_counts) -> dict:
    """The QMC phases: ``qmc_noise``, ``qmc_price`` (1e7 x 365 on K2),
    ``qmc_price_cv`` (K2/cv), ``qmc_fgn`` (365 steps with the fGN planes
    in the Sobol set), ``qmc_price_long`` (1825 steps on K7) and
    ``qmc_price_xlong`` (4000 on K9), each cut to QMC_CUT_CHUNKS,
    ``qmc_chain`` (the strip on K5, 1e7 x 365) and ``qmc_fallback``.
    ``prng`` holds the PRNG runs they are held against: "price",
    "price_cv", "price_long", "price_xlong" as (price, stderr, paths,
    fits) and "strip" as (prices, stderrs, fits).  Returns each kernel's
    noise-in launches, by the wrapper's name."""
    t0 = time.perf_counter()
    qmc_noise_phase(torch, engine, smi, dev)
    out = {}
    for name, n, form, chunks, ref, ratio in (
            ("qmc_price", N_STEPS, {}, N_CHUNKS, "price", True),
            ("qmc_price_cv", N_STEPS, dict(control_variate=True),
             QMC_CUT_CHUNKS, "price_cv", True),
            ("qmc_fgn", N_STEPS, dict(qmc_fgn=True), QMC_CUT_CHUNKS,
             "price", True),
            ("qmc_price_long", LONG_STEPS, {}, QMC_CUT_CHUNKS, "price_long",
             False),
            ("qmc_price_xlong", XLONG_STEPS, {}, QMC_CUT_CHUNKS,
             "price_xlong", False)):
        kname, launches = qmc_price_phase(
            torch, pc, pfc, engine, smi, dev, name, n, form, chunks,
            prng[ref], reset_counts, read_counts, ratio)
        out.setdefault(FORM_WRAPPERS[kname], 0)
        out[FORM_WRAPPERS[kname]] += launches
    out["priced_chain"] = qmc_chain_phase(torch, pc, cc, engine, smi, dev,
                                          prng["strip"], reset_counts,
                                          read_counts)
    qmc_fallback_phase(engine, smi, dev)
    emit({"phase": "qmc", "card": smi, "noise_in_launches": out,
          "seconds": time.perf_counter() - t0})
    return out


def qmc_prediction_gen_phase(torch, smi, dev, reset_counts,
                             read_counts) -> None:
    """``qmc_prediction_gen``: ``run_pipeline`` with ``PricingConfig(qmc=
    True)`` (the CLI's ``--qmc``) on the card, on QMC_PG_ROWS of the
    ``prediction_gen`` phase's rows: one row of each bucket, the planted
    rows, then the earliest others.  No kernel lies on it (every launch
    count stays 0).  Checks the exit code, the header, the rows, the
    sentinels at the planted rows, finite prices elsewhere, every bucket
    run, and that a resume of the output cut after QMC_PG_RESUME_FROM
    rows writes the one-shot run's bytes."""
    import shutil
    import tempfile

    import numpy as np
    from montecarlooptionspricer_tpu_torch.config import (
        AUGMENTED_COLUMNS, MarketDefaults, PipelineConfig, PricingConfig)
    from montecarlooptionspricer_tpu_torch.pipeline import csv_io, driver
    from montecarlooptionspricer_tpu_torch.pipeline.watchdog import (
        current_memory_bytes)

    work = Path(tempfile.mkdtemp(prefix="mcop_qmc_prediction_gen_"))
    try:
        planted = pipeline_inputs(work, SEED)
        lines = (work / "options.csv").read_text().splitlines()
        body = lines[1:]
        first = {}
        for i, ln in enumerate(body):
            tokens = ln.split(",")
            if i not in planted and len(tokens) > 4:
                first.setdefault(float(tokens[4]), i)
        keep = set(planted) | {first[d] for d in PG_BUCKET_DTE}
        for i in range(len(body)):
            if len(keep) == QMC_PG_ROWS:
                break
            keep.add(i)
        keep = sorted(keep)
        sentinel_at = [j for j, i in enumerate(keep) if i in planted]
        (work / "options.csv").write_text("\n".join(
            [lines[0]] + [body[i] for i in keep]) + "\n")
        limit = PipelineConfig().max_memory_bytes
        peak_rss = current_memory_bytes()
        if peak_rss >= limit // 2:
            limit += peak_rss
        config = PipelineConfig(
            option_csv=str(work / "options.csv"),
            spot_csv=str(work / "spot.csv"),
            output_csv=str(work / "out.csv"),
            error_log=str(work / "error_log.txt"),
            diagnostic_csv=str(work / "diagnostic.csv"),
            max_memory_bytes=limit)
        pricing = PricingConfig(**PG_PRICING, qmc=True)
        market = MarketDefaults()
        timings = {}
        reset_counts()
        t0 = time.perf_counter()
        rc = driver.run_pipeline(config, pricing, market, device=dev,
                                 timings=timings)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        header, rows = csv_io.read_table(config.option_csv)
        out_header, out_rows = csv_io.read_table(config.output_csv)
        one_shot = (work / "out.csv").read_bytes()
        sentinels = [i for i, ln in enumerate(one_shot.decode().splitlines()
                                              [1:])
                     if ln.endswith(driver.SENTINEL)]
        prices = np.asarray([[float(v) for v in r[-6:-2]]
                             for i, r in enumerate(out_rows)
                             if i not in sentinel_at])
        buckets = {key: {"batches": len(secs),
                         "ms_per_batch": 1e3 * sum(secs) / len(secs)}
                   for key, secs in timings.get("buckets", {}).items()}
        cut = one_shot.splitlines(keepends=True)[:1 + QMC_PG_RESUME_FROM]
        (work / "out.csv").write_bytes(b"".join(cut))
        t0 = time.perf_counter()
        rc_resume = driver.run_pipeline(config, pricing, market, resume=True,
                                        device=dev)
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        resumed = (work / "out.csv").read_bytes()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    emit({"phase": "qmc_prediction_gen", "card": smi, "rows": len(keep),
          "rc": rc, "wall_s": wall, "rows_per_s": len(keep) / wall,
          "host_s": timings.get("host_s"), "device_s": timings.get("device_s"),
          "buckets": buckets, "sentinel_rows": sentinels,
          "resume_from": QMC_PG_RESUME_FROM, "resume_s": resume_s,
          "resume_byte_equal": resumed == one_shot,
          "kernel_launches": sum(launches.values())})
    check(rc == 0 and rc_resume == 0,
          f"qmc_prediction_gen: exit codes {rc}, {rc_resume}")
    check(launches == expected_counts(),
          f"qmc_prediction_gen launched kernels: {launches}")
    check(out_header == header + list(AUGMENTED_COLUMNS)
          and len(out_rows) == len(rows) == QMC_PG_ROWS,
          f"qmc_prediction_gen: {len(out_rows)} rows, header {out_header}")
    check(sentinels == sentinel_at,
          f"qmc_prediction_gen: sentinels at {sentinels}, planted at "
          f"{sentinel_at}")
    check(bool(np.isfinite(prices).all()),
          "qmc_prediction_gen: non-finite prices")
    check(len(buckets) >= len(PG_BUCKET_DTE),
          f"qmc_prediction_gen: buckets {sorted(buckets)}")
    check(resumed == one_shot, "qmc_prediction_gen: the resume's bytes "
          "differ from the one-shot run's")


# ---------------------------------------------------------------------------
# The serving CLI (``mcop-price-torch --serve``) and the jvp Greeks stream:
# plain PyTorch on the generic stream, which no kernel runs.

SERVE_REPLAY = 40          # mixed quotes, as the CPU test's 100-quote replay
SERVE_BENCH_CHUNKS = 8     # the bench strip's served chunks
JVP_CHUNKS = 16            # the jvp Greeks at 365 steps
JVP_LONG_CHUNKS = 8        # and at 1825, past the tile


def serve_requests() -> list:
    """The serve phase's JSON lines: SERVE_REPLAY quotes over step buckets
    8 and 32 and strip buckets 2 and 4 (2 and 3 strikes), fresh strips,
    markets, H and seeds, one or two chunks, Greeks every 5th quote, two
    malformed lines, and last the bench strip (21 strikes, 365 steps in
    bucket 512, SERVE_BENCH_CHUNKS chunks), quoted twice."""
    reqs = []
    for i in range(SERVE_REPLAY):
        k = [2, 3][i % 2]
        steps = [8, 24][(i // 2) % 2]
        reqs.append(json.dumps({
            "id": i, "strikes": [94.0 + 4 * j + (i % 9) * 0.5
                                 for j in range(k)],
            "put": True, "steps": steps, "maturity": steps / 252.0,
            "paths": CHUNK * (1 + i % 2), "hurst": 0.1 + 0.02 * (i % 8),
            "s0": 100.0 + 0.2 * (i % 7), "xi": 0.04 + 0.002 * (i % 4),
            "seed": i, "greeks": i % 5 == 4}))
    reqs.insert(13, "{broken json")
    reqs.insert(27, json.dumps({"id": "bad", "strike": 100.0,
                                "maturity": 0.1, "hurst": 2.0}))
    bench = {"strikes": list(STRIP), "put": not IS_CALL, "steps": N_STEPS,
             "maturity": MATURITY, "paths": CHUNK * SERVE_BENCH_CHUNKS,
             "seed": SEED, "hurst": MARKET["h"], "s0": MARKET["s0"],
             "xi": MARKET["xi"], "eta": MARKET["eta"], "r": MARKET["r"]}
    reqs += [json.dumps({"id": "bench", **bench}),
             json.dumps({"id": "bench_warm", **bench})]
    return reqs


def bucket_law_strip(torch, engine, smi, dev, reset_counts,
                     read_counts) -> tuple:
    """The bench strip under the law a server prices it in: 365 live steps
    of the 512-step bucket's spectral synthesis, whose first 365 fGN
    entries have another covariance than the 365-step synthesis's (the
    reference's map is no circulant embedding).  K1 and K5 in the chol
    form on the Cholesky factor of that covariance's leading 365 x 365
    block (the same Gaussian law), N_CHUNKS chunks: (prices, stderrs) of
    the ``serve_reference`` phase, beside the variance ratio of the two
    laws' fGN entries."""
    import dataclasses

    import numpy as np

    bucket = 1 << (N_STEPS - 1).bit_length()
    cr, ci = engine._fgn_matrices_np(bucket, MARKET["h"], MARKET["eta"], DT)
    cov = (cr.T @ cr + ci.T @ ci)[:N_STEPS, :N_STEPS]
    cr0, ci0 = engine._fgn_matrices_np(N_STEPS, MARKET["h"], MARKET["eta"],
                                       DT)
    var_ratio = float(cov[0, 0] / (cr0.T @ cr0 + ci0.T @ ci0)[0, 0])
    lt = np.ascontiguousarray(np.linalg.cholesky(cov).T)
    cfg = engine.StreamConfig(n_paths=CHUNK * N_CHUNKS, n_steps=N_STEPS,
                              chunk_paths=CHUNK, pilot_paths=PILOT, dt=DT,
                              chunks_per_call=N_CHUNKS)
    chain = engine.StreamingChainPricer(**MARKET, strikes=STRIP,
                                        maturity=MATURITY, is_call=IS_CALL,
                                        config=cfg, device=dev)
    chain.consts = chain.chain_consts = dataclasses.replace(
        chain.consts, lt_half=(0.5 * torch.tensor(lt, dtype=torch.float32)
                               ).to(dev).contiguous())
    reset_counts()
    out, wall = timed(torch, lambda: chain.price(SEED, with_stderr=True))
    launches = read_counts()
    i_k = STRIP.index(STRIKE)
    emit({"phase": "serve_reference", "card": smi, "bucket": bucket,
          "n_steps": N_STEPS, "fgn_var_ratio_bucket_to_exact": var_ratio,
          "prices": out[0].tolist(), "stderrs": out[1].tolist(),
          "price_at_strike": float(out[0][i_k]),
          "stderr_at_strike": float(out[1][i_k]), "wall_s": wall,
          "nonzero_launches": {k: v for k, v in launches.items() if v}})
    check(launches == expected_counts(pathgen=1, priced_chain=N_CHUNKS),
          f"serve_reference launches {launches}")
    return out


def serve_phase(torch, smi, dev, strip: tuple, bucket_strip: tuple,
                reset_counts, read_counts) -> None:
    """The ``serve`` phase: ``serve_requests()`` through the in-process
    server of ``mcop-price-torch --serve`` on the card (chunk CHUNK, the
    JAX server's default pilot of 65,536), launch counts 0 before it and
    read after.  Checks 9 compiled answers (5 classes, 4 first Greeks
    quotes), 2 errors, 8 Greeks answers, no kernel launched, every
    pricer's tensors on the card, and the bench strip's strike 105 within
    5 combined stderr of ``bucket_strip`` = (prices, stderrs), K1 + K5
    under the bucket's law (``bucket_law_strip``); its distance from
    ``chain_price``'s ``strip`` (K1 + K5 under the 365-step law) is
    printed beside.  Prints the answers' seconds by class, the first (the
    build) apart from the warm ones."""
    import collections
    import contextlib
    import io
    import statistics

    from montecarlooptionspricer_tpu_torch.cli import price as price_cli
    from montecarlooptionspricer_tpu_torch.config import MarketDefaults

    args = price_cli.build_parser().parse_args(
        ["--serve", "--device", str(dev), "--chunk-paths", str(CHUNK)])
    reqs = serve_requests()
    pricers = collections.OrderedDict()
    out = io.StringIO()
    old_stdin = sys.stdin
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    try:
        sys.stdin = io.StringIO("\n".join(reqs) + "\n")
        with contextlib.redirect_stdout(out):
            rc = price_cli.serve(args, MarketDefaults(), pricers)
    finally:
        sys.stdin = old_stdin
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    rows = [json.loads(line) for line in out.getvalue().splitlines()]
    errors = [r for r in rows if "error" in r]
    ok = [r for r in rows if "error" not in r]
    by_class = collections.defaultdict(lambda: {"first_s": None,
                                                "warm_s": []})
    for r in ok:
        k_b = 1 << max(0, (len(r["strikes"]) - 1).bit_length())
        b = max(8, 1 << max(0, (r["n_steps"] - 1).bit_length()))
        cls = by_class[f"{b}x{k_b}{'/greeks' if 'delta' in r else ''}"]
        if r["compiled"]:
            cls["first_s"] = r["elapsed_s"]
        else:
            cls["warm_s"].append(r["elapsed_s"])
    latency = {k: {"first_s": v["first_s"], "n_warm": len(v["warm_s"]),
                   "warm_median_s": (statistics.median(v["warm_s"])
                                     if v["warm_s"] else None),
                   "warm_max_s": max(v["warm_s"], default=None)}
               for k, v in sorted(by_class.items())}
    bench = {r["id"]: r for r in ok if r["id"] in ("bench", "bench_warm")}
    i_k = STRIP.index(STRIKE)
    p_k = bench["bench"]["prices"][i_k]
    se_k = bench["bench"]["stderrs"][i_k]
    sigmas = abs(p_k - float(bucket_strip[0][i_k])) / math.hypot(
        se_k, float(bucket_strip[1][i_k]))
    sigmas_exact = abs(p_k - float(strip[0][i_k])) / math.hypot(
        se_k, float(strip[1][i_k]))
    on_card = all(
        t.device.type == "cuda"
        for entry in pricers.values()
        for t in (entry[0].strikes, entry[0].stream_consts.cr,
                  entry[0].stream_consts.ci, entry[0].stream_consts.t_pow))
    compiled = sum(bool(r.get("compiled")) for r in ok)
    n_greeks = sum("delta" in r for r in ok)
    emit({"phase": "serve", "card": smi, "requests": len(reqs),
          "answers": len(rows), "errors": len(errors),
          "compiled": compiled, "greeks_answers": n_greeks,
          "classes": len(pricers), "wall_s": wall,
          "latency_by_class": latency,
          "bench_strip": {"n_paths": bench["bench"]["n_paths"],
                          "n_steps": N_STEPS, "price_at_strike": p_k,
                          "stderr_at_strike": se_k,
                          "elapsed_s": bench["bench"]["elapsed_s"],
                          "warm_elapsed_s":
                              bench["bench_warm"]["elapsed_s"]},
          "bucket_law_at_strike": [float(bucket_strip[0][i_k]),
                                   float(bucket_strip[1][i_k])],
          "combined_stderrs_apart": sigmas, "limit": STDERR_SIGMAS,
          "chain_price_at_strike": [float(strip[0][i_k]),
                                    float(strip[1][i_k])],
          "combined_stderrs_from_chain_price": sigmas_exact,
          "peak_device_bytes": torch.cuda.max_memory_allocated(),
          "tensors_on_card": on_card,
          "nonzero_launches": {k: v for k, v in launches.items() if v}})
    check(rc == 0 and len(rows) == len(reqs), "serve lost answers")
    check(len(errors) == 2, f"serve answered {len(errors)} errors, want 2")
    check(compiled == 9, f"serve built {compiled} times, want 9")
    check(n_greeks == SERVE_REPLAY // 5, "serve Greeks answers")
    check(launches == expected_counts(), f"serve launched kernels: "
          f"{launches}")
    check(on_card, "a served pricer holds tensors off the card")
    check(all(math.isfinite(v) for r in ok for v in r["prices"]),
          "non-finite served prices")
    check(sigmas <= STDERR_SIGMAS, "the served strip's strike 105 is "
          f"{sigmas:.2f} combined stderrs from K1 + K5 under its bucket's "
          "law")


def greeks_jvp_phase(torch, engine, smi, dev, greeks: tuple,
                     price_long: tuple, reset_counts, read_counts) -> None:
    """The ``greeks_jvp`` phase: the jvp Greeks stream of the bench option
    at 365 steps (``pathgen_impl="xla"``, JVP_CHUNKS chunks), each Greek
    within 5 combined stderr of K3's ``greeks`` = (greeks, stderrs) and
    the price lane within 1e-5 of ``price_with_fit`` on the same fits,
    timed beside it; then
    at 1825 steps past the tile (the tiled family's configuration, whose
    Greeks K3 does not reach; JVP_LONG_CHUNKS chunks), its price lane
    within 5 combined stderr of ``price_long`` = (price, stderr) (K6/K7),
    with the peak device bytes.  No kernel launches in either."""
    import numpy as np

    k_pilot = engine._pilot_stream_keys(SEED)[0]
    runs = {}
    for name, n, chunks, impl in (("bench", N_STEPS, JVP_CHUNKS, "xla"),
                                  ("long", LONG_STEPS, JVP_LONG_CHUNKS,
                                   "pallas")):
        cfg = engine.StreamConfig(n_paths=CHUNK * chunks, n_steps=n,
                                  chunk_paths=CHUNK, pilot_paths=PILOT,
                                  dt=DT, chunks_per_call=chunks,
                                  pathgen_impl=impl)
        pricer = engine.StreamingPricer(**MARKET, strike=STRIKE,
                                        maturity=n * DT, is_call=IS_CALL,
                                        config=cfg, device=dev)
        check(not pricer._kernel_greeks(), f"{name}: K3 took the Greeks")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_counts()
        fits, fit_s = timed(torch, lambda: pricer.greeks_fit(k_pilot))
        (g, se), stream_s = timed(torch, lambda: pricer.greeks_with_fit(
            fits, SEED, with_stderr=True))
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated()
        runs[name] = dict(n_steps=n, n_paths=CHUNK * chunks,
                          family=pricer.kernel_family,
                          greeks=dict(zip(engine.GREEK_ORDER, g)),
                          stderrs=dict(zip(engine.GREEK_ORDER, se)),
                          fit_s=fit_s, stream_s=stream_s,
                          stream_s_per_chunk=stream_s / chunks,
                          peak_device_bytes=peak,
                          peak_above_start_bytes=peak - base,
                          nonzero_launches={k: v for k, v in
                                            launches.items() if v})
        if pricer.kernel_family == "stream":
            # The same pilot, fits and chunks as price(): the price lane
            # is price_with_fit's, and the price stream's time beside.
            price, p_stream_s = timed(torch, lambda: pricer.price_with_fit(
                fits, SEED))
            runs[name].update(price_stream_s=p_stream_s,
                              price_same_fits=price)
            check(abs(g[0] / price - 1.0) <= 1e-5, f"greeks_jvp {name}: "
                  "the price lane differs from price_with_fit")
        check(launches == expected_counts(),
              f"greeks_jvp {name} launched kernels: {launches}")
        check(all(math.isfinite(v) for v in (*g, *se)),
              f"greeks_jvp {name}: non-finite Greeks")
    g, se = np.array(list(runs["bench"]["greeks"].values())), np.array(
        list(runs["bench"]["stderrs"].values()))
    k3, k3_se = np.array(greeks[0]), np.array(greeks[1])
    sig = np.abs(g - k3) / np.hypot(se, k3_se)
    lg = runs["long"]
    sig_long = abs(lg["greeks"]["price"] - price_long[0]) / math.hypot(
        lg["stderrs"]["price"], price_long[1])
    emit({"phase": "greeks_jvp", "card": smi, "runs": runs,
          "k3_greeks": dict(zip(engine.GREEK_ORDER, k3.tolist())),
          "combined_stderrs_apart_k3": dict(zip(engine.GREEK_ORDER,
                                                sig.tolist())),
          "price_long": list(price_long),
          "long_price_combined_stderrs_apart": sig_long,
          "limit": STDERR_SIGMAS})
    check(bool(np.all(sig <= STDERR_SIGMAS)),
          f"jvp Greeks at {N_STEPS} steps vs K3: {sig.tolist()} stderrs")
    check(sig_long <= STDERR_SIGMAS, "the jvp price lane at "
          f"{LONG_STEPS} steps is {sig_long:.2f} stderrs from price_long")


def serve_jvp_main(root: Path) -> int:
    """``python3 chip_smoke.py --serve-jvp [ROOT]``: the ``serve`` and
    ``greeks_jvp`` phases alone with the package of the checkout at ROOT
    (default: this script's), after the kernel runs they are held against
    (the strip through K1 + K5, the Greeks through K3, 1e7 x 1825 through
    K6/K7; 76 chunks each)."""
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(root.resolve()))
    _START[0] = time.perf_counter()
    from montecarlooptionspricer_tpu_torch.kernels import build
    from montecarlooptionspricer_tpu_torch.models import engine

    torch.backends.cuda.matmul.allow_tf32 = False
    dev, smi = torch.device("cuda", 0), _card()
    reset_counts, read_counts = launch_counters()
    _, nvcc_s, _ = build.build()
    build.load()
    emit({"phase": "build", "nvcc_wall_s": round(nvcc_s, 3)})
    k_pilot = engine._pilot_stream_keys(SEED)[0]
    cfg = engine.StreamConfig(n_paths=CHUNK * N_CHUNKS, n_steps=N_STEPS,
                              chunk_paths=CHUNK, pilot_paths=PILOT, dt=DT,
                              chunks_per_call=N_CHUNKS)
    chain = engine.StreamingChainPricer(**MARKET, strikes=STRIP,
                                        maturity=MATURITY, is_call=IS_CALL,
                                        config=cfg, device=dev)
    strip = chain.price_with_fit(chain.fit(k_pilot), SEED, with_stderr=True)
    pricer = engine.StreamingPricer(**MARKET, strike=STRIKE,
                                    maturity=MATURITY, is_call=IS_CALL,
                                    config=cfg, device=dev)
    greeks = pricer.price_and_greeks(SEED, with_stderr=True)
    long_cfg = engine.StreamConfig(n_paths=CHUNK * LONG_CHUNKS,
                                   n_steps=LONG_STEPS, chunk_paths=CHUNK,
                                   pilot_paths=PILOT, dt=DT,
                                   chunks_per_call=LONG_CHUNKS)
    long_p = engine.StreamingPricer(**MARKET, strike=STRIKE,
                                    maturity=LONG_MATURITY, is_call=IS_CALL,
                                    config=long_cfg, device=dev)
    price_long = long_p.price(SEED, with_stderr=True)
    emit({"phase": "serve_jvp_references", "strip_at_strike": [
        float(strip[0][STRIP.index(STRIKE)]),
        float(strip[1][STRIP.index(STRIKE)])], "greeks": list(greeks[0]),
        "greeks_stderrs": list(greeks[1]), "price_long": list(price_long)})
    bucket_strip = bucket_law_strip(torch, engine, smi, dev,
                                    reset_counts, read_counts)
    serve_phase(torch, smi, dev, strip, bucket_strip, reset_counts,
                read_counts)
    greeks_jvp_phase(torch, engine, smi, dev, greeks, price_long,
                     reset_counts, read_counts)
    print(smi, flush=True)
    return 0


# ---------------------------------------------------------------------------
# The Bayesian meta-model: ``mcop-train-nn-torch`` and
# ``mcop-evaluate-nn-torch`` at the model's full width, plain PyTorch on the
# card, which no kernel runs.

NN_ROWS = {"train": 65_536, "valid": 8_192, "test": 8_192}
NN_EPOCHS = 7              # crosses the 5 warm-up epochs
# Steps of the epoch's step loop profiled for the device's busy share (the
# whole epoch's 256 under the profiler took 6.6 s on a slow host).
NN_PROFILE_STEPS = 64
NN_BATCH, NN_LR, NN_MC = 256, 3e-4, 100
NN_EVAL_BATCH = 512
NN_RESUME_ROWS = 4_096
NN_INTERVAL_DRAWS = 2_000
NN_FWD_RTOL, NN_FWD_ATOL = 1e-4, 1e-5
NN_GRAD_TOL, NN_UPDATE_ATOL = 1e-4, 1e-6
NN_PEAK_GROWTH = 10.0
# In the full script; ``--nn`` alone also pays the process's first
# dispatch mode (``cuda_ops``, ~9 s), which an earlier phase pays there.
NN_PHASE_LIMIT_S = 30.0


def nn_inputs(work: Path, seed: int) -> dict:
    """Feature CSVs in the INPUT_COLUMNS + ``last`` schema, from a numpy
    seed: Black-Scholes calls on lognormal spots, 7-730 days, the four
    estimators' columns within 5 % of the price, the traded price within
    3 %.  Returns {split: (path, features, targets)}, the arrays as
    float32."""
    import numpy as np
    from montecarlooptionspricer_tpu_torch.config import (
        INPUT_COLUMNS, TARGET_COLUMN)

    rng = np.random.default_rng(seed)
    ncdf = np.frompyfunc(lambda v: 0.5 * (1.0 + math.erf(v / math.sqrt(2))),
                         1, 1)
    paths = {}
    for split, n in NN_ROWS.items():
        s = 100.0 * np.exp(0.3 * rng.standard_normal(n))
        dte = rng.integers(7, 731, n).astype(np.float64)
        dist = 15.0 * rng.standard_normal(n)
        iv = rng.uniform(0.15, 0.6, n)
        k, t, r, q = s * (1.0 + dist / 100.0), dte / 365.0, 0.04, 0.01
        sd = iv * np.sqrt(t)
        d1 = (np.log(s / k) + (r - q + 0.5 * iv ** 2) * t) / sd
        n1 = ncdf(d1).astype(np.float64)
        n2 = ncdf(d1 - sd).astype(np.float64)
        pdf = np.exp(-0.5 * d1 ** 2) / math.sqrt(2.0 * math.pi)
        price = s * np.exp(-q * t) * n1 - k * np.exp(-r * t) * n2
        cols = [s, dte, dist, n1, pdf / (s * sd), s * pdf * np.sqrt(t) / 100,
                -s * pdf * iv / (2.0 * np.sqrt(t)) / 365.0,
                k * t * np.exp(-r * t) * n2 / 100.0, iv,
                np.exp(rng.normal(6.0, 1.5, n)), np.full(n, q)]
        cols += [price * (1.0 + 0.05 * rng.standard_normal(n))
                 for _ in range(4)]
        cols += [iv * (1.0 + 0.1 * rng.standard_normal(n)),
                 0.05 * rng.standard_normal(n),
                 np.maximum(price * (1.0 + 0.03 * rng.standard_normal(n)),
                            0.01)]
        path = work / f"{split}.csv"
        table = np.stack(cols, axis=1)
        np.savetxt(path, table, fmt="%.6g", delimiter=",",
                   header=",".join(INPUT_COLUMNS + (TARGET_COLUMN,)),
                   comments="")
        table = table.astype(np.float32)
        paths[split] = (path, table[:, :-1].copy(), table[:, -1].copy())
    return paths


def nn_interval_sigmas(card_draws, host_draws, stds: float) -> dict:
    """Combined stderrs between the card's and the host's MC-dropout
    mean and interval ends (mean +- stds * sd), each end's stderr from the
    draws' variance and fourth moment."""
    import numpy as np

    def stats(v):
        v = np.asarray(v, np.float64)
        n, m, s = v.size, v.mean(), v.std()
        m4 = np.mean((v - m) ** 4)
        se_m = s / math.sqrt(n)
        se_s = math.sqrt(max(m4 - s ** 4, 0.0) / n) / (2.0 * s)
        return m, s, se_m, math.hypot(se_m, stds * se_s)

    mc, sc, se_mc, se_ec = stats(card_draws)
    mh, sh, se_mh, se_eh = stats(host_draws)
    return {"mean": abs(mc - mh) / math.hypot(se_mc, se_mh),
            "lower": abs((mc - stds * sc) - (mh - stds * sh))
            / math.hypot(se_ec, se_eh),
            "upper": abs((mc + stds * sc) - (mh + stds * sh))
            / math.hypot(se_ec, se_eh),
            "card": [mc, sc], "host": [mh, sh]}


def nn_phase(torch, smi, dev, reset_counts, read_counts,
             limit_s=NN_PHASE_LIMIT_S) -> None:
    """``nn``: the Bayesian meta-model at its full width (17 inputs, the
    fixed 512-256-128-64-32-16 funnel; the batch attention's output is dead,
    so no forward computes it) on the card. ``train_nn.main`` trains
    NN_EPOCHS epochs on 65,536 rows of synthetic features (batch 256, lr
    3e-4, 100 MC draws), then ``evaluate_nn.main`` evaluates 8,192 rows at
    100 draws a row in batches of 512, plainly and with
    ``--calibrated-intervals``. Checks: (a) the trained model's eval forward
    on the card within 1e-5 abs / 1e-4 rel of the host's, and its peak bytes
    linear in the rows (8,192 against 65,536: at most NN_PEAK_GROWTH times,
    8 if linear, 64 if quadratic); (b) one masked batch's loss and gradients
    in both loss phases within 1e-4 of each gradient's max-abs of the
    host's, and the optimizer's update on the host's gradients within 1e-6;
    (c) a batch with a NaN row leaves the parameters and Adam's count and
    stays out of the epoch's loss; (d) one epoch's step loop under
    ``torch.cuda.set_sync_debug_mode("error")``; (e) 2 epochs against 1 +
    resume + 1 on 4,096 rows; (f) the card's and the host's MC-dropout mean
    and interval ends for test row 0 at 2,000 draws within 5 combined
    stderr; (g) the results CSVs' 8,192 rows, lower <= mean <= upper, the
    calibrated coverage at least the plain one; (h) no kernel launched; the
    phase within ``limit_s`` when one is given. Prints s an epoch, ms and
    CUDA operators a step, rows/s, ms an MC batch, peak device bytes and the
    device's busy share over NN_PROFILE_STEPS steps of an epoch
    (torch.profiler)."""
    import logging
    import shutil
    import tempfile

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from montecarlooptionspricer_tpu_torch.cli import evaluate_nn, train_nn
    from montecarlooptionspricer_tpu_torch.config import (
        INPUT_COLUMNS, TrainConfig)
    from montecarlooptionspricer_tpu_torch.nn.trainer import BayesianTrainer

    t_phase = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="mcop_nn_"))
    epochs = []

    class EpochSeconds(logging.Handler):
        def emit(self, record):
            if record.msg.startswith("Epoch "):
                epochs.append(float(record.args[3]))

    epoch_log = logging.getLogger("montecarlooptionspricer_tpu_torch.nn."
                                  "trainer")
    handler = EpochSeconds()
    epoch_log.addHandler(handler)
    split_s = {}
    try:
        t0 = time.perf_counter()
        data = nn_inputs(work, SEED)
        csv = {k: v[0] for k, v in data.items()}
        split_s["csv"] = time.perf_counter() - t0
        model, ckpt = str(work / "model"), str(work / "checkpoint")
        reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rc, train_s = timed(torch, lambda: train_nn.main([
            "--train-csv", str(csv["train"]), "--valid-csv",
            str(csv["valid"]), "--test-csv", str(csv["test"]),
            "--model-file", model, "--checkpoint-file", ckpt,
            "--num-epochs", str(NN_EPOCHS), "--batch-size", str(NN_BATCH),
            "--learning-rate", str(NN_LR), "--mc-samples", str(NN_MC),
            "--device", "cuda"]))
        epoch_log.removeHandler(handler)
        check(rc == 0, f"nn: train_nn exit code {rc}")
        check(len(epochs) == NN_EPOCHS, f"nn: {len(epochs)} epochs logged")
        results, eval_s = {}, {}
        for name, extra in (("plain", []),
                            ("calibrated", ["--calibrated-intervals"])):
            results[name] = str(work / f"results_{name}.csv")
            rc, eval_s[name] = timed(torch, lambda: evaluate_nn.main([
                "--test-csv", str(csv["test"]), "--model-file", model,
                "--results-csv", results[name], "--n-samples", str(NN_MC),
                "--batch-size", str(NN_EVAL_BATCH), "--device", "cuda"]
                + extra))
            check(rc == 0, f"nn: evaluate_nn {name} exit code {rc}")
        peak = torch.cuda.max_memory_allocated()

        t0 = time.perf_counter()
        _, x_tr, y_tr = data["train"]
        _, x_te, _ = data["test"]
        card = BayesianTrainer(len(INPUT_COLUMNS), 64, device=dev)
        host = BayesianTrainer(len(INPUT_COLUMNS), 64, device="cpu")
        for t in (card, host):
            t.load_model(model)

        # (a) the eval forward, card against host.
        got = card.forward(x_te[:NN_EVAL_BATCH]).cpu()
        want = host.forward(x_te[:NN_EVAL_BATCH])
        fwd_abs = float((got - want).abs().max())
        fwd_ok = bool(((got - want).abs()
                       <= NN_FWD_ATOL + NN_FWD_RTOL * want.abs()).all())
        # Its peak bytes above what was allocated before it, at the test
        # set's rows and at the training set's.
        fwd_peak = {}
        for rows in (NN_ROWS["test"], NN_ROWS["train"]):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            check(card.forward(x_tr[:rows]).shape == (rows, 15),
                  f"nn (a): eval forward shape at {rows} rows")
            torch.cuda.synchronize()
            fwd_peak[rows] = torch.cuda.max_memory_allocated() - base

        # (f) MC-dropout intervals of test row 0, card against host.
        sig = nn_interval_sigmas(
            card.predict_mc(x_te[:1], NN_INTERVAL_DRAWS)[:, 0].cpu().numpy(),
            host.predict_mc(x_te[:1], NN_INTERVAL_DRAWS)[:, 0].numpy(), 3.0)
        mc_ms = time_ms(torch, lambda: card.predict_mc(
            x_te[:NN_EVAL_BATCH], NN_MC), reps=5)

        # (b) one masked batch in both phases; the update on equal grads.
        gen = torch.Generator().manual_seed(SEED)
        x, y = torch.from_numpy(x_tr[:NN_BATCH]), torch.from_numpy(
            y_tr[:NN_BATCH]).reshape(-1, 1)
        w = torch.ones(NN_BATCH)
        masks = host.model.draw_masks((NN_BATCH,), gen, "cpu")
        grad_err, loss_rel = {}, {}
        for phase, warmup in (("warmup", True), ("mdn", False)):
            lh, gh = host.loss_and_grads(x, y, w, warmup=warmup, masks=masks)
            lc, gc_ = card.loss_and_grads(x.to(dev), y.to(dev), w.to(dev),
                                          warmup=warmup,
                                          masks=[m.to(dev) for m in masks])
            loss_rel[phase] = abs(float(lc) / float(lh) - 1.0)
            grad_err[phase] = max(
                float((c.cpu() - h).abs().max())
                / max(float(h.abs().max()), 1e-30)
                for c, h in zip(gc_, gh))
        for t in (card, host):
            t._make_optimizer(NN_LR)
        card.optimizer.step([g.to(dev) for g in gh])
        host.optimizer.step(gh)
        update_abs = float((card.optimizer._update.cpu()
                            - host.optimizer._update).abs().max())

        # (c) a NaN row: no update, count kept, out of the epoch's loss.
        xb, yb, wb = card.batched(x_tr[:2 * NN_BATCH], y_tr[:2 * NN_BATCH],
                                  NN_BATCH)
        xb[1, 7, 3] = float("nan")
        params = {k: v.clone() for k, v in card.model.state_dict().items()}
        opt_state = card.optimizer.state_dict()
        gen_state = card.generator.get_state()
        count = int(card.optimizer.count)
        epoch_loss = float(card.run_epoch(xb, yb, wb, warmup=False))
        card.model.load_state_dict(params)
        card.optimizer.load_state_dict(opt_state)
        card.generator.set_state(gen_state)
        good, _ = card._step(xb[0], yb[0], wb[0], False)
        after = {k: v.clone() for k, v in card.model.state_dict().items()}
        skipped, finite = card._step(xb[1], yb[1], wb[1], False)
        nan_ok = (not bool(finite) and float(skipped) == 0.0
                  and int(card.optimizer.count) == count + 1
                  and int(card.optimizer.total_notfinite) == 1
                  and all(torch.equal(v, after[k]) for k, v in
                          card.model.state_dict().items())
                  and epoch_loss == float(good))

        split_s["checks_a_b_c_f"] = time.perf_counter() - t0

        # (d) one epoch's step loop with no host sync; its time, operators
        # a step (the process's first dispatch mode costs seconds, paid by
        # an earlier phase in the full run) and the device's busy share
        # under the profiler, CUDA activity only.
        xb, yb, wb = card.batched(x_tr, y_tr, NN_BATCH)
        steps = xb.shape[0]
        torch.cuda.set_sync_debug_mode("error")
        try:
            loss, epoch_s = timed(torch, lambda: card.run_epoch(
                xb, yb, wb, warmup=False))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        check(math.isfinite(float(loss)), "nn: non-finite epoch loss")
        ops, split_s["cuda_ops"] = timed(torch, lambda: cuda_ops(
            torch, lambda: card._step(xb[0], yb[0], wb[0], False)))
        t0 = time.perf_counter()
        window = slice(0, NN_PROFILE_STEPS)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _, epoch_prof_s = timed(torch, lambda: card.run_epoch(
                xb[window], yb[window], wb[window], warmup=False))
        kernels = [e for e in prof.profiler.kineto_results.events()
                   if e.device_type() == torch.autograd.DeviceType.CUDA]
        busy_s = sum(e.duration_ns() for e in kernels) * 1e-9
        split_s["profile"] = time.perf_counter() - t0

        # (e) 2 epochs against 1 + resume + 1, crossing the warm-up.
        t0 = time.perf_counter()
        cfg = TrainConfig(warmup_epochs=1, batch_size=NN_BATCH)
        xr, yr = x_tr[:NN_RESUME_ROWS], y_tr[:NN_RESUME_ROWS]
        one = BayesianTrainer(17, 64, config=cfg, device=dev)
        one.train_model(xr, yr, num_epochs=2,
                        checkpoint_path=str(work / "one"))
        BayesianTrainer(17, 64, config=cfg, device=dev).train_model(
            xr, yr, num_epochs=1, checkpoint_path=str(work / "two"))
        two = BayesianTrainer(17, 64, config=cfg, device=dev)
        two.train_model(xr, yr, num_epochs=2,
                        checkpoint_path=str(work / "two"))
        resume_diff = max(float((a - b).abs().max()) for a, b in zip(
            one.model.state_dict().values(),
            two.model.state_dict().values()))
        split_s["resume_e"] = time.perf_counter() - t0
        launches = read_counts()

        # (g) the results CSVs.
        res = {name: np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2)
               for name, path in results.items()}
        coverage = {name: float(r[:, 6].mean()) for name, r in res.items()}
        ordered = all(bool(((r[:, 3] <= r[:, 2]) & (r[:, 2] <= r[:, 4]))
                           .all()) for r in res.values())
        mae = {name: float(r[:, 5].mean()) for name, r in res.items()}
    finally:
        epoch_log.removeHandler(handler)
        shutil.rmtree(work, ignore_errors=True)
    phase_s = time.perf_counter() - t_phase
    train_rows = NN_ROWS["train"]
    emit({"phase": "nn", "card": smi, "rows": NN_ROWS,
          "epochs": NN_EPOCHS, "batch": NN_BATCH, "mc_draws": NN_MC,
          "split_s": split_s, "train_cli_s": train_s,
          "epoch_s": epochs, "first_epoch_s": epochs[0],
          "later_epoch_s_mean": sum(epochs[1:]) / len(epochs[1:]),
          "train_rows_per_s": train_rows * NN_EPOCHS / sum(epochs),
          "step_loop_epoch_s": epoch_s, "steps_per_epoch": steps,
          "ms_per_step": 1e3 * epoch_s / steps,
          "step_rows_per_s": train_rows / epoch_s,
          "cuda_ops_per_step": ops,
          "profiled_steps": NN_PROFILE_STEPS,
          "profiled_window_s": epoch_prof_s, "device_busy_s": busy_s,
          "device_launches_profiled": len(kernels),
          "busy_share": busy_s / (epoch_s * NN_PROFILE_STEPS / steps),
          "busy_share_profiled": busy_s / epoch_prof_s,
          "eval_cli_s": eval_s,
          "eval_rows_per_s": {k: NN_ROWS["test"] / v
                              for k, v in eval_s.items()},
          "mc_batch_ms": mc_ms, "mc_batch_rows": NN_EVAL_BATCH,
          "peak_device_bytes": peak, "eval_forward_peak_bytes": fwd_peak,
          "fwd_max_abs_err": fwd_abs, "loss_rel_err": loss_rel,
          "grad_err_of_max_abs": grad_err, "update_max_abs_err": update_abs,
          "nan_batch_skipped": nan_ok, "resume_max_abs_diff": resume_diff,
          "interval_sigmas": sig, "coverage": coverage, "mae": mae,
          "kernel_launches": sum(launches.values()), "phase_s": phase_s,
          "phase_limit_s": NN_PHASE_LIMIT_S})
    check(fwd_ok, f"nn (a): card forward {fwd_abs} from the host's")
    small, big = (fwd_peak[NN_ROWS[k]] for k in ("test", "train"))
    check(big <= NN_PEAK_GROWTH * small,
          f"nn (a): eval forward peak {small} -> {big} bytes for 8x rows")
    check(max(loss_rel.values()) <= 1e-5
          and max(grad_err.values()) <= NN_GRAD_TOL,
          f"nn (b): loss {loss_rel}, gradients {grad_err}")
    check(update_abs <= NN_UPDATE_ATOL, f"nn (b): update {update_abs}")
    check(nan_ok, "nn (c): the NaN batch was not skipped cleanly")
    if resume_diff:
        print("nn (e): the resumed parameters differ by "
              f"{resume_diff:.3g}: float32 reductions on the card need not "
              "repeat their bits", file=sys.stderr)
    check(resume_diff <= 1e-6, f"nn (e): resume differs by {resume_diff}")
    check(max(sig["mean"], sig["lower"], sig["upper"]) <= STDERR_SIGMAS,
          f"nn (f): intervals {sig}")
    check(all(r.shape == (NN_ROWS["test"], 7) for r in res.values())
          and ordered, "nn (g): results CSV rows or interval order")
    check(coverage["calibrated"] >= coverage["plain"],
          f"nn (g): coverage {coverage}")
    check(launches == expected_counts(),
          f"nn (h): kernels launched: {launches}")
    if limit_s is not None:
        check(phase_s <= limit_s, f"nn: the phase took {phase_s:.1f} s")


# The mesh phase (``mesh``): the multi-device forms over NCCL at a world of
# one (the machine has one card), at the bench configuration cut to
# MESH_CHUNKS chunks; the pipeline on MESH_PG_ROWS short-dated rows; one
# trainer epoch on MESH_NN_ROWS rows.
MESH_CHUNKS = 8
MESH_STDERRS = 4.0
MESH_PG_ROWS = 64
MESH_PG_MAX_DTE = 150.0
MESH_NN_ROWS, MESH_NN_BATCH = 4096, 256
MESH_PHASE_LIMIT_S = 30.0


def _is_number(tokens: list) -> bool:
    """Whether ``tokens`` holds one token that parses as a float."""
    try:
        return len(tokens) == 1 and math.isfinite(float(tokens[0]))
    except ValueError:
        return False


def mesh_phase(torch, smi, dev, reset_counts, read_counts,
               limit_s=MESH_PHASE_LIMIT_S) -> None:
    """``mesh``: the port's multi-device forms on the card, over NCCL at a
    world of one (no second card here, so no multi-GPU figure).  (a)
    ``make_mesh(2, "cuda")`` raises ValueError and ``make_mesh(1, "cuda")``
    gives an NCCL group on a file store; (b) ``StreamingPricer(mesh=)`` at
    the bench configuration on MESH_CHUNKS chunks launches K1 once and K2
    MESH_CHUNKS times, K2's chunk total on the rank-offset key is its plain
    version's (SUM_RTOL), the fit through the group is the fit without one
    on the same pilot to the bit, and the price lies within MESH_STDERRS
    combined stderr of ``mesh=None``'s; (c) ``StreamingChainPricer(mesh=)``
    launches K1 once and K5 a chunk, each strike within MESH_STDERRS of
    ``mesh=None``'s strip under the same fits; (d) ``run_pipeline(mesh=)``
    over MESH_PG_ROWS rows writes the one-device CSV byte for byte; (e) one
    ``train_model(mesh=)`` epoch leaves the parameters and Adam's moments of
    the one-device epoch to the bit; (f) ``device_trace`` writes a Chrome
    trace naming K2's kernel (``tile_kernel``) and the pipeline's
    ``price_batch[...]`` span.  The group is destroyed at the end; the
    phase within ``limit_s`` when one is given."""
    import json as json_mod
    import shutil
    import tempfile

    import numpy as np
    import torch.distributed as dist

    from montecarlooptionspricer_tpu_torch.config import (
        MarketDefaults, PipelineConfig, PricingConfig, TrainConfig)
    from montecarlooptionspricer_tpu_torch.models import engine
    from montecarlooptionspricer_tpu_torch.models import pathgen_cuda as pc
    from montecarlooptionspricer_tpu_torch.models.lsm import lsm_fit
    from montecarlooptionspricer_tpu_torch.nn.trainer import BayesianTrainer
    from montecarlooptionspricer_tpu_torch.parallel import make_mesh
    from montecarlooptionspricer_tpu_torch.pipeline import driver
    from montecarlooptionspricer_tpu_torch.utils import device_trace

    t_phase = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="mcop_mesh_"))
    check(not dist.is_initialized(), "mesh: a process group already exists")
    try:
        # (a) The mesh.
        try:
            make_mesh(2, dev.type)
            too_big = None
        except ValueError as e:
            too_big = str(e)
        (mesh, init_s) = timed(torch, lambda: make_mesh(1, dev.type))
        backend = dist.get_backend()
        emit({"phase": "mesh_init", "card": smi, "backend": backend,
              "rank": mesh.rank, "size": mesh.size,
              "device": str(mesh.device), "init_s": init_s,
              "make_mesh_2": too_big})
        check(too_big is not None and "2-device mesh" in too_big,
              "mesh: make_mesh(2) did not raise ValueError on one card")
        check(backend == ("nccl" if dev.type == "cuda" else "gloo")
              and mesh.size == 1 and mesh.rank == 0,
              f"mesh: {backend} group of {mesh.size}")

        # (b) The single-strike pricer.
        cfg = engine.StreamConfig(n_paths=CHUNK * MESH_CHUNKS,
                                  n_steps=N_STEPS, chunk_paths=CHUNK,
                                  pilot_paths=PILOT, dt=DT,
                                  chunks_per_call=MESH_CHUNKS)
        kw = dict(**MARKET, strike=STRIKE, maturity=MATURITY,
                  is_call=IS_CALL, config=cfg)
        sharded = engine.StreamingPricer(**kw, device=dev, mesh=mesh)
        one = engine.StreamingPricer(**kw, device=dev)
        check(sharded.kernel_family == "single",
              f"mesh: family {sharded.kernel_family}")
        reset_counts()
        (price, stderr), wall = timed(
            torch, lambda: sharded.price(SEED, with_stderr=True))
        launches = read_counts()
        (price1, stderr1), wall1 = timed(
            torch, lambda: one.price(SEED, with_stderr=True))
        sigmas = abs(price - price1) / math.hypot(stderr, stderr1)
        k_pilot = engine._pilot_stream_keys(SEED)[0]
        pilot = sharded._pilot(k_pilot)
        fit_group = lsm_fit(pilot, sharded.r, STRIKE, MATURITY, DT, IS_CALL,
                            group=mesh.group)[1]
        fit_none = lsm_fit(pilot, sharded.r, STRIKE, MATURITY, DT,
                           IS_CALL)[1]
        bit_equal = all(torch.equal(a, b) for a, b in zip(fit_group,
                                                          fit_none))
        table = sharded._make_rows(fit_group)
        run, start = engine._pilot_stream_keys(SEED)[1]
        key = pc._fold_words(run, start + (1 << 20))
        got = float(pc.priced_chunk(sharded.consts, table, STRIKE, IS_CALL,
                                    rows=CHUNK, key=key))
        want = float(pc.priced_chunk_from_noise_ref(
            sharded.consts, table, pc.philox_normals_ref(
                key, CHUNK, N_STEPS, device=dev), STRIKE, IS_CALL))
        k2_err = abs(got / want - 1.0)
        emit({"phase": "mesh_price", "card": smi, "n_paths": cfg.n_paths,
              "n_steps": N_STEPS, "price": price, "stderr": stderr,
              "wall_s": wall, "launches": launches, "price_one": price1,
              "stderr_one": stderr1, "wall_one_s": wall1,
              "combined_stderrs_apart": sigmas, "limit": MESH_STDERRS,
              "fit_bit_equal": bit_equal, "k2_offset_key_sum": got,
              "k2_offset_key_plain": want, "k2_rel_err": k2_err,
              "rtol": SUM_RTOL})
        check(launches == expected_counts(pathgen=1,
                                          priced_chunk=MESH_CHUNKS),
              f"mesh: price launches {launches}")
        check(bit_equal, "mesh: the fit through the group is not the fit "
              "without one")
        check(k2_err <= SUM_RTOL, "mesh: K2 on the rank-offset key disagrees")
        check(math.isfinite(price) and 0.0 < price < STRIKE
              and sigmas <= MESH_STDERRS,
              f"mesh: price {price} is {sigmas:.2f} stderr from {price1}")
        del pilot

        # (c) The strip on K5.
        chain = engine.StreamingChainPricer(
            **MARKET, strikes=STRIP, maturity=MATURITY, is_call=IS_CALL,
            config=cfg, device=dev, mesh=mesh)
        reset_counts()
        fits = chain.fit(k_pilot)
        (prices, stderrs), chain_wall = timed(
            torch, lambda: chain.price_with_fit(fits, SEED,
                                                with_stderr=True))
        chain_launches = read_counts()
        prices1, stderrs1 = engine.StreamingChainPricer(
            **MARKET, strikes=STRIP, maturity=MATURITY, is_call=IS_CALL,
            config=cfg, device=dev).price_with_fit(fits, SEED,
                                                   with_stderr=True)
        apart = np.abs(prices - prices1) / np.maximum(
            np.hypot(stderrs, stderrs1), 1e-300)
        apart = np.where(prices == prices1, 0.0, apart)
        emit({"phase": "mesh_chain", "card": smi, "strikes": list(STRIP),
              "prices": prices.tolist(), "stderrs": stderrs.tolist(),
              "prices_one": prices1.tolist(), "wall_s": chain_wall,
              "launches": chain_launches,
              "max_combined_stderrs_apart": float(apart.max())})
        check(chain_launches == expected_counts(
            pathgen=1, priced_chain=MESH_CHUNKS),
              f"mesh: strip launches {chain_launches}")
        check(bool(np.all(apart <= MESH_STDERRS)),
              f"mesh: strip {apart.max():.2f} stderr from mesh=None's")

        # (d) The pipeline, batches split over the mesh's ranks.
        pipeline_inputs(work, SEED)
        lines = (work / "options.csv").read_text().splitlines()
        keep = []
        for ln in lines[1:]:
            tok = ln.split(",")
            try:
                short = float(tok[4]) <= MESH_PG_MAX_DTE
            except (IndexError, ValueError):
                short = True            # a planted row: a sentinel
            if short and len(keep) < MESH_PG_ROWS:
                keep.append(ln)
        (work / "options.csv").write_text(
            "\n".join([lines[0]] + keep) + "\n")
        outs = {}
        for name, m in (("one", None), ("mesh", mesh)):
            config = PipelineConfig(
                option_csv=str(work / "options.csv"),
                spot_csv=str(work / "spot.csv"),
                output_csv=str(work / f"out_{name}.csv"),
                error_log=str(work / f"errors_{name}.txt"),
                diagnostic_csv=str(work / f"diag_{name}.csv"),
                max_memory_bytes=1 << 62)
            rc, pg_wall = timed(torch, lambda: driver.run_pipeline(
                config, PricingConfig(**PG_PRICING), MarketDefaults(), m,
                device=dev))
            check(rc == 0, f"mesh: run_pipeline ({name}) exit code {rc}")
            outs[name] = ((work / f"out_{name}.csv").read_bytes(), pg_wall)
        emit({"phase": "mesh_prediction_gen", "card": smi,
              "rows": len(keep), "wall_one_s": outs["one"][1],
              "wall_mesh_s": outs["mesh"][1],
              "byte_equal": outs["one"][0] == outs["mesh"][0]})
        check(outs["one"][0] == outs["mesh"][0],
              "mesh: the pipeline's CSV differs from the one-device CSV")

        # (e) One trainer epoch.
        rng = np.random.default_rng(SEED)
        x = rng.normal(size=(MESH_NN_ROWS, 17)).astype(np.float32)
        y = (1.0 + 0.5 * x[:, 0] - 0.2 * x[:, 3]).astype(np.float32)
        states = {}
        for name, m in (("one", None), ("mesh", mesh)):
            t = BayesianTrainer(17, 64, config=TrainConfig(seed=SEED),
                                device=dev)
            _, nn_s = timed(torch, lambda: t.train_model(
                x, y, num_epochs=1, batch_size=MESH_NN_BATCH,
                checkpoint_path=str(work / f"ckpt_{name}"), mesh=m))
            states[name] = (t.model.state_dict(), t.optimizer.m,
                            t.optimizer.v, nn_s)
        same = all(torch.equal(a, states["mesh"][0][k])
                   for k, a in states["one"][0].items())
        same_moments = all(torch.equal(states["one"][i], states["mesh"][i])
                           for i in (1, 2))
        emit({"phase": "mesh_train", "card": smi, "rows": MESH_NN_ROWS,
              "batch": MESH_NN_BATCH, "epoch_one_s": states["one"][3],
              "epoch_mesh_s": states["mesh"][3], "params_bit_equal": same,
              "moments_bit_equal": same_moments})
        check(same and same_moments,
              "mesh: the sharded epoch is not the one-device epoch")

        # (f) A trace of one K2 chunk and a pipeline run of the two
        # shortest rows (a trace holds some ten events an operator, and
        # the LSM loop dispatches ~100 operators a step).
        dated = sorted((float(ln.split(",")[4]), ln) for ln in keep
                       if _is_number(ln.split(",")[4:5]))
        (work / "options4.csv").write_text(
            "\n".join([lines[0]] + [ln for _, ln in dated[:2]]) + "\n")
        config = PipelineConfig(
            option_csv=str(work / "options4.csv"),
            spot_csv=str(work / "spot.csv"),
            output_csv=str(work / "out4.csv"),
            error_log=str(work / "errors4.txt"),
            diagnostic_csv=str(work / "diag4.csv"), max_memory_bytes=1 << 62)
        reset_counts()
        with device_trace(str(work / "trace")):
            sharded.price_with_fit(fit_group, SEED, n_paths=CHUNK)
            rc = driver.run_pipeline(config, PricingConfig(**PG_PRICING),
                                     MarketDefaults(), mesh, device=dev)
            torch.cuda.synchronize()
        traced = read_counts()
        check(rc == 0, f"mesh: traced run_pipeline exit code {rc}")
        files = sorted((work / "trace").glob("trace_*.json"))
        check(len(files) == 1, f"mesh: trace files {files}")
        events = json_mod.loads(files[0].read_text())["traceEvents"]
        kernel_names = {e.get("name", "") for e in events
                        if e.get("cat") == "kernel"}
        k2_named = any("tile_kernel" in n for n in kernel_names)
        span = any(str(e.get("name", "")).startswith("price_batch[")
                   for e in events)
        emit({"phase": "mesh_trace", "card": smi,
              "trace_bytes": files[0].stat().st_size,
              "events": len(events), "launches": traced,
              "kernel_names": sorted(kernel_names)[:8],
              "k2_named": k2_named, "price_batch_span": span})
        check(traced == expected_counts(priced_chunk=1),
              f"mesh: traced launches {traced}")
        check(k2_named and span,
              "mesh: the trace lacks K2's kernel or the price_batch span")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(work, ignore_errors=True)
    phase_s = time.perf_counter() - t_phase
    emit({"phase": "mesh", "card": smi, "phase_s": phase_s,
          "limit_s": limit_s})
    if limit_s is not None:
        check(phase_s <= limit_s, f"mesh: the phase took {phase_s:.1f} s")


def mesh_main(root: Path) -> int:
    """``python3 chip_smoke.py --mesh [ROOT]``: the ``mesh`` phase alone
    with the package of the checkout at ROOT (default: this script's), the
    kernels built first."""
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(root.resolve()))
    _START[0] = time.perf_counter()
    from montecarlooptionspricer_tpu_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    dev, smi = torch.device("cuda", 0), _card()
    reset_counts, read_counts = launch_counters()
    _, nvcc_s, _ = build.build()
    build.load()
    emit({"phase": "build", "nvcc_wall_s": round(nvcc_s, 3)})
    mesh_phase(torch, smi, dev, reset_counts, read_counts, limit_s=None)
    print(smi, flush=True)
    return 0


def nn_main(root: Path) -> int:
    """``python3 chip_smoke.py --nn [ROOT]``: the ``nn`` phase alone with
    the package of the checkout at ROOT (default: this script's), no
    kernel built."""
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(root.resolve()))
    _START[0] = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = _card()
    reset_counts, read_counts = launch_counters()
    nn_phase(torch, smi, torch.device("cuda", 0), reset_counts, read_counts,
             limit_s=None)
    print(smi, flush=True)
    return 0


def prediction_gen_main(root: Path) -> int:
    """``python3 chip_smoke.py --prediction-gen [ROOT]``: the
    ``host_engine`` and ``prediction_gen`` phases alone with the package of
    the checkout at ROOT (default: this script's), the host engine built
    and no kernel."""
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(root.resolve()))
    _START[0] = time.perf_counter()
    smi = _card()
    reset_counts, read_counts = launch_counters()
    host_engine_phase(smi)
    prediction_gen_phase(torch, smi, torch.device("cuda", 0), reset_counts,
                         read_counts)
    print(smi, flush=True)
    return 0


def qmc_main(root: Path) -> int:
    """``python3 chip_smoke.py --qmc [ROOT]``: the QMC phases alone with
    the package of the checkout at ROOT (default: this script's), the
    kernels built first, after the PRNG runs they are held against (the
    bench price and its CV form, the 1825- and 4000-step prices, the
    strip; 76 chunks each)."""
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(root.resolve()))
    _START[0] = time.perf_counter()
    from montecarlooptionspricer_tpu_torch.kernels import build
    from montecarlooptionspricer_tpu_torch.models import chain_cuda as cc
    from montecarlooptionspricer_tpu_torch.models import engine
    from montecarlooptionspricer_tpu_torch.models import pathgen_cuda as pc
    from montecarlooptionspricer_tpu_torch.models import (
        pathgen_factored_cuda as pfc)

    torch.backends.cuda.matmul.allow_tf32 = False
    dev, smi = torch.device("cuda", 0), _card()
    reset_counts, read_counts = launch_counters()
    _, nvcc_s, _ = build.build()
    build.load()
    emit({"phase": "build", "nvcc_wall_s": round(nvcc_s, 3)})

    def run(n, chunks, strip=False, **form):
        pricer = prng_pricer(engine, dev, n, chunks, strip, **form)
        fits = pricer.fit(engine._pilot_stream_keys(SEED)[0])
        out = pricer.price_with_fit(fits, SEED, with_stderr=True)
        return (*out, fits) if strip else (*out, CHUNK * chunks, fits)

    prng = {"price": run(N_STEPS, N_CHUNKS),
            "price_cv": run(N_STEPS, N_CHUNKS, control_variate=True),
            "price_long": run(LONG_STEPS, LONG_CHUNKS),
            "price_xlong": run(XLONG_STEPS, XLONG_CHUNKS),
            "strip": run(N_STEPS, N_CHUNKS, strip=True)}
    emit({"phase": "qmc_prng_runs", "runs": {
        k: [v.tolist() if hasattr(v, "tolist") else v for v in r[:-1]]
        for k, r in prng.items()}})
    qmc_phases(torch, pc, cc, pfc, engine, smi, dev, prng, reset_counts,
               read_counts)
    qmc_prediction_gen_phase(torch, smi, dev, reset_counts, read_counts)
    print(smi, flush=True)
    return 0


def _forms_setup(root: Path, module: str):
    """The checkout at ROOT on sys.path, its package checked to be the one
    imported, TF32 off and the kernels built: (torch, dev) for the forms
    runners, or None without a CUDA device."""
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return None
    sys.path.insert(0, str(root.resolve()))
    import importlib

    from montecarlooptionspricer_tpu_torch.kernels import build

    mod = importlib.import_module(module)
    check(Path(mod.__file__).resolve().is_relative_to(root.resolve()),
          f"imported {mod.__file__}, not the checkout at {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    build.load()
    return torch, torch.device("cuda", 0)


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def _digest(t) -> str:
    """sha256 of a tensor's bytes, to hold two checkouts' outputs equal bit
    for bit."""
    import hashlib

    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()


def k2_forms_main(root: Path) -> int:
    """``python3 chip_smoke.py --k2-forms [ROOT]``: K2 in each of its 24
    forms (float32 and bf16, chol and spectral, the four boundary forms
    and the two quadratic ones) on the bench option's fitted tables at
    131,072 rows and 365 steps, seeded, with the package of the checkout at
    ROOT (default: this script's): each form's ms (CUDA events, the mean
    of 10 launches after a warm one), its lanes' relative error against
    the plain version on the same seed and its block, beside K1's ms in
    each fGN form, dtype and pairing and K5's one-strike ms in its
    plain, paired and quadratic forms.  Prints one JSON line; run it on
    two checkouts in one call, in turns, to compare them."""
    got_setup = _forms_setup(root, "montecarlooptionspricer_tpu_torch."
                                   "models.pathgen_cuda")
    if got_setup is None:
        return 1
    torch, dev = got_setup
    from montecarlooptionspricer_tpu_torch.models import chain_cuda as cc
    from montecarlooptionspricer_tpu_torch.models import engine
    from montecarlooptionspricer_tpu_torch.models import pathgen_cuda as pc

    market = [MARKET[k] for k in ("s0", "xi", "h", "eta", "r")]
    cfg = engine.StreamConfig(n_paths=CHUNK * N_CHUNKS, n_steps=N_STEPS,
                              chunk_paths=CHUNK, pilot_paths=PILOT, dt=DT,
                              chunks_per_call=N_CHUNKS)
    pricer = engine.StreamingPricer(**MARKET, strike=STRIKE,
                                    maturity=MATURITY, is_call=IS_CALL,
                                    config=cfg, device=dev)
    fits = pricer.fit(engine._pilot_stream_keys(SEED)[0])
    s_table = pc.boundary_rows(fits, MARKET["r"], STRIKE, MATURITY, DT,
                               N_STEPS, IS_CALL).contiguous()
    tables = {"boundary": pc.log_boundary_rows(s_table).contiguous(),
              "quadratic": pc.policy_rows(fits, MARKET["r"], STRIKE,
                                          MATURITY, DT, N_STEPS,
                                          IS_CALL).contiguous()}
    key = pc._fold_words(12345, 7)
    forms, k1, k5 = [], {}, {}
    for bf16 in (False, True):
        for spec in (False, True):
            consts = pc.make_path_consts(
                *market, N_STEPS, DT, dev,
                fgn_form="spectral" if spec else "chol",
                fgn_dtype="bfloat16" if bf16 else "float32")
            for anti in (False, True):
                k1[pc.form_name(anti, spectral=spec, bf16=bf16)] = time_ms(
                    torch, lambda: pc.pathgen(consts, rows=CHUNK, key=key,
                                              antithetic=anti), 10)
            for anti, quad in ((False, False), (True, False), (False, True)):
                policy = "quadratic" if quad else "boundary"
                one = (tables[policy] if quad else s_table)[None]
                k5[pc.form_name(anti, False, spec, quad, bf16)] = time_ms(
                    torch, lambda: cc.priced_chain(
                        consts, one, IS_CALL, rows=CHUNK, key=key,
                        antithetic=anti, policy_form=policy), 10)
            for anti, cv, quad in ((False, False, False),
                                   (True, False, False),
                                   (False, True, False), (True, True, False),
                                   (False, False, True), (False, True, True)):
                policy = "quadratic" if quad else "boundary"
                table = tables[policy]

                def run():
                    return pc.priced_chunk(
                        consts, table, STRIKE, IS_CALL, rows=CHUNK, key=key,
                        antithetic=anti, with_cv=cv, policy_form=policy)

                got = run()
                noise = pc.normals_ref(consts, key,
                                       CHUNK // 2 if anti else CHUNK,
                                       device=dev)
                want = pc.priced_chunk_from_noise_ref(
                    consts, table, noise, STRIKE, IS_CALL, anti, cv, policy)
                del noise
                got, want = (got, want) if cv else ((got,), (want,))
                rec = {"form": pc.form_name(anti, cv, spec, quad, bf16),
                       "ms": time_ms(torch, run, 10),
                       "rel_err": [abs(float(g) / float(w) - 1.0)
                                   for g, w in zip(got, want)],
                       "block_paths": pc.priced_block_paths(consts, CHUNK,
                                                            anti)}
                if hasattr(pc, "priced_blocks_per_sm"):
                    rec["blocks_per_sm"] = pc.priced_blocks_per_sm(
                        consts, CHUNK, anti, cv, policy)
                forms.append(rec)
    emit({"k2_forms": forms, "k1_ms": k1, "k5_one_strike_ms": k5,
          "root": str(root), "card": _card()})
    return 0


K9_FORMS = ((False, False, False), (True, False, False), (False, True, False),
            (True, True, False), (False, False, True), (False, True, True))


def k9_forms_main(root: Path) -> int:
    """``python3 chip_smoke.py --k9-forms [ROOT]``: K9 in each of its 12
    forms (float32 and bf16; plain, paired, CV, paired CV, quadratic,
    quadratic CV) and K8 in its four (float32 and bf16, plain and paired)
    at XLONG_STEPS, and K9 and K8 plain at LONG_STEPS and 8192, seeded at
    131,072 rows on the bench option's fitted tables of each horizon, with
    the package of the checkout at ROOT (default: this script's): each
    form's ms (CUDA events, the mean of 10 launches after a warm one), K9's
    lanes' relative error against the plain version on the same seed
    (16,384 rows at 8192 steps, whose plain planes would not fit beside
    the chunk's), K8's largest absolute error on its first 8,192 rows, and
    blocks per SM where the checkout reports them.  Prints one JSON line;
    run it on two checkouts in one call, in turns, to compare them."""
    got_setup = _forms_setup(root, "montecarlooptionspricer_tpu_torch."
                                   "models.pathgen_factored_cuda")
    if got_setup is None:
        return 1
    torch, dev = got_setup
    from montecarlooptionspricer_tpu_torch.models import engine
    from montecarlooptionspricer_tpu_torch.models import pathgen_cuda as pc
    from montecarlooptionspricer_tpu_torch.models import (
        pathgen_factored_cuda as pfc)

    market = [MARKET[k] for k in ("s0", "xi", "h", "eta", "r")]
    key = pc._fold_words(12345, 9)
    k9_rows, k8_err_rows = CHUNK, min(CHUNK, 1 << 13)
    forms = []
    for n in (XLONG_STEPS, LONG_STEPS, 8192):
        cfg = engine.StreamConfig(n_paths=CHUNK, n_steps=n, chunk_paths=CHUNK,
                                  pilot_paths=PILOT, dt=DT,
                                  tiled_impl="factored")
        pricer = engine.StreamingPricer(**MARKET, strike=STRIKE,
                                        maturity=n * DT, is_call=IS_CALL,
                                        config=cfg, device=dev)
        check(pricer.kernel_family == "factored",
              f"{n} steps resolved to {pricer.kernel_family!r}")
        fits = pricer.fit(engine._pilot_stream_keys(SEED)[0])
        tables = {policy: engine._fused_rows_builder(
            MARKET["r"], STRIKE, n * DT, DT, n, IS_CALL, policy)(fits)
            for policy in ("boundary", "quadratic")}
        del pricer
        err_rows = k9_rows if n <= 4096 else min(k9_rows, 1 << 14)
        all_forms = n == XLONG_STEPS
        for bf16 in ((False, True) if all_forms else (False,)):
            consts = pfc.make_factored_consts(
                *market, n, DT, dev,
                fgn_dtype="bfloat16" if bf16 else "float32")
            for anti in ((False, True) if all_forms else (False,)):
                def run_k8():
                    return pfc.factored_pathgen(consts, rows=k9_rows,
                                                key=key, antithetic=anti)
                ms = time_ms(torch, run_k8, 10)
                got = pfc.factored_pathgen(consts, rows=k8_err_rows,
                                           key=key, antithetic=anti)
                noise = pfc.philox_factored_normals_ref(
                    key, k8_err_rows // 2 if anti else k8_err_rows, n,
                    device=dev)
                want = pfc.factored_pathgen_from_noise_ref(consts, noise,
                                                           anti)
                rec = {"kernel": "K8", "n_steps": n,
                       "form": pc.form_name(anti, bf16=bf16), "ms": ms,
                       "max_abs_err": float((got - want).abs().max()),
                       "max_rel_err": float(((got - want) / want).abs()
                                            .max())}
                if hasattr(pfc, "blocks_per_sm"):
                    rec["blocks_per_sm"] = pfc.blocks_per_sm(
                        consts, priced=False, antithetic=anti)
                forms.append(rec)
                del got, noise, want
            for anti, cv, quad in (K9_FORMS if all_forms
                                   else K9_FORMS[:1]):
                policy = "quadratic" if quad else "boundary"
                table = tables[policy]

                def run_k9(rows=k9_rows):
                    return pfc.factored_priced_chunk(
                        consts, table, STRIKE, IS_CALL, rows=rows, key=key,
                        antithetic=anti, with_cv=cv, policy_form=policy)

                ms = time_ms(torch, run_k9, 10)
                got = run_k9(err_rows)
                noise = pfc.philox_factored_normals_ref(
                    key, err_rows // 2 if anti else err_rows, n, device=dev)
                want = pfc.factored_priced_chunk_from_noise_ref(
                    consts, table, noise, STRIKE, IS_CALL, anti, cv, policy)
                del noise
                got, want = (got, want) if cv else ((got,), (want,))
                rec = {"kernel": "K9", "n_steps": n,
                       "form": pc.form_name(anti, cv, quadratic=quad,
                                            bf16=bf16), "ms": ms,
                       "rel_err": [abs(float(g) / float(w) - 1.0)
                                   for g, w in zip(got, want)],
                       "abs_err": [abs(float(g) - float(w))
                                   for g, w in zip(got, want)]}
                if hasattr(pfc, "blocks_per_sm"):
                    rec["blocks_per_sm"] = pfc.blocks_per_sm(
                        consts, antithetic=anti, with_cv=cv,
                        policy_form=policy)
                forms.append(rec)
    emit({"k9_forms": forms, "rows": k9_rows, "root": str(root),
          "card": _card()})
    return 0


# K1's eight forms and K6's: (bf16, spectral, antithetic).
PATH_FORM_KEYS = tuple((b, s, a) for b in (False, True) for s in (False, True)
                       for a in (False, True))


def k1_forms_main(root: Path) -> int:
    """``python3 chip_smoke.py --k1-forms [ROOT]``: K1 in each of its 8
    forms (float32 and bf16, chol and spectral, plain and paired) at
    N_STEPS, seeded at 131,072 rows, with the package of the checkout at
    ROOT (default: this script's): each form's ms (CUDA events, the mean
    of 10 launches after a warm one), its largest absolute and relative
    error against the plain version on the same seed, its block and, where
    the checkout reports them, its blocks per SM and the ms of every block
    that fits (``block_ms``, the form's cap set to each in turn).  Prints
    one JSON line; run it on two checkouts in one call, in turns, to
    compare them."""
    got_setup = _forms_setup(root, "montecarlooptionspricer_tpu_torch."
                                   "models.pathgen_cuda")
    if got_setup is None:
        return 1
    torch, dev = got_setup
    from montecarlooptionspricer_tpu_torch.models import pathgen_cuda as pc

    market = [MARKET[k] for k in ("s0", "xi", "h", "eta", "r")]
    key = pc._fold_words(12345, 16)
    forms = []
    for bf16, spec, anti in PATH_FORM_KEYS:
        consts = pc.make_path_consts(
            *market, N_STEPS, DT, dev,
            fgn_form="spectral" if spec else "chol",
            fgn_dtype="bfloat16" if bf16 else "float32")

        def run():
            return pc.pathgen(consts, rows=CHUNK, key=key, antithetic=anti)

        got = run()
        noise = pc.normals_ref(consts, key, CHUNK // 2 if anti else CHUNK,
                               device=dev)
        want = pc.pathgen_from_noise_ref(consts, noise, anti)
        del noise
        diff = (got - want).abs()
        rec = {"form": pc.form_name(anti, spectral=spec, bf16=bf16),
               "ms": time_ms(torch, run, 10),
               "max_abs_err": float(diff.max()),
               "max_rel_err": float((diff / want.abs()).max())}
        del got, want, diff
        if hasattr(pc, "pathgen_block_paths"):
            rec["block_paths"] = pc.pathgen_block_paths(consts, CHUNK, anti)
            rec["blocks_per_sm"] = pc.pathgen_blocks_per_sm(consts, CHUNK,
                                                            anti)
            caps, form_key = pc.PATHGEN_BLOCK_CAPS, (bf16, spec, anti)
            saved = caps.get(form_key)
            block_ms = {}
            for bp in (pc.PAIRED_BLOCK_CHOICES if anti
                       else pc.BLOCK_CHOICES):
                if pc.pathgen_smem_bytes(N_STEPS, bp, anti, spec,
                                         bf16) > pc.SMEM_LIMIT:
                    continue
                caps[form_key] = bp
                block_ms[bp] = time_ms(torch, run, 10)
            if saved is None:
                del caps[form_key]
            else:
                caps[form_key] = saved
            rec["block_ms"] = block_ms
        else:
            rec["block_paths"] = (consts.block_paths if not anti
                                  else pc.path_block_paths(consts, CHUNK,
                                                           True))
        forms.append(rec)
    emit({"k1_forms": forms, "n_steps": N_STEPS, "rows": CHUNK,
          "root": str(root), "card": _card()})
    return 0


def k7_forms_main(root: Path) -> int:
    """``python3 chip_smoke.py --k7-forms [ROOT]``: K7 in each of its 24
    forms (float32 and bf16, chol and spectral; plain, paired, CV, paired
    CV, quadratic, quadratic CV) and K6 in its 8 at LONG_STEPS, seeded at
    131,072 rows on the bench option's fitted tables, and P1's matmul
    probe in both dtypes (66 blocks of 512 rows, 384 steps, k 19 and 31),
    with the package of the checkout at ROOT (default: this script's):
    each form's ms (CUDA events, the mean of 5 launches after a warm one),
    K7's lanes' relative error against the plain version on the same
    seed, K6's largest errors and the sha256 of its seeded output on
    16,384 rows, P1's ms and the sha256 of its product, and blocks per SM
    where the checkout reports them.  Prints one JSON line; run it on two
    checkouts in one call, in turns: equal digests are the same bits."""
    got_setup = _forms_setup(root, "montecarlooptionspricer_tpu_torch."
                                   "models.pathgen_tiled_cuda")
    if got_setup is None:
        return 1
    torch, dev = got_setup
    from montecarlooptionspricer_tpu_torch import roofline as rl
    from montecarlooptionspricer_tpu_torch.models import engine
    from montecarlooptionspricer_tpu_torch.models import pathgen_cuda as pc
    from montecarlooptionspricer_tpu_torch.models import (
        pathgen_tiled_cuda as ptc)

    market = [MARKET[k] for k in ("s0", "xi", "h", "eta", "r")]
    key = pc._fold_words(12345, 17)
    n = LONG_STEPS
    cfg = engine.StreamConfig(n_paths=CHUNK, n_steps=n, chunk_paths=CHUNK,
                              pilot_paths=PILOT, dt=DT)
    pricer = engine.StreamingPricer(**MARKET, strike=STRIKE,
                                    maturity=LONG_MATURITY, is_call=IS_CALL,
                                    config=cfg, device=dev)
    check(pricer.kernel_family == "tiled",
          f"{n} steps resolved to {pricer.kernel_family!r}")
    fits = pricer.fit(engine._pilot_stream_keys(SEED)[0])
    tables = {policy: engine._fused_rows_builder(
        MARKET["r"], STRIKE, LONG_MATURITY, DT, n, IS_CALL, policy)(fits)
        for policy in ("boundary", "quadratic")}
    del pricer
    k6_rows = 1 << 14
    forms = []
    for bf16, spec, anti in PATH_FORM_KEYS:
        consts = pc.make_path_consts(
            *market, n, DT, dev, fgn_form="spectral" if spec else "chol",
            fgn_dtype="bfloat16" if bf16 else "float32")

        def run_k6(rows=CHUNK):
            return ptc.tiled_pathgen(consts, rows=rows, key=key,
                                     antithetic=anti)

        got = run_k6(k6_rows)
        noise = pc.normals_ref(consts, key, k6_rows // 2 if anti else k6_rows,
                               device=dev)
        want = ptc.pathgen_from_noise_ref(consts, noise, anti)
        diff = (got - want).abs()
        rec = {"kernel": "K6", "form": pc.form_name(anti, spectral=spec,
                                                    bf16=bf16),
               "ms": time_ms(torch, run_k6, 5),
               "max_abs_err": float(diff.max()),
               "max_rel_err": float((diff / want.abs()).max()),
               "sha256": _digest(got)}
        del got, noise, want, diff
        if hasattr(ptc, "blocks_per_sm"):
            rec["blocks_per_sm"] = ptc.blocks_per_sm(consts, CHUNK, False,
                                                     anti)
        forms.append(rec)
        if anti:
            continue
        for anti7, cv, quad in K9_FORMS:
            policy = "quadratic" if quad else "boundary"
            table = tables[policy]

            def run_k7():
                return ptc.tiled_priced_chunk(
                    consts, table, STRIKE, IS_CALL, rows=CHUNK, key=key,
                    antithetic=anti7, with_cv=cv, policy_form=policy)

            got = run_k7()
            noise = pc.normals_ref(consts, key,
                                   CHUNK // 2 if anti7 else CHUNK,
                                   device=dev)
            want = ptc.priced_chunk_from_noise_ref(
                consts, table, noise, STRIKE, IS_CALL, anti7, cv, policy)
            del noise
            got, want = (got, want) if cv else ((got,), (want,))
            rec = {"kernel": "K7",
                   "form": pc.form_name(anti7, cv, spec, quad, bf16),
                   "ms": time_ms(torch, run_k7, 5),
                   "rel_err": [abs(float(g) / float(w) - 1.0)
                               for g, w in zip(got, want)],
                   "abs_err": [abs(float(g) - float(w))
                               for g, w in zip(got, want)]}
            if hasattr(ptc, "blocks_per_sm"):
                rec["blocks_per_sm"] = ptc.blocks_per_sm(
                    consts, CHUNK, True, anti7, cv, policy)
            forms.append(rec)
    p1 = []
    s_pad = 384
    b32 = rl.orthogonal(s_pad).to(dev)
    for name, b, k in (("float32", b32, 19),
                       ("bfloat16", b32.to(torch.bfloat16), 31)):
        out = rl.matmul(7, b, 66, k)
        p1.append({"dtype": name, "grid": 66, "s_pad": s_pad, "k": k,
                   "ms": time_ms(torch, lambda: rl.matmul(7, b, 66, k), 5),
                   "sha256": _digest(out)})
    emit({"k7_forms": forms, "p1_matmul": p1, "n_steps": n, "rows": CHUNK,
          "k6_digest_rows": k6_rows, "root": str(root), "card": _card()})
    return 0


FORMS_MAINS = {"--k1-forms": "k1_forms_main", "--k2-forms": "k2_forms_main",
               "--k7-forms": "k7_forms_main", "--k9-forms": "k9_forms_main",
               "--prediction-gen": "prediction_gen_main",
               "--qmc": "qmc_main", "--serve-jvp": "serve_jvp_main",
               "--nn": "nn_main", "--mesh": "mesh_main"}


def launch_counters():
    """(reset_counts, read_counts) over the launch counters of every kernel
    wrapper: the plain form keeps the wrapper's name, the others are
    kernel/form."""
    from montecarlooptionspricer_tpu_torch import roofline as rl
    from montecarlooptionspricer_tpu_torch.models import chain_cuda as cc
    from montecarlooptionspricer_tpu_torch.models import greeks_cuda as gc
    from montecarlooptionspricer_tpu_torch.models import pathgen_cuda as pc
    from montecarlooptionspricer_tpu_torch.models import (
        pathgen_factored_cuda as pfc)
    from montecarlooptionspricer_tpu_torch.models import (
        pathgen_tiled_cuda as ptc)

    wrappers = {"pathgen": pc.pathgen, "priced_chunk": pc.priced_chunk,
                "tiled_pathgen": ptc.tiled_pathgen,
                "tiled_priced_chunk": ptc.tiled_priced_chunk,
                "priced_chain": cc.priced_chain,
                "greeks_chunk": gc.greeks_chunk,
                "chain_greeks_chunk": gc.chain_greeks_chunk,
                "factored_pathgen": pfc.factored_pathgen,
                "factored_priced_chunk": pfc.factored_priced_chunk,
                "P1/normals": rl.normals, "P1/matmul": rl.matmul}

    def reset_counts():
        for fn in wrappers.values():
            fn.launches = 0
            for form in getattr(fn, "form_launches", {}):
                fn.form_launches[form] = 0

    def read_counts():
        counts = {k: fn.launches for k, fn in wrappers.items()}
        for kernel, wname in FORM_WRAPPERS.items():
            by_form = wrappers[wname].form_launches
            counts[wname] = by_form["plain"]
            counts.update({f"{kernel}/{f}": n for f, n in by_form.items()
                           if f != "plain"})
        return counts

    return reset_counts, read_counts


def main() -> int:
    _START[0] = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device; chip_smoke.py measures the GPU path "
              "only", file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parent
    if not (root / "montecarlooptionspricer_tpu_torch").is_dir():
        print("error: run chip_smoke.py from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(root))
    from montecarlooptionspricer_tpu_torch.kernels import build

    # Phase 1: build, one nvcc per unit, all started together; the
    # process's imports and one-time host costs are paid while nvcc runs.
    t0 = time.perf_counter()
    built = {}

    def run_build():
        try:
            built["out"] = build.build(verbose=True)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            built["err"] = e

    build_thread = threading.Thread(target=run_build)
    build_thread.start()
    # The host engine's two units, compiled with the host C++ compiler
    # beside nvcc; the ``host_engine`` phase reports and checks them.
    from montecarlooptionspricer_tpu_torch.kernels import host_build
    host_built = {}

    def run_host_build():
        try:
            host_built["out"] = host_build.build()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            host_built["err"] = e

    host_thread = threading.Thread(target=run_host_build)
    host_thread.start()
    from montecarlooptionspricer_tpu_torch import roofline as rl
    from montecarlooptionspricer_tpu_torch.models import chain_cuda as cc
    from montecarlooptionspricer_tpu_torch.models import closed_form
    from montecarlooptionspricer_tpu_torch.models import engine
    from montecarlooptionspricer_tpu_torch.models import greeks_cuda as gc
    from montecarlooptionspricer_tpu_torch.models import pathgen_cuda as pc
    from montecarlooptionspricer_tpu_torch.models import (
        pathgen_factored_cuda as pfc)
    from montecarlooptionspricer_tpu_torch.models import (
        pathgen_tiled_cuda as ptc)
    from montecarlooptionspricer_tpu_torch.models.lsm import lsm_fit

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()

    reset_counts, read_counts = launch_counters()
    warm_s = warm_up(torch, dev)
    build_thread.join()
    host_thread.join()
    for out in (built, host_built):
        if "err" in out:
            raise out["err"]
    lib_paths, nvcc_s, unit_s = built["out"]
    build.load()
    torch.cuda.synchronize()
    emit({"phase": "build", "libraries": [p.name for p in lib_paths],
          "nvcc_wall_s": round(nvcc_s, 3), "nvcc_s_per_unit": unit_s,
          "host_build_s": round(host_built["out"][1], 3),
          "warm_up_s": round(warm_s, 3),
          "seconds": round(time.perf_counter() - t0, 3)})

    cfg = engine.StreamConfig(n_paths=CHUNK * N_CHUNKS, n_steps=N_STEPS,
                              chunk_paths=CHUNK, pilot_paths=PILOT, dt=DT,
                              chunks_per_call=N_CHUNKS)
    pricer = engine.StreamingPricer(**MARKET, strike=STRIKE,
                                    maturity=MATURITY, is_call=IS_CALL,
                                    config=cfg, device=dev)
    consts = pricer.consts
    key = pc._fold_words(12345, 7)

    def rel_err(got, want):
        return float(torch.max(torch.abs(got - want) / torch.abs(want)))

    # Phase 2: K1 noise-in against its plain version, elementwise.
    noise = pc.philox_normals_ref(key, PILOT, N_STEPS, device=dev)
    got = pc.pathgen(consts, noise=noise)
    want = pc.pathgen_from_noise_ref(consts, noise)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), "K1 noise-in: non-finite paths")
    err_k1_noise = rel_err(got, want)
    emit({"phase": "k1_noise_in", "rows": PILOT, "n_steps": N_STEPS,
          "block_paths": consts.block_paths, "max_rel_err": err_k1_noise,
          "rtol": PATH_RTOL})
    check(err_k1_noise <= PATH_RTOL, "K1 noise-in disagrees")

    # Phase 3: K1 seeded against Philox reference -> plain, elementwise.
    got = pc.pathgen(consts, rows=PILOT, key=key)
    torch.cuda.synchronize()
    err_k1 = rel_err(got, want)
    abs_k1 = float(torch.max(torch.abs(got - want)))
    emit({"phase": "k1_seeded", "max_rel_err": err_k1,
          "max_abs_err": abs_k1, "rtol": PATH_RTOL})
    check(err_k1 <= PATH_RTOL, "K1 seeded disagrees with philox_normals_ref")
    del got, want

    # Phase 4: K2 against its plain version on a fitted policy table.
    fits = pricer.fit(engine._pilot_stream_keys(SEED)[0])
    table = pricer._make_rows(fits)
    got_n = pc.priced_chunk(consts, table, STRIKE, IS_CALL, noise=noise)
    want_n = pc.priced_chunk_from_noise_ref(consts, table, noise, STRIKE,
                                            IS_CALL)
    noise_s = pc.philox_normals_ref(key, CHUNK, N_STEPS, device=dev)
    got_s = pc.priced_chunk(consts, table, STRIKE, IS_CALL, rows=CHUNK,
                            key=key)
    want_s = pc.priced_chunk_from_noise_ref(consts, table, noise_s, STRIKE,
                                            IS_CALL)
    torch.cuda.synchronize()
    err_k2_noise = abs(float(got_n) / float(want_n) - 1.0)
    err_k2 = abs(float(got_s) / float(want_s) - 1.0)
    abs_k2 = abs(float(got_s) - float(want_s))
    emit({"phase": "k2", "rows": CHUNK, "noise_in_sum": float(got_n),
          "noise_in_plain": float(want_n), "noise_in_rel_err": err_k2_noise,
          "seeded_sum": float(got_s), "seeded_plain": float(want_s),
          "seeded_rel_err": err_k2, "rtol": SUM_RTOL})
    check(err_k2_noise <= SUM_RTOL and err_k2 <= SUM_RTOL,
          "K2 disagrees with its plain version")
    del noise, noise_s

    # Phase 5: the full-width main path, through the kernels.
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    price, stderr = pricer.price(SEED, with_stderr=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    n_paths = CHUNK * N_CHUNKS
    price_plain = plain_price(pc, engine, lsm_fit, pricer, SEED)
    torch.cuda.synchronize()
    price_rel = abs(price / price_plain - 1.0)
    emit({"phase": "price", "n_paths": n_paths, "n_steps": N_STEPS,
          "price": price, "stderr": stderr, "wall_s": wall,
          "paths_per_s": n_paths / wall, "launches": launches,
          "plain_price": price_plain, "rel_err": price_rel,
          "rtol": SUM_RTOL})
    check(launches == expected_counts(pathgen=1, priced_chunk=N_CHUNKS),
          f"main path launches {launches}, want 1 and {N_CHUNKS}")
    check(math.isfinite(price) and 0.0 < price < STRIKE,
          f"price {price} outside (0, strike)")
    check(math.isfinite(stderr) and 0.0 < stderr < 0.01 * price,
          f"stderr {stderr} implausible")
    check(price_rel <= SUM_RTOL, "price disagrees with the plain path")

    # Phase 6: times at the main path's shapes.
    def k1():
        pc.pathgen(consts, rows=PILOT, key=key)

    def k1_plain():
        pc.pathgen_from_noise_ref(consts, pc.philox_normals_ref(
            key, PILOT, N_STEPS, device=dev))

    def k2():
        pc.priced_chunk(consts, table, STRIKE, IS_CALL, rows=CHUNK, key=key)

    def k2_plain():
        pc.priced_chunk_from_noise_ref(consts, table, pc.philox_normals_ref(
            key, CHUNK, N_STEPS, device=dev), STRIKE, IS_CALL)

    a = torch.randn((CHUNK, N_STEPS), device=dev)
    lt = consts.lt_half
    lib_ms = time_ms(torch, lambda: torch.matmul(a, lt), reps=20)
    k1_b, k1_by = bound_ms(PILOT, N_STEPS, 4 * PILOT * (N_STEPS + 1))
    k2_b, k2_by = bound_ms(CHUNK, N_STEPS,
                           4 * (CHUNK // pc.priced_block_paths(consts, CHUNK)))
    k1_ms, k2_ms = time_ms(torch, k1, 10), time_ms(torch, k2, 10)
    kernels = [
        kernel_record("pathgen", launches, k1_ms, time_ms(torch, k1_plain, 3),
                      k1_b, k1_by, abs_k1, lib_ms),
        kernel_record("priced_chunk", launches, k2_ms,
                      time_ms(torch, k2_plain, 3), k2_b, k2_by, abs_k2,
                      lib_ms)]
    # Host-clock split of one main-path run: pilot + fit, then the stream.
    t0 = time.perf_counter()
    fits = pricer.fit(engine._pilot_stream_keys(SEED)[0])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pricer.price_with_fit(fits, SEED)
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    del a, table

    # Phases k5, chain_price, k3, k4, greeks and chain_greeks.
    records, chain_times, strip_plain, greeks32 = chain_and_greeks_phases(
        torch, pc, cc, gc, engine, smi, dev, key, pricer, price, stderr,
        reset_counts, read_counts)
    kernels += records
    emit({"phase": "times", "card": smi, "library_call":
          "torch.matmul [131072,365]x[365,365] float32 (fGN product only; "
          "K3/K4: with [365,365] dLt' too)",
          "library_ms": lib_ms, "fit_s": fit_s, "stream_s": stream_s,
          "k1_ms": k1_ms, "k2_ms": k2_ms, **chain_times})

    records, long_fits, long_price, long_stderr, long_stream_s = \
        long_horizon_phases(torch, pc, ptc, engine, smi, dev, key, rel_err,
                            reset_counts, read_counts)
    kernels += records
    records, xlong, factored_long = factored_phases(
        torch, pc, pfc, engine, smi, dev, key, rel_err, reset_counts,
        read_counts, long_fits, long_price, long_stderr)
    kernels += records

    # The estimators: K2, K7 and K9 in each form, and nine prices.
    plain_runs = {N_STEPS: (fits, price, stderr, stream_s),
                  LONG_STEPS: (long_fits, long_price, long_stderr,
                               long_stream_s),
                  XLONG_STEPS: xlong}
    records, vr_prices = estimator_phases(
        torch, pc, ptc, pfc, engine, smi, dev, key, pricer, plain_runs,
        reset_counts, read_counts)
    kernels += records

    # The pair forms of K5, K3 and K4, K5 past the single tile, and the
    # generic path stream.
    kernels += pair_phases(torch, pc, cc, gc, engine, smi, dev, key, pricer,
                           strip_plain, vr_prices["price_anti"],
                           reset_counts, read_counts)
    chain_past_tile_phase(torch, pc, cc, engine, smi, dev, key)
    stream_phases(torch, pc, engine, smi, dev, (long_price, long_stderr),
                  (price, stderr), reset_counts, read_counts)

    # The duality bounds and the whole-path pair forms they stream.
    pair_times = path_pair_phase(torch, pc, ptc, pfc, smi, dev, key, rel_err)
    pair_launches = bounds_phases(
        torch, pc, engine, closed_form, smi, dev,
        {"plain": (price, stderr), "anti": vr_prices["price_anti"]},
        reset_counts, read_counts)
    for form, t in pair_times.items():
        kernels.append(kernel_record(form, pair_launches, t["ms"],
                                     t["plain_ms"], t["bound_ms"],
                                     t["bound_by"], t["max_abs_err"],
                                     t["library_ms"]))

    # The spectral fGN form of K1/K2, K5 and K6/K7.
    records, price_spectral = spectral_phases(
        torch, pc, cc, ptc, engine, smi, dev, key, rel_err,
        {"price": (price, stderr), "price_factored": factored_long},
        reset_counts, read_counts)
    kernels += records

    # The quadratic exercise-policy forms of K2, K7, K9 and K5.
    kernels += quadratic_phases(
        torch, pc, cc, ptc, pfc, engine, smi, dev, key,
        {"price": (price, stderr), "price_cv": vr_prices["price_cv"],
         "price_long": (long_price, long_stderr),
         "price_long_cv": vr_prices["price_long_cv"],
         "price_xlong": xlong[1:3],
         "price_xlong_cv": vr_prices["price_xlong_cv"], "fits": fits,
         "long_fits": long_fits, "xlong_fits": xlong[0]},
        reset_counts, read_counts)

    # The bf16 fGN-input forms of K1/K2 and K6/K7; of K8/K9, the spectral
    # and the quadratic bodies; of K5 and K3/K4; then P1.
    records, _, bf16_runs = bf16_phases(
        torch, pc, ptc, engine, lsm_fit, smi, dev, key,
        {"price": (price, stderr), "price_long": (long_price, long_stderr)},
        reset_counts, read_counts)
    kernels += records
    kernels += bf16_later_phases(
        torch, pc, ptc, pfc, engine, lsm_fit, smi, dev, key,
        {"price_xlong": xlong[1:3], "xlong_fits": xlong[0],
         "price_spectral": price_spectral, "price_factored": factored_long,
         "bf16": bf16_runs}, reset_counts, read_counts)
    kernels += bf16_chain_greeks_phases(
        torch, pc, cc, gc, engine, smi, dev, key,
        {"price_bf16": bf16_runs["price_bf16"]["price"],
         "strip": strip_plain, "greeks": greeks32[0],
         "chain_greeks": greeks32[1]}, reset_counts, read_counts)
    kernels += roofline_phase(torch, rl, smi, dev, kernels, reset_counts,
                              read_counts)
    k2_split(pc, kernels, dev)
    k1_k7_split(pc, ptc, kernels, dev)
    k89_split(pfc, kernels, dev)
    # Randomized QMC through the noise-in entries of K2, K7, K9 and K5, held
    # against the PRNG runs above under their fits (refitted: a seed's fit
    # is the same bits every time).
    k_pilot = engine._pilot_stream_keys(SEED)[0]
    cv_fits = prng_pricer(engine, dev, N_STEPS, N_CHUNKS,
                          control_variate=True).fit(k_pilot)
    strip_fits = prng_pricer(engine, dev, N_STEPS, N_CHUNKS,
                             strip=True).fit(k_pilot)
    qmc_launches = qmc_phases(torch, pc, cc, pfc, engine, smi, dev, {
        "price": (price, stderr, CHUNK * N_CHUNKS, fits),
        "price_cv": (*vr_prices["price_cv"], CHUNK * N_CHUNKS, cv_fits),
        "price_long": (long_price, long_stderr, CHUNK * LONG_CHUNKS,
                       long_fits),
        "price_xlong": (*xlong[1:3], CHUNK * XLONG_CHUNKS, xlong[0]),
        "strip": (*strip_plain, strip_fits)}, reset_counts, read_counts)
    for k in kernels:
        if k["name"] in qmc_launches:
            k["qmc_noise_in_launches"] = qmc_launches[k["name"]]
    # The native host engine against its plain versions, then the
    # PredictionGen pipeline on it, which launches no kernel, and its --qmc.
    host_engine_phase(smi, host_built["out"])
    prediction_gen_phase(torch, smi, dev, reset_counts, read_counts)
    qmc_prediction_gen_phase(torch, smi, dev, reset_counts, read_counts)
    # The serving CLI and the jvp Greeks stream, which launch no kernel;
    # the served bench strip against K1 + K5 under its bucket's law.
    bucket_strip = bucket_law_strip(torch, engine, smi, dev,
                                    reset_counts, read_counts)
    serve_phase(torch, smi, dev, strip_plain, bucket_strip, reset_counts,
                read_counts)
    greeks_jvp_phase(torch, engine, smi, dev, greeks32[0],
                     (long_price, long_stderr), reset_counts, read_counts)
    # The Bayesian meta-model's two CLIs, which launch no kernel.
    nn_phase(torch, smi, dev, reset_counts, read_counts)
    # The multi-device forms over NCCL at a world of one.
    mesh_phase(torch, smi, dev, reset_counts, read_counts)
    check(sorted(k["name"] for k in kernels) == sorted(REPLACES),
          "the kernels line does not list every kernel and form")
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        if sys.argv[1:2] and sys.argv[1] in FORMS_MAINS:
            forms_main = globals()[FORMS_MAINS[sys.argv[1]]]
            sys.exit(forms_main(Path(sys.argv[2]) if len(sys.argv) > 2
                                else Path(__file__).resolve().parent))
        sys.exit(main())
    except SmokeError as e:
        print(f"error: {e}", file=sys.stderr)
        sys.exit(1)
