"""PredictionGen pipeline driver (counterpart:
``montecarlooptionspricer_tpu/pipeline/driver.py``).

Host: parse and validate rows, fetch each row's spot history, the 20-day
vol and momentum, and the rough-vol parameters (scalar float64 work).
Device: rows are bucketed by (n_pad, m1) = (next_pow2(steps),
next_pow2(steps + 1)) and priced in batches, each row building its own
[num_paths, n_pad + 1] rBergomi block and running the four estimators,
with its true step count, option type and contract as per-row tensors.
A batch is one set of launches per step across its rows.

Each row's draws come from its own generator seeded from (seed, row
index), and the estimators' sums are batch-independent
(``ops.reductions.row_sum``), so a row's prices do not depend on the
batch it lands in: a resumed run writes the same bytes as a one-shot run.
Under ``PricingConfig.qmc`` the paths are randomized QMC: one scrambled
Sobol base per (num_paths, 3 n_pad) bucket, and each row's digital shift
drawn first from the row's own generator
(``rough_volatility.qmc_bucketed_noise``), so resumes stay byte-equal.

Under a ``mesh`` (``parallel.mesh.Mesh``; counterpart: the ``mesh=`` of
the JAX pipeline) every rank runs the pipeline: the host pass on every rank, and
each batch, rounded up to a multiple of the mesh size, split into one
contiguous slice of rows a rank.  The ranks price their rows with no
cross-rank reduction, and one collective gathers the batch's prices on
every rank.  Rank 0 alone writes the CSV, the error log, the diagnostic
dump, the backup and the resume state; the others write nothing.  A
batch that fails on any rank fails on all of them, and the ranks agree on
termination before each batch, so they stay in step; a failed collective
raises out of ``run_pipeline``.

Failure containment follows the reference: a sentinel ",0,0,0,0,0,0" line
for a row that fails validation or pricing, an error count, the health
watchdog and heartbeat, signal handlers, a backup of earlier output,
ordered incremental writes and the spot-data diagnostic dump.  The signal
handlers and the watchdog's threads end with ``run_pipeline``.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import shutil
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import (AUGMENTED_COLUMNS, MarketDefaults, PipelineConfig,
                      PricingConfig)
from ..models import rough_volatility
from ..models.branching import BranchIndices
from ..models.pricing import PricerSpec, price_all
from ..ops import estimators
from ..ops import qmc as qmc_ops
from ..ops.fgn import next_pow2
from ..ops.reductions import gather_ranks, psum_if
from ..ops.rng import generator_for_row
from ..parallel.mesh import mesh_device
from ..utils.profiling import span
from . import csv_io, spot as spot_mod
from .watchdog import ProcessStats, Watchdog, install_signal_handlers
from .writer import OrderedResultWriter, SafeFileWriter

log = logging.getLogger(__name__)

SENTINEL = ",0,0,0,0,0,0"
RESUME_MARKER_SUFFIX = ".resume"


@dataclasses.dataclass
class RowTask:
    """A validated row ready for device pricing."""

    index: int
    line: str
    n_steps: int
    is_call: bool
    s0: float
    xi: float
    h: float
    eta: float
    rho: float
    strike: float
    maturity: float
    sigma: float
    dividend: float
    twenty_day_vol: float
    twenty_day_momentum: float


@dataclasses.dataclass
class RowResult:
    index: int
    line: str
    values: Tuple[float, float, float, float, float, float]

    def format(self) -> str:
        return self.line + "," + ",".join(_fmt(v) for v in self.values)


def _fmt(v: float) -> str:
    """Compact float formatting comparable to C++ operator<< defaults."""
    if v == 0.0:
        return "0"
    return f"{v:.6g}"


def _parse_row(index: int, line: str, tokens: List[str],
               spot_data: spot_mod.SpotData, market: MarketDefaults,
               error) -> Tuple[Optional[RowTask], Optional[str]]:
    """The reference's validation chain.  Returns (task, None) on success,
    (None, reason) for a sentinel row, and (None, "") for the no-history
    case (zeros appended, not an error)."""
    if len(tokens) < 15:
        return None, "Insufficient columns"
    try:
        underlying_last = float(tokens[3])
        dte_val = float(tokens[4])
        strike_dist_pct = float(tokens[5])
    except (ValueError, TypeError) as e:
        return None, f"Number parsing error: {e}"
    if (not np.isfinite(underlying_last) or not np.isfinite(dte_val)
            or not np.isfinite(strike_dist_pct) or underlying_last <= 0.0
            or dte_val <= 0.0 or not -1.0 <= strike_dist_pct <= 1.0):
        return None, "Invalid numeric input(s)."
    ticker = tokens[0]
    try:
        option_type = int(tokens[1])
    except (ValueError, TypeError):
        return None, "optionType parse error."
    quote_date = spot_mod.parse_date_mmddyyyy(tokens[2])

    idte = int(dte_val)
    hist = (spot_mod.fetch_spot_history(spot_data, ticker, quote_date, idte)
            if quote_date is not None else [])
    if not hist:
        return None, ""
    if len(hist) < 2:
        hist.append(underlying_last)
    if not all(np.isfinite(h) for h in hist):
        return None, "Non-finite values in spotHist. Skipping."

    vol, momentum = spot_mod.twenty_day_vol_and_momentum(hist)

    maturity = dte_val / market.calendar_days
    is_call = option_type == 1
    strike = underlying_last * (1.0 - strike_dist_pct)
    sigma = vol
    dividend = market.dividend
    try:
        dividend = float(tokens[14])
    except (ValueError, TypeError):
        error(f"Row {index}: 'dividend' parse error. Using default "
              f"{market.dividend}")

    n_steps = int(math.floor(maturity * market.trading_days))
    if n_steps < 1:
        return None, "No time steps => skipping pricer to avoid error."
    if sigma <= 0.0:
        # The reference's asymptotic pricer throws, and the row's catch
        # zeroes the whole row.
        return None, ("Exception inside pricer calls: Volatility must be "
                      "positive.")
    try:
        params = estimators.estimate_params(np.asarray(hist), r=market.r)
    except (ValueError, FloatingPointError) as e:
        return None, f"Exception inside pricer calls: {e}"

    return RowTask(index=index, line=line, n_steps=n_steps, is_call=is_call,
                   s0=params.s0, xi=params.xi, h=params.h, eta=params.eta,
                   rho=params.rho, strike=strike, maturity=maturity,
                   sigma=sigma, dividend=dividend, twenty_day_vol=vol,
                   twenty_day_momentum=momentum), None


class BatchFailed(RuntimeError):
    """A batch whose pricing failed on some rank of a mesh: every rank
    raises it after the batch's gather, so the ranks stay in step."""


def bucket_key(n_steps: int) -> Tuple[int, int]:
    """A row's bucket (n_pad, m1): n_pad = next_pow2(n_steps) is the
    reference's circular-convolution length, the same across the bucket,
    so padding rows to it is exact; m1 = next_pow2(n_steps + 1) splits off
    the rows whose step count is a power of two."""
    return next_pow2(n_steps), next_pow2(n_steps + 1)


class BatchedPricer:
    """Prices a bucket's rows in padded batches on one device, or under
    ``mesh`` on every rank's device, each rank its slice of a batch.

    ``price`` draws each row's noise from the row's own generator and calls
    ``price_from_noise``, the seam that the tests and the card check drive
    with injected noise.  ``batch_seconds`` keeps the wall seconds of each
    batch by bucket, the device synchronized at its end."""

    def __init__(self, pricing: PricingConfig, market: MarketDefaults,
                 device="cuda", mesh=None):
        device = mesh_device(mesh, device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu'")
        self.pricing = pricing
        self.market = market
        self.device = device
        self.mesh = mesh
        self.rank = 0 if mesh is None else mesh.rank
        self.batch_seconds: Dict[Tuple[int, int], List[float]] = {}

    def _batch_size(self, n: int) -> int:
        """The batch for a call of n rows: rows_per_batch for full chunks,
        else the next power of two with a floor of min(8, rows_per_batch),
        so a sparse bucket's tail pays at most ~2x its rows.  Under a mesh
        every batch rounds up to a multiple of its size (rows_per_batch
        need not divide it)."""
        full = self.pricing.rows_per_batch
        batch = full if n >= full else min(full, max(next_pow2(n),
                                                      min(8, full)))
        if self.mesh is not None:
            d = self.mesh.size
            batch = -(-batch // d) * d
        return batch

    def agree(self, flag: bool) -> bool:
        """``flag`` on any rank of the mesh (``flag`` itself without one):
        the ranks' common decision, e.g. to stop."""
        if self.mesh is None:
            return flag
        t = torch.tensor([float(flag)], device=self.device)
        return bool(psum_if(t, self.mesh.group).item() > 0)

    def price(self, tasks: List[RowTask], base_seed: int) -> np.ndarray:
        """[len(tasks), 4] prices (asymptotic, branching, lsm, martingale)
        of rows of one bucket, padded to ``_batch_size`` rows with copies
        of the first.  Under a mesh each rank prices its slice
        (``price_shard``) and one collective gathers the batch: a pricing
        failure on any rank raises ``BatchFailed`` on every rank, and any
        other exception is the collective's own."""
        if self.mesh is None:
            return self.price_shard(tasks, base_seed)[:len(tasks)] \
                .cpu().numpy()
        try:
            shard, err = self.price_shard(tasks, base_seed), None
        except Exception as e:  # noqa: BLE001 - carried to every rank
            shard, err = None, e
        per = len(self._shard_rows(tasks))
        local = torch.zeros((per, 5), dtype=torch.float64,
                            device=self.device)
        if shard is None:
            local[:, 4] = 1.0               # this rank's failure flag
        else:
            local[:, :4] = shard.to(torch.float64)
        every = gather_ranks(local, self.mesh.group).reshape(-1, 5)
        bad = np.flatnonzero(every[::per, 4].cpu().numpy())
        if bad.size:
            why = f": {err}" if err is not None else ""
            raise BatchFailed(f"pricing failed on rank(s) {bad.tolist()}"
                              f"{why}") from err
        return every[:len(tasks), :4].cpu().numpy().astype(np.float32)

    def share(self, value: int) -> int:
        """Rank 0's ``value`` on every rank of the mesh (``value`` itself
        without one)."""
        if self.mesh is None:
            return value
        t = torch.tensor([float(value if self.rank == 0 else 0)],
                         dtype=torch.float64, device=self.device)
        return int(psum_if(t, self.mesh.group).item())

    def _shard_rows(self, tasks: List[RowTask]) -> List[RowTask]:
        """This rank's contiguous slice of the padded batch (all of it
        without a mesh)."""
        n = len(tasks)
        padded = tasks + [tasks[0]] * (self._batch_size(n) - n)
        if self.mesh is None:
            return padded
        per = len(padded) // self.mesh.size
        return padded[self.rank * per:(self.rank + 1) * per]

    def price_shard(self, tasks: List[RowTask],
                    base_seed: int) -> torch.Tensor:
        """[rows of this rank's slice, 4] prices (asymptotic, branching,
        lsm, martingale) on the device, of the padded batch of ``tasks``
        (all of it without a mesh)."""
        if not tasks:
            raise ValueError("no rows to price")
        t0 = time.perf_counter()
        n_pad, _ = bucket_key(tasks[0].n_steps)
        padded = self._shard_rows(tasks)
        p = self.pricing
        gens = [generator_for_row(base_seed, t.index, self.device)
                for t in padded]
        if p.qmc:
            shifts = torch.stack([qmc_ops.draw_shift(g, 3 * n_pad)
                                  for g in gens])
            zc, dw = rough_volatility.qmc_bucketed_noise(
                qmc_ops.base_bits(p.num_paths, 3 * n_pad, self.device),
                shifts, n_pad, self.market.dt)
        else:
            n_draw = p.num_paths // 2 if p.antithetic else p.num_paths
            zc, dw = rough_volatility.draw_bucketed_noise(
                gens, n_draw, n_pad, self.market.dt)

        def branch_plane(b: int) -> torch.Tensor:
            del b      # each row's generator yields its branches in order
            return torch.stack([
                torch.randint(0, p.num_paths, (p.num_paths, n_pad),
                              generator=g, device=self.device)
                for g in gens])

        out = self.prices_from_noise(padded, zc, dw, branch_plane)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.batch_seconds.setdefault(bucket_key(tasks[0].n_steps), []).append(
            time.perf_counter() - t0)
        return out

    def price_from_noise(self, tasks: List[RowTask], zc: torch.Tensor,
                         dw: torch.Tensor, rp: BranchIndices) -> np.ndarray:
        """``prices_from_noise`` on the host (numpy)."""
        return self.prices_from_noise(tasks, zc, dw, rp).cpu().numpy()

    def prices_from_noise(self, tasks: List[RowTask], zc: torch.Tensor,
                          dw: torch.Tensor,
                          rp: BranchIndices) -> torch.Tensor:
        """[len(tasks), 4] prices of rows of one bucket from injected
        noise: ``zc`` [rows, n_draw, n_pad] complex, ``dw`` [rows, n_draw,
        n_pad] Brownian increments with their sqrt(dt) scale (n_draw =
        num_paths, or half of it under antithetic; under qmc the planes of
        ``rough_volatility.qmc_bucketed_noise``), and ``rp`` the branch
        indices ([rows, num_paths, n_pad, num_branches], or a callable of
        the branch)."""
        n_pad, m1 = bucket_key(tasks[0].n_steps)
        if any(bucket_key(t.n_steps) != (n_pad, m1) for t in tasks):
            raise ValueError("rows of one batch must share a bucket")
        p, mkt, dev = self.pricing, self.market, self.device

        def col(name, dtype=torch.float32):
            return torch.tensor([getattr(t, name) for t in tasks],
                                dtype=dtype, device=dev)

        n_steps = col("n_steps", torch.int64)
        paths = rough_volatility._bucketed_paths_from_noise(
            col("s0"), col("xi"), col("h"), col("eta"), mkt.r, n_steps,
            n_pad, m1, zc.to(dev), dw.to(dev), mkt.dt,
            antithetic=p.antithetic)
        spec = PricerSpec(r=mkt.r, strike=col("strike"),
                          maturity=col("maturity"), dt=mkt.dt,
                          is_call=col("is_call", torch.bool),
                          sigma=col("sigma"), dividend=col("dividend"),
                          num_branches=p.num_branches,
                          poly_order=p.poly_order,
                          max_iterations=p.max_iterations)
        if isinstance(rp, torch.Tensor):
            rp = rp.to(dev)
        return price_all(paths, spec, rp, n_steps=n_steps)


def _resume_row_count(output_csv: str, expected_header: str) -> int:
    """Completed data rows in a previous run's output, or 0 when the file
    is absent or foreign (header mismatch).  Two crash states are
    truncated rather than counted, so the append-mode writer never merges
    onto a corrupt tail:

    * a partial trailing line (no newline) from a mid-write kill;
    * a trailing run of sentinel rows, which a signal-interrupted run
      writes for every row it did not price.  Trailing sentinels are
      re-processed: either they were such fills, or they are
      deterministic validation failures that repricing rewrites.

    A gracefully terminated run may flush priced high-index rows after
    its fills (buckets price out of row order), so it records its first
    filled row in a ``<output>.resume`` sidecar; when present, every row
    from there on is re-processed and the file truncated there."""
    if not os.path.exists(output_csv):
        return 0
    cap = None
    try:
        with open(output_csv + RESUME_MARKER_SUFFIX) as mf:
            cap = max(0, int(mf.read().strip()))
    except (OSError, ValueError):
        cap = None
    try:
        with open(output_csv, "r+") as f:
            header = f.readline()
            if header.rstrip("\n") != expected_header:
                return 0
            done = 0            # rows up to (incl.) the last non-sentinel
            offset = f.tell()   # byte offset just past that row
            run = 0             # current trailing sentinel run
            row = 0             # 0-based index of the line about to scan
            for line in iter(f.readline, ""):
                if not line.endswith("\n"):
                    break       # partial tail from a mid-write crash
                if cap is not None and row >= cap:
                    break       # fill region: redo from here
                row += 1
                if line.rstrip("\n").endswith(SENTINEL):
                    run += 1
                    continue
                done += run + 1
                run = 0
                offset = f.tell()
            end = f.seek(0, os.SEEK_END)
            if end != offset:
                f.truncate(offset)
            return done
    except OSError:
        return 0


def run_pipeline(config: Optional[PipelineConfig] = None,
                 pricing: Optional[PricingConfig] = None,
                 market: Optional[MarketDefaults] = None,
                 mesh=None, resume: bool = False, device="cuda",
                 timings: Optional[dict] = None) -> int:
    """The PredictionGen main: augment ``config.option_csv`` into
    ``config.output_csv`` on ``device``.  Returns the process exit code.
    ``timings``, when given, receives the host pass's seconds (parse and
    estimate), the device pass's, and each bucket's batch seconds keyed
    "n_pad/m1".  Under ``mesh`` every rank calls it with the same
    arguments; rank 0 writes every file (module docstring)."""
    config = config or PipelineConfig()
    pricing = pricing or PricingConfig()
    market = market or MarketDefaults()
    pricer = BatchedPricer(pricing, market, device, mesh)

    stats = ProcessStats(config)
    error_log = SafeFileWriter(config.error_log if pricer.rank == 0
                               else os.devnull)
    restore_signals = install_signal_handlers(stats, error_log.write)
    try:
        return _run(config, pricing, market, resume, pricer, stats,
                    error_log, timings)
    finally:
        restore_signals()
        error_log.close()


def _run(config: PipelineConfig, pricing: PricingConfig,
         market: MarketDefaults, resume: bool, pricer: BatchedPricer,
         stats: ProcessStats, error_log: SafeFileWriter,
         timings: Optional[dict]) -> int:
    writes = pricer.rank == 0
    spot_data = spot_mod.load_spot_prices(config.spot_csv)
    try:
        with open(config.diagnostic_csv if writes else os.devnull,
                  "w") as diag:
            diag.write("Ticker,Date,Price\n")
            for ticker, daily in spot_data.items():
                for ymd, px in daily.items():
                    diag.write(f"{ticker},{ymd},{px:g}\n")
    except OSError as e:
        log.error("Failed to open %s: %s", config.diagnostic_csv, e)

    try:
        header, raw_rows = csv_io.read_table(config.option_csv)
    except (OSError, ValueError) as e:
        log.error("Failed to open %s: %s", config.option_csv, e)
        return 1
    if not raw_rows:
        log.error("No data lines found in %s.", config.option_csv)
        return 1
    total_rows = len(raw_rows)

    out_header = ",".join(header) + "," + ",".join(AUGMENTED_COLUMNS)
    done_rows = pricer.share(
        _resume_row_count(config.output_csv, out_header)
        if resume and writes else 0)
    out_csv = config.output_csv if writes else os.devnull
    if writes:
        # The marker, if any, was read above; drop it so it cannot mislead
        # a later run against fresh output.
        try:
            os.remove(config.output_csv + RESUME_MARKER_SUFFIX)
        except OSError:
            pass
        # Back up earlier output before truncating it: foo.csv ->
        # foo.backup.csv.  Skipped only for a genuine resume.
        if os.path.exists(config.output_csv) and done_rows == 0:
            try:
                base, _ = os.path.splitext(config.output_csv)
                shutil.copyfile(config.output_csv,
                                base + config.backup_suffix)
            except OSError:
                pass
    if done_rows:
        log.info("Resuming: %d/%d rows already in %s", done_rows, total_rows,
                 config.output_csv)
        result_file = SafeFileWriter(out_csv, mode="a")
    else:
        result_file = SafeFileWriter(out_csv)
        result_file.write(out_header + "\n")
    writer = OrderedResultWriter(result_file, total_rows,
                                 start_index=done_rows)
    watchdog = Watchdog(stats, error_log.write,
                        progress=lambda: writer.next_row_to_write)
    watchdog.start()
    try:
        first_fill = _price_rows(raw_rows, done_rows, spot_data, pricing,
                                 market, pricer, stats, error_log, writer,
                                 timings)
        writer.flush_remaining()
    finally:
        watchdog.stop()
        result_file.close()
    # A terminating run records where its fills began, so a later resume
    # re-processes from there; a clean finish leaves no marker.
    if writes and stats.catastrophic_failure and first_fill is not None:
        try:
            with open(config.output_csv + RESUME_MARKER_SUFFIX, "w") as mf:
                mf.write(f"{first_fill}\n")
        except OSError:
            pass
    if stats.error_count > 0:
        log.warning("Completed with %d errors. Check %s", stats.error_count,
                    config.error_log)
    if stats.catastrophic_failure:
        log.error("Process failed: %s", stats.failure_reason)
        return 1
    log.info("Done. Wrote %s with new columns.", config.output_csv)
    return 0


def _price_rows(raw_rows, done_rows: int, spot_data: spot_mod.SpotData,
                pricing: PricingConfig, market: MarketDefaults,
                pricer: BatchedPricer, stats: ProcessStats,
                error_log: SafeFileWriter, writer: OrderedResultWriter,
                timings: Optional[dict]) -> Optional[int]:
    """The host pass, then the device pass by bucket.  Returns the lowest
    row index filled with a sentinel because the run was terminating."""
    first_fill: Optional[int] = None

    def fill(idx: int, line: str) -> None:
        nonlocal first_fill
        first_fill = idx if first_fill is None else min(first_fill, idx)
        writer.put(idx, line + SENTINEL)

    def log_row_error(index: int, msg: str) -> None:
        error_log.write_line(f"Row {index}: {msg}")

    def terminating() -> bool:
        return stats.should_terminate.is_set() or stats.catastrophic_failure

    # Host pass: validate and feature-engineer every row, and bucket the
    # priceable ones by (n_pad, m1).
    buckets: Dict[Tuple[int, int], List[RowTask]] = {}
    t_host = time.perf_counter()
    for idx, tokens in enumerate(raw_rows):
        line = ",".join(tokens)
        if idx < done_rows:
            continue
        # Under a mesh the ranks stop together, at a batch (below).
        if pricer.mesh is None and terminating():
            fill(idx, line)
            continue
        error_log.write_line(f"Starting row {idx}")
        try:
            task, reason = _parse_row(idx, line, tokens, spot_data, market,
                                      error_log.write_line)
        except Exception as e:  # noqa: BLE001 - the row's catch-all
            log_row_error(idx, f"Unexpected error: {e}")
            writer.put(idx, line + SENTINEL)
            stats.add_error()
            continue
        if task is None:
            if reason:          # a validation failure: sentinel and count
                log_row_error(idx, reason)
                stats.add_error()
            writer.put(idx, line + SENTINEL)
            continue
        buckets.setdefault(bucket_key(task.n_steps), []).append(task)
    host_s = time.perf_counter() - t_host

    # Device pass: price the buckets in batches.
    n_priceable = sum(len(v) for v in buckets.values())
    processed = 0
    t_dev = time.perf_counter()
    for (n_pad, _m1), tasks in sorted(buckets.items()):
        b = pricing.rows_per_batch
        for i in range(0, len(tasks), b):
            chunk = tasks[i:i + b]
            if pricer.agree(terminating()):
                for t in chunk:
                    fill(t.index, t.line)
                continue
            try:
                with span(f"price_batch[{n_pad}x{len(chunk)}]"):
                    values = pricer.price(chunk, pricing.seed)
            except Exception as e:  # noqa: BLE001 - a batch's failure
                if pricer.mesh is not None and not isinstance(e,
                                                              BatchFailed):
                    raise       # a collective failed: the ranks are apart
                stats.fail(f"Thread error: {e}")
                error_log.write_line(f"Thread error: {e}")
                for t in chunk:
                    fill(t.index, t.line)
                continue
            for t, row_vals in zip(chunk, values):
                if not np.all(np.isfinite(row_vals)):
                    log_row_error(t.index,
                                  "Invalid path dimension or inf/nan found.")
                    writer.put(t.index, t.line + SENTINEL)
                    stats.add_error()
                    continue
                writer.put(t.index, RowResult(
                    t.index, t.line,
                    (float(row_vals[0]), float(row_vals[1]),
                     float(row_vals[2]), float(row_vals[3]),
                     t.twenty_day_vol, t.twenty_day_momentum)).format())
            processed += len(chunk)
            log.info("Progress: %d/%d priceable (%.2f%%)", processed,
                     n_priceable, 100.0 * processed / max(n_priceable, 1))
    if timings is not None:
        timings.update(
            host_s=host_s, device_s=time.perf_counter() - t_dev,
            buckets={f"{n_pad}/{m1}": list(secs) for (n_pad, m1), secs
                     in sorted(pricer.batch_seconds.items())})
    return first_fill
