#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA card and check it.

Run from the repository root, with one card visible:

    python3 chip_smoke.py

Phases:
  1. set-up: the card's name and power limit (nvidia-smi), versions, the
     kernel build from ``iv_interpolation_tpu_torch/csrc`` and the pinned
     float32 matmul precision;
  2. each CUDA kernel against its plain PyTorch version on the card, at
     every shape the main paths give it and at the edges of its launch
     plan (B1: n=1 and 2, float64, the partitioned route of n beyond the
     staged tiles and the global-scratch route beyond its tiles; B2: int64
     minutes beyond int32, shuffled rows, NaN/Inf payloads, negative
     minutes, scalar loads, the tile loop; B2 once more with float64
     values, every case and the three timed shapes; in float32 also timed
     at the served refits' shapes, 256 rows, and at ``window_candles``'
     shape, 1,024 x 8,192 -> 1,640); at each main-path
     shape the
     device time of the wrapper and of the plain call (each replayed from
     a CUDA graph), the bound (bytes or operations this call's inputs need
     over the card's peak rates), the share of it, and the library call
     where one computes the same function (B1: ``torch.linalg.solve`` on
     the dense systems; B2: none); B1 also times its global-scratch
     kernel (one thread a system) in turns with the planned route, and on
     the partitioned route holds the kernel to its own plain version and
     times each systems-a-block count and both solvers of the reduced
     system (PCR, Thomas);
  3. the surface step: ``fit_eval_surface`` (cubic spline, not-a-knot) on
     32768 surfaces of 30 x 50 quotes, held to SciPy on a sub-batch;
  4. the streaming refit: a ``StreamingSession`` over 1024 underlyings
     (30 x 50 chains, 512-minute window, 8192-tick rings), held to the same
     session on CPU tensors, then one ``run_stream_replay``;
  5. the fused task pipeline: 2,048 option symbols x 7 days of hourly rows
     through ``pipeline.runner.fused_batch`` (interpolate + greeks ->
     bridge -> quality gate -> 5-min candles) in 8 batches of 256, then one
     cubic batch; every batch checked for OHLC integrity, the quality
     gate, candle counts and volume preservation, and launching B2 once
     (the cubic one B1 too); then B2 on a real batch's candle stage
     against its plain version, the stage timed from a CUDA graph with
     its int64 minutes, and batch 0 and the cubic one against the
     same batches on CPU tensors; (a) the 30-day cubic batch (256 symbols
     x 721 hourly rows, the config's 30-day span, in the 65,536-minute
     bucket: B1 at n=719 x 768 on the partitioned route) in float32 and
     float64, its first 32 symbols against CPU tensors;
  6. the host runner: the same 2,048 symbols x 7 days (from the port's
     sample generator) through ``PipelineRunner.run_pipeline_fused`` from
     a store to the three tables (parquet when pyarrow imports, else
     memory): output rows/s, host seconds by phase, the device's idle
     share, peak memory; every symbol completed or skipped, row counts
     equal to the manifests', the result audits, one B2 launch a batch,
     the first batch's symbols against a CPU run; at 512 symbols x 2 days a
     stopped-and-resumed run and a staged ``run_all`` against the fused
     tables and a cubic run (B1 once a sub-batch); a float64 run
     (``processing.dtype="float64"``, 256 symbols in 4 batches: B2 float64
     once a batch, no symbol in error, held to the same run on CPU
     tensors); the CLI in a subprocess; (b) a 30-day cubic run (64
     symbols x 721 hours, 10 % dropped, split into sub-batches of one
     observation count) in float32 and float64 from a parquet store, every
     B1 launch on the partitioned route, 16 symbols against CPU tensors;
  7. the surface task: an ``interpolated`` table of 256 underlyings (192
     of 12 expiries x 32 strikes, 64 of 6 x 16, call and put, two
     snapshots a symbol, about 2 % of the latest rows marked by price
     only) in a parquet store, through ``run_surface_fit`` on the card
     with the cubic spline (B1 float32), the smoothing spline, parity mode
     (B1 float64) and local vol: host seconds by phase, surfaces/s, idle
     share, peak memory, B1 launches by dtype, no plain version called;
     each run against the same run on CPU tensors, parity mode against
     SciPy's float64 spline on 32 surfaces, the surface audit, and the
     CLI (``--task surface`` exits 0, and so does ``--method svi``);
  8. serving: ``run_serve`` over phase 7's store (its 256 underlyings'
     chains), a client's ticks, flush, 7 refits (median reply latency),
     stats and stop; the refits against a CPU session fed the same ticks,
     B2 twice a refit; the same over Arrow Flight where it imports;
  9. the calibrated families at 1,024 surfaces x 30 expiries x 50 quotes,
     float32, noise 1e-4: (a) ``fit_svi_batched`` on the 30,720 slices
     (quasi init, 32 iterations; again with the butterfly hinge and with
     the Huber loss; the first runs the raw-SVI kernel, ``svi_lm.cu``,
     which is held bit for bit to its plain version on the card and to the
     generic loop at the same shape, then timed at 32,768 surfaces beside
     its bound and the plain version), (b) ``fit_essvi_batched`` with the
     block solver, and
     the dense solver on 256 surfaces (each call's counters checked and
     printed: one call of that solver), (c) ``fit_sabr_batched`` on 30,720
     slices, (d) ``fit_eval_surface`` for the three methods, (e)
     ``greek_surfaces`` on (d)'s grids; each held to the same call on CPU
     tensors at 64 surfaces and to the generating smile, and timed (ms a
     fit, ms an LM iteration, slices/s or surfaces/s, peak memory, device
     launches a fit from ``torch.profiler``); (f) phase 7's store through
     ``run_surface_fit`` with svi, essvi and sabr;
 10. Andreasen-Huge and RBF: (a) ``fit_eval_ah_surface`` at 512 surfaces
     x 8 expiries x 16 quotes with an ATM spike (grid 257, 16 iterations,
     float32): surfaces/s over CUDA events and host time, B1 launches a
     fit by dtype and batch (512 and 8,192), device launches and idle
     share, peak memory, every surface arbitrage-free, 64 surfaces against
     CPU tensors; (b) the same 64 in float64 (B1's partitioned route,
     every launch) against CPU float64 within 1e-10 in price; (c) ``eval_ah`` at 64 x 64
     scattered queries; (d) RBF penalized at 8 x 2,048 (every site a
     center) and 64 x 2,048 on 512 centers, 24 iterations, and the
     zero-penalty path at 8 x 2,048 in float64 against CPU float64; (e)
     phase 7's store through ``run_surface_fit`` with ah and rbf, every 8th
     underlying against CPU tensors; (f) ``--task surface --method ah
     --profile`` (a ``torch.profiler`` trace), ``--validate-only`` and
     ``--estimate`` from the CLI;
 11. the operator's pieces: (a) ``ringbuffer.window_candles`` on a wrapped
     float32 ring of 1,024 streams x 5 channels x 8,192 slots with
     per-stream first minutes, one B2 launch, against its plain version on
     the card and the same ring on CPU tensors; the smoothing spline's
     penalty search (``fit_smoothing_spline_autolam``) at 1,024 x 30 slices
     with 8 penalties against CPU tensors; (b) the ``--shard`` proofs
     (``parallel/shardproof``): two shard processes on the card at once over
     one parquet store, then one killed mid-run and resumed, each against
     the unsharded run (every column exact but the 5-minute volume, within
     8 eps32); (c) the loopback PostgreSQL mock server
     (``tests/pg_mock_server.py``, loaded by path): ``--check-db --storage
     postgres`` in a subprocess, and a ``PipelineRunner`` on a
     ``PostgresStore`` against the same run on a parquet store; (d) ``--task
     pipeline --with-monitor`` in a subprocess: the side dashboard prints a
     frame and never touches the card (not among ``nvidia-smi``'s compute
     processes, no CUDA driver mapped), then ``--monitor``; (e)
     ``--visualize`` over phase 7's store (local vol) and (c)'s run; (f) a
     ``SurfaceFit`` checkpoint restored to the card and to the CPU;
 12. the device mesh (``parallel/mesh.py`` over ``torch.distributed``
     ranks): (a) a world of one rank over NCCL in this process (file
     rendezvous): ``sharded_masked_interp``'s local form and all-gather on a
     (1, 1) mesh at 128 series x 4 columns x 2^19 minutes, about 80 %
     missing, gaps across the chunk seam, equal to ``masked_interp`` bit
     for bit, fill and all-gather timed by CUDA events; (b) one launched
     world of two ranks sharing the card over gloo, each rank with its
     launch counts: the same timeline at 2^18 minutes a rank (its chunk
     equal to ``masked_interp``'s, the gathered whole to (a)'s); the fused
     runner at 1,024 symbols x 168 hourly rows, 256 a batch, on a parquet
     store with mesh (2,) (tables equal to a one-rank run's, every column
     exact but the 5-minute volume within 8 eps32; B2 once a batch on
     each rank; rows/s, host seconds by phase, each rank's peak); phase
     7's store through ``run_surface_fit`` with cubic_spline (exact) and
     ah (phase 10's tolerance), B1 by rank and dtype; a ``StreamingSession``
     of STREAM's universe for 7 refits (flags exact, grids within phase
     4's tolerance, B2 twice a refit on each rank); the dry run's proofs
     2-3; (c) the CLI under ``torch.distributed.run --standalone
     --nproc-per-node 2``: ``--task pipeline`` with
     ``IVTPU_PROCESSING__MESH_SHAPE=2`` (exit 0, one JSON summary, the
     one-rank run's tables) and ``--task serve`` over phase 7's store
     (a client's ticks, refit, stats and stop). Two ranks on one card
     measure correctness and overhead, not scaling.
 13. the library entry point: (a) ``quickstart.main()``, the port's
     library tour, on the card in float32 (B1 float32 and B2 launches
     counted and required; each section's wall seconds, cold and warm) and
     float64, each held to the same call on CPU tensors at
     ``quickstart.TOLERANCES`` with flags exact; the top-level
     ``iv_interpolation_tpu_torch.fit_eval_surface`` is the surface
     module's and gives phase 3's output bit for bit; (b) the reference's
     parallel cyclic reduction (``ops.tridiag.tridiag_solve_pcr``) timed
     against B1 at every phase-2 main-path shape (CUDA graphs of 10 calls,
     in turns) with max |PCR - B1| / max |x|; (c) the native host packer
     built on this machine, bit-exact against NumPy at phase 6's runner
     batch, both times. Phase 6 also fails unless its float32 run gathered
     its rows with the native packer.
 14. the bench harness: (a) ``python -m iv_interpolation_tpu_torch.bench``
     at full size in a subprocess (its state file under ``build/``): the
     one line parses with bench.py's keys and no incomplete metric, names
     the card and its power limit, the clean butterfly fraction is 1.0 and
     the adversarial one <= 0.05, the fast path within 5e-6 of SciPy and
     parity mode within 1e-9, AH all arbitrage-free, B1 float64 launched
     in the parity stage, B1 float32 in the AH stage and B2 in the
     streaming stage (the state file's counts); each stage's value, host
     and event medians and peak memory, beside phases 3, 4, 9 and 10's
     figures at the same shapes; (b) ``graft_entry.entry()``'s forward
     step once on the card (B1 float32), held to the same step on CPU
     tensors.

``--phases 2,9`` (development only) runs the named phases after the
build and prints no result line. ``--mesh-rank ARGS`` is phase 12's rank
body (the script launches it; not for a caller).

B1 and B2 are each listed twice in the kernel line, float32 and float64,
each with its launches on every path; B2 float32's include
``window_candles`` and the PostgreSQL-backed run of phase 11, and the
mesh's runner and session of phase 12 (both ranks' launches), B1
float32's the mesh's surface task and dry run; phase 13 adds the
quickstart's B1 and B2 launches (float32 and float64) and the top-level
``fit_eval_surface``'s B1; phase 14 the bench's parity (B1 float64), AH
(B1 float32) and streaming (B2) stages, counted in the bench's own
process, and the entry point's B1.

Prints a JSON line of per-kernel results, then as the last line
``{"ok": true, "device": {...}}``. Any failed check raises, so the script
exits non-zero and prints no result; so does a machine without a card or
a directory without the package. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import signal
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

EPS32 = float(np.finfo(np.float32).eps)
EPS64 = float(np.finfo(np.float64).eps)
DEV = "cuda"

# phase 2's B1 cases (n, batch, dtype): every main-path shape, then the
# edges (n=1 and 2, a batch that is no multiple of 4, float64, the
# partitioned route of n beyond the staged tiles and the global-scratch
# route beyond the partitioned tiles). n=48 at 983,040 is the not-a-knot
# reduced system of the surface step (32768 x 30 smiles); n=166 at 768
# the pipeline's cubic batch (168 hourly knots, 256 x 3); n=719 at 768
# the 30-day cubic batch (721 hourly knots, the config's max_span_days,
# 256 x 3: the partitioned route, float32 and, in phase 5 (a)'s float64
# run, float64); n=SUB_N at 48 a sub-batch of phase 6 (b)'s 30-day
# runner (one observation count, 1-16 symbols padded to 16, x 3); n=30 at
# 3,072 and n=14 at 512 the surface task's two buckets (192 x 16 slices
# of 32 strikes, 64 x 8 of 16), float32 and, in parity mode, float64; n=6
# and 62 the neighbouring buckets (8 and 64 strikes). n=257 at 512 and
# 8,192 are Andreasen-Huge's step and tangent solves at its bench shape
# (512 surfaces x 16 quotes, surface.ah_grid = 257): the staged route in
# float32, the partitioned route in float64, on the rows of its own step
# systems (B1_AH). n=48 at 983,040 in float64 is the bench's parity stage
# (32768 x 30 smiles in parity mode).
F32, F64 = torch.float32, torch.float64
SUB_N = 646
B1_MAIN = {(48, 983_040, F32): "surface step", (166, 768, F32): "cubic batch",
           (719, 768, F32): "30-day cubic batch", (719, 768, F64): "30-day cubic batch",
           (SUB_N, 48, F32): "30-day runner sub-batch",
           (30, 3072, F32): "surface task 192x16", (14, 512, F32): "surface task 64x8",
           (30, 3072, F64): "surface task parity 192x16",
           (14, 512, F64): "surface task parity 64x8",
           (257, 512, F32): "AH step", (257, 8192, F32): "AH tangents",
           (257, 512, F64): "AH step", (257, 8192, F64): "AH tangents",
           (48, 983_040, F64): "bench parity"}
B1_AH = {(257, 512), (257, 8192)}
B1_CASES = ((48, 983_040, F32, 1.0), (166, 768, F32, 1.0),
            (719, 768, F32, 1.0), (719, 768, F64, 1.0), (SUB_N, 48, F32, 1.0),
            (30, 3072, F32, 1.0), (14, 512, F32, 1.0),
            (30, 3072, F64, 1.0), (14, 512, F64, 1.0),
            (257, 512, F32, 1.0), (257, 8192, F32, 1.0),
            (257, 512, F64, 1.0), (257, 8192, F64, 1.0), (48, 983_040, F64, 1.0),
            (6, 512, F64, 1.0), (6, 3072, F64, 1.0), (14, 3072, F64, 1.0),
            (30, 512, F64, 1.0), (62, 512, F64, 1.0), (62, 3072, F64, 1.0),
            (50, 4096, F64, 1.0), (50, 1000, F32, 1.0),
            (1, 4097, F32, 1.0), (2, 4097, F64, 1.0),
            (257, 4096, F64, 1.0), (500, 2048, F32, 1.0), (1600, 512, F64, 1.0),
            (24, 4096, F32, 1e38))
# the surface task's float64 systems all take the staged route
B1_STAGED_F64 = {(n, batch) for n in (6, 14, 30, 62) for batch in (512, 3072)}
# every shape beyond the staged tiles up to n = 1,000 takes the
# partitioned route; n=1600 in float64 is beyond its tiles (scratch)
B1_SCRATCH = {(1600, 512, F64)}
# scale 1e38: diagonals near float32's largest values, whose reciprocals
# are subnormal and leave the kernel's fast reciprocal (its full-division
# sweep runs); x stays of order 0.1
# B2 (B, L, buckets): the streaming refit's 1-min stage and its 5-min stage
# (1-min candles in, stage 2), and the pipeline's candle stage (256 rows of
# 16,384 one-minute slots, 10,021 of them filled, to 3,278 5-min buckets)
B2_SHAPE = (1024, 4096, 512)
B2_CANDLE = dict(B=256, L=16384, filled=10021, buckets=3278)
SURFACE = dict(B=32768, E=30, N=50, M=50)
STREAM = dict(B=1024, E=30, N=50, W=512, CAP=8192, CHUNKS=8, PER=512)
REPLAY = dict(n_underlyings=1024, window_minutes=512)
# the fused pipeline: 2,048 option symbols x 168 hourly observations (7
# days), about 10 % dropped, packed compact into 8 batches of 256 symbols
# (the production batch size); the 10,021-minute timeline pads to the
# 16,384 length bucket; batches 0 and 7 are also run on CPU tensors
PIPELINE = dict(symbols=2048, hours=168, drop_frac=0.1, batch=256, bucket=16384,
                cpu_batches=(0, 7))
# phase 5 (a), the 30-day cubic batch: 256 symbols x 721 hourly rows (the
# config's max_span_days = 30, hours 0 .. 720), nothing dropped, packed
# into the 65,536 bucket (43,201 minutes): B1 at n=719 x 768 on the
# partitioned route, in float32 and float64; its first 32 symbols also on
# CPU tensors
CUBIC30 = dict(symbols=256, hours=721, bucket=65536, cpu=32, seed=30)
# phase 6, the host runner: the same scale as phase 5 through
# ``PipelineRunner.run_pipeline_fused`` from a store of sample tickers
# (the JAX package's generator, about 10 % dropped) to the three tables,
# production config (float32, linear, 256 a batch, the 16,384 bucket);
# then (d) at 512 symbols x 2 days, 64 a batch (8 batches). The main run
# has 2 batches in flight; the run with 1 in flight is no longer timed
# (the two orders measured within their spread, and the script's time went
# to later phases).
RUNNER = dict(symbols=2048, hours=168, drop_frac=0.1, seed=16, batch=256,
              small_symbols=512, small_hours=48, small_batch=64)
# phase 7, the surface task: 256 underlyings, 192 of 12 expiries x 32
# strikes and 64 of 6 x 16, call and put (159,744 option symbols, two
# snapshots each), about 2 % of the latest rows without iv; 32 parity
# surfaces held to SciPy. Buckets (16, 32) and (8, 16): B1 at n=30 x
# 3,072 and n=14 x 512.
SURFACE_TASK = dict(big=(192, 12, 32), small=(64, 6, 16), nan_frac=0.02, seed=17,
                    sampled=32, n_grid=50, chains=192 * 12 + 64 * 6,
                    grid_rows=(192 * 12 + 64 * 6) * 50)
# phase 8, serving phase 7's store: 64 ticks per underlying over a
# 512-minute window, then 7 refits
SERVE = dict(ticks=64, window=512, refits=7, seed=18)
# phase 6 (b), the 30-day cubic runner: 64 symbols x 721 hourly rows, 10 %
# dropped, 64 a batch, split by observation count into sub-batches of a
# few symbols (each padded to 16: B1 at n about 630-680 x 48), float32
# and float64 from a parquet store; the first 16 symbols also on CPU
# tensors (the CPU's plain loop and 65,536-minute grids take about 1 s a
# sub-batch: the whole 64 would cost the script a minute a dtype)
RUNNER30 = dict(symbols=64, hours=721, drop_frac=0.1, seed=31, batch=64, cpu_symbols=16)
# phase 6's float64 run: 256 symbols x 2 days in 4 batches of 64
RUNNER_F64 = dict(symbols=256, hours=48, batch=64, seed=20)
# phase 9, the calibrated families: 1,024 surfaces x 30 expiries x 50
# quotes on k = linspace(-1.2, 1.2, 50), float32, noise 1e-4, 32 LM
# iterations; 64 surfaces also on CPU tensors (16 for the dense solver,
# which runs on 256 surfaces on the card)
CALIB = dict(B=1024, E=30, N=50, M=50, iters=32, noise=1e-4, cpu=64, dense_B=256,
             dense_cpu=16, seed=19)
# calls a CUDA graph when a kernel is timed: back to back, as a stream of
# launches runs them (one a graph adds a graph launch to every call)
CALLS = 10
# the card's published peaks (NVIDIA H100 SXM data sheet, at 700 W):
# device-memory bytes/s and float32 operations/s outside the tensor cores
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12
# float64 outside the tensor cores (the same data sheet)
F64_OPS_S = 34e12


def module_version(name: str) -> str:
    try:
        return __import__(name).__version__
    except ImportError:
        return "missing"


def check(ok, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def log(*parts) -> None:
    print(*parts, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` in ms over ``reps`` calls, after one warm
    call, from CUDA events."""
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


def device_ms(fn, reps: int, calls: int = 1) -> float:
    """Device time of one ``fn`` call in ms: ``calls`` calls of ``fn`` are
    captured in one CUDA graph and replayed ``reps`` times between CUDA
    events, so the host's launch overhead stays out of the number (eager
    calls of these wrappers are bound by the host, not the card). With
    ``calls=1`` each call also carries one graph launch; with more, the
    calls run back to back as a stream of launches does."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up off the capture, as capture requires
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * calls)


def same_with_nan(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype.is_floating_point:
        return bool(torch.equal(torch.isnan(a), torch.isnan(b))
                    and torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)))
    return bool(torch.equal(a, b))


def timing_row(shape: str, ms: float, plain_ms: float, nbytes: float, ops: float,
               library_ms, ops_s: float = F32_OPS_S, **extra) -> dict:
    """One timed shape: the bound is the larger of the bytes over the
    card's memory rate and the operations over its rate for their type
    (float32 unless ``ops_s`` says otherwise)."""
    byte_ms, op_ms = nbytes / HBM_BYTES_S * 1e3, ops / ops_s * 1e3
    bound = max(byte_ms, op_ms)
    row = {"shape": shape, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
           "bound_by": "bytes" if byte_ms >= op_ms else "operations",
           "share": bound / ms, "library_ms": library_ms, **extra}
    lib = "none" if library_ms is None else f"{library_ms:.4f}"
    log(f"  {shape}: device ms kernel {ms:.4f}, plain {plain_ms:.4f}, bound "
        f"{bound:.4f} ({row['bound_by']}, {nbytes / 1e6:.1f} MB), share {row['share']:.1%}, "
        f"library {lib}" + "".join(f", {k} {v}" for k, v in extra.items()))
    return row


# -- phase 2: kernels against their plain versions ---------------------------

def dense_solve_ms(dl, d, du, b, x, tol: float = 1e-3) -> float | None:
    """``torch.linalg.solve`` on the densified (batch, n, n) systems, 3
    reps, the matrices built outside the timed window; None where the
    card's free memory does not hold the matrix, its LU copy and a margin.
    Its solution is held to the kernel's within ``tol`` of max |x| as a
    check that it solves the same systems. The port never calls it."""
    n, batch = d.shape
    dense_bytes = batch * n * n * d.element_size()
    if 3 * dense_bytes > torch.cuda.mem_get_info()[0]:
        log(f"  library (dense solve) at n={n} batch={batch}: not measured, "
            f"{dense_bytes / 1e9:.1f} GB a copy")
        return None
    A = torch.zeros((batch, n, n), dtype=d.dtype, device=d.device)
    A.diagonal(0, 1, 2).copy_(d.T)
    A.diagonal(1, 1, 2).copy_(du.T[:, :-1])
    A.diagonal(-1, 1, 2).copy_(dl.T[:, 1:])
    rhs = b.T.unsqueeze(-1).contiguous()
    ms = cuda_ms(lambda: torch.linalg.solve(A, rhs), 3)
    dense = torch.linalg.solve(A, rhs)[..., 0].T
    err = float((dense - x).abs().max())
    check(err <= tol * max(1.0, float(x.abs().max())),
          f"the dense solve agrees with the kernel at n={n} ({err:.3e})")
    del A, rhs, dense
    torch.cuda.empty_cache()
    return ms


def ah_systems(n: int, batch: int, dtype, gen):
    """Andreasen-Huge step systems (``ops.andreasen_huge._step_system`` and
    ``_step_rhs``): per system a uniform log-moneyness grid over
    [-3, -1.5] .. [1.5, 3], local variances 0.01-0.6 a node and dt
    0.02-1, built in float64 and cast; the right-hand side an intrinsic
    curve plus time value. Not diagonally dominant at the boundary rows
    (|du_0| = d_0, |dl_{n-1}| = d_{n-1}). Returns (dl, d, du, b), each
    (n, batch)."""
    from iv_interpolation_tpu_torch.ops.andreasen_huge import _step_rhs, _step_system

    u = lambda lo, hi, shape: torch.empty(shape, dtype=F64, device=DEV).uniform_(
        lo, hi, generator=gen)
    lo, hi = u(-3.0, -1.5, (batch, 1)), u(1.5, 3.0, (batch, 1))
    x = lo + (hi - lo) * torch.linspace(0.0, 1.0, n, dtype=F64, device=DEV)
    dl, d, du = _step_system(u(0.01, 0.6, (batch, n)), x, u(0.02, 1.0, (batch,)))
    c_prev = torch.clamp_min(1.0 - torch.exp(x), 0.0) + 0.05 * torch.exp(-x * x)
    return [a.T.to(dtype).contiguous() for a in (dl, d, du, _step_rhs(c_prev, x))]


def tridiag_cases(tridiag, lib) -> dict:
    """B1 against the plain Thomas loop at every case of B1_CASES, then
    timed at the main-path shapes: the kernel on its planned route, the
    global-scratch kernel (one thread a system, which the plan keeps for
    n beyond the partitioned tiles) in turns with it, the plain loop, the
    dense library solve and the bound; on the partitioned route also
    against its own plain version (``tridiag_solve_partitioned_plain``)
    and timed at each systems-a-block count.
    Tolerance: 256 ulps of max |x| (diagonally dominant systems and
    M-matrices: Thomas and the partition method are backward stable with
    error growth O(n eps), and the kernel's fused multiply-adds round each
    step at most one ulp differently from the plain version's separate
    multiply and subtract). The Andreasen-Huge systems of B1_AH are not
    diagonally dominant at their boundary rows, and the same bound holds
    there (measured: 68 ulps in float32 and in float64 on an H100 on the
    staged and scratch routes). Returns, per dtype name, the worst error,
    the first main-path shape's row and every main-path row."""
    gen = torch.Generator(device=DEV).manual_seed(11)
    worst, rows = {"float32": 0.0, "float64": 0.0}, {"float32": [], "float64": []}
    for n, batch, dtype, scale in B1_CASES:
        u = lambda lo, hi: torch.empty((n, batch), dtype=dtype, device=DEV).uniform_(
            lo * scale, hi * scale, generator=gen)
        ah_like = (n, batch) in B1_AH
        if ah_like:
            dl, d, du, b = ah_systems(n, batch, dtype, gen)
        else:
            d, dl, du = (u(2.0, 3.0), u(-0.1, 0.1), u(-0.1, 0.1)) if scale > 1 else (
                u(4.0, 6.0), u(-1.0, 1.0), u(-1.0, 1.0))
            b = torch.randn((n, batch), dtype=dtype, device=DEV, generator=gen) * max(1.0, scale / 10)
        plan = tridiag.thomas_plan(n, dtype, batch)
        routes = dict(tridiag.tridiag_solve_cuda.launches_by_route)
        x = tridiag.tridiag_solve_cuda(dl, d, du, b)
        torch.cuda.synchronize()
        check(tridiag.tridiag_solve_cuda.launches_by_route[plan.route] == routes[plan.route] + 1,
              f"B1 n={n} batch={batch} counted on its route {plan.route}")
        ref = tridiag.tridiag_solve_plain(dl, d, du, b)
        err = float((x - ref).abs().max())
        eps = EPS32 if dtype == torch.float32 else EPS64
        xmax = max(1.0, float(ref.abs().max()))
        bound = 256 * eps * xmax
        extra = {}
        if plan.route == "partitioned":
            part = tridiag.tridiag_solve_partitioned_plain(dl, d, du, b)
            extra["max_abs_err_partitioned_plain"] = float((x - part).abs().max())
            check(extra["max_abs_err_partitioned_plain"] <= bound,
                  f"B1 partitioned kernel agrees with its plain version at n={n} batch={batch}")
        log(f"  B1 n={n} batch={batch} {str(dtype)[6:]}{' x%g' % scale if scale > 1 else ''}"
            f"{' AH systems' if ah_like else ''} "
            f"({plan.route}, {plan.systems} systems a block, "
            f"{plan.smem} B shared): max|kernel-plain|={err:.3e} = {err / xmax / eps:.1f} ulps "
            f"of max|x| (bound 256)" + "".join(f", {k} {v:.3e}" for k, v in extra.items()))
        check(err <= bound and bool(torch.isfinite(x).all()),
              f"B1 kernel agrees with plain at n={n} batch={batch} {dtype}")
        if dtype == F64 and (n, batch) in B1_STAGED_F64:
            check(plan.route == "staged", f"thomas_plan stages n={n} batch={batch} float64")
        want_route = ("scratch" if (n, batch, dtype) in B1_SCRATCH else "staged"
                      if 4 * n * 32 * d.element_size() <= 200 * 1024 else "partitioned")
        check(plan.route == want_route, f"thomas_plan routes n={n} batch={batch} {dtype} "
              f"to {want_route}: {plan}")
        key = str(dtype)[6:]
        worst[key] = max(worst[key], err)
        if (n, batch, dtype) not in B1_MAIN:
            continue
        planned = lambda: tridiag.tridiag_solve_cuda(dl, d, du, b)
        scratch = scratch_route(lib, dl, d, du, b)
        turns = [device_ms(f, 20, CALLS) for f in (planned, scratch, scratch, planned)]
        # every main path hands B1 its systems batch-last; the layout it
        # launches follows from the shape (layout_turns times the
        # batch-last kernel's systems a block)
        main_plan = tridiag.thomas_plan(n, dtype, batch, "batch_last")
        if main_plan.route == "staged":
            extra.update(layout_turns(tridiag, lib, dl, d, du, b, x, main_plan.layout))
        if main_plan.layout == "system_major" and plan.route == "staged":
            # the plan's choice of systems a block against the other tiles
            extra["ms_by_systems_a_block"] = {
                S: round(device_ms(staged_route(lib, dl, d, du, b, S), 20, CALLS), 5)
                for S in (32, 64, 128) if 4 * n * S * d.element_size() <= 232448}
        elif main_plan.layout == "system_major":
            extra["ms_by_systems_a_block"] = {
                S: round(device_ms(partitioned_route(lib, dl, d, du, b, S), 20, CALLS), 5)
                for S in (4, 8, 16) if tridiag.partitioned_smem(n, dtype, S) <= 232448}
        # the plain loop is n Python steps of eager launches: fewer calls a
        # graph at large n keep its capture short
        plain_ms = device_ms(lambda: tridiag.tridiag_solve_plain(dl, d, du, b), 5,
                             CALLS if n <= 300 else 2)
        kernel_ms = extra.pop("batch_last_ms", (turns[0] + turns[3]) / 2)
        rows[key].append(timing_row(
            f"B1 {B1_MAIN[n, batch, dtype]} n={n} batch={batch} {key} {main_plan.layout}",
            kernel_ms, plain_ms, 5 * n * batch * d.element_size(),
            # float32 LU strays to 1.2e-3 on the AH systems (measured on an
            # H100), where the kernel holds 68 ulps of the plain loop
            9 * n * batch, dense_solve_ms(dl, d, du, b, x, 1e-2 if ah_like else 1e-3),
            ops_s=F32_OPS_S if dtype == F32 else F64_OPS_S,
            thomas_route=main_plan.route, main_path_layout=main_plan.layout,
            scratch_route_ms=(turns[1] + turns[2]) / 2, turns=[round(t, 5) for t in turns],
            **{"ms_one_call_a_graph": device_ms(planned, 20), **extra},
            systems_a_block=main_plan.systems, smem=main_plan.smem, max_abs_err=err,
            rel_err=err / xmax))
        del scratch
    return {key: {"max_abs_err": worst[key], **{k: v for k, v in rows[key][0].items()
                                                if k != "max_abs_err"}, "shapes": rows[key]}
            for key in rows}


def layout_turns(tridiag, lib, dl, d, du, b, x, layout) -> dict:
    """B1 on the batch-last layout of these (n, batch) systems (the
    transposes of row-major (batch, n) arrays, as the cubic fit builds
    them), as its main path takes them in ``layout``: the batch-last
    kernel, or the copies to row-major and the system-major kernel. x is
    the system-major kernel's, bit for bit. Timed in turns against the
    system-major kernel on row-major arrays and, where the batch-last
    kernel runs, against the route it replaced (the four row-major copies,
    then the system-major kernel): (system-major, batch-last, copies,
    copies, batch-last, system-major), else (system-major, copies, copies,
    system-major)."""
    n, batch = d.shape
    last = [a.T.contiguous().mT for a in (dl, d, du, b)]
    layouts = dict(tridiag.tridiag_solve_cuda.launches_by_layout)
    got = tridiag.tridiag_solve_cuda(*last)
    torch.cuda.synchronize()
    counted = {k: v - layouts[k] for k, v in tridiag.tridiag_solve_cuda.launches_by_layout.items()}
    check(counted == {lay: int(lay == layout) for lay in tridiag.LAYOUTS},
          f"B1 n={n} batch={batch} {d.dtype} on batch-last arrays counted {layout}: {counted}")
    check(got.stride() == ((1, n) if layout == "batch_last" else (batch, 1))
          and torch.equal(got, x),
          f"B1 on batch-last arrays ({layout}) equals the system-major kernel bit for bit "
          f"at n={n} batch={batch} {d.dtype}")
    system = lambda: tridiag.tridiag_solve_cuda(dl, d, du, b)
    main = lambda: tridiag.tridiag_solve_cuda(*last)
    copies = lambda: tridiag.tridiag_solve_cuda(*(a.contiguous() for a in last))
    order = (system, main, copies, copies, main, system) if layout == "batch_last" else (
        system, copies, copies, system)
    turns = [device_ms(f, 20, CALLS) for f in order]
    out = {"system_major_ms": (turns[0] + turns[-1]) / 2,
           "copies_then_system_major_ms": (turns[len(turns) // 2 - 1] + turns[len(turns) // 2]) / 2,
           "layout_turns": [round(t, 5) for t in turns]}
    if layout == "batch_last":
        out["batch_last_ms"] = (turns[1] + turns[4]) / 2
        out["ms_one_call_a_graph"] = device_ms(main, 20)
        out["ms_by_systems_a_block"] = {
            S: round(device_ms(staged_route(lib, *last, S), 20, CALLS), 5)
            for S in (32, 64, 128)
            if 4 * tridiag.batch_last_rows(n, d.dtype) * S * d.element_size() <= 232448}
    del last, got
    torch.cuda.empty_cache()
    return out


def _suffix(t) -> str:
    return "f32" if t.dtype == F32 else "f64"


def staged_route(lib, dl, d, du, b, S):
    """A call of the staged Thomas kernel with S systems a block, outside
    the wrapper, so it counts no launch: the batch-last kernel on
    batch-last arrays, else the system-major one."""
    n, batch = d.shape
    last = not d.is_contiguous()
    x = torch.empty((batch, n), dtype=b.dtype, device=b.device).mT if last else torch.empty_like(b)
    staged = getattr(lib, f"ivt_thomas_staged_{'batch_last_' if last else ''}{_suffix(d)}")

    def run():
        err = staged(*(a.data_ptr() for a in (dl, d, du, b, x)), n,
                     batch, S, torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"staged-route launch (S={S}) returned {err}")
    return run


def partitioned_route(lib, dl, d, du, b, S):
    """A call of the partitioned Thomas kernel with S systems a block,
    outside the wrapper, so it counts no launch."""
    n, batch = d.shape
    x = torch.empty_like(b)
    part = getattr(lib, f"ivt_thomas_partitioned_{_suffix(d)}")

    def run():
        err = part(*(a.data_ptr() for a in (dl, d, du, b, x)), n, batch, S,
                   torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"partitioned-route launch (S={S}) returned {err}")
    return run


def scratch_route(lib, dl, d, du, b):
    """A call of the global-scratch Thomas kernel on these systems,
    outside the wrapper, so it counts no launch."""
    n, batch = d.shape
    x, cp = torch.empty_like(b), torch.empty_like(d)
    scratch = getattr(lib, f"ivt_thomas_scratch_{_suffix(d)}")

    def run():
        err = scratch(
            *(a.data_ptr() for a in (dl, d, du, b, x, cp)), n, batch,
            torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"scratch-route launch returned {err}")
    return run


def bucket_sums(minutes, v, valid, bm, base, ns):
    """float64 per-bucket sum of v and of |v| (the volume oracle)."""
    seg = torch.div(minutes.long(), bm, rounding_mode="floor") - base
    ok = valid & (seg >= 0) & (seg < ns)
    idx = torch.where(ok, seg, ns)
    v64 = torch.where(ok, v.double(), torch.zeros_like(v, dtype=torch.float64))
    out = lambda src: torch.zeros((v.shape[0], ns + 1), dtype=torch.float64,
                                  device=v.device).scatter_add_(1, idx, src)[:, :ns]
    return out(v64), out(v64.abs())


def eps_of(t: torch.Tensor) -> float:
    return EPS32 if t.dtype == torch.float32 else EPS64


def compare_candles(got, ref, inputs, bm, base, ns, what) -> float:
    """Exact open/high/low/close/count/valid; volume within the sum bound
    of the values' dtype (eps = eps32 or eps64). Both sums run in unordered
    atomics, and any sum of a bucket's values in that dtype lies within
    (count - 1) eps sum|v| of the exact sum; the two differ by at most
    twice that plus an ulp of rounding. The float64 oracle is exact beside
    float32 values; beside float64 values it is one more such sum, so the
    kernel is held to it within twice the bound."""
    for f in ("open", "high", "low", "close", "count", "valid"):
        check(same_with_nan(getattr(got, f), getattr(ref, f)), f"B2 {what}: {f} exact")
    check(all(getattr(got, f).dtype == inputs[5].dtype
              for f in ("open", "high", "low", "close", "volume")),
          f"B2 {what}: outputs in the values' dtype")
    eps, wide = eps_of(inputs[5]), inputs[5].dtype == torch.float64
    vol64, mag = bucket_sums(inputs[0], inputs[5], inputs[6], bm, base, ns)
    cnt = (got.count.double() - 1).clamp_min(0)
    err = (got.volume.double() - ref.volume.double()).abs()
    check(bool((err <= 2 * cnt * eps * mag + eps * vol64.abs()).all()),
          f"B2 {what}: volume within the sum bound of the plain version")
    check(bool(((got.volume.double() - vol64).abs()
                <= (2 if wide else 1) * cnt * eps * mag + eps * vol64.abs()).all()),
          f"B2 {what}: volume within the sum bound of the float64 sum")
    return float(err.max())


def b2_bytes(ticks, got) -> int:
    """Bytes a B2 call must move with these inputs: valid once; the
    minutes of the valid rows; h, l and v of the rows that land in a
    bucket (each distinct tensor once); o and c once per nonempty bucket;
    five values, an int32 count and a bool a bucket out (25 bytes in
    float32, 45 in float64)."""
    minutes, o, h, l, c, v, valid = ticks
    distinct = lambda *ts: len({t.data_ptr() for t in ts})
    counted = int(got.count.sum())
    nonempty = int((got.count > 0).sum())
    size = v.element_size()
    return (valid.numel() + int(valid.sum()) * minutes.element_size()
            + counted * size * distinct(h, l, v) + nonempty * size * distinct(o, c)
            + got.count.numel() * (5 * size + 5))


def b2_case(agg, ticks, kw, what, timed=False):
    """One B2 case against its plain version; timed, the kernel and the
    plain version from CUDA graphs and the bound from these inputs."""
    got = agg.aggregate_ohlcv_cuda(*ticks, **kw)
    torch.cuda.synchronize()
    ref = agg.aggregate_ohlcv_plain(*ticks, **kw)
    err = compare_candles(got, ref, ticks, kw["bucket_minutes"], kw.get("base_bucket", 0),
                          kw["num_segments"], what)
    if not timed:
        return got, ref, err, None
    plan = agg.agg_plan(ticks[0].shape[1], kw["num_segments"], ticks[1].dtype)
    kernel = lambda: agg.aggregate_ohlcv_cuda(*ticks, **kw)
    ms = device_ms(kernel, 20, CALLS)
    plain = device_ms(lambda: agg.aggregate_ohlcv_plain(*ticks, **kw), 5, CALLS)
    row = timing_row(f"B2 {what}", ms, plain, b2_bytes(ticks, got), 0, None,
                     ms_one_call_a_graph=device_ms(kernel, 20),
                     tiles=plan.tiles, threads=plan.threads, smem=plan.smem,
                     minutes=str(ticks[0].dtype)[6:], values=str(ticks[1].dtype)[6:])
    return got, ref, err, row


def candle_ticks(gen, dtype=torch.float32):
    """Candle-stage-shaped ticks: each row's 1-min grid from an epoch
    minute on, the first ``filled`` slots valid (the pipeline's timeline),
    int64 minutes as the stage passes them, values in ``dtype``."""
    P = B2_CANDLE
    B, L = P["B"], P["L"]
    start = int(np.datetime64("2023-03-20T09:00", "m").astype(np.int64))
    minutes = (start + torch.arange(L, device=DEV)).expand(B, L).contiguous()
    mid = 25000 + torch.randn((B, L), generator=gen, device=DEV).cumsum(-1)
    spread = torch.rand((B, L), generator=gen, device=DEV) * 10
    valid = (torch.arange(L, device=DEV) < P["filled"]).expand(B, L).contiguous()
    vol = torch.rand((B, L), generator=gen, device=DEV) * 50
    values = [a.to(dtype) for a in (mid, mid + spread, mid - spread, mid + 0.5 * spread, vol)]
    return [minutes, *values, valid], start


def stream_agg_cases(agg, dtype=torch.float32) -> dict:
    """B2 with values in ``dtype`` against its plain version: the three
    main-path shapes (timed) and the edges of its launch plan."""
    gen = torch.Generator(device=DEV).manual_seed(12)
    eps = EPS32 if dtype == torch.float32 else EPS64
    B, L, ns1 = B2_SHAPE
    minutes = torch.sort(torch.randint(0, ns1, (B, L), generator=gen, device=DEV,
                                       dtype=torch.int32), dim=-1).values
    price = (100 + torch.randn((B, L), generator=gen, device=DEV).cumsum(-1) * 0.01).to(dtype)
    size = (torch.rand((B, L), generator=gen, device=DEV) * 5).to(dtype)
    valid = torch.rand((B, L), generator=gen, device=DEV) < 0.9
    ticks = [minutes, price, price, price, price, size, valid]
    s1 = dict(bucket_minutes=1, num_segments=ns1, min_count=1)
    rows = []

    # the pipeline's candle stage: epoch-scale int64 minutes shifted into
    # range by base_bucket; then the same minutes moved past int32 (the
    # 64-bit division), with base_bucket moved by as many buckets
    candles, start = candle_ticks(gen, dtype)
    P = B2_CANDLE
    sc = dict(bucket_minutes=5, base_bucket=start // 5, num_segments=P["buckets"],
              min_count=5)
    got, _, worst, row = b2_case(agg, candles, sc,
                                 f"candle stage {P['B']}x{P['L']}->{P['buckets']}", True)
    rows.append(row)
    check(int(got.count.sum()) == P["B"] * P["filled"], "candle stage: every filled slot counted")
    shift = -5 * 2**31
    far = [candles[0] + shift] + candles[1:]
    far_kw = dict(sc, base_bucket=start // 5 + shift // 5)
    got_far, _, err, _ = b2_case(agg, far, far_kw, "minutes beyond int32")
    check(same_with_nan(got_far.count, got.count), "minutes beyond int32: same counts")
    worst = max(worst, err)
    del candles, far, got, got_far

    # the streaming refit: 1-min stage, then stage 2 on its 1-min candles
    c1, c1_plain, err, row = b2_case(agg, ticks, s1, f"refit 1-min {B}x{L}->{ns1}", True)
    rows.append(row)
    worst = max(worst, err)
    check(bool(torch.isnan(c1_plain.open).any()), "stage-2 input carries NaN")
    m1 = torch.arange(ns1, dtype=torch.int32, device=DEV).expand(B, ns1).contiguous()
    stage2 = [m1, c1_plain.open, c1_plain.high, c1_plain.low, c1_plain.close,
              c1_plain.volume, c1_plain.valid]
    s2 = dict(bucket_minutes=5, num_segments=ns1 // 5 + 1, min_count=5)
    _, _, err, row = b2_case(agg, stage2, s2, f"refit 5-min {B}x{ns1}->{s2['num_segments']}", True)
    rows.append(row)
    worst = max(worst, err)
    if dtype == torch.float32:
        # the served refits (phase 8's 256 underlyings) and window_candles
        # (phase 11 (a)), float32 only: no float64 path runs them
        served = 256
        for stage, args, kw in (("1-min", ticks, s1), ("5-min", stage2, s2)):
            cut = [a[:served].contiguous() for a in args]
            _, _, err, row = b2_case(agg, cut, kw, f"served refit {stage} {served}x"
                                     f"{cut[0].shape[1]}->{kw['num_segments']}", True)
            rows.append(row)
            worst = max(worst, err)
        from iv_interpolation_tpu_torch.pipeline import ringbuffer
        P = RING
        blocks, _, t0 = ring_ticks(torch.Generator().manual_seed(P["seed"]), P)
        window = ringbuffer.window_ticks(wrapped_ring(ringbuffer, blocks, DEV), t0.to(DEV),
                                         P["bm"])
        sw = dict(bucket_minutes=P["bm"], num_segments=P["L"] // P["bm"] + 1, min_count=P["bm"])
        _, _, err, row = b2_case(agg, list(window), sw, f"window_candles {P['B']}x{P['L']}->"
                                 f"{sw['num_segments']}", True)
        rows.append(row)
        worst = max(worst, err)
        del blocks, window

    # shuffled rows: high, low, count, valid and volume do not need order
    perm = torch.argsort(torch.rand((B, L), generator=gen, device=DEV), dim=-1)
    shuffled = [torch.gather(a, 1, perm) for a in ticks]
    cs = agg.aggregate_ohlcv_cuda(*shuffled, **s1)
    for f in ("high", "low", "count", "valid"):
        check(same_with_nan(getattr(cs, f), getattr(c1_plain, f)), f"B2 shuffled: {f}")
    vol64, mag = bucket_sums(ticks[0], ticks[5], ticks[6], 1, 0, ns1)
    cnt = (cs.count.double() - 1).clamp_min(0)
    check(bool(((cs.volume.double() - vol64).abs()
                <= (1 if dtype == torch.float32 else 2) * cnt * eps * mag
                + eps * vol64.abs()).all()), "B2 shuffled: volume")

    # NaN / Inf payloads in invalid rows never reach a result
    bad = [a.clone() for a in ticks]
    for j in range(1, 6):
        bad[j][~valid] = float("nan")
    bad[5][0, torch.nonzero(~valid[0])[0, 0]] = float("inf")
    cb = agg.aggregate_ohlcv_cuda(*bad, **s1)
    for f in ("open", "high", "low", "close", "count", "valid"):
        check(same_with_nan(getattr(cb, f), getattr(c1_plain, f)), f"B2 NaN rows: {f}")
    check(bool(torch.isfinite(cb.volume).all()), "B2 NaN rows: volume finite")

    # negative minutes: floor division drops minutes -4..-1 at base 0
    neg = [ticks[0] - 7] + ticks[1:]
    s_neg = dict(bucket_minutes=5, num_segments=103, min_count=1)
    cn, _, err, _ = b2_case(agg, neg, s_neg, "negative minutes")
    worst = max(worst, err)
    in_first = (valid & (neg[0] >= 0) & (neg[0] < 5)).sum(-1).to(torch.int32)
    check(torch.equal(cn.count[:, 0], in_first), "B2 negative minutes: bucket 0 count")

    # a row length that is no multiple of 4 (scalar loads), and a bucket
    # count past one block's shared memory (the tile loop)
    odd = [a[:, :L - 3].contiguous() for a in ticks]
    worst = max(worst, b2_case(agg, odd, s1, f"{B}x{L - 3} (scalar loads)")[2])
    wide_ns, wide_shape = agg.MAX_TILE * 2 + 3616, (64, 16384)
    wide_tiles = 3 if dtype == torch.float32 else 4    # tiles of 8,192 or of 6,144
    wide_min = torch.sort(torch.randint(0, wide_ns, wide_shape, generator=gen, device=DEV,
                                        dtype=torch.int32), dim=-1).values
    wide_p = (100 + torch.randn(wide_shape, generator=gen, device=DEV).cumsum(-1) * 0.01
              ).to(dtype)
    wide = [wide_min, wide_p, wide_p, wide_p, wide_p,
            (torch.rand(wide_shape, generator=gen, device=DEV) * 5).to(dtype),
            torch.rand(wide_shape, generator=gen, device=DEV) < 0.9]
    plan = agg.agg_plan(wide_shape[1], wide_ns, dtype)
    check(plan.tiles == wide_tiles, f"the wide case takes the tile loop: {plan}")
    worst = max(worst, b2_case(agg, wide, dict(s1, num_segments=wide_ns),
                               f"tile loop {wide_shape[0]}x{wide_shape[1]}->{wide_ns} "
                               f"({plan.tiles} tiles)")[2])
    log(f"  B2 {str(dtype)[6:]} max|volume kernel-plain| = {worst:.3e}; beyond-int32, "
        f"shuffled, NaN/Inf, negative-minute, scalar-load and tile-loop cases pass")
    return {"max_abs_err": worst, **rows[0], "shapes": rows}


# -- phase 2 (c): the spline evaluation kernel --------------------------------

# Its callers' shapes (name: slices' batch, n, m, dtype, results, queries):
# the surface step's grid (w, w', w'' on the common support, read at stride
# 0 over the 30 expiries) and its quotes (w at the knots themselves), the
# same grid in float64 (parity mode, the bench's parity stage), eval_surface's
# one-point slices (1,024 surfaces x 256 queries), and the 30-day cubic
# batch's resampling (768 series of 721 hourly knots, n=719 as B1's, on one
# timeline shared by the batch) in float32 and float64.
SPLINE_CASES = (("surface grid", (32768, 30), 50, 50, F32, (0, 1, 2), "grid"),
                ("surface quotes", (32768, 30), 50, 50, F32, (0,), "knots"),
                ("parity grid", (32768, 30), 50, 50, F64, (0, 1, 2), "grid"),
                ("eval_surface", (1024, 256), 50, 1, F32, (0,), "points"),
                ("30-day timeline", (768,), 719, 721, F32, (0,), "timeline"),
                ("30-day timeline", (768,), 719, 721, F64, (0,), "timeline"))
# kernel against its plain version: ulps of each slice's size in a result
# (tests/test_torch_spline_eval.py ULPS and _ulps: the same operations in
# the same order; PyTorch's card kernels divide by the scalar 6 as a
# product with a rounded 1/6, an ulp in that term and one in the sum)
SPLINE_ULPS = 4.0


def spline_ulps(got, ref, r, x, y, M) -> float:
    """Largest |got - ref| of result r (0: S, 1: S', 2: S'') on each slice
    in ulps of the slice's size there: its largest |value|, and at least
    its knots' size in that order (|y|, the secant slopes, |M|)."""
    knots = (y.abs(), (torch.diff(y, dim=-1) / torch.diff(x, dim=-1)).abs(), M.abs())[r]
    size = torch.maximum(ref.abs().amax(dim=-1, keepdim=True),
                         knots.amax(dim=-1, keepdim=True).to(ref.device))
    size = size.clamp_min(torch.finfo(ref.dtype).tiny)
    return float(((got - ref).abs() / size).max()) / torch.finfo(ref.dtype).eps


def spline_inputs(batch, n, m, dtype, queries, gen):
    """Sorted jittered knots, smile-like values, curvatures and the query
    view of one SPLINE_CASES row, on the card."""
    u = lambda *shape: torch.rand(*shape, device=DEV, generator=gen, dtype=F64)
    base = torch.linspace(-1.0, 1.0, n, device=DEV, dtype=F64)
    x = base + (0.4 / n) * u(*batch, n)
    y = 0.04 + 0.05 * x * x + 1e-3 * u(*batch, n)
    M = 0.1 + torch.randn(*batch, n, device=DEV, generator=gen, dtype=F64)
    if queries == "timeline":
        x = (x + 1.0) * 360.0
    x, y, M = (a.to(dtype) for a in (x, y, M))
    if queries == "grid":
        row = torch.linspace(-1.1, 1.1, m, device=DEV, dtype=F64)[None] + 0.01 * u(batch[0], 1)
        t = row.to(dtype)[:, None, :].expand(*batch, m)
    elif queries == "knots":
        t = x
    elif queries == "points":
        t = (2.4 * u(*batch) - 1.2).to(dtype)[..., None]
    else:
        t = torch.arange(m, device=DEV, dtype=dtype).expand(*batch, m)
    return x, y, M, t


def spline_bytes(x, t, outputs: int) -> int:
    """Least bytes of one evaluation: the knots read once, each distinct
    query once (none where the queries are the knots), each result
    written once."""
    distinct = math.prod(size for size, stride in zip(t.shape, t.stride()) if stride)
    queries = 0 if t.data_ptr() == x.data_ptr() else distinct
    return (3 * x.numel() + queries + outputs * x[..., :1].numel() * t.shape[-1]) * x.element_size()


def spline_eval_cases(se) -> dict:
    """The evaluation kernel against its plain version at every
    SPLINE_CASES row (within SPLINE_ULPS of each slice's size, also
    against the plain version on CPU tensors for the first 64 slices,
    and each result alone equal to the three together), counted on its
    planned route, then timed beside the plain version and the bound.
    Operations: 37 a query for all three results (3 shared, 4 for a and b,
    14 for S, 12 for S', 4 for S''), 21 for S alone."""
    gen = torch.Generator(device=DEV).manual_seed(19)
    rows, worst = [], {"float32": 0.0, "float64": 0.0}
    for what, batch, n, m, dtype, results, queries in SPLINE_CASES:
        x, y, M, t = spline_inputs(batch, n, m, dtype, queries, gen)
        plan = se.spline_eval_plan(n, m, dtype, math.prod(batch))
        routes = dict(se.spline_eval_cuda.launches_by_route)
        got = se.spline_eval_cuda(x, y, M, t, results)
        torch.cuda.synchronize()
        check(se.spline_eval_cuda.launches_by_route[plan.route] == routes[plan.route] + 1,
              f"spline evaluation {what} counted on its route {plan.route}")
        plain = se.spline_eval_plain(x, y, M, t, results)
        cut = [a[:64] for a in (x, y, M)] + [t[:64]]
        on_cpu = se.spline_eval_plain(*(a.cpu() for a in cut), results)
        err = {"card": 0.0, "cpu": 0.0}
        for r, g, p, c in zip(results, got, plain, on_cpu):
            err["card"] = max(err["card"], spline_ulps(g, p, r, x, y, M))
            err["cpu"] = max(err["cpu"], spline_ulps(g[:64].cpu(), c, r, *cut[:3]))
            check(bool(torch.isfinite(g).all()), f"spline evaluation {what}: result {r} finite")
        for r, g in zip(results, got):
            (alone,) = se.spline_eval_cuda(x, y, M, t, (r,))
            check(torch.equal(alone, g), f"spline evaluation {what}: result {r} alone")
        key = str(dtype)[6:]
        worst[key] = max(worst[key], *err.values())
        check(max(err.values()) <= SPLINE_ULPS, f"spline evaluation {what} {key}: {err} ulps "
              f"of each slice's size against the plain version on the card and on CPU "
              f"tensors (bound {SPLINE_ULPS})")
        kernel = lambda: se.spline_eval_cuda(x, y, M, t, results)
        plain_fn = lambda: se.spline_eval_plain(x, y, M, t, results)
        turns = [device_ms(f, 20, CALLS) for f in (kernel, plain_fn, plain_fn, kernel)]
        ops = (37 if len(results) == 3 else 21) * x[..., :1].numel() * m
        rows.append(timing_row(
            f"spline eval {what} slices={math.prod(batch)} n={n} m={m} results={len(results)} {key}",
            (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2,
            spline_bytes(x, t, len(results)), ops, None,
            ops_s=F32_OPS_S if dtype == F32 else F64_OPS_S, route=plan.route,
            slices_a_block=plan.slices, turns=[round(v, 5) for v in turns],
            ms_one_call_a_graph=device_ms(kernel, 20),
            max_ulps_plain_card=round(err["card"], 3), max_ulps_plain_cpu=round(err["cpu"], 3)))
        del x, y, M, t, got, plain
        torch.cuda.empty_cache()
    log(f"  spline evaluation: worst {worst} ulps of each slice's size (bound {SPLINE_ULPS})")
    return {"max_ulps": worst, **{k: v for k, v in rows[0].items()}, "shapes": rows}


# -- phase 3: the surface step ------------------------------------------------

def surface_inputs():
    """Phase 3's quotes on the card, from seed 13: (k, T, clean iv, iv
    with butterfly arbitrage, clean iv with 1e-4 noise)."""
    B, E, N = (SURFACE[x] for x in "BEN")
    gen = torch.Generator(device=DEV).manual_seed(13)
    k_row = np.linspace(-1.0, 1.0, N, dtype=np.float32)
    T_row = np.linspace(0.05, 2.0, E, dtype=np.float32)
    k = torch.from_numpy(k_row).to(DEV).expand(B, E, N).contiguous()
    T = torch.from_numpy(T_row).to(DEV).expand(B, E).contiguous()
    atm = torch.empty((B, 1, 1), device=DEV).uniform_(0.15, 0.6, generator=gen)
    curv = torch.empty((B, 1, 1), device=DEV).uniform_(0.05, 0.3, generator=gen)
    iv_clean = atm + curv * k * k
    iv_bad = iv_clean + 0.08 * torch.sin(20 * k)       # butterfly arbitrage
    noise = 1e-4 * torch.randn((B, E, N), device=DEV, generator=gen)
    return k, T, iv_clean, iv_bad, iv_clean + noise


def surface_digests(out: dict) -> dict:
    """Bitwise digests of a surface step's grids and flags."""
    return {key: digest(out[key]) for key in ("k_grid", "w_grid", "iv_grid", "g",
                                              "butterfly_ok", "calendar_ok")}


def surface_step(surface, tridiag, se) -> dict:
    from scipy.interpolate import CubicSpline

    B, E, N, M = (SURFACE[x] for x in "BENM")
    k, T, iv_clean, iv_bad, iv_timed = surface_inputs()
    k_row, T_row = k[0, 0].cpu().numpy(), T[0].cpu().numpy()

    def step(iv):
        return surface.fit_eval_surface(k, iv, T, method="cubic_spline", n_grid=M,
                                        spline_bc="not-a-knot")

    before = tridiag.tridiag_solve_cuda.launches
    layouts = dict(tridiag.tridiag_solve_cuda.launches_by_layout)
    evals = se.spline_eval_cuda.launches
    out = step(iv_clean)
    torch.cuda.synchronize()
    check(tridiag.tridiag_solve_cuda.launches == before + 1
          and tridiag.tridiag_solve_cuda.launches_by_layout["batch_last"]
          == layouts["batch_last"] + 1,
          "the surface step launched the Thomas kernel once, on its systems batch-last")
    check(se.spline_eval_cuda.launches == evals + 2,
          "the surface step launched the spline evaluation twice (grid, quotes)")
    w = out["w_grid"]
    check(tuple(w.shape) == (B, E, M) and w.dtype == torch.float32, "w_grid shape")
    check(bool(torch.isfinite(w).all() and torch.isfinite(out["g"]).all()),
          "w_grid and g finite")
    clean_frac = float(out["butterfly_ok"].float().mean())
    adv_frac = float(step(iv_bad)["butterfly_ok"].float().mean())
    check(clean_frac == 1.0, f"butterfly_clean_frac == 1.0 (got {clean_frac})")
    check(adv_frac <= 0.05, f"butterfly_adversarial_frac <= 0.05 (got {adv_frac})")
    check(bool(out["calendar_ok"].all()), "clean surfaces calendar-clean")

    # SciPy float64 not-a-knot spline through the same float32 quotes.
    # Bound 5e-6, about 40 float32 ulps at the largest w (1.62): the
    # rounding of w = iv^2 T (<= 1.5 ulp), the float32 grid (<= 1 ulp
    # times |w'| <= 2.2) and the evaluation (a few ulps), carried at most
    # x2 by the spline's interpolation operator.
    q = np.linspace(-1.0, 1.0, M)
    stride = max(1, B // 8)                    # 8 surfaces, every expiry
    iv_host = iv_clean[::stride].double().cpu().numpy()
    w_host = w[::stride].double().cpu().numpy()
    parity = 0.0
    for b in range(iv_host.shape[0]):
        for e in range(E):
            ref = CubicSpline(k_row.astype(np.float64),
                              iv_host[b, e] ** 2 * float(T_row[e]),
                              bc_type="not-a-knot")(q)
            parity = max(parity, float(np.abs(w_host[b, e] - ref).max()))
    check(parity < 5e-6, f"max |w_grid - SciPy| < 5e-6 (got {parity:.3e})")

    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: step(iv_timed), 5)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    log(f"  surface step B={B} E={E} n={N} m={M}: {ms:.3f} ms/call, "
        f"{B / (ms / 1e3):,.0f} surfaces/s, peak {peak_gb:.2f} GiB")
    log(f"  butterfly_clean_frac={clean_frac} butterfly_adversarial_frac={adv_frac} "
        f"parity_max_err={parity:.3e}")
    return {"surfaces_per_s": B / (ms / 1e3), "ms": ms, "parity_max_err": parity,
            "butterfly_clean_frac": clean_frac, "butterfly_adversarial_frac": adv_frac,
            "digests": surface_digests(out)}


# -- phase 4: the streaming refit ---------------------------------------------

def stream_data():
    """STREAM's universe from a seeded numpy generator: (underlyings, k,
    iv, T, the tick chunks, the minutes a chunk spans)."""
    B, E, N, W, CHUNKS, PER = (STREAM[x] for x in ("B", "E", "N", "W", "CHUNKS", "PER"))
    rng = np.random.default_rng(14)
    half = rng.uniform(0.8, 1.2, (B, 1, 1))
    k = np.broadcast_to(half * np.linspace(-1.0, 1.0, N), (B, E, N)).astype(np.float32)
    T = np.broadcast_to(np.linspace(0.05, 2.0, E), (B, E)).astype(np.float32)
    iv = (rng.uniform(0.15, 0.6, (B, 1, 1))
          + rng.uniform(0.05, 0.3, (B, 1, 1)) * k * k).astype(np.float32)
    unds = np.array([f"u{i:04d}" for i in range(B)])
    per_min = 0.5 / np.sqrt(365.25 * 24 * 60)
    path = 100 * np.exp(np.cumsum(rng.normal(0, per_min, (B, W)), axis=-1))
    span = W // CHUNKS
    chunks = []
    for c in range(CHUNKS):
        minute = np.sort(rng.integers(c * span, (c + 1) * span, (B, PER)), axis=-1)
        chunks.append({"underlying": np.repeat(unds, PER),
                       "minute": minute.ravel(),
                       "price": np.take_along_axis(path, minute, -1).ravel(),
                       "size": rng.uniform(0, 5, B * PER)})
    return unds, k, iv, T, chunks, span


def streaming_session(svc, agg) -> dict:
    B, E, N, W, CAP, CHUNKS, PER = (STREAM[x] for x in
                                    ("B", "E", "N", "W", "CAP", "CHUNKS", "PER"))
    unds, k, iv, T, chunks, span = stream_data()
    t0 = time.perf_counter()
    sess = svc.StreamingSession(list(unds), k, iv, T, window_minutes=W,
                                tick_capacity=CAP, n_grid=50, device=DEV)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    refit_s, out = [], None
    for c, ticks in enumerate(chunks):
        check(sess.ingest_ticks(ticks) == B * PER, "every tick ingested")
        torch.cuda.synchronize()
        before = agg.aggregate_ohlcv_cuda.launches
        t0 = time.perf_counter()
        out = sess.refit(now_minute=(c + 1) * span - 1)
        torch.cuda.synchronize()
        refit_s.append(time.perf_counter() - t0)
        check(agg.aggregate_ohlcv_cuda.launches - before == 2,
              "each refit launches the aggregation kernel twice")
    check(tuple(out.w_grid.shape) == (B, E, 50), "refit w_grid shape")
    check(bool(torch.isfinite(out.w_grid).all()), "refit w_grid finite")
    check(int(out.candles_1m.count.sum()) == B * PER * CHUNKS,
          "every ingested tick lands in a 1-min candle")
    warm = sorted(refit_s[1:])
    median_ms = warm[len(warm) // 2] * 1e3

    # the same session on CPU tensors (plain versions), last refit compared
    cpu = svc.StreamingSession(list(unds), k, iv, T, window_minutes=W,
                               tick_capacity=CAP, n_grid=50, device="cpu")
    for ticks in chunks:
        cpu.ingest_ticks(ticks)
    ref = cpu.refit(now_minute=W - 1)
    for f in ("butterfly_ok", "calendar_ok"):
        check(torch.equal(getattr(out, f).cpu(), getattr(ref, f)), f"refit {f} equal")
    for stage in ("candles_1m", "candles_5m"):
        for f in ("count", "valid"):
            check(torch.equal(getattr(getattr(out, stage), f).cpu(),
                              getattr(getattr(ref, stage), f)), f"{stage}.{f} equal")
    # realized vol: identical closes; float32 log (a few ulps) and sums of
    # <= 102 positive terms in another order ((n-1) eps) -> 128 ulps
    rv_err = float(((out.realized_vol.cpu() - ref.realized_vol).abs()
                    / ref.realized_vol.abs().clamp_min(1e-30)).max())
    check(rv_err <= 128 * EPS32, f"realized_vol within 128 ulps (got {rv_err:.3e})")
    # w ~ scale^2: 2x the realized-vol bound relative, with margin, plus
    # float32 contraction order over n=50 terms (50 eps sum|E0 w| <= 2e-5)
    w_err = (out.w_grid.cpu() - ref.w_grid).abs()
    check(bool((w_err <= 1e-4 * ref.w_grid.abs() + 2e-5).all()),
          f"w_grid within 1e-4 rel + 2e-5 (max abs {float(w_err.max()):.3e})")
    log(f"  session B={B} E={E} n={N} window={W} ring={CAP}: set-up {setup_s:.2f} s, "
        f"refits ms {[round(s * 1e3, 2) for s in refit_s]}")
    log(f"  median warm refit {median_ms:.3f} ms, {B / (median_ms / 1e3):,.0f} "
        f"underlyings/s; vs CPU session: realized rel err {rv_err:.3e}, "
        f"w_grid max abs err {float(w_err.max()):.3e}, "
        f"butterfly_ok {int(out.butterfly_ok.sum())}/{B}")
    return {"warm_refit_ms": median_ms, "underlyings_per_s": B / (median_ms / 1e3)}


# -- phase 5: the fused task pipeline ----------------------------------------

EXPIRIES = (("20mar23", 7), ("27mar23", 14), ("03apr23", 21), ("28apr23", 46),
            ("26may23", 74), ("30jun23", 109), ("29sep23", 200), ("29dec23", 291))
STAGES = ("scatter", "interpolate", "bridge", "quality", "candles")


def pipeline_config(method: str) -> types.SimpleNamespace:
    """The JAX package's ``get_config()`` defaults for the fields the fused
    batch reads (5-minute target, greeks on, spread simulation, quality
    gate on), with ``method`` as given."""
    ns = types.SimpleNamespace
    return ns(
        processing=ns(dtype="float32"),
        interpolation=ns(frequency="1min", method=method, max_gap_hours=48,
                         extrapolate=False, compute_greeks=True),
        data_bridge=ns(conversion_strategy="spread_simulation",
                       enable_quality_checks=True, seed=0,
                       base_spread_percent=0.002, volatility_factor=1.5,
                       min_spread_percent=0.0005, trend_strength=0.6,
                       base_volume=50.0, max_spread_percent=0.10),
        candle_reconstruction=ns(target_frequency="5min", min_candles_required=5))


def make_chain(rng, n_symbols: int, hours: int, drop_frac: float):
    """Hourly ticker rows of an option chain (8 expiries x strikes x call/
    put), with the columns and distributions of the JAX package's sample
    generator, in numpy: names, strikes, call/put flags, (S, H, C) values
    in ``tasks.ALL_COLS`` order, and the (S, H) mask of kept rows (the
    first and last hour always kept)."""
    per_exp = n_symbols // len(EXPIRIES)
    strikes = 20000 + 100 * np.arange(per_exp // 2)
    syms = [(e, k, cp) for e in range(len(EXPIRIES)) for k in strikes for cp in "cp"]
    names = [f"btc-{EXPIRIES[e][0]}-{k}-{cp}" for e, k, cp in syms]
    strike = np.array([k for _, k, _ in syms], np.float64)
    callput = [cp.upper() for _, _, cp in syms]
    t0 = np.array([EXPIRIES[e][1] / 365 for e, _, _ in syms])
    S, H = len(syms), hours
    base_under = 25000 + rng.normal(0, 500)
    under = base_under + np.cumsum(rng.normal(0, 50, (S, H)), axis=1)
    kmon = np.log(strike / base_under)[:, None]
    iv = np.clip(0.45 + 0.15 * kmon * kmon + 0.05 * np.cumsum(
        rng.normal(0, 0.02, (S, H)), axis=1) / np.sqrt(np.arange(1, H + 1)), 0.05, 3.0)
    ttm = np.maximum(t0[:, None] - np.arange(H) / (24 * 365.0), 1e-4)
    cols = np.stack([iv, under, ttm, np.full((S, H), 0.03), under * 0.02 * iv,
                     under + rng.normal(0, 5, (S, H)), rng.exponential(10, (S, H)),
                     rng.exponential(250, (S, H))], axis=-1).astype(np.float32)
    keep = rng.uniform(size=(S, H)) >= drop_frac
    keep[:, [0, -1]] = True
    return names, strike, callput, cols, keep


def pack_compact(chain, rows, start_minute: int, bucket: int, columns, dtype=np.float32):
    """One compact batch with the fields of the JAX package's
    ``PackedBatch``: only the observations travel, as (N, C) values in
    ``dtype`` (the batch's compute dtype) with row and grid-slot
    coordinates; N is padded to a power of two >= 1024 with rows marked
    out of range."""
    names, strike, callput, cols, keep = chain
    B, H, C = len(rows), cols.shape[1], cols.shape[2]
    r, h = np.nonzero(keep[rows])                 # row-major: (row, slot) sorted
    N = 1024
    while N < len(r):
        N *= 2
    obs_vals = np.full((N, C), np.nan, dtype)
    obs_vals[:len(r)] = cols[rows][r, h]
    obs_row = np.full(N, B, np.int32)
    obs_row[:len(r)] = r
    obs_pos = np.zeros(N, np.int64)
    obs_pos[:len(r)] = h * 60
    return types.SimpleNamespace(
        bucket_len=bucket, symbols=[names[i] for i in rows], columns=columns,
        t0_minutes=np.full(B, start_minute, np.int64),
        valid_len=np.full(B, (H - 1) * 60 + 1, np.int64),
        n_obs=keep[rows].sum(axis=1), values=None, obs_mask=None, timeline_mask=None,
        const_cols={"strike": list(strike[rows]), "callput": [callput[i] for i in rows]},
        obs_vals=obs_vals, obs_row=obs_row, obs_pos=obs_pos)


def timed_batch(runner, batch, config):
    """``fused_batch`` on the card with a CUDA event after each stage:
    (result, device ms per stage, host seconds of the call including the
    readback to numpy)."""
    marks = []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    torch.cuda.synchronize()
    mark("start")
    t0 = time.perf_counter()
    res = runner.fused_batch(batch, config, DEV, on_stage=mark)
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    ms = {name: marks[i - 1][1].elapsed_time(ev) for i, (name, ev) in enumerate(marks) if i}
    return res, ms, wall


def check_batch(res, segment_ohlcv, what: str) -> dict:
    """(c): OHLC integrity of the 1-min and 5-min candles, the quality gate,
    5-min counts against the valid 1-min candles, and volume preservation.
    Returns the batch's output row counts."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    o, c = res["ohlcv"], res["candles"]
    for stage, d in (("1-min", o), ("5-min", c)):
        all_ok, _ = segment_ohlcv.validate_ohlcv(*(t(d[f]) for f in (
            "open", "high", "low", "close", "volume", "valid")))
        check(bool(all_ok), f"{what}: validate_ohlcv all ok on the {stage} candles")
    check(not res["failed"] and bool(res["quality_ok"].all()),
          f"{what}: quality gate passes ({len(res['failed'])} symbols failed)")
    ns = c["count"].shape[1]
    seg = res["minutes"] // 5 - res["base_bucket"][:, None]
    in_range = o["valid"] & (seg >= 0) & (seg < ns)
    check(int(c["count"].sum()) == int(in_range.sum()),
          f"{what}: 5-min counts sum to the valid in-range 1-min candles")
    # volume: every 1-min volume of a valid 5-min bucket, summed in float64,
    # against the float64 sum of the float32 5-min volumes; each bucket is
    # a float32 sum of <= 5 non-negative values (<= 4 eps32 relative)
    in_valid = in_range & np.take_along_axis(c["valid"], np.clip(seg, 0, ns - 1), axis=1)
    vol_in = float(o["volume"][in_valid].astype(np.float64).sum())
    candles64 = segment_ohlcv.Candles(**{k: t(v) for k, v in c.items()})
    candles64 = candles64._replace(volume=candles64.volume.double())
    stats = segment_ohlcv.reconstruction_stats(int(in_range.sum()), candles64, vol_in)
    pres = float(stats["volume_preservation"])
    check(pres <= 4 * EPS32, f"{what}: volume preservation {pres:.3e} <= 4 eps32")
    return {"interp": int(res["valid"].sum()), "m1": int(o["valid"].sum()),
            "m5": int(c["valid"].sum()), "preservation": pres}


def pipeline_main_path(runner, tasks, segment_ohlcv, agg, tridiag) -> dict:
    """2,048 symbols through ``fused_batch`` on the card in 8 batches of
    256, then one cubic batch; (c) and (d) on every batch."""
    P = PIPELINE
    rng = np.random.default_rng(15)
    t0 = time.perf_counter()
    start = int(np.datetime64("2023-03-20T09:00", "m").astype(np.int64))
    chain = make_chain(rng, P["symbols"], P["hours"], P["drop_frac"])
    B = P["batch"]
    batches = [pack_compact(chain, np.arange(i, i + B), start, P["bucket"], tasks.ALL_COLS)
               for i in range(0, P["symbols"], B)]
    # the cubic batch needs one observation count per batch: nothing dropped
    cubic_chain = make_chain(rng, B, P["hours"], 0.0)
    cubic_batch = pack_compact(cubic_chain, np.arange(B), start, P["bucket"],
                               tasks.ALL_COLS)
    n_in = int(chain[4].sum())
    log(f"  data: {P['symbols']} symbols x {P['hours']} hours, {n_in:,} input rows "
        f"after dropping {P['drop_frac']:.0%}; {len(batches)} compact batches of {B} "
        f"x {P['bucket']} slots; made and packed in {time.perf_counter() - t0:.2f} s (host)")

    config = pipeline_config("linear")
    torch.cuda.reset_peak_memory_stats()
    stage_ms, walls, rows, kept = [], [], [], {}
    for i, batch in enumerate(batches):
        before = agg.aggregate_ohlcv_cuda.launches
        res, ms, wall = timed_batch(runner, batch, config)
        check(agg.aggregate_ohlcv_cuda.launches - before == 1,
              f"batch {i}: the candle stage launched kernel B2 exactly once")
        check(res["method"] == "linear" and res["filled"].shape == (B, 8, P["bucket"])
              and res["candles"]["count"].shape == (B, (P["bucket"] + 4) // 5 + 1),
              f"batch {i}: output shapes")
        rows.append(check_batch(res, segment_ohlcv, f"batch {i}"))
        stage_ms.append(ms)
        walls.append(wall)
        if i in P["cpu_batches"]:
            kept[i] = res
        log(f"  batch {i}: {wall * 1e3:.1f} ms host; device ms "
            + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()))
    peak_gb = torch.cuda.max_memory_allocated() / 2**30

    before = (tridiag.tridiag_solve_cuda.launches, agg.aggregate_ohlcv_cuda.launches)
    cubic, cubic_ms, cubic_wall = timed_batch(runner, cubic_batch, pipeline_config("cubic"))
    check(cubic["method"] == "cubic", "the cubic batch ran the cubic method")
    check(tridiag.tridiag_solve_cuda.launches - before[0] == 1
          and agg.aggregate_ohlcv_cuda.launches - before[1] == 1,
          "the cubic batch launched B1 and B2 once each")
    cubic_rows = check_batch(cubic, segment_ohlcv, "cubic batch")
    log(f"  cubic batch: {cubic_wall * 1e3:.1f} ms host; device ms "
        + ", ".join(f"{k} {v:.3f}" for k, v in cubic_ms.items()))

    total = {k: sum(r[k] for r in rows) for k in ("interp", "m1", "m5")}
    out_rows = sum(total.values())
    warm = {k: float(np.mean([m[k] for m in stage_ms[1:]])) for k in STAGES}
    rate = out_rows / sum(walls)
    log(f"  rows out: {total['interp']:,} interpolated, {total['m1']:,} 1-min candles, "
        f"{total['m5']:,} 5-min candles ({out_rows:,}) from {n_in:,} input rows")
    log(f"  end to end ({len(walls)} batches, host clock incl. readback): {sum(walls):.3f} s, "
        f"{rate:,.0f} output rows/s; warm batch median "
        f"{sorted(walls[1:])[len(walls[1:]) // 2] * 1e3:.1f} ms")
    log(f"  warm device ms per batch (mean of batches 1-{len(walls) - 1}): "
        + ", ".join(f"{k} {v:.3f}" for k, v in warm.items())
        + f"; sum {sum(warm.values()):.3f}")
    log(f"  peak device memory {peak_gb:.2f} GiB; max volume preservation "
        f"{max(r['preservation'] for r in rows + [cubic_rows]):.3e}")
    return {"batches": batches, "kept": kept, "config": config, "cubic_batch": cubic_batch,
            "cubic": cubic, "rows_per_s": rate, "warm_stage_ms": warm,
            "peak_gb": peak_gb}


def near_band(o, base, min_spread):
    """Rows whose high - low sits on the minimum-spread band (the bridge's
    narrow branch): mid +/- base * min_spread / 2, to rounding."""
    band = base * min_spread
    return np.abs((o["high"] - o["low"]) - band) <= 2e-4 + 16 * EPS32 * base


def compare_fused(gpu, cpu, config, what, filled_scale=None) -> dict:
    """(b)/(e): the card's fused batch against the same batch on CPU tensors.
    Exact: keys, price columns, masks, quality verdicts, candle counts.
    ``filled`` within 2 ulps of max(1, |x|) (or 64 eps32 of each column's
    largest |x| for the cubic path, ``filled_scale``), greeks within 64
    eps32 of each greek's largest |x| (log/exp/ndtr differ in ulps between
    the devices). OHLC and volume after rounding: within 8 ulps plus one
    rounding step (max(1e-4 or 1e-6, ulp(x))); a value beyond that must be
    a minimum-spread flip (``near_band`` in either run), at most 0.1 % of
    the rows; values that differ at all are counted, at most 1 %."""
    for k in ("keys", "price_col", "valid", "is_interpolated", "minutes",
              "base_bucket", "quality_ok"):
        check(np.array_equal(gpu[k], cpu[k]), f"{what}: {k} equal")
    check(gpu["failed"] == cpu["failed"], f"{what}: same failed symbols")
    for stage in ("ohlcv", "candles"):
        check(np.array_equal(gpu[stage]["valid"], cpu[stage]["valid"]),
              f"{what}: {stage} valid equal")
    check(np.array_equal(gpu["candles"]["count"], cpu["candles"]["count"]),
          f"{what}: candle counts equal")
    nan_same = lambda a, b: np.array_equal(np.isnan(a), np.isnan(b))
    a, b = gpu["filled"].astype(np.float64), cpu["filled"].astype(np.float64)
    check(nan_same(a, b), f"{what}: filled NaN masks equal")
    d = np.nan_to_num(np.abs(a - b))
    if filled_scale is None:
        bound = 2 * EPS32 * np.maximum(1.0, np.abs(np.nan_to_num(b)))
    else:
        bound = filled_scale * EPS32 * np.nanmax(np.abs(b), axis=(0, 2), keepdims=True)
    filled_err = float(d.max())
    check(bool((d <= bound).all()), f"{what}: filled within its bound (max {filled_err:.3e})")
    greek_err = 0.0
    for name, g in cpu["greeks"].items():
        e = np.nan_to_num(np.abs(gpu["greeks"][name].astype(np.float64) - g))
        scale = float(np.nanmax(np.abs(g)))
        check(nan_same(gpu["greeks"][name], g) and e.max() <= 64 * EPS32 * scale,
              f"{what}: greek {name} within 64 eps32 of {scale:.3e} (max {e.max():.3e})")
        greek_err = max(greek_err, float(e.max()) / scale)
    base = np.take_along_axis(cpu["filled"], cpu["price_col"][:, None, None],
                              axis=1)[:, 0].astype(np.float64)
    ms = config.data_bridge.min_spread_percent
    flips, beyond_rows, worst = 0, np.zeros(base.shape, bool), 0.0
    o_ok = cpu["ohlcv"]["valid"]
    for f in ("open", "high", "low", "close", "volume"):
        x, y = gpu["ohlcv"][f].astype(np.float64), cpu["ohlcv"][f].astype(np.float64)
        ulp = np.spacing(np.abs(y).astype(np.float32)).astype(np.float64)
        step = np.maximum(1e-6 if f == "volume" else 1e-4, ulp)
        dd = np.where(o_ok, np.abs(x - y), 0.0)
        flips += int((dd > 0).sum())
        beyond_rows |= o_ok & ~(dd <= step + 8 * EPS32 * np.abs(y))
        worst = max(worst, float(dd.max()))
    n_beyond = int(beyond_rows.sum())
    check(flips <= 0.01 * 5 * max(int(o_ok.sum()), 1),
          f"{what}: at most 1 % of the 1-min OHLCV values differ ({flips})")
    check(n_beyond <= 1e-3 * max(int(o_ok.sum()), 1)
          and bool((near_band(gpu["ohlcv"], base, ms) | near_band(cpu["ohlcv"], base, ms))
                   [beyond_rows].all()),
          f"{what}: 1-min rows beyond one rounding step are minimum-spread flips "
          f"({n_beyond})")
    # 5-min: selections and sums of the 1-min values; buckets holding a row
    # beyond one step are excused like the row
    c_ok = cpu["candles"]["valid"]
    ns = c_ok.shape[1]
    seg = np.clip(cpu["minutes"] // 5 - cpu["base_bucket"][:, None], 0, ns - 1)
    excused = np.zeros(c_ok.shape, bool)
    rb, rl = np.nonzero(beyond_rows)
    excused[rb, seg[rb, rl]] = True
    for f in ("open", "high", "low", "close", "volume"):
        x, y = gpu["candles"][f].astype(np.float64), cpu["candles"][f].astype(np.float64)
        ulp = np.spacing(np.abs(y).astype(np.float32)).astype(np.float64)
        if f == "volume":   # a float32 sum of <= 5 rounded 1-min volumes
            bound = 5 * np.maximum(1e-6, ulp) + 16 * EPS32 * np.abs(y)
        else:
            bound = np.maximum(1e-4, ulp) + 8 * EPS32 * np.abs(y)
        dd = np.where(c_ok & ~excused, np.abs(x - y), 0.0)
        check(bool(np.where(c_ok & ~excused, dd <= bound, True).all()),
              f"{what}: 5-min {f} within one rounding step (max {dd.max():.3e})")
    log(f"  {what}: card vs CPU tensors: filled max {filled_err:.3e}, greeks max "
        f"{greek_err:.3e} of scale, 1-min OHLCV values that differ {flips} of "
        f"{5 * int(o_ok.sum()):,} (max {worst:.3e}), beyond one step {n_beyond}")
    return {"filled": filled_err, "greeks": greek_err, "flips": flips, "beyond": n_beyond}


def pipeline_checks(main, runner, tasks, agg) -> dict:
    """(a) B2 at the candle stage on a real batch, (b) batch 0 on CPU
    tensors, (e) the cubic batch on CPU tensors; none counts toward the
    main path's launches."""
    config = main["config"]
    batch = main["batches"][0]
    dev = runner.dispatch(batch, config, DEV)
    ohlcv = dev["ohlcv"]
    ns = dev["candles"]["count"].shape[1]
    shifted = dev["minutes"] - dev["base_bucket"][:, None] * 5
    check(shifted.dtype == torch.int64, "the candle stage's minutes are int64")
    ticks = [shifted, ohlcv["open"], ohlcv["high"], ohlcv["low"], ohlcv["close"],
             ohlcv["volume"], ohlcv["valid"]]
    seg_kw = dict(num_segments=ns, min_count=5)
    kw = dict(bucket_minutes=5, **seg_kw)
    got = agg.aggregate_ohlcv_cuda(*ticks, **kw)
    torch.cuda.synchronize()
    ref = agg.aggregate_ohlcv_plain(*ticks, **kw)
    b2_err = compare_candles(got, ref, ticks, 5, 0, ns, f"candle stage {tuple(shifted.shape)} -> {ns}")
    stage = lambda: tasks.candles_batch(dev["minutes"], ohlcv, 5, dev["base_bucket"], **seg_kw)
    via_tasks = stage()
    for f in ("open", "high", "low", "close", "count", "valid"):
        check(same_with_nan(getattr(via_tasks, f), getattr(ref, f)),
              f"candles_batch's per-row base shift: {f} exact")
    # the same stage in float64 launches the float64 kernel (selections
    # are the float32 values widened: exact); mixed value dtypes raise
    wide = [ticks[0], *(a.double() for a in ticks[1:6]), ticks[6]]
    got64 = agg.aggregate_ohlcv_cuda(*wide, **kw)
    for f in ("open", "high", "low", "close"):
        check(same_with_nan(getattr(got64, f), getattr(ref, f).double()),
              f"candle stage in float64: {f} is the float32 selection")
    compare_candles(got64, agg.aggregate_ohlcv_plain(*wide, **kw), wide, 5, 0, ns,
                    "candle stage in float64")
    try:
        agg.aggregate_ohlcv_cuda(ticks[0], ticks[1].double(), *ticks[2:], **kw)
        check(False, "mixed value dtypes on a CUDA batch raise")
    except TypeError:
        pass
    del wide, got64
    # the stage as the pipeline calls it (int64 minutes, the per-row
    # shift, the kernel) captured in a CUDA graph: the wrapper reads
    # nothing back from the device
    stage_ms = device_ms(stage, 20, CALLS)
    kernel_ms = device_ms(lambda: agg.aggregate_ohlcv_cuda(*ticks, **kw), 20, CALLS)
    log(f"  (a) candle stage {tuple(shifted.shape)} -> {ns}, int64 minutes, from a CUDA "
        f"graph: candles_batch {stage_ms:.4f} ms, of which B2 {kernel_ms:.4f} ms; "
        f"max|volume kernel-plain| {b2_err:.3e}")
    del dev, got, ref, via_tasks, ticks, shifted, ohlcv

    errs = {}
    for i, gpu in main["kept"].items():
        t0 = time.perf_counter()
        cpu = runner.fused_batch(main["batches"][i], config, "cpu")
        log(f"  (b) batch {i} on CPU tensors in {time.perf_counter() - t0:.1f} s")
        errs[i] = compare_fused(gpu, cpu, config, f"batch {i}")
    t0 = time.perf_counter()
    cubic_cfg = pipeline_config("cubic")
    cpu = runner.fused_batch(main["cubic_batch"], cubic_cfg, "cpu")
    log(f"  (e) cubic batch on CPU tensors in {time.perf_counter() - t0:.1f} s")
    check(cpu["method"] == "cubic", "the CPU cubic batch ran the cubic method")
    errs["cubic"] = compare_fused(main["cubic"], cpu, cubic_cfg, "cubic batch",
                                  filled_scale=64)
    return {"b2_err": b2_err, "errs": errs}


def first_rows(res: dict, k: int, symbols) -> dict:
    """A fused batch's result cut to its first ``k`` rows (``symbols``
    their names): every array's batch axis, the failed symbols among
    them."""
    def cut(v):
        if isinstance(v, dict):
            return {key: cut(x) for key, x in v.items()}
        return v[:k] if isinstance(v, np.ndarray) else v
    out = {key: cut(v) for key, v in res.items() if key != "failed"}
    out["failed"] = {s: r for s, r in res["failed"].items() if s in set(symbols)}
    return out


def cubic_30_day(runner, tasks, segment_ohlcv, tridiag, reset_counts, read_by_dtype) -> dict:
    """Phase 5 (a): the 30-day cubic batch (CUBIC30) through ``fused_batch``
    on the card in float32 and float64: B1 and B2 once each, B1 on the
    partitioned route, OHLC integrity, the quality gate, candle counts and
    volume preservation, device ms by stage; its first 32 symbols against
    the same symbols on CPU tensors, float32 at phase 5's cubic
    tolerances, float64 with keys, masks and candle counts equal and
    ``filled`` within 1e-9 of max(1, |x|). Returns each dtype's B1 and B2
    launches and routes, stage ms and host seconds."""
    P = CUBIC30
    rng = np.random.default_rng(P["seed"])
    start = int(np.datetime64("2023-03-20T09:00", "m").astype(np.int64))
    chain = make_chain(rng, P["symbols"], P["hours"], 0.0)
    pack = lambda k, dtype: pack_compact(chain, np.arange(k), start, P["bucket"],
                                         tasks.ALL_COLS, np.dtype(dtype))
    out, kept = {}, {}
    for dtype in ("float32", "float64"):
        batch = pack(P["symbols"], dtype)
        config = pipeline_config("cubic")
        config.processing.dtype = dtype
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        res, ms, wall = timed_batch(runner, batch, config)
        counts = read_by_dtype()
        by_route = dict(tridiag.tridiag_solve_cuda.launches_by_route)
        b1 = "b1_f32" if dtype == "float32" else "b1_f64"
        check(res["method"] == "cubic" and res["filled"].shape == (P["symbols"], 8, P["bucket"])
              and res["filled"].dtype == np.dtype(dtype),
              f"(a) the 30-day batch ran cubic in {dtype}, {res['filled'].shape}")
        check(counts[b1] == 1 and sum(counts.values()) == 2 and counts["b2"] == 1
              and by_route == {"staged": 0, "partitioned": 1, "scratch": 0},
              f"(a) {dtype}: B1 once on the partitioned route and B2 once: {counts}, {by_route}")
        rows = check_batch(res, segment_ohlcv, f"(a) 30-day cubic batch {dtype}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"  (a) 30-day cubic batch {P['symbols']} x {P['hours']} h -> {P['bucket']} "
            f"minutes, {dtype}: {wall * 1e3:.1f} ms host incl. readback, peak {peak:.2f} GiB; "
            f"device ms " + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
            + f"; B1 {by_route}, {rows['interp']:,} interpolated rows")
        out[dtype] = {"counts": counts, "by_route": by_route, "stage_ms": ms, "host_s": wall,
                      "peak_gb": peak}
        kept[dtype] = first_rows(res, P["cpu"], batch.symbols[:P["cpu"]])
        del res
    config = pipeline_config("cubic")
    t0 = time.perf_counter()
    cpu = runner.fused_batch(pack(P["cpu"], "float32"), config, "cpu")
    log(f"  (a) its first {P['cpu']} symbols on CPU tensors in {time.perf_counter() - t0:.1f} s")
    out["float32"]["cpu"] = compare_fused(kept["float32"], cpu, config,
                                          "(a) 30-day cubic batch float32", filled_scale=64)
    config.processing.dtype = "float64"
    cpu = runner.fused_batch(pack(P["cpu"], "float64"), config, "cpu")
    gpu = kept["float64"]
    for k in ("keys", "price_col", "valid", "is_interpolated", "minutes", "base_bucket"):
        check(np.array_equal(gpu[k], cpu[k]), f"(a) 30-day float64: {k} equal")
    check(np.array_equal(gpu["candles"]["count"], cpu["candles"]["count"]),
          "(a) 30-day float64: candle counts equal")
    a, b = gpu["filled"], cpu["filled"]
    check(np.array_equal(np.isnan(a), np.isnan(b)), "(a) 30-day float64: filled NaN masks equal")
    d = np.nan_to_num(np.abs(a - b)) / np.maximum(1.0, np.abs(np.nan_to_num(b)))
    check(float(d.max()) <= 1e-9, f"(a) 30-day float64: filled within 1e-9 ({d.max():.3e})")
    log(f"  (a) 30-day float64 vs CPU tensors on {P['cpu']} symbols: keys, masks and candle "
        f"counts equal, filled max rel err {d.max():.3e}")
    out["float64"]["filled_rel_err"] = float(d.max())
    return out


# -- phase 6: the host runner -------------------------------------------------

def make_store(st, root):
    """A parquet store under ``root`` when pyarrow imports, else a memory
    store: a choice of store, not of device."""
    shutil.rmtree(root, ignore_errors=True)
    try:
        import pyarrow  # noqa: F401
    except ImportError:
        return st.MemoryStore()
    return st.ParquetStore(str(root))


def runner_config(get_config, work, batch: int, method: str = "linear"):
    """``get_config("production")`` (float32, 5-minute candles, greeks,
    the quality gate, the 16,384 bucket) with its run files under
    ``work`` and the given batch size and method."""
    cfg = get_config("production")
    cfg.processing.batch_size = batch
    cfg.interpolation.method = method
    cfg.checkpoint.manifest_dir = str(work / "runs")
    cfg.monitoring.snapshot_dir = str(work / "snapshots")
    return cfg


class DispatchProbe:
    """Wraps ``runner.dispatch`` while installed: CUDA events before and
    after each batch's stages (device busy time), and the method each
    batch ran."""

    def __init__(self, runner_mod):
        self.mod, self.orig = runner_mod, runner_mod.dispatch
        self.events, self.methods = [], []

    def __enter__(self):
        def probed(batch, config, device, on_stage=None, mesh=None):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            dev = self.orig(batch, config, device, on_stage, mesh=mesh)
            end.record()
            self.events.append((start, end))
            self.methods.append(dev["method"])
            return dev
        self.mod.dispatch = probed
        return self

    def __exit__(self, *exc):
        self.mod.dispatch = self.orig

    def busy_ms(self) -> float:
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.events)


TABLE_KEYS = {"interpolated_trading_tickers": ["symbol", "date"],
              "minute_candles": ["symbol", "timestamp"],
              "reconstructed_candles": ["symbol", "timestamp", "frequency"]}


def read_table(store, table, symbols=None):
    """A table sorted by its upsert keys, symbols as str, without the
    columns that name a run (batch_id, created_at)."""
    df = store.read(table, symbols=symbols)
    df = df.drop(columns=[c for c in ("batch_id", "created_at") if c in df.columns])
    df["symbol"] = df["symbol"].astype(str)
    return df.sort_values(TABLE_KEYS[table]).reset_index(drop=True)


def tables_equal(a_store, b_store, what: str, symbols=None) -> int:
    """Every table equal (over ``symbols`` when given), value for value,
    except the 5-minute volume: a float32 sum of <= 5 one-minute volumes,
    within 8 eps32 of it (the kernel's atomics may add a bucket's parts in
    another order). Returns the number of 5-minute volumes that differ at
    all."""
    import pandas as pd
    differ = 0
    for table in TABLE_KEYS:
        a, b = read_table(a_store, table, symbols), read_table(b_store, table, symbols)
        if table == "reconstructed_candles":
            va, vb = a.pop("volume").to_numpy(np.float64), b.pop("volume").to_numpy(np.float64)
            check(len(va) == len(vb) and bool((np.abs(va - vb) <= 8 * EPS32 * np.abs(vb)).all()),
                  f"{what}: 5-min volume within 8 eps32")
            differ = int((va != vb).sum())
        try:
            pd.testing.assert_frame_equal(a, b)
        except AssertionError as e:
            check(False, f"{what}: {table} equal ({str(e)[:300]})")
    return differ


def compare_tables_cpu(card, cpu, symbols, min_spread, cubic_scale=None) -> dict:
    """(c): the card's tables for ``symbols`` against the same symbols run
    on CPU tensors, at phase 5's tolerances: keys, flags and counts exact;
    interpolated values within 2 ulps of max(1, |x|) (a cubic run's
    spline columns, ``cubic_scale`` given: within that many eps32 of each
    column's largest |x|, phase 5's cubic bound), greeks within 64 eps32
    of each greek's largest |x|; 1-minute OHLCV within one rounding step
    plus 8 ulps, a row beyond that a minimum-spread flip (at most 0.1 % of
    rows), values that differ at all at most 1 %; 5-minute candles within
    one step unless their bucket holds such a row."""
    from iv_interpolation_tpu_torch.pipeline.ingest import INTERP_COLS
    interp = [read_table(s, "interpolated_trading_tickers", symbols) for s in (card, cpu)]
    a, b = interp
    same = lambda x, y, cols: all(np.array_equal(x[c].to_numpy(), y[c].to_numpy())
                                  for c in cols)
    check(len(a) == len(b) and same(a, b, ("symbol", "date")),
          "(c) interpolated keys equal")
    check(same(a, b, ("is_interpolated", "strike", "callput")),
          "(c) interpolated flags, strikes and call/put equal")
    worst = {}
    for c in ("iv", "underlying_price", "time_to_maturity", "interest_rate", "mark_price",
              "index_price", "volume", "quote_volume"):
        x, y = a[c].to_numpy(np.float64), b[c].to_numpy(np.float64)
        check(np.array_equal(np.isnan(x), np.isnan(y)), f"(c) {c} NaN mask")
        d = np.nan_to_num(np.abs(x - y))
        if cubic_scale is not None and c in INTERP_COLS:
            bound = cubic_scale * EPS32 * np.nanmax(np.abs(y))
        else:
            bound = 2 * EPS32 * np.maximum(1.0, np.abs(np.nan_to_num(y)))
        check(bool((d <= bound).all()), f"(c) {c} within its bound (max {d.max():.3e})")
        worst[c] = float(d.max())
    for g in ("delta", "gamma", "theta", "vega", "rho"):
        x, y = a[g].to_numpy(np.float64), b[g].to_numpy(np.float64)
        scale = float(np.nanmax(np.abs(y)))
        d = np.nan_to_num(np.abs(x - y))
        check(np.array_equal(np.isnan(x), np.isnan(y)) and d.max() <= 64 * EPS32 * scale,
              f"(c) greek {g} within 64 eps32 of {scale:.3e} (max {d.max():.3e})")
    m = [read_table(s, "minute_candles", symbols) for s in (card, cpu)]
    check(len(m[0]) == len(m[1]) and same(m[0], m[1], ("symbol", "timestamp")),
          "(c) 1-min keys equal")
    base = m[1].merge(b[["symbol", "date", "underlying_price"]],
                      left_on=["symbol", "timestamp"], right_on=["symbol", "date"],
                      how="left")["underlying_price"].to_numpy(np.float64)
    band = base * min_spread
    near = lambda f: np.abs((f["high"].to_numpy(np.float64) - f["low"].to_numpy(np.float64))
                            - band) <= 2e-4 + 16 * EPS32 * base
    beyond, flips = np.zeros(len(base), bool), 0
    for f in ("open", "high", "low", "close", "volume"):
        x, y = m[0][f].to_numpy(np.float64), m[1][f].to_numpy(np.float64)
        ulp = np.spacing(np.abs(y).astype(np.float32)).astype(np.float64)
        dd = np.abs(x - y)
        flips += int((dd > 0).sum())
        beyond |= ~(dd <= np.maximum(1e-6 if f == "volume" else 1e-4, ulp) + 8 * EPS32 * np.abs(y))
    n_beyond = int(beyond.sum())
    check(flips <= 0.01 * 5 * len(base), f"(c) at most 1 % of 1-min values differ ({flips})")
    check(n_beyond <= 1e-3 * len(base) and bool((near(m[0]) | near(m[1]))[beyond].all()),
          f"(c) 1-min rows beyond one step are minimum-spread flips ({n_beyond})")
    r = [read_table(s, "reconstructed_candles", symbols) for s in (card, cpu)]
    check(len(r[0]) == len(r[1]) and same(r[0], r[1], ("symbol", "timestamp", "source_candles")),
          "(c) 5-min keys equal")
    bucket = m[1]["timestamp"].dt.floor("5min")
    excused = set(zip(m[1]["symbol"][beyond], bucket[beyond]))
    ok = ~np.fromiter(((s, t) in excused for s, t in zip(r[1]["symbol"], r[1]["timestamp"])),
                      bool, len(r[1]))
    for f in ("open", "high", "low", "close", "volume"):
        x, y = r[0][f].to_numpy(np.float64), r[1][f].to_numpy(np.float64)
        ulp = np.spacing(np.abs(y).astype(np.float32)).astype(np.float64)
        bound = (5 * np.maximum(1e-6, ulp) + 16 * EPS32 * np.abs(y) if f == "volume"
                 else np.maximum(1e-4, ulp) + 8 * EPS32 * np.abs(y))
        check(bool((np.abs(x - y) <= bound)[ok].all()), f"(c) 5-min {f} within one step")
    log(f"  (c) {len(symbols)} symbols on CPU tensors: {len(a):,} / {len(base):,} / "
        f"{len(r[1]):,} rows; filled max err {max(worst.values()):.3e}, 1-min values "
        f"that differ {flips}, rows beyond one step {n_beyond}")
    return {"flips": flips, "beyond": n_beyond}


def host_runner(reset_counts, read_counts) -> dict:
    """Phase 6: ``PipelineRunner`` from store to store. (a) 2,048 symbols
    x 168 hourly rows through ``run_pipeline_fused`` on the card, (b) its
    rows/s, host split, idle share and peak memory; (c) the manifests, row
    counts, audits, one B2 launch a batch, the host packer, and the first
    batch's symbols on CPU tensors; then (d) and (e). Returns the launches
    of the runs that count, rows/s and the store."""
    from iv_interpolation_tpu_torch.config import get_config
    from iv_interpolation_tpu_torch.pipeline import check_results
    from iv_interpolation_tpu_torch.pipeline import runner as runner_mod
    from iv_interpolation_tpu_torch.pipeline import storage as st
    from iv_interpolation_tpu_torch.pipeline.sample_data import generate_sample_tickers

    P = RUNNER
    root = Path(__file__).resolve().parent
    work = root / "build" / "chip_smoke_runner"
    t0 = time.perf_counter()
    tickers = generate_sample_tickers(num_symbols=P["symbols"], hours=P["hours"],
                                      seed=P["seed"], drop_frac=P["drop_frac"])
    log(f"  data: {P['symbols']} symbols x {P['hours']} hours, {len(tickers):,} rows, "
        f"made in {time.perf_counter() - t0:.2f} s (host, set-up)")

    def full_run(name):
        store = make_store(st, work / name / "data")
        store.write(st.TICKERS, tickers, upsert_keys=["symbol", "date"])
        cfg = runner_config(get_config, work / name, P["batch"])
        runner = runner_mod.PipelineRunner(cfg, store)
        runner.queue_depth = 2
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        with DispatchProbe(runner_mod) as probe:
            t = time.perf_counter()
            res = runner.run_pipeline_fused()
            wall = time.perf_counter() - t
        counts = read_counts()
        rows = sum(res[k]["output_rows"] for k in ("task1", "bridge", "task2"))
        busy = probe.busy_ms() / 1e3
        return dict(store=store, res=res, wall=wall, rows=rows, rate=rows / wall,
                    busy=busy, idle=1 - busy / wall, host=dict(runner.host_s),
                    peak=torch.cuda.max_memory_allocated() / 2**30, counts=counts,
                    batches=len(probe.events))

    # (a), (b)
    kind = "parquet" if module_version("pyarrow") != "missing" else "memory"
    log(f"  store: {kind} (pyarrow {module_version('pyarrow')}) — the choice of store, "
        f"not of device")
    main = full_run("main")
    res = main["res"]
    log(f"  (a) run_pipeline_fused, 2 batches in flight: {main['wall']:.3f} s, "
        f"{main['rows']:,} output rows, {main['rate']:,.0f} output rows/s; "
        f"{main['batches']} batches, launches {main['counts']}")
    log("  (b) host s: " + ", ".join(f"{k} {v:.3f}" for k, v in sorted(main["host"].items()))
        + f"; device busy {main['busy']:.3f} s, idle share {main['idle']:.1%}, "
        f"peak device memory {main['peak']:.2f} GiB")
    # (c)
    store = main["store"]
    for k in ("task1", "bridge", "task2"):
        by = res[k]["by_status"]
        check(set(by) <= {"completed", "skipped"} and sum(by.values()) == P["symbols"],
              f"(c) {k}: every symbol completed or skipped, none in error: {by}")
    for k, table in (("task1", st.INTERPOLATED), ("bridge", st.MINUTE_CANDLES),
                     ("task2", st.RECONSTRUCTED)):
        check(store.count(table) == res[k]["output_rows"],
              f"(c) {table}: {store.count(table)} rows = the manifest's {res[k]['output_rows']}")
    check(main["counts"] == {"b1": 0, "b2": main["batches"]}
          and main["batches"] == P["symbols"] // P["batch"],
          f"(c) B2 once a batch, {main['batches']} batches: {main['counts']}")
    packer = res["packer"]
    check(packer.get("gather native", 0) >= main["batches"] and "gather numpy" not in packer,
          f"(c) the native host packer gathered every batch's rows: {packer}")
    log(f"  (c) host packer: {packer}, gathers {main['host']['gather']:.3f} s of unpack "
        f"{main['host']['unpack']:.3f} s")
    audit1 = check_results.check_interpolation_results(store)
    audit2 = check_results.check_candle_results(store)
    sample = check_results.compare_minute_vs_reconstructed(store, n=12)
    check(audit1["ok"] and audit1["symbols"] == P["symbols"], "(c) task 1 audit")
    check(audit2["ok"] and audit2["invalid_ohlc_rows"] == 0
          and audit2["negative_volume_rows"] == 0, "(c) task 2 audit: OHLC integrity")
    check(len(sample) == 12 and bool(sample["matches"].all())
          and bool((sample["src_count"] >= 5).all()),
          "(c) 5-min candles are their 1-min candles, >= 5 each")
    log(f"  (c) audits: expansion {audit1['expansion_ratio']:.1f}, compression "
        f"{audit2['compression_ratio']:.2f}, {audit2['valid_ohlc_rows']:,} valid OHLC rows")
    first = sorted(tickers["symbol"].unique())[:P["batch"]]
    cpu_store = st.MemoryStore()
    cpu_store.write(st.TICKERS, tickers[tickers["symbol"].isin(first)])
    t = time.perf_counter()
    cpu_cfg = runner_config(get_config, work / "cpu", P["batch"])
    runner_mod.PipelineRunner(cpu_cfg, cpu_store, device="cpu").run_pipeline_fused()
    log(f"  (c) the first batch's {len(first)} symbols on CPU tensors in "
        f"{time.perf_counter() - t:.1f} s")
    compare_tables_cpu(store, cpu_store, first, cpu_cfg.data_bridge.min_spread_percent)
    del cpu_store
    shutil.rmtree(work / "main", ignore_errors=True)
    small = runner_small_scale(work, reset_counts, read_counts)
    f64 = runner_float64(work, reset_counts)
    runner_cli(root, work)
    shutil.rmtree(work, ignore_errors=True)
    return {"launches": {k: main["counts"][k] + small[k] for k in main["counts"]},
            "b2_f64_launches": f64, "rows_per_s": main["rate"], "store": kind}


def runner_small_scale(work, reset_counts, read_counts) -> dict:
    """Phase 6 (d), 512 symbols x 2 days, 64 a batch: a run stopped after
    two batches and resumed against an uninterrupted one, a staged
    ``run_all`` against it (B2 once a ``run_task2`` batch), and a cubic run
    with mixed observation counts (B1 and B2 once a sub-batch). Returns
    the launches of the staged and cubic runs."""
    from iv_interpolation_tpu_torch.config import get_config
    from iv_interpolation_tpu_torch.pipeline import runner as runner_mod
    from iv_interpolation_tpu_torch.pipeline import storage as st
    from iv_interpolation_tpu_torch.pipeline.sample_data import generate_sample_tickers

    P = RUNNER
    small = generate_sample_tickers(num_symbols=P["small_symbols"], hours=P["small_hours"],
                                    seed=P["seed"] + 1, drop_frac=P["drop_frac"])

    def small_runner(name, method="linear", batch=P["small_batch"]):
        store = make_store(st, work / name / "data")
        store.write(st.TICKERS, small, upsert_keys=["symbol", "date"])
        return runner_mod.PipelineRunner(
            runner_config(get_config, work / name, batch, method), store)

    whole = small_runner("whole")
    whole.run_pipeline_fused()
    stopped = small_runner("stopped")
    attempts, orig_attempt = [], stopped._attempt

    def stop_after_two(label, fn):
        attempts.append(label)
        if len(attempts) == 2:
            stopped.request_stop()
        return orig_attempt(label, fn)

    stopped._attempt = stop_after_two
    s1 = stopped.run_pipeline_fused()
    pending = s1["task1"]["by_status"].get("pending", 0)
    check(pending > 0, f"(d) the stopped run left symbols pending: {s1['task1']['by_status']}")
    resumed = runner_mod.PipelineRunner(stopped.config, stopped.store)
    s2 = resumed.run_pipeline_fused(resume_batch_id=s1["task1"]["batch_id"])
    check(s2["task1"]["by_status"] == {"completed": P["small_symbols"]},
          f"(d) the resumed run completed every symbol: {s2['task1']['by_status']}")
    resume_differ = tables_equal(resumed.store, whole.store, "(d) stopped + resumed vs whole")
    staged = small_runner("staged")
    reset_counts()
    s3 = staged.run_all()
    staged_counts = read_counts()
    n_task2 = sum(1 for rec in staged.metrics.steps if rec["name"].startswith("candles/"))
    check(staged_counts == {"b1": 0, "b2": n_task2} and n_task2 > 0,
          f"(d) run_all launched B2 once a run_task2 batch ({n_task2}): {staged_counts}")
    check(all(s3[k]["by_status"] == {"completed": P["small_symbols"]}
              for k in ("task1", "bridge", "task2")), "(d) run_all completed every symbol")
    staged_differ = tables_equal(staged.store, whole.store, "(d) staged vs fused")
    cubic = small_runner("cubic", "cubic", P["batch"])
    reset_counts()
    with DispatchProbe(runner_mod) as probe:
        s4 = cubic.run_pipeline_fused()
    cubic_counts = read_counts()
    n_sub = len(probe.methods)
    check(set(probe.methods) == {"cubic"} and n_sub > P["small_symbols"] // P["batch"],
          f"(d) every cubic sub-batch ran the cubic method: {probe.methods}")
    check(cubic_counts == {"b1": n_sub, "b2": n_sub},
          f"(d) B1 and B2 once a cubic sub-batch ({n_sub}): {cubic_counts}")
    check(s4["task2"]["by_status"] == {"completed": P["small_symbols"]},
          f"(d) the cubic run completed every symbol: {s4['task2']['by_status']}")
    log(f"  (d) {P['small_symbols']} symbols x {P['small_hours']} h: stopped after "
        f"{len(attempts)} batches ({pending} pending) and resumed = uninterrupted; staged "
        f"run_all = fused ({n_task2} task-2 batches); 5-min volumes that differ in the "
        f"last bit: {resume_differ} and {staged_differ}; cubic: {n_sub} sub-batches, "
        f"launches {cubic_counts}")
    return {k: staged_counts[k] + cubic_counts[k] for k in staged_counts}


def compare_tables_f64(card, cpu, what: str, symbols=None) -> float:
    """A float64 run's tables on the card against CPU tensors' (over
    ``symbols`` when given): the same rows and columns, non-float columns
    equal, NaN masks equal, and every float column within 1e-9 of max(1,
    |x|) in all but at most 0.1 % of its rows (a value that sits on a
    rounding step of the bridge may land on either side between the two
    devices' exp and log). Returns the worst column median."""
    worst = 0.0
    for table in TABLE_KEYS:
        a, b = read_table(card, table, symbols), read_table(cpu, table, symbols)
        check(len(a) == len(b) and list(a.columns) == list(b.columns),
              f"{what} {table}: {len(a)} rows on the card, {len(b)} on CPU tensors")
        for c in a.columns:
            x, y = a[c].to_numpy(), b[c].to_numpy()
            if x.dtype.kind != "f":
                check(bool((x == y).all()), f"{what} {table}.{c} equal")
                continue
            y = y.astype(np.float64)      # a memory store may keep an object column
            check(np.array_equal(np.isnan(x), np.isnan(y)), f"{what} {table}.{c} NaN mask")
            d = np.nan_to_num(np.abs(x - y)) / np.maximum(1.0, np.abs(np.nan_to_num(y)))
            off = float((d > 1e-9).mean())
            check(off <= 1e-3, f"{what} {table}.{c}: {off:.2%} of rows beyond 1e-9")
            worst = max(worst, float(np.median(d)))
        if table == "interpolated_trading_tickers":
            check(a["iv"].dtype == np.float64, f"{what}: the run persists float64")
    return worst


def runner_30_day(work, reset_counts, read_by_dtype, tridiag, ops_tridiag) -> dict:
    """Phase 6 (b): RUNNER30's 30-day cubic runs through
    ``run_pipeline_fused`` from a parquet store (memory if pyarrow is
    missing), float32 and float64: every symbol completed or skipped, none
    in error, table rows equal to the manifests', every batch split into
    cubic sub-batches, B1 and B2 once a sub-batch, every B1 launch on the
    partitioned route; the first 16 symbols' tables against the same
    symbols run on CPU tensors (float32 at phase 5's cubic tolerances,
    float64 within 1e-9). Returns each dtype's launches, routes, sub-batch
    count and B1 shapes (n, batch)."""
    from collections import Counter
    from iv_interpolation_tpu_torch.config import get_config
    from iv_interpolation_tpu_torch.pipeline import runner as runner_mod
    from iv_interpolation_tpu_torch.pipeline import storage as st
    from iv_interpolation_tpu_torch.pipeline.sample_data import generate_sample_tickers

    P = RUNNER30
    tickers = generate_sample_tickers(num_symbols=P["symbols"], hours=P["hours"],
                                      seed=P["seed"], drop_frac=P["drop_frac"])
    first = sorted(tickers["symbol"].unique())[:P["cpu_symbols"]]
    out = {}
    for dtype in ("float32", "float64"):
        name = f"30d_{dtype}"
        store = make_store(st, work / name / "data")
        store.write(st.TICKERS, tickers, upsert_keys=["symbol", "date"])
        cfg = runner_config(get_config, work / name, P["batch"], "cubic")
        cfg.processing.dtype = dtype
        shapes, solve = Counter(), ops_tridiag.tridiag_solve_cuda

        def recorded(dl, d, du, b):
            shapes[tuple(d.shape)] += 1
            return solve(dl, d, du, b)
        reset_counts()
        ops_tridiag.tridiag_solve_cuda = recorded
        try:
            with DispatchProbe(runner_mod) as probe:
                t = time.perf_counter()
                res = runner_mod.PipelineRunner(cfg, store).run_pipeline_fused()
                wall = time.perf_counter() - t
        finally:
            ops_tridiag.tridiag_solve_cuda = solve
        counts = read_by_dtype()
        by_route = dict(tridiag.tridiag_solve_cuda.launches_by_route)
        n_sub = len(probe.methods)
        b1 = "b1_f32" if dtype == "float32" else "b1_f64"
        check(set(probe.methods) == {"cubic"} and n_sub > 1,
              f"(b) {dtype}: the 30-day batch split into cubic sub-batches: {probe.methods}")
        check(counts[b1] == n_sub and counts["b2"] == n_sub and sum(counts.values()) == 2 * n_sub
              and by_route == {"staged": 0, "partitioned": n_sub, "scratch": 0},
              f"(b) {dtype}: B1 and B2 once a sub-batch ({n_sub}), every B1 launch on the "
              f"partitioned route: {counts}, {by_route}")
        check(all(tridiag.thomas_plan(n, getattr(torch, dtype), m).route == "partitioned"
                  for n, m in shapes) and (SUB_N, 48) in shapes,
              f"(b) {dtype}: every sub-batch shape plans to the partitioned route, phase 2's "
              f"sub-batch row ({SUB_N}, 48) among them: {dict(shapes)}")
        for k, table in (("task1", st.INTERPOLATED), ("bridge", st.MINUTE_CANDLES),
                         ("task2", st.RECONSTRUCTED)):
            by = res[k]["by_status"]
            check(set(by) <= {"completed", "skipped"} and by.get("completed", 0) > 0
                  and sum(by.values()) == P["symbols"],
                  f"(b) {dtype} {k}: every symbol completed or skipped, none in error: {by}")
            check(store.count(table) == res[k]["output_rows"] > 0,
                  f"(b) {dtype} {table}: {store.count(table)} rows = the manifest's")
        cpu_store = st.MemoryStore()
        cpu_store.write(st.TICKERS, tickers[tickers["symbol"].isin(first)])
        cpu_cfg = runner_config(get_config, work / f"{name}_cpu", P["batch"], "cubic")
        cpu_cfg.processing.dtype = dtype
        t = time.perf_counter()
        runner_mod.PipelineRunner(cpu_cfg, cpu_store, device="cpu").run_pipeline_fused()
        cpu_s = time.perf_counter() - t
        if dtype == "float32":
            cmp = compare_tables_cpu(store, cpu_store, first,
                                     cpu_cfg.data_bridge.min_spread_percent, cubic_scale=64)
        else:
            cmp = {"worst_median": compare_tables_f64(store, cpu_store, f"(b) {dtype}", first)}
        log(f"  (b) 30-day cubic runner {P['symbols']} x {P['hours']} h, {dtype}: {wall:.2f} s "
            f"on the card, {n_sub} sub-batches, B1 {by_route}, shapes (n, batch) "
            f"{dict(sorted(shapes.items()))}; statuses {res['task2']['by_status']}; its first "
            f"{len(first)} symbols on CPU tensors in {cpu_s:.1f} s: {cmp}")
        out[dtype] = {"counts": counts, "by_route": by_route, "sub_batches": n_sub,
                      "shapes": dict(shapes), "wall_s": wall}
        shutil.rmtree(work / name, ignore_errors=True)
    return out


def runner_float64(work, reset_counts) -> int:
    """Phase 6 (f): ``processing.dtype="float64"`` through
    ``run_pipeline_fused`` on the card, RUNNER_F64's 256 symbols x 2 days
    in 4 batches: every symbol completed or skipped (none in error), the
    tables' rows equal to the manifests', B2 launched once a batch in
    float64 and never in float32; against the same run on CPU tensors:
    the same statuses, keys and row counts, and every numeric column
    within 1e-9 of max(1, |x|) in all but at most 0.1 % of its rows (a
    value that sits on a rounding step of the bridge may land on either
    side between the two devices' exp and log). Returns the B2 float64
    launches."""
    from iv_interpolation_tpu_torch.config import get_config
    from iv_interpolation_tpu_torch.ops.cuda.stream_agg import aggregate_ohlcv_cuda
    from iv_interpolation_tpu_torch.pipeline import runner as runner_mod
    from iv_interpolation_tpu_torch.pipeline import storage as st
    from iv_interpolation_tpu_torch.pipeline.sample_data import generate_sample_tickers

    P = RUNNER_F64
    tickers = generate_sample_tickers(num_symbols=P["symbols"], hours=P["hours"],
                                      seed=P["seed"], drop_frac=RUNNER["drop_frac"])
    runs = {}
    for device in (DEV, "cpu"):
        store = st.MemoryStore()
        store.write(st.TICKERS, tickers)
        cfg = runner_config(get_config, work / f"f64_{device}", P["batch"])
        cfg.processing.dtype = "float64"
        if device == DEV:
            reset_counts()
        t = time.perf_counter()
        res = runner_mod.PipelineRunner(cfg, store, device=device).run_pipeline_fused()
        runs[device] = (store, res, time.perf_counter() - t)
    by_dtype = dict(aggregate_ohlcv_cuda.launches_by_dtype)
    store, res, wall = runs[DEV]
    n_batches = P["symbols"] // P["batch"]
    for k, table in (("task1", st.INTERPOLATED), ("bridge", st.MINUTE_CANDLES),
                     ("task2", st.RECONSTRUCTED)):
        by = res[k]["by_status"]
        check(set(by) <= {"completed", "skipped"} and sum(by.values()) == P["symbols"]
              and by.get("completed", 0) > 0,
              f"(f) float64 {k}: every symbol completed or skipped, none in error: {by}")
        check(by == runs["cpu"][1][k]["by_status"], f"(f) float64 {k}: statuses as on CPU tensors")
        check(store.count(table) == res[k]["output_rows"] > 0,
              f"(f) float64 {table}: {store.count(table)} rows = the manifest's")
    check(by_dtype == {"float32": 0, "float64": n_batches},
          f"(f) B2 float64 once a batch ({n_batches}), never float32: {by_dtype}")
    worst = compare_tables_f64(store, runs["cpu"][0], "(f) float64")
    log(f"  (f) float64 pipeline, {P['symbols']} symbols x {P['hours']} h in {n_batches} "
        f"batches: {wall:.2f} s on the card, {runs['cpu'][2]:.2f} s on CPU tensors; "
        f"statuses {res['task2']['by_status']}; B2 launches {by_dtype}; tables equal to CPU "
        f"tensors' within 1e-9 (worst column median {worst:.2e})")
    return by_dtype["float64"]


def runner_cli(root, work) -> None:
    """Phase 6 (e): ``iv-tpu-torch --task pipeline --storage memory --test
    --json`` in a subprocess on the card exits 0 with the JAX CLI's keys."""
    cli_dir = work / "cli"
    cli_dir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(root), os.environ.get("PYTHONPATH", "")) if p))
    cmd = [sys.executable, "-m", "iv_interpolation_tpu_torch.cli", "--task", "pipeline",
           "--storage", "memory", "--test", "--json"]
    proc = subprocess.run(cmd, cwd=cli_dir, env=env, capture_output=True, text=True,
                          timeout=300)
    check(proc.returncode == 0, f"(e) the CLI exits 0: {proc.stderr[-2000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    check({"task1", "bridge", "task2", "fused", "wall_s", "status"} <= set(out),
          f"(e) the CLI's JSON keys: {sorted(out)}")
    log(f"  (e) {' '.join(cmd[1:])}: exit 0, keys {sorted(out)}")


# -- phase 7: the surface task ----------------------------------------------

# expiries of the surface task's chains, days from the snapshot
SURFACE_DAYS = (7, 14, 21, 30, 46, 60, 74, 91, 109, 140, 200, 291)
SURFACE_RUNS = (("cubic_spline", "cubic_spline", {}),
                ("smoothing_spline", "smoothing_spline", {}),
                ("parity", "cubic_spline", {"compensated": True}),
                ("local vol", "cubic_spline", {"compute_local_vol": True}))


def make_surface_table(rng):
    """The ``interpolated`` table of SURFACE_TASK: per underlying its
    expiries x strikes, call and put at each strike (one iv), two
    snapshots a symbol (the older one an hour earlier with another iv and
    price, which the task must not use); about 2 % of the latest rows have
    NaN iv and a Black-Scholes mark price. Returns the frame and the
    latest rows' truth (symbol -> (underlying, T, k, iv))."""
    import pandas as pd
    from scipy.special import ndtr

    P = SURFACE_TASK
    latest = pd.Timestamp("2023-03-20 10:00")
    frames, u0 = [], 0
    for n_und, E, N in (P["big"], P["small"]):
        days = np.array(SURFACE_DAYS[:E] if E == len(SURFACE_DAYS) else SURFACE_DAYS[1::2][:E])
        labels = [(latest + pd.Timedelta(days=int(d))).strftime("%d%b%y").lower() for d in days]
        T = days / 365.0
        S = 100 * np.exp(rng.normal(0, 0.5, n_und))
        width = 0.3 + 0.3 * np.sqrt(T / T.max())
        K = S[:, None, None] * np.exp(np.linspace(-1, 1, N)[None, None, :] * width[None, :, None])
        # the strike as the symbol spells it, so k = log(K / S) is exact
        K = np.array([float(f"{x:.2f}") for x in K.ravel()]).reshape(K.shape)
        k = np.log(K / S[:, None, None])
        iv = (rng.uniform(0.3, 0.8, (n_und, 1, 1)) + rng.uniform(-0.15, 0.0, (n_und, 1, 1)) * k
              + rng.uniform(0.05, 0.3, (n_und, 1, 1)) * k * k)
        shape = (n_und, E, N, 2)
        u = np.broadcast_to(np.arange(u0, u0 + n_und)[:, None, None, None], shape).ravel()
        e = np.broadcast_to(np.arange(E)[None, :, None, None], shape).ravel()
        cp = np.broadcast_to(np.array([True, False]), shape).ravel()
        b = lambda a: np.broadcast_to(a[..., None], shape).ravel()
        Kf, ivf, kf, Sf = b(K), b(iv), b(k), np.repeat(S, E * N * 2)
        Tf = T[e]
        names = [f"u{ui:03d}-{labels[ei]}-{Ki:.2f}-{'c' if c else 'p'}"
                 for ui, ei, Ki, c in zip(u, e, Kf, cp)]
        r = 0.03
        sq = ivf * np.sqrt(Tf)
        d1 = (np.log(Sf / Kf) + (r + 0.5 * ivf ** 2) * Tf) / sq
        d2 = d1 - sq
        disc = np.exp(-r * Tf)
        price = np.where(cp, Sf * ndtr(d1) - Kf * disc * ndtr(d2),
                         Kf * disc * ndtr(-d2) - Sf * ndtr(-d1))
        frames.append(pd.DataFrame({
            "symbol": names, "underlying": [f"u{ui:03d}" for ui in u],
            "expiry": [labels[ei] for ei in e], "k": kf,
            "true_iv": ivf, "underlying_price": Sf, "time_to_maturity": Tf,
            "interest_rate": r, "mark_price": price}))
        u0 += n_und
    truth = pd.concat(frames, ignore_index=True)
    # the quotes without iv are out of the money (the wings a desk marks
    # by price), 2 % of all latest rows
    iv = truth["true_iv"].to_numpy().copy()
    K = truth["symbol"].str.split("-").str[-2].astype(float).to_numpy()
    call = truth["symbol"].str.endswith("-c").to_numpy()
    otm = np.where(call, K > truth["underlying_price"], K < truth["underlying_price"])
    iv[otm & (rng.uniform(size=len(iv)) < P["nan_frac"] * len(iv) / otm.sum())] = np.nan
    cols = ["symbol", "underlying_price", "time_to_maturity", "interest_rate", "mark_price"]
    new = truth[cols].assign(date=latest, iv=iv)
    old = truth[cols].assign(date=latest - pd.Timedelta(hours=1), iv=truth["true_iv"] + 0.25,
                             underlying_price=truth["underlying_price"] * 1.01)
    return pd.concat([old, new], ignore_index=True), truth


class TimedStore:
    """A store whose reads and writes add their host seconds to ``host``."""

    def __init__(self, store, host):
        self.store, self.host = store, host

    def _timed(self, name, fn, *a, **kw):
        t = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            self.host[name] += time.perf_counter() - t

    def read(self, *a, **kw):
        return self._timed("read", self.store.read, *a, **kw)

    def write(self, *a, **kw):
        return self._timed("write", self.store.write, *a, **kw)


class SurfaceProbe:
    """While installed: host seconds of the surface task's phases
    (``build_chains``, ``pack_chain_group``, the family's fit and local
    vol), CUDA events around the fit on the card, the chains the run
    built (or ``chains`` in their place), and on the card the calls of the
    kernels' plain versions."""

    def __init__(self, task, models, tridiag, agg, on_card: bool, chains=None):
        self.task, self.models, self.mods, self.on_card = task, models, (tridiag, agg), on_card
        self.given = chains

    def __enter__(self):
        from collections import defaultdict
        self.host, self.events, self.chains, self.plain = defaultdict(float), [], None, 0
        task, models = self.task, self.models
        self.orig = (task.build_chains, task.pack_chain_group, models.get,
                     self.mods[0].tridiag_solve_plain, self.mods[1].aggregate_ohlcv_plain)
        build, pack, get, plain_b1, plain_b2 = self.orig

        def timed(name, fn):
            def run(*a, **kw):
                t = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    self.host[name] += time.perf_counter() - t
            return run

        def on_device(fn):
            def run(*a, **kw):
                if self.on_card:
                    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    start.record()
                out = timed("fit", fn)(*a, **kw)
                if self.on_card:
                    end.record()
                    self.events.append((start, end))
                return out
            return run

        def chains(*a, **kw):
            self.chains = (self.given if self.given is not None
                           else timed("build_chains", build)(*a, **kw))
            return self.chains

        def family(name):
            m = get(name)
            return models.SurfaceModel(name=m.name, fit_eval=on_device(m.fit_eval),
                                       attach_local_vol=on_device(m.attach_local_vol))

        def counted(fn):
            def run(*a, **kw):
                self.plain += 1
                return fn(*a, **kw)
            return run

        task.build_chains, task.pack_chain_group, models.get = chains, timed("pack", pack), family
        if self.on_card:
            self.mods[0].tridiag_solve_plain = counted(plain_b1)
            self.mods[1].aggregate_ohlcv_plain = counted(plain_b2)
        return self

    def __exit__(self, *exc):
        (self.task.build_chains, self.task.pack_chain_group, self.models.get,
         self.mods[0].tridiag_solve_plain, self.mods[1].aggregate_ohlcv_plain) = self.orig

    def busy_s(self) -> float:
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.events) / 1e3


def surface_config(get_config, work, surface: dict):
    cfg = get_config("production")
    cfg.checkpoint.manifest_dir = str(work / "runs")
    cfg.monitoring.snapshot_dir = str(work / "snapshots")
    for key, value in surface.items():
        setattr(cfg.surface, key, value)
    return cfg


def sorted_surfaces(store, task):
    df = store.read(task.SURFACES)
    return df.sort_values(["underlying", "expiry_t", "log_moneyness"]).reset_index(drop=True)


def truth_of(chain, by_key):
    """The generating (k, iv) of a chain's strikes: for each chain k the
    nearest generated k of its (underlying, expiry)."""
    want = by_key.get_group((chain["underlying"], chain["expiry"])).groupby("k")["true_iv"].first()
    k_true = want.index.to_numpy()
    idx = np.clip(np.searchsorted(k_true, chain["k"] - 1e-12), 0, len(k_true) - 1)
    return k_true[idx], want.to_numpy()[idx]


def inversion_error(chains, truth) -> float:
    """Largest |iv - generating iv| over the chains' strikes."""
    by_key = truth.groupby(["underlying", "expiry"])
    return max(float(np.abs(c["iv"] - truth_of(c, by_key)[1]).max()) for c in chains)


def compare_chains(card, cpu, truth):
    """Chains on the card against those on CPU tensors and against the
    generated latest rows: keys, T and k exact between the devices, k
    within 1e-15 of log(K / S) of the latest rows; iv exact where the
    latest row had one, and where it was inverted from the mark price
    (float64 Newton on each device) within 1e-6 between the devices and
    1e-5 of the truth (a strike's iv is the mean of its call's and put's,
    so one inverted quote moves it by half its error); the older
    snapshot's iv (0.25 away) is never read. Returns the worst errors
    against the truth and between the devices."""
    check(len(card) == len(cpu) == SURFACE_TASK["chains"],
          f"(c) {len(card)} chains on the card, {len(cpu)} on CPU tensors")
    by_key = truth.groupby(["underlying", "expiry"])
    worst, between = 0.0, 0.0
    for a, b in zip(card, cpu):
        check((a["underlying"], a["expiry"], a["T"]) == (b["underlying"], b["expiry"], b["T"])
              and np.array_equal(a["k"], b["k"]), f"(c) chain {a['underlying']} {a['expiry']}")
        k_true, iv_true = truth_of(a, by_key)
        check(bool((np.abs(k_true - a["k"]) <= 1e-15).all()),
              f"(c) chain {a['underlying']} {a['expiry']}: k = log(K / S) of the latest rows")
        d_truth, d_cpu = np.abs(a["iv"] - iv_true), np.abs(a["iv"] - b["iv"])
        worst, between = max(worst, float(d_truth.max())), max(between, float(d_cpu.max()))
        check(bool((d_truth <= 1e-5).all() and (d_cpu <= 1e-6).all()),
              f"(c) chain {a['underlying']} {a['expiry']}: iv within 1e-5 of the truth "
              f"({d_truth.max():.3e}) and 1e-6 of CPU ({d_cpu.max():.3e})")
    return worst, between


def compare_surfaces(card, cpu, parity: bool) -> float:
    """(c): the card's table against the CPU run's on the same chains:
    keys, flags and row counts exact; float32 grids within 256 eps32 of
    each column's scale; parity mode's float64 pair within 1e-12."""
    check(len(card) == len(cpu) and list(card.columns) == list(cpu.columns),
          f"(c) {len(card)} rows / {len(cpu)} rows, same columns")
    for c in ("underlying", "expiry_t", "butterfly_ok", "calendar_ok"):
        check(np.array_equal(card[c].to_numpy(), cpu[c].to_numpy()), f"(c) {c} equal")
    worst = 0.0
    for c in card.columns:
        if c in ("underlying", "expiry_t", "butterfly_ok", "calendar_ok"):
            continue
        x, y = card[c].to_numpy(np.float64), cpu[c].to_numpy(np.float64)
        check(np.array_equal(np.isnan(x), np.isnan(y)), f"(c) {c} NaN mask")
        d = np.nan_to_num(np.abs(x - y))
        scale = max(1.0, float(np.nanmax(np.abs(y))))
        check(bool((d <= 256 * EPS32 * scale).all()), f"(c) {c} within 256 eps32 of {scale:.3g} "
              f"(max {d.max():.3e})")
        worst = max(worst, float(d.max()) / scale)
    if parity:
        pair = lambda f: f["total_variance"].to_numpy(np.float64) + f["total_variance_lo"].to_numpy(
            np.float64)
        d = np.abs(pair(card) - pair(cpu))
        check(bool((d <= 1e-12).all()), f"(c) parity pair within 1e-12 (max {d.max():.3e})")
    return worst


def parity_oracle(task, chains, table, rng) -> float:
    """Parity mode on SURFACE_TASK["sampled"] surfaces: f64(total_variance)
    + f64(total_variance_lo) against SciPy's float64 not-a-knot spline
    through the same float32 inputs (the packed batch the fit saw), on the
    float64 linspace between the float32 support ends."""
    from scipy.interpolate import CubicSpline

    by_und = {}
    for c in chains:
        by_und.setdefault(c["underlying"], []).append(c)
    m = SURFACE_TASK["n_grid"]
    worst = 0.0
    for u in rng.choice(sorted(by_und), SURFACE_TASK["sampled"], replace=False):
        slices = sorted(by_und[u], key=lambda c: c["T"])
        E_pad = task._pow2_at_least(max(len(slices), 2), 2)
        n_pad = task._pow2_at_least(max(len(c["k"]) for c in slices), 8)
        k, iv, T, _, _ = task.pack_chain_group([(u, slices)], E_pad, n_pad)
        k, iv, T = (np.asarray(a, np.float32).astype(np.float64)[0] for a in (k, iv, T))
        lo = min(k[:, 0].max(), k[:, -1].min())
        hi = max(k[:, 0].max(), k[:, -1].min())
        q = lo + (hi - lo) * np.linspace(0.0, 1.0, m)
        rows = table[table["underlying"] == u].sort_values(["expiry_t", "log_moneyness"])
        got = (rows["total_variance"].to_numpy(np.float64)
               + rows["total_variance_lo"].to_numpy(np.float64)).reshape(len(slices), m)
        for e in range(len(slices)):
            ref = CubicSpline(k[e], iv[e] ** 2 * T[e], bc_type="not-a-knot")(q)
            worst = max(worst, float(np.abs(got[e] - ref).max()))
    check(worst < 1e-9, f"(d) parity pair vs SciPy float64 on {SURFACE_TASK['sampled']} "
          f"surfaces < 1e-9 (got {worst:.3e})")
    return worst


def surface_work() -> Path:
    return Path(__file__).resolve().parent / "build" / "chip_smoke_surface"


def surface_store(rng):
    """SURFACE_TASK's ``interpolated`` table in a store under
    ``surface_work()`` (parquet when pyarrow imports): the store, the
    frame and the latest rows' truth."""
    from iv_interpolation_tpu_torch.pipeline import storage as st
    frame, truth = make_surface_table(rng)
    store = make_store(st, surface_work() / "data")
    store.write(st.INTERPOLATED, frame, upsert_keys=["symbol", "date"])
    return store, frame, truth


def surface_task_phase(reset_counts, read_counts, tridiag, agg) -> dict:
    """Phase 7: ``run_surface_fit`` from a parquet store on the card, on
    SURFACE_TASK's 256 underlyings, once for each of SURFACE_RUNS: (a)
    host seconds by phase, surfaces/s, idle share, peak memory; (b) B1
    launches by dtype, no plain version called; (c) the same run on CPU
    tensors; (d) parity mode against SciPy; (e) the audit; (f) the CLI.
    Returns the store's root, the launches of the runs and the rates."""
    import pandas as pd
    from iv_interpolation_tpu_torch import models
    from iv_interpolation_tpu_torch.config import get_config
    from iv_interpolation_tpu_torch.pipeline import check_results
    from iv_interpolation_tpu_torch.pipeline import storage as st
    from iv_interpolation_tpu_torch.pipeline import surface_task as task

    P = SURFACE_TASK
    root = Path(__file__).resolve().parent
    work = surface_work()
    rng = np.random.default_rng(P["seed"])
    t0 = time.perf_counter()
    store, frame, truth = surface_store(rng)
    cpu_store = st.MemoryStore()
    cpu_store.write(st.INTERPOLATED, frame)
    n_nan = int(frame["iv"].isna().sum())
    log(f"  data: {frame['symbol'].nunique():,} option symbols of 256 underlyings x 2 "
        f"snapshots = {len(frame):,} rows, {n_nan:,} latest rows without iv; made and "
        f"written in {time.perf_counter() - t0:.2f} s (host, set-up)")
    t = time.perf_counter()
    cpu_chains = task.build_chains(frame, device="cpu")
    log(f"  chains on CPU tensors in {time.perf_counter() - t:.2f} s")
    # the prices inverted in float32, as the JAX package does outside x64,
    # against the float64 inversion the port keeps (ROADMAP C7)
    errs = {str(dt)[6:]: inversion_error(task.build_chains(frame, device=DEV, dtype=dt), truth)
            for dt in (torch.float32, torch.float64)}
    log(f"  iv inverted from mark prices on {DEV}, max |iv - generating iv|: "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    launches = {"b1_f32": 0, "b1_f64": 0, "b2": 0}
    rates = {}
    for name, method, surface in SURFACE_RUNS:
        cfg = surface_config(get_config, work, dict(surface, smile_method=method))
        # warm-up on one underlying: the first use of each device kernel
        # (module loading, library handles) stays out of the timed run
        task.run_surface_fit(cfg, store, limit=12, device=DEV)
        store.drop(task.SURFACES)
        reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with SurfaceProbe(task, models, tridiag, agg, on_card=True) as probe:
            timed = TimedStore(store, probe.host)
            t = time.perf_counter()
            rep = task.run_surface_fit(cfg, timed, device=DEV)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        busy = probe.busy_s()
        host = dict(probe.host)
        host["unpack"] = wall - sum(host.values())
        check(rep["surfaces"] == 256 and rep["grid_rows"] == P["grid_rows"]
              and rep["method"] == method, f"(a) {name}: 256 surfaces, {P['grid_rows']} rows: {rep}")
        want = {"cubic_spline": (2, 0), "smoothing_spline": (0, 0), "parity": (0, 2),
                "local vol": (2, 0)}[name]
        check((counts["b1_f32"], counts["b1_f64"], counts["b2"]) == want + (0,),
              f"(b) {name}: B1 float32 / float64 once a bucket as the family needs: {counts}")
        check(probe.plain == 0, f"(b) {name}: no plain version called on the card ({probe.plain})")
        for k in launches:
            launches[k] += counts[k]
        rates[name] = 256 / wall
        log(f"  (a) {name}: {wall:.3f} s, {256 / wall:,.0f} surfaces/s end to end; host s "
            + ", ".join(f"{k} {v:.3f}" for k, v in host.items())
            + f"; device busy {busy * 1e3:.2f} ms (fit), idle share {1 - busy / wall:.1%}, "
            f"peak {peak:.2f} GiB; launches {counts}; butterfly_ok {rep['butterfly_ok']}, "
            f"calendar_ok {rep['calendar_ok']}")
        card_chains, card_table = probe.chains, sorted_surfaces(store, task)
        # (c) the chains against those built on CPU tensors, then the same
        # run on CPU tensors fed the card's chains
        iv_err, iv_dev = compare_chains(card_chains, cpu_chains, truth)
        cpu_store.drop(task.SURFACES)
        t = time.perf_counter()
        with SurfaceProbe(task, models, tridiag, agg, on_card=False, chains=card_chains):
            cpu_rep = task.run_surface_fit(cfg, cpu_store, device="cpu")
        check(cpu_rep == rep, f"(c) same summary: {cpu_rep}")
        err = compare_surfaces(card_table, sorted_surfaces(cpu_store, task), name == "parity")
        log(f"  (c) {name} on CPU tensors in {time.perf_counter() - t:.1f} s: grids within "
            f"{err:.3e} of scale; chains' iv max err {iv_err:.3e} vs truth, {iv_dev:.3e} "
            f"card vs CPU")
        if name == "parity":
            worst = parity_oracle(task, card_chains, card_table, rng)
            log(f"  (d) parity pair vs SciPy float64 on {P['sampled']} surfaces: max {worst:.3e}")
        if name == "local vol":
            lv = card_table["local_vol"].to_numpy()
            check(np.isfinite(lv).mean() > 0.5 and bool((lv[np.isfinite(lv)] >= 0).all()),
                  "(a) local vol: most cells real, none negative")
    audit = check_results.check_surface_results(store)
    check(audit["ok"] and audit["surfaces"] == 256, f"(e) surface audit: {audit.get('reason')}")
    log(f"  (e) audit: {audit['surfaces']} surfaces, iv range {audit['iv_range']}, "
        f"butterfly_ok {audit['butterfly_ok']}, calendar_ok {audit['calendar_ok']}")
    if isinstance(store, st.ParquetStore):
        surface_cli(root, work)
    else:
        log("  (f) pyarrow does not import: the CLI on a parquet store was not run")
    return {"store": store, "work": work, "launches": launches, "rates": rates}


def cli_env(root):
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(root), os.environ.get("PYTHONPATH", "")) if p))


def surface_cli(root, work) -> None:
    """(f): ``iv-tpu-torch --task surface --json`` on the phase's store
    exits 0 on the card, and so does ``--method svi``."""
    cli_dir = work / "cli"
    cli_dir.mkdir(parents=True, exist_ok=True)
    env = cli_env(root)
    base = [sys.executable, "-m", "iv_interpolation_tpu_torch.cli", "--task", "surface",
            "--storage", "parquet", "--data-root", str(work / "data"), "--json",
            "--device", DEV]
    proc = subprocess.run(base, cwd=cli_dir, env=env, capture_output=True, text=True,
                          timeout=300)
    check(proc.returncode == 0, f"(f) the surface CLI exits 0: {proc.stderr[-2000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    check(out["surface"]["surfaces"] == 256, f"(f) the CLI fitted 256 surfaces: {out['surface']}")
    svi = subprocess.run(base + ["--method", "svi"], cwd=cli_dir, env=env, capture_output=True,
                         text=True, timeout=300)
    check(svi.returncode == 0, f"(f) --method svi exits 0: {svi.stderr[-2000:]}")
    svi_out = json.loads(svi.stdout.strip().splitlines()[-1])["surface"]
    check(svi_out["surfaces"] == 256 and svi_out["method"] == "svi",
          f"(f) --method svi fitted 256 surfaces: {svi_out}")
    log(f"  (f) {' '.join(base[1:])}: exit 0, {out['surface']}; --method svi: exit 0, "
        f"{svi_out}")


# -- phase 8: serving ----------------------------------------------------------

def serve_ticks(rng, unds):
    """SERVE["ticks"] ticks per underlying over the session's window,
    minutes sorted, float32 prices (exact in JSON and in Arrow)."""
    P = SERVE
    n = P["ticks"]
    per_min = 0.5 / np.sqrt(365.25 * 24 * 60)
    minute = np.sort(rng.integers(0, P["window"], (len(unds), n)), axis=-1)
    price = (100 * np.exp(np.cumsum(rng.normal(0, per_min, (len(unds), n)), axis=-1))
             ).astype(np.float32)
    size = rng.uniform(0, 5, (len(unds), n)).astype(np.float32)
    cols = {"underlying": np.repeat(np.asarray(unds, dtype=object), n),
            "minute": minute.ravel(), "price": price.ravel(), "size": size.ravel()}
    lines = [{"underlying": u, "minute": int(m), "price": float(p), "size": float(s)}
             for u, m, p, s in zip(*cols.values())]
    return cols, lines


def serving_phase(store, reset_counts, read_counts) -> dict:
    """Phase 8: ``run_serve`` over phase 7's store (256 underlyings from
    their chains) on the card; a client sends SERVE["ticks"] ticks per
    underlying, flush, SERVE["refits"] refits (median reply latency on
    the host clock), stats and stop; the refit replies against a CPU
    session fed the same ticks; B2 twice a refit; then the same over
    Arrow Flight where ``pyarrow.flight`` imports."""
    from iv_interpolation_tpu_torch.config import get_config
    from iv_interpolation_tpu_torch.pipeline import flight_service as fs
    from iv_interpolation_tpu_torch.pipeline import serve

    P = SERVE
    cfg = get_config("production")
    rng = np.random.default_rng(P["seed"])
    reset_counts()
    t = time.perf_counter()
    server = serve.run_serve(cfg, store, port=0, blocking=False, device=DEV)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t
    unds = server.session.underlyings
    check(len(unds) == 256, f"the server serves the store's 256 underlyings ({len(unds)})")
    cols, lines = serve_ticks(rng, unds)
    n_ticks = len(lines)
    send = lambda msgs: serve.send_lines("127.0.0.1", server.port, msgs, timeout=120)
    try:
        reset_counts()
        t = time.perf_counter()
        (flush,) = send(lines + [{"cmd": "flush"}])
        ingest_s = time.perf_counter() - t
        refits, latency = [], []
        for _ in range(P["refits"]):
            t = time.perf_counter()
            refits += send([{"cmd": "refit"}])
            latency.append(time.perf_counter() - t)
        (stats,) = send([{"cmd": "stats"}])
        (stop,) = send([{"cmd": "stop"}])
        counts = read_counts()
    finally:
        server.stop()
    check(flush["ok"] and flush["total"] == n_ticks and stats["ticks_seen"] == n_ticks
          and stop == {"ok": True}, f"(a) flush / stats / stop: {flush} {stats} {stop}")
    check(all(r["ok"] for r in refits) and all(r == refits[0] for r in refits),
          "(a) every refit reply ok and the same")
    check(counts["b2"] == 2 * P["refits"] and counts["b1_f64"] == 0,
          f"(b) B2 twice a refit ({P['refits']} refits): {counts}")
    med = sorted(latency)[len(latency) // 2] * 1e3
    log(f"  (a) JSONL: set-up {setup_s:.2f} s, {n_ticks:,} ticks "
        f"+ flush in {ingest_s:.2f} s, refit reply ms {[round(x * 1e3, 2) for x in latency]}, "
        f"median {med:.2f}; launches {counts}")
    # (c) a CPU session fed the same ticks
    cpu, _ = serve.build_session(cfg, store, device="cpu")
    cpu.ingest_ticks(cols)
    ref = cpu.refit()
    reply = refits[0]
    rv, atm = ref.realized_vol.numpy(), ref.iv_grid[:, 0, ref.iv_grid.shape[-1] // 2].numpy()
    rv_err = atm_err = 0.0
    for i, u in enumerate(unds):
        check(reply["butterfly_ok"][u] == bool(ref.butterfly_ok[i]), f"(c) butterfly_ok {u}")
        e_rv = abs(reply["realized_vol"][u] - float(rv[i]))
        e_atm = abs(reply["atm_iv"][u] - float(atm[i]))
        check(e_rv <= 5e-7 + 128 * EPS32 * abs(float(rv[i])), f"(c) realized_vol {u} ({e_rv:.3e})")
        check(e_atm <= 5e-7 + 1e-4 * abs(float(atm[i])) + 2e-5, f"(c) atm_iv {u} ({e_atm:.3e})")
        rv_err, atm_err = max(rv_err, e_rv), max(atm_err, e_atm)
    log(f"  (c) vs a CPU session: realized_vol max err {rv_err:.3e}, atm_iv {atm_err:.3e}, "
        f"butterfly_ok equal ({sum(reply['butterfly_ok'].values())}/256)")
    out = {"launches": {"b2": counts["b2"]}, "refit_ms": med, "flight": False}
    if not fs.HAVE_FLIGHT:
        log("  (d) pyarrow.flight does not import: the Flight transport was not run")
        return out
    import pyarrow.flight as fl
    reset_counts()
    fserver = fs.run_serve_flight(cfg, store, port=0, blocking=False, device=DEV)
    try:
        client = fl.connect(f"grpc+tcp://127.0.0.1:{fserver.port}")
        opts = fl.FlightCallOptions(timeout=120)
        reset_counts()
        fs.put_ticks(client, list(cols["underlying"]), cols["minute"], cols["price"],
                     cols["size"])
        fflush = fs.action_json(client, "flush")
        tables, flat = [], []
        for _ in range(P["refits"]):
            t = time.perf_counter()
            tables.append(client.do_get(fl.Ticket(b"refit"), options=opts).read_all())
            flat.append(time.perf_counter() - t)
        fstats = fs.action_json(client, "stats")
        fcounts = read_counts()
        fstop = fs.action_json(client, "stop")
        client.close()
    finally:
        fserver.shutdown()
    check(fflush["total"] == n_ticks and fstats["ticks_seen"] == n_ticks and fstop["ok"],
          f"(d) Flight flush / stats / stop: {fflush} {fstats}")
    check(fcounts["b2"] == 2 * P["refits"], f"(d) Flight: B2 twice a refit: {fcounts}")
    tab = {c: tables[0].column(c).to_pylist() for c in tables[0].column_names}
    check(tab["underlying"] == list(unds), "(d) Flight rows in the session's order")
    for i, u in enumerate(unds):
        check(tab["butterfly_ok"][i] == reply["butterfly_ok"][u]
              and abs(tab["realized_vol"][i] - reply["realized_vol"][u]) <= 5e-7 + 1e-12
              and abs(tab["atm_iv"][i] - reply["atm_iv"][u]) <= 5e-7 + 1e-12,
              f"(d) Flight agrees with the JSONL reply for {u}")
    fmed = sorted(flat)[len(flat) // 2] * 1e3
    out["launches"]["b2"] += fcounts["b2"]
    out.update(flight=True, flight_refit_ms=fmed)
    log(f"  (d) Arrow Flight (pyarrow {module_version('pyarrow')}): refit reply ms "
        f"{[round(x * 1e3, 2) for x in flat]}, median {fmed:.2f}; agrees with JSONL; "
        f"launches {fcounts}")
    return out


# -- phase 9: the calibrated families -----------------------------------------

CALIB_RUNS = (("svi", {}), ("essvi", {}), ("sabr", {}))


def calib_data(P):
    """Phase 9's quotes from a numpy generator: k (B, E, n) on
    linspace(-1.2, 1.2, n), T (B, E) on linspace(0.05, 2, E), and per
    family the generating smile plus noise: raw-SVI slices, eSSVI surfaces
    (theta a running sum, rho and the psi fraction one a surface), SABR
    slices (beta 0.5, F = 1, K = e^k; the noise on the vols). All float32;
    ``clean`` holds the noiseless total variance of each."""
    from iv_interpolation_tpu_torch.ops import essvi, sabr, svi

    B, E, n = P["B"], P["E"], P["N"]
    rng = np.random.default_rng(P["seed"])
    U = lambda lo, hi, shape: torch.from_numpy(rng.uniform(lo, hi, shape))
    noise = lambda: torch.from_numpy(P["noise"] * rng.normal(size=(B, E, n)))
    k = torch.linspace(-1.2, 1.2, n, dtype=torch.float64).expand(B, E, n)
    T = torch.linspace(0.05, 2.0, E, dtype=torch.float64).expand(B, E)
    p_svi = torch.cat([U(0.01, 0.08, (B, E, 1)), U(0.05, 0.3, (B, E, 1)),
                       U(-0.6, 0.6, (B, E, 1)), U(-0.2, 0.2, (B, E, 1)),
                       U(0.1, 0.5, (B, E, 1))], dim=-1)
    theta = U(0.005, 0.03, (B, E)).cumsum(-1)
    rho = U(-0.6, 0.6, (B, 1)).expand(B, E)
    psi = essvi.psi_butterfly_cap(theta, rho) * U(0.2, 0.7, (B, 1))
    p_sabr = torch.cat([U(0.15, 0.5, (B, E, 1)), torch.full((B, E, 1), 0.5, dtype=torch.float64),
                        U(-0.5, 0.2, (B, E, 1)), U(0.2, 0.8, (B, E, 1))], dim=-1)
    clean = {"svi": svi.svi_total_variance(p_svi, k),
             "essvi": essvi.essvi_w(torch.stack([theta, rho, psi], dim=-1), k)}
    iv_sabr = sabr.sabr_vol(p_sabr, torch.ones_like(T), torch.exp(k), T)
    clean["sabr"] = iv_sabr * iv_sabr * T[..., None]
    w = {"svi": clean["svi"] + noise(), "essvi": clean["essvi"] + noise()}
    iv = {m: torch.sqrt(w[m] / T[..., None]) for m in w}
    iv["sabr"] = iv_sabr + noise()
    w["sabr"] = iv["sabr"] ** 2 * T[..., None]
    f32 = lambda d: {m: a.float().contiguous() for m, a in d.items()}
    return dict(k=k.float().contiguous(), T=T.float().contiguous(), w=f32(w), iv=f32(iv),
                clean=f32(clean))


def timed_fit(fit, iters: int, reps: int = 2) -> dict:
    """``fit(max_iters)`` on the card: device ms of a fit of ``iters``
    iterations (CUDA events after a warm-up call), ms an LM iteration from
    the difference to a fit of a quarter as many, host seconds of one
    synchronised call, and the peak memory of a fit."""
    short = max(iters // 4, 1)
    ms = cuda_ms(lambda: fit(iters), reps)
    ms_short = cuda_ms(lambda: fit(short), reps)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    fit(iters)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t
    return {"ms": ms, "iter_ms": (ms - ms_short) / (iters - short), "host_s": host_s,
            "peak_gb": torch.cuda.max_memory_allocated() / 2**30}


def launches_a_fit(fit, iters: int):
    """Device launches of one fit, from ``torch.profiler``: kernels and
    memory operations counted on fits of 2 and 4 iterations, the difference
    a launch count an iteration (0 for a fit whose iterations run in one
    kernel), extended to ``iters``. None where the profiler records no
    device activity."""
    from torch.profiler import ProfilerActivity, profile

    def count(n):
        fit(n)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fit(n)
            torch.cuda.synchronize()
        return sum(1 for ev in prof.events()
                   if str(getattr(ev, "device_type", "")).endswith("CUDA"))

    n2, n4 = count(2), count(4)
    if n2 == 0 or n4 < n2:
        return None
    per_iter = (n4 - n2) / 2
    return {"an_iteration": per_iter, "a_fit": int(n2 + per_iter * (iters - 2))}


def w_close(got, ref, scale_of, what: str, tol: float = 5e-5) -> float:
    """Fitted total variance on the card against the same call on CPU
    tensors: within ``tol`` of the slice's largest |w| (two float32 LM runs
    take accept/reject decisions inside rounding, so their iterate paths
    differ; the bound of the CPU parity tests)."""
    err = slice_errors(got, ref, scale_of).max()
    check(float(err) <= tol, f"{what}: fitted w within {tol:g} of the slice's scale on the card "
          f"and on CPU tensors (got {float(err):.3e})")
    return float(err)


def slice_errors(got, ref, scale_of) -> torch.Tensor:
    """Per slice, the largest |got - ref| over the slice's largest |w|."""
    scale = scale_of.abs().amax(dim=-1)
    return (got.cpu() - ref).abs().amax(dim=-1) / scale


def recovery(w_fit, clean, what: str) -> float:
    rmse = float(torch.sqrt(((w_fit - clean) ** 2).mean()))
    check(rmse < 5e-4 and bool(torch.isfinite(w_fit).all()),
          f"{what}: rmse in w against the generating smile < 5e-4 (got {rmse:.3e})")
    return rmse

# the raw-SVI calibration's least work, counted in fused form: about 35
# float32 instructions a quote for a full pass (the residual, four Jacobian
# columns, the 21 sums as fused multiply-adds; a square root and a
# reciprocal on the SFU beside them), about 10 for a pass that forms the
# cost alone, and about 100 a slice an iteration for the damped 5 x 5
# Cholesky and its two substitutions. A slice needs a full pass at the
# start, then in each iteration it runs (up to the one it converges in)
# the solve and the trial's pass: a full one where the trial is accepted
# (the next J^T J), a cost-only one where it is rejected (the kernel
# itself fuses nothing, to match its plain version bit for bit, and runs a
# rejected trial's pass to the end). The card issues F32_OPS_S / 2 float32
# instructions a second (128 lanes x 132 SMs x 1.98 GHz; F32_OPS_S counts
# a fused multiply-add as two operations).
SVI_QUOTE_OPS = 35
SVI_COST_OPS = 10
SVI_SOLVE_OPS = 100
# the kernel's timed shape: phase 9's 1,024 surfaces tiled to the cell's
# 32,768 (983,040 slices), 50 iterations
SVI_LM = dict(surfaces=32768, iters=50)


def svi_lm_cases(P, data) -> dict:
    """Phase 9 (a): the raw-SVI kernel (``fit_svi_batched``'s route on the
    card for the linear loss without a penalty) on P's slices. From the
    heuristic start (the book's): one launch, the generic loop's counter
    unmoved, bit for bit its plain version on the card (the same IEEE
    operations in the same order, none fused) and the first 4,096 slices on
    CPU tensors. From the quasi start (as (a)'s fits): against the generic
    loop on the card, fitted w within 5e-5 of the slice's largest w (two
    float32 LMs that round differently take other accept/reject decisions:
    the bound of (a)'s card-against-CPU check) and both within the
    generating smile's bound. Then timed at SVI_LM beside the plain
    version, equal to it bit for bit there too, and beside the least work
    of the run's own iterations (SVI_QUOTE_OPS, SVI_COST_OPS,
    SVI_SOLVE_OPS): each slice's iterations up to the one it converged in,
    read from the kernel's ``converged`` after 1, 2, ... iterations (a
    converged slice is frozen, so the flag never falls back), and its
    accepted steps."""
    from functools import partial

    from iv_interpolation_tpu_torch.ops import lm, svi
    from iv_interpolation_tpu_torch.ops.cuda import svi_lm as K

    n, iters = P["N"], P["iters"]
    kf = data["k"].to(DEV).reshape(-1, n).contiguous()
    wf = data["w"]["svi"].to(DEV).reshape(-1, n).contiguous()
    clean = data["clean"]["svi"].to(DEV).reshape(-1, n)
    p0 = svi.svi_init(kf, wf)
    args = (iters, lm.LAMBDA0, lm.TOL, svi.SVI_LOWER, svi.SVI_UPPER)
    before = (K.svi_lm_cuda.launches, lm.levenberg_marquardt_batched.calls)
    got = K.svi_lm_cuda(kf, wf, None, p0, *args)
    torch.cuda.synchronize()
    check((K.svi_lm_cuda.launches, lm.levenberg_marquardt_batched.calls)
          == (before[0] + 1, before[1]), "(a) svi_lm: one kernel launch, no generic loop")
    plain = K.svi_lm_plain(kf, wf, None, p0, *args)
    check(all(same_with_nan(a, b) for a, b in zip(got, plain)),
          "(a) svi_lm: the kernel equals its plain version on the card bit for bit")
    C = min(4096, kf.shape[0])
    on_cpu = K.svi_lm_plain(kf[:C].cpu(), wf[:C].cpu(), None, p0[:C].cpu(), *args)
    check(all(same_with_nan(a[:C].cpu(), b) for a, b in zip(got, on_cpu)),
          "(a) svi_lm: the kernel equals its plain version on CPU tensors bit for bit")
    pq = svi.svi_quasi_init(kf, wf)
    got = K.svi_lm_cuda(kf, wf, None, pq, *args)
    generic = lm.levenberg_marquardt_batched(
        partial(svi._svi_residual, butterfly_penalty=0.0), pq, kf, wf, torch.ones_like(wf),
        max_iters=iters, lower=svi.SVI_LOWER, upper=svi.SVI_UPPER)
    w_kernel = svi.svi_total_variance(got.params, kf)
    w_generic = svi.svi_total_variance(generic.params, kf)
    err = w_close(w_kernel, w_generic.cpu(), wf.cpu(), "(a) svi_lm against the generic loop")
    rmse = {"kernel": recovery(w_kernel, clean, "(a) svi_lm kernel"),
            "generic": recovery(w_generic, clean, "(a) svi_lm generic loop")}
    lower_cost = float((got.cost <= generic.cost).float().mean())
    log(f"  (a) svi_lm at {kf.shape[0]:,} slices x {n}, {iters} iterations: = plain from the "
        f"heuristic start (card, bit for bit; CPU tensors, {C} slices); from the quasi start "
        f"against the generic loop w within {err:.2e} of scale, rmse vs the generating smile "
        f"{rmse}, cost at most the generic loop's on {lower_cost:.1%} of slices; converged "
        f"{float(got.converged.float().mean()):.1%} / {float(generic.converged.float().mean()):.1%}")
    reps = SVI_LM["surfaces"] // P["B"]
    kb, wb, pb = (a.repeat(reps, 1) for a in (kf, wf, p0))
    S, its = kb.shape[0], SVI_LM["iters"]
    big = (its, lm.LAMBDA0, lm.TOL, svi.SVI_LOWER, svi.SVI_UPPER)
    runs = {}
    ms = cuda_ms(lambda: runs.update(kernel=K.svi_lm_cuda(kb, wb, None, pb, *big)), 5)
    plain_ms = cuda_ms(lambda: runs.update(plain=K.svi_lm_plain(kb, wb, None, pb, *big)), 1)
    check(all(same_with_nan(a, b) for a, b in zip(runs["kernel"], runs["plain"])),
          f"(a) svi_lm: the kernel equals its plain version at {S:,} slices bit for bit")
    # the iterations each slice runs: 1 + the counts of 1 .. its - 1 after
    # which it had not converged (the tiled copies run alike)
    ran = torch.ones(kf.shape[0], dtype=torch.float64, device=DEV)
    for i in range(1, its):
        done_i = K.svi_lm_cuda(kf, wf, None, p0, i, *big[1:]).converged
        ran += (~done_i).double()
    accepted = runs["kernel"].n_accepted[:kf.shape[0]].double()
    quote_ops = n * (SVI_QUOTE_OPS * (1 + accepted) + SVI_COST_OPS * (ran - accepted))
    ops = reps * float((quote_ops + SVI_SOLVE_OPS * ran).sum())
    full = S * ((its + 1) * n * SVI_QUOTE_OPS + its * SVI_SOLVE_OPS)
    nbytes = S * (2 * n + 5) * 4 + S * (5 * 4 + 4 + 4 + 1)
    row = timing_row(f"svi lm slices={S} n={n} iters={its} float32", ms, plain_ms, nbytes, ops,
                     None, ops_s=F32_OPS_S / 2, iterations_mean=float(ran.mean()),
                     accepted_mean=float(accepted.mean()), ops_least=ops,
                     ops_every_iteration_full=full)
    return {**row, "shapes": [row], "against_generic": {"w_err": err, "rmse": rmse,
                                                         "cost_at_most_generic": lower_cost}}


def calibrated_fits(P, data, reset_counts, read_lm) -> dict:
    """Phase 9 (a)-(c): the batched fits on the card, each held to the same
    call on CPU tensors at P["cpu"] surfaces and to the generating smile,
    and timed. SVI's first call of each kind, with the counts set to 0
    just before it: the linear loss without a penalty launches the raw-SVI
    kernel once and calls no generic loop; the hinge and Huber call the
    generic loop once and launch no kernel."""
    from iv_interpolation_tpu_torch.ops import essvi, sabr, svi

    B, E, n, iters, C = P["B"], P["E"], P["N"], P["iters"], P["cpu"]
    k_dev, T_dev = data["k"].to(DEV), data["T"].to(DEV)
    dev = {m: a.to(DEV) for m, a in data["w"].items()}
    clean = {m: a.to(DEV) for m, a in data["clean"].items()}
    out = {}

    def report(name, unit, count, t, rmse, err, launches, extra=""):
        la = ("not measured" if launches is None else
              f"{launches['a_fit']:,} a fit ({launches['an_iteration']:,.0f} an iteration)")
        log(f"  {name}: {t['ms']:.1f} ms a fit (device), {t['host_s'] * 1e3:.1f} ms host, "
            f"{t['iter_ms']:.3f} ms an LM iteration, {count / (t['ms'] / 1e3):,.0f} {unit}/s, "
            f"peak {t['peak_gb']:.2f} GiB, device launches {la}; rmse vs the generating "
            f"smile {rmse:.2e}, card vs CPU tensors {err:.2e} of scale{extra}")
        out[name] = dict(t, rate=count / (t["ms"] / 1e3), rmse=rmse, launches=launches)

    # (a) SVI on the B x E slices
    for name, kw in (("svi quasi", {}), ("svi quasi + hinge", {"butterfly_penalty": 10.0}),
                     ("svi quasi + huber", {"loss": "huber"})):
        fit = lambda it, kw=kw: svi.fit_svi_batched(k_dev, dev["svi"], max_iters=it,
                                                    init="quasi", **kw)
        reset_counts()
        res = fit(iters)
        lm_calls = read_lm()
        want = {"svi_lm": 0, "generic_lm": 1} if kw else {"svi_lm": 1, "generic_lm": 0}
        check(lm_calls == want, f"(a) {name}: one call, "
              f"{'the generic loop' if kw else 'one raw-SVI kernel launch'}: {lm_calls}")
        w_fit = svi.svi_total_variance(res.params, k_dev)
        check(tuple(res.params.shape) == (B, E, 5) and res.params.dtype == torch.float32,
              f"(a) {name}: params shape and dtype")
        rmse = recovery(w_fit, clean["svi"], f"(a) {name}")
        ref = svi.fit_svi_batched(data["k"][:C], data["w"]["svi"][:C], max_iters=iters,
                                  init="quasi", **kw)
        err = w_close(w_fit[:C], svi.svi_total_variance(ref.params, data["k"][:C]),
                      data["w"]["svi"][:C], f"(a) {name}")
        report(name, "slices", B * E, timed_fit(fit, iters), rmse, err,
               launches_a_fit(fit, iters) if not kw else None,
               f"; accepted steps mean {float(res.n_accepted.float().mean()):.1f}, "
               f"converged {float(res.converged.float().mean()):.1%}; a call: {lm_calls}")
        out[name]["lm_calls"] = lm_calls

    # (b) eSSVI: the block solver on every surface, the dense one on a part;
    # the first call of each with the counts set to 0 just before it
    for name, solver, nb, nc in (("essvi block", "block", B, C),
                                 ("essvi dense", "dense", P["dense_B"], P["dense_cpu"])):
        fit = lambda it, solver=solver, nb=nb: essvi.fit_essvi_batched(
            k_dev[:nb], dev["essvi"][:nb], max_iters=it, solver=solver)
        reset_counts()
        res = fit(iters)
        counted = essvi.fit_essvi_batched
        advance = {"calls": counted.calls, "iterations": counted.iterations,
                   "surfaces": counted.surfaces, "by_solver": dict(counted.by_solver)}
        check(advance == {"calls": 1, "iterations": iters, "surfaces": nb,
                          "by_solver": {"block": int(solver == "block"),
                                        "dense": int(solver == "dense")}},
              f"(b) {name}: the counters advance by one {solver} call: {advance}")
        w_fit = essvi.essvi_w(res.params, k_dev[:nb])
        check(tuple(res.params.shape) == (nb, E, 3), f"(b) {name}: params shape")
        theta = res.params[..., 0]
        check(bool((theta[:, 1:] > theta[:, :-1]).all()), f"(b) {name}: theta increasing")
        rmse = recovery(w_fit, clean["essvi"][:nb], f"(b) {name}")
        ref = essvi.fit_essvi_batched(data["k"][:nc], data["w"]["essvi"][:nc], max_iters=iters,
                                      solver=solver)
        err = w_close(w_fit[:nc], essvi.essvi_w(ref.params, data["k"][:nc]),
                      data["w"]["essvi"][:nc], f"(b) {name}")
        report(name, "surfaces", nb, timed_fit(fit, iters), rmse, err,
               launches_a_fit(fit, iters),
               f"; {nb} surfaces; accepted steps mean {float(res.n_accepted.float().mean()):.1f}"
               f"; a call's counters: {advance}")
        out[name]["counters"] = advance

    # (c) SABR on the B x E slices
    K_dev, iv_dev, F_dev = torch.exp(k_dev), data["iv"]["sabr"].to(DEV), torch.ones_like(T_dev)
    fit = lambda it: sabr.fit_sabr_batched(K_dev, iv_dev, F_dev, T_dev, max_iters=it,
                                           fix_beta=0.5)
    res = fit(iters)
    vol = sabr.sabr_vol(res.params, F_dev, K_dev, T_dev)
    w_fit = vol * vol * T_dev[..., None]
    check(bool((res.params[..., 1] == 0.5).all()), "(c) sabr: beta pinned")
    rmse = recovery(w_fit, clean["sabr"], "(c) sabr")
    kc, Tc = data["k"][:C], data["T"][:C]
    ref = sabr.fit_sabr_batched(torch.exp(kc), data["iv"]["sabr"][:C], torch.ones_like(Tc), Tc,
                                max_iters=iters, fix_beta=0.5)
    vol_ref = sabr.sabr_vol(ref.params, torch.ones_like(Tc), torch.exp(kc), Tc)
    err = w_close(w_fit[:C], vol_ref * vol_ref * Tc[..., None], data["w"]["sabr"][:C], "(c) sabr")
    report("sabr", "slices", B * E, timed_fit(fit, iters), rmse, err, launches_a_fit(fit, iters))
    return out


def calibrated_surfaces(P, data, reset_counts, read_lm) -> dict:
    """Phase 9 (d) and (e): ``fit_eval_surface`` for the three methods and
    ``greek_surfaces`` on its grids, held to CPU tensors at P["cpu"]
    surfaces. ``fit_eval_surface`` starts SVI from the heuristic init, from
    which some slices are still moving after 32 iterations, and two
    float32 runs that are still moving end at different points: w_grid
    within 5e-5 of the slice's scale on at least 99 % of the slices and
    within 1e-3 on all, the per-surface fit_rmse within 1e-5, and at most
    2 of the 2 x 64 flags different (a g or a calendar gap that sits on
    its tolerance may fall on either side of it on the two devices). The
    first svi call, with the counts set to 0 just before it, launches the
    raw-SVI kernel once and calls no generic loop."""
    from iv_interpolation_tpu_torch.surface import greeks, surface

    B, E, M, iters, C = P["B"], P["E"], P["M"], P["iters"], P["cpu"]
    k_dev, T_dev = data["k"].to(DEV), data["T"].to(DEV)
    out, grids = {}, None
    for method, _ in CALIB_RUNS:
        iv_dev = data["iv"][method].to(DEV)
        step = lambda: surface.fit_eval_surface(k_dev, iv_dev, T_dev, method=method, n_grid=M,
                                                svi_iters=iters)
        reset_counts()
        res = step()
        lm_calls = read_lm()
        if method == "svi":
            check(lm_calls == {"svi_lm": 1, "generic_lm": 0},
                  f"(d) svi: one raw-SVI kernel launch a call, no generic loop: {lm_calls}")
        check(tuple(res["w_grid"].shape) == (B, E, M) and res["w_grid"].dtype == torch.float32
              and bool(torch.isfinite(res["w_grid"]).all() and torch.isfinite(res["g"]).all()),
              f"(d) {method}: w_grid and g finite, (B, E, M)")
        ref = surface.fit_eval_surface(data["k"][:C], data["iv"][method][:C], data["T"][:C],
                                       method=method, n_grid=M, svi_iters=iters)
        errs = slice_errors(res["w_grid"][:C], ref["w_grid"], data["w"][method][:C])
        near, err = float((errs <= 5e-5).float().mean()), float(errs.max())
        rmse_gap = float((res["fit_rmse"][:C].cpu() - ref["fit_rmse"]).abs().max())
        differ = sum(int((res[f][:C].cpu() != ref[f]).sum())
                     for f in ("butterfly_ok", "calendar_ok"))
        log(f"  (d) {method}: card vs CPU tensors on {C} surfaces: w_grid within 5e-5 of "
            f"scale on {near:.1%} of the slices, worst {err:.2e}, median "
            f"{float(errs.median()):.2e}; fit_rmse gap {rmse_gap:.2e}; flags that differ {differ}")
        check(near >= 0.99 and err <= 1e-3, f"(d) {method}: w_grid as on CPU tensors "
              f"({near:.1%} of slices within 5e-5, worst {err:.2e})")
        check(rmse_gap <= 1e-5, f"(d) {method}: fit_rmse as on CPU tensors ({rmse_gap:.2e})")
        check(differ <= 2, f"(d) {method}: flags as on CPU tensors ({differ} differ)")
        rmse = float(res["fit_rmse"].median())
        check(rmse < 5e-4, f"(d) {method}: median fit_rmse < 5e-4 (got {rmse:.3e})")
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(step, 2)
        both = float((res["butterfly_ok"] & res["calendar_ok"]).float().mean())
        log(f"  (d) fit_eval_surface {method}: {ms:.1f} ms a call, {B / (ms / 1e3):,.0f} "
            f"surfaces/s, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; median "
            f"fit_rmse {rmse:.2e}, both flags clean {both:.1%}")
        out[method] = {"ms": ms, "surfaces_per_s": B / (ms / 1e3), "both_clean": both,
                       "lm_calls": lm_calls}
        if method == "svi":
            grids = (res["k_grid"], res["iv_grid"])
    rng = np.random.default_rng(P["seed"] + 1)
    spot = torch.from_numpy(rng.uniform(50, 150, B).astype(np.float32))
    rate = torch.from_numpy(rng.uniform(0.0, 0.05, B).astype(np.float32))
    call = lambda dev_: greeks.greek_surfaces(grids[0].to(dev_), grids[1].to(dev_),
                                              data["T"].to(dev_), spot.to(dev_), rate.to(dev_))
    got = call(DEV)
    ref = greeks.greek_surfaces(grids[0][:C].cpu(), grids[1][:C].cpu(), data["T"][:C],
                                spot[:C], rate[:C])
    worst = 0.0
    for name, g in ref.items():
        check(tuple(got[name].shape) == (B, E, M) and bool(torch.isfinite(got[name]).all()),
              f"(e) {name}: finite, (B, E, M)")
        scale = float(g.abs().max())
        e = float((got[name][:C].cpu() - g).abs().max()) / scale
        check(e <= 64 * EPS32, f"(e) {name} within 64 eps32 of its scale {scale:.3g} ({e:.2e})")
        worst = max(worst, e)
    ms = cuda_ms(lambda: call(DEV), 5)
    log(f"  (e) greek_surfaces on {B} x {E} x {M}: {ms:.3f} ms a call, six grids within "
        f"{worst:.2e} of scale of CPU tensors")
    out["greeks_ms"] = ms
    return out


def calibrated_task(store, tridiag, agg) -> dict:
    """Phase 9 (f): SURFACE_TASK's store through ``run_surface_fit`` with
    svi, essvi and sabr on the card (production config), each warmed on
    one underlying: surfaces/s, host seconds by phase, idle share, the
    share of surfaces with both flags clean, the median fit_rmse; against
    the same run on CPU tensors fed the card's chains: the counts of clean
    surfaces within 5 of 256, the median fit_rmse within a factor 1.5,
    total variance within 5e-5 of the table's scale on 99 % of the rows."""
    from iv_interpolation_tpu_torch import models
    from iv_interpolation_tpu_torch.config import get_config
    from iv_interpolation_tpu_torch.pipeline import storage as st
    from iv_interpolation_tpu_torch.pipeline import surface_task as task

    work, out = surface_work(), {}
    frame = store.read(st.INTERPOLATED)
    for method, surface in CALIB_RUNS:
        cfg = surface_config(get_config, work, dict(surface, smile_method=method))
        task.run_surface_fit(cfg, store, limit=12, device=DEV)
        store.drop(task.SURFACES)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with SurfaceProbe(task, models, tridiag, agg, on_card=True) as probe:
            timed = TimedStore(store, probe.host)
            t = time.perf_counter()
            rep = task.run_surface_fit(cfg, timed, device=DEV)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        busy, host = probe.busy_s(), dict(probe.host)
        host["unpack"] = wall - sum(host.values())
        peak = torch.cuda.max_memory_allocated() / 2**30
        check(rep["surfaces"] == 256 and rep["grid_rows"] == SURFACE_TASK["grid_rows"]
              and rep["method"] == method, f"(f) {method}: 256 surfaces: {rep}")
        check(probe.plain == 0, f"(f) {method}: no plain version called on the card")
        card = sorted_surfaces(store, task)
        cpu_store = st.MemoryStore()
        cpu_store.write(st.INTERPOLATED, frame)
        t = time.perf_counter()
        with SurfaceProbe(task, models, tridiag, agg, on_card=False, chains=probe.chains):
            cpu_rep = task.run_surface_fit(cfg, cpu_store, device="cpu")
        cpu_s = time.perf_counter() - t
        cpu = sorted_surfaces(cpu_store, task)
        check(all(abs(rep[f] - cpu_rep[f]) <= 5 for f in ("butterfly_ok", "calendar_ok"))
              and len(card) == len(cpu),
              f"(f) {method}: clean counts as on CPU tensors: {rep} / {cpu_rep}")
        per = lambda df: df.groupby("underlying")[["butterfly_ok", "calendar_ok", "fit_rmse"]].first()
        a, b = per(card), per(cpu)
        both = float((a["butterfly_ok"] & a["calendar_ok"]).mean())
        med, med_cpu = float(a["fit_rmse"].median()), float(b["fit_rmse"].median())
        check(max(med, med_cpu) <= 1.5 * min(med, med_cpu) + 1e-7 and np.isfinite(med),
              f"(f) {method}: median fit_rmse {med:.3e} on the card, {med_cpu:.3e} on CPU tensors")
        x, y = (d["total_variance"].to_numpy(np.float64) for d in (card, cpu))
        near = float((np.abs(x - y) <= 5e-5 * max(1.0, np.abs(y).max())).mean())
        check(near >= 0.99, f"(f) {method}: total variance within 5e-5 of scale on {near:.2%} "
              f"of the rows")
        log(f"  (f) {method}: {wall:.3f} s, {256 / wall:,.0f} surfaces/s end to end; host s "
            + ", ".join(f"{k} {v:.3f}" for k, v in host.items())
            + f"; device busy {busy * 1e3:.1f} ms (fit), idle share {1 - busy / wall:.1%}, "
            f"peak {peak:.2f} GiB; both flags clean {both:.1%} (card) / "
            f"{float((b['butterfly_ok'] & b['calendar_ok']).mean()):.1%} (CPU tensors), median "
            f"fit_rmse {med:.2e} / {med_cpu:.2e}; CPU tensors in {cpu_s:.1f} s; total variance "
            f"within 5e-5 of scale on {near:.2%} of rows")
        out[method] = {"surfaces_per_s": 256 / wall, "both_clean": both, "fit_rmse": med}
    store.drop(task.SURFACES)
    return out


# -- phase 10: Andreasen-Huge and RBF ---------------------------------------

# (a)-(c) Andreasen-Huge at its bench shape (bench.py:491): 512 surfaces x
# 8 expiries x 16 quotes with an ATM spike, grid 257, 16 LM iterations,
# float32; 64 surfaces also on CPU tensors and in float64; eval_ah at 64
# surfaces x 64 scattered queries. (d) RBF penalized at 8 x 2,048 sites, 24
# iterations, every site a center, and 64 x 2,048 on 512 centers
# (bench.py:328); the zero-penalty direct path at 8 x 2,048 in float64.
# (e) phase 7's store with ah and rbf, every 8th underlying (32) also on
# CPU tensors.
AH = dict(B=512, E=8, m=16, n_grid=257, iters=16, cpu=64, Q=64, seed=22, seed2=122)
RBF = dict(B=8, N=2048, iters=24, reduced_B=64, centers=512, queries=64, seed=23)
FAMILY_RUNS = ("ah", "rbf")
FAMILY_CPU_STRIDE = 8


def ah_quotes(B: int, seed: int):
    """bench_ah's quotes from a numpy generator: k = linspace(-0.6, 0.6, 16),
    T = linspace(0.08, 1.5, 8), a level U(0.18, 0.30) a surface plus
    0.1 k^2 + 0.02 sqrt(T), the middle quote raised by 40 % (butterfly
    arbitrage in the quotes). float32 CPU tensors (k, iv, T)."""
    E, m = AH["E"], AH["m"]
    rng = np.random.default_rng(seed)
    k = np.broadcast_to(np.linspace(-0.6, 0.6, m, dtype=np.float32), (B, E, m)).copy()
    T = np.broadcast_to(np.linspace(0.08, 1.5, E, dtype=np.float32), (B, E)).copy()
    iv = rng.uniform(0.18, 0.30, (B, 1, 1)).astype(np.float32) + 0.1 * k * k \
        + 0.02 * np.sqrt(T)[..., None]
    iv[..., m // 2] *= 1.4
    return tuple(torch.from_numpy(np.ascontiguousarray(a, np.float32)) for a in (k, iv, T))


class PartitionedSolves:
    """While installed: solves on CPU tensors at shapes the launch plan
    sends to the partitioned route run that route's plain version (the
    kernel's order of operations) in place of the plain Thomas loop."""

    def __init__(self, ops_tridiag, tridiag):
        self.mod, self.tridiag = ops_tridiag, tridiag

    def __enter__(self):
        self.orig, self.calls = self.mod.tridiag_solve_cuda, 0

        def solve(dl, d, du, b):
            n, batch = d.shape
            if (d.device.type == "cpu"
                    and self.tridiag.thomas_plan(n, d.dtype, batch).route == "partitioned"):
                self.calls += 1
                return self.tridiag.tridiag_solve_partitioned_plain(dl, d, du, b)
            return self.orig(dl, d, du, b)
        self.mod.tridiag_solve_cuda = solve
        return self

    def __exit__(self, *exc):
        self.mod.tridiag_solve_cuda = self.orig


class SolveRecorder:
    """While installed: B1 launches through ``ops.tridiag`` by (dtype,
    batch); the wrapper underneath still counts each one."""

    def __init__(self, ops_tridiag):
        self.mod = ops_tridiag

    def __enter__(self):
        from collections import Counter
        self.by, self.orig = Counter(), self.mod.tridiag_solve_cuda

        def recorded(dl, d, du, b):
            self.by[(str(d.dtype)[6:], d.shape[1])] += 1
            return self.orig(dl, d, du, b)
        self.mod.tridiag_solve_cuda = recorded
        return self

    def __exit__(self, *exc):
        self.mod.tridiag_solve_cuda = self.orig


def device_profile(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler``: device launches (kernels
    and memory operations) and the sum of their spans in ms (one stream:
    they do not overlap). Zero launches where the profiler records no
    device activity."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = [ev for ev in prof.events() if str(getattr(ev, "device_type", "")).endswith("CUDA")]
    return {"launches": len(dev), "busy_ms": sum(ev.time_range.elapsed_us() for ev in dev) / 1e3}


def price_gap(ah, k, w_a, w_b) -> float:
    """Largest |c(k, w_a) - c(k, w_b)|: Black-inverted total variances
    compared in price space (unit forward), where the wings' vanishing
    vega cannot magnify a price difference."""
    c = lambda w: ah.normalized_call(k.double().cpu(), w.double().cpu())
    return float((c(w_a) - c(w_b)).abs().max())


def ah_replay(ah, fit, C: int) -> torch.Tensor:
    """The first C surfaces' calibrated curves recomputed on CPU tensors
    from the card's theta: the same chain of refined implicit steps, so
    only the solves' rounding (kernel against plain loop) can differ."""
    x, T, theta, k_q = (f[:C].cpu() for f in (fit.x, fit.expiries, fit.theta, fit.k_q))
    dts = torch.diff(T, dim=-1, prepend=torch.zeros_like(T[:, :1]))
    c = torch.clamp_min(1.0 - torch.exp(x), 0.0)
    curves = []
    for j in range(T.shape[1]):
        c = ah.ah_step(c, ah._cells_to_grid(theta[:, j], k_q[:, j], x), x, dts[:, j], refine=True)
        curves.append(c)
    return torch.stack(curves, 1)


def fit_spread(card: dict, cpu: dict, C: int) -> dict:
    """An AH fit on the card against an independent one on CPU tensors:
    flags that differ, the price_rmse (max over surfaces of the price RMSE
    at the quotes) gap relative to the CPU's, the per-surface fit_rmse
    gap, and the c gap (max, median, surfaces above 1024 float32 ulps).
    On arbitrage-laden quotes the LM pushes some theta to the box and its
    iterate paths part at rounding, so two correct fits can differ in c
    beyond 1024 ulps while their flags and objective agree."""
    flags = sum(int((card[f][:C].cpu() != cpu[f]).sum()) for f in ("butterfly_ok", "calendar_ok"))
    rm_card, rm_cpu = card["fit_rmse"][:C].cpu().double(), cpu["fit_rmse"].double()
    gap = (card["fit"].c[:C].cpu() - cpu["fit"].c).abs().flatten(1).amax(1).double()
    return {"flags_differ": flags,
            "price_rmse_rel": float((rm_card.max() - rm_cpu.max()).abs() / rm_cpu.max()),
            "fit_rmse_gap": float((rm_card - rm_cpu).abs().max()),
            "c_gap_max": float(gap.max()), "c_gap_median": float(gap.median()),
            "surfaces_c_gap_over_1024_ulps": int((gap > 1024 * EPS32).sum())}


def ah_phase(reset_counts, read_by_dtype, ops_tridiag) -> dict:
    """Phase 10 (a)-(c): ``fit_eval_ah_surface`` at the bench shape on the
    card (float32), B1 launches a fit by dtype and batch, device launches
    and busy time from ``torch.profiler``, surfaces/s over CUDA-event time
    and over host time, peak memory; every surface arbitrage-free; 64
    surfaces against CPU tensors (flags equal, prices c within 1024 float32
    ulps of the unit price when the card's theta is replayed there, the
    reference's flag policy; an independent CPU fit with flags equal and
    price_rmse within 1 %); the same 64 in float64 (B1's partitioned
    route, every launch): replayed within 1e-10 in price, an independent CPU float64 fit
    with flags equal and price_rmse within 1e-4, and so a CPU fit whose
    solves take the partitioned route's plain version, and both CPU fits
    on 64 surfaces of a second seed; ``eval_ah`` at 64 x 64 scattered
    queries against CPU tensors."""
    from iv_interpolation_tpu_torch.ops import andreasen_huge as ah
    from iv_interpolation_tpu_torch.ops.cuda import tridiag
    from iv_interpolation_tpu_torch.ops.cuda.tridiag import tridiag_solve_cuda

    B, E, m, C, Q = AH["B"], AH["E"], AH["m"], AH["cpu"], AH["Q"]
    kw = dict(n_grid=AH["n_grid"], n_iters=AH["iters"])
    k, iv, T = ah_quotes(B, AH["seed"])
    kd, ivd, Td = (a.to(DEV) for a in (k, iv, T))
    fit = lambda: ah.fit_eval_ah_surface(kd, ivd, Td, **kw)
    fit()                                           # warm-up
    torch.cuda.synchronize()
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    with SolveRecorder(ops_tridiag) as rec:
        t = time.perf_counter()
        out = fit()
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t
    counts, by_batch = read_by_dtype(), dict(rec.by)
    peak = torch.cuda.max_memory_allocated() / 2**30
    per_slice = AH["iters"]
    want = {("float32", B): E * (2 * per_slice + 3), ("float32", B * m): E * per_slice}
    check(by_batch == want and counts["b1_f32"] == sum(want.values()) and counts["b1_f64"] == 0,
          f"(a) B1 float32 launches a fit by batch {by_batch}, expected {want}: {counts}")
    both = out["butterfly_ok"] & out["calendar_ok"]
    frac = float(both.float().mean())
    price_rmse = float(out["fit_rmse"].max())
    check(bool(both.all()), f"(a) AH arbitrage-free on all {B} surfaces ({frac:.4f})")
    check(bool(torch.isfinite(out["fit"].c).all() and torch.isfinite(out["w_grid"]).all())
          and np.isfinite(price_rmse), "(a) c, w_grid and fit_rmse finite")
    ms = cuda_ms(fit, 2)
    prof = device_profile(fit)
    log(f"  (a) AH fit_eval {B} x {E} x {m}, grid {AH['n_grid']}, {AH['iters']} iterations, "
        f"float32: {ms:.1f} ms a call (CUDA events), {host_s * 1e3:.1f} ms host; "
        f"{B / (ms / 1e3):,.0f} surfaces/s (device events), {B / host_s:,.0f} (host); peak "
        f"{peak:.2f} GiB; B1 launches {by_batch}; device launches {prof['launches']:,}, busy "
        f"{prof['busy_ms']:.1f} ms, idle share {1 - prof['busy_ms'] / (host_s * 1e3):.1%}; "
        f"arbitrage-free {frac:.4f}; price_rmse (max over surfaces of the price RMSE at the "
        f"quotes) {price_rmse:.3e}")
    # 64 surfaces on CPU tensors (the plain Thomas loop): the card's theta
    # replayed through the same steps, then an independent fit
    replay = float((ah_replay(ah, out["fit"], C) - out["fit"].c[:C].cpu()).abs().max())
    t = time.perf_counter()
    ref = ah.fit_eval_ah_surface(k[:C], iv[:C], T[:C], **kw)
    cpu_s = time.perf_counter() - t
    fits = fit_spread(out, ref, C)
    log(f"  (a) card vs CPU tensors on {C} surfaces: the card's theta replayed on CPU, max |c| gap "
        f"{replay:.3e} (bound 1024 eps32 = {1024 * EPS32:.3e}); an independent fit ({cpu_s:.1f} s): "
        + ", ".join(f"{key} {v:.3e}" if isinstance(v, float) else f"{key} {v}"
                    for key, v in fits.items()))
    check(replay <= 1024 * EPS32, f"(a) AH float32 replay on CPU tensors ({replay:.3e})")
    check(fits["flags_differ"] == 0 and fits["price_rmse_rel"] <= 0.01,
          f"(a) AH float32 fits on the card and on CPU tensors: flags equal, price_rmse within 1 %")

    # (b) float64 on the card (B1's partitioned route) against CPU float64
    k64, iv64, T64 = (a[:C].double() for a in (k, iv, T))
    fit64 = lambda: ah.fit_eval_ah_surface(k64.to(DEV), iv64.to(DEV), T64.to(DEV), **kw)
    fit64()
    torch.cuda.synchronize()
    reset_counts()
    with SolveRecorder(ops_tridiag) as rec64:
        t = time.perf_counter()
        out64 = fit64()
        torch.cuda.synchronize()
        host64 = time.perf_counter() - t
    counts64 = read_by_dtype()
    by_route64 = dict(tridiag_solve_cuda.launches_by_route)
    check(counts64["b1_f64"] == sum(want.values()) and counts64["b1_f32"] == 0,
          f"(b) B1 float64 launches a float64 fit: {dict(rec64.by)}")
    check(by_route64 == {"staged": 0, "partitioned": counts64["b1_f64"], "scratch": 0},
          f"(b) every B1 float64 launch of the fit on the partitioned route: {by_route64}")
    replay64 = float((ah_replay(ah, out64["fit"], C) - out64["fit"].c.cpu()).abs().max())
    fits64 = fit_spread(out64, ah.fit_eval_ah_surface(k64, iv64, T64, **kw), C)
    ms64 = cuda_ms(fit64, 1)
    log(f"  (b) AH float64 {C} x {E} x {m}: {ms64:.1f} ms a call (CUDA events), "
        f"{host64 * 1e3:.1f} ms host, B1 float64 {dict(rec64.by)}, {by_route64}; the card's "
        f"theta replayed on "
        f"CPU float64, max |c| gap {replay64:.3e} (bound 1e-10); an independent CPU float64 fit: "
        + ", ".join(f"{key} {v:.3e}" if isinstance(v, float) else f"{key} {v}"
                    for key, v in fits64.items()))
    check(replay64 <= 1e-10, f"(b) AH float64 within 1e-10 in price ({replay64:.3e})")
    check(fits64["flags_differ"] == 0 and fits64["price_rmse_rel"] <= 1e-4,
          "(b) AH float64 fits on the card and on CPU tensors: flags equal, price_rmse within 1e-4")
    # witnesses of that gap: the card's fit against a CPU float64 fit whose
    # solves take the partitioned route's plain version, and both CPU fits
    # on the quotes of a second seed
    def witness(k_, iv_, T_):
        with PartitionedSolves(ops_tridiag, tridiag) as part:
            fitted = ah.fit_eval_ah_surface(k_, iv_, T_, **kw)
        check(part.calls == sum(want.values()),
              f"(b) the witness fit solved every system by the partitioned plain version "
              f"({part.calls})")
        return fitted
    gaps = {AH["seed"]: {"thomas": fits64,
                         "partitioned": fit_spread(out64, witness(k64, iv64, T64), C)}}
    k2, iv2, T2 = (a.double() for a in ah_quotes(C, AH["seed2"]))
    out2 = ah.fit_eval_ah_surface(k2.to(DEV), iv2.to(DEV), T2.to(DEV), **kw)
    gaps[AH["seed2"]] = {"thomas": fit_spread(out2, ah.fit_eval_ah_surface(k2, iv2, T2, **kw), C),
                         "partitioned": fit_spread(out2, witness(k2, iv2, T2), C)}
    for seed, by in gaps.items():
        for plain, f in by.items():
            log(f"  (b) seed {seed}, the card's float64 fit against a CPU fit by the {plain} "
                "plain solve: " + ", ".join(f"{key} {v:.3e}" if isinstance(v, float)
                                            else f"{key} {v}" for key, v in f.items()))
            check(f["flags_differ"] == 0 and f["price_rmse_rel"] <= 1e-4,
                  f"(b) seed {seed}, CPU fit by the {plain} plain solve: flags equal, "
                  f"price_rmse within 1e-4")

    # (c) eval_ah at scattered queries on the float32 fit's first 64 surfaces
    rng = np.random.default_rng(AH["seed"] + 1)
    k_q = torch.from_numpy(rng.uniform(-0.6, 0.6, (C, Q)).astype(np.float32))
    T_q = torch.from_numpy(rng.uniform(0.02, 2.0, (C, Q)).astype(np.float32))
    sub = ah.AHFit(*(f[:C] for f in out["fit"]))
    reset_counts()
    w_card = ah.eval_ah(sub, k_q.to(DEV), T_q.to(DEV))
    torch.cuda.synchronize()
    eval_counts = read_by_dtype()
    w_cpu = ah.eval_ah(ah.AHFit(*(f.cpu() for f in sub)), k_q, T_q)
    gap = price_gap(ah, k_q, w_card, w_cpu)
    eval_ms = cuda_ms(lambda: ah.eval_ah(sub, k_q.to(DEV), T_q.to(DEV)), 3)
    log(f"  (c) eval_ah {C} x {Q} queries: {eval_ms:.2f} ms a call, B1 {eval_counts}; vs CPU "
        f"tensors max price gap {gap:.3e}")
    check(eval_counts["b1_f32"] == 2 and gap <= 1024 * EPS32 and bool(torch.isfinite(w_card).all()),
          f"(c) eval_ah: two B1 launches, prices within 1024 ulps of CPU tensors ({gap:.3e})")
    return {"surfaces_per_s": B / (ms / 1e3), "surfaces_per_s_host": B / host_s,
            "b1_f32": counts["b1_f32"] + eval_counts["b1_f32"], "b1_f64": counts64["b1_f64"],
            "b1_f64_by_route": by_route64, "b1_f64_by_batch": dict(rec64.by),
            "f64_gaps": gaps,
            "arbfree": frac, "price_rmse": price_rmse, "ms": ms, "ms64": ms64}


def rbf_quotes(B: int, N: int, seed: int, dtype=F32):
    """bench_rbf's quotes from a numpy generator: k U(-1, 1), T U(0.05, 2),
    w = (0.04 + 0.3 k^2) T + 0.01 sin(8k) T (butterfly arbitrage in the
    quotes). CPU tensors (points (B, N, 2), w (B, N))."""
    rng = np.random.default_rng(seed)
    k, T = rng.uniform(-1.0, 1.0, (B, N)), rng.uniform(0.05, 2.0, (B, N))
    w = (0.04 + 0.3 * k * k) * T + 0.01 * np.sin(8.0 * k) * T
    pts = np.stack([k, T], axis=-1)
    return torch.from_numpy(pts).to(dtype), torch.from_numpy(w).to(dtype)


def saddle_cond(rbf, pts: torch.Tensor, smoothing: float) -> torch.Tensor:
    """The condition numbers of the zero-penalty thin-plate saddle systems
    [[K + s I, P], [P^T, 0]] of (B, N, 2) sites, in float64."""
    pts = pts.double()
    n = pts.shape[-2]
    K = rbf._kernel(rbf._pairwise_r(pts, pts), "thin_plate", 1.0)
    P = rbf._poly(pts, 3)
    K = K + (smoothing + 1e-12) * torch.eye(n, dtype=K.dtype, device=K.device)
    lhs = torch.cat([torch.cat([K, P], -1),
                     torch.cat([P.mT, torch.zeros((*P.shape[:-2], 3, 3), dtype=K.dtype,
                                                  device=K.device)], -1)], -2)
    return torch.linalg.cond(lhs)


def rbf_phase() -> dict:
    """Phase 10 (d): ``fit_eval_rbf_arbfree_batched`` penalized on the card
    at 8 x 2,048 (every site a center) and 64 x 2,048 on 512 centers,
    float32, 24 iterations: surfaces/s over CUDA events, the arbitrage-free
    fraction on the penalty grid, peak memory, device launches; then the
    zero-penalty direct path at 8 x 2,048 in float64 against CPU float64,
    within kappa * eps64 * max|w| (kappa the larger condition number of
    the first two surfaces' saddle systems, measured)."""
    from iv_interpolation_tpu_torch.ops import rbf

    out = {}
    for name, B, extra in (("full", RBF["B"], {}),
                           ("reduced", RBF["reduced_B"], {"n_centers": RBF["centers"]})):
        pts, w = (a.to(DEV) for a in rbf_quotes(B, RBF["N"], RBF["seed"]))
        step = lambda: rbf.fit_eval_rbf_arbfree_batched(
            pts, w, pts[:, :RBF["queries"]], smoothing=1e-8, n_iters=RBF["iters"], **extra)
        w_q, bok, cok = step()
        torch.cuda.synchronize()
        check(bool(torch.isfinite(w_q).all()), f"(d) rbf {name}: finite surfaces")
        frac = float((bok & cok).float().mean())
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(step, 2)
        peak = torch.cuda.max_memory_allocated() / 2**30
        prof = device_profile(step)
        log(f"  (d) rbf penalized {name} {B} x {RBF['N']}{' c=%d' % RBF['centers'] if extra else ''}"
            f", {RBF['iters']} iterations, float32: {ms:.1f} ms a call, {B / (ms / 1e3):,.1f} "
            f"surfaces/s, arbitrage-free {frac:.4f}, peak {peak:.2f} GiB, device launches "
            f"{prof['launches']:,}, busy {prof['busy_ms']:.1f} ms")
        out[name] = {"surfaces_per_s": B / (ms / 1e3), "arbfree": frac, "ms": ms}
        del pts, w
        torch.cuda.empty_cache()
    pts, w = rbf_quotes(RBF["B"], RBF["N"], RBF["seed"], F64)
    q = pts[:, :RBF["queries"]]
    direct = lambda dev, dtype: rbf.fit_eval_rbf_arbfree_batched(
        pts.to(dev, dtype), w.to(dev, dtype), q.to(dev, dtype), smoothing=1e-8,
        butterfly_weight=0.0, calendar_weight=0.0)[0]
    ref = direct("cpu", F64)
    got = direct(DEV, F64).cpu()
    got32 = direct(DEV, F32).cpu().double()
    kappa = float(saddle_cond(rbf, pts[:2].to(DEV), 1e-8).max())
    bound = kappa * EPS64 * float(w.abs().max())
    err, err32 = float((got - ref).abs().max()), float((got32 - ref).abs().max())
    log(f"  (d) rbf direct (zero penalty) {RBF['B']} x {RBF['N']}: float64 on the card vs CPU "
        f"float64 max |w| gap {err:.3e} (bound kappa eps64 max|w| = {bound:.3e}, kappa "
        f"{kappa:.3e}); float32 on the card vs CPU float64 {err32:.3e}")
    check(err <= bound, f"(d) rbf direct float64 within {bound:.3e} of CPU float64 ({err:.3e})")
    out["direct_err"], out["kappa"] = err, kappa
    return out


def family_task(store, ops_tridiag, tridiag, agg, reset_counts, read_by_dtype) -> dict:
    """Phase 10 (e): SURFACE_TASK's store through ``run_surface_fit`` with
    ah and rbf on the card (production config, float32), each warmed on
    one underlying: host seconds by phase, surfaces/s, the device's idle
    share, B1 launches by dtype and batch, no plain version called; every
    8th underlying also on CPU tensors fed the card's chains (AH: flags
    equal, prices within 1024 float32 ulps on 99 % of the rows and within
    1e-3 on all; RBF: the saddle systems' condition numbers, measured,
    bound what float32 can hold: w within kappa eps32, flags reported)."""
    from iv_interpolation_tpu_torch import models
    from iv_interpolation_tpu_torch.config import get_config
    from iv_interpolation_tpu_torch.ops import andreasen_huge as ah
    from iv_interpolation_tpu_torch.ops import rbf
    from iv_interpolation_tpu_torch.pipeline import storage as st
    from iv_interpolation_tpu_torch.pipeline import surface_task as task

    work, out, launches = surface_work(), {}, {"b1_f32": 0, "b1_f64": 0, "b2": 0}
    frame = store.read(st.INTERPOLATED)
    n_und = SURFACE_TASK["big"][0] + SURFACE_TASK["small"][0]
    for method in FAMILY_RUNS:
        cfg = surface_config(get_config, work, {"smile_method": method})
        task.run_surface_fit(cfg, store, limit=12, device=DEV)
        store.drop(task.SURFACES)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        with SurfaceProbe(task, models, tridiag, agg, on_card=True) as probe, \
                SolveRecorder(ops_tridiag) as rec:
            timed = TimedStore(store, probe.host)
            t = time.perf_counter()
            rep = task.run_surface_fit(cfg, timed, device=DEV)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        counts = read_by_dtype()
        busy, host = probe.busy_s(), dict(probe.host)
        host["unpack"] = wall - sum(host.values())
        peak = torch.cuda.max_memory_allocated() / 2**30
        check(rep["surfaces"] == n_und and rep["method"] == method,
              f"(e) {method}: {n_und} surfaces: {rep}")
        check(probe.plain == 0, f"(e) {method}: no plain version called on the card")
        check(counts["b2"] == 0 and counts["b1_f64"] == 0
              and (counts["b1_f32"] > 0) == (method == "ah"),
              f"(e) {method}: B1 float32 on the AH path only: {counts}")
        for key in launches:
            launches[key] += counts[key]
        card = sorted_surfaces(store, task)
        # every 8th underlying on CPU tensors, fed the card's chains
        unds = sorted({c["underlying"] for c in probe.chains})[::FAMILY_CPU_STRIDE]
        chains = [c for c in probe.chains if c["underlying"] in set(unds)]
        cpu_store = st.MemoryStore()
        cpu_store.write(st.INTERPOLATED, frame)
        t = time.perf_counter()
        with SurfaceProbe(task, models, tridiag, agg, on_card=False, chains=chains):
            task.run_surface_fit(cfg, cpu_store, device="cpu")
        cpu_s = time.perf_counter() - t
        cpu = sorted_surfaces(cpu_store, task)
        mine = card[card["underlying"].isin(unds)].reset_index(drop=True)
        check(len(mine) == len(cpu), f"(e) {method}: {len(mine)} rows on the card, {len(cpu)} on CPU")
        per = lambda df: df.groupby("underlying")[["butterfly_ok", "calendar_ok"]].first()
        differ = int((per(mine) != per(cpu)).to_numpy().sum())
        x, y = (torch.from_numpy(d["total_variance"].to_numpy(np.float64)) for d in (mine, cpu))
        kq = torch.from_numpy(cpu["log_moneyness"].to_numpy(np.float64))
        both = float((per(card)["butterfly_ok"] & per(card)["calendar_ok"]).mean())
        if method == "ah":
            gap = price_gap(ah, kq, x, y)
            c = lambda w: ah.normalized_call(kq, w)
            near = float(((c(x) - c(y)).abs() <= 1024 * EPS32).double().mean())
            extra = {"price_gap": gap, "rows_within_1024_ulps": near}
            # two independent float32 LM fits part at rounding (phase 10
            # (a)): flags equal, prices within 1024 ulps on 99 % of the rows
            check(differ == 0 and near >= 0.99 and gap <= 1e-3,
                  f"(e) ah on the card as on CPU tensors: {differ} flags, price gap {gap:.3e}, "
                  f"{near:.2%} of rows within 1024 ulps")
        else:
            # the saddle systems of a few underlyings of each bucket, float64
            rel = float((x - y).abs().max()) / float(y.abs().max())
            kappa, kappa_real = rbf_task_cond(task, rbf, probe.chains)
            extra = {"w_gap_rel": rel, "kappa": kappa, "kappa_without_padded_slots": kappa_real}
            # kappa eps32 > 1: float32 guarantees no digit of these solves
            # (ROADMAP C10); held to that bound, the flags reported
            check(bool(np.isfinite(card["total_variance"].to_numpy()).all())
                  and rel <= kappa * EPS32, f"(e) rbf: finite, w within kappa eps32 of CPU tensors")
        log(f"  (e) {method}: {wall:.3f} s, {n_und / wall:,.1f} surfaces/s end to end; host s "
            + ", ".join(f"{k} {v:.3f}" for k, v in host.items())
            + f"; device busy {busy * 1e3:.1f} ms (fit), idle share {1 - busy / wall:.1%}, peak "
            f"{peak:.2f} GiB; B1 {dict(rec.by)}; both flags clean {both:.1%}; {len(unds)} "
            f"underlyings on CPU tensors in {cpu_s:.1f} s: flags that differ {differ}, "
            + ", ".join(f"{k} {v:.3e}" for k, v in extra.items()))
        out[method] = {"surfaces_per_s": n_und / wall, "both_clean": both, "idle": 1 - busy / wall,
                       **extra}
    store.drop(task.SURFACES)
    out["launches"] = launches
    return out


def rbf_task_cond(task, rbf, chains):
    """The largest condition number of the zero-penalty saddle systems
    the surface task solves, on the first 8 underlyings of each bucket
    (float64): with the packed sites as the task fits them (padded expiry
    slots 1e-3 apart in T, padded strikes), and with the real quotes only."""
    by_und = {}
    for c in chains:
        by_und.setdefault(c["underlying"], []).append(c)
    groups = {}
    for und, slices in by_und.items():
        slices = sorted(slices, key=lambda c: c["T"])
        shape = (task._pow2_at_least(max(len(slices), 2), 2),
                 task._pow2_at_least(max(len(c["k"]) for c in slices), 8))
        groups.setdefault(shape, []).append((und, slices))
    worst, real = 0.0, 0.0
    for (E_pad, n_pad), group in groups.items():
        k, _, T, _, mask = task.pack_chain_group(group[:8], E_pad, n_pad)
        pts = np.stack([k.reshape(len(k), -1), np.repeat(T, n_pad, axis=-1)], axis=-1)
        worst = max(worst, float(saddle_cond(rbf, torch.from_numpy(pts), 1e-8).max()))
        for b in range(len(pts)):
            live = torch.from_numpy(pts[b][mask[b].reshape(-1)])
            real = max(real, float(saddle_cond(rbf, live, 1e-8)))
    return worst, real


def family_cli(root, work) -> None:
    """Phase 10 (f), three CLI processes on phase 7's parquet store, run
    together: ``--task surface --method ah --profile --symbols 24`` (2
    underlyings, a trace of a few MB) exits 0 with
    ``profile_dir`` and a non-empty ``torch.profiler`` trace holding the
    card's kernels; ``--validate-only`` and ``--estimate`` exit 0 with the
    JAX CLI's keys."""
    cli_dir = work / "cli10"
    cli_dir.mkdir(parents=True, exist_ok=True)
    base = [sys.executable, "-m", "iv_interpolation_tpu_torch.cli", "--storage", "parquet",
            "--data-root", str(work / "data"), "--json", "--device", DEV]
    runs = {"ah --profile": ["--task", "surface", "--method", "ah", "--profile", "--symbols", "24"],
            "--validate-only": ["--validate-only", "--task", "surface"],
            "--estimate": ["--estimate"]}
    procs = {name: subprocess.Popen(base + args, cwd=cli_dir, env=cli_env(root), text=True,
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for name, args in runs.items()}
    outs = {}
    for name, proc in procs.items():
        try:
            stdout, stderr = proc.communicate(timeout=300)
        finally:
            proc.kill()
        check(proc.returncode == 0, f"(f) {name} exits 0: {stderr[-2000:]}")
        outs[name] = json.loads(stdout.strip().splitlines()[-1])
    prof = outs["ah --profile"]
    check(prof["surface"]["surfaces"] == 2 and prof["surface"]["method"] == "ah",
          f"(f) --method ah fitted the 24 chains' 2 surfaces: {prof['surface']}")
    traces = list((cli_dir / prof["profile_dir"]).glob("trace_*.json"))
    check(len(traces) == 1 and traces[0].stat().st_size > 0, f"(f) one trace written: {traces}")
    events = json.loads(traces[0].read_text())["traceEvents"]
    kernels = sum(1 for ev in events if ev.get("cat") == "kernel")
    check(kernels > 0, "(f) the trace holds the card's kernels")
    check(set(outs["--validate-only"]) == {"ready", "task", "checks"}
          and outs["--validate-only"]["ready"]
          and outs["--validate-only"]["checks"]["device"]["platform"] == "gpu",
          f"(f) --validate-only: {outs['--validate-only']}")
    check(set(outs["--estimate"]) == {"input_rows", "symbols", "estimated_output_rows",
                                      "measured_grid_points_per_s", "estimated_seconds",
                                      "estimated_minutes"}, f"(f) --estimate: {outs['--estimate']}")
    log(f"  (f) --task surface --method ah --profile: exit 0, {prof['surface']}, trace "
        f"{traces[0].stat().st_size / 1e6:.1f} MB with {kernels:,} kernel events; "
        f"--validate-only: ready, device {outs['--validate-only']['checks']['device']}; "
        f"--estimate: {outs['--estimate']}")


# -- phase 11: the operator's pieces -------------------------------------------

# (a) window_candles on phase 4's ring capacity: 1,024 streams x 5 channels
# x 8,192 slots, float32, each stream pushed 4,096 to 16,383 one-minute
# ticks in 4 blocks of 4,096 (wrapped rings beside unwrapped ones), its own
# first minute near an epoch minute; 5-minute buckets. Then the smoothing
# spline's penalty search at 1,024 x 30 slices of 50 quotes, 8 penalties,
# float64, 64 surfaces also on CPU tensors.
RING = dict(B=1024, C=5, L=8192, K=4096, pushes=4, bm=5, seed=24)
AUTOLAM = dict(B=1024, E=30, N=50, lams=8, cpu=64, seed=25)
# (b) the shard proofs: 256 symbols x 1 day, 32 symbols a batch (4 or 5
# batches a shard), so the victim is killed between two of its batches
SHARDS = dict(symbols=256, hours=24, batch=32)
# (c) the PostgreSQL-backed run against the loopback mock server. The
# mock parses every INSERT with regular expressions and checks each row's
# key against every stored row, so its time grows with the square of a
# table's rows: 4 symbols x 12 hours (2,644 rows a table) in 2 batches.
PG = dict(symbols=4, hours=12, batch=2, seed=26)
# (f) a cubic-spline SurfaceFit of 64 surfaces x 8 expiries x 16 quotes
CKPT = dict(B=64, E=8, n=16, seed=27)


def ring_ticks(gen_cpu, P):
    """RING's pushes, made on the host from a seed: (blocks of (rows,
    valid)), each stream's total and first minute."""
    B, C, K = P["B"], P["C"], P["K"]
    half = P["L"] // 2
    total = half + (torch.arange(B) * 7919) % (P["pushes"] * K - half)   # 4,096 .. 16,383
    t0 = 28_000_000 + (torch.arange(B) * 104_729) % 100_003          # epoch minutes
    price = 100 + torch.randn((B, P["pushes"] * K), generator=gen_cpu).cumsum(-1) * 0.01
    spread = torch.rand((B, P["pushes"] * K), generator=gen_cpu) * 0.05
    vol = torch.randint(0, 50, (B, P["pushes"] * K), generator=gen_cpu).float()
    data = torch.stack([price, price + spread, price - spread, price + 0.3 * spread, vol], 1)
    blocks = []
    for p in range(P["pushes"]):
        sl = slice(p * K, (p + 1) * K)
        valid = (torch.arange(p * K, (p + 1) * K)[None, :] < total[:, None])
        blocks.append((data[:, :, sl].contiguous(), valid))
    return blocks, total, t0


def wrapped_ring(ringbuffer, blocks, device):
    P = RING
    ring = ringbuffer.make_ring(P["B"], P["C"], P["L"], device=device)
    for rows, valid in blocks:
        ringbuffer.push(ring, rows.to(device), valid.to(device))
    return ring


def window_candles_phase(ringbuffer, agg, reset_counts, read_counts) -> dict:
    """Phase 11 (a): ``window_candles`` over RING on the card is one B2
    launch; it equals its plain version on the card (every output exact,
    volume within the sum bound) and the same ring on CPU tensors; then
    ``fit_smoothing_spline_autolam`` at AUTOLAM against CPU tensors."""
    P = RING
    blocks, total, t0 = ring_ticks(torch.Generator().manual_seed(P["seed"]), P)
    card = wrapped_ring(ringbuffer, blocks, DEV)
    check(torch.equal(card.count.cpu(), total.to(torch.int32)), "(a) every stream's push count")
    kw = dict(bucket_minutes=P["bm"], num_segments=P["L"] // P["bm"] + 1, min_count=P["bm"])
    torch.cuda.synchronize()
    reset_counts()
    got = ringbuffer.window_candles(card, t0.to(DEV), **kw)
    torch.cuda.synchronize()
    launches = read_counts()
    check(launches == {"b1": 0, "b2": 1}, f"(a) window_candles is one B2 launch: {launches}")
    ticks = ringbuffer.window_ticks(card, t0.to(DEV), P["bm"])
    ref = agg.aggregate_ohlcv_plain(*ticks, base_bucket=0, **kw)
    err = compare_candles(got, ref, ticks, P["bm"], 0, kw["num_segments"], "window_candles")
    cpu_ring = wrapped_ring(ringbuffer, blocks, "cpu")
    cpu = ringbuffer.window_candles(cpu_ring, t0, **kw)
    cpu_ticks = ringbuffer.window_ticks(cpu_ring, t0, P["bm"])
    check(all(same_with_nan(a.cpu(), b) for a, b in zip(ticks, cpu_ticks)),
          "(a) the card's window and minutes equal the CPU ring's")
    err_cpu = compare_candles(type(got)(*(a.cpu() for a in got)), cpu, cpu_ticks, P["bm"], 0,
                              kw["num_segments"], "window_candles vs CPU tensors")
    wrapped = int((total > P["L"]).sum())
    check(0 < wrapped < P["B"] and int(got.valid.sum()) > 0, f"(a) {wrapped} wrapped rings")
    ms = cuda_ms(lambda: ringbuffer.window_candles(card, t0.to(DEV), **kw), 10)
    log(f"  (a) window_candles {P['B']} x {P['L']} -> {kw['num_segments']} ({wrapped} wrapped "
        f"rings, per-stream t0): 1 B2 launch, {int(got.valid.sum()):,} complete candles, "
        f"{ms:.4f} ms a call (device, the window's gathers included); max|volume| vs plain "
        f"{err:.3e}, vs CPU tensors {err_cpu:.3e}")
    return {"launches": launches["b2"], "ms": ms, "autolam": autolam_case()}


def autolam_case() -> dict:
    """(a): ``fit_smoothing_spline_autolam`` on AUTOLAM's float64 slices
    on the card (timed) against the first ``cpu`` surfaces on CPU tensors:
    x exact, g within 1e-10 and M within 1e-8 of their scales (a slice that
    took another penalty would differ by orders more)."""
    from iv_interpolation_tpu_torch.ops.smoothing_spline import fit_smoothing_spline_autolam
    P = AUTOLAM
    gen = torch.Generator().manual_seed(P["seed"])
    k = torch.linspace(-1.0, 1.0, P["N"], dtype=F64) + (
        torch.rand((P["B"], P["E"], P["N"]), generator=gen, dtype=F64) - 0.5) * 0.02
    noise = torch.tensor([0.0, 1e-3, 4e-3, 2e-2], dtype=F64).repeat(P["E"] // 4 + 1)[:P["E"]]
    w = 0.04 + 0.1 * k**2 + noise[None, :, None] * torch.randn(k.shape, generator=gen, dtype=F64)
    lams = torch.logspace(-8, -2, P["lams"], dtype=F64)
    kc, wc, lc = k.to(DEV), w.to(DEV), lams.to(DEV)
    fit = fit_smoothing_spline_autolam(kc, wc, lc)
    ms = cuda_ms(lambda: fit_smoothing_spline_autolam(kc, wc, lc), 3)
    C = P["cpu"]
    ref = fit_smoothing_spline_autolam(k[:C], w[:C], lams)
    check(torch.equal(fit.x[:C].cpu(), ref.x), "(a) autolam x exact")
    dg = float((fit.g[:C].cpu() - ref.g).abs().max())
    dm = float((fit.M[:C].cpu() - ref.M).abs().max())
    scale_m = float(ref.M.abs().max())
    check(dg <= 1e-10 and dm <= 1e-8 * max(1.0, scale_m),
          f"(a) autolam g within 1e-10 ({dg:.3e}) and M within 1e-8 of {scale_m:.3g} ({dm:.3e})")
    log(f"  (a) fit_smoothing_spline_autolam {P['B']} x {P['E']} x {P['N']}, {P['lams']} "
        f"penalties, float64: {ms:.2f} ms on the card; {C} surfaces vs CPU tensors: g "
        f"{dg:.2e}, M {dm:.2e}")
    return {"ms": ms, "g_err": dg}


def shard_phase(work) -> dict:
    """Phase 11 (b): ``proof_concurrent`` and ``proof_kill_resume`` with
    both shard processes on the card, SHARDS' run, held to one unsharded
    reference run on the card by the card's comparison (every column exact
    but the 5-minute volume, within 8 eps32)."""
    from iv_interpolation_tpu_torch.parallel import shardproof
    P = SHARDS
    kw = dict(num_symbols=P["symbols"], hours=P["hours"], device=DEV, batch_size=P["batch"])
    t = time.perf_counter()
    ref = shardproof.reference_tables(str(work / "reference"), **kw)
    t_ref = time.perf_counter() - t
    conc = shardproof.proof_concurrent(str(work / "concurrent"), timeout_s=300, reference=ref, **kw)
    kill = shardproof.proof_kill_resume(str(work / "kill"), timeout_s=300, reference=ref, **kw)
    log(f"  (b) {P['symbols']} symbols x {P['hours']} h, {P['batch']} a batch; the unsharded "
        f"reference run in this process {t_ref:.1f} s")
    log(f"  (b) proof_concurrent: partition {conc['partition_sizes']}, the two shards "
        f"{conc['wall_s']:.3f} s wall, tables {conc['tables']}, 5-min volumes that differ "
        f"{conc['volumes_that_differ']}")
    log(f"  (b) proof_kill_resume: shard 0 killed after {kill['completed_before_kill']} of "
        f"{kill['partition_sizes'][0]} symbols, resumed batch {kill['killed_batch_id']} beside "
        f"shard 1; {kill['wall_s']:.3f} s wall, 5-min volumes that differ "
        f"{kill['volumes_that_differ']}")
    return {"concurrent": conc, "kill": kill, "store": work / "kill" / "kill_store"}


def load_mock_server(root):
    """``tests/pg_mock_server.py`` by path (it is pure Python)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("pg_mock_server",
                                                  root / "tests" / "pg_mock_server.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.MockPgServer


def pg_env(root, srv):
    return dict(cli_env(root), IVTPU_STORAGE__PG_HOST="127.0.0.1",
                IVTPU_STORAGE__PG_PORT=str(srv.port), IVTPU_STORAGE__PG_DATABASE="test",
                IVTPU_STORAGE__PG_USER="ivtpu", IVTPU_STORAGE__PG_PASSWORD="secret")


def postgres_phase(root, work, srv, reset_counts, read_counts) -> dict:
    """Phase 11 (c), against the mock server (SCRAM-SHA-256): ``--check-db
    --storage postgres`` in a subprocess, then PG's run through a
    ``PipelineRunner`` on a ``PostgresStore`` on the card, its tables read
    back from the server equal to the same run on a parquet store on the
    card (card rule), B2 once a batch."""
    import pandas as pd

    from iv_interpolation_tpu_torch.config import get_config
    from iv_interpolation_tpu_torch.parallel import shardproof
    from iv_interpolation_tpu_torch.pipeline import runner as runner_mod
    from iv_interpolation_tpu_torch.pipeline import storage as st
    from iv_interpolation_tpu_torch.pipeline.sample_data import generate_sample_tickers

    (work / "cli").mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([sys.executable, "-m", "iv_interpolation_tpu_torch.cli", "--check-db",
                           "--storage", "postgres", "--json"], cwd=work / "cli",
                          env=pg_env(root, srv), capture_output=True, text=True, timeout=120)
    check(proc.returncode == 0, f"(c) --check-db exits 0: {proc.stderr[-2000:]}")
    db = json.loads(proc.stdout.strip().splitlines()[-1])
    check(db["ok"] and db["backend"] == "postgres" and set(db["permissions"]) ==
          {"create_table", "pg_stat_access", "database_size"}, f"(c) --check-db: {db}")
    P = PG
    tickers = generate_sample_tickers(num_symbols=P["symbols"], hours=P["hours"], seed=P["seed"])
    pg = st.PostgresStore("127.0.0.1", "test", "ivtpu", "secret", port=srv.port,
                          connect_test=True)
    stores = {"postgres": pg, "parquet": st.ParquetStore(str(work / "pg_ref"))}
    res, launches = {}, None
    for name, store in stores.items():
        store.write(st.TICKERS, tickers, upsert_keys=["symbol", "date"])
        cfg = runner_config(get_config, work / name, P["batch"])
        t = time.perf_counter()
        if name == "postgres":
            reset_counts()
        res[name] = runner_mod.PipelineRunner(cfg, store, device=DEV).run_pipeline_fused()
        if name == "postgres":
            torch.cuda.synchronize()
            launches = read_counts()
        res[name]["wall"] = time.perf_counter() - t
    n_batches = -(-P["symbols"] // P["batch"])
    check(launches == {"b1": 0, "b2": n_batches},
          f"(c) B2 once a batch on the postgres-backed run ({n_batches}): {launches}")
    check(res["postgres"]["task2"]["by_status"] == {"completed": P["symbols"]},
          f"(c) every symbol completed: {res['postgres']['task2']['by_status']}")
    want = {t: read_table(stores["parquet"], t) for t in TABLE_KEYS}
    got = {}
    for table, ref in want.items():
        df = pg.read(table).drop(columns=["id"])
        for c in ref.columns:
            if ref[c].dtype.kind == "M":
                df[c] = pd.to_datetime(df[c]).astype(ref[c].dtype)
            elif ref[c].dtype.kind in "fiub":
                df[c] = df[c].astype(ref[c].dtype)
        df["symbol"] = df["symbol"].astype(str)
        got[table] = df[list(ref.columns)].sort_values(TABLE_KEYS[table]).reset_index(drop=True)
    differ = shardproof.assert_tables_equal(got, want, DEV)
    rows = {t: len(df) for t, df in got.items()}
    log(f"  (c) --check-db: {db['server']}, permissions {db['permissions']}; PostgresStore run "
        f"{P['symbols']} symbols x {P['hours']} h in {n_batches} batches: {res['postgres']['wall']:.2f} s "
        f"(parquet {res['parquet']['wall']:.2f} s), rows {rows}, equal to the parquet run "
        f"(5-min volumes that differ {differ}), launches {launches}")
    return {"launches": launches["b2"]}


def children_of(pid: int) -> list:
    """Every live descendant of ``pid``, from /proc."""
    parent = {}
    for d in Path("/proc").iterdir():
        if d.name.isdigit():
            try:
                parent[int(d.name)] = int((d / "stat").read_text().rsplit(")", 1)[1].split()[1])
            except (OSError, IndexError, ValueError):
                pass
    out, todo = [], [pid]
    while todo:
        p = todo.pop()
        kids = [c for c, pp in parent.items() if pp == p]
        out += kids
        todo += kids
    return out


def maps_cuda(pid: int) -> bool | None:
    """Whether ``pid`` has the CUDA driver library mapped (None: gone)."""
    try:
        return "libcuda.so" in Path(f"/proc/{pid}/maps").read_text()
    except OSError:
        return None


class MonitorRun:
    """Phase 11 (d): ``--task pipeline --with-monitor`` over (b)'s store in
    a subprocess on the card, watched from a thread while this process
    goes on with (c). The side dashboard prints a frame of the new batch;
    while the run lasts, its process (and every other child of the CLI)
    never appears among the card's compute processes and never maps the
    CUDA driver, while the CLI does. Then ``--monitor`` on the finished
    batch prints ``batch complete``."""

    def __init__(self, root, work, store_root):
        import threading
        self.dir = work / "monitor"
        self.dir.mkdir(parents=True, exist_ok=True)
        self.env = dict(cli_env(root), IVTPU_MONITORING__REFRESH_INTERVAL_S="0.5",
                        IVTPU_PROCESSING__BATCH_SIZE=str(SHARDS["batch"]),
                        IVTPU_CHECKPOINT__CHECKPOINT_INTERVAL="1",
                        IVTPU_CHECKPOINT__MANIFEST_DIR=str(self.dir / "runs"))
        cmd = [sys.executable, "-m", "iv_interpolation_tpu_torch.cli", "--task", "pipeline",
               "--with-monitor", "--env", "testing", "--storage", "parquet", "--data-root",
               str(store_root), "--json", "--device", DEV]
        with open(self.dir / "out.log", "w") as out:
            self.proc = subprocess.Popen(cmd, cwd=self.dir, env=self.env, stdout=out,
                                         stderr=subprocess.STDOUT, text=True)
        self.apps, self.kids, self.kid_cuda, self.cli_cuda, self.polls = set(), set(), set(), False, 0
        self.thread = threading.Thread(target=self._watch, daemon=True)
        self.thread.start()

    def _watch(self):
        deadline = time.time() + 300
        while self.proc.poll() is None and time.time() < deadline:
            now = set(children_of(self.proc.pid))
            self.kids |= now
            self.cli_cuda |= bool(maps_cuda(self.proc.pid))
            self.kid_cuda |= {k for k in now if maps_cuda(k)}
            smi = subprocess.run(["nvidia-smi", "--query-compute-apps=pid",
                                  "--format=csv,noheader"],
                                 capture_output=True, text=True, timeout=60).stdout
            self.apps |= {int(x) for x in smi.split() if x.strip().isdigit()}
            self.polls += 1
            time.sleep(0.1)

    def finish(self) -> subprocess.Popen:
        """The run's checks; starts and returns the ``--monitor`` process."""
        self.thread.join(timeout=320)
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        text = (self.dir / "out.log").read_text()
        check(self.proc.returncode == 0, f"(d) --with-monitor exits 0: {text[-2000:]}")
        result = json.loads(text.strip().splitlines()[-1])
        bid = result["task1"]["batch_id"]
        check(f"batch {bid} [interpolation]" in text,
              f"(d) the side dashboard printed a frame of batch {bid}: {text[-2000:]}")
        check(self.kids and not (self.kids & self.apps) and not self.kid_cuda,
              f"(d) the CLI's children {sorted(self.kids)} never on the card (compute apps "
              f"{sorted(self.apps)}, CUDA mapped in {sorted(self.kid_cuda)})")
        if DEV == "cuda":
            check(self.cli_cuda, "(d) the CLI process itself maps the CUDA driver")
        listed = ("listed" if self.proc.pid in self.apps
                  else "not listed: the listing shows other pids")
        log(f"  (d) --with-monitor: exit 0, {result['task1']['by_status']}; the CLI's children "
            f"{sorted(self.kids)} in none of {self.polls} polls of the compute apps (the CLI's "
            f"pid {listed}), CUDA mapped in the CLI only")
        return subprocess.Popen([sys.executable, "-m", "iv_interpolation_tpu_torch.cli",
                                 "--monitor"], cwd=self.dir, env=self.env, text=True,
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE)

    @staticmethod
    def check_monitor(proc) -> None:
        out, err = proc.communicate(timeout=120)
        check(proc.returncode == 0 and "batch complete" in out,
              f"(d) --monitor on the finished batch: {out[-1000:]} {err[-1000:]}")
        log("  (d) --monitor on the finished batch: batch complete")


def visualize_start(root, work, surface_store_, srv) -> dict:
    """Phase 11 (e): ``--visualize --plot-dir`` over phase 7's store, its
    surfaces refitted with local vol (no candles there), and over (c)'s
    PostgreSQL-backed run (no surfaces there), both processes started at
    once: between them the four figures. Returns the processes and what
    each must write, for :func:`visualize_check`."""
    from iv_interpolation_tpu_torch.config import get_config
    from iv_interpolation_tpu_torch.pipeline import storage as st
    from iv_interpolation_tpu_torch.pipeline import surface_task

    store = surface_store_
    if store is None:
        store = surface_store(np.random.default_rng(SURFACE_TASK["seed"]))[0]
    if not isinstance(store, st.ParquetStore):
        log("  (e) pyarrow does not import: --visualize over phase 7's store was not run")
        return {}
    if module_version("matplotlib") != "missing":
        store.drop(surface_task.SURFACES)
        surface_task.run_surface_fit(surface_config(get_config, work / "lv",
                                                    {"compute_local_vol": True}), store,
                                     device=DEV)
        check("local_vol" in store.read(surface_task.SURFACES).columns, "(e) local vol persisted")
    flow, interp = "pipeline_data_flow.png", "interpolation_analysis.png"
    runs = {"phase 7": (["--storage", "parquet", "--data-root", store.root], cli_env(root),
                        {flow, interp, "surface_analysis.png"}),
            "postgres": (["--storage", "postgres"], pg_env(root, srv),
                         {flow, interp, "candle_analysis.png"})}
    started = {}
    for name, (args, env, figs) in runs.items():
        out_dir = work / f"plots_{name.replace(' ', '')}"
        proc = subprocess.Popen([sys.executable, "-m", "iv_interpolation_tpu_torch.cli",
                                 "--visualize", "--plot-dir", str(out_dir), "--json", *args],
                                cwd=work, env=env, text=True, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE)
        started[name] = (proc, out_dir, figs)
    return started


def visualize_check(started: dict) -> dict:
    """(e): each figure written and non-empty; without matplotlib each
    process exits 1 naming it."""
    figs = {}
    for name, (proc, out_dir, want) in started.items():
        _, err = proc.communicate(timeout=300)
        if module_version("matplotlib") == "missing":
            check(proc.returncode == 1 and "matplotlib" in err,
                  f"(e) without matplotlib --visualize exits 1 naming it: {err[-500:]}")
            log(f"  (e) {name}: matplotlib is missing; --visualize exits 1: {err.strip()[-200:]}")
            continue
        check(proc.returncode == 0, f"(e) --visualize over {name} exits 0: {err[-2000:]}")
        pngs = sorted(out_dir.glob("*.png"))
        check({p.name for p in pngs} == want and all(p.stat().st_size > 10_000 for p in pngs),
              f"(e) {name}: the figures {sorted(want)}, non-empty: "
              f"{[(p.name, p.stat().st_size) for p in pngs]}")
        figs[name] = {p.name: p.stat().st_size for p in pngs}
        log(f"  (e) --visualize over {name}: {figs[name]}")
    return figs


def checkpoint_phase(work) -> None:
    """Phase 11 (f): a cubic-spline ``SurfaceFit`` fitted on the card,
    saved, restored to the card and to the CPU; ``eval_surface`` of the
    card's restore bitwise equal to the original's, the CPU restore's
    arrays equal to the original's."""
    from iv_interpolation_tpu_torch.pipeline import checkpoint
    from iv_interpolation_tpu_torch.surface import surface
    P = CKPT
    gen = torch.Generator().manual_seed(P["seed"])
    k = torch.linspace(-1.0, 1.0, P["n"]).expand(P["B"], P["E"], P["n"]).contiguous()
    T = torch.linspace(0.05, 2.0, P["E"]).expand(P["B"], P["E"]).contiguous()
    iv = 0.2 + 0.1 * k**2 + 0.05 * torch.rand((P["B"], 1, 1), generator=gen)
    fit = surface.fit_surface(k.to(DEV), iv.to(DEV), T.to(DEV), spline_bc="not-a-knot")
    path = checkpoint.save_surface_fit(str(work / "ckpt"), fit)
    back = checkpoint.restore_surface_fit(path, device=DEV)
    host = checkpoint.restore_surface_fit(path, device="cpu")
    kq = (torch.rand((P["B"], 64), generator=gen) * 2.4 - 1.2).to(DEV)
    Tq = (torch.rand((P["B"], 64), generator=gen) * 2.2).to(DEV)
    check(back.k.device.type == torch.device(DEV).type and host.k.device.type == "cpu"
          and back.method == host.method == fit.method, "(f) restored to the card and the CPU")
    check(torch.equal(surface.eval_surface(back, kq, Tq), surface.eval_surface(fit, kq, Tq)),
          "(f) eval_surface of the card's restore bitwise equal")
    check(all(torch.equal(getattr(host, f), getattr(fit, f).cpu())
              for f in ("k", "expiries", "w", "coefs")), "(f) the CPU restore's arrays equal")
    size = sum(p.stat().st_size for p in Path(path).iterdir())
    log(f"  (f) SurfaceFit {P['B']} x {P['E']} x {P['n']} saved ({size:,} bytes), restored to "
        f"the card (eval_surface bitwise equal) and to the CPU (arrays equal)")


def operator_phase(root, surface_store_, reset_counts, read_counts) -> dict:
    """Phase 11: the operator's pieces, (a)-(f), under
    ``build/chip_smoke_operator`` (removed at the end); (d) runs in other
    processes while (c) runs here, and (e)'s processes while (f) does.
    Returns B2's launches by path, counted in this process."""
    from iv_interpolation_tpu_torch.pipeline import ringbuffer
    from iv_interpolation_tpu_torch.ops.cuda import stream_agg as agg

    work = root / "build" / "chip_smoke_operator"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t = time.perf_counter()
    at = lambda part: log(f"  ({part}) done at {time.perf_counter() - t:.1f} s of phase 11")
    ring = window_candles_phase(ringbuffer, agg, reset_counts, read_counts)
    at("a")
    reset_counts()
    shards = shard_phase(work)
    shard_launches = read_counts()["b2"]
    at("b")
    watch = MonitorRun(root, work, shards["store"])
    srv = load_mock_server(root)(auth="scram-sha-256", user="ivtpu", password="secret")
    try:
        pg = postgres_phase(root, work, srv, reset_counts, read_counts)
        at("c")
        monitor = watch.finish()
        at("d")
        viz = visualize_start(root, work, surface_store_, srv)
        checkpoint_phase(work)
        MonitorRun.check_monitor(monitor)
        visualize_check(viz)
        at("e, f")
    finally:
        srv.close()
    shutil.rmtree(work, ignore_errors=True)
    log(f"  phase 11 took {time.perf_counter() - t:.1f} s")
    return {"window_candles": ring["launches"], "postgres": pg["launches"],
            "shard_reference": shard_launches, "autolam_ms": ring["autolam"]["ms"],
            "window_candles_ms": ring["ms"]}

# -- phase 12: the device mesh ------------------------------------------------

# phase 12: (a) sequence-parallel interpolation at 128 series x 4 columns x
# 2^19 minutes (a year of 1-minute rows a series, 1.07 GB of float32
# values, about 80 % missing; every 4th series has a gap across the
# timeline's midpoint, the seam of two ranks, every 8th is empty past it)
# on a world of one rank over NCCL in this process; (b) one launched world
# of two ranks sharing the card over gloo: the same timeline, 2^18 minutes
# a rank; the runner at 1,024 symbols x 168 hourly rows, 256 a batch (4
# batches); phase 7's store through the surface task (cubic, ah); a
# STREAM session for 7 refits; the dry run's proofs 2-3; (c) the CLI under
# ``torch.distributed.run --nproc-per-node 2``: --task pipeline on the first
# 256 of those symbols (one batch; cut from 1,024, a minute on the H100) and
# --task serve, both at once, beside this process's one-rank runner
# reference (the three are read for correctness only)
MESH = dict(series=128, cols=4, minutes=1 << 19, missing=0.8, seed=28, ranks=2,
            symbols=1024, hours=168, drop_frac=0.1, batch=256, refits=7, cli_symbols=256,
            timeout=300)
MESH_METHODS = ("cubic_spline", "ah")


def mesh_work() -> Path:
    return Path(__file__).resolve().parent / "build" / "chip_smoke_mesh"


def mesh_timeline(device):
    """MESH's timeline on ``device`` from a seeded generator: (values
    (S, C, L) float32, timeline mask (S, 1, L) with 1,000 padded minutes
    at the end of every 16th series)."""
    P = MESH
    S, C, L = P["series"], P["cols"], P["minutes"]
    g = torch.Generator(device=device).manual_seed(P["seed"])
    vals = 5.0 + torch.randn((S, C, L), generator=g, device=device)
    vals.masked_fill_(torch.rand((S, C, L), generator=g, device=device) < P["missing"],
                      float("nan"))
    vals[::4, :, L // 2 - 20_000:L // 2 + 20_000] = float("nan")
    vals[::8, :, L // 2:] = float("nan")
    mask = torch.ones((S, 1, L), dtype=torch.bool, device=device)
    mask[1::16, :, L - 1000:] = False
    return vals, mask


def digest(t: torch.Tensor) -> int:
    """A position-weighted sum of a float32 tensor's bits (NaN as one
    value): equal digests for bitwise-equal tensors."""
    bits = torch.nan_to_num(t.float(), nan=-7.0).view(torch.int32).reshape(-1).to(torch.int64)
    weights = torch.arange(bits.numel(), device=bits.device) % 65521 + 1
    return int((bits * weights).sum())


def mesh_config(get_config, work, batch: int, shape):
    cfg = runner_config(get_config, work, batch)
    cfg.processing.mesh_shape = shape
    cfg.monitoring.enable_snapshots = False
    cfg.monitoring.log_dir = str(work / "logs")
    return cfg


def mesh_world_one() -> dict:
    """Phase 12 (a): a world of one rank over NCCL in this process (file
    rendezvous), ``sharded_masked_interp``'s local form and its all-gather
    on a (1, 1) mesh against ``masked_interp`` bit for bit; CUDA-event
    times of the fill, the all-gather and the plain call."""
    from iv_interpolation_tpu_torch.ops.interp import masked_interp
    from iv_interpolation_tpu_torch.parallel import mesh as pmesh
    from iv_interpolation_tpu_torch.parallel.sequence import local_masked_interp

    rdzv = mesh_work() / "rendezvous1"
    rdzv.mkdir(parents=True, exist_ok=True)
    backend = pmesh.init_world(DEV, init_method=f"file://{rdzv}/store", world_size=1, rank=0,
                               timeout_s=120)
    try:
        check(backend == "nccl", f"(a) a world of one rank on a card of its own is nccl: {backend}")
        mesh = pmesh.make_mesh((1, 1), device=DEV)
        vals, mask = mesh_timeline(mesh.device)
        L = vals.shape[-1]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ref = masked_interp(vals, mask)
        plain_ms = cuda_ms(lambda: masked_interp(vals, mask), 1)
        fill = local_masked_interp(vals, mask, mesh, L)
        fill_ms = cuda_ms(lambda: local_masked_interp(vals, mask, mesh, L), 1)
        whole = pmesh.all_gather(mesh, fill, "data", dim=-1)
        gather_ms = cuda_ms(lambda: pmesh.all_gather(mesh, fill, "data", dim=-1), 1)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        check(same_with_nan(whole, ref), "(a) the mesh's fill equals masked_interp bit for bit")
        missing = float(torch.isnan(vals).double().mean())
        out = {"digest": digest(ref), "fill_ms": fill_ms, "gather_ms": gather_ms,
               "plain_ms": plain_ms, "peak_gib": peak, "missing": missing}
        del vals, mask, ref, fill, whole
    finally:
        pmesh.shutdown_world()
    torch.cuda.empty_cache()
    check(peak <= 40, f"(a) one rank's peak within 40 GB ({peak:.1f} GiB)")
    log(f"  (a) world of 1 (nccl): {MESH['series']} x {MESH['cols']} x {MESH['minutes']:,} "
        f"float32, {missing:.1%} missing: fill {fill_ms:.2f} ms, all-gather {gather_ms:.2f} ms, "
        f"masked_interp {plain_ms:.2f} ms (CUDA events); equal bit for bit; peak {peak:.2f} GiB")
    return out


def mesh_rank(args: dict) -> int:
    """Phase 12 (b), one rank of the launched world: joins it (gloo, the
    card shared), runs the sequence, runner, surface task, session and dry
    run in turn, each with the launch counts set to 0 before it and read
    after, and prints its result line. Rank 0 writes what it gathered
    under ``args["work"]``."""
    from iv_interpolation_tpu_torch.config import get_config
    from iv_interpolation_tpu_torch.ops.cuda import stream_agg as agg
    from iv_interpolation_tpu_torch.ops.cuda import tridiag
    from iv_interpolation_tpu_torch.ops.interp import masked_interp
    from iv_interpolation_tpu_torch.parallel import dryrun
    from iv_interpolation_tpu_torch.parallel import mesh as pmesh
    from iv_interpolation_tpu_torch.parallel.sequence import local_masked_interp
    from iv_interpolation_tpu_torch.pipeline import runner as runner_mod
    from iv_interpolation_tpu_torch.pipeline import storage as st
    from iv_interpolation_tpu_torch.pipeline import surface_task as task
    from iv_interpolation_tpu_torch.pipeline.stream_service import StreamingSession

    from iv_interpolation_tpu_torch import _build

    device = dryrun.join_world(DEV)
    _build.pin_precision()
    work = Path(args["work"])
    mesh = pmesh.make_mesh((MESH["ranks"],), ("data",), device=DEV)
    me = mesh.rank
    out = {"rank": me, "backend": mesh.backend, "device": str(device)}

    def reset():
        tridiag.tridiag_solve_cuda.launches = 0
        tridiag.tridiag_solve_cuda.launches_by_dtype.update(float32=0, float64=0)
        tridiag.tridiag_solve_cuda.launches_by_route.update(dict.fromkeys(tridiag.ROUTES, 0))
        tridiag.tridiag_solve_cuda.launches_by_layout.update(dict.fromkeys(tridiag.LAYOUTS, 0))
        agg.aggregate_ohlcv_cuda.launches = 0

    def read():
        by = tridiag.tridiag_solve_cuda.launches_by_dtype
        return {"b1_f32": by["float32"], "b1_f64": by["float64"],
                "b2": agg.aggregate_ohlcv_cuda.launches}

    def timed(fn):
        torch.cuda.synchronize(device)
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize(device)
        return res, time.perf_counter() - t

    # sequence: this rank's 2^18 minutes, against masked_interp of the whole
    vals, mask = mesh_timeline(device)
    L, half = vals.shape[-1], vals.shape[-1] // MESH["ranks"]
    lo = me * half
    ref = masked_interp(vals, mask)[..., lo:lo + half].clone()
    torch.cuda.empty_cache()
    chunk_v, chunk_m = vals[..., lo:lo + half].clone(), mask[..., lo:lo + half].clone()
    del vals, mask
    fill, fill_s = timed(lambda: local_masked_interp(chunk_v, chunk_m, mesh, L))
    check(same_with_nan(fill, ref), f"(b) rank {me}: its chunk equals masked_interp's")
    whole, gather_s = timed(lambda: pmesh.all_gather(mesh, fill, "data", dim=-1))
    out["sequence"] = {"fill_s": fill_s, "gather_s": gather_s,
                       "digest": digest(whole) if mesh.is_leader else None}
    del chunk_v, chunk_m, fill, whole, ref
    torch.cuda.empty_cache()

    # the runner over a parquet store (rank 0's)
    cfg = mesh_config(get_config, work / "runner_mesh", MESH["batch"], (MESH["ranks"],))
    store = st.ParquetStore(str(work / "runner_mesh" / "data")) if mesh.is_leader else None
    torch.cuda.reset_peak_memory_stats(device)
    reset()
    runner = runner_mod.PipelineRunner(cfg, store=store, device=DEV)
    res, wall = timed(runner.run_pipeline_fused)
    rows = sum(res[k]["output_rows"] for k in ("task1", "bridge", "task2"))
    out["runner"] = {"launches": read(), "wall_s": wall, "rows": rows,
                     "host_s": dict(runner.host_s), "world": res["world"],
                     "by_status": {k: res[k]["by_status"] for k in ("task1", "bridge", "task2")}}

    # the surface task over phase 7's store (a copy, rank 0's)
    surf = st.ParquetStore(str(work / "surface" / "data")) if mesh.is_leader else None
    out["surface"] = {}
    for method in MESH_METHODS:
        scfg = surface_config(get_config, work / "surface", {"smile_method": method})
        scfg.processing.mesh_shape = (MESH["ranks"],)
        if mesh.is_leader:
            surf.drop(task.SURFACES)
        reset()
        rep, wall = timed(lambda: task.run_surface_fit(scfg, surf, device=DEV))
        out["surface"][method] = {"launches": read(), "wall_s": wall, "surfaces": rep["surfaces"]}
        if mesh.is_leader:
            sorted_surfaces(surf, task).to_pickle(work / f"surface_{method}.pkl")

    # the session: STREAM's universe, MESH["refits"] refits
    unds, k, iv, T, chunks, span = stream_data()
    sess = StreamingSession(list(unds), k, iv, T, window_minutes=STREAM["W"],
                            tick_capacity=STREAM["CAP"], n_grid=50, device=DEV, mesh=mesh)
    reset()
    refits, refit_s = {}, []
    for c, ticks in enumerate(chunks[:MESH["refits"]]):
        sess.ingest_ticks(ticks)
        o, dt = timed(lambda: sess.refit(now_minute=(c + 1) * span - 1))
        refit_s.append(dt)
        if o is None:  # the whole result is rank 0's
            continue
        for f in ("w_grid", "iv_grid", "realized_vol", "butterfly_ok", "calendar_ok"):
            refits[f"{c}_{f}"] = getattr(o, f).cpu().numpy()
        refits[f"{c}_count"] = o.candles_1m.count.cpu().numpy()
    out["session"] = {"launches": read(), "refit_s": refit_s, "rows": list(sess.rows)}
    if mesh.is_leader:
        np.savez(work / "session.npz", **refits)
    del sess

    # the dry run's proofs 2-3
    reset()
    (methods, dims), dry_s = timed(lambda: (dryrun.run_method_parity(mesh, device),
                                            dryrun.run_collectives(device)))
    out["dryrun"] = {"methods": methods, "mesh": dims[0], "bad_surfaces": dims[2],
                     "wall_s": dry_s, "launches": read()}
    out["peak_bytes"] = torch.cuda.max_memory_allocated(device)
    dryrun.report(out)
    pmesh.shutdown_world()
    return 0


def mesh_stores(work) -> dict:
    """Phase 12's stores: MESH's tickers for the reference and the mesh
    runs, its first ``cli_symbols`` symbols for the CLI, a copy of phase
    7's."""
    from iv_interpolation_tpu_torch.pipeline import storage as st
    from iv_interpolation_tpu_torch.pipeline.sample_data import generate_sample_tickers

    P = MESH
    tickers = generate_sample_tickers(num_symbols=P["symbols"], hours=P["hours"],
                                      seed=P["seed"], drop_frac=P["drop_frac"])
    cli_symbols = sorted(tickers["symbol"].unique())[:P["cli_symbols"]]
    stores = {}
    for name, rows in (("runner_ref", tickers), ("runner_mesh", tickers),
                       ("cli", tickers[tickers["symbol"].isin(cli_symbols)])):
        stores[name] = st.ParquetStore(str(work / name / "data"))
        stores[name].write(st.TICKERS, rows, upsert_keys=["symbol", "date"])
    shutil.copytree(surface_work() / "data", work / "surface" / "data")
    return {"stores": stores, "cli_symbols": cli_symbols}


def mesh_references(store7) -> dict:
    """The one-rank references in this process, on the card: the surface
    task with each method on phase 7's store, and the session's refits.
    The runner's runs later (:func:`mesh_runner_reference`)."""
    from iv_interpolation_tpu_torch.config import get_config
    from iv_interpolation_tpu_torch.pipeline import surface_task as task
    from iv_interpolation_tpu_torch.pipeline.stream_service import StreamingSession

    work = mesh_work()
    surfaces = {}
    for method in MESH_METHODS:
        store7.drop(task.SURFACES)
        task.run_surface_fit(surface_config(get_config, work / "surface_ref",
                                            {"smile_method": method}), store7, device=DEV)
        surfaces[method] = sorted_surfaces(store7, task)
    store7.drop(task.SURFACES)
    unds, k, iv, T, chunks, span = stream_data()
    sess = StreamingSession(list(unds), k, iv, T, window_minutes=STREAM["W"],
                            tick_capacity=STREAM["CAP"], n_grid=50, device=DEV)
    refits = []
    for c, ticks in enumerate(chunks[:MESH["refits"]]):
        sess.ingest_ticks(ticks)
        refits.append(sess.refit(now_minute=(c + 1) * span - 1))
    torch.cuda.synchronize()
    return {"surfaces": surfaces, "refits": refits}


def mesh_runner_reference(work, refs) -> float:
    """The one-rank fused run of MESH's store in this process (host s)."""
    from iv_interpolation_tpu_torch.config import get_config
    from iv_interpolation_tpu_torch.pipeline import runner as runner_mod

    t = time.perf_counter()
    runner_mod.PipelineRunner(mesh_config(get_config, work / "runner_ref", MESH["batch"], None),
                              refs["stores"]["runner_ref"]).run_pipeline_fused()
    torch.cuda.synchronize()
    return time.perf_counter() - t


def mesh_compare(work, refs, results, world_one) -> None:
    """Phase 12 (b)'s results against the one-rank references."""
    from iv_interpolation_tpu_torch.ops import andreasen_huge as ah
    from iv_interpolation_tpu_torch.pipeline import storage as st

    P, n = MESH, MESH["ranks"]
    check([r["backend"] for r in results] == ["gloo"] * n,
          f"(b) ranks sharing one card use gloo: {[r['backend'] for r in results]}")
    check(results[0]["sequence"]["digest"] == world_one["digest"],
          "(b) the two ranks' timeline equals (a)'s bit for bit")
    batches = P["symbols"] // P["batch"]
    for r in results:
        check(r["runner"]["launches"] == {"b1_f32": 0, "b1_f64": 0, "b2": batches},
              f"(b) rank {r['rank']}: B2 once a batch ({batches}): {r['runner']['launches']}")
        for method in MESH_METHODS:
            got = r["surface"][method]["launches"]
            check(got["b1_f32"] > 0 and got["b1_f64"] == 0 and got["b2"] == 0,
                  f"(b) rank {r['rank']}: {method} launches B1 float32: {got}")
        check(r["session"]["launches"]["b2"] == 2 * P["refits"],
              f"(b) rank {r['rank']}: B2 twice a refit: {r['session']['launches']}")
        check(r["session"]["rows"] == [r["rank"] * STREAM["B"] // n,
                                       (r["rank"] + 1) * STREAM["B"] // n],
              f"(b) rank {r['rank']} holds its block of the session")
    lead = results[0]["runner"]
    check(all(set(by) <= {"completed", "skipped"} for by in lead["by_status"].values()),
          f"(b) runner: no symbol in error: {lead['by_status']}")
    differ = tables_equal(st.ParquetStore(str(work / "runner_mesh" / "data")),
                          refs["stores"]["runner_ref"], "(b) runner over the mesh")
    import pandas as pd
    for method in MESH_METHODS:
        got = pd.read_pickle(work / f"surface_{method}.pkl")
        want = refs["surfaces"][method]
        check(len(got) == len(want), f"(b) {method}: {len(got)} rows, one rank {len(want)}")
        for c in ("underlying", "expiry_t", "log_moneyness", "butterfly_ok", "calendar_ok"):
            check(bool((got[c].to_numpy() == want[c].to_numpy()).all()), f"(b) {method}: {c} equal")
        if method == "cubic_spline":
            pd.testing.assert_frame_equal(got, want, check_exact=True)
        else:
            kq = torch.from_numpy(want["log_moneyness"].to_numpy(np.float64))
            x, y = (torch.from_numpy(d["total_variance"].to_numpy(np.float64)) for d in (got, want))
            gap = price_gap(ah, kq, x, y)
            near = float(((ah.normalized_call(kq, x) - ah.normalized_call(kq, y)).abs()
                          <= 1024 * EPS32).double().mean())
            check(near >= 0.99 and gap <= 1e-3,
                  f"(b) ah over the mesh as on one rank: price gap {gap:.3e}, {near:.2%} within "
                  f"1024 ulps")
    saved = np.load(work / "session.npz")
    w_err = 0.0
    for c, ref in enumerate(refs["refits"]):
        for f in ("butterfly_ok", "calendar_ok"):
            check(np.array_equal(saved[f"{c}_{f}"], getattr(ref, f).cpu().numpy()),
                  f"(b) refit {c}: {f} equal")
        check(np.array_equal(saved[f"{c}_count"], ref.candles_1m.count.cpu().numpy()),
              f"(b) refit {c}: 1-min counts equal")
        w, wr = saved[f"{c}_w_grid"], ref.w_grid.cpu().numpy()
        err = np.abs(w - wr)
        check(bool((err <= 1e-4 * np.abs(wr) + 2e-5).all()),
              f"(b) refit {c}: w_grid within phase 4's tolerance")
        w_err = max(w_err, float(err.max()))
    dry = results[0]["dryrun"]
    check(dry["methods"] == ["cubic_spline", "svi", "essvi", "sabr", "smoothing_spline", "rbf",
                             "ah"] and dry["bad_surfaces"] == 0, f"(b) dry run: {dry}")
    log(f"  (b) runner: tables equal the one-rank run's ({differ} 5-min volumes differ within "
        f"8 eps32); surface task cubic exact, ah within phase 10's tolerance; session refits "
        f"equal in flags, w_grid max err {w_err:.3e}")


def mesh_env(work: Path, **overrides) -> dict:
    from iv_interpolation_tpu_torch.parallel.dryrun import outside_world_env
    env = outside_world_env()
    env.update(IVTPU_CHECKPOINT__MANIFEST_DIR=str(work / "runs"),
               IVTPU_MONITORING__LOG_DIR=str(work / "logs"),
               IVTPU_MONITORING__ENABLE_SNAPSHOTS="false",
               IVTPU_PROCESSING__MESH_SHAPE=str(MESH["ranks"]),
               IVTPU_DIST_TIMEOUT_S=str(MESH["timeout"]), **overrides)
    return env


TORCHRUN = ("-m", "torch.distributed.run", "--standalone", "--nproc-per-node")


def mesh_cli_start(work: Path) -> dict:
    """Phase 12 (c), started: the CLI under ``torch.distributed.run`` with
    two ranks on the card, ``--task pipeline`` over the CLI's store and
    ``--task serve`` over phase 7's, at once; output to files."""
    launcher = [sys.executable, *TORCHRUN, str(MESH["ranks"]), "-m",
                "iv_interpolation_tpu_torch.cli", "--storage", "parquet", "--json", "--yes",
                "--env", "production"]
    runs = {"pipeline": (["--task", "pipeline", "--data-root", str(work / "cli" / "data")],
                         mesh_env(work / "cli", IVTPU_PROCESSING__BATCH_SIZE=str(MESH["batch"]))),
            "serve": (["--task", "serve", "--serve-port", "0", "--data-root",
                       str(surface_work() / "data")], mesh_env(work / "serve"))}
    started = {"t": time.perf_counter()}
    for name, (argv, env) in runs.items():
        with open(work / f"{name}.out", "w") as out, open(work / f"{name}.err", "w") as err:
            started[name] = subprocess.Popen(launcher + argv, cwd=work, env=env, stdout=out,
                                             stderr=err)
    return started


def mesh_cli_finish(work: Path, refs, started) -> dict:
    """Phase 12 (c), checked: a client's ticks, flush, refit, stats and
    stop to the server (stop ends both ranks); the pipeline exits 0 with
    one JSON summary, rank 0's, and the one-rank reference's tables for
    its symbols."""
    import re

    from iv_interpolation_tpu_torch.pipeline import serve
    from iv_interpolation_tpu_torch.pipeline import storage as st

    server, pipeline = started["serve"], started["pipeline"]
    try:
        port, deadline = None, time.monotonic() + 240
        while port is None and time.monotonic() < deadline:
            check(server.poll() is None,
                  f"(c) the server is up: {(work / 'serve.err').read_text()[-3000:]}")
            found = re.search(r"on 127\.0\.0\.1:(\d+)", (work / "serve.out").read_text())
            port = int(found.group(1)) if found else None
            time.sleep(0.2)
        check(port is not None, "(c) rank 0 listens")
        up_s = time.perf_counter() - started["t"]
        unds = surface_underlyings()
        _, lines = serve_ticks(np.random.default_rng(MESH["seed"]), unds)
        flush, refit, stats = serve.send_lines(
            "127.0.0.1", port, lines + [{"cmd": "flush"}, {"cmd": "refit"}, {"cmd": "stats"}],
            timeout=120)
        (stop,) = serve.send_lines("127.0.0.1", port, [{"cmd": "stop"}], timeout=120)
        server.wait(timeout=120)
        pipeline.wait(timeout=600)
    finally:
        for proc in (server, pipeline):
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    check(server.returncode == 0 and stop == {"ok": True} and flush["total"] == len(lines)
          and refit["ok"] and sorted(refit["realized_vol"]) == unds
          and stats["ticks_seen"] == len(lines),
          f"(c) serve under torchrun: ingest, refit, stats, stop; exit {server.returncode}")
    stdout = (work / "pipeline.out").read_text()
    check(pipeline.returncode == 0,
          f"(c) --task pipeline under torchrun exits 0: {(work / 'pipeline.err').read_text()[-3000:]}")
    summaries = [json.loads(ln) for ln in stdout.splitlines() if ln.startswith("{")]
    check(len(summaries) == 1 and summaries[0]["world"]["size"] == MESH["ranks"]
          and summaries[0]["world"]["backend"] == "gloo"
          and summaries[0]["task2"]["by_status"] == {"completed": MESH["cli_symbols"]},
          f"(c) one JSON summary, rank 0's: {stdout[-2000:]}")
    differ = tables_equal(st.ParquetStore(str(work / "cli" / "data")),
                          refs["stores"]["runner_ref"], "(c) the CLI over the mesh",
                          symbols=refs["cli_symbols"])
    world = summaries[0]["world"]
    log(f"  (c) --task pipeline under torch.distributed.run (2 ranks), {MESH['cli_symbols']} "
        f"symbols: exit 0, one summary (world {world['size']}, {world['backend']}, peaks by "
        f"rank {[round(b / 2**30, 2) for b in world['peak_bytes_by_rank']]} GiB), wall "
        f"{summaries[0]['wall_s']} s; tables equal the one-rank run's ({differ} 5-min volumes "
        f"differ)")
    log(f"  (c) --task serve under torch.distributed.run: up in {up_s:.1f} s (beside the "
        f"pipeline and the reference), {len(unds)} underlyings, {len(lines):,} ticks, refit "
        f"ok, stats {stats['ticks_seen']} ticks, stop ended both ranks")
    return {"serve_up_s": up_s, "pipeline_wall_s": summaries[0]["wall_s"]}


def surface_underlyings() -> list:
    """The underlyings of phase 7's store, as ``build_session`` names them."""
    from iv_interpolation_tpu_torch.pipeline import storage as st
    from iv_interpolation_tpu_torch.pipeline.surface_task import parse_symbol
    syms = st.ParquetStore(str(surface_work() / "data")).list_symbols(st.INTERPOLATED)
    return sorted({p[0] for p in map(parse_symbol, syms) if p is not None})


def mesh_phase(root: Path, store7) -> dict:
    """Phase 12: (a) in this process, then the one-rank references, (b) the
    launched world of two ranks sharing the card, (c) the CLI under
    torch.distributed.run. Returns the mesh paths' launches."""
    from iv_interpolation_tpu_torch.parallel import dryrun

    work = mesh_work()
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t0 = time.perf_counter()
    world_one = mesh_world_one()
    refs = mesh_stores(work)
    t = time.perf_counter()
    world = dryrun.start_world(MESH["ranks"], [str(root / "chip_smoke.py"), "--mesh-rank",
                                               json.dumps({"work": str(work)})],
                               timeout_s=MESH["timeout"])
    # the light references while the ranks start (10-20 s before they
    # reach the card)
    refs.update(mesh_references(store7))
    log(f"  the one-rank surface and session references: done "
        f"{time.perf_counter() - t:.1f} s after the launch")
    results = [dryrun.result_of(out) for out in world.wait(900)]
    world_s = time.perf_counter() - t
    for r in results:
        run = r["runner"]
        log(f"  (b) rank {r['rank']} ({r['backend']}, {r['device']}): sequence fill "
            f"{r['sequence']['fill_s'] * 1e3:.1f} ms, all-gather {r['sequence']['gather_s'] * 1e3:.1f} ms "
            f"(host clock); runner {run['wall_s']:.2f} s, {run['rows'] / run['wall_s']:,.0f} output "
            f"rows/s, host s " + ", ".join(f"{k} {v:.3f}" for k, v in sorted(run["host_s"].items()))
            + f", launches {run['launches']}; surface "
            + ", ".join(f"{m} {v['wall_s']:.2f} s {v['launches']}" for m, v in r["surface"].items())
            + f"; session refits ms {[round(x * 1e3, 1) for x in r['session']['refit_s']]}, "
            f"launches {r['session']['launches']}; dry run {r['dryrun']['wall_s']:.1f} s; peak "
            f"{r['peak_bytes'] / 2**30:.2f} GiB")
    log(f"  (b) runner peaks by rank (GiB): "
        f"{[round(b / 2**30, 2) for b in results[0]['runner']['world']['peak_bytes_by_rank']]}; "
        f"the world took {world_s:.1f} s from launch to exit")
    # (c) and the one-rank runner reference at once: all three are read for
    # correctness only
    started = mesh_cli_start(work)
    ref_s = mesh_runner_reference(work, refs)
    log(f"  the one-rank runner reference: {ref_s:.2f} s (beside (c))")
    cli = mesh_cli_finish(work, refs, started)
    mesh_compare(work, refs, results, world_one)
    shutil.rmtree(work, ignore_errors=True)
    log(f"  phase 12 took {time.perf_counter() - t0:.1f} s")
    launches = {"surface_b1": 0, "runner_b2": 0, "session_b2": 0, "dryrun_b1": 0}
    for r in results:
        launches["surface_b1"] += sum(v["launches"]["b1_f32"] for v in r["surface"].values())
        launches["runner_b2"] += r["runner"]["launches"]["b2"]
        launches["session_b2"] += r["session"]["launches"]["b2"]
        launches["dryrun_b1"] += r["dryrun"]["launches"]["b1_f32"]
    return {**launches, "world_s": world_s, "sequence": world_one, "cli": cli}


# -- phase 13: the library entry point ------------------------------------------

# (b) PCR against B1 at phase 2's main-path shapes; the n=48 run is skipped
# when its temporaries (about 10 full-size arrays a level) would pass this
PCR_CAP_BYTES = 40e9
# (c) the native host packer at phase 6's runner batch: 256 symbols x 8
# columns x the 16,384-minute bucket, 168 hourly observations a symbol
# (about 10 % dropped) spread over 10,021 valid minutes; 8 batches make
# phase 6's 2,048 symbols
PACKER = dict(B=256, C=8, L=16384, valid=10021, hours=168, drop=0.1, batches=8,
              reps=3, seed=29)


def quickstart_phase(reset_counts, read_by_dtype, surface_ref) -> dict:
    """Phase 13 (a): the library tour ``quickstart.main()`` on the card in
    float32 (launches counted: B1 float32 and B2 must both run) and again
    warm, then in float64; each dtype held section by section to the same
    call on CPU tensors at ``quickstart.TOLERANCES`` (flags exact). The
    top-level ``fit_eval_surface`` is the surface module's function and
    gives phase 3's output bit for bit at 32768 x 30 x 50 (``surface_ref``:
    phase 3's digests, or None to compute them here)."""
    import iv_interpolation_tpu_torch as top
    from iv_interpolation_tpu_torch import quickstart
    from iv_interpolation_tpu_torch.surface import surface as surf

    check(top.fit_eval_surface is surf.fit_eval_surface,
          "(a) the top-level fit_eval_surface is surface.surface.fit_eval_surface")
    out = {"seconds": {}, "launches": {}}
    for dtype in ("float32", "float64"):
        reset_counts()
        t = time.perf_counter()
        card = quickstart.main(device=DEV, dtype=dtype, verbose=False)
        wall = time.perf_counter() - t
        out["launches"][dtype] = read_by_dtype()
        out["seconds"][dtype] = card["seconds"]
        log(f"  (a) quickstart {dtype} on the card: {wall:.2f} s, sections s "
            + ", ".join(f"{k} {v:.3f}" for k, v in card["seconds"].items())
            + f"; launches {out['launches'][dtype]}")
        if dtype == "float32":
            check(out["launches"][dtype]["b1_f32"] > 0 and out["launches"][dtype]["b2"] > 0,
                  f"(a) the quickstart launched B1 float32 and B2: {out['launches'][dtype]}")
            warm = quickstart.main(device=DEV, dtype=dtype, verbose=False)
            out["seconds"]["float32 warm"] = warm["seconds"]
            log("  (a) quickstart float32 again (warm): sections s "
                + ", ".join(f"{k} {v:.3f}" for k, v in warm["seconds"].items()))
        t = time.perf_counter()
        cpu = quickstart.main(device="cpu", dtype=dtype, verbose=False)
        log(f"  (a) the same on CPU tensors: {time.perf_counter() - t:.2f} s")
        got, want = quickstart.arrays(card), quickstart.arrays(cpu)
        check(set(got) == set(want), f"(a) the same sections ran: {sorted(got)} / {sorted(want)}")
        gaps = {sec: quickstart.hold(got[sec], want[sec], dtype, sec)
                for sec in got if sec != "flight"}
        if "flight" in got:
            fl_rows, refit = got["flight"], got["streaming"]
            check(np.array_equal(fl_rows["realized_vol"], refit["realized_vol"].astype(np.float64))
                  and all(np.array_equal(fl_rows[f], refit[f])
                          for f in ("butterfly_ok", "calendar_ok")),
                  f"(a) {dtype}: the Flight table is the session's refit")
        worst = {sec: max((v for v in g.values()), default=0.0) for sec, g in gaps.items()}
        log(f"  (a) {dtype} card vs CPU tensors, largest gap a section (flags: count apart): "
            + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))
        del card, cpu, got, want
    # the top-level entry point at phase 3's shape, bit for bit
    k, T, iv_clean, _, _ = surface_inputs()
    M = SURFACE["M"]
    if surface_ref is None:
        surface_ref = surface_digests(surf.fit_eval_surface(
            k, iv_clean, T, method="cubic_spline", n_grid=M, spline_bc="not-a-knot"))
    reset_counts()
    res = top.fit_eval_surface(k, iv_clean, T, method="cubic_spline", n_grid=M,
                               spline_bc="not-a-knot")
    torch.cuda.synchronize()
    out["launches"]["top-level"] = read_by_dtype()
    mine = surface_digests(res)
    check(mine == surface_ref, f"(a) top-level fit_eval_surface = phase 3's output bit for "
          f"bit at 32768 x 30 x 50: {mine} / {surface_ref}")
    log(f"  (a) top-level fit_eval_surface at {SURFACE['B']} x {SURFACE['E']} x {SURFACE['N']}: "
        f"phase 3's output bit for bit; launches {out['launches']['top-level']}")
    del k, T, iv_clean, res
    torch.cuda.empty_cache()
    return out


def pcr_phase(tridiag, ops_tridiag) -> list:
    """Phase 13 (b): the reference's parallel cyclic reduction
    (``ops.tridiag.tridiag_solve_pcr``, plain tensor code) against B1 at
    every main-path shape of phase 2 on phase 2's systems: ms of each from
    CUDA graphs of 10 calls, in turns (B1, PCR, PCR, B1), and
    max |PCR - B1| / max |x|. B1's launches here count on no path."""
    import math

    gen = torch.Generator(device=DEV).manual_seed(30)
    rows = []
    for (n, batch, dtype), what in B1_MAIN.items():
        levels = math.ceil(math.log2(n))
        elsize = torch.empty((), dtype=dtype).element_size()
        temp = levels * 10 * n * batch * elsize
        if temp > PCR_CAP_BYTES:
            log(f"  (b) PCR n={n} batch={batch} {str(dtype)[6:]}: not run, {levels} levels x "
                f"10 arrays of {n * batch * elsize / 1e9:.2f} GB = {temp / 1e9:.1f} GB of "
                f"temporaries > {PCR_CAP_BYTES / 1e9:.0f} GB")
            continue
        if (n, batch) in B1_AH:
            dl, d, du, b = ah_systems(n, batch, dtype, gen)
        else:
            u = lambda lo, hi: torch.empty((n, batch), dtype=dtype, device=DEV).uniform_(
                lo, hi, generator=gen)
            d, dl, du = u(4.0, 6.0), u(-1.0, 1.0), u(-1.0, 1.0)
            b = torch.randn((n, batch), dtype=dtype, device=DEV, generator=gen)
        x = tridiag.tridiag_solve_cuda(dl, d, du, b)
        x_pcr = ops_tridiag.tridiag_solve_pcr(dl, d, du, b)
        torch.cuda.synchronize()
        scale = float(x.abs().max())
        err = float((x_pcr - x).abs().max()) / scale
        check(bool(torch.isfinite(x_pcr).all()), f"(b) PCR finite at n={n} batch={batch}")
        b1 = lambda: tridiag.tridiag_solve_cuda(dl, d, du, b)
        pcr = lambda: ops_tridiag.tridiag_solve_pcr(dl, d, du, b)
        torch.cuda.reset_peak_memory_stats()
        turns = [device_ms(f, 10, CALLS) for f in (b1, pcr, pcr, b1)]
        peak = torch.cuda.max_memory_allocated() / 2**30
        row = {"shape": f"B1 {what} n={n} batch={batch} {str(dtype)[6:]}",
               "b1_ms": (turns[0] + turns[3]) / 2, "pcr_ms": (turns[1] + turns[2]) / 2,
               "turns": [round(t, 5) for t in turns], "levels": levels,
               "max_rel_gap": err, "peak_gib": peak}
        row["pcr_over_b1"] = row["pcr_ms"] / row["b1_ms"]
        log(f"  (b) {row['shape']}: B1 {row['b1_ms']:.4f} ms, PCR {row['pcr_ms']:.4f} ms "
            f"({levels} levels, {row['pcr_over_b1']:.1f}x B1), max|PCR-B1|/max|x| "
            f"{err:.3e}, peak {peak:.2f} GiB")
        rows.append(row)
        del dl, d, du, b, x, x_pcr
        torch.cuda.empty_cache()
    return rows


def packer_phase() -> dict:
    """Phase 13 (c): the native host packer on this machine, at phase 6's
    runner batch (256 x 8 x 16,384 float32 grids): ``gather_unpack`` of
    every valid row (the runner's unpack gather) and ``scatter_pack`` of
    the hourly observations (a dense batch's host scatter), each bit-exact
    against NumPy's fancy indexing, with both times (median of ``reps``)
    for one batch and for phase 6's 8."""
    from iv_interpolation_tpu_torch import native
    from iv_interpolation_tpu_torch.pipeline import ingest

    P = PACKER
    check(native.native_available(),
          f"(c) the native packer builds on the card's host: {native.build_error}")
    rng = np.random.default_rng(P["seed"])
    B, C, L = P["B"], P["C"], P["L"]
    grids = rng.normal(size=(B, C, L)).astype(np.float32)
    grids[:, 2, ::17] = np.nan
    valid = np.zeros((B, L), bool)
    valid[:, :P["valid"]] = True
    sel_b, sel_pos = np.nonzero(valid)
    hours = np.arange(P["hours"]) * 60
    keep = rng.uniform(size=(B, P["hours"])) >= P["drop"]
    row_sym, hour = np.nonzero(keep)
    row_pos = hours[hour].astype(np.int64)
    colmat = rng.normal(size=(len(row_sym), C)).astype(np.float32)

    def timed(fn):
        times, out = [], None
        for _ in range(P["reps"]):
            t = time.perf_counter()
            out = fn()
            times.append(time.perf_counter() - t)
        return float(np.median(times)), out

    native_s, rows = timed(lambda: native.gather_unpack(grids, sel_b, sel_pos))
    numpy_s, rows_np = timed(lambda: grids[sel_b, :, sel_pos])
    check(rows is not None and np.array_equal(rows.view(np.uint32), rows_np.view(np.uint32)),
          "(c) gather_unpack bit-exact against NumPy")

    def scatter(use_native):
        values, mask = ingest.full_nan((B, C, L), np.float32), np.zeros((B, L), bool)
        if use_native:
            check(native.scatter_pack(colmat, row_sym.astype(np.int32), row_pos,
                                      np.ones(len(row_pos), np.uint8), values, mask),
                  "(c) scatter_pack ran natively")
        else:
            values[row_sym, :, row_pos] = colmat
            mask[row_sym, row_pos] = True
        return values, mask

    scat_native_s, (v_n, m_n) = timed(lambda: scatter(True))
    scat_numpy_s, (v_p, m_p) = timed(lambda: scatter(False))
    check(np.array_equal(v_n.view(np.uint32), v_p.view(np.uint32)) and np.array_equal(m_n, m_p),
          "(c) scatter_pack bit-exact against NumPy")
    out = {"rows": len(sel_b), "obs": len(row_sym), "gather_native_s": native_s,
           "gather_numpy_s": numpy_s, "scatter_native_s": scat_native_s,
           "scatter_numpy_s": scat_numpy_s, "batches": P["batches"]}
    log(f"  (c) native packer ({native.library_path().name}) at {B} x {C} x {L} float32, one "
        f"batch: gather of {len(sel_b):,} rows native {native_s * 1e3:.1f} ms, NumPy "
        f"{numpy_s * 1e3:.1f} ms ({numpy_s / native_s:.2f}x); scatter of {len(row_sym):,} "
        f"observations (with the NaN fill) native {scat_native_s * 1e3:.1f} ms, NumPy "
        f"{scat_numpy_s * 1e3:.1f} ms; phase 6's {P['batches']} batches: gathers "
        f"{native_s * P['batches']:.3f} s native against {numpy_s * P['batches']:.3f} s NumPy; "
        f"bit-exact")
    return out


def library_phase(reset_counts, read_by_dtype, tridiag, ops_tridiag, surface_ref) -> dict:
    """Phase 13: (a) the quickstart and the top-level entry point, (b) PCR
    against B1, (c) the native host packer."""
    t0 = time.perf_counter()
    quick = quickstart_phase(reset_counts, read_by_dtype, surface_ref)
    pcr = pcr_phase(tridiag, ops_tridiag)
    packer = packer_phase()
    log(f"  phase 13 took {time.perf_counter() - t0:.1f} s")
    return {"quick": quick, "pcr": pcr, "packer": packer}


# -- phase 14: the bench harness -------------------------------------------------

# the keys of bench.py's line (``_assemble``), which the port's line keeps
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "batch", "device",
              "parity_max_err_vs_x64_oracle", "parity_fast_f32_max_err",
              "butterfly_clean_frac", "butterfly_adversarial_frac", "extra_metrics")
BENCH = dict(seed=14, timeout=900, attempt=600)


def bench_work() -> Path:
    return Path(__file__).resolve().parent / "build" / "chip_smoke_bench"


def run_bench(root: Path) -> tuple[dict, dict, float]:
    """The harness at full size in its own process group: (the line, the
    state file, wall seconds). Its stage lines go to this log; its whole
    stderr to ``build/chip_smoke_bench/bench.err``."""
    work = bench_work()
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    state = work / "state.json"
    env = dict(os.environ, IVTPU_BENCH_STATE=str(state), IVTPU_BENCH_ATTEMPT_S=str(BENCH["attempt"]),
               PYTHONPATH=os.pathsep.join(p for p in (str(root), os.environ.get("PYTHONPATH")) if p))
    for k in ("IVTPU_BENCH_SMOKE", "IVTPU_BENCH_ROLE"):
        env.pop(k, None)
    t = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "iv_interpolation_tpu_torch.bench",
                             "--seed", str(BENCH["seed"])], cwd=root, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=BENCH["timeout"])
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)      # the harness and its child
        out, err = proc.communicate()
        (work / "bench.err").write_text(err)
        raise RuntimeError(f"check failed: the bench ended within {BENCH['timeout']} s: "
                           f"{err[-3000:]}")
    wall = time.perf_counter() - t
    (work / "bench.err").write_text(err)
    for line in err.splitlines():
        if line.startswith("# "):
            log("  " + line)
    check(proc.returncode == 0, f"the bench exited 0 (got {proc.returncode}): {err[-3000:]}")
    lines = out.splitlines()
    check(len(lines) == 1, f"the bench printed exactly one line on stdout: {out[-2000:]}")
    return json.loads(lines[0]), json.loads(state.read_text()), wall


def bench_phase(root: Path, reset_counts, read_by_dtype, earlier: dict) -> dict:
    """Phase 14: (a) the bench harness at full size, its line and state
    file checked, each stage beside the earlier phases' figures at its
    shape (``earlier``: stage -> (what, surfaces or slices a second)); (b)
    ``graft_entry.entry()`` once on the card. Returns the launches of the
    bench's stages and of the entry point."""
    from iv_interpolation_tpu_torch import graft_entry

    t0 = time.perf_counter()
    line, state, wall = run_bench(root)
    log(f"  (a) the bench took {wall:.1f} s; its line: {json.dumps(line)}")
    missing = [k for k in BENCH_KEYS if k not in line]
    check(not missing and "incomplete_metrics" not in line and not state["failed"],
          f"(a) the line has bench.py's keys and every stage: missing {missing}, incomplete "
          f"{line.get('incomplete_metrics')}, failed {sorted(state['failed'])}")
    check(line["device"].startswith(torch.cuda.get_device_name(0)) and line["device"].endswith("W)"),
          f"(a) the line names the card and its power limit: {line['device']}")
    check(line["butterfly_clean_frac"] == 1.0 and line["butterfly_adversarial_frac"] <= 0.05,
          f"(a) butterfly fractions clean {line['butterfly_clean_frac']}, adversarial "
          f"{line['butterfly_adversarial_frac']}")
    check(line["parity_fast_f32_max_err"] < 5e-6 and line["parity_max_err_vs_x64_oracle"] < 1e-9,
          f"(a) the fast path within 5e-6 of SciPy ({line['parity_fast_f32_max_err']}) and "
          f"parity mode within 1e-9 ({line['parity_max_err_vs_x64_oracle']})")
    extras = {e["metric"]: e for e in line["extra_metrics"]}
    ah_line = extras["ah_surfaces_per_sec_512x8x16_grid257_iters16"]
    check(ah_line["arbfree_frac"] == 1.0, f"(a) AH all arbitrage-free: {ah_line}")
    stages = state["stages"]
    launches = {name: stages[name]["launches"] for name in ("parity", "ah", "streaming")}
    check(launches["parity"]["b1_f64"] > 0 and launches["ah"]["b1_f32"] > 0
          and launches["streaming"]["b2"] > 0,
          f"(a) B1 float64 ran in the parity stage, B1 float32 in AH, B2 in streaming: {launches}")
    for name, res in stages.items():
        ev = res["event_median_ms"]
        # the spline stage times two batches; its value is the better one's
        batches = res["calls"] if len(res["calls"]) > 1 else []
        log(f"  (a) {name}: value {res['value']:,} (host median {res['host_median_s'] * 1e3:.3f} "
            f"ms a call; event median {ev:.3f} ms, host/event {res['host_median_s'] * 1e3 / ev:.2f}"
            f"), peak {res['peak_bytes'] / 2**30:.2f} GiB, launches {res['launches']}, "
            f"{res['seconds']:.1f} s"
            + "".join(f"; B={c['batch']}: host median {c['host_median_s'] * 1e3:.3f} ms, event "
                      f"median {c['event_median_ms']:.3f} ms" for c in batches)
            + (f"; {earlier[name][0]}: {earlier[name][1]:,.1f}" if name in earlier else ""))

    # (b) the entry point's forward step
    fn, args = graft_entry.entry()
    reset_counts()
    got = fn(*args)
    torch.cuda.synchronize()
    entry_counts = read_by_dtype()
    want = fn(*(a.cpu() for a in args))
    gap = float((got[0].cpu() - want[0]).abs().max())
    scale = float(want[0].abs().max())
    check(entry_counts["b1_f32"] >= 1 and gap <= 256 * EPS32 * scale
          and all(torch.equal(g.cpu(), h) for g, h in zip(got[1:], want[1:])),
          f"(b) entry() on the card launched B1 float32 ({entry_counts}) and matches CPU "
          f"tensors: max |w gap| {gap:.3e}, flags equal")
    log(f"  (b) graft_entry.entry() on the card: w_grid {tuple(got[0].shape)}, {entry_counts}, "
        f"max |card - CPU| {gap:.3e}, all butterfly-free {bool(got[1].all())}")
    shutil.rmtree(bench_work(), ignore_errors=True)
    log(f"  phase 14 took {time.perf_counter() - t0:.1f} s")
    return {"line": line, "launches": launches, "entry": entry_counts,
            "stages": {n: {k: r[k] for k in ("value", "host_median_s", "event_median_ms",
                                             "peak_bytes")} for n, r in stages.items()}}


def parse_phases(argv) -> set | None:
    """``--phases 2,9``: the phases a development run keeps (phase 1, the
    build, always runs). None, the default, runs them all."""
    if not argv:
        return None
    if len(argv) != 2 or argv[0] != "--phases":
        raise SystemExit("usage: chip_smoke.py [--phases 2,9]")
    return {int(x) for x in argv[1].split(",")}


def main(argv=()) -> int:
    if list(argv[:1]) == ["--mesh-rank"]:
        # one rank of phase 12's launched world
        return mesh_rank(json.loads(argv[1]))
    only = parse_phases(list(argv))
    want = lambda n: only is None or n in only
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; nothing was run",
              file=sys.stderr)
        return 1
    # the package lives beside this script; outside a checkout this fails
    from iv_interpolation_tpu_torch import _build
    from iv_interpolation_tpu_torch.ops.cuda import spline_eval as se
    from iv_interpolation_tpu_torch.ops.cuda import stream_agg as agg
    from iv_interpolation_tpu_torch.ops.cuda import svi_lm
    from iv_interpolation_tpu_torch.ops.cuda import tridiag
    from iv_interpolation_tpu_torch.ops import essvi, lm, segment_ohlcv
    from iv_interpolation_tpu_torch.ops import tridiag as ops_tridiag
    from iv_interpolation_tpu_torch.pipeline import runner, tasks
    from iv_interpolation_tpu_torch.pipeline import storage as st
    from iv_interpolation_tpu_torch.pipeline import stream_service as svc
    from iv_interpolation_tpu_torch.surface import surface

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(smi.splitlines()[0])
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, device {torch.cuda.get_device_name(0)}")
    log(f"pandas {module_version('pandas')}, pyarrow {module_version('pyarrow')}, "
        f"matplotlib {module_version('matplotlib')}, psutil {module_version('psutil')}")

    log("phase 1: build")
    t_start = t0 = time.perf_counter()
    lib_path, nvcc_s = _build.build()
    lib = _build.load_library()
    log(f"  kernels built in {nvcc_s:.2f} s (nvcc), ready in "
        f"{time.perf_counter() - t0:.2f} s: {lib_path.name}")
    # ptxas's report for each kernel: registers, spills (shared memory is
    # dynamic and sized by the launch plans, printed with phase 2's cases)
    ptxas = [ln for ln in lib_path.with_suffix(".log").read_text().splitlines()
             if any(k in ln for k in ("Compiling entry", "registers", "spill"))] if nvcc_s else []
    for line in ptxas:
        log("  " + line.strip())
    # full float32 in every product: E2 operator entries (~+-600) under
    # TF32 flip butterfly-g signs
    _build.pin_precision()
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "float32 matmul precision pinned to full float32")

    # each main path runs with the launch counts set to 0 just before it
    # and read just after it; each read also keeps B1's launches by route
    # and the spline evaluation's and the raw-SVI kernel's launches by dtype
    # since the last reset, under the phase it ran in
    route_reads, phase_now = [], ["phases 3-4"]

    def reset_counts():
        route_reads.append([phase_now[0], None, None, None, None])
        tridiag.tridiag_solve_cuda.launches = 0
        tridiag.tridiag_solve_cuda.launches_by_dtype.update(float32=0, float64=0)
        tridiag.tridiag_solve_cuda.launches_by_route.update(dict.fromkeys(tridiag.ROUTES, 0))
        tridiag.tridiag_solve_cuda.launches_by_layout.update(dict.fromkeys(tridiag.LAYOUTS, 0))
        agg.aggregate_ohlcv_cuda.launches = 0
        agg.aggregate_ohlcv_cuda.launches_by_dtype.update(float32=0, float64=0)
        se.spline_eval_cuda.launches = 0
        se.spline_eval_cuda.launches_by_dtype.update(float32=0, float64=0)
        se.spline_eval_cuda.launches_by_route.update(dict.fromkeys(se.ROUTES, 0))
        svi_lm.svi_lm_cuda.launches = 0
        svi_lm.svi_lm_cuda.launches_by_dtype.update(float32=0, float64=0)
        lm.levenberg_marquardt_batched.calls = 0
        fit_essvi = essvi.fit_essvi_batched
        fit_essvi.calls = fit_essvi.iterations = fit_essvi.surfaces = 0
        fit_essvi.by_solver.update(block=0, dense=0)

    def read_routes():
        if route_reads:
            route_reads[-1][1] = dict(tridiag.tridiag_solve_cuda.launches_by_route)
            route_reads[-1][2] = dict(se.spline_eval_cuda.launches_by_dtype)
            route_reads[-1][3] = dict(svi_lm.svi_lm_cuda.launches_by_dtype)
            route_reads[-1][4] = dict(tridiag.tridiag_solve_cuda.launches_by_layout)

    def read_counts():
        read_routes()
        return {"b1": tridiag.tridiag_solve_cuda.launches,
                "b2": agg.aggregate_ohlcv_cuda.launches}

    def read_by_dtype():
        read_routes()
        by = tridiag.tridiag_solve_cuda.launches_by_dtype
        return {"b1_f32": by["float32"], "b1_f64": by["float64"],
                "b2": agg.aggregate_ohlcv_cuda.launches}

    def read_lm():
        read_routes()
        return {"svi_lm": svi_lm.svi_lm_cuda.launches,
                "generic_lm": lm.levenberg_marquardt_batched.calls}

    def done(n):
        log(f"  phase {n} done at {time.perf_counter() - t_start:.1f} s")
        phase_now[0] = "phases 3-4" if n == 2 else f"phase {n + 1}"

    if want(2):
        log("phase 2: kernels against their plain versions")
        b1 = tridiag_cases(tridiag, lib)
        b2 = stream_agg_cases(agg)
        b2_f64 = stream_agg_cases(agg, torch.float64)
        spl = spline_eval_cases(se)
        done(2)
    reset_counts()
    if want(3):
        log("phase 3: surface step")
        surf = surface_step(surface, tridiag, se)
    if want(4):
        log("phase 4: streaming refit")
        stream = streaming_session(svc, agg)
        config = types.SimpleNamespace(surface=types.SimpleNamespace(grid_strikes=50))
        replay = svc.run_stream_replay(config, device=DEV, **REPLAY)
        torch.cuda.synchronize()
        check(replay["device"].startswith(DEV)
              and replay["butterfly_ok"] == REPLAY["n_underlyings"],
              f"run_stream_replay on the card, all surfaces clean: {replay}")
        log(f"  run_stream_replay: {replay}")
    surface_stream = read_counts()
    if want(3) and want(4):
        check(surface_stream["b1"] > 0 and surface_stream["b2"] > 0,
              f"both kernels ran on the surface and streaming paths: {surface_stream}")
        log(f"  launches: {surface_stream}")
        done(4)
    if want(5):
        log("phase 5: fused task pipeline")
        reset_counts()
        pipe = pipeline_main_path(runner, tasks, segment_ohlcv, agg, tridiag)
        fused = read_counts()
        check(fused == {"b1": 1, "b2": len(pipe["batches"]) + 1},
              f"the pipeline launched B2 once a batch and B1 in the cubic batch: {fused}")
        log(f"  launches: {fused}")
        checks = pipeline_checks(pipe, runner, tasks, agg)
        cubic30 = cubic_30_day(runner, tasks, segment_ohlcv, tridiag, reset_counts,
                               read_by_dtype)
        done(5)
    if want(6):
        log("phase 6: the host runner")
        log(f"  card: {smi.splitlines()[0]}")
        host = host_runner(reset_counts, read_counts)
        log(f"  launches: {host['launches']}, B2 float64 {host['b2_f64_launches']}")
        check(tridiag.tridiag_solve_cuda.launches_by_dtype["float64"] == 0,
              "phase 6's runs before (b) solve in float32 only")
        runner30 = runner_30_day(Path(__file__).resolve().parent / "build" / "chip_smoke_runner",
                                 reset_counts, read_by_dtype, tridiag, ops_tridiag)
        shutil.rmtree(Path(__file__).resolve().parent / "build" / "chip_smoke_runner",
                      ignore_errors=True)
        done(6)
    store = None
    if want(7):
        log("phase 7: the surface task")
        surf_task = surface_task_phase(reset_counts, read_by_dtype, tridiag, agg)
        store = surf_task["store"]
        log(f"  launches: {surf_task['launches']}")
        done(7)
    if want(8):
        log("phase 8: serving")
        if store is None:
            store = surface_store(np.random.default_rng(SURFACE_TASK["seed"]))[0]
        served = serving_phase(store, reset_counts, read_by_dtype)
        log(f"  launches: {served['launches']}")
        done(8)
    if want(9):
        log("phase 9: the calibrated families")
        log(f"  card: {smi.splitlines()[0]}")
        data = calib_data(CALIB)
        svi_rows = svi_lm_cases(CALIB, data)
        torch.cuda.empty_cache()
        fits = calibrated_fits(CALIB, data, reset_counts, read_lm)
        calib = calibrated_surfaces(CALIB, data, reset_counts, read_lm)
        del data
        torch.cuda.empty_cache()
        if store is None:
            store = surface_store(np.random.default_rng(SURFACE_TASK["seed"]))[0]
        reset_counts()
        calib_task = calibrated_task(store, tridiag, agg)
        check(read_counts() == {"b1": 0, "b2": 0},
              f"the calibrated families launch neither kernel: {read_counts()}")
        done(9)
    if want(10):
        log("phase 10: Andreasen-Huge and RBF")
        log(f"  card: {smi.splitlines()[0]}")
        ah_res = ah_phase(reset_counts, read_by_dtype, ops_tridiag)
        rbf_res = rbf_phase()
        torch.cuda.empty_cache()
        if store is None:
            store = surface_store(np.random.default_rng(SURFACE_TASK["seed"]))[0]
        fam = family_task(store, ops_tridiag, tridiag, agg, reset_counts, read_by_dtype)
        if isinstance(store, st.ParquetStore):
            family_cli(Path(__file__).resolve().parent, surface_work())
        else:
            log("  (f) pyarrow does not import: the CLI on a parquet store was not run")
        done(10)
    if want(11):
        log("phase 11: the operator's pieces")
        log(f"  card: {smi.splitlines()[0]}")
        operator = operator_phase(Path(__file__).resolve().parent, store, reset_counts,
                                  read_counts)
        log(f"  launches (B2, counted in this process): {operator}")
        done(11)
    if want(12):
        log("phase 12: the device mesh")
        log(f"  card: {smi.splitlines()[0]}")
        if store is None:
            store = surface_store(np.random.default_rng(SURFACE_TASK["seed"]))[0]
        check(isinstance(store, st.ParquetStore), "phase 12 needs phase 7's parquet store")
        meshed = mesh_phase(Path(__file__).resolve().parent, store)
        log(f"  launches on the mesh paths (both ranks): "
            f"{ {k: v for k, v in meshed.items() if k.endswith(('_b1', '_b2'))} }")
        done(12)
    if want(13):
        log("phase 13: the library entry point")
        log(f"  card: {smi.splitlines()[0]}")
        library = library_phase(reset_counts, read_by_dtype, tridiag, ops_tridiag,
                                surf["digests"] if want(3) else None)
        done(13)
    if want(14):
        log("phase 14: the bench harness")
        log(f"  card: {smi.splitlines()[0]}")
        earlier = {}
        if want(3):
            earlier["spline"] = ("phase 3, fit_eval_surface at 32768 (another function), "
                                 "surfaces/s by events", surf["surfaces_per_s"])
        if want(4):
            earlier["streaming"] = ("phase 4, a session's warm refit at 1024 x 30 x 50 chains, "
                                    "underlyings/s by host", stream["underlyings_per_s"])
        if want(9):
            earlier["svi"] = ("phase 9 (a), slices/s by events", fits["svi quasi"]["rate"])
            earlier["essvi"] = ("phase 9 (b), surfaces/s by events", fits["essvi block"]["rate"])
        if want(10):
            earlier["ah"] = ("phase 10 (a), surfaces/s by events (by host "
                             f"{ah_res['surfaces_per_s_host']:,.1f})", ah_res["surfaces_per_s"])
            earlier["rbf"] = ("phase 10 (d), surfaces/s by events",
                              rbf_res["full"]["surfaces_per_s"])
            earlier["rbf_reduced"] = ("phase 10 (d), surfaces/s by events",
                                      rbf_res["reduced"]["surfaces_per_s"])
        torch.cuda.empty_cache()
        benched = bench_phase(Path(__file__).resolve().parent, reset_counts, read_by_dtype,
                              earlier)
        done(14)
    shutil.rmtree(surface_work(), ignore_errors=True)
    if only is not None:
        log(f"partial run of phases {sorted(only)}: no result line")
        return 0
    log(f"  summary: {surf['surfaces_per_s']:,.0f} surfaces/s, warm refit "
        f"{stream['warm_refit_ms']:.3f} ms ({stream['underlyings_per_s']:,.0f} "
        f"underlyings/s), fused_batch {pipe['rows_per_s']:,.0f} output rows/s, "
        f"runner {host['rows_per_s']:,.0f} output rows/s ({host['store']}), surface task "
        + ", ".join(f"{k} {v:,.0f}" for k, v in surf_task["rates"].items())
        + f" surfaces/s, served refit {served['refit_ms']:.2f} ms; calibrated: svi "
        f"{fits['svi quasi']['rate']:,.0f} slices/s, essvi block "
        f"{fits['essvi block']['rate']:,.0f} surfaces/s, sabr {fits['sabr']['rate']:,.0f} "
        f"slices/s, fit_eval_surface "
        + ", ".join(f"{m} {calib[m]['surfaces_per_s']:,.0f}" for m, _ in CALIB_RUNS)
        + " surfaces/s, surface task "
        + ", ".join(f"{m} {v['surfaces_per_s']:,.0f}" for m, v in calib_task.items())
        + f" surfaces/s; AH {ah_res['surfaces_per_s']:,.0f} surfaces/s ({ah_res['arbfree']:.4f} "
        f"arbitrage-free), RBF penalized {rbf_res['full']['surfaces_per_s']:,.1f} (full) / "
        f"{rbf_res['reduced']['surfaces_per_s']:,.1f} (c=512) surfaces/s, surface task "
        + ", ".join(f"{m} {fam[m]['surfaces_per_s']:,.1f}" for m in FAMILY_RUNS)
        + f" surfaces/s; autolam {operator['autolam_ms']:.1f} ms at 1,024 x 30 x 8 penalties"
        f"; quickstart float32 sections s "
        + ", ".join(f"{k} {v:.3f}" for k, v in library["quick"]["seconds"]["float32 warm"].items())
        + f"; bench: " + ", ".join(f"{n} {r['value']:,}" for n, r in benched["stages"].items())
        + f"; all phases done at {time.perf_counter() - t_start:.1f} s")
    b2["max_abs_err"] = max(b2["max_abs_err"], checks["b2_err"])

    # the spline evaluation's launches by phase, both dtypes, over every
    # path of this process (phases 12 and 14 run theirs in processes of
    # their own but for phase 14's entry point)
    spline_by_phase, svi_by_phase = {}, {}
    for phase, _, spline_by, svi_by, _ in route_reads:
        for by_phase, by_dtype in ((spline_by_phase, spline_by), (svi_by_phase, svi_by)):
            for dtype, k in (by_dtype or {}).items():
                by = by_phase.setdefault(phase, {"float32": 0, "float64": 0})
                by[dtype] += k
    # launches on each main path, by kernel (phases 3-6 solve in float32;
    # B2 runs in float64 on phase 6's float64 pipeline only)
    paths = {
        "tridiag_thomas_f32": {
            "surface step + streaming (phases 3-4)": surface_stream["b1"],
            "fused_batch (phase 5)": fused["b1"], "runner (phase 6)": host["launches"]["b1"],
            "30-day cubic batch (phase 5 (a))": cubic30["float32"]["counts"]["b1_f32"],
            "30-day cubic runner (phase 6 (b))": runner30["float32"]["counts"]["b1_f32"],
            "surface task (phase 7)": surf_task["launches"]["b1_f32"],
            "AH fit_eval + eval_ah (phase 10)": ah_res["b1_f32"],
            "AH surface task (phase 10)": fam["launches"]["b1_f32"],
            "mesh surface task (phase 12)": meshed["surface_b1"],
            "mesh dry run (phase 12)": meshed["dryrun_b1"],
            "quickstart (phase 13)": library["quick"]["launches"]["float32"]["b1_f32"],
            "top-level fit_eval_surface (phase 13)":
                library["quick"]["launches"]["top-level"]["b1_f32"],
            "bench AH (phase 14)": benched["launches"]["ah"]["b1_f32"],
            "graft_entry.entry (phase 14)": benched["entry"]["b1_f32"]},
        "tridiag_thomas_f64": {"30-day cubic batch (phase 5 (a))":
                                   cubic30["float64"]["counts"]["b1_f64"],
                               "30-day cubic runner (phase 6 (b))":
                                   runner30["float64"]["counts"]["b1_f64"],
                               "surface task parity (phase 7)": surf_task["launches"]["b1_f64"],
                               "AH float64 fit (phase 10)": ah_res["b1_f64"],
                               "quickstart float64 (phase 13)":
                                   library["quick"]["launches"]["float64"]["b1_f64"],
                               "bench parity (phase 14)": benched["launches"]["parity"]["b1_f64"]},
        "stream_agg": {
            "streaming (phase 4)": surface_stream["b2"], "fused_batch (phase 5)": fused["b2"],
            "runner (phase 6)": host["launches"]["b2"],
            "serving refits (phase 8)": served["launches"]["b2"],
            "window_candles (phase 11)": operator["window_candles"],
            "postgres-backed run (phase 11)": operator["postgres"],
            "shard proofs' reference runs (phase 11)": operator["shard_reference"],
            "mesh runner (phase 12)": meshed["runner_b2"],
            "mesh session (phase 12)": meshed["session_b2"],
            "quickstart (phase 13)": library["quick"]["launches"]["float32"]["b2"],
            "quickstart float64 (phase 13)": library["quick"]["launches"]["float64"]["b2"],
            "bench streaming (phase 14)": benched["launches"]["streaming"]["b2"]},
        "stream_agg_f64": {"float64 pipeline (phase 6)": host["b2_f64_launches"]},
        "spline_eval": {phase: sum(by.values()) for phase, by in spline_by_phase.items()},
    }
    # every CUDA spline evaluation launches the kernel: the surface step,
    # the 30-day cubic batch and runner (cubic_resample), the surface
    # task's cubic, smoothing and parity (float64) runs, the quickstart and
    # the top-level fit_eval_surface, the bench's entry point
    spline_wanted = ("phases 3-4", "phase 5", "phase 6", "phase 7", "phase 13", "phase 14")
    check(all(spline_by_phase.get(ph, {}).get("float32", 0) > 0 for ph in spline_wanted)
          and all(spline_by_phase.get(ph, {}).get("float64", 0) > 0
                  for ph in ("phase 5", "phase 6", "phase 7", "phase 13")),
          f"the spline evaluation kernel ran in float32 on the paths of {spline_wanted}, and in "
          f"float64 on the 30-day float64 batch and runner, the parity surface task and the "
          f"float64 quickstart: {spline_by_phase}")
    check(all(n > 0 for n in paths["tridiag_thomas_f64"].values())
          and paths["tridiag_thomas_f32"]["surface task (phase 7)"] > 0
          and paths["tridiag_thomas_f32"]["AH fit_eval + eval_ah (phase 10)"] > 0
          and paths["tridiag_thomas_f32"]["AH surface task (phase 10)"] > 0
          and paths["stream_agg"]["serving refits (phase 8)"] > 0
          and paths["stream_agg"]["window_candles (phase 11)"] > 0
          and paths["stream_agg"]["postgres-backed run (phase 11)"] > 0
          and paths["stream_agg_f64"]["float64 pipeline (phase 6)"] > 0
          and paths["tridiag_thomas_f32"]["mesh surface task (phase 12)"] > 0
          and paths["stream_agg"]["mesh runner (phase 12)"] > 0
          and paths["stream_agg"]["mesh session (phase 12)"] > 0
          and paths["tridiag_thomas_f32"]["quickstart (phase 13)"] > 0
          and paths["tridiag_thomas_f32"]["top-level fit_eval_surface (phase 13)"] > 0
          and paths["stream_agg"]["quickstart (phase 13)"] > 0
          and paths["tridiag_thomas_f32"]["bench AH (phase 14)"] > 0
          and paths["tridiag_thomas_f32"]["graft_entry.entry (phase 14)"] > 0
          and paths["stream_agg"]["bench streaming (phase 14)"] > 0,
          f"B1 float32 and float64 ran on the surface task and the AH paths, B2 on the served "
          f"refits, window_candles and the postgres-backed run and, in float64, on the "
          f"float64 pipeline; B1 on the mesh's surface task, B2 on its runner and session; "
          f"B1 and B2 in the quickstart; B1 float64 in the bench's parity stage, B1 float32 "
          f"in its AH stage and the entry point, B2 in its streaming stage: "
          f"{paths}")
    thomas = dict(route="cuda", source="iv_interpolation_tpu_torch/csrc/tridiag_thomas.cu",
                  replaces="iv_interpolation_tpu/ops/pallas/tridiag_pallas.py:57")
    agg_src = dict(route="cuda", source="iv_interpolation_tpu_torch/csrc/stream_agg.cu",
                  replaces="iv_interpolation_tpu/ops/pallas/stream_agg_pallas.py:163")
    # per kernel: the numbers of its first main-path shape (B1 float32 the
    # surface step, B1 float64 the 30-day cubic batch, B2 the candle
    # stage), and every main-path shape under "shapes"
    spline_src = dict(route="cuda", source="iv_interpolation_tpu_torch/csrc/spline_eval.cu",
                      replaces="none (the JAX package leaves the evaluation to XLA)")
    svi_src = dict(route="cuda", source="iv_interpolation_tpu_torch/csrc/svi_lm.cu",
                   replaces="none (the JAX package leaves its batched LM to XLA)")
    # the raw-SVI kernel's launches and the generic loop's calls in one
    # call of each SVI main path (checked in phase 9 (a) and (d))
    svi_calls = {"fit_svi_batched quasi (phase 9 (a))": fits["svi quasi"]["lm_calls"],
                 "fit_svi_batched quasi + hinge (phase 9 (a))":
                     fits["svi quasi + hinge"]["lm_calls"],
                 "fit_svi_batched quasi + huber (phase 9 (a))":
                     fits["svi quasi + huber"]["lm_calls"],
                 "fit_eval_surface svi (phase 9 (d))": calib["svi"]["lm_calls"]}
    paths["svi_lm"] = {path: calls["svi_lm"] for path, calls in svi_calls.items()}
    results = {"tridiag_thomas_f32": (thomas, b1["float32"]),
               "tridiag_thomas_f64": (thomas, b1["float64"]),
               "stream_agg": (agg_src, b2), "stream_agg_f64": (agg_src, b2_f64),
               "spline_eval": (spline_src, spl), "svi_lm": (svi_src, svi_rows)}
    kernels = [{"name": name, "launches": sum(paths[name].values()), "paths": paths[name],
                **rows, **source} for name, (source, rows) in results.items()]
    # B1's launches by route on the paths that read them by dtype, and on
    # every path of this process by phase, float32 and float64 together
    # (phases 12 and 14 run their paths in processes of their own); counts
    # set to 0 just before each path and read just after. Each partitioned-route
    # row's launches on its path. The AH rows take phase 10 (b)'s float64
    # fit, whose 64 surfaces solve the same systems at batches 64 (the
    # steps) and 1,024 (the tangents); a fit's launches do not depend on
    # its batch.
    ah64 = ah_res["b1_f64_by_batch"]
    by_phase, layout_by_phase = {}, {}
    for phase, routes, _, _, layouts in route_reads:
        for route, k in (routes or {}).items():
            if k:
                by = by_phase.setdefault(phase, dict.fromkeys(tridiag.ROUTES, 0))
                by[route] += k
        for lay, k in (layouts or {}).items():
            if k:
                by = layout_by_phase.setdefault(phase, dict.fromkeys(tridiag.LAYOUTS, 0))
                by[lay] += k
    # the surface step's fit reads its systems batch-last (phase 3)
    check(layout_by_phase.get("phases 3-4", {}).get("batch_last", 0) > 0,
          f"B1 read the surface step's systems batch-last: {layout_by_phase}")
    on_path = {(719, 768, "float32"): cubic30["float32"]["counts"]["b1_f32"],
               (719, 768, "float64"): cubic30["float64"]["counts"]["b1_f64"],
               (SUB_N, 48, "float32"): runner30["float32"]["shapes"].get((SUB_N, 48), 0),
               (257, 512, "float64"): ah64.get(("float64", AH["cpu"]), 0),
               (257, 8192, "float64"): ah64.get(("float64", AH["cpu"] * AH["m"]), 0)}
    kernels[-2]["launches_by_dtype"] = spline_by_phase
    kernels[-1]["launches_by_dtype"] = svi_by_phase
    kernels[-1]["generic_lm_calls"] = {path: calls["generic_lm"]
                                       for path, calls in svi_calls.items()}
    for entry, dtype in zip(kernels, ("float32", "float64")):
        for row in entry["shapes"]:
            n, batch = (int(row["shape"].split(f"{k}=")[1].split()[0]) for k in ("n", "batch"))
            if row["thomas_route"] == "partitioned":
                row["launches_on_path"] = on_path[n, batch, dtype]
        entry["launches_by_route"] = {
            "30-day cubic batch (phase 5 (a))": cubic30[dtype]["by_route"],
            "30-day cubic runner (phase 6 (b))": runner30[dtype]["by_route"],
            **({"AH float64 fit (phase 10 (b))": ah_res["b1_f64_by_route"]}
               if dtype == "float64" else {}),
            "by phase, both dtypes": by_phase}
        entry["launches_by_layout"] = {"by phase, both dtypes": layout_by_phase}
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
