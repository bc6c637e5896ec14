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
     plan (B1: n=1 and 2, float64, the global-scratch route; B2: int64
     minutes beyond int32, shuffled rows, NaN/Inf payloads, negative
     minutes, scalar loads, the tile loop; B2 once more with float64
     values, every case and the three timed shapes); at each main-path
     shape the
     device time of the wrapper and of the plain call (each replayed from
     a CUDA graph), the bound (bytes or operations this call's inputs need
     over the card's peak rates), the share of it, and the library call
     where one computes the same function (B1: ``torch.linalg.solve`` on
     the dense systems; B2: none); B1 also times its global-scratch
     kernel (one thread a system) in turns with the planned route;
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
     its int64 minutes, and two batches and the cubic one against the
     same batches on CPU tensors;
  6. the host runner: the same 2,048 symbols x 7 days (from the port's
     sample generator) through ``PipelineRunner.run_pipeline_fused`` from
     a store to the three tables (parquet when pyarrow imports, else
     memory): output rows/s, host seconds by phase, the device's idle
     share, peak memory; every symbol completed or skipped, row counts
     equal to the manifests', the result audits, one B2 launch a batch,
     the first batch's symbols against a CPU run; the dispatch orders
     (2 batches in flight against 1) in turns; at 512 symbols x 2 days a
     stopped-and-resumed run and a staged ``run_all`` against the fused
     tables and a cubic run (B1 once a sub-batch); a float64 run
     (``processing.dtype="float64"``, 256 symbols in 4 batches: B2 float64
     once a batch, no symbol in error, held to the same run on CPU
     tensors); the CLI in a subprocess;
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
     the Huber loss), (b) ``fit_essvi_batched`` with the block solver, and
     the dense solver on 256 surfaces, (c) ``fit_sabr_batched`` on 30,720
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
     CPU tensors; (b) the same 64 in float64 (B1's global-scratch route)
     against CPU float64 within 1e-10 in price; (c) ``eval_ah`` at 64 x 64
     scattered queries; (d) RBF penalized at 8 x 2,048 (every site a
     center) and 64 x 2,048 on 512 centers, 24 iterations, and the
     zero-penalty path at 8 x 2,048 in float64 against CPU float64; (e)
     phase 7's store through ``run_surface_fit`` with ah and rbf, every 8th
     underlying against CPU tensors; (f) ``--task surface --method ah
     --profile`` (a ``torch.profiler`` trace), ``--validate-only`` and
     ``--estimate`` from the CLI.

``--phases 2,9`` (development only) runs the named phases after the
build and prints no result line.

B1 and B2 are each listed twice in the kernel line, float32 and float64,
each with its launches on every path.

Prints a JSON line of per-kernel results, then as the last line
``{"ok": true, "device": {...}}``. Any failed check raises, so the script
exits non-zero and prints no result; so does a machine without a card or
a directory without the package. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import shutil
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
# global-scratch route of n beyond the staged tiles). n=48 at 983,040 is
# the not-a-knot reduced system of the surface step (32768 x 30 smiles);
# n=166 at 768 the pipeline's cubic batch (168 hourly knots, 256 x 3);
# n=30 at 3,072 and n=14 at 512 the surface task's two buckets (192 x 16
# slices of 32 strikes, 64 x 8 of 16), float32 and, in parity mode,
# float64; n=6 and 62 the neighbouring buckets (8 and 64 strikes). n=257
# at 512 and 8,192 are Andreasen-Huge's step and tangent solves at its
# bench shape (512 surfaces x 16 quotes, surface.ah_grid = 257): the
# staged route in float32, the global-scratch route in float64, on the
# rows of its own step systems (B1_AH).
F32, F64 = torch.float32, torch.float64
B1_MAIN = {(48, 983_040, F32): "surface step", (166, 768, F32): "cubic batch",
           (30, 3072, F32): "surface task 192x16", (14, 512, F32): "surface task 64x8",
           (30, 3072, F64): "surface task parity 192x16",
           (14, 512, F64): "surface task parity 64x8",
           (257, 512, F32): "AH step", (257, 8192, F32): "AH tangents",
           (257, 512, F64): "AH step", (257, 8192, F64): "AH tangents"}
B1_AH = {(257, 512), (257, 8192)}
B1_CASES = ((48, 983_040, F32, 1.0), (166, 768, F32, 1.0),
            (30, 3072, F32, 1.0), (14, 512, F32, 1.0),
            (30, 3072, F64, 1.0), (14, 512, F64, 1.0),
            (257, 512, F32, 1.0), (257, 8192, F32, 1.0),
            (257, 512, F64, 1.0), (257, 8192, F64, 1.0),
            (6, 512, F64, 1.0), (6, 3072, F64, 1.0), (14, 3072, F64, 1.0),
            (30, 512, F64, 1.0), (62, 512, F64, 1.0), (62, 3072, F64, 1.0),
            (50, 4096, F64, 1.0), (50, 1000, F32, 1.0),
            (1, 4097, F32, 1.0), (2, 4097, F64, 1.0),
            (257, 4096, F64, 1.0), (500, 2048, F32, 1.0),
            (24, 4096, F32, 1e38))
# the surface task's float64 systems all take the staged route
B1_STAGED_F64 = {(n, batch) for n in (6, 14, 30, 62) for batch in (512, 3072)}
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
# phase 6, the host runner: the same scale as phase 5 through
# ``PipelineRunner.run_pipeline_fused`` from a store of sample tickers
# (the JAX package's generator, about 10 % dropped) to the three tables,
# production config (float32, linear, 256 a batch, the 16,384 bucket);
# then (d) at 512 symbols x 2 days, 64 a batch (8 batches). After the
# main run (2 batches in flight), one run with 1 batch in flight (cut from
# four turns, then from two: the orders have measured within their spread,
# and the script's time went to Andreasen-Huge and RBF).
RUNNER = dict(symbols=2048, hours=168, drop_frac=0.1, seed=16, batch=256,
              small_symbols=512, small_hours=48, small_batch=64)
RUNNER_ORDER_TURNS = (1,)
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
    large n) in turns with it, the plain loop, the dense library solve and the
    bound. Tolerance: 256 ulps of max |x| (diagonally dominant systems:
    Thomas is backward stable with error growth O(n eps), and the kernel's
    fused multiply-adds round each step at most one ulp differently from
    the plain version's separate multiply and subtract). The
    Andreasen-Huge systems of B1_AH are not diagonally dominant at their
    boundary rows, and the same bound holds there (measured: 68 ulps in
    float32 and in float64 on an H100). Returns, per dtype name, the worst
    error, the first main-path shape's row and every main-path row."""
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
        plan = tridiag.thomas_plan(n, dtype)
        x = tridiag.tridiag_solve_cuda(dl, d, du, b)
        torch.cuda.synchronize()
        ref = tridiag.tridiag_solve_plain(dl, d, du, b)
        err = float((x - ref).abs().max())
        eps = EPS32 if dtype == torch.float32 else EPS64
        bound = 256 * eps * max(1.0, float(ref.abs().max()))
        log(f"  B1 n={n} batch={batch} {str(dtype)[6:]}{' x%g' % scale if scale > 1 else ''}"
            f"{' AH systems' if ah_like else ''} "
            f"({plan.route}, {plan.threads} a block, "
            f"{plan.smem} B shared): max|kernel-plain|={err:.3e} (bound {bound:.3e})")
        check(err <= bound and bool(torch.isfinite(x).all()),
              f"B1 kernel agrees with plain at n={n} batch={batch} {dtype}")
        if dtype == F64 and (n, batch) in B1_STAGED_F64:
            check(plan.route == "staged", f"thomas_plan stages n={n} batch={batch} float64")
        key = str(dtype)[6:]
        worst[key] = max(worst[key], err)
        if (n, batch, dtype) not in B1_MAIN:
            continue
        staged = lambda: tridiag.tridiag_solve_cuda(dl, d, du, b)
        scratch = scratch_route(lib, dl, d, du, b)
        turns = [device_ms(f, 20, CALLS) for f in (staged, scratch, scratch, staged)]
        # the plan's choice of systems a block against the other tiles
        tiles = {S: round(device_ms(staged_route(lib, dl, d, du, b, S), 20, CALLS), 5)
                 for S in (32, 64, 128) if 4 * n * S * d.element_size() <= 232448}
        plain_ms = device_ms(lambda: tridiag.tridiag_solve_plain(dl, d, du, b), 5, CALLS)
        rows[key].append(timing_row(
            f"B1 {B1_MAIN[n, batch, dtype]} n={n} batch={batch} {key}",
            (turns[0] + turns[3]) / 2, plain_ms, 5 * n * batch * d.element_size(),
            # float32 LU strays to 1.2e-3 on the AH systems (measured on an
            # H100), where the kernel holds 68 ulps of the plain loop
            9 * n * batch, dense_solve_ms(dl, d, du, b, x, 1e-2 if ah_like else 1e-3),
            ops_s=F32_OPS_S if dtype == F32 else F64_OPS_S,
            scratch_route_ms=(turns[1] + turns[2]) / 2,
            turns=[round(t, 5) for t in turns], ms_one_call_a_graph=device_ms(staged, 20),
            systems_a_block=plan.threads,
            ms_by_systems_a_block=tiles))
        del scratch
    return {key: {"max_abs_err": worst[key], **rows[key][0], "shapes": rows[key]}
            for key in rows}


def _suffix(t) -> str:
    return "f32" if t.dtype == F32 else "f64"


def staged_route(lib, dl, d, du, b, S):
    """A call of the staged Thomas kernel with S systems a block, outside
    the wrapper, so it counts no launch."""
    n, batch = d.shape
    x = torch.empty_like(b)
    staged = getattr(lib, f"ivt_thomas_staged_{_suffix(d)}")

    def run():
        err = staged(*(a.data_ptr() for a in (dl, d, du, b, x)), n,
                     batch, S, torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"staged-route launch (S={S}) returned {err}")
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


# -- phase 3: the surface step ------------------------------------------------

def surface_step(surface, tridiag) -> dict:
    from scipy.interpolate import CubicSpline

    B, E, N, M = (SURFACE[x] for x in "BENM")
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
    iv_timed = iv_clean + noise

    def step(iv):
        return surface.fit_eval_surface(k, iv, T, method="cubic_spline", n_grid=M,
                                        spline_bc="not-a-knot")

    before = tridiag.tridiag_solve_cuda.launches
    out = step(iv_clean)
    torch.cuda.synchronize()
    check(tridiag.tridiag_solve_cuda.launches > before,
          "the surface step launched the Thomas kernel")
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
            "butterfly_clean_frac": clean_frac, "butterfly_adversarial_frac": adv_frac}


# -- phase 4: the streaming refit ---------------------------------------------

def streaming_session(svc, agg) -> dict:
    B, E, N, W, CAP, CHUNKS, PER = (STREAM[x] for x in
                                    ("B", "E", "N", "W", "CAP", "CHUNKS", "PER"))
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


def pack_compact(chain, rows, start_minute: int, bucket: int, columns):
    """One compact batch with the fields of the JAX package's
    ``PackedBatch``: only the observations travel, as (N, C) values with
    row and grid-slot coordinates; N is padded to a power of two >= 1024
    with rows marked out of range."""
    names, strike, callput, cols, keep = chain
    B, H, C = len(rows), cols.shape[1], cols.shape[2]
    r, h = np.nonzero(keep[rows])                 # row-major: (row, slot) sorted
    N = 1024
    while N < len(r):
        N *= 2
    obs_vals = np.full((N, C), np.nan, np.float32)
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
    """(a) B2 at the candle stage on a real batch, (b) two batches on CPU
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
        def probed(batch, config, device, on_stage=None):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            dev = self.orig(batch, config, device, on_stage)
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


def tables_equal(a_store, b_store, what: str) -> int:
    """Every table equal, value for value, except the 5-minute volume: a
    float32 sum of <= 5 one-minute volumes, within 8 eps32 of it (the
    kernel's atomics may add a bucket's parts in another order). Returns
    the number of 5-minute volumes that differ at all."""
    import pandas as pd
    differ = 0
    for table in TABLE_KEYS:
        a, b = read_table(a_store, table), read_table(b_store, table)
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


def compare_tables_cpu(card, cpu, symbols, min_spread) -> dict:
    """(c): the card's tables for ``symbols`` against the same symbols run
    on CPU tensors, at phase 5's tolerances: keys, flags and counts exact;
    interpolated values within 2 ulps of max(1, |x|), greeks within 64
    eps32 of each greek's largest |x|; 1-minute OHLCV within one rounding
    step plus 8 ulps, a row beyond that a minimum-spread flip (at most
    0.1 % of rows), values that differ at all at most 1 %; 5-minute
    candles within one step unless their bucket holds such a row."""
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
        check(bool((d <= 2 * EPS32 * np.maximum(1.0, np.abs(np.nan_to_num(y)))).all()),
              f"(c) {c} within 2 ulps (max {d.max():.3e})")
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
    rows/s, host split, idle share and peak memory, then the dispatch
    orders in turns; (c) the manifests, row counts, audits, one B2 launch
    a batch, and the first batch's symbols on CPU tensors; then (d) and
    (e). Returns the launches of the runs that count, rows/s, the store
    and the dispatch orders' wall seconds."""
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

    def full_run(name, depth, probe_counts=False):
        store = make_store(st, work / name / "data")
        store.write(st.TICKERS, tickers, upsert_keys=["symbol", "date"])
        cfg = runner_config(get_config, work / name, P["batch"])
        runner = runner_mod.PipelineRunner(cfg, store)
        runner.queue_depth = depth
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if probe_counts:
            reset_counts()
        with DispatchProbe(runner_mod) as probe:
            t = time.perf_counter()
            res = runner.run_pipeline_fused()
            wall = time.perf_counter() - t
        counts = read_counts() if probe_counts else None
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
    main = full_run("main", 2, probe_counts=True)
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
    # the dispatch orders in turns after the main run (2 batches in flight)
    order = {}
    for i, depth in enumerate(RUNNER_ORDER_TURNS):
        run = full_run(f"order{i}", depth)
        order.setdefault(depth, []).append(run)
        log(f"  (b) {depth} batch{'es' if depth > 1 else ''} in flight: {run['wall']:.3f} s, "
            f"{run['rate']:,.0f} output rows/s, idle share {run['idle']:.1%}")
        shutil.rmtree(work / f"order{i}", ignore_errors=True)
    shutil.rmtree(work / "main", ignore_errors=True)
    small = runner_small_scale(work, reset_counts, read_counts)
    f64 = runner_float64(work, reset_counts)
    runner_cli(root, work)
    shutil.rmtree(work, ignore_errors=True)
    return {"launches": {k: main["counts"][k] + small[k] for k in main["counts"]},
            "b2_f64_launches": f64, "rows_per_s": main["rate"], "store": kind,
            "order_s": {d: [round(r["wall"], 3) for r in runs] for d, runs in order.items()}}


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
    worst = 0.0
    for table in TABLE_KEYS:
        a, b = read_table(store, table), read_table(runs["cpu"][0], table)
        check(len(a) == len(b) and list(a.columns) == list(b.columns),
              f"(f) float64 {table}: {len(a)} rows on the card, {len(b)} on CPU tensors")
        for c in a.columns:
            x, y = a[c].to_numpy(), b[c].to_numpy()
            if x.dtype.kind != "f":
                check(bool((x == y).all()), f"(f) float64 {table}.{c} equal")
                continue
            check(np.array_equal(np.isnan(x), np.isnan(y)), f"(f) float64 {table}.{c} NaN mask")
            d = np.nan_to_num(np.abs(x - y)) / np.maximum(1.0, np.abs(np.nan_to_num(y)))
            off = float((d > 1e-9).mean())
            check(off <= 1e-3, f"(f) float64 {table}.{c}: {off:.2%} of rows beyond 1e-9")
            worst = max(worst, float(np.median(d)))
        if table == "interpolated_trading_tickers":
            check(a["iv"].dtype == np.float64, "(f) the float64 run persists float64")
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
    a launch count an iteration, extended to ``iters``. None where the
    profiler records no device activity."""
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
    if n2 == 0 or n4 <= n2:
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


def calibrated_fits(P, data) -> dict:
    """Phase 9 (a)-(c): the batched fits on the card, each held to the same
    call on CPU tensors at P["cpu"] surfaces and to the generating smile,
    and timed."""
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
        res = fit(iters)
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
               f"converged {float(res.converged.float().mean()):.1%}")

    # (b) eSSVI: the block solver on every surface, the dense one on a part
    for name, solver, nb, nc in (("essvi block", "block", B, C),
                                 ("essvi dense", "dense", P["dense_B"], P["dense_cpu"])):
        fit = lambda it, solver=solver, nb=nb: essvi.fit_essvi_batched(
            k_dev[:nb], dev["essvi"][:nb], max_iters=it, solver=solver)
        res = fit(iters)
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
               f"; {nb} surfaces; accepted steps mean {float(res.n_accepted.float().mean()):.1f}")

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


def calibrated_surfaces(P, data) -> dict:
    """Phase 9 (d) and (e): ``fit_eval_surface`` for the three methods and
    ``greek_surfaces`` on its grids, held to CPU tensors at P["cpu"]
    surfaces. ``fit_eval_surface`` starts SVI from the heuristic init, from
    which some slices are still moving after 32 iterations, and two
    float32 runs that are still moving end at different points: w_grid
    within 5e-5 of the slice's scale on at least 99 % of the slices and
    within 1e-3 on all, the per-surface fit_rmse within 1e-5, and at most
    2 of the 2 x 64 flags different (a g or a calendar gap that sits on
    its tolerance may fall on either side of it on the two devices)."""
    from iv_interpolation_tpu_torch.surface import greeks, surface

    B, E, M, iters, C = P["B"], P["E"], P["M"], P["iters"], P["cpu"]
    k_dev, T_dev = data["k"].to(DEV), data["T"].to(DEV)
    out, grids = {}, None
    for method, _ in CALIB_RUNS:
        iv_dev = data["iv"][method].to(DEV)
        step = lambda: surface.fit_eval_surface(k_dev, iv_dev, T_dev, method=method, n_grid=M,
                                                svi_iters=iters)
        res = step()
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
        out[method] = {"ms": ms, "surfaces_per_s": B / (ms / 1e3), "both_clean": both}
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
AH = dict(B=512, E=8, m=16, n_grid=257, iters=16, cpu=64, Q=64, seed=22)
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
    price_rmse within 1 %); the same 64 in float64 (B1's global-scratch
    route): replayed within 1e-10 in price, an independent CPU float64 fit
    with flags equal and price_rmse within 1e-4; ``eval_ah`` at 64 x 64
    scattered queries against CPU tensors."""
    from iv_interpolation_tpu_torch.ops import andreasen_huge as ah

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

    # (b) float64 on the card (B1's global-scratch route) against CPU float64
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
    check(counts64["b1_f64"] == sum(want.values()) and counts64["b1_f32"] == 0,
          f"(b) B1 float64 launches a float64 fit: {dict(rec64.by)}")
    replay64 = float((ah_replay(ah, out64["fit"], C) - out64["fit"].c.cpu()).abs().max())
    fits64 = fit_spread(out64, ah.fit_eval_ah_surface(k64, iv64, T64, **kw), C)
    ms64 = cuda_ms(fit64, 1)
    log(f"  (b) AH float64 {C} x {E} x {m}: {ms64:.1f} ms a call (CUDA events), "
        f"{host64 * 1e3:.1f} ms host, B1 float64 {dict(rec64.by)}; the card's theta replayed on "
        f"CPU float64, max |c| gap {replay64:.3e} (bound 1e-10); an independent CPU float64 fit: "
        + ", ".join(f"{key} {v:.3e}" if isinstance(v, float) else f"{key} {v}"
                    for key, v in fits64.items()))
    check(replay64 <= 1e-10, f"(b) AH float64 within 1e-10 in price ({replay64:.3e})")
    check(fits64["flags_differ"] == 0 and fits64["price_rmse_rel"] <= 1e-4,
          "(b) AH float64 fits on the card and on CPU tensors: flags equal, price_rmse within 1e-4")

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


def parse_phases(argv) -> set | None:
    """``--phases 2,9``: the phases a development run keeps (phase 1, the
    build, always runs). None, the default, runs them all."""
    if not argv:
        return None
    if len(argv) != 2 or argv[0] != "--phases":
        raise SystemExit("usage: chip_smoke.py [--phases 2,9]")
    return {int(x) for x in argv[1].split(",")}


def main(argv=()) -> int:
    only = parse_phases(list(argv))
    want = lambda n: only is None or n in only
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; nothing was run",
              file=sys.stderr)
        return 1
    # the package lives beside this script; outside a checkout this fails
    from iv_interpolation_tpu_torch import _build
    from iv_interpolation_tpu_torch.ops.cuda import stream_agg as agg
    from iv_interpolation_tpu_torch.ops.cuda import tridiag
    from iv_interpolation_tpu_torch.ops import segment_ohlcv
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
    log(f"pandas {module_version('pandas')}, pyarrow {module_version('pyarrow')}")

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
    # and read just after it
    def reset_counts():
        tridiag.tridiag_solve_cuda.launches = 0
        tridiag.tridiag_solve_cuda.launches_by_dtype.update(float32=0, float64=0)
        agg.aggregate_ohlcv_cuda.launches = 0
        agg.aggregate_ohlcv_cuda.launches_by_dtype.update(float32=0, float64=0)

    def read_counts():
        return {"b1": tridiag.tridiag_solve_cuda.launches,
                "b2": agg.aggregate_ohlcv_cuda.launches}

    def read_by_dtype():
        by = tridiag.tridiag_solve_cuda.launches_by_dtype
        return {"b1_f32": by["float32"], "b1_f64": by["float64"],
                "b2": agg.aggregate_ohlcv_cuda.launches}

    def done(n):
        log(f"  phase {n} done at {time.perf_counter() - t_start:.1f} s")

    if want(2):
        log("phase 2: kernels against their plain versions")
        b1 = tridiag_cases(tridiag, lib)
        b2 = stream_agg_cases(agg)
        b2_f64 = stream_agg_cases(agg, torch.float64)
        done(2)
    reset_counts()
    if want(3):
        log("phase 3: surface step")
        surf = surface_step(surface, tridiag)
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
        done(5)
    if want(6):
        log("phase 6: the host runner")
        log(f"  card: {smi.splitlines()[0]}")
        host = host_runner(reset_counts, read_counts)
        log(f"  launches: {host['launches']}, B2 float64 {host['b2_f64_launches']}; dispatch "
            f"orders, wall s by batches in flight: {host['order_s']}")
        done(6)
        check(tridiag.tridiag_solve_cuda.launches_by_dtype["float64"] == 0,
              "phases 3-6 solve in float32 only")
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
        fits = calibrated_fits(CALIB, data)
        calib = calibrated_surfaces(CALIB, data)
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
        + f" surfaces/s; all phases done at {time.perf_counter() - t_start:.1f} s")
    b2["max_abs_err"] = max(b2["max_abs_err"], checks["b2_err"])

    # launches on each main path, by kernel (phases 3-6 solve in float32;
    # B2 runs in float64 on phase 6's float64 pipeline only)
    paths = {
        "tridiag_thomas_f32": {
            "surface step + streaming (phases 3-4)": surface_stream["b1"],
            "fused_batch (phase 5)": fused["b1"], "runner (phase 6)": host["launches"]["b1"],
            "surface task (phase 7)": surf_task["launches"]["b1_f32"],
            "AH fit_eval + eval_ah (phase 10)": ah_res["b1_f32"],
            "AH surface task (phase 10)": fam["launches"]["b1_f32"]},
        "tridiag_thomas_f64": {"surface task parity (phase 7)": surf_task["launches"]["b1_f64"],
                               "AH float64 fit (phase 10)": ah_res["b1_f64"]},
        "stream_agg": {
            "streaming (phase 4)": surface_stream["b2"], "fused_batch (phase 5)": fused["b2"],
            "runner (phase 6)": host["launches"]["b2"],
            "serving refits (phase 8)": served["launches"]["b2"]},
        "stream_agg_f64": {"float64 pipeline (phase 6)": host["b2_f64_launches"]},
    }
    check(all(n > 0 for n in paths["tridiag_thomas_f64"].values())
          and paths["tridiag_thomas_f32"]["surface task (phase 7)"] > 0
          and paths["tridiag_thomas_f32"]["AH fit_eval + eval_ah (phase 10)"] > 0
          and paths["tridiag_thomas_f32"]["AH surface task (phase 10)"] > 0
          and paths["stream_agg"]["serving refits (phase 8)"] > 0
          and paths["stream_agg_f64"]["float64 pipeline (phase 6)"] > 0,
          f"B1 float32 and float64 ran on the surface task and the AH paths, B2 on the served "
          f"refits and, in float64, on the float64 pipeline: {paths}")
    thomas = dict(route="cuda", source="iv_interpolation_tpu_torch/csrc/tridiag_thomas.cu",
                  replaces="iv_interpolation_tpu/ops/pallas/tridiag_pallas.py:57")
    agg_src = dict(route="cuda", source="iv_interpolation_tpu_torch/csrc/stream_agg.cu",
                  replaces="iv_interpolation_tpu/ops/pallas/stream_agg_pallas.py:163")
    # per kernel: the numbers of its first main-path shape (B1 float32 the
    # surface step, B1 float64 the parity surface task's larger bucket, B2
    # the candle stage), and every main-path shape under "shapes"
    results = {"tridiag_thomas_f32": (thomas, b1["float32"]),
               "tridiag_thomas_f64": (thomas, b1["float64"]),
               "stream_agg": (agg_src, b2), "stream_agg_f64": (agg_src, b2_f64)}
    kernels = [{"name": name, **source, "launches": sum(paths[name].values()),
                "paths": paths[name], **rows} for name, (source, rows) in results.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
