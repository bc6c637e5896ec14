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
     minutes, scalar loads, the tile loop); at each main-path shape the
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
     tables and a cubic run (B1 once a sub-batch); the CLI in a
     subprocess;
  7. the surface task: an ``interpolated`` table of 256 underlyings (192
     of 12 expiries x 32 strikes, 64 of 6 x 16, call and put, two
     snapshots a symbol, about 2 % of the latest rows marked by price
     only) in a parquet store, through ``run_surface_fit`` on the card
     with the cubic spline (B1 float32), the smoothing spline, parity mode
     (B1 float64) and local vol: host seconds by phase, surfaces/s, idle
     share, peak memory, B1 launches by dtype, no plain version called;
     each run against the same run on CPU tensors, parity mode against
     SciPy's float64 spline on 32 surfaces, the surface audit, and the
     CLI (``--task surface`` exits 0, ``--method svi`` exits 2);
  8. serving: ``run_serve`` over phase 7's store (its 256 underlyings'
     chains), a client's ticks, flush, 7 refits (median reply latency),
     stats and stop; the refits against a CPU session fed the same ticks,
     B2 twice a refit; the same over Arrow Flight where it imports.

B1 is listed twice in the kernel line, float32 and float64, each with its
launches on every path.

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
# float64; n=6 and 62 the neighbouring buckets (8 and 64 strikes).
F32, F64 = torch.float32, torch.float64
B1_MAIN = {(48, 983_040, F32): "surface step", (166, 768, F32): "cubic batch",
           (30, 3072, F32): "surface task 192x16", (14, 512, F32): "surface task 64x8",
           (30, 3072, F64): "surface task parity 192x16",
           (14, 512, F64): "surface task parity 64x8"}
B1_CASES = ((48, 983_040, F32, 1.0), (166, 768, F32, 1.0),
            (30, 3072, F32, 1.0), (14, 512, F32, 1.0),
            (30, 3072, F64, 1.0), (14, 512, F64, 1.0),
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
# main run (2 batches in flight), one run with 1 and one with 2 batches in
# flight (cut from four turns: on a slow host the four took over three
# minutes, and the two orders have measured within their spread).
RUNNER = dict(symbols=2048, hours=168, drop_frac=0.1, seed=16, batch=256,
              small_symbols=512, small_hours=48, small_batch=64)
RUNNER_ORDER_TURNS = (1, 2)
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

def dense_solve_ms(dl, d, du, b, x) -> float | None:
    """``torch.linalg.solve`` on the densified (batch, n, n) systems, 3
    reps, the matrices built outside the timed window; None where the
    card's free memory does not hold the matrix, its LU copy and a margin.
    Its solution is held to the kernel's as a check that it solves the
    same systems. The port never calls it."""
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
    check(err <= 1e-3 * max(1.0, float(x.abs().max())),
          f"the dense solve agrees with the kernel at n={n} ({err:.3e})")
    del A, rhs, dense
    torch.cuda.empty_cache()
    return ms


def tridiag_cases(tridiag, lib) -> dict:
    """B1 against the plain Thomas loop at every case of B1_CASES, then
    timed at the main-path shapes: the kernel on its planned route, the
    global-scratch kernel (one thread a system, which the plan keeps for
    large n) in turns with it, the plain loop, the dense library solve and the
    bound. Tolerance: 256 ulps of max |x| (diagonally dominant systems:
    Thomas is backward stable with error growth O(n eps), and the kernel's
    fused multiply-adds round each step at most one ulp differently from
    the plain version's separate multiply and subtract). Returns, per
    dtype name, the worst error, the first main-path shape's row and
    every main-path row."""
    gen = torch.Generator(device=DEV).manual_seed(11)
    worst, rows = {"float32": 0.0, "float64": 0.0}, {"float32": [], "float64": []}
    for n, batch, dtype, scale in B1_CASES:
        u = lambda lo, hi: torch.empty((n, batch), dtype=dtype, device=DEV).uniform_(
            lo * scale, hi * scale, generator=gen)
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
        log(f"  B1 n={n} batch={batch} {str(dtype)[6:]}{' x%g' % scale if scale > 1 else ''} "
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
            9 * n * batch, dense_solve_ms(dl, d, du, b, x),
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


def compare_candles(got, ref, inputs, bm, base, ns, what) -> float:
    """Exact open/high/low/close/count/valid; volume within the float32
    sum bound. Both sums run in unordered atomics, and any float32 sum of
    a bucket's values lies within (count - 1) eps32 sum|v| of the exact
    sum; the two differ by at most twice that plus an ulp of rounding."""
    for f in ("open", "high", "low", "close", "count", "valid"):
        check(same_with_nan(getattr(got, f), getattr(ref, f)), f"B2 {what}: {f} exact")
    vol64, mag = bucket_sums(inputs[0], inputs[5], inputs[6], bm, base, ns)
    cnt = (got.count.double() - 1).clamp_min(0)
    err = (got.volume.double() - ref.volume.double()).abs()
    check(bool((err <= 2 * cnt * EPS32 * mag + EPS32 * vol64.abs()).all()),
          f"B2 {what}: volume within the float32 sum bound of the plain version")
    check(bool(((got.volume.double() - vol64).abs()
                <= cnt * EPS32 * mag + EPS32 * vol64.abs()).all()),
          f"B2 {what}: volume within the float32 sum bound of the float64 sum")
    return float(err.max())


def b2_bytes(ticks, got) -> int:
    """Bytes a B2 call must move with these inputs: valid once; the
    minutes of the valid rows; h, l and v of the rows that land in a
    bucket (each distinct tensor once); o and c once per nonempty bucket;
    25 bytes a bucket out (five float32, an int32 count, a bool)."""
    minutes, o, h, l, c, v, valid = ticks
    distinct = lambda *ts: len({t.data_ptr() for t in ts})
    counted = int(got.count.sum())
    nonempty = int((got.count > 0).sum())
    return (valid.numel() + int(valid.sum()) * minutes.element_size()
            + counted * 4 * distinct(h, l, v) + nonempty * 4 * distinct(o, c)
            + got.count.numel() * 25)


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
    plan = agg.agg_plan(ticks[0].shape[1], kw["num_segments"])
    kernel = lambda: agg.aggregate_ohlcv_cuda(*ticks, **kw)
    ms = device_ms(kernel, 20, CALLS)
    plain = device_ms(lambda: agg.aggregate_ohlcv_plain(*ticks, **kw), 5, CALLS)
    row = timing_row(f"B2 {what}", ms, plain, b2_bytes(ticks, got), 0, None,
                     ms_one_call_a_graph=device_ms(kernel, 20),
                     tiles=plan.tiles, threads=plan.threads, smem=plan.smem,
                     minutes=str(ticks[0].dtype)[6:])
    return got, ref, err, row


def candle_ticks(gen):
    """Candle-stage-shaped ticks: each row's 1-min grid from an epoch
    minute on, the first ``filled`` slots valid (the pipeline's timeline),
    int64 minutes as the stage passes them."""
    P = B2_CANDLE
    B, L = P["B"], P["L"]
    start = int(np.datetime64("2023-03-20T09:00", "m").astype(np.int64))
    minutes = (start + torch.arange(L, device=DEV)).expand(B, L).contiguous()
    mid = 25000 + torch.randn((B, L), generator=gen, device=DEV).cumsum(-1)
    spread = torch.rand((B, L), generator=gen, device=DEV) * 10
    valid = (torch.arange(L, device=DEV) < P["filled"]).expand(B, L).contiguous()
    vol = torch.rand((B, L), generator=gen, device=DEV) * 50
    return [minutes, mid, mid + spread, mid - spread, mid + 0.5 * spread, vol, valid], start


def stream_agg_cases(agg) -> dict:
    gen = torch.Generator(device=DEV).manual_seed(12)
    B, L, ns1 = B2_SHAPE
    minutes = torch.sort(torch.randint(0, ns1, (B, L), generator=gen, device=DEV,
                                       dtype=torch.int32), dim=-1).values
    price = 100 + torch.randn((B, L), generator=gen, device=DEV).cumsum(-1) * 0.01
    size = torch.rand((B, L), generator=gen, device=DEV) * 5
    valid = torch.rand((B, L), generator=gen, device=DEV) < 0.9
    ticks = [minutes, price, price, price, price, size, valid]
    s1 = dict(bucket_minutes=1, num_segments=ns1, min_count=1)
    rows = []

    # the pipeline's candle stage: epoch-scale int64 minutes shifted into
    # range by base_bucket; then the same minutes moved past int32 (the
    # 64-bit division), with base_bucket moved by as many buckets
    candles, start = candle_ticks(gen)
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
                <= cnt * EPS32 * mag + EPS32 * vol64.abs()).all()), "B2 shuffled: volume")

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
    wide_min = torch.sort(torch.randint(0, wide_ns, wide_shape, generator=gen, device=DEV,
                                        dtype=torch.int32), dim=-1).values
    wide_p = 100 + torch.randn(wide_shape, generator=gen, device=DEV).cumsum(-1) * 0.01
    wide = [wide_min, wide_p, wide_p, wide_p, wide_p,
            torch.rand(wide_shape, generator=gen, device=DEV) * 5,
            torch.rand(wide_shape, generator=gen, device=DEV) < 0.9]
    plan = agg.agg_plan(wide_shape[1], wide_ns)
    check(plan.tiles == 3, f"the wide case takes the tile loop: {plan}")
    worst = max(worst, b2_case(agg, wide, dict(s1, num_segments=wide_ns),
                               f"tile loop {wide_shape[0]}x{wide_shape[1]}->{wide_ns} "
                               f"({plan.tiles} tiles)")[2])
    log(f"  B2 max|volume kernel-plain| = {worst:.3e}; beyond-int32, shuffled, NaN/Inf, "
        f"negative-minute, scalar-load and tile-loop cases pass")
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
    try:
        agg.aggregate_ohlcv_cuda(ticks[0], *(a.double() for a in ticks[1:6]), ticks[6], **kw)
        check(False, "a float64 CUDA batch raises")
    except TypeError:
        pass
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
    runner_cli(root, work)
    shutil.rmtree(work, ignore_errors=True)
    return {"launches": {k: main["counts"][k] + small[k] for k in main["counts"]},
            "rows_per_s": main["rate"], "store": kind,
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
    work = root / "build" / "chip_smoke_surface"
    rng = np.random.default_rng(P["seed"])
    t0 = time.perf_counter()
    frame, truth = make_surface_table(rng)
    store = make_store(st, work / "data")
    store.write(st.INTERPOLATED, frame, upsert_keys=["symbol", "date"])
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


def surface_cli(root, work) -> None:
    """(f): ``iv-tpu-torch --task surface --json`` on the phase's store
    exits 0 on the card, ``--method svi`` exits 2 naming A5."""
    cli_dir = work / "cli"
    cli_dir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(root), os.environ.get("PYTHONPATH", "")) if p))
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
    check(svi.returncode == 2 and "ROADMAP: A5" in svi.stderr,
          f"(f) --method svi exits 2 naming A5: {svi.returncode} {svi.stderr[-500:]}")
    log(f"  (f) {' '.join(base[1:])}: exit 0, {out['surface']}; --method svi: exit 2 "
        f"({svi.stderr.strip()})")


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; nothing was run",
              file=sys.stderr)
        return 1
    # the package lives beside this script; outside a checkout this fails
    from iv_interpolation_tpu_torch import _build
    from iv_interpolation_tpu_torch.ops.cuda import stream_agg as agg
    from iv_interpolation_tpu_torch.ops.cuda import tridiag
    from iv_interpolation_tpu_torch.ops import segment_ohlcv
    from iv_interpolation_tpu_torch.pipeline import runner, tasks
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

    log("phase 2: kernels against their plain versions")
    b1 = tridiag_cases(tridiag, lib)
    b2 = stream_agg_cases(agg)

    # each main path runs with the launch counts set to 0 just before it
    # and read just after it
    def reset_counts():
        tridiag.tridiag_solve_cuda.launches = 0
        tridiag.tridiag_solve_cuda.launches_by_dtype.update(float32=0, float64=0)
        agg.aggregate_ohlcv_cuda.launches = 0

    def read_counts():
        return {"b1": tridiag.tridiag_solve_cuda.launches,
                "b2": agg.aggregate_ohlcv_cuda.launches}

    def read_by_dtype():
        by = tridiag.tridiag_solve_cuda.launches_by_dtype
        return {"b1_f32": by["float32"], "b1_f64": by["float64"],
                "b2": agg.aggregate_ohlcv_cuda.launches}

    reset_counts()
    log("phase 3: surface step")
    surf = surface_step(surface, tridiag)
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
    check(surface_stream["b1"] > 0 and surface_stream["b2"] > 0,
          f"both kernels ran on the surface and streaming paths: {surface_stream}")
    log(f"  launches: {surface_stream}; phases 3-4 done at "
        f"{time.perf_counter() - t_start:.1f} s")
    log("phase 5: fused task pipeline")
    reset_counts()
    pipe = pipeline_main_path(runner, tasks, segment_ohlcv, agg, tridiag)
    fused = read_counts()
    check(fused == {"b1": 1, "b2": len(pipe["batches"]) + 1},
          f"the pipeline launched B2 once a batch and B1 in the cubic batch: {fused}")
    log(f"  launches: {fused}")
    checks = pipeline_checks(pipe, runner, tasks, agg)
    log(f"  phase 5 done at {time.perf_counter() - t_start:.1f} s")
    log("phase 6: the host runner")
    log(f"  card: {smi.splitlines()[0]}")
    host = host_runner(reset_counts, read_counts)
    log(f"  launches: {host['launches']}; dispatch orders, wall s by batches in flight: "
        f"{host['order_s']}; phase 6 done at {time.perf_counter() - t_start:.1f} s")
    check(tridiag.tridiag_solve_cuda.launches_by_dtype["float64"] == 0,
          "phases 3-6 solve in float32 only")
    log("phase 7: the surface task")
    surf_task = surface_task_phase(reset_counts, read_by_dtype, tridiag, agg)
    log(f"  launches: {surf_task['launches']}; phase 7 done at "
        f"{time.perf_counter() - t_start:.1f} s")
    log("phase 8: serving")
    served = serving_phase(surf_task["store"], reset_counts, read_by_dtype)
    shutil.rmtree(surf_task["work"], ignore_errors=True)
    log(f"  launches: {served['launches']}; phase 8 done at "
        f"{time.perf_counter() - t_start:.1f} s")
    log(f"  summary: {surf['surfaces_per_s']:,.0f} surfaces/s, warm refit "
        f"{stream['warm_refit_ms']:.3f} ms ({stream['underlyings_per_s']:,.0f} "
        f"underlyings/s), fused_batch {pipe['rows_per_s']:,.0f} output rows/s, "
        f"runner {host['rows_per_s']:,.0f} output rows/s ({host['store']}), surface task "
        + ", ".join(f"{k} {v:,.0f}" for k, v in surf_task["rates"].items())
        + f" surfaces/s, served refit {served['refit_ms']:.2f} ms; all phases done at "
        f"{time.perf_counter() - t_start:.1f} s")
    b2["max_abs_err"] = max(b2["max_abs_err"], checks["b2_err"])

    # launches on each main path, by kernel (phases 3-6 solve in float32)
    paths = {
        "tridiag_thomas_f32": {
            "surface step + streaming (phases 3-4)": surface_stream["b1"],
            "fused_batch (phase 5)": fused["b1"], "runner (phase 6)": host["launches"]["b1"],
            "surface task (phase 7)": surf_task["launches"]["b1_f32"]},
        "tridiag_thomas_f64": {"surface task parity (phase 7)": surf_task["launches"]["b1_f64"]},
        "stream_agg": {
            "streaming (phase 4)": surface_stream["b2"], "fused_batch (phase 5)": fused["b2"],
            "runner (phase 6)": host["launches"]["b2"],
            "serving refits (phase 8)": served["launches"]["b2"]},
    }
    check(all(n > 0 for n in paths["tridiag_thomas_f64"].values())
          and paths["tridiag_thomas_f32"]["surface task (phase 7)"] > 0
          and paths["stream_agg"]["serving refits (phase 8)"] > 0,
          f"B1 float32 and float64 ran on the surface task, B2 on the served refits: {paths}")
    thomas = dict(route="cuda", source="iv_interpolation_tpu_torch/csrc/tridiag_thomas.cu",
                  replaces="iv_interpolation_tpu/ops/pallas/tridiag_pallas.py:57")
    # per kernel: the numbers of its first main-path shape (B1 float32 the
    # surface step, B1 float64 the parity surface task's larger bucket, B2
    # the candle stage), and every main-path shape under "shapes"
    kernels = [
        {"name": "tridiag_thomas_f32", **thomas,
         "launches": sum(paths["tridiag_thomas_f32"].values()),
         "paths": paths["tridiag_thomas_f32"], **b1["float32"]},
        {"name": "tridiag_thomas_f64", **thomas,
         "launches": sum(paths["tridiag_thomas_f64"].values()),
         "paths": paths["tridiag_thomas_f64"], **b1["float64"]},
        {"name": "stream_agg", "route": "cuda",
         "source": "iv_interpolation_tpu_torch/csrc/stream_agg.cu",
         "replaces": "iv_interpolation_tpu/ops/pallas/stream_agg_pallas.py:163",
         "launches": sum(paths["stream_agg"].values()), "paths": paths["stream_agg"], **b2},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
