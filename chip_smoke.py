#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA card and check it.

Run from the repository root, with one card visible:

    python3 chip_smoke.py

Phases:
  1. set-up: the card's name and power limit (nvidia-smi), versions, the
     kernel build from ``iv_interpolation_tpu_torch/csrc`` and the pinned
     float32 matmul precision;
  2. each CUDA kernel against its plain PyTorch version on the card, at
     the shapes the main path gives it, with the device time of both
     (wrapper call and plain call, each replayed from a CUDA graph);
  3. the surface step: ``fit_eval_surface`` (cubic spline, not-a-knot) on
     32768 surfaces of 30 x 50 quotes, held to SciPy on a sub-batch;
  4. the streaming refit: a ``StreamingSession`` over 1024 underlyings
     (30 x 50 chains, 512-minute window, 8192-tick rings), held to the same
     session on CPU tensors, then one ``run_stream_replay``.

Prints a JSON line of per-kernel results, then as the last line
``{"ok": true, "device": {...}}``. Any failed check raises, so the script
exits non-zero and prints no result; so does a machine without a card or
a directory without the package. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import types

import numpy as np
import torch

EPS32 = float(np.finfo(np.float32).eps)
EPS64 = float(np.finfo(np.float64).eps)
DEV = "cuda"

# main-path shapes: B1 systems (n, batch, dtype, timed) -- n=48 at 983,040
# is the not-a-knot reduced system of the surface step (32768 x 30
# smiles); B2 (B, L, buckets) of the 1-min stage; the surface step; the
# streaming session; the replay
B1_CASES = ((48, 983_040, torch.float32, True), (50, 4096, torch.float64, False),
            (50, 1000, torch.float32, False), (1, 4097, torch.float32, False),
            (2, 4097, torch.float64, False))
B2_SHAPE = (1024, 4096, 512)
SURFACE = dict(B=32768, E=30, N=50, M=50)
STREAM = dict(B=1024, E=30, N=50, W=512, CAP=8192, CHUNKS=8, PER=512)
REPLAY = dict(n_underlyings=1024, window_minutes=512)


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


def device_ms(fn, reps: int) -> float:
    """Device time of one ``fn`` call in ms: ``fn`` is captured once in a
    CUDA graph and replayed ``reps`` times between CUDA events, so the
    host's launch overhead stays out of the number (eager calls of these
    wrappers are bound by the host, not the card)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up off the capture, as capture requires
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
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
    return start.elapsed_time(end) / reps


def same_with_nan(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype.is_floating_point:
        return bool(torch.equal(torch.isnan(a), torch.isnan(b))
                    and torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)))
    return bool(torch.equal(a, b))


# -- phase 2: kernels against their plain versions ---------------------------

def tridiag_cases(tridiag) -> dict:
    """B1 against the plain Thomas loop. Tolerance: 256 ulps of max |x|
    (diagonally dominant systems, n <= 50: Thomas is backward stable with
    error growth O(n eps), and the kernel's fused multiply-adds round each
    step at most one ulp differently from the plain version's separate
    multiply and subtract)."""
    gen = torch.Generator(device=DEV).manual_seed(11)
    worst, timing = 0.0, None
    for n, batch, dtype, timed in B1_CASES:
        u = lambda lo, hi: torch.empty((n, batch), dtype=dtype, device=DEV).uniform_(
            lo, hi, generator=gen)
        d, dl, du = u(4.0, 6.0), u(-1.0, 1.0), u(-1.0, 1.0)
        b = torch.randn((n, batch), dtype=dtype, device=DEV, generator=gen)
        x = tridiag.tridiag_solve_cuda(dl, d, du, b)
        torch.cuda.synchronize()
        ref = tridiag.tridiag_solve_plain(dl, d, du, b)
        err = float((x - ref).abs().max())
        eps = EPS32 if dtype == torch.float32 else EPS64
        bound = 256 * eps * max(1.0, float(ref.abs().max()))
        log(f"  B1 n={n} batch={batch} {str(dtype)[6:]}: max|kernel-plain|={err:.3e} "
            f"(bound {bound:.3e})")
        check(err <= bound and bool(torch.isfinite(x).all()),
              f"B1 kernel agrees with plain at n={n} batch={batch} {dtype}")
        worst = max(worst, err)
        if timed:
            ms = device_ms(lambda: tridiag.tridiag_solve_cuda(dl, d, du, b), 20)
            plain_ms = device_ms(lambda: tridiag.tridiag_solve_plain(dl, d, du, b), 5)
            log(f"  B1 n={n} batch={batch}: device ms kernel {ms:.4f}, plain {plain_ms:.4f}")
            timing = (ms, plain_ms)
    return {"max_abs_err": worst, "ms": timing[0], "plain_ms": timing[1]}


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
    worst = 0.0

    c1 = agg.aggregate_ohlcv_cuda(*ticks, **s1)
    torch.cuda.synchronize()
    c1_plain = agg.aggregate_ohlcv_plain(*ticks, **s1)
    worst = max(worst, compare_candles(c1, c1_plain, ticks, 1, 0, ns1,
                                       f"{B}x{L} -> {ns1}"))
    ms1 = device_ms(lambda: agg.aggregate_ohlcv_cuda(*ticks, **s1), 20)
    plain1 = device_ms(lambda: agg.aggregate_ohlcv_plain(*ticks, **s1), 5)

    # stage 2 reads the 1-min candles, NaN in their empty buckets
    check(bool(torch.isnan(c1_plain.open).any()), "stage-2 input carries NaN")
    m1 = torch.arange(ns1, dtype=torch.int32, device=DEV).expand(B, ns1).contiguous()
    stage2 = [m1, c1_plain.open, c1_plain.high, c1_plain.low, c1_plain.close,
              c1_plain.volume, c1_plain.valid]
    s2 = dict(bucket_minutes=5, num_segments=ns1 // 5 + 1, min_count=5)
    c5 = agg.aggregate_ohlcv_cuda(*stage2, **s2)
    torch.cuda.synchronize()
    worst = max(worst, compare_candles(c5, agg.aggregate_ohlcv_plain(*stage2, **s2),
                                       stage2, 5, 0, s2["num_segments"],
                                       f"{B}x{ns1} -> {s2['num_segments']}"))
    ms2 = device_ms(lambda: agg.aggregate_ohlcv_cuda(*stage2, **s2), 20)
    plain2 = device_ms(lambda: agg.aggregate_ohlcv_plain(*stage2, **s2), 5)

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
    cn = agg.aggregate_ohlcv_cuda(*neg, **s_neg)
    worst = max(worst, compare_candles(cn, agg.aggregate_ohlcv_plain(*neg, **s_neg),
                                       neg, 5, 0, 103, "negative minutes"))
    in_first = (valid & (neg[0] >= 0) & (neg[0] < 5)).sum(-1).to(torch.int32)
    check(torch.equal(cn.count[:, 0], in_first), "B2 negative minutes: bucket 0 count")

    log(f"  B2 {B}x{L}->{ns1} (bm=1): device ms kernel {ms1:.4f}, plain {plain1:.4f}")
    log(f"  B2 {B}x{ns1}->{ns1 // 5 + 1} (bm=5): device ms kernel {ms2:.4f}, "
        f"plain {plain2:.4f}")
    log(f"  B2 max|volume kernel-plain| = {worst:.3e}; shuffled, NaN/Inf and "
        f"negative-minute cases pass")
    return {"max_abs_err": worst, "ms": ms1 + ms2, "plain_ms": plain1 + plain2}


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; nothing was run",
              file=sys.stderr)
        return 1
    # the package lives beside this script; outside a checkout this fails
    from iv_interpolation_tpu_torch import _build
    from iv_interpolation_tpu_torch.ops.cuda import stream_agg as agg
    from iv_interpolation_tpu_torch.ops.cuda import tridiag
    from iv_interpolation_tpu_torch.pipeline import stream_service as svc
    from iv_interpolation_tpu_torch.surface import surface

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(smi.splitlines()[0])
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, device {torch.cuda.get_device_name(0)}")

    log("phase 1: build")
    t0 = time.perf_counter()
    lib_path, nvcc_s = _build.build()
    _build.load_library()
    log(f"  kernels built in {nvcc_s:.2f} s (nvcc), ready in "
        f"{time.perf_counter() - t0:.2f} s: {lib_path.name}")
    ptxas = [ln for ln in lib_path.with_suffix(".log").read_text().splitlines()
             if "registers" in ln or "Compiling entry" in ln] if nvcc_s else []
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
    b1 = tridiag_cases(tridiag)
    b2 = stream_agg_cases(agg)

    # the main path: launch counts start here
    tridiag.tridiag_solve_cuda.launches = 0
    agg.aggregate_ohlcv_cuda.launches = 0
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
    launches = {"b1": tridiag.tridiag_solve_cuda.launches,
                "b2": agg.aggregate_ohlcv_cuda.launches}
    check(launches["b1"] > 0 and launches["b2"] > 0,
          f"both kernels ran on the main path: {launches}")
    log(f"  summary: {surf['surfaces_per_s']:,.0f} surfaces/s, warm refit "
        f"{stream['warm_refit_ms']:.3f} ms ({stream['underlyings_per_s']:,.0f} "
        f"underlyings/s)")

    kernels = [
        {"name": "tridiag_thomas", "route": "cuda",
         "source": "iv_interpolation_tpu_torch/csrc/tridiag_thomas.cu",
         "replaces": "iv_interpolation_tpu/ops/pallas/tridiag_pallas.py:57",
         "launches": launches["b1"], **b1},
        {"name": "stream_agg", "route": "cuda",
         "source": "iv_interpolation_tpu_torch/csrc/stream_agg.cu",
         "replaces": "iv_interpolation_tpu/ops/pallas/stream_agg_pallas.py:163",
         "launches": launches["b2"], **b2},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
