"""Bench harness of the port: eight stages timed on one NVIDIA card (port
of the root ``bench.py``).

Run from the repository root::

    python -m iv_interpolation_tpu_torch.bench                 # on the card
    IVTPU_BENCH_SMOKE=1 python -m iv_interpolation_tpu_torch.bench --device cpu

The second form runs tiny shapes on the CPU, the harness's own test. The
stages (``STAGES``), each a ``bench_*`` function with bench.py's name,
default shapes and return tuple:

  * ``spline`` (the headline): the operator form
    ``ops.spline_matrix.fit_eval_surface_grid`` (not-a-knot, 30 expiries x
    50 knots -> 50 queries) at B = 32,768 and 131,072, the better of the
    two; ``build_surface_operators`` is set-up, untimed. Its accuracy
    telemetry: a 64-surface clean sub-batch against SciPy's float64
    not-a-knot spline on 8 x 5 slices, and the clean and adversarial
    butterfly fractions;
  * ``parity``: parity mode, ``models.spline.fit_eval_surface_parity``
    (float64, the knot curvatures from kernel B1 in float64) at 32,768 x
    30 x 50, held to SciPy on the float64 ``parity_grid``;
  * ``svi`` and ``essvi``: ``fit_svi_batched(init="quasi")`` and
    ``fit_essvi_batched`` (block solver) at 1,024 x 30 x 50, 32 iterations,
    with their rmse;
  * ``streaming``: ``pipeline.streaming.streaming_step`` on precomputed
    per-underlying operators, 1,024 x 4,096 ticks -> 512 minutes (kernel
    B2 twice a step);
  * ``rbf`` and ``rbf_reduced``: ``fit_eval_rbf_arbfree_batched`` at 8 x
    2,048 sites and at 64 x 2,048 on 512 centers, 24 iterations, with the
    arbitrage-free fraction;
  * ``ah``: ``fit_eval_ah_surface`` at 512 x 8 x 16 quotes with an ATM
    spike, grid 257, 16 iterations (B1 in float32), with the
    arbitrage-free fraction and the price rmse.

Inputs are made on the device from seeds by ``ops.prng``, JAX's
partitionable threefry: uniform and integer draws are JAX's bit for bit,
normal draws within the ulps that module states. Each stage draws
``seed0 = int(rng.integers(0, 2**31 - 16))`` from its numpy ``rng`` and
makes input set i from ``seed0 + i`` by bench.py's formulas. The harness
gives stage j the ``rng`` ``np.random.default_rng([seed, j])``, so a
stage's inputs depend only on ``--seed`` and the stage, whichever child
runs it.

Timing. Each stage makes bench.py's input sets (6 for spline and parity,
4 for the rest): the last warms up, and each other is one timed call on
its own input (the spline stage's inputs, 197-786 MB each, exceed an
NVIDIA H100's 50 MB L2 cache either way). A call is timed twice: by the
host clock from the call to a ``torch.cuda.synchronize()`` after it, and
by CUDA events recorded around it on the current stream. ``value`` is the
work over the median host time, the time to a result with dispatch
included, as in bench.py; the event median goes beside it. The events
bracket the gaps in which the card waits for the host's launches too, so
a launch-bound stage (AH makes tens of thousands of launches a fit) reads
about the same both ways; how long the card idles needs a profiler.

The harness. The parent process starts a child that runs the selected
stages in order and writes each result to the state file
(``IVTPU_BENCH_STATE``, replaced atomically) the moment it completes. A
stage that raises is recorded as failed, and the child exits non-zero at
once: a sticky CUDA error (an illegal address, a failed launch) poisons
the context for the rest of its process. The parent then starts a fresh
child for the stages that remain; a failed stage is not retried, and a
child that dies or outlives ``IVTPU_BENCH_ATTEMPT_S`` seconds has its
running stage recorded as failed. Stdout carries exactly one JSON line,
assembled from whatever completed; SIGTERM and SIGINT flush it. All else
(progress, the kernel build, library warnings) goes to stderr. The parent
exits 0 only when the headline stage was measured.

The line has bench.py's keys and metric names, with three departures:

  * the parity metric is ``parity_f64_surfaces_per_sec_fit_eval_30x50``:
    parity mode runs in float64 on the card, not in double-float32;
  * ``device`` is the card's name with its power limit, for example
    ``"NVIDIA H100 80GB HBM3 (700.00 W)"``; a CPU run (tests only) says
    ``"cpu"``;
  * ``vs_baseline`` is null: bench.py divides by a target set for another
    chip, and the card has none yet.

The state file also keeps, for each stage, every call's host and event
times with their medians, the peak device memory, the launches of kernel
B1 (by dtype) and B2 during the stage, its seed and its wall seconds.

Arguments: ``--device`` (default ``cuda``; without a card the harness
raises rather than run on the CPU), ``--seed`` (default time-derived),
``--stages a,b`` (a subset, run in ``STAGES`` order). Environment:
``IVTPU_BENCH_STATE`` (the state file; the stages an existing file holds
are kept, and a complete run's file is kept only when named here),
``IVTPU_BENCH_ATTEMPT_S`` (a child's time limit), ``IVTPU_BENCH_SMOKE=1``
(tiny shapes).
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from iv_interpolation_tpu_torch import _build
from iv_interpolation_tpu_torch.ops import prng
from iv_interpolation_tpu_torch.ops.cuda.stream_agg import aggregate_ohlcv_cuda
from iv_interpolation_tpu_torch.ops.cuda.tridiag import tridiag_solve_cuda

E, N_K, N_GRID = 30, 50, 50
SMOKE = os.environ.get("IVTPU_BENCH_SMOKE", "") == "1"
F32 = torch.float32
_REPO_ROOT = Path(__file__).resolve().parents[1]


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, args, device: torch.device) -> tuple[float, float | None]:
    """One call of ``fn``: host seconds to a synchronize after it, and the
    CUDA events' milliseconds around it (None off the card)."""
    cuda = device.type == "cuda"
    if cuda:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    if cuda:
        start.record()
    fn(*args)
    if cuda:
        end.record()
    _sync(device)
    host = time.perf_counter() - t0
    return host, (start.elapsed_time(end) if cuda else None)


def _median_time(fn, inputs, device: torch.device, calls: list | None = None,
                 batch: int | None = None) -> float:
    """Median host seconds of ``fn`` over fresh inputs (the last one warms
    up). Each timed call's host and event times go to ``calls``."""
    _timed(fn, inputs[-1], device)
    times = [_timed(fn, args, device) for args in inputs[:-1]]
    host = sorted(t for t, _ in times)
    events = [ms for _, ms in times]
    if calls is not None:
        calls.append({
            "batch": batch, "host_s": [t for t, _ in times], "event_ms": events,
            "host_median_s": host[len(host) // 2],
            "event_median_ms": (None if events[0] is None
                                else sorted(events)[len(events) // 2])})
    return host[len(host) // 2]


def _iv_gen(B, k_row, device):
    """Seed -> (B, E, N_K) float32 smiles made on ``device``: a uniform ATM
    level and curvature per surface plus 1e-4 normal noise."""
    kk = torch.from_numpy(k_row).to(device)[None, None, :]

    def gen(seed):
        k1, k2, k3 = prng.split(prng.key(seed, device), 3)
        atm = prng.uniform(k1, F32, 0.15, 0.6, (B, 1, 1))
        curv = prng.uniform(k2, F32, 0.05, 0.3, (B, 1, 1))
        noise = 1e-4 * prng.normal(k3, F32, (B, E, N_K))
        return atm + curv * kk * kk + noise

    return gen


def _clean_smiles(k_row):
    """bench.py's 64-surface clean sub-batch (numpy seed 12345): float32
    (64, E, N_K) noiseless convex smiles."""
    rng = np.random.default_rng(12345)
    atm = rng.uniform(0.15, 0.6, (64, 1, 1))
    curv = rng.uniform(0.05, 0.3, (64, 1, 1))
    kk = k_row[None, None, :]
    return np.broadcast_to(atm + curv * kk * kk, (64, E, N_K)).astype(np.float32)


def bench_spline(rng, batch_sizes=(32768, 131072), device="cuda", calls=None):
    """The headline: operator-form fit + eval on a 30 x 50 grid. Returns
    (surfaces/s at the better batch, that batch, accuracy dict)."""
    from iv_interpolation_tpu_torch.ops.spline_matrix import (
        build_surface_operators, fit_eval_surface_grid)

    device = torch.device(device)
    k_row = np.linspace(-1.0, 1.0, N_K, dtype=np.float32)
    knots = torch.from_numpy(np.broadcast_to(k_row, (E, N_K)).copy()).to(device)
    queries = torch.from_numpy(np.linspace(-1.0, 1.0, N_GRID, dtype=np.float32)).to(device)
    T_host = np.linspace(0.05, 2.0, E, dtype=np.float32)
    T = torch.from_numpy(T_host).to(device)
    # not-a-knot: the operator shapes and work of natural, without spurious
    # edge butterfly flags on smooth smiles; set-up, untimed
    ops = build_surface_operators(knots, queries, bc_type="not-a-knot")
    _sync(device)

    def step(iv):
        out = fit_eval_surface_grid(ops, iv, T)
        return out["w_grid"], out["butterfly_ok"], out["calendar_ok"]

    best, best_B = 0.0, 0
    for B in batch_sizes:
        gen = _iv_gen(B, k_row, device)
        seed0 = int(rng.integers(0, 2**31 - 16))
        inputs = [(gen(seed0 + i),) for i in range(6)]
        _sync(device)
        dt = _median_time(step, inputs, device, calls, B)
        del inputs  # free the resident batches before the next size
        if B / dt > best:
            best, best_B = B / dt, B
    return best, best_B, _spline_accuracy(step, k_row, T_host, device)


def _spline_accuracy(step, k_row, T_host, device) -> dict:
    """Accuracy telemetry of the headline path: a fast number means nothing
    if values or flags went wrong (a reduced-precision product flips
    butterfly g). ``parity_max_err``: max |w_grid - SciPy float64| on 8 x 5
    slices of the clean sub-batch; ``butterfly_clean_frac``: clean smiles
    flagged butterfly-free (1.0); ``butterfly_adversarial_frac``:
    grid-scale wiggles flagged clean (about 0)."""
    iv_clean = _clean_smiles(k_row)
    w_dev, bfly_clean, _ = step(torch.from_numpy(iv_clean).to(device))
    w_dev = w_dev.cpu().numpy()
    parity = 0.0
    try:
        from scipy.interpolate import CubicSpline
        q = np.linspace(-1.0, 1.0, N_GRID)
        for b in range(0, 64, 8):
            for e in range(0, E, 6):
                w_knots = iv_clean[b, e].astype(np.float64) ** 2 * float(T_host[e])
                ref = CubicSpline(k_row.astype(np.float64), w_knots, bc_type="not-a-knot")(q)
                parity = max(parity, float(np.abs(w_dev[b, e] - ref).max()))
    except ImportError:                       # pragma: no cover
        parity = None
    kk = k_row[None, None, :]
    iv_bad = (iv_clean + 0.08 * np.sin(20 * kk)).astype(np.float32)
    _, bfly_bad, _ = step(torch.from_numpy(iv_bad).to(device))
    return {"parity_max_err": parity,
            "butterfly_clean_frac": float(bfly_clean.double().mean()),
            "butterfly_adversarial_frac": float(bfly_bad.double().mean())}


def bench_parity(rng, B=32768, device="cuda", calls=None):
    """Parity mode (CLI ``--parity``): float64 fit + eval of the float32
    quotes, the (w_grid, w_grid_lo) pair. Returns (surfaces/s, max
    |hi + lo - SciPy float64| over 16 x 30 slices of the clean sub-batch,
    the oracle evaluated on the float64 ``parity_grid``)."""
    from iv_interpolation_tpu_torch.models.spline import fit_eval_surface_parity, parity_grid

    device = torch.device(device)
    k_row = np.linspace(-1.0, 1.0, N_K, dtype=np.float32)
    T_host = np.linspace(0.05, 2.0, E, dtype=np.float32)
    k_dev, T_dev = (torch.from_numpy(a).to(device) for a in (k_row, T_host))

    def step(iv):
        b = iv.shape[0]
        out = fit_eval_surface_parity(k_dev.expand(b, E, N_K), iv, T_dev.expand(b, E),
                                      n_grid=N_GRID, bc_type="not-a-knot")
        return out["w_grid"], out["w_grid_lo"], out["butterfly_ok"], out["calendar_ok"]

    gen = _iv_gen(B, k_row, device)
    seed0 = int(rng.integers(0, 2**31 - 16))
    inputs = [(gen(seed0 + i),) for i in range(6)]
    _sync(device)
    dt = _median_time(step, inputs, device, calls, B)
    del inputs

    iv_clean = _clean_smiles(k_row)
    w_hi, w_lo, _, _ = step(torch.from_numpy(iv_clean).to(device))
    w64 = w_hi.cpu().double().numpy() + w_lo.cpu().double().numpy()
    q64 = parity_grid(torch.from_numpy(k_row).expand(1, E, N_K), N_GRID)[0, 0].numpy()
    parity = 0.0
    try:
        from scipy.interpolate import CubicSpline
        for b in range(0, 64, 4):
            for e in range(E):
                w_knots = iv_clean[b, e].astype(np.float64) ** 2 * float(T_host[e])
                ref = CubicSpline(k_row.astype(np.float64), w_knots, bc_type="not-a-knot")(q64)
                parity = max(parity, float(np.abs(w64[b, e] - ref).max()))
    except ImportError:                       # pragma: no cover
        parity = None
    return B / dt, parity


def _rbf_gen(B, N, device):
    """Seed -> (points (B, N, 2), w (B, N)): uniform (k, T) sites and an
    arbitrage-laden total variance."""
    def gen(seed):
        ks = prng.split(prng.key(seed, device), 3)
        kq = prng.uniform(ks[0], F32, -1.0, 1.0, (B, N))
        Tq = prng.uniform(ks[1], F32, 0.05, 2.0, (B, N))
        w = (0.04 + 0.3 * kq * kq) * Tq + 0.01 * torch.sin(8.0 * kq) * Tq
        return torch.stack([kq, Tq], dim=-1), w

    return gen


def bench_rbf(rng, B=8, N=2048, n_iters=24, n_centers=None, device="cuda", calls=None):
    """Arbitrage-penalized RBF on B x N scattered quotes with an arbitrage-
    laden wiggle, fitted as one batched damped Gauss-Newton solve, flags
    from the penalty grid. 24 iterations: fewer leave part of the batch
    unrepaired. Returns (surfaces/s, arbitrage-free fraction)."""
    from iv_interpolation_tpu_torch.ops.rbf import fit_eval_rbf_arbfree_batched

    device = torch.device(device)
    gen = _rbf_gen(B, N, device)

    def step(pts, w):
        return fit_eval_rbf_arbfree_batched(pts, w, pts[:, :64], smoothing=1e-8,
                                            n_iters=n_iters, n_centers=n_centers)

    seed0 = int(rng.integers(0, 2**31 - 16))
    inputs = [gen(seed0 + i) for i in range(4)]
    _sync(device)
    dt = _median_time(step, inputs, device, calls, B)
    _, bok, cok = step(*inputs[0])
    return B / dt, float((bok & cok).double().mean())


def _svi_gen(B, k_row, device):
    """Seed -> (B, E, n) SVI slices with uniform raw parameters a slice,
    plus 1e-4 normal noise."""
    kk = torch.from_numpy(k_row).to(device)[None, None, :]
    n = k_row.shape[0]

    def gen_w(seed):
        keys = prng.split(prng.key(seed, device), 6)
        U = lambda key, lo, hi: prng.uniform(key, F32, lo, hi, (B, E, 1))
        a, b = U(keys[0], 0.01, 0.08), U(keys[1], 0.05, 0.3)
        rho, m = U(keys[2], -0.6, 0.6), U(keys[3], -0.2, 0.2)
        sig = U(keys[4], 0.1, 0.5)
        w = a + b * (rho * (kk - m) + torch.sqrt((kk - m) ** 2 + sig ** 2))
        return w + 1e-4 * prng.normal(keys[5], F32, (B, E, n))

    return gen_w


def bench_svi(rng, B=1024, n_iters=32, device="cuda", calls=None):
    """SVI calibration of B surfaces x 30 slices with the quasi-explicit
    init. Returns (slices/s, rmse of the fit against the quotes)."""
    from iv_interpolation_tpu_torch.ops.svi import fit_svi_batched, svi_total_variance

    device = torch.device(device)
    n = N_K
    k_row = np.linspace(-1.2, 1.2, n, dtype=np.float32)
    k_dev = torch.from_numpy(np.broadcast_to(k_row, (B, E, n)).copy()).to(device)
    gen_w = _svi_gen(B, k_row, device)
    seed0 = int(rng.integers(0, 2**31 - 16))

    def fit(k, w):
        return fit_svi_batched(k, w, max_iters=n_iters, init="quasi")

    inputs = [(k_dev, gen_w(seed0 + i)) for i in range(4)]
    _sync(device)
    dt = _median_time(fit, inputs, device, calls, B)
    res = fit(*inputs[0])
    k, w = inputs[0]
    pred = svi_total_variance(res.params, k)
    return B * E / dt, float(torch.sqrt(torch.mean((pred - w) ** 2)))


def _essvi_gen(k):
    """Seed -> eSSVI surfaces on the strikes ``k`` (B, E, n): increasing
    ATM variance, one rho and one fraction of the butterfly cap a surface,
    plus 1e-4 normal noise."""
    from iv_interpolation_tpu_torch.ops.essvi import essvi_w, psi_butterfly_cap

    B, E_, n = k.shape

    def gen_w(seed):
        keys = prng.split(prng.key(seed, k.device), 5)
        theta = torch.cumsum(prng.uniform(keys[0], F32, 0.005, 0.03, (B, E_)), dim=-1)
        rho = prng.uniform(keys[1], F32, -0.6, 0.6, (B, 1)).expand(B, E_)
        frac = prng.uniform(keys[2], F32, 0.2, 0.7, (B, 1)).expand(B, E_)
        params = torch.stack([theta, rho, psi_butterfly_cap(theta, rho) * frac], dim=-1)
        w = essvi_w(params, k)
        return w + 1e-4 * prng.normal(keys[3], F32, (B, E_, n))

    return gen_w


def bench_essvi(rng, B=1024, n_iters=32, device="cuda", calls=None):
    """eSSVI global calibration: one joint 3E-parameter LM a surface on
    the block-tridiagonal slice-space solver. Returns (surfaces/s, rmse)."""
    from iv_interpolation_tpu_torch.ops.essvi import essvi_w, fit_essvi_batched

    device = torch.device(device)
    n = N_K
    k_row = np.linspace(-1.2, 1.2, n, dtype=np.float32)
    k_dev = torch.from_numpy(np.broadcast_to(k_row, (B, E, n)).copy()).to(device)
    gen_w = _essvi_gen(k_dev)
    seed0 = int(rng.integers(0, 2**31 - 16))

    def fit(k, w):
        return fit_essvi_batched(k, w, max_iters=n_iters)

    inputs = [(k_dev, gen_w(seed0 + i)) for i in range(4)]
    _sync(device)
    dt = _median_time(fit, inputs, device, calls, B)
    res = fit(*inputs[0])
    rmse = float(torch.sqrt(torch.mean((essvi_w(res.params, k_dev) - inputs[0][1]) ** 2)))
    return B / dt, rmse


def _ticks_gen(B, L_ticks, n_minutes, device):
    """Seed -> (minute int32, price, size, valid), each (B, L_ticks): sorted
    uniform minutes, a normal random walk from 100, uniform sizes."""
    def make_inputs(seed):
        k1, k2, k3 = prng.split(prng.key(seed, device), 3)
        minute = torch.sort(prng.randint(k1, (B, L_ticks), 0, n_minutes), dim=-1).values
        price = 100 + torch.cumsum(0.01 * prng.normal(k2, F32, (B, L_ticks)), dim=-1)
        size = prng.uniform(k3, F32, 0.0, 5.0, (B, L_ticks))
        valid = torch.ones((B, L_ticks), dtype=torch.bool, device=device)
        return minute, price, size, valid

    return make_inputs


def bench_streaming(rng, B=1024, L_ticks=4096, n_minutes=512, device="cuda", calls=None):
    """The streaming chain (ticks -> 1-min -> 5-min candles -> surface
    refit) per underlying on precomputed operators. Returns underlyings/s."""
    from iv_interpolation_tpu_torch.ops.spline_matrix import build_surface_operators_batched
    from iv_interpolation_tpu_torch.pipeline.streaming import streaming_step
    from iv_interpolation_tpu_torch.surface.surface import common_support_grid

    device = torch.device(device)
    E_s, n_s, m = 4, 12, 50
    k = torch.linspace(-0.8, 0.8, n_s, dtype=F32, device=device).expand(B, E_s, n_s)
    T = torch.linspace(0.1, 1.0, E_s, dtype=F32, device=device).expand(B, E_s)
    iv = 0.5 + 0.05 * k * k
    # fixed session grids: the operators are set-up, as a session's are
    ops = build_surface_operators_batched(k, common_support_grid(k, m), bc_type="not-a-knot")
    _sync(device)

    make_inputs = _ticks_gen(B, L_ticks, n_minutes, device)

    def step(mi, p, s, v):
        return streaming_step(mi, p, s, v, k, iv, T, n_minutes=n_minutes, n_grid=m,
                              spline_ops=ops)

    seed0 = int(rng.integers(0, 2**31 - 16))
    inputs = [make_inputs(seed0 + i) for i in range(4)]
    _sync(device)
    return B / _median_time(step, inputs, device, calls, B)


def _ah_gen(k, T):
    """Seed -> (B, E, m) quotes on the strikes ``k`` and maturities ``T``:
    a uniform level a surface, a smile, and a 40 % spike at the middle
    strike, which violates butterfly arbitrage."""
    B, m = k.shape[0], k.shape[-1]
    spike = torch.zeros(m, dtype=F32, device=k.device)
    spike[m // 2] = 0.4

    def gen_iv(seed):
        keys = prng.split(prng.key(seed, k.device), 2)
        lvl = prng.uniform(keys[0], F32, 0.18, 0.30, (B, 1, 1))
        iv = lvl + 0.1 * k * k + 0.02 * torch.sqrt(T)[..., None]
        return iv * (1.0 + spike)

    return gen_iv


def bench_ah(rng, B=512, n_iters=16, n_grid=257, device="cuda", calls=None):
    """Andreasen-Huge one-step surfaces on arbitrage-laden quotes (an ATM
    spike): arbitrage-free by construction, which every run checks.
    Returns (surfaces/s, arbitrage-free fraction, largest price rmse)."""
    from iv_interpolation_tpu_torch.ops.andreasen_huge import fit_eval_ah_surface

    device = torch.device(device)
    E_a, m = 8, 16
    k = torch.from_numpy(np.broadcast_to(
        np.linspace(-0.6, 0.6, m, dtype=np.float32), (B, E_a, m)).copy()).to(device)
    T = torch.from_numpy(np.broadcast_to(
        np.linspace(0.08, 1.5, E_a, dtype=np.float32), (B, E_a)).copy()).to(device)
    gen_iv = _ah_gen(k, T)

    def fit(iv):
        return fit_eval_ah_surface(k, iv, T, n_grid=n_grid, n_iters=n_iters)

    seed0 = int(rng.integers(0, 2**31 - 16))
    inputs = [(gen_iv(seed0 + i),) for i in range(4)]
    _sync(device)
    dt = _median_time(fit, inputs, device, calls, B)
    out = fit(*inputs[0])
    frac = float((out["butterfly_ok"] & out["calendar_ok"]).double().mean())
    return B / dt, frac, float(out["fit_rmse"].max())


# ---------------------------------------------------------------------------
# Stage registry: each stage takes (rng, device, calls) and returns the
# result dict the state file keeps and ``_assemble`` reads.

def _device_label(device: torch.device) -> str:
    """The card's name and power limit (``nvidia-smi``), or the device type
    off the card."""
    if device.type != "cuda":
        return device.type
    index = torch.cuda.current_device() if device.index is None else device.index
    try:
        limit = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        limit = "power limit not read"
    return f"{torch.cuda.get_device_name(index)} ({limit})"


def _stage_spline(rng, device, calls):
    sizes = (512,) if SMOKE else (32768, 131072)
    best, best_B, acc = bench_spline(rng, batch_sizes=sizes, device=device, calls=calls)
    return {"value": round(best, 1), "batch": best_B, "device": _device_label(device), **acc}


def _stage_parity(rng, device, calls):
    sps, err = bench_parity(rng, B=512 if SMOKE else 32768, device=device, calls=calls)
    return {"value": round(sps, 1),
            "max_err_vs_x64_oracle": None if err is None else float(f"{err:.3g}")}


def _stage_svi(rng, device, calls):
    sps, rmse = (bench_svi(rng, B=16, n_iters=4, device=device, calls=calls) if SMOKE
                 else bench_svi(rng, device=device, calls=calls))
    return {"value": round(sps, 1), "rmse": round(rmse, 6)}


def _stage_essvi(rng, device, calls):
    sps, rmse = (bench_essvi(rng, B=16, n_iters=4, device=device, calls=calls) if SMOKE
                 else bench_essvi(rng, device=device, calls=calls))
    return {"value": round(sps, 1), "rmse": round(rmse, 6)}


def _stage_streaming(rng, device, calls):
    ups = (bench_streaming(rng, B=8, L_ticks=256, n_minutes=64, device=device, calls=calls)
           if SMOKE else bench_streaming(rng, device=device, calls=calls))
    return {"value": round(ups, 1)}


def _stage_rbf(rng, device, calls):
    sps, frac = (bench_rbf(rng, B=2, N=128, n_iters=2, device=device, calls=calls) if SMOKE
                 else bench_rbf(rng, device=device, calls=calls))
    return {"value": round(sps, 2), "arbfree_frac": frac}


def _stage_rbf_reduced(rng, device, calls):
    """The least-squares reduced basis (512 centers over 2,048 quotes):
    the same hinge repair on (c + p)^3 factorizations; the exact
    every-site-a-center stage stays the scattered-quote headline."""
    sps, frac = (bench_rbf(rng, B=2, N=128, n_iters=2, n_centers=32, device=device,
                           calls=calls) if SMOKE
                 else bench_rbf(rng, B=64, n_centers=512, device=device, calls=calls))
    return {"value": round(sps, 2), "arbfree_frac": frac}


def _stage_ah(rng, device, calls):
    sps, frac, rmse = (bench_ah(rng, B=2, n_iters=2, n_grid=65, device=device, calls=calls)
                       if SMOKE else bench_ah(rng, device=device, calls=calls))
    return {"value": round(sps, 1), "arbfree_frac": frac,
            "price_rmse": float(f"{rmse:.3g}")}


STAGES = (
    ("spline", _stage_spline),
    ("parity", _stage_parity),
    ("svi", _stage_svi),
    ("essvi", _stage_essvi),
    ("streaming", _stage_streaming),
    ("rbf", _stage_rbf),
    ("rbf_reduced", _stage_rbf_reduced),
    ("ah", _stage_ah),
)

_EXTRA_NAMES = {
    "parity": "parity_f64_surfaces_per_sec_fit_eval_30x50",
    "svi": "svi_lm_slices_per_sec_1024x30_quasi32",
    "essvi": "essvi_surfaces_per_sec_1024x30x50_iters32",
    "streaming": "streaming_refit_underlyings_per_sec_1024",
    "rbf": "rbf_arbfree_surfaces_per_sec_8x2048_iters24",
    "rbf_reduced": "rbf_arbfree_reduced_c512_surfaces_per_sec_64x2048_iters24",
    "ah": "ah_surfaces_per_sec_512x8x16_grid257_iters16",
}
_EXTRA_UNITS = {"parity": "surfaces/s",
                "svi": "slices/s", "essvi": "surfaces/s",
                "streaming": "underlyings/s", "rbf": "surfaces/s",
                "rbf_reduced": "surfaces/s", "ah": "surfaces/s"}


def _state_read(path) -> dict:
    try:
        with open(path) as f:
            state = json.load(f)
    except (OSError, ValueError):
        state = {}
    state.setdefault("stages", {})
    state.setdefault("failed", {})
    return state


def _state_write(path, state) -> None:
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(state, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _assemble(state) -> dict | None:
    """The single output line from the completed stages; None without the
    headline."""
    stages = state.get("stages", {})
    sp = stages.get("spline")
    if sp is None:
        return None
    fast = None if sp.get("parity_max_err") is None else float(f"{sp['parity_max_err']:.3g}")
    out = {
        "metric": "surfaces_per_sec_fit_eval_30x50",
        "value": sp["value"],
        "unit": "surfaces/s",
        "vs_baseline": None,
        "batch": sp["batch"],
        "device": sp.get("device", "unknown"),
        # accuracy telemetry pins values and flags on every run: the
        # headline parity is parity mode's (CLI --parity); the fast float32
        # path's own envelope stays visible beside it
        "parity_max_err_vs_x64_oracle": (stages["parity"].get("max_err_vs_x64_oracle")
                                         if "parity" in stages else fast),
        "parity_fast_f32_max_err": fast,
        "butterfly_clean_frac": sp.get("butterfly_clean_frac"),
        "butterfly_adversarial_frac": sp.get("butterfly_adversarial_frac"),
    }
    extras, missing = [], []
    for name, _fn in STAGES[1:]:
        res = stages.get(name)
        if res is None:
            missing.append(_EXTRA_NAMES[name])
            continue
        extra = {"metric": _EXTRA_NAMES[name], "value": res["value"],
                 "unit": _EXTRA_UNITS[name]}
        for key in ("rmse", "arbfree_frac", "price_rmse", "max_err_vs_x64_oracle"):
            if key in res:
                extra[key] = res[key]
        extras.append(extra)
    out["extra_metrics"] = extras
    if missing:
        out["incomplete_metrics"] = missing
    return out


# ---------------------------------------------------------------------------
# The harness

def _launches() -> dict:
    by = tridiag_solve_cuda.launches_by_dtype
    return {"b1_f32": by["float32"], "b1_f64": by["float64"],
            "b2": aggregate_ohlcv_cuda.launches}


def _resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the bench runs on the card and no CUDA device is visible; "
                           "--device cpu runs it on the CPU (the harness's own tests)")
    return device


def run_stages(names, state_path, device, seed: int, stages=STAGES) -> int:
    """The child's loop: run the stages of ``stages`` named in ``names``
    that the state file holds neither as done nor as failed, in order,
    writing each result (or failure) the moment it is known. Returns 0, or
    1 after the first failed stage without running another."""
    device = _resolve_device(str(device))
    cuda = device.type == "cuda"
    if cuda:
        _build.pin_precision()
    state = _state_read(state_path)
    for j, (name, fn) in enumerate(stages):
        if name not in names or name in state["stages"] or name in state["failed"]:
            continue
        state["running"] = name
        _state_write(state_path, state)
        calls: list = []
        before = _launches()
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        try:
            res = fn(np.random.default_rng([seed, j]), device, calls)
            _sync(device)
        except Exception:  # noqa: BLE001 - recorded; the parent goes on in a fresh child
            tb = traceback.format_exc()
            log(f"# stage {name}: FAILED after {time.perf_counter() - t0:.1f} s\n{tb}")
            del state["running"]
            state["failed"][name] = tb[-4000:]
            _state_write(state_path, state)
            return 1
        after = _launches()
        timed = next((c for c in calls if c["batch"] == res.get("batch")), calls[-1])
        res.update(
            seed=[seed, j], seconds=time.perf_counter() - t0, calls=calls,
            host_median_s=timed["host_median_s"], event_median_ms=timed["event_median_ms"],
            peak_bytes=torch.cuda.max_memory_allocated(device) if cuda else None,
            launches={k: after[k] - before[k] for k in after})
        del state["running"]
        state["stages"][name] = res
        _state_write(state_path, state)
        log(f"# stage {name}: done in {res['seconds']:.1f} s: value {res['value']}, host "
            f"median {res['host_median_s'] * 1e3:.3f} ms, event median "
            f"{res['event_median_ms']} ms, peak {res['peak_bytes']} B, launches "
            f"{res['launches']}")
        if cuda:
            torch.cuda.empty_cache()
    return 0


def drive(state_path, names, launch) -> dict:
    """The parent's loop: ``launch(remaining)`` runs one child over the
    stages not yet done or failed and returns its exit code (None when it
    was stopped at its time limit); repeat until none remains. A child
    that ends without finishing the stage it was running, or without
    finishing any, has that stage (or the first it was given) recorded as
    failed, so every round settles at least one stage."""
    while True:
        state = _state_read(state_path)
        remaining = [n for n in names if n not in state["stages"] and n not in state["failed"]]
        if not remaining:
            return state
        rc = launch(remaining)
        state = _state_read(state_path)
        running = state.pop("running", None)
        settled = any(n in state["stages"] or n in state["failed"] for n in remaining)
        if running is not None or not settled:
            stuck = running or remaining[0]
            how = "was stopped at its time limit" if rc is None else f"exited {rc}"
            log(f"# bench: the child {how} during stage {stuck}; recorded as failed")
            state["failed"][stuck] = f"the child {how} during the stage"
            _state_write(state_path, state)


def _parse(argv):
    p = argparse.ArgumentParser(prog="python -m iv_interpolation_tpu_torch.bench")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=None,
                   help="the stages' inputs derive from it (default: from the clock)")
    p.add_argument("--stages", default=",".join(name for name, _ in STAGES),
                   help="comma-separated subset of " + ",".join(n for n, _ in STAGES))
    args = p.parse_args(argv)
    args.stages = args.stages.split(",")
    unknown = set(args.stages) - {name for name, _ in STAGES}
    if unknown:
        p.error(f"unknown stages: {sorted(unknown)}")
    return args


def child_main(args) -> int:
    """One child: the stages the parent names, into the state file."""
    return run_stages(args.stages, os.environ["IVTPU_BENCH_STATE"], args.device, args.seed)


def parent_main(args) -> int:
    """The harness: children until every stage has completed or failed,
    then ONE JSON line on stdout (also on SIGTERM or SIGINT)."""
    device = _resolve_device(args.device)
    seed = time.time_ns() % 2**31 if args.seed is None else args.seed
    named = os.environ.get("IVTPU_BENCH_STATE")
    if named:
        state_path = named
    else:
        fd, state_path = tempfile.mkstemp(prefix="ivtorch_bench_", suffix=".json")
        os.close(fd)
        os.unlink(state_path)
    state = _state_read(state_path)
    state.update(seed=seed, failed={})
    state.pop("running", None)
    _state_write(state_path, state)
    log(f"# bench state file: {state_path}; seed {seed}; device {device}")
    attempt_s = float(os.environ.get("IVTPU_BENCH_ATTEMPT_S", "2700"))
    child: dict = {}

    def emit(signum=None, frame=None):
        proc = child.get("proc")
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
        state = _state_read(state_path)
        out = _assemble(state)
        if out is None:
            log("# bench: no headline measured")
            os._exit(1)
        print(json.dumps(out), flush=True)
        if not named and len(state["stages"]) == len(STAGES):
            os.unlink(state_path)
        os._exit(0)

    signal.signal(signal.SIGTERM, emit)
    signal.signal(signal.SIGINT, emit)

    def launch(remaining):
        env = dict(os.environ, IVTPU_BENCH_ROLE="child", IVTPU_BENCH_STATE=state_path,
                   PYTHONPATH=os.pathsep.join(
                       p for p in (str(_REPO_ROOT), os.environ.get("PYTHONPATH")) if p))
        cmd = [sys.executable, "-m", "iv_interpolation_tpu_torch.bench", "--device",
               str(device), "--seed", str(seed), "--stages", ",".join(remaining)]
        # the child's stdout goes to stderr: stdout carries the line alone
        child["proc"] = proc = subprocess.Popen(cmd, env=env, stdout=2)
        try:
            return proc.wait(timeout=attempt_s)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            return None
        finally:
            child.pop("proc", None)

    state = drive(state_path, args.stages, launch)
    if state["failed"]:
        log(f"# bench: failed stages: {sorted(state['failed'])}")
    emit()


def main(argv=None) -> int:
    args = _parse(argv)
    if os.environ.get("IVTPU_BENCH_ROLE") == "child":
        return child_main(args)
    return parent_main(args)


if __name__ == "__main__":
    sys.exit(main())
