"""Driver ``open_loop_stream``: tick batches arrive on a fixed schedule,
one market minute a batch, whether or not the service has caught up; each
is ingested and followed by one refit of every underlying, which ends in
a synchronise.

The service is the port's ``pipeline.stream_service.StreamingSession``
(``ingest_ticks`` then ``refit(now_minute)``). Set-up fills its ring with
the window's history in one ingest and warms the path on a few batches.
Reports ``refit_p95_ms``: the 95th percentile, over every batch due in the
window, of the time from the batch's due time to the synchronise after
its refit (queue wait and the generator's lateness included; a batch
never refitted counts as missing and takes the time to the run's end).

Traffic keys: ``rate`` (batches/s; optional ``burst_factor``,
``burst_every_s``, ``burst_s``), ``warm_batches``, ``sample_batches``
(refits compared, drawn from the seed), ``trace_batches``, ``minute0``
(the epoch minute of the first market minute), and the tick and chain
generator's parameters (``benchmark.generators``).
"""

from __future__ import annotations

import math
import time
import types

import numpy as np
import torch

from benchmark import compare, generators, harness, trace
from benchmark.harness import STARTED, Run, Sample
from benchmark.reference import spline
from benchmark.reference import stream as reference
from benchmark.roofline import b2_bytes

def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _batches(ticks: dict, first: int, last: int, names: np.ndarray, minute0: int):
    """The ingest columns of market minutes first..last-1, one dict each,
    with absolute minutes and underlying names as a client sends them, and
    the index of each minute's first tick (one more at the end)."""
    bounds = np.searchsorted(ticks["batch"], np.arange(first, last + 1))
    out = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        out.append({"underlying": names[ticks["underlying"][lo:hi]],
                    "minute": ticks["minute"][lo:hi].astype(np.int64) + minute0,
                    "price": ticks["price"][lo:hi], "size": ticks["size"][lo:hi]})
    return out, bounds


def _wait_until(when: float) -> None:
    """Sleep until 2 ms before ``when``, then spin: a batch is handed over
    within microseconds of its due time (a plain sleep overshoots by about
    half a millisecond, and by more on a busy host)."""
    left = when - time.perf_counter()
    if left > 0.002:
        time.sleep(left - 0.002)
    while time.perf_counter() < when:
        pass


def _keep(out) -> dict:
    copy = lambda c: type(c)(*(getattr(c, name).clone() for name in c._fields))
    return {"candles_1m": copy(out.candles_1m), "candles_5m": copy(out.candles_5m),
            "realized_vol": out.realized_vol.clone(), "w_grid": out.w_grid.clone(),
            "iv_grid": out.iv_grid.clone(), "butterfly_ok": out.butterfly_ok.clone(),
            "calendar_ok": out.calendar_ok.clone()}


def run(cell, seed: int, seconds: float, traced: bool, device, control: bool = False) -> Run:
    from iv_interpolation_tpu_torch.pipeline import streaming
    from iv_interpolation_tpu_torch.pipeline.stream_service import StreamingSession

    cfg, traffic = cell.config, cell.traffic
    U, W = cfg["underlyings"], cfg["window_minutes"]
    n_due = math.ceil(seconds * traffic["rate"])
    warm = traffic["warm_batches"]
    minutes = W + warm + n_due
    chain = generators.chains(seed, U, cfg["expiries"], cfg["strikes"], traffic, device)
    ticks = generators.tick_stream(seed, U, minutes, traffic, device)
    names = np.asarray([f"u{r:05d}" for r in range(U)])
    minute0 = int(traffic["minute0"])
    history, _ = _batches(ticks, 0, W, names, minute0)
    history = {key: np.concatenate([b[key] for b in history]) for key in history[0]}
    batches, bounds = _batches(ticks, W, minutes, names, minute0)
    session = StreamingSession(list(names), chain["k"], chain["iv"], chain["T"],
                               window_minutes=W, tick_capacity=cfg["tick_capacity"],
                               n_grid=cfg["n_grid"], spline_bc=cfg["spline_bc"], device=device)
    session.ingest_ticks(history)
    for j in range(warm):
        session.ingest_ticks(batches[j])
        session.refit(now_minute=minute0 + W + j)
        _sync(device)
    if traced:
        trace.warm_up(device)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    harness.quiet_collector()
    setup_s = time.perf_counter() - STARTED

    due = generators.schedule(n_due, traffic)
    sample = Sample(traffic["sample_batches"], seed)
    done = np.full(n_due, np.nan)
    started = np.full(n_due, np.nan)
    ingest_s = np.full(n_due, np.nan)
    refit_ms = []
    slice_lo = n_due // 3 if traced else n_due
    slice_hi = slice_lo + traffic["trace_batches"] if traced else n_due
    ctx: dict = {}
    b2 = []
    hard_stop = 3 * seconds + 30

    def one(i: int, timed_events: bool, kept_here: bool = True) -> None:
        j = warm + i
        with torch.profiler.record_function("bench.ingest"):
            t = time.perf_counter()
            session.ingest_ticks(batches[j])
            ingest_s[i] = time.perf_counter() - t
        with torch.profiler.record_function("bench.refit"):
            if timed_events:
                ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                ev[0].record()
            out = session.refit(now_minute=minute0 + W + j)
            if timed_events:
                ev[1].record()
            _sync(device)
        if timed_events:
            refit_ms.append(ev)
        # one refit kept for each residue of the batch index
        if kept_here and sample.wants(i % sample.size):
            sample.items[i % sample.size] = (j, _keep(out))

    t0 = time.perf_counter()
    i = 0
    while i < n_due:
        if traced and i == slice_lo:
            def slice_batches():
                for k in range(slice_lo, min(slice_hi, n_due)):
                    _wait_until(t0 + due[k])
                    started[k] = time.perf_counter()
                    one(k, False, kept_here=False)
                    done[k] = time.perf_counter()
                    # the batch's B2 bytes, counted once its refit has
                    # synchronised, so the slice holds no tensor of it
                    ctx["b2_bytes"] += [b2_bytes(args, got) for args, got in b2]
                    b2.clear()

            def record_b2(args, kwargs, got):
                # the valid mask and the result; the other inputs only by
                # address and width
                b2.append((tuple(_Stub(a) for a in args[:6]) + (args[6],), got))

            ctx["b2_bytes"] = []
            with trace.recording(streaming, "aggregate_ohlcv_cuda", record_b2):
                ctx["trace"] = trace.profile(slice_batches)
            i = min(slice_hi, n_due)
            continue
        if time.perf_counter() - t0 > hard_stop:
            break
        _wait_until(t0 + due[i])
        started[i] = time.perf_counter()
        one(i, traced and torch.device(device).type == "cuda")
        done[i] = time.perf_counter()
        i += 1
    end = time.perf_counter()
    peak = torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0

    missing = int(np.isnan(done).sum())
    latency = latencies(t0 + due, done, end)
    p95 = percentile(latency, 95)
    # how late the generator handed a batch over when the service was idle
    free = np.r_[True, done[:-1] <= t0 + due[1:]] & ~np.isnan(started)
    lateness = (started - (t0 + due))[free]
    backlog = [int(np.searchsorted(due, s - t0, side="right")) - k
               for k, s in enumerate(started) if not np.isnan(s)]
    outside = np.r_[0:slice_lo, slice_hi:n_due] if traced else np.arange(n_due)
    if traced:
        ctx.update(calls=min(slice_hi, n_due) - slice_lo,
                   ingest_s=[float(x) for x in ingest_s[outside] if not np.isnan(x)],
                   refit_device_ms=[a.elapsed_time(b) for a, b in refit_ms])
    kept = sample.kept()
    if control:
        # the control in the program's place: the reference computed in
        # TF32 (the step below the float32 the configuration states)
        kept = [(j, _control(ticks, bounds, W, j, chain, cfg)) for j, _ in kept]
    state = {"ticks": ticks, "bounds": bounds, "chain": chain, "cfg": cfg, "W": W}
    del session
    return Run(setup_s=setup_s, e2e={"refit_p95_ms": p95 * 1e3}, attempted=n_due,
               failed=missing, memory_peak_bytes=int(peak), ctx=ctx, kept=kept, state=state,
               notes={"batches_due": n_due, "missing": missing,
                      "ticks_per_batch": float(np.diff(bounds).mean()),
                      "latency_p50_ms": float(np.median(latency) * 1e3),
                      "latency_p50_ms_by_quarter": [float(np.median(q) * 1e3) for q in
                                                    np.array_split(latency, 4)],
                      "completed_per_s": (n_due - missing) / (end - t0),
                      "generator_late_ms_max": float(lateness.max() * 1e3) if len(lateness) else 0.0,
                      "generator_late_ms_mean": float(lateness.mean() * 1e3) if len(lateness) else 0.0,
                      "backlog_max": max(backlog, default=0),
                      "service_ms_max": float(np.nanmax(done - started) * 1e3),
                      "slowest": [[int(k), float((done - started)[k] * 1e3),
                                   float(ingest_s[k] * 1e3)]
                                  for k in np.argsort(-np.nan_to_num(done - started))[:5]],
                      "refits_compared": sorted(j for j, _ in kept)})


def _control(ticks, bounds, W, j, chain, cfg) -> dict:
    out = reference.refit(ticks, int(bounds[j + 1]), W + j, chain, cfg, spline.tf32)
    as_candles = lambda c: types.SimpleNamespace(**{k: torch.as_tensor(v) for k, v in c.items()})
    return {"candles_1m": as_candles(out["candles_1m"]), "candles_5m": as_candles(out["candles_5m"]),
            "realized_vol": torch.as_tensor(out["realized_vol"]), "w_grid": out["w_grid"],
            "iv_grid": out["iv_grid"], "butterfly_ok": out["butterfly_margin"] >= 0,
            "calendar_ok": out["calendar_margin"] >= 0}


def latencies(due: np.ndarray, done: np.ndarray, end: float) -> np.ndarray:
    """Seconds from each batch's due time to the synchronise after its
    refit; a batch never refitted (NaN) counts until ``end``."""
    return np.where(np.isnan(done), end, done) - due


def percentile(values: np.ndarray, q: float) -> float:
    """The nearest-rank ``q``-th percentile of all values: the smallest
    value with at least q % of them at or below it."""
    ordered = np.sort(values)
    return float(ordered[max(0, math.ceil(q / 100.0 * len(ordered)) - 1)])


class _Stub:
    """A tensor's address and element width, all ``b2_bytes`` reads of
    the inputs it does not sum."""

    def __init__(self, t: torch.Tensor):
        self.ptr, self.width = t.data_ptr(), t.element_size()

    def data_ptr(self) -> int:
        return self.ptr

    def element_size(self) -> int:
        return self.width


def judge(cell, run: Run) -> dict:
    """The compared numbers over every kept refit, against the reference
    worked out from the raw ticks up to that batch."""
    st, limits = run.state, cell.limits
    numbers: dict = {}
    for j, got in run.kept:
        upto = int(st["bounds"][j + 1])
        ref = reference.refit(st["ticks"], upto, st["W"] + j, st["chain"], st["cfg"])
        compare.merge(numbers, compare.candle_numbers(got["candles_1m"], ref["candles_1m"]))
        part = compare.candle_numbers(got["candles_5m"], ref["candles_5m"])
        compare.merge(numbers, {"candle_mismatches": part["candle_mismatches"],
                                "volume_rel_gap": part["volume_rel_gap"]})
        compare.merge(numbers, {"rv_gap": compare.median_scaled_gap(got["realized_vol"],
                                                                    ref["realized_vol"])})
        compare.merge(numbers, compare.surface_numbers(got, ref, limits["flag_band_g"],
                                                       limits["flag_band_w"]))
    return numbers
