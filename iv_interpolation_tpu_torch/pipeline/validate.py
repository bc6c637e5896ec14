"""Readiness validation and processing estimates (port of
``iv_interpolation_tpu/pipeline/validate.py``).

The reference's gates (RAM, cores, tables, row census, a time estimate)
recast for one card: the device check reads ``torch.cuda`` (or reports
the CPU when the run is asked to use it), and the throughput model is
measured from a timed calibration microbatch of ``tasks.interpolate_batch``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from iv_interpolation_tpu_torch.pipeline import storage as st

_TASK_INPUTS = {
    "interpolation": [st.TICKERS],
    "bridge": [st.INTERPOLATED],
    "candles": [st.MINUTE_CANDLES],
    "both": [st.TICKERS],
    "pipeline": [st.TICKERS],
    "all": [st.TICKERS],
    "surface": [st.INTERPOLATED],
}


def _device_checks(device: torch.device) -> dict:
    """The run's device: its platform, count, name and memory. A CUDA
    runtime that fails to start reports not-ready with its error."""
    if device.type == "cpu":
        return {"device": {"ok": True, "platform": "cpu", "count": 1, "kind": "cpu"},
                "device_memory": {"ok": True, "hbm_gb": None}}
    try:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        kind = torch.cuda.get_device_name(device) if count else None
        total = torch.cuda.get_device_properties(device).total_memory if count else None
    except (RuntimeError, AssertionError) as e:  # the runtime's own failure is the finding
        return {"device": {"ok": False, "platform": None, "count": 0,
                           "error": f"{type(e).__name__}: {e}"},
                "device_memory": {"ok": True, "hbm_gb": None}}
    return {"device": {"ok": count > 0, "platform": "gpu" if count else None,
                       "count": count, "kind": kind},
            "device_memory": {"ok": True,
                              "hbm_gb": None if total is None else round(total / 2**30, 1)}}


def validate_readiness(config, store, task: str = "all",
                       device: torch.device | str = "cuda") -> dict:
    """Environment and data readiness: ``ready`` and per-check details
    (the JAX package's keys; the device check names the card)."""
    checks = _device_checks(torch.device(device))
    # host-resource gates are advisory: the device does the work
    try:
        import psutil
        ram_gb = psutil.virtual_memory().total / 2**30
        cores = psutil.cpu_count()
        checks["host_ram"] = {"ok": True, "warn": ram_gb < 4, "ram_gb": round(ram_gb, 1)}
        checks["host_cores"] = {"ok": True, "warn": cores < 2, "cores": cores}
    except ImportError:
        checks["host_ram"] = {"ok": True, "ram_gb": None}
        checks["host_cores"] = {"ok": True, "cores": None}

    for table in _TASK_INPUTS.get(task, [st.TICKERS]):
        rows = store.count(table)
        n_sym = len(store.list_symbols(table)) if rows else 0
        checks[f"table_{table}"] = {"ok": rows > 0, "rows": rows, "symbols": n_sym}

    return {"ready": all(c["ok"] for c in checks.values()), "task": task, "checks": checks}


def estimate_processing(config, store, device: torch.device | str = "cuda") -> dict:
    """Estimate the wall time of a full task-1 run from a timed
    calibration microbatch of ``tasks.interpolate_batch`` on ``device``:
    one warm-up call, then one call on fresh inputs, timed by CUDA events
    on the card (the host clock around the call on the CPU)."""
    from iv_interpolation_tpu_torch.pipeline import tasks

    device = torch.device(device)
    n_rows = store.count(st.TICKERS)
    n_sym = len(store.list_symbols(st.TICKERS)) if n_rows else 0
    B, C, L = 8, 8, 256

    def make_args(seed):
        vals = np.random.default_rng(seed).normal(size=(B, C, L)).astype(np.float32)
        vals[:, :, 1::3] = np.nan
        put = lambda a: torch.as_tensor(a, device=device)
        ones = torch.ones((B, L), dtype=torch.bool, device=device)
        return (put(vals), ones, ones, torch.ones((B,), device=device),
                torch.zeros((B,), dtype=torch.bool, device=device))

    tasks.interpolate_batch(*make_args(0))
    args = make_args(1)                    # fresh content, same shapes
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        tasks.interpolate_batch(*args)
        end.record()
        end.synchronize()
        dt = start.elapsed_time(end) / 1e3
    else:
        t0 = time.perf_counter()
        tasks.interpolate_batch(*args)
        dt = time.perf_counter() - t0
    grid_points_per_s = (B * L) / max(dt, 1e-9)

    expansion = 60  # hourly -> 1-min rows
    est_output_rows = n_rows * expansion
    # host pack/unpack dominates a real run: the reference's 1.5x factor
    est_total_s = est_output_rows / max(grid_points_per_s, 1.0) * 1.5
    return {
        "input_rows": n_rows,
        "symbols": n_sym,
        "estimated_output_rows": est_output_rows,
        "measured_grid_points_per_s": round(grid_points_per_s),
        "estimated_seconds": round(est_total_s, 2),
        "estimated_minutes": round(est_total_s / 60, 2),
    }
