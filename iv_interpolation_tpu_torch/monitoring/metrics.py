"""Step metrics: wall-clock spans, rows per second, device memory and a
profiler trace (port of ``iv_interpolation_tpu/monitoring/metrics.py``).

The device memory comes from PyTorch's CUDA caching allocator instead of
``jax``; JSON snapshots keep the JAX package's layout; the trace is a
``torch.profiler`` trace instead of ``jax.profiler``'s.
"""

from __future__ import annotations

import json
import os
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch


def device_memory_stats() -> dict:
    """Card 0's memory from the caching allocator: bytes in use, the peak
    since the last ``reset_peak_memory_stats`` and the card's total. Empty
    without CUDA, or before anything touched the card (reading the
    counters would otherwise initialise it)."""
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return {}
    stats = torch.cuda.memory_stats(0)
    return {
        "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
        "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
        "bytes_limit": torch.cuda.get_device_properties(0).total_memory,
    }


def host_memory_stats() -> dict:
    try:
        import psutil
        vm = psutil.virtual_memory()
        return {"host_used_pct": vm.percent,
                "host_available_gb": vm.available / 2**30}
    except Exception:
        return {}


@dataclass
class StepMetrics:
    """Accumulates per-step timings and emits snapshots."""

    snapshot_dir: Optional[str] = None
    steps: List[dict] = field(default_factory=list)

    @contextmanager
    def step(self, name: str, items: int = 0):
        """Bracket a device computation; the caller must wait for the
        device inside (or the span is the enqueue only)."""
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        rec = {
            "name": name,
            "wall_s": dt,
            "items": items,
            "items_per_s": items / dt if dt > 0 and items else None,
            "ts": time.time(),
        }
        rec.update(device_memory_stats())
        self.steps.append(rec)

    def summary(self) -> Dict[str, dict]:
        out: Dict[str, dict] = {}
        for rec in self.steps:
            s = out.setdefault(rec["name"], {"wall_s": 0.0, "items": 0,
                                             "count": 0})
            s["wall_s"] += rec["wall_s"]
            s["items"] += rec["items"]
            s["count"] += 1
        for s in out.values():
            s["items_per_s"] = s["items"] / s["wall_s"] if s["wall_s"] else 0.0
        return out

    def snapshot(self, tag: str) -> Optional[str]:
        """Persist a JSON snapshot ``metrics_<tag>.json``."""
        if not self.snapshot_dir:
            return None
        os.makedirs(self.snapshot_dir, exist_ok=True)
        path = os.path.join(self.snapshot_dir, f"metrics_{tag}.json")
        payload = {
            "tag": tag,
            "ts": time.time(),
            "summary": self.summary(),
            "device": device_memory_stats(),
            "host": host_memory_stats(),
        }
        with open(path, "w") as f:
            json.dump(payload, f, indent=2)
        return path


@contextmanager
def profile_trace(profiler_dir: Optional[str]):
    """A ``torch.profiler`` trace of the host and, where a card is
    visible, its kernels around a region, written as a Chrome trace
    (``trace_<pid>_<ms>.json``) into ``profiler_dir``; no-op without a
    directory."""
    if not profiler_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profiler_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        profiler_dir, f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json"))
