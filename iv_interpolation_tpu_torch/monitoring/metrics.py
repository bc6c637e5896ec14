"""Step metrics: wall-clock spans, rows per second, device memory, a
profiler trace and the program's named spans in it (port of
``iv_interpolation_tpu/monitoring/metrics.py``).

The device memory comes from PyTorch's CUDA caching allocator instead of
``jax``; JSON snapshots keep the JAX package's layout; the trace is a
``torch.profiler`` trace instead of ``jax.profiler``'s.
"""

from __future__ import annotations

import json
import os
import sys
import time
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from typing import Dict, List, Optional


def device_memory_stats(rank_peak_bytes: Optional[List[int]] = None) -> dict:
    """The current card's memory from the caching allocator (a rank's own
    card under a mesh): bytes in use, the peak since the last
    ``reset_peak_memory_stats`` and the card's total. Empty without CUDA,
    or before anything touched the card (reading the counters would
    otherwise initialise it). ``rank_peak_bytes``, every rank's peak that
    the runner gathered, adds the mesh's total and the list, as the JAX
    package sums its mesh's devices. The module does not import torch: a
    process that never did (the monitor's) has touched no card."""
    out: dict = {}
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_available() and torch.cuda.is_initialized():
        dev = torch.cuda.current_device()
        stats = torch.cuda.memory_stats(dev)
        out = {
            "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.get_device_properties(dev).total_memory,
        }
    if rank_peak_bytes:
        out["all_ranks_peak_bytes_in_use"] = int(sum(rank_peak_bytes))
        out["rank_peak_bytes_in_use"] = list(rank_peak_bytes)
    return out


def host_memory_stats() -> dict:
    try:
        import psutil
        vm = psutil.virtual_memory()
        return {"host_used_pct": vm.percent,
                "host_available_gb": vm.available / 2**30}
    except Exception:
        return {}


def host_system_census() -> dict:
    """Full host census: per-core CPU, disk usage + IO counters, network
    counters, process RSS (the reference monitor's system snapshot), via
    psutil when it imports; empty without it."""
    try:
        import psutil
    except Exception:
        return {}
    out: dict = {}

    def probe(name, fn):
        # per-probe guard: one unavailable counter (containers often
        # lack net/disk IO counters) must not discard the whole census
        try:
            out[name] = fn()
        except Exception:
            out[name] = None

    probe("cpu_percent_per_core", lambda: psutil.cpu_percent(percpu=True))
    probe("cpu_percent", psutil.cpu_percent)
    probe("load_avg", lambda: list(os.getloadavg()))
    probe("disk_used_pct", lambda: psutil.disk_usage("/").percent)
    probe("disk_free_gb", lambda: psutil.disk_usage("/").free / 2**30)
    probe("disk_read_mb",
          lambda: psutil.disk_io_counters().read_bytes / 2**20)
    probe("disk_write_mb",
          lambda: psutil.disk_io_counters().write_bytes / 2**20)
    probe("net_sent_mb",
          lambda: psutil.net_io_counters().bytes_sent / 2**20)
    probe("net_recv_mb",
          lambda: psutil.net_io_counters().bytes_recv / 2**20)
    probe("process_rss_gb",
          lambda: psutil.Process(os.getpid()).memory_info().rss / 2**30)
    return out


@dataclass
class StepMetrics:
    """Accumulates per-step timings and emits snapshots."""

    snapshot_dir: Optional[str] = None
    steps: List[dict] = field(default_factory=list)
    #: every rank's peak device bytes, set by the runner under a mesh
    rank_peak_bytes: Optional[List[int]] = None

    @contextmanager
    def step(self, name: str, items: int = 0):
        """Bracket a device computation on the host clock, and open
        :func:`span` ``name`` around it (the step in a profiler trace).
        ``wall_s`` holds the wait for the device only where the block
        waits: the runner's steps end in a host readback, so theirs do
        (in the fused loop the batch was dispatched before its step, which
        then holds the wait, the readback and the unpack)."""
        t0 = time.perf_counter()
        with span(name):
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
            "device": device_memory_stats(self.rank_peak_bytes),
            "host": host_memory_stats(),
        }
        with open(path, "w") as f:
            json.dump(payload, f, indent=2)
        return path


_NO_SPAN = nullcontext()


def span(name: str):
    """A named span of the program in the profiler's trace.

    While a ``torch.profiler`` profile records, this is
    ``torch.profiler.record_function(name)``: a ``user_annotation`` event
    on the calling thread, on the clock of the trace's kernels, which a
    reader joins to the kernels launched inside it through their launch
    correlation. Otherwise it is one shared no-op context, so an
    unprofiled call pays a flag check where an unconditional
    ``record_function`` would pay microseconds a span. Names are
    ``iv.<layer>.<stage>``; a ``[...]`` suffix carries the call's shapes
    and groups under the name before it. Torch is looked up, not
    imported: a process that never imported it records nothing.
    """
    torch = sys.modules.get("torch")
    if torch is None or not torch.autograd.profiler._is_profiler_enabled:
        return _NO_SPAN
    return torch.profiler.record_function(name)


@contextmanager
def profile_trace(profiler_dir: Optional[str]):
    """A ``torch.profiler`` trace of the host and, where a card is
    visible, its kernels around a region, written as a Chrome trace
    (``trace_<pid>_<ms>.json``) into ``profiler_dir``; no-op without a
    directory."""
    if not profiler_dir:
        yield
        return
    import torch
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
