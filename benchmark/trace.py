"""The traced run's reduction: ``torch.profiler`` over a steady slice of
the window, reduced to device busy time, kernel time by name, launches,
and the idle gaps labelled by what the host was doing.

The trace is written under ``TMPDIR`` as Chrome JSON, read back and
deleted; nothing else is kept on disk.
"""

from __future__ import annotations

import contextlib
import dataclasses
import heapq
import json
import os
import tempfile

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")
SLICE = "bench.slice"


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    kernels: list          # (name, start_us, dur_us) of every kernel launch in the slice
    device_ops: dict       # name -> seconds, kernels and copies
    idle_gaps: dict        # host activity -> seconds the device sat idle

    def kernel_time_s(self, part: str) -> tuple[float, int]:
        """Seconds and launches of the kernels whose name holds ``part``."""
        hits = [dur for name, _, dur in self.kernels if part in name]
        return sum(hits) * 1e-6, len(hits)

    def breakdown(self, top: int = 10) -> dict:
        order = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[name[:160], s] for name, s in order(self.device_ops)],
                "idle_gaps": [[name[:160], s] for name, s in order(self.idle_gaps)]}


def warm_up(device) -> None:
    """Start the profiler once on a tiny op, so the slice does not pay for
    its first start."""
    x = torch.ones(8, device=device)
    with torch.profiler.profile(activities=_activities()):
        (x + 1).sum().item()


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def profile(fn) -> Summary:
    """Run ``fn`` under the profiler in one annotated slice that ends in a
    synchronise, and reduce the trace."""
    with torch.profiler.profile(activities=_activities()) as prof:
        with torch.profiler.record_function(SLICE):
            fn()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.remove(path)
    return summarize(events["traceEvents"] if isinstance(events, dict) else events)


def _union(spans):
    """Merged [start, end) intervals of sorted spans."""
    merged = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _innermost(points, spans):
    """For each point (ascending), the name of the latest-started span that
    covers it (the innermost of nested spans), or None."""
    spans = sorted(spans)
    out, heap, j = [], [], 0
    for p in points:
        while j < len(spans) and spans[j][0] <= p:
            start, end, name = spans[j]
            heapq.heappush(heap, (-start, end, name))
            j += 1
        while heap and heap[0][1] < p:
            heapq.heappop(heap)
        out.append(heap[0][2] if heap else None)
    return out


def summarize(events: list) -> Summary:
    """Reduce Chrome trace events to the slice's :class:`Summary`."""
    complete = [e for e in events if e.get("ph") == "X" and "dur" in e]
    marks = [e for e in complete if e.get("name") == SLICE and e.get("cat") == "user_annotation"]
    if not marks:
        raise RuntimeError("the trace holds no slice annotation")
    w0 = float(marks[0]["ts"])
    w1 = w0 + float(marks[0]["dur"])
    device = [e for e in complete if e.get("cat") in DEVICE_CATS
              and w0 <= float(e["ts"]) < w1]
    spans = [(float(e["ts"]), min(float(e["ts"]) + float(e["dur"]), w1)) for e in device]
    busy = _union(spans)
    busy_us = sum(b - a for a, b in busy)
    ops: dict = {}
    for e in device:
        ops[e["name"]] = ops.get(e["name"], 0.0) + float(e["dur"]) * 1e-6
    kernels = [(e["name"], float(e["ts"]), float(e["dur"])) for e in device
               if e.get("cat") == "kernel"]
    # the idle gaps: the slice less the union of device work
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w1 > t:
        gaps.append((t, w1))
    host = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in complete
            if e.get("cat") in HOST_CATS and e["name"] != SLICE]
    harness = [s for s in host if s[2].startswith("bench.")]
    mids = [(a + b) / 2 for a, b in gaps]
    inner = _innermost(mids, host)
    outer = _innermost(mids, harness)
    idle: dict = {}
    for (a, b), o, i in zip(gaps, outer, inner):
        label = f"{o or 'bench.slice'}/{i or 'none'}"
        idle[label] = idle.get(label, 0.0) + (b - a) * 1e-6
    return Summary(window_s=(w1 - w0) * 1e-6, busy_s=busy_us * 1e-6, kernels=kernels,
                   device_ops=ops, idle_gaps=idle)


@contextlib.contextmanager
def recording(module, name: str, record):
    """Within the block, calls of ``module.<name>`` also hand their
    arguments and result to ``record(args, kwargs, result)``; the
    function's own attributes (launch counters) stay where they are."""
    fn = getattr(module, name)

    def wrapper(*args, **kwargs):
        result = fn(*args, **kwargs)
        record(args, kwargs, result)
        return result

    setattr(module, name, wrapper)
    try:
        yield
    finally:
        setattr(module, name, fn)
