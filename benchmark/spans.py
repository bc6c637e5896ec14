"""Device time by the program's spans, through launch correlation.

The port names the stages of its surface step with spans
(``iv_interpolation_tpu_torch.monitoring.metrics.span``): ``user_annotation``
events on the launching thread, in the same trace as the kernels. In a
closed loop the host runs far ahead of the device, so the span that is
open while a kernel runs says nothing of which stage launched it. Each
kernel, copy or set of the slice carries the correlation id of its launch,
a ``cuda_runtime`` or ``cuda_driver`` event (ATen's launches and B1's
ctypes ``cudaLaunchKernel`` alike); its duration is credited to every
span on that thread that covers the launch.

    python3 -m benchmark.spans --workload <cell> --seeds 1,2,... --seconds 20

runs the cell's own driver traced, once a seed, and prints for each run
the device time a call of every span in the profiled slice.
"""

from __future__ import annotations

import argparse
import dataclasses
import heapq
import json
import sys

import torch

from benchmark import harness, trace
from benchmark.trace import DEVICE_CATS, SLICE

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@dataclasses.dataclass
class DeviceBySpan:
    seconds: dict        # span name -> device seconds launched inside a span of that name
    count: dict          # span name -> spans of that name that start in the slice
    unspanned_s: float   # device seconds launched inside no span of the prefix
    device_s: float      # device seconds of every kernel and copy that starts in the slice


def _base(name: str) -> str:
    """A span's name up to its first ``[``: ``iv.tridiag.b1[staged n=48 ...]``
    groups under ``iv.tridiag.b1``."""
    return name.split("[", 1)[0]


def device_by_span(events: list, prefix: str = "iv.") -> DeviceBySpan:
    """Credit each device event that starts in the slice to the spans
    (names starting with ``prefix``) that cover its launch, inclusively:
    once per span name, even where spans of one name nest."""
    complete = [e for e in events if e.get("ph") == "X" and "dur" in e]
    marks = [e for e in complete if e.get("name") == SLICE and e.get("cat") == "user_annotation"]
    if not marks:
        raise RuntimeError("the trace holds no slice annotation")
    w0 = float(marks[0]["ts"])
    w1 = w0 + float(marks[0]["dur"])
    device = [e for e in complete if e.get("cat") in DEVICE_CATS and w0 <= float(e["ts"]) < w1]
    launches = {e["args"]["correlation"]: e for e in complete
                if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    spans: dict = {}                 # thread -> [(start, end, name)]
    count: dict = {}
    for e in complete:
        if e.get("cat") == "user_annotation" and e["name"].startswith(prefix):
            start, name = float(e["ts"]), _base(e["name"])
            spans.setdefault((e.get("pid"), e.get("tid")), []).append(
                (start, start + float(e["dur"]), name))
            if w0 <= start < w1:
                count[name] = count.get(name, 0) + 1
    by_thread: dict = {}             # thread -> [(launch time, device seconds)]
    unspanned = 0.0
    for e in device:
        launch = launches.get(e.get("args", {}).get("correlation"))
        dur = float(e["dur"]) * 1e-6
        if launch is None:
            unspanned += dur
            continue
        by_thread.setdefault((launch.get("pid"), launch.get("tid")), []).append(
            (float(launch["ts"]), dur))
    seconds: dict = {}
    for thread, items in by_thread.items():
        # sweep the launches in time order; the heap holds the spans begun
        # so far, least end first, so those that ended are on top
        todo, j, open_ = sorted(spans.get(thread, [])), 0, []
        for t, dur in sorted(items):
            while j < len(todo) and todo[j][0] <= t:
                heapq.heappush(open_, (todo[j][1], todo[j][2]))
                j += 1
            while open_ and open_[0][0] < t:
                heapq.heappop(open_)
            names = {name for _, name in open_}
            for name in names:
                seconds[name] = seconds.get(name, 0.0) + dur
            if not names:
                unspanned += dur
    return DeviceBySpan(seconds=seconds, count=count, unspanned_s=unspanned,
                        device_s=sum(float(e["dur"]) for e in device) * 1e-6)


def traced_run(cell, seed: int, seconds: float, device):
    """A traced run of the cell's own driver, and the device time by span
    of its profiled slice: the slice's events are caught on their way into
    ``trace.summarize``, which reduces them for the run as it always does."""
    caught = []
    with trace.recording(trace, "summarize", lambda args, kwargs, result: caught.append(args[0])):
        run = cell.module("driver").run(cell, seed, seconds, True, device)
    return run, device_by_span(caught[-1])


def per_call(by_span: DeviceBySpan, calls: int) -> dict:
    """The slice's reading a call: device ms and count of each span, the
    device ms of all work, and the share launched inside no span (%)."""
    return {"stage_ms": {name: s * 1e3 / calls for name, s in sorted(by_span.seconds.items())},
            "spans_per_call": {name: n / calls for name, n in sorted(by_span.count.items())},
            "device_ms": by_span.device_s * 1e3 / calls,
            "unspanned_share": (100.0 * by_span.unspanned_s / by_span.device_s
                                if by_span.device_s > 0 else None)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("device time by span needs a CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        run, by_span = traced_run(cell, seed, args.seconds, "cuda")
        ctx = run.ctx
        print(json.dumps({"workload": cell.name, "seed": seed, "calls": ctx["calls"],
                          **per_call(by_span, ctx["calls"]),
                          "launches_per_call": len(ctx["trace"].kernels) / ctx["calls"]}),
              flush=True)
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
