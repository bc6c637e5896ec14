"""device_ms_per_batch.surface: device time of one surface call, the sum
of the durations of every kernel and copy in the profiled slice over the
calls in it (ms)."""


def read(ctx):
    summary = ctx.get("trace")
    if summary is None or not ctx.get("calls") or not summary.device_ops:
        return None
    return sum(summary.device_ops.values()) * 1e3 / ctx["calls"]
