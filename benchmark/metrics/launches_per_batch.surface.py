"""launches_per_batch.surface: kernel launches of one surface call, the
kernels in the profiled slice over the calls in it (a count that repeats
exactly from run to run while the program is unchanged)."""


def read(ctx):
    summary = ctx.get("trace")
    if summary is None or not ctx.get("calls") or not summary.kernels:
        return None
    return len(summary.kernels) / ctx["calls"]
