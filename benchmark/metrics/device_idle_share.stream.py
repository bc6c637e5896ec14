"""device_idle_share.stream: the share of the profiled slice of tick
batches (ingest and refit) in which no kernel or copy ran on the device (%)."""


def read(ctx):
    summary = ctx.get("trace")
    if summary is None or summary.window_s <= 0 or not summary.device_ops:
        return None
    return 100.0 * (1.0 - summary.busy_s / summary.window_s)
