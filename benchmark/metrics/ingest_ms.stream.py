"""ingest_ms.stream: host time of ``StreamingSession.ingest_ticks`` a
tick batch (ms), the harness's clock around each call over the window's
batches outside the profiled slice, total over count."""


def read(ctx):
    times = ctx.get("ingest_s")
    if not times:
        return None
    return sum(times) * 1e3 / len(times)
