"""refit_device_ms.stream: device time of one ``StreamingSession.refit``
(ms), from CUDA events recorded on the stream before and after each refit
of the window's batches outside the profiled slice, total over count."""


def read(ctx):
    times = ctx.get("refit_device_ms")
    if not times:
        return None
    return sum(times) / len(times)
