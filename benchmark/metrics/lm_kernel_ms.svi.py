"""lm_kernel_ms.svi: device time a call of the raw-SVI calibration kernel
(``iv.svi.lm``, one launch that runs every Levenberg-Marquardt iteration of
every slice): the device time of the profiled slice launched inside that
span, over the calls in it (ms). None where the program has no such span."""


def read(ctx):
    by_span = ctx.get("spans")
    if by_span is None or not ctx.get("calls") or "iv.svi.lm" not in by_span.seconds:
        return None
    return by_span.seconds["iv.svi.lm"] * 1e3 / ctx["calls"]
