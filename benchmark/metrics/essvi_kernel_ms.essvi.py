"""essvi_kernel_ms.essvi: device time a call of the joint eSSVI calibration
kernel (``iv.essvi.lm``, one launch that runs every Levenberg-Marquardt
iteration of every surface): the device time of the profiled slice launched
inside that span, over the calls in it (ms). None where the program has no
such span."""


def read(ctx):
    by_span = ctx.get("spans")
    if by_span is None or not ctx.get("calls") or "iv.essvi.lm" not in by_span.seconds:
        return None
    return by_span.seconds["iv.essvi.lm"] * 1e3 / ctx["calls"]
