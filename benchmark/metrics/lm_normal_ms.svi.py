"""lm_normal_ms.svi: device time a call of the batched Levenberg-Marquardt's
gradient, J^T J and damping (``iv.lm.normal``) over all its iterations: the
device time of the profiled slice launched inside that span, over the calls
in it (ms). None where the program has no such span."""


def read(ctx):
    by_span = ctx.get("spans")
    if by_span is None or not ctx.get("calls") or "iv.lm.normal" not in by_span.seconds:
        return None
    return by_span.seconds["iv.lm.normal"] * 1e3 / ctx["calls"]
