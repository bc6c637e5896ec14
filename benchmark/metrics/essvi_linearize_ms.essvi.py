"""essvi_linearize_ms.essvi: device time a call of the eSSVI block solver's
``iv.essvi.linearize`` spans (the slice Jacobians at the quotes and on the
calendar-penalty grid, the residuals, the gradient and the blocks D and U) over
all its iterations: the device time of the profiled slice launched inside that
span, over the calls in it (ms). None where the program has no such span."""


def read(ctx):
    by_span = ctx.get("spans")
    if by_span is None or not ctx.get("calls") or "iv.essvi.linearize" not in by_span.seconds:
        return None
    return by_span.seconds["iv.essvi.linearize"] * 1e3 / ctx["calls"]
