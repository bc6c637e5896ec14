"""lm_solve_ms.svi: device time a call of the batched Levenberg-Marquardt's 5 x
5 Cholesky solves (``iv.lm.solve``) over all its iterations: the device time
of the profiled slice launched inside that span, over the calls in it (ms).
None where the program has no such span."""


def read(ctx):
    by_span = ctx.get("spans")
    if by_span is None or not ctx.get("calls") or "iv.lm.solve" not in by_span.seconds:
        return None
    return by_span.seconds["iv.lm.solve"] * 1e3 / ctx["calls"]
