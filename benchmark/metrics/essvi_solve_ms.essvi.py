"""essvi_solve_ms.essvi: device time a call of the eSSVI block solver's
``iv.essvi.solve`` spans (the damping, the block Thomas loop over the expiries
and the pullback of the step to the unconstrained parameters) over all its
iterations: the device time of the profiled slice launched inside that span,
over the calls in it (ms). None where the program has no such span."""


def read(ctx):
    by_span = ctx.get("spans")
    if by_span is None or not ctx.get("calls") or "iv.essvi.solve" not in by_span.seconds:
        return None
    return by_span.seconds["iv.essvi.solve"] * 1e3 / ctx["calls"]
