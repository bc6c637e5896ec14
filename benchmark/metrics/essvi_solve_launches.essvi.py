"""essvi_solve_launches.essvi: kernel launches a call inside the eSSVI block
solver's ``iv.essvi.solve`` spans (the block Thomas loop over the expiries
and the pullback, every iteration): the kernels of the profiled slice whose
launch falls inside such a span, over the calls in it. None where the
program has no such span."""


def read(ctx):
    launches = ctx.get("essvi_solve_launches")
    if launches is None or not ctx.get("calls"):
        return None
    return launches / ctx["calls"]
