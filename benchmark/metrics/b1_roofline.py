"""b1_roofline: kernel B1's share of its roofline in the
surface step (%): the least time of every B1 launch in the profiled slice
(bytes and operations from ``benchmark.roofline``, from the shapes each
launch was given) over the time the trace gives B1's kernels. None where
the slice launched no B1."""

from benchmark import roofline


def read(ctx):
    summary, launches = ctx.get("trace"), ctx.get("b1") or []
    if summary is None or not launches:
        return None
    seconds, count = summary.kernel_time_s("thomas")
    if count != len(launches) or seconds <= 0:
        return None
    least = sum(roofline.bound_s(roofline.b1_bytes(n, batch, width), roofline.b1_ops(n, batch),
                                 roofline.F32_OPS_S if width == 4 else roofline.F64_OPS_S)
                for n, batch, width in launches)
    return 100.0 * least / seconds
