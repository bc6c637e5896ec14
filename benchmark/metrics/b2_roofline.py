"""b2_roofline: kernel B2's share of its roofline in the
refits of the profiled slice (%): the bytes of every B2 call (the frozen
``b2_bytes`` of its actual inputs and result) over the card's memory rate,
over the time the trace gives B2's kernels. None where the slice launched
no B2."""

from benchmark import roofline


def read(ctx):
    summary, calls = ctx.get("trace"), ctx.get("b2_bytes") or []
    if summary is None or not calls:
        return None
    seconds, count = summary.kernel_time_s("stream_agg")
    if count != len(calls) or seconds <= 0:
        return None
    return 100.0 * sum(roofline.bound_s(nbytes, 0) for nbytes in calls) / seconds
