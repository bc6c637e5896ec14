"""Batched cubic-spline evaluation: the wrapper of kernel
``csrc/spline_eval.cu``, its launch plan and its plain PyTorch version.

The kernel replaces no Pallas kernel: the JAX package evaluates splines
with jnp code (``ops/cubic_spline.py``) and leaves the fusion to XLA. Here
one launch brackets each query once, reads each slice's knots once and
writes S(t), S'(t) and S''(t), or any subset of them.

Knots ``x``, ``y``, ``M`` are ``(..., n)``; queries ``t`` are ``(..., m)``
with batch dimensions that broadcast against the knots'. The kernel reads
the queries through their strides, so a grid expanded over expiries or a
timeline expanded over a batch is never copied.

:func:`spline_eval_cuda` takes the plain version only for tensors on the
CPU. A CUDA tensor launches the kernel, or the call raises.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from iv_interpolation_tpu_torch._build import check_launch, load_library
from iv_interpolation_tpu_torch.monitoring.metrics import span

_DTYPES = (torch.float32, torch.float64)
OUTPUTS_A_BLOCK = 2048          # the outputs a block aims at: 8 a thread of 256
SMEM = 48 * 1024                # csrc kMaxSmem: a block's staged knots
ROUTES = ("staged", "global")
RESULTS = (0, 1, 2)             # S, S', S''


class SplinePlan(NamedTuple):
    """How one evaluation launches: ``route`` "staged" (a block's knots in
    shared memory) or "global" (knots searched in device memory, one slice
    a block); ``slices`` and ``queries`` a block (the grid is ceil(slices /
    slices a block) x ceil(m / queries a block)). The kernel sizes its
    shared memory from these."""
    route: str
    slices: int
    queries: int


def spline_eval_plan(n: int, m: int, dtype: torch.dtype, slices: int) -> SplinePlan:
    """The launch plan for ``slices`` slices of ``n`` knots and ``m``
    queries in ``dtype``, by shape.

    A block aims at ``OUTPUTS_A_BLOCK`` outputs. A query row of at most
    that many takes one chunk and the block as many whole slices as make
    up the aim; a longer row is cut into chunks of that many queries, a
    block each, every block of a slice staging its knots. Each slice's
    three knot rows (3 n itemsize bytes) and the offset of its query row
    (8 bytes) sit in shared memory, at most ``SMEM`` bytes a block, which
    caps the slices a block (the "staged" route). A slice whose knots
    alone exceed that (n > 4,095 in float32, n > 2,047 in float64) takes
    the "global" route.
    """
    if n < 2:
        raise ValueError(f"a spline needs at least 2 knots, got n={n}")
    if m < 1:
        raise ValueError(f"m must be positive, got {m}")
    queries = min(m, OUTPUTS_A_BLOCK)
    per_slice = 3 * n * dtype.itemsize + 8
    if per_slice > SMEM:
        return SplinePlan("global", 1, queries)
    return SplinePlan("staged", max(1, min(OUTPUTS_A_BLOCK // queries, SMEM // per_slice, slices)),
                      queries)


def query_layout(shape, strides) -> tuple[int, int, int] | None:
    """The kernel's addressing of the query rows of a ``(*batch, m)`` view
    with these ``shape`` and ``strides``: ``(inner, t_outer, t_inner)``
    such that slice s's row starts at element ``(s // inner) * t_outer +
    (s % inner) * t_inner``, with s the flat index over ``batch``. Batch
    dimensions merge where their strides allow (size-1 dimensions drop);
    None where more than two remain."""
    dims = []
    for size, stride in zip(shape[:-1], strides[:-1]):
        if size == 1:
            continue
        if dims and dims[-1][1] == stride * size:
            dims[-1] = (dims[-1][0] * size, stride)
        else:
            dims.append((size, stride))
    if not dims:
        return 1, 0, 0
    if len(dims) == 1:
        return dims[0][0], 0, dims[0][1]
    if len(dims) == 2:
        return dims[1][0], dims[0][1], dims[1][1]
    return None


def spline_eval_plain(x: torch.Tensor, y: torch.Tensor, M: torch.Tensor,
                      t: torch.Tensor, results=RESULTS) -> tuple:
    """The kernel's algorithm in PyTorch, on any device: one bracket search
    (``ops.cubic_spline._bracket``), one gather of each knot array at the
    interval's two ends, then each requested result (0: S, 1: S', 2: S'')
    with the kernel's operations in its order. ``x``, ``y``, ``M`` of one
    shape; returns the results asked, in ascending order."""
    from iv_interpolation_tpu_torch.ops.cubic_spline import _bracket

    idx = _bracket(x, t)
    batch = idx.shape[:-1]

    def ends(a):
        a = a.expand(*batch, a.shape[-1])
        return torch.gather(a, -1, idx), torch.gather(a, -1, idx + 1)

    x0, x1 = ends(x)
    M0, M1 = ends(M)
    hh = x1 - x0
    out = {}
    if 0 in results or 1 in results:
        y0, y1 = ends(y)
        a = (x1 - t) / hh
        b = (t - x0) / hh
        if 0 in results:
            out[0] = (a * y0 + b * y1
                      + ((a * a * a - a) * M0 + (b * b * b - b) * M1) * (hh * hh) / 6.0)
        if 1 in results:
            out[1] = ((y1 - y0) / hh
                      + ((-3 * (a * a) + 1) * M0 + (3 * (b * b) - 1) * M1) * hh / 6.0)
    if 2 in results:
        out[2] = ((x1 - t) * M0 + (t - x0) * M1) / hh
    return tuple(out[r] for r in results)


def _check(x, y, M, t, results) -> tuple:
    """The batch shape, n and m of a call it takes; raises on any other."""
    arrays = (x, y, M, t)
    if not all(isinstance(a, torch.Tensor) for a in arrays):
        raise TypeError("spline_eval_cuda takes torch tensors")
    if x.dtype not in _DTYPES or any(a.dtype != x.dtype for a in arrays):
        raise TypeError("x, y, M and t must all be float32 or all float64: "
                        f"{[a.dtype for a in arrays]}")
    if any(a.device != x.device for a in arrays):
        raise ValueError(f"tensors on different devices: {[a.device for a in arrays]}")
    if any(a.dim() < 1 for a in arrays):
        raise ValueError("x, y, M and t need a last dimension: "
                         f"{[tuple(a.shape) for a in arrays]}")
    if not (x.shape == y.shape == M.shape):
        raise ValueError("x, y and M must have one shape (broadcast them first): "
                         f"{[tuple(a.shape) for a in (x, y, M)]}")
    n, m = x.shape[-1], t.shape[-1]
    if n < 2:
        raise ValueError(f"a spline needs at least 2 knots, got n={n}")
    if n > 2**31 - 1 or m > 2**31 - 1:
        raise ValueError(f"n and m must fit in 32 bits, got n={n}, m={m}")
    try:
        batch = torch.broadcast_shapes(x.shape[:-1], t.shape[:-1])
    except RuntimeError as exc:
        raise ValueError(f"knots {tuple(x.shape)} and queries {tuple(t.shape)} "
                         "have batch shapes that do not broadcast") from exc
    if not results or any(r not in RESULTS for r in results) or list(results) != sorted(set(results)):
        raise ValueError(f"results must be distinct entries of {RESULTS} in ascending order, "
                         f"got {results}")
    return batch, n, m


def spline_eval_cuda(x: torch.Tensor, y: torch.Tensor, M: torch.Tensor,
                     t: torch.Tensor, results=RESULTS) -> tuple:
    """S(t), S'(t) and S''(t) of fitted cubic splines, those of
    ``results`` (0, 1, 2; ascending), each of shape ``(*batch, m)``.

    ``x``, ``y``, ``M`` are knots, values and knot second derivatives of
    one shape ``(..., n)``, n >= 2; ``t`` queries ``(..., m)`` whose batch
    dimensions broadcast against the knots'; all float32 or all float64 on
    one device. CPU tensors run :func:`spline_eval_plain`; CUDA tensors
    launch the kernel on the route :func:`spline_eval_plan` picks for
    (n, m, dtype, slices). ``spline_eval_cuda.launches`` counts kernel
    launches, one a call, ``.launches_by_dtype`` the same by dtype name
    and ``.launches_by_route`` by route. Span ``iv.spline.eval[<route>
    n=<n> m=<m> slices=<slices> <dtype>]``, route ``plain`` on the CPU.
    """
    results = tuple(results)
    batch, n, m = _check(x, y, M, t, results)
    slices = math.prod(batch)
    dtype = str(x.dtype)[6:]
    if x.device.type == "cpu":
        with span(f"iv.spline.eval[plain n={n} m={m} slices={slices} {dtype}]"):
            return spline_eval_plain(x, y, M, t, results)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    outs = [torch.empty((*batch, m), dtype=x.dtype, device=x.device) for _ in results]
    if slices == 0 or m == 0:
        return tuple(outs)
    plan = spline_eval_plan(n, m, x.dtype, slices)
    knots = [a.expand(*batch, n).contiguous() for a in (x, y, M)]
    queries = t.expand(*batch, m)
    layout = query_layout(queries.shape, queries.stride())
    if layout is None:
        queries = queries.contiguous()
        layout = query_layout(queries.shape, queries.stride())
    ptrs = [None, None, None]
    for r, out in zip(results, outs):
        ptrs[r] = out.data_ptr()
    lib = load_library()
    suffix = "f32" if x.dtype == torch.float32 else "f64"
    with span(f"iv.spline.eval[{plan.route} n={n} m={m} slices={slices} {dtype}]"), \
            torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, f"ivt_spline_eval_{suffix}")(
            *(a.data_ptr() for a in knots), queries.data_ptr(), *ptrs,
            slices, n, m, *layout, queries.stride(-1), plan.slices, plan.queries,
            int(plan.route == "staged"), stream)
    check_launch(err, f"spline evaluation ({plan.route})")
    spline_eval_cuda.launches += 1
    spline_eval_cuda.launches_by_dtype[dtype] += 1
    spline_eval_cuda.launches_by_route[plan.route] += 1
    return tuple(outs)


spline_eval_cuda.launches = 0
spline_eval_cuda.launches_by_dtype = {"float32": 0, "float64": 0}
spline_eval_cuda.launches_by_route = dict.fromkeys(ROUTES, 0)
