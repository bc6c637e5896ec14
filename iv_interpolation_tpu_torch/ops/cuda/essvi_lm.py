"""Joint eSSVI calibration by Levenberg-Marquardt: the wrapper of kernel
``csrc/essvi_lm.cu``.

The kernel replaces no Pallas kernel: the JAX package leaves its eSSVI
block solver to XLA, and the port's (``ops.essvi._fit_essvi_block``) runs it
as eager passes, about 1,100 launches an iteration. Here one launch runs
every iteration of every surface of that loop, from the start
``essvi_init`` gives to the returned
:class:`~iv_interpolation_tpu_torch.ops.essvi.EssviFit`: the transform,
the data residual and the calendar hinge, the slice-space blocks g, D and
U from closed-form slice Jacobians, the damping, the block-tridiagonal
solve (the eager loop's block Thomas chain, its Schur complements passed
lane to lane across a warp, or block by block where no hinge couples the
expiries), the pullback, acceptance and the convergence tests. The
linearisation is redone only after an accepted step (after a rejection z,
and so the system, is unchanged), and a converged surface stops.

The plain version is the eager loop itself: :func:`essvi_lm_cuda` runs
``_fit_essvi_block`` for tensors on the CPU. A CUDA tensor launches the
kernel, or the call raises.
"""

from __future__ import annotations

import operator

import torch

from iv_interpolation_tpu_torch._build import check_launch, load_library
from iv_interpolation_tpu_torch.monitoring.metrics import span

_DTYPES = (torch.float32, torch.float64)
MAX_EXPIRIES = 32               # csrc kLanes: one warp a surface, a lane an expiry
LAMBDA0 = 1e-3                  # the block solver's starting damping
TOL = 1e-12                     # and its convergence tolerance


def _check(k, w, weights, k_pen, max_iters, calendar_weight) -> tuple[int, int, int, int, int]:
    """B, E, n, m and the iteration count of a call the kernel takes;
    raises on any other."""
    arrays = [k, w, k_pen] + ([] if weights is None else [weights])
    if not all(isinstance(a, torch.Tensor) for a in arrays):
        raise TypeError("essvi_lm_cuda takes torch tensors")
    if w.dtype not in _DTYPES or any(a.dtype != w.dtype for a in arrays):
        raise TypeError("k, w, weights and k_pen must all be float32 or all float64: "
                        f"{[a.dtype for a in arrays]}")
    if any(a.device != w.device for a in arrays):
        raise ValueError(f"tensors on different devices: {[a.device for a in arrays]}")
    if w.dim() != 3 or k.shape != w.shape or (weights is not None and weights.shape != w.shape):
        raise ValueError("k, w and weights must be (surfaces, E, n) of one shape: "
                         f"{[tuple(a.shape) for a in arrays]}")
    B, E, n = w.shape
    if k_pen.dim() != 2 or k_pen.shape[0] != B:
        raise ValueError(f"k_pen must be ({B}, m), got {tuple(k_pen.shape)}")
    if not 1 <= E <= MAX_EXPIRIES:
        raise ValueError(f"E must be 1 to {MAX_EXPIRIES}, got E={E}")
    if n < 1 or E * n > (2**31 - 1) // 3:
        raise ValueError(f"n must be at least 1 and E n fit in 32 bits, got n={n}")
    if not all(a.is_contiguous() for a in arrays):
        raise ValueError("k, w, weights and k_pen must be contiguous")
    iters = operator.index(max_iters)
    if not 0 <= iters <= 2**31 - 1:
        raise ValueError(f"max_iters must be a non-negative 32-bit count, got {max_iters!r}")
    if not float(calendar_weight) >= 0.0:
        raise ValueError(f"calendar_weight must be at least 0, got {calendar_weight!r}")
    return B, E, n, k_pen.shape[1], iters


def essvi_lm_cuda(k: torch.Tensor, w: torch.Tensor, weights: torch.Tensor | None,
                  k_pen: torch.Tensor, max_iters: int, calendar_weight: float):
    """Calibrate one joint eSSVI surface a batch element by the block
    solver's Levenberg-Marquardt: ``k``, ``w`` (B, E, n) log-moneyness and
    total variance, ``weights`` (B, E, n) or None for unit weights,
    ``k_pen`` (B, m) the calendar hinge's grid (``ops.essvi._penalty_grid``),
    the hinge at ``calendar_weight``; all float32 or all float64,
    contiguous, on one device, 1 <= E <= 32. Returns ``ops.essvi.EssviFit``
    (params (B, E, 3), cost (B,), n_accepted int32, converged bool) as
    ``ops.essvi._fit_essvi_block`` computes it, with the linear loss.

    CPU tensors run ``_fit_essvi_block`` itself (span ``iv.essvi.lm[plain
    ...]`` around its own). CUDA tensors compute the start in span
    ``iv.essvi.init`` and launch the kernel in span ``iv.essvi.lm[cuda
    surfaces=<B> E=<E> n=<n> m=<m> iters=<max_iters> <dtype>]`` (the
    launch stages a block's quotes in shared memory where a surface's fit
    in 48 KiB and reads them in device memory otherwise).
    ``essvi_lm_cuda.launches`` counts kernel launches, one a call,
    ``.launches_by_dtype`` the same by dtype name and ``.surfaces`` the
    surfaces of every launch.
    """
    from iv_interpolation_tpu_torch.ops import essvi  # ops.essvi routes its calls here

    B, E, n, m, iters = _check(k, w, weights, k_pen, max_iters, calendar_weight)
    dtype = str(w.dtype)[6:]
    name = f"surfaces={B} E={E} n={n} m={m} iters={iters} {dtype}"
    if w.device.type == "cpu":
        with span(f"iv.essvi.lm[plain {name}]"):
            return essvi._fit_essvi_block(k, w, torch.ones_like(w) if weights is None else weights,
                                          k_pen, iters, float(calendar_weight), TOL)
    if w.device.type != "cuda":
        raise ValueError(f"no kernel for device {w.device}")
    params = torch.empty((B, E, 3), dtype=w.dtype, device=w.device)
    cost = torch.empty((B,), dtype=w.dtype, device=w.device)
    n_acc = torch.empty((B,), dtype=torch.int32, device=w.device)
    converged = torch.empty((B,), dtype=torch.bool, device=w.device)
    fit = essvi.EssviFit(params=params, cost=cost, n_accepted=n_acc, converged=converged)
    if B == 0:
        return fit
    with span("iv.essvi.init"):
        z0 = essvi.essvi_init(k, w, weights).contiguous()
    lib = load_library()
    suffix = "f32" if w.dtype == torch.float32 else "f64"
    with span(f"iv.essvi.lm[cuda {name}]"), torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        err = getattr(lib, f"ivt_essvi_lm_{suffix}")(
            k.data_ptr(), w.data_ptr(), None if weights is None else weights.data_ptr(),
            k_pen.data_ptr(), z0.data_ptr(), params.data_ptr(), cost.data_ptr(),
            n_acc.data_ptr(), converged.data_ptr(), B, E, n, m, iters,
            float(calendar_weight), LAMBDA0, TOL, stream)
    check_launch(err, "eSSVI calibration")
    essvi_lm_cuda.launches += 1
    essvi_lm_cuda.launches_by_dtype[dtype] += 1
    essvi_lm_cuda.surfaces += B
    return fit


essvi_lm_cuda.launches = 0
essvi_lm_cuda.launches_by_dtype = {"float32": 0, "float64": 0}
essvi_lm_cuda.surfaces = 0
