"""Raw-SVI calibration by Levenberg-Marquardt: the wrapper of kernel
``csrc/svi_lm.cu``, and its plain PyTorch version.

The kernel replaces no Pallas kernel: the JAX package leaves its batched
LM to XLA (``vmap(jacfwd)``), and the port's generic loop
(``ops.lm.levenberg_marquardt_batched``) runs it as eager passes. Here
one launch runs every iteration of every slice of the raw-SVI residual
with linear loss and no butterfly penalty: the closed-form Jacobian, the
21 sums of J^T J, J^T r and r^T r, the damped 5 x 5 Cholesky solve, the
projected trial point, acceptance and the convergence tests. It returns
the generic loop's :class:`~iv_interpolation_tpu_torch.ops.lm.LMResult`.

Slices are ``k``, ``w`` (B, n) with optional ``weights`` (B, n) (None:
unit weights) and starts ``p0`` (B, 5) in the order (a, b, rho, m,
sigma). :func:`svi_lm_cuda` takes the plain version only for tensors on
the CPU. A CUDA tensor launches the kernel, or the call raises.
"""

from __future__ import annotations

import ctypes
import operator

import numpy as np
import torch

from iv_interpolation_tpu_torch._build import check_launch, load_library
from iv_interpolation_tpu_torch.monitoring.metrics import span
from iv_interpolation_tpu_torch.ops.lm import LMResult

_DTYPES = (torch.float32, torch.float64)
P = 5
RUN = 8                         # csrc kRun: quotes summed apart, then joined
# J^T J's upper triangle row by row, the kernel's order of the sums
PAIRS = tuple((i, j) for i in range(P) for j in range(i, P))


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The IEEE square root, as the kernel and PyTorch's CUDA kernels take
    it. PyTorch's on CPU tensors goes through a vector math library that is
    not correctly rounded everywhere (an ulp off on about 0.7 % of float32
    inputs); NumPy's is."""
    if x.device.type == "cpu":
        with np.errstate(invalid="ignore"):     # a negative pivot: NaN, as on the card
            return torch.from_numpy(np.sqrt(x.numpy()))
    return torch.sqrt(x)


def _sums(p: torch.Tensor, k: torch.Tensor, w: torch.Tensor, weights) -> torch.Tensor:
    """The kernel's pass at ``p`` (B, 5): (B, 21) sums over the quotes of
    J^T J's pairs (``PAIRS``), J^T r and r^T r, each taken in runs of
    ``RUN`` quotes in quote order, each run from its first quote's terms,
    the runs joined in order from the first."""
    a, b, rho, m, sigma = (p[:, i:i + 1] for i in range(P))
    s2, bs = sigma * sigma, b * sigma
    km = k - m
    rt = _sqrt(km * km + s2)
    ir = torch.reciprocal(rt)
    u = rho * km + rt
    r = (a + b * u) - w
    J = [torch.ones_like(km), u, b * km, -(b * (rho + km * ir)), bs * ir]
    if weights is not None:
        r = r * weights
        J = [col * weights for col in J]
    terms = torch.stack([J[i] * J[j] for i, j in PAIRS] + [col * r for col in J] + [r * r],
                        dim=-1)                                        # (B, n, 21)
    acc = None
    for j0 in range(0, terms.shape[1], RUN):
        run = terms[:, j0]
        for j in range(j0 + 1, min(j0 + RUN, terms.shape[1])):
            run = run + terms[:, j]
        acc = run if acc is None else acc + run
    return acc


def _solve(acc: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """The kernel's damped 5 x 5 Cholesky solve of every slice, NaN where
    a pivot is not positive or the factor is not finite."""
    h = {pair: acc[:, e] for e, pair in enumerate(PAIRS)}
    g = acc[:, len(PAIRS):len(PAIRS) + P]
    L, inv = {}, []
    ok = torch.ones_like(lam, dtype=torch.bool)
    for j in range(P):
        hjj = h[j, j]
        s = hjj + lam * hjj.clamp_min(1e-12)
        for q in range(j):
            s = s - L[j, q] * L[j, q]
        ok = ok & (s > 0)
        d = _sqrt(s)
        ok = ok & torch.isfinite(d)
        inv.append(torch.reciprocal(d))
        for i in range(j + 1, P):
            t = h[j, i]
            for q in range(j):
                t = t - L[i, q] * L[j, q]
            L[i, j] = t * inv[j]
            ok = ok & torch.isfinite(L[i, j])
    y = []
    for i in range(P):
        t = -g[:, i]
        for q in range(i):
            t = t - L[i, q] * y[q]
        y.append(t * inv[i])
    x = [None] * P
    for i in reversed(range(P)):
        t = y[i]
        for q in range(i + 1, P):
            t = t - L[q, i] * x[q]
        x[i] = t * inv[i]
    delta = torch.stack(x, dim=-1)
    return torch.where(ok[:, None], delta, torch.full_like(delta, float("nan")))


def svi_lm_plain(k: torch.Tensor, w: torch.Tensor, weights: torch.Tensor | None,
                 p0: torch.Tensor, max_iters: int, lambda0: float, tol: float,
                 lower, upper) -> LMResult:
    """The kernel's algorithm in PyTorch, on any device: its operations in
    its order, batched over the slices. A converged slice keeps computing here, but its state no
    longer moves, which is what the kernel's early stop leaves."""
    dtype, device = w.dtype, w.device
    lo = torch.as_tensor(lower, device=device).to(dtype)
    hi = torch.as_tensor(upper, device=device).to(dtype)
    p = torch.clamp(p0, lo, hi)
    acc = _sums(p, k, w, weights)
    cost = 0.5 * acc[:, -1]
    lam = torch.full_like(cost, lambda0)
    three = torch.full_like(cost, 3.0)      # a true division on every device
    n_acc = torch.zeros(cost.shape, dtype=torch.int32, device=device)
    converged = torch.zeros(cost.shape, dtype=torch.bool, device=device)
    for _ in range(max_iters):
        g = acc[:, len(PAIRS):len(PAIRS) + P]
        delta = _solve(acc, lam)
        p_new = torch.clamp(p + delta, lo, hi)
        acc_new = _sums(p_new, k, w, weights)
        cost_new = 0.5 * acc_new[:, -1]
        accept = (cost_new < cost) & torch.isfinite(cost_new)
        take = accept & ~converged
        small_grad = g.abs().amax(dim=-1) < tol
        small_impr = accept & (cost - cost_new < tol * cost.clamp_min(1.0))
        p = torch.where(take[:, None], p_new, p)
        cost = torch.where(take, cost_new, cost)
        acc = torch.where(take[:, None], acc_new, acc)
        lam = torch.where(converged, lam, torch.where(accept, lam / three, lam * 3.0))
        lam = lam.clamp(1e-12, 1e12)
        n_acc = n_acc + take.to(torch.int32)
        small_step = accept & (delta.abs().amax(dim=-1) < tol * (1.0 + p.abs().amax(dim=-1)))
        converged = converged | small_step | small_grad | small_impr
    return LMResult(params=p, cost=cost, n_accepted=n_acc, converged=converged)


def _check(k, w, weights, p0, max_iters, lower, upper) -> tuple[int, int, int, list]:
    """B, n, the iteration count and the 10 bounds of a call the kernel
    takes; raises on any other."""
    arrays = [k, w, p0] + ([] if weights is None else [weights])
    if not all(isinstance(a, torch.Tensor) for a in arrays):
        raise TypeError("svi_lm_cuda takes torch tensors")
    if w.dtype not in _DTYPES or any(a.dtype != w.dtype for a in arrays):
        raise TypeError("k, w, weights and p0 must all be float32 or all float64: "
                        f"{[a.dtype for a in arrays]}")
    if any(a.device != w.device for a in arrays):
        raise ValueError(f"tensors on different devices: {[a.device for a in arrays]}")
    if w.dim() != 2 or k.shape != w.shape or (weights is not None and weights.shape != w.shape):
        raise ValueError("k, w and weights must be (slices, n) of one shape: "
                         f"{[tuple(a.shape) for a in arrays]}")
    B, n = w.shape
    if tuple(p0.shape) != (B, P):
        raise ValueError(f"p0 must be ({B}, {P}), got {tuple(p0.shape)}")
    if n < 1 or n > 2**31 - 1:
        raise ValueError(f"n must be at least 1 and fit in 32 bits, got n={n}")
    if not all(a.is_contiguous() for a in arrays):
        raise ValueError("k, w, weights and p0 must be contiguous")
    iters = operator.index(max_iters)
    if not 0 <= iters <= 2**31 - 1:
        raise ValueError(f"max_iters must be a non-negative 32-bit count, got {max_iters!r}")
    bounds = [float(b) for b in lower] + [float(b) for b in upper]
    if len(bounds) != 2 * P:
        raise ValueError(f"lower and upper must hold {P} bounds each, got {bounds}")
    return B, n, iters, bounds


def svi_lm_cuda(k: torch.Tensor, w: torch.Tensor, weights: torch.Tensor | None,
                p0: torch.Tensor, max_iters: int, lambda0: float, tol: float,
                lower, upper) -> LMResult:
    """Calibrate raw SVI on every slice: ``k``, ``w`` (B, n) log-moneyness
    and total variance, ``weights`` (B, n) or None for unit weights,
    ``p0`` (B, 5) starts, ``lower``/``upper`` the 5 bounds; all float32 or
    all float64, contiguous, on one device. Returns the generic loop's
    ``LMResult`` (params (B, 5), cost (B,), n_accepted int32, converged
    bool) for the residual ``(w(k; p) - w) * weights`` with linear loss.

    CPU tensors run :func:`svi_lm_plain`; CUDA tensors launch the kernel
    (its launch stages a block's quotes in shared memory where they fit,
    n <= 186 in float32 with unit weights, and reads them in device memory
    otherwise). ``svi_lm_cuda.launches`` counts kernel launches, one a
    call, ``.launches_by_dtype`` the same by dtype name and ``.problems``
    the slices of every launch. Span
    ``iv.svi.lm[<where> slices=<B> m=<n> iters=<max_iters> <dtype>]``,
    ``plain`` on the CPU, ``cuda`` on the card.
    """
    B, n, iters, bounds = _check(k, w, weights, p0, max_iters, lower, upper)
    dtype = str(w.dtype)[6:]
    name = f"slices={B} m={n} iters={max_iters} {dtype}"
    if w.device.type == "cpu":
        with span(f"iv.svi.lm[plain {name}]"):
            return svi_lm_plain(k, w, weights, p0, max_iters, lambda0, tol, lower, upper)
    if w.device.type != "cuda":
        raise ValueError(f"no kernel for device {w.device}")
    params = torch.empty_like(p0)
    cost = torch.empty((B,), dtype=w.dtype, device=w.device)
    n_acc = torch.empty((B,), dtype=torch.int32, device=w.device)
    converged = torch.empty((B,), dtype=torch.bool, device=w.device)
    if B == 0:
        return LMResult(params=params, cost=cost, n_accepted=n_acc, converged=converged)
    lib = load_library()
    suffix = "f32" if w.dtype == torch.float32 else "f64"
    with span(f"iv.svi.lm[cuda {name}]"), torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        err = getattr(lib, f"ivt_svi_lm_{suffix}")(
            k.data_ptr(), w.data_ptr(), None if weights is None else weights.data_ptr(),
            p0.data_ptr(), params.data_ptr(), cost.data_ptr(), n_acc.data_ptr(),
            converged.data_ptr(), B, n, iters, float(lambda0), float(tol),
            (ctypes.c_double * len(bounds))(*bounds), stream)
    check_launch(err, "raw-SVI calibration")
    svi_lm_cuda.launches += 1
    svi_lm_cuda.launches_by_dtype[dtype] += 1
    svi_lm_cuda.problems += B
    return LMResult(params=params, cost=cost, n_accepted=n_acc, converged=converged)


svi_lm_cuda.launches = 0
svi_lm_cuda.launches_by_dtype = {"float32": 0, "float64": 0}
svi_lm_cuda.problems = 0
