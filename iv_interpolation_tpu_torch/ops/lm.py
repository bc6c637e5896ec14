"""Batched Levenberg-Marquardt for small nonlinear least-squares problems
(port of ``iv_interpolation_tpu/ops/lm.py``).

Built for SVI smile calibration (5 parameters x thousands of slices, see
``ops.svi``) but generic:

  * a fixed iteration count with per-problem acceptance masks instead of
    data-dependent control flow: every problem of a batch runs the same
    straight-line program, nothing reads the device on the host (no
    ``.item()``, no early exit), so a fit can be captured in a CUDA graph;
  * Jacobians by ``torch.func.jacfwd`` under ``torch.func.vmap`` (forward
    mode: few parameters, many residuals), or from a caller's batched
    ``linearize`` where the residual cannot run under ``torch.func``
    (Andreasen-Huge: its step solve is a kernel launched on raw pointers);
  * normal equations with Marquardt diagonal scaling, solved by Cholesky
    on (P, P) systems. ``J^T J`` plus positive damping is symmetric
    positive definite by construction. If rounding or a non-finite
    residual makes one problem's system indefinite, that problem's step
    is NaN, its candidate cost is not finite, the step is rejected and its
    lambda grows, which is LM's normal recovery path; the other problems
    of the batch are untouched (``cholesky_ex`` reports per problem and
    does not raise).

The products stay in the inputs' dtype; on the card TF32 is held off by
``_build.pin_precision``.

Each iteration opens four spans (``monitoring.metrics.span``):
``iv.lm.linearize`` (residuals and Jacobian), ``iv.lm.normal`` (gradient,
``J^T J`` and damping), ``iv.lm.solve`` (:func:`solve_spd`) and
``iv.lm.step`` (projection, trial cost, acceptance and the convergence
tests).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch.func import jacfwd, vmap

from iv_interpolation_tpu_torch.monitoring.metrics import span


# the damping a problem starts from and the convergence tolerance, the
# defaults of every loop here and of the raw-SVI kernel (ops.cuda.svi_lm)
LAMBDA0, TOL = 1e-3, 1e-12


class LMResult(NamedTuple):
    params: torch.Tensor      # (..., P) final parameters
    cost: torch.Tensor        # (...,) final 0.5*sum(r^2)
    n_accepted: torch.Tensor  # (...,) int32 accepted steps
    converged: torch.Tensor   # (...,) bool: gradient/step tolerance met


def lm_accept(state, p_new: torch.Tensor, cost_new: torch.Tensor,
              accept: torch.Tensor):
    """The accept/reject bookkeeping shared by every LM loop here.

    ``state`` = (p, lam, cost, n_acc, converged) batched over B; ``accept``
    (B,) says the candidate ``p_new`` lowered the cost. Returns the next
    (p, lam, cost, n_acc). A converged problem is frozen: neither its
    parameters nor its lambda move again.
    """
    p, lam, cost, n_acc, converged = state
    take = accept & ~converged
    p = torch.where(take[:, None], p_new, p)
    cost = torch.where(take, cost_new, cost)
    lam = torch.where(converged, lam, torch.where(accept, lam / 3.0, lam * 3.0))
    return p, lam.clamp(1e-12, 1e12), cost, n_acc + take.to(torch.int32)


def solve_spd(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve the batched (B, P, P) symmetric systems ``A x = b`` by
    Cholesky. A problem whose matrix is not positive definite (or not
    finite) gets a NaN solution; the others are solved as usual, and
    nothing raises or reads the device on the host."""
    L, info = torch.linalg.cholesky_ex(A, check_errors=False)
    ok = (info == 0) & torch.isfinite(L).flatten(-2).all(dim=-1)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    L = torch.where(ok[:, None, None], L, eye)
    y = torch.linalg.solve_triangular(L, b[..., None], upper=False)
    x = torch.linalg.solve_triangular(L.mT, y, upper=True)[..., 0]
    nan = torch.full((), float("nan"), dtype=A.dtype, device=A.device)
    return torch.where(ok[:, None], x, nan)


def levenberg_marquardt_batched(residual_fn: Callable, params0: torch.Tensor, *args,
                                max_iters: int = 50, lambda0: float = LAMBDA0,
                                tol: float = TOL, lower=None, upper=None,
                                linearize: Callable | None = None) -> LMResult:
    """Minimise ``0.5 * ||residual_fn(p, *args)||^2`` for a batch of
    problems: ``params0`` (B, P) and every tensor of ``args`` carry the
    batch on axis 0.

    Args:
      residual_fn: one problem's (P,) params, *args -> (M,) residuals,
        written with functional tensor operations (it runs under
        ``torch.func.vmap`` and ``jacfwd``). With ``linearize`` it is
        batched instead: (B, P) params, *args -> (B, M).
      lower/upper: optional (P,) box constraints, applied by projection.
      linearize: optional batched (B, P) params, *args -> ((B, M)
        residuals, (B, M, P) Jacobian), used in place of mapping
        ``jacfwd`` over ``residual_fn``.

    Host counters, read by nothing in the loop:
    ``levenberg_marquardt_batched.calls`` (calls), ``.iterations``
    (iterations of every call) and ``.problems`` (problems summed over
    those iterations: B a call's iteration).
    """
    dtype, device = params0.dtype, params0.device
    lo = None if lower is None else torch.as_tensor(lower, device=device).to(dtype)
    hi = None if upper is None else torch.as_tensor(upper, device=device).to(dtype)

    def clip(p):
        if lo is None and hi is None:
            return p
        return torch.clamp(p, lo, hi)

    if linearize is None:
        residuals = vmap(residual_fn)
        jacobians = vmap(jacfwd(residual_fn))
        linearize = lambda p, *a: (residuals(p, *a), jacobians(p, *a))
    else:
        residuals = residual_fn

    def cost_of(p):
        r = residuals(p, *args)
        return 0.5 * (r * r).sum(dim=-1)

    B = params0.shape[0]
    levenberg_marquardt_batched.calls += 1
    levenberg_marquardt_batched.iterations += max_iters
    levenberg_marquardt_batched.problems += B * max_iters
    p = clip(params0)
    state = (p, torch.full((B,), lambda0, dtype=dtype, device=device), cost_of(p),
             torch.zeros((B,), dtype=torch.int32, device=device),
             torch.zeros((B,), dtype=torch.bool, device=device))
    for _ in range(max_iters):
        p, lam, cost = state[:3]
        with span("iv.lm.linearize"):
            r, J = linearize(p, *args)                   # (B, M), (B, M, P)
        with span("iv.lm.normal"):
            g = torch.einsum("bmp,bm->bp", J, r)         # gradient
            JtJ = torch.einsum("bmp,bmq->bpq", J, J)
            diag = torch.diagonal(JtJ, dim1=-2, dim2=-1)
            # Marquardt scaling with a floor so flat directions stay regularised
            damp = lam[:, None] * diag.clamp_min(1e-12)
            A = JtJ + torch.diag_embed(damp)
        with span("iv.lm.solve"):
            delta = solve_spd(A, -g)
        with span("iv.lm.step"):
            p_new = clip(p + delta)
            cost_new = cost_of(p_new)
            accept = (cost_new < cost) & torch.isfinite(cost_new)
            p_next, lam, cost_next, n_acc = lm_accept(state, p_new, cost_new, accept)
            # small_step is gated on acceptance: a rejection streak drives
            # lambda to its cap and the damped step towards zero, which must
            # not latch converged at a non-optimum. small_grad tests the
            # iterate the gradient was taken at and needs no gate.
            small_step = accept & (delta.abs().amax(dim=-1)
                                   < tol * (1.0 + p_next.abs().amax(dim=-1)))
            small_grad = g.abs().amax(dim=-1) < tol
            small_impr = accept & (cost - cost_new < tol * cost.clamp_min(1.0))
            state = (p_next, lam, cost_next, n_acc,
                     state[4] | small_step | small_grad | small_impr)
    p, _, cost, n_acc, converged = state
    return LMResult(params=p, cost=cost, n_accepted=n_acc, converged=converged)


levenberg_marquardt_batched.calls = 0
levenberg_marquardt_batched.iterations = 0
levenberg_marquardt_batched.problems = 0


def levenberg_marquardt(residual_fn: Callable, params0: torch.Tensor, *args,
                        **kw) -> LMResult:
    """One problem: ``params0`` (P,), ``args`` that problem's data. See
    :func:`levenberg_marquardt_batched` for the keywords."""
    # a Python number takes the parameters' dtype, not torch's default
    args = [(a if isinstance(a, torch.Tensor) else torch.as_tensor(
        a, dtype=params0.dtype, device=params0.device))[None] for a in args]
    fit = levenberg_marquardt_batched(residual_fn, params0[None], *args, **kw)
    return LMResult(*(a[0] for a in fit))


def robustify(residual_fn: Callable, delta: float) -> Callable:
    """Wrap a residual function with a pseudo-Huber transform so LM
    minimises a robust loss instead of plain least squares.

    With rho(r) = 2 delta^2 (sqrt(1+(r/delta)^2) - 1) (quadratic for
    |r| << delta, linear for |r| >> delta), the returned residual is
    s(r) = r * sqrt(rho(r)/r^2), so that ||s||^2 = sum rho. The ratio
    uses the exact identity rho/r^2 = 2/(1 + sqrt(1+(r/delta)^2)), which
    is smooth at r=0 and safe under ``jacfwd`` (no sign or abs).
    """
    inv_d = 1.0 / float(delta)

    def robust_fn(p, *args):
        r = residual_fn(p, *args)
        scaled = r * inv_d
        ratio = 2.0 / (1.0 + torch.sqrt(1.0 + scaled * scaled))
        return r * torch.sqrt(ratio)

    return robust_fn
