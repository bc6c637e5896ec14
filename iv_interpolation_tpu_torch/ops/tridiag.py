"""Batched tridiagonal solve and product (port of
``iv_interpolation_tpu/ops/tridiag.py``).

The system dimension is axis 0 and any batch dimensions follow, as in the
reference. :func:`tridiag_solve` is the Thomas algorithm of kernel B1
(``ops.cuda.tridiag``): on the H100 a thread walks one system's 2n-step
recurrence. Every caller of the port solves through it.
:func:`tridiag_solve_pcr` is the reference's parallel cyclic reduction as
plain tensor code, ceil(log2 n) levels of whole-array passes; it runs
beside B1 only to be measured against it.
"""

from __future__ import annotations

import math

import torch

from iv_interpolation_tpu_torch.ops.cuda.tridiag import tridiag_solve_cuda


def tridiag_solve(dl: torch.Tensor, d: torch.Tensor, du: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """Solve tridiagonal systems ``A x = b`` (Thomas, no pivoting).

    Args:
      dl: sub-diagonal, shape ``(n,) + batch``; ``dl[0]`` is ignored.
      d:  main diagonal, shape ``(n,) + batch``.
      du: super-diagonal, shape ``(n,) + batch``; ``du[n-1]`` is ignored.
      b:  right-hand side, shape ``(n,) + batch``.

    Returns x with the shape of ``b``; ``n == 1`` gives ``b / d``.
    """
    if not (dl.shape == d.shape == du.shape == b.shape):
        raise ValueError("dl, d, du and b must share one (n, ...) shape: "
                         f"{[tuple(a.shape) for a in (dl, d, du, b)]}")
    n = d.shape[0]
    flat = math.prod(d.shape[1:])
    as2d = lambda a: a.reshape(n, flat).contiguous()
    x = tridiag_solve_cuda(as2d(dl), as2d(d), as2d(du), as2d(b))
    return x.reshape(b.shape)


def tridiag_solve_pcr(dl: torch.Tensor, d: torch.Tensor, du: torch.Tensor,
                      b: torch.Tensor) -> torch.Tensor:
    """Parallel cyclic reduction solve, the contract of
    :func:`tridiag_solve` (system dim = axis 0, no pivoting).

    Each of the ceil(log2 n) levels couples row i with rows i - s and
    i + s and doubles s; ``dl[0]`` and ``du[n-1]`` are zeroed first, since
    PCR reads them.
    """
    n = d.shape[0]
    if n == 1:
        return b / d
    dl = dl.clone()
    du = du.clone()
    dl[0] = 0.0
    du[n - 1] = 0.0

    def shifted(a, s, fill):
        """a[i+s] along axis 0 with the rows out of range set to fill."""
        k = min(abs(s), n)
        pad = torch.full((k,) + tuple(a.shape[1:]), fill, dtype=a.dtype, device=a.device)
        if s > 0:
            return torch.cat([a[k:], pad])
        return torch.cat([pad, a[:n - k]])

    s = 1
    while s < n:
        alpha = -dl / shifted(d, -s, 1.0)   # identity ghost rows outside
        beta = -du / shifted(d, s, 1.0)
        dl_new = alpha * shifted(dl, -s, 0.0)
        du_new = beta * shifted(du, s, 0.0)
        d_new = d + alpha * shifted(du, -s, 0.0) + beta * shifted(dl, s, 0.0)
        b_new = b + alpha * shifted(b, -s, 0.0) + beta * shifted(b, s, 0.0)
        dl, d, du, b = dl_new, d_new, du_new, b_new
        s *= 2
    return b / d


def tridiag_solve_batch_last(dl: torch.Tensor, d: torch.Tensor, du: torch.Tensor,
                             b: torch.Tensor) -> torch.Tensor:
    """:func:`tridiag_solve` for ``(batch..., n)`` inputs: the system axis
    moves to the front and back (B1 on a CUDA tensor)."""
    to_sys = lambda a: torch.movedim(a, -1, 0)
    return torch.movedim(tridiag_solve(*map(to_sys, (dl, d, du, b))), 0, -1)


def tridiag_matvec(dl: torch.Tensor, d: torch.Tensor, du: torch.Tensor,
                   x: torch.Tensor) -> torch.Tensor:
    """Multiply a tridiagonal matrix by ``x`` (system dim = axis 0)."""
    upper = du[:-1] * x[1:]
    lower = dl[1:] * x[:-1]
    y = d * x
    y[:-1] += upper
    y[1:] += lower
    return y
