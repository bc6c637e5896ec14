"""Batched tridiagonal solve and product (port of
``iv_interpolation_tpu/ops/tridiag.py``).

The system dimension is axis 0 and any batch dimensions follow, as in the
reference. The solve is the Thomas algorithm of kernel B1
(``ops.cuda.tridiag``): on the H100 a thread walks one system's 2n-step
recurrence, so the reference's parallel cyclic reduction, which existed
only to cut per-step dispatch on the TPU, is not ported.
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


def tridiag_matvec(dl: torch.Tensor, d: torch.Tensor, du: torch.Tensor,
                   x: torch.Tensor) -> torch.Tensor:
    """Multiply a tridiagonal matrix by ``x`` (system dim = axis 0)."""
    upper = du[:-1] * x[1:]
    lower = dl[1:] * x[:-1]
    y = d * x
    y[:-1] += upper
    y[1:] += lower
    return y
