"""Batched Thomas solve: the wrapper of kernel ``csrc/tridiag_thomas.cu``
and its plain PyTorch version.

Port of ``iv_interpolation_tpu/ops/pallas/tridiag_pallas.py``
(``tridiag_solve_pallas``). Systems are (n, batch) with the system
dimension on axis 0; ``dl[0]`` and ``du[n-1]`` are ignored. No pivoting:
callers supply diagonally dominant systems (spline systems are).

:func:`tridiag_solve_cuda` takes the plain version only for tensors on
the CPU. A CUDA tensor launches the kernel, or the call raises.
"""

from __future__ import annotations

import torch

from iv_interpolation_tpu_torch._build import check_launch, load_library

_DTYPES = (torch.float32, torch.float64)


def tridiag_solve_plain(dl: torch.Tensor, d: torch.Tensor, du: torch.Tensor,
                        b: torch.Tensor) -> torch.Tensor:
    """Thomas loop over n in PyTorch, the kernel's arithmetic step by step:
    c'[0] = du[0]/d[0], r'[0] = b[0]/d[0]; then inv = 1/(d[i] - dl[i] c'[i-1]),
    c'[i] = du[i] inv, r'[i] = (b[i] - dl[i] r'[i-1]) inv; then
    x[i] = r'[i] - c'[i] x[i+1] from the bottom up."""
    n = d.shape[0]
    c = torch.empty_like(d)
    x = torch.empty_like(b)
    c[0] = du[0] / d[0]
    x[0] = b[0] / d[0]
    for i in range(1, n):
        inv = 1.0 / (d[i] - dl[i] * c[i - 1])
        c[i] = du[i] * inv
        x[i] = (b[i] - dl[i] * x[i - 1]) * inv
    for i in range(n - 2, -1, -1):
        x[i] = x[i] - c[i] * x[i + 1]
    return x


def _check(dl, d, du, b) -> None:
    arrays = (dl, d, du, b)
    if not all(isinstance(a, torch.Tensor) for a in arrays):
        raise TypeError("tridiag_solve_cuda takes torch tensors")
    if d.dim() != 2 or d.shape[0] < 1:
        raise ValueError(f"expected (n, batch) with n >= 1, got {tuple(d.shape)}")
    if any(a.shape != d.shape for a in arrays):
        raise ValueError("dl, d, du and b must have the same (n, batch) shape: "
                         f"{[tuple(a.shape) for a in arrays]}")
    if d.dtype not in _DTYPES or any(a.dtype != d.dtype for a in arrays):
        raise TypeError("dl, d, du and b must all be float32 or all float64: "
                        f"{[a.dtype for a in arrays]}")
    if any(a.device != d.device for a in arrays):
        raise ValueError(f"tensors on different devices: {[a.device for a in arrays]}")
    if not all(a.is_contiguous() for a in arrays):
        raise ValueError("dl, d, du and b must be contiguous")


def tridiag_solve_cuda(dl: torch.Tensor, d: torch.Tensor, du: torch.Tensor,
                       b: torch.Tensor) -> torch.Tensor:
    """Solve the (n, batch) tridiagonal systems ``A x = b``; returns x.

    CPU tensors run :func:`tridiag_solve_plain`; CUDA tensors launch the
    Thomas kernel (float32 or float64). ``tridiag_solve_cuda.launches``
    counts kernel launches.
    """
    _check(dl, d, du, b)
    if d.device.type == "cpu":
        return tridiag_solve_plain(dl, d, du, b)
    if d.device.type != "cuda":
        raise ValueError(f"no kernel for device {d.device}")
    n, batch = d.shape
    x = torch.empty_like(b)
    if batch == 0:
        return x
    cp = torch.empty_like(d)  # c' scratch; r' is written into x
    lib = load_library()
    fn = lib.ivt_thomas_f32 if d.dtype == torch.float32 else lib.ivt_thomas_f64
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream(d.device).cuda_stream
        err = fn(dl.data_ptr(), d.data_ptr(), du.data_ptr(), b.data_ptr(),
                 x.data_ptr(), cp.data_ptr(), n, batch, stream)
    check_launch(err, "thomas")
    tridiag_solve_cuda.launches += 1
    return x


tridiag_solve_cuda.launches = 0
