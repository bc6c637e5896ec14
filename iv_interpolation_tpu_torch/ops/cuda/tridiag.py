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

from typing import NamedTuple

import torch

from iv_interpolation_tpu_torch._build import check_launch, load_library

_DTYPES = (torch.float32, torch.float64)
_TILES = (128, 64, 32)          # systems a block of the staged route owns
_SMEM_ONE = 200 * 1024          # one block's tiles, of the 227 KiB a block may hold
_SMEM_TWO = 113 * 1024          # two such blocks (plus 1 KiB each) fill an SM's 228 KiB
_SCRATCH_THREADS = 256          # csrc/tridiag_thomas.cu kScratchThreads


class ThomasPlan(NamedTuple):
    """How one (n, batch) solve launches: ``route`` "staged" (tiles in
    shared memory) or "scratch" (c' in a global scratch array);
    ``threads`` a block (= systems a block owns); ``smem`` bytes of
    shared memory a block."""
    route: str
    threads: int
    smem: int


def thomas_plan(n: int, dtype: torch.dtype) -> ThomasPlan:
    """The launch plan for systems of size ``n`` in ``dtype``, by shape.

    The staged route keeps a block's four (n x S) tiles, 4 n S sizeof(T)
    bytes, in shared memory. S is the largest of 128, 64 and 32 whose tiles
    let two blocks share an SM, so that one block's copy overlaps the
    other's sweep; failing that, S=32 with one block an SM while its tiles
    fit in 200 KiB. Beyond that (n > 400 in float32, n > 200 in float64)
    the global-scratch route takes the shape.
    """
    if n < 1:
        raise ValueError(f"n must be positive, got {n}")
    per_system = 4 * n * dtype.itemsize
    fits = [s for s in _TILES if per_system * s <= _SMEM_ONE]
    if not fits:
        return ThomasPlan("scratch", _SCRATCH_THREADS, 0)
    two = [s for s in fits if per_system * s <= _SMEM_TWO]
    S = two[0] if two else fits[-1]
    return ThomasPlan("staged", S, per_system * S)


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
    Thomas kernel (float32 or float64) on the route :func:`thomas_plan`
    picks for n. ``tridiag_solve_cuda.launches`` counts kernel launches,
    one a call, and ``tridiag_solve_cuda.launches_by_dtype`` the same
    launches by dtype name (``"float32"``, ``"float64"``).
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
    plan = thomas_plan(n, d.dtype)
    lib = load_library()
    suffix = "f32" if d.dtype == torch.float32 else "f64"
    ptrs = [a.data_ptr() for a in (dl, d, du, b, x)]
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream(d.device).cuda_stream
        if plan.route == "staged":
            err = getattr(lib, f"ivt_thomas_staged_{suffix}")(
                *ptrs, n, batch, plan.threads, stream)
        else:
            cp = torch.empty_like(d)  # c' scratch; r' is written into x
            err = getattr(lib, f"ivt_thomas_scratch_{suffix}")(
                *ptrs, cp.data_ptr(), n, batch, stream)
    check_launch(err, f"thomas ({plan.route})")
    tridiag_solve_cuda.launches += 1
    tridiag_solve_cuda.launches_by_dtype[str(d.dtype)[6:]] += 1
    return x


tridiag_solve_cuda.launches = 0
tridiag_solve_cuda.launches_by_dtype = {"float32": 0, "float64": 0}
