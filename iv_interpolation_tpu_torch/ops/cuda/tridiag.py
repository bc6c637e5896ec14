"""Batched Thomas solve: the wrapper of kernel ``csrc/tridiag_thomas.cu``
and its plain PyTorch versions.

Port of ``iv_interpolation_tpu/ops/pallas/tridiag_pallas.py``
(``tridiag_solve_pallas``). Systems are (n, batch) with the system
dimension on axis 0; ``dl[0]`` and ``du[n-1]`` are ignored. No pivoting:
callers supply diagonally dominant systems or M-matrices (spline systems
and Andreasen-Huge's steps are).

The four arrays share one of two layouts (``LAYOUTS``): "system_major",
row-major (n, batch), or "batch_last", the transpose of a row-major
(batch, n) array (``a.mT`` of it), as a fit that builds its systems along
the last axis has them. A batch-last call that the staged route's
batch-last kernel takes (:func:`thomas_plan` with ``layout="batch_last"``:
n a multiple of 16 bytes, its tiles in shared memory; every array 16-byte
aligned) launches it and returns x batch-last; otherwise the wrapper
copies the arrays to row-major first and returns x row-major.

:func:`tridiag_solve_cuda` takes the plain version only for tensors on
the CPU. A CUDA tensor launches the kernel, or the call raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from iv_interpolation_tpu_torch._build import check_launch, load_library
from iv_interpolation_tpu_torch.monitoring.metrics import span

_DTYPES = (torch.float32, torch.float64)
_TILES = (128, 64, 32)          # systems a block of the staged route owns
_PART_TILES = (16, 8, 4)        # systems a block of the partitioned route owns
LANES = 32                      # partitioned route: lanes a system (csrc kLanes)
_SMEM_ONE = 200 * 1024          # one block's tiles, of the 227 KiB a block may hold
_SMEM_TWO = 113 * 1024          # two such blocks (plus 1 KiB each) fill an SM's 228 KiB
_SMS = 132                      # the H100's streaming multiprocessors
_SCRATCH_THREADS = 256          # csrc/tridiag_thomas.cu kScratchThreads
ROUTES = ("staged", "partitioned", "scratch")
LAYOUTS = ("system_major", "batch_last")


class ThomasPlan(NamedTuple):
    """How one (n, batch) solve launches: ``route`` "staged" (tiles in
    shared memory, a thread a system), "partitioned" (tiles in shared
    memory, a warp a system) or "scratch" (c' in a global scratch array);
    ``threads`` a block; ``smem`` bytes of shared memory a block;
    ``systems`` a block; ``layout`` the layout the kernel reads (one of
    ``LAYOUTS``)."""
    route: str
    threads: int
    smem: int
    systems: int
    layout: str = "system_major"


def partitioned_smem(n: int, dtype: torch.dtype, systems: int) -> int:
    """Shared bytes of a partitioned-route block: four tiles of
    ``systems`` columns, each ``LANES`` segments of an odd stride
    M >= ceil(n / LANES) plus one element (csrc seg_stride, sys_stride)."""
    M = (n // LANES + 1) | 1
    return 4 * systems * (LANES * M + 1) * dtype.itemsize


def batch_last_rows(n: int, dtype: torch.dtype) -> int | None:
    """Rows a system takes in the batch-last staged kernel's tiles: n
    padded to an odd number of 16-byte pieces (csrc ``batch_last_stride``),
    or None where n is no multiple of 16 bytes, which that kernel does not
    take."""
    V = 16 // dtype.itemsize
    return None if n % V else ((n // V) | 1) * V


def thomas_plan(n: int, dtype: torch.dtype, batch: int | None = None,
                layout: str = "system_major") -> ThomasPlan:
    """The launch plan for ``batch`` systems of size ``n`` in ``dtype``, by
    shape (``batch=None``: a batch large enough to fill the card), for
    arrays in ``layout``.

    The staged route keeps a block's four (n x S) tiles, 4 n S sizeof(T)
    bytes, in shared memory. S is the largest of 128, 64 and 32 whose tiles
    let two blocks share an SM, so that one block's copy overlaps the
    other's sweep; failing that, S=32 with one block an SM while its tiles
    fit in 200 KiB. Beyond that (n > 400 in float32, n > 200 in float64)
    the partitioned route takes the shape while 4 systems' tiles fit in
    200 KiB (n <= 3,167 in float32, n <= 1,567 in float64). Its S is the
    smallest of 4, 8 and 16 whose blocks all run at once, one an SM (at
    most 132: a small batch is bound by its chain, and an SM that holds
    two blocks walks both chains); at a larger batch the largest whose
    tiles let two blocks share an SM (one block's copy overlaps the
    other's phases), else 4. The global-scratch route takes the rest.

    ``layout="batch_last"`` plans the staged batch-last kernel, its tiles
    sized at :func:`batch_last_rows` rows a system by the same rule, where
    n is a multiple of 16 bytes and those tiles fit; other shapes get the
    system-major plan, which a batch-last call reaches by copying.
    """
    if n < 1:
        raise ValueError(f"n must be positive, got {n}")
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    rows = batch_last_rows(n, dtype) if layout == "batch_last" else None
    for lay, r in (("batch_last", rows), ("system_major", n)):
        if r is None:
            continue
        per_system = 4 * r * dtype.itemsize
        fits = [s for s in _TILES if per_system * s <= _SMEM_ONE]
        if fits:
            two = [s for s in fits if per_system * s <= _SMEM_TWO]
            S = two[0] if two else fits[-1]
            return ThomasPlan("staged", S, per_system * S, S, lay)
    fits = [s for s in _PART_TILES if partitioned_smem(n, dtype, s) <= _SMEM_ONE]
    if not fits:
        return ThomasPlan("scratch", _SCRATCH_THREADS, 0, _SCRATCH_THREADS)
    one_wave = [s for s in reversed(fits) if batch is not None and -(-batch // s) <= _SMS]
    two = [s for s in fits if partitioned_smem(n, dtype, s) <= _SMEM_TWO]
    S = one_wave[0] if one_wave else two[0] if two else fits[-1]
    return ThomasPlan("partitioned", S * LANES, partitioned_smem(n, dtype, S), S)


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


def tridiag_solve_partitioned_plain(dl: torch.Tensor, d: torch.Tensor,
                                    du: torch.Tensor, b: torch.Tensor,
                                    P: int = LANES) -> torch.Tensor:
    """The partitioned route's arithmetic in PyTorch, vectorised over the
    P segments and the batch, in the kernel's order of operations.

    Segment k holds rows [start_k, start_k + len_k), the first n % P
    segments ceil(n / P) rows, the others floor(n / P); n >= 2P, so every
    segment has a first and a last row. Phase 1 normalises rows 0 and 1 of
    each segment, eliminates the sub-diagonal downward (each row then
    couples to the segment's first unknown, ``a``, and to the next row,
    ``c``) and the super-diagonal upward (``c`` then couples to the last
    unknown), row 0 last. Phase 2 eliminates each first unknown from the
    previous segment's last row and solves the P rows left in the last
    unknowns by parallel cyclic reduction, as
    ``ops.tridiag.tridiag_solve_pcr``. Phase 3 fills each segment from its
    two end values.
    """
    n = d.shape[0]
    if P < 1 or n < 2 * P:
        raise ValueError(f"the partitioned solve needs n >= 2P, got n={n}, P={P}")
    q, rem = divmod(n, P)
    dev = d.device
    lens = torch.tensor([q + 1] * rem + [q] * (P - rem), device=dev)
    lanes = torch.arange(P, device=dev)
    j = torch.arange(q + (rem > 0), device=dev)[:, None]
    rows = (torch.cumsum(lens, 0) - lens + j).clamp(max=n - 1)   # (m, P)
    valid = j < lens
    DL, D, DU, B = (t[rows] for t in (dl, d, du, b))             # (m, P, batch)
    DL[0, 0] = 0.0                      # dl[0] and du[n-1]: outside the matrix
    DU[lens[-1] - 1, P - 1] = 0.0
    a, c, r = torch.empty_like(DL), torch.empty_like(DU), torch.empty_like(B)
    for i in (0, 1):
        inv = 1.0 / D[i]
        a[i], c[i], r[i] = DL[i] * inv, DU[i] * inv, B[i] * inv
    for i in range(2, len(j)):
        inv = 1.0 / (D[i] - DL[i] * c[i - 1])
        r[i] = (B[i] - DL[i] * r[i - 1]) * inv
        a[i] = -DL[i] * a[i - 1] * inv
        c[i] = DU[i] * inv
    aL, cL, rL = (t[lens - 1, lanes] for t in (a, c, r))
    for i in range(len(j) - 3, 0, -1):
        on = (i <= lens - 3)[:, None]
        r[i] = torch.where(on, r[i] - c[i] * r[i + 1], r[i])
        a[i] = torch.where(on, a[i] - c[i] * a[i + 1], a[i])
        c[i] = torch.where(on, -c[i] * c[i + 1], c[i])
    on = (lens >= 3)[:, None]
    inv0 = 1.0 / (1.0 - c[0] * a[1])
    r0 = torch.where(on, (r[0] - c[0] * r[1]) * inv0, r[0])
    a0 = torch.where(on, a[0] * inv0, a[0])
    c0 = torch.where(on, -(c[0] * c[1]) * inv0, c[0])
    zero = torch.zeros_like(a0[:1])
    aN, cN, rN = (torch.cat([t[1:], zero]) for t in (a0, c0, r0))
    ra = -(aL * a0)
    rb = 1.0 - aL * c0 - cL * aN
    rc = -(cL * cN)
    rr = rL - aL * r0 - cL * rN
    from iv_interpolation_tpu_torch.ops.tridiag import tridiag_solve_pcr
    xL = tridiag_solve_pcr(ra, rb, rc, rr)
    xF = r0 - a0 * torch.cat([zero, xL[:-1]]) - c0 * xL
    X = r - a * xF - c * xL
    X[0] = xF
    X[lens - 1, lanes] = xL
    x = torch.empty_like(b)
    x[rows[valid]] = X[valid]
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


def _layout(dl, d, du, b) -> str:
    """The one layout of the four (n, batch) arrays: "system_major" where
    all are row-major, else "batch_last" where all are transposes of
    row-major (batch, n) arrays; anything else raises."""
    arrays = (dl, d, du, b)
    if all(a.is_contiguous() for a in arrays):
        return "system_major"
    if all(a.stride() == (1, a.shape[0]) for a in arrays):
        return "batch_last"
    raise ValueError("dl, d, du and b must all be row-major (n, batch) or all the "
                     "transposes of row-major (batch, n) arrays: strides "
                     f"{[a.stride() for a in arrays]}")


def tridiag_solve_cuda(dl: torch.Tensor, d: torch.Tensor, du: torch.Tensor,
                       b: torch.Tensor) -> torch.Tensor:
    """Solve the (n, batch) tridiagonal systems ``A x = b``; returns x.

    The arrays share one of ``LAYOUTS``. CPU tensors run
    :func:`tridiag_solve_plain`, x in b's layout; CUDA tensors launch the
    Thomas kernel (float32 or float64) on the plan :func:`thomas_plan`
    makes for (n, batch) and their layout: batch-last arrays that the
    batch-last staged kernel takes (every one 16-byte aligned) launch it
    and give x batch-last, others are copied to row-major first and give x
    row-major.
    ``tridiag_solve_cuda.launches`` counts kernel launches, one a call,
    ``tridiag_solve_cuda.launches_by_dtype`` the same launches by dtype
    name (``"float32"``, ``"float64"``),
    ``tridiag_solve_cuda.launches_by_route`` by route (``"staged"``,
    ``"partitioned"``, ``"scratch"``) and
    ``tridiag_solve_cuda.launches_by_layout`` by the layout the kernel
    read (``"system_major"``, ``"batch_last"``). Span
    ``iv.tridiag.b1[<route> n=<n> batch=<batch> <dtype>]``, route
    ``plain`` on the CPU.
    """
    _check(dl, d, du, b)
    lay = _layout(dl, d, du, b)
    n, batch = d.shape
    dtype = str(d.dtype)[6:]
    if d.device.type == "cpu":
        with span(f"iv.tridiag.b1[plain n={n} batch={batch} {dtype}]"):
            return tridiag_solve_plain(dl, d, du, b)
    if d.device.type != "cuda":
        raise ValueError(f"no kernel for device {d.device}")
    if batch == 0:
        return torch.empty_like(b)
    plan = thomas_plan(n, d.dtype, batch, lay)
    if plan.layout == "batch_last" and any(a.data_ptr() % 16 for a in (dl, d, du, b)):
        plan = thomas_plan(n, d.dtype, batch)
    if plan.layout != lay:
        dl, d, du, b = (a.contiguous() for a in (dl, d, du, b))
    if plan.layout == "batch_last":
        x = torch.empty((batch, n), dtype=b.dtype, device=b.device).mT
    else:
        x = torch.empty_like(b)
    lib = load_library()
    suffix = "f32" if d.dtype == torch.float32 else "f64"
    ptrs = [a.data_ptr() for a in (dl, d, du, b, x)]
    with span(f"iv.tridiag.b1[{plan.route} n={n} batch={batch} {dtype}]"), \
            torch.cuda.device(d.device):
        stream = torch.cuda.current_stream(d.device).cuda_stream
        if plan.layout == "batch_last":
            err = getattr(lib, f"ivt_thomas_staged_batch_last_{suffix}")(
                *ptrs, n, batch, plan.threads, stream)
        elif plan.route == "staged":
            err = getattr(lib, f"ivt_thomas_staged_{suffix}")(
                *ptrs, n, batch, plan.threads, stream)
        elif plan.route == "partitioned":
            err = getattr(lib, f"ivt_thomas_partitioned_{suffix}")(
                *ptrs, n, batch, plan.systems, stream)
        else:
            cp = torch.empty_like(d)  # c' scratch; r' is written into x
            err = getattr(lib, f"ivt_thomas_scratch_{suffix}")(
                *ptrs, cp.data_ptr(), n, batch, stream)
    check_launch(err, f"thomas ({plan.route}, {plan.layout})")
    tridiag_solve_cuda.launches += 1
    tridiag_solve_cuda.launches_by_dtype[dtype] += 1
    tridiag_solve_cuda.launches_by_route[plan.route] += 1
    tridiag_solve_cuda.launches_by_layout[plan.layout] += 1
    return x


tridiag_solve_cuda.launches = 0
tridiag_solve_cuda.launches_by_dtype = {"float32": 0, "float64": 0}
tridiag_solve_cuda.launches_by_route = dict.fromkeys(ROUTES, 0)
tridiag_solve_cuda.launches_by_layout = dict.fromkeys(LAYOUTS, 0)
