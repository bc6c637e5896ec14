"""Frozen roofline arithmetic: the card's published peaks and the bytes
and operations each kernel of the port must move.

Copied from ``chip_smoke.py`` at the repository root (``HBM_BYTES_S``,
``F32_OPS_S``, ``F64_OPS_S``, ``b2_bytes`` verbatim; B1's bytes and
operations as its ``timing_row`` calls count them). The benchmark owns this
copy so that a later change to the program cannot move the yardstick.
"""

from __future__ import annotations

# the card's published peaks (NVIDIA H100 SXM data sheet, at 700 W):
# device-memory bytes/s and float32 operations/s outside the tensor cores
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12
# float64 outside the tensor cores (the same data sheet)
F64_OPS_S = 34e12


def bound_s(nbytes: float, ops: float, ops_s: float = F32_OPS_S) -> float:
    """The least time the card could take: the larger of the bytes over its
    memory rate and the operations over its rate for their type."""
    return max(nbytes / HBM_BYTES_S, ops / ops_s)


def b1_bytes(n: int, batch: int, itemsize: int) -> int:
    """B1 (tridiagonal solve): dl, d, du and b read once, x written once."""
    return 5 * n * batch * itemsize


def b1_ops(n: int, batch: int) -> int:
    """B1's arithmetic: about 9 operations a row of a Thomas solve."""
    return 9 * n * batch


def b2_bytes(ticks, got) -> int:
    """Bytes a B2 call must move with these inputs: valid once; the
    minutes of the valid rows; h, l and v of the rows that land in a
    bucket (each distinct tensor once); o and c once per nonempty bucket;
    five values, an int32 count and a bool a bucket out (25 bytes in
    float32, 45 in float64)."""
    minutes, o, h, l, c, v, valid = ticks
    distinct = lambda *ts: len({t.data_ptr() for t in ts})
    counted = int(got.count.sum())
    nonempty = int((got.count > 0).sum())
    size = v.element_size()
    return (valid.numel() + int(valid.sum()) * minutes.element_size()
            + counted * size * distinct(h, l, v) + nonempty * size * distinct(o, c)
            + got.count.numel() * (5 * size + 5))
