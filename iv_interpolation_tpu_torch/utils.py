"""Shared helpers: timestamp conversion, length bucketing and batch
padding (port of ``iv_interpolation_tpu/utils/__init__.py``).

The padding schedules keep a small fixed set of batch shapes, so the
port packs the same batches as the JAX package and a stored run written
by either resumes in the other with the same row layout.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def to_epoch_minutes(ts) -> np.ndarray:
    """Timestamps (pd.Series) -> int64 epoch minutes (floor).

    The explicit ``datetime64[ns]`` cast matters: pandas infers the
    resolution of parsed timestamps, and an int64 view of a coarser unit
    would not be nanoseconds."""
    import pandas as pd
    vals = pd.to_datetime(ts).astype("datetime64[ns]").astype(np.int64)
    return vals // (60 * 1_000_000_000)


def choose_bucket(length: int, bucket_sizes: Sequence[int]) -> Optional[int]:
    """Smallest configured bucket >= length (None if too long)."""
    for b in sorted(bucket_sizes):
        if length <= b:
            return b
    return None


def batch_pad(n: int, max_batch: int) -> int:
    """Pad a chunk's batch dim to the geometric schedule 16, 32, 64, ...
    capped at ``max_batch``."""
    b = 16
    while b < n and b < max_batch:
        b *= 2
    return min(b, max_batch)
