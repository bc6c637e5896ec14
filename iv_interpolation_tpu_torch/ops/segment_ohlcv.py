"""Candle containers (port of ``iv_interpolation_tpu/ops/segment_ohlcv.py``).

Only :class:`Candles` is ported so far; the per-series ``aggregate_ohlcv``
and its sorted path wait (ROADMAP A3). The batched aggregation on the
streaming path is ``ops.cuda.stream_agg.aggregate_ohlcv_cuda``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Candles(NamedTuple):
    """A batch of candles on a dense bucket grid."""

    open: torch.Tensor
    high: torch.Tensor
    low: torch.Tensor
    close: torch.Tensor
    volume: torch.Tensor
    count: torch.Tensor  # source rows per bucket (int32)
    valid: torch.Tensor  # bool: bucket non-empty and count >= min_count
