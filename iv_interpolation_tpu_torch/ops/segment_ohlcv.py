"""Candle aggregation as segment reductions, the Task-2 compute core (port
of ``iv_interpolation_tpu/ops/segment_ohlcv.py``).

1-minute OHLCV bars are bucketed by ``floor(minute / bucket_minutes)`` and
reduced with open = first, high = max, low = min, close = last, volume =
sum; buckets with fewer than ``min_count`` bars are marked invalid.

This module is the plain version, in the inputs' own dtype, on any
device. The reference's two modes (a scatter path and a scatter-free
sparse-table path for time-sorted rows, which existed to dodge a serial
scatter on the TPU) give the same candles here from one ``scatter_reduce``
path. Kernel B2 (``ops.cuda.stream_agg``) is the float32 CUDA version.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
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


def segment_reduce(seg: torch.Tensor, o, h, l, c, v, ok: torch.Tensor,
                   num_segments: int):
    """Per-bucket open, high, low, close, volume and count of (B, L) rows.

    ``seg`` holds each row's bucket id; rows with ``ok`` False or an id
    outside ``[0, num_segments)`` are dropped. open and close are the
    first and last kept row by position. Empty buckets hold arbitrary
    values here; :func:`finish_candles` fills them. Values keep their
    dtype; count is int32.
    """
    B, L = seg.shape
    ok = ok & (seg >= 0) & (seg < num_segments)
    # dropped rows go to an overflow slot that is sliced off; where()
    # (never a masked product) keeps their NaN/Inf payloads out
    idx = torch.where(ok, seg, num_segments).long()

    def reduce(src, how, init):
        out = torch.full((B, num_segments + 1), init, dtype=src.dtype,
                         device=src.device)
        out.scatter_reduce_(1, idx, src, how, include_self=True)
        return out[:, :num_segments]

    inf = float("inf")
    pos = torch.arange(L, device=seg.device).expand(B, L)
    high = reduce(torch.where(ok, h, -inf), "amax", -inf)
    low = reduce(torch.where(ok, l, inf), "amin", inf)
    volume = reduce(torch.where(ok, v, 0.0), "sum", 0.0)
    count = reduce(ok.to(torch.int32), "sum", 0)
    first = reduce(torch.where(ok, pos, L), "amin", L)
    last = reduce(torch.where(ok, pos, -1), "amax", -1)
    open_ = torch.gather(o, 1, first.clamp(max=L - 1))
    close = torch.gather(c, 1, last.clamp(min=0))
    return open_, high, low, close, volume, count


def finish_candles(open_, high, low, close, volume, count,
                   min_count: int) -> Candles:
    """NaN prices and zero volume in empty buckets; ``valid`` = non-empty
    and at least ``min_count`` rows."""
    empty = count == 0
    fix = lambda a: a.masked_fill(empty, float("nan"))
    return Candles(open=fix(open_), high=fix(high), low=fix(low),
                   close=fix(close), volume=volume.masked_fill(empty, 0.0),
                   count=count, valid=~empty & (count >= min_count))


def aggregate_ohlcv(minutes, o, h, l, c, v, valid, bucket_minutes, base_bucket,
                    *, num_segments: int, min_count: int,
                    assume_sorted: bool = False) -> Candles:
    """Aggregate 1-minute bars into ``bucket_minutes``-minute candles.

    Args:
      minutes: ``(L,)`` or ``(B, L)`` integer bar timestamps in minutes.
        Valid rows must be time-sorted (open/close are the first/last
        row of a bucket by position).
      o/h/l/c/v: OHLCV columns of the same shape.
      valid: bool, same shape: padding / missing-bar mask.
      bucket_minutes: int, the target frequency.
      base_bucket: int, or ``(B,)`` for batched inputs: the bucket id of
        output slot 0, so slot j covers bucket ``base_bucket + j``.
      num_segments: output length.
      min_count: incomplete-bucket threshold.
      assume_sorted: accepted for the reference's signature; both of its
        modes give these candles.

    Returns :class:`Candles` of shape ``(num_segments,)`` or
    ``(B, num_segments)``, values in the inputs' dtype.
    """
    del assume_sorted
    single = minutes.dim() == 1
    as2d = (lambda a: a[None]) if single else (lambda a: a)
    minutes = as2d(minutes)
    if minutes.is_floating_point():
        raise TypeError(f"minutes must be integers, got {minutes.dtype}")
    base = torch.as_tensor(base_bucket, device=minutes.device).long()
    base = base.reshape(-1, 1) if base.dim() else base
    seg = torch.div(minutes.long(), int(bucket_minutes), rounding_mode="floor") - base
    raw = segment_reduce(seg, *map(as2d, (o, h, l, c, v, valid)), num_segments)
    out = finish_candles(*raw, min_count)
    return Candles(*(a[0] for a in out)) if single else out


def validate_ohlcv(o, h, l, c, v, valid):
    """OHLC integrity: finite prices, high >= max(open, close, low), low <=
    min(open, close), volume >= 0, on valid rows (padding passes).

    Returns (all_ok: bool tensor, per-row ok mask)."""
    finite = torch.isfinite(o) & torch.isfinite(h) & torch.isfinite(l) & torch.isfinite(c)
    rel = (h >= l) & (h >= o) & (h >= c) & (l <= o) & (l <= c)
    ok = ~valid | (finite & rel & (v >= 0))
    return ok.all(), ok


def reconstruction_stats(count_in, candles: Candles, volume_in) -> dict:
    """Compression and volume-preservation statistics of a reconstruction
    (scalars as 0-dim tensors)."""
    device = candles.valid.device
    # numpy's dtypes for Python numbers: a float total stays float64
    scalar = lambda x: (x.to(device) if isinstance(x, torch.Tensor)
                        else torch.as_tensor(np.asarray(x), device=device))
    n_out = candles.valid.sum()
    count_in, volume_in = scalar(count_in), scalar(volume_in)
    vol_out = torch.where(candles.valid, candles.volume,
                          torch.zeros_like(candles.volume)).sum()
    return {
        "original_candles": count_in,
        "reconstructed_candles": n_out,
        "compression_ratio": torch.where(
            n_out > 0, count_in.double() / n_out.clamp_min(1).double(), 0.0),
        "total_volume_original": volume_in,
        "total_volume_reconstructed": vol_out,
        "volume_preservation": torch.where(
            volume_in > 0, (1.0 - vol_out / volume_in).abs(), 1.0),
    }
