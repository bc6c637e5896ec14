"""Batched OHLCV bucket aggregation: the wrapper of kernel
``csrc/stream_agg.cu`` and its plain PyTorch version.

Port of ``iv_interpolation_tpu/ops/pallas/stream_agg_pallas.py``
(``aggregate_ohlcv_pallas``), same contract: all inputs (B, L), outputs
(B, num_segments); static ``bucket_minutes`` and ``base_bucket``; bucket
id ``floor(minute / bucket_minutes) - base_bucket``, ids outside
``[0, num_segments)`` and invalid rows dropped; open/close from the first
and last valid row by position. After the reduction, as in the
reference: the ``min_count`` validity test, NaN fill for empty buckets
and volume 0 (:func:`finish_candles` in the plain version, the kernel's
epilogue on the card).

:func:`aggregate_ohlcv_cuda` takes the plain version only for tensors on
the CPU. A CUDA tensor launches the kernel, or the call raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from iv_interpolation_tpu_torch._build import check_launch, load_library
from iv_interpolation_tpu_torch.ops.segment_ohlcv import (
    Candles,
    finish_candles,
    segment_reduce,
)

MAX_TILE = 8192   # float32 buckets a block holds in shared memory; csrc kMaxTile
MAX_TILE_F64 = 6144   # float64 buckets: 36 bytes each in the 227 KiB a block may hold
_DTYPES = {torch.float32: "", torch.float64: "_f64"}   # value dtype -> symbol suffix
_INT32 = (-2**31, 2**31 - 1)


class AggPlan(NamedTuple):
    """How one (B, L) -> num_segments call launches: ``tile`` buckets a
    block, ``tiles`` blocks a row (each reads the row once), ``threads``
    a block, ``smem`` bytes of shared memory a block."""
    tile: int
    tiles: int
    threads: int
    smem: int


def agg_plan(L: int, num_segments: int,
             dtype: torch.dtype = torch.float32) -> AggPlan:
    """The launch plan, by shape and value dtype: one block a row holds all
    the row's buckets in shared memory (24 bytes each in float32, up to
    :data:`MAX_TILE`; 36 bytes in float64, whose images and volume are 8
    bytes wide, up to :data:`MAX_TILE_F64`), so the row is read once;
    beyond that the buckets split into tiles of that size and each tile's
    block reads the row. A thread takes 4 ticks a pass, so a block has
    ceil(L / 4) threads rounded up to a power of two, from 64 to 512."""
    if L < 1 or num_segments < 1:
        raise ValueError(f"L and num_segments must be positive, got {L}, {num_segments}")
    if dtype not in _DTYPES:
        raise TypeError(f"no aggregation kernel for {dtype} values")
    wide = dtype == torch.float64
    tile = min(num_segments, MAX_TILE_F64 if wide else MAX_TILE)
    tiles = -(-num_segments // tile)
    threads = min(512, max(64, 1 << (-(-L // 4) - 1).bit_length()))
    return AggPlan(tile, tiles, threads, (36 if wide else 24) * tile)


def _check(minutes, o, h, l, c, v, valid, bucket_minutes, base_bucket,
           num_segments) -> None:
    """Shapes, devices and scalar ranges of a call; casts nothing."""
    arrays = (minutes, o, h, l, c, v, valid)
    if minutes.dim() != 2:
        raise ValueError(f"expected (B, L) inputs, got {tuple(minutes.shape)}")
    if any(a.shape != minutes.shape for a in arrays):
        raise ValueError(f"inputs must share one (B, L) shape: "
                         f"{[tuple(a.shape) for a in arrays]}")
    if any(a.device != minutes.device for a in arrays):
        raise ValueError(f"inputs on different devices: {[a.device for a in arrays]}")
    if minutes.shape[1] < 1:
        raise ValueError(f"empty tick window: L={minutes.shape[1]}")
    if minutes.is_floating_point():
        raise TypeError(f"minutes must be integers, got {minutes.dtype}")
    if bucket_minutes < 1 or num_segments < 1:
        raise ValueError(f"bucket_minutes and num_segments must be positive, "
                         f"got {bucket_minutes}, {num_segments}")
    if not all(_INT32[0] <= int(a) <= _INT32[1] for a in (
            *minutes.shape, bucket_minutes, base_bucket, num_segments)):
        raise ValueError("shapes, bucket_minutes, base_bucket and num_segments "
                         "must fit in int32")


def aggregate_ohlcv_plain(minutes, o, h, l, c, v, valid, *, bucket_minutes: int,
                          base_bucket: int = 0, num_segments: int,
                          min_count: int) -> Candles:
    """The plain PyTorch version: ``scatter_reduce`` (amax, amin, sum) on
    values selected by ``where``, and amin/amax of row positions for
    open/close. Runs on any device, in the values' own dtype."""
    _check(minutes, o, h, l, c, v, valid, bucket_minutes, base_bucket,
           num_segments)
    seg = torch.div(minutes.long(), bucket_minutes, rounding_mode="floor") - base_bucket
    raw = segment_reduce(seg, o, h, l, c, v, valid.to(torch.bool), num_segments)
    return finish_candles(*raw, min_count)


def aggregate_ohlcv_cuda(minutes, o, h, l, c, v, valid, *, bucket_minutes: int,
                         base_bucket: int = 0, num_segments: int,
                         min_count: int) -> Candles:
    """OHLCV per bucket for every row of a (B, L) tick batch.

    CPU tensors run :func:`aggregate_ohlcv_plain` in their own dtype.
    CUDA tensors launch the aggregation kernel, which takes int32 or int64
    minutes as they are (other integer types widen to int64) and float32
    or float64 values, all five of one dtype (mixed or other dtypes
    raise); the outputs are in the values' dtype. Nothing reads the device
    on the host, so the call can be captured in a CUDA graph.
    ``aggregate_ohlcv_cuda.launches`` counts kernel launches and
    ``aggregate_ohlcv_cuda.launches_by_dtype`` the same launches by the
    values' dtype name (``"float32"``, ``"float64"``). Volume from the
    kernel is a sum in the values' dtype in an order that varies between
    runs (shared-memory atomics); every other output is a selection or an
    integer and is exact.
    """
    _check(minutes, o, h, l, c, v, valid, bucket_minutes, base_bucket,
           num_segments)
    values = (o, h, l, c, v)
    dtype = o.dtype
    if dtype not in _DTYPES or any(a.dtype != dtype for a in values):
        raise TypeError("o, h, l, c and v must all be float32 or all float64: "
                        f"{[a.dtype for a in values]}")
    device = minutes.device
    if device.type == "cpu":
        return aggregate_ohlcv_plain(
            minutes, o, h, l, c, v, valid, bucket_minutes=bucket_minutes,
            base_bucket=base_bucket, num_segments=num_segments,
            min_count=min_count)
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    if minutes.dtype not in (torch.int32, torch.int64):
        minutes = minutes.to(torch.int64)
    args = (minutes.contiguous(), *(a.contiguous() for a in values),
            valid.to(torch.bool).contiguous())
    B, L = minutes.shape
    ohlcv = [torch.empty((B, num_segments), dtype=dtype, device=device)
             for _ in range(5)]
    count = torch.empty((B, num_segments), dtype=torch.int32, device=device)
    ok = torch.empty((B, num_segments), dtype=torch.bool, device=device)
    if B > 0:
        plan = agg_plan(L, num_segments, dtype)
        width = "i32" if minutes.dtype == torch.int32 else "i64"
        fn = getattr(load_library(), f"ivt_stream_agg_{width}{_DTYPES[dtype]}")
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = fn(*(a.data_ptr() for a in (*args, *ohlcv, count, ok)),
                     B, L, num_segments, bucket_minutes, base_bucket,
                     max(_INT32[0], min(_INT32[1], int(min_count))),
                     plan.tile, plan.threads, stream)
        check_launch(err, "stream_agg")
        aggregate_ohlcv_cuda.launches += 1
        aggregate_ohlcv_cuda.launches_by_dtype[str(dtype)[6:]] += 1
    return Candles(*ohlcv, count=count, valid=ok)


aggregate_ohlcv_cuda.launches = 0
aggregate_ohlcv_cuda.launches_by_dtype = {"float32": 0, "float64": 0}
