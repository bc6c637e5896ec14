"""Batched OHLCV bucket aggregation: the wrapper of kernel
``csrc/stream_agg.cu`` and its plain PyTorch version.

Port of ``iv_interpolation_tpu/ops/pallas/stream_agg_pallas.py``
(``aggregate_ohlcv_pallas``), same contract: all inputs (B, L), outputs
(B, num_segments); static ``bucket_minutes`` and ``base_bucket``; bucket
id ``floor(minute / bucket_minutes) - base_bucket``, ids outside
``[0, num_segments)`` and invalid rows dropped; open/close from the first
and last valid row by position. Outside the kernel, as in the reference:
the ``min_count`` validity test, NaN fill for empty buckets and volume 0.

:func:`aggregate_ohlcv_cuda` takes the plain version only for tensors on
the CPU. A CUDA tensor launches the kernel, or the call raises.
"""

from __future__ import annotations

import torch

from iv_interpolation_tpu_torch._build import check_launch, load_library
from iv_interpolation_tpu_torch.ops.segment_ohlcv import Candles

_MAX_TILE = 1024  # buckets per block; csrc/stream_agg.cu kMaxTile


def _prepare(minutes, o, h, l, c, v, valid, bucket_minutes, base_bucket,
             num_segments):
    """Cast to the kernel's types (int32 minutes, float32 values, bool
    valid), make contiguous, and check shapes and devices."""
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
    if bucket_minutes < 1 or num_segments < 1:
        raise ValueError(f"bucket_minutes and num_segments must be positive, "
                         f"got {bucket_minutes}, {num_segments}")
    if not all(-2**31 <= int(a) < 2**31 for a in (*minutes.shape, bucket_minutes,
                                                   base_bucket, num_segments)):
        raise ValueError("shapes, bucket_minutes, base_bucket and num_segments "
                         "must fit in int32")
    f32 = lambda a: a.to(torch.float32).contiguous()
    return (minutes.to(torch.int32).contiguous(), f32(o), f32(h), f32(l),
            f32(c), f32(v), valid.to(torch.bool).contiguous())


def _finish(open_, high, low, close, volume, count, min_count: int) -> Candles:
    empty = count == 0
    fix = lambda a: a.masked_fill(empty, float("nan"))
    return Candles(open=fix(open_), high=fix(high), low=fix(low),
                   close=fix(close), volume=volume.masked_fill(empty, 0.0),
                   count=count, valid=~empty & (count >= min_count))


def _aggregate_raw_plain(minutes, o, h, l, c, v, valid, bucket_minutes,
                         base_bucket, num_segments):
    B, L = minutes.shape
    seg = torch.div(minutes, bucket_minutes, rounding_mode="floor") - base_bucket
    ok = valid & (seg >= 0) & (seg < num_segments)
    # dropped rows go to an overflow slot that is sliced off; where()
    # (never a masked product) keeps their NaN/Inf payloads out
    idx = torch.where(ok, seg, num_segments).long()

    def reduce(src, how, init):
        out = torch.full((B, num_segments + 1), init, dtype=src.dtype,
                         device=src.device)
        out.scatter_reduce_(1, idx, src, how, include_self=True)
        return out[:, :num_segments]

    inf = float("inf")
    pos = torch.arange(L, device=minutes.device).expand(B, L)
    high = reduce(torch.where(ok, h, -inf), "amax", -inf)
    low = reduce(torch.where(ok, l, inf), "amin", inf)
    volume = reduce(torch.where(ok, v, 0.0), "sum", 0.0)
    count = reduce(ok.to(torch.int32), "sum", 0)
    first = reduce(torch.where(ok, pos, L), "amin", L)
    last = reduce(torch.where(ok, pos, -1), "amax", -1)
    # empty buckets read some row here; _finish replaces them with NaN
    open_ = torch.gather(o, 1, first.clamp(max=L - 1))
    close = torch.gather(c, 1, last.clamp(min=0))
    return open_, high, low, close, volume, count


def aggregate_ohlcv_plain(minutes, o, h, l, c, v, valid, *, bucket_minutes: int,
                          base_bucket: int = 0, num_segments: int,
                          min_count: int) -> Candles:
    """The plain PyTorch version: ``scatter_reduce`` (amax, amin, sum) on
    values selected by ``where``, and amin/amax of row positions for
    open/close. Runs on any device."""
    args = _prepare(minutes, o, h, l, c, v, valid, bucket_minutes,
                    base_bucket, num_segments)
    raw = _aggregate_raw_plain(*args, bucket_minutes, base_bucket, num_segments)
    return _finish(*raw, min_count)


def aggregate_ohlcv_cuda(minutes, o, h, l, c, v, valid, *, bucket_minutes: int,
                         base_bucket: int = 0, num_segments: int,
                         min_count: int) -> Candles:
    """OHLCV per bucket for every row of a (B, L) tick batch.

    CPU tensors run :func:`aggregate_ohlcv_plain`; CUDA tensors launch the
    aggregation kernel. ``aggregate_ohlcv_cuda.launches`` counts kernel
    launches. Volume from the kernel is a float32 sum in an order that
    varies between runs (shared-memory atomics); every other output is a
    selection or an integer and is exact.
    """
    args = _prepare(minutes, o, h, l, c, v, valid, bucket_minutes,
                    base_bucket, num_segments)
    device = args[0].device
    if device.type == "cpu":
        raw = _aggregate_raw_plain(*args, bucket_minutes, base_bucket,
                                   num_segments)
        return _finish(*raw, min_count)
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    B, L = args[0].shape
    out = [torch.empty((B, num_segments), dtype=torch.float32, device=device)
           for _ in range(5)]
    count = torch.empty((B, num_segments), dtype=torch.int32, device=device)
    if B > 0:
        lib = load_library()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = lib.ivt_stream_agg(
                *(a.data_ptr() for a in args), *(a.data_ptr() for a in out),
                count.data_ptr(), B, L, num_segments, bucket_minutes,
                base_bucket, min(num_segments, _MAX_TILE), stream)
        check_launch(err, "stream_agg")
        aggregate_ohlcv_cuda.launches += 1
    return _finish(*out, count, min_count)


aggregate_ohlcv_cuda.launches = 0
