"""Device-resident ring buffers for streaming tick windows (port of
``iv_interpolation_tpu/pipeline/ringbuffer.py``).

Layout: (B, C, L) ring with a per-stream cursor. Ingest blocks are padded
to the per-call largest tick count, so streams receive ragged valid runs;
each stream compacts its valid ticks and advances its own cursor by its
own count, so a sparse stream's older ticks are never overwritten by
another stream's padding. Reads return each stream's window in its own
chronological order. ``window_candles`` waits for ROADMAP A3.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class RingState(NamedTuple):
    data: torch.Tensor    # (B, C, L) rolling window
    valid: torch.Tensor   # (B, L) slot has real data
    cursor: torch.Tensor  # (B,) int32: next write slot per stream
    count: torch.Tensor   # (B,) int32: total ticks ever pushed per stream


def make_ring(batch: int, channels: int, length: int,
              dtype: torch.dtype = torch.float32,
              device: torch.device | str = "cpu") -> RingState:
    return RingState(
        data=torch.full((batch, channels, length), float("nan"), dtype=dtype,
                        device=device),
        valid=torch.zeros((batch, length), dtype=torch.bool, device=device),
        cursor=torch.zeros((batch,), dtype=torch.int32, device=device),
        count=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def push(state: RingState, rows: torch.Tensor,
         rows_valid: torch.Tensor) -> RingState:
    """Append ``rows`` (B, C, K) with validity (B, K), each stream at its
    own cursor, wrapping modulo L.

    Updates ``state``'s tensors in place (the counterpart of the
    reference's donated buffers: a streaming loop allocates no new ring)
    and returns ``state``.
    """
    data, valid, cursor, count = state
    B, C, L = data.shape
    K = rows.shape[-1]
    dev = data.device
    rows = rows.to(dtype=data.dtype, device=dev)
    rows_valid = rows_valid.to(dtype=torch.bool, device=dev)
    n = rows_valid.sum(dim=-1)                                  # (B,) int64
    # order-preserving compaction of each stream's valid ticks to a
    # prefix: valid tick j lands at rank cumsum - 1. Only valid (b, j) are
    # written (torch has no scatter drop mode), so padding never lands.
    rank = rows_valid.long().cumsum(dim=-1) - 1
    b_idx, j_idx = rows_valid.nonzero(as_tuple=True)
    staged = torch.zeros_like(rows)
    staged[b_idx, :, rank[b_idx, j_idx]] = rows[b_idx, :, j_idx]
    # only the newest L compacted ticks can survive; keeping just those
    # leaves no two writes to one slot
    out_k = min(K, L)
    drop = (n - out_k).clamp_min(0)                             # (B,)
    ar = torch.arange(out_k, device=dev)
    take = (ar[None, :] + drop[:, None]).clamp(0, max(K - 1, 0))
    gathered = torch.gather(staged, 2, take[:, None, :].expand(B, C, out_k))
    g_valid = ar[None, :] < (n - drop)[:, None]                 # (B, out_k)
    slots = (cursor[:, None].long() + ar[None, :]) % L          # (B, out_k)
    slots_c = slots[:, None, :].expand(B, C, out_k)
    old = torch.gather(data, 2, slots_c)
    data.scatter_(2, slots_c, torch.where(g_valid[:, None, :], gathered, old))
    valid.scatter_(1, slots, g_valid | torch.gather(valid, 1, slots))
    cursor.copy_((cursor.long() + n - drop) % L)
    count.add_(n.to(count.dtype))
    return state


def window(state: RingState):
    """Each stream's ring contents in chronological order: (data, valid)
    with the oldest slot first. Slots never written stay NaN/False."""
    data, valid, cursor, count = state
    B, C, L = data.shape
    start = torch.where(count >= L, cursor, torch.zeros_like(cursor)).long()
    idx = (start[:, None] + torch.arange(L, device=data.device)) % L
    return (torch.gather(data, 2, idx[:, None, :].expand(B, C, L)),
            torch.gather(valid, 1, idx))
