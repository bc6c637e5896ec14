"""Sequence parallelism: timeline-sharded masked interpolation (port of
``iv_interpolation_tpu/parallel/sequence.py``).

A timeline longer than one device holds is cut into equal chunks along
its last axis, one a rank of a mesh axis. Each rank sends the others only
its first and last valid ``(position, value)``: all that linear
interpolation and forward fill need to bridge a gap across a chunk seam.
Positions travel in their own int64 all-gather, never in the values'
dtype (bfloat16 is integer-exact only to 256, float32 to 2^24).

:func:`local_masked_interp` fills this rank's chunk, which is the form a
timeline that never exists whole on one device takes;
:func:`sharded_masked_interp` takes and returns the whole tensor, as the
JAX function does. Both equal ``ops.interp.masked_interp`` on the whole
timeline bit for bit.
"""

from __future__ import annotations

import torch

from iv_interpolation_tpu_torch.ops.interp import _prev_next_valid, _take
from iv_interpolation_tpu_torch.parallel.mesh import Mesh, all_gather


def _local_fill(values, timeline_mask, offset: int, L_global: int,
                prev_in_pos, prev_in_val, next_in_pos, next_in_val,
                method: str, max_gap_minutes: int):
    """Fill one chunk given the carry-in boundary state of the other
    chunks. values/timeline_mask: (..., Lc); ``offset`` the chunk's global
    start; ``*_in_*``: (...,) global positions and values."""
    Lc = values.shape[-1]
    dtype = values.dtype
    gpos = torch.arange(Lc, device=values.device) + offset
    valid = torch.isfinite(values) & timeline_mask
    lp, ln = _prev_next_valid(valid)
    zeros = torch.where(valid, values, torch.zeros((), dtype=dtype, device=values.device))
    lp_val = _take(zeros, lp.clamp(0, Lc - 1))
    ln_val = _take(zeros, ln.clamp(0, Lc - 1))

    has_lp, has_ln = lp >= 0, ln < Lc
    prev_pos = torch.where(has_lp, lp + offset, prev_in_pos[..., None])
    prev_val = torch.where(has_lp, lp_val, prev_in_val[..., None])
    next_pos = torch.where(has_ln, ln + offset, next_in_pos[..., None])
    next_val = torch.where(has_ln, ln_val, next_in_val[..., None])
    has_prev = prev_pos >= 0
    has_next = next_pos < L_global

    if method == "linear":
        span = (next_pos - prev_pos).to(dtype)
        w = torch.where(span > 0, (gpos - prev_pos).to(dtype)
                        / torch.where(span > 0, span, 1.0), 0.0)
        interior = prev_val * (1.0 - w) + next_val * w
        filled = torch.where(has_next, interior, prev_val)
    elif method == "ffill":
        filled = prev_val
    else:
        raise ValueError(f"unsupported sharded method: {method!r}")

    nan = torch.full((), float("nan"), dtype=dtype, device=values.device)
    if max_gap_minutes > 0:
        too_wide = ~valid & has_prev & has_next & ((next_pos - prev_pos) > max_gap_minutes)
        filled = torch.where(too_wide, nan, filled)
    filled = torch.where(has_prev & timeline_mask, filled, nan)
    return torch.where(valid, values, filled)


def local_masked_interp(values: torch.Tensor, timeline_mask: torch.Tensor, mesh: Mesh,
                        L_global: int, axis_name: str = "data", method: str = "linear",
                        max_gap_minutes: int = 0) -> torch.Tensor:
    """``masked_interp`` of this rank's chunk ``(..., L_global / n)`` of a
    timeline cut over ``axis_name``; every rank of the axis calls it."""
    ax = mesh.axes[axis_name]
    Lc = values.shape[-1]
    if Lc * ax.size != L_global:
        raise ValueError(f"chunk {Lc} x {ax.size} ranks != timeline {L_global}")
    offset = ax.index * Lc
    valid = torch.isfinite(values) & timeline_mask
    any_valid = valid.any(-1)
    first_loc = torch.argmax(valid.to(torch.uint8), dim=-1)
    last_loc = (Lc - 1) - torch.argmax(valid.flip(-1).to(torch.uint8), dim=-1)
    zeros = torch.where(valid, values, torch.zeros((), dtype=values.dtype, device=values.device))
    at = lambda i: torch.gather(zeros, -1, i[..., None])[..., 0]
    last_pos = torch.where(any_valid, last_loc + offset, -1)
    first_pos = torch.where(any_valid, first_loc + offset, L_global)
    last_val = torch.where(any_valid, at(last_loc), 0.0)
    first_val = torch.where(any_valid, at(first_loc), 0.0)

    # (n, 2, ...): every chunk's last and first valid sample
    g_pos = all_gather(mesh, torch.stack([last_pos, first_pos])[None], axis_name)
    g_val = all_gather(mesh, torch.stack([last_val, first_val])[None], axis_name)
    shard = torch.arange(ax.size, device=values.device).reshape(
        (ax.size,) + (1,) * (g_pos.ndim - 2))
    # carry-in prev: the last valid sample of any earlier chunk (positions
    # grow with the chunk, so the largest); next: the first of any later one
    prev_masked = torch.where(shard < ax.index, g_pos[:, 0], -1)
    prev_pos, sel_prev = prev_masked.max(0)
    prev_val = torch.gather(g_val[:, 0], 0, sel_prev[None])[0]
    next_masked = torch.where(shard > ax.index, g_pos[:, 1], L_global)
    next_pos, sel_next = next_masked.min(0)
    next_val = torch.gather(g_val[:, 1], 0, sel_next[None])[0]
    return _local_fill(values, timeline_mask, offset, L_global, prev_pos, prev_val,
                       next_pos, next_val, method, max_gap_minutes)


def sharded_masked_interp(values: torch.Tensor, timeline_mask: torch.Tensor, mesh: Mesh,
                          axis_name: str = "data", method: str = "linear",
                          max_gap_minutes: int = 0) -> torch.Tensor:
    """``masked_interp`` with the trailing (timeline) axis cut over
    ``axis_name``: every rank passes the whole ``(..., L)`` tensor, fills
    its chunk and gets the whole result back. L must divide by the axis
    size; batch and column axes are replicated."""
    L = values.shape[-1]
    n = mesh.axes[axis_name].size
    if L % n:
        raise ValueError(f"timeline {L} not divisible by mesh axis {n}")
    Lc = L // n
    lo = mesh.axes[axis_name].index * Lc
    mask = torch.broadcast_to(timeline_mask, values.shape)
    out = local_masked_interp(values[..., lo:lo + Lc], mask[..., lo:lo + Lc], mesh, L,
                              axis_name, method, max_gap_minutes)
    return all_gather(mesh, out, axis_name, dim=-1)
