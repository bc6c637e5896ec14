"""Streaming session: tick ingestion + periodic surface refit (port of
``iv_interpolation_tpu/pipeline/stream_service.py``).

Ticks stream in per underlying and land in a device-resident tick ring
(updated in place); ``refit()`` re-derives candles, realized vol and
arbitrage-checked surfaces for every underlying in one
``streaming_step``. One card: the reference's ``mesh`` argument waits for
ROADMAP A3.
"""

from __future__ import annotations

import time
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch

from iv_interpolation_tpu_torch.ops.spline_matrix import build_surface_operators_batched
from iv_interpolation_tpu_torch.pipeline.ringbuffer import RingState, make_ring, push, window
from iv_interpolation_tpu_torch.pipeline.streaming import StreamingOut, streaming_step
from iv_interpolation_tpu_torch.surface.surface import common_support_grid

_CH_MINUTE, _CH_PRICE, _CH_SIZE = 0, 1, 2
_INVALID_KEY = 2 ** 30


def _sort_window_by_minute(minute, price, size, ok):
    """Stable per-row sort by minute with invalid rows keyed last: gives
    streaming_step time-sorted valid rows for any tick arrival order."""
    key = torch.where(ok, minute, torch.full_like(minute, _INVALID_KEY))
    order = torch.sort(key, dim=-1, stable=True).indices
    take = lambda a: torch.gather(a, -1, order)
    return take(minute), take(price), take(size), take(ok)


class StreamingSession:
    """Stateful streaming engine over a fixed underlying universe.

    Args:
      underlyings: ordered list of underlying ids (row index of the batch).
      chain_k/iv/T: (B, E, n) / (B, E, n) / (B, E) quote surfaces used as
        the refit baseline (tensors or arrays; moved to ``device``).
      window_minutes: lookback window for candles and realized vol.
      tick_capacity: per-underlying tick-ring slots.
      n_grid: dense eval grid points per expiry.
      spline_bc: boundary condition of the refit operators.
      device: where the chains, operators and ring live: the card unless
        the caller passes another (``device="cpu"`` for CPU tensors).
    """

    def __init__(self, underlyings: List[str], chain_k, chain_iv, chain_T,
                 window_minutes: int = 512, tick_capacity: int = 8192,
                 n_grid: int = 50, spline_bc: str = "not-a-knot",
                 device: torch.device | str = "cuda"):
        self.underlyings = list(underlyings)
        self.index: Dict[str, int] = {u: i for i, u in
                                      enumerate(self.underlyings)}
        B = len(self.underlyings)
        self.window_minutes = int(window_minutes)
        self.n_grid = int(n_grid)
        self.device = torch.device(device)
        as_dev = lambda a: torch.as_tensor(a, device=self.device)
        self.chain_k = as_dev(chain_k)
        self.chain_iv = as_dev(chain_iv)
        self.chain_T = as_dev(chain_T)
        # the quote grids are fixed for the session, so the spline refit is
        # a linear map of the rescaled knot variances: build each
        # underlying's eval operators once, and every refit is one product
        queries = common_support_grid(self.chain_k, self.n_grid)
        self.spline_ops = build_surface_operators_batched(
            self.chain_k, queries, bc_type=spline_bc)
        # tick ring channels: [minute, price, size]
        self.ring: RingState = make_ring(B, 3, int(tick_capacity),
                                         dtype=torch.float32,
                                         device=self.device)
        self.latest_minute: int = 0
        self.n_ticks_seen = 0
        # the ring's minute channel is float32, exact for integers only up
        # to 2^24 (~16.7M); epoch minutes (~29.8M) would round to even
        # values and land in wrong 1-min buckets. Minutes are rebased to
        # the first minute ingested before they enter the ring; the public
        # API stays absolute (latest_minute, refit(now_minute=...)).
        self._minute_base: Optional[int] = None

    def ingest_ticks(self, ticks: Mapping) -> int:
        """Append ticks given as columns ``underlying``, ``minute``,
        ``price`` and ``size`` (a pandas DataFrame or a dict of arrays).
        Returns rows ingested; unknown underlyings are dropped.

        All underlyings' rows of one call go to the ring as one padded
        (B, 3, K) block.
        """
        und = np.asarray(ticks["underlying"])
        keep = np.fromiter((u in self.index for u in und), bool, len(und))
        if not keep.any():
            return 0
        rows = np.asarray([self.index[u] for u in und[keep]])
        B = len(self.underlyings)
        K = int(np.bincount(rows, minlength=B).max())
        block = np.zeros((B, 3, K), np.float32)
        valid = np.zeros((B, K), bool)
        order = np.argsort(rows, kind="stable")
        rows_s = rows[order]
        minute_abs = np.asarray(ticks["minute"], np.int64)[keep][order]
        if self._minute_base is None:
            self._minute_base = int(minute_abs.min())
        minute = (minute_abs - self._minute_base).astype(np.float32)
        price = np.asarray(ticks["price"], np.float32)[keep][order]
        size = np.asarray(ticks["size"], np.float32)[keep][order]
        # position within each underlying's run
        pos = np.arange(len(rows_s)) - np.searchsorted(rows_s, rows_s)
        block[rows_s, _CH_MINUTE, pos] = minute
        block[rows_s, _CH_PRICE, pos] = price
        block[rows_s, _CH_SIZE, pos] = size
        valid[rows_s, pos] = True
        push(self.ring, torch.from_numpy(block).to(self.device),
             torch.from_numpy(valid).to(self.device))
        self.latest_minute = max(self.latest_minute, int(minute_abs.max()))
        self.n_ticks_seen += len(rows_s)
        return len(rows_s)

    def refit(self, now_minute: Optional[int] = None) -> StreamingOut:
        """Refit every underlying from the ticks inside the lookback window
        ending at ``now_minute`` (default: the latest ingested minute)."""
        now = self.latest_minute if now_minute is None else int(now_minute)
        # ring minutes are rebased (see __init__): translate the absolute
        # window start into ring coordinates
        start = now - self.window_minutes + 1 - (self._minute_base or 0)
        data, valid = window(self.ring)
        minute_rel = (data[:, _CH_MINUTE] - float(start)).to(torch.int32)
        in_window = valid & (minute_rel >= 0) \
            & (minute_rel < self.window_minutes)
        # ring order is arrival order, which late ticks and wrap-around
        # break; a stable sort restores time order within the window and
        # keeps arrival order within a minute
        m, p, s, ok = _sort_window_by_minute(
            minute_rel, data[:, _CH_PRICE], data[:, _CH_SIZE], in_window)
        return streaming_step(
            m, p, s, ok, self.chain_k, self.chain_iv, self.chain_T,
            n_minutes=self.window_minutes, n_grid=self.n_grid,
            spline_ops=self.spline_ops)

    def stats(self) -> dict:
        L = int(self.ring.data.shape[-1])
        return {
            "underlyings": len(self.underlyings),
            "ticks_seen": self.n_ticks_seen,
            "ring_capacity": L,
            "ring_fill": int(self.ring.count.clamp(max=L).max()),
            "latest_minute": self.latest_minute,
        }


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_stream_replay(config, n_underlyings: int = 64,
                      window_minutes: int = 256, chunks: int = 8,
                      ticks_per_chunk: int = 200, seed: int = 0,
                      device: torch.device | str | None = None) -> dict:
    """Synthetic streaming replay: GBM ticks ingested chunk by chunk with a
    refit after each (``iv-tpu-torch --task stream``). ``config`` is the
    port's ``iv_interpolation_tpu_torch.config.Config`` (its
    ``surface.grid_strikes`` is read). Runs on the card
    (``device=None`` means ``"cuda"``) unless ``device`` names another;
    CPU callers pass ``device="cpu"``. Returns throughput and
    diagnostics."""
    device = torch.device("cuda" if device is None else device)
    rng = np.random.default_rng(seed)
    unds = [f"u{i:04d}" for i in range(n_underlyings)]
    E, n = 4, 12
    k = np.broadcast_to(np.linspace(-0.8, 0.8, n, dtype=np.float32),
                        (n_underlyings, E, n))
    T = np.broadcast_to(np.linspace(0.1, 1.0, E, dtype=np.float32),
                        (n_underlyings, E))
    iv = 0.5 + 0.05 * k * k
    sess = StreamingSession(unds, k.copy(), iv, T.copy(),
                            window_minutes=window_minutes,
                            tick_capacity=4 * window_minutes,
                            n_grid=config.surface.grid_strikes, device=device)
    per_min = 0.5 / np.sqrt(365.25 * 24 * 60)
    paths = 100.0 * np.exp(np.cumsum(
        rng.normal(0, per_min, (n_underlyings, window_minutes)), axis=-1))

    total_ticks = 0
    refit_s = []
    span = window_minutes // chunks
    out = None
    for c in range(chunks):
        lo, hi = c * span, (c + 1) * span
        cols = {"minute": [], "price": [], "size": []}
        for i in range(n_underlyings):
            minutes = np.sort(rng.integers(lo, hi, ticks_per_chunk))
            cols["minute"].append(minutes)
            cols["price"].append(paths[i, minutes])
            cols["size"].append(rng.uniform(0, 5, ticks_per_chunk))
        ticks = {name: np.concatenate(parts) for name, parts in cols.items()}
        ticks["underlying"] = np.repeat(unds, ticks_per_chunk)
        total_ticks += sess.ingest_ticks(ticks)
        _sync(device)
        t0 = time.perf_counter()
        out = sess.refit(now_minute=hi - 1)
        _sync(device)
        refit_s.append(time.perf_counter() - t0)

    return {
        "underlyings": n_underlyings,
        "chunks": chunks,
        "ticks_ingested": total_ticks,
        "device": str(device),
        "warm_refit_ms": round(sorted(refit_s)[len(refit_s) // 2] * 1e3, 1),
        "realized_vol_mean": round(float(out.realized_vol.mean()), 4),
        "butterfly_ok": int(out.butterfly_ok.sum()),
        "stats": sess.stats(),
    }
