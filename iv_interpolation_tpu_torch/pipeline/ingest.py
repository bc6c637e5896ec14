"""Host-side ingest: ragged per-symbol time series -> padded batches (port
of ``iv_interpolation_tpu/pipeline/ingest.py``, NumPy and pandas only).

Each symbol's minute timeline is padded to the smallest configured
bucket length and symbols sharing a bucket are stacked into one batch;
the port packs the same batches as the JAX package (its
``max_slots_per_batch = 0`` behaviour: a batch is capped by
``batch_size`` alone).

Guardrails mirror the reference (src/interpolation/core.py):
  * < ``min_data_points`` observations -> skip          (core.py:26)
  * time span > ``max_span_days``     -> skip          (core.py:37)
  * timeline > ``max_timeline_points`` -> skip          (core.py:49)

Column semantics (core.py:58-68): ``iv``, ``underlying_price`` and
``time_to_maturity`` are interpolated; the rest are forward-filled.
``symbol``/``strike``/``callput`` are per-symbol constants kept on the
host.
"""

from __future__ import annotations

import threading
import time
from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import pandas as pd

from iv_interpolation_tpu_torch import native
from iv_interpolation_tpu_torch.utils import batch_pad, choose_bucket

INTERP_COLS = ("iv", "underlying_price", "time_to_maturity")
FFILL_COLS = ("interest_rate", "mark_price", "index_price", "volume",
              "quote_volume")
ALL_COLS = INTERP_COLS + FFILL_COLS

_MINUTE_NS = 60_000_000_000


#: host packing calls and their seconds, keyed by operation and packer
#: ("scatter native", "gather numpy", ...): float32 takes the native packer
#: where it builds, NumPy otherwise and for float64. The runner reports the
#: calls of a run under ``packer`` and the gathers' seconds in ``host_s``.
PACKER_CALLS: Counter = Counter()
PACKER_SECONDS: Counter = Counter()
_packer_lock = threading.Lock()


def packer_snapshot():
    """Copies of (PACKER_CALLS, PACKER_SECONDS), taken together."""
    with _packer_lock:
        return PACKER_CALLS.copy(), PACKER_SECONDS.copy()


def _count(op: str, ran_native: bool, t0: float) -> None:
    key = f"{op} {'native' if ran_native else 'numpy'}"
    with _packer_lock:
        PACKER_CALLS[key] += 1
        PACKER_SECONDS[key] += time.perf_counter() - t0


def full_nan(shape, dtype) -> np.ndarray:
    """All-NaN array via empty + slice-assign, which takes NumPy's
    vectorised fill (``np.full(shape, np.nan, float32)`` casts element by
    element, far slower at grid sizes)."""
    a = np.empty(shape, dtype)
    a[...] = a.dtype.type(np.nan)
    return a


@dataclass
class PackedBatch:
    """One length-bucket's worth of symbols, padded to a common timeline.

    Two storage forms:

    * **dense**: ``values``/``obs_mask``/``timeline_mask`` on the host.
    * **compact**: only the observations, ``obs_vals`` (N, C) with
      ``obs_row``/``obs_pos`` coordinates; the NaN grid is built on the
      device (``tasks.scatter_batch``). ``densify()`` builds the dense
      fields when host code needs them.
    """

    bucket_len: int
    symbols: List[str]
    t0_minutes: np.ndarray          # (B,) epoch minute of grid slot 0
    valid_len: np.ndarray           # (B,) actual timeline length
    values: Optional[np.ndarray] = None    # (B, C, L) float, NaN = missing
    obs_mask: Optional[np.ndarray] = None  # (B, L) bool, obs landed here
    timeline_mask: Optional[np.ndarray] = None  # (B, L) bool
    n_obs: np.ndarray = None        # (B,) source observation count
    const_cols: Dict[str, list] = field(default_factory=dict)
    columns: Sequence[str] = ALL_COLS
    # compact form (None when dense); padding entries have obs_row == B
    obs_vals: Optional[np.ndarray] = None   # (N, C)
    obs_row: Optional[np.ndarray] = None    # (N,) int32 row in [0, B)
    obs_pos: Optional[np.ndarray] = None    # (N,) int64 grid slot

    @property
    def batch(self) -> int:
        return len(self.symbols)

    @property
    def batch_padded(self) -> int:
        """B including shape padding."""
        return (self.values.shape[0] if self.values is not None
                else len(self.t0_minutes))

    def densify(self) -> "PackedBatch":
        """Build the dense grids on the host from the compact form."""
        if self.values is not None:
            return self
        B, L = self.batch_padded, self.bucket_len
        values, obs_mask = scatter_rows(self.obs_vals, self.obs_row, self.obs_pos, B, L)
        timeline_mask = (np.arange(L)[None, :]
                         < np.asarray(self.valid_len)[:, None])
        self.values, self.obs_mask, self.timeline_mask = (
            values, obs_mask, timeline_mask)
        return self


def scatter_rows(obs_vals: np.ndarray, obs_row: np.ndarray, obs_pos: np.ndarray,
                 B: int, L: int):
    """Dense (B, C, L) grids, NaN where nothing landed, and the (B, L)
    observation mask from compact observations (N, C) at rows ``obs_row``
    and slots ``obs_pos``; entries with a row outside [0, B) are padding
    and dropped. The native packer scatters float32 where it builds."""
    t0 = time.perf_counter()
    values = full_nan((B, obs_vals.shape[1], L), obs_vals.dtype)
    obs_mask = np.zeros((B, L), bool)
    real = (obs_row >= 0) & (obs_row < B)
    r, p = obs_row[real], obs_pos[real]
    ran = native.scatter_pack(obs_vals[real], r, p, np.ones(len(p), np.uint8),
                              values, obs_mask)
    if not ran:
        values[r, :, p] = obs_vals[real]
        obs_mask[r, p] = True
    _count("scatter", ran, t0)
    return values, obs_mask


@dataclass
class IngestResult:
    batches: List[PackedBatch]
    skipped: Dict[str, str]         # symbol -> reason


def bucket_batch_cap(bucket: int, max_batch: int,
                     max_slots: int = 0) -> int:
    """Per-bucket batch cap so batch x bucket_len stays within
    ``max_slots`` (0: no cap beyond ``max_batch``). The port packs with
    0: its batches are capped by ``max_batch`` alone."""
    if not max_slots:
        return max_batch
    return max(16, min(max_batch, max_slots // bucket))


def obs_pad(n: int) -> int:
    """Geometric schedule (1024, 2048, ...) for the compact observation
    count N. Padding entries carry the out-of-range row sentinel
    (obs_row == B) and are dropped by the device scatter."""
    m = 1024
    while m < n:
        m *= 2
    return m


def pack_symbols(df: pd.DataFrame, bucket_sizes: Sequence[int],
                 min_points: int = 10, max_span_days: int = 30,
                 max_timeline_points: int = 100_000,
                 freq_minutes: int = 1,
                 max_batch: int = 4096,
                 dtype=np.float32,
                 compact: bool = False) -> IngestResult:
    """Pack a tickers frame (reference ``trading_tickers`` layout: one row
    per (symbol, date) observation) into padded batches.

    Rows sharing a (symbol, epoch minute) keep the last one.
    ``compact=True`` leaves the dense grid to the device (see
    :class:`PackedBatch`).
    """
    if df.empty:
        return IngestResult(batches=[], skipped={})

    # sort by the computed epoch minutes, not the raw date column (a
    # string column sorts lexicographically); the stable lexsort keeps
    # input order within equal (symbol, time) keys, so keep='last' below
    # keeps the latest row. The datetime64[ns] cast pins the resolution
    # pandas would otherwise infer.
    ts_ns = (pd.to_datetime(df["date"]).astype("datetime64[ns]")
             .astype(np.int64).to_numpy())
    order = np.lexsort((ts_ns, df["symbol"].to_numpy()))
    df = df.iloc[order]
    minutes_all = ts_ns[order] // _MINUTE_NS
    # distinct timestamps inside one grid minute would give duplicate
    # (row, pos) scatter coordinates: keep the last row per minute
    dup = pd.DataFrame({
        "s": df["symbol"].to_numpy(),
        "m": minutes_all,
    }).duplicated(["s", "m"], keep="last").to_numpy()
    if dup.any():
        df = df[~dup]
        minutes_all = minutes_all[~dup]

    per_bucket: Dict[int, List[dict]] = {}
    skipped: Dict[str, str] = {}

    # every numeric grid column extracted once for the whole frame;
    # numpy fancy-indexing per chunk does the rest
    minutes_np = np.asarray(minutes_all)
    C_all = len(ALL_COLS)
    colmat_all = full_nan((len(df), C_all), dtype)
    for c, col in enumerate(ALL_COLS):
        if col in df.columns:
            colmat_all[:, c] = pd.to_numeric(
                df[col], errors="coerce").to_numpy(dtype)
    const_all = {cc: df[cc].to_numpy() for cc in ("strike", "callput")
                 if cc in df.columns}

    for symbol, idx in df.groupby("symbol", sort=True).indices.items():
        obs_min = minutes_np[idx]
        n = len(obs_min)
        if n < min_points:
            skipped[symbol] = f"insufficient data points: {n} < {min_points}"
            continue
        span_min = int(obs_min[-1] - obs_min[0])
        if span_min > max_span_days * 24 * 60:
            skipped[symbol] = f"time range too large: {span_min} minutes"
            continue
        L = span_min // freq_minutes + 1
        if L > max_timeline_points:
            skipped[symbol] = f"timeline too long: {L} points"
            continue
        bucket = choose_bucket(L, bucket_sizes)
        if bucket is None:
            skipped[symbol] = f"timeline {L} exceeds largest bucket"
            continue
        per_bucket.setdefault(bucket, []).append(
            dict(symbol=symbol, obs_min=obs_min, L=L, idx=idx))

    batches: List[PackedBatch] = []
    for bucket, items in sorted(per_bucket.items()):
        cap = bucket_batch_cap(bucket, max_batch)
        for lo in range(0, len(items), cap):
            chunk = items[lo:lo + cap]
            B_real = len(chunk)
            B = batch_pad(B_real, cap)
            C = len(ALL_COLS)
            symbols = [it["symbol"] for it in chunk]
            t0 = np.zeros(B, np.int64)
            t0[:B_real] = [it["obs_min"][0] for it in chunk]
            valid_len = np.zeros(B, np.int64)
            valid_len[:B_real] = [it["L"] for it in chunk]
            n_obs = np.zeros(B, np.int64)
            n_obs[:B_real] = [len(it["obs_min"]) for it in chunk]

            counts = n_obs[:B_real]
            row_sym = np.repeat(np.arange(B_real), counts)
            obs_all = np.concatenate([it["obs_min"] for it in chunk])
            rel = obs_all - t0[row_sym]
            # exact-grid alignment (the reference's left-merge on equal
            # timestamps, core.py:54-55): off-grid observations are
            # dropped from the grid but still bound the timeline
            on_grid = rel % freq_minutes == 0
            pos = (rel[on_grid] // freq_minutes).astype(np.int64)
            sym_on = row_sym[on_grid]
            colmat = colmat_all[np.concatenate(
                [it["idx"] for it in chunk])]

            consts: Dict[str, list] = {}
            for cc in ("strike", "callput"):
                vals = const_all.get(cc)
                if vals is None:
                    consts[cc] = [None] * B  # padding symbols stay None
                    continue
                # first non-null value per symbol (groupby().first())
                out_c: list = [None] * B
                for i, it in enumerate(chunk):
                    for j in it["idx"]:
                        v = vals[j]
                        if not pd.isna(v):
                            out_c[i] = v
                            break
                consts[cc] = out_c

            n_on = int(on_grid.sum())
            N = obs_pad(n_on)
            obs_vals = full_nan((N, C), dtype)
            obs_vals[:n_on] = colmat[on_grid]
            obs_row = np.full(N, B, np.int32)  # sentinel: dropped on device
            obs_row[:n_on] = sym_on
            obs_pos_arr = np.zeros(N, np.int64)
            obs_pos_arr[:n_on] = pos
            out = PackedBatch(
                bucket_len=bucket, symbols=symbols, t0_minutes=t0,
                valid_len=valid_len, n_obs=n_obs, const_cols=consts,
                obs_vals=obs_vals, obs_row=obs_row, obs_pos=obs_pos_arr,
            )
            if not compact:
                out.densify()
                out.obs_vals = out.obs_row = out.obs_pos = None
            batches.append(out)
    return IngestResult(batches=batches, skipped=skipped)


def gather_rows(grids: np.ndarray, sel_b: np.ndarray,
                sel_pos: np.ndarray) -> np.ndarray:
    """(B, C, L) grids -> (N, C) rows at (sel_b, sel_pos): the native
    packer's one sweep for float32 where it builds, else NumPy fancy
    indexing."""
    t0 = time.perf_counter()
    out = native.gather_unpack(grids, sel_b, sel_pos)
    ran = out is not None
    if not ran:
        out = grids[sel_b, :, sel_pos]
    _count("gather", ran, t0)
    return out


def unpack_interpolated(batch: PackedBatch, filled: np.ndarray,
                        valid: np.ndarray, is_interpolated: np.ndarray,
                        batch_id: int,
                        greeks: Optional[Dict[str, np.ndarray]] = None,
                        freq_minutes: int = 1) -> pd.DataFrame:
    """Grids -> the reference ``interpolated_trading_tickers`` layout
    (src/database/schema.py:21-52), valid rows only, vectorised over the
    batch."""
    sel_b, sel_pos = np.nonzero(np.asarray(valid))
    if not len(sel_b):
        return pd.DataFrame()
    dates = pd.to_datetime(
        (batch.t0_minutes[sel_b] + sel_pos * freq_minutes) * _MINUTE_NS)
    rows = gather_rows(np.asarray(filled), sel_b, sel_pos)
    # categorical symbols: integer codes, not millions of Python strings
    data = {"symbol": pd.Categorical.from_codes(sel_b, categories=batch.symbols),
            "date": dates}
    for c, col in enumerate(batch.columns):
        data[col] = rows[:, c]
    nsym = len(batch.symbols)
    strike = np.asarray(
        batch.const_cols.get("strike", [None] * nsym), object)
    callput = np.asarray(
        batch.const_cols.get("callput", [None] * nsym), object)
    data["strike"] = strike[sel_b]
    data["callput"] = callput[sel_b]
    data["is_interpolated"] = np.asarray(is_interpolated)[sel_b, sel_pos]
    if greeks is not None:
        for gname, garr in greeks.items():
            data[gname] = np.asarray(garr)[sel_b, sel_pos]
    data["batch_id"] = batch_id
    return pd.DataFrame(data)
