"""The fused pipeline's device part over one packed batch (partial port of
``iv_interpolation_tpu/pipeline/runner.py``).

:func:`fused_batch` chains the three stages on one device with no storage
round-trip between them, as the reference's ``run_pipeline_fused`` does
for each batch (its ``dispatch`` and the readback of its ``finish``):
scatter -> interpolate (+ Greeks) -> price column and per-symbol keys ->
bridge -> quality gate -> 5-minute candles, then numpy arrays with the
symbol-level quality gate applied. The host runner around it (storage,
manifests, resume, the async writer, the CLI) is not ported yet.

``batch`` is any object with the fields of the JAX package's
``pipeline.ingest.PackedBatch``, dense or compact; ``config`` is read by
attribute (``interpolation``, ``data_bridge``, ``candle_reconstruction``,
``processing.dtype``), as the JAX package's ``Config`` lays it out. The
TPU-only knobs (``max_slots_per_batch``, the mesh) are not read.
"""

from __future__ import annotations

import math
import zlib
from typing import Callable, Dict, Optional

import numpy as np
import torch

from iv_interpolation_tpu_torch.ops import prng
from iv_interpolation_tpu_torch.ops.bridge import BridgeParams, validate_bridge_quality
from iv_interpolation_tpu_torch.pipeline import tasks

_FREQ_MIN = {"1min": 1, "5min": 5, "15min": 15, "30min": 30, "1h": 60}
_DTYPES = {"float32": np.float32, "float64": np.float64, "bfloat16": np.float32}
QUALITY_REASON = "OHLCV quality gate failed"


def symbol_fold(symbol: str) -> int:
    """Stable 31-bit fold-in value of a symbol's bridge PRNG key (CRC32,
    the same in every process and on every platform)."""
    return zlib.crc32(symbol.encode("utf-8")) & 0x7FFFFFFF


def parse_frequency(freq: str) -> int:
    """'5min' / '5m' / '1h' -> minutes."""
    if freq in _FREQ_MIN:
        return _FREQ_MIN[freq]
    if freq.endswith("min"):
        return int(freq[:-3])
    if freq.endswith("m"):
        return int(freq[:-1])
    if freq.endswith("h"):
        return int(freq[:-1]) * 60
    raise ValueError(f"Unsupported frequency: {freq}")


def _host_grids(batch):
    """(values, obs_mask) of the batch as dense numpy, built from the
    compact form when the batch has no dense grids."""
    if batch.values is not None:
        return np.asarray(batch.values), np.asarray(batch.obs_mask)
    B, L, C = len(batch.t0_minutes), batch.bucket_len, len(batch.columns)
    values = np.empty((B, C, L), batch.obs_vals.dtype)
    values[...] = np.nan
    obs_mask = np.zeros((B, L), bool)
    keep = (batch.obs_row >= 0) & (batch.obs_row < B)
    r, p = batch.obs_row[keep], batch.obs_pos[keep]
    values[r, :, p] = batch.obs_vals[keep]
    obs_mask[r, p] = True
    return values, obs_mask


def _obs_positions(batch):
    """(B, k) observation grid positions of a batch with one on-grid
    observation count k >= 2 across its non-empty rows, and whether the
    interpolated columns are NaN-free there. Empty (padding) rows get the
    first non-empty row's positions. (None, False) when the counts
    differ."""
    values, mask = _host_grids(batch)
    counts = mask.sum(axis=1)
    nonempty = counts > 0
    if not nonempty.any():
        return None, False
    k = int(counts[nonempty].max())
    if k < 2 or not (counts[nonempty] == k).all():
        return None, False
    pos = np.zeros((mask.shape[0], k), np.int64)
    pos[nonempty] = np.nonzero(mask)[1].reshape(-1, k)
    pos[~nonempty] = pos[nonempty][0]
    vals = np.take_along_axis(values[nonempty, :tasks._N_INTERP],
                              pos[nonempty][:, None, :], axis=2)
    return pos, bool(np.isfinite(vals).all())


def _to_float(v) -> float:
    try:
        return float(v)
    except (TypeError, ValueError):
        return math.nan


def _device_grids(batch, device):
    """(values, obs_mask, timeline_mask) on ``device``; a compact batch is
    scattered into its grid there."""
    put = lambda a: torch.as_tensor(np.asarray(a), device=device)
    if batch.values is not None:
        return put(batch.values), put(batch.obs_mask), put(batch.timeline_mask)
    return tasks.scatter_batch(
        put(batch.obs_vals), put(batch.obs_row), put(batch.obs_pos),
        put(batch.valid_len), B=len(batch.t0_minutes), C=len(batch.columns),
        L=batch.bucket_len)


def dispatch(batch, config, device: torch.device | str,
             on_stage: Optional[Callable[[str], None]] = None) -> dict:
    """Enqueue the three stages of one batch on ``device``; returns the
    device tensors. ``on_stage(name)``, when given, is called after each
    stage is enqueued: 'scatter', 'interpolate', 'bridge', 'quality',
    'candles' (a timer records an event there)."""
    icfg, bcfg = config.interpolation, config.data_bridge
    ccfg = config.candle_reconstruction
    mark = on_stage or (lambda name: None)
    freq = parse_frequency(icfg.frequency)
    tgt_freq = parse_frequency(ccfg.target_frequency)
    B_pad, L = len(batch.t0_minutes), batch.bucket_len

    values, obs_mask, timeline_mask = _device_grids(batch, device)
    mark("scatter")

    np_dtype = _DTYPES[config.processing.dtype]
    strikes = batch.const_cols.get("strike", [])
    strike = torch.as_tensor(np.array([_to_float(s) for s in strikes], np_dtype),
                             device=device)
    is_call = torch.as_tensor(np.array(
        [str(c).lower() in ("c", "call") for c in batch.const_cols.get("callput", [])],
        bool), device=device)
    # cubic needs one observation count per batch and NaN-free columns at
    # the observations; otherwise the batch falls back to linear
    method, obs_pos = icfg.method, None
    if method == "cubic":
        pos, clean = _obs_positions(batch)
        if clean:
            obs_pos = torch.as_tensor(pos, device=device)
        else:
            method = "linear"
    max_gap = icfg.max_gap_hours * 60 if icfg.max_gap_hours else 0
    out = tasks.interpolate_batch(values, obs_mask, timeline_mask, strike, is_call,
                                  method=method, max_gap_minutes=max_gap,
                                  compute_greeks=icfg.compute_greeks,
                                  extrapolate=icfg.extrapolate, obs_pos=obs_pos)
    mark("interpolate")

    price_col = tasks.select_price_columns(values, obs_mask)
    hashes = [symbol_fold(s) for s in batch.symbols]
    hashes += [0] * (B_pad - len(hashes))
    keys = prng.fold_in(prng.key(bcfg.seed, device),
                        torch.tensor(hashes, dtype=torch.int64, device=device))
    t0 = np.asarray(batch.t0_minutes, np.int64)
    minutes = (torch.as_tensor(t0, device=device)[:, None]
               + torch.arange(L, device=device)[None, :] * freq)
    base_bucket = torch.as_tensor(t0 // tgt_freq, device=device)
    params = BridgeParams(
        base_spread_percent=bcfg.base_spread_percent,
        volatility_factor=bcfg.volatility_factor,
        min_spread_percent=bcfg.min_spread_percent,
        trend_strength=bcfg.trend_strength, base_volume=bcfg.base_volume)
    ohlcv = tasks.bridge_batch(out["filled"], out["valid"], keys, params=params,
                               price_col=price_col,
                               strategy=bcfg.conversion_strategy,
                               abs_minutes=minutes)
    mark("bridge")

    quality_ok = None
    if bcfg.enable_quality_checks:
        base = torch.gather(out["filled"], 1,
                            price_col[:, None, None].expand(B_pad, 1, L))[:, 0]
        _, quality_ok = validate_bridge_quality(
            ohlcv["open"], ohlcv["high"], ohlcv["low"], ohlcv["close"], base,
            ohlcv["valid"], max_spread_frac=bcfg.max_spread_percent)
    mark("quality")

    candles = tasks.candles_batch(
        minutes, ohlcv, tgt_freq, base_bucket,
        num_segments=(L * freq + tgt_freq - 1) // tgt_freq + 1,
        min_count=ccfg.min_candles_required)
    mark("candles")
    return {**out, "price_col": price_col, "keys": keys, "minutes": minutes,
            "base_bucket": base_bucket, "ohlcv": ohlcv, "quality_ok": quality_ok,
            "candles": candles._asdict(), "method": method}


def _numpy(tree):
    if isinstance(tree, torch.Tensor):
        return tree.cpu().numpy()
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree


def quality_failures(symbols, ok_rows: np.ndarray) -> Dict[str, str]:
    """Symbols whose row fails the quality gate anywhere (padding rows,
    beyond ``len(symbols)``, are ignored)."""
    sym_ok = ok_rows.reshape(ok_rows.shape[0], -1).all(axis=1)
    return {s: QUALITY_REASON for i, s in enumerate(symbols) if not sym_ok[i]}


def _mask_failed_rows(symbols, failed: Dict[str, str], valid: np.ndarray) -> np.ndarray:
    """``valid`` with the rows of failed symbols cleared."""
    if not failed:
        return valid
    valid = np.array(valid)
    for i, s in enumerate(symbols):
        if s in failed:
            valid[i] = False
    return valid


def fused_batch(batch, config, device: torch.device | str,
                on_stage: Optional[Callable[[str], None]] = None) -> dict:
    """Interpolate -> bridge -> candles for one packed batch on ``device``.

    Returns numpy arrays over the padded batch: ``filled`` (B, C, L),
    ``valid``, ``is_interpolated``, ``greeks`` (dict, when computed),
    ``price_col`` (B,), ``keys`` (B, 2) (the symbols' bridge keys),
    ``minutes`` (B, L) and ``base_bucket`` (B,), ``ohlcv`` (dict of
    (B, L) 1-minute candles), ``candles`` (dict of the
    ``Candles`` fields, (B, S) target-frequency candles), ``quality_ok``
    (B, L) or None; ``failed`` (symbol -> reason) for symbols that failed
    the quality gate, whose rows are cleared from ``ohlcv['valid']`` and
    ``candles['valid']``; and ``method``, the interpolation method that ran
    (a cubic batch falls back to linear).
    """
    res = _numpy(dispatch(batch, config, device, on_stage))
    failed = {}
    if res["quality_ok"] is not None:
        failed = quality_failures(batch.symbols, res["quality_ok"])
    res["ohlcv"]["valid"] = _mask_failed_rows(batch.symbols, failed,
                                              res["ohlcv"]["valid"])
    res["candles"]["valid"] = _mask_failed_rows(batch.symbols, failed,
                                                res["candles"]["valid"])
    res["failed"] = failed
    return res
