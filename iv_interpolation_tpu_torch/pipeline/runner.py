"""Pipeline runner: storage -> packed batches -> the three stages on the
device -> storage, with run manifests, resume and failure isolation (port
of ``iv_interpolation_tpu/pipeline/runner.py``).

Two layers:

* :func:`fused_batch` (:func:`dispatch`, then :func:`readback`) chains the
  three stages of one packed batch on one device with no storage
  round-trip between them: scatter -> interpolate (+ Greeks) -> price
  column and per-symbol keys -> bridge -> quality gate -> 5-minute
  candles, then numpy arrays with the symbol-level quality gate applied.
  ``batch`` is any object with the fields of ``pipeline.ingest.
  PackedBatch``, dense or compact; ``config`` is read by attribute
  (``interpolation``, ``data_bridge``, ``candle_reconstruction``,
  ``processing.dtype``).
* :class:`PipelineRunner` runs the job from store to store: the fused
  path (``run_pipeline_fused``, a depth-2 dispatch/finish queue and one
  writer thread), the staged path (``run_task1`` -> ``run_bridge`` ->
  ``run_task2``, ``run_all``), per-symbol manifests with resume, retries,
  quality-gate isolation and ``--shard`` ownership. It runs on the card
  unless built with ``device="cpu"``.

Under a mesh (``processing.mesh_shape`` over ``torch.distributed`` ranks,
``parallel.mesh``) every rank runs the same runner: it computes its block
of each batch's rows on its own device, and rank 0 gathers the rows,
unpacks and writes them. Rank 0 alone reads the store (each read is
broadcast, so every rank packs the same batches), decides the work list,
the batch id and the resume set, and writes the manifests; a rank's
error is shared before any gather, so a failed batch takes the same
branch on every rank.

The JAX package's compile-wall cap (``processing.max_slots_per_batch``)
is not read.
"""

from __future__ import annotations

import math
import tempfile
import time
import zlib
from collections import defaultdict, deque
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional

import numpy as np
import pandas as pd
import torch

from iv_interpolation_tpu_torch.monitoring.logging import PerformanceLogger, get_logger
from iv_interpolation_tpu_torch.monitoring.metrics import StepMetrics
from iv_interpolation_tpu_torch.ops import prng
from iv_interpolation_tpu_torch.ops.bridge import BridgeParams, validate_bridge_quality
from iv_interpolation_tpu_torch.ops.segment_ohlcv import validate_ohlcv
from iv_interpolation_tpu_torch.parallel.mesh import (Mesh, agree, any_rank, collect,
                                                      from_leader, gather_objects,
                                                      pipeline_mesh, rank_store, world_info)
from iv_interpolation_tpu_torch.pipeline import ingest, tasks
from iv_interpolation_tpu_torch.pipeline import storage as st
from iv_interpolation_tpu_torch.pipeline.manifest import RunManifest, free_batch_id
from iv_interpolation_tpu_torch.utils import to_epoch_minutes

_FREQ_MIN = {"1min": 1, "5min": 5, "15min": 15, "30min": 30, "1h": 60}
_DTYPES = {"float32": np.float32, "float64": np.float64, "bfloat16": np.float32}
QUALITY_REASON = "OHLCV quality gate failed"
#: the manifest names of the three stages, in pipeline order
STAGE_NAMES = ("interpolation", "bridge", "candles")
_log = get_logger("pipeline")


def symbol_fold(symbol: str) -> int:
    """Stable 31-bit fold-in value of a symbol's bridge PRNG key (CRC32,
    the same in every process and on every platform, so a resumed run
    draws what the first run drew)."""
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
    return ingest.scatter_rows(batch.obs_vals, batch.obs_row, batch.obs_pos,
                               len(batch.t0_minutes), batch.bucket_len)


def _split_by_obs_count(batch: ingest.PackedBatch,
                        max_batch: Optional[int] = None):
    """Split a dense packed batch by on-grid observation count, so each
    sub-batch has the one count k that the batched cubic spline needs.
    Each sub-batch is padded to the packing's shape schedule
    (``batch_pad``) with all-masked rows. The key is the on-grid count
    (``obs_mask`` row sums), which :func:`_obs_positions` checks, not the
    source count: off-grid observations make the two differ."""
    grid_counts = np.asarray(batch.obs_mask).sum(axis=1)
    real = batch.n_obs > 0
    counts = np.unique(grid_counts[real])
    if len(counts) <= 1:
        return [batch]
    out = []
    for k in counts:
        rows = np.flatnonzero((grid_counts == k) & real)
        B_real = len(rows)
        B = ingest.batch_pad(B_real, max_batch) if max_batch else B_real
        pad = B - B_real

        def take(a, fill=0):
            sel = a[rows]
            if pad:
                tail = np.full((pad,) + sel.shape[1:], fill, sel.dtype)
                sel = np.concatenate([sel, tail])
            return sel

        out.append(ingest.PackedBatch(
            bucket_len=batch.bucket_len,
            symbols=[batch.symbols[i] for i in rows if i < len(batch.symbols)],
            t0_minutes=take(batch.t0_minutes),
            valid_len=take(batch.valid_len),
            values=take(batch.values, fill=np.nan),
            obs_mask=take(batch.obs_mask),
            timeline_mask=take(batch.timeline_mask),
            n_obs=take(batch.n_obs),
            const_cols={c: [v[i] for i in rows] + [None] * pad
                        for c, v in batch.const_cols.items()},
            columns=batch.columns,
        ))
    return out


def _take_rows(batch, lo: int, hi: int):
    """Rows ``lo:hi`` of a packed batch (dense or compact) as a batch of
    their own: a rank's block under a mesh. Compact observations of other
    rows are dropped; the padding entries keep the row sentinel."""
    sl = lambda a: None if a is None else a[lo:hi]
    kw = dict(bucket_len=batch.bucket_len, symbols=list(batch.symbols[lo:hi]),
              t0_minutes=sl(batch.t0_minutes), valid_len=sl(batch.valid_len),
              values=sl(batch.values), obs_mask=sl(batch.obs_mask),
              timeline_mask=sl(batch.timeline_mask), n_obs=sl(batch.n_obs),
              const_cols={c: list(v[lo:hi]) for c, v in batch.const_cols.items()},
              columns=batch.columns)
    if batch.obs_row is not None:
        keep = (batch.obs_row >= lo) & (batch.obs_row < hi)
        n = int(keep.sum())
        N = ingest.obs_pad(n)
        obs_vals = ingest.full_nan((N,) + batch.obs_vals.shape[1:], batch.obs_vals.dtype)
        obs_vals[:n] = batch.obs_vals[keep]
        obs_row = np.full(N, hi - lo, batch.obs_row.dtype)
        obs_row[:n] = batch.obs_row[keep] - lo
        obs_pos = np.zeros(N, batch.obs_pos.dtype)
        obs_pos[:n] = batch.obs_pos[keep]
        kw.update(obs_vals=obs_vals, obs_row=obs_row, obs_pos=obs_pos)
    return ingest.PackedBatch(**kw)


def _block_of(batch, mesh: Optional[Mesh], cubic: bool = False):
    """(this rank's block of ``batch``, the cubic observation positions of
    its rows or None). The positions are found on the whole batch: a
    block of padding rows alone has none. Without a mesh, or where the
    rows do not split over it, the whole batch."""
    obs = _obs_positions(batch) if cubic else None
    rows = mesh.block(len(batch.t0_minutes)) if mesh is not None else None
    if rows is None:
        return batch, obs
    lo, hi = rows
    if obs is not None and obs[0] is not None:
        obs = (obs[0][lo:hi], obs[1])
    return _take_rows(batch, lo, hi), obs


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


def _interpolate(batch, config, device, grids, obs=None):
    """Task 1 of one batch on ``device``: (outputs, method that ran). A
    cubic batch needs one on-grid observation count and NaN-free
    interpolated columns at the observations; otherwise it falls back to
    linear, with a warning. ``obs``: the batch's ``_obs_positions``, when
    the caller found them (on the whole batch of a block)."""
    icfg = config.interpolation
    values, obs_mask, timeline_mask = grids
    np_dtype = _DTYPES[config.processing.dtype]
    strikes = batch.const_cols.get("strike", [])
    strike = torch.as_tensor(np.array([_to_float(s) for s in strikes], np_dtype),
                             device=device)
    is_call = torch.as_tensor(np.array(
        [str(c).lower() in ("c", "call") for c in batch.const_cols.get("callput", [])],
        bool), device=device)
    method, obs_pos = icfg.method, None
    if method == "cubic":
        pos, clean = obs if obs is not None else _obs_positions(batch)
        if clean:
            obs_pos = torch.as_tensor(pos, device=device)
        else:
            _log.warning("cubic: NaN at observations or mixed observation "
                         "counts in bucket L=%d, falling back to linear",
                         batch.bucket_len)
            method = "linear"
    max_gap = icfg.max_gap_hours * 60 if icfg.max_gap_hours else 0
    out = tasks.interpolate_batch(values, obs_mask, timeline_mask, strike, is_call,
                                  method=method, max_gap_minutes=max_gap,
                                  compute_greeks=icfg.compute_greeks,
                                  extrapolate=icfg.extrapolate, obs_pos=obs_pos)
    return out, method


def _bridge_params(bcfg) -> BridgeParams:
    return BridgeParams(
        base_spread_percent=bcfg.base_spread_percent,
        volatility_factor=bcfg.volatility_factor,
        min_spread_percent=bcfg.min_spread_percent,
        trend_strength=bcfg.trend_strength, base_volume=bcfg.base_volume)


def _bridge_keys(symbols, B_pad: int, seed: int, device) -> torch.Tensor:
    """One bridge key per symbol, folded from its name's CRC32 (order-free
    and process-stable); shape-padding rows get a dummy key."""
    hashes = [symbol_fold(s) for s in symbols]
    hashes += [0] * (B_pad - len(hashes))
    return prng.fold_in(prng.key(seed, device),
                        torch.tensor(hashes, dtype=torch.int64, device=device))


def _price_base(filled: torch.Tensor, price_col: torch.Tensor) -> torch.Tensor:
    B, _, L = filled.shape
    return torch.gather(filled, 1, price_col.long()[:, None, None].expand(B, 1, L))[:, 0]


def dispatch(batch, config, device: torch.device | str,
             on_stage: Optional[Callable[[str], None]] = None,
             mesh: Optional[Mesh] = None) -> dict:
    """Enqueue the three stages of one batch on ``device``; returns the
    device tensors. ``on_stage(name)``, when given, is called after each
    stage is enqueued: 'scatter', 'interpolate', 'bridge', 'quality',
    'candles' (a timer records an event there). Under ``mesh``, this
    rank's block of the batch's rows."""
    icfg, bcfg = config.interpolation, config.data_bridge
    ccfg = config.candle_reconstruction
    mark = on_stage or (lambda name: None)
    batch, obs = _block_of(batch, mesh, cubic=icfg.method == "cubic")
    freq = parse_frequency(icfg.frequency)
    tgt_freq = parse_frequency(ccfg.target_frequency)
    B_pad, L = len(batch.t0_minutes), batch.bucket_len

    grids = _device_grids(batch, device)
    mark("scatter")
    out, method = _interpolate(batch, config, device, grids, obs)
    mark("interpolate")

    values, obs_mask, _ = grids
    price_col = tasks.select_price_columns(values, obs_mask)
    keys = _bridge_keys(batch.symbols, B_pad, bcfg.seed, device)
    t0 = np.asarray(batch.t0_minutes, np.int64)
    minutes = (torch.as_tensor(t0, device=device)[:, None]
               + torch.arange(L, device=device)[None, :] * freq)
    base_bucket = torch.as_tensor(t0 // tgt_freq, device=device)
    ohlcv = tasks.bridge_batch(out["filled"], out["valid"], keys,
                               params=_bridge_params(bcfg), price_col=price_col,
                               strategy=bcfg.conversion_strategy,
                               abs_minutes=minutes)
    mark("bridge")

    quality_ok = None
    if bcfg.enable_quality_checks:
        _, quality_ok = validate_bridge_quality(
            ohlcv["open"], ohlcv["high"], ohlcv["low"], ohlcv["close"],
            _price_base(out["filled"], price_col), ohlcv["valid"],
            max_spread_frac=bcfg.max_spread_percent)
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
    """Tensors -> numpy, dict keys sorted as ``jax.tree.map`` orders them
    (so the Greek columns of the interpolated table come out in the JAX
    package's order)."""
    if isinstance(tree, torch.Tensor):
        return tree.cpu().numpy()
    if isinstance(tree, dict):
        return {k: _numpy(tree[k]) for k in sorted(tree)}
    return tree


def quality_failures(symbols, ok_rows: np.ndarray,
                     reason: str = QUALITY_REASON) -> Dict[str, str]:
    """Symbols whose row fails a per-row check anywhere (padding rows,
    beyond ``len(symbols)``, are ignored)."""
    sym_ok = ok_rows.reshape(ok_rows.shape[0], -1).all(axis=1)
    return {s: reason for i, s in enumerate(symbols) if not sym_ok[i]}


def _mask_failed_rows(symbols, failed: Dict[str, str], valid: np.ndarray) -> np.ndarray:
    """``valid`` with the rows of failed symbols cleared."""
    if not failed:
        return valid
    valid = np.array(valid)
    for i, s in enumerate(symbols):
        if s in failed:
            valid[i] = False
    return valid


def readback(batch, dev: dict, mesh: Optional[Mesh] = None) -> Optional[dict]:
    """The device tensors of :func:`dispatch` -> numpy (waits for the
    device), with the symbol-level quality gate applied. Under ``mesh``
    every rank passes its block's tensors (or, under ``"error"``, what its
    dispatch raised); rank 0 gets the whole batch, the others None."""
    def block():
        if "error" in dev:
            raise dev["error"]
        return dev

    dev = collect(mesh, block, rows=len(batch.t0_minutes))
    if dev is None:
        return None
    res = _numpy(dev)
    failed = {}
    if res["quality_ok"] is not None:
        failed = quality_failures(batch.symbols, res["quality_ok"])
    res["ohlcv"]["valid"] = _mask_failed_rows(batch.symbols, failed,
                                              res["ohlcv"]["valid"])
    res["candles"]["valid"] = _mask_failed_rows(batch.symbols, failed,
                                                res["candles"]["valid"])
    res["failed"] = failed
    return res


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
    return readback(batch, dispatch(batch, config, device, on_stage))


def _unpack_candles(batch, ohlcv: Dict[str, np.ndarray],
                    freq_minutes: int = 1) -> pd.DataFrame:
    """1-minute candle grids -> the ``minute_candles`` layout, valid rows."""
    sel_b, sel_pos = np.nonzero(np.asarray(ohlcv["valid"]))
    if not len(sel_b):
        return pd.DataFrame()
    ts = pd.to_datetime(
        (batch.t0_minutes[sel_b] + sel_pos * freq_minutes) * 60_000_000_000)
    return pd.DataFrame({
        "symbol": pd.Categorical.from_codes(sel_b, categories=batch.symbols),
        "timestamp": ts,
        **{f: ohlcv[f][sel_b, sel_pos]
           for f in ("open", "high", "low", "close", "volume")},
    })


def _unpack_aggregated(batch, agg: Dict[str, np.ndarray], freq: int,
                       src_freq: int, freq_name: str, created_at,
                       base_bucket=None) -> pd.DataFrame:
    """Target-frequency candle grids -> the ``reconstructed_candles``
    layout, valid rows. ``base_bucket`` defaults to the staged task 2's
    convention, ``t0_minutes`` in source-interval units."""
    if base_bucket is None:
        base_bucket = batch.t0_minutes * src_freq // freq
    sel_b, sel_pos = np.nonzero(np.asarray(agg["valid"]))
    if not len(sel_b):
        return pd.DataFrame()
    ts = pd.to_datetime((base_bucket[sel_b] + sel_pos) * freq * 60_000_000_000)
    return pd.DataFrame({
        "symbol": pd.Categorical.from_codes(sel_b, categories=batch.symbols),
        "timestamp": ts,
        **{f: agg[f][sel_b, sel_pos]
           for f in ("open", "high", "low", "close", "volume")},
        "frequency": freq_name,
        "source_candles": freq // src_freq,
        "created_at": created_at,
    })


def _per_symbol(df: pd.DataFrame) -> pd.Series:
    return df.groupby("symbol", observed=True).size() if len(df) else pd.Series(dtype=int)


class PipelineRunner:
    """End-to-end three-stage pipeline over a storage adapter: on the card
    unless ``device`` names another (``"cpu"`` for CPU tensors; without a
    card a run on ``"cuda"`` raises), and under ``processing.mesh_shape``
    on every rank of the launched world (``self.mesh``), each on its own
    device."""

    #: batches in flight in ``run_pipeline_fused``: batch i+1 is
    #: dispatched before batch i is read back (1: each batch in turn)
    queue_depth = 2

    def __init__(self, config, store=None, device: torch.device | str = "cuda"):
        self.config = config
        self.log = get_logger("pipeline")
        # the data-parallel mesh of processing.mesh_shape over the launched
        # ranks (None on one device); a shape the world cannot hold raises
        self.mesh = pipeline_mesh(config.processing.mesh_shape,
                                  config.processing.mesh_axis_names, device=device)
        self.device = self.mesh.device if self.mesh is not None else torch.device(device)
        #: rank 0 of the mesh, or the only process: it writes and reports
        self.leader = self.mesh is None or self.mesh.is_leader
        if self.mesh is not None:
            self.log.info("pipeline mesh: shape=%s rank %d on %s (%s)", self.mesh.shape,
                          self.mesh.rank, self.device, self.mesh.backend)
        # touch the device now: a runner that cannot reach it fails here,
        # before it reads the store or writes a manifest
        torch.empty(0, device=self.device)
        if store is None and self.leader:
            store = st.get_store(config.storage)
        self.store = rank_store(store, self.mesh)
        # the other ranks keep their manifests out of the run's directory
        self._scratch = None if self.leader else tempfile.TemporaryDirectory(
            prefix="ivtorch-rank-manifests-")
        self.manifest_dir = (config.checkpoint.manifest_dir if self.leader
                             else self._scratch.name)
        self.perf = PerformanceLogger()
        self.metrics = StepMetrics(
            snapshot_dir=config.monitoring.snapshot_dir
            if config.monitoring.enable_snapshots and self.leader else None)
        self.np_dtype = _DTYPES[config.processing.dtype]
        # cooperative stop flag, checked between batches; unfinished
        # symbols stay 'pending' in the manifest for --resume
        self.stop_requested = False
        # host seconds by phase of the fused path: read_pack, dispatch,
        # readback, unpack, write (the writer thread's), and gather (the
        # host packer's row gathers, a part of unpack)
        self.host_s: Dict[str, float] = defaultdict(float)

    def request_stop(self) -> None:
        self.stop_requested = True

    def _stopping(self) -> bool:
        """The stop flag, agreed across the ranks (any rank's stop stops
        every rank after the same batch)."""
        return any_rank(self.mesh, self.stop_requested)

    def _decide(self, fn):
        """``fn()`` decided on rank 0 (manifest reads, the batch id) and
        given to every rank."""
        return from_leader(self.mesh, fn)

    def completed_symbols(self, name: str, batch_id) -> List[str]:
        """The symbols a stage's manifest records completed (rank 0's)."""
        return self._decide(lambda: sorted(
            s for s, r in self._manifest(name, batch_id).records().items()
            if r.status == "completed"))

    def world_report(self) -> dict:
        """The world of a run, for its JSON: size, rank, backend, the mesh
        and every rank's peak device memory (bytes; 0 on CPU ranks).
        Collective under a mesh: every rank calls it."""
        peak = (torch.cuda.max_memory_allocated(self.device)
                if self.device.type == "cuda" else 0)
        peaks = gather_objects(self.mesh, int(peak))
        self.metrics.rank_peak_bytes = peaks
        return {**world_info(), "device": str(self.device),
                "mesh_shape": dict(self.mesh.shape) if self.mesh is not None else None,
                "peak_bytes_by_rank": peaks}

    def install_signal_handler(self) -> None:
        """SIGINT -> graceful stop after the current batch."""
        import signal

        def handler(signum, frame):
            self.log.warning("interrupt received — stopping after the "
                             "current batch (resume with --resume)")
            self.stop_requested = True

        signal.signal(signal.SIGINT, handler)

    @contextmanager
    def _clock(self, phase: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.host_s[phase] += time.perf_counter() - t0

    def _shard_symbols(self, symbols: List[str]) -> List[str]:
        """Process-level symbol partition (processing.shard_index /
        shard_count): process i of n owns symbol s iff crc32(s) % n == i.
        Ownership depends on the name alone, so the rule is idempotent and
        order-free: safe after discovery, resume or an explicit list."""
        n = self.config.processing.shard_count
        if n <= 1:
            return symbols
        i = self.config.processing.shard_index
        if not (0 <= i < n):
            # wrapping with % n would alias another shard's partition
            raise ValueError(
                f"processing.shard_index={i} out of range for "
                f"shard_count={n} (want 0 <= index < count)")
        return [s for s in symbols if symbol_fold(s) % n == i]

    def _manifest_name(self, name: str) -> str:
        """Under --shard I/N the task name gains a per-shard suffix, so
        each process writes its own jsonl."""
        n = self.config.processing.shard_count
        return f"{name}.shard{self.config.processing.shard_index}" if n > 1 else name

    def _manifest(self, name: str, resume_batch_id=None,
                  new_batch_id=None) -> RunManifest:
        """Stage manifest: the one of ``resume_batch_id``, a new one under
        ``new_batch_id`` (an id that ``_free_batch_id`` found free), else a
        new one under a fresh id."""
        return RunManifest(
            self.manifest_dir, self._manifest_name(name),
            resume_batch_id if resume_batch_id is not None else new_batch_id,
            flush_interval=self.config.checkpoint.checkpoint_interval)

    def _free_batch_id(self) -> int:
        """One batch id free for all three stages: a run whose stages
        share it is resumed by it in every stage."""
        return self._decide(lambda: free_batch_id(
            self.manifest_dir, [self._manifest_name(n) for n in STAGE_NAMES]))

    def _on_block(self, batch, compute, cubic: bool = False):
        """``compute(rows, obs)`` on this rank's block of ``batch`` (the
        whole batch without a mesh; ``obs`` the cubic observation
        positions of its rows, or None) -> device tensors; returns the
        whole batch's as numpy on rank 0 and None on the other ranks."""
        dev = collect(self.mesh, lambda: compute(*_block_of(batch, self.mesh, cubic)),
                      rows=len(batch.t0_minutes))
        return None if dev is None else _numpy(dev)

    def _symbol_chunks(self, symbols: List[str]):
        """The requested symbols in groups of ``read_chunk_symbols``, so
        each storage read is bounded."""
        n = self.config.processing.read_chunk_symbols
        if not n or n >= len(symbols):
            yield symbols
            return
        for lo in range(0, len(symbols), n):
            yield symbols[lo:lo + n]

    def _iter_packed_batches(self, symbols, skip, start_date=None,
                             end_date=None):
        """Read and pack one bounded symbol chunk at a time (the staged
        task 1 and the fused path share it). A requested symbol with no
        observations in the date window, or absent from the table, gets a
        skip record; a cubic run's batches are packed dense and split by
        observation count."""
        cfg = self.config.interpolation
        freq = parse_frequency(cfg.frequency)
        for chunk_syms in self._symbol_chunks(symbols):
            with self._clock("read_pack"):
                df = self.store.read(st.TICKERS, symbols=chunk_syms)
                if start_date is not None and len(df):
                    df = df[pd.to_datetime(df["date"])
                            >= pd.to_datetime(start_date)]
                if end_date is not None and len(df):
                    df = df[pd.to_datetime(df["date"])
                            <= pd.to_datetime(end_date)]
                present = (set(df["symbol"].astype(str).unique())
                           if len(df) else set())
                for sym in chunk_syms:
                    if str(sym) not in present:
                        skip(sym, "no observations (unknown symbol or "
                                  "empty date window)")
                packed = ingest.pack_symbols(
                    df, self.config.processing.bucket_sizes,
                    min_points=cfg.min_data_points,
                    max_span_days=cfg.max_span_days,
                    max_timeline_points=cfg.max_timeline_points,
                    freq_minutes=freq,
                    max_batch=self.config.processing.batch_size,
                    dtype=self.np_dtype,
                    # the cubic split walks host-side masks
                    compact=(cfg.method != "cubic"),
                )
                for sym, reason in packed.skipped.items():
                    skip(sym, reason)
                bs = packed.batches
                if cfg.method == "cubic":
                    bs = [b for orig in bs for b in _split_by_obs_count(
                        orig, self.config.processing.batch_size)]
            yield from bs

    def _attempt(self, label: str, fn):
        """Run a batch computation with ``checkpoint.max_retries``
        retries. Returns (result, None) or (None, last_error). Under a mesh
        the ranks agree after each attempt, so all of them retry, or give
        up, together."""
        retries = self.config.checkpoint.max_retries
        last = None
        for attempt in range(retries + 1):
            out, err = None, None
            try:
                out = fn()
            except Exception as e:  # noqa: BLE001 — failure isolation
                err = e
            try:
                agree(self.mesh, err)
            except Exception as e:  # noqa: BLE001 — the mesh's verdict
                err = e
            if err is None:
                return out, None
            last = err
            if attempt < retries:
                self.log.warning("%s attempt %d/%d failed: %s — retrying",
                                 label, attempt + 1, retries + 1, err)
        self.log.exception("%s failed after %d attempts", label, retries + 1,
                           exc_info=last)
        return None, last

    def _open_stage(self, name: str, symbols, resume_batch_id, table: str,
                    limit: Optional[int] = None, new_batch_id: Optional[int] = None):
        """A staged task's manifest and symbols: the pending symbols of a
        resumed batch, else ``symbols``, else every symbol of ``table``;
        cut to ``limit``, sharded, recorded pending and flushed (so
        --resume can re-enqueue the run after an early crash). A new
        manifest takes ``new_batch_id`` when ``run_all`` gives one."""
        manifest = self._manifest(name, resume_batch_id, new_batch_id)
        if resume_batch_id is not None:
            symbols = self._decide(manifest.pending_symbols)
            self.log.info("resume %s batch %s: %d pending symbols", name,
                          resume_batch_id, len(symbols))
        if symbols is None:
            symbols = self.store.list_symbols(table)
        if limit:
            symbols = symbols[:limit]
        symbols = self._shard_symbols(symbols)
        manifest.initialize_symbols(symbols)
        manifest.flush()
        return manifest, symbols

    def _run_batches(self, stage: str, manifest: RunManifest, batches, process) -> None:
        """The staged stages' loop: each batch through ``process`` with
        retries; a batch that keeps failing marks its symbols 'error' and
        the run goes on. Under a mesh ``process`` returns None on every
        rank but 0."""
        for batch in batches:
            if self._stopping():
                break
            t0 = time.time()
            with self.metrics.step(f"{stage}/L{batch.bucket_len}", items=batch.batch):
                result, err = self._attempt(
                    f"{stage} bucket L={batch.bucket_len}",
                    lambda batch=batch: process(batch))
            if err is not None:
                for sym in batch.symbols:
                    manifest.error_symbol(sym, str(err), time.time() - t0)
                continue
            if not self.leader:
                continue
            result_df, failed = result
            share = (time.time() - t0) / batch.batch
            per_sym = _per_symbol(result_df)
            for i, sym in enumerate(batch.symbols):
                if sym in failed:
                    # deterministic validation failure: the symbol alone
                    # errors, no retries spent
                    manifest.error_symbol(sym, failed[sym], share)
                    continue
                n_in, n_out = int(batch.n_obs[i]), int(per_sym.get(sym, 0))
                manifest.complete_symbol(sym, n_in, n_out, share)
                if stage == "task1":
                    self.perf.log_symbol_processed(sym, n_in, n_out, share)
        manifest.flush()

    # ------------------------------------------------------------------
    # Task 1 — IV interpolation
    # ------------------------------------------------------------------
    def run_task1(self, symbols: Optional[List[str]] = None,
                  resume_batch_id: Optional[int] = None,
                  limit: Optional[int] = None,
                  start_date=None, end_date=None, *,
                  _new_batch_id: Optional[int] = None) -> dict:
        """Interpolate hourly tickers to the minute grid with Greeks.
        ``start_date``/``end_date`` (any pandas-parseable timestamp)
        restrict the observation window."""
        manifest, symbols = self._open_stage("interpolation", symbols, resume_batch_id,
                                             st.TICKERS, limit, _new_batch_id)
        if not symbols:
            return manifest.summary()

        t_start = time.time()
        self.perf.log_batch_start(manifest.batch_id, len(symbols))
        freq = parse_frequency(self.config.interpolation.frequency)

        def compute(rows, obs):
            grids = _device_grids(rows, self.device)
            return _interpolate(rows, self.config, self.device, grids, obs)[0]

        def process(batch):
            out_np = self._on_block(batch, compute,
                                    cubic=self.config.interpolation.method == "cubic")
            if out_np is None:
                return None
            result_df = ingest.unpack_interpolated(
                batch, out_np["filled"], out_np["valid"],
                out_np["is_interpolated"], manifest.batch_id,
                greeks=out_np.get("greeks"), freq_minutes=freq)
            self.store.write(st.INTERPOLATED, result_df,
                             upsert_keys=["symbol", "date"])
            return result_df, {}

        self._run_batches("task1", manifest, self._iter_packed_batches(
            symbols, manifest.skip_symbol, start_date, end_date), process)
        summary = manifest.summary()
        self.perf.log_batch_complete(manifest.batch_id, time.time() - t_start,
                                     summary["output_rows"])
        return summary

    # ------------------------------------------------------------------
    # Data bridge — interpolated -> synthetic 1-min OHLCV
    # ------------------------------------------------------------------
    def run_bridge(self, symbols: Optional[List[str]] = None,
                   batch_id: Optional[int] = None,
                   resume_batch_id: Optional[int] = None, *,
                   _new_batch_id: Optional[int] = None) -> dict:
        """Synthesize 1-minute OHLCV from the interpolated table.
        ``batch_id`` converts only that task-1 batch's rows."""
        cfg = self.config.data_bridge
        manifest, symbols = self._open_stage("bridge", symbols, resume_batch_id,
                                             st.INTERPOLATED, new_batch_id=_new_batch_id)
        if not symbols:
            return manifest.summary()

        # the stored rows are interpolation.frequency apart; the grid and
        # the candle timestamps use the same spacing as the fused path
        freq = parse_frequency(self.config.interpolation.frequency)
        read_cols = ["symbol", "date"] + list(ingest.ALL_COLS)
        if batch_id is not None:
            read_cols.append("batch_id")
        # the price-source priority rule (first of underlying / mark /
        # index price with >= 80 % coverage, ohlcv_converter.py:189-207)
        # is evaluated over the raw quotes: every stored interpolated row
        # has its columns filled, so only TICKERS can answer it, as the
        # fused path's select_price_columns does at the observations
        price_choice: Dict[str, int] = {}

        def choose_price_cols(chunk_syms) -> None:
            prio = ["underlying_price", "mark_price", "index_price"]
            raw = self.store.read(st.TICKERS, symbols=chunk_syms,
                                  columns=["symbol"] + prio)
            for sym, g in raw.groupby("symbol"):
                n = max(len(g), 1)
                fr = [(g[c].notna().sum() / n if c in g.columns else 0.0)
                      for c in prio]
                good = [i for i, f in enumerate(fr) if f >= 0.8]
                anyd = [i for i, f in enumerate(fr) if f > 0.0]
                pick = good[0] if good else (anyd[0] if anyd else 0)
                price_choice[sym] = ingest.ALL_COLS.index(prio[pick])

        def iter_batches():
            for chunk_syms in self._symbol_chunks(symbols):
                df = self.store.read(st.INTERPOLATED, symbols=chunk_syms,
                                     columns=read_cols)
                if batch_id is not None and "batch_id" in df.columns:
                    df = df[df["batch_id"] == batch_id]
                choose_price_cols(chunk_syms)
                packed = ingest.pack_symbols(
                    df, self.config.processing.bucket_sizes, min_points=1,
                    max_span_days=self.config.interpolation.max_span_days,
                    max_timeline_points=self.config.interpolation.max_timeline_points,
                    freq_minutes=freq,
                    max_batch=self.config.processing.batch_size,
                    dtype=self.np_dtype, compact=True)
                for sym, reason in packed.skipped.items():
                    manifest.skip_symbol(sym, reason)
                yield from packed.batches

        def compute(rows, _obs):
            dev = self.device
            values, b_obs_mask, mask = _device_grids(rows, dev)
            B_pad = rows.batch_padded
            # the stored rows are post-fill; on the grid they sit at the
            # observation positions, padding in between
            filled = tasks.interpolate_batch(
                values, b_obs_mask, mask,
                torch.full((B_pad,), float("nan"), dtype=values.dtype, device=dev),
                torch.zeros((B_pad,), dtype=torch.bool, device=dev),
                method="ffill", compute_greeks=False)
            up = ingest.ALL_COLS.index("underlying_price")
            pc = np.zeros(B_pad, np.int64)
            pc[:len(rows.symbols)] = [price_choice.get(s, up) for s in rows.symbols]
            price_col = torch.as_tensor(pc, device=dev)
            # absolute epoch minutes of the grid rows: the draws key on
            # them, so candles match the fused path's
            abs_min = (torch.as_tensor(np.asarray(rows.t0_minutes), device=dev)[:, None]
                       + torch.arange(rows.bucket_len, device=dev)[None, :] * freq)
            ohlcv = tasks.bridge_batch(
                filled["filled"], filled["valid"] & b_obs_mask,
                _bridge_keys(rows.symbols, B_pad, cfg.seed, dev),
                params=_bridge_params(cfg), price_col=price_col,
                strategy=cfg.conversion_strategy, abs_minutes=abs_min)
            ok = None
            if cfg.enable_quality_checks:
                _, ok = validate_bridge_quality(
                    ohlcv["open"], ohlcv["high"], ohlcv["low"], ohlcv["close"],
                    _price_base(filled["filled"], price_col), ohlcv["valid"],
                    max_spread_frac=cfg.max_spread_percent)
            return {"ohlcv": ohlcv, "ok": ok}

        def process(batch):
            res = self._on_block(batch, compute)
            if res is None:
                return None
            failed: Dict[str, str] = {}
            if res["ok"] is not None:
                failed = quality_failures(batch.symbols, res["ok"])
            ohlcv_np = res["ohlcv"]
            ohlcv_np["valid"] = _mask_failed_rows(batch.symbols, failed,
                                                  ohlcv_np["valid"])
            result_df = _unpack_candles(batch, ohlcv_np, freq_minutes=freq)
            self.store.write(st.MINUTE_CANDLES, result_df,
                             upsert_keys=["symbol", "timestamp"])
            return result_df, failed

        self._run_batches("bridge", manifest, iter_batches(), process)
        return manifest.summary()

    # ------------------------------------------------------------------
    # Task 2 — candle reconstruction
    # ------------------------------------------------------------------
    def run_task2(self, symbols: Optional[List[str]] = None,
                  resume_batch_id: Optional[int] = None, *,
                  _new_batch_id: Optional[int] = None) -> dict:
        """Aggregate the 1-minute candles to the target frequency; on the
        card each batch launches the aggregation kernel (B2) once."""
        cfg = self.config.candle_reconstruction
        manifest, symbols = self._open_stage("candles", symbols, resume_batch_id,
                                             st.MINUTE_CANDLES, new_batch_id=_new_batch_id)
        if not symbols:
            return manifest.summary()

        freq = parse_frequency(cfg.target_frequency)
        src_freq = parse_frequency(cfg.source_frequency)
        if src_freq != parse_frequency(self.config.interpolation.frequency):
            # the bridge writes candles interpolation.frequency apart: a
            # different source_frequency leaves most buckets short of
            # min_candles_required
            self.log.warning(
                "candle_reconstruction.source_frequency=%s but the bridge "
                "writes %s-spaced candles (interpolation.frequency) — "
                "if MINUTE_CANDLES came from the bridge, buckets will be "
                "mostly empty", cfg.source_frequency,
                self.config.interpolation.frequency)
        created_at = pd.Timestamp.now()

        def iter_batches():
            for chunk_syms in self._symbol_chunks(symbols):
                df = self.store.read(st.MINUTE_CANDLES, symbols=chunk_syms)
                batches, skipped = self._pack_candles(df, src_freq)
                for sym, reason in skipped.items():
                    manifest.skip_symbol(sym, reason)
                yield from batches

        def compute(rows, _obs):
            dev = self.device
            # t0_minutes is in source-interval units: grid slot j is epoch
            # minute (t0 + j) * src_freq
            t0 = torch.as_tensor(np.asarray(rows.t0_minutes), device=dev)
            minutes = (t0[:, None] + torch.arange(rows.bucket_len, device=dev)[None, :]) * src_freq
            values, valid_in, _ = _device_grids(rows, dev)
            grids = {c: values[:, j] for j, c in enumerate(rows.columns)}
            ok_in = ok_out = None
            if cfg.validate_ohlc:
                _, ok_in = validate_ohlcv(grids["open"], grids["high"], grids["low"],
                                          grids["close"], grids["volume"], valid_in)
                # a row with an invalid input bar (a failed symbol) stays
                # out of the aggregation
                valid_in = valid_in & ok_in.reshape(ok_in.shape[0], -1).all(1)[:, None]
            # ceil, so a misaligned t0 keeps its trailing partial bucket
            agg = tasks.candles_batch(
                minutes, {**grids, "valid": valid_in}, freq, t0 * src_freq // freq,
                num_segments=(rows.bucket_len * src_freq + freq - 1) // freq + 1,
                min_count=cfg.min_candles_required)
            if cfg.validate_ohlc:
                _, ok_out = validate_ohlcv(agg.open, agg.high, agg.low, agg.close,
                                           agg.volume, agg.valid)
            return {"agg": agg._asdict(), "ok_in": ok_in, "ok_out": ok_out}

        def process(batch):
            res = self._on_block(batch, compute)
            if res is None:
                return None
            failed: Dict[str, str] = {}
            if res["ok_in"] is not None:
                failed = quality_failures(batch.symbols, res["ok_in"],
                                          "invalid input candle data")
                failed.update(quality_failures(batch.symbols, res["ok_out"],
                                               "invalid reconstructed candle data"))
            agg_np = res["agg"]
            agg_np["valid"] = _mask_failed_rows(batch.symbols, failed, agg_np["valid"])
            result_df = _unpack_aggregated(batch, agg_np, freq, src_freq,
                                           cfg.target_frequency, created_at)
            self.store.write(st.RECONSTRUCTED, result_df,
                             upsert_keys=["symbol", "timestamp", "frequency"])
            return result_df, failed

        self._run_batches("candles", manifest, iter_batches(), process)
        return manifest.summary()

    def _pack_candles(self, df: pd.DataFrame, src_freq: int):
        """Pack per-symbol 1-minute candles into compact batches.

        Returns (batches, skipped): skipped maps symbol -> reason for
        symbols that cannot be packed (a timeline beyond the largest
        bucket), so they get a record instead of staying pending."""
        skipped: Dict[str, str] = {}
        if df.empty:
            return [], skipped
        cols = ("open", "high", "low", "close", "volume")
        df = df.sort_values(["symbol", "timestamp"]).drop_duplicates(
            subset=["symbol", "timestamp"], keep="last")
        # candles sharing one source-interval slot (stored spacing finer
        # than source_frequency) would give duplicate scatter coordinates:
        # keep the last per slot
        slots = np.asarray(to_epoch_minutes(df["timestamp"])) // src_freq
        dup = pd.DataFrame({
            "s": df["symbol"].to_numpy(), "m": slots,
        }).duplicated(["s", "m"], keep="last").to_numpy()
        if dup.any():
            self.log.warning(
                "candles: %d bars share a %d-min source slot with a later "
                "bar (stored spacing finer than source_frequency?) — "
                "keeping the last per slot", int(dup.sum()), src_freq)
            df = df[~dup]
            slots = slots[~dup]
        colmat_all = np.stack([
            pd.to_numeric(df[c], errors="coerce").to_numpy(self.np_dtype)
            for c in cols], axis=1)
        out: List[ingest.PackedBatch] = []
        per_bucket: Dict[int, List[dict]] = {}
        for symbol, idx in df.groupby("symbol", sort=True).indices.items():
            obs = slots[idx]
            L = int(obs[-1] - obs[0]) + 1
            bucket = ingest.choose_bucket(L, self.config.processing.bucket_sizes)
            if bucket is None:
                skipped[symbol] = (f"candle timeline {L} src intervals exceeds the "
                                   f"largest bucket")
                continue
            per_bucket.setdefault(bucket, []).append(
                dict(symbol=symbol, obs=obs, idx=idx, L=L))
        cap = self.config.processing.batch_size
        for bucket, items in sorted(per_bucket.items()):
            for lo in range(0, len(items), cap):
                chunk = items[lo:lo + cap]
                B_real = len(chunk)
                B = ingest.batch_pad(B_real, cap)
                t0 = np.zeros(B, np.int64)
                vlen = np.zeros(B, np.int64)
                n_obs = np.zeros(B, np.int64)
                t0[:B_real] = [it["obs"][0] for it in chunk]
                vlen[:B_real] = [it["L"] for it in chunk]
                n_obs[:B_real] = [len(it["obs"]) for it in chunk]
                row_sym = np.repeat(np.arange(B_real), n_obs[:B_real])
                pos = (np.concatenate([it["obs"] for it in chunk])
                       - t0[row_sym]).astype(np.int64)
                N = ingest.obs_pad(len(pos))
                obs_vals = ingest.full_nan((N, len(cols)), self.np_dtype)
                obs_vals[:len(pos)] = colmat_all[np.concatenate(
                    [it["idx"] for it in chunk])]
                obs_row = np.full(N, B, np.int32)
                obs_row[:len(pos)] = row_sym
                obs_pos = np.zeros(N, np.int64)
                obs_pos[:len(pos)] = pos
                out.append(ingest.PackedBatch(
                    bucket_len=bucket, symbols=[it["symbol"] for it in chunk],
                    t0_minutes=t0, valid_len=vlen, n_obs=n_obs, columns=cols,
                    obs_vals=obs_vals, obs_row=obs_row, obs_pos=obs_pos))
        return out, skipped

    # ------------------------------------------------------------------
    # Fused pipeline — all three stages chained on the device per batch
    # ------------------------------------------------------------------
    def run_pipeline_fused(self, symbols: Optional[List[str]] = None,
                           limit: Optional[int] = None,
                           resume_batch_id: Optional[int] = None,
                           start_date=None, end_date=None) -> dict:
        """interpolate -> bridge -> aggregate per batch with no storage
        round-trip between the stages; all three tables are written.
        Gives the tables of the staged ``run_all`` (the bridge keys derive
        from symbol names and epoch minutes, not execution order).

        Batch i+1 is dispatched before batch i is read back
        (``queue_depth``); one writer thread lands each batch's three
        writes while the next batch runs, and a batch's symbols are
        recorded completed only after its writes landed."""
        icfg = self.config.interpolation
        ccfg = self.config.candle_reconstruction
        # a fresh run takes one id for its three manifests, so --resume
        # names it in every stage
        new_id = self._free_batch_id() if resume_batch_id is None else None
        manifests = {name: self._manifest(name, resume_batch_id, new_id)
                     for name in STAGE_NAMES}
        if resume_batch_id is not None:
            # a symbol is done only when all three stages completed it
            symbols = self._decide(lambda: sorted(
                {s for m in manifests.values() for s in m.pending_symbols()}))
            self.log.info("fused resume batch %s: %d pending symbols",
                          resume_batch_id, len(symbols))
        if symbols is None:
            symbols = self.store.list_symbols(st.TICKERS)
        if limit:
            symbols = symbols[:limit]
        symbols = self._shard_symbols(symbols)
        for m in manifests.values():
            m.initialize_symbols(symbols)
            m.flush()
        summaries = lambda: {"task1": manifests["interpolation"].summary(),
                             "bridge": manifests["bridge"].summary(),
                             "task2": manifests["candles"].summary()}
        if not symbols:
            return {**summaries(), "fused": True}

        freq = parse_frequency(icfg.frequency)
        tgt_freq = parse_frequency(ccfg.target_frequency)
        created_at = pd.Timestamp.now()

        def skip_all(sym, reason):
            for m in manifests.values():
                m.skip_symbol(sym, reason)

        writer = ThreadPoolExecutor(max_workers=1)
        inflight: list = []

        def timed_write(table, df, keys):
            with self._clock("write"):
                return self.store.write(table, df, upsert_keys=keys)

        def drain(limit: int) -> None:
            while len(inflight) > limit:
                syms, futs, record_completions = inflight.pop(0)
                ok = True
                for f in futs:
                    try:
                        f.result()
                    except Exception as e:  # noqa: BLE001
                        ok = False
                        self.log.exception("async write failed")
                        for sym in syms:
                            for m in manifests.values():
                                m.error_symbol(sym, f"async write failed: {e}")
                        break
                if ok:
                    # 'completed' only after the writes landed: a crash
                    # in between errs the safe way (the symbol re-runs;
                    # writes are idempotent upserts)
                    record_completions()

        def start(batch):
            with self._clock("dispatch"):
                # a dispatch never raises: its error rides to the readback,
                # where the ranks of a mesh share it before the gather
                try:
                    return dispatch(batch, self.config, self.device, mesh=self.mesh)
                except Exception as e:  # noqa: BLE001
                    return {"error": e}

        def finish(batch, dev):
            with self._clock("readback"):
                res = readback(batch, dev, self.mesh)
            if res is None:
                return None
            with self._clock("unpack"):
                interp_df = ingest.unpack_interpolated(
                    batch, res["filled"], res["valid"], res["is_interpolated"],
                    manifests["interpolation"].batch_id,
                    greeks=res.get("greeks"), freq_minutes=freq)
                # the quality gate's failed symbols keep their interpolated
                # rows but write no candles (readback cleared them)
                candle_df = _unpack_candles(batch, res["ohlcv"], freq_minutes=freq)
                recon_df = _unpack_aggregated(
                    batch, res["candles"], tgt_freq, freq, ccfg.target_frequency,
                    created_at, base_bucket=batch.t0_minutes // tgt_freq)
            return interp_df, candle_df, recon_df, res["failed"]

        pending = deque()  # (batch, dev, t0)

        def complete_one():
            batch, dev, t0 = pending.popleft()
            # the pre-dispatched tensors serve the first attempt only: a
            # device error surfaces at the readback, so a retry dispatches
            # again
            cell = {"dev": dev}

            def closure(batch=batch):
                d = cell.pop("dev", None)
                if d is None:
                    d = start(batch)
                return finish(batch, d)

            with self.metrics.step(f"fused/L{batch.bucket_len}", items=batch.batch):
                result, err = self._attempt(f"fused bucket L={batch.bucket_len}",
                                            closure)
            if err is not None:
                for sym in batch.symbols:
                    for m in manifests.values():
                        m.error_symbol(sym, str(err), time.time() - t0)
                return
            if not self.leader:
                return
            interp_df, candle_df, recon_df, failed = result
            dt = time.time() - t0
            per = {"interpolation": _per_symbol(interp_df),
                   "bridge": _per_symbol(candle_df),
                   "candles": _per_symbol(recon_df)}

            def record_completions(batch=batch, per=per, failed=failed, dt=dt):
                share = dt / batch.batch
                for i, sym in enumerate(batch.symbols):
                    n_interp = int(per["interpolation"].get(sym, 0))
                    manifests["interpolation"].complete_symbol(
                        sym, int(batch.n_obs[i]), n_interp, share)
                    if sym in failed:
                        manifests["bridge"].error_symbol(sym, failed[sym], share)
                        manifests["candles"].error_symbol(sym, failed[sym], share)
                        continue
                    n_bridge = int(per["bridge"].get(sym, 0))
                    manifests["bridge"].complete_symbol(sym, n_interp, n_bridge, share)
                    manifests["candles"].complete_symbol(
                        sym, n_bridge, int(per["candles"].get(sym, 0)), share)

            drain(0)  # the previous write-set lands before more are queued
            inflight.append((list(batch.symbols), [
                writer.submit(timed_write, st.INTERPOLATED, interp_df,
                              ["symbol", "date"]),
                writer.submit(timed_write, st.MINUTE_CANDLES, candle_df,
                              ["symbol", "timestamp"]),
                writer.submit(timed_write, st.RECONSTRUCTED, recon_df,
                              ["symbol", "timestamp", "frequency"]),
            ], record_completions))

        packed_before = ingest.packer_snapshot()
        try:
            for batch in self._iter_packed_batches(symbols, skip_all,
                                                   start_date, end_date):
                if self._stopping():
                    break
                t0 = time.time()
                pending.append((batch, start(batch), t0))
                while len(pending) >= self.queue_depth:
                    complete_one()
            while pending:
                complete_one()
        finally:
            # an exception anywhere above still lands the in-flight
            # writes, stops the writer and flushes the manifests, so
            # --resume sees every recorded event
            try:
                drain(0)
            finally:
                writer.shutdown(wait=True)
                for m in manifests.values():
                    m.flush()
        # which host packer ran (calls by operation and packer), and the
        # gathers' share of the unpack seconds
        calls, seconds = (now - then for now, then in
                          zip(ingest.packer_snapshot(), packed_before))
        self.host_s["gather"] += sum(v for k, v in seconds.items() if k.startswith("gather"))
        out = {**summaries(), "step_metrics": self.metrics.summary(), "fused": True,
               "packer": dict(calls)}
        if self.mesh is not None:
            out["world"] = self.world_report()
        self.metrics.snapshot(f"fused_{manifests['interpolation'].batch_id}")
        return out

    # ------------------------------------------------------------------
    def run_all(self, symbols: Optional[List[str]] = None,
                limit: Optional[int] = None,
                resume_batch_id: Optional[int] = None,
                start_date=None, end_date=None) -> dict:
        """Staged pipeline: interpolate -> bridge -> reconstruct, each
        stage through storage.

        With ``symbols``/``limit``/``resume_batch_id``/date bounds, each
        downstream stage is scoped to the symbols the stage before it
        completed, instead of every symbol in the shared tables.
        ``resume_batch_id`` resumes each stage whose manifest exists for
        that batch; a stage that never started runs fresh over the scoped
        set, under the same id. A fresh run takes one id free for all
        three stages, so that id names this run in every stage."""
        scoped = (symbols is not None or bool(limit)
                  or resume_batch_id is not None
                  or start_date is not None or end_date is not None)
        run_id = self._free_batch_id() if resume_batch_id is None else resume_batch_id

        def stage_ids(name):
            """(resume id, new id) of a downstream stage."""
            if resume_batch_id is not None and self._decide(
                    lambda: bool(self._manifest(name, resume_batch_id).records())):
                return resume_batch_id, None
            return None, run_id

        completed = self.completed_symbols

        # task 1 gets the id as it is: resuming an unknown batch is a
        # no-op (nothing pending), not a fresh full run
        s1 = self.run_task1(symbols=symbols, limit=limit,
                            resume_batch_id=resume_batch_id,
                            start_date=start_date, end_date=end_date,
                            _new_batch_id=run_id)
        scope = completed("interpolation", s1.get("batch_id")) if scoped else None
        resume, new = stage_ids("bridge")
        s2 = self.run_bridge(symbols=scope, resume_batch_id=resume, _new_batch_id=new)
        scope2 = completed("bridge", s2.get("batch_id")) if scoped else None
        resume, new = stage_ids("candles")
        s3 = self.run_task2(symbols=scope2, resume_batch_id=resume, _new_batch_id=new)
        out = {"task1": s1, "bridge": s2, "task2": s3,
               "step_metrics": self.metrics.summary()}
        if self.mesh is not None:
            out["world"] = self.world_report()
        self.metrics.snapshot(f"pipeline_{s1.get('batch_id', 'run')}")
        return out

    def status(self) -> dict:
        """Row and symbol counts of the four tables."""
        return {table: {"rows": self.store.count(table),
                        "symbols": len(self.store.list_symbols(table))}
                for table in (st.TICKERS, st.INTERPOLATED, st.MINUTE_CANDLES,
                              st.RECONSTRUCTED)}
