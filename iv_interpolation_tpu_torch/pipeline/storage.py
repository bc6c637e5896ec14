"""Storage adapters at the pipeline's edges (port of
``iv_interpolation_tpu/pipeline/storage.py``: the memory and parquet
backends).

The reference round-tripped every stage through PostgreSQL tables
(``trading_tickers`` -> ``interpolated_trading_tickers`` ->
``minute_candles`` -> ``reconstructed_candles``). Here the adapters feed
and drain pandas frames at the pipeline's edges.

Adapters share one duck-typed interface:
  * ``list_symbols(table)``
  * ``read(table, symbols=None, columns=None)`` -> DataFrame
  * ``write(table, df, upsert_keys=None)``: last write wins on the keys
  * ``count(table)``, ``tables()``, ``drop(table)``

A parquet store is laid out as the JAX package lays it out (one
directory a table, ``part-<ns>-<pid>.parquet`` parts, a ``_meta.json``
with the upsert keys), so a store written by one package reads back
unchanged in the other. ``PostgresStore`` is not ported yet (ROADMAP).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

import pandas as pd

# canonical table names, matching the reference schema
TICKERS = "trading_tickers"
INTERPOLATED = "interpolated_trading_tickers"
MINUTE_CANDLES = "minute_candles"
RECONSTRUCTED = "reconstructed_candles"


def _upsert(existing: pd.DataFrame, incoming: pd.DataFrame,
            keys: List[str]) -> pd.DataFrame:
    """Last-write-wins upsert on key columns."""
    merged = pd.concat([existing, incoming], ignore_index=True)
    return merged.drop_duplicates(subset=keys, keep="last").reset_index(drop=True)


class MemoryStore:
    """Dict-of-DataFrames store (tests and ephemeral runs). Each upsert
    concatenates and de-duplicates the whole table."""

    def __init__(self):
        self._tables: Dict[str, pd.DataFrame] = {}

    def tables(self) -> List[str]:
        return sorted(self._tables)

    def list_symbols(self, table: str) -> List[str]:
        df = self._tables.get(table)
        if df is None or df.empty or "symbol" not in df.columns:
            return []
        return sorted(df["symbol"].unique().tolist())

    def read(self, table: str, symbols: Optional[List[str]] = None,
             columns: Optional[List[str]] = None) -> pd.DataFrame:
        df = self._tables.get(table, pd.DataFrame())
        if symbols is not None and not df.empty:
            df = df[df["symbol"].isin(symbols)]
        if columns is not None and not df.empty:
            df = df[[c for c in columns if c in df.columns]]
        return df.reset_index(drop=True).copy()

    def write(self, table: str, df: pd.DataFrame,
              upsert_keys: Optional[List[str]] = None) -> int:
        if df is None or df.empty:
            return 0
        if table in self._tables and upsert_keys:
            self._tables[table] = _upsert(self._tables[table], df, upsert_keys)
        elif table in self._tables:
            self._tables[table] = pd.concat(
                [self._tables[table], df], ignore_index=True)
        else:
            self._tables[table] = df.reset_index(drop=True).copy()
        return len(df)

    def count(self, table: str) -> int:
        return len(self._tables.get(table, ()))

    def drop(self, table: str) -> None:
        self._tables.pop(table, None)


class ParquetStore:
    """Append-only parquet dataset per table under ``root``.

    Each ``write`` lands a new ``part-<ns>-<pid>.parquet`` (O(batch),
    never a table rewrite; the (timestamp, pid) name stays collision-free
    across concurrent ``--shard`` writers). Upserts are realised at read
    time by dropping duplicate keys, keeping the newest part; a
    ``_meta.json`` sidecar remembers the table's upsert keys. Needs
    pyarrow.
    """

    def __init__(self, root: str, compact_after: int = 0):
        """``compact_after > 0`` compacts a table once it holds that many
        parts; off by default (``compact()`` is maintenance)."""
        try:
            import pyarrow  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "ParquetStore needs pyarrow, which is not installed; use "
                "storage backend 'memory' (--storage memory) or install "
                "pyarrow") from e
        self.root = root
        self.compact_after = compact_after
        os.makedirs(root, exist_ok=True)

    def _dir(self, table: str) -> str:
        return os.path.join(self.root, table)

    def _parts(self, table: str) -> List[str]:
        d = self._dir(table)
        if not os.path.isdir(d):
            return []
        return sorted(os.path.join(d, f) for f in os.listdir(d)
                      if f.endswith(".parquet"))

    def _keys(self, table: str) -> Optional[List[str]]:
        meta = os.path.join(self._dir(table), "_meta.json")
        if os.path.exists(meta):
            with open(meta) as f:
                return json.load(f).get("upsert_keys")
        return None

    def tables(self) -> List[str]:
        return sorted(
            t for t in os.listdir(self.root)
            if os.path.isdir(self._dir(t)) and self._parts(t)
        )

    def _read_raw(self, table: str, columns=None, filters=None) -> pd.DataFrame:
        parts = self._parts(table)
        if not parts:
            return pd.DataFrame()
        frames = [pd.read_parquet(p, columns=columns, filters=filters)
                  for p in parts]
        return pd.concat(frames, ignore_index=True)

    def list_symbols(self, table: str) -> List[str]:
        df = self._read_raw(table, columns=["symbol"])
        if df.empty:
            return []
        return sorted(df["symbol"].unique().tolist())

    def read(self, table: str, symbols: Optional[List[str]] = None,
             columns: Optional[List[str]] = None) -> pd.DataFrame:
        """``columns`` prunes at the parquet reader; the upsert-key
        columns are read regardless so the dedup stays correct, then
        pruned from the result."""
        filters = [("symbol", "in", symbols)] if symbols is not None else None
        keys = self._keys(table)
        read_cols = columns
        if columns is not None and keys:
            read_cols = list(dict.fromkeys(list(columns) + keys))
        df = self._read_raw(table, columns=read_cols, filters=filters)
        if keys and not df.empty:
            df = df.drop_duplicates(subset=keys, keep="last")
        if columns is not None and not df.empty:
            df = df[[c for c in columns if c in df.columns]]
        return df.reset_index(drop=True)

    def write(self, table: str, df: pd.DataFrame,
              upsert_keys: Optional[List[str]] = None) -> int:
        if df is None or df.empty:
            return 0
        d = self._dir(table)
        os.makedirs(d, exist_ok=True)
        if upsert_keys:
            with open(os.path.join(d, "_meta.json"), "w") as f:
                json.dump({"upsert_keys": upsert_keys}, f)
        parts = self._parts(table)
        # (timestamp_ns, pid)-unique names: concurrent --shard writers
        # sharing a store cannot pick the same name, and the zero-padded
        # ns keeps lexicographic order = write order, which read-time
        # keep='last' dedup relies on ("part-000000", compact()'s output,
        # sorts before every such part)
        name = f"part-{time.time_ns():020d}-{os.getpid():07d}"
        tmp = os.path.join(d, f".{name}.tmp")
        df.to_parquet(tmp, index=False)
        os.replace(tmp, os.path.join(d, f"{name}.parquet"))
        if self.compact_after and len(parts) + 1 >= self.compact_after:
            self.compact(table)
        return len(df)

    def compact(self, table: str) -> None:
        """Merge all parts into one (applying upsert dedup). The compacted
        file is installed before the old parts are removed, so a crash in
        between loses nothing (keep-last dedup still reads the originals)."""
        parts = self._parts(table)
        if len(parts) <= 1:
            return
        df = self.read(table)
        d = self._dir(table)
        tmp = os.path.join(d, f".compact-{os.getpid()}.tmp")
        df.to_parquet(tmp, index=False)
        target = os.path.join(d, "part-000000.parquet")
        os.replace(tmp, target)
        for p in parts:
            if p != target:
                os.remove(p)

    def count(self, table: str, exact: bool = False) -> int:
        """Row count from part metadata (fast). Upserted duplicates across
        parts can overcount; ``exact=True`` pays for the dedup'd read."""
        import pyarrow.parquet as pq
        parts = self._parts(table)
        if not parts:
            return 0
        if exact and len(parts) > 1 and self._keys(table):
            return len(self.read(table))
        return sum(pq.ParquetFile(p).metadata.num_rows for p in parts)

    def drop(self, table: str) -> None:
        d = self._dir(table)
        if os.path.isdir(d):
            for f in os.listdir(d):
                os.remove(os.path.join(d, f))
            os.rmdir(d)


def get_store(cfg) -> "MemoryStore | ParquetStore":
    """Build the configured storage adapter (cfg: StorageConfig)."""
    if cfg.backend == "memory":
        return MemoryStore()
    if cfg.backend == "parquet":
        return ParquetStore(cfg.root)
    if cfg.backend == "postgres":
        raise NotImplementedError(
            "storage backend 'postgres' is not ported yet (ROADMAP: "
            "PostgresStore, pgwire and schema); use 'parquet' or 'memory'")
    raise ValueError(f"unknown storage backend: {cfg.backend!r}")
