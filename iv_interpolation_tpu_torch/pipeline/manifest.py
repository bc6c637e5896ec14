"""Run manifest: host-side checkpoint/resume state (port of
``iv_interpolation_tpu/pipeline/manifest.py``, same jsonl format: a
manifest written by either package resumes in the other).

Replaces the reference's DB-backed progress tables
(``interpolation_progress`` / ``candle_reconstruction_progress``,
src/database/schema.py:88-109, candle_schema.py:89-111) and the
``ProgressTracker`` state machine (src/monitoring/progress.py:10-216)
with an append-only jsonl manifest per run. Semantics preserved:

  * ``batch_id = int(time.time())`` (progress.py:18-20)
  * per-symbol state machine pending -> processing -> {completed, error,
    skipped} with input/output rows, timing and error message
  * resume re-enqueues ``pending`` + ``error`` symbols of a prior batch
    (batch_processor.py:53-65)
  * aggregate summary with expansion ratio and average per-symbol time
    (progress.py:177-216)

The jsonl file is the source of truth; an in-memory dict serves queries.
Append-only writes make concurrent monitor reads safe (the reference used
DB transactions for the same purpose, SURVEY.md §5.2).
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional


def free_batch_id(manifest_dir: str, tasks) -> int:
    """An epoch-seconds batch id (reference convention, progress.py:18-20)
    bumped until no ``{task}_{id}.jsonl`` of ``tasks`` exists: a run whose
    stages all take this id is named by it in every stage."""
    batch_id = int(time.time())
    while any(os.path.exists(os.path.join(manifest_dir, f"{task}_{batch_id}.jsonl"))
              for task in tasks):
        batch_id += 1
    return batch_id


@dataclass
class SymbolRecord:
    symbol: str
    status: str = "pending"  # pending|processing|completed|error|skipped
    input_rows: int = 0
    output_rows: int = 0
    processing_time: float = 0.0
    error_message: Optional[str] = None
    started_at: Optional[float] = None
    completed_at: Optional[float] = None


class RunManifest:
    """Append-only jsonl manifest for one pipeline run (one task stage)."""

    def __init__(self, manifest_dir: str, task: str,
                 batch_id: Optional[int] = None,
                 flush_interval: int = 1):
        """``flush_interval`` buffers that many events between file writes
        (the reference's declared-but-unused ``checkpoint_interval``,
        config_production.py:78 — wired here). A crash loses at most the
        buffered tail; those symbols simply re-run on resume (storage
        writes are idempotent upserts)."""
        self.task = task
        self.flush_interval = max(1, flush_interval)
        os.makedirs(manifest_dir, exist_ok=True)
        if batch_id is None:
            # two runs started within the same second must not share a
            # file, or the second would report the first's completions
            batch_id = free_batch_id(manifest_dir, (task,))
        self.batch_id = batch_id
        self.path = os.path.join(manifest_dir,
                                 f"{task}_{self.batch_id}.jsonl")
        self._records: Dict[str, SymbolRecord] = {}
        self._buffer: list = []
        if os.path.exists(self.path):
            self._load()

    # -- persistence ------------------------------------------------------
    def _load(self) -> None:
        with open(self.path) as f:
            for line in f:
                if not line.strip():
                    continue
                rec = json.loads(line)
                self._records[rec["symbol"]] = SymbolRecord(**rec)

    def _append(self, rec: SymbolRecord) -> None:
        self._buffer.append(json.dumps(asdict(rec)))
        if len(self._buffer) >= self.flush_interval:
            self.flush()

    def flush(self) -> None:
        """Write buffered events to the jsonl file."""
        if not self._buffer:
            return
        with open(self.path, "a") as f:
            f.write("\n".join(self._buffer) + "\n")
        self._buffer = []

    # -- state machine (mirrors progress.py:22-106) -----------------------
    def initialize_symbols(self, symbols: List[str]) -> None:
        for s in symbols:
            if s not in self._records:
                rec = SymbolRecord(symbol=s)
                self._records[s] = rec
                self._append(rec)

    def start_symbol(self, symbol: str, input_rows: int = 0) -> None:
        rec = self._records.setdefault(symbol, SymbolRecord(symbol=symbol))
        rec.status = "processing"
        rec.input_rows = input_rows
        rec.started_at = time.time()
        self._append(rec)

    def complete_symbol(self, symbol: str, input_rows: int,
                        output_rows: int, processing_time: float) -> None:
        rec = self._records.setdefault(symbol, SymbolRecord(symbol=symbol))
        rec.status = "completed"
        rec.input_rows = input_rows
        rec.output_rows = output_rows
        rec.processing_time = processing_time
        rec.completed_at = time.time()
        self._append(rec)

    def error_symbol(self, symbol: str, error_message: str,
                     processing_time: float = 0.0) -> None:
        rec = self._records.setdefault(symbol, SymbolRecord(symbol=symbol))
        rec.status = "error"
        rec.error_message = str(error_message)[:500]
        rec.processing_time = processing_time
        rec.completed_at = time.time()
        self._append(rec)

    def skip_symbol(self, symbol: str, reason: str) -> None:
        rec = self._records.setdefault(symbol, SymbolRecord(symbol=symbol))
        rec.status = "skipped"
        rec.error_message = str(reason)[:500]
        rec.completed_at = time.time()
        self._append(rec)

    # -- queries (mirror progress.py:108-216) ------------------------------
    def records(self) -> Dict[str, SymbolRecord]:
        return dict(self._records)

    def pending_symbols(self) -> List[str]:
        """Symbols to (re)process on resume: pending + error + the ones
        caught mid-PROCESSING by a crash (batch_processor.py:53-65
        resume semantics). A flushed start_symbol with no completion is
        the crash signature, so 'processing' re-runs too. Storage writes
        are idempotent upserts, so re-running a symbol that half-wrote is
        safe."""
        return sorted(
            s for s, r in self._records.items()
            if r.status in ("pending", "error", "processing")
        )

    def summary(self) -> dict:
        counts: Dict[str, int] = {}
        in_rows = out_rows = 0
        total_time = 0.0
        n_timed = 0
        for r in self._records.values():
            counts[r.status] = counts.get(r.status, 0) + 1
            if r.status == "completed":
                in_rows += r.input_rows
                out_rows += r.output_rows
                total_time += r.processing_time
                n_timed += 1
        return {
            "task": self.task,
            "batch_id": self.batch_id,
            "total_symbols": len(self._records),
            "by_status": counts,
            "input_rows": in_rows,
            "output_rows": out_rows,
            "expansion_ratio": (out_rows / in_rows) if in_rows else 0.0,
            "avg_symbol_time": (total_time / n_timed) if n_timed else 0.0,
        }

    def is_done(self) -> bool:
        return not any(
            r.status in ("pending", "processing")
            for r in self._records.values()
        )

    # -- discovery ---------------------------------------------------------
    @staticmethod
    def list_batches(manifest_dir: str, task: Optional[str] = None) -> List[dict]:
        """Enumerate prior runs (the reference's aspirational
        ``--list-batches``, setup.py:258, implemented for real)."""
        out = []
        if not os.path.isdir(manifest_dir):
            return out
        for name in sorted(os.listdir(manifest_dir)):
            if not name.endswith(".jsonl"):
                continue
            stem = name[:-6]
            t, _, bid = stem.rpartition("_")
            if task and t != task:
                continue
            try:
                m = RunManifest(manifest_dir, t, int(bid))
            except (ValueError, json.JSONDecodeError, TypeError,
                    KeyError):
                # one malformed or foreign-version manifest (extra or
                # missing record fields) must not abort the listing
                continue
            out.append(m.summary())
        return out
