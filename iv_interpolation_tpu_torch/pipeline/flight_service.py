"""Arrow Flight transport for the streaming serving daemon (port of
``iv_interpolation_tpu/pipeline/flight_service.py``).

gRPC + Arrow columnar batches in front of the same single-writer
:class:`StreamingSession` as the JSONL server (``pipeline/serve.py``):
tick ingest decodes columns straight into the arrays the session's ring
takes, and refit results come back as Arrow tables.

* ``do_put`` with any descriptor: RecordBatches with columns
  ``underlying: utf8 | dictionary``, ``minute: int``, ``price: float``,
  ``size: float``, buffered and flushed to the session in one padded
  batch per flush.
* ``do_get(Ticket(b"refit"))``: flush + refit; a table ``underlying,
  realized_vol, atm_iv, butterfly_ok, calendar_ok``.
* ``do_get(Ticket(b"surfaces"))``: flush + refit; the IV grids as
  ``underlying, expiry, iv: fixed_size_list<float32>[m]`` (one row per
  (underlying, expiry) slice).
* ``do_action``: ``flush`` / ``stats`` (JSON payload back) / ``stop``.

Needs ``pyarrow.flight``; the import is guarded, so an installation
without Flight still serves JSONL.
"""

from __future__ import annotations

import json
import threading
from typing import List

import numpy as np
import torch

from iv_interpolation_tpu_torch.pipeline.serve import TICK_COLUMNS

try:  # pyarrow.flight ships with the pyarrow the parquet store uses
    import pyarrow as pa
    import pyarrow.flight as fl
    HAVE_FLIGHT = True
except Exception:  # pragma: no cover - exercised via the import guard test
    pa = None
    fl = None
    HAVE_FLIGHT = False


# do_put validates the tick columns, so a malformed batch fails the
# offending client, not whichever client flushes later
TICK_SCHEMA_DOC = "underlying: utf8, minute: int32, price: float, size: float"


def _require_flight():
    if not HAVE_FLIGHT:
        raise RuntimeError(
            "pyarrow.flight is unavailable — install pyarrow with Flight "
            "support or use the JSONL server (pipeline/serve.py)")


class FlightStreamServer(fl.FlightServerBase if HAVE_FLIGHT else object):
    """Arrow Flight front-end over one :class:`StreamingSession`."""

    def __init__(self, session, host: str = "127.0.0.1", port: int = 0):
        _require_flight()
        super().__init__(f"grpc+tcp://{host}:{port}")
        # advertise the resolved port: with port=0 the constructor's
        # location ends in ':0', which no client can connect to
        self._location = f"grpc+tcp://{host}:{self.port}"
        self.session = session
        self._lock = threading.Lock()
        self._buffer: List = []           # pending RecordBatches
        self._buffered_rows = 0
        self._ingested = 0

    # -- ingest --------------------------------------------------------
    def do_put(self, context, descriptor, reader, writer):
        for chunk in reader:
            batch = chunk.data
            if batch is None:             # metadata-only chunk
                continue
            missing = [c for c in TICK_COLUMNS if c not in batch.schema.names]
            if missing:
                raise fl.FlightServerError(
                    f"tick batch is missing columns {missing}; "
                    f"expected {TICK_SCHEMA_DOC}")
            for col in TICK_COLUMNS[1:]:
                typ = batch.schema.field(col).type
                if not (pa.types.is_integer(typ) or pa.types.is_floating(typ)):
                    raise fl.FlightServerError(
                        f"tick column {col!r} has non-numeric type {typ}; "
                        f"expected {TICK_SCHEMA_DOC}")
            with self._lock:
                if self._buffer and not batch.schema.equals(self._buffer[0].schema):
                    # batches of different types cannot share one Table:
                    # flush the old schema's buffer first
                    self._flush_locked()
                self._buffer.append(batch)
                self._buffered_rows += batch.num_rows
                if self._buffered_rows >= 10_000:
                    self._flush_locked()

    def _flush_locked(self) -> int:
        if not self._buffer:
            return 0
        tbl = pa.Table.from_batches(self._buffer)
        self._buffer = []
        self._buffered_rows = 0
        # the session takes a mapping of columns
        n = self.session.ingest_ticks({
            c: tbl.column(c).to_numpy(zero_copy_only=False) for c in TICK_COLUMNS})
        self._ingested += n
        return n

    # -- results -------------------------------------------------------
    def do_get(self, context, ticket):
        kind = ticket.ticket.decode(errors="replace")
        # validated before the flush and refit under the lock
        if kind not in ("refit", "surfaces"):
            raise fl.FlightServerError(f"unknown ticket {kind!r}")
        with self._lock:
            self._flush_locked()
            out = self.session.refit()
            unds = self.session.underlyings
            host = lambda t: t.cpu().numpy()
            if kind == "refit":
                m = out.iv_grid.shape[-1]
                table = pa.table({
                    "underlying": pa.array(unds),
                    "realized_vol": pa.array(host(out.realized_vol).astype(np.float64)),
                    "atm_iv": pa.array(host(out.iv_grid[:, 0, m // 2]).astype(np.float64)),
                    "butterfly_ok": pa.array(host(out.butterfly_ok).astype(bool)),
                    "calendar_ok": pa.array(host(out.calendar_ok).astype(bool)),
                })
            else:
                iv = host(out.iv_grid.to(torch.float32))     # (B, E, m)
                B, E, m = iv.shape
                table = pa.table({
                    "underlying": pa.array([u for u in unds for _ in range(E)]),
                    "expiry": pa.array(np.tile(np.arange(E, dtype=np.int32), B)),
                    "iv": pa.FixedSizeListArray.from_arrays(pa.array(iv.reshape(-1)), m),
                })
        return fl.RecordBatchStream(table)

    # -- control -------------------------------------------------------
    def do_action(self, context, action):
        if action.type == "flush":
            with self._lock:
                n = self._flush_locked()
                body = {"ok": True, "ingested": n, "total": self._ingested}
        elif action.type == "stats":
            with self._lock:
                self._flush_locked()
                body = {"ok": True, **self.session.stats(),
                        "server_ingested": self._ingested}
        elif action.type == "stop":
            with self._lock:
                self._flush_locked()
            body = {"ok": True}
            threading.Thread(target=self.shutdown, daemon=True).start()
        else:
            raise fl.FlightServerError(f"unknown action {action.type!r}")
        yield fl.Result(json.dumps(body).encode())

    def list_actions(self, context):
        return [("flush", "flush buffered ticks to the device ring"),
                ("stats", "session statistics (JSON)"),
                ("stop", "flush and shut the server down")]

    def list_flights(self, context, criteria):
        for name in ("refit", "surfaces"):
            desc = fl.FlightDescriptor.for_path(name)
            yield fl.FlightInfo(pa.schema([]), desc,
                                [fl.FlightEndpoint(name, [self._location])])


# ---------------------------------------------------------------------
# client helpers
# ---------------------------------------------------------------------

def put_ticks(client, underlying, minute, price, size) -> None:
    """Upload one columnar tick batch over an open FlightClient."""
    _require_flight()
    batch = pa.record_batch({
        "underlying": pa.array(underlying),
        "minute": pa.array(np.asarray(minute, np.int32)),
        "price": pa.array(np.asarray(price, np.float32)),
        "size": pa.array(np.asarray(size, np.float32)),
    })
    writer, _ = client.do_put(fl.FlightDescriptor.for_path("ticks"), batch.schema)
    writer.write_batch(batch)
    writer.close()


def action_json(client, name: str) -> dict:
    """Run a named action and decode its JSON reply."""
    _require_flight()
    results = list(client.do_action(fl.Action(name, b"")))
    return json.loads(results[0].body.to_pybytes())


def run_serve_flight(config, store, port: int = 8815, n_underlyings: int = 64,
                     blocking: bool = True,
                     device: torch.device | str = "cuda") -> "FlightStreamServer":
    """CLI entry (``--task serve --serve-transport flight``): the JSONL
    server's session, the Flight transport in front, on the card unless
    ``device`` names another."""
    _require_flight()
    from iv_interpolation_tpu_torch.pipeline.serve import build_session
    session, unds = build_session(config, store, n_underlyings=n_underlyings,
                                  device=device)
    server = FlightStreamServer(session, port=port)
    print(f"serving {len(unds)} underlyings on grpc+tcp://127.0.0.1:"
          f"{server.port} (Arrow Flight; do_action('stop') to exit)", flush=True)
    if blocking:
        server.serve()
    return server
