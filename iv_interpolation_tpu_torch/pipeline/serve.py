"""Streaming serving daemon: a line-protocol tick feed in front of
:class:`~iv_interpolation_tpu_torch.pipeline.stream_service.StreamingSession`
(port of ``iv_interpolation_tpu/pipeline/serve.py``).

Clients stream JSON lines over TCP (localhost); ticks buffer on the host
and flush to the session's tick ring in batches; ``refit`` answers with
the fused candle -> realized-vol -> surface result of every underlying.

Protocol (newline-delimited JSON, one object per line):
  {"underlying": "btc", "minute": 123, "price": 25001.5, "size": 0.2}
  {"cmd": "flush"}                  -> {"ok": true, "ingested": N, ...}
  {"cmd": "refit"}                  -> {"ok": true, "realized_vol": {...},
                                        "butterfly_ok": {...}, "atm_iv": {...}}
  {"cmd": "stats"}                  -> {"ok": true, ...session stats}
  {"cmd": "stop"}                   -> {"ok": true} and server shutdown

Single writer by design (one device session): clients may connect
concurrently, and a lock serialises their requests.

Under a mesh (``processing.mesh_shape`` over launched ranks) rank 0
listens, and every call it makes on the session goes first to the other
ranks (:class:`MeshSession`), which make it on their blocks in the same
order (:func:`follow`); ``stop`` ends every rank.
"""

from __future__ import annotations

import json
import socket
import socketserver
import threading
from typing import Optional

import numpy as np
import torch

from iv_interpolation_tpu_torch.parallel.mesh import broadcast_object

TICK_COLUMNS = ("underlying", "minute", "price", "size")


class MeshSession:
    """The session on rank 0 of a mesh: each call is broadcast to the
    other ranks before rank 0 makes it, so every rank runs the same calls
    in the same order; anything else reads rank 0's session."""

    def __init__(self, session):
        self.session = session
        self.closed = False

    def __getattr__(self, name):
        return getattr(self.session, name)

    def _call(self, name: str, *args):
        broadcast_object(self.session.mesh, (name, args))
        return getattr(self.session, name)(*args)

    def ingest_ticks(self, ticks) -> int:
        return self._call("ingest_ticks", ticks)

    def refit(self, now_minute=None):
        return self._call("refit", now_minute)

    def stats(self) -> dict:
        return self._call("stats")

    def close(self) -> None:
        """End the other ranks' :func:`follow` (once)."""
        if not self.closed:
            self.closed = True
            broadcast_object(self.session.mesh, ("stop", ()))


def follow(session) -> int:
    """A rank other than 0 of a served mesh: make rank 0's session calls
    on this rank's block until it stops; returns the calls made. A call
    that raises here raises on rank 0 too (same ticks), which replies with
    the error; the loop goes on."""
    calls = 0
    while True:
        name, args = broadcast_object(session.mesh, None)
        if name == "stop":
            return calls
        calls += 1
        try:
            getattr(session, name)(*args)
        except Exception:  # noqa: BLE001 — rank 0 replies with it
            pass


class StreamServer:
    def __init__(self, session, host: str = "127.0.0.1", port: int = 0,
                 flush_every: int = 10_000):
        """``port=0`` picks a free port (see ``.port``)."""
        self.session = session
        self.flush_every = flush_every
        self._buffer: list = []
        self._lock = threading.Lock()
        self._ingested = 0
        self._rejected = 0

        outer = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                for raw in self.rfile:
                    try:
                        msg = json.loads(raw)
                    except json.JSONDecodeError:
                        self._reply({"ok": False, "error": "bad json"})
                        continue
                    if not isinstance(msg, dict):
                        self._reply({"ok": False,
                                     "error": "message must be an object"})
                        continue
                    if "cmd" in msg:
                        self._reply(outer._command(msg["cmd"]))
                        if msg["cmd"] == "stop":
                            threading.Thread(target=outer._server.shutdown,
                                             daemon=True).start()
                            return
                    else:
                        outer._tick(msg)

            def _reply(self, obj):
                self.wfile.write((json.dumps(obj) + "\n").encode())
                self.wfile.flush()

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    def _tick(self, msg: dict) -> None:
        # validated at the boundary: a malformed tick must not buffer and
        # then fail a later flush (maybe another client's); ticks get no
        # reply, so rejects are counted in flush/stats replies
        if not isinstance(msg.get("underlying"), str) or not all(
                isinstance(msg.get(f), (int, float)) and not isinstance(msg.get(f), bool)
                for f in TICK_COLUMNS[1:]):
            with self._lock:
                self._rejected += 1
            return
        with self._lock:
            self._buffer.append(msg)
            if len(self._buffer) >= self.flush_every:
                self._flush_locked()

    def _flush_locked(self) -> int:
        if not self._buffer:
            return 0
        # the session takes a mapping of columns
        ticks = {f: np.asarray([m[f] for m in self._buffer]) for f in TICK_COLUMNS}
        n = self.session.ingest_ticks(ticks)
        # cleared only after a successful ingest, which is all or nothing
        self._buffer = []
        self._ingested += n
        return n

    def _command(self, cmd: str) -> dict:
        try:
            return self._command_locked(cmd)
        except Exception as e:  # noqa: BLE001 — reply, don't kill the thread
            return {"ok": False, "error": f"{type(e).__name__}: {e}"}

    def _command_locked(self, cmd: str) -> dict:
        with self._lock:
            if cmd == "flush":
                return {"ok": True, "ingested": self._flush_locked(),
                        "total": self._ingested, "rejected": self._rejected}
            if cmd == "stats":
                self._flush_locked()
                return {"ok": True, **self.session.stats(),
                        "server_ingested": self._ingested,
                        "rejected": self._rejected}
            if cmd == "refit":
                self._flush_locked()
                out = self.session.refit()
                unds = self.session.underlyings
                m = out.iv_grid.shape[-1]
                rv, bok, atm = (t.cpu().numpy() for t in (
                    out.realized_vol, out.butterfly_ok, out.iv_grid[:, 0, m // 2]))
                return {
                    "ok": True,
                    "realized_vol": {u: round(float(rv[i]), 6) for i, u in enumerate(unds)},
                    "butterfly_ok": {u: bool(bok[i]) for i, u in enumerate(unds)},
                    "atm_iv": {u: round(float(atm[i]), 6) for i, u in enumerate(unds)},
                }
            if cmd == "stop":
                self._flush_locked()
                self._close_session()
                return {"ok": True}
            return {"ok": False, "error": f"unknown cmd {cmd!r}"}

    def _close_session(self) -> None:
        close = getattr(self.session, "close", None)
        if close is not None:
            close()

    # ------------------------------------------------------------------
    def start(self) -> None:
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread:
            self._thread.join(timeout=5)
        with self._lock:
            self._close_session()

    def serve_forever(self) -> None:
        """Blocking serve (CLI mode); returns after a 'stop' command."""
        self._server.serve_forever()
        self._server.server_close()


def send_lines(host: str, port: int, lines, timeout: Optional[float] = None) -> list:
    """Client helper: send JSON objects, return the JSON replies (only
    commands get replies). ``timeout`` bounds each socket operation."""
    replies = []
    with socket.create_connection((host, port), timeout=timeout) as sock:
        f = sock.makefile("rwb")
        for obj in lines:
            f.write((json.dumps(obj) + "\n").encode())
            f.flush()
            if "cmd" in obj:
                replies.append(json.loads(f.readline()))
    return replies


def build_session(config, store, n_underlyings: int = 64,
                  device: torch.device | str = "cuda"):
    """The serving :class:`StreamingSession`, from the store's chains when
    it has interpolated data (``surface_task.build_chains``, one batch of
    every underlying), else a synthetic universe. Shared by the JSONL and
    Arrow Flight transports. Under ``processing.mesh_shape`` every launched
    rank calls it and holds its block (rank 0 reads the store). Returns
    ``(session, underlyings)``."""
    from iv_interpolation_tpu_torch.parallel.mesh import pipeline_mesh, rank_store
    from iv_interpolation_tpu_torch.pipeline import storage as st
    from iv_interpolation_tpu_torch.pipeline.stream_service import StreamingSession
    from iv_interpolation_tpu_torch.pipeline.surface_task import build_chains, pack_chain_group

    mesh = pipeline_mesh(config.processing.mesh_shape, config.processing.mesh_axis_names,
                         device=device)
    if mesh is not None:
        device = mesh.device
    store = rank_store(store, mesh)
    chains = []
    df = store.read(st.INTERPOLATED)
    if not df.empty:
        chains = build_chains(df, device=device)
    if chains:
        by_und = {}
        for c in chains:
            by_und.setdefault(c["underlying"], []).append(c)
        unds = sorted(by_und)
        E = max(len(v) for v in by_und.values())
        n = max(len(c["k"]) for c in chains)
        group = [(u, sorted(by_und[u], key=lambda c: c["T"])) for u in unds]
        k, iv, T, _, _ = pack_chain_group(group, E, n, dtype=np.float32)
    else:
        unds = [f"u{i:04d}" for i in range(n_underlyings)]
        E, n = 4, 12
        k = np.broadcast_to(np.linspace(-0.8, 0.8, n, dtype=np.float32),
                            (len(unds), E, n)).copy()
        T = np.broadcast_to(np.linspace(0.1, 1.0, E, dtype=np.float32),
                            (len(unds), E)).copy()
        iv = (0.5 + 0.05 * k * k).astype(np.float32)
    session = StreamingSession(unds, k, iv, T, n_grid=config.surface.grid_strikes,
                               device=device, mesh=mesh)
    return session, unds


def mesh_role(session):
    """(the session a server fronts, whether this rank serves): rank 0 of
    a mesh serves through :class:`MeshSession`, the other ranks follow."""
    if session.mesh is None:
        return session, True
    return (MeshSession(session), True) if session.mesh.is_leader else (session, False)


def run_serve(config, store, port: int = 8787, n_underlyings: int = 64,
              blocking: bool = True, device: torch.device | str = "cuda") -> "StreamServer":
    """CLI entry: serve the session over newline-delimited JSON on
    localhost:port (blocking unless told otherwise), on the card unless
    ``device`` names another. Under a mesh rank 0 serves and the other
    ranks follow it until ``stop`` (they return None)."""
    session, unds = build_session(config, store, n_underlyings=n_underlyings,
                                  device=device)
    session, serving = mesh_role(session)
    if not serving:
        follow(session)
        return None
    server = StreamServer(session, port=port)
    print(f"serving {len(unds)} underlyings on 127.0.0.1:{server.port} "
          f"(JSONL protocol; send {{\"cmd\": \"stop\"}} to exit)", flush=True)
    if blocking:
        server.serve_forever()
        server._close_session()
    else:
        server.start()
    return server
