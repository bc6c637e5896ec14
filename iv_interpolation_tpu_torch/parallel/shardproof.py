"""Concurrent multi-process shard proof: simultaneous OS processes over one
store (port of ``iv_interpolation_tpu/parallel/shardproof.py``).

The ``--shard I/N`` machinery carries its concurrency design in the
pieces: (ns, pid) parquet part names, per-shard manifest names and
hash-of-name ownership. This module proves that it holds under real
concurrency:

1. **Concurrent parity** (:func:`proof_concurrent`): two
   ``iv-tpu-torch --task pipeline --shard {0,1}/2`` subprocesses started
   together against one parquet store; both exit 0, the three output
   tables equal the unsharded in-process run, and each shard's manifest
   covers exactly its hash partition with no torn line.
2. **Crash and resume** (:func:`proof_kill_resume`): shard 0 is SIGKILLed
   mid-run, once its manifest shows a symbol completed and one still
   pending, then run again with ``--resume <batch_id>`` while shard 1
   runs on; the resumed process finishes the partition and the store
   reaches the same tables.

The subprocesses and the in-process reference run on ``device``: the card
unless the caller passes ``"cpu"``. Equality follows the device
(:func:`assert_tables_equal`): on CPU tensors the tables are equal byte
for byte; on the card every column is, except the 5-minute ``volume``,
which may differ within 8 eps32 of itself, because the aggregation kernel
adds a bucket's parts through shared-memory atomics in an order that
varies between runs. Every shard process loads the kernel library that is
already built; none builds it.
"""

from __future__ import annotations

import glob
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# environment variables of the JAX/TPU runtime, dropped from a shard's
# environment: the port's processes use none of them
_FOREIGN_ENV = ("JAX_", "XLA_", "PALLAS_", "TPU_")
EPS32 = float(np.finfo(np.float32).eps)
TABLE_KEYS = {"interpolated_trading_tickers": ["symbol", "date"],
              "minute_candles": ["symbol", "timestamp"],
              "reconstructed_candles": ["symbol", "timestamp"]}


def subprocess_env(manifest_dir: str, log_dir: str,
                   overrides: Optional[Dict[str, str]] = None) -> dict:
    """The environment of a shard's CLI subprocess: this process's, less
    every JAX or XLA variable and the ``torch.distributed`` launcher's (a
    rank of a mesh may run the proof; its shards are processes of their
    own), with the package on ``PYTHONPATH``, the manifest and log
    directories overridden, snapshots off, and ``overrides`` (``IVTPU_*``
    settings) on top."""
    from iv_interpolation_tpu_torch.parallel.mesh import WORLD_ENV
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(_FOREIGN_ENV) and k not in WORLD_ENV}
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_REPO_ROOT, env.get("PYTHONPATH", "")) if p)
    env["IVTPU_CHECKPOINT__MANIFEST_DIR"] = manifest_dir
    env["IVTPU_MONITORING__LOG_DIR"] = log_dir
    env["IVTPU_MONITORING__ENABLE_SNAPSHOTS"] = "false"
    env.update(overrides or {})
    return env


def launch_shard(i: int, n: int, data_root: str, workdir: str,
                 resume: Optional[int] = None, device: str = "cuda",
                 overrides: Optional[Dict[str, str]] = None) -> subprocess.Popen:
    """Start ``iv-tpu-torch --task pipeline --shard i/n --device <device>``
    as an OS process; its output goes to ``workdir/shard<i>.log``."""
    manifest_dir = os.path.join(workdir, f"runs_shard{i}")
    log_dir = os.path.join(workdir, f"logs_shard{i}")
    cmd = [sys.executable, "-m", "iv_interpolation_tpu_torch.cli",
           "--task", "pipeline", "--shard", f"{i}/{n}",
           "--env", "testing", "--storage", "parquet",
           "--data-root", data_root, "--json", "--device", device]
    if resume is not None:
        cmd += ["--resume", str(resume)]
    out = open(os.path.join(workdir, f"shard{i}.log"), "a")
    try:
        return subprocess.Popen(
            cmd, env=subprocess_env(manifest_dir, log_dir, overrides),
            cwd=workdir, stdout=out, stderr=subprocess.STDOUT, text=True)
    finally:
        out.close()


def _output(workdir: str, i: int) -> str:
    with open(os.path.join(workdir, f"shard{i}.log")) as f:
        return f.read()[-4000:]


def _wait(p: subprocess.Popen, workdir: str, i: int, timeout_s: float) -> None:
    """Wait for shard ``i``; it must exit 0."""
    try:
        p.wait(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        p.kill()
        p.wait()
        raise AssertionError(f"shard {i} timed out:\n{_output(workdir, i)}")
    if p.returncode != 0:
        raise AssertionError(f"shard {i} subprocess rc={p.returncode}:\n"
                             f"{_output(workdir, i)}")


def _seed_store(data_root: str, num_symbols: int = 6, hours: int = 12):
    """Write deterministic sample tickers into a fresh parquet store.
    ``hours`` >= interpolation.min_data_points (10 in every preset), so
    the seeded series clear the default skip threshold."""
    from iv_interpolation_tpu_torch.pipeline import storage as st
    from iv_interpolation_tpu_torch.pipeline.sample_data import generate_sample_tickers

    tickers = generate_sample_tickers(num_symbols=num_symbols, hours=hours)
    st.ParquetStore(data_root).write(st.TICKERS, tickers)
    return tickers


def _read_tables(data_root: str) -> Dict[str, "object"]:
    """The three output tables, sorted by their keys, without the columns
    that name a run (batch_id, created_at)."""
    from iv_interpolation_tpu_torch.pipeline import storage as st

    store = st.ParquetStore(data_root)
    out = {}
    for t, key in TABLE_KEYS.items():
        df = store.read(t).sort_values(key).reset_index(drop=True)
        df = df.drop(columns=[c for c in ("batch_id", "created_at") if c in df.columns])
        df["symbol"] = df["symbol"].astype(str)
        out[t] = df
    return out


def _reference_run(data_root: str, device: str,
                   batch_size: Optional[int] = None) -> Dict[str, "object"]:
    """The unsharded in-process fused run of the port over ``data_root``,
    on ``device`` (one rank's, inside a launched world too); returns its
    tables."""
    from iv_interpolation_tpu_torch.config import get_config
    from iv_interpolation_tpu_torch.pipeline import storage as st
    from iv_interpolation_tpu_torch.pipeline.runner import PipelineRunner

    cfg = get_config("testing")
    cfg.storage.backend = "parquet"
    cfg.storage.root = data_root
    cfg.processing.mesh_shape = (1,)
    if batch_size:
        cfg.processing.batch_size = batch_size
    with tempfile.TemporaryDirectory() as td:
        cfg.checkpoint.manifest_dir = os.path.join(td, "runs")
        cfg.monitoring.log_dir = os.path.join(td, "logs")
        cfg.monitoring.enable_snapshots = False
        PipelineRunner(cfg, store=st.ParquetStore(data_root),
                       device=device).run_pipeline_fused()
    return _read_tables(data_root)


def assert_tables_equal(got: Dict[str, "object"], ref: Dict[str, "object"],
                        device: str) -> int:
    """The tables of a sharded run against the reference's. On CPU tensors
    every table is equal byte for byte. On the card every column is equal
    except the 5-minute ``volume``, a float32 sum of <= 5 one-minute
    volumes that the kernel's atomics may add in another order, held
    within 8 eps32 of itself. Returns the number of 5-minute volumes that
    differ at all."""
    import pandas as pd

    differ = 0
    for t, want in ref.items():
        have = got[t]
        if t == "reconstructed_candles" and device != "cpu":
            have, want = have.copy(), want.copy()
            va = have.pop("volume").to_numpy(np.float64)
            vb = want.pop("volume").to_numpy(np.float64)
            if len(va) != len(vb) or not (np.abs(va - vb) <= 8 * EPS32 * np.abs(vb)).all():
                raise AssertionError(f"{t}: 5-minute volume beyond 8 eps32")
            differ = int((va != vb).sum())
        pd.testing.assert_frame_equal(have, want, check_exact=True)
    return differ


def _manifest_records(workdir: str, shard: int, task: str = "interpolation",
                      strict: bool = True) -> Dict[str, dict]:
    """A shard's newest manifest jsonl, by symbol. Sharded runners suffix
    the task name (``interpolation.shard0``). ``strict`` raises on a torn
    line; without it (polling a live run) an unfinished last line is
    skipped."""
    paths = sorted(glob.glob(os.path.join(
        workdir, f"runs_shard{shard}", f"{task}.shard{shard}_*.jsonl")))
    if not paths:
        return {}
    records: Dict[str, dict] = {}
    with open(paths[-1]) as f:
        for line in f:
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                if strict:
                    raise
                break
            records[rec["symbol"]] = rec
    return records


def _done(records: Dict[str, dict]) -> List[str]:
    return sorted(s for s, r in records.items() if r["status"] in ("completed", "skipped"))


def _expected_partition(tickers, n: int) -> Dict[int, List[str]]:
    from iv_interpolation_tpu_torch.pipeline.runner import symbol_fold

    universe = sorted(tickers["symbol"].unique())
    return {i: [s for s in universe if symbol_fold(s) % n == i] for i in range(n)}


def _overrides(batch_size: Optional[int], checkpoint_interval: Optional[int] = None):
    out = {}
    if batch_size:
        out["IVTPU_PROCESSING__BATCH_SIZE"] = str(batch_size)
    if checkpoint_interval:
        out["IVTPU_CHECKPOINT__CHECKPOINT_INTERVAL"] = str(checkpoint_interval)
    return out


def reference_tables(workdir: str, num_symbols: int = 6, hours: int = 12,
                     device: str = "cuda", batch_size: Optional[int] = None):
    """The unsharded run's tables over the proofs' seeded store, which
    both proofs compare against (pass them as ``reference`` to run it
    once for both)."""
    ref_root = os.path.join(workdir, "ref_store")
    _seed_store(ref_root, num_symbols=num_symbols, hours=hours)
    return _reference_run(ref_root, device, batch_size)


def proof_concurrent(workdir: str, num_symbols: int = 6, hours: int = 12,
                     timeout_s: float = 600.0, device: str = "cuda",
                     batch_size: Optional[int] = None, reference=None) -> dict:
    """Two simultaneous shard processes over one store == the unsharded
    run, on ``device``."""
    ref_tables = reference or reference_tables(workdir, num_symbols, hours, device, batch_size)

    data_root = os.path.join(workdir, "shared_store")
    tickers = _seed_store(data_root, num_symbols=num_symbols, hours=hours)
    expect = _expected_partition(tickers, 2)
    assert min(len(v) for v in expect.values()) >= 1, expect

    t0 = time.time()
    procs = [launch_shard(i, 2, data_root, workdir, device=device,
                          overrides=_overrides(batch_size)) for i in (0, 1)]
    for i, p in enumerate(procs):
        _wait(p, workdir, i, timeout_s)
    wall = time.time() - t0

    # disjoint complete coverage, no torn manifest lines
    for i in (0, 1):
        done = _done(_manifest_records(workdir, i))
        assert done == expect[i], (i, done, expect[i])

    got = _read_tables(data_root)
    differ = assert_tables_equal(got, ref_tables, device)
    return {"symbols": num_symbols,
            "partition_sizes": {i: len(v) for i, v in expect.items()},
            "wall_s": round(wall, 3), "volumes_that_differ": differ,
            "tables": {t: len(df) for t, df in got.items()}}


def proof_kill_resume(workdir: str, num_symbols: int = 6, hours: int = 12,
                      timeout_s: float = 600.0, device: str = "cuda",
                      batch_size: Optional[int] = 1, reference=None) -> dict:
    """SIGKILL shard 0 mid-run; ``--resume`` finishes its partition.

    Shard 0 flushes its manifest after every event and is killed once it
    shows a symbol completed and one still pending, so its partition must
    span more than one batch (``batch_size``). A victim that exits before
    that fails the proof: it would prove nothing."""
    ref_tables = reference or reference_tables(workdir, num_symbols, hours, device, batch_size)

    data_root = os.path.join(workdir, "kill_store")
    tickers = _seed_store(data_root, num_symbols=num_symbols, hours=hours)
    expect = _expected_partition(tickers, 2)
    assert len(expect[0]) >= 2, f"shard 0 needs two symbols to be killed mid-run: {expect}"

    # shard 0 is killed between two of its batches and resumed while
    # shard 1 runs to completion
    t0 = time.time()
    p1 = launch_shard(1, 2, data_root, workdir, device=device,
                      overrides=_overrides(batch_size))
    p0 = launch_shard(0, 2, data_root, workdir, device=device,
                      overrides=_overrides(batch_size, checkpoint_interval=1))
    deadline = time.time() + timeout_s
    while True:
        recs = _manifest_records(workdir, 0, strict=False)
        status = [r["status"] for r in recs.values()]
        if "completed" in status and "pending" in status:
            break
        if p0.poll() is not None:
            p1.kill()
            raise AssertionError(
                f"shard 0 exited (rc={p0.returncode}) before it could be killed "
                f"mid-run: {status}\n{_output(workdir, 0)}")
        if time.time() > deadline:
            p0.kill()
            p1.kill()
            raise AssertionError("timed out waiting for shard 0 to complete a symbol")
        time.sleep(0.005)
    os.kill(p0.pid, signal.SIGKILL)
    p0.wait()
    assert p0.returncode == -signal.SIGKILL, p0.returncode   # really died
    completed_before = status.count("completed")

    # resume shard 0 under the same batch id (the torn run's manifest)
    paths = sorted(glob.glob(os.path.join(workdir, "runs_shard0",
                                          "interpolation.shard0_*.jsonl")))
    batch_id = int(os.path.basename(paths[-1]).split("_")[-1].split(".")[0])
    pr = launch_shard(0, 2, data_root, workdir, resume=batch_id, device=device,
                      overrides=_overrides(batch_size))
    _wait(p1, workdir, 1, timeout_s)
    _wait(pr, workdir, 0, timeout_s)
    wall = time.time() - t0

    done = _done(_manifest_records(workdir, 0))
    assert done == expect[0], (done, expect[0])
    got = _read_tables(data_root)
    differ = assert_tables_equal(got, ref_tables, device)
    return {"killed_batch_id": batch_id, "completed_before_kill": completed_before,
            "resumed_symbols": len(done), "wall_s": round(wall, 3),
            "partition_sizes": {i: len(v) for i, v in expect.items()},
            "volumes_that_differ": differ,
            "tables": {t: len(df) for t, df in got.items()}}
