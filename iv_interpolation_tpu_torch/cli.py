"""Command-line interface of the port (port of ``iv_interpolation_tpu/cli.py``).

The operator surface of the JAX package's ``iv-tpu``, on one card:

  --task {interpolation,bridge,candles,both,pipeline,all,surface,stream,serve}
  --method / --parity  the surface family and parity mode of --task surface
  --serve-port / --serve-transport {jsonl,flight}  --task serve
  --validate-only   readiness report (device, tables), exit 1 if not ready
  --estimate        task-1 time estimate from a timed calibration batch
  --profile         wrap the run in a torch.profiler trace written to
                    monitoring.profiler_dir (so does monitoring.enable_profiler)
  --test            3-symbol smoke run
  --resume BATCH_ID re-enqueue pending/error symbols
  --monitor         live progress dashboard for the latest batch
  --with-monitor    the dashboard in a side process during the task
  --visualize [--plot-dir DIR] [--plot-symbol SYM]  analysis PNGs
                    (needs matplotlib)
  --check-db        storage connectivity self-test (postgres: the server's
                    version and the role's permissions)
  --generate-sample-candles / --generate-sample-tickers, --symbols N
  --storage {memory,parquet,postgres}, --data-root, --env, --init-env
  --list-batches, --check [--quick], --compact, --json, --yes
  --start-date / --end-date, --batch-id, --shard I/N
  --device          where the pipeline runs: the card (``cuda``, the
                    default) unless ``--device cpu`` is given

Run as ``iv-tpu-torch ...`` or ``python -m iv_interpolation_tpu_torch.cli``.
Under a launched world (``torchrun`` / ``python -m torch.distributed.run
--nproc-per-node N -m iv_interpolation_tpu_torch.cli ...``) every rank runs
the CLI: it initialises the world first, ``processing.mesh_shape`` (e.g.
``IVTPU_PROCESSING__MESH_SHAPE=2``) shards the tasks over the ranks, rank 0
alone prints and writes, and the exit code is the largest of the ranks'.
A mesh larger than the world exits 2 with the message.
Every flag of the JAX package's ``iv-tpu`` is here. ``--check-db``,
``--monitor`` and ``--visualize`` read the store or the manifests only and
never touch the device; the monitor's side process creates no CUDA
context.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from iv_interpolation_tpu_torch import models


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="iv-tpu-torch",
        description="IV interpolation & candle pipeline on one NVIDIA card (PyTorch)")
    p.add_argument("--task",
                   choices=["interpolation", "bridge", "candles", "both",
                            "pipeline", "all", "surface", "stream", "serve"],
                   default="all",
                   help="stage(s) to run; 'pipeline' = fused on-device "
                        "chain, 'all' = staged via storage, 'surface' = "
                        "fit vol surfaces, 'serve' = streaming server")
    p.add_argument("--device", default="cuda",
                   help="torch device the pipeline runs on (default: cuda; "
                        "'cpu' for CPU tensors)")
    p.add_argument("--test", action="store_true",
                   help="smoke run limited to 3 symbols")
    p.add_argument("--resume", type=int, metavar="BATCH_ID",
                   help="resume pending/error symbols of a prior batch")
    p.add_argument("--monitor", action="store_true",
                   help="live progress dashboard for the latest batch")
    p.add_argument("--with-monitor", action="store_true",
                   help="run the dashboard in a side process during the task")
    p.add_argument("--generate-sample-candles", action="store_true",
                   help="write synthetic 1-min candles to storage")
    p.add_argument("--generate-sample-tickers", action="store_true",
                   help="write synthetic hourly tickers to storage")
    p.add_argument("--symbols", type=int, default=None,
                   help="limit number of symbols processed")
    p.add_argument("--method", default=None, choices=list(models.available()),
                   help="smile/surface family for --task surface "
                        "(default: config surface.smile_method)")
    p.add_argument("--parity", action="store_true",
                   help="float64 cubic-spline surface fits: the persisted "
                        "(total_variance, total_variance_lo) pair matches "
                        "SciPy's float64 spline to <=1e-8 (cubic_spline only)")
    p.add_argument("--env", choices=["development", "testing", "production"],
                   default=None, help="environment preset")
    p.add_argument("--storage", choices=["parquet", "memory", "postgres"],
                   default=None, help="storage backend override")
    p.add_argument("--data-root", default=None,
                   help="parquet dataset root (default ./data)")
    p.add_argument("--list-batches", action="store_true",
                   help="list prior run manifests")
    p.add_argument("--check", action="store_true",
                   help="audit the pipeline tables")
    p.add_argument("--visualize", action="store_true",
                   help="render pipeline analysis PNGs (needs matplotlib)")
    p.add_argument("--plot-dir", default=".",
                   help="output directory for --visualize figures")
    p.add_argument("--plot-symbol", default=None, metavar="SYM",
                   help="scope --visualize per-symbol figures to one symbol")
    p.add_argument("--quick", action="store_true",
                   help="with --check: quick census only")
    p.add_argument("--json", action="store_true",
                   help="machine-readable summaries")
    p.add_argument("--batch-id", type=int, default=None,
                   help="bridge only: convert rows from this task-1 batch")
    p.add_argument("--start-date", default=None,
                   help="restrict task-1 observations to >= this date")
    p.add_argument("--end-date", default=None,
                   help="restrict task-1 observations to <= this date")
    p.add_argument("--compact", action="store_true",
                   help="compact parquet tables (merge parts, apply "
                        "upsert dedup), then exit")
    p.add_argument("--yes", action="store_true",
                   help="skip interactive confirmations (large runs)")
    p.add_argument("--shard", default=None, metavar="I/N",
                   help="process-level scale-out: this process owns the "
                        "symbols whose crc32(name) %% N == I; storage "
                        "upserts are the rendezvous, manifests are "
                        "per-process")
    p.add_argument("--init-env", action="store_true",
                   help="write a .env template with the IVTPU_* knobs and exit")
    p.add_argument("--serve-port", type=int, default=8787,
                   help="TCP port for --task serve (0 = auto)")
    p.add_argument("--serve-transport", choices=["jsonl", "flight"], default="jsonl",
                   help="serving wire protocol: newline-delimited JSON or "
                        "Arrow Flight (gRPC, columnar; needs pyarrow with Flight)")
    p.add_argument("--validate-only", action="store_true",
                   help="check device and input tables, print a readiness "
                        "report, exit 1 if not ready")
    p.add_argument("--estimate", action="store_true",
                   help="estimate a full task-1 run from a timed calibration batch")
    p.add_argument("--profile", action="store_true",
                   help="write a torch.profiler trace of the run to "
                        "monitoring.profiler_dir")
    p.add_argument("--check-db", action="store_true",
                   help="run the storage-backend connectivity self-test and exit")
    return p


_ENV_TEMPLATE = """\
# iv_interpolation_tpu_torch environment template. Every
# IVTPU_<SECTION>__<FIELD> maps onto config.py; uncomment to override.
# ENVIRONMENT selects the preset (development|testing|production).
ENVIRONMENT=development

# storage backend: parquet (default) | memory | postgres
#IVTPU_STORAGE__BACKEND=parquet
#IVTPU_STORAGE__ROOT=./data

# postgres (used when backend=postgres; pure-Python driver built in,
# psycopg2 optional)
#IVTPU_STORAGE__PG_HOST=localhost
#IVTPU_STORAGE__PG_PORT=5432
#IVTPU_STORAGE__PG_DATABASE=trading
#IVTPU_STORAGE__PG_USER=postgres
#IVTPU_STORAGE__PG_PASSWORD=

# processing (MESH_SHAPE: ranks of a torch.distributed world, e.g. 2)
#IVTPU_PROCESSING__BATCH_SIZE=256
#IVTPU_PROCESSING__MESH_SHAPE=
#IVTPU_PROCESSING__READ_CHUNK_SYMBOLS=2048
#IVTPU_CHECKPOINT__MAX_RETRIES=3

# monitoring
#IVTPU_MONITORING__LOG_DIR=./logs
#IVTPU_MONITORING__SNAPSHOT_DIR=./snapshots
"""


def _leader() -> bool:
    """Rank 0 of the launched world, or the only process: it prints."""
    from iv_interpolation_tpu_torch.parallel.mesh import world_info
    return world_info()["rank"] == 0


def _own_store(runner):
    """The runner's store itself: under a mesh rank 0's (None on the other
    ranks), not the view that broadcasts its reads."""
    from iv_interpolation_tpu_torch.parallel.mesh import RankStore
    return runner.store.store if isinstance(runner.store, RankStore) else runner.store


def _emit(args, payload: dict, title: str) -> None:
    if not _leader():
        return
    if args.json:
        print(json.dumps(payload, default=str))
        return
    print(f"\n=== {title} ===")
    for k, v in payload.items():
        print(f"  {k}: {v}")


def _check_db(config, args) -> int:
    """Connectivity self-test for the configured backend: on postgres the
    server's ``SELECT version()`` and the role's permissions, elsewhere
    the table count."""
    from iv_interpolation_tpu_torch.pipeline.storage import get_store
    try:
        store = get_store(config.storage)
        if hasattr(store, "probe_permissions"):     # PostgresStore
            with store._connect() as conn, conn.cursor() as cur:
                cur.execute("SELECT version()")
                version = cur.fetchone()[0]
            payload = {"ok": True, "backend": "postgres", "server": version,
                       "permissions": store.probe_permissions()}
        else:
            payload = {"ok": True, "backend": config.storage.backend,
                       "tables": len(store.tables())}
    except Exception as e:  # noqa: BLE001 — the self-test reports any failure
        payload = {"ok": False, "backend": config.storage.backend, "error": str(e)}
    _emit(args, payload, "storage connectivity")
    return 0 if payload["ok"] else 1


def _visualize(config, args) -> int:
    """The analysis figures of the configured store into ``--plot-dir``;
    exit 1 with a message naming matplotlib where it is not installed."""
    from iv_interpolation_tpu_torch.pipeline import storage as st
    try:
        from iv_interpolation_tpu_torch.pipeline.visualize import PipelineVisualizer
        viz = PipelineVisualizer(st.get_store(config.storage), out_dir=args.plot_dir)
    except ImportError as e:
        print(f"iv-tpu-torch: --visualize: {e}", file=sys.stderr)
        return 1
    _emit(args, viz.summary_report(symbol=args.plot_symbol), "visualization report")
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from iv_interpolation_tpu_torch.parallel import mesh as pmesh
    world = pmesh.launched_world() > 1
    if world:
        # every rank joins before it reads a config or touches a store
        pmesh.init_world(args.device)
    try:
        code = _main(args)
        if world:
            # the run's exit code is the worst rank's
            code = pmesh.worst_code(code)
    finally:
        if world:
            pmesh.shutdown_world()
    return code


def _main(args) -> int:
    if not _leader() and (args.init_env or args.check_db or args.list_batches
                          or args.visualize or args.monitor):
        # host-only commands: rank 0 alone runs them
        return 0

    if args.init_env:
        root = args.data_root or "."
        os.makedirs(root, exist_ok=True)
        path = os.path.join(root, ".env")
        if os.path.exists(path):
            print(f"refusing to overwrite existing {path}")
            return 1
        with open(path, "w") as f:
            f.write(_ENV_TEMPLATE)
        print(f"wrote {path}")
        return 0

    from iv_interpolation_tpu_torch.config import get_config, load_dotenv
    from iv_interpolation_tpu_torch.monitoring.logging import setup_logging

    # a --data-root .env (written by --init-env) joins the overlay;
    # get_config() also loads ./.env from the working directory
    if args.data_root:
        load_dotenv(os.path.join(args.data_root, ".env"))
    config = get_config(args.env)
    if args.storage:
        config.storage.backend = args.storage
    if args.data_root:
        config.storage.root = args.data_root
    if args.parity:
        config.surface.compensated = True
    if args.shard:
        try:
            i_s, n_s = args.shard.split("/")
            config.processing.shard_index = int(i_s)
            config.processing.shard_count = int(n_s)
        except ValueError:
            print(f"--shard expects I/N (got {args.shard!r})", file=sys.stderr)
            return 2
        if not (config.processing.shard_count >= 1
                and 0 <= config.processing.shard_index
                < config.processing.shard_count):
            print(f"--shard index out of range: {args.shard}", file=sys.stderr)
            return 2
    if config.processing.enable_logging:
        # rank 0 alone keeps the log files
        setup_logging(config.monitoring.log_dir if _leader() else None,
                      config.processing.log_level)

    from iv_interpolation_tpu_torch.pipeline import storage as st
    from iv_interpolation_tpu_torch.pipeline.manifest import RunManifest
    from iv_interpolation_tpu_torch.pipeline.runner import PipelineRunner

    if args.check_db:
        return _check_db(config, args)

    if args.list_batches:
        batches = RunManifest.list_batches(config.checkpoint.manifest_dir)
        if args.json:
            print(json.dumps(batches, default=str))
        else:
            for b in batches:
                print(f"  batch {b['batch_id']} [{b['task']}]: {b['by_status']}")
            if not batches:
                print("  (no batches)")
        return 0

    if args.validate_only:
        # before the runner, which raises where the device cannot be
        # reached: that is a readiness report's finding
        from iv_interpolation_tpu_torch.pipeline.validate import validate_readiness
        report = validate_readiness(config, st.get_store(config.storage), task=args.task,
                                    device=args.device)
        _emit(args, report, "readiness report")
        return 0 if report["ready"] else 1

    # the store and manifest readers run before the runner, which touches
    # the device: they never need it
    if args.visualize:
        return _visualize(config, args)

    if args.monitor:
        from iv_interpolation_tpu_torch.monitoring.monitor import RealtimeMonitor
        RealtimeMonitor(config).run()
        return 0

    try:
        runner = PipelineRunner(config, device=args.device)
    except ValueError as e:
        if "mesh_shape" not in str(e):
            raise
        print(f"iv-tpu-torch: {e}", file=sys.stderr)
        return 2
    runner.install_signal_handler()

    if args.compact:
        from iv_interpolation_tpu_torch.parallel.mesh import from_leader
        store = _own_store(runner)

        def compact():
            if not hasattr(store, "compact"):
                return None
            report = {}
            for table in store.tables():
                before = len(store._parts(table))
                store.compact(table)
                report[table] = {"parts_before": before, "parts_after": 1}
            return report

        report = from_leader(runner.mesh, compact)
        if report is None:
            _emit(args, {"ok": False, "reason": "backend has no compaction"},
                  "compact")
            return 1
        _emit(args, report, "compaction complete")
        return 0

    if args.check:
        from iv_interpolation_tpu_torch.pipeline.check_results import (
            check_candle_results, check_interpolation_results, quick_summary)
        _emit(args, quick_summary(runner.store), "quick summary")
        if args.quick:
            return 0
        _emit(args, check_interpolation_results(runner.store), "task 1 audit")
        _emit(args, check_candle_results(runner.store), "task 2 audit")
        from iv_interpolation_tpu_torch.pipeline.check_results import check_surface_results
        _emit(args, check_surface_results(runner.store), "surface audit")
        return 0

    if args.generate_sample_candles or args.generate_sample_tickers:
        from iv_interpolation_tpu_torch.pipeline.sample_data import (
            generate_sample_candles, generate_sample_tickers)
        n = args.symbols or 5
        if args.generate_sample_tickers:
            rows = runner.store.write(st.TICKERS, generate_sample_tickers(num_symbols=n),
                                      upsert_keys=["symbol", "date"])
            _emit(args, {"table": st.TICKERS, "rows": rows, "symbols": n},
                  "sample tickers generated")
        if args.generate_sample_candles:
            rows = runner.store.write(st.MINUTE_CANDLES,
                                      generate_sample_candles(num_symbols=n),
                                      upsert_keys=["symbol", "timestamp"])
            _emit(args, {"table": st.MINUTE_CANDLES, "rows": rows, "symbols": n},
                  "sample candles generated")
        return 0

    if args.estimate:
        from iv_interpolation_tpu_torch.pipeline.validate import estimate_processing
        _emit(args, estimate_processing(config, runner.store, device=runner.device),
              "processing estimate")
        return 0

    from contextlib import nullcontext

    from iv_interpolation_tpu_torch.monitoring.metrics import profile_trace

    limit = 3 if args.test else args.symbols
    monitor_proc = None
    if args.with_monitor and _leader():
        # spawn, not fork: a fork of a process whose torch runtime has
        # started threads (and a CUDA context) can deadlock
        import multiprocessing as mp

        from iv_interpolation_tpu_torch.monitoring.monitor import RealtimeMonitor
        monitor_proc = mp.get_context("spawn").Process(
            target=RealtimeMonitor(config).run, daemon=True,
            # the side dashboard starts before the run's first manifest
            # flush: it waits for a new batch instead of exiting on the
            # previous (finished) one or on a missing runs directory
            kwargs={"wait_for_new": True})
        monitor_proc.start()
    profiling = args.profile or config.monitoring.enable_profiler
    t0 = time.time()
    with profile_trace(config.monitoring.profiler_dir) if profiling else nullcontext():
        out = _dispatch(args, runner, limit)
    out["wall_s"] = round(time.time() - t0, 3)
    out["status"] = runner.status()
    if runner.mesh is not None and "world" not in out:
        out["world"] = runner.world_report()
    if profiling:
        out["profile_dir"] = config.monitoring.profiler_dir
    if monitor_proc is not None:
        monitor_proc.join(timeout=2 * config.monitoring.refresh_interval_s)
        if monitor_proc.is_alive():
            monitor_proc.terminate()
    _emit(args, out, f"task={args.task} complete")
    return 0


def _confirm_large_run(args, runner, limit) -> bool:
    """Operator guard for runs over 100 symbols, active only on a TTY and
    bypassed by --yes/--test."""
    if args.yes or args.test:
        return True
    from iv_interpolation_tpu_torch.parallel.mesh import from_leader
    from iv_interpolation_tpu_torch.pipeline import storage as st
    store = _own_store(runner)

    def ask() -> bool:
        if not sys.stdin.isatty():
            return True
        n = len(store.list_symbols(st.TICKERS))
        if limit:
            n = min(n, limit)
        if n <= 100:
            return True
        answer = input(f"process {n} symbols? [y/N] ").strip().lower()
        return answer in ("y", "yes")

    # rank 0 asks; every rank follows its answer
    return from_leader(runner.mesh, ask)


def _dispatch(args, runner, limit):
    from iv_interpolation_tpu_torch.pipeline import storage as st

    if args.task in ("interpolation", "both", "pipeline", "all") \
            and not _confirm_large_run(args, runner, limit):
        return {"aborted": "user declined large run"}

    dates = dict(start_date=args.start_date, end_date=args.end_date)
    if args.task == "interpolation":
        return {"task1": runner.run_task1(resume_batch_id=args.resume,
                                          limit=limit, **dates)}
    if args.task == "bridge":
        syms = runner.store.list_symbols(st.INTERPOLATED)[:limit] if limit else None
        return {"bridge": runner.run_bridge(symbols=syms, batch_id=args.batch_id,
                                            resume_batch_id=args.resume)}
    if args.task == "candles":
        syms = runner.store.list_symbols(st.MINUTE_CANDLES)[:limit] if limit else None
        return {"task2": runner.run_task2(symbols=syms, resume_batch_id=args.resume)}
    if args.task == "both":
        out = {"task1": runner.run_task1(resume_batch_id=args.resume,
                                         limit=limit, **dates)}
        # a scoped run reconstructs only this run's symbols
        scope = None
        if limit or args.resume or args.start_date or args.end_date:
            scope = runner.completed_symbols("interpolation", out["task1"].get("batch_id"))
        out["task2"] = runner.run_task2(symbols=scope)
        return out
    if args.task == "surface":
        from iv_interpolation_tpu_torch.pipeline.surface_task import run_surface_fit
        return {"surface": run_surface_fit(runner.config, runner.store, limit=limit,
                                           method=args.method, device=runner.device)}
    if args.task == "serve":
        if args.serve_transport == "flight":
            from iv_interpolation_tpu_torch.pipeline.flight_service import run_serve_flight
            serve = run_serve_flight
        else:
            from iv_interpolation_tpu_torch.pipeline.serve import run_serve
            serve = run_serve
        serve(runner.config, runner.store, port=args.serve_port,
              n_underlyings=limit or 64, device=runner.device)
        return {"serve": "stopped"}
    if args.task == "stream":
        from iv_interpolation_tpu_torch.pipeline.stream_service import run_stream_replay
        return {"stream": run_stream_replay(runner.config, n_underlyings=limit or 64,
                                            device=runner.device)}
    if args.task == "pipeline":
        # fused: stages chained on the device, no storage round trips
        return runner.run_pipeline_fused(limit=limit, resume_batch_id=args.resume,
                                         **dates)
    return runner.run_all(limit=limit, resume_batch_id=args.resume, **dates)


if __name__ == "__main__":
    sys.exit(main())
