"""Rank bodies of the mesh checks: what each rank of a launched world runs
when the CPU tests (and their rehearsals) drive the port's mesh paths.

Run as ``python -m iv_interpolation_tpu_torch.parallel._ranks BODY JSON``
under ``parallel.dryrun.start_world`` (or any launcher): the rank joins
the world, runs ``BODY`` with the JSON arguments, writes what rank 0
gathered under ``args["out"]`` (pickles and ``.npz`` files) and prints its
result line. Inputs come as files the caller wrote, so a rank imports
nothing but the port.
"""

from __future__ import annotations

import json
import os
import pickle
import sys

import numpy as np
import torch

from iv_interpolation_tpu_torch.parallel import dryrun
from iv_interpolation_tpu_torch.parallel import mesh as pmesh


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _dump(obj, path) -> None:
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def _raises(fn, *args, **kwargs) -> str:
    try:
        fn(*args, **kwargs)
    except ValueError as e:
        return str(e)
    return ""


def mesh_contract(args, device) -> dict:
    """``make_mesh`` / ``pipeline_mesh`` / the placement helpers and the
    collectives at this world's size."""
    n = pmesh.launched_world()
    out = {"world": n, "rank": pmesh.world_info()["rank"],
           "backend": pmesh.world_info()["backend"]}
    out["default"] = pmesh.make_mesh(device=device).shape
    out["pipeline_none"] = pmesh.pipeline_mesh(None, device=device).shape
    out["pipeline_one"] = pmesh.pipeline_mesh((1,), device=device)
    out["pipeline_gen"] = pmesh.pipeline_mesh((n, 1), device=device).shape
    if n % 2 == 0:
        m2 = pmesh.pipeline_mesh((n // 2, 2), ("data", "slice"), device=device)
        out["pipeline_2d"] = m2.shape
        out["pipeline_2d_axes"] = {a: [x.size, x.index] for a, x in m2.axes.items()}
    out["too_big"] = _raises(pmesh.pipeline_mesh, (2 * n,), device=device)
    out["partial"] = _raises(pmesh.pipeline_mesh, (n // 2,), device=device) if n > 2 else ""
    out["make_wrong"] = _raises(pmesh.make_mesh, (n + 1, 1), device=device)
    mesh = pmesh.make_mesh((n,), ("data",), device=device)
    x = torch.arange(4 * n * 3, dtype=torch.float64).reshape(4 * n, 3)
    block = pmesh.shard_rows(mesh, x)
    out["block"] = block[:, 0].tolist()
    out["passthrough"] = [tuple(pmesh.shard_rows(mesh, torch.zeros(r, 2)).shape)
                          for r in (n - 1, 4 * n + 1)] if n > 1 else []
    out["expect_dim0"] = tuple(pmesh.shard_rows(mesh, x, expect_dim0=7).shape)
    out["numpy_block"] = pmesh.shard_rows(mesh, x.numpy())[:, 0].tolist()
    back = pmesh.gather_rows(mesh, {"x": block, "flag": block[:, 0] > 5,
                                    "half": block.to(torch.bfloat16), "tag": "k"},
                             rows=4 * n)
    out["gather_equal"] = bool(torch.equal(back["x"], x) and torch.equal(back["flag"], x[:, 0] > 5)
                               and torch.equal(back["half"], x.to(torch.bfloat16))
                               and back["tag"] == "k")
    to0 = pmesh.gather_rows(mesh, block, rows=4 * n, dst=0)
    out["gather_dst0"] = None if to0 is None else bool(torch.equal(to0, x))
    out["psum"] = float(pmesh.psum(mesh, torch.tensor([float(mesh.rank + 1)]))[0])
    out["shard_batch_axis1"] = tuple(pmesh.shard_batch(mesh, torch.zeros(3, 2 * n), axis=1).shape)
    out["any_rank"] = pmesh.any_rank(mesh, mesh.rank == n - 1)
    try:
        pmesh.agree(mesh, RuntimeError("boom") if mesh.rank == n - 1 else None)
        out["agree"] = ""
    except pmesh.RankError as e:
        out["agree"] = str(e)
    return out


def sequence(args, device) -> dict:
    """Each case of ``args["cases"]`` (an ``.npz`` of values and masks)
    through ``sharded_masked_interp`` and ``local_masked_interp``."""
    from iv_interpolation_tpu_torch.parallel.sequence import (local_masked_interp,
                                                              sharded_masked_interp)
    mesh = pmesh.make_mesh((pmesh.launched_world(), 1), device=device)
    cases = json.loads(args["spec"])
    data = np.load(args["cases"])
    got = {}
    for name, (method, max_gap, bf16) in cases.items():
        vals = torch.as_tensor(data[f"{name}_values"], device=mesh.device)
        mask = torch.as_tensor(data[f"{name}_mask"], device=mesh.device)
        if bf16:
            vals = vals.to(torch.bfloat16)
        out = sharded_masked_interp(vals, mask, mesh, method=method, max_gap_minutes=max_gap)
        L, ax = vals.shape[-1], mesh.axes["data"]
        lo = ax.index * (L // ax.size)
        local = local_masked_interp(vals[..., lo:lo + L // ax.size],
                                    torch.broadcast_to(mask, vals.shape)[..., lo:lo + L // ax.size],
                                    mesh, L, method=method, max_gap_minutes=max_gap)
        same = torch.equal(torch.nan_to_num(local, nan=-7.0),
                           torch.nan_to_num(out[..., lo:lo + L // ax.size], nan=-7.0))
        got[name] = out.float().cpu().numpy() if bf16 else out.cpu().numpy()
        got[f"{name}_local_equal"] = np.array(same)
    if mesh.is_leader:
        np.savez(os.path.join(args["out"], "sequence.npz"), **got)
    return {"cases": sorted(cases)}


def _runner_config(args, root, shape):
    from iv_interpolation_tpu_torch.config import get_config
    cfg = get_config("testing")
    cfg.storage.backend = "memory"
    cfg.processing.dtype = args.get("dtype", "float64")
    cfg.processing.mesh_shape = shape
    cfg.processing.batch_size = args.get("batch", 16)
    cfg.interpolation.method = args.get("method", "linear")
    cfg.interpolation.min_data_points = 5
    cfg.checkpoint.manifest_dir = os.path.join(root, "runs")
    cfg.monitoring.log_dir = os.path.join(root, "logs")
    cfg.monitoring.enable_snapshots = False
    return cfg


def _store(tickers):
    from iv_interpolation_tpu_torch.pipeline import storage as st
    store = st.MemoryStore()
    store.write(st.TICKERS, tickers)
    return store


def _dump_tables(store, path) -> None:
    from iv_interpolation_tpu_torch.pipeline import storage as st
    _dump({t: store.read(t) for t in (st.INTERPOLATED, st.MINUTE_CANDLES, st.RECONSTRUCTED)},
          path)


def runner(args, device) -> dict:
    """The runner's cases over a mesh of the whole world, from the tickers
    at ``args["tickers"]``: ``fused`` and ``staged`` runs; ``resume`` (a
    run stopped after its first batch, then resumed); ``fail`` (rank
    ``args["fail_rank"]`` raises in the batch holding ``args["fail_symbol"]``
    on every attempt); ``cubic`` (a fused cubic run). Rank 0 writes each
    case's tables and summary."""
    from iv_interpolation_tpu_torch.pipeline import runner as runner_mod
    n = pmesh.launched_world()
    tickers = _load(args["tickers"])
    out = {}
    for case in args["cases"]:
        cfg = _runner_config(args, os.path.join(args["out"], case), (n,))
        store = _store(tickers)
        r = runner_mod.PipelineRunner(cfg, store=store, device=device)
        summary = {}
        if case in ("fused", "cubic"):
            if case == "cubic":
                cfg.interpolation.method = "cubic"
            summary = r.run_pipeline_fused()
        elif case == "staged":
            summary = r.run_all()
        elif case == "resume":
            batches = {"n": 0}
            stopping = r._stopping

            def stop_after_one():
                batches["n"] += 1
                return batches["n"] > 1 or stopping()

            r._stopping = stop_after_one
            first = r.run_pipeline_fused()
            r = runner_mod.PipelineRunner(cfg, store=store, device=device)
            summary = {"first": first,
                       "resumed": r.run_pipeline_fused(resume_batch_id=first["task1"]["batch_id"])}
        elif case == "fail":
            cfg.checkpoint.max_retries = 1
            dispatch = runner_mod.dispatch
            attempts = {"n": 0}

            def failing(batch, *a, **kw):
                if pmesh.world_info()["rank"] == args["fail_rank"] \
                        and args["fail_symbol"] in batch.symbols:
                    attempts["n"] += 1
                    raise RuntimeError("injected failure")
                return dispatch(batch, *a, **kw)

            runner_mod.dispatch = failing
            try:
                summary = r.run_pipeline_fused()
            finally:
                runner_mod.dispatch = dispatch
        if r.leader:
            _dump_tables(store, os.path.join(args["out"], f"{case}.pkl"))
            _dump(summary, os.path.join(args["out"], f"{case}_summary.pkl"))
        out[case] = {"mesh": None if r.mesh is None else r.mesh.shape,
                     "leader": r.leader, "device": str(r.device),
                     "attempts": attempts["n"] if case == "fail" else None}
    return out


def surface(args, device) -> dict:
    """``run_surface_fit`` over a mesh of the world for each method of
    ``args["methods"]``, from the interpolated table at ``args["table"]``."""
    from iv_interpolation_tpu_torch.config import get_config
    from iv_interpolation_tpu_torch.pipeline import storage as st
    from iv_interpolation_tpu_torch.pipeline import surface_task as task
    cfg = get_config("testing")
    cfg.processing.dtype = "float64"
    cfg.processing.mesh_shape = (pmesh.launched_world(),)
    for k, v in args.get("surface", {}).items():
        setattr(cfg.surface, k, v)
    store = st.MemoryStore()
    store.write(st.INTERPOLATED, _load(args["table"]))
    out = {}
    for method in args["methods"]:
        store.drop(task.SURFACES)
        out[method] = task.run_surface_fit(cfg, store, method=method, device=device)
        if pmesh.world_info()["rank"] == 0:
            _dump(store.read(task.SURFACES), os.path.join(args["out"], f"surface_{method}.pkl"))
    return out


def session(args, device) -> dict:
    """A ``StreamingSession`` over a mesh of the world fed the ticks at
    ``args["ticks"]`` (chains at ``args["chains"]``) in ``args["chunks"]``
    calls, refitting after each; rank 0 saves every refit."""
    from iv_interpolation_tpu_torch.pipeline.stream_service import StreamingSession
    mesh = pmesh.pipeline_mesh((pmesh.launched_world(),), device=device)
    unds, k, iv, T = _load(args["chains"])
    sess = StreamingSession(unds, k, iv, T, window_minutes=args["window"],
                            tick_capacity=args["capacity"], n_grid=args["n_grid"],
                            device=device, mesh=mesh)
    saved = {}
    for i, ticks in enumerate(_load(args["ticks"])):
        sess.ingest_ticks(ticks)
        out = sess.refit()
        if out is None:  # the whole result is rank 0's
            continue
        for name, v in out._asdict().items():
            if isinstance(v, torch.Tensor):
                saved[f"{i}_{name}"] = v.cpu().numpy()
            else:
                for f, t in v._asdict().items():
                    saved[f"{i}_{name}_{f}"] = t.cpu().numpy()
    stats = sess.stats()
    if mesh.is_leader:
        np.savez(os.path.join(args["out"], "session.npz"), **saved)
    return {"rows": list(sess.rows), "ring_rows": int(sess.ring.data.shape[0]), "stats": stats}


def serve(args, device) -> dict:
    """``run_serve`` (blocking) over a mesh of the world, from the
    interpolated table at ``args["table"]`` (none: the synthetic
    universe); rank 0 prints its port and serves, the others follow."""
    from iv_interpolation_tpu_torch.config import get_config
    from iv_interpolation_tpu_torch.pipeline import serve as srv
    from iv_interpolation_tpu_torch.pipeline import storage as st
    cfg = get_config("testing")
    cfg.processing.mesh_shape = (pmesh.launched_world(),)
    cfg.surface.grid_strikes = args.get("n_grid", 10)
    store = st.MemoryStore()
    if args.get("table"):
        store.write(st.INTERPOLATED, _load(args["table"]))
    server = srv.run_serve(cfg, store, port=0, n_underlyings=args.get("underlyings", 8),
                           blocking=True, device=device)
    return {"served": server is not None}


BODIES = {f.__name__: f for f in (mesh_contract, sequence, runner, surface, session, serve)}


def main(argv) -> int:
    body, args = argv[0], json.loads(argv[1])
    device = dryrun.join_world(args.get("device", "cpu"))
    # a rank holds that the port pulled in nothing of JAX
    if "jax" in sys.modules or "iv_interpolation_tpu" in sys.modules:
        raise RuntimeError("a rank imported JAX or the JAX package")
    result = BODIES[body](args, device)
    dryrun.report({"rank": pmesh.world_info()["rank"], "jax_free": "jax" not in sys.modules,
                   "result": result})
    pmesh.shutdown_world()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
