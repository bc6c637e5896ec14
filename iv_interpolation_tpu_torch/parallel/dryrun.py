"""Multi-rank dry run: the real pipeline over a mesh of ``torch.distributed``
ranks, plus per-method sharded surface-fit parity (port of
``iv_interpolation_tpu/parallel/dryrun.py``).

:func:`run` runs inside a launched world and makes four proofs:

1. **Real runner, sharded = unsharded.** ``run_pipeline_fused`` over a
   memory store of sample tickers with ``mesh_shape=(n,)`` on every rank,
   against rank 0's own run with ``mesh_shape=(1,)``: the three tables
   are equal byte for byte.
2. **Per-method sharded surface parity.** ``fit_eval_surface`` for
   cubic_spline (exact), svi, essvi, sabr and smoothing_spline (1e-6),
   the penalized RBF and Andreasen-Huge (rtol 1e-5, atol 1e-6): each
   rank fits its block of the batch, the rows are gathered and held to
   the whole batch fitted on one rank.
3. **Collectives ride the mesh.** On a (data, slice) mesh each rank fits
   its block of underlyings and expiries, the butterfly violations are
   summed over both axes (``psum``) and the grids gathered over both.
4. **Concurrent ``--shard`` processes** (``shardproof.proof_concurrent``),
   on rank 0; ``--no-shards`` leaves it out where another check makes it.

:func:`main` (``python -m iv_interpolation_tpu_torch.parallel.dryrun
--ranks 4 --device cpu``) launches the world itself, one process a rank
with a file rendezvous in a temporary directory (:func:`spawn_world`), and
prints the JAX dry run's summary line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import List, Optional, Sequence

import torch

from iv_interpolation_tpu_torch.parallel.mesh import WORLD_ENV
from iv_interpolation_tpu_torch.parallel.shardproof import _FOREIGN_ENV

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
#: a rank's result line on its standard output
RESULT_TAG = "RANK_RESULT "


def outside_world_env(env: Optional[dict] = None) -> dict:
    """``env`` (default: this process's) without the launcher's variables
    and the JAX runtime's, with the package on ``PYTHONPATH``."""
    env = dict(os.environ if env is None else env)
    for k in list(env):
        if k in WORLD_ENV or k.startswith(_FOREIGN_ENV):
            del env[k]
    env["PYTHONPATH"] = os.pathsep.join(p for p in (_REPO_ROOT, env.get("PYTHONPATH")) if p)
    return env


class World:
    """The processes of one launched world (see :func:`start_world`)."""

    def __init__(self, procs: List[subprocess.Popen], logs: List[str], tmp):
        self.procs, self.logs, self._tmp = procs, logs, tmp

    def wait(self, timeout_s: float) -> List[str]:
        """Each rank's standard output; raises (after stopping every rank)
        when a rank fails or the world outlives ``timeout_s``."""
        deadline = time.monotonic() + timeout_s
        try:
            while any(p.poll() is None for p in self.procs):
                bad = [r for r, p in enumerate(self.procs) if p.poll() not in (None, 0)]
                if bad or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
        finally:
            self.stop()
        outs = [open(log).read() for log in self.logs]
        codes = [p.returncode for p in self.procs]
        self._tmp.cleanup()
        if any(codes):
            detail = "\n".join(f"--- rank {r} (exit {c}) ---\n{out[-4000:]}"
                               for r, (c, out) in enumerate(zip(codes, outs)))
            raise RuntimeError(f"a rank of the world failed: exits {codes}\n{detail}")
        return outs

    def stop(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.terminate()
        for p in self.procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


def start_world(n: int, argv: Sequence[str], env: Optional[dict] = None,
                timeout_s: float = 60.0) -> World:
    """Start ``n`` ranks, each running ``python argv...`` with the
    launcher's variables (``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``,
    ``LOCAL_WORLD_SIZE``) and a file rendezvous (``IVTPU_DIST_INIT``), the
    groups' timeout ``timeout_s``. Output goes to files; :meth:`World.wait`
    reads it."""
    tmp = tempfile.TemporaryDirectory(prefix="ivtorch-world-")
    base = outside_world_env(env)
    procs, logs = [], []
    # the ranks share the host's cores rather than each taking all of them
    base.setdefault("OMP_NUM_THREADS", str(max(1, (os.cpu_count() or 1) // n)))
    for r in range(n):
        rank_env = dict(base, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(n),
                        LOCAL_WORLD_SIZE=str(n), IVTPU_DIST_TIMEOUT_S=str(timeout_s),
                        IVTPU_DIST_INIT=f"file://{tmp.name}/rendezvous")
        log = os.path.join(tmp.name, f"rank{r}.log")
        with open(log, "w") as f:
            procs.append(subprocess.Popen([sys.executable, *argv], env=rank_env, stdout=f,
                                          stderr=subprocess.STDOUT, cwd=_REPO_ROOT))
        logs.append(log)
    return World(procs, logs, tmp)


def spawn_world(n: int, argv: Sequence[str], env: Optional[dict] = None,
                timeout_s: float = 60.0, wait_s: float = 600.0) -> List[dict]:
    """Run a world of ``n`` ranks to its end (:func:`start_world`) and
    return each rank's result (the JSON of its :data:`RESULT_TAG` line)."""
    outs = start_world(n, argv, env, timeout_s).wait(wait_s)
    return [result_of(out) for out in outs]


def result_of(out: str) -> dict:
    lines = [ln for ln in out.splitlines() if ln.startswith(RESULT_TAG)]
    if not lines:
        raise RuntimeError(f"a rank printed no result:\n{out[-4000:]}")
    return json.loads(lines[-1][len(RESULT_TAG):])


def report(result) -> None:
    """Print this rank's result line."""
    print(RESULT_TAG + json.dumps(result, default=str), flush=True)


def join_world(device) -> "object":
    """Initialise this rank's world from the launcher's variables (a file
    rendezvous where :func:`start_world` gave one) and return the rank's
    device."""
    from iv_interpolation_tpu_torch.parallel import mesh as pmesh
    pmesh.init_world(device)
    return pmesh.rank_device(device)


# ----------------------------------------------------------------------
# the proofs
# ----------------------------------------------------------------------
def _surface_batch(B=16, E=6, n=16, dtype=torch.float32, device="cuda"):
    k = torch.linspace(-1.0, 1.0, n, dtype=dtype).expand(B, E, n).contiguous()
    T = torch.linspace(0.1, 1.5, E, dtype=dtype).expand(B, E).contiguous()
    iv = 0.2 + 0.1 * k * k + 0.02 * torch.sin(torch.arange(B, dtype=dtype)[:, None, None])
    return k.to(device), iv.to(device), T.to(device)


def _tables(store) -> dict:
    from iv_interpolation_tpu_torch.pipeline import storage as st
    out = {}
    for t in (st.INTERPOLATED, st.MINUTE_CANDLES, st.RECONSTRUCTED):
        df = store.read(t)
        df = df.drop(columns=[c for c in ("batch_id", "created_at") if c in df.columns])
        df = df.assign(symbol=df["symbol"].astype(str))
        out[t] = df.sort_values(["symbol"] + (["date"] if t == st.INTERPOLATED
                                              else ["timestamp"])).reset_index(drop=True)
    return out


def run_real_pipeline(mesh, device) -> None:
    """Proof 1: the fused runner over the mesh against rank 0's own run."""
    import pandas as pd

    from iv_interpolation_tpu_torch.config import get_config
    from iv_interpolation_tpu_torch.pipeline import storage as st
    from iv_interpolation_tpu_torch.pipeline.runner import PipelineRunner
    from iv_interpolation_tpu_torch.pipeline.sample_data import generate_sample_tickers

    tickers = generate_sample_tickers(num_symbols=8, hours=6, drop_frac=0.1)
    n = mesh.size
    shapes = ((1,), (n,)) if mesh.is_leader else ((n,),)
    tables = {}
    for shape in shapes:
        cfg = get_config("testing")
        cfg.storage.backend = "memory"
        cfg.processing.mesh_shape = shape
        cfg.processing.batch_size = 8
        cfg.interpolation.min_data_points = 5
        with tempfile.TemporaryDirectory() as td:
            cfg.checkpoint.manifest_dir = td
            cfg.monitoring.log_dir = td
            cfg.monitoring.enable_snapshots = False
            store = st.MemoryStore()
            store.write(st.TICKERS, tickers)
            runner = PipelineRunner(cfg, store=store, device=device)
            assert (runner.mesh is not None) == (shape != (1,)), "mesh knobs not consumed"
            res = runner.run_pipeline_fused()
            if mesh.is_leader:
                assert res["task1"]["by_status"].get("completed") == 8, res
                tables[shape] = _tables(store)
    if mesh.is_leader:
        for t, a in tables[(1,)].items():
            pd.testing.assert_frame_equal(a, tables[(n,)][t], check_exact=True)


def run_method_parity(mesh, device) -> list:
    """Proof 2: each family on this rank's block against the whole batch."""
    from iv_interpolation_tpu_torch.ops.andreasen_huge import fit_eval_ah_surface
    from iv_interpolation_tpu_torch.ops.rbf import fit_eval_rbf_arbfree_batched
    from iv_interpolation_tpu_torch.parallel.mesh import gather_rows, shard_batch
    from iv_interpolation_tpu_torch.surface.surface import fit_eval_surface

    k, iv, T = _surface_batch(device=device)
    B = k.shape[0]
    passed = []

    def check(got, ref, tol_r, tol_a, what):
        got = gather_rows(mesh, got, rows=B)
        torch.testing.assert_close(got, ref, rtol=tol_r, atol=tol_a, equal_nan=True,
                                   msg=lambda m: f"sharded {what} diverged: {m}")

    for method, tol in (("cubic_spline", 0.0), ("svi", 1e-6), ("essvi", 1e-6),
                        ("sabr", 1e-6), ("smoothing_spline", 1e-6)):
        fit = lambda a, b, c, m=method: fit_eval_surface(a, b, c, method=m, n_grid=16,
                                                         svi_iters=8)
        ref = fit(k, iv, T)
        out = fit(*shard_batch(mesh, k, iv, T))
        check(out["w_grid"], ref["w_grid"], tol, tol, f"{method} w_grid")
        check(out["butterfly_ok"], ref["butterfly_ok"], 0, 0, f"{method} butterfly flags")
        passed.append(method)

    pts = torch.stack([k.reshape(B, -1), T[..., None].expand(k.shape).reshape(B, -1)], dim=-1)
    vals = (iv * iv * T[..., None]).reshape(B, -1)
    query = pts[:, ::3]
    rbf = lambda p, v, q: fit_eval_rbf_arbfree_batched(p, v, q, n_iters=4, n_pen_t=6,
                                                        n_pen_k=9)[0]
    check(rbf(*shard_batch(mesh, pts, vals, query)), rbf(pts, vals, query), 1e-5, 1e-6,
          "rbf w_query")
    passed.append("rbf")

    ah = lambda a, b, c: fit_eval_ah_surface(a, b, c, n_grid=65, n_iters=4)["w_grid"]
    check(ah(*shard_batch(mesh, k, iv, T)), ah(k, iv, T), 1e-5, 1e-6, "ah w_grid")
    passed.append("ah")
    return passed


def run_collectives(device):
    """Proof 3: a (data, slice) mesh; violations summed over both axes."""
    from iv_interpolation_tpu_torch.parallel.mesh import (all_gather, launched_world,
                                                          make_mesh, psum,
                                                          surface_batch_sharding)
    from iv_interpolation_tpu_torch.surface.surface import fit_eval_surface

    n = launched_world()
    d_slice = 2 if n % 2 == 0 else 1
    d_data = n // d_slice
    mesh = make_mesh((d_data, d_slice), ("data", "slice"), device=device)
    B, E, m = 4 * d_data, 3 * d_slice, 16
    k, iv, T = _surface_batch(B=B, E=E, n=m, device=device)
    place = surface_batch_sharding(mesh, shard_expiries=True)
    # cubic smiles are independent per expiry: each rank fits its block of
    # underlyings and expiries
    out = fit_eval_surface(place(k), place(iv), place(T), method="cubic_spline", n_grid=m)
    n_bad = psum(mesh, (~out["butterfly_ok"]).sum().to(torch.int64), ("data", "slice"))
    w_grid = all_gather(mesh, all_gather(mesh, out["w_grid"], "slice", dim=1), "data", dim=0)
    ref = fit_eval_surface(k, iv, T, method="cubic_spline", n_grid=m)["w_grid"]
    torch.testing.assert_close(w_grid, ref, rtol=1e-5, atol=1e-6)
    return (d_data, d_slice), tuple(w_grid.shape), int(n_bad)


def run(device="cuda", shards: bool = True) -> dict:
    """The four proofs inside a launched world (every rank calls it), on
    the card unless ``device`` names another; returns rank 0's summary
    (the other ranks' is partial)."""
    from iv_interpolation_tpu_torch.parallel.mesh import make_mesh, world_info

    n = world_info()["size"]
    mesh = make_mesh((n,), ("data",), device=device)
    run_real_pipeline(mesh, mesh.device)
    methods = run_method_parity(mesh, mesh.device)
    mesh_shape, w_shape, n_bad = run_collectives(mesh.device)
    out = {"ranks": n, "backend": mesh.backend, "device": str(mesh.device),
           "mesh": mesh_shape, "w_grid": w_shape, "bad_surfaces": n_bad, "methods": methods}
    if shards and mesh.is_leader:
        from iv_interpolation_tpu_torch.parallel import shardproof
        with tempfile.TemporaryDirectory() as td:
            out["shards"] = shardproof.proof_concurrent(td, device=mesh.device.type)
    return out


def summary_line(res: dict) -> str:
    """The JAX dry run's summary line, from rank 0's result."""
    shards = res.get("shards")
    line = (f"dryrun_multichip ok: mesh=({res['mesh'][0]}x{res['mesh'][1]}) "
            f"platform={res['device']} backend={res['backend']} ranks={res['ranks']} "
            f"w_grid={tuple(res['w_grid'])} bad_surfaces={res['bad_surfaces']} "
            f"pipeline_tables_sharded_vs_single_device=BYTE_IDENTICAL "
            f"method_parity_PASS={'+'.join(res['methods'])} "
            f"parity_vs_single_device=PASS ")
    if shards:
        line += (f"concurrent_shard_processes=PASS (2 simultaneous procs, "
                 f"{shards['wall_s']}s overlap, tables byte-equal unsharded)")
    else:
        line += "concurrent_shard_processes=NOT_RUN"
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m iv_interpolation_tpu_torch.parallel.dryrun")
    p.add_argument("--ranks", type=int, default=4)
    p.add_argument("--device", default="cuda")
    p.add_argument("--no-shards", action="store_true",
                   help="leave out proof 4 (the concurrent --shard processes)")
    p.add_argument("--rank", action="store_true",
                   help="run as one rank of a launched world")
    p.add_argument("--timeout", type=float, default=600.0)
    args = p.parse_args(argv)
    if args.rank:
        join_world(args.device)
        res = run(args.device, shards=not args.no_shards)
        report(res)
        from iv_interpolation_tpu_torch.parallel.mesh import shutdown_world
        shutdown_world()
        return 0
    rank_argv = ["-m", "iv_interpolation_tpu_torch.parallel.dryrun", "--rank",
                 "--device", args.device] + (["--no-shards"] if args.no_shards else [])
    results = spawn_world(args.ranks, rank_argv, timeout_s=min(args.timeout, 300.0),
                          wait_s=args.timeout)
    print(summary_line(results[0]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
