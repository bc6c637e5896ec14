"""Port parity: the bench harness (``iv_interpolation_tpu_torch/bench.py``)
against the root ``bench.py`` on JAX's CPU, and the entry points
(``iv_interpolation_tpu_torch/graft_entry.py``) against
``__graft_entry__.py``. The stages themselves are held to bench.py's in
``test_torch_bench_stages.py``.

Tolerances:
* the stage generators, seeds 0 and 12345 at the smoke shapes, against
  bench.py's formulas (``_iv_gen`` imported, the inner generators
  reproduced from their lines): uniform and integer draws bit for bit
  (the RBF sites, the tick minutes and sizes); inputs derived from
  uniform draws within 4 float32 ulps (XLA fuses and orders the float32
  arithmetic its own way; eSSVI's w within 8, its ATM variance a
  cumulative sum in XLA's order, held to the summation bound); inputs with a normal term within 4 ulps plus
  the normal's own bound from ``ops/prng.py``, 64 ulps of max(1, |x|),
  times the term's scale (summed along the price walk, a cumulative sum
  of such terms);
* the entry point's example batch within 4 ulps of its scale, its
  forward step's w_grid within 256 ulps of max |w| (the
  float32 surface tolerance of ``test_torch_surface.py``), flags exact.

``import bench`` sets JAX's persistent compile cache; the fixture puts
the two settings back, so later tests in the worker are unaffected.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iv_interpolation_tpu_torch import bench as port
from iv_interpolation_tpu_torch import graft_entry
from iv_interpolation_tpu_torch.ops import prng

REPO = Path(__file__).resolve().parents[1]
EPS32 = float(np.finfo(np.float32).eps)
NORMAL_ULPS = 64    # ops/prng.py's float32 bound for normal draws
CACHE_KEYS = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")


@pytest.fixture(scope="module")
def ref():
    """The root ``bench.py``, with JAX's cache settings put back."""
    before = {k: getattr(jax.config, k) for k in CACHE_KEYS}
    import bench
    for k, v in before.items():
        jax.config.update(k, v)
    return bench


def _close(got, want, noise=0.0, ulps=4):
    """float32 ``got`` within ``ulps`` of ``want`` plus ``noise``, what the
    normal draws in ``want`` may carry (:func:`_normal_bound`)."""
    got, want = np.asarray(got, np.float64), np.asarray(want)
    assert got.shape == want.shape and want.dtype == np.float32
    bound = ulps * np.spacing(np.abs(want)).astype(np.float64) + noise
    assert (np.abs(got - want) <= bound).all(), np.abs(got - want).max()


def _normal_bound(normal, scale):
    """``scale`` times ``ops/prng.py``'s bound on each normal draw."""
    return scale * NORMAL_ULPS * EPS32 * np.maximum(1.0, np.abs(np.asarray(normal, np.float64)))


def _key(seed):
    return jax.random.PRNGKey(seed)


@pytest.mark.parametrize("seed", [0, 12345])
def test_smile_generator_matches_bench(ref, seed):
    k_row = np.linspace(-1.0, 1.0, port.N_K, dtype=np.float32)
    normal = jax.random.normal(jax.random.split(_key(seed), 3)[2], (16, port.E, port.N_K),
                               jnp.float32)
    _close(port._iv_gen(16, k_row, "cpu")(seed).numpy(), ref._iv_gen(16, k_row)(seed),
           _normal_bound(normal, 1e-4))


@pytest.mark.parametrize("seed", [0, 12345])
def test_svi_generator_matches_bench(seed):
    B, E, n = 4, port.E, port.N_K
    k_row = np.linspace(-1.2, 1.2, n, dtype=np.float32)
    # bench.py:380-388
    keys = jax.random.split(_key(seed), 6)
    U = lambda key, lo, hi: jax.random.uniform(key, (B, E, 1), jnp.float32, lo, hi)
    a, b = U(keys[0], 0.01, 0.08), U(keys[1], 0.05, 0.3)
    rho, m = U(keys[2], -0.6, 0.6), U(keys[3], -0.2, 0.2)
    sig = U(keys[4], 0.1, 0.5)
    kk = jnp.asarray(k_row)[None, None, :]
    w = a + b * (rho * (kk - m) + jnp.sqrt((kk - m) ** 2 + sig ** 2))
    normal = jax.random.normal(keys[5], (B, E, n), jnp.float32)
    _close(port._svi_gen(B, k_row, "cpu")(seed).numpy(), w + 1e-4 * normal,
           _normal_bound(normal, 1e-4))


@pytest.mark.parametrize("seed", [0, 12345])
def test_essvi_generator_matches_bench(seed):
    from iv_interpolation_tpu.ops.essvi import essvi_w, psi_butterfly_cap

    B, E, n = 4, port.E, port.N_K
    k = np.broadcast_to(np.linspace(-1.2, 1.2, n, dtype=np.float32), (B, E, n)).copy()
    # bench.py:424-436
    keys = jax.random.split(_key(seed), 5)
    th0 = jax.random.uniform(keys[0], (B, E), jnp.float32, 0.005, 0.03)
    theta = jnp.cumsum(th0, axis=-1)
    rho = jnp.broadcast_to(jax.random.uniform(keys[1], (B, 1), jnp.float32, -0.6, 0.6), (B, E))
    frac = jnp.broadcast_to(jax.random.uniform(keys[2], (B, 1), jnp.float32, 0.2, 0.7), (B, E))
    params = jnp.stack([theta, rho, psi_butterfly_cap(theta, rho) * frac], axis=-1)
    normal = jax.random.normal(keys[3], (B, E, n), jnp.float32)
    # theta sums in XLA's order: within the bound of two orders of a
    # float32 sum of E terms, 2 (E - 1) eps sum|x|; essvi_w carries that
    # into w, held at twice the 4 ulps of the other generators
    got_th0 = prng.uniform(prng.split(prng.key(seed, "cpu"), 5)[0], torch.float32,
                           0.005, 0.03, (B, E))
    np.testing.assert_array_equal(got_th0.numpy(), np.asarray(th0))
    th_bound = 2 * (E - 1) * EPS32 * np.cumsum(np.asarray(th0, np.float64), axis=-1)
    assert (np.abs(torch.cumsum(got_th0, -1).numpy() - np.asarray(theta)) <= th_bound).all()
    _close(port._essvi_gen(torch.from_numpy(k))(seed).numpy(),
           essvi_w(params, jnp.asarray(k)) + 1e-4 * normal, _normal_bound(normal, 1e-4), ulps=8)


@pytest.mark.parametrize("seed", [0, 12345])
def test_tick_generator_matches_bench(seed):
    B, L, n_minutes = 8, 256, 64
    # bench.py:470-478
    k1, k2, k3 = jax.random.split(_key(seed), 3)
    minute = jnp.sort(jax.random.randint(k1, (B, L), 0, n_minutes, jnp.int32), axis=-1)
    normal = jax.random.normal(k2, (B, L), jnp.float32)
    price = 100 + jnp.cumsum(0.01 * normal, axis=-1)
    size = jax.random.uniform(k3, (B, L), jnp.float32, 0, 5)
    got = port._ticks_gen(B, L, n_minutes, "cpu")(seed)
    assert got[0].dtype == torch.int32 and got[3].dtype == torch.bool and bool(got[3].all())
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(minute))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(size))
    _close(got[1].numpy(), price, np.cumsum(_normal_bound(normal, 0.01), axis=-1))


@pytest.mark.parametrize("seed", [0, 12345])
def test_rbf_generator_matches_bench(seed):
    B, N = 2, 128
    # bench.py:340-346
    ks = jax.random.split(_key(seed), 3)
    kq = jax.random.uniform(ks[0], (B, N), jnp.float32, -1.0, 1.0)
    Tq = jax.random.uniform(ks[1], (B, N), jnp.float32, 0.05, 2.0)
    w = (0.04 + 0.3 * kq * kq) * Tq + 0.01 * jnp.sin(8.0 * kq) * Tq
    pts, got_w = port._rbf_gen(B, N, "cpu")(seed)
    np.testing.assert_array_equal(pts.numpy(), np.asarray(jnp.stack([kq, Tq], axis=-1)))
    _close(got_w.numpy(), w)


@pytest.mark.parametrize("seed", [0, 12345])
def test_ah_generator_matches_bench(seed):
    B, E_a, m = 2, 8, 16
    k = np.broadcast_to(np.linspace(-0.6, 0.6, m, dtype=np.float32), (B, E_a, m)).copy()
    T = np.broadcast_to(np.linspace(0.08, 1.5, E_a, dtype=np.float32), (B, E_a)).copy()
    # bench.py:510-515
    keys = jax.random.split(_key(seed), 2)
    lvl = jax.random.uniform(keys[0], (B, 1, 1), jnp.float32, 0.18, 0.30)
    iv = lvl + 0.1 * jnp.asarray(k) ** 2 + 0.02 * jnp.sqrt(jnp.asarray(T))[..., None]
    spike = jnp.zeros((m,), jnp.float32).at[m // 2].set(0.4)
    got = port._ah_gen(torch.from_numpy(k), torch.from_numpy(T))(seed)
    _close(got.numpy(), iv * (1.0 + spike))


def _stage_dicts():
    """Result dicts of every stage as the child writes them (telemetry
    keys included, which the line ignores)."""
    extra = {"calls": [], "peak_bytes": None, "launches": {"b1_f32": 0}}
    return {
        "spline": {"value": 1e6, "batch": 131072, "device": "cpu", "parity_max_err": 4.66e-8,
                   "butterfly_clean_frac": 1.0, "butterfly_adversarial_frac": 0.0, **extra},
        "parity": {"value": 9e4, "max_err_vs_x64_oracle": 1e-15, **extra},
        "svi": {"value": 2e5, "rmse": 1e-4, **extra},
        "essvi": {"value": 900.0, "rmse": 1e-4, **extra},
        "streaming": {"value": 5e5, **extra},
        "rbf": {"value": 14.5, "arbfree_frac": 1.0, **extra},
        "rbf_reduced": {"value": 200.0, "arbfree_frac": 1.0, **extra},
        "ah": {"value": 400.0, "arbfree_frac": 1.0, "price_rmse": 1e-3, **extra},
    }


@pytest.mark.parametrize("drop", [None, "parity", "ah", "spline"])
def test_the_line_has_bench_keys(ref, drop):
    """``_assemble`` of the port and of bench.py on the same stage dicts:
    the same keys and values but the parity metric's name and
    ``vs_baseline`` (null); None without the headline."""
    stages = _stage_dicts()
    stages.pop(drop, None)
    got, want = port._assemble({"stages": stages}), ref._assemble({"stages": stages})
    if drop == "spline":
        assert got is None and want is None
        return
    assert got["vs_baseline"] is None and want["vs_baseline"] == round(1e6 / ref.TARGET, 3)
    assert got.keys() == want.keys()
    same = lambda line: {k: v for k, v in line.items()
                         if k not in ("extra_metrics", "vs_baseline", "incomplete_metrics")}
    assert same(got) == same(want)
    renamed = {"parity_df64_surfaces_per_sec_fit_eval_30x50":
               "parity_f64_surfaces_per_sec_fit_eval_30x50"}
    want_extras = [dict(e, metric=renamed.get(e["metric"], e["metric"]))
                   for e in want["extra_metrics"]]
    assert got["extra_metrics"] == want_extras
    want_missing = [renamed.get(m, m) for m in want.get("incomplete_metrics", [])]
    assert got.get("incomplete_metrics", []) == want_missing
    assert [name for name, _ in port.STAGES] == [name for name, _ in ref.STAGES]


def test_harness_end_to_end_without_jax(tmp_path):
    """``python -m iv_interpolation_tpu_torch.bench --device cpu`` at the
    smoke shapes, in a process where ``jax`` and ``iv_interpolation_tpu``
    cannot be imported (the child inherits the block through a
    ``sitecustomize`` on its path): exactly one line on stdout with every
    stage; the state file keeps every stage's telemetry."""
    (tmp_path / "sitecustomize.py").write_text(
        "import sys\nsys.modules['jax'] = None\nsys.modules['iv_interpolation_tpu'] = None\n")
    state = tmp_path / "state.json"
    # one thread: the test workers share the host's cores
    env = dict(os.environ, IVTPU_BENCH_SMOKE="1", IVTPU_BENCH_STATE=str(state),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join((str(tmp_path), str(REPO))))
    env.pop("IVTPU_BENCH_ROLE", None)
    proc = subprocess.run([sys.executable, "-m", "iv_interpolation_tpu_torch.bench",
                           "--device", "cpu", "--seed", "7"], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert len(lines) == 1, proc.stdout
    line = json.loads(lines[0])
    assert "incomplete_metrics" not in line and line["device"] == "cpu"
    assert len(line["extra_metrics"]) == len(port.STAGES) - 1
    assert line["butterfly_clean_frac"] == 1.0 and line["vs_baseline"] is None
    kept = json.loads(state.read_text())
    assert kept["seed"] == 7 and not kept["failed"] and "running" not in kept
    for j, (name, _) in enumerate(port.STAGES):
        res = kept["stages"][name]
        assert res["seed"] == [7, j] and res["launches"] == {"b1_f32": 0, "b1_f64": 0, "b2": 0}
        assert res["host_median_s"] > 0 and res["event_median_ms"] is None
        assert len(res["calls"][-1]["host_s"]) == (5 if name in ("spline", "parity") else 3)
    assert "stage spline: done" in proc.stderr


def _fake_stages(log, fail=(), die=()):
    """Stand-ins for ``STAGES``: each logs its name; those in ``fail``
    raise, those in ``die`` end the child as a hard crash would."""
    def make(name):
        def fn(rng, device, calls):
            log.append(name)
            if name in fail:
                raise RuntimeError(f"{name}: an illegal memory access")
            if name in die:
                raise SystemExit(3)
            calls.append({"batch": 1, "host_median_s": 1e-3, "event_median_ms": None})
            return {"value": float(len(name)), "batch": 1}
        return fn
    return tuple((name, make(name)) for name, _ in port.STAGES)


def test_a_failed_stage_keeps_the_others_and_a_fresh_child_runs_the_rest(tmp_path):
    """A stage that raises is recorded as failed and ends its child; the
    parent's loop starts another for the stages left, never the failed one
    again; a child that dies mid-stage has that stage recorded as failed."""
    log, children = [], []
    stages = _fake_stages(log, fail={"svi", "rbf"}, die={"ah"})
    state_path = str(tmp_path / "state.json")
    names = [name for name, _ in port.STAGES]

    def launch(remaining):
        children.append(list(remaining))
        try:
            return port.run_stages(remaining, state_path, "cpu", 11, stages=stages)
        except SystemExit as e:
            return e.code

    state = port.drive(state_path, names, launch)
    assert log == names
    assert children == [names, names[3:], names[6:]]
    assert sorted(state["failed"]) == ["ah", "rbf", "svi"]
    assert "illegal memory access" in state["failed"]["svi"]
    assert "exited 3" in state["failed"]["ah"]
    assert sorted(state["stages"]) == sorted(set(names) - {"ah", "rbf", "svi"})
    assert state["stages"]["essvi"]["seed"] == [11, 3]
    line = port._assemble(state)
    assert line["value"] == 6.0 and len(line["incomplete_metrics"]) == 3


def test_a_child_that_settles_nothing_costs_one_stage(tmp_path):
    """A child that exits (or times out) before it starts a stage: the
    first stage it was given is recorded as failed, so the loop ends."""
    state_path = str(tmp_path / "state.json")
    calls = []

    def launch(remaining):
        calls.append(remaining)
        return None if len(calls) % 2 else 1

    state = port.drive(state_path, ["svi", "essvi", "ah"], launch)
    assert calls == [["svi", "essvi", "ah"], ["essvi", "ah"], ["ah"]]
    assert "time limit" in state["failed"]["svi"] and "exited 1" in state["failed"]["essvi"]


def test_stages_subset_and_unknown_names(tmp_path):
    """``--stages`` runs a subset in ``STAGES`` order, settled stages of an
    earlier run are kept, and an unknown name is refused."""
    log = []
    state_path = str(tmp_path / "state.json")
    port._state_write(state_path, {"stages": {"svi": {"value": 1.0}}, "failed": {}})
    args = port._parse(["--device", "cpu", "--stages", "ah,svi,spline", "--seed", "3"])
    assert port.run_stages(args.stages, state_path, args.device, args.seed,
                           stages=_fake_stages(log)) == 0
    assert log == ["spline", "ah"]
    with pytest.raises(SystemExit):
        port._parse(["--stages", "spline,nope"])


def test_without_a_card_the_harness_raises(monkeypatch):
    """No ``--device cpu`` and no card: the entry point raises before it
    starts a child or writes a state file."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("IVTPU_BENCH_ROLE", raising=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port.main([])
    with pytest.raises(RuntimeError, match="CUDA"):
        port.run_stages(["spline"], "unused", "cuda", 0)


def test_entry_forward_matches_jax_entry(ref):
    """``entry()``'s forward step on its example batch against the JAX
    ``entry()``'s, on the CPU; without ``device`` it targets the card.
    (``__graft_entry__`` imports bench.py, which ``ref`` imported first.)"""
    import __graft_entry__ as ge

    fn, args = graft_entry.entry(device="cpu")
    want_fn, want_args = ge.entry()
    for a, b in zip(args, want_args):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=4 * EPS32 * np.abs(b).max())
    got, want = fn(*args), want_fn(*want_args)
    w = np.asarray(want[0])
    np.testing.assert_allclose(got[0].numpy(), w, rtol=0,
                               atol=256 * EPS32 * np.abs(w).max())
    for g, h in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(h))
    assert tuple(got[0].shape) == (256, 30, 50) and bool(got[1].all())
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            graft_entry.entry()


def test_dryrun_multichip_runs_the_port_dry_run_on_cpu_ranks(monkeypatch):
    """``dryrun_multichip(n)`` is the port's dry run in a world of n CPU
    ranks (the world itself is held by ``test_torch_dryrun.py``)."""
    from iv_interpolation_tpu_torch.parallel import dryrun

    seen = []
    monkeypatch.setattr(dryrun, "main", lambda argv: seen.append(argv) or 0)
    graft_entry.dryrun_multichip(3)
    assert seen == [["--ranks", "3", "--device", "cpu"]]
    monkeypatch.setattr(dryrun, "main", lambda argv: 1)
    with pytest.raises(RuntimeError, match="exited 1"):
        graft_entry.dryrun_multichip(2)
